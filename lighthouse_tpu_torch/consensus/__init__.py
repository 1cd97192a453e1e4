"""Pure consensus layer of the port: the helpers, the shuffle, the
signature-set constructors, slot and epoch processing and the fork
upgrades, copied from the JAX package's ``lighthouse_tpu/consensus/``.

Epoch processing reaches the card through ``ops/epoch_device.py`` and
``ops/shuffle_device.py`` (``per_epoch.configure``).  Block processing
(``per_block``, ``state_transition``), ``electra`` and ``genesis`` are
not ported yet.
"""

from .per_epoch import process_epoch
from .per_slot import process_slot, process_slots
from .shuffling import compute_shuffled_index, shuffle_list

__all__ = [
    "compute_shuffled_index",
    "process_epoch",
    "process_slot",
    "process_slots",
    "shuffle_list",
]
