"""Pure consensus layer of the port: the state-transition function and its
helpers, copied from the JAX package's ``lighthouse_tpu/consensus/``.

Block processing (``per_block``, ``state_transition``) verifies a block's
signatures as one batch through the port's BLS API, on the card by default
(the ``"torch"`` backend).  Epoch processing reaches the card through
``ops/epoch_device.py`` and ``ops/shuffle_device.py``
(``per_epoch.configure``).  ``electra`` and ``genesis`` are host Python, as
in the JAX package.
"""

from .per_block import BlockSignatureStrategy, BlockSignatureVerifier, per_block_processing
from .per_epoch import process_epoch
from .per_slot import process_slot, process_slots
from .shuffling import compute_shuffled_index, shuffle_list
from .state_transition import StateRootMismatch, state_transition

__all__ = [
    "BlockSignatureStrategy",
    "BlockSignatureVerifier",
    "StateRootMismatch",
    "compute_shuffled_index",
    "per_block_processing",
    "process_epoch",
    "process_slot",
    "process_slots",
    "shuffle_list",
    "state_transition",
]
