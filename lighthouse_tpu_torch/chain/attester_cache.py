"""Early-attester cache: attest to the newest block before it hits the store.

Equivalent of the reference's single-item
``beacon_node/beacon_chain/src/early_attester_cache.rs``: when a block
finishes verification, enough of its post-state is captured (source/target
checkpoints, committee count) to produce attestations for the block's epoch
WITHOUT touching ``chain.head_state`` — on the 4-second attestation deadline,
waiting for the database write and head recompute is a latency cliff.  The
cached block/blobs also serve RPC requests for a block peers can already see
on gossip but which is not yet queryable from the store.

A copy of the JAX package's ``lighthouse_tpu/chain/attester_cache.py``.
"""

from __future__ import annotations

from typing import List, Optional

from ..timeout_lock import TimeoutLock

from .. import metrics

EARLY_CACHE_HITS = metrics.counter(
    "beacon_early_attester_cache_hits",
    "attestation data served from the early-attester cache",
)


class EarlyAttesterCache:
    """Single-item cache (the newest verified head candidate)."""

    def __init__(self) -> None:
        self._item: Optional[dict] = None
        self._lock = TimeoutLock("early_attester_cache")

    def clear(self) -> None:
        with self._lock:
            self._item = None

    def clear_unless(self, block_root: bytes) -> None:
        """Atomically drop the item unless it is for ``block_root``.

        Head-recompute path: a compare-then-``clear()`` outside the lock
        races a concurrent ``add_head_block`` — the fresh item of the block
        that just became head could be wiped between the check and the
        clear, dropping a valid early-attestation target."""
        with self._lock:
            if self._item is not None and self._item["block_root"] != bytes(block_root):
                self._item = None

    def add_head_block(self, block_root: bytes, signed_block, state,
                       types, spec, blobs: Optional[list] = None) -> None:
        """Capture attestation-production state for the verified block
        (reference ``add_head_block``): the post-state's justified source,
        the epoch target (the block itself when it sits at/before the epoch
        start), and the committee count for index bounds."""
        from ..consensus import helpers as h

        epoch = int(state.slot) // spec.slots_per_epoch
        target_slot = epoch * spec.slots_per_epoch
        if int(state.slot) <= target_slot:
            target_root = bytes(block_root)
        else:
            target_root = bytes(h.get_block_root(state, epoch, spec))
        item = {
            "epoch": epoch,
            "block_slot": int(signed_block.message.slot),
            "block_root": bytes(block_root),
            "source": state.current_justified_checkpoint.copy(),
            "target_root": target_root,
            "committee_count": h.get_committee_count_per_slot(state, epoch, spec),
            "block": signed_block,
            "blobs": list(blobs) if blobs else None,
        }
        with self._lock:
            self._item = item

    def try_attest(self, request_slot: int, request_index: int, types, spec):
        """``AttestationData`` for (slot, index) from the cache, or None when
        the item is absent / a different epoch / the index is out of bounds
        (reference ``try_attest`` conditions)."""
        with self._lock:
            item = self._item
        if item is None:
            return None
        if request_slot // spec.slots_per_epoch != item["epoch"]:
            return None
        if request_slot < item["block_slot"]:
            return None
        if request_index >= item["committee_count"]:
            return None
        data_index = (
            0 if spec.fork_name_at_slot(request_slot) == "electra"
            else request_index
        )
        EARLY_CACHE_HITS.inc()
        return types.AttestationData(
            slot=request_slot,
            index=data_index,
            beacon_block_root=item["block_root"],
            source=item["source"].copy(),
            target=types.Checkpoint(epoch=item["epoch"],
                                    root=item["target_root"]),
        )

    def get_block(self, block_root: bytes):
        """The cached signed block, for serving RPC before the store has it."""
        with self._lock:
            item = self._item
        if item is not None and item["block_root"] == bytes(block_root):
            return item["block"]
        return None

    def get_blobs(self, block_root: bytes) -> Optional[List]:
        with self._lock:
            item = self._item
        if item is not None and item["block_root"] == bytes(block_root):
            return item["blobs"]
        return None
