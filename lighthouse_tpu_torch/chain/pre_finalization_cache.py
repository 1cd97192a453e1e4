"""Cache for rejecting attestations to pre-finalization blocks.

Equivalent of the reference's
``beacon_node/beacon_chain/src/pre_finalization_cache.rs``: an attestation
whose head block is unknown to fork choice is either (a) pointing at an
already-finalized-past block — reject outright, it can never become a head —
or (b) pointing at a block we have not imported yet — hand it to sync's
single-block lookup.  Without this cache, an attacker replaying ancient
attestations forces a disk lookup per packet; with it, known-ancient roots
are refused from memory, and in-flight lookups are de-duplicated.

A copy of the JAX package's ``lighthouse_tpu/chain/pre_finalization_cache.py``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

from ..timeout_lock import TimeoutLock

BLOCK_ROOT_CACHE_LIMIT = 512
LOOKUP_LIMIT = 8


class _Lru:
    def __init__(self, cap: int) -> None:
        self.cap = cap
        self._d: "OrderedDict[bytes, None]" = OrderedDict()

    def __contains__(self, key: bytes) -> bool:
        if key in self._d:
            self._d.move_to_end(key)
            return True
        return False

    def put(self, key: bytes) -> None:
        self._d[key] = None
        self._d.move_to_end(key)
        while len(self._d) > self.cap:
            self._d.popitem(last=False)

    def pop(self, key: bytes) -> None:
        self._d.pop(key, None)

    def __len__(self) -> int:
        return len(self._d)


class PreFinalizationBlockCache:
    def __init__(self) -> None:
        self._lock = TimeoutLock("pre_finalization_cache")
        self._block_roots = _Lru(BLOCK_ROOT_CACHE_LIMIT)
        self._in_progress = _Lru(LOOKUP_LIMIT)
        # head-history snapshot: frozenset of the head state's block-roots
        # vector, rebuilt only when the head moves (the per-packet scan of
        # SLOTS_PER_HISTORICAL_ROOT entries is exactly the DoS cost this
        # cache exists to avoid).
        self._history_key: Optional[bytes] = None
        self._history: frozenset = frozenset()

    def _head_history(self, chain) -> frozenset:
        head = chain.head_root
        with self._lock:
            if self._history_key == head:
                return self._history
        snap = frozenset(bytes(r) for r in chain.head_state.block_roots)
        with self._lock:
            self._history_key = head
            self._history = snap
        return snap

    # -------------------------------------------------------------- queries

    def check(self, block_root: bytes, chain) -> bool:
        """True = the root is known pre-finalization: reject the attestation
        outright.  False = unknown; the caller should fall through to a
        single-block lookup (already-de-duplicated here)."""
        block_root = bytes(block_root)
        with self._lock:
            if block_root in self._block_roots:
                return True
            if block_root in self._in_progress:
                return False
        # 1. Recent history: the head state's block-roots vector covers the
        #    last SLOTS_PER_HISTORICAL_ROOT slots without touching disk
        #    (O(1) against the per-head frozenset snapshot).
        # 2. Disk: a stored block that fork choice does NOT know is on a
        #    pruned (pre-finalization) branch.
        if (block_root in self._head_history(chain)
                or chain.db.get_block(block_root) is not None):
            # Re-check fork choice AFTER the store read: a concurrent import
            # may have landed between the caller's fork-choice miss and now —
            # a freshly-imported head must not be classified ancient (and
            # its attester penalized).
            if chain.fork_choice.contains_block(block_root):
                return False
            with self._lock:
                self._block_roots.put(block_root)
            return True
        # 3. Unknown everywhere: let sync look it up (bounded, de-duplicated).
        with self._lock:
            self._in_progress.put(block_root)
        return False

    # -------------------------------------------------------------- feeding

    def block_processed(self, block_root: bytes) -> None:
        """An import landed: fork choice knows the root now."""
        with self._lock:
            self._in_progress.pop(bytes(block_root))

    def block_rejected(self, block_root: bytes) -> None:
        """A looked-up block failed import as pre-finalization: remember."""
        with self._lock:
            root = bytes(block_root)
            self._in_progress.pop(root)
            self._block_roots.put(root)

    def contains(self, block_root: bytes) -> bool:
        with self._lock:
            return bytes(block_root) in self._block_roots

    def metrics(self) -> Optional[Tuple[int, int]]:
        with self._lock:
            return len(self._block_roots), len(self._in_progress)
