"""Incremental Merkleization for ``BeaconState``.

Equivalent capability to the reference's ``consensus/cached_tree_hash``
(`src/lib.rs:1-45` — arena-backed ``TreeHashCache`` with per-list leaf
caches) + milhouse's tree-backed state hashing
(`consensus/types/src/beacon_state.rs:34`), re-designed for this codebase's
plain-array containers:

- Every big list/vector field keeps its **leaf chunks** and all **interior
  Merkle layers** as flat byte arrays.  On re-hash, fresh leaves are packed
  from the current values (cheap, no hashing), diffed against the cached
  leaves with one vectorized compare, and only the ancestor paths of changed
  leaves are re-hashed — O(k·log n) SHA-256 calls for k changed leaves
  instead of O(n).
- The leaves themselves are always recomputed from the live values, so the
  cache cannot go stale through in-place mutation — correctness never
  depends on dirty *tracking*, only dirty *detection* (the diff).
- Composite element lists (validators) cache one root per element,
  fingerprinted by the element's field tuple; only changed elements are
  re-hashed (8 SHA-256 calls each).

The pair-hash primitive is whatever ``types.ssz`` has installed — the native
batched SHA-256 (`native/hash_pairs.cc`) when available, or the hybrid of
``ops/sha256_device.install_device_hash`` (the CUDA pair kernel for big
layers).  A copy of the JAX package's ``lighthouse_tpu/types/tree_cache.py``;
only the device engine's module and its default (on, on the card) differ.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import tree_hash
from . import ssz as _ssz
from .ssz import (
    ZERO_HASHES,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    List as SszList,
    UintType,
    Vector,
    mix_in_length,
)


def _hash_blocks(buf: bytes) -> bytes:
    """Hash consecutive 64-byte blocks with the installed pair-hash impl."""
    return _ssz._hash_pairs(buf)


def _ceil_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _make_tree(limit_chunks: int):
    """The leaf-tree engine for one big field: the device-backed
    ``ops/tree_hash.DeviceLeafTree`` while device tree hashing is on (the
    default, on the card; full rebuilds walk the fused subtree kernel five
    levels per launch, dirty-path pair batches ride the pipeline-aware hash
    seam), else the host :class:`_LeafTree` (``tree_hash.configure(
    enabled=False)``).  Both engines share the attribute layout
    (leaves/layers/limit/depth/_root), so clone/deepcopy handles either —
    and both are bit-identical to the hashlib golden model."""
    if tree_hash.enabled():
        return tree_hash.DeviceLeafTree(limit_chunks)
    return _LeafTree(limit_chunks)


class _LeafTree:
    """Incremental Merkle tree over 32-byte leaf chunks with a chunk limit.

    Layers are stored as numpy uint8 arrays of shape (n_i, 32) covering the
    *occupied* part of each level; everything to the right is the all-zero
    subtree, folded in via ``ZERO_HASHES`` (so a 2^40-limit validator
    registry costs only its occupied prefix).
    """

    def __init__(self, limit_chunks: int):
        self.limit = limit_chunks
        self.depth = max(0, (limit_chunks - 1).bit_length())
        self.leaves: Optional[np.ndarray] = None  # (n, 32) uint8
        self.layers: List[np.ndarray] = []  # interior levels, bottom-up
        self._root: bytes = ZERO_HASHES[self.depth]

    # ------------------------------------------------------------- updates

    def update(self, new_leaves: np.ndarray,
               dirty_hint: Optional[np.ndarray] = None) -> bytes:
        """Bring the tree to ``new_leaves`` (shape (n, 32) uint8), re-hashing
        only changed paths; returns the root.

        ``dirty_hint``: indices the caller asserts are the only possibly-
        changed leaves (hinted rows are still diffed; un-hinted rows are
        trusted unchanged, skipping the O(n) leaf scan).  Only exact
        sources may hint — the validator cache's fingerprint diff is one;
        a wrong hint would serve a stale root."""
        n = len(new_leaves)
        if n > self.limit:
            raise ValueError(f"{n} chunks exceeds limit {self.limit}")
        if self.leaves is None or len(self.leaves) != n:
            return self._rebuild(new_leaves)
        if dirty_hint is not None:
            hint = np.unique(np.asarray(dirty_hint, dtype=np.int64))
            if hint.size == 0:
                return self._root
            changed = np.any(self.leaves[hint] != new_leaves[hint], axis=1)
            dirty = hint[changed]
            if dirty.size == 0:
                return self._root
            self.leaves[dirty] = new_leaves[dirty]
        else:
            diff = np.any(self.leaves != new_leaves, axis=1)
            if not diff.any():
                return self._root
            dirty = np.nonzero(diff)[0]
            self.leaves = new_leaves.copy()
        level = self.leaves
        for d, layer in enumerate(self.layers):
            parents = np.unique(dirty >> 1)
            lo = parents << 1
            hi = lo + 1
            left = level[lo]
            # Right sibling may be past the occupied edge -> zero subtree.
            in_range = hi < len(level)
            right = np.empty_like(left)
            right[in_range] = level[hi[in_range]]
            if not in_range.all():
                right[~in_range] = np.frombuffer(ZERO_HASHES[d], dtype=np.uint8)
            pairs = np.concatenate([left, right], axis=1)  # (k, 64)
            hashed = _hash_blocks(pairs.tobytes())
            layer[parents] = np.frombuffer(hashed, dtype=np.uint8).reshape(-1, 32)
            dirty = parents
            level = layer
        self._root = self._fold_zero_cap(level)
        return self._root

    def _rebuild(self, new_leaves: np.ndarray) -> bytes:
        """Full vectorized rebuild (first call, or occupied size changed)."""
        self.leaves = new_leaves.copy()
        self.layers = []
        level = self.leaves
        occupied_depth = max(0, (_ceil_pow2(max(len(level), 1)) - 1).bit_length())
        for d in range(min(occupied_depth, self.depth)):
            if len(level) % 2:
                zrow = np.frombuffer(ZERO_HASHES[d], dtype=np.uint8).reshape(1, 32)
                level = np.concatenate([level, zrow], axis=0)
            pairs = level.reshape(-1, 64)
            hashed = _hash_blocks(pairs.tobytes())
            layer = np.frombuffer(hashed, dtype=np.uint8).reshape(-1, 32).copy()
            self.layers.append(layer)
            level = layer
        self._root = self._fold_zero_cap(level)
        return self._root

    def _fold_zero_cap(self, top: np.ndarray) -> bytes:
        """Fold the top occupied level up to the limit depth with zero trees."""
        d = len(self.layers)
        if len(top) == 0:
            return ZERO_HASHES[self.depth]
        root = top[0].tobytes()
        for level in range(d, self.depth):
            root = _ssz.hash_two(root, ZERO_HASHES[level])
        return root


def _pack_basic(serialized: bytes) -> np.ndarray:
    """Zero-pad a byte string to 32-byte chunks as an (n, 32) uint8 array."""
    n = len(serialized)
    chunks = (n + 31) // 32
    if chunks == 0:
        return np.empty((0, 32), dtype=np.uint8)
    buf = np.zeros(chunks * 32, dtype=np.uint8)
    buf[:n] = np.frombuffer(serialized, dtype=np.uint8)
    return buf.reshape(-1, 32)


class _BasicListCache:
    """Cache for List/Vector of uints (balances, slashings, …) and byte
    lists (participation): leaves are packed serialization — no per-element
    hashing at all, just the incremental tree."""

    def __init__(self, elem_size: int, limit_elems: int, mix_length: bool):
        limit_chunks = max(1, (limit_elems * elem_size + 31) // 32)
        self.elem_size = elem_size
        self.tree = _make_tree(limit_chunks)
        self.mix_length = mix_length

    def root(self, values) -> bytes:
        if isinstance(values, (bytes, bytearray)):
            data = bytes(values)
            length = len(data)
        else:
            length = len(values)
            if self.elem_size == 8:
                data = np.asarray(values, dtype=np.uint64).tobytes()
            elif self.elem_size == 1:
                data = np.asarray(values, dtype=np.uint8).tobytes()
            else:
                data = b"".join(
                    int(v).to_bytes(self.elem_size, "little") for v in values
                )
        body = self.tree.update(_pack_basic(data))
        return mix_in_length(body, length) if self.mix_length else body


class _RootListCache:
    """Cache for Vector/List of bytes32 roots (block_roots, state_roots,
    randao_mixes, historical roots): each element IS a leaf chunk."""

    def __init__(self, limit_elems: int, mix_length: bool):
        self.tree = _make_tree(max(1, limit_elems))
        self.mix_length = mix_length

    def root(self, values) -> bytes:
        if values:
            arr = np.frombuffer(b"".join(bytes(v) for v in values), dtype=np.uint8)
            leaves = arr.reshape(-1, 32)
        else:
            leaves = np.empty((0, 32), dtype=np.uint8)
        body = self.tree.update(leaves)
        return mix_in_length(body, len(values)) if self.mix_length else body


class _ValidatorListCache:
    """Cache for the validator registry: per-element root memo keyed by the
    element's field-value fingerprint, plus an incremental tree over the
    element roots.  A re-hash after one mutation costs one element re-hash
    (8 SHA-256) + O(log n) interior nodes."""

    def __init__(self, elem_type, limit_elems: int):
        self.elem_type = elem_type  # _ContainerType of Validator
        self.tree = _make_tree(max(1, limit_elems))
        self.fingerprints: List[Optional[tuple]] = []
        self.roots: Optional[np.ndarray] = None  # (n, 32) uint8

    @staticmethod
    def _fingerprint(v) -> tuple:
        # Validator fields are ints/bools/bytes — all hashable values.
        return (
            v.pubkey, v.withdrawal_credentials, v.effective_balance, v.slashed,
            v.activation_eligibility_epoch, v.activation_epoch, v.exit_epoch,
            v.withdrawable_epoch,
        )

    def root(self, values) -> bytes:
        n = len(values)
        if self.roots is None or len(self.roots) != n:
            self.fingerprints = [None] * n
            self.roots = np.zeros((n, 32), dtype=np.uint8)
        dirty = []
        for i, v in enumerate(values):
            fp = self._fingerprint(v)
            if fp != self.fingerprints[i]:
                self.fingerprints[i] = fp
                dirty.append(i)
        if dirty:
            # Re-hash changed validators in one batched pipeline:
            # pubkey root (1 hash) -> 8 leaf chunks -> 4+2+1 hashes.
            k = len(dirty)
            pk = np.zeros((k, 64), dtype=np.uint8)
            for j, i in enumerate(dirty):
                pk[j, :48] = np.frombuffer(bytes(values[i].pubkey), dtype=np.uint8)
            pk_roots = np.frombuffer(_hash_blocks(pk.tobytes()), dtype=np.uint8).reshape(-1, 32)
            leaves = np.zeros((k, 8, 32), dtype=np.uint8)
            for j, i in enumerate(dirty):
                v = values[i]
                leaves[j, 0] = pk_roots[j]
                leaves[j, 1] = np.frombuffer(bytes(v.withdrawal_credentials), dtype=np.uint8)
                leaves[j, 2, :8] = np.frombuffer(
                    int(v.effective_balance).to_bytes(8, "little"), dtype=np.uint8)
                leaves[j, 3, 0] = 1 if v.slashed else 0
                for fi, val in (
                    (4, v.activation_eligibility_epoch), (5, v.activation_epoch),
                    (6, v.exit_epoch), (7, v.withdrawable_epoch),
                ):
                    leaves[j, fi, :8] = np.frombuffer(
                        int(val).to_bytes(8, "little"), dtype=np.uint8)
            level = leaves.reshape(k, 8 * 32)
            for width in (8, 4, 2):
                hashed = _hash_blocks(level.tobytes())
                level = np.frombuffer(hashed, dtype=np.uint8).reshape(k, width // 2 * 32)
            self.roots[dirty] = level.reshape(k, 32)
        # the fingerprint diff IS an exact dirty set (an empty one proves
        # no element root changed): hint the tree so a 1%-dirty mainnet
        # registry skips the O(n) root-leaf scan
        body = self.tree.update(
            self.roots, dirty_hint=np.asarray(dirty, dtype=np.int64))
        return mix_in_length(body, n)




class _ElementMemoListCache:
    """Cache for append-mostly lists of container elements (eth1_data_votes,
    historical_summaries, phase0 pending attestations): per-index root memo
    keyed by the element's SSZ serialization — unlike an identity key, an
    in-place mutation of a cached element can never serve a stale root (a
    wrong BeaconState root is a consensus split), and unlike a deep Python
    tuple, the unchanged-element check is one flat bytes compare (SSZ
    encoding is injective for a fixed type) — plus the incremental tree over
    element roots."""

    def __init__(self, elem_type, limit_elems: int):
        self.elem_type = elem_type
        self.tree = _make_tree(max(1, limit_elems))
        self.fps: List[Optional[bytes]] = []
        self.roots: Optional[np.ndarray] = None  # (n, 32) uint8

    def root(self, values) -> bytes:
        n = len(values)
        if self.roots is None or len(self.roots) != n:
            old_fps, old_roots = self.fps, self.roots
            roots = np.zeros((n, 32), dtype=np.uint8)
            keep = min(n, len(old_fps)) if old_roots is not None else 0
            if keep:
                roots[:keep] = old_roots[:keep]
            self.fps = [None] * n
            self.roots = roots
            for i, v in enumerate(values):
                fp = self.elem_type.serialize(v)
                if i < keep and fp == old_fps[i]:
                    self.fps[i] = fp
                    continue
                self.fps[i] = fp
                self.roots[i] = np.frombuffer(
                    self.elem_type.hash_tree_root(v), dtype=np.uint8)
        else:
            for i, v in enumerate(values):
                fp = self.elem_type.serialize(v)
                if fp != self.fps[i]:
                    self.fps[i] = fp
                    self.roots[i] = np.frombuffer(
                        self.elem_type.hash_tree_root(v), dtype=np.uint8)
        body = self.tree.update(self.roots)
        return mix_in_length(body, n)


class _IdentityMemoCache:
    """Root memo for container fields that are REPLACED, never mutated in
    place (sync committees: a fresh object is assigned each period,
    ``per_epoch.py:293-294``).  Holds a strong ref so the identity stays
    valid; a state.copy() produces a new object and safely recomputes."""

    def __init__(self, t):
        self.t = t
        self.obj = None
        self._root: Optional[bytes] = None

    def root(self, value) -> bytes:
        if value is not self.obj or self._root is None:
            self.obj = value
            self._root = self.t.hash_tree_root(value)
        return self._root


class StateTreeHashCache:
    """Per-state container-level cache: big fields get incremental list
    caches; everything else is recomputed directly (cheap scalars / small
    containers).  Attached lazily to state instances as ``_thc``."""

    # Field names -> cache strategy, resolved per concrete state class.
    def __init__(self, container_type):
        import threading

        self.type = container_type
        self.caches: Dict[str, object] = {}
        # hash_tree_root is no longer a pure function: the HTTP server hashes
        # shared head states from multiple threads, so cache updates must be
        # serialized (the reference wraps its caches in timeout RwLocks).
        self._lock = threading.Lock()
        for name, t in container_type.field_types.items():
            cache = self._cache_for(name, t)
            if cache is not None:
                self.caches[name] = cache

    @staticmethod
    def _cache_for(name: str, t):
        if name in ("current_sync_committee", "next_sync_committee"):
            return _IdentityMemoCache(t)
        if isinstance(t, SszList):
            if isinstance(t.elem, UintType):
                return _BasicListCache(t.elem.fixed_size, t.limit, mix_length=True)
            if isinstance(t.elem, ByteVector) and t.elem.length == 32:
                return _RootListCache(t.limit, mix_length=True)
            if name == "validators":
                return _ValidatorListCache(t.elem, t.limit)
            if name in ("eth1_data_votes", "historical_summaries",
                        "previous_epoch_attestations", "current_epoch_attestations"):
                return _ElementMemoListCache(t.elem, t.limit)
            return None
        if isinstance(t, Vector) and t.length >= 64:
            if isinstance(t.elem, UintType):
                return _BasicListCache(t.elem.fixed_size, t.length, mix_length=False)
            if isinstance(t.elem, ByteVector) and t.elem.length == 32:
                return _RootListCache(t.length, mix_length=False)
            return None
        if isinstance(t, ByteList):
            return _BasicListCache(1, t.limit, mix_length=True)
        return None

    def field_roots(self, state) -> List[bytes]:
        """Per-field roots (the state container's Merkle leaves) — shared
        with the light-client branch builder so proofs reuse the
        incremental caches instead of re-merkleizing the state."""
        with self._lock:
            leaves = []
            for name, t in self.type.field_types.items():
                cache = self.caches.get(name)
                if cache is not None:
                    leaves.append(cache.root(getattr(state, name)))
                else:
                    leaves.append(t.hash_tree_root(getattr(state, name)))
            return leaves

    def root(self, state) -> bytes:
        return _ssz.merkleize(self.field_roots(state))

    def __deepcopy__(self, memo):
        # state.copy() deep-copies the whole object graph; cloning the cache
        # arrays keeps the copy incremental from the parent's position.
        # Cloning runs under the source lock: a concurrent hash_tree_root
        # mid-update must not be snapshotted half-written (new leaves with
        # the old root would make the clone silently serve stale roots).
        import copy as _copy
        import threading

        clone = StateTreeHashCache.__new__(StateTreeHashCache)
        clone.type = self.type
        clone._lock = threading.Lock()
        clone.caches = {}
        with self._lock:
            for name, cache in self.caches.items():
                c = _copy.copy(cache)
                if hasattr(cache, "tree"):
                    c.tree = _copy.copy(cache.tree)
                    c.tree.leaves = (
                        None if cache.tree.leaves is None else cache.tree.leaves.copy()
                    )
                    c.tree.layers = [l.copy() for l in cache.tree.layers]
                if isinstance(cache, _ValidatorListCache):
                    c.fingerprints = list(cache.fingerprints)
                    c.roots = None if cache.roots is None else cache.roots.copy()
                elif isinstance(cache, _ElementMemoListCache):
                    c.fps = list(cache.fps)
                    c.roots = None if cache.roots is None else cache.roots.copy()
                clone.caches[name] = c
        return clone
