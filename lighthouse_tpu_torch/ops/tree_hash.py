"""Incremental device tree-hashing: Merkleization as batched SHA-256 work.

The port of ``lighthouse_tpu/ops/tree_hash.py``.  The reference spends a
whole subsystem on exactly this (``consensus/cached_tree_hash`` +
milhouse's tree-backed ``BeaconState``): at mainnet shape (~1M validators)
state Merkleization is the hot path right after BLS, and the winning
strategy is *incremental* — keep the interior Merkle nodes, re-hash only
the ancestor paths of leaves that actually changed.  This module is that
blueprint on the card:

- :func:`_tree_hash_subtrees` — the fused subtree program, the hand-written
  CUDA kernel ``csrc/sha256.cu:tree_hash_subtrees_kernel``
  (``ops/cuda_sha.py``): a batch of depth-:data:`SUBTREE_DEPTH` subtrees
  (32 leaf chunks each) Merkleized in ONE launch, every interior level
  returned.  Full (re)builds of a big field walk the tree
  ``SUBTREE_DEPTH`` levels per launch — log32 launches for a registry, not
  log2.  Batched over the subtree axis, bucketed (:data:`N_BUCKETS`),
  supervised (``device_supervisor.run("tree_hash", ...)`` — watchdog,
  split-retry, breaker; on the card a failure raises, with
  ``device="cpu"`` the hashlib host model answers).
- :class:`DeviceLeafTree` — the cached-tree-hash layer: leaf chunks and
  all interior levels stay HOST-side as numpy arrays; ``update`` diffs the
  new leaves against the cache with one vectorized compare and re-hashes
  only dirty paths, each level's changed pairs as one ``sha256_pairs``
  batch (pipeline-coalesced via :func:`hash_pairs` when the async device
  pipeline is on) — cost scales with dirty leaves, not registry size.
  Structure-compatible with ``types/tree_cache._LeafTree`` so the state
  cache can swap engines per field.
- :func:`hash_pairs` — THE pair-hash seam for tree-hash traffic: layers
  big enough to amortize a launch ride the card (coalesced through the
  ``sha256_pairs`` hash pipeline when enabled, the supervised direct op
  otherwise); everything below the thresholds stays on the host kernel.

Routing thresholds and host seams are the JAX package's.  Device tree
hashing is on by default, on ``"cuda"`` (:func:`configure` turns it off or
points it at ``"cpu"``).  Every path is bit-identical to the pure-hashlib
golden model (:func:`golden_root`).

**Device mesh** (``device_mesh.py``): while the mesh is on, the subtree
axis pads to a multiple of the mesh size with zero subtrees, each mesh
member Merkleizes its contiguous block, and every level concatenates in
shard order on the mesh's first device: subtrees are independent, so the
levels, and every root above them, are the unsharded bytes.
"""

from __future__ import annotations

import hashlib as _hashlib
import time as _time
from typing import List, Optional

import numpy as np
import torch

from . import cuda_sha
from .devices import on_device, resolve_device, wait_for
from .sha256_device import note_route

#: Depth of the fused subtree program: 32 leaf chunks -> 1 root per subtree,
#: all five interior levels returned (the host cache needs every node).
SUBTREE_DEPTH = cuda_sha.SUBTREE_DEPTH
SUBTREE_LEAVES = cuda_sha.SUBTREE_LEAVES

#: Subtree-count buckets: the top bucket (32768 subtrees) Merkleizes one
#: 2^20-chunk level — the mainnet validator registry — in a single
#: launch.  Bigger levels chunk through the top bucket.
N_BUCKETS = (8, 128, 2048, 32768)

ENTRY_KEY = "lighthouse_tpu_torch/ops/tree_hash.py:_tree_hash_subtrees"

#: device_mesh.ShardedEntry for the subtree kernel (lazy).
_SHARDED_ENTRY = None


def _sharded_entry():
    global _SHARDED_ENTRY
    if _SHARDED_ENTRY is None:
        from .. import device_mesh

        _SHARDED_ENTRY = device_mesh.ShardedEntry(ENTRY_KEY, _tree_hash_subtrees)
    return _SHARDED_ENTRY

#: Precomputed zero-subtree roots (index d = root of a depth-d all-zero
#: tree) — the right-edge padding vocabulary, identical to types/ssz.py's
#: table (recomputed here so ops/ stays import-light).
ZERO_HASHES: List[bytes] = [b"\x00" * 32]
for _ in range(64):
    ZERO_HASHES.append(
        _hashlib.sha256(ZERO_HASHES[-1] + ZERO_HASHES[-1]).digest()
    )


# ------------------------------------------------------------ configuration

#: Device tree hashing is on by default, on the card: a state's big fields
#: build :class:`DeviceLeafTree` engines, which raise where there is no
#: card.  Host-only callers ask for the host engine with
#: ``configure(enabled=False)``, the kernels' plain versions with
#: ``configure(device="cpu")``.
_ENABLED = True

#: The card the device routes run on (``"cpu"`` runs the kernels' plain
#: versions).
_DEVICE = "cuda"

#: A full-rebuild level smaller than this many subtrees stays on the host
#: kernel (launch overhead dominates tiny trees).
DEVICE_MIN_SUBTREES = 4
_DEVICE_MIN_SUBTREES = DEVICE_MIN_SUBTREES

#: A dirty-path pair batch smaller than this many 64-byte blocks stays on
#: the host kernel; at or above it the batch rides :func:`hash_pairs`'
#: device route (pipeline-coalesced sha256_pairs when enabled).
DEVICE_MIN_BLOCKS = 64
_DEVICE_MIN_BLOCKS = DEVICE_MIN_BLOCKS


def enabled() -> bool:
    return _ENABLED


def device() -> torch.device:
    """The card the device routes run on (raises where it has no card)."""
    return resolve_device(_DEVICE)


def configure(enabled: Optional[bool] = None,
              device_min_subtrees: Optional[int] = None,
              device_min_blocks: Optional[int] = None,
              device=None) -> None:
    """Re-tune the device routing (tests / the caller that assembles a
    node).  ``enabled=False`` keeps every path on the host kernel;
    ``device`` names the card the device routes run on (``"cuda"`` by
    default, ``"cpu"`` for the kernels' plain versions)."""
    global _ENABLED, _DEVICE_MIN_SUBTREES, _DEVICE_MIN_BLOCKS, _DEVICE
    if enabled is not None:
        _ENABLED = bool(enabled)
    if device_min_subtrees is not None:
        _DEVICE_MIN_SUBTREES = max(1, int(device_min_subtrees))
    if device_min_blocks is not None:
        _DEVICE_MIN_BLOCKS = max(1, int(device_min_blocks))
    if device is not None:
        _DEVICE = str(resolve_device(device))


def reset_for_tests() -> None:
    """Back to the defaults: on, on the card, the default thresholds."""
    global _DEVICE
    configure(enabled=True, device_min_subtrees=DEVICE_MIN_SUBTREES,
              device_min_blocks=DEVICE_MIN_BLOCKS)
    _DEVICE = "cuda"


# -------------------------------------------------------------- the kernel


def _tree_hash_subtrees(leaves: torch.Tensor):
    """Merkleize a batch of 32-leaf subtrees in one launch.

    leaves: (m, 32, 8) int32 big-endian words of 32-byte leaf chunks.
    Returns the 5 interior levels, per subtree:
    ((m, 16, 8), (m, 8, 8), (m, 4, 8), (m, 2, 8), (m, 1, 8)) — the CUDA
    kernel on the card, its plain version on the CPU.
    """
    return cuda_sha.tree_hash_subtrees(leaves)


# ---------------------------------------------------------------- host side


def _bucket(m: int) -> int:
    for b in N_BUCKETS:
        if m <= b:
            return b
    raise ValueError(f"batch of {m} subtrees exceeds max bucket {N_BUCKETS[-1]}")


def _chunks_to_words(chunks: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 chunks (n a multiple of 32) -> (m, 32, 8) uint32 BE."""
    m = chunks.shape[0] // SUBTREE_LEAVES
    return np.ascontiguousarray(
        chunks.reshape(m, SUBTREE_LEAVES, 32)
    ).view(">u4").astype(np.uint32)


def _words_to_chunks(words: np.ndarray) -> np.ndarray:
    """(m, w, 8) uint32 -> (m*w, 32) uint8."""
    m, w = words.shape[0], words.shape[1]
    return np.frombuffer(
        np.ascontiguousarray(words).astype(">u4").tobytes(), dtype=np.uint8
    ).reshape(m * w, 32)


def golden_hash_pairs(data: bytes) -> bytes:
    """The pure-hashlib pair hash — the golden model every device path must
    match bit-for-bit (and the supervisor's terminal host fallback)."""
    out = bytearray()
    for i in range(0, len(data), 64):
        out += _hashlib.sha256(data[i: i + 64]).digest()
    return bytes(out)


def _host_subtree_levels(words: np.ndarray) -> List[np.ndarray]:
    """The hashlib golden model of :func:`_tree_hash_subtrees`: same input
    words, same 5 per-subtree levels, pure host."""
    m = words.shape[0]
    level = _words_to_chunks(words)  # (m*32, 32) u8
    out = []
    for d in range(SUBTREE_DEPTH):
        hashed = golden_hash_pairs(level.reshape(-1, 64).tobytes())
        level = np.frombuffer(hashed, dtype=np.uint8).reshape(-1, 32)
        w = SUBTREE_LEAVES >> (d + 1)
        out.append(
            np.ascontiguousarray(level.reshape(m, w, 32)
                                 ).view(">u4").astype(np.uint32)
        )
    return out


def _dispatch_subtrees(words: np.ndarray, mb: int, dev: torch.device,
                       stages: dict, state: dict) -> List[np.ndarray]:
    """Upload, launch and wait for one bucket-padded subtree batch on the
    supervisor's watchdog worker.  Mesh on: the subtree axis pads to a
    mesh multiple, each member Merkleizes its row block, and each level
    concatenates in shard order on the mesh's first device."""
    from .. import device_mesh, device_telemetry, fault_injection

    mesh = 0
    if device_mesh.enabled():
        mesh = device_mesh.size()
        mbp = device_mesh.pad_rows(mb)
        words, mb = device_mesh.grow_rows(words, mbp, 0), mbp
        placed = _sharded_entry().place(words.view(np.int32))
        dev = device_mesh.first_device()
    state["mesh"], state["mb"] = mesh, mb
    if fault_injection.ACTIVE:
        if not device_telemetry.COMPILE_CACHE.seen("tree_hash", (mb,), mesh=mesh):
            fault_injection.check("device.compile", op="tree_hash")
        fault_injection.check("device.dispatch", op="tree_hash")
    t_dispatch = _time.perf_counter()
    with on_device(dev):
        # mb is bucket-quantized by the caller
        if mesh:
            parts = _sharded_entry().run(_tree_hash_subtrees, placed)
            dev_out = tuple(torch.cat(level) for level in zip(*parts))
        else:
            dev_out = _tree_hash_subtrees(
                torch.from_numpy(words.view(np.int32)).to(dev))
    dispatch_s = _time.perf_counter() - t_dispatch
    stages["dispatch"] = dispatch_s
    if device_telemetry.note_dispatch("tree_hash", (mb,), dispatch_s, mesh=mesh):
        state["compiled"] = True
    t_wait = _time.perf_counter()
    wait_for(dev)
    out = [lv.cpu().numpy().view(np.uint32) for lv in dev_out]
    stages["wait"] = _time.perf_counter() - t_wait
    return out


def hash_subtree_levels(chunks: np.ndarray) -> List[np.ndarray]:
    """Merkleize one level of 32-byte ``chunks`` (shape ``(n, 32)`` uint8,
    ``n`` a positive multiple of :data:`SUBTREE_LEAVES`) through the fused
    subtree kernel on the configured card, :data:`SUBTREE_DEPTH` levels at
    once.

    Returns the 5 interior levels as flat chunk arrays
    ``[(n/2, 32), (n/4, 32), ..., (n/32, 32)]`` uint8 — Merkle level order
    (each subtree's nodes are contiguous).  Supervised: a failing dispatch
    is split-retried once (subtrees are independent, halves concatenate
    exactly); on the card a failure past that, a hang or an OPEN breaker
    raises, on the CPU the hashlib golden model answers."""
    from .. import device_supervisor, device_telemetry

    dev = device()

    n = int(chunks.shape[0])
    if n == 0 or n % SUBTREE_LEAVES:
        raise ValueError(f"level of {n} chunks is not a subtree multiple")
    m = n // SUBTREE_LEAVES
    top = N_BUCKETS[-1]
    if m > top:
        # Oversized levels chunk through the top bucket (independently
        # supervised launches; per-level outputs concatenate exactly).
        parts = [
            hash_subtree_levels(chunks[i * SUBTREE_LEAVES:
                                       (i + top) * SUBTREE_LEAVES])
            for i in range(0, m, top)
        ]
        return [np.concatenate(level) for level in zip(*parts)]

    t_route = _time.perf_counter()
    words = _chunks_to_words(chunks)
    mb = _bucket(m)
    if mb != m:
        padded = np.zeros((mb,) + words.shape[1:], dtype=np.uint32)
        padded[:m] = words
        words = padded
    holder: dict = {}

    def device_fn() -> List[np.ndarray]:
        stages_local: dict = {}
        state_local: dict = {}
        try:
            out = _dispatch_subtrees(words, mb, dev, stages_local, state_local)
            return [lv[:m] for lv in out]
        finally:
            holder["stages"] = stages_local
            holder["state"] = state_local

    def _device_half(half_words: np.ndarray) -> List[np.ndarray]:
        # Raw device path for one half — must NOT recurse into the
        # supervised entry (the halves already run on the watchdog worker).
        k = half_words.shape[0]
        kb = _bucket(k)
        if kb != k:
            grown = np.zeros((kb,) + half_words.shape[1:], dtype=np.uint32)
            grown[:k] = half_words
            half_words = grown
        out = _dispatch_subtrees(half_words, kb, dev, {}, {})
        return [lv[:k] for lv in out]

    def split_fn():
        mid = m // 2
        if mid == 0:
            raise ValueError("single-subtree batch cannot split")
        return [
            lambda: _device_half(words[:mid]),
            lambda: _device_half(words[mid:m]),
        ]

    def combine_fn(halves):
        return [np.concatenate(level) for level in zip(*halves)]

    info: dict = {}
    out_words = device_supervisor.run(
        "tree_hash",
        device_fn,
        host_fn=lambda: _host_subtree_levels(words[:m]),
        split_fn=split_fn,
        combine_fn=combine_fn,
        info=info,
        host_on_failure=dev.type != "cuda",
    )
    reason = info.get("fallback_reason")
    stages: dict = {}
    compiled = False
    mesh, shard_live = 0, None
    if reason != "dispatch_timeout":
        stages = holder.get("stages") or {}
        state = holder.get("state") or {}
        compiled = state.get("compiled", False)
        mesh, mb = state.get("mesh", 0), state.get("mb", mb)
        if mesh:
            shard_live = _sharded_entry().shard_live_counts(m, mb)
    device_telemetry.record_batch(
        op="tree_hash",
        shape=(mb,),
        mesh=mesh,
        shard_live=shard_live,
        n_live=m,
        stages=stages or None,
        host_fallback=info.get("route") == "host",
        fallback_reason=reason,
        trace_id=device_telemetry.active_trace_id(),
        compiled=compiled,
        breaker_state=info.get("breaker_state"),
        dispatched=reason != "breaker_open",
    )
    out = [_words_to_chunks(lv) for lv in out_words]
    note_route("device_subtree", m * (SUBTREE_LEAVES - 1), _time.perf_counter() - t_route)
    return out


# ---------------------------------------------------------- pair-hash seam


def hash_pairs(data: bytes) -> bytes:
    """THE pair-hash seam for tree-hash traffic.

    Device tree hashing on + a layer big enough to amortize a launch: ride
    the async device pipeline's ``sha256_pairs`` hash pipeline (the batch
    coalesces with other hash traffic and contends for the card through
    the shared arbiter) when it runs on the configured card; otherwise the
    supervised direct device op.  Everything else — small layers, layers
    above the top bucket, device hashing disabled — stays on the host
    kernel.  All routes are bit-identical."""
    n = len(data) // 64
    if n == 0:
        return b""
    from .sha256_device import N_BUCKETS as SHA_BUCKETS
    from .sha256_device import _host_hash_pairs, hash_pairs_device

    t0 = _time.perf_counter()
    if _ENABLED and _DEVICE_MIN_BLOCKS <= n <= SHA_BUCKETS[-1]:
        from .. import device_pipeline

        out = None
        if device_pipeline.routes_hash(n, device=_DEVICE):
            try:
                out = device_pipeline.hash_pairs(data, device=_DEVICE)
            except device_pipeline.PipelineShutdown:
                pass  # racing shutdown: fall through to the direct path
        if out is None:
            out = hash_pairs_device(data, device=_DEVICE)
        route = "device_pairs"
    else:
        out = _host_hash_pairs(data)
        route = ("host_off" if not _ENABLED
                 else "host_below" if n < _DEVICE_MIN_BLOCKS else "host_above")
    note_route(route, n, _time.perf_counter() - t0)
    return out


# ------------------------------------------------------- incremental cache


def _ceil_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def golden_root(leaves: np.ndarray, limit_chunks: int) -> bytes:
    """Pure-hashlib golden model: merkleize ``(n, 32)`` uint8 leaf chunks
    under a ``limit_chunks`` zero-subtree cap (the ssz ``merkleize``
    semantics, computed with nothing but hashlib)."""
    limit = max(1, int(limit_chunks))
    depth = max(0, (limit - 1).bit_length())
    n = len(leaves)
    if n > limit:
        raise ValueError(f"{n} chunks exceeds limit {limit}")
    if n == 0:
        return ZERO_HASHES[depth]
    layer = [leaves[i].tobytes() for i in range(n)]
    for d in range(depth):
        if len(layer) % 2:
            layer.append(ZERO_HASHES[d])
        layer = [
            _hashlib.sha256(layer[i] + layer[i + 1]).digest()
            for i in range(0, len(layer), 2)
        ]
    return layer[0]


class DeviceLeafTree:
    """Incremental Merkle tree over 32-byte leaf chunks, device-built.

    The cached-tree-hash layer: leaves and every interior level live
    host-side as ``(k, 32)`` uint8 numpy arrays covering the *occupied*
    prefix (everything right of it is the all-zero subtree, folded via
    :data:`ZERO_HASHES`).  ``update`` diffs new leaves against the cache in
    one vectorized compare; only the ancestor paths of changed leaves
    re-hash — each level's dirty pairs as ONE batch through
    :func:`hash_pairs` (pipeline-coalesced ``sha256_pairs`` for big dirty
    sets, host kernel for small ones).  A first build or occupied-size
    change rebuilds bottom-up through the fused subtree program
    (:func:`hash_subtree_levels`), :data:`SUBTREE_DEPTH` levels per
    dispatch.

    Attribute layout (``limit``/``depth``/``leaves``/``layers``/``_root``)
    is deliberately identical to ``types/tree_cache._LeafTree`` so the
    state cache's clone path handles either engine.

    While device tree hashing is on, building one resolves the configured
    card, so on the default ``"cuda"`` it raises where there is none.
    """

    def __init__(self, limit_chunks: int):
        if _ENABLED:
            device()
        self.limit = limit_chunks
        self.depth = max(0, (limit_chunks - 1).bit_length())
        self.leaves: Optional[np.ndarray] = None  # (n, 32) uint8
        self.layers: List[np.ndarray] = []  # interior levels, bottom-up
        self._root: bytes = ZERO_HASHES[self.depth]

    # ------------------------------------------------------------- updates

    def update(self, new_leaves: np.ndarray,
               dirty_hint: Optional[np.ndarray] = None) -> bytes:
        """Bring the tree to ``new_leaves`` (shape (n, 32) uint8),
        re-hashing only changed paths; returns the root.

        ``dirty_hint`` — indices the CALLER asserts are the only possibly-
        changed leaves (milhouse's dirty-tracking model; the validator
        cache knows its dirty elements from the fingerprint diff).  Hinted
        rows are still diffed (a hint naming unchanged rows costs nothing),
        but un-hinted rows are TRUSTED unchanged — the O(n) full-leaf scan,
        which dominates a 1%-dirty re-hash at mainnet size, is skipped.  A
        WRONG hint (omitting a changed leaf) yields a stale root: only pass
        one from an exact source."""
        n = len(new_leaves)
        if n > self.limit:
            raise ValueError(f"{n} chunks exceeds limit {self.limit}")
        if self.leaves is None or len(self.leaves) != n:
            return self._rebuild(new_leaves)
        new_leaves = np.ascontiguousarray(new_leaves)
        if dirty_hint is not None:
            hint = np.unique(np.asarray(dirty_hint, dtype=np.int64))
            if hint.size == 0:
                return self._root
            changed = (
                self.leaves[hint].view(np.uint64)
                != new_leaves[hint].view(np.uint64)
            ).any(axis=1)
            dirty = hint[changed]
        else:
            # u64-view compare: 4 lanes/row beats the u8 row-any ~2x at
            # mainnet leaf counts (rows are 32 bytes, always 8-aligned)
            dirty = np.nonzero(
                (self.leaves.view(np.uint64)
                 != new_leaves.view(np.uint64)).any(axis=1)
            )[0]
        if dirty.size == 0:
            return self._root
        # scatter-copy only the changed rows: un-dirty rows are equal by
        # construction, and the full 33 MB copy was the second-largest cost
        # of a mainnet-size incremental update
        self.leaves[dirty] = new_leaves[dirty]
        level = self.leaves
        for d, layer in enumerate(self.layers):
            # ``dirty`` is sorted (nonzero/np.unique above, and parents of
            # sorted stay sorted), so dedup is one shifted compare — the
            # per-level np.unique sort was a measurable slice of a
            # mainnet-size 1%-dirty re-hash
            parents = dirty >> 1
            if parents.size > 1:
                keep = np.empty(parents.size, dtype=bool)
                keep[0] = True
                np.not_equal(parents[1:], parents[:-1], out=keep[1:])
                parents = parents[keep]
            lo = parents << 1
            hi = lo + 1
            pairs = np.empty((parents.size, 64), dtype=np.uint8)
            pairs[:, :32] = level[lo]
            # Right sibling may be past the occupied edge -> zero subtree.
            in_range = hi < len(level)
            pairs[in_range, 32:] = level[hi[in_range]]
            if not in_range.all():
                pairs[~in_range, 32:] = np.frombuffer(ZERO_HASHES[d],
                                                      dtype=np.uint8)
            hashed = hash_pairs(pairs.tobytes())
            layer[parents] = np.frombuffer(hashed, dtype=np.uint8
                                           ).reshape(-1, 32)
            dirty = parents
            level = layer
        self._root = self._fold_zero_cap(level)
        return self._root

    def _use_device(self, occupied: int) -> bool:
        return (_ENABLED
                and occupied >= _DEVICE_MIN_SUBTREES * SUBTREE_LEAVES)

    def _rebuild(self, new_leaves: np.ndarray) -> bytes:
        """Full bottom-up rebuild (first call, or occupied size changed):
        the fused subtree program walks :data:`SUBTREE_DEPTH` levels per
        dispatch while enough of the tree remains; the host kernel finishes
        the narrow top."""
        self.leaves = new_leaves.copy()
        self.layers = []
        level = self.leaves
        occupied_depth = max(
            0, (_ceil_pow2(max(len(level), 1)) - 1).bit_length())
        occupied_depth = min(occupied_depth, self.depth)
        d = 0
        while d < occupied_depth:
            if (occupied_depth - d >= SUBTREE_DEPTH
                    and self._use_device(len(level))):
                occ = len(level)
                pad_to = -(-occ // SUBTREE_LEAVES) * SUBTREE_LEAVES
                padded = level
                if pad_to != occ:
                    padded = np.empty((pad_to, 32), dtype=np.uint8)
                    padded[:occ] = level
                    padded[occ:] = np.frombuffer(ZERO_HASHES[d],
                                                 dtype=np.uint8)
                sub_levels = hash_subtree_levels(padded)
                for lv in sub_levels:
                    occ = -(-occ // 2)  # occupied width of the next level
                    layer = lv[:occ].copy()
                    self.layers.append(layer)
                    level = layer
                    d += 1
            else:
                if len(level) % 2:
                    zrow = np.frombuffer(ZERO_HASHES[d], dtype=np.uint8
                                         ).reshape(1, 32)
                    level = np.concatenate([level, zrow], axis=0)
                pairs = level.reshape(-1, 64)
                hashed = hash_pairs(pairs.tobytes())
                layer = np.frombuffer(hashed, dtype=np.uint8
                                      ).reshape(-1, 32).copy()
                self.layers.append(layer)
                level = layer
                d += 1
        self._root = self._fold_zero_cap(level)
        return self._root

    def _fold_zero_cap(self, top: np.ndarray) -> bytes:
        """Fold the top occupied level up to the limit depth with zero
        trees (identical to ``_LeafTree._fold_zero_cap``)."""
        d = len(self.layers)
        if len(top) == 0:
            return ZERO_HASHES[self.depth]
        root = top[0].tobytes()
        for level in range(d, self.depth):
            root = _hashlib.sha256(root + ZERO_HASHES[level]).digest()
        return root
