"""Batched SHA-256 pair hashing on the card: the supervised device op.

The port of ``lighthouse_tpu/ops/sha256_device.py``.  The second crypto
hot loop after BLS is SHA-256 Merkleization (SURVEY §2.1).  This op hashes
N independent 64-byte blocks (exactly the Merkle pair-hash shape) with the
hand-written CUDA kernel ``csrc/sha256.cu:sha256_pairs_kernel``
(``ops/cuda_sha.py``; on a CPU tensor its plain PyTorch version).

Batches are padded to the JAX package's static shape buckets
(:data:`N_BUCKETS`), so every layer size lands on one of six launch sizes
and the first-dispatch mirror and the occupancy accounting of the device
telemetry read as the JAX package's do.  The host kernel
(``native/hash_pairs.cc``, SHA-NI) stays the route for small layers, where
the upload and launch cost more than the hashing: :func:`install_device_hash`
installs the hybrid as the SSZ pair-hash seam
(``types.ssz.set_hash_pairs_impl``).

Supervised (``device_supervisor.run("sha256_pairs", ...)``): a failing
batch is split-retried once (every block is independent, so halves
concatenate exactly); on the card a failure that survives the retry, a
hang past the watchdog or an OPEN breaker raises into the caller — the
host kernel answers failures only for ``device="cpu"``.

**Device mesh** (``device_mesh.py``): while the mesh is on, the block
axis pads to a multiple of the mesh size with zero blocks, splits into
contiguous row blocks, one per mesh member, runs the kernel on each, and
the digests concatenate in order on the mesh's first device (every block
is independent, so the bytes are the unsharded ones).  The block axis
buckets against ``autotune.bucket_vocabulary("sha256_pairs", N_BUCKETS)``.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from .. import autotune
from . import cuda_sha
from .devices import on_device, resolve_device, wait_for

N_BUCKETS = (256, 1024, 4096, 16384, 65536, 262144)

ENTRY_KEY = "lighthouse_tpu_torch/ops/sha256_device.py:_sha256_64byte_batch"


def _warmup(nb: int) -> None:
    from .compile_cache import aot_warmup_op

    aot_warmup_op("sha256_pairs", nb)


# Self-tuning enrolment (autotune.py): this ratio-4 vocabulary has real
# gaps, so the controller's densify heuristic can overlay midpoint buckets
# (e.g. 640 between 256 and 1024) when the flight recorder shows the
# median dispatched layer wasting over half its lanes.  N_BUCKETS stays
# the floor and its top bucket the ceiling; every adoption waits for its
# warmup dispatch.
autotune.register_vocabulary(
    "sha256_pairs", N_BUCKETS, telemetry_ops=("sha256_pairs",), warmup=_warmup)

#: device_mesh.ShardedEntry for the pair-hash kernel (lazy).
_SHARDED_ENTRY = None


def _sharded_entry():
    global _SHARDED_ENTRY
    if _SHARDED_ENTRY is None:
        from .. import device_mesh

        _SHARDED_ENTRY = device_mesh.ShardedEntry(ENTRY_KEY, _sha256_64byte_batch)
    return _SHARDED_ENTRY

#: 64-byte blocks hashed, and seconds spent, per route since the last
#: :func:`reset_routes`, counted where the route is chosen:
#: ``device_subtree`` (the fused subtree kernel, 31 blocks a subtree),
#: ``device_pairs`` (the pair kernel), ``host_below`` (a layer below the
#: device threshold), ``host_above`` (a layer above the top bucket) and
#: ``host_off`` (device tree hashing off).  A device route's seconds hold
#: the whole supervised call (upload, launch, wait, download).
#: Updated under :data:`_ROUTE_LOCK`: the hash pipeline's callers note
#: routes from many threads at once.
ROUTE_BLOCKS: Counter = Counter()
ROUTE_SECONDS: Counter = Counter()
_ROUTE_LOCK = threading.Lock()


def note_route(route: str, n_blocks: int, seconds: float) -> None:
    with _ROUTE_LOCK:
        ROUTE_BLOCKS[route] += n_blocks
        ROUTE_SECONDS[route] += seconds


def reset_routes() -> None:
    with _ROUTE_LOCK:
        ROUTE_BLOCKS.clear()
        ROUTE_SECONDS.clear()


def _sha256_64byte_batch(words: torch.Tensor) -> torch.Tensor:
    """words: (N, 16) int32 big-endian message words -> (N, 8) digest words
    (the CUDA kernel on the card, its plain version on the CPU)."""
    return cuda_sha.sha256_pairs(words)


def _bucket(n: int, buckets: Optional[Sequence[int]] = None) -> int:
    if buckets is None:
        # the live vocabulary: static N_BUCKETS plus controller-adopted
        # overlay buckets (autotune.py)
        buckets = autotune.bucket_vocabulary("sha256_pairs", N_BUCKETS)
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} blocks exceeds max bucket {buckets[-1]}")


_installed = False

# The true host kernel, captured before install_device_hash swaps the ssz
# seam — the host route must reach the native/hashlib impl, not recurse
# into the installed hybrid wrapper.
_HOST_IMPL = None


def install_device_hash(threshold_blocks: int = 8192, device="cuda") -> None:
    """Install a hybrid pair-hash kernel as the SSZ seam: the card (on
    ``device``) for layers of ``threshold_blocks`` up to the top bucket,
    the existing host kernel (SHA-NI native / hashlib) below and above.
    Idempotent: a second call keeps the first hybrid."""
    global _installed, _HOST_IMPL
    if _installed:
        return
    from ..types import ssz as ssz_mod

    device = resolve_device(device)
    host_impl = ssz_mod._hash_pairs
    _HOST_IMPL = host_impl

    def hybrid(data: bytes) -> bytes:
        n = len(data) // 64
        t0 = time.perf_counter()
        if threshold_blocks <= n <= N_BUCKETS[-1]:
            out = hash_pairs_device(data, device=device)
            route = "device_pairs"
        else:
            # below threshold OR above the largest bucket: the host kernel
            # (oversize layers must never crash hash_tree_root)
            out = host_impl(data)
            route = "host_below" if n < threshold_blocks else "host_above"
        note_route(route, n, time.perf_counter() - t0)
        return out

    ssz_mod.set_hash_pairs_impl(hybrid)
    _installed = True


def uninstall_device_hash() -> None:
    """Put the host kernel that :func:`install_device_hash` replaced back
    as the SSZ seam (no-op when nothing is installed)."""
    global _installed, _HOST_IMPL
    if not _installed:
        return
    from ..types import ssz as ssz_mod

    ssz_mod.set_hash_pairs_impl(_HOST_IMPL)
    _installed = False
    _HOST_IMPL = None


def _host_hash_pairs(data: bytes) -> bytes:
    """The host kernel (SHA-NI native / hashlib): the impl captured before
    :func:`install_device_hash` swapped the ssz seam — never the installed
    hybrid (which would recurse right back into the device path)."""
    if _HOST_IMPL is not None:
        return _HOST_IMPL(data)
    from ..types import ssz as ssz_mod

    return ssz_mod._hash_pairs(data)


def _words(data: bytes, n: int, nb: int) -> np.ndarray:
    """The first ``n`` 64-byte blocks of ``data`` as (nb, 16) big-endian
    words (uint32), zero rows past ``n``."""
    buf = np.zeros((nb, 64), dtype=np.uint8)
    buf[:n] = np.frombuffer(data[: n * 64], dtype=np.uint8).reshape(n, 64)
    return buf.view(">u4").astype(np.uint32)


def _dispatch_batch(words: np.ndarray, nb: int, device: torch.device,
                    stages: dict, state: dict) -> np.ndarray:
    """Upload, launch and wait for one bucket-padded batch on the
    supervisor's watchdog worker; the (nb, 8) uint32 digest words (more
    rows, zero blocks' digests, when the mesh padded the batch).

    Mesh on: the block axis pads to a multiple of the mesh size, each
    member hashes its row block, and the digests concatenate in shard
    order on the mesh's first device."""
    from .. import device_mesh, device_telemetry, fault_injection

    mesh = 0
    if device_mesh.enabled():
        mesh = device_mesh.size()
        nbp = device_mesh.pad_rows(nb)
        words, nb = device_mesh.grow_rows(words, nbp, 0), nbp
        placed = _sharded_entry().place(words.view(np.int32))
        device = device_mesh.first_device()
    state["mesh"], state["nb"] = mesh, nb
    if fault_injection.ACTIVE:
        if not device_telemetry.COMPILE_CACHE.seen("sha256_pairs", (nb,), mesh=mesh):
            fault_injection.check("device.compile", op="sha256_pairs")
        fault_injection.check("device.dispatch", op="sha256_pairs")
    t_dispatch = time.perf_counter()
    with on_device(device):
        if mesh:
            dev_out = torch.cat(_sharded_entry().run(_sha256_64byte_batch, placed))
        else:
            dev_out = _sha256_64byte_batch(torch.from_numpy(words.view(np.int32)).to(device))
    dispatch_s = time.perf_counter() - t_dispatch
    stages["dispatch"] = dispatch_s
    if device_telemetry.note_dispatch("sha256_pairs", (nb,), dispatch_s, mesh=mesh):
        state["compiled"] = True
    t_wait = time.perf_counter()
    wait_for(device)
    out = dev_out.cpu().numpy().view(np.uint32)
    stages["wait"] = time.perf_counter() - t_wait
    return out


def hash_pairs_device(data: bytes, device="cuda") -> bytes:
    """Drop-in for ``types.ssz.set_hash_pairs_impl``: hash consecutive
    64-byte blocks on ``device`` (``"cuda"`` by default; ``"cpu"`` runs the
    kernel's plain version), padded to a shape bucket.  Telemetry: the
    dispatch registers in the first-dispatch mirror and the batch's
    block-lane occupancy is accounted (device_telemetry.py).

    Supervised (device_supervisor.py): a failing batch is split-retried
    once; on the card a failure past that raises, on the CPU the host SHA
    kernel answers."""
    from .. import device_supervisor, device_telemetry

    device = resolve_device(device)
    n = len(data) // 64
    if n == 0:
        return b""
    nb = _bucket(n)
    words = _words(data, n, nb)
    # Worker-owned stage dicts, published when the device fn finishes (see
    # verify.py): sharing them with an abandoned watchdog worker would race
    # record_batch's iteration after a dispatch timeout.
    holder: dict = {}

    def device_fn() -> bytes:
        stages_local: dict = {}
        state_local: dict = {}
        try:
            out = _dispatch_batch(words, nb, device, stages_local, state_local)
            return out[:n].astype(">u4").tobytes()
        finally:
            holder["stages"] = stages_local
            holder["state"] = state_local

    def _device_half(chunk: bytes) -> bytes:
        # Raw device path for one half — must NOT recurse into the
        # supervised entry point (the halves already run on the watchdog
        # worker; re-entering run() would submit to the busy worker).
        m = len(chunk) // 64
        nbh = _bucket(m)
        out = _dispatch_batch(_words(chunk, m, nbh), nbh, device, {}, {})
        return out[:m].astype(">u4").tobytes()

    def split_fn():
        mid = n // 2
        if mid == 0:
            raise ValueError("single-block batch cannot split")
        return [
            lambda: _device_half(data[: mid * 64]),
            lambda: _device_half(data[mid * 64: n * 64]),
        ]

    info: dict = {}
    out_bytes = device_supervisor.run(
        "sha256_pairs",
        device_fn,
        host_fn=lambda: _host_hash_pairs(data),
        split_fn=split_fn,
        combine_fn=b"".join,
        info=info,
        host_on_failure=device.type != "cuda",
    )
    reason = info.get("fallback_reason")
    stages: dict = {}
    compiled = False
    mesh, shard_live = 0, None
    if reason != "dispatch_timeout":
        stages = holder.get("stages") or {}
        state = holder.get("state") or {}
        compiled = state.get("compiled", False)
        mesh, nb = state.get("mesh", 0), state.get("nb", nb)
        if mesh:
            shard_live = _sharded_entry().shard_live_counts(n, nb)
    device_telemetry.record_batch(
        op="sha256_pairs",
        shape=(nb,),
        mesh=mesh,
        shard_live=shard_live,
        n_live=n,
        stages=stages or None,
        host_fallback=info.get("route") == "host",
        fallback_reason=reason,
        trace_id=device_telemetry.active_trace_id(),
        compiled=compiled,
        breaker_state=info.get("breaker_state"),
        dispatched=reason != "breaker_open",
    )
    return out_bytes
