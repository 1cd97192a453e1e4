"""Kernel build cache.

The port of ``lighthouse_tpu/ops/compile_cache.py``.  The JAX package
points jax's persistent XLA cache at a directory and compiles its standard
buckets ahead of time.  The port's device programs are eager PyTorch, so
there is no per-bucket program to compile: what is built once is the CUDA
kernel libraries.  :func:`build_kernels` runs ``nvcc`` for sm_90a on every
source of ``KERNEL_SOURCES`` at once, one process per source
(``ops/cuda_build.py``; libraries in ``lighthouse_tpu_torch/build/``, keyed
by each source's hash), and notes each build in the device-telemetry
mirror through ``device_telemetry.note_warmup`` as its own entry: a
**hit** when an up-to-date library was found, a **miss** when ``nvcc``
ran.  ``cuda_fq.library``, ``cuda_sha.library`` and ``cuda_epoch.library``
build through here on first use, so the first kernel any of them needs
builds all three.

The bucket warmup the autotune controller's adoption gate needs is here
(:func:`aot_warmup_op`): one supervised dispatch of a neutral batch of an
op at a bucket, on the node's device, checked against the result a
neutral batch must give, and noted in the telemetry mirror.  So is the
JAX package's opt-in warmup of the standard verifier buckets at boot
(:func:`maybe_warmup_from_env`, ``LIGHTHOUSE_TPU_AOT_WARMUP``, ``bn
--aot-warmup``; the buckets from ``LIGHTHOUSE_TPU_AOT_BUCKETS``, else
:data:`DEFAULT_WARMUP_BUCKETS`): the port compiles no program, so a warm
bucket is one neutral ``bls_verify`` dispatch through
:func:`aot_warmup_op`, and what it takes off the request path is the
first dispatch's extra cost.  Its records (outcome ``miss``: this was the
bucket's first dispatch; ``hit``: the bucket was warm already;
``error``) feed ``GET /lighthouse/device`` before the first batch.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cuda_build import CSRC_DIR, build

#: Every CUDA source of the port (``csrc/``), by library name, with its
#: entry in the device-telemetry mirror.
KERNEL_SOURCES = {
    "fq_mul": (CSRC_DIR / "fq_mul.cu", "cuda_fq_build"),
    "sha256": (CSRC_DIR / "sha256.cu", "cuda_sha_build"),
    "shuffle": (CSRC_DIR / "shuffle.cu", "cuda_epoch_build"),
}


def build_kernels(force: bool = False) -> dict:
    """Build (or find) every kernel library, all ``nvcc`` runs started
    together, and note each outcome in the device-telemetry mirror; returns
    ``{name: cuda_build.BuildResult}``.  Raises if any build fails."""
    from .. import device_telemetry

    with ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:
        futures = {name: pool.submit(build, source, force)
                   for name, (source, _) in KERNEL_SOURCES.items()}
        results = {name: f.result() for name, f in futures.items()}
    for name, res in results.items():
        device_telemetry.note_warmup(KERNEL_SOURCES[name][1], (), res.seconds,
                                     hit=res.seconds == 0.0)
    return results


# ------------------------------------------------------------ bucket warmup

#: The device the warmups dispatch on: the node's (``configure``; the card
#: by default, ``"cpu"`` for the kernels' plain versions).
_WARMUP_DEVICE = "cuda"


def configure(device=None) -> None:
    """Point the bucket warmups at the node's device."""
    global _WARMUP_DEVICE
    if device is not None:
        from .devices import resolve_device

        _WARMUP_DEVICE = str(resolve_device(device))


def reset_for_tests() -> None:
    global _WARMUP_DEVICE
    _WARMUP_DEVICE = "cuda"


def _neutral_bls(nb: int, device, keys: int = 32) -> dict:
    """``_device_verify`` on an all-padding batch at ``nb`` sets x ``keys``
    keys: every weight is zero, so ``W`` is the point at infinity (its Z
    limbs zero) — the one result a neutral batch may give."""
    from . import ec, tower, verify

    id1, id2 = ec.g1_to_limbs(None), ec.g2_to_limbs(None)
    pk = tuple(np.broadcast_to(id1[c], (nb, keys, id1[c].shape[-1])).copy() for c in range(3))
    sig = tuple(np.broadcast_to(id2[c], (nb,) + id2[c].shape).copy() for c in range(3))
    msg = tuple(np.broadcast_to(verify._G2_GEN_AFF[c], (nb,) + verify._G2_GEN_AFF[c].shape
                                ).copy() for c in range(2))
    host = (pk, sig, msg, np.zeros((nb, 64), np.int32), np.zeros((nb,), bool))
    _, w_z = verify._device_verify(*verify.batch_from_numpy(host, device))
    if not tower.fq2_from_limbs(w_z.cpu()).is_zero():
        raise RuntimeError(f"bls_verify warmup at {nb}: W of a neutral batch is not infinity")
    return {"shape": (nb, keys)}


def _neutral_sha(nb: int, device) -> dict:
    """``_sha256_64byte_batch`` on ``nb`` zero blocks: every row the
    SHA-256 of 64 zero bytes."""
    from .sha256_device import _sha256_64byte_batch

    out = _sha256_64byte_batch(torch.zeros((nb, 16), dtype=torch.int32, device=device))
    want = np.frombuffer(hashlib.sha256(bytes(64)).digest(), dtype=">u4").astype(np.uint32)
    got = out.cpu().numpy().view(np.uint32)
    if got.shape != (nb, 8) or not (got == want).all():
        raise RuntimeError(f"sha256_pairs warmup at {nb}: wrong digest of a zero block")
    return {"shape": (nb,)}


_EPOCH_SCALARS = dict(previous_epoch=1, base_reward_per_increment=1,
                      total_active_balance=32 * 10**9, increment=10**9,
                      inactivity_score_bias=4, inactivity_score_recovery_rate=16,
                      quotient=1 << 24)


def _neutral_deltas(nb: int, device, in_leak: bool) -> None:
    """``_deltas_kernel`` on ``nb`` never-active pad rows: every delta and
    every inactivity score zero."""
    from .epoch_device import _PAD_FILLS, _deltas_kernel

    dtypes = (torch.int64,) * 4 + (torch.bool,) + (torch.int64,) * 2
    rows = [torch.full((nb,), f, dtype=d, device=device) for f, d in zip(_PAD_FILLS, dtypes)]
    inactivity, delta = _deltas_kernel(*rows, *_EPOCH_SCALARS.values(), in_leak=in_leak)
    if bool(inactivity.any()) or bool(delta.any()):
        raise RuntimeError(f"epoch_deltas warmup at {nb}: a pad row moved")


def _neutral_epoch(nb: int, device) -> dict:
    _neutral_deltas(nb, device, False)
    _neutral_deltas(nb, device, True)
    return {"shape": (nb,)}


def _neutral_shuffle(nb: int, device) -> dict:
    """``_shuffle_kernel`` over 90 rounds with no live lane: the identity."""
    from .shuffle_device import _chunk_count, _shuffle_kernel

    values = torch.arange(nb, dtype=torch.int32, device=device)
    pivots = torch.zeros(90, dtype=torch.int32, device=device)
    digests = torch.zeros((90, _chunk_count(nb) * 32), dtype=torch.uint8, device=device)
    out = _shuffle_kernel(values, pivots, digests, 0)
    if not torch.equal(out, values):
        raise RuntimeError(f"shuffle warmup at {nb}: a pad lane moved")
    return {"shape": (nb,)}


def _neutral_proposer(nb: int, device) -> dict:
    """``_proposer_kernel`` over ``nb`` zero effective balances with every
    acceptance byte 255: no candidate can be accepted."""
    from .shuffle_device import PROPOSER_CANDIDATES, _proposer_kernel

    seed_words = torch.zeros((32, 8), dtype=torch.int32, device=device)
    pivots = torch.zeros((32, 90), dtype=torch.int32, device=device)
    rbytes = torch.full((32, PROPOSER_CANDIDATES), 255, dtype=torch.int32, device=device)
    eff = torch.zeros(nb, dtype=torch.int64, device=device)
    pos, found = _proposer_kernel(seed_words, pivots, rbytes, eff, nb, 32 * 10**9)
    if bool(found.any()) or bool((pos != -1).any()):
        raise RuntimeError(f"proposer_select warmup at {nb}: a zero balance was accepted")
    return {"shape": (nb,)}


def _neutral_boundary(nb: int, device) -> dict:
    """The fused boundary's parts at ``nb`` (its deltas pass in both leak
    modes, a round-free shuffle, the walk's acceptance): each on neutral
    rows, each with its neutral result."""
    _neutral_epoch(nb, device)
    _neutral_shuffle(nb, device)
    _neutral_proposer(nb, device)
    return {"shape": (nb,)}


#: op -> (the supervised op its dispatch runs under, the neutral dispatch)
_NEUTRAL = {
    "bls_verify": ("bls_verify", _neutral_bls),
    "sha256_pairs": ("sha256_pairs", _neutral_sha),
    "epoch_deltas": ("epoch_deltas", _neutral_epoch),
    "shuffle": ("shuffle", _neutral_shuffle),
    "proposer_select": ("proposer_select", _neutral_proposer),
    "epoch_boundary": ("epoch_boundary", _neutral_boundary),
}


def aot_warmup_op(op: str, nb: int, device=None, keys: Optional[int] = None) -> List[dict]:
    """Warm ``op``'s bucket ``nb`` off the request path — the autotune
    controller's adoption prerequisite: one supervised dispatch
    (``device_supervisor.run``, on the card with ``host_on_failure=False``)
    of a neutral batch on the node's device, whose result must be the one
    a neutral batch gives (else this raises), noted in the telemetry
    mirror (``device_telemetry.note_warmup``: the first production
    dispatch at the bucket is then not counted as its first).  ``keys``:
    the key bucket of a ``bls_verify`` warmup (32 when None)."""
    from .. import device_supervisor, device_telemetry
    from ..logs import get_logger
    from .devices import on_device, resolve_device, wait_for

    if op not in _NEUTRAL:
        raise ValueError(f"no warmup for op {op!r}")
    if keys is not None and op != "bls_verify":
        raise ValueError(f"{op} has no key bucket")
    supervised_op, neutral = _NEUTRAL[op]
    dev = resolve_device(device if device is not None else _WARMUP_DEVICE)
    nb = int(nb)
    extra = {} if keys is None else {"keys": int(keys)}

    def run() -> dict:
        with on_device(dev):
            out = neutral(nb, dev, **extra)
            wait_for(dev)
        return out

    t0 = time.perf_counter()
    out = device_supervisor.run(supervised_op, run, host_on_failure=dev.type != "cuda")
    seconds = time.perf_counter() - t0
    device_telemetry.note_warmup(op, out["shape"], seconds, hit=False)
    record = {"op": op, "shape": "x".join(str(s) for s in out["shape"]),
              "seconds": round(seconds, 6), "outcome": "ok", "device": str(dev)}
    get_logger("compile_cache").info("bucket warmup", **record)
    return [record]


# ------------------------------------------------- standard buckets at boot

AOT_WARMUP_ENV = "LIGHTHOUSE_TPU_AOT_WARMUP"
AOT_BUCKETS_ENV = "LIGHTHOUSE_TPU_AOT_BUCKETS"

#: The standard verifier buckets warmed by default: the headline 128 x 32
#: and the 4,096-set top bucket (``ops/verify.py`` ``N_BUCKETS[-1]``).
DEFAULT_WARMUP_BUCKETS: Tuple[Tuple[int, int], ...] = ((128, 32), (4096, 32))


def _env_buckets() -> Optional[List[Tuple[int, int]]]:
    """Parse ``LIGHTHOUSE_TPU_AOT_BUCKETS`` ("128x32,4096x32"; case-insensitive
    separator, empty parts skipped).  Raises ValueError naming the variable on
    garbage — callers decide whether to fall back."""
    raw = os.environ.get(AOT_BUCKETS_ENV, "").strip()
    if not raw:
        return None
    buckets = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        nb, _, kb = part.lower().partition("x")
        try:
            bucket = (int(nb), int(kb))
        except ValueError:
            raise ValueError(
                f"{AOT_BUCKETS_ENV}={raw!r}: expected e.g. \"128x32,4096x32\""
            ) from None
        buckets.append(bucket)
    return buckets or None


def warmup_standard_buckets(
    buckets: Optional[Sequence[Tuple[int, int]]] = None,
) -> List[dict]:
    """Warm the standard verifier buckets on the node's device
    (:func:`configure`), one neutral supervised ``bls_verify`` dispatch each
    (:func:`aot_warmup_op`); returns per-bucket records ``{"op", "shape",
    "seconds", "outcome"}``, outcome ``miss`` (the bucket's first
    dispatch), ``hit`` (it was warm already) or ``error``.  Off the card an
    error is recorded and the next bucket warmed; on the card it is logged
    and raised (a warmup never stands in for an answer).

    The mirror entries (``device_telemetry.note_warmup``) show the warmed
    buckets in ``GET /lighthouse/device`` before the first batch."""
    from .. import device_telemetry
    from ..logs import get_logger
    from .devices import resolve_device

    log = get_logger("compile_cache")
    dev = resolve_device(_WARMUP_DEVICE)
    if buckets is None:
        try:
            buckets = _env_buckets()
        except ValueError as e:
            # A bad env list must neither kill the warmup thread nor
            # silently disable the warmup the operator asked for: log loud,
            # warm the defaults.
            log.warning("warmup bucket list invalid, warming defaults", error=str(e))
            buckets = None
        buckets = buckets or list(DEFAULT_WARMUP_BUCKETS)
    results: List[dict] = []
    for nb, kb in buckets:
        nb, kb = int(nb), int(kb)
        warm = device_telemetry.COMPILE_CACHE.seen("bls_verify", (nb, kb))
        t0 = time.perf_counter()
        try:
            aot_warmup_op("bls_verify", nb, device=dev, keys=kb)
        except Exception as e:
            record = {"op": "bls_verify", "shape": f"{nb}x{kb}",
                      "seconds": round(time.perf_counter() - t0, 6), "outcome": "error",
                      "error": f"{type(e).__name__}: {e}", "device": str(dev)}
            log.error("bucket warmup failed", **record)
            if dev.type == "cuda":
                raise
            results.append(record)
            continue
        results.append({"op": "bls_verify", "shape": f"{nb}x{kb}",
                        "seconds": round(time.perf_counter() - t0, 6),
                        "outcome": "hit" if warm else "miss", "device": str(dev)})
    return results


def maybe_warmup_from_env(*, background: bool = True) -> Optional[threading.Thread]:
    """Startup hook: run :func:`warmup_standard_buckets` iff
    ``LIGHTHOUSE_TPU_AOT_WARMUP`` is truthy.  Background by default, so node
    startup never waits on it; returns the thread (None when disabled or
    run inline)."""
    if os.environ.get(AOT_WARMUP_ENV, "").strip().lower() not in ("1", "true", "yes"):
        return None
    if not background:
        warmup_standard_buckets()
        return None
    thread = threading.Thread(target=warmup_standard_buckets, name="aot-warmup", daemon=True)
    thread.start()
    return thread
