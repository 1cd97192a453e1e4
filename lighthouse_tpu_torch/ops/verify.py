"""Batched ``verify_signature_sets`` as one PyTorch program on the Fq kernels.

The counterpart of ``lighthouse_tpu/ops/verify.py``.  The device program
implements the batch-verification equation of the reference's hot loop
(``crypto/bls/src/impls/blst.rs:35-117``):

    e(-g1, sum_i [r_i] sig_i) * prod_i e([r_i] aggpk_i, H(m_i)) == 1

on the device: per-set pubkey aggregation (complete-formula tree sum over a
padded key axis), 64-bit random-weight scalar multiplications on G1 and G2,
the batched Miller loop, one shared final exponentiation.  The host keeps
what the reference keeps on the trusted side: CSPRNG weights (blst.rs:52-57 —
randomness must not come from the device), signature subgroup/infinity
checks, hash-to-curve (SHA-256), shape bucketing.

Shape discipline: batches are padded to (N_BUCKETS, K_BUCKETS) shapes with
identity points + zero weights, which flow through the complete formulas and
masked Miller loop as exact neutral elements.

Edge cases (parity with the host backend):
 - empty batch, missing/out-of-subgroup signature, empty pubkey list -> False on host
 - aggregate pubkey at infinity -> its pair contributes only F_{p^6} factors,
   which the final exponentiation kills (no special-casing needed)
 - weighted-signature-sum W at infinity (adversarially unreachable): detected
   from the returned W_z limbs; the device leg disclaims its verdict with
   ``device_supervisor.HostFallback("w_at_infinity")`` and the host golden
   model decides, counted in
   ``device_batch_host_fallback_total{reason="w_at_infinity"}``.

Execution is supervised (``device_supervisor.py``), in the reference's
stages: :func:`build_device_batch` (host marshalling and upload) and
:func:`execute_built_batch` (dispatch, wait and verdict on the
supervisor's watchdog worker, one split-batch retry, the per-op circuit
breaker, a flight-recorder entry).  On the card a batch whose device leg
fails (and its retry too), hangs past the deadline or meets an OPEN
breaker raises into the caller; with ``device="cpu"`` it resolves on the
host golden model, as in the reference.
``verify_signature_sets_device`` runs the two back to back; the async
pipeline (``device_pipeline.py``) runs them on its own two threads.

**Device mesh** (``device_mesh.py``): while the mesh is on, the batch is
padded to a multiple of the mesh size with the same neutral rows and
split into contiguous row blocks, one per mesh member.  The program does
not split by rows alone — the batch-wide ``(-g1, W)`` pair comes from an
MSM over every set — so it runs in two parts: :func:`_device_verify_shard`
on each member (pubkey sums, the G1 scalar products, the shard's partial
``W_s = sum [r_i] sig_i`` and the Miller-loop product of its rows) and
:func:`_combine_shards` on the mesh's first device (``W = sum W_s``, the
``(-g1, W)`` Miller loop, the product of the shards' Fq12 values and one
final exponentiation).  The set axis buckets against
``autotune.bucket_vocabulary("bls_verify", N_BUCKETS)`` (the static tuple
unless the controller adopted an overlay).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..crypto.bls import curve
from ..crypto.bls.backends import host
from ..crypto.bls.backends.host import _rand_scalars
from ..crypto.bls.hash_to_curve import hash_to_g2
from ..crypto.bls.params import DST
from .. import autotune
from . import ec, pairing, tower
from .devices import on_device, resolve_device, wait_for
from .fq import L16, const

_NEG_G1 = ec.g1_to_limbs((curve.G1[0], -curve.G1[1]))
_G2_GEN_AFF = ec.G2_GEN_LIMBS[:2]

#: Static set-axis and key-axis buckets (the JAX package's vocabulary).
#: Batches larger than the top set bucket chunk through
#: ``MAX_SETS_PER_DISPATCH``-set dispatches.
N_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
K_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
MAX_SETS_PER_DISPATCH = N_BUCKETS[-1]

ENTRY_KEY = "lighthouse_tpu_torch/ops/verify.py:_device_verify"


def _warmup(nb: int) -> None:
    from .compile_cache import aot_warmup_op

    aot_warmup_op("bls_verify", nb)


# Enroll the set-axis vocabulary in the self-tuning control plane
# (autotune.py): live mode may overlay midpoint buckets below the static
# top (N_BUCKETS stays the floor, MAX_SETS_PER_DISPATCH the ceiling) —
# though this ratio-2 vocabulary has no real gaps, so the densify
# heuristic never fires here; the registration keeps a future vocabulary
# edit tunable without re-wiring.
autotune.register_vocabulary(
    "bls_verify", N_BUCKETS, telemetry_ops=("bls_verify",), warmup=_warmup)

#: Seconds of each stage of the last batch through
#: :func:`execute_built_batch` that the device decided: ``build`` (weights,
#: validation, hash-to-curve, limb packing, upload), ``device`` (the device
#: program, to the end of its work on the card), ``verdict`` (the host
#: check of the result).  Written by the calling thread; the flight record
#: (``device_telemetry``) is the per-batch source when batches run
#: concurrently.
LAST_STAGES: dict = {}


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds max bucket {buckets[-1]}")


def _device_verify(pk, sig, msg, wbits, live):
    """The device program.

    pk:   G1 projective, coords (N, K, 25) — per-set key lists, identity-padded
    sig:  G2 projective, coords (N, 2, 25)
    msg:  G2 affine hash points, coords (N, 2, 25)
    wbits:(N, 64) int32, MSB-first random weights (zero rows for padding)
    live: (N,) bool
    Returns (fe, w_z): final-exponentiation output (12-coeff limbs) and the
    Z coordinate of W = sum_i [r_i] sig_i for the host-side infinity check.
    """
    device = wbits.device
    agg = ec.tree_sum(ec.G1_OPS, pk, axis=1)                  # (N,) G1 proj
    p_weighted = ec.scalar_mul_windowed(ec.G1_OPS, agg, wbits)
    w = ec.msm_windowed(ec.G2_OPS, sig, wbits)                # G2 proj

    # W -> affine (zero-divides yield exact 0 limbs, caught by the host check).
    zi = tower.fq2_inv(w[2])
    w_aff = (tower.fq2_mul(w[0], zi), tower.fq2_mul(w[1], zi))

    # Assemble N+1 pairs: ( [r_i]aggpk_i, H_i ) ... ( -g1, W ).
    p1 = tuple(torch.cat([p_weighted[i], const(_NEG_G1[i], device)[None]]) for i in range(3))
    q2 = tuple(torch.cat([msg[i], w_aff[i][None]]) for i in range(2))
    mask = torch.cat([live, torch.ones(1, dtype=torch.bool, device=device)])
    fe = pairing.multi_pairing_fe(p1, q2, mask)
    return fe, w[2]


def _device_verify_shard(pk, sig, msg, wbits, live):
    """One mesh member's part of :func:`_device_verify` over its row block
    (same arguments): its pubkey sums and G1 scalar products, its partial
    ``W_s = sum_i [r_i] sig_i`` (G2 projective) and the Miller-loop product
    of its rows' pairs, no final exponentiation.  Returns ``(w_s, f_s)``."""
    agg = ec.tree_sum(ec.G1_OPS, pk, axis=1)
    p_weighted = ec.scalar_mul_windowed(ec.G1_OPS, agg, wbits)
    w = ec.msm_windowed(ec.G2_OPS, sig, wbits)
    f = pairing.multi_miller_loop(p_weighted, msg, live)
    return w, f


def _combine_shards(parts):
    """The combine of a sharded verify on the mesh's first device:
    ``W = sum_s W_s``, the ``(-g1, W)`` pair's Miller loop, its product
    with every shard's Fq12 value, one final exponentiation.  Returns
    ``(fe, w_z)`` like :func:`_device_verify`.

    Why the verdict does not depend on the mesh size: the shared-
    accumulator Miller loop of N pairs is, as a field element, the product
    of the N pairs' own Miller loops (``f^2 * prod lines`` squares every
    factor alike), so splitting the rows into blocks and multiplying the
    blocks' values gives the same element of F_p^12 for any split; the
    shards' values multiply here in shard order, a fixed order, so a run
    is reproducible limb for limb at a given mesh size.  ``W`` is a sum of
    points, the same point for any split.  The final exponentiation of
    the same element is the same element, so ``fe == 1`` — the verdict —
    and the W-at-infinity check are the unsharded program's."""
    w = parts[0][0]
    for w_s, _ in parts[1:]:
        w = ec.point_add(ec.G2_OPS, w, w_s)
    device = w[2].device
    zi = tower.fq2_inv(w[2])
    w_aff = (tower.fq2_mul(w[0], zi), tower.fq2_mul(w[1], zi))
    p1 = tuple(const(_NEG_G1[i], device)[None] for i in range(3))
    q2 = tuple(x[None] for x in w_aff)
    f = pairing.multi_miller_loop(p1, q2, torch.ones(1, dtype=torch.bool, device=device))
    for _, f_s in parts:
        f = tower.fq12_mul(f, f_s)
    return pairing.final_exponentiation(f), w[2]


#: device_mesh.ShardedEntry for the verifier (lazy: the registry-derived
#: placement lives in device_mesh).
_SHARDED_ENTRY = None


def _sharded_entry():
    global _SHARDED_ENTRY
    if _SHARDED_ENTRY is None:
        from .. import device_mesh

        _SHARDED_ENTRY = device_mesh.ShardedEntry(ENTRY_KEY, _device_verify)
    return _SHARDED_ENTRY


def _pad_host_rows(host_batch: tuple, nbp: int) -> tuple:
    """Grow the batch axis to ``nbp`` rows with the exact neutral padding
    :func:`build_batch` uses (identity points, generator hash slots, zero
    weights, dead ``live`` rows) — the mesh-divisibility pad."""
    from .. import device_mesh

    pk, sig, msg, wbits, live = host_batch
    if nbp == live.shape[0]:
        return host_batch
    id1, id2 = ec.g1_to_limbs(None), ec.g2_to_limbs(None)
    grow = device_mesh.grow_rows
    pk = tuple(grow(pk[c], nbp, id1[c]) for c in range(3))
    sig = tuple(grow(sig[c], nbp, id2[c]) for c in range(3))
    msg = tuple(grow(msg[c], nbp, _G2_GEN_AFF[c]) for c in range(2))
    return pk, sig, msg, grow(wbits, nbp, 0), grow(live, nbp, False)


def place_batch(host_batch: tuple, device) -> tuple:
    """Upload a marshalled host batch.  Mesh on: pad the batch axis to a
    multiple of the mesh size and split it over the members
    (``device_mesh.ShardedEntry.place``).  Mesh off: the tensors on
    ``device``, the pre-mesh path unchanged.  Returns ``(placed,
    mesh_size, topology_generation, rows)`` so a dispatch can detect a
    reshard between placement and execution."""
    from .. import device_mesh

    # Generation snapshotted BEFORE padding/placement: a reshard landing
    # mid-place leaves this batch tagged stale, and it is placed again.
    meshed = device_mesh.enabled()
    gen = device_mesh.generation()
    if meshed:
        nbp = device_mesh.pad_rows(int(host_batch[4].shape[0]))
        placed = _sharded_entry().place(*_pad_host_rows(host_batch, nbp))
        return placed, device_mesh.size(), gen, nbp
    with on_device(device):
        placed = batch_from_numpy(host_batch, device)
    return placed, 0, gen, int(host_batch[4].shape[0])


def _run_placed(placed, mesh: int):
    """The device program on a placed batch: ``(fe, w_z)``."""
    if mesh:
        return _combine_shards(_sharded_entry().run(_device_verify_shard, placed))
    return _device_verify(*placed)


# ----------------------------------------------------------------- host side

_hash_cache: dict = {}


def _hash_to_g2_cached(message: bytes):
    key = bytes(message)
    pt = _hash_cache.get(key)
    if pt is None:
        pt = hash_to_g2(key, DST)
        if len(_hash_cache) > 4096:
            _hash_cache.clear()
        _hash_cache[key] = pt
    return pt


def build_batch(sets, rands) -> Optional[tuple]:
    """Validate + marshal signature sets into padded HOST arrays (numpy,
    bucket-shaped): ``(pk ×3 (N,K,25), sig ×3 (N,2,25), msg ×2 (N,2,25),
    wbits (N,64), live (N,))``, the same arrays as the JAX package's
    ``build_batch``.

    Returns None if host-side validation already decides False.
    """
    n = len(sets)
    # The set axis buckets against the live vocabulary (static N_BUCKETS
    # plus any controller-adopted overlay buckets); the key axis stays
    # static.
    nb = _bucket(n, autotune.bucket_vocabulary("bls_verify", N_BUCKETS))
    kb = _bucket(max(len(s.signing_keys) for s in sets), K_BUCKETS)

    pk = [np.zeros((nb, kb, L16), np.int32) for _ in range(3)]
    sig = [np.zeros((nb, 2, L16), np.int32) for _ in range(3)]
    msg = [np.zeros((nb, 2, L16), np.int32) for _ in range(2)]
    wbits = np.zeros((nb, 64), np.int32)
    live = np.zeros((nb,), bool)

    id1 = ec.g1_to_limbs(None)
    id2 = ec.g2_to_limbs(None)
    for c in range(3):
        pk[c][:] = id1[c]
        sig[c][:] = id2[c]
    for c in range(2):
        msg[c][:] = _G2_GEN_AFF[c]

    for i, (s, r) in enumerate(zip(sets, rands)):
        sig_pt = s.signature.point
        if sig_pt is None or not curve.in_g2(sig_pt):
            return None
        if not s.signing_keys:
            return None
        sl = ec.g2_to_limbs(sig_pt)
        h = _hash_to_g2_cached(s.message)
        for c in range(3):
            sig[c][i] = sl[c]
        msg[0][i] = tower.fq2_to_limbs(h[0])
        msg[1][i] = tower.fq2_to_limbs(h[1])
        for j, key in enumerate(s.signing_keys):
            kl = ec.g1_to_limbs(key.point)
            for c in range(3):
                pk[c][i, j] = kl[c]
        wbits[i] = ec.bits_msb(r, 64)
        live[i] = True

    return tuple(pk), tuple(sig), tuple(msg), wbits, live


def batch_from_numpy(host_batch: tuple, device) -> tuple:
    """A marshalled host batch (this module's or the JAX package's
    ``build_batch`` output) as tensors on ``device``, in the argument order
    of :func:`_device_verify`."""
    device = resolve_device(device)
    pk, sig, msg, wbits, live = host_batch

    def up(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    return (
        tuple(up(a, torch.int32) for a in pk),
        tuple(up(a, torch.int32) for a in sig),
        tuple(up(a, torch.int32) for a in msg),
        up(wbits, torch.int32),
        up(live, torch.bool),
    )


def _device_batch_verdict(built: "BuiltBatch", stages: dict, state: dict) -> bool:
    """Dispatch + wait + verdict for one marshalled batch.

    Runs on the supervisor's watchdog worker thread (the caller's trace
    context is re-attached there), so a hung device strands the worker,
    never the caller.  Raises ``device_supervisor.HostFallback(
    "w_at_infinity")`` when the device disclaims its own Miller value — the
    supervisor then re-verifies on the host through the one shared
    fallback path.
    """
    from .. import device_supervisor, device_telemetry, fault_injection, metrics, tracing

    built.ensure_placed()  # a reshard since placement re-pads + re-uploads
    nb, kb, mesh = built.nb, built.kb, built.mesh
    device = built.result_device()
    state["mesh"], state["nb"] = mesh, nb
    with on_device(device):
        if fault_injection.ACTIVE:
            if not device_telemetry.COMPILE_CACHE.seen("bls_verify", (nb, kb), mesh=mesh):
                fault_injection.check("device.compile", op="bls_verify")
            fault_injection.check("device.dispatch", op="bls_verify")
        with tracing.span(
            "device_batch_dispatch", hist=metrics.DEVICE_DISPATCH_SECONDS,
            n_bucket=nb, k_bucket=kb, mesh=mesh,
        ) as sp_dispatch:
            fe, w_z = _run_placed(built.batch, mesh)
        # The first dispatch of a shape (and of the process: the kernel
        # build) pays its one-time costs inside the call itself.
        if device_telemetry.note_dispatch("bls_verify", (nb, kb), sp_dispatch.duration,
                                          mesh=mesh):
            sp_dispatch.fields["compiled"] = True
            state["compiled"] = True
        stages["dispatch"] = sp_dispatch.duration
        with tracing.span(
            "device_batch_wait", hist=metrics.DEVICE_BLOCK_UNTIL_READY_SECONDS,
            n_bucket=nb, k_bucket=kb,
        ) as sp_wait:
            wait_for(device)
        stages["wait"] = sp_wait.duration
        with tracing.span(
            "device_batch_verdict", hist=metrics.DEVICE_VERDICT_SECONDS
        ) as sp_verdict:
            try:
                if tower.fq2_from_limbs(w_z).is_zero():
                    # W at infinity: the Miller value is poisoned; decide on
                    # the host — via the supervisor, so every fallback
                    # reason shares one mechanism and one counter.
                    sp_verdict.fields["host_fallback"] = True
                    raise device_supervisor.HostFallback("w_at_infinity")
                ok = pairing.fe_is_one(fe)
                if (
                    fault_injection.ACTIVE
                    and fault_injection.fire("device.result", op="bls_verify")
                    == "corrupt"
                ):
                    tracing.annotate(corrupted_verdict=True)
                    ok = False
            finally:
                stages["verdict"] = sp_verdict.duration
    return ok


def _device_verify_subset(subset, seed: Optional[bytes], device: torch.device) -> bool:
    """One half of a split-batch retry: the raw device path at the half's
    own bucket shape.  No stage spans (the parent batch's flight record
    carries the split outcome); the dispatch still registers in the
    first-dispatch mirror — a half bucket can be a first-seen shape."""
    from .. import device_supervisor, device_telemetry, fault_injection

    host_batch = build_batch(subset, _rand_scalars(len(subset), seed))
    if host_batch is None:
        return False
    kb = int(host_batch[0][0].shape[1])
    batch, mesh, _, nb = place_batch(host_batch, device)
    device = _result_device(mesh, device)
    with on_device(device):
        if fault_injection.ACTIVE:
            fault_injection.check("device.dispatch", op="bls_verify")
        t0 = time.perf_counter()
        fe, w_z = _run_placed(batch, mesh)
        device_telemetry.note_dispatch("bls_verify", (nb, kb), time.perf_counter() - t0,
                                       mesh=mesh)
        wait_for(device)
    if tower.fq2_from_limbs(w_z).is_zero():
        raise device_supervisor.HostFallback("w_at_infinity")
    return pairing.fe_is_one(fe)


class BuiltBatch:
    """A marshalled batch between the build and dispatch stages.

    The two stages are separately callable so the async device pipeline
    (``device_pipeline.py``) can overlap the host build of batch N+1 (its
    builder thread calls :func:`build_device_batch`) with the device stage
    of batch N (its executor thread calls :func:`execute_built_batch`).
    ``verify_signature_sets_device`` is the two stages run back to back —
    the direct, non-pipelined path."""

    __slots__ = ("sets", "seed", "device", "host", "batch", "nb", "kb", "mesh",
                 "generation", "live_keys", "setup_s")

    def __init__(self, sets, seed, device: torch.device, host_batch, setup_s: float):
        self.sets = sets
        self.seed = seed
        self.device = device
        # The host arrays stay beside the placed ones: a mesh reshard
        # between build and dispatch invalidates the placement, and
        # ensure_placed() re-pads and re-uploads from them.
        self.host = host_batch
        self.batch, self.mesh, self.generation, self.nb = place_batch(host_batch, device)
        self.kb = int(host_batch[0][0].shape[1])
        self.live_keys = sum(len(s.signing_keys) for s in sets)
        self.setup_s = setup_s

    def ensure_placed(self) -> None:
        """Place again after any topology change since the last placement
        (mesh enabled, disabled or re-sharded: each moves the generation)."""
        from .. import device_mesh

        if device_mesh.generation() != self.generation:
            self.batch, self.mesh, self.generation, self.nb = place_batch(
                self.host, self.device)

    def result_device(self) -> torch.device:
        """Where the program's outputs land: the mesh's first device while
        the batch is sharded, else the batch's device."""
        return _result_device(self.mesh, self.device)


def _result_device(mesh: int, device: torch.device) -> torch.device:
    from .. import device_mesh

    return (device_mesh.first_device() or device) if mesh else device


def build_device_batch(sets, seed: Optional[bytes] = None,
                       device="cuda") -> Optional[BuiltBatch]:
    """Stage 1 — host-side marshalling (validation, hash-to-curve, limb
    packing) into padded arrays, uploaded to ``device``.  Returns None when
    host-side validation already decides False (bad/missing signature,
    empty key list).  Safe to call from any thread; no device work happens
    here beyond the uploads."""
    from .. import metrics, tracing

    device = resolve_device(device)
    sets = list(sets)
    if not sets or len(sets) > MAX_SETS_PER_DISPATCH:
        raise ValueError(
            f"build_device_batch takes 1..{MAX_SETS_PER_DISPATCH} sets, "
            f"got {len(sets)}"
        )
    with tracing.span(
        "device_batch_setup", hist=metrics.DEVICE_BATCH_SETUP_SECONDS,
        n_sets=len(sets),
    ) as sp_setup:
        host_batch = build_batch(sets, _rand_scalars(len(sets), seed))
        if host_batch is None:
            return None
        # The upload is part of the build stage, so the pipeline overlaps
        # it with the in-flight batch like the rest of setup.
        built = BuiltBatch(sets, seed, device, host_batch, 0.0)
    built.setup_s = sp_setup.duration
    return built


def execute_built_batch(built: BuiltBatch, *, n_groups: int = 1,
                        work_mix: Optional[dict] = None) -> bool:
    """Stage 2 — supervised dispatch + wait + verdict for a built batch.

    Runs under the device supervisor (watchdog, one split-batch retry, the
    per-op circuit breaker) and records the batch in the flight recorder.
    On the card a device failure raises (``DispatchTimeout``,
    ``RequeueWork`` for an OPEN breaker, else the device's own error);
    on the CPU it resolves on the host golden model.  ``n_groups``/``work_mix`` attribute
    a pipeline-coalesced batch's composition in the flight record."""
    from .. import device_supervisor, device_telemetry, tracing

    sets, seed, device = built.sets, built.seed, built.device
    LAST_STAGES.clear()
    stages = {"setup": built.setup_s}
    # The watchdog worker writes stage durations into dicts IT owns and
    # publishes them via this one-slot holder when the device leg finishes.
    # The caller merges only when the worker completed (never on a dispatch
    # timeout, where the abandoned worker may still be writing).
    holder: dict = {}

    def device_fn():
        stages_local: dict = {}
        state_local = {"compiled": False}
        try:
            return _device_batch_verdict(built, stages_local, state_local)
        finally:
            holder["stages"] = stages_local
            holder["state"] = state_local

    def split_fn():
        mid = len(sets) // 2
        if mid == 0:
            raise ValueError("single-set batch cannot split")
        return [
            lambda: _device_verify_subset(sets[:mid], seed, device),
            lambda: _device_verify_subset(sets[mid:], seed, device),
        ]

    info: dict = {}
    ok = device_supervisor.run(
        "bls_verify",
        device_fn,
        host_fn=lambda: host.verify_signature_sets(sets, seed=seed),
        split_fn=split_fn,
        combine_fn=all,
        info=info,
        host_on_failure=device.type != "cuda",
    )
    host_fallback = info.get("route") == "host"
    reason = info.get("fallback_reason")
    compiled = False
    mesh, nb = built.mesh, built.nb
    if reason != "dispatch_timeout":
        stages.update(holder.get("stages") or {})
        state = holder.get("state") or {}
        compiled = state.get("compiled", False)
        mesh, nb = state.get("mesh", mesh), state.get("nb", nb)
    if not host_fallback and "split_retry" not in info:
        LAST_STAGES.update(
            build=stages["setup"],
            device=stages.get("dispatch", 0.0) + stages.get("wait", 0.0),
            verdict=stages.get("verdict", 0.0),
        )
    shard_live = None
    if mesh:
        shard_live = _sharded_entry().shard_live_counts(len(sets), nb)
    rec = device_telemetry.record_batch(
        op="bls_verify",
        shape=(nb, built.kb),
        n_live=len(sets),
        live_keys=built.live_keys,
        n_groups=n_groups,
        work_mix=work_mix,
        stages=stages,
        verdict=ok,
        host_fallback=host_fallback,
        fallback_reason=reason,
        trace_id=device_telemetry.active_trace_id(),
        compiled=compiled,
        breaker_state=info.get("breaker_state"),
        # breaker-OPEN batches never reached the device: keep them out of
        # the occupancy/wasted-lane tuning data.
        dispatched=reason != "breaker_open",
        mesh=mesh,
        shard_live=shard_live,
    )
    # Reverse link: the enclosing span (device_verify when routed through
    # the backend) carries the flight-recorder seq of this batch.
    tracing.annotate(flight_seq=rec["seq"])
    if host_fallback:
        tracing.annotate(host_fallback=True)
    return ok


def verify_signature_sets_device(sets, seed: Optional[bytes] = None,
                                 device="cuda") -> bool:
    """Batch verifier running the device program on ``device`` (default
    ``"cuda"``; ``"cpu"`` runs the kernels' plain versions), the build and
    dispatch stages back to back on the calling thread, supervised.
    Asking for CUDA where there is none raises (a caller's error, not a
    device failure)."""
    device = resolve_device(device)
    sets = list(sets)
    if not sets:
        return False
    if len(sets) > MAX_SETS_PER_DISPATCH:
        # Oversized batches chunk through the top bucket: each chunk is an
        # independently supervised dispatch, verdicts AND together.  Each
        # chunk is its own batch-verification equation, so the shared seed
        # is harmless.
        return all(
            verify_signature_sets_device(
                sets[i:i + MAX_SETS_PER_DISPATCH], seed=seed, device=device
            )
            for i in range(0, len(sets), MAX_SETS_PER_DISPATCH)
        )
    built = build_device_batch(sets, seed=seed, device=device)
    if built is None:
        return False
    return execute_built_batch(built)
