"""Batched blob-KZG-proof verification as one PyTorch program on the Fq kernels.

The counterpart of ``lighthouse_tpu/ops/kzg_device.py``: the Deneb
data-availability hot path (reference
``beacon_node/beacon_chain/src/kzg_utils.rs:23-36`` ->
``c_kzg::KzgProof::verify_blob_kzg_proof_batch``).  The random-linear-
combination MSMs (three N-point G1 scalar multiplications and their
tree-sums, one generator multiplication) and the final 2-pairing run as one
program on the device, batched over the blob axis; the Deneb target shape
is 6 blobs x 32 blocks = 192 lanes.

Host responsibilities (the trusted side, as in ``ops/verify.py``):
Fiat-Shamir challenges, polynomial evaluation over the blob field elements,
byte parsing and subgroup checks, and the exact ``fe == 1`` verdict.

Verification equation (``crypto/kzg/kzg.py:_verify_kzg_proof_batch_host``,
the host golden model this program must agree with):

    e(sum_i [r_i] P_i, [tau]G2) * e(-(sum_i [r_i](C_i - [y_i]G1 + [z_i]P_i)), G2) == 1

Supervised like the BLS entry point (``device_supervisor.run("kzg_batch",
...)``): the marshalling, dispatch and the ``fe == 1`` check run on the
watchdog worker, and a hung or failing device resolves through the
caller's ``host_fn`` (``Kzg``'s host MSM path).  ``kzg_batch`` reduces over
the blob axis, so it never splits.

**Device mesh** (``device_mesh.py``): while the mesh is on, the blob axis
pads to a multiple of the mesh size with identity points and zero scalars
(exact neutral contributions) and splits into row blocks; each member
computes its three partial lincombs (:func:`_kzg_shard`), and
:func:`_kzg_combine` adds them on the mesh's first device before the one
pairing check — the same points, so the same verdict, for any mesh size.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from ..crypto.bls.params import R
from . import ec, pairing, tower
from .fq import const
from .devices import on_device, resolve_device, wait_for

#: Blob-axis buckets (the JAX package's vocabulary); larger batches raise.
N_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)

#: Seconds of each stage of the last batch through
#: :func:`verify_kzg_proof_batch_device`: ``build`` (limb packing and
#: scalar bits on the host), ``device`` (upload + device program, to the end
#: of its work on the card), ``verdict`` (the host check of ``fe``).
LAST_STAGES: dict = {}


def _device_kzg_batch(c, p, r_bits, rz_bits, ry_bits, tau, g2gen):
    """The device program.

    c, p: G1 projective coords (N, 25) x3 (commitments, proofs);
    r_bits, rz_bits: (N, 256) int32 MSB-first scalars (r_i, r_i*z_i mod R);
    ry_bits: (256,), sum_i r_i*y_i mod R; tau, g2gen: affine twist (2, 25) x2.
    Returns the final-exponentiation output limbs (the host checks == 1).

    The JAX package runs four scalar multiplications ([r_i]C_i, [r_i]P_i,
    [r_i z_i]P_i, [sum r_i y_i]G1) and three tree-sums; every step of both
    is row-wise, so here their rows are stacked into one 3N+1-row scalar
    multiplication and one tree-sum over a (3, N) batch, which gives the
    same limbs with a quarter of the host loop's steps.
    """
    n = r_bits.shape[0]
    gen = tuple(const(x, r_bits.device)[None] for x in ec.G1_GEN_LIMBS)
    pts = tuple(torch.cat([ci, pi, pi, gi]) for ci, pi, gi in zip(c, p, gen))
    bits = torch.cat([r_bits, r_bits, rz_bits, ry_bits[None]])
    prod = ec.scalar_mul_bits(ec.G1_OPS, pts, bits)
    lincombs = ec.tree_sum(ec.G1_OPS, tuple(x[: 3 * n].reshape(3, n, -1) for x in prod),
                           axis=1)
    return _kzg_pairing(lincombs, tuple(x[3 * n] for x in prod), tau, g2gen)


def _kzg_pairing(lincombs, gen_ry, tau, g2gen):
    """The program's one 2-pairing from the three lincombs (a G1 point
    batch of 3: ``sum [r_i]C_i``, ``sum [r_i]P_i``, ``sum [r_i z_i]P_i``)
    and ``[sum r_i y_i]G1``: the final-exponentiation limbs."""
    c_lincomb, proof_lincomb, pz_lincomb = (tuple(x[i] for x in lincombs) for i in range(3))
    rhs = ec.point_add(
        ec.G1_OPS,
        ec.point_add(ec.G1_OPS, c_lincomb, ec.point_neg(gen_ry)),
        pz_lincomb,
    )
    p1 = tuple(torch.stack([a, b]) for a, b in zip(proof_lincomb, ec.point_neg(rhs)))
    q2 = tuple(torch.stack([a, b]) for a, b in zip(tau, g2gen))
    mask = torch.ones(2, dtype=torch.bool, device=gen_ry[0].device)
    return pairing.multi_pairing_fe(p1, q2, mask)


def _kzg_shard(c, p, r_bits, rz_bits, ry_bits, tau, g2gen):
    """One mesh member's part of :func:`_device_kzg_batch` over its row
    block (same arguments; the replicated ones are read by the combine):
    the three partial lincombs ``sum [r_i]C_i``, ``sum [r_i]P_i`` and
    ``sum [r_i z_i]P_i`` of its rows, as one G1 point batch of 3."""
    n = r_bits.shape[0]
    pts = tuple(torch.cat([ci, pi, pi]) for ci, pi in zip(c, p))
    bits = torch.cat([r_bits, r_bits, rz_bits])
    prod = ec.scalar_mul_bits(ec.G1_OPS, pts, bits)
    return ec.tree_sum(ec.G1_OPS, tuple(x.reshape(3, n, -1) for x in prod), axis=1)


def _kzg_combine(parts, ry_bits, tau, g2gen):
    """The combine of a sharded KZG batch on the mesh's first device: the
    shards' partial lincombs added in shard order (a sum of points: the
    unsharded lincombs for any split), ``[sum r_i y_i]G1``, and the
    program's one 2-pairing.  Returns the final-exponentiation limbs."""
    acc = parts[0]
    for part in parts[1:]:
        acc = ec.point_add(ec.G1_OPS, acc, part)
    gen = tuple(const(x, ry_bits.device)[None] for x in ec.G1_GEN_LIMBS)
    gen_ry = tuple(x[0] for x in ec.scalar_mul_bits(ec.G1_OPS, gen, ry_bits[None]))
    return _kzg_pairing(acc, gen_ry, tau, g2gen)


ENTRY_KEY = "lighthouse_tpu_torch/ops/kzg_device.py:_device_kzg_batch"

#: device_mesh.ShardedEntry for the KZG program (lazy).
_SHARDED_ENTRY = None


def _sharded_entry():
    global _SHARDED_ENTRY
    if _SHARDED_ENTRY is None:
        from .. import device_mesh

        _SHARDED_ENTRY = device_mesh.ShardedEntry(ENTRY_KEY, _device_kzg_batch)
    return _SHARDED_ENTRY


def _run_sharded(host_batch: tuple):
    """The sharded program on a mesh-padded host batch: the shards'
    lincombs, combined on the mesh's first device (``fe`` there)."""
    from .. import device_mesh

    def i32(a):
        return tuple(i32(x) for x in a) if isinstance(a, tuple) else np.asarray(a, np.int32)

    entry = _sharded_entry()
    placed = entry.place(*(i32(a) for a in host_batch))
    parts = entry.run(_kzg_shard, placed)
    # the replicated arguments, as every shard holds them, on the first device
    ry_bits, tau, g2gen = placed[0][4:]
    first = device_mesh.first_device()
    return _kzg_combine(parts, ry_bits.to(first), tuple(x.to(first) for x in tau),
                        tuple(x.to(first) for x in g2gen))


def _bucket(n: int) -> int:
    for b in N_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"kzg batch of {n} exceeds max bucket {N_BUCKETS[-1]}")


def _build_kzg_batch(c_pts, p_pts, r_powers, zs, ys, g2_tau, nb: int) -> tuple:
    """Host-side marshalling (limb packing, scalar-bit expansion) into
    padded numpy arrays, in the argument order of :func:`_device_kzg_batch`:
    ``(c ×3 (nb,25), p ×3 (nb,25), r_bits (nb,256), rz_bits (nb,256),
    ry_bits (256,), tau ×2 (2,25), g2gen ×2 (2,25))``, the same arrays as the
    JAX package's.  Pad rows are identity points with zero scalars."""
    n = len(c_pts)
    id1 = ec.g1_to_limbs(None)
    c = [np.tile(x, (nb, 1)) for x in id1]
    p = [np.tile(x, (nb, 1)) for x in id1]
    r_bits = np.zeros((nb, 256), np.int32)
    rz_bits = np.zeros((nb, 256), np.int32)
    ry = 0
    for i in range(n):
        cl = ec.g1_to_limbs(c_pts[i])
        pl = ec.g1_to_limbs(p_pts[i])
        for coord in range(3):
            c[coord][i] = cl[coord]
            p[coord][i] = pl[coord]
        r_bits[i] = ec.bits_msb(r_powers[i] % R, 256)
        rz_bits[i] = ec.bits_msb(r_powers[i] * zs[i] % R, 256)
        ry = (ry + r_powers[i] * ys[i]) % R
    tau = (tower.fq2_to_limbs(g2_tau[0]), tower.fq2_to_limbs(g2_tau[1]))
    return (tuple(c), tuple(p), r_bits, rz_bits, ec.bits_msb(ry, 256), tau,
            tuple(ec.G2_GEN_LIMBS[:2]))


def batch_from_numpy(host_batch: tuple, device) -> tuple:
    """A marshalled host batch (this module's or the JAX package's
    ``_build_kzg_batch`` arrays) as int32 tensors on ``device``, in the
    argument order of :func:`_device_kzg_batch`."""
    device = resolve_device(device)

    def up(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=torch.int32)

    return tuple(tuple(up(x) for x in a) if isinstance(a, tuple) else up(a)
                 for a in host_batch)


def verify_kzg_proof_batch_device(
    c_pts: Sequence, p_pts: Sequence, r_powers: Sequence[int],
    zs: Sequence[int], ys: Sequence[int], g2_tau, device="cuda",
    host_fn=None,
) -> bool:
    """Run the device program on parsed host points and scalars, under the
    device supervisor.

    ``c_pts``/``p_pts``: host affine G1 (Fq pairs, or None for infinity);
    ``g2_tau``: host Fq2 affine point ([tau]G2 from the trusted setup).
    ``device`` defaults to ``"cuda"``; ``"cpu"`` runs the kernels' plain
    versions.  Asking for CUDA where there is none raises.  On the card a
    hung or failing device leg (or an OPEN ``kzg_batch`` breaker) raises
    into the caller; off the card it resolves through ``host_fn``, the
    golden model, where one is given (with ``host_fn=None`` failures
    propagate there too)."""
    from .. import device_mesh, device_supervisor, device_telemetry, fault_injection

    device = resolve_device(device)
    n = len(c_pts)
    if not n == len(p_pts) == len(r_powers) == len(zs) == len(ys):
        raise ValueError("kzg batch: argument lengths differ")
    nb = _bucket(max(1, n))
    holder: dict = {}

    def device_fn() -> bool:
        stages_local: dict = {}
        state_local: dict = {}
        try:
            # Marshalling and upload happen INSIDE the supervised leg: an
            # OPEN breaker must not touch the device at all, and an upload
            # raising on a dead device resolves through the host fallback
            # like any other device failure.  The mesh pad is computed
            # here too, so a supervisor reshard retry places under the
            # surviving topology.
            mesh = device_mesh.size() if device_mesh.enabled() else 0
            nbm = device_mesh.pad_rows(nb) if mesh else nb
            dev = device_mesh.first_device() if mesh else device
            state_local["mesh"], state_local["nb"] = mesh, nbm
            with on_device(dev):
                t0 = time.perf_counter()
                host_batch = _build_kzg_batch(c_pts, p_pts, r_powers, zs, ys, g2_tau, nbm)
                if not mesh:
                    batch = batch_from_numpy(host_batch, device)
                stages_local["setup"] = time.perf_counter() - t0
                if fault_injection.ACTIVE:
                    if not device_telemetry.COMPILE_CACHE.seen("kzg_batch", (nbm,), mesh=mesh):
                        fault_injection.check("device.compile", op="kzg_batch")
                    fault_injection.check("device.dispatch", op="kzg_batch")
                t0 = time.perf_counter()
                fe = _run_sharded(host_batch) if mesh else _device_kzg_batch(*batch)
                stages_local["dispatch"] = time.perf_counter() - t0
                if device_telemetry.note_dispatch("kzg_batch", (nbm,), stages_local["dispatch"],
                                                  mesh=mesh):
                    state_local["compiled"] = True
                t0 = time.perf_counter()
                wait_for(dev)
                stages_local["wait"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ok = pairing.fe_is_one(fe)
            stages_local["verdict"] = time.perf_counter() - t0
            return ok
        finally:
            holder["stages"] = stages_local
            holder["state"] = state_local

    LAST_STAGES.clear()
    info: dict = {}
    ok = device_supervisor.run("kzg_batch", device_fn, host_fn=host_fn, info=info,
                               host_on_failure=device.type != "cuda")
    reason = info.get("fallback_reason")
    stages: dict = {}
    state: dict = {}
    if reason != "dispatch_timeout":
        stages = holder.get("stages") or {}
        state = holder.get("state") or {}
    mesh, nb = state.get("mesh", 0), state.get("nb", nb)
    shard_live = _sharded_entry().shard_live_counts(n, nb) if mesh else None
    host_fallback = info.get("route") == "host"
    if not host_fallback:
        LAST_STAGES.update(
            build=stages["setup"],
            device=stages["dispatch"] + stages["wait"],
            verdict=stages["verdict"],
        )
    device_telemetry.record_batch(
        op="kzg_batch",
        shape=(nb,),
        mesh=mesh,
        shard_live=shard_live,
        n_live=n,
        stages=stages or None,
        verdict=bool(ok),
        host_fallback=host_fallback,
        fallback_reason=reason,
        trace_id=device_telemetry.active_trace_id(),
        compiled=state.get("compiled", False),
        breaker_state=info.get("breaker_state"),
        dispatched=reason != "breaker_open",
    )
    return bool(ok)
