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
   from the returned W_z limbs and decided on the host golden model — part of
   the verification algorithm, counted in ``COUNTERS["w_z_rechecks"]``.
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
from . import ec, pairing, tower
from .fq import L16, const

_NEG_G1 = ec.g1_to_limbs((curve.G1[0], -curve.G1[1]))
_G2_GEN_AFF = ec.G2_GEN_LIMBS[:2]

#: Static set-axis and key-axis buckets (the JAX package's vocabulary).
#: Batches larger than the top set bucket chunk through
#: ``MAX_SETS_PER_DISPATCH``-set dispatches.
N_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
K_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
MAX_SETS_PER_DISPATCH = N_BUCKETS[-1]

#: ``w_z_rechecks``: batches whose W was at infinity and were decided on the
#: host golden model.
COUNTERS = {"w_z_rechecks": 0}

#: Seconds of each stage of the last batch through
#: :func:`verify_signature_sets_device`: ``build`` (weights, validation,
#: hash-to-curve, limb packing), ``device`` (upload + device program, to the
#: end of its work on the card), ``verdict`` (the host check of the result).
LAST_STAGES: dict = {}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


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
    nb = _bucket(n, N_BUCKETS)
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


def verify_signature_sets_device(sets, seed: Optional[bytes] = None,
                                 device="cuda") -> bool:
    """Batch verifier running the device program on ``device`` (default
    ``"cuda"``; ``"cpu"`` runs the kernels' plain versions).  Asking for
    CUDA where there is none raises."""
    device = resolve_device(device)
    sets = list(sets)
    if not sets:
        return False
    if len(sets) > MAX_SETS_PER_DISPATCH:
        # Oversized batches chunk through the top bucket; verdicts AND
        # together.  Each chunk is its own batch-verification equation, so
        # the shared seed is harmless.
        return all(
            verify_signature_sets_device(
                sets[i:i + MAX_SETS_PER_DISPATCH], seed=seed, device=device
            )
            for i in range(0, len(sets), MAX_SETS_PER_DISPATCH)
        )
    LAST_STAGES.clear()
    t0 = time.perf_counter()
    host_batch = build_batch(sets, _rand_scalars(len(sets), seed))
    t1 = time.perf_counter()
    LAST_STAGES["build"] = t1 - t0
    if host_batch is None:
        return False
    fe, w_z = _device_verify(*batch_from_numpy(host_batch, device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    LAST_STAGES["device"] = t2 - t1
    if tower.fq2_from_limbs(w_z).is_zero():
        # W at infinity: the Miller value is poisoned; decide on the host.
        COUNTERS["w_z_rechecks"] += 1
        ok = host.verify_signature_sets(sets, seed=seed)
    else:
        ok = pairing.fe_is_one(fe)
    LAST_STAGES["verdict"] = time.perf_counter() - t2
    return ok
