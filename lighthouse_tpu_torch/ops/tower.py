"""Extension-field tower Fq2/Fq6/Fq12 over int32 limb tensors (PyTorch).

The counterpart of ``lighthouse_tpu/ops/tower.py``, formula for formula, so
every limb equals the JAX package's.  Tower: Fp2 = Fp[u]/(u^2+1),
Fp6 = Fp2[v]/(v^3 - (1+u)), Fp12 = Fp6[w]/(w^2 - v).

Shapes (trailing dims; leading batch dims broadcast):
    Fq  : (..., 25)
    Fq2 : (..., 2, 25)
    Fq6 : (..., 3, 2, 25)
    Fq12: (..., 2, 3, 2, 25)

``fq2_mul`` is one launch of the fused Fq2 Karatsuba kernel on a CUDA tensor;
``fq2_many`` stacks every independent Fq2 product of a step into one launch
of the Fq kernel.  Sub-multiplications of the higher levels are stacked onto
one axis before a single ``fq2_mul``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..crypto.bls import fields as hf
from . import cuda_fq
from .fq import (
    FQ_ONE,
    FQ_ZERO,
    L16,
    const,
    fq_inv,
    fq_mul,
    fq_mul_many,
    from_limbs16,
    to_limbs16,
    to_numpy,
)

# ----------------------------------------------------------------------- Fq2


def fq2_mul(a, b):
    """Karatsuba (3 base products and the recombination) in one launch of
    the Fq2 kernel."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    out = cuda_fq.fq2_mul(a.reshape(-1, 2, L16).contiguous(),
                          b.reshape(-1, 2, L16).contiguous())
    return out.reshape(shape)


def fq2_conj(a):
    return torch.stack([a[..., 0, :], -a[..., 1, :]], dim=-2)


def fq2_mul_by_xi(a):
    """Multiply by xi = 1 + u."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([a0 - a1, a0 + a1], dim=-2)


def fq2_mul_small(a, k: int):
    return a * k


def fq2_many(muls: Sequence[Tuple] = (), squares: Sequence = ()):
    """All the round's independent Fq2 products in ONE Fq-kernel launch.

    Each mul contributes its 3 Karatsuba sub-products, each square its 2
    (the cheaper ``(a0+a1)(a0-a1) / 2·a0·a1`` form); the flattened operand
    rows ride one launch.  Returns ``(mul_results, square_results)`` —
    bit-identical to per-call products of the same rows.
    """
    if not muls and not squares:
        return [], []
    plan = []  # (kind, stacked shape)
    lhs_parts, rhs_parts = [], []

    def emit(kind, l, r):
        plan.append((kind, l.shape))
        lhs_parts.append(l.reshape(-1, l.shape[-1]))
        rhs_parts.append(r.reshape(-1, r.shape[-1]))

    for a, b in muls:
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        emit("mul",
             torch.stack([a0, a1, a0 + a1], dim=-2),
             torch.stack([b0, b1, b0 + b1], dim=-2))
    for x in squares:
        x0, x1 = x[..., 0, :], x[..., 1, :]
        emit("square",
             torch.stack([x0 + x1, x0], dim=-2),
             torch.stack([x0 - x1, x1 + x1], dim=-2))

    out = fq_mul(torch.cat(lhs_parts), torch.cat(rhs_parts))
    mul_out, sq_out = [], []
    off = 0
    for kind, shape in plan:
        n = int(np.prod(shape[:-1], dtype=np.int64))
        t = out[off:off + n].reshape(shape)
        off += n
        if kind == "mul":
            t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
            mul_out.append(torch.stack([t0 - t1, t2 - t0 - t1], dim=-2))
        else:
            sq_out.append(t)
    return mul_out, sq_out


def fq2_mul_fq_many(pairs: Sequence[Tuple]) -> List:
    """Independent Fq2 x Fq products (one Fq launch, no Karatsuba — the
    scalar broadcasts over the pair axis, 2 base muls each)."""
    return fq_mul_many([(a, s[..., None, :]) for a, s in pairs])


def fq2_inv(a):
    """conj(a) / norm(a); one base-field inversion."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    sq = torch.stack([a0, a1], dim=-2)
    t = fq_mul(sq, sq)
    d = fq_inv(t[..., 0, :] + t[..., 1, :])
    return fq_mul(torch.stack([a0, -a1], dim=-2), d[..., None, :])


# ----------------------------------------------------------------------- Fq6


def _fq6_parts(a):
    return a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]


def fq6_mul(a, b):
    """Toom-style 6-mul schedule, mirroring fields.Fq6.__mul__; one fq2_mul call."""
    a0, a1, a2 = _fq6_parts(a)
    b0, b1, b2 = _fq6_parts(b)
    lhs = torch.stack([a0, a1, a2, a1 + a2, a0 + a1, a0 + a2], dim=-3)
    rhs = torch.stack([b0, b1, b2, b1 + b2, b0 + b1, b0 + b2], dim=-3)
    t = fq2_mul(lhs, rhs)
    t0, t1, t2 = t[..., 0, :, :], t[..., 1, :, :], t[..., 2, :, :]
    s12, s01, s02 = t[..., 3, :, :], t[..., 4, :, :], t[..., 5, :, :]
    c0 = t0 + fq2_mul_by_xi(s12 - t1 - t2)
    c1 = s01 - t0 - t1 + fq2_mul_by_xi(t2)
    c2 = s02 - t0 - t2 + t1
    return torch.stack([c0, c1, c2], dim=-3)


def fq6_mul_by_v(a):
    a0, a1, a2 = _fq6_parts(a)
    return torch.stack([fq2_mul_by_xi(a2), a0, a1], dim=-3)


def fq6_mul_fq2(a, s):
    return fq2_mul(a, s[..., None, :, :])


def fq6_inv(a):
    """fields.Fq6.inv formulas; one fq2 inversion."""
    a0, a1, a2 = _fq6_parts(a)
    t = fq2_mul(
        torch.stack([a0, a2, a1, a1, a0, a0], dim=-3),
        torch.stack([a0, a2, a1, a2, a1, a2], dim=-3),
    )
    sq0, sq2, sq1 = t[..., 0, :, :], t[..., 1, :, :], t[..., 2, :, :]
    p12, p01, p02 = t[..., 3, :, :], t[..., 4, :, :], t[..., 5, :, :]
    c0 = sq0 - fq2_mul_by_xi(p12)
    c1 = fq2_mul_by_xi(sq2) - p01
    c2 = sq1 - p02
    c = torch.stack([c0, c1, c2], dim=-3)
    prods = fq2_mul(torch.stack([a0, a2, a1], dim=-3), c)
    t = fq2_inv(
        prods[..., 0, :, :] + fq2_mul_by_xi(prods[..., 1, :, :] + prods[..., 2, :, :])
    )
    return fq6_mul_fq2(c, t)


# ----------------------------------------------------------------------- Fq12


def fq12_parts(a):
    return a[..., 0, :, :, :], a[..., 1, :, :, :]


def fq12_mul(a, b):
    a0, a1 = fq12_parts(a)
    b0, b1 = fq12_parts(b)
    t = fq6_mul(
        torch.stack([a0, a1, a0 + a1], dim=-4),
        torch.stack([b0, b1, b0 + b1], dim=-4),
    )
    t0, t1, t2 = t[..., 0, :, :, :], t[..., 1, :, :, :], t[..., 2, :, :, :]
    return torch.stack([t0 + fq6_mul_by_v(t1), t2 - t0 - t1], dim=-4)


def fq12_square(a):
    """Complex squaring over the w-quadratic: (a0 + a1 w)^2 =
    (a0^2 + v a1^2) + 2 a0 a1 w, via 2 fq6 muls instead of fq12_mul's 3:
    t0 = a0 a1;  t1 = (a0 + a1)(a0 + v a1) = a0^2 + v a1^2 + (1 + v) t0."""
    a0, a1 = fq12_parts(a)
    t = fq6_mul(
        torch.stack([a0, a0 + a1], dim=-4),
        torch.stack([a1, a0 + fq6_mul_by_v(a1)], dim=-4),
    )
    t0 = t[..., 0, :, :, :]
    t1 = t[..., 1, :, :, :]
    c0 = t1 - t0 - fq6_mul_by_v(t0)
    return torch.stack([c0, t0 + t0], dim=-4)


def fq12_conj(a):
    a0, a1 = fq12_parts(a)
    return torch.stack([a0, -a1], dim=-4)


def fq12_inv(a):
    a0, a1 = fq12_parts(a)
    pair = torch.stack([a0, a1], dim=-4)
    sq = fq6_mul(pair, pair)
    t = fq6_inv(sq[..., 0, :, :, :] - fq6_mul_by_v(sq[..., 1, :, :, :]))
    return torch.stack([fq6_mul(a0, t), -fq6_mul(a1, t)], dim=-4)


# ---------------------------------------------------------------- Frobenius

def _fq2_const(x: hf.Fq2) -> np.ndarray:
    return np.stack([to_limbs16(x.c0), to_limbs16(x.c1)])


# gamma_i = xi^(i*(p-1)/6) as limb constants, from the host golden model,
# in the order fq12_frobenius multiplies them: (2, 4, 1, 3, 5).
_GAMMA_FROB = np.stack([_fq2_const(hf.GAMMA[i]) for i in (2, 4, 1, 3, 5)])  # (5, 2, 25)


def fq12_frobenius(a):
    """x -> x^p, mirroring fields.Fq12.frobenius."""
    a0, a1 = fq12_parts(a)
    a00, a01, a02 = _fq6_parts(a0)
    a10, a11, a12 = _fq6_parts(a1)
    lhs = torch.stack(
        [fq2_conj(a01), fq2_conj(a02), fq2_conj(a10), fq2_conj(a11), fq2_conj(a12)],
        dim=-3,
    )
    t = fq2_mul(lhs, const(_GAMMA_FROB, lhs.device))
    c0 = torch.stack([fq2_conj(a00), t[..., 0, :, :], t[..., 1, :, :]], dim=-3)
    c1 = torch.stack([t[..., 2, :, :], t[..., 3, :, :], t[..., 4, :, :]], dim=-3)
    return torch.stack([c0, c1], dim=-4)


def fq12_frobenius_n(a, n: int):
    for _ in range(n % 12):
        a = fq12_frobenius(a)
    return a


# ------------------------------------------------------------ host conversion

FQ2_ZERO = np.stack([FQ_ZERO, FQ_ZERO])
FQ2_ONE = np.stack([FQ_ONE, FQ_ZERO])
FQ6_ZERO = np.stack([FQ2_ZERO] * 3)
FQ6_ONE = np.stack([FQ2_ONE, FQ2_ZERO, FQ2_ZERO])
FQ12_ONE = np.stack([FQ6_ONE, FQ6_ZERO])


def fq2_to_limbs(x: hf.Fq2) -> np.ndarray:
    return _fq2_const(x)


def fq2_from_limbs(arr) -> hf.Fq2:
    a = to_numpy(arr)
    return hf.Fq2(from_limbs16(a[..., 0, :]), from_limbs16(a[..., 1, :]))


def fq6_from_limbs(arr) -> hf.Fq6:
    a = to_numpy(arr)
    return hf.Fq6(*(fq2_from_limbs(a[i]) for i in range(3)))


def fq12_from_limbs(arr) -> hf.Fq12:
    a = to_numpy(arr)
    return hf.Fq12(fq6_from_limbs(a[0]), fq6_from_limbs(a[1]))
