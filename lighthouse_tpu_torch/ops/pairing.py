"""Batched optimal-ate multi-pairing, inversion-free Miller loop (PyTorch).

The counterpart of ``lighthouse_tpu/ops/pairing.py``: projective Miller loop
on the twist with denominator elimination over the 63 bits of |x| below the
leading one, and one shared final exponentiation.  The JAX package's
``lax.scan`` over those constant bits becomes a host loop, and its
``lax.cond`` on a bit becomes a host branch (the bits are constants, so the
values are the same).

G1 arguments are *projective* — the line value is scaled by Z_P, which lies
in Fp and is erased by the final exponentiation.  G2 infinity must be masked
by the caller (``mask``): a Z=0 twist point collapses the accumulator to zero.
"""

from __future__ import annotations

import torch

from ..crypto.bls.params import X_ABS
from . import tower as tw
from .fq import const
from .tower import (
    FQ12_ONE,
    fq2_mul,
    fq2_mul_by_xi,
    fq2_mul_small,
    fq12_conj,
    fq12_frobenius,
    fq12_frobenius_n,
    fq12_inv,
    fq12_mul,
    fq12_square,
)

# Miller schedule: bits of |x| below the leading one, MSB first (63 steps).
X_BITS = [int(b) for b in bin(X_ABS)[3:]]
# pow_x schedule: bits of |x|, LSB first (64 steps).
X_BITS_LSB = [(X_ABS >> i) & 1 for i in range(X_ABS.bit_length())]


def _proj_dbl(t):
    """Twist-point doubling + eliminated-denominator line
    (host_projective.proj_dbl): 16 Fq2 products in THREE fused launches."""
    x, y, z = t
    (xy, s), (xx, y2, zz) = tw.fq2_many([(x, y), (y, z)], [x, y, z])
    w3 = fq2_mul_small(xx, 3)
    (b, ys, yzz, xx3x, xxz, y2_2z), (w3sq, s2) = tw.fq2_many(
        [(xy, s), (y, s), (y, zz), (xx, fq2_mul_small(x, 3)), (xx, z),
         (y2, fq2_mul_small(z, 2))],
        [w3, s],
    )
    h = w3sq - fq2_mul_small(b, 8)
    (hs, tt, s3), (y2s2,) = tw.fq2_many(
        [(h, s), (w3, fq2_mul_small(b, 4) - h), (s2, s)], [ys]
    )
    x3 = fq2_mul_small(hs, 2)
    y3 = tt - fq2_mul_small(y2s2, 8)
    z3 = fq2_mul_small(s3, 8)

    l00 = fq2_mul_by_xi(fq2_mul_small(yzz, 2))
    l1v = -(y2_2z - xx3x)
    l1vv = -fq2_mul_small(xxz, 3)
    return (x3, y3, z3), (l00, l1v, l1vv)


def _proj_add_mixed(t, q):
    """Mixed addition + line (host_projective.proj_add_mixed) — 14 Fq2
    products in FOUR fused launches."""
    x, y, z = t
    xq, yq = q
    (yqz, xqz), _ = tw.fq2_many([(yq, z), (xq, z)])
    e = yqz - y
    f = xqz - x
    (yqf, exq), (ff, ee) = tw.fq2_many([(yq, f), (e, xq)], [f, e])
    (fff, eez, ffx, ffs), _ = tw.fq2_many(
        [(f, ff), (ee, z), (ff, x), (ff, x + xqz)]
    )
    t1 = eez - ffs
    (x3, et, fffy, z3), _ = tw.fq2_many(
        [(f, t1), (e, ffx - t1), (fff, y), (z, fff)]
    )
    y3 = et - fffy

    l00 = fq2_mul_by_xi(f)
    l1v = -(yqf - exq)
    l1vv = -e
    return (x3, y3, z3), (l00, l1v, l1vv)


def _sparse_to_fq12(a, b1, b2):
    """Expand sparse line coefficients (a, b1, b2) — the Fq12 element
    (a + 0 v + 0 v^2) + (0 + b1 v + b2 v^2) w — to a full Fq12 element."""
    zero = torch.zeros_like(a)
    c0 = torch.stack([a, zero, zero], dim=-3)
    c1 = torch.stack([zero, b1, b2], dim=-3)
    return torch.stack([c0, c1], dim=-4)


def _line_fq12(line, p1):
    """Sparse line scaled by the projective G1 coords, as a full Fq12:
    l = (L00*Y_P) + w*( (L1v*Z_P)*v + (L1vv*X_P)*v^2 )."""
    l00, l1v, l1vv = line
    xp, yp, zp = p1
    a, b1, b2 = tw.fq2_mul_fq_many([(l00, yp), (l1v, zp), (l1vv, xp)])
    return _sparse_to_fq12(a, b1, b2)


def _twist_start(q2):
    xq, yq = q2
    return (xq, yq, const(tw.FQ2_ONE, xq.device).expand(xq.shape))


def miller_loop(p1, q2):
    """f_{|x|,Q}(P) for batched projective G1 p1=(X,Y,Z) and affine twist q2=(x,y).

    Returns batched Fq12 (leading dims = broadcast of input batch dims).
    The mixed-addition step runs on the 5 set bits of the 63."""
    t = _twist_start(q2)
    batch = torch.broadcast_shapes(p1[0].shape[:-1], q2[0].shape[:-2])
    f = const(FQ12_ONE, q2[0].device).expand(tuple(batch) + FQ12_ONE.shape)
    for bit in X_BITS:
        t, line = _proj_dbl(t)
        f = fq12_mul(fq12_square(f), _line_fq12(line, p1))
        if bit:
            t, line_a = _proj_add_mixed(t, q2)
            f = fq12_mul(f, _line_fq12(line_a, p1))
    return f


def _pow_x(g):
    """g^|x| then conjugate (x < 0), for g in the cyclotomic subgroup; the
    multiply runs on the 6 set bits of the 64."""
    r = const(FQ12_ONE, g.device).expand(g.shape)
    b = g
    for bit in X_BITS_LSB:
        if bit:
            r = fq12_mul(r, b)
        b = fq12_square(b)
    return fq12_conj(r)


def final_exponentiation(f):
    """Mirror of the golden model's f^((p^12-1)/r * 3) (crypto/bls/pairing.py)."""
    f = fq12_mul(fq12_conj(f), fq12_inv(f))        # ^(p^6 - 1)
    f = fq12_mul(fq12_frobenius_n(f, 2), f)        # ^(p^2 + 1)
    t0 = fq12_mul(_pow_x(f), fq12_conj(f))
    t1 = fq12_mul(_pow_x(t0), fq12_conj(t0))
    t2 = fq12_mul(_pow_x(t1), fq12_frobenius(t1))
    t3 = fq12_mul(fq12_mul(_pow_x(_pow_x(t2)), fq12_frobenius_n(t2, 2)), fq12_conj(t2))
    f3 = fq12_mul(fq12_mul(f, f), f)
    return fq12_mul(t3, f3)


def fq12_product_any(fs, axis: int = 0):
    """Multiplicative tree-reduce along a batch axis, any length >= 1.

    Odd tails are set aside and folded back at the end — no neutral-element
    padding muls."""
    n = fs.shape[axis]
    extra = None
    while n > 1:
        if n % 2:
            last = fs.narrow(axis, n - 1, 1)
            extra = last if extra is None else fq12_mul(extra, last)
            n -= 1
            fs = fs.narrow(axis, 0, n)
        half = n // 2
        fs = fq12_mul(fs.narrow(axis, 0, half), fs.narrow(axis, half, half))
        n = half
    if extra is not None:
        fs = fq12_mul(fs, extra)
    return fs.squeeze(axis)


# ------------------------------------------------- sparse-line multi-pairing


def _sparse_line_coeffs(line, p1, mask):
    """Scale a raw line by the projective G1 coords and mask dead pairs to 1."""
    l00, l1v, l1vv = line
    xp, yp, zp = p1
    a, b1, b2 = tw.fq2_mul_fq_many([(l00, yp), (l1v, zp), (l1vv, xp)])
    m = mask.reshape(mask.shape + (1, 1))
    one = const(tw.FQ2_ONE, a.device).expand(a.shape)
    zero = torch.zeros_like(b1)
    return torch.where(m, a, one), torch.where(m, b1, zero), torch.where(m, b2, zero)


def _sparse_pair_mul(x, y):
    """Product of two sparse lines -> full Fq12, 9 fq2 muls (vs 18 general).

    (A + B w)(C + D w) = (AC + v BD) + (AD + CB) w with A=(a,0,0), B=(0,b1,b2):
        c0 = (ac + xi*b1d1,  xi*(b1d2 + b2d1),  xi*b2d2)
        c1 = (0,  a d1 + c b1,  a d2 + c b2)
    """
    a, b1, b2 = x
    c, d1, d2 = y
    lhs = torch.stack([a, b1, b1, b2, b2, a, c, a, c], dim=-3)
    rhs = torch.stack([c, d1, d2, d1, d2, d1, b1, d2, b2], dim=-3)
    p = fq2_mul(lhs, rhs)
    p0, p1_, p2, p3, p4 = (p[..., i, :, :] for i in range(5))
    p5, p6, p7, p8 = (p[..., i, :, :] for i in range(5, 9))
    zero = torch.zeros_like(p0)
    c0 = torch.stack(
        [p0 + fq2_mul_by_xi(p1_), fq2_mul_by_xi(p2 + p3), fq2_mul_by_xi(p4)], dim=-3
    )
    c1 = torch.stack([zero, p5 + p6, p7 + p8], dim=-3)
    return torch.stack([c0, c1], dim=-4)


def _lines_product(a, b1, b2):
    """Product of N sparse lines (leading axis) -> one full Fq12.

    First level pairs sparse x sparse (half-cost); upper levels are a general
    tree product with no padding waste."""
    n = a.shape[0]
    if n == 1:
        return _sparse_to_fq12(a, b1, b2).squeeze(0)
    h = n // 2
    lo = (a[:h], b1[:h], b2[:h])
    hi = (a[h: 2 * h], b1[h: 2 * h], b2[h: 2 * h])
    prod = _sparse_pair_mul(lo, hi)
    if n % 2:
        prod = torch.cat([prod, _sparse_to_fq12(a[-1:], b1[-1:], b2[-1:])], dim=0)
    return fq12_product_any(prod)


def multi_pairing_fe(p1, q2, mask):
    """FE(prod_i f_i) over the leading pair axis, with per-pair live mask.

    p1: projective G1, coords (N, 25); q2: affine twist, coords (N, 2, 25);
    mask: (N,) bool — False pairs contribute the neutral element (required
    for G2 infinity, used for padding).

    Shared accumulator: the T points and line computations stay batched per
    pair, but the Fq12 accumulator is ONE element — per step,
    f = f^2 * prod_i line_i."""
    return final_exponentiation(multi_miller_loop(p1, q2, mask))


def multi_miller_loop(p1, q2, mask):
    """prod_i f_i, the Miller-loop product of :func:`multi_pairing_fe`
    before its final exponentiation (same arguments).  As an element of
    F_p^12 it is the product of the pairs' own Miller loops, so the
    products of disjoint sets of pairs multiply to the product over their
    union (the sharded verify's combine relies on it)."""
    t = _twist_start(q2)
    f = const(FQ12_ONE, q2[0].device)

    def fold_lines(f, line):
        a, b1, b2 = _sparse_line_coeffs(line, p1, mask)
        return fq12_mul(f, _lines_product(a, b1, b2))

    for bit in X_BITS:
        t, line = _proj_dbl(t)
        f = fold_lines(fq12_square(f), line)
        if bit:
            t, line_a = _proj_add_mixed(t, q2)
            f = fold_lines(f, line_a)
    return f


# ------------------------------------------------------------ host-side check


def fe_is_one(fe_limbs) -> bool:
    """Exact host check that a final-exponentiation output equals 1."""
    return tw.fq12_from_limbs(fe_limbs).is_one()
