# A frozen copy of lighthouse_tpu_torch/crypto/bls/pairing.py, the benchmark's plain
# reference: the yardstick stays as it is when the program changes.  Do not edit.
"""Optimal-ate pairing on BLS12-381 (host golden model).

Semantics match the multi-pairing used by the reference's batch verifier
(``crypto/bls/src/impls/blst.rs:112-114`` — blst's
``verify_multiple_aggregate_signatures``): accumulate Miller-loop values for many
(G1, G2) pairs, one shared final exponentiation, compare against 1.

The Miller loop runs on the untwisted curve E(Fp12) with affine line functions —
slow but transparently correct; the TPU kernel (``lighthouse_tpu/ops``) implements
the optimised projective/sparse version and is validated against this module.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .curve import Point, add, double, embed_g1, untwist
from .fields import Fq12
from .params import X_ABS

_X_BITS = bin(X_ABS)[3:]  # bits of |x| below the leading 1


def _line(t: Point, q: Point, p: Point) -> Fq12:
    """Evaluate the line through t and q at p (all on E(Fp12), affine)."""
    xt, yt = t
    xq, yq = q
    xp, yp = p
    if xt != xq:
        m = (yq - yt) * (xq - xt).inv()
        return yp - yt - m * (xp - xt)
    if yt == yq:
        # tangent
        m = (xt * xt + xt * xt + xt * xt) * (yt + yt).inv()
        return yp - yt - m * (xp - xt)
    # vertical
    return xp - xt


def miller_loop(p: Point, q: Point) -> Fq12:
    """f_{|x|,Q}(P) with the end-of-loop conjugation for the negative BLS x.

    p is a G1 point embedded in Fp12, q a G2 point untwisted into Fp12.
    Returns 1 for either input at infinity.
    """
    if p is None or q is None:
        return Fq12.one()
    f = Fq12.one()
    t = q
    for bit in _X_BITS:
        f = f.square() * _line(t, t, p)
        t = double(t)
        if bit == "1":
            f = f * _line(t, q, p)
            t = add(t, q)
    # x < 0: invert; cheap inversion via conjugation is only valid post easy part,
    # so use the honest inverse here (reference model).
    return f.inv()


def _pow_x(g: Fq12) -> Fq12:
    """g^x for the (negative) BLS parameter x, for g in the cyclotomic subgroup."""
    r = Fq12.one()
    b = g
    e = X_ABS
    while e:
        if e & 1:
            r = r * b
        b = b.square()
        e >>= 1
    return r.conj()  # x negative; conj == inverse on the cyclotomic subgroup


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p^12-1)/r · 3).

    Easy part (p^6-1)(p^2+1), then the hard part scaled by 3 via the
    Hayashida–Hayasaka–Teruya decomposition
        3·(p^4-p^2+1)/r = (x-1)^2·(x+p)·(x^2+p^2-1) + 3
    (identity asserted in tests).  The extra cube is harmless for every use here:
    the framework only ever compares pairing products against 1, and gcd(3, r) = 1.
    """
    f = f.conj() * f.inv()          # ^(p^6 - 1); result is unitary
    f = f.frobenius_n(2) * f        # ^(p^2 + 1); now in the cyclotomic subgroup
    t0 = _pow_x(f) * f.conj()               # f^(x-1)
    t1 = _pow_x(t0) * t0.conj()             # ^(x-1) again
    t2 = _pow_x(t1) * t1.frobenius()        # ^(x+p)
    t3 = _pow_x(_pow_x(t2)) * t2.frobenius_n(2) * t2.conj()  # ^(x^2+p^2-1)
    return t3 * f * f * f                   # · f^3


def pairing(p: Point, q: Point) -> Fq12:
    """e(P, Q)^3 for P in G1(Fp), Q in G2(Fp2).  (Constant cube — see above.)"""
    return final_exponentiation(miller_loop(embed_g1(p), untwist(q)))


def multi_pairing_is_one(pairs: Sequence[Tuple[Point, Point]]) -> bool:
    """prod_i e(P_i, Q_i) == 1, with a single shared final exponentiation.

    This is the host-reference analog of blst's batched
    ``verify_multiple_aggregate_signatures`` multi-pairing check.
    """
    f = Fq12.one()
    for p, q in pairs:
        f = f * miller_loop(embed_g1(p), untwist(q))
    return final_exponentiation(f).is_one()
