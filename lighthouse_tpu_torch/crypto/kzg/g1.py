"""Fast host-side G1 arithmetic over plain integers (Jacobian coordinates)
plus a Pippenger multi-scalar multiplication.

The KZG hot operations (`blob_to_kzg_commitment`, proof computation, batch
lin-combs) are G1 MSMs over the 4096-point Lagrange setup.  The generic
``crypto/bls/curve.py`` path works on wrapped field elements and is an order
of magnitude slower; this module is the host baseline the device MSM is
measured against (role of blst's Pippenger in the reference,
``crypto/bls/src/impls/blst.rs``).

Points are affine ``(x, y)`` int tuples or ``None`` for infinity at the API
boundary; Jacobian ``(X, Y, Z)`` internally with ``Z == 0`` for infinity.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..bls.params import P, R

Affine = Optional[Tuple[int, int]]
Jac = Tuple[int, int, int]

INF: Jac = (1, 1, 0)


def to_jac(pt: Affine) -> Jac:
    if pt is None:
        return INF
    return (pt[0], pt[1], 1)


def to_affine(p: Jac) -> Affine:
    X, Y, Z = p
    if Z == 0:
        return None
    zinv = pow(Z, P - 2, P)
    z2 = zinv * zinv % P
    return (X * z2 % P, Y * z2 * zinv % P)


def jac_dbl(p: Jac) -> Jac:
    X1, Y1, Z1 = p
    if Z1 == 0 or Y1 == 0:
        return INF
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = B * B % P
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % P
    E = 3 * A % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y1 * Z1 % P
    return (X3, Y3, Z3)


def jac_add(p: Jac, q: Jac) -> Jac:
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        if S1 != S2:
            return INF
        return jac_dbl(p)
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    r = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (r * r - J - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * S1 * J) % P
    Z3 = 2 * H * Z1 * Z2 % P
    return (X3, Y3, Z3)


def jac_add_affine(p: Jac, q: Affine) -> Jac:
    """Mixed addition (q affine, Z2 == 1)."""
    if q is None:
        return p
    X1, Y1, Z1 = p
    if Z1 == 0:
        return (q[0], q[1], 1)
    X2, Y2 = q
    Z1Z1 = Z1 * Z1 % P
    U2 = X2 * Z1Z1 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if X1 == U2:
        if Y1 != S2:
            return INF
        return jac_dbl(p)
    H = (U2 - X1) % P
    HH = H * H % P
    I = 4 * HH % P
    J = H * I % P
    r = 2 * (S2 - Y1) % P
    V = X1 * I % P
    X3 = (r * r - J - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * Y1 * J) % P
    Z3 = (Z1 + H) * (Z1 + H) % P
    Z3 = (Z3 - Z1Z1 - HH) % P
    return (X3, Y3, Z3)


def jac_neg(p: Jac) -> Jac:
    X, Y, Z = p
    return (X, (P - Y) % P, Z)


def scalar_mul(pt: Affine, k: int) -> Affine:
    k %= R
    if pt is None or k == 0:
        return None
    acc = INF
    base = to_jac(pt)
    while k:
        if k & 1:
            acc = jac_add(acc, base)
        base = jac_dbl(base)
        k >>= 1
    return to_affine(acc)


def msm(points: Sequence[Affine], scalars: Sequence[int], window: int = 8) -> Affine:
    """Pippenger bucket MSM: ``sum_i scalars[i] * points[i]``."""
    n = len(points)
    if n != len(scalars):
        raise ValueError(f"msm: {n} points vs {len(scalars)} scalars")
    ks = [s % R for s in scalars]
    if n == 0:
        return None
    if n == 1:
        return scalar_mul(points[0], ks[0])
    nbits = R.bit_length()
    nwin = (nbits + window - 1) // window
    acc = INF
    mask = (1 << window) - 1
    for w in range(nwin - 1, -1, -1):
        if acc[2] != 0:
            for _ in range(window):
                acc = jac_dbl(acc)
        buckets: List[Jac] = [INF] * (mask + 1)
        shift = w * window
        for pt, k in zip(points, ks):
            if pt is None:
                continue
            d = (k >> shift) & mask
            if d:
                buckets[d] = jac_add_affine(buckets[d], pt)
        # running-sum trick: sum_d d * bucket[d]
        run = INF
        win_sum = INF
        for d in range(mask, 0, -1):
            run = jac_add(run, buckets[d])
            win_sum = jac_add(win_sum, run)
        acc = jac_add(acc, win_sum)
    return to_affine(acc)


def add(p: Affine, q: Affine) -> Affine:
    return to_affine(jac_add(to_jac(p), to_jac(q)))


def neg(p: Affine) -> Affine:
    if p is None:
        return None
    return (p[0], (P - p[1]) % P)


def is_on_curve(p: Affine) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + 4)) % P == 0
