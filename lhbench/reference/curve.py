# A frozen copy of lighthouse_tpu_torch/crypto/bls/curve.py, the benchmark's plain
# reference: the yardstick stays as it is when the program changes.  Do not edit.
"""BLS12-381 elliptic-curve group operations (host golden model).

Generic short-Weierstrass (a = 0) affine arithmetic parameterised over the field
element type, so the same code serves E1(Fp), the twist E2(Fp2) and the untwisted
E(Fp12) used by the Miller loop.  Mirrors the capability surface of the reference's
``crypto/bls`` point types (``crypto/bls/src/generic_public_key.rs`` et al.).
"""

from __future__ import annotations

from typing import Optional, Tuple

from .fields import Fq, Fq2, Fq12
from .params import B1, B2, G1_X, G1_Y, G2_X_C0, G2_X_C1, G2_Y_C0, G2_Y_C1, P, X

# A point is None (infinity) or a tuple (x, y) of field elements.
Point = Optional[Tuple[object, object]]


def is_on_curve(pt: Point, b) -> bool:
    if pt is None:
        return True
    x, y = pt
    return y * y == x * x * x + b


def add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return double(p1)
        return None
    m = (y2 - y1) * (x2 - x1).inv()
    x3 = m * m - x1 - x2
    return (x3, m * (x1 - x3) - y1)


def double(p1: Point) -> Point:
    if p1 is None:
        return None
    x1, y1 = p1
    if y1.is_zero():
        return None
    m = (x1 * x1 + x1 * x1 + x1 * x1) * (y1 + y1).inv()
    x3 = m * m - x1 - x1
    return (x3, m * (x1 - x3) - y1)


def neg(p1: Point) -> Point:
    if p1 is None:
        return None
    x1, y1 = p1
    return (x1, -y1)


# Jacobian projective coordinates (x = X/Z^2, y = Y/Z^3) for the scalar-
# multiplication hot path: affine double-and-add pays one ~381-bit modular
# inversion PER STEP (~0.3 ms each on Python ints), so deriving a
# production-scale registry's worth of interop keypairs took minutes of
# setup.  Jacobian arithmetic is inversion-free until the single final
# conversion — an order-of-magnitude speedup with identical results.
# Formulas: EFD dbl-2009-l / add-2007-bl, valid for a = 0 over every field
# in the tower (the same genericity contract as the affine ops above).
# Infinity stays None; a Jacobian point is a tuple (X, Y, Z).


def _jac_double(p):
    if p is None:
        return None
    X1, Y1, Z1 = p
    if Y1.is_zero():
        return None
    A = X1 * X1
    B = Y1 * Y1
    C = B * B
    t = X1 + B
    D = t * t - A - C
    D = D + D
    E = A + A + A
    F = E * E
    X3 = F - (D + D)
    C8 = C + C
    C8 = C8 + C8
    C8 = C8 + C8
    Y3 = E * (D - X3) - C8
    Z3 = (Y1 + Y1) * Z1
    return (X3, Y3, Z3)


def _jac_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = Z1 * Z1
    Z2Z2 = Z2 * Z2
    U1 = X1 * Z2Z2
    U2 = X2 * Z1Z1
    S1 = Y1 * Z2 * Z2Z2
    S2 = Y2 * Z1 * Z1Z1
    if U1 == U2:
        if S1 == S2:
            return _jac_double(p)
        return None
    H = U2 - U1
    t = H + H
    I = t * t
    J = H * I
    r = S2 - S1
    r = r + r
    V = U1 * I
    X3 = r * r - J - (V + V)
    S1J2 = S1 * J
    Y3 = r * (V - X3) - (S1J2 + S1J2)
    t2 = Z1 + Z2
    Z3 = (t2 * t2 - Z1Z1 - Z2Z2) * H
    return (X3, Y3, Z3)


def mul(p1: Point, k: int) -> Point:
    """Scalar multiplication [k]P (host reference only) — Jacobian
    double-and-add internally, converted back to the affine form the rest
    of the module speaks."""
    if k < 0:
        return mul(neg(p1), -k)
    if p1 is None or k == 0:
        return None
    acc = None
    addend = (p1[0], p1[1], p1[0].one())
    while k:
        if k & 1:
            acc = _jac_add(acc, addend)
        addend = _jac_double(addend)
        k >>= 1
    if acc is None:
        return None
    X, Y, Z = acc
    zinv = Z.inv()
    zinv2 = zinv * zinv
    return (X * zinv2, Y * zinv2 * zinv)


G1 = (Fq(G1_X), Fq(G1_Y))
G2 = (Fq2(G2_X_C0, G2_X_C1), Fq2(G2_Y_C0, G2_Y_C1))

B1_FQ = Fq(B1)
B2_FQ2 = Fq2(*B2)
B12_FQ12 = Fq12.from_fq2(Fq2(4, 0))  # untwisted curve: y^2 = x^3 + 4 over Fp12


def untwist(pt: Point) -> Point:
    """Map E2(Fp2) -> E(Fp12): (x, y) -> (x / w^2, y / w^3)  (M-twist)."""
    if pt is None:
        return None
    x, y = pt
    w = Fq12.w()
    w2_inv = (w * w).inv()
    w3_inv = (w * w * w).inv()
    return (Fq12.from_fq2(x) * w2_inv, Fq12.from_fq2(y) * w3_inv)


def embed_g1(pt: Point) -> Point:
    """Embed E1(Fp) into E(Fp12)."""
    if pt is None:
        return None
    x, y = pt
    return (Fq12.from_fq2(Fq2(x.n, 0)), Fq12.from_fq2(Fq2(y.n, 0)))


# psi: untwist -> Frobenius -> twist endomorphism on E2(Fp2).
# psi(x, y) = (cx * conj(x), cy * conj(y)) with cx = xi^{-(p-1)/3}, cy = xi^{-(p-1)/2}.
_XI = Fq2(1, 1)
PSI_CX = _XI.pow((P - 1) // 3).inv()
PSI_CY = _XI.pow((P - 1) // 2).inv()


def psi(pt: Point) -> Point:
    if pt is None:
        return None
    x, y = pt
    return (x.conj() * PSI_CX, y.conj() * PSI_CY)


def psi2(pt: Point) -> Point:
    return psi(psi(pt))


def clear_cofactor_g2(pt: Point) -> Point:
    """Budroni–Pintore fast cofactor clearing, as specified for BLS12-381 G2
    (RFC 9380 / hash-to-curve draft; what blst implements):

        h_eff * P = [x^2 - x - 1]P + [x - 1]psi(P) + psi^2([2]P)
    """
    t1 = mul(pt, X * X - X - 1)
    t2 = mul(psi(pt), X - 1)
    t3 = psi2(double(pt))
    return add(add(t1, t2), t3)


def mul_by_x(pt: Point) -> Point:
    """[x]P with the (negative) BLS parameter."""
    return mul(pt, X)


def in_g2(pt: Point) -> bool:
    """Full G2 membership: on the twist and in the r-order subgroup.

    Uses the psi-eigenvalue check psi(P) == [x]P (valid for BLS12-381; the host
    tests cross-validate against the naive [r]P == O check).
    """
    if pt is None:
        return True
    if not is_on_curve(pt, B2_FQ2):
        return False
    return psi(pt) == mul_by_x(pt)
