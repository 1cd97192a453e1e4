"""BLS12-381 arithmetic on plain Python integers, fast enough to make a
benchmark's traffic in its set-up.

The benchmark's inputs (public keys, signatures over gossip messages) come
from here, and the program under test receives only their bytes and points.
Nothing here is shared with the program or with the plain reference
(``lhbench/reference``): the tests hold this module's hash-to-curve, scalar
multiplication and point encodings to the reference's.

Points are Jacobian ``(X, Y, Z)`` tuples (``x = X/Z^2``, ``y = Y/Z^3``) or
``None`` for infinity; G1 coordinates are ints mod ``P``, G2 coordinates are
``(c0, c1)`` pairs for ``c0 + c1*u`` with ``u^2 = -1``.  Formulas: EFD
``dbl-2009-l`` and ``add-2007-bl`` for ``a = 0``.
"""

from __future__ import annotations

import hashlib
import struct

from .reference import _sswu_g2_iso as _ISO
from .reference.params import (DST, G1_X, G1_Y, G2_X_C0, G2_X_C1, G2_Y_C0,
                               G2_Y_C1, P, R, SSWU_A, SSWU_B, SSWU_Z, X)

HALF_P = (P - 1) // 2


# ------------------------------------------------------------------ Fq2

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_neg(a):
    return (-a[0] % P, -a[1] % P)


def f2_mul(a, b):
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def f2_sqr(a):
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)


def f2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], P - 2, P)
    return (a[0] * d % P, -a[1] * d % P)


def f2_pow(a, e: int):
    out = (1, 0)
    while e:
        if e & 1:
            out = f2_mul(out, a)
        a = f2_sqr(a)
        e >>= 1
    return out


def f2_conj(a):
    return (a[0], -a[1] % P)


def f2_sqrt(a):
    """A square root of ``a`` in Fq2 (complex method, p = 3 mod 4), or None."""
    a0, a1 = a
    if a1 == 0:
        s = pow(a0, (P + 1) // 4, P)
        if s * s % P == a0:
            return (s, 0)
        s = pow(-a0 % P, (P + 1) // 4, P)
        return (0, s) if s * s % P == -a0 % P else None
    n = (a0 * a0 + a1 * a1) % P
    s = pow(n, (P + 1) // 4, P)
    if s * s % P != n:
        return None
    half = (P + 1) // 2
    for d in ((a0 + s) * half % P, (a0 - s) * half % P):
        x = pow(d, (P + 1) // 4, P)
        if x and x * x % P == d:
            y = a1 * half % P * pow(x, P - 2, P) % P
            return (x, y)
    return None


def f2_sgn0(a) -> int:
    return (a[0] & 1) | (int(a[0] == 0) & (a[1] & 1))


# ------------------------------------------------------------- the curves

def _g1_dbl(p):
    if p is None or p[1] == 0:
        return None
    x, y, z = p
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    return (x3, (e * (d - x3) - 8 * c) % P, 2 * y * z % P)


def _g1_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        return _g1_dbl(p) if s1 == s2 else None
    h = u2 - u1
    i = 4 * h * h % P
    j = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % P
    return (x3, y3, z3)


def _g1_neg(p):
    return None if p is None else (p[0], -p[1] % P, p[2])


def _g2_dbl(p):
    if p is None:
        return None
    (x0, x1), (y0, y1), (z0, z1) = p
    if y0 == 0 and y1 == 0:
        return None
    # a = x^2, b = y^2, c = b^2 (Fq2 squarings written out: this is the
    # inner loop of every chain and scalar multiplication)
    a0, a1 = (x0 + x1) * (x0 - x1) % P, 2 * x0 * x1 % P
    b0, b1 = (y0 + y1) * (y0 - y1) % P, 2 * y0 * y1 % P
    c0, c1 = (b0 + b1) * (b0 - b1) % P, 2 * b0 * b1 % P
    s0, s1 = x0 + b0, x1 + b1
    d0 = 2 * ((s0 + s1) * (s0 - s1) - a0 - c0) % P
    d1 = 2 * (2 * s0 * s1 - a1 - c1) % P
    e0, e1 = 3 * a0, 3 * a1
    x30 = ((e0 + e1) * (e0 - e1) - 2 * d0) % P
    x31 = (2 * e0 * e1 - 2 * d1) % P
    u0, u1 = d0 - x30, d1 - x31
    t0, t1 = e0 * u0, e1 * u1
    y30 = (t0 - t1 - 8 * c0) % P
    y31 = ((e0 + e1) * (u0 + u1) - t0 - t1 - 8 * c1) % P
    t0, t1 = y0 * z0, y1 * z1
    z30 = 2 * (t0 - t1) % P
    z31 = 2 * ((y0 + y1) * (z0 + z1) - t0 - t1) % P
    return ((x30, x31), (y30, y31), (z30, z31))


def _m2(a0, a1, b0, b1):
    t0 = a0 * b0
    t1 = a1 * b1
    return (t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P


def _g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    (x10, x11), (y10, y11), (z10, z11) = p
    (x20, x21), (y20, y21), (z20, z21) = q
    zz10, zz11 = (z10 + z11) * (z10 - z11) % P, 2 * z10 * z11 % P
    if z20 == 1 and z21 == 0:          # q affine: madd-2007-bl
        u10, u11, s10, s11 = x10, x11, y10, y11
        zz20, zz21 = 1, 0
    else:
        zz20, zz21 = (z20 + z21) * (z20 - z21) % P, 2 * z20 * z21 % P
        u10, u11 = _m2(x10, x11, zz20, zz21)
        t0, t1 = _m2(y10, y11, z20, z21)
        s10, s11 = _m2(t0, t1, zz20, zz21)
    u20, u21 = _m2(x20, x21, zz10, zz11)
    t0, t1 = _m2(y20, y21, z10, z11)
    s20, s21 = _m2(t0, t1, zz10, zz11)
    if u10 == u20 and u11 == u21:
        return _g2_dbl(p) if (s10 == s20 and s11 == s21) else None
    h0, h1 = (u20 - u10) % P, (u21 - u11) % P
    i0, i1 = 4 * (h0 + h1) * (h0 - h1) % P, 8 * h0 * h1 % P
    j0, j1 = _m2(h0, h1, i0, i1)
    r0, r1 = 2 * (s20 - s10) % P, 2 * (s21 - s11) % P
    v0, v1 = _m2(u10, u11, i0, i1)
    x30 = ((r0 + r1) * (r0 - r1) - j0 - 2 * v0) % P
    x31 = (2 * r0 * r1 - j1 - 2 * v1) % P
    t0, t1 = _m2(r0, r1, v0 - x30, v1 - x31)
    w0, w1 = _m2(s10, s11, j0, j1)
    y30, y31 = (t0 - 2 * w0) % P, (t1 - 2 * w1) % P
    a0, a1 = z10 + z20, z11 + z21
    t0 = ((a0 + a1) * (a0 - a1) - zz10 - zz20) % P
    t1 = (2 * a0 * a1 - zz11 - zz21) % P
    z30, z31 = _m2(t0, t1, h0, h1)
    return ((x30, x31), (y30, y31), (z30, z31))


def _g2_neg(p):
    return None if p is None else (p[0], f2_neg(p[1]), p[2])


class _Group:
    __slots__ = ("dbl", "add", "neg")

    def __init__(self, dbl, add, neg):
        self.dbl, self.add, self.neg = dbl, add, neg


G1_OPS = _Group(_g1_dbl, _g1_add, _g1_neg)
G2_OPS = _Group(_g2_dbl, _g2_add, _g2_neg)

G1 = (G1_X, G1_Y, 1)
G2 = ((G2_X_C0, G2_X_C1), (G2_Y_C0, G2_Y_C1), (1, 0))


def mul(ops: _Group, p, k: int):
    """``[k]P`` by 4-bit fixed windows (``k`` of any sign)."""
    if k < 0:
        return mul(ops, ops.neg(p), -k)
    if p is None or k == 0:
        return None
    table = [None, p]
    for _ in range(14):
        table.append(ops.add(table[-1], p))
    acc = None
    for shift in range((k.bit_length() + 3) // 4 * 4 - 4, -1, -4):
        for _ in range(4):
            acc = ops.dbl(acc)
        digit = (k >> shift) & 15
        if digit:
            acc = ops.add(acc, table[digit])
    return acc


def g1_affine(points: list) -> list:
    """Jacobian G1 points to affine ``(x, y)`` int pairs, one inversion for
    all (Montgomery's trick); infinity stays None."""
    zs = [p[2] for p in points if p is not None]
    invs = _batch_inverse(zs, lambda a, b: a * b % P, lambda a: pow(a, P - 2, P))
    out, k = [], 0
    for p in points:
        if p is None:
            out.append(None)
            continue
        zi = invs[k]
        k += 1
        zi2 = zi * zi % P
        out.append((p[0] * zi2 % P, p[1] * zi2 % P * zi % P))
    return out


def g2_affine(points: list) -> list:
    """Jacobian G2 points to affine ``((x0, x1), (y0, y1))``, one inversion
    for all; infinity stays None."""
    zs = [p[2] for p in points if p is not None]
    invs = _batch_inverse(zs, f2_mul, f2_inv)
    out, k = [], 0
    for p in points:
        if p is None:
            out.append(None)
            continue
        zi = invs[k]
        k += 1
        zi2 = f2_sqr(zi)
        out.append((f2_mul(p[0], zi2), f2_mul(f2_mul(p[1], zi2), zi)))
    return out


def _batch_inverse(values: list, mul_fn, inv_fn) -> list:
    if not values:
        return []
    prefix = [values[0]]
    for v in values[1:]:
        prefix.append(mul_fn(prefix[-1], v))
    inv = inv_fn(prefix[-1])
    out = [None] * len(values)
    for i in range(len(values) - 1, 0, -1):
        out[i] = mul_fn(inv, prefix[i - 1])
        inv = mul_fn(inv, values[i])
    out[0] = inv
    return out


# -------------------------------------------------------------- encodings

def g1_compress(pt) -> bytes:
    """48-byte ZCash encoding of an affine G1 point."""
    if pt is None:
        return bytes([0xC0]) + bytes(47)
    x, y = pt
    raw = bytearray(x.to_bytes(48, "big"))
    raw[0] |= 0x80 | (0x20 if y > HALF_P else 0)
    return bytes(raw)


def g2_compress(pt) -> bytes:
    """96-byte ZCash encoding of an affine G2 point."""
    if pt is None:
        return bytes([0xC0]) + bytes(95)
    (x0, x1), (y0, y1) = pt
    big = y1 > HALF_P if y1 else y0 > HALF_P
    raw = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    raw[0] |= 0x80 | (0x20 if big else 0)
    return bytes(raw)


# ------------------------------------------------- hash to G2 (RFC 9380)

_L = 64
_A = SSWU_A
_B = SSWU_B
_Z = SSWU_Z
_NEG_B_OVER_A = f2_neg(f2_mul(_B, f2_inv(_A)))
_B_OVER_ZA = f2_mul(_B, f2_inv(f2_mul(_Z, _A)))
_XI = (1, 1)
_PSI_CX = f2_inv(f2_pow(_XI, (P - 1) // 3))
_PSI_CY = f2_inv(f2_pow(_XI, (P - 1) // 2))


def expand_message_xmd(msg: bytes, dst: bytes, n: int) -> bytes:
    """RFC 9380 5.3.1 with SHA-256."""
    ell = (n + 31) // 32
    dst_prime = dst + bytes([len(dst)])
    b0 = hashlib.sha256(bytes(64) + msg + struct.pack(">H", n) + b"\x00" + dst_prime).digest()
    b = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [b]
    for i in range(2, ell + 1):
        b = hashlib.sha256(bytes(x ^ y for x, y in zip(b0, b)) + bytes([i]) + dst_prime).digest()
        out.append(b)
    return b"".join(out)[:n]


def _horner(coeffs, x):
    acc = (0, 0)
    for c in reversed(coeffs):
        acc = f2_add(f2_mul(acc, x), c)
    return acc


def _sswu(u):
    """Simplified SWU onto E' (RFC 9380 6.6.2), then the 3-isogeny to E2;
    returns an affine point."""
    zu2 = f2_mul(_Z, f2_sqr(u))
    tv = f2_add(f2_sqr(zu2), zu2)
    if tv == (0, 0):
        x1 = _B_OVER_ZA
    else:
        x1 = f2_mul(_NEG_B_OVER_A, f2_add((1, 0), f2_inv(tv)))
    gx1 = f2_add(f2_add(f2_mul(f2_sqr(x1), x1), f2_mul(_A, x1)), _B)
    y = f2_sqrt(gx1)
    x = x1
    if y is None:
        x = f2_mul(zu2, x1)
        y = f2_sqrt(f2_add(f2_add(f2_mul(f2_sqr(x), x), f2_mul(_A, x)), _B))
    if f2_sgn0(u) != f2_sgn0(y):
        y = f2_neg(y)
    xn = _horner(_ISO.XNUM, x)
    xd = _horner(_ISO.XDEN, x)
    yn = _horner(_ISO.YNUM, x)
    yd = _horner(_ISO.YDEN, x)
    inv = f2_inv(f2_mul(xd, yd))
    return (f2_mul(f2_mul(xn, yd), inv), f2_mul(f2_mul(y, f2_mul(yn, xd)), inv))


def _psi(p):
    if p is None:
        return None
    return (f2_mul(f2_conj(p[0]), _PSI_CX), f2_mul(f2_conj(p[1]), _PSI_CY), f2_conj(p[2]))


def _mul_by_x(p):
    """``[x]P`` for the (negative) BLS parameter, by its six set bits."""
    acc = p
    for bit in bin(-X)[3:]:
        acc = _g2_dbl(acc)
        if bit == "1":
            acc = _g2_add(acc, p)
    return _g2_neg(acc)


def clear_cofactor(p):
    """RFC 9380 G.3: ``[x^2 - x - 1]P + [x - 1]psi(P) + psi^2([2]P)``."""
    t1 = _mul_by_x(p)
    t2 = _psi(p)
    t3 = _psi(_psi(_g2_dbl(p)))
    t3 = _g2_add(t3, _g2_neg(t2))
    t2 = _mul_by_x(_g2_add(t1, t2))
    t3 = _g2_add(_g2_add(t3, t2), _g2_neg(t1))
    return _g2_add(t3, _g2_neg(p))


def hash_to_g2(msg: bytes, dst: bytes = DST):
    """RFC 9380 hash_to_curve for BLS12381G2_XMD:SHA-256_SSWU_RO_: a
    Jacobian point of G2."""
    uniform = expand_message_xmd(msg, dst, 4 * _L)
    e = [int.from_bytes(uniform[i * _L:(i + 1) * _L], "big") % P for i in range(4)]
    q0 = _sswu((e[0], e[1]))
    q1 = _sswu((e[2], e[3]))
    q = _g2_add((q0[0], q0[1], (1, 0)), (q1[0], q1[1], (1, 0)))
    return clear_cofactor(q)


def scalar(k: int) -> int:
    """``k`` reduced into the scalar field."""
    return k % R
