"""RFC 9380 hash-to-curve for BLS12-381 G2 (suite BLS12381G2_XMD:SHA-256_SSWU_RO_).

The reference client delegates this to blst via its DST constant
(``crypto/bls/src/impls/blst.rs:13``).  Here: expand_message_xmd(SHA-256) →
hash_to_field(Fp2, m=2, count=2, L=64) → simplified SWU on the 3-isogenous curve
E' → derived Velu isogeny (``_sswu_g2_iso.py``, see scripts/derive_g2_isogeny.py
for the derivation and the RFC-fingerprint cross-checks) → Budroni–Pintore
cofactor clearing.
"""

from __future__ import annotations

import hashlib
import struct

from . import _sswu_g2_iso as ISO
from .curve import Point, add, clear_cofactor_g2
from .fields import Fq2
from .params import P, SSWU_A, SSWU_B, SSWU_Z

_A = Fq2(*SSWU_A)
_B = Fq2(*SSWU_B)
_Z = Fq2(*SSWU_Z)

_XNUM = [Fq2(c0, c1) for c0, c1 in ISO.XNUM]
_XDEN = [Fq2(c0, c1) for c0, c1 in ISO.XDEN]
_YNUM = [Fq2(c0, c1) for c0, c1 in ISO.YNUM]
_YDEN = [Fq2(c0, c1) for c0, c1 in ISO.YDEN]

L = 64  # ceil((ceil(log2(p)) + k) / 8) = ceil((381 + 128) / 8)


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 with SHA-256."""
    b_in_bytes = 32
    r_in_bytes = 64
    ell = (len_in_bytes + b_in_bytes - 1) // b_in_bytes
    if ell > 255 or len_in_bytes > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd parameter out of range")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * r_in_bytes
    l_i_b_str = struct.pack(">H", len_in_bytes)
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    bs = [b1]
    for i in range(2, ell + 1):
        prev = bs[-1]
        xored = bytes(a ^ b for a, b in zip(b0, prev))
        bs.append(hashlib.sha256(xored + bytes([i]) + dst_prime).digest())
    return b"".join(bs)[:len_in_bytes]


def hash_to_field_fq2(msg: bytes, count: int, dst: bytes) -> list:
    """RFC 9380 §5.2: count elements of Fp2."""
    m = 2
    uniform = expand_message_xmd(msg, dst, count * m * L)
    out = []
    for i in range(count):
        coeffs = []
        for j in range(m):
            off = L * (j + i * m)
            coeffs.append(int.from_bytes(uniform[off : off + L], "big") % P)
        out.append(Fq2(coeffs[0], coeffs[1]))
    return out


def map_to_curve_simple_swu(u: Fq2):
    """Simplified SWU map onto E': y^2 = x^3 + A'x + B' (RFC 9380 §6.6.2)."""
    u2 = u.square()
    zu2 = _Z * u2
    tv = zu2.square() + zu2  # Z^2 u^4 + Z u^2
    neg_b_over_a = -(_B * _A.inv())
    if tv.is_zero():
        x1 = _B * (_Z * _A).inv()
    else:
        x1 = neg_b_over_a * (Fq2.one() + tv.inv())
    gx1 = x1.square() * x1 + _A * x1 + _B
    y1 = gx1.sqrt()
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = zu2 * x1
        gx2 = x2.square() * x2 + _A * x2 + _B
        y2 = gx2.sqrt()
        assert y2 is not None, "SSWU: neither gx1 nor gx2 is square (impossible)"
        x, y = x2, y2
    if u.sgn0() != y.sgn0():
        y = -y
    return (x, y)


def _horner(poly, x: Fq2) -> Fq2:
    acc = Fq2.zero()
    for c in reversed(poly):
        acc = acc * x + c
    return acc


def iso_map(pt) -> Point:
    """Evaluate the 3-isogeny E' -> E2."""
    x, y = pt
    xden = _horner(_XDEN, x)
    if xden.is_zero():
        return None  # kernel point maps to infinity
    x2 = _horner(_XNUM, x) * xden.inv()
    y2 = y * _horner(_YNUM, x) * _horner(_YDEN, x).inv()
    return (x2, y2)


def hash_to_g2(msg: bytes, dst: bytes) -> Point:
    """hash_to_curve (random-oracle variant): the signing/verification H(m)."""
    u0, u1 = hash_to_field_fq2(msg, 2, dst)
    q0 = iso_map(map_to_curve_simple_swu(u0))
    q1 = iso_map(map_to_curve_simple_swu(u1))
    return clear_cofactor_g2(add(q0, q1))
