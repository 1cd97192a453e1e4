"""ZCash-convention point (de)serialization for BLS12-381.

Byte-compatible with the encodings the reference handles via blst
(``crypto/bls/src/generic_public_key_bytes.rs`` / ``generic_signature.rs``):
48-byte compressed G1, 96-byte compressed G2, with the three flag bits in the
most-significant byte (compression 0x80, infinity 0x40, y-sign 0x20).
"""

from __future__ import annotations

from typing import Optional

from .curve import B1_FQ, B2_FQ2, Point, is_on_curve
from .fields import Fq, Fq2
from .params import P

_C_FLAG = 0x80
_I_FLAG = 0x40
_S_FLAG = 0x20
_HALF_P = (P - 1) // 2

G1_COMPRESSED_LEN = 48
G2_COMPRESSED_LEN = 96


class DecodeError(ValueError):
    pass


def _y_is_big_fq(y: Fq) -> bool:
    return y.n > _HALF_P


def _y_is_big_fq2(y: Fq2) -> bool:
    if y.c1 != 0:
        return y.c1 > _HALF_P
    return y.c0 > _HALF_P


def g1_compress(pt: Point) -> bytes:
    if pt is None:
        return bytes([_C_FLAG | _I_FLAG]) + b"\x00" * 47
    x, y = pt
    flags = _C_FLAG | (_S_FLAG if _y_is_big_fq(y) else 0)
    raw = x.n.to_bytes(48, "big")
    return bytes([raw[0] | flags]) + raw[1:]


def g1_decompress(data: bytes) -> Point:
    if len(data) != G1_COMPRESSED_LEN:
        raise DecodeError(f"G1 compressed must be 48 bytes, got {len(data)}")
    flags = data[0]
    if not flags & _C_FLAG:
        raise DecodeError("compression flag not set")
    if flags & _I_FLAG:
        if flags & _S_FLAG or any(data[1:]) or data[0] & 0x1F:
            raise DecodeError("malformed infinity encoding")
        return None
    x_int = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x_int >= P:
        raise DecodeError("x >= p")
    x = Fq(x_int)
    y2 = x * x * x + B1_FQ
    y = y2.sqrt()
    if y is None:
        raise DecodeError("x not on curve")
    if _y_is_big_fq(y) != bool(flags & _S_FLAG):
        y = -y
    return (x, y)


def g2_compress(pt: Point) -> bytes:
    if pt is None:
        return bytes([_C_FLAG | _I_FLAG]) + b"\x00" * 95
    x, y = pt
    flags = _C_FLAG | (_S_FLAG if _y_is_big_fq2(y) else 0)
    raw_c1 = x.c1.to_bytes(48, "big")
    raw_c0 = x.c0.to_bytes(48, "big")
    return bytes([raw_c1[0] | flags]) + raw_c1[1:] + raw_c0


def g2_decompress(data: bytes) -> Point:
    if len(data) != G2_COMPRESSED_LEN:
        raise DecodeError(f"G2 compressed must be 96 bytes, got {len(data)}")
    flags = data[0]
    if not flags & _C_FLAG:
        raise DecodeError("compression flag not set")
    if flags & _I_FLAG:
        if flags & _S_FLAG or any(data[1:]) or data[0] & 0x1F:
            raise DecodeError("malformed infinity encoding")
        return None
    x_c1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x_c0 = int.from_bytes(data[48:], "big")
    if x_c1 >= P or x_c0 >= P:
        raise DecodeError("x component >= p")
    x = Fq2(x_c0, x_c1)
    y2 = x * x * x + B2_FQ2
    y = y2.sqrt()
    if y is None:
        raise DecodeError("x not on curve")
    if _y_is_big_fq2(y) != bool(flags & _S_FLAG):
        y = -y
    return (x, y)
