"""Minimal secp256k1 for discv5: point arithmetic, deterministic ECDSA
(RFC 6979), and ECDH — ENR identity scheme v4 and the handshake's key
agreement.  Discovery-scale only (a handful of ops per handshake); the
BLS hot path lives in ``ops/``, not here.

A copy of the JAX package's ``lighthouse_tpu/network/discv5/secp256k1.py``.
"""

from __future__ import annotations

import hashlib
import hmac
from typing import Optional, Tuple

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
Gx = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
Gy = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (Gx, Gy)

Point = Optional[Tuple[int, int]]  # None = infinity


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def mul(p: Point, k: int) -> Point:
    k %= N
    result: Point = None
    addend = p
    while k:
        if k & 1:
            result = add(result, addend)
        addend = add(addend, addend)
        k >>= 1
    return result


def pubkey(priv: int) -> Tuple[int, int]:
    pt = mul(G, priv)
    assert pt is not None
    return pt


def compress(pt: Tuple[int, int]) -> bytes:
    x, y = pt
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def decompress(data: bytes) -> Tuple[int, int]:
    if len(data) == 65 and data[0] == 4:
        return (int.from_bytes(data[1:33], "big"), int.from_bytes(data[33:], "big"))
    if len(data) != 33 or data[0] not in (2, 3):
        raise ValueError("bad secp256k1 point encoding")
    x = int.from_bytes(data[1:], "big")
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise ValueError("x not on curve")
    if (y & 1) != (data[0] & 1):
        y = P - y
    return (x, y)


def uncompressed_xy(pt: Tuple[int, int]) -> bytes:
    """x || y, 64 bytes — keccak of this is the discv5 node id."""
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


# ------------------------------------------------------------------- ECDSA


def _rfc6979_k(priv: int, h: bytes) -> int:
    """Deterministic nonce (RFC 6979, HMAC-SHA256)."""
    x = priv.to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(priv: int, msg_hash: bytes) -> bytes:
    """64-byte r||s signature (low-s), over a 32-byte message hash."""
    z = int.from_bytes(msg_hash, "big") % N
    while True:
        k = _rfc6979_k(priv, msg_hash)
        pt = mul(G, k)
        r = pt[0] % N
        if r == 0:
            msg_hash = hashlib.sha256(msg_hash).digest()
            continue
        s = _inv(k, N) * (z + r * priv) % N
        if s == 0:
            msg_hash = hashlib.sha256(msg_hash).digest()
            continue
        if s > N // 2:
            s = N - s
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def verify(pub: Tuple[int, int], msg_hash: bytes, sig: bytes) -> bool:
    if len(sig) != 64:
        return False
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (1 <= r < N and 1 <= s < N):
        return False
    z = int.from_bytes(msg_hash, "big") % N
    w = _inv(s, N)
    u1 = z * w % N
    u2 = r * w % N
    pt = add(mul(G, u1), mul(pub, u2))
    if pt is None:
        return False
    return pt[0] % N == r


def ecdh(priv: int, pub: Tuple[int, int]) -> bytes:
    """discv5 ecdh(): the COMPRESSED shared point (33 bytes)."""
    shared = mul(pub, priv)
    assert shared is not None
    return compress(shared)
