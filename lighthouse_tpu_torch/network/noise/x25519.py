"""RFC 7748 curve25519 Diffie-Hellman (X25519), pure Python.

Handshake-scale only (two scalar mults per connection).  Pinned to the
RFC's published test vectors in ``tests/test_noise_yamux.py``.

A copy of the JAX package's ``lighthouse_tpu/network/noise/x25519.py``.
"""

from __future__ import annotations

import secrets

P = 2**255 - 19
A24 = 121665  # (486662 - 2) / 4


def _decode_u(data: bytes) -> int:
    if len(data) != 32:
        raise ValueError("u-coordinate must be 32 bytes")
    u = bytearray(data)
    u[31] &= 0x7F  # mask the unused high bit
    return int.from_bytes(u, "little")


def _decode_scalar(data: bytes) -> int:
    if len(data) != 32:
        raise ValueError("scalar must be 32 bytes")
    k = bytearray(data)
    k[0] &= 248
    k[31] &= 127
    k[31] |= 64
    return int.from_bytes(k, "little")


def x25519(scalar: bytes, u_bytes: bytes) -> bytes:
    """The X25519 function: Montgomery ladder, constant structure."""
    k = _decode_scalar(scalar)
    u = _decode_u(u_bytes) % P

    x1 = u
    x2, z2 = 1, 0
    x3, z3 = u, 1
    swap = 0
    for t in range(254, -1, -1):
        k_t = (k >> t) & 1
        swap ^= k_t
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t

        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = x1 * (z3 * z3 % P) % P
        x2 = aa * bb % P
        z2 = e * (aa + A24 * e) % P

    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, P - 2, P) % P
    return out.to_bytes(32, "little")


BASE_POINT = (9).to_bytes(32, "little")


def keypair(priv: bytes = None):
    """(private, public) X25519 key pair."""
    if priv is None:
        priv = secrets.token_bytes(32)
    return priv, x25519(priv, BASE_POINT)
