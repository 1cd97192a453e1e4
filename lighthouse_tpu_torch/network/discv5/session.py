"""Handshake cryptography: HKDF session keys + the id-signature.

discv5-theory.md:

    ecdh-secret    = ecdh(eph-privkey, dest-static-pubkey)   (compressed, 33B)
    kdf-info       = "discovery v5 key agreement" || node-id-A || node-id-B
    keydata        = HKDF-SHA256(salt=challenge-data, ikm=ecdh-secret,
                                 info=kdf-info, len=32)
    initiator-key  = keydata[:16];  recipient-key = keydata[16:]

    id-signature   = sign(sha256("discovery v5 identity proof"
                          || challenge-data || eph-pubkey || node-id-B))

A is always the handshake INITIATOR (the side that got WHOAREYOU).

A copy of the JAX package's ``lighthouse_tpu/network/discv5/session.py``.
"""

from __future__ import annotations

import hashlib
import hmac
from typing import Tuple

from . import secp256k1

ID_SIGNATURE_TEXT = b"discovery v5 identity proof"
KDF_INFO_TEXT = b"discovery v5 key agreement"


def _hkdf_sha256(salt: bytes, ikm: bytes, info: bytes, length: int) -> bytes:
    prk = hmac.new(salt, ikm, hashlib.sha256).digest()
    out = b""
    block = b""
    counter = 1
    while len(out) < length:
        block = hmac.new(prk, block + info + bytes([counter]), hashlib.sha256).digest()
        out += block
        counter += 1
    return out[:length]


def derive_keys(eph_priv: int, dest_pub, node_id_a: bytes, node_id_b: bytes,
                challenge_data: bytes) -> Tuple[bytes, bytes]:
    """(initiator_key, recipient_key) from OUR ephemeral private key."""
    secret = secp256k1.ecdh(eph_priv, dest_pub)
    info = KDF_INFO_TEXT + node_id_a + node_id_b
    keydata = _hkdf_sha256(challenge_data, secret, info, 32)
    return keydata[:16], keydata[16:]


def derive_keys_from_pubkey(static_priv: int, eph_pub, node_id_a: bytes,
                            node_id_b: bytes, challenge_data: bytes
                            ) -> Tuple[bytes, bytes]:
    """Recipient side: same secret via ecdh(static-priv, eph-pubkey)."""
    secret = secp256k1.ecdh(static_priv, eph_pub)
    info = KDF_INFO_TEXT + node_id_a + node_id_b
    keydata = _hkdf_sha256(challenge_data, secret, info, 32)
    return keydata[:16], keydata[16:]


def id_sign(static_priv: int, challenge_data: bytes, eph_pubkey: bytes,
            dest_node_id: bytes) -> bytes:
    h = hashlib.sha256(
        ID_SIGNATURE_TEXT + challenge_data + eph_pubkey + dest_node_id
    ).digest()
    return secp256k1.sign(static_priv, h)


def id_verify(static_pub, signature: bytes, challenge_data: bytes,
              eph_pubkey: bytes, dest_node_id: bytes) -> bool:
    h = hashlib.sha256(
        ID_SIGNATURE_TEXT + challenge_data + eph_pubkey + dest_node_id
    ).digest()
    return secp256k1.verify(static_pub, h, signature)
