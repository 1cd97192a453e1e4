"""EIP-2333 BLS key derivation (HKDF tree) + EIP-2334 paths.

Re-implements the capability of the reference's ``crypto/eth2_key_derivation``
(``src/derived_key.rs``: ``DerivedKey::from_seed`` / ``child``) from the
public EIP-2333 specification: a Lamport-keyed HKDF derivation tree over the
BLS12-381 scalar field.  Host-side code — key derivation is cold-path setup,
not device work.

Checked against the official EIP-2333 test vectors (tests/vectors/eip2333.json,
the same vectors the reference pins in tests/eip2333_vectors.rs).

A copy of the JAX package's ``lighthouse_tpu/crypto/key_derivation.py``.
"""

from __future__ import annotations

import hashlib
import hmac
from typing import List

from .bls.params import R  # BLS12-381 scalar field order

_SALT0 = b"BLS-SIG-KEYGEN-SALT-"
_LAMPORT_CHUNKS = 255


def _hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt, ikm, hashlib.sha256).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    counter = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([counter]), hashlib.sha256).digest()
        out += t
        counter += 1
    return out[:length]


def hkdf_mod_r(ikm: bytes, key_info: bytes = b"") -> int:
    """RFC-draft KeyGen: map IKM to a nonzero scalar mod r."""
    salt = _SALT0
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = _hkdf_extract(salt, ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % R
    return sk


def _ikm_to_lamport_sk(ikm: bytes, salt: bytes) -> List[bytes]:
    prk = _hkdf_extract(salt, ikm)
    okm = _hkdf_expand(prk, b"", 32 * _LAMPORT_CHUNKS)
    return [okm[i * 32 : (i + 1) * 32] for i in range(_LAMPORT_CHUNKS)]


def _parent_sk_to_lamport_pk(parent_sk: int, index: int) -> bytes:
    salt = index.to_bytes(4, "big")
    ikm = parent_sk.to_bytes(32, "big")
    lamport_0 = _ikm_to_lamport_sk(ikm, salt)
    not_ikm = bytes(b ^ 0xFF for b in ikm)
    lamport_1 = _ikm_to_lamport_sk(not_ikm, salt)
    pk = b"".join(hashlib.sha256(x).digest() for x in lamport_0 + lamport_1)
    return hashlib.sha256(pk).digest()


def derive_master_sk(seed: bytes) -> int:
    if len(seed) < 32:
        raise ValueError("seed must be >= 32 bytes (EIP-2333)")
    return hkdf_mod_r(seed)


def derive_child_sk(parent_sk: int, index: int) -> int:
    if not 0 <= index < 2**32:
        raise ValueError("child index out of range")
    return hkdf_mod_r(_parent_sk_to_lamport_pk(parent_sk, index))


def derive_path(seed: bytes, path: str) -> int:
    """EIP-2334 path derivation, e.g. ``m/12381/3600/0/0/0`` (validator
    signing key i = m/12381/3600/i/0/0, withdrawal key = m/12381/3600/i/0)."""
    parts = path.strip().split("/")
    if not parts or parts[0] != "m":
        raise ValueError(f"bad derivation path {path!r}")
    sk = derive_master_sk(seed)
    for p in parts[1:]:
        if not p.isdigit():
            raise ValueError(f"bad path component {p!r}")
        sk = derive_child_sk(sk, int(p))
    return sk


def mnemonic_to_seed(mnemonic: str, passphrase: str = "") -> bytes:
    """BIP-39 seed derivation (PBKDF2-HMAC-SHA512, 2048 rounds)."""
    import unicodedata

    norm = unicodedata.normalize("NFKD", mnemonic)
    salt = unicodedata.normalize("NFKD", "mnemonic" + passphrase)
    return hashlib.pbkdf2_hmac("sha512", norm.encode(), salt.encode(), 2048, 64)
