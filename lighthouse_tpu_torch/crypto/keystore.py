"""EIP-2335 keystores and EIP-2386 wallets.

Equivalent of the reference's ``crypto/eth2_keystore`` + ``crypto/eth2_wallet``
crates: scrypt/pbkdf2 KDF (stdlib hashlib), AES-128-CTR cipher, sha256
checksum, the v4 keystore JSON layout, and the hierarchical-deterministic
wallet that derives EIP-2334 validator paths from a mnemonic seed.

A copy of the JAX package's ``lighthouse_tpu/crypto/keystore.py``, but for
the cipher: the JAX package loads OpenSSL's libcrypto through ctypes, the
port takes AES-128-CTR from its own ``native/wire_cipher.cc``
(:func:`lighthouse_tpu_torch.native.aes128_ctr`), so it needs no system
library.  The KDFs stay on ``hashlib`` (``hashlib.scrypt`` exists where
Python was built against OpenSSL).
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import unicodedata
import uuid
from typing import Optional, Tuple

from .. import native
from . import key_derivation as kd

KEYSTORE_VERSION = 4
WALLET_VERSION = 1


class KeystoreError(Exception):
    pass


# ------------------------------------------------------------- AES-128-CTR


def aes128_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-128-CTR keystream XOR (encrypt == decrypt)."""
    if len(key) != 16 or len(iv) != 16:
        raise KeystoreError("aes-128-ctr needs 16-byte key and iv")
    return native.aes128_ctr(key, iv, data)


# ----------------------------------------------------------------- KDF


def _kdf_derive(password: bytes, kdf: dict) -> bytes:
    params = kdf["params"]
    salt = bytes.fromhex(params["salt"])
    if kdf["function"] == "scrypt":
        return hashlib.scrypt(
            password, salt=salt, n=params["n"], r=params["r"], p=params["p"],
            dklen=params["dklen"], maxmem=2**31 - 1,  # fits n=2^18, r=8 (256 MiB)
        )
    if kdf["function"] == "pbkdf2":
        return hashlib.pbkdf2_hmac(
            params["prf"].replace("hmac-", ""), password, salt, params["c"],
            dklen=params["dklen"],
        )
    raise KeystoreError(f"unsupported kdf {kdf['function']}")


def _normalize_password(password: str) -> bytes:
    """EIP-2335: NFKD normalize, strip C0/C1/DEL control codes."""
    norm = unicodedata.normalize("NFKD", password)
    return "".join(
        c for c in norm if not (ord(c) < 0x20 or 0x7F <= ord(c) < 0xA0)
    ).encode()


# ------------------------------------------------------------- keystore


def encrypt(secret: bytes, password: str, *, path: str = "",
            pubkey: Optional[bytes] = None, kdf: str = "scrypt",
            description: str = "",
            _test_fast_kdf: bool = False) -> dict:
    """Build an EIP-2335 v4 keystore JSON object for ``secret``.

    ``_test_fast_kdf`` lowers work factors (tests only — interop with other
    tooling requires the defaults)."""
    salt = secrets.token_bytes(32)
    iv = secrets.token_bytes(16)
    if kdf == "scrypt":
        n = 2**4 if _test_fast_kdf else 2**18
        kdf_module = {
            "function": "scrypt",
            "params": {"dklen": 32, "n": n, "r": 8, "p": 1, "salt": salt.hex()},
            "message": "",
        }
    elif kdf == "pbkdf2":
        c = 2**4 if _test_fast_kdf else 2**18
        kdf_module = {
            "function": "pbkdf2",
            "params": {"dklen": 32, "c": c, "prf": "hmac-sha256", "salt": salt.hex()},
            "message": "",
        }
    else:
        raise KeystoreError(f"unsupported kdf {kdf}")
    dk = _kdf_derive(_normalize_password(password), kdf_module)
    cipher_message = aes128_ctr(dk[:16], iv, secret)
    checksum = hashlib.sha256(dk[16:32] + cipher_message).hexdigest()
    return {
        "crypto": {
            "kdf": kdf_module,
            "checksum": {"function": "sha256", "params": {}, "message": checksum},
            "cipher": {
                "function": "aes-128-ctr",
                "params": {"iv": iv.hex()},
                "message": cipher_message.hex(),
            },
        },
        "description": description,
        "pubkey": pubkey.hex() if pubkey is not None else "",
        "path": path,
        "uuid": str(uuid.uuid4()),
        "version": KEYSTORE_VERSION,
    }


def decrypt(keystore: dict, password: str) -> bytes:
    """Recover the secret; raises KeystoreError on a wrong password."""
    if int(keystore.get("version", 0)) != KEYSTORE_VERSION:
        raise KeystoreError(f"unsupported keystore version {keystore.get('version')}")
    crypto = keystore["crypto"]
    dk = _kdf_derive(_normalize_password(password), crypto["kdf"])
    cipher_message = bytes.fromhex(crypto["cipher"]["message"])
    checksum = hashlib.sha256(dk[16:32] + cipher_message).hexdigest()
    if checksum != crypto["checksum"]["message"]:
        raise KeystoreError("wrong password (checksum mismatch)")
    if crypto["cipher"]["function"] != "aes-128-ctr":
        raise KeystoreError(f"unsupported cipher {crypto['cipher']['function']}")
    iv = bytes.fromhex(crypto["cipher"]["params"]["iv"])
    return aes128_ctr(dk[:16], iv, cipher_message)


# --------------------------------------------------------------- wallet


def create_wallet(name: str, password: str, *, seed: Optional[bytes] = None,
                  _test_fast_kdf: bool = False) -> Tuple[dict, bytes]:
    """EIP-2386 hierarchical-deterministic wallet: the encrypted master seed
    plus derivation bookkeeping.  Returns (wallet_json, seed)."""
    if seed is None:
        seed = secrets.token_bytes(32)
    crypto = encrypt(seed, password, _test_fast_kdf=_test_fast_kdf)["crypto"]
    wallet = {
        "crypto": crypto,
        "name": name,
        "nextaccount": 0,
        "type": "hierarchical deterministic",
        "uuid": str(uuid.uuid4()),
        "version": WALLET_VERSION,
    }
    return wallet, seed


def wallet_seed(wallet: dict, password: str) -> bytes:
    if wallet.get("type") != "hierarchical deterministic":
        raise KeystoreError(f"unsupported wallet type {wallet.get('type')}")
    return decrypt({"crypto": wallet["crypto"], "version": KEYSTORE_VERSION}, password)


def derive_validator_keystores(wallet: dict, wallet_password: str,
                               keystore_password: str, count: int,
                               _test_fast_kdf: bool = False):
    """Derive the next ``count`` validators at the EIP-2334 signing paths
    m/12381/3600/i/0/0; advances ``wallet['nextaccount']``.  Returns
    ``[(voting_keystore_json, secret_key_int)]``."""
    from .bls import api as bls

    seed = wallet_seed(wallet, wallet_password)
    out = []
    start = int(wallet["nextaccount"])
    for i in range(start, start + count):
        path = f"m/12381/3600/{i}/0/0"
        sk_int = kd.derive_path(seed, path)
        sk = bls.SecretKey(sk_int)
        ks = encrypt(
            sk_int.to_bytes(32, "big"), keystore_password,
            path=path, pubkey=sk.public_key().to_bytes(),
            _test_fast_kdf=_test_fast_kdf,
        )
        out.append((ks, sk_int))
    wallet["nextaccount"] = start + count
    return out


def load_keystore_signing_key(keystore: dict, password: str):
    from .bls import api as bls

    secret = decrypt(keystore, password)
    return bls.SecretKey(int.from_bytes(secret, "big"))


def save_json(obj: dict, path: str) -> None:
    # key material: owner-only permissions (the reference writes 0600 too)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        json.dump(obj, f, indent=2)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
