"""The port's key material (``crypto/keystore.py``, ``crypto/key_derivation.py``)
vs the JAX package's.

- EIP-2335 keystores: the port's ``encrypt`` gives the JAX package's JSON
  byte for byte when both draw the same salt, IV and UUID; each package
  decrypts the other's keystores; the two official vectors (scrypt and
  pbkdf2) decrypt to their known secrets; a wrong password is refused;
- the cipher: the port's AES-128-CTR (``native/wire_cipher.cc``) gives the
  JAX package's (OpenSSL's libcrypto) bytes;
- EIP-2333: the specification's vectors hold and ``derive_path`` agrees
  with the JAX package's; the BIP-39 seed is the JAX package's;
- EIP-2386: a wallet on a fixed seed derives the JAX package's EIP-2334
  keystores, and the official wallet vector decrypts.

Work factors are lowered (``_test_fast_kdf=True``) except where a case
checks the defaults or an official vector.
"""

import json
import secrets
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu.crypto import key_derivation as jkd  # noqa: E402
from lighthouse_tpu.crypto import keystore as jks  # noqa: E402
from lighthouse_tpu_torch.crypto import key_derivation as kd  # noqa: E402
from lighthouse_tpu_torch.crypto import keystore as ks  # noqa: E402

VECTORS = Path(__file__).parent / "vectors"
OFFICIAL = VECTORS / "conformance" / "tests" / "general" / "phase0"
FIXED_UUID = uuid.UUID("4e5a0c1f-9d2b-4f3a-8c6e-7b1d2e3f4a5b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def same_randomness(monkeypatch):
    """``secrets.token_bytes`` and ``uuid.uuid4`` made deterministic; call
    the returned ``reset()`` before each package's run so both draw the same
    salt, IV and UUID."""
    state = {}

    def reset(seed: int = 7):
        state["rng"] = np.random.default_rng(seed)

    def token_bytes(n):
        return state["rng"].integers(0, 256, n, dtype=np.uint8).tobytes()

    reset()
    monkeypatch.setattr(secrets, "token_bytes", token_bytes)
    monkeypatch.setattr(uuid, "uuid4", lambda: FIXED_UUID)
    return reset


def _official(kind: str, name: str):
    standard, body = ("eip2335", "keystore.json") if kind == "keystore" else \
        ("eip2386", "wallet.json")
    root = OFFICIAL / kind / standard / "official" / name
    return json.loads((root / body).read_text()), json.loads((root / "meta.json").read_text())


# ------------------------------------------------------------------ cipher


@pytest.mark.parametrize("size", [0, 1, 15, 16, 17, 32, 64, 1000])
def test_aes128_ctr_matches_jax(size):
    rng = np.random.default_rng(size)
    key, iv, data = (rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (16, 16, size))
    assert ks.aes128_ctr(key, iv, data) == jks.aes128_ctr(key, iv, data)
    assert ks.aes128_ctr(key, iv, ks.aes128_ctr(key, iv, data)) == data


def test_aes128_ctr_counter_wraps_like_jax():
    """The IV is one big-endian 128-bit counter: its carry crosses the
    64-bit halves in both packages."""
    key, iv = bytes(range(16)), b"\x00" * 8 + b"\xff" * 8
    data = bytes(48)
    assert ks.aes128_ctr(key, iv, data) == jks.aes128_ctr(key, iv, data)


def test_aes128_ctr_rejects_bad_sizes():
    with pytest.raises(ks.KeystoreError):
        ks.aes128_ctr(b"\x00" * 15, b"\x00" * 16, b"x")
    with pytest.raises(ks.KeystoreError):
        ks.aes128_ctr(b"\x00" * 16, b"\x00" * 12, b"x")


def test_keystore_loads_no_system_library():
    source = Path(ks.__file__).read_text()
    assert "find_library" not in source and "import ctypes" not in source


# ---------------------------------------------------------------- keystore


@pytest.mark.parametrize("kdf", ["scrypt", "pbkdf2"])
@pytest.mark.parametrize("password", ["pw", "𝔱𝔢𝔰𝔱𝔭𝔞𝔰𝔰𝔴𝔬𝔯𝔡🔑\x7f\x00"])
def test_encrypt_byte_identical_to_jax(same_randomness, kdf, password):
    secret = bytes(range(32))
    pubkey = b"\xab" * 48
    kw = dict(path="m/12381/3600/0/0/0", pubkey=pubkey, kdf=kdf, description="d",
              _test_fast_kdf=True)
    same_randomness()
    mine = ks.encrypt(secret, password, **kw)
    same_randomness()
    theirs = jks.encrypt(secret, password, **kw)
    assert json.dumps(mine, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    assert json.dumps(mine) == json.dumps(theirs)  # the key order too


def test_encrypt_defaults_byte_identical_to_jax(same_randomness):
    """The defaults a deployment uses: scrypt at n = 2^18, r = 8."""
    secret = b"\x11" * 32
    same_randomness(3)
    mine = ks.encrypt(secret, "password")
    same_randomness(3)
    theirs = jks.encrypt(secret, "password")
    assert mine == theirs
    assert mine["crypto"]["kdf"]["params"]["n"] == 2 ** 18
    assert ks.decrypt(mine, "password") == secret


@pytest.mark.parametrize("kdf", ["scrypt", "pbkdf2"])
def test_each_package_decrypts_the_others(kdf):
    secret = bytes(range(100, 132))
    mine = ks.encrypt(secret, "pässwörd", kdf=kdf, _test_fast_kdf=True)
    theirs = jks.encrypt(secret, "pässwörd", kdf=kdf, _test_fast_kdf=True)
    assert jks.decrypt(mine, "pässwörd") == secret
    assert ks.decrypt(theirs, "pässwörd") == secret
    assert ks.decrypt(mine, "pässwörd") == secret


def test_wrong_password_and_bad_versions_refused():
    ksj = ks.encrypt(b"\x01" * 32, "right", _test_fast_kdf=True)
    with pytest.raises(ks.KeystoreError, match="checksum"):
        ks.decrypt(ksj, "wrong")
    with pytest.raises(ks.KeystoreError, match="version"):
        ks.decrypt({**ksj, "version": 3}, "right")
    with pytest.raises(ks.KeystoreError, match="kdf"):
        ks.encrypt(b"\x01" * 32, "pw", kdf="argon2")


@pytest.mark.parametrize("name", ["scrypt", "pbkdf2"])
def test_official_eip2335_vectors(name):
    vector, meta = _official("keystore", name)
    assert ks.decrypt(vector, meta["password"]).hex() == meta["secret"]
    assert ks.load_keystore_signing_key(vector, meta["password"]).public_key() \
        .to_bytes().hex() == vector["pubkey"]
    with pytest.raises(ks.KeystoreError):
        ks.decrypt(vector, meta["password"] + "x")


def test_password_normalization_matches_jax():
    for pw in ["a\x00b\x1fc\x7fd\x9fe", "ｆｕｌｌ", "é", "𝔭"]:
        assert ks._normalize_password(pw) == jks._normalize_password(pw)


def test_save_json_is_owner_only(tmp_path):
    path = tmp_path / "k.json"
    ks.save_json({"a": 1}, str(path))
    assert path.stat().st_mode & 0o777 == 0o600
    assert ks.load_json(str(path)) == {"a": 1}


# ---------------------------------------------------------------- EIP-2333


def test_eip2333_vectors():
    for case in json.loads((VECTORS / "eip2333.json").read_text())["cases"]:
        master = kd.derive_master_sk(bytes.fromhex(case["seed"]))
        assert master == int(case["master_sk"])
        assert kd.derive_child_sk(master, int(case["child_index"])) == int(case["child_sk"])


@pytest.mark.parametrize("path", ["m", "m/12381/3600/0/0", "m/12381/3600/0/0/0",
                                  "m/12381/3600/7/0/0", "m/4294967295/1"])
def test_derive_path_matches_jax(path):
    seed = bytes(range(64))
    assert kd.derive_path(seed, path) == jkd.derive_path(seed, path)


def test_bad_paths_and_seeds_refused():
    with pytest.raises(ValueError):
        kd.derive_path(bytes(32), "x/1")
    with pytest.raises(ValueError):
        kd.derive_path(bytes(32), "m/a")
    with pytest.raises(ValueError):
        kd.derive_master_sk(bytes(31))
    with pytest.raises(ValueError):
        kd.derive_child_sk(1, 2 ** 32)


def test_mnemonic_seed_matches_jax():
    words = "abandon " * 11 + "about"
    assert kd.mnemonic_to_seed(words, "TREZOR") == jkd.mnemonic_to_seed(words, "TREZOR")
    assert kd.mnemonic_to_seed(words).hex().startswith(
        "5eb00bbddcf069084889a8ab9155568165f5c453ccb85e70811aaed6f6da5fc1")


# ---------------------------------------------------------------- EIP-2386


def test_wallet_derives_jax_keystores(same_randomness):
    seed = bytes(range(32, 64))
    same_randomness(11)
    wallet, got_seed = ks.create_wallet("w", "wpw", seed=seed, _test_fast_kdf=True)
    mine = ks.derive_validator_keystores(wallet, "wpw", "kpw", 3, _test_fast_kdf=True)
    same_randomness(11)
    jwallet, _ = jks.create_wallet("w", "wpw", seed=seed, _test_fast_kdf=True)
    theirs = jks.derive_validator_keystores(jwallet, "wpw", "kpw", 3, _test_fast_kdf=True)
    assert got_seed == seed and wallet == jwallet
    assert [sk for _, sk in mine] == [sk for _, sk in theirs]
    assert [k for k, _ in mine] == [k for k, _ in theirs]
    assert wallet["nextaccount"] == 3
    for i, (keystore, sk) in enumerate(mine):
        assert keystore["path"] == f"m/12381/3600/{i}/0/0"
        assert sk == jkd.derive_path(seed, keystore["path"])
        assert jks.decrypt(keystore, "kpw") == sk.to_bytes(32, "big")


def test_wallet_refuses_other_types():
    wallet, _ = ks.create_wallet("w", "pw", _test_fast_kdf=True)
    assert ks.wallet_seed(wallet, "pw") == jks.wallet_seed(wallet, "pw")
    with pytest.raises(ks.KeystoreError):
        ks.wallet_seed({**wallet, "type": "non-deterministic"}, "pw")


def test_official_eip2386_wallet():
    vector, meta = _official("wallet", "pbkdf2")
    assert ks.wallet_seed(vector, meta["password"]).hex() == meta["seed"]
