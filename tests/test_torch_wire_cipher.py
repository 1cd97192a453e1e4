"""The port's wire ciphers (``native/wire_cipher.cc`` through
``lighthouse_tpu_torch.native``), which stand where the JAX package calls
the ``cryptography`` package: ChaCha20-Poly1305 for Noise frames,
AES-128-CTR and AES-128-GCM for discv5 packets.

- published vectors held as constants: RFC 8439 section 2.8.2, the GCM
  specification's test cases 1-4 and 6 (the ones NIST SP 800-38D's
  validation uses; case 6 has a 60-byte IV), NIST SP 800-38A F.5.1
  (CTR-AES128) and FIPS-197 appendix C.1;
- the same bytes as ``cryptography`` on seeded random inputs of 0 to
  4,096 bytes, with and without associated data (skipped where the
  package is missing: the port itself never needs it);
- a flipped byte anywhere in the ciphertext, the tag or the associated
  data, or another nonce, raises ``InvalidTag``.
"""

import random

import pytest

from lighthouse_tpu_torch import native
from test_torch_chain import one_torch_thread  # noqa: F401

SEED = 0x5EA1
LENGTHS = (0, 1, 15, 16, 17, 63, 64, 65, 255, 1000, 4096)

# RFC 8439 section 2.8.2
RFC_KEY = bytes(range(0x80, 0xA0))
RFC_NONCE = bytes.fromhex("070000004041424344454647")
RFC_AD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
RFC_PT = (b"Ladies and Gentlemen of the class of '99: If I could offer you only one "
          b"tip for the future, sunscreen would be it.")
RFC_CT = bytes.fromhex(
    "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
    "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
    "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
    "3ff4def08e4b7a9de576d26586cec64b6116")
RFC_TAG = bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")

# The GCM specification's test cases (key, IV, plaintext, AD, ciphertext, tag)
GCM_K = bytes.fromhex("feffe9928665731c6d6a8f9467308308")
GCM_P = bytes.fromhex(
    "d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
    "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255")
GCM_C = bytes.fromhex(
    "42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
    "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091473f5985")
GCM_IV = bytes.fromhex("cafebabefacedbaddecaf888")
GCM_A = bytes.fromhex("feedfacedeadbeeffeedfacedeadbeefabaddad2")
GCM_IV6 = bytes.fromhex(
    "9313225df88406e555909c5aff5269aa6a7a9538534f7da1e4c303d2a318a728"
    "c3c0c95156809539fcf0e2429a6b525416aedbf5a0de6a57a637b39b")
GCM_CASES = {
    "case1": (bytes(16), bytes(12), b"", b"", b"", "58e2fccefa7e3061367f1d57a4e7455a"),
    "case2": (bytes(16), bytes(12), bytes(16), b"",
              bytes.fromhex("0388dace60b6a392f328c2b971b2fe78"),
              "ab6e47d42cec13bdf53a67b21257bddf"),
    "case3": (GCM_K, GCM_IV, GCM_P, b"", GCM_C, "4d5c2af327cd64a62cf35abd2ba6fab4"),
    "case4": (GCM_K, GCM_IV, GCM_P[:60], GCM_A, GCM_C[:60], "5bc94fbc3221a5db94fae95ae7121a47"),
    "case6": (GCM_K, GCM_IV6, GCM_P[:60], GCM_A, bytes.fromhex(
        "8ce24998625615b603a033aca13fb894be9112a5c3a211a8ba262a3cca7e2ca7"
        "01e4a9a4fba43c90ccdcb281d48c7c6fd62875d2aca417034c34aee5"),
        "619cc5aefffe0bfa462af43c1699d050"),
}

# NIST SP 800-38A F.5.1, CTR-AES128.Encrypt
CTR_KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
CTR_IV = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
CTR_PT = bytes.fromhex(
    "6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
    "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
CTR_CT = bytes.fromhex(
    "874d6191b620e3261bef6864990db6ce9806f66b7970fdff8617187bb9fffdff"
    "5ae4df3edbd5d35e5b4f09020db03eab1e031dda2fbe03d1792170a0f3009cee")


# ------------------------------------------------------------------ vectors


def test_chacha20_poly1305_rfc8439_vector():
    sealed = native.chacha20_poly1305_seal(RFC_KEY, RFC_NONCE, RFC_PT, RFC_AD)
    assert sealed == RFC_CT + RFC_TAG
    assert native.chacha20_poly1305_open(RFC_KEY, RFC_NONCE, sealed, RFC_AD) == RFC_PT


@pytest.mark.parametrize("case", sorted(GCM_CASES))
def test_aes128_gcm_spec_vectors(case):
    key, iv, pt, ad, ct, tag = GCM_CASES[case]
    sealed = native.aes128_gcm_seal(key, iv, pt, ad)
    assert sealed == ct + bytes.fromhex(tag)
    assert native.aes128_gcm_open(key, iv, sealed, ad) == pt


def test_aes128_ctr_sp800_38a_vector():
    assert native.aes128_ctr(CTR_KEY, CTR_IV, CTR_PT) == CTR_CT
    assert native.aes128_ctr(CTR_KEY, CTR_IV, CTR_CT) == CTR_PT
    # a prefix is the prefix of the keystream: the header decode's two reads
    assert native.aes128_ctr(CTR_KEY, CTR_IV, CTR_PT[:23]) == CTR_CT[:23]


def test_aes128_block_fips197_appendix_c1():
    """One CTR block over zeros is the AES-128 encryption of the counter."""
    out = native.aes128_ctr(bytes(range(16)), bytes.fromhex("00112233445566778899aabbccddeeff"),
                            bytes(16))
    assert out.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


# ------------------------------------------------------------- cryptography


def _inputs(rng: random.Random, with_ad: bool):
    for n in LENGTHS:
        yield rng.randbytes(n), rng.randbytes(rng.choice((1, 12, 33, 300))) if with_ad else b""


@pytest.mark.parametrize("with_ad", [False, True], ids=["no_ad", "ad"])
def test_chacha20_poly1305_matches_cryptography(with_ad):
    aead = pytest.importorskip("cryptography.hazmat.primitives.ciphers.aead")
    rng = random.Random(SEED + with_ad)
    for pt, ad in _inputs(rng, with_ad):
        key, nonce = rng.randbytes(32), rng.randbytes(12)
        want = aead.ChaCha20Poly1305(key).encrypt(nonce, pt, ad or None)
        assert native.chacha20_poly1305_seal(key, nonce, pt, ad) == want
        assert native.chacha20_poly1305_open(key, nonce, want, ad) == pt


@pytest.mark.parametrize("with_ad", [False, True], ids=["no_ad", "ad"])
def test_aes128_gcm_matches_cryptography(with_ad):
    aead = pytest.importorskip("cryptography.hazmat.primitives.ciphers.aead")
    rng = random.Random(SEED + 2 + with_ad)
    for pt, ad in _inputs(rng, with_ad):
        key = rng.randbytes(16)
        for nonce in (rng.randbytes(12), rng.randbytes(rng.choice((8, 16, 60)))):
            want = aead.AESGCM(key).encrypt(nonce, pt, ad or None)
            assert native.aes128_gcm_seal(key, nonce, pt, ad) == want
            assert native.aes128_gcm_open(key, nonce, want, ad) == pt


def test_aes128_ctr_matches_cryptography():
    ciphers = pytest.importorskip("cryptography.hazmat.primitives.ciphers")
    rng = random.Random(SEED + 4)
    for n in LENGTHS:
        key = rng.randbytes(16)
        # a random counter, and one whose 128-bit increment wraps
        for iv in (rng.randbytes(16), b"\xff" * 16, b"\x00" * 8 + b"\xff" * 8):
            data = rng.randbytes(n)
            enc = ciphers.Cipher(ciphers.algorithms.AES(key), ciphers.modes.CTR(iv)).encryptor()
            assert native.aes128_ctr(key, iv, data) == enc.update(data) + enc.finalize()


# ------------------------------------------------------------------ refusals


def _flips(sealed: bytes, ad: bytes, rng: random.Random):
    """(ciphertext, ad) pairs with one flipped bit: in the ciphertext, in
    the tag, in the associated data."""
    body = len(sealed) - native.TAG_BYTES
    spots = [("tag", rng.randrange(body, len(sealed)))]
    if body:
        spots.append(("ct", rng.randrange(body)))
    for where, i in spots:
        bad = bytearray(sealed)
        bad[i] ^= 1 << rng.randrange(8)
        yield where, bytes(bad), ad
    if ad:
        bad = bytearray(ad)
        bad[rng.randrange(len(ad))] ^= 1
        yield "ad", sealed, bytes(bad)


AEADS = {
    "chacha20_poly1305": (32, native.chacha20_poly1305_seal, native.chacha20_poly1305_open),
    "aes128_gcm": (16, native.aes128_gcm_seal, native.aes128_gcm_open),
}


@pytest.mark.parametrize("aead", sorted(AEADS))
def test_flipped_byte_raises(aead):
    key_len, seal, open_ = AEADS[aead]
    rng = random.Random(SEED + 5)
    for n in (0, 1, 16, 100, 4096):
        key, nonce = rng.randbytes(key_len), rng.randbytes(12)
        pt, ad = rng.randbytes(n), rng.randbytes(rng.choice((0, 7, 32)))
        sealed = seal(key, nonce, pt, ad)
        for where, ct, bad_ad in _flips(sealed, ad, rng):
            with pytest.raises(native.InvalidTag):
                open_(key, nonce, ct, bad_ad)
        other = bytearray(nonce)
        other[0] ^= 0x80
        with pytest.raises(native.InvalidTag):
            open_(key, bytes(other), sealed, ad)
        with pytest.raises(native.InvalidTag):
            open_(key, nonce, sealed[: native.TAG_BYTES - 1], ad)
        assert open_(key, nonce, sealed, ad) == pt


def test_bad_sizes_raise_value_error():
    with pytest.raises(ValueError):
        native.chacha20_poly1305_seal(bytes(16), bytes(12), b"x")
    with pytest.raises(ValueError):
        native.chacha20_poly1305_seal(bytes(32), bytes(8), b"x")
    with pytest.raises(ValueError):
        native.aes128_gcm_seal(bytes(32), bytes(12), b"x")
    with pytest.raises(ValueError):
        native.aes128_gcm_seal(bytes(16), bytes(4), b"x")
    with pytest.raises(ValueError):
        native.aes128_ctr(bytes(16), bytes(12), b"x")


def test_noise_and_discv5_refuse_through_their_own_errors():
    """A failed tag reaches the callers' ``except`` paths as in the JAX
    package: Noise raises its ``NoiseError``; discv5's ``decrypt_message``
    raises (the service catches any exception there)."""
    from lighthouse_tpu_torch.network.discv5 import packets
    from lighthouse_tpu_torch.network.noise.protocol import CipherState, NoiseError

    send, recv = CipherState(), CipherState()
    send.initialize_key(RFC_KEY)
    recv.initialize_key(RFC_KEY)
    ct = bytearray(send.encrypt_with_ad(b"h", b"frame"))
    ct[0] ^= 1
    with pytest.raises(NoiseError):
        recv.decrypt_with_ad(b"h", bytes(ct))
    assert recv.n == 0  # a refused frame does not advance the nonce
    ct = packets.encrypt_message(GCM_K, GCM_IV, b"msg", b"ad")
    with pytest.raises(native.InvalidTag):
        packets.decrypt_message(GCM_K, GCM_IV, ct, b"other ad")
