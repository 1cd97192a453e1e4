"""Noise protocol framework core: Noise_XX_25519_ChaChaPoly_SHA256.

The exact pattern libp2p-noise mandates (and the reference's transport
uses).  Implements the framework's CipherState / SymmetricState /
HandshakeState objects (Noise spec rev 34) for the XX pattern:

    XX:
      -> e
      <- e, ee, s, es
      -> s, se

Both parties transmit their STATIC Noise key encrypted (identity-hiding),
and the final split() yields one CipherState per direction.

A copy of the JAX package's ``lighthouse_tpu/network/noise/protocol.py``,
with ChaCha20-Poly1305 from the port's native cipher
(``native/wire_cipher.cc``) in place of the ``cryptography`` package.
"""

from __future__ import annotations

import hashlib
import hmac
from typing import List, Optional, Tuple

from ... import native
from . import x25519

PROTOCOL_NAME = b"Noise_XX_25519_ChaChaPoly_SHA256"
HASHLEN = 32
DHLEN = 32


class NoiseError(Exception):
    pass


def _hmac_sha256(key: bytes, data: bytes) -> bytes:
    return hmac.new(key, data, hashlib.sha256).digest()


def _hkdf(chaining_key: bytes, ikm: bytes, n: int) -> List[bytes]:
    """Noise-spec HKDF: n in {2, 3}."""
    temp = _hmac_sha256(chaining_key, ikm)
    out1 = _hmac_sha256(temp, b"\x01")
    out2 = _hmac_sha256(temp, out1 + b"\x02")
    if n == 2:
        return [out1, out2]
    out3 = _hmac_sha256(temp, out2 + b"\x03")
    return [out1, out2, out3]


class CipherState:
    def __init__(self) -> None:
        self.k: Optional[bytes] = None
        self.n = 0

    def initialize_key(self, key: Optional[bytes]) -> None:
        self.k = key
        self.n = 0

    def has_key(self) -> bool:
        return self.k is not None

    def _nonce(self) -> bytes:
        # ChaChaPoly nonce: 4 zero bytes || little-endian u64 counter
        return b"\x00" * 4 + self.n.to_bytes(8, "little")

    def encrypt_with_ad(self, ad: bytes, plaintext: bytes) -> bytes:
        if self.k is None:
            return plaintext
        out = native.chacha20_poly1305_seal(self.k, self._nonce(), plaintext, ad)
        self.n += 1
        return out

    def decrypt_with_ad(self, ad: bytes, ciphertext: bytes) -> bytes:
        if self.k is None:
            return ciphertext
        try:
            out = native.chacha20_poly1305_open(self.k, self._nonce(), ciphertext, ad)
        except Exception as e:
            raise NoiseError(f"AEAD decryption failed: {e}") from e
        self.n += 1
        return out


class SymmetricState:
    def __init__(self) -> None:
        if len(PROTOCOL_NAME) <= HASHLEN:
            self.h = PROTOCOL_NAME.ljust(HASHLEN, b"\x00")
        else:
            self.h = hashlib.sha256(PROTOCOL_NAME).digest()
        self.ck = self.h
        self.cipher = CipherState()

    def mix_key(self, ikm: bytes) -> None:
        self.ck, temp_k = _hkdf(self.ck, ikm, 2)
        self.cipher.initialize_key(temp_k)

    def mix_hash(self, data: bytes) -> None:
        self.h = hashlib.sha256(self.h + data).digest()

    def encrypt_and_hash(self, plaintext: bytes) -> bytes:
        ct = self.cipher.encrypt_with_ad(self.h, plaintext)
        self.mix_hash(ct)
        return ct

    def decrypt_and_hash(self, ciphertext: bytes) -> bytes:
        pt = self.cipher.decrypt_with_ad(self.h, ciphertext)
        self.mix_hash(ciphertext)
        return pt

    def split(self) -> Tuple[CipherState, CipherState]:
        k1, k2 = _hkdf(self.ck, b"", 2)
        c1, c2 = CipherState(), CipherState()
        c1.initialize_key(k1)
        c2.initialize_key(k2)
        return c1, c2


class HandshakeState:
    """The XX pattern only — exactly what libp2p-noise speaks."""

    def __init__(self, initiator: bool, s_priv: Optional[bytes] = None,
                 prologue: bytes = b"") -> None:
        self.initiator = initiator
        self.ss = SymmetricState()
        self.ss.mix_hash(prologue)
        self.s_priv, self.s_pub = x25519.keypair(s_priv)
        self.e_priv: Optional[bytes] = None
        self.e_pub: Optional[bytes] = None
        self.rs: Optional[bytes] = None  # remote static
        self.re: Optional[bytes] = None  # remote ephemeral
        self.message_index = 0

    # -- message 1: -> e --------------------------------------------------

    def write_message_1(self, payload: bytes = b"") -> bytes:
        assert self.initiator and self.message_index == 0
        self.e_priv, self.e_pub = x25519.keypair()
        self.ss.mix_hash(self.e_pub)
        out = self.e_pub + self.ss.encrypt_and_hash(payload)
        self.message_index = 1
        return out

    def read_message_1(self, message: bytes) -> bytes:
        assert not self.initiator and self.message_index == 0
        self.re = message[:DHLEN]
        self.ss.mix_hash(self.re)
        payload = self.ss.decrypt_and_hash(message[DHLEN:])
        self.message_index = 1
        return payload

    # -- message 2: <- e, ee, s, es ---------------------------------------

    def write_message_2(self, payload: bytes = b"") -> bytes:
        assert not self.initiator and self.message_index == 1
        self.e_priv, self.e_pub = x25519.keypair()
        self.ss.mix_hash(self.e_pub)
        out = self.e_pub
        self.ss.mix_key(x25519.x25519(self.e_priv, self.re))          # ee
        out += self.ss.encrypt_and_hash(self.s_pub)                   # s
        self.ss.mix_key(x25519.x25519(self.s_priv, self.re))          # es
        out += self.ss.encrypt_and_hash(payload)
        self.message_index = 2
        return out

    def read_message_2(self, message: bytes) -> bytes:
        assert self.initiator and self.message_index == 1
        self.re = message[:DHLEN]
        self.ss.mix_hash(self.re)
        self.ss.mix_key(x25519.x25519(self.e_priv, self.re))          # ee
        enc_s = message[DHLEN:DHLEN + DHLEN + 16]
        self.rs = self.ss.decrypt_and_hash(enc_s)                     # s
        self.ss.mix_key(x25519.x25519(self.e_priv, self.rs))          # es
        payload = self.ss.decrypt_and_hash(message[DHLEN + DHLEN + 16:])
        self.message_index = 2
        return payload

    # -- message 3: -> s, se ----------------------------------------------

    def write_message_3(self, payload: bytes = b"") -> Tuple[bytes, CipherState, CipherState]:
        assert self.initiator and self.message_index == 2
        out = self.ss.encrypt_and_hash(self.s_pub)                    # s
        self.ss.mix_key(x25519.x25519(self.s_priv, self.re))          # se
        out += self.ss.encrypt_and_hash(payload)
        send, recv = self.ss.split()  # initiator sends with c1
        return out, send, recv

    def read_message_3(self, message: bytes) -> Tuple[bytes, CipherState, CipherState]:
        assert not self.initiator and self.message_index == 2
        enc_s = message[:DHLEN + 16]
        self.rs = self.ss.decrypt_and_hash(enc_s)                     # s
        self.ss.mix_key(x25519.x25519(self.e_priv, self.rs))          # se
        payload = self.ss.decrypt_and_hash(message[DHLEN + 16:])
        c1, c2 = self.ss.split()
        return payload, c2, c1  # responder sends with c2
