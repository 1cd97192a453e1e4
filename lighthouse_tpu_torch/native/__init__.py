"""Native (C++) host components, compiled on demand with g++.

The port's copy of the JAX package's ``lighthouse_tpu/native``, two
sources built once into the port's build directory
(``lighthouse_tpu_torch/build/``, each library named by its source's hash)
and loaded with ctypes:

- ``hash_pairs.cc``: the batched SHA-256 pair hasher (SHA-NI where the CPU
  has it, else libcrypto or a portable loop), the host kernel of the SSZ
  Merkle layer (``types/ssz.py``) and the golden host route of the hashing
  slice;
- ``lockbox.cc``: the embedded key-value engine behind
  ``store.lockbox_store.LockboxStore`` (the reference links LevelDB there),
  a byte-for-byte copy of the JAX package's;
- ``wire_cipher.cc``: the wire's ciphers, ChaCha20-Poly1305 (RFC 8439) for
  Noise frames and AES-128-CTR / AES-128-GCM (NIST SP 800-38D) for discv5
  packets, where the JAX package calls the ``cryptography`` package: the
  functions below take the same inputs, give the same bytes and raise
  :class:`InvalidTag` where a tag does not verify.  ctypes releases the GIL
  for each call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parent / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_BUILD_LOCK = threading.Lock()
_HASH_LIB = None
_LOCKBOX_LIB = None
_CIPHER_LIB = None
TAG_BYTES = 16


def _compile_and_load(src_name: str, stem: str, extra_flags=()) -> ctypes.CDLL:
    """Compile ``src_name`` into a library named by its content hash (unless
    one is there already) and load it."""
    src = SOURCE_DIR / src_name
    flags = (*GXX_FLAGS, *extra_flags)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"lib{stem}-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src), *extra_flags],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def load_hash_pairs() -> ctypes.CDLL:
    """Compile (if needed) and load the batched SHA-256 pair hasher."""
    global _HASH_LIB
    if _HASH_LIB is not None:
        return _HASH_LIB
    with _BUILD_LOCK:
        if _HASH_LIB is not None:
            return _HASH_LIB
        lib = _compile_and_load("hash_pairs.cc", "hashpairs", ["-ldl", "-lpthread"])
        lib.hash_pairs.restype = ctypes.c_int
        lib.hash_pairs.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
        ]
        _HASH_LIB = lib
        return lib


def load_lockbox() -> ctypes.CDLL:
    """Compile (if needed) and load the lockbox engine."""
    global _LOCKBOX_LIB
    if _LOCKBOX_LIB is not None:
        return _LOCKBOX_LIB
    with _BUILD_LOCK:
        if _LOCKBOX_LIB is not None:
            return _LOCKBOX_LIB
        lib = _compile_and_load("lockbox.cc", "lockbox")
        lib.lockbox_open.restype = ctypes.c_void_p
        lib.lockbox_open.argtypes = [ctypes.c_char_p]
        lib.lockbox_close.argtypes = [ctypes.c_void_p]
        lib.lockbox_put.restype = ctypes.c_int
        lib.lockbox_put.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.lockbox_get.restype = ctypes.c_int64
        lib.lockbox_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.lockbox_delete.restype = ctypes.c_int
        lib.lockbox_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        lib.lockbox_count.restype = ctypes.c_uint64
        lib.lockbox_count.argtypes = [ctypes.c_void_p]
        lib.lockbox_keys.restype = ctypes.c_uint64
        lib.lockbox_keys.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.lockbox_flush.restype = ctypes.c_int
        lib.lockbox_flush.argtypes = [ctypes.c_void_p]
        lib.lockbox_compact.restype = ctypes.c_int
        lib.lockbox_compact.argtypes = [ctypes.c_void_p]
        _LOCKBOX_LIB = lib
        return lib


def load_wire_cipher() -> ctypes.CDLL:
    """Compile (if needed) and load the wire's ciphers."""
    global _CIPHER_LIB
    if _CIPHER_LIB is not None:
        return _CIPHER_LIB
    with _BUILD_LOCK:
        if _CIPHER_LIB is not None:
            return _CIPHER_LIB
        lib = _compile_and_load("wire_cipher.cc", "wirecipher")
        buf, n = ctypes.c_char_p, ctypes.c_uint64
        for name in ("wc_chacha20_poly1305_seal", "wc_chacha20_poly1305_open"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [buf, buf, buf, n, buf, n, buf]
        lib.wc_aes128_ctr.restype = ctypes.c_int
        lib.wc_aes128_ctr.argtypes = [buf, buf, buf, n, buf]
        for name in ("wc_aes128_gcm_seal", "wc_aes128_gcm_open"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [buf, buf, n, buf, n, buf, n, buf]
        _CIPHER_LIB = lib
        return lib


class InvalidTag(Exception):
    """An AEAD tag did not verify (the ciphertext, its tag, the key, the
    nonce or the associated data is not the one sealed)."""


def _sizes(key: bytes, key_len: int, nonce: bytes, nonce_ok, what: str) -> None:
    if len(key) != key_len:
        raise ValueError(f"{what} needs a {key_len}-byte key, not {len(key)}")
    if not nonce_ok(len(nonce)):
        raise ValueError(f"{what}: a nonce of {len(nonce)} bytes")


def chacha20_poly1305_seal(key: bytes, nonce: bytes, plaintext: bytes, ad: bytes = b"") -> bytes:
    """RFC 8439 ChaCha20-Poly1305: the ciphertext and its 16-byte tag."""
    _sizes(key, 32, nonce, lambda n: n == 12, "ChaCha20-Poly1305")
    out = ctypes.create_string_buffer(len(plaintext) + TAG_BYTES)
    load_wire_cipher().wc_chacha20_poly1305_seal(
        bytes(key), bytes(nonce), bytes(ad), len(ad), bytes(plaintext), len(plaintext), out)
    return out.raw


def chacha20_poly1305_open(key: bytes, nonce: bytes, ciphertext: bytes, ad: bytes = b"") -> bytes:
    """The plaintext of :func:`chacha20_poly1305_seal`'s output; raises
    :class:`InvalidTag` where its tag does not verify."""
    _sizes(key, 32, nonce, lambda n: n == 12, "ChaCha20-Poly1305")
    if len(ciphertext) < TAG_BYTES:
        raise InvalidTag("ciphertext shorter than its tag")
    out = ctypes.create_string_buffer(len(ciphertext) - TAG_BYTES)
    if load_wire_cipher().wc_chacha20_poly1305_open(
            bytes(key), bytes(nonce), bytes(ad), len(ad), bytes(ciphertext), len(ciphertext),
            out):
        raise InvalidTag("ChaCha20-Poly1305 tag mismatch")
    return out.raw


def aes128_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-128 in CTR mode, the 16-byte ``iv`` the initial counter block
    (incremented as one big-endian integer): encrypts and decrypts."""
    _sizes(key, 16, iv, lambda n: n == 16, "AES-128-CTR")
    out = ctypes.create_string_buffer(len(data))
    load_wire_cipher().wc_aes128_ctr(bytes(key), bytes(iv), bytes(data), len(data), out)
    return out.raw


def aes128_gcm_seal(key: bytes, nonce: bytes, plaintext: bytes, ad: bytes = b"") -> bytes:
    """AES-128-GCM (NIST SP 800-38D): the ciphertext and its 16-byte tag.
    Nonces of 8 to 128 bytes, as the ``cryptography`` package takes."""
    _sizes(key, 16, nonce, lambda n: 8 <= n <= 128, "AES-128-GCM")
    out = ctypes.create_string_buffer(len(plaintext) + TAG_BYTES)
    load_wire_cipher().wc_aes128_gcm_seal(
        bytes(key), bytes(nonce), len(nonce), bytes(ad), len(ad), bytes(plaintext),
        len(plaintext), out)
    return out.raw


def aes128_gcm_open(key: bytes, nonce: bytes, ciphertext: bytes, ad: bytes = b"") -> bytes:
    """The plaintext of :func:`aes128_gcm_seal`'s output; raises
    :class:`InvalidTag` where its tag does not verify."""
    _sizes(key, 16, nonce, lambda n: 8 <= n <= 128, "AES-128-GCM")
    if len(ciphertext) < TAG_BYTES:
        raise InvalidTag("ciphertext shorter than its tag")
    out = ctypes.create_string_buffer(len(ciphertext) - TAG_BYTES)
    if load_wire_cipher().wc_aes128_gcm_open(
            bytes(key), bytes(nonce), len(nonce), bytes(ad), len(ad), bytes(ciphertext),
            len(ciphertext), out):
        raise InvalidTag("AES-128-GCM tag mismatch")
    return out.raw
