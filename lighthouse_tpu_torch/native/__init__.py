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
  a byte-for-byte copy of the JAX package's.
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
