"""Native (C++) host components, compiled on demand with g++.

The port's copy of the JAX package's ``lighthouse_tpu/native``: the
batched SHA-256 pair hasher (``hash_pairs.cc``, SHA-NI where the CPU has
it, else libcrypto or a portable loop), built once into the port's build
directory (``lighthouse_tpu_torch/build/``, keyed by the source's hash)
and loaded with ctypes.  It is the host kernel of the SSZ Merkle layer
(``types/ssz.py``) and the golden host route of the hashing slice.  The
embedded store's ``lockbox.cc`` comes with the port of ``store/``.
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
