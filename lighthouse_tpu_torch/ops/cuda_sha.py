"""The two hand-written CUDA kernels of SHA-256 Merkleization, their plain
PyTorch versions, launch counters and the library loader.

Kernels (source ``lighthouse_tpu_torch/csrc/sha256.cu``, built for
``sm_90a`` with ``nvcc`` into a plain-C shared library through
``ops/compile_cache.build_kernels``, loaded with ``ctypes``):

- ``sha256_pairs``: SHA-256 of n independent 64-byte blocks, (n, 16)
  big-endian message words -> (n, 8) digest words.  Replaces the XLA
  program ``lighthouse_tpu/ops/sha256_device.py:_sha256_64byte_batch``.
- ``tree_hash_subtrees``: the five interior levels of m 32-leaf Merkle
  subtrees in one launch, (m, 32, 8) leaf words -> (m, 16, 8), (m, 8, 8),
  (m, 4, 8), (m, 2, 8), (m, 1, 8), with T threads a subtree (T in
  :data:`SUBTREE_THREADS`; the source's table picks T from m, and
  :func:`_tree_hash_subtrees_t` forces it for the tests and the card's
  timing).  Replaces
  the XLA program ``lighthouse_tpu/ops/tree_hash.py:_tree_hash_subtrees``.

Words are 32-bit values held in int32 tensors (torch's CUDA integer
arithmetic has no uint32 form; the bits are the same).  Each wrapper
takes a contiguous int32 tensor of exactly its shape.  On a CUDA tensor it
launches its kernel on the current stream (or raises); on a CPU tensor it
runs the plain version (:func:`sha256_pairs_plain`,
:func:`tree_hash_subtrees_plain`), the JAX package's round function in
PyTorch on int64 values below 2^32, so kernel, plain version and JAX
package agree word for word.
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from .cuda_build import CSRC_DIR, check_cuda

SOURCE = CSRC_DIR / "sha256.cu"

#: SHA-256 round constants, initial state, and the constant padding block
#: of an exactly-64-byte message (0x80, zeros, the bit length 512): the
#: JAX package's ``ops/sha256_device.py`` tables.
_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)

_PAD_WORDS = np.zeros(16, dtype=np.uint32)
_PAD_WORDS[0] = 0x80000000
_PAD_WORDS[15] = 512

#: Leaves and interior levels of one subtree of the fused subtree kernel.
SUBTREE_LEAVES = 32
SUBTREE_DEPTH = 5
#: The threads a subtree the subtree kernel can take.
SUBTREE_THREADS = (2, 4, 8, 16)

#: Kernel launches per wrapper, bumped where each kernel is launched and
#: nowhere else; ``SIZES`` holds the number of those launches at each row
#: (block or subtree) count.
LAUNCHES = {"sha256_pairs": 0, "tree_hash_subtrees": 0}
SIZES = {"sha256_pairs": Counter(), "tree_hash_subtrees": Counter()}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        SIZES[name].clear()


# ------------------------------------------------------------ plain versions

_MASK = 0xFFFFFFFF


def _to_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & _MASK


def _to_i32(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same bits as int32 words."""
    return torch.where(values >= 1 << 31, values - (1 << 32), values).to(torch.int32)


def _rotr3(x: torch.Tensor, r1: int, r2: int, r3: int) -> torch.Tensor:
    """XOR of three 32-bit right-rotations of ``x`` (int64, below 2^32):
    ``x`` doubled into both halves of an int64, so a right shift of the
    pair is the rotation in its low 32 bits."""
    y = x | (x << 32)
    return ((y >> r1) ^ (y >> r2) ^ (y >> r3)) & _MASK


def _sigma(x: torch.Tensor, r1: int, r2: int, s: int) -> torch.Tensor:
    """The schedule's small sigma: two rotations and a shift, XORed."""
    y = x | (x << 32)
    return ((y >> r1) ^ (y >> r2)) & _MASK ^ (x >> s)


def _schedule_plus_k(words) -> list:
    """The 64 schedule words of a 16-word block, each plus its round
    constant (Python ints)."""
    w = [int(v) for v in words]
    for i in range(16, 64):
        s0 = (((w[i - 15] >> 7) | (w[i - 15] << 25)) ^ ((w[i - 15] >> 18) | (w[i - 15] << 14))
              ^ (w[i - 15] >> 3)) & _MASK
        s1 = (((w[i - 2] >> 17) | (w[i - 2] << 15)) ^ ((w[i - 2] >> 19) | (w[i - 2] << 13))
              ^ (w[i - 2] >> 10)) & _MASK
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _MASK)
    return [w[i] + int(_K[i]) for i in range(64)]


#: The padding block of a 64-byte message is a constant: its schedule (plus
#: the round constants) is computed once.
_PAD_WK = _schedule_plus_k(_PAD_WORDS)


def _compress(state: list, w: Optional[list]) -> list:
    """One SHA-256 compression: ``state`` 8 int64 tensors of equal shape,
    values below 2^32, and ``w`` the block's 16 words as such tensors, or
    None for the constant padding block of a 64-byte message; the JAX
    package's ``_compress`` round function, with the schedule as a 16-word
    ring.  Sums stay below 2^35, so they are reduced mod 2^32 only where a
    value feeds a rotation or the next round."""
    ring = list(w) if w is not None else None
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr3(e, 6, 11, 25)
        ch = g ^ (e & (f ^ g))
        if ring is None:
            t1 = h + s1 + ch + _PAD_WK[i]
        else:
            t1 = h + s1 + ch + ring[0] + int(_K[i])
            if i < 48:
                w1, w14 = ring[1], ring[14]
                nxt = (ring[0] + _sigma(w1, 7, 18, 3) + ring[9] + _sigma(w14, 17, 19, 10)) & _MASK
                ring = ring[1:] + [nxt]
            else:
                ring = ring[1:]
        t2 = _rotr3(a, 2, 13, 22) + ((a & b) | (c & (a | b)))
        a, b, c, d, e, f, g, h = (t1 + t2) & _MASK, a, b, c, (d + t1) & _MASK, e, f, g
    return [(s + o) & _MASK for s, o in zip(state, (a, b, c, d, e, f, g, h))]


def _hash_blocks(words: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 message words -> (..., 8) int64 digest words."""
    lead = words.shape[:-1]
    state = [torch.full(lead, int(v), dtype=torch.int64, device=words.device) for v in _H0]
    state = _compress(state, list(words.unbind(-1)))
    return torch.stack(_compress(state, None), dim=-1)


def sha256_pairs_plain(words: torch.Tensor) -> torch.Tensor:
    """``sha256_pairs_kernel`` in plain PyTorch: (n, 16) int32 big-endian
    words of n 64-byte blocks -> (n, 8) int32 digest words."""
    return _to_i32(_hash_blocks(_to_u32(words)))


def tree_hash_subtrees_plain(leaves: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``tree_hash_subtrees_kernel`` in plain PyTorch: (m, 32, 8) int32 leaf
    words -> the five interior levels (m, 16, 8) ... (m, 1, 8)."""
    m = leaves.shape[0]
    level = _to_u32(leaves)
    out = []
    for _ in range(SUBTREE_DEPTH):
        level = _hash_blocks(level.reshape(m, level.shape[1] // 2, 16))
        out.append(_to_i32(level))
    return tuple(out)


# -------------------------------------------------------------- the library

_lib = None
_load_lock = threading.Lock()


def load_library(path) -> ctypes.CDLL:
    """A built SHA-256 kernel library with its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    ptr, i64, cint = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn in (lib.lt_sha256_pairs, lib.lt_tree_hash_subtrees):
        fn.argtypes = [ptr, ptr, i64, ptr]
        fn.restype = cint
    lib.lt_tree_hash_subtrees_t.argtypes = [ptr, ptr, i64, cint, ptr]
    lib.lt_tree_hash_subtrees_t.restype = cint
    lib.lt_subtree_threads.argtypes = [i64]
    lib.lt_subtree_threads.restype = cint
    lib.lt_error_string.argtypes = [cint]
    lib.lt_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _load_lock:
        if _lib is None:
            from .compile_cache import build_kernels

            _lib = load_library(build_kernels()["sha256"].path)
    return _lib


# ---------------------------------------------------------------- wrappers


def _check(x: torch.Tensor, tail: tuple, name: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if x.dim() != 1 + len(tail) or tuple(x.shape[1:]) != tail:
        raise ValueError(f"{name} must have shape (n, {', '.join(map(str, tail))}), "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _launch(name: str, fn_name: str, x: torch.Tensor, out: torch.Tensor, *extra) -> None:
    n = x.shape[0]
    lib = library()
    # The C entry points launch on the thread's current device: select the
    # input's device for the call and restore the caller's afterwards.
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(x.data_ptr(), out.data_ptr(), n, *extra, stream)
    check_cuda(lib, err, fn_name)
    LAUNCHES[name] += 1
    SIZES[name][n] += 1


def sha256_pairs(words: torch.Tensor) -> torch.Tensor:
    """SHA-256 of (n, 16) int32 big-endian words -> (n, 8): the CUDA kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    _check(words, (16,), "words")
    if words.device.type == "cpu":
        return sha256_pairs_plain(words)
    out = torch.empty((words.shape[0], 8), dtype=torch.int32, device=words.device)
    if words.shape[0]:
        _launch("sha256_pairs", "lt_sha256_pairs", words, out)
    return out


def subtree_threads(m: int) -> int:
    """The threads a subtree the CUDA kernel takes for m subtrees (the
    table in ``csrc/sha256.cu``; builds the library)."""
    return int(library().lt_subtree_threads(m))


def tree_hash_subtrees(leaves: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The five interior levels of (m, 32, 8) int32 subtree leaves: the CUDA
    kernel on a CUDA tensor (one launch, the levels as views of one
    buffer), the plain version on a CPU tensor."""
    return _tree_hash_subtrees_t(leaves, None)


def _tree_hash_subtrees_t(leaves: torch.Tensor, threads: Optional[int]
                          ) -> Tuple[torch.Tensor, ...]:
    """:func:`tree_hash_subtrees` with the kernel's threads a subtree forced
    to ``threads`` (one of :data:`SUBTREE_THREADS`), for the tests and the
    card's timing; None takes the source's table, as the main path does."""
    _check(leaves, (SUBTREE_LEAVES, 8), "leaves")
    if threads is not None and threads not in SUBTREE_THREADS:
        raise ValueError(f"threads must be one of {SUBTREE_THREADS}, got {threads}")
    if leaves.device.type == "cpu":
        return tree_hash_subtrees_plain(leaves)
    m = leaves.shape[0]
    out = torch.empty((SUBTREE_LEAVES - 1) * m * 8, dtype=torch.int32, device=leaves.device)
    if m and threads is None:
        _launch("tree_hash_subtrees", "lt_tree_hash_subtrees", leaves, out)
    elif m:
        _launch("tree_hash_subtrees", "lt_tree_hash_subtrees_t", leaves, out, threads)
    levels, start = [], 0
    for d in range(SUBTREE_DEPTH):
        width = SUBTREE_LEAVES >> (d + 1)
        levels.append(out[start:start + m * width * 8].view(m, width, 8))
        start += m * width * 8
    return tuple(levels)
