"""The two hand-written CUDA kernels of the epoch boundary, their plain
PyTorch versions, launch counters and the library loader.

Kernels (source ``lighthouse_tpu_torch/csrc/shuffle.cu``, built for
``sm_90a`` with ``nvcc`` into a plain-C shared library through
``ops/compile_cache.build_kernels``, loaded with ``ctypes``):

- ``shuffle_round``: one swap-or-not round over every lane of a registry
  bucket, launched once per round by :func:`shuffle_rounds`.  Replaces the
  XLA program ``lighthouse_tpu/ops/shuffle_device.py:_shuffle_kernel``.
- ``proposer_walk``: the spec's candidate walk of (slot, candidate) lanes,
  one SHA-256 block a round, several rounds a step (the lookahead, one of
  :data:`WALK_LOOKAHEADS`; the source's default on the main path, and
  :func:`_proposer_walk_k` forces it for the tests and the card's timing),
  by :func:`proposer_walk`.  Replaces the walk of
  ``lighthouse_tpu/ops/shuffle_device.py:_proposer_kernel`` (its
  acceptance stays in PyTorch, ``ops/shuffle_device.py``).

Values and pivots are int32 tensors, digest rows uint8, SHA words int32
tensors carrying the bits of uint32.  On a CUDA tensor a wrapper launches
its kernel on the current stream (or raises); on a CPU tensor it runs the
plain version (:func:`shuffle_rounds_plain`, :func:`proposer_walk_plain`),
the JAX package's round body in PyTorch, so kernel, plain version and JAX
package agree bit for bit.
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter
from typing import Optional

import torch

from .cuda_build import CSRC_DIR, check_cuda
from .cuda_sha import _H0, _compress, _to_u32

SOURCE = CSRC_DIR / "shuffle.cu"

#: The proposer walk's lookaheads (rounds resolved a step), and its most
#: rounds (the round is one byte of the hashed message).
WALK_LOOKAHEADS = (1, 2, 3, 4)
WALK_MAX_ROUNDS = 256

#: Kernel launches per kernel, bumped where each kernel is launched and
#: nowhere else (a shuffle of R rounds is R launches of ``shuffle_round``);
#: ``SIZES`` holds the number of those launches at each lane count.
LAUNCHES = {"shuffle_round": 0, "proposer_walk": 0}
SIZES = {"shuffle_round": Counter(), "proposer_walk": Counter()}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        SIZES[name].clear()


# ------------------------------------------------------------ plain versions


def shuffle_rounds_plain(values: torch.Tensor, pivots: torch.Tensor,
                         digests: torch.Tensor, n_live: int) -> torch.Tensor:
    """``shuffle_round_kernel`` over all rounds in plain PyTorch: (nb,)
    int32 values, (R,) int32 pivots (row 0 first), (R, row) uint8 digest
    rows; lanes at or past ``n_live`` never swap."""
    nb = values.shape[0]
    lane = torch.arange(nb, dtype=torch.int64, device=values.device)
    n_mod = max(int(n_live), 1)
    a = values
    for r in range(pivots.shape[0]):
        flip = torch.remainder(pivots[r].to(torch.int64) - lane, n_mod)
        position = torch.maximum(lane, flip)
        byte = digests[r][position >> 3].to(torch.int64)
        bit = (byte >> (position & 7)) & 1
        a = torch.where((bit == 1) & (lane < n_live), a[flip], a)
    return a


def proposer_walk_plain(seed_words: torch.Tensor, pivots: torch.Tensor,
                        k: int, m_live: int) -> torch.Tensor:
    """``proposer_walk_kernel`` in plain PyTorch: (S, 8) int32 seed words,
    (S, R) int32 pivots (forward round order) -> (S, k) int32 final
    positions of the candidate walks started at ``c mod m_live``."""
    s, rounds = pivots.shape
    dev = seed_words.device
    m_mod = max(int(m_live), 1)
    idx = (torch.arange(k, dtype=torch.int64, device=dev) % m_mod).expand(s, k)
    seed = _to_u32(seed_words)[:, None, :].expand(s, k, 8)
    h0 = [torch.full((s, k), int(v), dtype=torch.int64, device=dev) for v in _H0]
    zero = torch.zeros((s, k), dtype=torch.int64, device=dev)
    length = torch.full((s, k), 296, dtype=torch.int64, device=dev)  # 37 bytes
    for r in range(rounds):
        flip = torch.remainder(pivots[:, r:r + 1].to(torch.int64) + m_mod - idx, m_mod)
        position = torch.maximum(idx, flip)
        # 37-byte message `seed(32) | round(1) | chunk_le(4)` in one padded
        # block: word 8 = round | chunk bytes 0-2, word 9 = chunk byte 3 |
        # 0x80 terminator, word 15 = bit length.
        chunk = position >> 8
        w8 = ((r << 24) | ((chunk & 0xFF) << 16) | (((chunk >> 8) & 0xFF) << 8)
              | ((chunk >> 16) & 0xFF))
        w9 = (((chunk >> 24) & 0xFF) << 24) | (0x80 << 16)
        words = list(seed.unbind(-1)) + [w8, w9, zero, zero, zero, zero, zero, length]
        dig = torch.stack(_compress(h0, words), dim=-1)
        byte_idx = (position % 256) >> 3
        word = dig.gather(2, (byte_idx >> 2)[..., None])[..., 0]
        byte = (word >> ((3 - (byte_idx & 3)) * 8)) & 0xFF
        bit = (byte >> (position & 7)) & 1
        idx = torch.where(bit == 1, flip, idx)
    return idx.to(torch.int32)


# -------------------------------------------------------------- the library

_lib = None
_load_lock = threading.Lock()


def load_library(path) -> ctypes.CDLL:
    """A built shuffle kernel library with its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    ptr, i64, cint = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.lt_shuffle_rounds.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, cint, cint, cint, ptr]
    lib.lt_shuffle_rounds.restype = cint
    lib.lt_proposer_walk.argtypes = [ptr, ptr, ptr, cint, cint, cint, cint, ptr]
    lib.lt_proposer_walk.restype = cint
    lib.lt_proposer_walk_k.argtypes = [ptr, ptr, ptr, cint, cint, cint, cint, cint, ptr]
    lib.lt_proposer_walk_k.restype = cint
    lib.lt_walk_lookahead.argtypes = []
    lib.lt_walk_lookahead.restype = cint
    lib.lt_error_string.argtypes = [cint]
    lib.lt_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _load_lock:
        if _lib is None:
            from .compile_cache import build_kernels

            _lib = load_library(build_kernels()["shuffle"].path)
    return _lib


# ---------------------------------------------------------------- wrappers


def _check(x: torch.Tensor, dtype: torch.dtype, dims: int, name: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != dims:
        raise ValueError(f"{name} must have {dims} dimensions, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _same_device(first: torch.Tensor, *others: torch.Tensor) -> None:
    for x in others:
        if x.device != first.device:
            raise ValueError(f"operands on {first.device} and {x.device}")


def shuffle_rounds(values: torch.Tensor, pivots: torch.Tensor, digests: torch.Tensor,
                   n_live: int) -> torch.Tensor:
    """Every swap-or-not round of ``pivots`` / ``digests`` (row 0 first)
    over the (nb,) int32 ``values``: one launch of ``shuffle_round_kernel``
    a round on a CUDA tensor, the plain version on a CPU tensor."""
    _check(values, torch.int32, 1, "values")
    _check(pivots, torch.int32, 1, "pivots")
    _check(digests, torch.uint8, 2, "digests")
    _same_device(values, pivots, digests)
    nb, rounds = values.shape[0], pivots.shape[0]
    if digests.shape[0] != rounds:
        raise ValueError(f"{rounds} pivots but {digests.shape[0]} digest rows")
    if rounds and digests.shape[1] * 8 < nb:
        raise ValueError(f"digest rows of {digests.shape[1]} bytes cover fewer than {nb} lanes")
    if not 0 <= n_live <= nb:
        raise ValueError(f"n_live {n_live} outside [0, {nb}]")
    if values.device.type == "cpu":
        return shuffle_rounds_plain(values, pivots, digests, n_live)
    out = torch.empty_like(values)
    if nb == 0:
        return out
    scratch = torch.empty_like(values)
    lib = library()
    # The C entry points launch on the thread's current device: select the
    # input's device for the call and restore the caller's afterwards.
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lt_shuffle_rounds(
            values.data_ptr(), out.data_ptr(), scratch.data_ptr(), pivots.data_ptr(),
            digests.data_ptr(), digests.shape[1], rounds, int(n_live), nb, stream)
    check_cuda(lib, err, "lt_shuffle_rounds")
    LAUNCHES["shuffle_round"] += rounds
    SIZES["shuffle_round"][nb] += rounds
    return out


def walk_lookahead() -> int:
    """The lookahead the CUDA walk takes on the main path (the source's
    default; builds the library)."""
    return int(library().lt_walk_lookahead())


def proposer_walk(seed_words: torch.Tensor, pivots: torch.Tensor, k: int,
                  m_live: int) -> torch.Tensor:
    """The (S, k) final positions of the candidate walks over ``m_live``
    active validators: ``proposer_walk_kernel`` on a CUDA tensor, the plain
    version on a CPU tensor.  Each pivot counts mod max(m_live, 1)."""
    return _proposer_walk_k(seed_words, pivots, k, m_live, None)


def _proposer_walk_k(seed_words: torch.Tensor, pivots: torch.Tensor, k: int,
                     m_live: int, lookahead: Optional[int]) -> torch.Tensor:
    """:func:`proposer_walk` with the kernel's rounds a step forced to
    ``lookahead`` (one of :data:`WALK_LOOKAHEADS`), for the tests and the
    card's timing; None takes the source's default, as the main path does."""
    _check(seed_words, torch.int32, 2, "seed_words")
    _check(pivots, torch.int32, 2, "pivots")
    _same_device(seed_words, pivots)
    s = seed_words.shape[0]
    if seed_words.shape[1] != 8 or pivots.shape[0] != s:
        raise ValueError(f"seed_words {tuple(seed_words.shape)} and pivots "
                         f"{tuple(pivots.shape)} must be (S, 8) and (S, R)")
    if pivots.shape[1] > WALK_MAX_ROUNDS:
        raise ValueError(f"{pivots.shape[1]} rounds: the round is one byte, at most "
                         f"{WALK_MAX_ROUNDS}")
    if lookahead is not None and lookahead not in WALK_LOOKAHEADS:
        raise ValueError(f"lookahead must be one of {WALK_LOOKAHEADS}, got {lookahead}")
    if seed_words.device.type == "cpu":
        return proposer_walk_plain(seed_words, pivots, k, m_live)
    out = torch.empty((s, k), dtype=torch.int32, device=seed_words.device)
    if s == 0 or k == 0:
        return out
    lib = library()
    args = (seed_words.data_ptr(), pivots.data_ptr(), out.data_ptr(), s, pivots.shape[1], k,
            int(m_live))
    with torch.cuda.device(seed_words.device):
        stream = torch.cuda.current_stream().cuda_stream
        if lookahead is None:
            err = lib.lt_proposer_walk(*args, stream)
        else:
            err = lib.lt_proposer_walk_k(*args, lookahead, stream)
    check_cuda(lib, err, "lt_proposer_walk")
    LAUNCHES["proposer_walk"] += 1
    SIZES["proposer_walk"][s * k] += 1
    return out
