"""The two hand-written CUDA kernels of the Fq product, their plain PyTorch
versions, launch counters and the build.

Kernels (source ``lighthouse_tpu_torch/csrc/fq_mul.cu``, built for
``sm_90a`` with ``nvcc`` into a plain-C shared library, loaded with
``ctypes``):

- ``fq_mul``: batched Fq products, (n, 25) x (n, 25) -> (n, 25) int32.
  Replaces the Pallas kernel ``lighthouse_tpu/ops/pallas_fq.py:_fq_mul_kernel``.
- ``fq2_mul``: batched Fq2 products by Karatsuba, (n, 2, 25) x (n, 2, 25) ->
  (n, 2, 25), three product pipelines and the recombination in one launch.
  Replaces ``lighthouse_tpu/ops/pallas_fq.py:_fq2_mul_kernel``.

Each wrapper takes contiguous int32 tensors of exactly those shapes.  On a
CUDA tensor it launches its kernel on the current stream (or raises); on a
CPU tensor it runs the plain version (``fq_mul_plain`` / ``fq2_mul_plain``),
the same int32 pipeline as the JAX package's ``ops/fq.py:_fq_mul_int32``, so
kernel, plain version and JAX package agree limb for limb.

The library is built at first use into ``lighthouse_tpu_torch/build/`` (a
file name keyed by the source's hash), or ahead of time by :func:`build`;
:func:`build` and :func:`load_library` also take another source with the
same C entry points (``lighthouse_tpu_torch/bench_kernels.py`` times an
earlier version of the kernels that way).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .fq import CONV8, L16, RED_IN, RED_OUT, REDMAT8, SPLIT8, fold8_2, fold16_2, reduce8, split16_to_8

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "fq_mul.cu"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Kernel launches per wrapper, bumped where each kernel is launched and
#: nowhere else; ``SIZES`` holds the number of those launches at each row
#: count.
LAUNCHES = {"fq_mul": 0, "fq2_mul": 0}
SIZES = {"fq_mul": Counter(), "fq2_mul": Counter()}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        SIZES[name].clear()


# ------------------------------------------------------------ plain versions


def conv54(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of two radix-2^8 digit vectors, (.., 54) x (.., 54)
    -> (.., 107), exact in int32 (every coefficient stays below 2^24).

    Torch has no integer matrix product on CUDA, so the JAX package's
    one-hot einsum becomes an outer product whose rows are skewed (row i
    shifted right by i, by padding each row to 108 and re-viewing the flat
    buffer at width 107) and summed down the columns."""
    lead = a8.shape[:-1]
    outer = a8.unsqueeze(-1) * b8.unsqueeze(-2)              # (.., 54, 54)
    skew = F.pad(outer, (0, SPLIT8)).reshape(*lead, SPLIT8 * 2 * SPLIT8)
    skew = skew[..., : SPLIT8 * CONV8].reshape(*lead, SPLIT8, CONV8)
    return skew.sum(dim=-2, dtype=torch.int32)


def fq_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Fq kernel's pipeline in plain PyTorch (any device, any matching
    leading shape): fold16_2 + split, convolution, fold8_2, reduction."""
    a8 = split16_to_8(fold16_2(a))
    b8 = split16_to_8(fold16_2(b))
    return reduce8(fold8_2(conv54(a8, b8)))


def fq2_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Fq2 kernel in plain PyTorch: Karatsuba's three products
    (a0 b0, a1 b1, (a0+a1)(b0+b1)) and the recombination
    (t0 - t1, t2 - t0 - t1), on (.., 2, 25) operands."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    t = fq_mul_plain(torch.stack([a0, a1, a0 + a1], dim=-2),
                     torch.stack([b0, b1, b0 + b1], dim=-2))
    t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    return torch.stack([t0 - t1, t2 - t0 - t1], dim=-2)


# ------------------------------------------------------------------- build


class BuildResult(NamedTuple):
    path: Path
    seconds: float  # 0.0 when an up-to-date library was found
    log: str        # nvcc's output, -Xptxas -v included ("" when reused)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfq_mul-{digest.hexdigest()[:12]}.so"


def build(force: bool = False, source: Path = SOURCE) -> BuildResult:
    """Compile ``source`` (by default ``csrc/fq_mul.cu``) with nvcc for
    sm_90a, unless a library built from the same source and flags is
    already there."""
    path = library_path(source)
    if path.exists() and not force:
        return BuildResult(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees old or new, whole
    return BuildResult(path, seconds, log)


_RED_W = 64  # table rows RED_OUT..RED_IN-1, zero padded, as in the CUDA source
_lib = None
_ready_devices: set = set()
_load_lock = threading.Lock()


def reduction_table() -> np.ndarray:
    """The kernels' reduction table: rows ``RED_OUT..RED_IN-1`` of
    ``REDMAT8``, transposed and zero padded to (RED_OUT, 64) int32, as
    ``lt_fq_init`` takes it.  The rows below ``RED_OUT`` are unit vectors
    (2^8k < p), which the kernels apply as an add, not a product."""
    if not np.array_equal(REDMAT8[:RED_OUT], np.eye(RED_OUT, dtype=REDMAT8.dtype)):
        raise AssertionError("REDMAT8 rows below RED_OUT are not unit vectors")
    table = np.zeros((RED_OUT, _RED_W), np.int32)
    table[:, : RED_IN - RED_OUT] = REDMAT8[RED_OUT:].T
    return table


def load_library(path: Path) -> ctypes.CDLL:
    """A built kernel library with its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    ptr, i64, cint = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.lt_fq_init.argtypes = [ptr]
    lib.lt_fq_init.restype = cint
    for fn in (lib.lt_fq_mul, lib.lt_fq2_mul):
        fn.argtypes = [ptr, ptr, ptr, i64, ptr]
        fn.restype = cint
    lib.lt_error_string.argtypes = [cint]
    lib.lt_error_string.restype = ctypes.c_char_p
    return lib


def init_device(lib: ctypes.CDLL, index: int) -> None:
    """Upload the reduction table to device ``index`` for ``lib``'s kernels."""
    table = reduction_table()
    with torch.cuda.device(index):
        check_cuda(lib, lib.lt_fq_init(table.ctypes.data), "lt_fq_init")


def library(device: torch.device):
    """The loaded kernel library, with the reduction table uploaded to
    ``device``, and the device's index."""
    global _lib
    with _load_lock:
        if _lib is None:
            _lib = load_library(build().path)
        index = device.index if device.index is not None else torch.cuda.current_device()
        if index not in _ready_devices:
            init_device(_lib, index)
            _ready_devices.add(index)
    return _lib, index


def check_cuda(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.lt_error_string(err).decode() if lib is not None else ""
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# ---------------------------------------------------------------- wrappers


def _check_operands(a: torch.Tensor, b: torch.Tensor, tail: tuple) -> None:
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 1 + len(tail) or tuple(t.shape[1:]) != tail:
            raise ValueError(f"{name} must have shape (n, {', '.join(map(str, tail))}), "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.shape != b.shape:
        raise ValueError(f"operand shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} vs {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def _launch(name: str, fn_name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(a)
    n = a.shape[0]
    if n == 0:
        return out
    lib, index = library(a.device)
    # The C entry points launch on the thread's current device: select the
    # operands' device for the call and restore the caller's afterwards.
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, stream)
    check_cuda(lib, err, fn_name)
    LAUNCHES[name] += 1
    SIZES[name][n] += 1
    return out


def fq_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fq products of (n, 25) int32 rows: the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    _check_operands(a, b, (L16,))
    if a.device.type == "cpu":
        return fq_mul_plain(a, b)
    return _launch("fq_mul", "lt_fq_mul", a, b)


def fq2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fq2 products of (n, 2, 25) int32 rows: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    _check_operands(a, b, (2, L16))
    if a.device.type == "cpu":
        return fq2_mul_plain(a, b)
    return _launch("fq2_mul", "lt_fq2_mul", a, b)


def ptxas_summary(log: str) -> list:
    """The lines of an nvcc log that give each kernel's registers and spills."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]

