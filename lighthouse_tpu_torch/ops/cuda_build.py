"""The nvcc build of the port's hand-written CUDA sources.

Each source under ``lighthouse_tpu_torch/csrc/`` (``fq_mul.cu``,
``sha256.cu``, ``shuffle.cu``) has a plain-C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library in
``lighthouse_tpu_torch/build/`` (gitignored), named by the source's stem
and the hash of its text, its headers' and the flags, then loaded with
``ctypes`` by its wrapper module (``cuda_fq.py``, ``cuda_sha.py``,
``cuda_epoch.py``).  ``ops/compile_cache.build_kernels`` builds every source
at once, one ``nvcc`` per source.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


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


def library_path(source: Path) -> Path:
    """The library built from ``source``, named by the hash of its text,
    the text of the headers beside it (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:12]}.so"


def build(source: Path, force: bool = False) -> BuildResult:
    """Compile ``source`` with nvcc for sm_90a, unless a library built from
    the same source and flags is already there."""
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
        raise RuntimeError(f"nvcc failed on {source.name} ({res.returncode}):\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees old or new, whole
    return BuildResult(path, seconds, log)


def check_cuda(lib, err: int, what: str) -> None:
    """Raise unless ``err`` (a cudaError_t returned by ``lib``) is 0."""
    if err != 0:
        msg = lib.lt_error_string(err).decode() if lib is not None else ""
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptxas_summary(log: str) -> list:
    """The lines of an nvcc log that give each kernel's registers and spills."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
