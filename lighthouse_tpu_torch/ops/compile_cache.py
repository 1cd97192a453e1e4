"""Kernel build cache.

The port of ``lighthouse_tpu/ops/compile_cache.py``.  The JAX package
points jax's persistent XLA cache at a directory and compiles its standard
buckets ahead of time.  The port's device programs are eager PyTorch, so
there is no per-bucket program to compile: what is built once is the CUDA
kernel libraries.  :func:`build_kernels` runs ``nvcc`` for sm_90a on every
source of ``KERNEL_SOURCES`` at once, one process per source
(``ops/cuda_build.py``; libraries in ``lighthouse_tpu_torch/build/``, keyed
by each source's hash), and notes each build in the device-telemetry
mirror through ``device_telemetry.note_warmup`` as its own entry: a
**hit** when an up-to-date library was found, a **miss** when ``nvcc``
ran.  ``cuda_fq.library``, ``cuda_sha.library`` and ``cuda_epoch.library``
build through here on first use, so the first kernel any of them needs
builds all three.

The JAX package's opt-in bucket warmup (``LIGHTHOUSE_TPU_AOT_WARMUP``) is
not ported: no first-dispatch cost of a bucket that a warmup would remove
has been measured on the card.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from .cuda_build import CSRC_DIR, build

#: Every CUDA source of the port (``csrc/``), by library name, with its
#: entry in the device-telemetry mirror.
KERNEL_SOURCES = {
    "fq_mul": (CSRC_DIR / "fq_mul.cu", "cuda_fq_build"),
    "sha256": (CSRC_DIR / "sha256.cu", "cuda_sha_build"),
    "shuffle": (CSRC_DIR / "shuffle.cu", "cuda_epoch_build"),
}


def build_kernels(force: bool = False) -> dict:
    """Build (or find) every kernel library, all ``nvcc`` runs started
    together, and note each outcome in the device-telemetry mirror; returns
    ``{name: cuda_build.BuildResult}``.  Raises if any build fails."""
    from .. import device_telemetry

    with ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:
        futures = {name: pool.submit(build, source, force)
                   for name, (source, _) in KERNEL_SOURCES.items()}
        results = {name: f.result() for name, f in futures.items()}
    for name, res in results.items():
        device_telemetry.note_warmup(KERNEL_SOURCES[name][1], (), res.seconds,
                                     hit=res.seconds == 0.0)
    return results
