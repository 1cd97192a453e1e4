"""Kernel build cache.

The port of ``lighthouse_tpu/ops/compile_cache.py``.  The JAX package
points jax's persistent XLA cache at a directory and compiles its standard
buckets ahead of time.  The port's device programs are eager PyTorch, so
there is no per-bucket program to compile: what is built once is the CUDA
kernel library.  :func:`build_kernels` is the kernel build of
``cuda_fq.py`` (``nvcc`` for sm_90a into ``lighthouse_tpu_torch/build/``,
keyed by the source's hash), noted in the device-telemetry mirror through
``device_telemetry.note_warmup`` as its own entry: a **hit** when an
up-to-date library was found, a **miss** when ``nvcc`` ran.
``cuda_fq.library`` builds through here on first use.

The JAX package's opt-in bucket warmup (``LIGHTHOUSE_TPU_AOT_WARMUP``) is
not ported: no first-dispatch cost of a bucket that a warmup would remove
has been measured on the card.
"""

from __future__ import annotations

#: The kernel build's entry in the device-telemetry mirror.
KERNEL_BUILD_OP = "cuda_fq_build"


def build_kernels(force: bool = False):
    """Build (or find) the Fq kernel library and note the outcome in the
    device-telemetry mirror; returns ``cuda_fq.build``'s ``BuildResult``."""
    from .. import device_telemetry
    from . import cuda_fq

    res = cuda_fq.build(force=force)
    device_telemetry.note_warmup(KERNEL_BUILD_OP, (), res.seconds, hit=res.seconds == 0.0)
    return res
