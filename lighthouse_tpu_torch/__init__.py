"""lighthouse-tpu on PyTorch and CUDA: the batched BLS verifier on an NVIDIA GPU.

This package is the PyTorch/CUDA counterpart of ``lighthouse_tpu`` (the JAX
package, which stays the reference).  It imports ``torch`` and never ``jax``,
and nothing of ``lighthouse_tpu``: the pure-Python BLS modules it needs are
its own copies under ``crypto/bls``.

Entry points take an explicit ``device`` argument that defaults to
``"cuda"``; pass ``device="cpu"`` to run the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"
