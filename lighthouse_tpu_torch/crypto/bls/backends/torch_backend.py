"""PyTorch/CUDA batch-verification backend.

The slot of ``crypto/bls/src/impls/blst.rs`` in the reference: all signature
sets funnel through here, and the multi-pairing runs as one shape-bucketed
PyTorch program on the hand-written Fq kernels (``lighthouse_tpu_torch/ops``).
"""

from __future__ import annotations

from typing import Optional


def verify_signature_sets(sets, seed: Optional[bytes] = None,
                          device: str = "cuda") -> bool:
    from ....ops.verify import verify_signature_sets_device

    return verify_signature_sets_device(list(sets), seed=seed, device=device)
