"""PyTorch/CUDA batch-verification backend.

The slot of ``crypto/bls/src/impls/blst.rs`` in the reference: all signature
sets funnel through here, and the multi-pairing runs as one shape-bucketed
PyTorch program on the hand-written Fq kernels (``lighthouse_tpu_torch/ops``),
supervised by ``device_supervisor.py``.
"""

from __future__ import annotations

from typing import Optional


def verify_signature_sets(sets, seed: Optional[bytes] = None,
                          device: str = "cuda") -> bool:
    from .... import tracing
    from ....ops.devices import resolve_device
    from ....ops.verify import verify_signature_sets_device

    sets = list(sets)
    dev = resolve_device(device)
    # The device-side parent span: the stage spans recorded inside
    # verify_signature_sets_device (setup/dispatch/wait/verdict) nest here,
    # and the callee stamps its flight-recorder seq (and host-fallback flag,
    # when taken) onto this span.
    with tracing.span(
        "device_verify", backend="torch", platform=dev.type,
        n_sets=len(sets),
    ):
        return verify_signature_sets_device(sets, seed=seed, device=dev)
