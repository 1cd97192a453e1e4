"""BLS execution backends (the reference's `define_mod!` seam, crypto/bls/src/lib.rs:84-139).

- ``host``: pure-Python multi-pairing (the golden model; always available)
- ``fake``: always-valid (mirrors impls/fake_crypto.rs — lets every logic test run
  without crypto cost or a GPU)
- ``torch``: batched multi-pairing on a CUDA card (lighthouse_tpu_torch/ops);
  the default

Selected via ``set_backend()``.
"""

from __future__ import annotations

from typing import Optional

DEFAULT = "torch"

_ACTIVE = None
_NAME = None


def get_backend():
    global _ACTIVE, _NAME
    if _ACTIVE is None:
        set_backend(DEFAULT)
    return _ACTIVE


def backend_name() -> Optional[str]:
    get_backend()
    return _NAME


def set_backend(name: str):
    global _ACTIVE, _NAME
    if name == "host":
        from . import host as mod
    elif name == "fake":
        from . import fake as mod
    elif name == "torch":
        from . import torch_backend as mod
    else:
        raise ValueError(f"unknown BLS backend: {name!r}")
    _ACTIVE = mod
    _NAME = name
    return mod
