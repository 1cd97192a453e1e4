"""Which card a device program runs on, and waiting for it.

Shared by every supervised entry point of the port (``ops/verify.py``,
``ops/kzg_device.py``, ``ops/sha256_device.py``, ``ops/tree_hash.py``).
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@contextlib.contextmanager
def on_device(device: torch.device):
    """Make ``device`` the thread's current card for the block (a no-op on
    the CPU): the supervisor's worker threads start on card 0."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        yield


def wait_for(device: torch.device) -> None:
    """Block until the work issued so far on ``device``'s current stream is
    done: an event recorded after it, then waited on (the counterpart of
    jax's ``block_until_ready``).  A no-op on the CPU."""
    if device.type != "cuda":
        return
    with torch.cuda.device(device):
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
