"""Storage layer (reference: ``beacon_node/store``).

A copy of the JAX package's ``lighthouse_tpu/store/__init__.py``.
"""

from .hot_cold import AnchorInfo, HotColdDB, HotStateSummary
from .kv import DBColumn, KeyValueStore, MemoryStore, StoreError

__all__ = [
    "AnchorInfo",
    "DBColumn",
    "HotColdDB",
    "HotStateSummary",
    "KeyValueStore",
    "LockboxStore",
    "MemoryStore",
    "StoreError",
]


def __getattr__(name):
    # LockboxStore compiles the native engine on first touch; keep the
    # package import light for users who only need MemoryStore.
    if name == "LockboxStore":
        from .lockbox_store import LockboxStore

        return LockboxStore
    raise AttributeError(name)
