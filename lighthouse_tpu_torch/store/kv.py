"""Key-value store abstraction + in-memory backend.

Equivalent of the reference's ``KeyValueStore``/``ItemStore`` traits
(`beacon_node/store/src/lib.rs:53`) and ``MemoryStore``
(`beacon_node/store/src/memory_store.rs`).  The hot/cold split database
(``HotColdDB``) builds on these in ``hot_cold.py``; every test runs on
``MemoryStore`` exactly like the reference's harness does.

Keys are column-scoped: ``(column, key)`` → value bytes.  Columns mirror the
reference's ``DBColumn`` enum (block/state/summary/…); using explicit columns
keeps the on-disk layout stable when an embedded native backend is swapped in.

A copy of the JAX package's ``lighthouse_tpu/store/kv.py``.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple


class StoreError(Exception):
    pass


class DBColumn:
    """Column families (reference ``DBColumn``, ``store/src/lib.rs``)."""

    BEACON_BLOCK = b"blk"
    BEACON_STATE = b"ste"
    BEACON_STATE_SUMMARY = b"bss"
    BEACON_STATE_TEMPORARY = b"bst"
    BEACON_META = b"bma"
    BEACON_CHAIN = b"bch"
    OP_POOL = b"opo"
    ETH1_CACHE = b"etc"
    FORK_CHOICE = b"frk"
    PUBKEY_CACHE = b"pkc"
    BEACON_RESTORE_POINT = b"brp"
    BEACON_BLOCK_ROOTS = b"bbr"
    BEACON_STATE_ROOTS = b"bsr"
    BEACON_HISTORICAL_ROOTS = b"bhr"
    BEACON_RANDAO_MIXES = b"brm"
    BEACON_HISTORICAL_SUMMARIES = b"bhs"
    BLOB_SIDECAR = b"blb"
    DHT = b"dht"


class KeyValueStore:
    """Abstract synchronous KV store with batched atomic writes."""

    def get(self, column: bytes, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, column: bytes, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, column: bytes, key: bytes) -> None:
        raise NotImplementedError

    def exists(self, column: bytes, key: bytes) -> bool:
        return self.get(column, key) is not None

    def do_atomically(self, ops: List[Tuple[str, bytes, bytes, Optional[bytes]]]) -> None:
        """Apply ``[("put", col, key, value) | ("del", col, key, None)]`` as a
        unit (reference ``do_atomically`` with ``KeyValueStoreOp``)."""
        raise NotImplementedError

    def iter_column(self, column: bytes) -> Iterator[Tuple[bytes, bytes]]:
        """Iterate (key, value) pairs of one column in key order."""
        raise NotImplementedError

    def compact(self) -> None:
        pass

    def close(self) -> None:
        pass


class MemoryStore(KeyValueStore):
    """Dict-backed store (reference ``memory_store.rs``), thread-safe."""

    def __init__(self) -> None:
        self._data: Dict[bytes, Dict[bytes, bytes]] = {}
        self._lock = threading.RLock()

    def get(self, column: bytes, key: bytes) -> Optional[bytes]:
        with self._lock:
            col = self._data.get(column)
            return col.get(key) if col is not None else None

    def put(self, column: bytes, key: bytes, value: bytes) -> None:
        with self._lock:
            self._data.setdefault(column, {})[key] = value

    def delete(self, column: bytes, key: bytes) -> None:
        with self._lock:
            col = self._data.get(column)
            if col is not None:
                col.pop(key, None)

    def do_atomically(self, ops) -> None:
        with self._lock:
            for op, column, key, value in ops:
                if op == "put":
                    self._data.setdefault(column, {})[key] = value
                elif op == "del":
                    col = self._data.get(column)
                    if col is not None:
                        col.pop(key, None)
                else:
                    raise StoreError(f"unknown op {op!r}")

    def iter_column(self, column: bytes) -> Iterator[Tuple[bytes, bytes]]:
        with self._lock:
            items = sorted(self._data.get(column, {}).items())
        return iter(items)
