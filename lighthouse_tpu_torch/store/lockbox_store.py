"""On-disk ``KeyValueStore`` backed by the native lockbox engine
(reference: ``beacon_node/store/src/leveldb_store.rs`` — the persistent
backend slot; lockbox is our embedded C++ engine, ``native/lockbox.cc``).

A copy of the JAX package's ``lighthouse_tpu/store/lockbox_store.py``.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Iterator, List, Optional, Tuple

from ..native import load_lockbox
from .kv import KeyValueStore, StoreError


class LockboxStore(KeyValueStore):
    def __init__(self, path: str):
        self._lib = load_lockbox()
        self._h = self._lib.lockbox_open(path.encode())
        if not self._h:
            raise StoreError(f"cannot open lockbox at {path}")
        self.path = path

    @staticmethod
    def _k(column: bytes, key: bytes) -> bytes:
        return column + b"\x1f" + key

    def get(self, column: bytes, key: bytes) -> Optional[bytes]:
        k = self._k(column, key)
        buf = ctypes.create_string_buffer(4096)
        n = self._lib.lockbox_get(self._h, k, len(k), buf, len(buf))
        if n == -1:
            return None
        if n < -1:
            raise StoreError("lockbox read error")
        if n <= len(buf):
            return buf.raw[:n]
        big = ctypes.create_string_buffer(n)
        n2 = self._lib.lockbox_get(self._h, k, len(k), big, n)
        if n2 != n:
            raise StoreError("lockbox read race")
        return big.raw[:n]

    def put(self, column: bytes, key: bytes, value: bytes) -> None:
        k = self._k(column, key)
        if self._lib.lockbox_put(self._h, k, len(k), value, len(value)) != 0:
            raise StoreError("lockbox write error")

    def delete(self, column: bytes, key: bytes) -> None:
        k = self._k(column, key)
        if self._lib.lockbox_delete(self._h, k, len(k)) != 0:
            raise StoreError("lockbox delete error")

    def do_atomically(self, ops: List[Tuple[str, bytes, bytes, Optional[bytes]]]) -> None:
        # Crash atomicity holds per record; a torn multi-op batch is bounded
        # by the log-scan truncation on reopen.  Matches the durability class
        # of the reference's non-WAL LevelDB usage.
        for op, column, key, value in ops:
            if op == "put":
                self.put(column, key, value)
            elif op == "del":
                self.delete(column, key)
            else:
                raise StoreError(f"unknown op {op!r}")
        self.flush()

    def iter_column(self, column: bytes) -> Iterator[Tuple[bytes, bytes]]:
        prefix = column + b"\x1f"
        need = self._lib.lockbox_keys(self._h, prefix, len(prefix), None, 0)
        buf = ctypes.create_string_buffer(int(need) or 1)
        self._lib.lockbox_keys(self._h, prefix, len(prefix), buf, len(buf))
        keys = []
        off = 0
        raw = buf.raw[: int(need)]
        while off < len(raw):
            (klen,) = struct.unpack_from("<I", raw, off)
            keys.append(raw[off + 4 : off + 4 + klen])
            off += 4 + klen
        for full_key in keys:
            key = full_key[len(prefix):]
            value = self.get(column, key)
            if value is not None:
                yield (key, value)

    def flush(self) -> None:
        self._lib.lockbox_flush(self._h)

    def compact(self) -> None:
        if self._lib.lockbox_compact(self._h) != 0:
            raise StoreError("lockbox compaction failed")

    def close(self) -> None:
        if self._h:
            self._lib.lockbox_close(self._h)
            self._h = None
