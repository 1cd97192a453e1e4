"""Persist the discv5 routing table across restarts.

Equivalent of the reference's ``beacon_node/network/src/persisted_dht.rs``:
on shutdown the node writes every ENR it knows to the store's DHT column;
on startup discovery seeds its table from them, so a restarted node
re-joins the network without waiting for fresh bootstrap rounds.

Wire format: concatenated ``u16-be length || ENR rlp`` records under the
all-zero key (the reference uses Hash256::zero() in its own column).

A copy of the JAX package's ``lighthouse_tpu/network/persisted_dht.py``.
"""

from __future__ import annotations

import struct
from typing import List

from ..store.kv import DBColumn

DHT_DB_KEY = b"\x00" * 32


def persist_dht(store, enrs: List) -> int:
    """Write ``enrs`` to the DHT column; returns the count written."""
    out = bytearray()
    n = 0
    for enr in enrs:
        rlp = enr.to_rlp()
        if len(rlp) > 0xFFFF:
            continue  # spec caps ENRs at 300 bytes; refuse anything absurd
        out += struct.pack(">H", len(rlp)) + rlp
        n += 1
    store.put(DBColumn.DHT, DHT_DB_KEY, bytes(out))
    return n


def load_dht(store) -> List:
    """Read the persisted ENRs (empty list when absent or corrupt — a bad
    record must never stop node startup)."""
    from .discv5.enr import ENR

    raw = store.get(DBColumn.DHT, DHT_DB_KEY)
    if not raw:
        return []
    enrs = []
    pos = 0
    try:
        while pos + 2 <= len(raw):
            (n,) = struct.unpack_from(">H", raw, pos)
            pos += 2
            if pos + n > len(raw):
                break
            enrs.append(ENR.from_rlp(raw[pos:pos + n]))
            pos += n
    except Exception:
        return enrs  # keep whatever decoded cleanly
    return enrs


def clear_dht(store) -> None:
    store.delete(DBColumn.DHT, DHT_DB_KEY)
