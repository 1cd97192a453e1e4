"""Checkpoint-keyed HTTP response cache.

The serving layer's answer to "millions of users asking the same
questions": between head changes, every duty/state/rewards query against a
given ``(head, justified, finalized)`` checkpoint tuple has exactly one
answer — so the server computes it once and replays the serialized bytes.
The reference client reaches the same place with per-fork cached responses
inside ``beacon_chain`` (e.g. the validator-duties and deposit caches);
here the cache sits at the HTTP seam so *every* declared hot route gets it
mechanically.

Correctness model
-----------------
- The key embeds the **checkpoint fingerprint** — ``(head_root,
  justified_checkpoint, finalized_checkpoint)`` — plus the route template,
  path params, canonicalized query, canonicalized POST body, and the
  negotiated content type.  A request computes its key from the chain's
  *current* fingerprint, so a reorg or new head can never serve a stale
  entry: the stale entry's key simply stops being computed.
- Event-driven invalidation keeps the map bounded and exact: on a
  ``head``/``finalized_checkpoint``/``chain_reorg`` event every entry whose
  fingerprint differs from the chain's current fingerprint is dropped
  (counted per topic on ``http_response_cache_invalidations_total``).
  Routes whose answers depend on the *set of known blocks* rather than the
  canonical chain (``/eth/v1/beacon/headers`` by parent root, debug heads)
  additionally declare the ``block`` topic: a block event drops their
  entries even when the fingerprint is unchanged.
- A handler that ran while the head moved under it is not stored: ``put``
  re-reads the fingerprint and discards the entry on mismatch (otherwise a
  reorg A→B→A could resurrect a B-computed answer under an A key).

Entries hold the **serialized** response (JSON bytes or SSZ bytes), so a
cache hit is a dict lookup plus a socket write, and cached vs uncached
responses are bit-identical by construction — the property the ``api_load``
scenario's determinism gate pins down.

A copy of the JAX package's ``lighthouse_tpu/http_api/response_cache.py``;
its lock comes from the lock sanitizer's factory (``locksmith.lock``: a
plain ``threading.Lock`` while the sanitizer is off).
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from .. import locksmith, metrics, tracing

#: Topics a cached route may declare.  ``head`` and ``finalized_checkpoint``
#: prune dead-fingerprint entries; ``block``/``chain_reorg`` additionally
#: drop same-fingerprint entries of routes that declared them.
VALID_INVALIDATION_TOPICS = (
    "head",
    "finalized_checkpoint",
    "block",
    "chain_reorg",
)

#: The standard declaration for canonical-chain-derived routes (duties,
#: state queries, rewards): pinned by the checkpoint fingerprint, pruned on
#: head/finality movement.
CKPT = ("head", "finalized_checkpoint")
#: For routes that also read non-canonical blocks (headers search, debug
#: heads): any imported block may change the answer without moving the head.
CKPT_BLOCKS = ("head", "finalized_checkpoint", "block")

_TRIGGER_TOPICS = frozenset(VALID_INVALIDATION_TOPICS)


class CacheEntry:
    __slots__ = ("kind", "body", "version", "headers", "fingerprint", "topics")

    def __init__(self, kind: str, body: bytes, version: Optional[str],
                 headers: Tuple[Tuple[str, str], ...],
                 fingerprint: Tuple, topics: Tuple[str, ...]):
        self.kind = kind  # "json" | "ssz"
        self.body = body
        self.version = version
        self.headers = headers
        self.fingerprint = fingerprint
        self.topics = topics


def default_capacity() -> int:
    raw = os.environ.get("LIGHTHOUSE_TPU_API_CACHE_CAPACITY", "4096")
    try:
        return max(16, int(raw))
    except ValueError:
        return 4096


class ResponseCache:
    """LRU over serialized responses, keyed by checkpoint fingerprint +
    request identity, invalidated by chain events."""

    def __init__(self, chain, capacity: Optional[int] = None):
        self.chain = chain
        self.capacity = capacity if capacity is not None else default_capacity()
        self._entries: "OrderedDict[Tuple, CacheEntry]" = OrderedDict()
        self._lock = locksmith.lock("ResponseCache._lock")
        self._attached_bus = None
        self.hits = 0
        self.misses = 0
        self.invalidated = 0
        #: bumped on every invalidation-relevant chain event — the
        #: store-guard against mid-handler reorgs (see :meth:`put`)
        self.generation = 0

    # ------------------------------------------------------------- wiring

    def attach(self, event_bus) -> None:
        """Subscribe invalidation to the chain's event bus (idempotent)."""
        if self._attached_bus is not None:
            return
        event_bus.add_listener(self.on_event)
        self._attached_bus = event_bus

    def detach(self) -> None:
        if self._attached_bus is not None:
            self._attached_bus.remove_listener(self.on_event)
            self._attached_bus = None

    # --------------------------------------------------------------- keys

    def fingerprint(self) -> Tuple:
        """The chain's current ``(head, justified, finalized)`` identity.
        Justified rides along because ``state_id=justified`` answers can
        move when a side-branch block advances justification without
        changing the head."""
        chain = self.chain
        j_epoch, j_root = chain.justified_checkpoint()
        f_epoch, f_root = chain.finalized_checkpoint()
        return (chain.head_root, j_epoch, j_root, f_epoch, f_root)

    @staticmethod
    def _canonical_body(body: Any) -> Optional[str]:
        if body is None:
            return None
        try:
            return json.dumps(body, sort_keys=True, separators=(",", ":"))
        except (TypeError, ValueError):
            return None  # unhashable/binary body: treat as uncacheable

    def make_key(self, method: str, route: str, params: Dict[str, str],
                 query: Dict[str, List[str]], body: Any,
                 wants_ssz: bool) -> Optional[Tuple]:
        """The full cache key, or ``None`` when the request is uncacheable
        (non-JSON body)."""
        if isinstance(body, (bytes, bytearray)):
            return None
        body_key = self._canonical_body(body)
        if body is not None and body_key is None:
            return None
        return (
            self.fingerprint(),
            method,
            route,
            tuple(sorted(params.items())),
            tuple(sorted((k, tuple(v)) for k, v in query.items())),
            body_key,
            wants_ssz,
        )

    # ------------------------------------------------------------ get/put

    def get(self, key: Tuple, route: str) -> Optional[CacheEntry]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        if entry is None:
            metrics.HTTP_CACHE_MISSES.inc(route=route)
            return None
        metrics.HTTP_CACHE_HITS.inc(route=route)
        return entry

    def put(self, key: Tuple, route: str, entry: CacheEntry,
            generation: Optional[int] = None) -> bool:
        """Store; refused when the chain moved while the handler ran.

        Two guards: the fingerprint must still equal the key's, AND — when
        the caller passes the ``generation`` it read at handler start — no
        invalidation event may have fired since.  The fingerprint check
        alone cannot catch an A→B→A reorg that completes within the
        handler's run (the response was computed against B but both
        fingerprint reads see A); the round trip necessarily publishes
        head events, each of which bumps :attr:`generation`."""
        if self.fingerprint() != key[0]:
            return False
        if generation is not None and generation != self.generation:
            return False
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
            metrics.HTTP_CACHE_ENTRIES.set(len(self._entries))
        return True

    # ------------------------------------------------------- invalidation

    def on_event(self, topic: str, data: dict) -> None:
        """Chain-event invalidation: drop every entry whose fingerprint is
        no longer the chain's, plus same-fingerprint entries of routes that
        declared this topic as content-bearing (``block``/``chain_reorg``)."""
        if topic not in _TRIGGER_TOPICS:
            return
        current = self.fingerprint()
        dropped = 0
        with self._lock:
            self.generation += 1
            stale = [
                k for k, e in self._entries.items()
                if e.fingerprint != current
                or (topic in e.topics and topic not in CKPT)
            ]
            for k in stale:
                del self._entries[k]
            dropped = len(stale)
            self.invalidated += dropped
            metrics.HTTP_CACHE_ENTRIES.set(len(self._entries))
        if dropped:
            metrics.HTTP_CACHE_INVALIDATIONS.inc(dropped, topic=topic)
            # Visible inside the publishing trace (head_recompute /
            # block_import): which event emptied the cache, and how much.
            tracing.span_event("api_cache_invalidate",
                               topic=topic, dropped=dropped)

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            metrics.HTTP_CACHE_ENTRIES.set(0)
        return n

    # ----------------------------------------------------------- visible

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys_snapshot(self) -> List[Tuple]:
        with self._lock:
            return list(self._entries.keys())

    def snapshot(self) -> dict:
        with self._lock:
            n = len(self._entries)
        total = self.hits + self.misses
        return {
            "entries": n,
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else None,
            "invalidated": self.invalidated,
        }
