"""Server-sent-event bus for the beacon API ``/eth/v1/events`` stream.

Equivalent of the reference's ``beacon_chain/src/events.rs`` (``ServerSentEventHandler``
— per-topic broadcast channels the HTTP API subscribes to).  Subscribers get a
bounded queue; slow consumers drop events rather than stall the chain.

A copy of the JAX package's ``lighthouse_tpu/chain/events.py``.
"""

from __future__ import annotations

import queue
import threading

from .. import metrics
from ..timeout_lock import TimeoutLock
from typing import Callable, Dict, List, Optional, Tuple

TOPIC_HEAD = "head"
TOPIC_BLOCK = "block"
TOPIC_ATTESTATION = "attestation"
TOPIC_FINALIZED = "finalized_checkpoint"
TOPIC_EXIT = "voluntary_exit"
TOPIC_BLOB_SIDECAR = "blob_sidecar"
TOPIC_CHAIN_REORG = "chain_reorg"
TOPIC_PAYLOAD_ATTRIBUTES = "payload_attributes"
TOPIC_CONTRIBUTION_AND_PROOF = "contribution_and_proof"
# Non-spec operator topic: device circuit-breaker transitions
# (device_supervisor.py) — a subscriber watching this sees the device
# degrade to the host path and recover, live.
TOPIC_DEVICE_BREAKER = "device_breaker"

ALL_TOPICS = (
    TOPIC_HEAD,
    TOPIC_BLOCK,
    TOPIC_ATTESTATION,
    TOPIC_PAYLOAD_ATTRIBUTES,
    TOPIC_CONTRIBUTION_AND_PROOF,
    TOPIC_FINALIZED,
    TOPIC_EXIT,
    TOPIC_BLOB_SIDECAR,
    TOPIC_CHAIN_REORG,
    TOPIC_DEVICE_BREAKER,
)


class EventSubscription:
    def __init__(self, topics: List[str], maxsize: int = 256):
        self.topics = set(topics)
        self.q: "queue.Queue[Tuple[str, dict]]" = queue.Queue(maxsize=maxsize)
        self.dropped = 0
        self.dropped_by_topic: Dict[str, int] = {}
        self.sent = 0  # bumped by the SSE writer on each delivered event

    def poll(self, timeout: Optional[float] = None) -> Optional[Tuple[str, dict]]:
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None


class EventBus:
    def __init__(self) -> None:
        self._subs: List[EventSubscription] = []
        # Synchronous in-process listeners (fn(topic, data)) — the HTTP
        # response cache's invalidation feed.  Unlike subscriptions these
        # run inline on the publishing (chain) thread, so they must be
        # cheap and must never raise into the chain.
        self._listeners: List[Callable[[str, dict], None]] = []
        self._lock = TimeoutLock("event_bus")

    def add_listener(self, fn: Callable[[str, dict], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[str, dict], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def subscribe(self, topics: List[str]) -> EventSubscription:
        bad = [t for t in topics if t not in ALL_TOPICS]
        if bad:
            raise ValueError(f"unknown event topics: {bad}")
        sub = EventSubscription(topics)
        with self._lock:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: EventSubscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def publish(self, topic: str, data: dict) -> None:
        with self._lock:
            subs = list(self._subs)
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(topic, data)
            except Exception:
                # A broken listener (cache invalidation hook) must never
                # break head recompute / block import.
                pass
        for sub in subs:
            if topic in sub.topics:
                try:
                    sub.q.put_nowait((topic, data))
                except queue.Full:
                    # Slow consumer: drop rather than stall the chain — but
                    # never silently (per-subscriber tallies + a per-topic
                    # counter, so a lossy /eth/v1/events stream is visible
                    # on /metrics before a user reports missing heads).
                    sub.dropped += 1
                    sub.dropped_by_topic[topic] = (
                        sub.dropped_by_topic.get(topic, 0) + 1
                    )
                    metrics.SSE_EVENTS_DROPPED.inc(topic=topic)

    def summary(self) -> List[dict]:
        """Per-subscriber state for the operator surface
        (``GET /lighthouse/events/subscribers``)."""
        with self._lock:
            subs = list(self._subs)
        return [
            {
                "topics": sorted(sub.topics),
                "queue_depth": sub.q.qsize(),
                "queue_capacity": sub.q.maxsize,
                "sent": sub.sent,
                "dropped": sub.dropped,
                "dropped_by_topic": dict(sub.dropped_by_topic),
            }
            for sub in subs
        ]

    # Convenience emitters mirroring the reference's EventKind variants.

    def head(self, *, slot: int, block_root: bytes, state_root: bytes,
             epoch_transition: bool) -> None:
        self.publish(TOPIC_HEAD, {
            "slot": str(slot),
            "block": "0x" + block_root.hex(),
            "state": "0x" + state_root.hex(),
            "epoch_transition": epoch_transition,
            "execution_optimistic": False,
        })

    def block(self, *, slot: int, block_root: bytes) -> None:
        self.publish(TOPIC_BLOCK, {
            "slot": str(slot),
            "block": "0x" + block_root.hex(),
            "execution_optimistic": False,
        })

    def finalized(self, *, epoch: int, block_root: bytes, state_root: bytes) -> None:
        self.publish(TOPIC_FINALIZED, {
            "epoch": str(epoch),
            "block": "0x" + block_root.hex(),
            "state": "0x" + state_root.hex(),
            "execution_optimistic": False,
        })

    def device_breaker(self, *, op: str, **fields) -> None:
        """Device circuit-breaker transition (called by the supervisor on
        every state change: op, from, to, reason, timestamp_ms)."""
        self.publish(TOPIC_DEVICE_BREAKER, {"op": op, **fields})


def exit_event_payload(exit_) -> dict:
    """SSE payload for a pooled voluntary exit (the chain layer builds
    event dicts itself — no dependency on the HTTP serializer)."""
    return {
        "message": {
            "epoch": str(int(exit_.message.epoch)),
            "validator_index": str(int(exit_.message.validator_index)),
        },
        "signature": "0x" + bytes(exit_.signature).hex(),
    }
