"""Node-scoped telemetry: per-node views of the observability plane.

Every telemetry surface in this tree — the metrics registry, the flight
recorder, the log ring, the blackbox journal, the trace store — began as a
process-global singleton.  That is the right zero-cost default for a
single-node run, but a multi-node scenario fleet (and, next, the
multi-process device service) smears N nodes into one
timeline where node A's breaker trip and node B's reorg are
indistinguishable.  ``process_boundary_pass`` baselined those singletons
as "the split's work map"; this module is the seam that burns the
telemetry-owned subset down.

A :class:`TelemetryScope` is one node's (or, later, one process's) view of
the plane:

- its own :class:`blackbox.Journal` ring (records mirrored from the
  process-global journal, stamped with ``node`` + Lamport ``lamport``);
- its own flight-recorder tail and log tail (copies of the entries the
  global rings saw while the scope was active);
- a :class:`metrics.LocalTally` — a per-scope metrics view next to the
  process-global registry;
- a per-node **Lamport clock**: ``tick()`` on every scoped journal append,
  ``tick(at_least=remote)`` when a record is causally linked to another
  node's event (a gossip import resuming a remote trace), ``clock()`` for
  a read-only stamp on outbound envelopes.  ``blackbox.merge_journals``
  orders the fleet timeline on (virtual slot, lamport, node, seq), so the
  clock is what makes cross-node causality hold in the merge.

Propagation follows ``tracing``'s model: a contextvar carries the active
scope on the thread that entered it (``activate()``), and long-lived
subsystems that outlive a context — a node's transport endpoint, its
gossip router — hold a direct scope reference instead (contextvars do not
reach into already-running threads).  When no scope is active every
telemetry call degrades to exactly the old process-global behavior:
single-node runs pay nothing.

Worker-thread events (a gossip block import on a processor worker) must
NOT append into the scoped journal directly — thread interleaving would
make per-node ``seq`` assignment racy across runs.  They go through
``defer()`` into a pending buffer and are drained on the runner thread at
settle boundaries (``Simulator.drain_fleet_events``), sorted on stable
keys, so two runs at one seed produce byte-identical merged timelines.

Import discipline: host-side plumbing only, like ``blackbox.py``.

A copy of the JAX package's ``lighthouse_tpu/telemetry_scope.py``; its
locks come from the lock sanitizer's factory (``locksmith.lock``: plain
``threading.Lock`` locks while the sanitizer is off).  As in the JAX
package, ``blackbox`` mirrors its records into the active scope,
``device_telemetry`` stamps its flight records with the scope's node, and
the network stamps envelopes with a scope's trace context and defers
fleet events into it.
"""

from __future__ import annotations

import contextlib
from collections import deque
from contextvars import ContextVar
from typing import Dict, Iterator, List, Optional, Tuple

from . import locksmith, metrics

#: Per-scope flight/log tail lengths — mirrors, not the system of record
#: (the global rings keep their own capacity).
FLIGHT_TAIL = 256
LOG_TAIL = 200

FLEET_JOURNAL_EVENTS = metrics.counter(
    "fleet_journal_events_total",
    "journal records routed into a node scope, by node",
)
FLEET_TRACE_LINKS = metrics.counter(
    "fleet_trace_links_total",
    "cross-node causal links recorded (envelope trace resumes, journal "
    "links), by kind",
)


class TelemetryScope:
    """One node's view of the telemetry plane (see module docstring)."""

    def __init__(self, node_id: str):
        from . import blackbox  # lazy: keep this module import-light

        self.node_id = str(node_id)
        self.journal = blackbox.Journal()
        #: per-scope mirrors; deque appends are atomic, single-purpose
        #: monitoring tails — deliberately not lock-guarded state.
        self.flight: deque = deque(maxlen=FLIGHT_TAIL)
        self.log_tail: deque = deque(maxlen=LOG_TAIL)
        self.tally = metrics.LocalTally()
        self._lock = locksmith.lock("TelemetryScope._lock")
        self._lamport = 0
        self._pending: List[dict] = []

    # ------------------------------------------------------- lamport clock

    def tick(self, at_least: int = 0) -> int:
        """Advance the Lamport clock past ``at_least`` and return it."""
        with self._lock:
            self._lamport = max(self._lamport, int(at_least)) + 1
            return self._lamport

    def clock(self) -> int:
        """Read the clock WITHOUT ticking — outbound envelope stamps read
        the proposer's current value so the receiver's ``tick(at_least=)``
        orders the import strictly after the proposal."""
        with self._lock:
            return self._lamport

    # ---------------------------------------------------- deferred events

    def defer(self, source: str, event: str, fields: dict,
              link: Optional[Tuple[str, int]] = None) -> None:
        """Queue a journal event from a worker thread for a deterministic
        runner-thread drain (see module docstring)."""
        item = {"source": source, "event": event, "fields": dict(fields)}
        if link is not None:
            item["link"] = (str(link[0]), int(link[1]))
        with self._lock:
            self._pending.append(item)

    def drain_pending(self) -> List[dict]:
        """Pop all deferred events, sorted on stable fields (slot, then
        root/event) so arrival interleaving cannot reorder them."""
        with self._lock:
            pending, self._pending = self._pending, []
        pending.sort(key=lambda it: (
            it["fields"].get("slot", -1),
            str(it["fields"].get("root", "")),
            it["event"],
            str(it.get("link", "")),
        ))
        return pending

    # ------------------------------------------------------------ mirrors

    def note_flight(self, entry: dict) -> None:
        self.flight.append(dict(entry))

    def note_log(self, entry: dict) -> None:
        self.log_tail.append(dict(entry))

    # ----------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        return {
            "node": self.node_id,
            "lamport": self.clock(),
            "journal_len": len(self.journal),
            "flight_tail": len(self.flight),
            "log_tail": len(self.log_tail),
            "tally": self.tally.snapshot(),
        }


def envelope_trace_ctx(scope: Optional["TelemetryScope"]) -> Optional[dict]:
    """The trace context an outbound envelope carries: active trace id (if
    any), origin node, and a read-only Lamport stamp.  Excluded from
    ``Hub.record_schedule``'s determinism digest by construction — the hub
    logs only link names and delivery decisions."""
    if scope is None:
        return None
    from . import tracing  # lazy: keep this module import-light

    sp = tracing.current_span()
    return {
        "trace_id": sp.trace.trace_id if sp is not None else None,
        "node": scope.node_id,
        "lamport": scope.clock(),
    }


# ----------------------------------------------------------- scope registry

_SCOPES_LOCK = locksmith.lock("telemetry_scope._SCOPES_LOCK")
_SCOPES: Dict[str, TelemetryScope] = {}

#: The active scope on this thread/context (None = process-global plane).
_current: ContextVar[Optional[TelemetryScope]] = ContextVar(
    "telemetry_scope", default=None)


def register(scope: TelemetryScope) -> TelemetryScope:
    with _SCOPES_LOCK:
        _SCOPES[scope.node_id] = scope
    return scope


def unregister(node_id: str) -> None:
    with _SCOPES_LOCK:
        _SCOPES.pop(str(node_id), None)


def get(node_id: str) -> Optional[TelemetryScope]:
    with _SCOPES_LOCK:
        return _SCOPES.get(str(node_id))


def all_scopes() -> List[TelemetryScope]:
    """Registered scopes in stable (node id) order."""
    with _SCOPES_LOCK:
        scopes = list(_SCOPES.values())
    return sorted(scopes, key=lambda s: s.node_id)


def current() -> Optional[TelemetryScope]:
    return _current.get()


@contextlib.contextmanager
def activate(scope: Optional[TelemetryScope]) -> Iterator[None]:
    """Make ``scope`` the active telemetry scope for this context."""
    token = _current.set(scope)
    try:
        yield
    finally:
        _current.reset(token)


def reset_for_tests() -> None:
    with _SCOPES_LOCK:
        _SCOPES.clear()
