"""Span tracing for the block-import → device-batch pipeline.

The metrics registry (``lighthouse_tpu_torch/metrics``) answers "how slow is this
stage on average"; this module answers "where did THIS block's 400 ms go".
Every instrumentation point opens a ``span(name, hist=...)`` that feeds the
stage's existing histogram on close AND records a node in a per-trace tree —
one seam, two sinks, so aggregates and traces can never disagree about what
was measured.

Model (a deliberately small subset of OpenTelemetry):

- A :class:`Span` has a name, perf-counter start/end, a field dict, and
  children.  The active span propagates through a ``contextvars.ContextVar``,
  so nesting is automatic within a thread.
- A span opened with no active parent starts a new :class:`Trace`.  When that
  root closes, the completed trace lands in the bounded :data:`TRACES` ring,
  keyed by root-span name (one sub-ring per root, so chatty roots cannot
  evict rare ones) and filterable by the root's ``slot`` field.
- Cross-thread hops (the scheduler's enqueue→worker seam) carry the parent
  span explicitly: the sender stamps it on the ``WorkEvent``, the worker
  re-attaches with :func:`attach`/:func:`detach`.  ``time.perf_counter`` is
  CLOCK_MONOTONIC — comparable across threads — so enqueue→drain queue-wait
  spans are exact.
- Trees are bounded (:data:`MAX_SPANS_PER_TRACE`); past the cap spans are
  still timed (their histograms must not go dark) but dropped from the tree,
  counted in ``Trace.dropped``.

A parent may close before a late child does (a delayed re-processed event
whose originating request already returned).  The child still attaches — the
tree is serialized at read time — it just renders past its parent's end.

Cross-node hops (a gossip block published by another node) resume the
envelope's trace context as a fresh local root (:func:`resume_remote`).

HTTP surface (``http_api/server.py``): ``/lighthouse/traces`` lists recent
trace summaries; ``/lighthouse/traces/{trace_id}`` returns the full tree,
``?format=chrome`` as Chrome trace-event JSON loadable in Perfetto.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

MAX_SPANS_PER_TRACE = 512
TRACES_PER_ROOT = 128

_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "lighthouse_tpu_current_span", default=None
)
_seq = itertools.count(1)


def _new_trace_id() -> str:
    return f"{next(_seq):08x}{os.urandom(4).hex()}"


class Span:
    __slots__ = (
        "name", "fields", "trace", "parent", "children",
        "start_pc", "end_pc", "start_wall", "tid",
    )

    def __init__(self, name: str, trace: "Trace", parent: Optional["Span"],
                 fields: Dict[str, Any], start_pc: Optional[float] = None):
        self.name = name
        self.trace = trace
        self.parent = parent
        self.fields = fields
        self.children: List[Span] = []
        self.start_pc = time.perf_counter() if start_pc is None else start_pc
        self.end_pc: Optional[float] = None
        self.start_wall = time.time()
        self.tid = threading.get_ident()

    @property
    def duration(self) -> float:
        end = self.end_pc if self.end_pc is not None else time.perf_counter()
        return max(0.0, end - self.start_pc)

    def close(self, end_pc: Optional[float] = None) -> None:
        if self.end_pc is None:
            self.end_pc = time.perf_counter() if end_pc is None else end_pc


class Trace:
    """One bounded span tree; completed when its root span closes."""

    __slots__ = ("trace_id", "root", "n_spans", "dropped", "_lock")

    def __init__(self, root_name: str, fields: Dict[str, Any]):
        self.trace_id = _new_trace_id()
        self._lock = threading.Lock()
        self.n_spans = 1
        self.dropped = 0
        self.root = Span(root_name, self, None, fields)

    def new_child(self, parent: Span, name: str, fields: Dict[str, Any],
                  start_pc: Optional[float] = None) -> Span:
        """A child span under ``parent``.  Past the per-trace cap the span is
        created detached (timed, histogram-fed) but not added to the tree."""
        sp = Span(name, self, parent, fields, start_pc=start_pc)
        with self._lock:
            if self.n_spans >= MAX_SPANS_PER_TRACE:
                self.dropped += 1
                return sp
            self.n_spans += 1
        parent.children.append(sp)
        return sp


class TraceRing:
    """Completed traces, keyed by root-span name with per-root bounds."""

    def __init__(self, per_root: int = TRACES_PER_ROOT):
        self.per_root = per_root
        self._by_root: Dict[str, deque] = {}
        self._by_id: Dict[str, Trace] = {}
        self._lock = threading.Lock()

    def push(self, trace: Trace) -> None:
        with self._lock:
            dq = self._by_root.setdefault(trace.root.name, deque())
            if len(dq) >= self.per_root:
                evicted = dq.popleft()
                self._by_id.pop(evicted.trace_id, None)
            dq.append(trace)
            self._by_id[trace.trace_id] = trace

    def get(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            return self._by_id.get(trace_id)

    def recent(self, limit: int = 64, root: Optional[str] = None,
               slot: Optional[int] = None) -> List[Trace]:
        """Newest-first completed traces, optionally filtered by root name
        and/or the root span's ``slot`` field."""
        with self._lock:
            if root is not None:
                traces = list(self._by_root.get(root, ()))
            else:
                traces = [t for dq in self._by_root.values() for t in dq]
        traces.sort(key=lambda t: t.root.start_wall, reverse=True)
        if slot is not None:
            traces = [t for t in traces if t.root.fields.get("slot") == slot]
        return traces[:limit]

    def clear(self) -> None:
        with self._lock:
            self._by_root.clear()
            self._by_id.clear()


TRACES = TraceRing()


# ------------------------------------------------------------------ context


def current_span() -> Optional[Span]:
    return _current.get()


def attach(parent: Optional[Span]):
    """Adopt ``parent`` as the active span on THIS thread (the worker side
    of a cross-thread hop).  Returns a token for :func:`detach`."""
    return _current.set(parent)


def detach(token) -> None:
    _current.reset(token)


def annotate(**fields) -> None:
    """Merge fields into the active span (no-op outside any span)."""
    sp = _current.get()
    if sp is not None:
        sp.fields.update(fields)


def annotate_trace(**fields) -> None:
    """Merge fields into the active TRACE's root span — how an inner stage
    keys the whole trace (a block import stamps its slot on the enclosing
    work/http root so ``TRACES.recent(slot=...)`` finds it)."""
    sp = _current.get()
    if sp is not None:
        sp.trace.root.fields.update(fields)


@contextmanager
def span(name: str, hist=None, hist_labels: Optional[dict] = None, **fields):
    """Record a span; on close, observe its duration into ``hist`` too.

    With no active parent this starts a new trace, completed (and pushed to
    :data:`TRACES`) when the span exits.
    """
    parent = _current.get()
    if parent is None:
        trace = Trace(name, fields)
        sp = trace.root
    else:
        trace = parent.trace
        sp = trace.new_child(parent, name, fields)
    token = _current.set(sp)
    try:
        yield sp
    finally:
        _current.reset(token)
        sp.close()
        if hist is not None:
            hist.observe(sp.duration, **(hist_labels or {}))
        if sp.parent is None:
            TRACES.push(trace)


@contextmanager
def resume_remote(ctx: Optional[dict], name: str, **fields):
    """Resume an envelope-propagated trace context from ANOTHER node as a
    new local root trace (the receiving half of cross-node propagation).

    The remote linkage rides in fields — ``remote_trace_id`` /
    ``remote_node`` / ``remote_lamport`` — rather than by reusing the
    origin's trace id: :data:`TRACES` is process-global across simulated
    nodes, so id reuse would splice two nodes' spans into one tree.  The
    fleet artifact joins proposal and import trees on
    ``remote_trace_id == <proposal trace_id>``.  Always roots a fresh
    trace: any span active on this worker thread belongs to LOCAL work,
    not to the remote cause."""
    ctx = ctx or {}
    token = _current.set(None)
    try:
        with span(name,
                  remote_trace_id=ctx.get("trace_id"),
                  remote_node=ctx.get("node"),
                  remote_lamport=ctx.get("lamport"),
                  **fields) as sp:
            yield sp
    finally:
        _current.reset(token)


def span_event(name: str, **fields) -> Optional[Span]:
    """A zero-duration marker child on the active span — for point events
    that explain a trace without timing anything (a response-cache
    invalidation inside ``head_recompute``, a shed decision inside an HTTP
    span).  No-op (returns None) outside any trace."""
    now = time.perf_counter()
    return record_span(name, start_pc=now, end_pc=now, **fields)


def record_span(name: str, start_pc: float, end_pc: Optional[float] = None,
                hist=None, hist_labels: Optional[dict] = None,
                **fields) -> Optional[Span]:
    """Add an already-measured interval as a closed child of the active span
    (the queue-wait case: the start happened on the sending thread).  Feeds
    ``hist`` regardless of whether a trace is active."""
    end = time.perf_counter() if end_pc is None else end_pc
    parent = _current.get()
    sp = None
    if parent is not None:
        sp = parent.trace.new_child(parent, name, fields, start_pc=start_pc)
        sp.close(end)
    if hist is not None:
        hist.observe(max(0.0, end - start_pc), **(hist_labels or {}))
    return sp


# -------------------------------------------------------------- serializers


def span_to_dict(sp: Span, root_start_pc: float) -> dict:
    return {
        "name": sp.name,
        "start_offset_s": round(max(0.0, sp.start_pc - root_start_pc), 6),
        "duration_s": round(sp.duration, 6),
        "fields": dict(sp.fields),
        "children": [span_to_dict(c, root_start_pc) for c in sp.children],
    }


def trace_to_dict(trace: Trace) -> dict:
    root = trace.root
    return {
        "trace_id": trace.trace_id,
        "started_at_ms": int(root.start_wall * 1000),
        "duration_s": round(root.duration, 6),
        "n_spans": trace.n_spans,
        "dropped_spans": trace.dropped,
        "root": span_to_dict(root, root.start_pc),
    }


def trace_summary(trace: Trace) -> dict:
    root = trace.root
    out = {
        "trace_id": trace.trace_id,
        "root": root.name,
        "started_at_ms": int(root.start_wall * 1000),
        "duration_s": round(root.duration, 6),
        "n_spans": trace.n_spans,
    }
    if "slot" in root.fields:
        out["slot"] = root.fields["slot"]
    return out


def trace_to_chrome(trace: Trace) -> dict:
    """Chrome trace-event JSON (``ph: "X"`` complete events, microsecond
    timestamps relative to the trace root) — loadable in Perfetto /
    chrome://tracing."""
    root = trace.root
    events: List[dict] = []

    def walk(sp: Span) -> None:
        events.append({
            "name": sp.name,
            "cat": "lighthouse_tpu",
            "ph": "X",
            "ts": round((sp.start_pc - root.start_pc) * 1e6, 1),
            "dur": round(sp.duration * 1e6, 1),
            "pid": os.getpid(),
            "tid": sp.tid,
            "args": {k: str(v) for k, v in sp.fields.items()},
        })
        for c in sp.children:
            walk(c)

    walk(root)
    return {"displayTimeUnit": "ms", "traceEvents": events}
