"""The black box: one causally-ordered incident journal + postmortem bundles.

The flight recorder, the trace ring and the supervisor's breakers answer
"what is the device runtime doing now"; this module answers "what
happened": every supervised seam appends to one journal, and a trigger
freezes the journal with what it cross-references.

- :func:`emit` — the seams (breaker transitions and watchdog timeouts in
  ``device_supervisor``, mesh reshards in ``device_mesh``, batch lifecycle
  in ``device_telemetry`` and ``device_pipeline``, autotune decisions,
  fault-plan firings) append structured records into
  one bounded ring.  Each record carries a monotonic ``seq`` (the causal
  order), the logical ``slot`` from the ``fault_injection`` slot provider,
  the active ``trace_id`` (auto-resolved from ``tracing``'s contextvar),
  and — for device batches — the flight-recorder ``flight_seq``, so
  journal, trace trees and flight records cross-reference three ways.
- :func:`capture` — on trigger (breaker OPEN, ``DispatchTimeout``, a
  manual ``POST /lighthouse/postmortem``, or a caller's own reason) the
  current journal window is frozen to disk together with the flight ring,
  the implicated trace trees, the breaker, mesh, pipeline, autotune and
  device-telemetry snapshots, the registered snapshot providers (the HTTP server's
  admission controller), the fleet timeline, a metrics dump, the active
  fault plans and the log tail.  Bundles live under newest-K retention
  and are served by ``GET /lighthouse/postmortems``.

Import discipline: this module is host-side plumbing only (no torch).
Bundles are written under ``$TMPDIR`` (``LIGHTHOUSE_TPU_BLACKBOX_DIR``
overrides), never into the repository.  All subsystem snapshots are gathered via lazy imports inside
:func:`capture`, each individually guarded, so a bundle is best-effort
complete rather than all-or-nothing.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from . import locksmith, metrics, telemetry_scope
from .logs import get_logger

log = get_logger("blackbox")

#: Journal ring capacity.  Sized a comfortable multiple of the flight
#: recorder's default 256 so pre-incident context outlives ring eviction.
JOURNAL_CAPACITY = int(os.environ.get("LIGHTHOUSE_TPU_BLACKBOX_JOURNAL", "4096"))

#: Newest-K postmortem bundles kept on disk (older ones are pruned before
#: each new capture, so a flapping breaker can't fill the disk).
RETAIN = int(os.environ.get("LIGHTHOUSE_TPU_BLACKBOX_RETAIN", "8"))

#: At most this many implicated trace trees ride one bundle (the newest).
MAX_BUNDLE_TRACES = 8

#: Log-ring tail length frozen into each bundle.
BUNDLE_LOG_TAIL = 200

BUNDLE_PREFIX = "postmortem_"


def _default_dir() -> str:
    return os.environ.get(
        "LIGHTHOUSE_TPU_BLACKBOX_DIR",
        os.path.join(os.environ.get("TMPDIR", "/tmp"),
                     "lighthouse_tpu_postmortems"),
    )


BLACKBOX_EVENTS = metrics.counter(
    "blackbox_events_total",
    "incident-journal records appended, by emitting seam",
)
BLACKBOX_CAPTURES = metrics.counter(
    "blackbox_captures_total",
    "postmortem bundles frozen to disk, by trigger reason",
)


# ---------------------------------------------------------------- journal


class Journal:
    """Bounded ring of structured incident records in causal order.

    ``seq`` is assigned under the ring lock, so the sequence numbers ARE
    the causal order of arrival — concurrent emitters serialize here and
    nowhere else (one uncontended lock per record; no I/O, no metrics,
    no imports under the lock).
    """

    def __init__(self, capacity: int = JOURNAL_CAPACITY):
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self._lock = locksmith.lock("Journal._lock")
        self._seq = 0

    def append(self, record: dict) -> dict:
        with self._lock:
            self._seq += 1
            record["seq"] = self._seq
            self._buf.append(record)
        return record

    def window(self, limit: Optional[int] = None,
               source: Optional[str] = None) -> List[dict]:
        """Oldest→newest records (the whole ring by default)."""
        with self._lock:
            records = list(self._buf)
        if source is not None:
            records = [r for r in records if r.get("source") == source]
        if limit is not None:
            records = records[-max(1, int(limit)):]
        return [dict(r) for r in records]

    @property
    def emitted_total(self) -> int:
        with self._lock:
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()


JOURNAL = Journal()


def emit(source: str, event: str, *, trace_id: Optional[str] = None,
         flight_seq=None, link=None, **fields) -> dict:
    """Append one record to the incident journal (the seam entry point).

    ``trace_id`` is auto-resolved from the active span when not given;
    ``slot`` comes from the ``fault_injection`` slot provider (None in
    production, the virtual clock under the scenario runner).  Returns
    the record with its assigned ``seq``.

    When a :mod:`telemetry_scope` is active the record is ALSO mirrored
    into that node's scoped journal, stamped with ``node`` and a Lamport
    ``lamport`` tick — ``merge_journals`` orders the fleet timeline on
    those.  ``link=(origin_node, origin_lamport)`` declares a cross-node
    causal edge (a gossip import linking back to the proposal): the local
    clock ticks past the origin's, so the linked record merges strictly
    after its cause.  ``flight_seq`` accepts the plain int or the fleet
    ``(node_id, seq)`` pair.
    """
    if trace_id is None:
        from . import tracing

        sp = tracing.current_span()
        if sp is not None:
            trace_id = sp.trace.trace_id
    from . import fault_injection

    record: Dict[str, Any] = {
        "seq": 0,  # assigned under the journal lock
        "t_ms": int(time.time() * 1000),
        "slot": fault_injection.current_slot(),
        "source": source,
        "event": event,
    }
    if trace_id is not None:
        record["trace_id"] = trace_id
    if flight_seq is not None:
        if isinstance(flight_seq, (tuple, list)):
            record["flight_seq"] = [str(flight_seq[0]), int(flight_seq[1])]
        else:
            record["flight_seq"] = int(flight_seq)
    for k, v in fields.items():
        if v is not None:
            record[k] = v
    scope = telemetry_scope.current()
    if scope is not None:
        record["node"] = scope.node_id
        if link is not None:
            record["link"] = [str(link[0]), int(link[1])]
            record["lamport"] = scope.tick(at_least=int(link[1]))
            telemetry_scope.FLEET_TRACE_LINKS.inc(kind="journal-link")
        else:
            record["lamport"] = scope.tick()
        telemetry_scope.FLEET_JOURNAL_EVENTS.inc(node=scope.node_id)
        scope.tally.inc("fleet_journal_events_total", source=source)
    JOURNAL.append(record)
    if scope is not None:
        # per-node mirror: the copy gets the SCOPED journal's own seq
        scope.journal.append(dict(record))
    BLACKBOX_EVENTS.inc(source=source)
    return record


# ----------------------------------------------------- fleet timeline merge

#: Fields dropped from merged fleet-timeline entries: wall-clock stamps and
#: trace ids contain run-local entropy (``os.urandom`` suffixes, real time)
#: — the merged timeline must be byte-identical across two runs at one
#: seed, so only seed-deterministic fields survive the fold.  Canonical
#: fleet time is the virtual ``slot`` (the fault-injection slot provider),
#: not ``t_ms``.  ``capture_seq`` counts postmortem captures over the
#: process's life, so a second run in one process numbers its captures on
#: from the first's (the JAX package keeps it, and its breaker scenarios'
#: fleet timelines differ between two runs in one process).
VOLATILE_FIELDS = frozenset({"t_ms", "trace_id", "remote_trace_id",
                             "flight_seq", "capture_seq"})


def merge_key(record: dict):
    """(virtual slot, Lamport clock, node id, per-node seq) — slot-major,
    so cross-slot causality holds by construction and same-slot cross-node
    edges hold via the Lamport tick (see :func:`emit`'s ``link``)."""
    slot = record.get("slot")
    return (
        -1 if slot is None else int(slot),
        int(record.get("lamport", 0)),
        str(record.get("node", "")),
        int(record.get("seq", 0)),
    )


def merge_journals(journals: Dict[str, List[dict]]) -> List[dict]:
    """Fold N per-node journal windows (``node_id -> records``) into ONE
    causally ordered fleet timeline, keyed by :func:`merge_key` with
    :data:`VOLATILE_FIELDS` dropped.  Tolerates empty/partial journals,
    clock skew (per-node Lamport rates differ freely), and a node restart
    resetting its Lamport state (restarted records re-order only within
    their own slot, never across slots)."""
    merged: List[dict] = []
    for node_id, records in journals.items():
        for r in records or ():
            entry = {k: v for k, v in r.items() if k not in VOLATILE_FIELDS}
            entry.setdefault("node", str(node_id))
            merged.append(entry)
    merged.sort(key=merge_key)
    return merged


def fleet_summary(limit: Optional[int] = None) -> dict:
    """The ``GET /lighthouse/fleet`` payload, also frozen into every
    postmortem bundle and SOAK artifact: per-node scope snapshots plus the
    merged fleet timeline over all registered scopes."""
    scopes = telemetry_scope.all_scopes()
    timeline = merge_journals(
        {s.node_id: s.journal.window() for s in scopes})
    if limit is not None:
        timeline = timeline[-max(1, int(limit)):]
    return {
        "nodes": [s.snapshot() for s in scopes],
        "timeline": timeline,
    }


# ------------------------------------------------------- snapshot registry

#: Extra snapshot providers frozen into each bundle (name -> thunk).  The
#: HTTP server registers its admission controller here; anything process-
#: local that a 3am triage would want can join.
_SNAPSHOTTERS: Dict[str, Callable[[], Any]] = {}
_SNAPSHOTTERS_LOCK = locksmith.lock("blackbox._SNAPSHOTTERS_LOCK")


def register_snapshot(name: str, fn: Callable[[], Any]) -> None:
    with _SNAPSHOTTERS_LOCK:
        _SNAPSHOTTERS[name] = fn


def unregister_snapshot(name: str) -> None:
    with _SNAPSHOTTERS_LOCK:
        _SNAPSHOTTERS.pop(name, None)


def _safe(fn: Callable[[], Any]) -> Any:
    """A bundle is best-effort complete: a broken section records its error
    instead of aborting the capture (the capture IS the error report)."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — frozen into the bundle
        return {"error": f"{type(e).__name__}: {e}"}


# ----------------------------------------------------------------- capture

#: Serializes captures AND guards the index/dir state.  Module-level (not
#: per-object): captures are rare, seconds-scale events — serializing the
#: whole freeze keeps bundle contents internally consistent.
_CAPTURE_LOCK = locksmith.lock("blackbox._CAPTURE_LOCK")
_CAPTURE_SEQ = 0
_INDEX: deque = deque(maxlen=64)
_DIR_OVERRIDE: Optional[str] = None
_RETAIN_OVERRIDE: Optional[int] = None


def bundle_dir() -> str:
    return _DIR_OVERRIDE or _default_dir()


def retain() -> int:
    return _RETAIN_OVERRIDE if _RETAIN_OVERRIDE is not None else RETAIN


def configure(directory: Optional[str] = None,
              retain_bundles: Optional[int] = None) -> None:
    """Override the bundle directory / retention (tests, harnesses).
    ``None`` leaves a setting unchanged; :func:`reset_for_tests` restores
    the env defaults."""
    global _DIR_OVERRIDE, _RETAIN_OVERRIDE
    if directory is not None:
        _DIR_OVERRIDE = directory
    if retain_bundles is not None:
        _RETAIN_OVERRIDE = max(1, int(retain_bundles))


def _implicated_traces(journal: List[dict], flight: List[dict]) -> List[dict]:
    """Serialize the newest trace trees the journal/flight window names."""
    ids: List[str] = []
    for r in list(journal) + list(flight):
        tid = r.get("trace_id")
        if tid and tid not in ids:
            ids.append(tid)
    from . import tracing

    trees = []
    for tid in ids[-MAX_BUNDLE_TRACES:]:
        tr = tracing.TRACES.get(tid)
        if tr is not None:
            trees.append(_safe(lambda t=tr: tracing.trace_to_dict(t)))
    return trees


def _gather_snapshots() -> Dict[str, Any]:
    sections: Dict[str, Any] = {}

    def _supervisor():
        from . import device_supervisor

        return device_supervisor.summary()

    def _mesh():
        from . import device_mesh

        return device_mesh.summary()

    def _pipeline():
        from . import device_pipeline

        return device_pipeline.summary()

    def _autotune():
        from . import autotune

        return autotune.snapshot()

    def _telemetry():
        from . import device_telemetry

        return {
            "programs": device_telemetry.COMPILE_CACHE.inventory(),
            "host_fallbacks": device_telemetry.host_fallback_counts(),
            "boundary_primes": device_telemetry.boundary_prime_counts(),
            "flight_recorder": {
                "capacity": device_telemetry.FLIGHT_RECORDER.capacity,
                "stored": len(device_telemetry.FLIGHT_RECORDER),
                "recorded_total":
                    device_telemetry.FLIGHT_RECORDER.recorded_total,
            },
        }

    sections["supervisor"] = _safe(_supervisor)
    sections["mesh"] = _safe(_mesh)
    sections["pipeline"] = _safe(_pipeline)
    sections["autotune"] = _safe(_autotune)
    sections["telemetry"] = _safe(_telemetry)
    with _SNAPSHOTTERS_LOCK:
        extra = dict(_SNAPSHOTTERS)
    for name, fn in extra.items():
        sections[name] = _safe(fn)
    return sections


def _prune_locked(directory: str, keep: int) -> None:
    try:
        names = sorted(
            e for e in os.listdir(directory)
            if e.startswith(BUNDLE_PREFIX) and e.endswith(".json")
        )
    except OSError:
        return
    for stale in names[: max(0, len(names) - keep)]:
        try:
            os.remove(os.path.join(directory, stale))
        except OSError:
            pass


def capture(reason: str, extra: Optional[dict] = None) -> dict:
    """Freeze a correlated postmortem bundle to disk; returns its index
    entry (``path``, ``reason``, counts).  ``reason`` is free-form —
    conventionally ``trigger`` or ``trigger:detail`` (the metric label is
    the part before the colon, keeping cardinality bounded)."""
    global _CAPTURE_SEQ
    reason_label = reason.split(":", 1)[0]
    with _CAPTURE_LOCK:
        _CAPTURE_SEQ += 1
        seq = _CAPTURE_SEQ
        journal = JOURNAL.window()

        def _flight() -> List[dict]:
            from . import device_telemetry

            rec = device_telemetry.FLIGHT_RECORDER
            return rec.recent(limit=rec.capacity)

        flight = _safe(_flight)
        if not isinstance(flight, list):
            flight = [flight]

        def _faults():
            from . import fault_injection

            return fault_injection.summary()

        def _logs():
            from .logs import RING

            return RING.tail(BUNDLE_LOG_TAIL)

        from . import fault_injection

        bundle = {
            "version": 1,
            "reason": reason,
            "capture_seq": seq,
            "t_ms": int(time.time() * 1000),
            "slot": fault_injection.current_slot(),
            "pid": os.getpid(),
            "journal": journal,
            "flight_recorder": flight,
            "traces": _safe(lambda: _implicated_traces(journal, flight)),
            "snapshots": _gather_snapshots(),
            "faults": _safe(_faults),
            "logs_tail": _safe(_logs),
            "metrics": _safe(metrics.render_prometheus),
            "fleet": _safe(fleet_summary),
        }
        if extra is not None:
            bundle["extra"] = extra
        directory = bundle_dir()
        os.makedirs(directory, exist_ok=True)
        _prune_locked(directory, max(0, retain() - 1))
        name = f"{BUNDLE_PREFIX}{bundle['t_ms']:013d}_{seq:04d}_{reason_label}.json"
        path = os.path.join(directory, name)
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        index_entry = {
            "capture_seq": seq,
            "reason": reason,
            "t_ms": bundle["t_ms"],
            "slot": bundle["slot"],
            "path": path,
            "journal_records": len(journal),
            "flight_records": len(flight),
            "trace_trees": len(bundle["traces"])
            if isinstance(bundle["traces"], list) else 0,
        }
        _INDEX.append(index_entry)
    BLACKBOX_CAPTURES.inc(reason=reason_label)
    log.warning("postmortem bundle captured", reason=reason, path=path,
                journal_records=index_entry["journal_records"],
                flight_records=index_entry["flight_records"])
    # The capture event itself joins the journal AFTER the freeze — it
    # names this bundle in the NEXT bundle's pre-incident context, and a
    # capture can never recurse into itself.
    emit("blackbox", "capture", reason=reason, capture_seq=seq)
    return dict(index_entry)


def captures() -> List[dict]:
    """Index entries of bundles captured by THIS process (newest last)."""
    with _CAPTURE_LOCK:
        return [dict(e) for e in _INDEX]


def bundle_files() -> List[dict]:
    """Bundles currently on disk (any process), newest first."""
    directory = bundle_dir()
    try:
        names = sorted(
            (e for e in os.listdir(directory)
             if e.startswith(BUNDLE_PREFIX) and e.endswith(".json")),
            reverse=True,
        )
    except OSError:
        return []
    out = []
    for n in names:
        p = os.path.join(directory, n)
        try:
            size = os.path.getsize(p)
        except OSError:
            continue
        out.append({"file": n, "path": p, "bytes": size})
    return out


def load_bundle(name: str) -> Optional[dict]:
    """One bundle by file name (no path components accepted)."""
    if os.path.basename(name) != name or not name.startswith(BUNDLE_PREFIX):
        return None
    path = os.path.join(bundle_dir(), name)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def summary() -> dict:
    """The ``GET /lighthouse/postmortems`` payload."""
    return {
        "dir": bundle_dir(),
        "retain": retain(),
        "journal": {
            "capacity": JOURNAL.capacity,
            "stored": len(JOURNAL),
            "emitted_total": JOURNAL.emitted_total,
        },
        "captures": captures(),
        "bundles": bundle_files(),
    }


def reset_for_tests() -> None:
    """Clear journal + capture index and restore env-default dir/retention
    (disk bundles are left alone — tests own their tmp dirs)."""
    global _DIR_OVERRIDE, _RETAIN_OVERRIDE
    JOURNAL.clear()
    with _CAPTURE_LOCK:
        _INDEX.clear()
    _DIR_OVERRIDE = None
    _RETAIN_OVERRIDE = None
    telemetry_scope.reset_for_tests()
