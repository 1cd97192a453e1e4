"""The black box: one causally-ordered incident journal + postmortem bundles.

The flight recorder, the trace ring and the supervisor's breakers answer
"what is the device runtime doing now"; this module answers "what
happened": every supervised seam appends to one journal, and a trigger
freezes the journal with what it cross-references.

- :func:`emit` — the seams (breaker transitions and watchdog timeouts in
  ``device_supervisor``, batch lifecycle in ``device_telemetry`` and
  ``device_pipeline``, fault-plan firings) append structured records into
  one bounded ring.  Each record carries a monotonic ``seq`` (the causal
  order), the logical ``slot`` from the ``fault_injection`` slot provider,
  the active ``trace_id`` (auto-resolved from ``tracing``'s contextvar),
  and — for device batches — the flight-recorder ``flight_seq``, so
  journal, trace trees and flight records cross-reference three ways.
- :func:`capture` — on trigger (breaker OPEN, ``DispatchTimeout``, or a
  caller's own reason) the current journal window is frozen to disk
  together with the flight ring, the implicated trace trees, the
  breaker, pipeline and device-telemetry snapshots, a metrics dump, the
  active fault plans and the log tail.  Bundles live under newest-K
  retention.

Import discipline: this module is host-side plumbing only (no torch).
Bundles are written under ``$TMPDIR`` (``LIGHTHOUSE_TPU_BLACKBOX_DIR``
overrides), never into the repository.  All subsystem snapshots are gathered via lazy imports inside
:func:`capture`, each individually guarded, so a bundle is best-effort
complete rather than all-or-nothing.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from . import metrics
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
        self._lock = threading.Lock()
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
         flight_seq: Optional[int] = None, **fields) -> dict:
    """Append one record to the incident journal (the seam entry point).

    ``trace_id`` is auto-resolved from the active span when not given;
    ``slot`` comes from the ``fault_injection`` slot provider (None in
    production, the virtual clock under the scenario runner).  Returns
    the record with its assigned ``seq``.

    The JAX package's per-node mirroring (telemetry scopes, Lamport ticks,
    cross-node links) comes with a multi-node simulator, which the port
    does not have yet.
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
        record["flight_seq"] = int(flight_seq)
    for k, v in fields.items():
        if v is not None:
            record[k] = v
    JOURNAL.append(record)
    BLACKBOX_EVENTS.inc(source=source)
    return record


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
_CAPTURE_LOCK = threading.Lock()
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

    def _pipeline():
        from . import device_pipeline

        return device_pipeline.summary()

    def _telemetry():
        from . import device_telemetry

        return {
            "programs": device_telemetry.COMPILE_CACHE.inventory(),
            "host_fallbacks": device_telemetry.host_fallback_counts(),
            "flight_recorder": {
                "capacity": device_telemetry.FLIGHT_RECORDER.capacity,
                "stored": len(device_telemetry.FLIGHT_RECORDER),
                "recorded_total":
                    device_telemetry.FLIGHT_RECORDER.recorded_total,
            },
        }

    sections["supervisor"] = _safe(_supervisor)
    sections["pipeline"] = _safe(_pipeline)
    sections["telemetry"] = _safe(_telemetry)
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


def summary() -> dict:
    """The black box's state: journal, captures and bundles on disk."""
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
