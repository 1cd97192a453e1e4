"""Structured logging: the reference's ``common/logging`` role.

The reference emits slog-style structured records (message + key=value
fields) to the terminal and keeps an in-memory tail that the HTTP API
streams over SSE (``common/logging/src/lib.rs:207-224`` — Siren's live log
view).  Here:

- ``setup_logging`` installs a key=value formatter (or JSON lines with
  ``json_format=True``) on the ``lighthouse_tpu_torch`` logger tree.
- ``LogRing`` is a bounded ring of recent records every handler feeds;
  ``/lighthouse/logs`` (http_api) streams it as SSE.
- ``get_logger(name).info("imported block", slot=5, root="0x..")`` —
  keyword fields ride the record and render as ``key=value`` pairs.
"""

from __future__ import annotations

import collections
import io
import json
import logging
import threading
import time
from typing import Deque, Dict, List, Optional

_ROOT_NAME = "lighthouse_tpu_torch"


class LogRing(logging.Handler):
    """Keep the last N formatted records for the SSE tail (the reference's
    SSELoggingComponents channel)."""

    def __init__(self, capacity: int = 512):
        super().__init__()
        self.capacity = capacity
        self._buf: Deque[dict] = collections.deque(maxlen=capacity)
        self._cv = threading.Condition()
        self._seq = 0

    def emit(self, record: logging.LogRecord) -> None:
        entry = {
            "seq": 0,  # assigned under the lock
            "time": round(record.created, 3),
            "level": record.levelname,
            "module": record.name,
            "message": record.getMessage(),
            "fields": getattr(record, "structured_fields", {}),
        }
        # Log lines join the black-box cross-reference scheme: a line
        # emitted inside a traced request carries its trace id, so a
        # postmortem bundle's log tail links to the implicated trace
        # trees the same way journal and flight records do.  (Imported
        # here, not at module top: ``tracing`` is stdlib-only, but every
        # module in the package imports ``logs`` first.)
        from . import tracing

        sp = tracing.current_span()
        if sp is not None:
            entry["trace_id"] = sp.trace.trace_id
        with self._cv:
            self._seq += 1
            entry["seq"] = self._seq
            self._buf.append(entry)
            self._cv.notify_all()

    def tail(self, n: int = 100) -> List[dict]:
        with self._cv:
            return list(self._buf)[-n:]

    def wait_for(self, after_seq: int, timeout: float = 10.0) -> List[dict]:
        """Records with seq > after_seq, blocking up to ``timeout``."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                fresh = [e for e in self._buf if e["seq"] > after_seq]
                if fresh:
                    return fresh
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cv.wait(remaining)


RING = LogRing()


class StructuredFormatter(logging.Formatter):
    """``HH:MM:SS.mmm LEVL module  message  key=value ...`` (slog-shaped)."""

    def __init__(self, json_format: bool = False):
        super().__init__()
        self.json_format = json_format

    def format(self, record: logging.LogRecord) -> str:
        fields: Dict = getattr(record, "structured_fields", {})
        if self.json_format:
            return json.dumps({
                "ts": round(record.created, 3),
                "level": record.levelname,
                "module": record.name,
                "msg": record.getMessage(),
                **fields,
            })
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        ms = int((record.created % 1) * 1000)
        out = io.StringIO()
        out.write(f"{ts}.{ms:03d} {record.levelname:<5} {record.name}  ")
        out.write(record.getMessage())
        for k, v in fields.items():
            out.write(f"  {k}={v}")
        if record.exc_info:
            out.write("\n" + self.formatException(record.exc_info))
        return out.getvalue()


class StructuredAdapter(logging.LoggerAdapter):
    """Keyword arguments become structured fields:
    ``log.info("imported", slot=5)`` -> ``imported  slot=5``."""

    _RESERVED = {"exc_info", "stack_info", "stacklevel", "extra"}

    def _forward(self, level, msg, args, kwargs):
        fields = {k: v for k, v in kwargs.items() if k not in self._RESERVED}
        passthrough = {k: v for k, v in kwargs.items() if k in self._RESERVED}
        extra = passthrough.setdefault("extra", {})
        extra["structured_fields"] = fields
        self.logger.log(level, msg, *args, **passthrough)

    def debug(self, msg, *args, **kwargs):
        self._forward(logging.DEBUG, msg, args, kwargs)

    def info(self, msg, *args, **kwargs):
        self._forward(logging.INFO, msg, args, kwargs)

    def warning(self, msg, *args, **kwargs):
        self._forward(logging.WARNING, msg, args, kwargs)

    def error(self, msg, *args, **kwargs):
        self._forward(logging.ERROR, msg, args, kwargs)

    def critical(self, msg, *args, **kwargs):
        self._forward(logging.CRITICAL, msg, args, kwargs)


def get_logger(name: str) -> StructuredAdapter:
    """Logger under the package tree; fields via keyword arguments."""
    full = name if name.startswith(_ROOT_NAME) else f"{_ROOT_NAME}.{name}"
    return StructuredAdapter(logging.getLogger(full), {})


_configured = False


def setup_logging(level: int = logging.INFO, *, json_format: bool = False,
                  stream=None) -> None:
    """Install the structured formatter + the SSE ring on the package tree.
    Idempotent; safe to call from the CLI and from tests."""
    global _configured
    root = logging.getLogger(_ROOT_NAME)
    root.setLevel(level)
    if _configured:
        return
    handler = logging.StreamHandler(stream)
    handler.setFormatter(StructuredFormatter(json_format=json_format))
    root.addHandler(handler)
    root.addHandler(RING)
    root.propagate = False
    _configured = True
