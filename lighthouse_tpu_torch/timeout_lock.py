"""Timeout-guarded locks: deadlocks must scream, not hang.

The reference wraps its canonical-head and snapshot locks in
``TimeoutRwLock`` (beacon_chain/src/timeout_rw_lock.rs): a lock held past a
deadline raises instead of blocking forever, because a deadlock between the
HTTP threads, the processor workers and the import path would otherwise
present as a silent stall.  Python's GIL removes data races but not
lock-ordering deadlocks — the same discipline applies.
"""

from __future__ import annotations

from . import locksmith
from .logs import get_logger

log = get_logger("locks")

#: Generous default: normal holds are micro/milliseconds; anything reaching
#: this is a bug, not contention (reference uses 1s for the head lock).
DEFAULT_TIMEOUT = 5.0


class LockTimeout(Exception):
    """A lock acquire exceeded its deadline — report the likely deadlock."""


class TimeoutLock:
    """``with lock:`` like ``threading.Lock``, but a bounded acquire that
    raises ``LockTimeout`` (and logs, with the lock's name) on expiry."""

    def __init__(self, name: str = "lock", timeout: float = DEFAULT_TIMEOUT,
                 label: str = None):
        # Label routing: the inner lock comes from the lock sanitizer's
        # factory, so under LIGHTHOUSE_TPU_LOCK_SANITIZE=1 TimeoutLock
        # acquisitions take part in the runtime order and ownership checks
        # under their static-graph label ("Class.attr").  Off by default:
        # the factory returns a plain threading.Lock.
        self._lock = locksmith.lock(label or name)
        self.name = name
        self.timeout = timeout

    def acquire(self, timeout: float = None) -> bool:
        limit = self.timeout if timeout is None else timeout
        if self._lock.acquire(timeout=limit):
            return True
        log.error("lock acquire timed out (possible deadlock)",
                  lock=self.name, timeout_s=limit)
        raise LockTimeout(f"{self.name}: not acquired within {limit}s")

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "TimeoutLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()
