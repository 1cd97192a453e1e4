"""Runtime lock sanitizer: the dynamic check of the static lock graph.

The port of ``lighthouse_tpu/locksmith.py``.  The static analysis layer
extracts a lock-acquisition order graph
(``scripts/analysis/lock_order_pass.acquisition_edges`` over the port's
paths → ``lighthouse_tpu_torch/lock_graph.py``) and an ownership registry
mapping each lock to the attributes it guards
(``lighthouse_tpu_torch/lock_ownership.py``).  Both are *claims*.  This
module is the dynamic cross-check: an opt-in instrumented-lock layer that
records per-thread acquisition sequences while tests run and turns two
classes of divergence into failures:

- **order inversion** — a thread acquires ``B`` while holding ``A`` when
  the committed static graph only proves the ``B -> A`` order (and the
  pair is not listed in ``lock_ownership.SANCTIONED_ORDER_PAIRS``);
- **unguarded write** — a write to a registry-listed attribute on a
  ``guard()``-ed instance while the owning lock is not held by the
  writing thread.

Zero overhead by default: unless ``LIGHTHOUSE_TPU_LOCK_SANITIZE=1`` is
set in the environment *at construction time*, the factories return the
plain ``threading`` primitives — no wrapper, no indirection, asserted by
``tests/test_torch_locksmith.py``.  The construction sites of the
concurrent subsystems route through these factories, so setting the
variable sanitizes the whole tree; ``TimeoutLock`` routes its inner lock
here too (label routing), so the breaker, supervisor and mesh locks take
part.

Checks happen at acquire *attempt* time (before blocking), so an
inversion is reported even when it does not happen to deadlock in this
interleaving: the sanitizer catches the schedule a run did not get.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from .lock_graph import EDGES as _STATIC_EDGES
from .lock_ownership import LOCK_OWNERSHIP, SANCTIONED_ORDER_PAIRS

ENV_VAR = "LIGHTHOUSE_TPU_LOCK_SANITIZE"

#: Forward edges the static pass proved.  An observed edge (A, B) whose
#: reverse (B, A) is the only statically-proven direction is an inversion.
_EDGE_SET = frozenset(_STATIC_EDGES)


class SanitizerViolation(AssertionError):
    """Raised by ``check()`` when the sanitizer recorded violations."""


def enabled() -> bool:
    return os.environ.get(ENV_VAR, "") == "1"


# --------------------------------------------------------------- recording

#: Guards the violation log itself (deliberately a raw primitive: the
#: sanitizer must never recurse into its own bookkeeping).
_LOG_LOCK = threading.Lock()
_VIOLATIONS: List[str] = []
_OBSERVED_EDGES: Dict[Tuple[str, str], str] = {}  # edge -> first witness

_tls = threading.local()


def _held() -> List[str]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _record(kind: str, detail: str) -> None:
    with _LOG_LOCK:
        _VIOLATIONS.append(f"{kind}: {detail}")


def violations() -> List[str]:
    with _LOG_LOCK:
        return list(_VIOLATIONS)


def observed_edges() -> List[Tuple[str, str]]:
    with _LOG_LOCK:
        return sorted(_OBSERVED_EDGES)


def reset() -> None:
    with _LOG_LOCK:
        _VIOLATIONS.clear()
        _OBSERVED_EDGES.clear()


def check() -> None:
    """Raise ``SanitizerViolation`` if anything was recorded — call at the
    end of a sanitized test so divergence reddens it."""
    vs = violations()
    if vs:
        raise SanitizerViolation(
            f"{len(vs)} lock-sanitizer violation(s):\n" + "\n".join(vs)
        )


def _note_attempt(label: str) -> None:
    """Order check at acquire-attempt time, against the static graph."""
    me = threading.current_thread().name
    for held in _held():
        if held == label:
            continue
        edge = (held, label)
        with _LOG_LOCK:
            _OBSERVED_EDGES.setdefault(edge, me)
        if edge in SANCTIONED_ORDER_PAIRS:
            continue
        if (label, held) in _EDGE_SET and edge not in _EDGE_SET:
            _record(
                "order-inversion",
                f"thread {me!r} acquires {label} while holding {held}, but "
                f"the static lock graph only proves {label} -> {held} "
                "(lock_graph.EDGES); sanction the pair in "
                "lock_ownership.SANCTIONED_ORDER_PAIRS or fix the order",
            )


# ------------------------------------------------------- sanitized wrappers


class _SanitizedLock:
    """``threading.Lock`` semantics + acquisition-sequence recording."""

    _reentrant = False

    def __init__(self, label: str):
        self.label = label
        self._inner = self._make_inner()
        self._owner: Optional[int] = None
        self._count = 0

    def _make_inner(self):
        return threading.Lock()

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident() and self._count > 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        reacquire = self._reentrant and self.held_by_me()
        if not reacquire:
            _note_attempt(self.label)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._owner = threading.get_ident()
            self._count += 1
            if not reacquire:
                _held().append(self.label)
        return ok

    def release(self) -> None:
        self._count -= 1
        if self._count <= 0:
            self._owner = None
            held = _held()
            if self.label in held:
                held.remove(self.label)
        self._inner.release()

    def __enter__(self) -> "_SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.label!r}>"


class _SanitizedRLock(_SanitizedLock):
    _reentrant = True

    def _make_inner(self):
        return threading.RLock()

    # Condition integration: an RLock-backed Condition needs these three.
    def _release_save(self):
        count, self._count = self._count, 0
        self._owner = None
        held = _held()
        if self.label in held:
            held.remove(self.label)
        state = self._inner._release_save()
        return (count, state)

    def _acquire_restore(self, saved):
        count, state = saved
        self._inner._acquire_restore(state)
        self._owner = threading.get_ident()
        self._count = count
        _held().append(self.label)

    def _is_owned(self) -> bool:
        return self.held_by_me()


def lock(label: str) -> "threading.Lock":
    """A mutex: plain ``threading.Lock`` unless sanitizing."""
    if not enabled():
        return threading.Lock()
    return _SanitizedLock(label)


def rlock(label: str) -> "threading.RLock":
    if not enabled():
        return threading.RLock()
    return _SanitizedRLock(label)


def condition(label: str) -> "threading.Condition":
    """A ``Condition`` whose underlying lock is label-routed when
    sanitizing (``Condition.wait`` releases and re-acquires through the
    wrapper, so waits never read as order violations)."""
    if not enabled():
        return threading.Condition()
    return threading.Condition(_SanitizedRLock(label))


# --------------------------------------------------------- write guarding

#: class name -> {guarded attr -> owning lock attr}, from the registry.
_ATTR_GUARDS: Dict[str, Dict[str, str]] = {}
for _entry in LOCK_OWNERSHIP.values():
    for _cls, _locks in _entry.get("classes", {}).items():
        _amap = _ATTR_GUARDS.setdefault(_cls, {})
        for _lock_attr, _attrs in _locks.items():
            for _a in _attrs:
                _amap[_a] = _lock_attr

_GUARDED_CACHE: Dict[type, type] = {}


def _lock_held(lk: object) -> Optional[bool]:
    """True/False when ``lk``'s hold state is knowable, None otherwise.
    Unwraps ``TimeoutLock``-style wrappers (duck-typed ``._lock``)."""
    seen = 0
    while not isinstance(lk, _SanitizedLock) and seen < 3:
        inner = getattr(lk, "_lock", None)
        if inner is None:
            return None
        lk, seen = inner, seen + 1
    if isinstance(lk, _SanitizedLock):
        return lk.held_by_me()
    return None


def guard(obj: object, attr_map: Optional[Dict[str, str]] = None) -> object:
    """Swap ``obj``'s class for a write-guarded subclass: every write to a
    registry-listed attribute asserts the owning lock is held by the
    writing thread.  No-op (returns ``obj`` unchanged) when the sanitizer
    is off or the class has no registered attributes.  Apply *after*
    ``__init__`` — construction-time writes are happens-before publish and
    exempt, matching the static race pass."""
    if not enabled():
        return obj
    base = type(obj)
    amap = attr_map if attr_map is not None else _ATTR_GUARDS.get(base.__name__)
    if not amap:
        return obj
    key = base if attr_map is None else (base, tuple(sorted(amap.items())))
    gcls = _GUARDED_CACHE.get(key)
    if gcls is None:

        def __setattr__(self, name, value, _amap=amap, _base=base):
            owner = _amap.get(name)
            if owner is not None:
                held = _lock_held(self.__dict__.get(owner))
                if held is False:
                    _record(
                        "unguarded-write",
                        f"{_base.__name__}.{name} written by thread "
                        f"{threading.current_thread().name!r} without "
                        f"holding {_base.__name__}.{owner} "
                        "(lock_ownership registry)",
                    )
            _base.__setattr__(self, name, value)

        gcls = type(f"_Guarded{base.__name__}", (base,),
                    {"__setattr__": __setattr__, "__module__": base.__module__})
        _GUARDED_CACHE[key] = gcls
    obj.__class__ = gcls
    return obj
