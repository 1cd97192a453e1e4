"""Virtual time for the scenario engine.

The port of ``lighthouse_tpu/virtual_clock.py`` (pure stdlib, the same
semantics).  The soak engine's control loops — pump deadlines, settle
quiescence windows, rekick cadences, breaker cooldowns and peer-score
decay — read time through this module, so a loaded box hits deadlines at
the same *virtual* points as an idle one.

Model
-----
* A **tick** is the scheduler quantum of the simulated fleet — the
  same unit ``transport.Hub`` counts for delayed-delivery heaps.  The
  hub's ``advance_tick`` drives the clock forward via ``on_tick``, so
  "ticks = hub ticks" holds by construction.
* Virtual **seconds** are derived: ``now() = ticks * tick_s`` with
  ``tick_s = 0.002`` (the settle loop's historical poll quantum).  All
  existing deadline constants (60 s sync, 30 s converge/settle, 1 s
  rekick, breaker cooldowns) keep their meaning as *idealized unloaded
  wall seconds*: a control loop that yields for ``y`` real seconds on
  an idle box advances the virtual clock by the same ``y``.
* **Slots** are derived from ticks (``ticks_per_slot``), giving fault
  plans and scenario gates a slot index that cannot drift from the
  clock.

Who may read the wall clock
---------------------------
Only this module.  ``WallClock`` wraps ``time.monotonic`` for
production (non-scenario) callers, and ``telemetry_stamp`` wraps it
for *telemetry* fields (artifact durations, log stamps) where real
elapsed time is the point.  ``wallclock_pass`` sanctions exactly those
two contexts; every other control-path read is a finding.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Union

#: Virtual seconds represented by one tick.  Chosen to match the old
#: settle poll sleep so "one settle round" costs the same virtual time
#: it used to cost in wall time.
TICK_S = 0.002

#: Real scheduling slice granted to a busy worker thread per settle
#: round.  Virtual time is charged for it via ``charge`` so settle's
#: virtual budget tracks the real waiting it grants.
WAIT_SLICE_S = 0.05


class VirtualClock:
    """A monotonic tick counter masquerading as a clock.

    Thread-safe: the hub tick thread, the scenario runner, and worker
    threads all advance/read it.  Uses a plain ``threading.Lock`` (not
    ``locksmith``) deliberately — the clock is a leaf that never calls
    out while holding its lock, and keeping it out of the lock graph
    keeps the committed graph stable.
    """

    def __init__(self, tick_s: float = TICK_S, *,
                 ticks_per_slot: Optional[int] = None,
                 seconds_per_slot: float = 1.0) -> None:
        if tick_s <= 0:
            raise ValueError("tick_s must be positive")
        self.tick_s = float(tick_s)
        if ticks_per_slot is None:
            ticks_per_slot = max(1, round(seconds_per_slot / self.tick_s))
        if ticks_per_slot <= 0:
            raise ValueError("ticks_per_slot must be positive")
        self.ticks_per_slot = int(ticks_per_slot)
        self._ticks = 0
        self._lock = threading.Lock()

    # ----------------------------------------------------------- reads

    @property
    def ticks(self) -> int:
        with self._lock:
            return self._ticks

    def now(self) -> float:
        """Virtual seconds since clock creation (monotonic)."""
        with self._lock:
            return self._ticks * self.tick_s

    def slot(self) -> int:
        """Slot index derived from ticks."""
        with self._lock:
            return self._ticks // self.ticks_per_slot

    # -------------------------------------------------------- advances

    def advance(self, n: int = 1) -> int:
        """Advance ``n`` ticks; returns the new tick count.

        The hub's ``on_tick`` hook calls this with ``n=1`` per
        delivered tick, which is what makes "ticks = hub ticks" true.
        """
        if n < 0:
            raise ValueError("clock cannot go backwards")
        with self._lock:
            self._ticks += int(n)
            return self._ticks

    def snap_to_next_slot(self) -> int:
        """Advance to the next slot boundary; returns the new tick count.

        The scenario runner calls this at the end of every stepped slot.
        Within-slot tick accrual (settle rounds, wait-slice charges) is
        schedule-dependent; snapping re-anchors the clock so any duration
        that SPANS slots — breaker cooldowns, score decay across a fault
        window — is a deterministic function of the slot timeline alone.
        """
        with self._lock:
            self._ticks += self.ticks_per_slot - (
                self._ticks % self.ticks_per_slot)
            return self._ticks

    def charge(self, seconds: float) -> None:
        """Account for ``seconds`` of real waiting done elsewhere.

        ``Simulator.settle`` grants a busy processor a real
        ``wait_idle(WAIT_SLICE_S)`` slice; charging the equivalent
        ticks keeps the virtual deadline budget aligned with the real
        waiting actually performed, so settle timeouts neither starve
        nor balloon relative to the old wall-clock budget.
        """
        if seconds > 0:
            self.advance(max(1, round(seconds / self.tick_s)))

    # ---------------------------------------------------------- yields

    def lull(self, yield_s: float) -> None:
        """Yield the CPU for ``yield_s`` real seconds *and* advance the
        equivalent virtual ticks.

        This is the control loop's replacement for a bare
        ``time.sleep``: the real yield lets worker threads run, while
        the tick advance moves virtual deadlines at the idealized
        unloaded rate — host load can delay the yield's return without
        shifting the virtual point at which a deadline fires.
        """
        if yield_s > 0:
            time.sleep(yield_s)
            self.advance(max(1, round(yield_s / self.tick_s)))

    def sleep(self, seconds: float) -> None:
        """Burn ``seconds`` of *virtual* time with one real yield.

        Used by the fault-injection hang seam during scenarios: a
        2-second injected hang advances the virtual clock 1000 ticks
        but costs ~0 real time, which is what makes hundreds-of-epochs
        soaks affordable.
        """
        if seconds > 0:
            self.advance(max(1, round(seconds / self.tick_s)))
            time.sleep(0)  # one real yield so waiters can observe it


class WallClock:
    """Production default: virtual time *is* wall time.

    ``now`` is the single sanctioned control-path ``time.monotonic``
    read; ``lull`` degrades to a plain sleep and the virtual-only
    operations are no-ops (wall time advances itself).
    """

    tick_s = TICK_S
    ticks_per_slot = max(1, round(1.0 / TICK_S))

    @property
    def ticks(self) -> int:
        return int(self.now() / self.tick_s)

    def now(self) -> float:
        return time.monotonic()

    def slot(self) -> int:
        return self.ticks // self.ticks_per_slot

    def advance(self, n: int = 1) -> int:
        return self.ticks

    def snap_to_next_slot(self) -> int:
        return self.ticks

    def charge(self, seconds: float) -> None:
        pass

    def lull(self, yield_s: float) -> None:
        if yield_s > 0:
            time.sleep(yield_s)

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


Clock = Union[VirtualClock, WallClock]


def telemetry_stamp() -> float:
    """Wall-clock stamp for telemetry fields (durations, artifacts).

    Telemetry wants *real* elapsed time — an operator reading
    ``duration_s`` in a SOAK artifact is asking how long the run took
    on their box, not how much virtual time it simulated.  This is the
    sanctioned seam for those reads; control paths must use a Clock.
    """
    return time.monotonic()


class _CallableShim:
    """Adapts a legacy ``clock=time.monotonic``-style callable to the
    Clock protocol (``Simulator(clock=fn)`` predates this module)."""

    tick_s = TICK_S
    ticks_per_slot = max(1, round(1.0 / TICK_S))

    def __init__(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def ticks(self) -> int:
        return int(self._fn() / self.tick_s)

    def now(self) -> float:
        return self._fn()

    def slot(self) -> int:
        return self.ticks // self.ticks_per_slot

    def advance(self, n: int = 1) -> int:
        return self.ticks

    def snap_to_next_slot(self) -> int:
        return self.ticks

    def charge(self, seconds: float) -> None:
        pass

    def lull(self, yield_s: float) -> None:
        if yield_s > 0:
            time.sleep(yield_s)

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


def ensure_clock(clock) -> Clock:
    """Coerce ``None`` / legacy callables / Clock instances to a Clock."""
    if clock is None:
        return WallClock()
    if hasattr(clock, "now") and hasattr(clock, "lull"):
        return clock
    if callable(clock):
        return _CallableShim(clock)
    raise TypeError(f"not a clock: {clock!r}")
