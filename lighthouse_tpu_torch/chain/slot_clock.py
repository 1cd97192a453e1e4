"""Slot clocks (reference: ``common/slot_clock`` — ``SystemTimeSlotClock`` for
production, ``ManualSlotClock`` for deterministic tests).

A copy of the JAX package's ``lighthouse_tpu/chain/slot_clock.py``.
"""

from __future__ import annotations

import time
from typing import Optional


class SlotClock:
    def __init__(self, genesis_time: int, seconds_per_slot: int):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot

    def _seconds(self) -> float:
        raise NotImplementedError

    def now(self) -> Optional[int]:
        """Current slot, or None before genesis."""
        s = self._seconds()
        if s < self.genesis_time:
            return None
        return int(s - self.genesis_time) // self.seconds_per_slot

    def start_of(self, slot: int) -> int:
        return self.genesis_time + slot * self.seconds_per_slot

    def seconds_from_current_slot_start(self) -> Optional[float]:
        now_slot = self.now()
        if now_slot is None:
            return None
        return self._seconds() - self.start_of(now_slot)

    def duration_to_next_slot(self) -> Optional[float]:
        now_slot = self.now()
        if now_slot is None:
            return None
        return self.start_of(now_slot + 1) - self._seconds()


class SystemTimeSlotClock(SlotClock):
    def _seconds(self) -> float:
        return time.time()


class ManualSlotClock(SlotClock):
    """Test clock advanced explicitly (reference ``manual_slot_clock.rs``)."""

    def __init__(self, genesis_time: int, seconds_per_slot: int):
        super().__init__(genesis_time, seconds_per_slot)
        self._now: float = float(genesis_time)

    def _seconds(self) -> float:
        return self._now

    def set_slot(self, slot: int, offset_seconds: float = 0.0) -> None:
        self._now = self.start_of(slot) + offset_seconds

    def advance_slot(self) -> None:
        current = self.now()
        self.set_slot((current if current is not None else -1) + 1)

    def advance_seconds(self, seconds: float) -> None:
        self._now += seconds
