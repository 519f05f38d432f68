"""Slot clocks.

Port of ``SlotClock`` (:12) and ``ManualSlotClock`` (:49) of
``lighthouse_tpu/common/slot_clock.py``.
"""

from __future__ import annotations


class SlotClock:
    def __init__(self, genesis_time: int, seconds_per_slot: int):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot

    def now(self) -> float:
        raise NotImplementedError

    def current_slot(self) -> int:
        t = self.now()
        if t < self.genesis_time:
            return 0
        return int((t - self.genesis_time) // self.seconds_per_slot)

    def slot_start(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot


class ManualSlotClock(SlotClock):
    """A clock that tests and benchmarks set explicitly."""

    def __init__(self, genesis_time: int, seconds_per_slot: int):
        super().__init__(genesis_time, seconds_per_slot)
        self._now = float(genesis_time)

    def now(self) -> float:
        return self._now

    def set_slot(self, slot: int):
        self._now = self.slot_start(slot)
