"""Realtime timing worker: wall-clock slot ticker.

A copy of ``srsran_project_tpu/ofh/timing.py``; its clock is
``time.monotonic`` (tests replace this module's ``time`` with a fake one).

Counterpart of the reference's realtime_timing_worker
(lib/ofh/timing/realtime_timing_worker.cpp:44-124: sleeps a fraction of a
symbol, derives slot_point from the GPS clock, notifies on slot
boundaries): derives the current SlotPoint from a monotonic epoch, sleeps
1/15 of a symbol between polls, and invokes the registered callback once
per new slot — flagging skipped slots when the host falls behind (the
late-tick pathology the reference logs).
"""

from __future__ import annotations

import time
from typing import Callable

from ..ran.constants import SubcarrierSpacing, nof_slots_per_subframe
from ..ran.slot_point import SlotPoint

SYMBOLS_PER_SLOT = 14


class RealtimeTimingWorker:
    def __init__(self, scs: SubcarrierSpacing = SubcarrierSpacing.KHZ30,
                 on_slot: Callable[[SlotPoint], None] | None = None,
                 gps_alpha_s: float = 0.0):
        self.scs = scs
        self.on_slot = on_slot or (lambda s: None)
        self.slot_duration_s = 1e-3 / nof_slots_per_subframe(scs)
        self.poll_sleep_s = self.slot_duration_s / SYMBOLS_PER_SLOT / 15
        self.epoch = time.monotonic() - gps_alpha_s
        self.slots_notified = 0
        self.slots_skipped = 0
        self._last = -1
        self._stop = False

    def current_slot_count(self) -> int:
        return int((time.monotonic() - self.epoch) / self.slot_duration_s)

    def poll(self) -> int:
        """Notify for any new slot boundary since the last poll; returns the
        number of notifications issued (1 normally; >1 means we fell behind
        and intermediate slots are reported as skipped)."""
        cur = self.current_slot_count()
        if cur == self._last:
            return 0
        issued = 0
        if self._last >= 0 and cur > self._last + 1:
            self.slots_skipped += cur - self._last - 1
        self._last = cur
        frame_len = 1024 * 10 * nof_slots_per_subframe(self.scs)
        self.on_slot(SlotPoint(scs=self.scs, count=cur % frame_len))
        self.slots_notified += 1
        issued += 1
        return issued

    def run(self, nof_slots: int) -> None:
        """Blocking loop for nof_slots notifications (tests/apps)."""
        while self.slots_notified < nof_slots and not self._stop:
            if self.poll() == 0:
                time.sleep(self.poll_sleep_s)

    def stop(self) -> None:
        self._stop = True
