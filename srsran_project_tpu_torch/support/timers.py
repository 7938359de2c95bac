"""Tick-driven timer manager — counterpart of the reference's
timer_manager (lib/support/timers.cpp, include/srsran/support/timers.h).

The reference advances a central timer wheel from the slot indication and
runs expiry callbacks on the owner's executor.  Here the same contract,
host-side: unique timers are created against the manager, set with a
duration in ticks, and `tick()` (called once per slot by the runtime loop)
fires due callbacks.  The L2 entities (rlc/pdcp) keep their internal
deadline logic; this manager serves procedure guards, periodic metrics
reports, and anything that needs a cancelable timeout.

A timer wheel bucketed by expiry tick keeps tick() O(due timers), not
O(live timers).  A copy of ``srsran_project_tpu/support/timers.py``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable


class UniqueTimer:
    """One cancelable, restartable timer owned by a TimerManager."""

    def __init__(self, mgr: "TimerManager", timer_id: int):
        self._mgr = mgr
        self.id = timer_id
        self.duration: int | None = None
        self._epoch = 0  # invalidates stale wheel entries on stop/restart

    def set(self, duration_ticks: int, callback: Callable[[], None] | None = None) -> None:
        """Arm (or re-arm) the timer; replaces any previous deadline."""
        assert duration_ticks >= 0
        self.duration = duration_ticks
        if callback is not None:
            self._callback = callback
        self._epoch += 1
        self._mgr._schedule(self, self._mgr.now + duration_ticks, self._epoch)

    def run(self) -> None:
        """Re-arm with the last duration (reference timer.run())."""
        assert self.duration is not None, "set() a duration first"
        self.set(self.duration)

    def stop(self) -> None:
        self._epoch += 1  # wheel entry becomes stale

    @property
    def is_running(self) -> bool:
        return self._mgr._armed_epoch.get(self.id) == self._epoch and self._epoch > 0 \
            and self.id in self._mgr._live

    _callback: Callable[[], None] = staticmethod(lambda: None)


class TimerManager:
    """Central tick-driven wheel; tick() once per slot."""

    def __init__(self):
        self.now = 0
        self._next_id = 0
        self._wheel: dict[int, list[tuple[int, int]]] = defaultdict(list)
        self._timers: dict[int, UniqueTimer] = {}
        self._armed_epoch: dict[int, int] = {}
        self._live: set[int] = set()
        self.nof_expiries = 0

    def create_timer(self) -> UniqueTimer:
        t = UniqueTimer(self, self._next_id)
        self._timers[t.id] = t
        self._next_id += 1
        return t

    def _schedule(self, t: UniqueTimer, deadline: int, epoch: int) -> None:
        self._wheel[deadline].append((t.id, epoch))
        self._armed_epoch[t.id] = epoch
        self._live.add(t.id)

    def tick(self, n: int = 1) -> int:
        """Advance time by n ticks; fire due, non-stale timers.  Returns the
        number of expiries."""
        fired = 0
        for _ in range(n):
            self.now += 1
            due = self._wheel.pop(self.now, ())
            for timer_id, epoch in due:
                t = self._timers.get(timer_id)
                if t is None or t._epoch != epoch:
                    continue  # stopped or re-armed since scheduling
                self._live.discard(timer_id)
                fired += 1
                self.nof_expiries += 1
                t._callback()
        return fired

    @property
    def nof_running_timers(self) -> int:
        return len([i for i in self._live
                    if self._armed_epoch.get(i) == self._timers[i]._epoch])
