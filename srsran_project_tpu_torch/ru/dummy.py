"""Dummy Radio Unit: timing + late-request accounting without any radio.

A copy of ``srsran_project_tpu/ru/dummy.py``.

Counterpart of lib/ru/dummy/ru_dummy_impl.{h,cpp} + ru_dummy_sector.h:
a slot ticker drives the sectors; each sector holds ring-buffered DL/UL/
PRACH requests indexed by ``system_slot % ring_size`` and, on every slot
boundary, pops the entry for the boundary slot — a non-matching stored
context means the upper layer delivered the request late
(ru_dummy_sector.h:154-207).  Used for performance/stability testing of
everything above the RU without RF.

Redesign notes: the reference's executor-deferred loop + atomics collapse
to a single ticker (RealtimeTimingWorker re-used from the OFH subsystem,
or manual ``tick()`` for deterministic tests) and plain counters guarded
by the per-sector lock.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

from ..ofh.timing import RealtimeTimingWorker
from ..ran.constants import SubcarrierSpacing
from ..ran.slot_point import SlotPoint
from .interface import (
    PrachBufferContext,
    ResourceGridContext,
    RuErrorNotifier,
    RuMetrics,
    RxSymbolContext,
    RxSymbolNotifier,
)

SYMBOLS_PER_SLOT = 14


def _ring_size(margin: int) -> int:
    # ru_dummy_sector.h:47-57 — at least 8 and a divisor of 10240 so the
    # system-slot modulo never aliases across the SFN wrap.
    n = max(margin, 8)
    while 10240 % n != 0:
        n += 1
    return n


@dataclasses.dataclass
class RuDummyConfig:
    scs: SubcarrierSpacing = SubcarrierSpacing.KHZ30
    nof_sectors: int = 1
    # Slots of DL lead time the upper layer is granted (reference
    # dl_processing_delay): the DL request for slot n+margin is checked at
    # the boundary of slot n.
    dl_data_margin: int = 2
    # Loop DL grids back as UL (the ru_emulator-style closed loop); when
    # False, UL notifications carry zero grids like the reference dummy.
    loopback: bool = False


class _Sector:
    def __init__(self, cfg: RuDummyConfig, symbol_notifier: RxSymbolNotifier,
                 error_notifier: Optional[RuErrorNotifier]):
        self.cfg = cfg
        self.symbol_notifier = symbol_notifier
        self.error_notifier = error_notifier
        n = _ring_size(cfg.dl_data_margin)
        self._dl: List[Optional[tuple]] = [None] * n
        self._ul: List[Optional[tuple]] = [None] * n
        self._prach: List[Optional[tuple]] = [None] * n
        self._last_dl_grid = None
        self.lock = threading.Lock()
        self.metrics = RuMetrics()

    def _slot_index(self, slot: SlotPoint, ring: list) -> int:
        return slot.count % len(ring)

    def handle_dl_data(self, context: ResourceGridContext, grid) -> None:
        with self.lock:
            idx = self._slot_index(context.slot, self._dl)
            late = self._dl[idx]
            self._dl[idx] = (context, grid)
            self.metrics.total_dl_requests += 1
            if late is not None:
                self._report_late("dl", late[0])

    def handle_new_uplink_slot(self, context: ResourceGridContext) -> None:
        with self.lock:
            idx = self._slot_index(context.slot, self._ul)
            late = self._ul[idx]
            self._ul[idx] = (context,)
            self.metrics.total_ul_requests += 1
            if late is not None:
                self._report_late("ul", late[0])

    def handle_prach_occasion(self, context: PrachBufferContext) -> None:
        with self.lock:
            idx = self._slot_index(context.slot, self._prach)
            late = self._prach[idx]
            self._prach[idx] = (context,)
            self.metrics.total_prach_requests += 1
            if late is not None:
                self._report_late("prach", late[0])

    def _report_late(self, plane: str, context) -> None:
        if plane == "dl":
            self.metrics.late_dl_requests += 1
            if self.error_notifier is not None:
                self.error_notifier.on_late_downlink_message(context.slot, context.sector)
        elif plane == "ul":
            self.metrics.late_ul_requests += 1
            if self.error_notifier is not None:
                self.error_notifier.on_late_uplink_message(context.slot, context.sector)
        else:
            self.metrics.late_prach_requests += 1
            if self.error_notifier is not None:
                self.error_notifier.on_late_prach_message(context.slot, context.sector)

    def new_slot_boundary(self, slot: SlotPoint) -> None:
        # ru_dummy_sector.h:154-207 — pop this boundary's entries; a stored
        # context whose slot differs from the boundary slot is late.
        with self.lock:
            dl_slot = slot + self.cfg.dl_data_margin
            idx = self._slot_index(dl_slot, self._dl)
            entry = self._dl[idx]
            self._dl[idx] = None
            if entry is not None:
                if entry[0].slot != dl_slot:
                    self._report_late("dl", entry[0])
                elif self.cfg.loopback:
                    self._last_dl_grid = entry[1]

            idx = self._slot_index(slot, self._ul)
            entry = self._ul[idx]
            self._ul[idx] = None
            notify_ul = None
            if entry is not None:
                if entry[0].slot == slot:
                    notify_ul = entry[0]
                else:
                    self._report_late("ul", entry[0])

            idx = self._slot_index(slot, self._prach)
            entry = self._prach[idx]
            self._prach[idx] = None
            notify_prach = None
            if entry is not None:
                if entry[0].slot == slot:
                    notify_prach = entry[0]
                else:
                    self._report_late("prach", entry[0])
            grid = self._last_dl_grid if self.cfg.loopback else None

        # Notify outside the lock (the notifier may call back into the RU).
        if notify_ul is not None:
            for i_symbol in range(SYMBOLS_PER_SLOT):
                ctx = RxSymbolContext(slot=notify_ul.slot, sector=notify_ul.sector,
                                      symbol_id=i_symbol)
                self.symbol_notifier.on_new_uplink_symbol(ctx, grid, grid is not None)
        if notify_prach is not None:
            self.symbol_notifier.on_new_prach_window_data(notify_prach, None)


class RuDummy:
    """radio_unit implementation: see module docstring."""

    def __init__(self, cfg: RuDummyConfig, symbol_notifier: RxSymbolNotifier,
                 timing_notifier=None, error_notifier: Optional[RuErrorNotifier] = None):
        self.cfg = cfg
        self.timing_notifier = timing_notifier
        self.sectors = [_Sector(cfg, symbol_notifier, error_notifier)
                        for _ in range(cfg.nof_sectors)]
        self._worker: Optional[RealtimeTimingWorker] = None
        self._thread: Optional[threading.Thread] = None
        self._slots_notified = 0

    # -- controller (ru_controller) --------------------------------------
    def start(self) -> None:
        self._worker = RealtimeTimingWorker(scs=self.cfg.scs, on_slot=self._on_slot)
        self._thread = threading.Thread(
            target=self._worker.run, args=(10**9,), daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._worker is not None:
            self._worker.stop()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._worker = None
        self._thread = None

    def set_tx_gain(self, sector: int, gain_db: float) -> bool:
        return False

    def set_rx_gain(self, sector: int, gain_db: float) -> bool:
        return False

    def set_tx_cfo(self, sector: int, cfo_hz: float) -> bool:
        return False

    def set_rx_cfo(self, sector: int, cfo_hz: float) -> bool:
        return False

    # -- timing -----------------------------------------------------------
    def _on_slot(self, slot: SlotPoint) -> None:
        self._slots_notified += 1
        if self.timing_notifier is not None:
            self.timing_notifier.on_tti_boundary(slot)
            self.timing_notifier.on_ul_half_slot_boundary(slot)
            self.timing_notifier.on_ul_full_slot_boundary(slot)
        for sector in self.sectors:
            sector.new_slot_boundary(slot)

    def tick(self, slot: SlotPoint) -> None:
        """Deterministic single slot boundary (tests — replaces wall clock)."""
        self._on_slot(slot)

    # -- planes ------------------------------------------------------------
    def get_controller(self):
        return self

    def get_downlink_plane_handler(self):
        return self

    def get_uplink_plane_handler(self):
        return self

    def handle_dl_data(self, context: ResourceGridContext, grid) -> None:
        self.sectors[context.sector].handle_dl_data(context, grid)

    def handle_new_uplink_slot(self, context: ResourceGridContext) -> None:
        self.sectors[context.sector].handle_new_uplink_slot(context)

    def handle_prach_occasion(self, context: PrachBufferContext) -> None:
        self.sectors[context.sector].handle_prach_occasion(context)

    # -- metrics -----------------------------------------------------------
    def get_metrics(self) -> RuMetrics:
        agg = RuMetrics(slots_notified=self._slots_notified)
        for s in self.sectors:
            m = s.metrics
            agg.total_dl_requests += m.total_dl_requests
            agg.total_ul_requests += m.total_ul_requests
            agg.total_prach_requests += m.total_prach_requests
            agg.late_dl_requests += m.late_dl_requests
            agg.late_ul_requests += m.late_ul_requests
            agg.late_prach_requests += m.late_prach_requests
        if self._worker is not None:
            agg.slots_skipped = self._worker.slots_skipped
        return agg
