"""Slot pipeline runtime: deadline-accounted, depth-limited async dispatch.

Replaces the reference's executor fabric + slot FSMs
(downlink_processor_multi_executor_impl, lower_phy_baseband_processor,
max_processing_delay_slots = du_low_config.h:39): CUDA launches are
already asynchronous, so the pipeline is a ring of in-flight slots bounded
by `depth`; results are collected against per-slot deadlines and late
slots surface as error indications (the reference's upper_phy_error_handler
/ FAPI ERROR.indication path).

Port of ``srsran_project_tpu/phy/slot_pipeline.py``.  A DL slot's grid is
a device tensor whose kernels may still run: a CUDA event is recorded on
the current stream when the slot is dispatched and synchronized when it
is materialized (a grid on the CPU is complete at dispatch).  Deadlines
are accounted on ``time.monotonic``; UL results are host values, so a UL
slot is stamped complete at dispatch.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import torch

from ..fapi import messages as fapi
from ..support.metrics import collector
from ..support.tracing import l1_tracer
from .upper_phy import UpperPhy


@dataclasses.dataclass
class SlotDeadlineStats:
    processed: int = 0
    late: int = 0
    total_lateness_s: float = 0.0


class SlotPipeline:
    def __init__(
        self,
        upper_phy: UpperPhy,
        slot_duration_s: float = 500e-6,
        depth: int = 4,
    ):
        self.phy = upper_phy
        self.slot_duration_s = slot_duration_s
        self.depth = depth
        self._inflight: deque = deque()
        self._completed: list = []
        self.stats = SlotDeadlineStats()
        self.errors: list[fapi.ErrorIndication] = []

    # -- downlink ------------------------------------------------------
    def push_dl_slot(self, request: fapi.DlTtiRequest, tx_data: fapi.TxDataRequest, deadline_s: float):
        """Dispatch a DL slot asynchronously; returns nothing (collect later)."""
        self._drain_to(self.depth - 1)
        with l1_tracer.span(f"dl_slot_{request.slot.count}"):
            t0 = time.monotonic()
            grid = self.phy.process_dl_tti(request, tx_data)
            collector.record("dl_slot_dispatch", time.monotonic() - t0)
        # DL payload is a device future: completion time is known only at
        # materialization (ready_hint None -> wait on the event + stamp there).
        done = None
        if grid.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(grid.device))
        self._inflight.append(("dl", request.slot, (grid, done), deadline_s, None))

    # -- uplink --------------------------------------------------------
    def push_ul_slot(self, request: fapi.UlTtiRequest, rx_grid, deadline_s: float, prach_fd=None):
        self._drain_to(self.depth - 1)
        with l1_tracer.span(f"ul_slot_{request.slot.count}"):
            t0 = time.monotonic()
            res = self.phy.process_ul_tti(request, rx_grid, prach_fd=prach_fd)
            collector.record("ul_slot_dispatch", time.monotonic() - t0)
        # UL results are host-materialized inside process_ul_tti (CRC/UCI
        # readouts), so the slot COMPLETED now — stamp the ready time so a
        # lazy drain doesn't bill queue-residence time as lateness.
        self._inflight.append(("ul", request.slot, res, deadline_s,
                               time.monotonic()))

    # -- collection ----------------------------------------------------
    def _materialize(self, kind, slot, payload, deadline_s, ready_hint=None):
        if kind == "dl":
            payload, done = payload
            if done is not None:
                done.synchronize()
        now = ready_hint if ready_hint is not None else time.monotonic()
        self.stats.processed += 1
        if now > deadline_s:
            self.stats.late += 1
            self.stats.total_lateness_s += now - deadline_s
            self.errors.append(
                fapi.ErrorIndication(slot, f"slot late by {(now - deadline_s) * 1e6:.0f} us")
            )
        return payload

    def _drain_to(self, n: int):
        while len(self._inflight) > n:
            self._completed.append(self._materialize(*self._inflight.popleft()))

    def flush(self):
        """Materialize everything in flight; returns all collected payloads
        (in dispatch order) since the last flush."""
        self._drain_to(0)
        out, self._completed = self._completed, []
        return out

    def report(self) -> dict:
        s = self.stats
        return {
            "slots": s.processed,
            "late": s.late,
            "late_ratio": (s.late / s.processed) if s.processed else 0.0,
            "mean_lateness_us": (s.total_lateness_s / s.late * 1e6) if s.late else 0.0,
        }
