"""SI-message windows, paging PF/PO math, and the CSI-RS scheduler.

Counterparts of the reference's common_scheduling engines at the exact
TS-spec math they implement:

- ``SiMessageScheduler`` — TS 38.331 §5.2.2.3.2 SI windows
  (si_message_scheduler.cpp:100-141): message n's window starts at slot
  a = x mod N of the radio frame with SFN mod T = floor(x/N), where
  x = (n-1)·w (or (si-WindowPosition-1)·w) and w = si-WindowLength.
- ``PagingOccasionScheduler`` — TS 38.304 §7.1 paging frames/occasions
  (paging_scheduler.cpp:154-161): PF satisfies
  (SFN + PF_offset) mod T = (T div N)·(UE_ID mod N); the PO index is
  i_s = floor(UE_ID / N) mod Ns.
- ``CsiRsScheduler`` — periodic NZP-CSI-RS resources due when
  (slot - offset) mod period == 0 (csi_rs_scheduler.cpp:97-106).

Copy of ``srsran_project_tpu/l2sim/si_paging.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..ran.slot_point import SlotPoint


@dataclasses.dataclass(frozen=True)
class SiMessageConfig:
    period_radio_frames: int  # si-Periodicity T
    payload: bytes
    si_window_position: Optional[int] = None  # 1-based; None = by list order


@dataclasses.dataclass(frozen=True)
class SiSchedulerConfig:
    si_window_len_slots: int = 5
    messages: tuple = ()  # tuple[SiMessageConfig, ...]


class SiMessageScheduler:
    """Other-SI scheduling (SIB2+...): one transmission per SI window."""

    def __init__(self, cfg: SiSchedulerConfig):
        self.cfg = cfg
        self._window_end: List[int] = [-1] * len(cfg.messages)
        self._sent_in_window: List[bool] = [False] * len(cfg.messages)
        self.nof_windows = [0] * len(cfg.messages)

    def run_slot(self, slot: SlotPoint) -> Optional[tuple[int, bytes]]:
        """(message index, payload) when an SI message transmits this slot."""
        n_slots_frame = slot.slots_per_frame
        out = None
        for i, msg in enumerate(self.cfg.messages):
            n = i + 1
            x = (n - 1) * self.cfg.si_window_len_slots
            if msg.si_window_position is not None:
                x = (msg.si_window_position - 1) * self.cfg.si_window_len_slots
            a = x % n_slots_frame
            if (slot.slot_in_frame == a
                    and slot.sfn % msg.period_radio_frames == x // n_slots_frame):
                # SI window start.
                self._window_end[i] = slot.count + self.cfg.si_window_len_slots
                self._sent_in_window[i] = False
                self.nof_windows[i] += 1
            if (slot.count < self._window_end[i] and not self._sent_in_window[i]
                    and out is None):
                self._sent_in_window[i] = True
                out = (i, msg.payload)
        return out


@dataclasses.dataclass(frozen=True)
class PagingConfig:
    drx_cycle_frames: int = 128      # T (defaultPagingCycle rf128)
    nof_pf_per_drx: int = 64         # N (T div 2 ... T); PF density
    paging_frame_offset: int = 0
    nof_po_per_pf: int = 1           # Ns


class PagingOccasionScheduler:
    """Queues paging records per UE_ID and drains them at that UE's PO."""

    def __init__(self, cfg: PagingConfig, max_records_per_po: int = 8):
        self.cfg = cfg
        self.max_records = max_records_per_po
        self._queue: Dict[int, List[dict]] = {}

    def page(self, ue_identity_index: int, record: dict) -> None:
        """ue_identity_index = 5G-S-TMSI mod 1024 (TS 38.304)."""
        self._queue.setdefault(ue_identity_index % 1024, []).append(record)

    def is_po(self, slot: SlotPoint, ue_id: int) -> bool:
        c = self.cfg
        t = c.drx_cycle_frames
        n = c.nof_pf_per_drx
        if (slot.sfn + c.paging_frame_offset) % t != (t // n) * (ue_id % n):
            return False
        i_s = (ue_id // n) % c.nof_po_per_pf
        po_slot = i_s * (slot.slots_per_frame // c.nof_po_per_pf)
        return slot.slot_in_frame == po_slot

    def run_slot(self, slot: SlotPoint) -> List[dict]:
        """Drain up to max_records records whose UE's PO is this slot;
        overflow stays queued for the next PO (maxNrofPageRec)."""
        due: List[dict] = []
        for ue_id in list(self._queue):
            if len(due) >= self.max_records:
                break
            if not self.is_po(slot, ue_id):
                continue
            recs = self._queue[ue_id]
            take = min(len(recs), self.max_records - len(due))
            for r in recs[:take]:
                r = dict(r)
                r.setdefault("ue_paging_id", ue_id)
                due.append(r)
            if take == len(recs):
                del self._queue[ue_id]
            else:
                self._queue[ue_id] = recs[take:]
        return due


@dataclasses.dataclass(frozen=True)
class CsiRsResourceConfig:
    row: int = 1
    rb_start: int = 0
    rb_count: int = 52
    symbol: int = 12
    period_slots: int = 40
    offset_slots: int = 0
    scrambling_id: int = 0


class CsiRsScheduler:
    """Periodic NZP-CSI-RS resources (csi_rs_scheduler.cpp role)."""

    def __init__(self, resources: list[CsiRsResourceConfig]):
        self.resources = list(resources)

    def run_slot(self, slot: SlotPoint) -> List[CsiRsResourceConfig]:
        return [r for r in self.resources
                if (slot.count - r.offset_slots) % r.period_slots == 0]
