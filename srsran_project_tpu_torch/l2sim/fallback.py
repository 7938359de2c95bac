"""Fallback scheduler: SRB0/SRB1 grants for UEs not yet reconfigured.

Counterpart of the reference's ue_fallback_scheduler
(lib/scheduler/ue_scheduling/ue_fallback_scheduler.{h,cpp}): after Msg3,
a UE is in *fallback* — it only monitors the common search space with
TC-RNTI/C-RNTI DCI 1_0, so RRC Setup (SRB0, with the Contention
Resolution CE) and the SRB1 traffic that follows must be scheduled
through common PDCCH candidates and simple type-1 PRB allocations, with
their own HARQ retransmission loop, until the UE leaves fallback
(reconfiguration complete).  The reference runs this stage after RA and
before the main UE scheduler each slot (cell_scheduler.cpp run_slot
order); FallbackScheduler.run_slot follows the same contract.

Copy of ``srsran_project_tpu/l2sim/fallback.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from . import pdcch_alloc
from ..l2 import mac_pdu


@dataclasses.dataclass
class FallbackGrant:
    rnti: int
    is_srb0: bool
    rb_start: int
    rb_count: int
    cce_index: int
    aggregation_level: int
    payload: bytes
    harq_id: int
    is_retx: bool = False


@dataclasses.dataclass
class _PendingDl:
    is_srb0: bool
    payload: bytes
    with_conres: bool = False
    harq_id: Optional[int] = None
    retx_left: int = 3
    awaiting_ack: bool = False


class _FallbackUe:
    def __init__(self, rnti: int, conres_id: bytes | None):
        self.rnti = rnti
        self.conres_id = conres_id
        self.conres_sent = False
        self.queue: List[_PendingDl] = []
        self.in_fallback = True


class FallbackScheduler:
    """Schedules DL SRB0/SRB1 for fallback UEs via common candidates."""

    def __init__(self, coresets: dict, search_spaces: dict,
                 common_ss_id: int = 0, nof_rb: int = 52,
                 srb_rb_count: int = 6, nof_harq: int = 4):
        self.coresets = coresets
        self.search_spaces = search_spaces
        self.common_ss_id = common_ss_id
        self.nof_rb = nof_rb
        self.srb_rb_count = srb_rb_count
        self.nof_harq = nof_harq
        self.ues: Dict[int, _FallbackUe] = {}
        self._free_harqs: Dict[int, List[int]] = {}

    # -- upper-layer hooks (ue_fallback_scheduler.h:52-60) -----------------
    def add_ue(self, rnti: int, conres_id: bytes | None = None) -> None:
        self.ues[rnti] = _FallbackUe(rnti, conres_id)
        self._free_harqs[rnti] = list(range(self.nof_harq))

    def handle_dl_buffer_state(self, rnti: int, payload: bytes,
                               is_srb0: bool = False) -> None:
        """SRB0 (RRC Setup) or SRB1 PDU awaiting a fallback grant."""
        ue = self.ues.get(rnti)
        if ue is None or not ue.in_fallback:
            return
        ue.queue.append(_PendingDl(is_srb0=is_srb0, payload=payload,
                                   with_conres=is_srb0 and not ue.conres_sent))
        if is_srb0:
            ue.conres_sent = True

    def handle_ack(self, rnti: int, harq_id: int, ack: bool) -> None:
        ue = self.ues.get(rnti)
        if ue is None:
            return
        for p in list(ue.queue):
            if p.harq_id == harq_id and p.awaiting_ack:
                if ack:
                    ue.queue.remove(p)
                    self._free_harqs[rnti].append(harq_id)
                else:
                    p.awaiting_ack = False  # schedule a retx
                    p.retx_left -= 1
                    if p.retx_left <= 0:
                        ue.queue.remove(p)
                        self._free_harqs[rnti].append(harq_id)
                return

    def exit_fallback(self, rnti: int) -> None:
        """RRC Reconfiguration complete: the main UE scheduler takes over."""
        ue = self.ues.get(rnti)
        if ue is not None:
            ue.in_fallback = False

    # -- per-slot scheduling ------------------------------------------------
    def run_slot(self, slot: int,
                 pdcch: Optional[pdcch_alloc.PdcchSlotAllocator] = None,
                 rb_start: int = 0) -> List[FallbackGrant]:
        """Allocate this slot's fallback grants.  Pass the slot's shared
        PdcchSlotAllocator so the main scheduler sees the CCEs this stage
        consumed (the reference shares cell_resource_allocator the same
        way); a fresh one is created when standalone.  ``rb_start`` is the
        first PRB this stage may use — the cell scheduler passes the end of
        the UE-data grants' span so fallback never overlaps them (shared
        per-slot resource map, cell_resource_allocator role)."""
        if pdcch is None:
            pdcch = pdcch_alloc.PdcchSlotAllocator(self.coresets, self.search_spaces)
        self.pdcch = pdcch
        grants: List[FallbackGrant] = []
        rb_cursor = rb_start
        for rnti, ue in self.ues.items():
            if not ue.in_fallback:
                continue
            for p in ue.queue:
                if p.awaiting_ack and p.harq_id is not None:
                    continue  # HARQ in flight
                if rb_cursor + self.srb_rb_count > self.nof_rb:
                    return grants  # out of PRBs this slot
                # Common-search-space PDCCH candidate; SRB traffic uses a
                # robust aggregation level first (reference uses the expert
                # config's fallback AL; try 4 then 8).
                g = None
                for al in (4, 8):
                    g = self.pdcch.alloc_dci(rnti, self.common_ss_id, al,
                                             slot_index=slot)
                    if g is not None:
                        break
                if g is None:
                    continue  # CCE congestion; try next slot
                if p.harq_id is None:
                    if not self._free_harqs[rnti]:
                        continue
                    p.harq_id = self._free_harqs[rnti].pop(0)
                    is_retx = False
                else:
                    is_retx = True
                payload = p.payload
                if p.with_conres and ue.conres_id is not None:
                    # SRB0 carries the UE Contention Resolution Identity CE
                    # ahead of the CCCH SDU (TS 38.321; reference conres
                    # handling in the fallback scheduler).
                    ce = mac_pdu.ce_con_res_id(ue.conres_id)
                    payload = bytes(ce) + payload
                p.awaiting_ack = True
                grants.append(FallbackGrant(
                    rnti=rnti, is_srb0=p.is_srb0, rb_start=rb_cursor,
                    rb_count=self.srb_rb_count, cce_index=g.cce_index,
                    aggregation_level=g.aggregation_level, payload=payload,
                    harq_id=p.harq_id, is_retx=is_retx))
                rb_cursor += self.srb_rb_count
        return grants

    def pending(self, rnti: int) -> int:
        ue = self.ues.get(rnti)
        return len(ue.queue) if ue else 0
