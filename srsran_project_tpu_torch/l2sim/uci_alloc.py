"""UCI allocation decisions: HARQ-ACK/SR/CSI onto PUCCH or PUSCH.

Counterpart of the reference's lib/scheduler/uci_scheduling/
(uci_allocator_impl + uci_scheduler_impl): when a UE has a PUSCH in the
UCI slot, pending PUCCH UCI moves onto the PUSCH (beta-offset driven,
via ran/sch_info.get_ulsch_information); otherwise a PUCCH resource is
allocated.  The periodic UCI scheduler raises SR and CSI opportunities
from the cell configuration.  A copy of
``srsran_project_tpu/l2sim/uci_alloc.py``.
"""

from __future__ import annotations

import dataclasses

from .pucch_alloc import PucchSlotAllocator


@dataclasses.dataclass
class UciOnPusch:
    rnti: int
    nof_harq_ack_bits: int = 0
    nof_csi_part1_bits: int = 0
    beta_offset_harq_ack: float = 2.0
    beta_offset_csi_part1: float = 2.0


class UciSlotAllocator:
    """Per-UL-slot UCI decisions over a PucchSlotAllocator and the set of
    RNTIs with PUSCH grants in the slot."""

    def __init__(self, pucch: PucchSlotAllocator, pusch_rntis: set) -> None:
        self.pucch = pucch
        self.pusch_rntis = set(pusch_rntis)
        self.on_pusch: dict[int, UciOnPusch] = {}

    def _pusch_entry(self, rnti: int) -> UciOnPusch:
        if rnti not in self.on_pusch:
            self.on_pusch[rnti] = UciOnPusch(rnti=rnti)
            # Fold any PUCCH UCI already allocated into the PUSCH.
            g = self.pucch.grants.get(rnti)
            if g is not None:
                self.on_pusch[rnti].nof_harq_ack_bits += g.nof_harq_bits
                self.on_pusch[rnti].nof_csi_part1_bits += g.nof_csi_bits
                self.pucch.remove_ue(rnti)
        return self.on_pusch[rnti]

    def alloc_harq_ack(self, rnti: int, pri: int, nof_bits: int = 1) -> bool:
        if rnti in self.pusch_rntis:
            self._pusch_entry(rnti).nof_harq_ack_bits += nof_bits
            return True
        return self.pucch.alloc_harq_ack(rnti, pri, nof_bits) is not None

    def alloc_sr(self, rnti: int) -> bool:
        if rnti in self.pusch_rntis:
            # SR is implicit when the UE already has an UL grant.
            return True
        return self.pucch.alloc_sr(rnti) is not None

    def alloc_csi(self, rnti: int, nof_bits: int) -> bool:
        if rnti in self.pusch_rntis:
            self._pusch_entry(rnti).nof_csi_part1_bits += nof_bits
            return True
        return self.pucch.alloc_csi(rnti, nof_bits) is not None


@dataclasses.dataclass(frozen=True)
class UciPeriodicConfig:
    sr_period_slots: int = 10
    sr_offset: int = 0
    csi_period_slots: int = 20
    csi_offset: int = 4
    csi_nof_bits: int = 4


def periodic_uci_opportunities(slot_count: int, cfg: UciPeriodicConfig):
    """(sr_due, csi_due) for the slot (reference uci_scheduler_impl's
    periodic ring)."""
    sr_due = (slot_count % cfg.sr_period_slots) == cfg.sr_offset
    csi_due = (slot_count % cfg.csi_period_slots) == cfg.csi_offset
    return sr_due, csi_due
