"""RAN slicing: per-slice PRB quotas over the UE scheduler.

Counterpart of the reference's lib/scheduler/slicing (ran_slice_instance,
slice_scheduler; SURVEY.md Appendix B): each slice owns a PRB quota derived
from its ratio policy (min guaranteed / max cap), idle slices donate their
share to busy ones each slot, and every slice runs its own UE policy
(RR or QoS/PF) inside its quota.  Grants from slice k are placed at the
slice's PRB offset, so slices never collide in frequency.

Copy of ``srsran_project_tpu/l2sim/slicing.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..fapi import messages as fapi
from .scheduler import RoundRobinScheduler, SchedulerConfig


@dataclasses.dataclass(frozen=True)
class SliceConfig:
    slice_id: int
    min_ratio: float = 0.0  # guaranteed share of the band
    max_ratio: float = 1.0  # cap
    policy: str = "rr"
    # S-NSSAI identifying this slice toward O-RAN RRM policies (E2SM-CCC
    # O-RRMPolicyRatio member list keys on {plmn, sst, sd}).
    sst: int = 1
    sd: int = 0


class SliceScheduler:
    """Partitions the band across slices, delegating inside each."""

    def __init__(self, cell_cfg: SchedulerConfig, slices: list[SliceConfig]):
        assert slices and abs(sum(s.min_ratio for s in slices)) <= 1.0 + 1e-9
        self.cell_cfg = cell_cfg
        self.slices = {s.slice_id: s for s in slices}
        self.inner: dict[int, RoundRobinScheduler] = {}
        for s in slices:
            cfg = dataclasses.replace(cell_cfg, policy=s.policy)
            self.inner[s.slice_id] = RoundRobinScheduler(cfg)
        self.last_quotas: dict[int, int] = {}

    def add_ue(self, slice_id: int, rnti: int, **kw):
        return self.inner[slice_id].add_ue(rnti, **kw)

    def _quotas(self) -> dict[int, int]:
        """PRB quota per slice this slot: idle slices keep only their
        guarantee's floor at 0; busy slices split the remainder by
        min_ratio weight (equal weight when all minimums are 0), capped."""
        total = self.cell_cfg.nof_rb
        busy = [sid for sid, sch in self.inner.items() if sch.ues]
        if not busy:
            return {sid: 0 for sid in self.inner}
        quotas = {sid: 0 for sid in self.inner}
        # guaranteed minimums first
        remaining = total
        for sid in busy:
            g = int(self.slices[sid].min_ratio * total)
            quotas[sid] = min(g, remaining)
            remaining -= quotas[sid]
        # spread the rest equally among busy slices, honoring caps
        order = sorted(busy, key=lambda sid: quotas[sid])
        while remaining > 0:
            progressed = False
            for sid in order:
                cap = int(self.slices[sid].max_ratio * total)
                if quotas[sid] < cap and remaining > 0:
                    quotas[sid] += 1
                    remaining -= 1
                    progressed = True
            if not progressed:
                break
        return quotas

    def run_slot(self, slot, rng: np.random.Generator):
        quotas = self._quotas()
        self.last_quotas = dict(quotas)
        pdsch, payloads, pusch, grants = [], [], [], []
        offset = 0
        for sid, sch in self.inner.items():
            q = quotas[sid]
            if q <= 0 or not sch.ues:
                continue
            sch.cfg = dataclasses.replace(sch.cfg, nof_rb=q)
            dl, tx, ul, g = sch.run_slot(slot, rng)
            for pdu, payload in zip(dl.pdsch, tx.payloads):
                pdsch.append(fapi.DlPdschPdu(pdu.config, pdu.rnti, pdu.precoding,
                                             len(payloads),
                                             first_rb=(pdu.first_rb or 0) + offset))
                payloads.append(payload)
            for pdu in ul.pusch:
                pusch.append(fapi.UlPuschPdu(pdu.config, pdu.rnti, pdu.harq_id,
                                             pdu.new_data,
                                             first_rb=(pdu.first_rb or 0) + offset))
            grants.extend((sid,) + t for t in g)
            offset += q
        return (fapi.DlTtiRequest(slot=slot, pdsch=pdsch),
                fapi.TxDataRequest(slot=slot, payloads=payloads),
                fapi.UlTtiRequest(slot=slot, pusch=pusch), grants)

    def apply_rrm_policy(self, policy: dict) -> bool:
        """Apply an O-RRMPolicyRatio structure (E2SM-CCC style 2, percent
        ratios per the reference's rrm_policy_ratio_group) to the slices
        whose S-NSSAI appears in the member list; returns False when no
        slice matches."""
        members = policy.get("members", [])
        targets = [
            sid for sid, s in self.slices.items()
            if any(mb.get("sst") == s.sst and mb.get("sd", 0) == s.sd
                   for mb in members)
        ]
        if not targets:
            return False
        for sid in targets:
            self.slices[sid] = dataclasses.replace(
                self.slices[sid],
                min_ratio=policy.get("min_ratio", 0) / 100.0,
                max_ratio=policy.get("max_ratio", 100) / 100.0)
        return True

    def handle_results(self, res: fapi.SlotResults):
        for sch in self.inner.values():
            sch.handle_results(res)

    def report(self) -> dict:
        return {sid: sch.report() for sid, sch in self.inner.items()}
