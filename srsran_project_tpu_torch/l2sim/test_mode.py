"""MAC test mode: synthetic UE indications at the MAC/FAPI boundary.

Counterpart of the reference's DU test mode
(lib/du/du_high/test_mode/mac_test_mode_adapter.cpp + configs/testmode.yml):
test UEs are created directly in connected state and every UL_TTI request
is answered with synthesized indications — CRC=OK PUSCH with a decoded
payload, and UCI carrying the configured CQI/RI/PMI — so the MAC and
scheduler run at full load with no UE, channel, or PHY attached.

Copy of ``srsran_project_tpu/l2sim/test_mode.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..fapi import messages as fapi
from ..ran import csi as csi_mod


@dataclasses.dataclass(frozen=True)
class TestModeUeConfig:
    """configs/testmode.yml test_ue section (reference field names)."""

    rnti: int = 0x44
    nof_ues: int = 1
    ri: int = 1
    cqi: int = 15
    i11: int = 0  # PMI azimuth beam reported when ri drives a PMI report
    i2: int = 0
    pusch_active: bool = True
    pdsch_active: bool = True
    csi_period_slots: int = 16


class MacTestModeAdapter:
    """Wraps a scheduler: run_slot yields the requests AND the synthetic
    slot results the reference adapter would inject."""

    def __init__(self, cfg: TestModeUeConfig, scheduler,
                 csi_report_cfg: csi_mod.CsiReportConfig | None = None):
        self.cfg = cfg
        self.scheduler = scheduler
        self.csi_cfg = csi_report_cfg
        for i in range(cfg.nof_ues):
            scheduler.add_ue(cfg.rnti + i, mcs=max(1, min(27, cfg.cqi + 8)))
        self.nof_crc = 0
        self.nof_uci = 0
        self.dl_bits = 0
        self.ul_bits = 0

    def _csi_report(self, rnti: int, res: fapi.SlotResults) -> None:
        cfg = self.csi_cfg
        if cfg is None:
            return
        part1 = csi_mod.pack_part1(cfg, cri=0, ri=self.cfg.ri, cqi=self.cfg.cqi)
        res.uci.append(fapi.UciIndicationPdu(rnti, part1, True, 30.0))
        if cfg.has_pmi and cfg.nof_csi_rs_ports > 1 and \
                csi_mod.part2_bitwidth(cfg, self.cfg.ri):
            part2 = csi_mod.pack_part2(cfg, self.cfg.ri, i11=self.cfg.i11,
                                       i2=self.cfg.i2)
            res.uci.append(fapi.UciIndicationPdu(rnti, part2, True, 30.0))
        self.nof_uci += 1

    def run_slot(self, slot, rng: np.random.Generator):
        """(dl, tx, ul, results): the scheduler's requests plus the
        synthetic results, already fed back into the scheduler."""
        dl, tx, ul, grants = self.scheduler.run_slot(slot, rng)
        res = fapi.SlotResults(slot=slot)
        if self.cfg.pusch_active:
            for pdu in ul.pusch:
                res.crc.append(fapi.CrcIndicationPdu(
                    pdu.rnti, pdu.harq_id, True, snr_db=30.0))
                payload = rng.integers(0, 2, size=(pdu.config.tbs,),
                                       dtype=np.uint8)
                res.rx_data.append(fapi.RxDataIndicationPdu(
                    pdu.rnti, pdu.harq_id, payload))
                self.nof_crc += 1
                self.ul_bits += pdu.config.tbs
        if self.cfg.pdsch_active:
            for pdu in dl.pdsch:
                self.dl_bits += pdu.config.tbs
        if slot.count % self.cfg.csi_period_slots == 0:
            for i in range(self.cfg.nof_ues):
                self._csi_report(self.cfg.rnti + i, res)
        self.scheduler.handle_results(res)
        return dl, tx, ul, res

    def report(self) -> dict:
        return {"nof_crc": self.nof_crc, "nof_uci": self.nof_uci,
                "dl_bits": self.dl_bits, "ul_bits": self.ul_bits}
