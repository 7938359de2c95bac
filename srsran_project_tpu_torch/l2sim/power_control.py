"""Closed-loop PUSCH/PUCCH uplink power control.

Counterpart of the reference's pusch_power_controller / pucch_power_controller
(lib/scheduler/support/pusch_power_controller.cpp).  The open-source
reference stubs the actual TPC computation ("only available in the
Enterprise version", returning the 0 dB command); here the real closed
loop is implemented, as in ``srsran_project_tpu/l2sim/power_control.py``
(of which this module is a copy):

- the measured PUSCH SINR (from CRC indications) is driven toward a
  target via TS 38.213 Table 7.1.1-1 TPC commands {-1, 0, +1, +3} dB,
- a prohibit window (reference tpc_adjust_prohibit_time_ms = 40 ms)
  prevents oscillation while earlier commands are still taking effect,
- power headroom reports cap the accumulated closed-loop adjustment and
  optionally shrink the PRB allocation when the UE is power limited
  (reference adapt_pusch_prbs_to_phr role).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# TS 38.213 Table 7.1.1-1 (accumulated closed-loop corrections).
TPC_STEPS_DB = (-1.0, 0.0, 1.0, 3.0)


@dataclasses.dataclass
class PowerControlConfig:
    target_sinr_db: float = 20.0
    # Hysteresis around the target inside which TPC stays at 0 dB.
    hysteresis_db: float = 1.0
    # TPC adjustments forbidden for this window after the last non-zero
    # command (reference tpc_adjust_prohibit_time_ms at the slot rate).
    prohibit_slots: int = 80
    # Cap on the accumulated closed-loop term f(i) in dB.
    f_max_db: float = 20.0
    f_min_db: float = -20.0
    # Shrink PRBs when the reported headroom is below this.
    phr_bw_adaptation: bool = True


@dataclasses.dataclass
class _UeState:
    f_db: float = 0.0  # accumulated closed-loop adjustment
    last_sinr_db: Optional[float] = None
    last_tpc_slot: int = -(10**9)
    phr_db: Optional[float] = None


class PuschPowerController:
    def __init__(self, cfg: PowerControlConfig | None = None):
        self.cfg = cfg if cfg is not None else PowerControlConfig()
        self.ues: Dict[int, _UeState] = {}

    def _ue(self, rnti: int) -> _UeState:
        return self.ues.setdefault(rnti, _UeState())

    # -- measurement inputs -------------------------------------------------
    def handle_pusch_snr(self, rnti: int, slot: int, snr_db: float) -> None:
        self._ue(rnti).last_sinr_db = float(snr_db)

    def handle_phr(self, rnti: int, ph_db: float) -> None:
        """MAC Single-Entry PHR CE (mac_pdu.ce_single_phr payload)."""
        self._ue(rnti).phr_db = float(ph_db)

    # -- scheduler queries --------------------------------------------------
    def compute_tpc(self, rnti: int, slot: int) -> int:
        """TPC command index (0..3) for this grant's DCI."""
        ue = self._ue(rnti)
        if ue.last_sinr_db is None:
            return 1  # 0 dB until the first measurement
        if slot - ue.last_tpc_slot < self.cfg.prohibit_slots:
            return 1
        err = self.cfg.target_sinr_db - ue.last_sinr_db
        if abs(err) <= self.cfg.hysteresis_db:
            return 1
        if err > 0:
            # UE below target: up-command unless power limited or capped.
            if ue.phr_db is not None and ue.phr_db <= 0:
                return 1
            if ue.f_db >= self.cfg.f_max_db:
                return 1
            step = 3 if err > 3.0 else 2
        else:
            if ue.f_db <= self.cfg.f_min_db:
                return 1
            step = 0
        ue.f_db += TPC_STEPS_DB[step]
        ue.last_tpc_slot = slot
        return step

    def adapt_prbs_to_phr(self, rnti: int, nof_prbs: int) -> int:
        """Shrink the grant when the UE reports negative headroom: halving
        the PRBs buys ~3 dB of per-PRB power (reference
        adapt_pusch_prbs_to_phr role)."""
        ue = self.ues.get(rnti)
        if (not self.cfg.phr_bw_adaptation or ue is None or ue.phr_db is None
                or ue.phr_db >= 0):
            return nof_prbs
        # Each halving recovers 3 dB; never below 1 PRB.
        deficit = -ue.phr_db
        while deficit > 0 and nof_prbs > 1:
            nof_prbs = max(1, nof_prbs // 2)
            deficit -= 3.0
        return nof_prbs

    def closed_loop_db(self, rnti: int) -> float:
        ue = self.ues.get(rnti)
        return ue.f_db if ue is not None else 0.0


class PucchPowerController(PuschPowerController):
    """PUCCH closed loop: same machinery against the PUCCH SINR/detection
    metrics (the reference pucch_power_controller is likewise an
    enterprise stub).  Feed `handle_pusch_snr` with the F0/F1 detection
    metric in dB or the F2+ post-equalization SINR; the TPC rides DCI
    1_0/1_1's 2-bit PUCCH TPC field."""

    def __init__(self, cfg: PowerControlConfig | None = None):
        super().__init__(cfg if cfg is not None
                         else PowerControlConfig(target_sinr_db=10.0))
