"""Link adaptation: CQI -> MCS mapping + outer-loop (OLLA) correction.

Counterpart of the reference's scheduler grant-parameter selection
(lib/scheduler ue_context CSI handling + policy MCS selection and the
link-adaptation controller; SURVEY.md Appendix B scheduler sub-inventory):

- CQI->MCS: match the CQI's spectral efficiency (TS 38.214 Table 5.2.2.1-2
  / -3 efficiencies) to the largest MCS whose efficiency does not exceed
  it (per MCS table).
- OLLA: a BLER-target outer loop nudges an offset (in CQI-equivalent dB)
  up on ACK by step*target/(1-target) and down on NACK by step, so the
  long-run NACK rate converges to the target (classic outer-loop LA).

A copy of ``srsran_project_tpu/l2sim/link_adaptation.py``.
"""

from __future__ import annotations

import dataclasses

from ..ran.tbs import MCS_TABLE_64QAM, MCS_TABLE_256QAM

# CQI table 2 (TS 38.214 5.2.2.1-2, 4-bit CQI -> (Qm, rate x1024)); entry 0
# is "out of range".
CQI_TABLE = (
    None, (2, 78), (2, 193), (2, 449), (4, 378), (4, 490), (4, 616),
    (6, 466), (6, 567), (6, 666), (6, 772), (6, 873), (8, 711), (8, 797),
    (8, 885), (8, 948),
)


def _eff(qm: int, rate1024: int) -> float:
    return qm * rate1024 / 1024.0


def cqi_to_mcs(cqi: int, table: str = "qam64") -> int:
    """Largest MCS whose spectral efficiency <= the CQI's efficiency."""
    cqi = max(0, min(15, cqi))
    if cqi == 0:
        return 0
    qm, r = CQI_TABLE[cqi]
    target = _eff(qm, r)
    tab = MCS_TABLE_64QAM if table == "qam64" else MCS_TABLE_256QAM
    best = 0
    for mcs, (mqm, mrate) in enumerate(tab):
        if _eff(mqm, mrate) <= target + 1e-9:
            best = mcs
    return best


def ul_mcs_from_snr(snr_db: float, table: str = "qam64",
                    margin_db: float = 2.0) -> int:
    """SRS/PUSCH-SNR-driven UL MCS: the largest MCS whose spectral
    efficiency fits the Shannon capacity at (snr - margin) dB — the
    SRS-based UL link-adaptation role of the reference's
    ue_channel_state_manager wideband SINR feeding grant MCS selection."""
    import math

    cap = math.log2(1.0 + 10.0 ** ((snr_db - margin_db) / 10.0))
    tab = MCS_TABLE_64QAM if table == "qam64" else MCS_TABLE_256QAM
    best = 0
    for mcs, (mqm, mrate) in enumerate(tab):
        if _eff(mqm, mrate) <= cap + 1e-9:
            best = mcs
    return best


@dataclasses.dataclass
class OllaState:
    offset_db: float = 0.0


class LinkAdaptor:
    """Per-UE CQI + OLLA -> MCS (the grant param selector role)."""

    # ~1 dB of SNR per CQI step; OLLA offset converts to CQI units with this
    DB_PER_CQI = 1.0

    def __init__(self, table: str = "qam64", target_bler: float = 0.1,
                 step_db: float = 0.5, max_offset_db: float = 6.0):
        self.table = table
        self.target = target_bler
        self.step = step_db
        self.max_offset = max_offset_db
        self.last_cqi: dict[int, int] = {}
        self.olla: dict[int, OllaState] = {}

    def handle_csi(self, rnti: int, cqi: int) -> None:
        self.last_cqi[rnti] = cqi

    def handle_crc(self, rnti: int, ok: bool) -> None:
        st = self.olla.setdefault(rnti, OllaState())
        if ok:
            st.offset_db += self.step * self.target / (1.0 - self.target)
        else:
            st.offset_db -= self.step
        st.offset_db = max(-self.max_offset, min(self.max_offset, st.offset_db))

    def select_mcs(self, rnti: int, fallback: int = 4) -> int:
        cqi = self.last_cqi.get(rnti)
        if cqi is None:
            return fallback
        adj = self.olla.get(rnti, OllaState()).offset_db / self.DB_PER_CQI
        eff_cqi = int(round(cqi + adj))
        return cqi_to_mcs(max(1, min(15, eff_cqi)), self.table)
