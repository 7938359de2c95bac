"""RRC UE context + SRB PDCP key derivation (reference lib/rrc role):
per-UE security state and the TS 33.501 A.8 K_RRCenc/K_RRCint derivation
feeding real PDCP SRB entities.

A copy of ``srsran_project_tpu/l3/rrc.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses

from ..l2 import pdcp, security


@dataclasses.dataclass
class CuUeCtx:
    cu_ue_id: int
    du_ue_id: int
    c_rnti: int
    state: str = "idle"
    amf_ue_id: int | None = None
    k_gnb: bytes | None = None
    nea: int = 2
    nia: int = 2
    srb1_pdcp: pdcp.PdcpEntity | None = None
    cu_up_ue_id: int | None = None
    pending_sessions: list = dataclasses.field(default_factory=list)
    drbs: list = dataclasses.field(default_factory=list)
    du_id: int = 0
    ho_target: tuple[int, int] | None = None  # (target du_id, target du_ue_id)
    ho_pci: int = 0


def make_srb_pdcp(k_gnb: bytes, nea: int, nia: int, is_cu_side: bool,
                  on_rx_sdu=None) -> pdcp.PdcpEntity:
    """SRB1 PDCP with K_RRCenc/K_RRCint derived per TS 33.501 A.8."""
    k_enc = security.derive_algo_key(k_gnb, security.ALGO_TYPE_NRRC_ENC, nea)
    k_int = security.derive_algo_key(k_gnb, security.ALGO_TYPE_NRRC_INT, nia)
    eng = security.SecurityEngine(nea, nia, k_enc, k_int, bearer=1)  # SRB1
    return pdcp.PdcpEntity(pdcp.PdcpConfig(sn_bits=12, is_srb=True), eng,
                           is_downlink_tx=is_cu_side, on_rx_sdu=on_rx_sdu)


# Back-compat alias (pre-split name).
_CuUeCtx = CuUeCtx
