"""CU-UP-side E1AP agent (reference lib/e1ap CU-UP role).

A copy of ``srsran_project_tpu/l3/cu_up_e1.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

from ..l2 import security
from . import messages as m


class CuUpE1Agent:
    """CU-UP-side E1AP agent around cu_up_sim.CuUpSim bearer plumbing."""

    def __init__(self, send_to_cucp, make_cu_up):
        """make_cu_up(ue_id, keys, nea, nia) -> object with setup_bearer()."""
        self.to_cucp = send_to_cucp
        self.make_cu_up = make_cu_up
        self.next_ue_id = 1
        self.cu_ups: dict[int, object] = {}
        self.next_f1u_teid = 0x4000

    def rx(self, data: bytes) -> None:
        msg = m.decode(data)
        if isinstance(msg, m.E1SetupRequest):
            self.to_cucp(m.encode(m.E1SetupResponse(gnb_cu_cp_name="cucp-sim")))
        elif isinstance(msg, m.BearerContextSetupRequest):
            ue_id = self.next_ue_id
            self.next_ue_id += 1
            k_gnb = bytes.fromhex(msg.security_key)
            k_enc = security.derive_algo_key(k_gnb, security.ALGO_TYPE_NUP_ENC, msg.nea)
            k_int = security.derive_algo_key(k_gnb, security.ALGO_TYPE_NUP_INT, msg.nia)
            cu_up = self.make_cu_up(ue_id, (k_enc, k_int), msg.nea, msg.nia)
            self.cu_ups[ue_id] = cu_up
            drbs = []
            for s in msg.sessions:
                f1u_ul = self.next_f1u_teid
                self.next_f1u_teid += 1
                cu_up.pending_setup = (s, f1u_ul)  # finished when DL TEID arrives
                drbs.append({"drb_id": s["drb_id"], "f1u_ul_teid": f1u_ul,
                             "ngu_dl_teid": 0x100 + ue_id})
            self.to_cucp(m.encode(m.BearerContextSetupResponse(
                gnb_cu_cp_ue_id=msg.gnb_cu_cp_ue_id, gnb_cu_up_ue_id=ue_id, drbs=drbs)))
        elif isinstance(msg, m.BearerContextModificationRequest):
            cu_up = self.cu_ups[msg.gnb_cu_up_ue_id]
            if getattr(cu_up, "on_f1u_dl_teids", None):
                cu_up.on_f1u_dl_teids(msg.drb_f1u_dl_teids)
            self.to_cucp(m.encode(m.BearerContextModificationResponse(
                gnb_cu_up_ue_id=msg.gnb_cu_up_ue_id)))


