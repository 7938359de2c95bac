"""DU-side F1AP agent (reference lib/f1ap DU + du_manager role).

A copy of ``srsran_project_tpu/l3/du_f1.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

from typing import Callable

from . import messages as m
from .amf_sim import _hex


class DuF1Sim:
    """DU-side F1AP agent (lib/f1ap DU + du_manager role): bridges RRC
    containers to the UE and materializes UE contexts/bearers in the DU."""

    def __init__(self, send_to_cucp, gnb_du_id: int = 1):
        self.to_cucp = send_to_cucp
        self.gnb_du_id = gnb_du_id
        self.rrc_to_ue: dict[int, Callable[[int, bytes], None]] = {}  # du_ue_id -> cb(srb, container)
        self.on_ue_context_setup = None  # cb(UeContextSetupRequest) -> drbs_setup list
        self.on_ue_release = None
        self.f1_ready = False
        self.next_du_ue_id = 1

    def setup(self, cells: list) -> None:
        self.to_cucp(m.encode(m.F1SetupRequest(gnb_du_id=self.gnb_du_id, cells=cells)))

    def allocate_ue(self, deliver_dl: Callable[[int, bytes], None]) -> int:
        """Create the DU UE context (du_manager ue_creation role)."""
        du_ue_id = self.next_du_ue_id
        self.next_du_ue_id += 1
        self.rrc_to_ue[du_ue_id] = deliver_dl
        return du_ue_id

    def initial_ul_rrc(self, du_ue_id: int, c_rnti: int, rrc_container: bytes) -> None:
        self.to_cucp(m.encode(m.InitialUlRrcMessageTransfer(
            gnb_du_ue_id=du_ue_id, c_rnti=c_rnti, rrc_container=_hex(rrc_container))))

    def ul_rrc(self, du_ue_id: int, srb_id: int, container: bytes) -> None:
        self.to_cucp(m.encode(m.UlRrcMessageTransfer(
            gnb_du_ue_id=du_ue_id, gnb_cu_ue_id=0, srb_id=srb_id,
            rrc_container=_hex(container))))

    def rx(self, data: bytes) -> None:
        msg = m.decode(data)
        if isinstance(msg, m.F1SetupResponse):
            self.f1_ready = True
        elif isinstance(msg, m.DlRrcMessageTransfer):
            self.rrc_to_ue[msg.gnb_du_ue_id](msg.srb_id, bytes.fromhex(msg.rrc_container))
        elif isinstance(msg, m.UeContextSetupRequest):
            drbs_setup = self.on_ue_context_setup(msg) if self.on_ue_context_setup else \
                [{"drb_id": d["drb_id"], "f1u_dl_teid": 0x3000 + msg.gnb_du_ue_id}
                 for d in msg.drbs_to_setup]
            self.to_cucp(m.encode(m.UeContextSetupResponse(
                gnb_du_ue_id=msg.gnb_du_ue_id, drbs_setup=drbs_setup)))
        elif isinstance(msg, m.UeContextReleaseCommand):
            if self.on_ue_release:
                self.on_ue_release(msg.gnb_du_ue_id)
            self.rrc_to_ue.pop(msg.gnb_du_ue_id, None)
            self.to_cucp(m.encode(m.UeContextReleaseComplete(gnb_du_ue_id=msg.gnb_du_ue_id)))

