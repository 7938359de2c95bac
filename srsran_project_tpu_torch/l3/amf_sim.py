"""AMF simulator: NGAP peer of the CU-CP (reference lib/ngap test AMF
role): answers InitialUeMessage with InitialContextSetupRequest (K_gNB)
and drives PDU session resource setup.

A copy of ``srsran_project_tpu/l3/amf_sim.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

from typing import Callable

from ..l2 import security
from . import messages as m


def _hex(b: bytes) -> str:
    return b.hex()


class AmfSim:
    """Minimal core: NG setup, auth-free attach, one PDU session per UE."""

    def __init__(self, send_to_cucp: Callable[[bytes], None] | None = None):
        self.send = send_to_cucp or (lambda b: None)
        self.next_amf_ue_id = 100
        self.ues: dict[int, dict] = {}
        self.k_amf = bytes(range(32))  # fixed test key material
        self.sessions_done: list[int] = []

    def rx(self, data: bytes) -> None:
        msg = m.decode(data)
        if isinstance(msg, m.NgSetupRequest):
            self.send(m.encode(m.NgSetupResponse(amf_name="amf-sim")))
        elif isinstance(msg, m.InitialUeMessage):
            amf_id = self.next_amf_ue_id
            self.next_amf_ue_id += 1
            self.ues[msg.ran_ue_id] = {"amf_ue_id": amf_id}
            k_gnb = security.kdf(self.k_amf, 0x6E, msg.ran_ue_id.to_bytes(4, "big"))
            self.send(m.encode(m.InitialContextSetupRequest(
                ran_ue_id=msg.ran_ue_id, amf_ue_id=amf_id, security_key=_hex(k_gnb),
                allowed_nea=[2, 1, 3], allowed_nia=[2, 1, 3])))
        elif isinstance(msg, m.InitialContextSetupResponse):
            self.send(m.encode(m.PduSessionResourceSetupRequest(
                ran_ue_id=msg.ran_ue_id, amf_ue_id=msg.amf_ue_id,
                sessions=[{"session_id": 1, "qfi": 9,
                           "ngu_ul_teid": 0x2000 + msg.ran_ue_id, "upf_addr": "upf"}])))
        elif isinstance(msg, m.PduSessionResourceSetupResponse):
            self.sessions_done.append(msg.ran_ue_id)

