"""CU-UP simulator: GTP-U <-> SDAP <-> PDCP <-> F1-U bearer contexts.

Counterpart of the reference's lib/cu_up (cu_up_impl, bearer contexts wired
from E1AP; SURVEY.md section 2.4 "CU-UP"): the NG-U side terminates GTP-U
tunnels from the core, SDAP maps QoS flows onto DRBs, PDCP
ciphers/integrity-protects, and the F1-U side ships PDCP PDUs DU-ward as
NR-U DL USER DATA frames (and receives UL PDCP PDUs back).  The F1-U
"link" is a pair of callables, mirroring the reference's in-process
connectors between CU-UP and DU (SURVEY.md section 3.1).

A copy of ``srsran_project_tpu/l2/cu_up_sim.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import gtpu, nru, pdcp, sdap, security


@dataclasses.dataclass
class DrbContext:
    drb_id: int
    pdcp_entity: pdcp.PdcpEntity
    nru_sn: int = 0
    f1u_tx: Callable[[bytes], None] | None = None  # NR-U frame toward the DU


class CuUpSim:
    """One UE's bearer contexts (per the reference's ue_context in CU-UP)."""

    def __init__(self, ue_id: int, ngu_tx: Callable[[bytes], None],
                 sec_cfg: tuple[int, int] = (2, 2),
                 keys: tuple[bytes, bytes] | None = None):
        self.ue_id = ue_id
        self.ngu_tx = ngu_tx  # GTP-U frames toward the core (UL exit)
        self.sdap = sdap.SdapEntity(sdap.SdapConfig())
        self.drbs: dict[int, DrbContext] = {}
        self._flows: dict[int, tuple[int, int]] = {}  # qfi -> (teid_ul, drb)
        self.nea, self.nia = sec_cfg
        self.keys = keys or (bytes(range(16)), bytes(range(16, 32)))
        self.demux = gtpu.GtpuDemux()

    def setup_bearer(self, drb_id: int, qfi: int, teid_dl: int, teid_ul: int,
                     f1u_tx: Callable[[bytes], None], sn_bits: int = 18) -> DrbContext:
        """E1AP BEARER CONTEXT SETUP equivalent: create DRB + tunnel wiring."""
        engine = security.SecurityEngine(self.nea, self.nia, self.keys[0], self.keys[1], bearer=drb_id)
        ent = pdcp.PdcpEntity(pdcp.PdcpConfig(sn_bits=sn_bits), engine, is_downlink_tx=True,
                              on_rx_sdu=lambda sdu, q=qfi, t=teid_ul: self._ul_exit(q, t, sdu))
        ctx = DrbContext(drb_id=drb_id, pdcp_entity=ent, f1u_tx=f1u_tx)
        self.drbs[drb_id] = ctx
        self.sdap.map_flow(qfi, drb_id)
        self._flows[qfi] = (teid_ul, drb_id)
        self.demux.add_tunnel(teid_dl, lambda gpdu: self._dl_entry(gpdu))
        return ctx

    # -- DL: core -> GTP-U -> SDAP -> PDCP -> NR-U -> DU ----------------------
    def rx_ngu(self, data: bytes) -> None:
        self.demux.rx(data)

    def _dl_entry(self, gpdu: gtpu.GtpuPdu) -> None:
        qfi = gpdu.qfi if gpdu.qfi is not None else 0
        drb_id, sdap_pdu = self.sdap.tx_sdu(qfi, gpdu.payload, downlink=True)
        ctx = self.drbs[drb_id]
        pdcp_pdu = ctx.pdcp_entity.tx_sdu(sdap_pdu)
        frame = nru.encode_dl_user_data(nru.NruDlUserData(nru_sn=ctx.nru_sn, payload=pdcp_pdu))
        ctx.nru_sn = (ctx.nru_sn + 1) & 0xFFFFFF
        if ctx.f1u_tx:
            ctx.f1u_tx(frame)

    # -- UL: DU -> PDCP PDU -> SDAP -> GTP-U -> core ---------------------------
    def rx_f1u_ul(self, drb_id: int, pdcp_pdu: bytes) -> None:
        """UL PDCP PDU arriving from the DU over F1-U."""
        self.drbs[drb_id].pdcp_entity.rx_pdu(pdcp_pdu)

    def _ul_exit(self, qfi: int, teid_ul: int, sdap_pdu: bytes) -> None:
        _, sdu = self.sdap.rx_pdu(sdap_pdu, downlink=False)
        self.ngu_tx(gtpu.encode_gpdu(teid=teid_ul, payload=sdu, qfi=qfi, downlink=False))

    def tick(self, now_slot: int) -> None:
        for ctx in self.drbs.values():
            ctx.pdcp_entity.tick(now_slot)
