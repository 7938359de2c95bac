"""CU-CP core: UE manager + NGAP/F1AP/E1AP procedure driver (reference
lib/cu_cp ue_manager + routines).  The mobility procedures are the
methods of its base ``mobility.MobilityMixin``; the full attach
choreography is documented in cu_cp_sim.py (the package's import surface
for these simulators).

A copy of ``srsran_project_tpu/l3/cu_cp.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

from . import messages as m
from .amf_sim import _hex
from .mobility import MobilityMixin
from .rrc import CuUeCtx as _CuUeCtx, make_srb_pdcp


class CuCpSim(MobilityMixin):
    """CU-CP: UE manager + RRC + NGAP/F1AP/E1AP procedure driver."""

    def __init__(self, send_to_amf, send_to_du, send_to_cuup):
        self.to_amf = send_to_amf
        self.du_links: dict[int, object] = {0: send_to_du}  # du_id -> send fn
        self.to_cuup = send_to_cuup
        self.next_cu_ue_id = 1
        self.ues: dict[int, _CuUeCtx] = {}  # by cu_ue_id
        self._by_du_id: dict[tuple[int, int], _CuUeCtx] = {}  # (du_id, du_ue_id)
        self.ng_ready = False
        self.f1_cells: list = []
        # paging sink: cb(ue_paging_id) -> the DU cell scheduler's paging
        # queue (l2sim.common_scheduling.PagingScheduler.page)
        self.paging_sink = None
        # mobility (the reference's cell_meas_manager + mobility_manager):
        # pci -> (du_id, next target du_ue_id allocator); A3 hysteresis dB
        self.neighbor_cells: dict[int, tuple[int, object]] = {}
        self.a3_offset_db = 3.0

    def add_du(self, du_id: int, send_fn) -> None:
        """Register an additional DU F1 connection (multi-DU / handover)."""
        self.du_links[du_id] = send_fn

    def start(self, gnb_id: int = 411, plmn: str = "00101", tac: int = 7):
        self.to_amf(m.encode(m.NgSetupRequest(gnb_id=gnb_id, plmn=plmn, tac=tac)))

    # -- RRC container helpers ------------------------------------------------
    def _send_rrc(self, ctx: _CuUeCtx, rrc_msg, srb_id: int = 1, protect: bool = True) -> None:
        container = m.encode(rrc_msg)
        if protect and ctx.srb1_pdcp is not None and srb_id == 1:
            container = ctx.srb1_pdcp.tx_sdu(container)
        self.du_links[ctx.du_id](m.encode(m.DlRrcMessageTransfer(
            gnb_du_ue_id=ctx.du_ue_id, gnb_cu_ue_id=ctx.cu_ue_id,
            srb_id=srb_id, rrc_container=_hex(container))))

    def _rx_rrc(self, ctx: _CuUeCtx, srb_id: int, container: bytes):
        if ctx.srb1_pdcp is not None and srb_id == 1:
            out = []
            ctx.srb1_pdcp.on_rx_sdu = out.append
            ctx.srb1_pdcp.rx_pdu(container)
            if not out:
                return None  # integrity failure / reorder buffer
            container = out[0]
        return m.decode(container)

    # -- message entry points ---------------------------------------------------
    def rx_from_amf(self, data: bytes) -> None:
        msg = m.decode(data)
        if isinstance(msg, m.NgSetupResponse):
            self.ng_ready = True
        elif isinstance(msg, m.InitialContextSetupRequest):
            ctx = self.ues[msg.ran_ue_id]
            ctx.amf_ue_id = msg.amf_ue_id
            ctx.k_gnb = bytes.fromhex(msg.security_key)
            ctx.nea, ctx.nia = msg.allowed_nea[0], msg.allowed_nia[0]
            ctx.state = "security"
            # SRB1 protection activates with the SMC (TS 38.331 5.3.4): the
            # SMC itself goes unprotected here (deviation: spec integrity-
            # protects it), everything after — starting with the UE's
            # SecurityModeComplete — is PDCP integrity+ciphered.  Activate
            # before sending: the UE's protected reply arrives synchronously.
            ctx.srb1_pdcp = make_srb_pdcp(ctx.k_gnb, ctx.nea, ctx.nia, is_cu_side=True)
            self._send_rrc(ctx, m.RrcSecurityModeCommand(ciphering_algo=ctx.nea,
                                                         integrity_algo=ctx.nia), protect=False)
        elif isinstance(msg, m.Paging):
            if self.paging_sink is not None:
                self.paging_sink(msg.ue_paging_id)
        elif isinstance(msg, m.PduSessionResourceSetupRequest):
            ctx = self.ues[msg.ran_ue_id]
            ctx.pending_sessions = msg.sessions
            ctx.state = "bearer_setup"
            self.to_cuup(m.encode(m.BearerContextSetupRequest(
                gnb_cu_cp_ue_id=ctx.cu_ue_id, security_key=_hex(ctx.k_gnb),
                nea=ctx.nea, nia=ctx.nia,
                sessions=[{"session_id": s["session_id"], "qfi": s["qfi"],
                           "drb_id": 1, "pdcp_sn_bits": 18,
                           "ngu_ul_teid": s["ngu_ul_teid"]} for s in msg.sessions])))

    def rx_from_du(self, data: bytes, du_id: int = 0) -> None:
        msg = m.decode(data)
        if isinstance(msg, m.F1SetupRequest):
            self.f1_cells = msg.cells
            self.du_links[du_id](m.encode(m.F1SetupResponse(gnb_cu_name="cucp-sim",
                                                  cells_to_activate=[c["pci"] for c in msg.cells])))
        elif isinstance(msg, m.InitialUlRrcMessageTransfer):
            req = m.decode(bytes.fromhex(msg.rrc_container))
            if isinstance(req, m.RrcReestablishmentRequest):
                self.handle_reestablishment(du_id, msg.gnb_du_ue_id, req)
                return
            assert isinstance(req, m.RrcSetupRequest)
            ctx = _CuUeCtx(cu_ue_id=self.next_cu_ue_id, du_ue_id=msg.gnb_du_ue_id,
                           c_rnti=msg.c_rnti, state="setup", du_id=du_id)
            self.next_cu_ue_id += 1
            self.ues[ctx.cu_ue_id] = ctx
            self._by_du_id[(du_id, ctx.du_ue_id)] = ctx
            self._send_rrc(ctx, m.RrcSetup(rnti=msg.c_rnti,
                                           srb1_config={"rlc": "am", "lcid": 1}), srb_id=0)
        elif isinstance(msg, m.UlRrcMessageTransfer):
            ctx = self._by_du_id[(du_id, msg.gnb_du_ue_id)]
            rrc = self._rx_rrc(ctx, msg.srb_id, bytes.fromhex(msg.rrc_container))
            if rrc is None:
                return
            self._handle_ue_rrc(ctx, rrc)
        elif isinstance(msg, m.UeContextSetupResponse):
            ctx = self._by_du_id[(du_id, msg.gnb_du_ue_id)]
            if ctx.ho_target is not None:
                self._continue_handover(ctx, msg)
                return
            # learn DU F1-U DL TEIDs -> E1 bearer modification, then RRC reconfig
            self.to_cuup(m.encode(m.BearerContextModificationRequest(
                gnb_cu_up_ue_id=ctx.cu_up_ue_id,
                drb_f1u_dl_teids=msg.drbs_setup)))
            self._send_rrc(ctx, m.RrcReconfiguration(
                drb_configs=[{"drb_id": d["drb_id"], "qfi": s["qfi"],
                              "pdcp_sn_bits": 18, "rlc_mode": "am", "lcid": 4}
                             for d, s in zip(msg.drbs_setup, ctx.pending_sessions)]))
        elif isinstance(msg, m.UeContextReleaseComplete):
            ctx = self._by_du_id.pop((du_id, msg.gnb_du_ue_id), None)
            if ctx is not None and ctx.du_id == du_id and ctx.du_ue_id == msg.gnb_du_ue_id:
                self.ues.pop(ctx.cu_ue_id, None)

    def rx_from_cuup(self, data: bytes) -> None:
        msg = m.decode(data)
        if isinstance(msg, m.BearerContextSetupResponse):
            ctx = self.ues[msg.gnb_cu_cp_ue_id]
            ctx.cu_up_ue_id = msg.gnb_cu_up_ue_id
            ctx.drbs = msg.drbs
            self.du_links[ctx.du_id](m.encode(m.UeContextSetupRequest(
                gnb_cu_ue_id=ctx.cu_ue_id, gnb_du_ue_id=ctx.du_ue_id,
                srbs_to_setup=[{"srb_id": 2}],
                drbs_to_setup=[{"drb_id": d["drb_id"], "lcid": 4, "rlc_mode": "am",
                                "f1u_ul_teid": d["f1u_ul_teid"]} for d in msg.drbs])))

    def _handle_ue_rrc(self, ctx: _CuUeCtx, rrc) -> None:
        if isinstance(rrc, m.RrcSetupComplete):
            ctx.state = "registered"
            self.to_amf(m.encode(m.InitialUeMessage(
                ran_ue_id=ctx.cu_ue_id, nas_pdu=rrc.nas_pdu,
                establishment_cause="mo_data")))
        elif isinstance(rrc, m.RrcSecurityModeComplete):
            ctx.state = "secure"
            self.to_amf(m.encode(m.InitialContextSetupResponse(
                ran_ue_id=ctx.cu_ue_id, amf_ue_id=ctx.amf_ue_id)))
        elif isinstance(rrc, m.RrcReestablishmentComplete):
            ctx.state = "connected"
        elif isinstance(rrc, m.RrcMeasurementReport):
            self._handle_measurement_report(ctx, rrc)
        elif isinstance(rrc, m.RrcReconfigurationComplete):
            if ctx.ho_target is not None:
                self._finish_handover(ctx)
                return
            ctx.state = "connected"
            self.to_amf(m.encode(m.PduSessionResourceSetupResponse(
                ran_ue_id=ctx.cu_ue_id,
                sessions_setup=[{"session_id": s["session_id"],
                                 "ngu_dl_teid": 0x100 + ctx.cu_ue_id}
                                for s in ctx.pending_sessions])))

    def release_ue(self, cu_ue_id: int) -> None:
        ctx = self.ues[cu_ue_id]
        self._send_rrc(ctx, m.RrcRelease())
        self.du_links[ctx.du_id](m.encode(m.UeContextReleaseCommand(
            gnb_cu_ue_id=ctx.cu_ue_id, gnb_du_ue_id=ctx.du_ue_id)))

