"""The UE side of the monolithic gNB simulator: the user-plane stack and the
RRC responder that ``gnb_sim`` drives its UEs with.

- ``UeSim``: MAC decode -> RLC AM -> PDCP -> SDAP on the downlink, and the
  reverse on the uplink (a short BSR, then RLC PDUs in a UL-SCH MAC PDU);
- ``UeRrcAgent``: answers the CU-CP's RRC procedures (setup, security mode
  with SRB1 protection from the derived keys, reconfiguration, release),
  its containers riding the DU's F1 RRC message transfers.

The reference's app takes these two classes from its test files
(``tests/test_du_cu_split.py`` and ``tests/test_l3_attach.py``); the port
keeps copies in its package, on its own L2 and L3 modules.
"""

from __future__ import annotations

import numpy as np

from ..l2 import du_high_sim, mac_pdu, pdcp, rlc, sdap, security
from ..l3 import messages as m
from ..l3.cu_cp_sim import DuF1Sim, make_srb_pdcp


class UeSim:
    """UE-side stack: MAC decode -> RLC AM -> PDCP -> SDAP."""

    def __init__(self, rnti):
        self.rnti = rnti
        self.delivered = []  # DL IP packets
        self.ul_queue = []
        self.sdap = sdap.SdapEntity(sdap.SdapConfig(),
                                    on_rx_sdu=lambda qfi, s: self.delivered.append((qfi, s)))
        eng = security.SecurityEngine(2, 2, bytes(range(16)), bytes(range(16, 32)), bearer=1)
        self.pdcp = pdcp.PdcpEntity(pdcp.PdcpConfig(sn_bits=18), eng, is_downlink_tx=False,
                                    on_rx_sdu=lambda s: self.sdap.rx_pdu(s, downlink=True))
        self.rlc = rlc.RlcAmEntity(on_rx_sdu=self.pdcp.rx_pdu)
        self.sdap.map_flow(9, 1)

    def send_ul(self, ip_packet: bytes):
        _, sdap_pdu = self.sdap.tx_sdu(9, ip_packet, downlink=False)
        self.rlc.tx_sdu(self.pdcp.tx_sdu(sdap_pdu))

    def handle_dl_tb(self, tb_bits: np.ndarray):
        data = du_high_sim.bits_to_bytes(tb_bits)
        for sp in mac_pdu.decode_mac_pdu(data):
            if 1 <= sp.lcid <= mac_pdu.MAX_LCID:
                self.rlc.rx_pdu(sp.payload)

    def build_ul_tb(self, tbs_bits: int) -> np.ndarray:
        tb_size = tbs_bits // 8
        subs = [mac_pdu.MacSubPdu(int(mac_pdu.UlLcid.SHORT_BSR),
                                  mac_pdu.ce_short_bsr(0, mac_pdu.bsr_index_from_bytes(4000)))]
        budget = tb_size - 2  # BSR CE = 1 subheader + 1 payload byte
        while budget > 5:
            p = self.rlc.pull_pdu(budget - 3)
            if p is None:
                break
            subs.append(mac_pdu.MacSubPdu(lcid=4, payload=p))
            budget -= len(p) + (2 if len(p) < 256 else 3)
        return du_high_sim.bytes_to_bits(
            mac_pdu.encode_mac_pdu(subs, tb_size=tb_size, uplink=True), tbs_bits)


class UeRrcAgent:
    """UE-side RRC responder; receives DL containers via the DU bridge."""

    def __init__(self, du: DuF1Sim, c_rnti: int, k_gnb_provider):
        self.du = du
        self.c_rnti = c_rnti
        self.k_gnb_provider = k_gnb_provider  # NAS-side key agreement stand-in
        self.du_ue_id = None
        self.srb1_pdcp = None
        self.state = "idle"
        self.drb_configs = []
        self.released = False

    def connect(self):
        self.du_ue_id = self.du.allocate_ue(self.deliver_dl)
        self.state = "connecting"
        self.du.initial_ul_rrc(self.du_ue_id, self.c_rnti,
                               m.encode(m.RrcSetupRequest(ue_identity=0x123456)))

    def _send(self, rrc_msg, srb_id=1):
        container = m.encode(rrc_msg)
        if self.srb1_pdcp is not None and srb_id == 1:
            container = self.srb1_pdcp.tx_sdu(container)
        self.du.ul_rrc(self.du_ue_id, srb_id, container)

    def deliver_dl(self, srb_id: int, container: bytes):
        if self.srb1_pdcp is not None and srb_id == 1:
            out = []
            self.srb1_pdcp.on_rx_sdu = out.append
            self.srb1_pdcp.rx_pdu(container)
            if not out:
                return  # integrity failure: discard silently
            container = out[0]
        rrc = m.decode(container)
        if isinstance(rrc, m.RrcSetup):
            self.state = "setup"
            self._send(m.RrcSetupComplete(selected_plmn="00101", nas_pdu="deadbeef"))
        elif isinstance(rrc, m.RrcSecurityModeCommand):
            # activate SRB1 protection first; the SecurityModeComplete itself
            # is already protected with the new keys (TS 38.331 5.3.4)
            self.srb1_pdcp = make_srb_pdcp(self.k_gnb_provider(), rrc.ciphering_algo,
                                           rrc.integrity_algo, is_cu_side=False)
            self.state = "secure"
            self._send(m.RrcSecurityModeComplete())
        elif isinstance(rrc, m.RrcReconfiguration):
            self.drb_configs = rrc.drb_configs
            self.state = "connected"
            self._send(m.RrcReconfigurationComplete())
        elif isinstance(rrc, m.RrcRelease):
            self.released = True
            self.state = "idle"
