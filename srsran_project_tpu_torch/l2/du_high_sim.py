"""DU-high simulator: MAC TB assembly/decode over RLC, driven by the scheduler.

Counterpart of the reference's lib/du/du_high + lib/mac data path (SURVEY.md
section 2.4 "DU-high", "MAC"): the scheduler (l2sim.scheduler) picks grants;
this module fills DL transport blocks with real MAC subPDUs pulled from
per-UE RLC entities (instead of the scheduler sim's random bits) and decodes
UL transport blocks back through MAC -> RLC.  F1-U (NR-U over GTP-U) links
it to the CU-UP simulator (cu_up_sim.py), mirroring the reference's split:
PDCP/SDAP live in the CU-UP, RLC/MAC in the DU.

TBs are numpy bit arrays at the FAPI boundary (what the PDSCH/PUSCH
processors carry); bytes<->bits conversion happens here.

A copy of ``srsran_project_tpu/l2/du_high_sim.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..l2sim.scheduler import RoundRobinScheduler, SchedulerConfig
from . import mac_pdu, rlc


def bytes_to_bits(b: bytes, nof_bits: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(b, dtype=np.uint8))
    out = np.zeros(nof_bits, dtype=np.uint8)
    out[: min(len(bits), nof_bits)] = bits[:nof_bits]
    return out


def bits_to_bytes(bits: np.ndarray) -> bytes:
    return np.packbits(bits.astype(np.uint8)).tobytes()


@dataclasses.dataclass
class DuBearer:
    lcid: int
    entity: rlc.RlcAmEntity | rlc.RlcUmEntity | rlc.RlcTmEntity


class DuUe:
    """Per-UE DU context: RLC bearers keyed by LCID."""

    def __init__(self, rnti: int):
        self.rnti = rnti
        self.bearers: dict[int, DuBearer] = {}
        self.ta_cmds: list[int] = []  # pending TA commands to send as MAC CE
        self.bsr_bytes = 0  # last reported UL buffer status

    def add_bearer(self, lcid: int, mode: str = "am",
                   on_rx_sdu: Callable[[bytes], None] | None = None) -> DuBearer:
        ent = {"am": lambda: rlc.RlcAmEntity(on_rx_sdu=on_rx_sdu),
               "um": lambda: rlc.RlcUmEntity(on_rx_sdu=on_rx_sdu),
               "tm": lambda: rlc.RlcTmEntity(on_rx_sdu=on_rx_sdu)}[mode]()
        b = DuBearer(lcid=lcid, entity=ent)
        self.bearers[lcid] = b
        return b


class DuHighSim:
    """MAC PDU assembly/decode around the scheduler simulator.

    Use with l2sim.scheduler: call fill_dl_tbs() on the scheduler's grants
    to replace random payloads with MAC PDUs, and handle_ul_tb() with
    decoded PUSCH transport blocks.
    """

    def __init__(self, sched_cfg: SchedulerConfig):
        self.scheduler = RoundRobinScheduler(sched_cfg)
        self.ues: dict[int, DuUe] = {}
        self.dl_bytes = 0
        self.ul_bytes = 0

    def add_ue(self, rnti: int, mcs: int = 10, on_rx_sdu=None) -> DuUe:
        self.scheduler.add_ue(rnti, mcs=mcs)
        ue = DuUe(rnti)
        ue.add_bearer(4, "am", on_rx_sdu=on_rx_sdu)  # default DRB LCID 4
        self.ues[rnti] = ue
        return ue

    # -- DL ------------------------------------------------------------------
    def build_dl_tb(self, rnti: int, tbs_bits: int) -> np.ndarray:
        """Assemble one DL-SCH MAC PDU of tbs_bits: CEs then RLC subPDUs, padded."""
        ue = self.ues[rnti]
        # Drain TA commands the scheduler's TA manager queued for this UE
        # (l2sim/ue_context_loops.TaManager -> TA-command MAC CE).
        ue.ta_cmds.extend(self.scheduler.pop_ta_cmds(rnti))
        tb_size = tbs_bits // 8
        subpdus: list[mac_pdu.MacSubPdu] = []
        budget = tb_size
        while ue.ta_cmds and budget >= 2:
            subpdus.append(mac_pdu.MacSubPdu(int(mac_pdu.DlLcid.TA_CMD),
                                             mac_pdu.ce_ta_command(0, ue.ta_cmds.pop(0))))
            budget -= 2
        for lcid, bearer in sorted(ue.bearers.items()):
            while budget > 5:
                pdu = bearer.entity.pull_pdu(budget - 3)  # leave subheader room
                if pdu is None:
                    break
                subpdus.append(mac_pdu.MacSubPdu(lcid=lcid, payload=pdu))
                budget -= len(pdu) + (2 if len(pdu) < 256 else 3)
        tb = mac_pdu.encode_mac_pdu(subpdus, tb_size=tb_size)
        self.dl_bytes += tb_size
        return bytes_to_bits(tb, tbs_bits)

    # -- UL ------------------------------------------------------------------
    def handle_ul_tb(self, rnti: int, tb_bits: np.ndarray) -> None:
        """Decode one UL-SCH MAC PDU: route SDU subPDUs to RLC, consume CEs."""
        ue = self.ues.get(rnti)
        if ue is None:
            return
        data = bits_to_bytes(tb_bits)
        for sp in mac_pdu.decode_mac_pdu(data, uplink=True):
            if sp.is_padding:
                continue
            if sp.lcid == int(mac_pdu.UlLcid.SHORT_BSR) and sp.payload:
                _, idx = mac_pdu.parse_short_bsr(sp.payload)
                ue.bsr_bytes = mac_pdu.BSR_5BIT_TABLE[idx]
            elif sp.lcid == int(mac_pdu.UlLcid.CRNTI) and len(sp.payload) == 2:
                pass  # C-RNTI CE: RA contention resolution hook
            elif 1 <= sp.lcid <= mac_pdu.MAX_LCID:
                bearer = ue.bearers.get(sp.lcid)
                if bearer is not None:
                    bearer.entity.rx_pdu(sp.payload)
                    self.ul_bytes += len(sp.payload)

    # -- RLC status piggyback (peer side runs the UE-side entities) ----------
    def exchange_am_status(self, rnti: int, lcid: int, peer: rlc.RlcAmEntity) -> None:
        ue = self.ues[rnti]
        ent = ue.bearers[lcid].entity
        if isinstance(ent, rlc.RlcAmEntity):
            ent.rx_status(rlc.decode_status_pdu(peer.build_status(), peer.sn_bits))
            peer.rx_status(rlc.decode_status_pdu(ent.build_status(), ent.sn_bits))
