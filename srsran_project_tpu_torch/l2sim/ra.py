"""Random-access procedure manager — TS 38.321 5.1 (4-step RA).

Counterpart of the reference's scheduler RA machinery (lib/scheduler
common_scheduling ra_scheduler.cpp + MAC rar handling; SURVEY.md section
2.4 "Scheduler" / Appendix B scheduler sub-inventory): consumes RACH
indications from the PRACH detector, schedules RAR (Msg2) PDSCH carrying a
real MAC RAR PDU (TC-RNTI, TA command, Msg3 grant), expects Msg3 on the
granted PUSCH, and resolves contention with the Msg4 UE Contention
Resolution Identity CE.  TC-RNTIs are promoted to C-RNTIs on success.

Copy of ``srsran_project_tpu/l2sim/ra.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..fapi import messages as fapi
from ..l2 import mac_pdu

RA_WINDOW_SLOTS = 10
TA_CMD_RESOLUTION = 16  # samples per TA command step in this sim


@dataclasses.dataclass
class RaContext:
    preamble: int
    tc_rnti: int
    ta_cmd: int
    rar_slot: int | None = None
    msg3_slot: int | None = None
    ccch: bytes | None = None  # Msg3 CCCH SDU (for contention resolution)
    state: str = "detected"  # detected -> rar_sent -> msg3_received -> resolved


class RaManager:
    def __init__(self, ra_rnti: int = 0x002A, first_tc_rnti: int = 0x4601):
        self.ra_rnti = ra_rnti
        self._next_tc_rnti = first_tc_rnti
        self.pending: dict[int, RaContext] = {}  # by preamble
        self.resolved: list[RaContext] = []

    def handle_rach_indication(self, slot_count: int, ind: fapi.RachIndicationPdu) -> RaContext:
        """RACH.indication -> allocate TC-RNTI, queue a RAR."""
        ta_cmd = max(0, min(63, int(round(ind.ta_samples / TA_CMD_RESOLUTION))))
        ctx = RaContext(preamble=ind.preamble_index, tc_rnti=self._next_tc_rnti, ta_cmd=ta_cmd)
        self._next_tc_rnti += 1
        self.pending[ind.preamble_index] = ctx
        return ctx

    def build_rar_tb(self, slot_count: int, tbs_bits: int) -> np.ndarray | None:
        """MAC RAR PDU for every pending detection, as a TB bit array
        (the Msg2 PDSCH payload addressed to RA-RNTI)."""
        grants = []
        for ctx in self.pending.values():
            if ctx.state == "detected":
                grants.append(mac_pdu.RarGrant(rapid=ctx.preamble, ta=ctx.ta_cmd,
                                               ul_grant=0x1, tc_rnti=ctx.tc_rnti))
                ctx.state = "rar_sent"
                ctx.rar_slot = slot_count
        if not grants:
            return None
        pdu = mac_pdu.encode_rar_pdu(grants)
        if 8 * len(pdu) > tbs_bits:
            raise ValueError("RAR PDU exceeds Msg2 TBS")
        bits = np.unpackbits(np.frombuffer(pdu.ljust(tbs_bits // 8, b"\0"), np.uint8))
        return bits[:tbs_bits].astype(np.uint8)

    def handle_msg3(self, slot_count: int, tb_bits: np.ndarray) -> RaContext | None:
        """Decode Msg3 (UL-SCH): CCCH SDU (initial access) or C-RNTI CE."""
        data = np.packbits(tb_bits.astype(np.uint8)).tobytes()
        subpdus = mac_pdu.decode_mac_pdu(data, uplink=True)
        ccch = None
        for sp in subpdus:
            if sp.lcid in (int(mac_pdu.UlLcid.CCCH48), int(mac_pdu.UlLcid.CCCH64)):
                ccch = sp.payload
        if ccch is None:
            return None
        # match to the oldest rar_sent context (single-preamble sim path)
        for ctx in self.pending.values():
            if ctx.state == "rar_sent":
                ctx.state = "msg3_received"
                ctx.msg3_slot = slot_count
                ctx.ccch = ccch
                return ctx
        return None

    def build_msg4_subpdus(self, ctx: RaContext) -> list[mac_pdu.MacSubPdu]:
        """Msg4 contention resolution: echo the first 48 bits of Msg3 CCCH."""
        assert ctx.state == "msg3_received"
        ctx.state = "resolved"
        self.resolved.append(ctx)
        self.pending.pop(ctx.preamble, None)
        return [mac_pdu.MacSubPdu(int(mac_pdu.DlLcid.CON_RES_ID),
                                  mac_pdu.ce_con_res_id(ctx.ccch))]

    def expire(self, slot_count: int) -> None:
        """Drop RA attempts whose Msg3 never arrived within the window."""
        for pre in [p for p, c in self.pending.items()
                    if c.rar_slot is not None and c.state == "rar_sent"
                    and slot_count - c.rar_slot > RA_WINDOW_SLOTS]:
            del self.pending[pre]
