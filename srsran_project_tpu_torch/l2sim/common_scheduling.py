"""Common-channel scheduling: SSB, SIB1, paging, CSI-RS, PRACH occasions.

Counterpart of the reference's lib/scheduler/common_scheduling (ssb, sib1,
paging, csi_rs, prach schedulers ordered by cell_scheduler::run_slot —
ssb -> csi -> si -> prach -> ra -> paging -> UE data, SURVEY.md section 3.2)
at simulator fidelity: a CellScheduler composes the common occasions with
the UE data scheduler (scheduler.py), yielding merged FAPI requests per
slot.  On slots carrying broadcast PDSCH (SIB1/paging) the UE data grants
yield the band, mirroring the priority order.

Port of ``srsran_project_tpu/l2sim/common_scheduling.py`` with the port's
FAPI and PHY config twins (``CommonSchedulingConfig.from_reference``
copies a JAX package config with its PRACH config), and the same optional
stages: the fallback scheduler (``fallback.FallbackScheduler``) and the
SI-window, PF/PO paging and CSI-RS resource engines (``si_paging``).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..fapi import messages as fapi
from ..phy.pdsch import PdschConfig
from ..phy.allocation import Allocation
from ..phy.prach import PrachConfig
from ..phy.ssb import SsbConfig
from ..ops.modulation import Modulation
from ..ran.slot_point import SlotPoint
from . import pdcch_alloc

SI_RNTI = 0xFFFF
P_RNTI = 0xFFFE


@dataclasses.dataclass(frozen=True)
class CommonSchedulingConfig:
    # SSB: burst every ssb_period_slots, one SSB at the configured position
    ssb_period_slots: int = 40  # 20 ms at 30 kHz SCS
    ssb_slot_offset: int = 0
    ssb_first_symbol: int = 2
    ssb_first_subcarrier: int = 0
    pci: int = 1
    # SIB1 periodicity (TS 38.331: 160 ms; modifiable)
    sib1_period_slots: int = 320
    sib1_slot_offset: int = 1
    sib1_payload: bytes = b"{}"
    # paging: PO every paging_period_slots, N occasions
    paging_period_slots: int = 64
    # PRACH occasion periodicity (UL)
    prach_period_slots: int = 20
    prach_slot_offset: int = 19
    prach_config: PrachConfig = PrachConfig()
    # periodic CSI-RS
    csi_rs_period_slots: int = 40
    csi_rs_slot_offset: int = 10
    nof_rb: int = 52
    nof_grid_sc: int = 624

    @classmethod
    def from_reference(cls, ref) -> "CommonSchedulingConfig":
        """Copy a reference (JAX package) ``CommonSchedulingConfig`` field by
        field, its PRACH config as the port's twin."""
        kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)}
        kw["prach_config"] = PrachConfig.from_reference(kw["prach_config"])
        return cls(**kw)


def _bcast_pdsch(nof_rb: int, nof_grid_sc: int, payload: bytes):
    """QPSK broadcast PDSCH config sized for the payload (SIB1/paging)."""
    tbs = 8 * len(payload)
    alloc = Allocation(rb_start=0, rb_count=nof_rb, sym_start=1, sym_count=12,
                       dmrs_symbols=(2,))
    cfg = PdschConfig(tbs=tbs, target_code_rate=0.25, modulation=Modulation.QPSK,
                      alloc=alloc, nof_layers=1, nof_ports=1,
                      nof_grid_symbols=14, nof_grid_sc=nof_grid_sc, rv=0)
    bits = np.unpackbits(np.frombuffer(payload, np.uint8)).astype(np.uint8)
    return cfg, bits


class PagingScheduler:
    """Queues paging records; drains them at paging occasions (P-RNTI PDSCH)."""

    def __init__(self):
        self._queue: list[dict] = []

    def page(self, ue_paging_id: int, domain: str = "ps") -> None:
        self._queue.append({"ue_paging_id": ue_paging_id, "domain": domain})

    def drain(self) -> bytes | None:
        if not self._queue:
            return None
        recs, self._queue = self._queue[:8], self._queue[8:]  # maxNrofPageRec
        return json.dumps({"paging_records": recs}).encode()


class CellScheduler:
    """run_slot = common occasions + UE data (the reference's cell_scheduler)."""

    def __init__(self, common: CommonSchedulingConfig, ue_scheduler,
                 fallback=None, si_scheduler=None, paging_po=None,
                 csi_rs_scheduler=None):
        self.common = common
        self.ue_scheduler = ue_scheduler
        # Optional l2sim.fallback.FallbackScheduler, run between common
        # occasions and UE data like the reference's run_slot order
        # (... -> ra -> FALLBACK -> UE data).
        self.fallback = fallback
        self.paging = PagingScheduler()
        # Optional spec-math engines (l2sim/si_paging.py): SI-message
        # windows (TS 38.331 5.2.2.3.2), PF/PO paging (TS 38.304 7.1) and
        # the periodic CSI-RS resource scheduler.  When given, they take
        # over from the simple modulo occasions.
        self.si_scheduler = si_scheduler
        self.paging_po = paging_po
        self.csi_rs_scheduler = csi_rs_scheduler
        self.cbs = CbsScheduler()
        self.counters = {"ssb": 0, "sib1": 0, "paging": 0, "csi_rs": 0,
                         "prach": 0, "cbs": 0, "fallback": 0, "si": 0}

    def _pbch_payload(self, slot: SlotPoint) -> np.ndarray:
        # 32-bit BCH payload: MIB-ish content (sfn + fixed fields), sim fidelity
        sfn = slot.sfn & 0x3FF
        word = (sfn << 16) | (self.common.pci & 0x3FF)
        return np.array([(word >> (31 - i)) & 1 for i in range(32)], np.uint8)

    def run_slot(self, slot: SlotPoint, rng: np.random.Generator):
        c = self.common
        count = slot.count
        ssb, csi_rs, prach = [], [], []

        # Broadcast decision first: on SIB1/paging/CBS slots the broadcast
        # PDSCH takes the band and neither fallback nor UE data run
        # (cell_scheduler.cpp run_slot priority order).
        broadcast = None
        if count % c.sib1_period_slots == c.sib1_slot_offset:
            broadcast = (SI_RNTI, c.sib1_payload)
            self.counters["sib1"] += 1
        elif self.si_scheduler is not None and (
                si := self.si_scheduler.run_slot(slot)) is not None:
            # Other-SI window transmission (si_message_scheduler role).
            broadcast = (SI_RNTI, si[1])
            self.counters["si"] += 1
        elif self.paging_po is not None:
            recs = self.paging_po.run_slot(slot)
            if recs:
                broadcast = (P_RNTI,
                             json.dumps({"paging_records": recs}).encode())
                self.counters["paging"] += 1
        elif self.paging_po is None and count % c.paging_period_slots == 0:
            recs = self.paging.drain()
            if recs is not None:
                broadcast = (P_RNTI, recs)
                self.counters["paging"] += 1
        if broadcast is None and (
                count % c.paging_period_slots == c.paging_period_slots // 2):
            # CBS warning SI window sits opposite the paging occasion
            recs = self.cbs.drain()
            if recs is not None:
                broadcast = (CBS_RNTI, recs)
                self.counters["cbs"] += 1

        # Fallback (SRB0/SRB1) runs before UE data — reference run_slot order
        # (... -> ra -> fallback -> UE data) — allocating PRBs from 0 and
        # CCEs from the slot's shared PdcchSlotAllocator so the stages never
        # collide (shared per-slot resource map, cell_resource_allocator
        # role).
        fallback_grants = []
        fb_span = 0
        shared_pdcch = None
        if self.fallback is not None and broadcast is None:
            ue_cfg = getattr(self.ue_scheduler, "cfg", None)
            if ue_cfg is not None and getattr(ue_cfg, "use_pdcch_alloc", False):
                shared_pdcch = pdcch_alloc.PdcchSlotAllocator(
                    self.ue_scheduler.coresets, self.ue_scheduler.search_spaces)
            fallback_grants = self.fallback.run_slot(count, pdcch=shared_pdcch)
            self.counters["fallback"] += len(fallback_grants)
            fb_span = max((g.rb_start + g.rb_count for g in fallback_grants),
                          default=0)

        dl, tx, ul, grants = self.ue_scheduler.run_slot(
            slot, rng, rb_offset=fb_span, pdcch_slot=shared_pdcch)
        pdsch = list(dl.pdsch)
        payloads = list(tx.payloads)
        for g in fallback_grants:
            cfg, bits = _bcast_pdsch(g.rb_count, c.nof_grid_sc, g.payload)
            pdsch.append(fapi.DlPdschPdu(cfg, g.rnti,
                                         np.eye(1, dtype=np.complex64),
                                         len(payloads), first_rb=g.rb_start))
            payloads.append(bits)

        if broadcast is not None:
            # broadcast PDSCH takes the band this slot (priority order)
            rnti, payload = broadcast
            cfg, bits = _bcast_pdsch(c.nof_rb, c.nof_grid_sc, payload)
            pdsch = [fapi.DlPdschPdu(cfg, rnti, np.eye(1, dtype=np.complex64), 0,
                                     first_rb=0)]
            payloads = [bits]
            grants = []

        if count % c.ssb_period_slots == c.ssb_slot_offset:
            ssb.append(fapi.DlSsbPdu(
                config=SsbConfig(pci=c.pci),
                payload=self._pbch_payload(slot),
                first_subcarrier=c.ssb_first_subcarrier,
                first_symbol=c.ssb_first_symbol))
            self.counters["ssb"] += 1

        if self.csi_rs_scheduler is not None:
            for r in self.csi_rs_scheduler.run_slot(slot):
                csi_rs.append(fapi.DlCsiRsPdu(
                    row=r.row, rb_start=r.rb_start, rb_count=r.rb_count,
                    symbol=r.symbol, scrambling_id=r.scrambling_id))
                self.counters["csi_rs"] += 1
        elif count % c.csi_rs_period_slots == c.csi_rs_slot_offset:
            csi_rs.append(fapi.DlCsiRsPdu(row=1, rb_start=0, rb_count=c.nof_rb,
                                          symbol=12, scrambling_id=c.pci))
            self.counters["csi_rs"] += 1

        if count % c.prach_period_slots == c.prach_slot_offset:
            prach.append(fapi.UlPrachPdu(c.prach_config))
            self.counters["prach"] += 1

        dl2 = fapi.DlTtiRequest(slot=slot, pdsch=pdsch, pdcch=dl.pdcch,
                                ssb=ssb, csi_rs=csi_rs)
        tx2 = fapi.TxDataRequest(slot=slot, payloads=payloads)
        ul2 = fapi.UlTtiRequest(slot=slot, pusch=ul.pusch, pucch=ul.pucch,
                                prach=prach, srs=ul.srs)
        return dl2, tx2, ul2, grants


# ---------------------------------------------------------------------------
# CBS / ETWS cell broadcast (reference: lib/du/du_high/du_manager/cbs/)
# ---------------------------------------------------------------------------

CBS_RNTI = 0xFFFD  # broadcast PDSCH identity used by this sim for warnings
CBS_PAGE_BYTES = 82  # CB-DATA page size (TS 23.041 9.4.2)


class CbsScheduler:
    """Queues ETWS/CMAS warning messages; drains them page-by-page at SI
    occasions (du_manager cbs + SIB6/7/8 scheduling role).

    Long messages segment into 82-byte CB-DATA pages, each broadcast as a
    (message_id, serial, page_index, total) record so UEs can reassemble.
    """

    def __init__(self):
        self._queue: list[dict] = []
        self._serial = 0

    def warn(self, message_id: int, body: bytes, repetitions: int = 1) -> int:
        """Queue a warning (ETWS primary: message_id 0x1100-0x1107 etc.)."""
        self._serial = (self._serial + 1) & 0xFFFF
        pages = [body[i : i + CBS_PAGE_BYTES] for i in range(0, len(body), CBS_PAGE_BYTES)] or [b""]
        for _ in range(repetitions):
            for k, pg in enumerate(pages):
                self._queue.append({"message_id": message_id, "serial": self._serial,
                                    "page": k, "total": len(pages),
                                    "data": pg.hex()})
        return self._serial

    def drain(self) -> bytes | None:
        if not self._queue:
            return None
        recs, self._queue = self._queue[:4], self._queue[4:]
        return json.dumps({"cbs_pages": recs}).encode()


def reassemble_cbs(payloads: list[bytes]) -> dict[tuple[int, int], bytes]:
    """UE-side: join CB-DATA pages back into full warning bodies keyed by
    (message_id, serial)."""
    pages: dict[tuple[int, int], dict[int, bytes]] = {}
    totals: dict[tuple[int, int], int] = {}
    for p in payloads:
        for rec in json.loads(p.decode()).get("cbs_pages", []):
            k = (rec["message_id"], rec["serial"])
            pages.setdefault(k, {})[rec["page"]] = bytes.fromhex(rec["data"])
            totals[k] = rec["total"]
    out = {}
    for k, pg in pages.items():
        if len(pg) == totals[k]:
            out[k] = b"".join(pg[i] for i in range(totals[k]))
    return out
