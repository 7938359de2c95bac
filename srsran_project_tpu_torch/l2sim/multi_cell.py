"""Multi-cell scheduling: one scheduler per cell, shared UE contexts.

Counterpart of the reference's per-cell scheduler architecture
(lib/scheduler/cell_scheduler.cpp:92 — the scheduler instantiates one
cell_scheduler per active cell, and a UE's resources live on its SERVING
cell through the ue_cell context, lib/scheduler/ue_context/ue_cell.cpp).
A copy of ``srsran_project_tpu/l2sim/multi_cell.py``, at simulator fidelity:

- every cell runs the FULL RoundRobinScheduler machinery (PDCCH/PUCCH/SRS
  allocators, HARQ, link adaptation, UE-context loops) over its own
  carrier, producing its own per-slot FAPI stream;
- the shared UE registry pins each UE's PUSCH/PUCCH to its serving cell
  (grants for a UE only ever appear in that cell's stream);
- move_ue() re-homes a UE — the whole UeContext (HARQ state, TA manager,
  DRX, PF averages) transfers to the target cell, the intra-gNB mobility
  step toward the reference's cross-cell UE carriers (full carrier
  aggregation — one UE scheduled on several cells at once — remains out
  of scope, as in SURVEY §7's L2 simulator boundary).

Per-cell metrics (grants, bits, CRC outcomes, blocked counts) accumulate
in the wrapper, the per-cell twin of the reference's
scheduler_cell_metrics.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .scheduler import RoundRobinScheduler, SchedulerConfig


@dataclasses.dataclass
class CellMetrics:
    """Per-cell counters (reference scheduler_cell_metrics role)."""

    nof_dl_grants: int = 0
    nof_ul_grants: int = 0
    dl_bits: int = 0
    ul_bits: int = 0
    nof_crc_ok: int = 0
    nof_crc_nok: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class MultiCellScheduler:
    """N per-cell schedulers + a shared UE registry."""

    def __init__(self, cell_cfgs: dict[int, SchedulerConfig]):
        assert cell_cfgs, "at least one cell"
        self.cells: dict[int, RoundRobinScheduler] = {
            cid: RoundRobinScheduler(cfg) for cid, cfg in cell_cfgs.items()}
        self.serving: dict[int, int] = {}  # rnti -> PCell id
        self.scells: dict[int, set] = {}  # rnti -> active SCell ids (CA)
        self.metrics: dict[int, CellMetrics] = {
            cid: CellMetrics() for cid in cell_cfgs}

    # -- UE registry --------------------------------------------------------
    def add_ue(self, rnti: int, cell_id: int, **kw):
        """Attach a UE on its serving cell."""
        assert rnti not in self.serving, hex(rnti)
        self.serving[rnti] = cell_id
        return self.cells[cell_id].add_ue(rnti, **kw)

    def add_scell(self, rnti: int, scell_id: int, **kw):
        """Carrier aggregation: activate a SECONDARY carrier for an
        attached UE.  Mirrors the reference's per-carrier ue_cell contexts
        (ue_cell.cpp — independent HARQ entity, link adaptation and PF
        state per serving cell, shared UE identity): the SCell's scheduler
        gets its own UeContext for this rnti, so DL/UL grants flow from
        BOTH carriers in the same slot and retransmissions stay on the
        carrier that scheduled the initial transmission.  PUCCH remains on
        the PCell (the serving-cell registry is unchanged); cross-carrier
        scheduling/PUCCH-SCell are out of scope."""
        assert rnti in self.serving, "attach on a PCell first"
        assert scell_id != self.serving[rnti]
        ctx = self.cells[scell_id].add_ue(rnti, **kw)
        self.scells.setdefault(rnti, set()).add(scell_id)
        return ctx

    def carriers_of(self, rnti: int) -> tuple[int, ...]:
        return (self.serving[rnti],) + tuple(sorted(self.scells.get(rnti, ())))

    def move_ue(self, rnti: int, target_cell: int) -> None:
        """Intra-gNB mobility: transfer the WHOLE UE context (HARQ buffers,
        TA manager, DRX, PF state) to the target cell's scheduler."""
        assert not self.scells.get(rnti), \
            "release SCells before moving the PCell"
        src_cell = self.serving[rnti]
        if src_cell == target_cell:
            return
        ctx = self.cells[src_cell].ues.pop(rnti)
        self.cells[target_cell].ues[rnti] = ctx
        self.serving[rnti] = target_cell

    def ue_context(self, rnti: int):
        return self.cells[self.serving[rnti]].ues[rnti]

    # -- slot ---------------------------------------------------------------
    def run_slot(self, slot, rng: np.random.Generator):
        """One slot across every cell: {cell_id: (dl, tx, ul, grants)} —
        one FAPI stream per cell (the reference drives one
        mac_cell_processor / FAPI message stream per cell)."""
        out = {}
        for cid, cell in self.cells.items():
            dl, tx, ul, grants = cell.run_slot(slot, rng)
            m = self.metrics[cid]
            m.nof_dl_grants += len(dl.pdsch)
            m.nof_ul_grants += len(grants)
            m.dl_bits += sum(p.config.tbs for p in dl.pdsch)
            m.ul_bits += sum(t for _r, _h, t in grants)
            out[cid] = (dl, tx, ul, grants)
        return out

    def handle_results(self, cell_id: int, res) -> None:
        m = self.metrics[cell_id]
        for crc in res.crc:
            if crc.rnti in self.cells[cell_id].ues:
                if crc.tb_crc_ok:
                    m.nof_crc_ok += 1
                else:
                    m.nof_crc_nok += 1
        self.cells[cell_id].handle_results(res)

    def metrics_report(self) -> dict:
        return {cid: m.as_dict() for cid, m in self.metrics.items()}
