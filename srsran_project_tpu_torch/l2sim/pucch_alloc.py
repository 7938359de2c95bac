"""PUCCH resource allocation with collision management.

Counterpart of the reference's lib/scheduler/pucch_scheduling/
(pucch_allocator_impl + pucch_resource_manager + pucch_collision_manager):

- per-cell PUCCH resource lists: set 0 (F1, <= 2 HARQ bits) indexed by the
  DCI's PUCCH resource indicator, set 1 (F2, > 2 bits or ACK+CSI),
  dedicated SR (F1) and CSI (F2) resources per UE;
- per-slot grid collision tracking over (PRB, symbol) cells;
- the reference's multiplexing ladder: HARQ on F1 via PRI -> adding SR
  keeps F1 -> exceeding 2 bits or adding CSI moves the UE to its F2
  resource (one PUCCH per UE per slot).

A copy of ``srsran_project_tpu/l2sim/pucch_alloc.py``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PucchResource:
    id: int
    format: int  # 0, 1 or 2
    prb: int
    start_symbol: int
    nof_symbols: int
    # F0/F1:
    initial_cyclic_shift: int = 0
    occ_index: int = 0
    # F2:
    rb_count: int = 1
    max_uci_bits: int = 8

    def prbs(self) -> set:
        return set(range(self.prb, self.prb + (self.rb_count if self.format == 2 else 1)))

    def cells(self) -> set:
        return {(rb, s) for rb in self.prbs()
                for s in range(self.start_symbol, self.start_symbol + self.nof_symbols)}


@dataclasses.dataclass(frozen=True)
class PucchCellConfig:
    # Resource set 0: F1 resources selected by the DCI PUCCH resource
    # indicator (TS 38.213 §9.2.3); up to 8 entries.
    set0: tuple
    # Resource set 1: F2 resources for payloads > 2 bits.
    set1: tuple
    # Dedicated periodic resources.
    sr_resource: PucchResource | None = None
    csi_resource: PucchResource | None = None
    sr_period_slots: int = 10
    csi_period_slots: int = 20


@dataclasses.dataclass
class PucchGrant:
    rnti: int
    resource: PucchResource
    nof_harq_bits: int = 0
    sr: bool = False
    nof_csi_bits: int = 0

    @property
    def uci_bits(self) -> int:
        return self.nof_harq_bits + (1 if self.sr else 0) + self.nof_csi_bits


class PucchSlotAllocator:
    """Allocates/multiplexes PUCCH for one UL slot (one PUCCH per UE).

    Mirrors pucch_allocator_impl's decision ladder; same-cell F0/F1
    resources with different cyclic shift / OCC are code-multiplexed and
    do not collide; F2 collisions are blocking.
    """

    def __init__(self, cfg: PucchCellConfig) -> None:
        self.cfg = cfg
        self.grants: dict[int, PucchGrant] = {}
        self._f2_cells: set = set()

    # -- internal ----------------------------------------------------------

    def _f2_free(self, res: PucchResource, ignore: PucchGrant | None = None) -> bool:
        cells = res.cells()
        used = set(self._f2_cells)
        if ignore is not None and ignore.resource.format == 2:
            used -= ignore.resource.cells()
        # F2 cannot share cells with F0/F1 either.
        for g in self.grants.values():
            if g is ignore:
                continue
            if g.resource.format != 2 and cells & g.resource.cells():
                return False
        return not (cells & used)

    def _f1_free(self, res: PucchResource, rnti: int) -> bool:
        for g in self.grants.values():
            if g.rnti == rnti:
                continue
            r = g.resource
            if r.format == 2:
                if res.cells() & r.cells():
                    return False
            else:
                same_cell = res.prb == r.prb and res.start_symbol == r.start_symbol
                if same_cell and res.initial_cyclic_shift == r.initial_cyclic_shift \
                        and res.occ_index == r.occ_index and res.format == r.format:
                    return False  # identical code resource
        return True

    def _commit(self, grant: PucchGrant) -> PucchGrant:
        old = self.grants.get(grant.rnti)
        if old is not None and old.resource.format == 2:
            self._f2_cells -= old.resource.cells()
        self.grants[grant.rnti] = grant
        if grant.resource.format == 2:
            self._f2_cells |= grant.resource.cells()
        return grant

    def _move_to_f2(self, rnti: int, harq: int, sr: bool, csi: int) -> PucchGrant | None:
        old = self.grants.get(rnti)
        for res in self.cfg.set1:
            if harq + (1 if sr else 0) + csi > res.max_uci_bits:
                continue
            if self._f2_free(res, ignore=old):
                return self._commit(PucchGrant(rnti, res, harq, sr, csi))
        return None

    # -- public ------------------------------------------------------------

    def alloc_harq_ack(self, rnti: int, pri: int, nof_bits: int = 1) -> PucchGrant | None:
        """HARQ-ACK resource via the DCI PUCCH resource indicator; grows an
        existing grant (SR/CSI/more ACKs) per the multiplexing ladder."""
        g = self.grants.get(rnti)
        harq = (g.nof_harq_bits if g else 0) + nof_bits
        sr = g.sr if g else False
        csi = g.nof_csi_bits if g else 0
        if harq <= 2 and csi == 0:
            res = self.cfg.set0[pri % len(self.cfg.set0)]
            if self._f1_free(res, rnti):
                return self._commit(PucchGrant(rnti, res, harq, sr, csi))
            return None
        return self._move_to_f2(rnti, harq, sr, csi)

    def alloc_sr(self, rnti: int) -> PucchGrant | None:
        g = self.grants.get(rnti)
        if g is None:
            res = self.cfg.sr_resource
            if res is None or not self._f1_free(res, rnti):
                return None
            return self._commit(PucchGrant(rnti, res, 0, True, 0))
        if g.resource.format == 2 or g.nof_harq_bits + 1 + g.nof_csi_bits > 2:
            return self._move_to_f2(rnti, g.nof_harq_bits, True, g.nof_csi_bits)
        return self._commit(PucchGrant(rnti, g.resource, g.nof_harq_bits, True, g.nof_csi_bits))

    def alloc_csi(self, rnti: int, nof_bits: int) -> PucchGrant | None:
        g = self.grants.get(rnti)
        if g is None:
            res = self.cfg.csi_resource
            if res is not None and nof_bits <= res.max_uci_bits and self._f2_free(res):
                return self._commit(PucchGrant(rnti, res, 0, False, nof_bits))
            return self._move_to_f2(rnti, 0, False, nof_bits)
        return self._move_to_f2(rnti, g.nof_harq_bits, g.sr, nof_bits)

    def remove_ue(self, rnti: int) -> None:
        """Drop a UE's PUCCH (UCI moved onto PUSCH)."""
        g = self.grants.pop(rnti, None)
        if g is not None and g.resource.format == 2:
            self._f2_cells -= g.resource.cells()


def default_pucch_cell_config(nof_prb: int) -> PucchCellConfig:
    """A practical cell resource map: 8 F1 resources (CS-multiplexed on the
    band edges) + 4 F2 resources + SR/CSI, like the reference's default
    cell_configuration PUCCH builder."""
    set0 = tuple(
        PucchResource(id=i, format=1, prb=(0 if i < 4 else nof_prb - 1),
                      start_symbol=0, nof_symbols=14,
                      initial_cyclic_shift=3 * (i % 4), occ_index=0)
        for i in range(8)
    )
    set1 = tuple(
        PucchResource(id=8 + i, format=2, prb=(1 if i < 2 else nof_prb - 2),
                      start_symbol=12 + (i % 2), nof_symbols=1, rb_count=1,
                      max_uci_bits=11)
        for i in range(4)
    )
    sr = PucchResource(id=12, format=1, prb=0, start_symbol=0, nof_symbols=14,
                       initial_cyclic_shift=9, occ_index=1)
    csi = PucchResource(id=13, format=2, prb=nof_prb - 3, start_symbol=12,
                        nof_symbols=2, rb_count=1, max_uci_bits=11)
    return PucchCellConfig(set0=set0, set1=set1, sr_resource=sr, csi_resource=csi)
