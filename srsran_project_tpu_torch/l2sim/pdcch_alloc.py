"""CCE-level PDCCH resource allocation.

Counterpart of the reference's lib/scheduler/pdcch_scheduling/
(pdcch_resource_allocator_impl) + lib/ran/pdcch/pdcch_candidates.cpp:
CORESET/search-space model, TS 38.213 §10.1 candidate generation (exact
reference formulas, golden-tested), and per-slot CCE collision tracking
with candidate fallback.  A copy of ``srsran_project_tpu/l2sim/pdcch_alloc.py``.
"""

from __future__ import annotations

import dataclasses
import functools

AGGREGATION_LEVELS = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class CoresetConfig:
    id: int
    rb_start: int
    nof_rbs: int  # multiple of 6
    duration: int  # 1-3 OFDM symbols

    @property
    def nof_cces(self) -> int:
        return self.nof_rbs * self.duration // 6


@dataclasses.dataclass(frozen=True)
class SearchSpaceConfig:
    id: int
    coreset_id: int
    is_common: bool
    # Candidates per aggregation level {1, 2, 4, 8, 16}.
    nof_candidates: tuple = (0, 0, 2, 2, 0)
    monitoring_period_slots: int = 1
    monitoring_offset: int = 0

    def candidates_for(self, al: int) -> int:
        return self.nof_candidates[AGGREGATION_LEVELS.index(al)]


def _y_p(a_p: int, d: int, rnti: int, n: int) -> int:
    """Y_{p,n} recursion (TS 38.213 §10.1; reference
    pdcch_candidates.cpp:50-57)."""
    y = rnti
    for _ in range(n + 1):
        y = (a_p * y) % d
    return y


@functools.lru_cache(maxsize=None)
def candidates_lowest_cce(
    al: int, nof_candidates: int, nof_cce_coreset: int,
    is_common: bool, coreset_id: int = 0, rnti: int = 0, slot_index: int = 0,
) -> tuple:
    """Lowest CCE index of each PDCCH candidate (reference
    pdcch_candidates.cpp:27-48 exact formulas)."""
    if nof_candidates == 0:
        return ()
    if al > nof_cce_coreset:
        return ()
    if is_common:
        y_p = 0
    else:
        a_p_values = (39827, 39829, 39839)
        a_p = a_p_values[coreset_id % 3]
        y_p = _y_p(a_p, 65537, rnti, slot_index)
    n_ci = 0
    out = []
    for cand in range(nof_candidates):
        n_cce = al * ((y_p + (cand * nof_cce_coreset) // (al * nof_candidates) + n_ci)
                      % (nof_cce_coreset // al))
        out.append(n_cce)
    return tuple(out)


@dataclasses.dataclass
class PdcchGrant:
    rnti: int
    search_space_id: int
    coreset_id: int
    aggregation_level: int
    cce_index: int
    candidate_index: int


class PdcchSlotAllocator:
    """Per-slot CCE occupancy across CORESETs; allocates DCIs by walking
    each RNTI's candidate list and skipping colliding candidates
    (reference pdcch_slot_resource_allocator.cpp model)."""

    def __init__(self, coresets: dict, search_spaces: dict) -> None:
        self.coresets = coresets
        self.search_spaces = search_spaces
        self._used: dict[int, set[int]] = {cs: set() for cs in coresets}
        self.grants: list[PdcchGrant] = []

    def alloc_dci(self, rnti: int, search_space_id: int, aggregation_level: int,
                  slot_index: int = 0) -> PdcchGrant | None:
        ss = self.search_spaces[search_space_id]
        cs = self.coresets[ss.coreset_id]
        cands = candidates_lowest_cce(
            aggregation_level, ss.candidates_for(aggregation_level), cs.nof_cces,
            ss.is_common, cs.id, rnti, slot_index,
        )
        used = self._used[cs.id]
        for cand_idx, n_cce in enumerate(cands):
            cces = set(range(n_cce, n_cce + aggregation_level))
            if cces & used:
                continue
            used |= cces
            grant = PdcchGrant(rnti=rnti, search_space_id=search_space_id,
                               coreset_id=cs.id, aggregation_level=aggregation_level,
                               cce_index=n_cce, candidate_index=cand_idx)
            self.grants.append(grant)
            return grant
        return None

    def nof_used_cces(self, coreset_id: int) -> int:
        return len(self._used[coreset_id])

    def cancel(self, grant: PdcchGrant) -> None:
        """Release a grant's CCEs (reference cancel_last_pdcch analogue)."""
        self._used[grant.coreset_id] -= set(
            range(grant.cce_index, grant.cce_index + grant.aggregation_level)
        )
        self.grants.remove(grant)
