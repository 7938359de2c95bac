"""Resource-allocation geometry for PxSCH processors.

Host-side precomputation of RE index sets (data vs DM-RS) for an allocation,
mirroring the role of the reference's bounded_bitset RB/RE mask machinery
(include/srsran/adt/bounded_bitset.h + resource_grid_mapper) — but as static
NumPy index arrays consumed by device gathers/scatters.

The port's own copy of ``srsran_project_tpu/phy/allocation.py`` (the port imports
nothing of the JAX package); tests/test_torch_import.py holds the two
equal value for value.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..ran import dmrs as dmrs_mod
from ..ran.constants import NRE


@dataclasses.dataclass(frozen=True)
class Allocation:
    """Static PxSCH time/frequency allocation (contiguous type-1 style)."""

    rb_start: int
    rb_count: int
    sym_start: int
    sym_count: int
    dmrs_symbols: tuple[int, ...]  # absolute symbol indices carrying DM-RS
    dmrs_config_type: int = 1
    nof_cdm_groups_without_data: int = 2
    # Absolute CRB index of this grid's subcarrier 0.  A compact window grid
    # (multi-UE grant placed by the PDU's first_rb) sets crb_start=first_rb so
    # the DM-RS Gold-sequence index still counts from CRB0 of the carrier
    # (TS 38.211 §7.4.1.1.2 reference point), matching the reference's
    # dmrs_pdsch/pusch generators.  Geometry (rb_start/indices) is unaffected.
    crb_start: int = 0

    @classmethod
    def from_fields(cls, other) -> "Allocation":
        """The port's ``Allocation`` with the fields of ``other`` (the JAX
        package's class, which compares unequal to this one)."""
        kw = {f.name: getattr(other, f.name) for f in dataclasses.fields(cls)}
        kw["dmrs_symbols"] = tuple(kw["dmrs_symbols"])
        return cls(**kw)

    @property
    def nof_sc(self) -> int:
        return self.rb_count * NRE

    @property
    def sc_start(self) -> int:
        return self.rb_start * NRE


@dataclasses.dataclass(frozen=True)
class RePattern:
    """REs a shared channel is rate-matched around, as srsRAN's
    ``re_pattern``: the PRBs it covers, counted on the channel's own grid,
    the REs of each of those PRBs (bit k: subcarrier k, 12 bits) and the
    OFDM symbols (bit l: symbol l, 14 bits)."""

    prbs: tuple[int, ...]
    re_mask: int
    symbol_mask: int


def _reserved_mask(reserved: tuple, nof_symbols: int, nof_sc_grid: int) -> np.ndarray:
    """(nof_symbols, nof_sc_grid) bool: the REs of the patterns."""
    mask = np.zeros((nof_symbols, nof_sc_grid // NRE, NRE), dtype=bool)
    for p in reserved:
        syms = [l for l in range(nof_symbols) if (p.symbol_mask >> l) & 1]
        res = [k for k in range(NRE) if (p.re_mask >> k) & 1]
        mask[np.ix_(syms, list(p.prbs), res)] = True
    return mask.reshape(nof_symbols, nof_sc_grid)


@functools.lru_cache(maxsize=None)
def data_re_indices(alloc: Allocation, nof_symbols: int, nof_sc_grid: int,
                    reserved: tuple = ()) -> np.ndarray:
    """Flat indices (into a (nof_symbols, nof_sc_grid) grid) of the data REs
    of the allocation, in mapping order: subcarrier-major within each symbol,
    symbols ascending (TS 38.211 §7.3.1.5); the REs of the ``reserved``
    patterns (``RePattern``) skipped."""
    out = []
    dmask = dmrs_mod.data_subcarrier_mask(
        alloc.dmrs_config_type, alloc.nof_cdm_groups_without_data
    )
    for sym in range(alloc.sym_start, alloc.sym_start + alloc.sym_count):
        for rb in range(alloc.rb_start, alloc.rb_start + alloc.rb_count):
            for re in range(NRE):
                if sym in alloc.dmrs_symbols and not dmask[re]:
                    continue
                out.append(sym * nof_sc_grid + rb * NRE + re)
    out = np.asarray(out, dtype=np.int32)
    if reserved:
        out = out[~_reserved_mask(reserved, nof_symbols, nof_sc_grid).reshape(-1)[out]]
    return out


@functools.lru_cache(maxsize=None)
def pilot_re_indices(alloc: Allocation, port: int, nof_sc_grid: int):
    """(flat grid indices (nsym_d, Np), wf (Np,), pair_positions, seq_idx (Np,)).

    seq_idx is the Gold-sequence pilot index m = 2n + k' of each pilot
    (TS 38.211 §7.4.1.1.2), counted from the grid's first subcarrier
    (reference point = CRB0 of this grid).
    """
    ks, wf = dmrs_mod.pilot_subcarriers(
        alloc.dmrs_config_type, port, alloc.rb_count, alloc.rb_start
    )
    idx = np.stack([sym * nof_sc_grid + ks for sym in alloc.dmrs_symbols])
    # Pair centers relative to allocation start (for interpolation).
    pair_pos = tuple(
        float((ks[2 * i] + ks[2 * i + 1]) / 2 - alloc.sc_start) for i in range(len(ks) // 2)
    )
    # Sequence index: pilots per PRB counted from CRB0 of the carrier
    # (crb_start repoints compact window grids to their absolute CRB).
    ppb = dmrs_mod.pilots_per_prb(alloc.dmrs_config_type)
    seq_idx = (alloc.crb_start + alloc.rb_start) * ppb + np.arange(len(ks), dtype=np.int32)
    return idx.astype(np.int32), wf, pair_pos, seq_idx


def nof_data_re(alloc: Allocation) -> int:
    full = alloc.rb_count * NRE * alloc.sym_count
    dmask = dmrs_mod.data_subcarrier_mask(
        alloc.dmrs_config_type, alloc.nof_cdm_groups_without_data
    )
    lost = int((~dmask).sum()) * alloc.rb_count * len(
        [s for s in alloc.dmrs_symbols if alloc.sym_start <= s < alloc.sym_start + alloc.sym_count]
    )
    return full - lost
