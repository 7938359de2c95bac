"""PT-RS (TS 38.211 §7.4.1.2) and PRS (TS 38.211 §7.4.1.7) generators,
and the PRS time-of-arrival estimate.

Port of ``srsran_project_tpu/phy/ptrs_prs.py``.  PT-RS reuses the PDSCH
DM-RS sequence on one subcarrier of every K-th allocated PRB; PRS is a
Gold-sequence QPSK signal on a comb across several symbols, its sequence
counted from Point A.  The pilots are host plans per config (float64
LFSR), uploaded once per device.

``prs_toa_estimate`` advances its pilot sequence by ``rb_start`` PRBs'
worth, as ``generate_prs`` does; the reference's estimator starts it at
PRB 0 and so reads a grid with ``rb_start`` > 0 against the wrong
pilots (ROADMAP Q3).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import scrambling
from ..ops._tables import device_table
from ..ran import dmrs as dmrs_mod
from ..ran.constants import NRE


@dataclasses.dataclass(frozen=True)
class PtrsConfig:
    """Twin of the reference's ``PtrsConfig``."""

    rb_start: int
    rb_count: int
    symbols: tuple[int, ...]  # PT-RS time positions (every L_PTRS-th data symbol)
    k_ptrs: int = 2  # frequency density: one RE every K_PTRS PRBs
    re_offset: int = 0
    scrambling_id: int = 0
    n_scid: int = 0
    slot_in_frame: int = 0
    nof_grid_sc: int = 624
    nof_grid_symbols: int = 14

    @classmethod
    def from_reference(cls, ref) -> "PtrsConfig":
        kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)}
        return cls(**dict(kw, symbols=tuple(kw["symbols"])))


def _qpsk(c: np.ndarray) -> np.ndarray:
    """Gold bits (2n,) -> n QPSK pilots, complex64."""
    c = c.astype(np.float32)
    return (((1.0 - 2.0 * c[0::2]) + 1j * (1.0 - 2.0 * c[1::2])) / np.sqrt(2)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _ptrs_plan(cfg: PtrsConfig):
    """(flat grid index (Nptrs,), pilot values (Nptrs,)), symbol-major."""
    prbs = np.arange(cfg.rb_start, cfg.rb_start + cfg.rb_count, cfg.k_ptrs)
    ks = prbs * NRE + cfg.re_offset
    # The PT-RS RE reuses r(m) of the type-1 DM-RS on the same subcarrier.
    seq_idx = prbs * 6 + cfg.re_offset // 2
    nseq = int(seq_idx.max()) + 1
    idx, vals = [], []
    for sym in cfg.symbols:
        c_init = dmrs_mod.dmrs_c_init(cfg.slot_in_frame, sym, cfg.scrambling_id, cfg.n_scid)
        idx.append(sym * cfg.nof_grid_sc + ks)
        vals.append(_qpsk(scrambling.gold_ref(int(c_init), 2 * nseq))[seq_idx])
    return np.concatenate(idx).astype(np.int64), np.concatenate(vals)


_ptrs_on = device_table(lambda cfg, which: _ptrs_plan(cfg)[which])


def generate_ptrs(cfg: PtrsConfig, device: torch.device | str = "cuda") -> torch.Tensor:
    """PT-RS contribution as a (nsym, nsc) single-layer complex64 grid on
    ``device``."""
    device = torch.device(device)
    grid = torch.zeros(cfg.nof_grid_symbols * cfg.nof_grid_sc, dtype=torch.complex64,
                       device=device)
    grid[_ptrs_on(device, cfg, 0)] = _ptrs_on(device, cfg, 1)
    return grid.reshape(cfg.nof_grid_symbols, cfg.nof_grid_sc)


@dataclasses.dataclass(frozen=True)
class PrsConfig:
    """Twin of the reference's ``PrsConfig``."""

    rb_start: int
    rb_count: int
    start_symbol: int
    nof_symbols: int  # 2, 4, 6, 12
    comb_size: int = 4  # K in {2, 4, 6, 12}
    comb_offset: int = 0
    n_id_prs: int = 0
    slot_in_frame: int = 0
    nof_grid_sc: int = 624
    nof_grid_symbols: int = 14

    @classmethod
    def from_reference(cls, ref) -> "PrsConfig":
        return cls(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)})


# Relative RE offsets per symbol within the comb pattern (TS 38.211 Table
# 7.4.1.7.3-1, comb sizes 2/4/6/12).
_PRS_OFFSETS = {
    2: (0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1),
    4: (0, 2, 1, 3, 0, 2, 1, 3, 0, 2, 1, 3),
    6: (0, 3, 1, 4, 2, 5, 0, 3, 1, 4, 2, 5),
    12: (0, 6, 3, 9, 1, 7, 4, 10, 2, 8, 5, 11),
}


def _prs_c_init(cfg: PrsConfig, symbol: int) -> int:
    """The symbol's sequence seed, reduced to 31 bits."""
    n = cfg.n_id_prs
    return ((1 << 22) * (n // 1024)
            + (1 << 10) * (14 * cfg.slot_in_frame + symbol + 1) * (2 * (n % 1024) + 1)
            + (n % 1024)) % (1 << 31)


@functools.lru_cache(maxsize=None)
def _prs_plan(cfg: PrsConfig):
    """(grid symbol of each PRS symbol (nsym,), their comb subcarriers
    (nsym, per_sym), their pilots (nsym, per_sym) complex64).  The pilot
    index counts from Point A: rb_start PRBs' worth of pilots are skipped
    (reference prs_generator_impl.cpp:77)."""
    per_sym = cfg.rb_count * NRE // cfg.comb_size
    skip = cfg.rb_start * (NRE // cfg.comb_size)
    offsets = _PRS_OFFSETS[cfg.comb_size]
    syms, ks, pilots = [], [], []
    for i in range(cfg.nof_symbols):
        sym = cfg.start_symbol + i
        koff = (cfg.comb_offset + offsets[i % len(offsets)]) % cfg.comb_size
        syms.append(sym)
        ks.append(cfg.rb_start * NRE + koff + cfg.comb_size * np.arange(per_sym))
        pilots.append(_qpsk(scrambling.gold_ref(_prs_c_init(cfg, sym), 2 * (skip + per_sym))
                            [2 * skip :]))
    return np.asarray(syms, np.int64), np.stack(ks).astype(np.int64), np.stack(pilots)


_prs_on = device_table(lambda cfg, which: _prs_plan(cfg)[which])


def generate_prs(cfg: PrsConfig, device: torch.device | str = "cuda") -> torch.Tensor:
    """PRS contribution as a (nsym, nsc) single-port complex64 grid on
    ``device``."""
    device = torch.device(device)
    grid = torch.zeros((cfg.nof_grid_symbols, cfg.nof_grid_sc), dtype=torch.complex64,
                       device=device)
    grid[_prs_on(device, cfg, 0)[:, None], _prs_on(device, cfg, 1)] = _prs_on(device, cfg, 2)
    return grid


def prs_toa_estimate(rx_grid: torch.Tensor, cfg: PrsConfig, dft_size: int = 4096) -> dict:
    """UE-side DL-PRS time of arrival and RSRP from a (nsym, nsc) grid.

    Per PRS symbol the LS channel at the comb REs; the staggered comb
    offsets fill the subcarrier grid, so the symbols' LS values go into
    one spectrum of dft_size bins (a static channel over the PRS) and one
    IDFT gives the delay profile; its peak, refined by a parabola, is the
    delay in samples of the dft_size domain (above dft_size / 2:
    negative).  Returns a dict of 0-dim tensors: toa_samples, rsrp and
    peak_power (the peak over the profile's mean)."""
    dev = rx_grid.device
    syms, ks, pilots = (_prs_on(dev, cfg, i) for i in range(3))
    h = rx_grid[syms[:, None], ks] * pilots.conj()  # (nsym, per_sym)
    rsrp = (h.abs() ** 2).mean(dim=-1).sum() / cfg.nof_symbols
    # The symbols' bins collide (index_add_ on the card adds in no fixed
    # order: equal within float rounding, not bitwise).
    spread = torch.zeros(dft_size, dtype=torch.complex64, device=dev).index_add_(
        0, (ks % dft_size).reshape(-1), h.reshape(-1))
    pdp = torch.fft.ifft(spread).abs() ** 2
    peak = torch.argmax(pdp)
    y0, y1, y2 = pdp[(peak - 1) % dft_size], pdp[peak], pdp[(peak + 1) % dft_size]
    frac = 0.5 * (y0 - y2) / (y0 - 2 * y1 + y2 + 1e-12)
    toa = (peak.to(torch.float32) + frac) % dft_size
    toa = torch.where(toa > dft_size / 2, toa - dft_size, toa)
    return {"toa_samples": toa, "rsrp": rsrp, "peak_power": y1 / (pdp.mean() + 1e-12)}
