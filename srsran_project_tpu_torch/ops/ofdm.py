"""OFDM modulation / demodulation of one slot (TS 38.211 §5.3-5.4).

Port of ``srsran_project_tpu/ops/ofdm.py`` with ``torch.fft`` for the
(I)DFTs.  The reference's two-stage matmul DFT was a TPU workaround and
is left out.  ``demodulate_slot`` takes the reference's intra-CP window
offsets (a fraction of each CP, or a fixed number of samples), each
compensated by a linear phase ramp over the subcarriers.

Conventions (as the reference): grid axes (..., nsym, nsc), subcarrier k
at (k - nsc/2) * scs from the carrier centre; modulate = sqrt(N) * ifft
(scale 1/sqrt(N), unitary pair) then the per-symbol phase compensation
exp(-j 2 pi f_c t_l); demodulate applies the conjugate.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ran.constants import (
    NRE,
    CyclicPrefix,
    SubcarrierSpacing,
    cp_lengths,
    nof_symbols_per_slot,
    sampling_rate_hz,
)

from ..support.tracing import l1_tracer
from ._tables import device_table


@functools.lru_cache(maxsize=None)
def _slot_geometry(scs: SubcarrierSpacing, dft_size: int, cp: CyclicPrefix,
                   slot_in_subframe: int):
    """Per-symbol (cp_len, t_start_useful_seconds) for one slot."""
    nsym = nof_symbols_per_slot(cp)
    all_cps = cp_lengths(scs, dft_size, cp)
    fs = sampling_rate_hz(scs, dft_size)
    starts = np.cumsum([0] + [c + dft_size for c in all_cps])[:-1]
    sel = slice(slot_in_subframe * nsym, (slot_in_subframe + 1) * nsym)
    t_useful = [(starts[i] + all_cps[i]) / fs for i in range(*sel.indices(len(all_cps)))]
    return tuple(all_cps[sel]), tuple(t_useful)


@functools.lru_cache(maxsize=None)
def _phase_comp(scs: SubcarrierSpacing, dft_size: int, cp: CyclicPrefix,
                slot_in_subframe: int, f_center_hz: float) -> np.ndarray:
    """(nsym,) complex64 TX phase-compensation coefficients exp(-j2pi fc t_l),
    with the cycle count reduced mod 1 in float64 first."""
    _, t_useful = _slot_geometry(scs, dft_size, cp, slot_in_subframe)
    cycles = np.array([f_center_hz * t for t in t_useful], dtype=np.float64)
    frac = cycles - np.round(cycles)
    return np.exp(-2j * np.pi * frac).astype(np.complex64)


def slot_nof_samples(scs: SubcarrierSpacing, dft_size: int, cp: CyclicPrefix,
                     slot_in_subframe: int) -> int:
    cps, _ = _slot_geometry(scs, dft_size, cp, slot_in_subframe)
    return sum(cps) + len(cps) * dft_size


def _cp_index(scs, dft_size, cp, slot_in_subframe) -> np.ndarray:
    """Output sample -> flat (symbol, intra-symbol) index: CP then body."""
    cps, _ = _slot_geometry(scs, dft_size, cp, slot_in_subframe)
    rows = []
    for l, c in enumerate(cps):
        rows.append(l * dft_size + np.arange(dft_size - c, dft_size))
        rows.append(l * dft_size + np.arange(dft_size))
    return np.concatenate(rows).astype(np.int64)


def _window_advances(scs, dft_size, cp, slot_in_subframe, window_offset: float,
                     window_offset_samples) -> np.ndarray:
    """(nsym,) samples by which each symbol's DFT window starts early,
    inside its CP: a fixed count, or the fraction of each CP."""
    cps, _ = _slot_geometry(scs, dft_size, cp, slot_in_subframe)
    if window_offset_samples is not None:
        return np.full(len(cps), int(window_offset_samples), np.int64)
    return np.asarray([int(window_offset * c) for c in cps], np.int64)


def _body_index(scs, dft_size, cp, slot_in_subframe, window_offset: float = 0.0,
                window_offset_samples=None) -> np.ndarray:
    """(nsym, dft) sample index of each symbol's DFT window: its useful
    part, started early by ``_window_advances``."""
    cps, _ = _slot_geometry(scs, dft_size, cp, slot_in_subframe)
    starts = np.cumsum([0] + [c + dft_size for c in cps])[:-1] + np.asarray(cps)
    starts = starts - _window_advances(scs, dft_size, cp, slot_in_subframe, window_offset,
                                       window_offset_samples)
    return (starts[:, None] + np.arange(dft_size)[None, :]).astype(np.int64)


def _window_correction(nsc: int, scs, dft_size, cp, slot_in_subframe, window_offset: float,
                       window_offset_samples) -> np.ndarray:
    """(nsym, nsc) complex64: a window advanced by adv samples rotates the
    signed subcarrier k by exp(-j 2 pi k adv / N); this undoes it."""
    advs = _window_advances(scs, dft_size, cp, slot_in_subframe, window_offset,
                            window_offset_samples)
    k = np.arange(nsc) - nsc // 2
    return np.stack([np.exp(2j * np.pi * k * adv / dft_size) for adv in advs]).astype(np.complex64)


_cp_index_on = device_table(_cp_index)
_body_index_on = device_table(_body_index)
_phase_on = device_table(_phase_comp)
_window_correction_on = device_table(_window_correction)


def modulate_slot(grid: torch.Tensor, scs: SubcarrierSpacing = SubcarrierSpacing.KHZ30,
                  dft_size: int = 1024, cp: CyclicPrefix = CyclicPrefix.NORMAL,
                  slot_in_subframe: int = 0, f_center_hz: float = 0.0) -> torch.Tensor:
    """Grid (..., nsym, nsc) complex64 -> samples (..., slot_nof_samples)."""
    with l1_tracer.span("ofdm.modulate"):
        nsym, nsc = grid.shape[-2], grid.shape[-1]
        assert nsym == nof_symbols_per_slot(cp)
        assert nsc <= dft_size and nsc % 2 == 0
        half = nsc // 2
        dev = grid.device
        spec = torch.zeros(grid.shape[:-1] + (dft_size,), dtype=torch.complex64, device=dev)
        spec[..., :half] = grid[..., half:]
        spec[..., dft_size - half :] = grid[..., :half]
        gain = float(np.float32(dft_size * (1.0 / np.sqrt(dft_size))))
        x = torch.fft.ifft(spec, dim=-1) * gain
        x = x * _phase_on(dev, scs, dft_size, cp, slot_in_subframe, f_center_hz)[:, None]
        flat = x.reshape(x.shape[:-2] + (nsym * dft_size,))
        return flat[..., _cp_index_on(dev, scs, dft_size, cp, slot_in_subframe)]


def demodulate_slot(samples: torch.Tensor, nof_rb: int,
                    scs: SubcarrierSpacing = SubcarrierSpacing.KHZ30,
                    dft_size: int = 1024, cp: CyclicPrefix = CyclicPrefix.NORMAL,
                    slot_in_subframe: int = 0, f_center_hz: float = 0.0,
                    window_offset: float = 0.0,
                    window_offset_samples: int | None = None) -> torch.Tensor:
    """Samples (..., slot_nof_samples) -> grid (..., nsym, nof_rb*12).

    window_offset in [0, 1): start each symbol's DFT window that fraction
    of its CP early (the reference's intra-CP window); or
    window_offset_samples: a fixed advance for every symbol (below the
    shortest CP).  Either is compensated per subcarrier."""
    with l1_tracer.span("ofdm.demodulate"):
        nsc = nof_rb * NRE
        dev = samples.device
        win = (float(window_offset), window_offset_samples)
        x = samples[..., _body_index_on(dev, scs, dft_size, cp, slot_in_subframe, *win)]
        x = x * _phase_on(dev, scs, dft_size, cp, slot_in_subframe, f_center_hz).conj()[:, None]
        gain = float(np.float32(dft_size * (1.0 / np.sqrt(dft_size))))
        spec = torch.fft.fft(x, dim=-1) / gain
        half = nsc // 2
        grid = torch.cat([spec[..., dft_size - half :], spec[..., :half]], dim=-1)
        if window_offset or window_offset_samples:
            grid = grid * _window_correction_on(dev, nsc, scs, dft_size, cp, slot_in_subframe,
                                                *win)
        return grid
