"""Lower-PHY sample-domain helpers: amplitude control and PRACH OFDM
demodulation.

Port of ``srsran_project_tpu/ops/lower_phy.py``: ``amplitude_control``
(gain, envelope clipping and its power metrics), ``prach_window_params``
(the occasion's window geometry per TS 38.211 §5.3.2 with the 16-kappa
boundary extensions, host integers) and ``prach_demodulate`` (the
preamble symbols' DFTs through ``torch.fft``, averaged, and the L_RA
preamble subcarriers gathered).  ``PRACH_PREAMBLES`` is the one table of
preamble formats; ``phy.prach`` reads it too.
"""

from __future__ import annotations

import numpy as np
import torch

from ._tables import device_table


def amplitude_control(samples: torch.Tensor, gain_db: float = 0.0, full_scale: float = 1.0,
                      ceiling_db: float = -0.1, enable_clipping: bool = True):
    """Apply the gain and (optionally) clip the complex envelope at the
    ceiling.  Returns (samples, metrics dict of avg_power_dbfs,
    peak_power_dbfs and clipping_prob, 0-dim float32 tensors)."""
    g = float(np.float32(10.0 ** (np.float32(gain_db) / np.float32(20.0))))
    x = samples * g
    mag = x.abs()
    avg_pw = (mag**2).mean()
    peak_pw = (mag**2).max()
    ceiling = full_scale * float(np.float32(10.0 ** (np.float32(ceiling_db) / np.float32(20.0))))
    clipped = mag > ceiling
    if enable_clipping:
        x = x * torch.where(clipped, ceiling / torch.clamp_min(mag, 1e-12), 1.0)
    metrics = {
        "avg_power_dbfs": 10.0 * torch.log10(torch.clamp_min(avg_pw, 1e-12) / full_scale**2),
        "peak_power_dbfs": 10.0 * torch.log10(torch.clamp_min(peak_pw, 1e-12) / full_scale**2),
        "clipping_prob": clipped.to(torch.float32).mean(),
    }
    return x, metrics


# PRACH preamble formats: (CP length in kappa units, nof_symbols, preamble
# SCS in Hz, None for the short formats, whose SCS is the PUSCH's); TS
# 38.211 Tables 6.3.3.1-1/2 (reference
# lib/ran/prach/prach_preamble_information.cpp).
PRACH_PREAMBLES = {
    "0": (3168, 1, 1250.0),
    "1": (21024, 2, 1250.0),
    "2": (4688, 4, 1250.0),
    "3": (3168, 4, 5000.0),
    "A1": (288, 2, None),
    "A2": (576, 4, None),
    "A3": (864, 6, None),
    "B1": (216, 2, None),
    "B4": (936, 12, None),
    "C0": (1240, 1, None),
    "C2": (2048, 4, None),
}

# Occasion duration in PUSCH symbols (reference prach_format_type.h
# get_preamble_duration; long formats occupy the whole window).
PRACH_DURATION_SYMBOLS = {"A1": 2, "B1": 2, "C0": 2, "A2": 4, "A3": 6,
                          "C2": 6, "B4": 12, "0": 0, "1": 0, "2": 0, "3": 0}

# (prach_scs_hz, pusch_scs_hz) -> (nof_rb_ra, k_bar); TS 38.211 Table
# 6.3.3.2-1 (reference lib/ran/prach/prach_frequency_mapping.cpp).
PRACH_FREQ_MAPPING = {
    (1250, 15000): (6, 7), (1250, 30000): (3, 1), (1250, 60000): (2, 133),
    (5000, 15000): (24, 12), (5000, 30000): (12, 10), (5000, 60000): (6, 7),
    (15000, 15000): (12, 2), (15000, 30000): (6, 2), (15000, 60000): (3, 2),
    (30000, 15000): (24, 2), (30000, 30000): (12, 2), (30000, 60000): (6, 2),
    (60000, 60000): (12, 2), (60000, 120000): (6, 2),
    (120000, 60000): (24, 2), (120000, 120000): (12, 2),
}

KAPPA_S = 64.0 / (480e3 * 4096)  # kappa = 64 Tc, seconds


def prach_window_params(fmt: str, pusch_scs_hz: int, slot_in_subframe: int,
                        start_symbol: int, td_occasion: int, srate_hz: float,
                        rb_offset: int, fd_occasion: int, nof_prb_ul_grid: int,
                        l_ra: int) -> dict:
    """PRACH occasion window geometry per TS 38.211 §5.3.2 as the
    reference computes it (ofdm_prach_demodulator_impl.cpp:79-147): the
    sample offset within the slot window, the CP length with the 16-kappa
    boundary extensions, the DFT size at the preamble SCS, the number of
    repeated symbols, and the DC-relative bin k_offset of the first
    preamble subcarrier."""
    cp_kappa, nof_symbols, ra_scs = PRACH_PREAMBLES[fmt]
    mu = {15000: 0, 30000: 1, 60000: 2, 120000: 3}[pusch_scs_hz]
    if ra_scs is None:
        # Short preamble: the SCS follows the numerology, and the tabulated
        # CP lengths (mu = 0 kappa units) scale by 2^-mu.
        ra_scs = float(pusch_scs_hz)
        cp_kappa >>= mu
    sym_kappa = (144 + 2048) >> mu  # PUSCH symbol with its CP, kappa
    ra_sym_kappa = int(round(30720000.0 / ra_scs))  # one preamble symbol

    dur_sym = PRACH_DURATION_SYMBOLS[fmt]
    t_occ_start_k = sym_kappa * (start_symbol + dur_sym * td_occasion)
    t_slot_start_k = sym_kappa * 14 * slot_in_subframe

    half_ms_k = int(round(0.5e-3 / KAPPA_S))
    # Window start correction (1.25/5/15/30 kHz preamble SCS).
    if ra_scs in (1250.0, 5000.0, 15000.0, 30000.0):
        if t_occ_start_k > 0:
            t_occ_start_k += 16
        if t_occ_start_k > half_ms_k:
            t_occ_start_k += 16
    # CP extension when a short-preamble occasion overlaps the subframe
    # start or its midpoint.
    if ra_scs in (15000.0, 30000.0, 60000.0, 120000.0):
        t_ra_start_k = t_occ_start_k + t_slot_start_k
        t_ra_end_k = t_ra_start_k + cp_kappa + nof_symbols * ra_sym_kappa
        if t_ra_start_k <= 0 <= t_ra_end_k:
            cp_kappa += 16
        if t_ra_start_k <= half_ms_k <= t_ra_end_k:
            cp_kappa += 16

    dft_size = int(round(srate_hz / ra_scs))
    k_ratio = int(round(pusch_scs_hz / ra_scs))
    nof_rb_ra, k_bar = PRACH_FREQ_MAPPING[(int(ra_scs), pusch_scs_hz)]
    grid = nof_prb_ul_grid * k_ratio * 12
    k_start = k_ratio * 12 * (rb_offset + nof_rb_ra * fd_occasion) + k_bar
    return {
        "sample_offset": int(round(t_occ_start_k * KAPPA_S * srate_hz)),
        "cp_samples": int(round(cp_kappa * KAPPA_S * srate_hz)),
        "dft_size": dft_size,
        "nof_symbols": nof_symbols,
        # Bin of the first preamble subcarrier relative to DC (mod dft):
        # grid subcarrier k_start with the grid centred on DC.
        "k_offset": (k_start - grid // 2) % dft_size,
        "l_ra": l_ra,
    }


_bins_on = device_table(lambda k_offset, l_ra, dft_size: (
    (k_offset + np.arange(l_ra)) % dft_size).astype(np.int64))


def prach_demodulate(samples: torch.Tensor, l_ra: int = 839, dft_size: int = 4096,
                     nof_symbols: int = 1, cp_samples: int = 3168,
                     k_offset: int = 0) -> torch.Tensor:
    """The frequency-domain PRACH preamble from time samples.

    samples: (..., >= cp_samples + nof_symbols*dft_size) complex64 at the
    PRACH sampling rate.  Each repeated symbol's DFT (scaled by
    1/sqrt(dft_size)); the symbols are averaged; returns (..., L_RA) the
    preamble subcarriers from bin k_offset (DC-relative, mod dft_size)."""
    body = samples[..., cp_samples : cp_samples + nof_symbols * dft_size]
    syms = body.reshape(body.shape[:-1] + (nof_symbols, dft_size))
    spec = torch.fft.fft(syms, dim=-1) / float(np.sqrt(dft_size))
    avg = spec.mean(dim=-2)
    return avg[..., _bins_on(samples.device, int(k_offset), int(l_ra), int(dft_size))]
