"""NR-ARFCN <-> frequency and band helpers (TS 38.104 §5.4.2).

Counterpart of the reference's band_helper.cpp essentials: the global
frequency raster F_REF = F_REF-Offs + dF_Global * (N_REF − N_REF-Offs) over
the three ranges, plus a handful of common FR1 band lookups.

Copy of ``srsran_project_tpu/ran/band.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

# (freq_low_mhz, df_global_khz, f_offs_mhz, n_offs, n_max)
_RASTER = (
    (0.0, 5.0, 0.0, 0, 599999),
    (3000.0, 15.0, 3000.0, 600000, 2016666),
    (24250.08, 60.0, 24250.08, 2016667, 3279165),
)


def arfcn_to_freq_hz(nref: int) -> float:
    for low, df_khz, f_offs_mhz, n_offs, n_max in reversed(_RASTER):
        if nref >= n_offs:
            return (f_offs_mhz * 1e6) + df_khz * 1e3 * (nref - n_offs)
    raise ValueError(nref)


def freq_to_arfcn(freq_hz: float) -> int:
    for low, df_khz, f_offs_mhz, n_offs, n_max in reversed(_RASTER):
        if freq_hz >= low * 1e6:
            return n_offs + round((freq_hz - f_offs_mhz * 1e6) / (df_khz * 1e3))
    raise ValueError(freq_hz)


# Common FR1 bands: band -> (dl_low_mhz, dl_high_mhz, duplex).
BANDS = {
    1: (2110.0, 2170.0, "fdd"),
    3: (1805.0, 1880.0, "fdd"),
    7: (2620.0, 2690.0, "fdd"),
    28: (758.0, 803.0, "fdd"),
    41: (2496.0, 2690.0, "tdd"),
    66: (2110.0, 2200.0, "fdd"),
    77: (3300.0, 4200.0, "tdd"),
    78: (3300.0, 3800.0, "tdd"),
    79: (4400.0, 5000.0, "tdd"),
    257: (26500.0, 29500.0, "tdd"),
    258: (24250.0, 27500.0, "tdd"),
}


def bands_for_freq(freq_hz: float):
    """NR bands whose DL range contains the frequency."""
    mhz = freq_hz / 1e6
    return sorted(b for b, (lo, hi, _) in BANDS.items() if lo <= mhz <= hi)


def is_tdd_band(band: int) -> bool:
    return BANDS[band][2] == "tdd"
