"""Reference-exact int8 soft demapper.

Port of ``srsran_project_tpu/ops/modulation/demapper_i8.py`` (the
demapper of ``PuschConfig.demapper="reference"``), which reproduces the
reference demodulation mapper's numerics bit for bit
(lib/phy/upper/channel_modulation/demodulation_mapper_{qpsk,qam16,qam64,
qam256}.cpp + demodulation_mapper_impl.cpp for BPSK/pi2-BPSK):

- max-log LLRs via piecewise-linear interval functions whose slope and
  intercept tables are derived analytically on the host (exact integer
  and rational arithmetic, materialized as the reference's float32
  expressions; the same numpy code as the reference's);
- noise handled as ``rcp = 1/nv`` if ``nv > 0`` else 0 (safe_div), one
  float32 division per symbol, LLR = (slope*y + intercept) * rcp;
- per-component near-zero squelch (|y| <= 1e-9 -> 0);
- quantization: scale by float32(LLR_MAX/range), clip to +-LLR_MAX,
  round half to even -> int8 (range 24 for BPSK, pi/2-BPSK and QPSK, 20
  for QAM); BPSK's scalar path clips in the LLR domain and rounds half
  away from zero.

Every step is a separate float32 tensor operation in the reference's
order, so no multiply-add is contracted on either device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._tables import device_table
from .mapper import Modulation, bits_per_symbol

LLR_MAX = 120
NEAR_ZERO = float(np.float32(1e-9))

# Per-axis PAM normalization 1/sqrt(norm): QPSK 2, QAM16 10, QAM64 42, QAM256 170.
_NORM = {Modulation.QAM16: 10, Modulation.QAM64: 42, Modulation.QAM256: 170}
_RANGE_LIMIT = {
    Modulation.BPSK: np.float32(24),
    Modulation.PI_2_BPSK: np.float32(24),
    Modulation.QPSK: np.float32(24),
    Modulation.QAM16: np.float32(20),
    Modulation.QAM64: np.float32(20),
    Modulation.QAM256: np.float32(20),
}


def _gray_pam_labels(m_bits: int) -> np.ndarray:
    """Amplitude-level multipliers per Gray label for one axis.

    levels[label] = odd multiplier k such that the constellation point is
    k/sqrt(norm).  Follows TS 38.211 §5.1: for each axis, bit t of the label
    selects sign (t=0) / magnitude splits (t>0).
    """
    n = 1 << m_bits
    levels = np.zeros(n, dtype=np.int64)
    for label in range(n):
        bits = [(label >> (m_bits - 1 - t)) & 1 for t in range(m_bits)]
        # TS 38.211 mapping: amplitude = (1-2b0) * [2^(m-1) - ... nested]
        # Build nested expression: a_m = 1; a_t = 2^t - (1-2*b_{m-t}) * a_{t-1}?
        # Use the closed form via the standard recursive construction.
        # TS 38.211 nesting (e.g. §5.1.5 QAM64 axis):
        #   I = (1-2a0) * (2^(m-1) - (1-2a1) * (2^(m-2) - ... (2 - (1-2a_{m-1})) ...))
        val = 1
        for t in range(m_bits - 1, 0, -1):
            val = (1 << (m_bits - t)) - (1 - 2 * bits[t]) * val
        val = (1 - 2 * bits[0]) * val
        levels[label] = val
    return levels


@functools.lru_cache(maxsize=None)
def _interval_tables(mod: Modulation):
    """Exact max-log slope/intercept interval tables for one axis.

    For interval i the nearest constellation points with bit=0 (s0) and
    bit=1 (s1) give  LLR(y)·nv = (y-s1)² - (y-s0)² = 2(s0-s1)·y + (s1²-s0²).
    With s = k/sqrt(norm):  slope = 2(k0-k1)/sqrt(norm)  (integer multiple
    of 1/sqrt(norm)) and intercept = (k1²-k0²)/norm (exact rational) —
    the same expression forms as the reference tables
    (demodulation_mapper_qam{64,256}.cpp:48-90), so the float32 constants
    are identical.
    """
    qm = bits_per_symbol(mod)
    m = qm // 2  # bits per axis
    norm = _NORM[mod]
    inv_sqrt = np.float32(1) / np.sqrt(np.float32(norm))
    levels = _gray_pam_labels(m)  # amplitude multiplier per axis label
    nof_levels = 1 << m

    widths = []
    slopes = []
    intercepts = []
    nof_intervals_list = []
    for t in range(m):  # axis bit index (bit 2t / 2t+1 of the symbol)
        # Interval grid (reference tables): every axis bit uses L intervals
        # of width 2c, except the last bit, which uses L/2 of width 4c.
        if t == m - 1:
            n_int = nof_levels // 2
            width_mult = 4
        else:
            n_int = nof_levels
            width_mult = 2
        width = np.float32(width_mult) * inv_sqrt
        slope_t = np.zeros(n_int, dtype=np.float32)
        icept_t = np.zeros(n_int, dtype=np.float32)
        for i in range(n_int):
            # Interval midpoint in units of c.
            mid = (i - n_int / 2 + 0.5) * width_mult
            # Nearest bit=0 / bit=1 levels at this midpoint (exact ints).
            best0, best1 = None, None
            for label in range(nof_levels):
                k = levels[label]
                d2 = (mid - k) ** 2
                bit = (label >> (m - 1 - t)) & 1
                if bit == 0:
                    if best0 is None or d2 < best0[0]:
                        best0 = (d2, k)
                else:
                    if best1 is None or d2 < best1[0]:
                        best1 = (d2, k)
            k0, k1 = best0[1], best1[1]
            slope_t[i] = np.float32(2 * (k0 - k1)) * inv_sqrt
            num = int(k1 * k1 - k0 * k0)
            # Reference writes intercepts as float divisions of reduced
            # rationals; float32 division is correctly rounded, so any
            # representation of the same rational gives the same bits.
            icept_t[i] = np.float32(num) / np.float32(norm)
        widths.append(width)
        slopes.append(slope_t)
        intercepts.append(icept_t)
        nof_intervals_list.append(n_int)
    return widths, nof_intervals_list, slopes, intercepts


_slope_on = device_table(lambda mod, t: _interval_tables(mod)[2][t])
_icept_on = device_table(lambda mod, t: _interval_tables(mod)[3][t])
_F32 = lambda x: float(np.float32(x))  # noqa: E731  (a float32 constant)


def _quantize(l_value: torch.Tensor, range_limit: np.float32) -> torch.Tensor:
    """SIMD-path quantization: scale, clip, round half to even, int8
    (reference avx2_helpers.h:121-151 quantize_ps)."""
    v = l_value * _F32(np.float32(LLR_MAX) / range_limit)
    v = torch.clamp(v, -float(LLR_MAX), float(LLR_MAX))
    v = torch.round(v)
    return torch.where(torch.isnan(v), 0.0, v).to(torch.int8)


def _quantize_scalar(l_value: torch.Tensor, range_limit: np.float32) -> torch.Tensor:
    """Scalar-path quantization: clip in the LLR domain, then
    round(clipped / range * LLR_MAX) half away from zero (reference
    log_likelihood_ratio.cpp:90-99)."""
    clipped = torch.clamp(l_value, -float(range_limit), float(range_limit))
    v = clipped / float(range_limit) * float(LLR_MAX)
    out = torch.sign(v) * torch.floor(v.abs() + 0.5)
    return torch.where(torch.isnan(out), 0.0, out).to(torch.int8)


def _safe_rcp(noise_var: torch.Tensor) -> torch.Tensor:
    nv = noise_var.to(torch.float32)
    return torch.where(nv > 0, 1.0 / nv, 0.0)


def demap_llr_i8(symbols: torch.Tensor, noise_var: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """(..., S) complex64 symbols and (..., S) float32 noise variances ->
    (..., S*Qm) int8 LLRs, bit-exact against the reference demodulation
    mapper.  Plain torch on the device of the input."""
    shape = symbols.shape
    symbols = symbols.to(torch.complex64)
    re, im = symbols.real, symbols.imag

    if mod in (Modulation.BPSK, Modulation.PI_2_BPSK):
        if mod == Modulation.PI_2_BPSK:
            # Odd symbols: z -> (im, -re) (demodulation_mapper_impl.cpp:72).
            odd = (torch.arange(shape[-1], device=symbols.device) % 2).bool()
            re, im = torch.where(odd, im, re), torch.where(odd, -re, im)
        nv = noise_var.to(torch.float32)
        # Scalar path: l = 2 sqrt2 (re + im) / nv, zero when nv <= 0 or NaN.
        l_value = _F32(np.float32(2) * np.float32(np.sqrt(np.float32(2)))) * (re + im) / nv
        l_value = torch.where(nv > 0, l_value, 0.0)
        return _quantize_scalar(l_value, _RANGE_LIMIT[mod]).reshape(shape)

    rcp = _safe_rcp(noise_var)

    if mod == Modulation.QPSK:
        gain = _F32(np.float32(2) * np.float32(np.sqrt(np.float32(2))))
        out = torch.stack([(gain * re) * rcp, (gain * im) * rcp], dim=-1)
        return _quantize(out.reshape(shape[:-1] + (shape[-1] * 2,)), _RANGE_LIMIT[mod])

    qm = bits_per_symbol(mod)

    if mod == Modulation.QAM16:
        # Direct formula path (demodulation_mapper_qam16.cpp:68-105).
        c = np.float32(1) / np.sqrt(np.float32(10))
        gain_first = _F32(np.float32(4) * c)
        thresh = _F32(np.float32(2) * c)

        def bits01(y):
            first = gain_first * y
            second = 2.0 * first - torch.copysign(torch.full_like(y, _F32(0.8)), y)
            return torch.where(y.abs() > thresh, second, first)

        def bits23(y):
            return _F32(0.8) - (gain_first * y).abs()

        lv = [bits01(re), bits01(im), bits23(re), bits23(im)]
        zero = [re.abs() <= NEAR_ZERO, im.abs() <= NEAR_ZERO] * 2
        lv = [torch.where(z, 0.0, v * rcp) for v, z in zip(lv, zero)]
        out = torch.stack(lv, dim=-1).reshape(shape[:-1] + (shape[-1] * qm,))
        return _quantize(out, _RANGE_LIMIT[mod])

    widths, n_ints, _, _ = _interval_tables(mod)

    def interval_fn(y, t):
        width, n_int = widths[t], n_ints[t]
        # AVX2 path: idx = floor(y * (1/width)) (avx2_helpers.h:175-194);
        # the clamp before the cast saturates as the reference's does.
        idx = torch.floor(y * _F32(np.float32(1) / width)).clamp(-(1 << 30), 1 << 30)
        idx = (idx.to(torch.int64) + n_int // 2).clamp(0, n_int - 1)
        sl = _slope_on(y.device, mod, t)[idx]
        ic = _icept_on(y.device, mod, t)[idx]
        res = (sl * y + ic) * rcp
        return torch.where(y.abs() <= NEAR_ZERO, 0.0, res)

    lv = []
    for t in range(qm // 2):
        lv.append(interval_fn(re, t))
        lv.append(interval_fn(im, t))
    out = torch.stack(lv, dim=-1).reshape(shape[:-1] + (shape[-1] * qm,))
    return _quantize(out, _RANGE_LIMIT[mod])
