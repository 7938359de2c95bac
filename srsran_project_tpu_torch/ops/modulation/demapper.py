"""Soft demapping: exact per-axis max-log LLRs, and int8 quantization.

Port of ``srsran_project_tpu/ops/modulation/demapper.py`` (closed form
``_axis_llrs_closed``, ``demap_soft`` for BPSK, pi/2-BPSK, QPSK and
square QAM, ``quantize_llr``).
LLR sign convention: positive = bit 0.  ``torch.round``, like
``jnp.round``, rounds half to even.
"""

from __future__ import annotations

import numpy as np
import torch

from .mapper import Modulation, bits_per_symbol, pam_levels, pi2_rotation

LLR_MAX = 120


def _axis_llrs_closed(y: torch.Tensor, levels: np.ndarray, labels: np.ndarray):
    """Exact per-axis max-log LLRs by direct distance minimization:
    (m, ...) LLRs of the (...) axis observations y."""
    d2 = [(y - float(np.float32(lv))) ** 2 for lv in levels]
    outs = []
    for b in range(labels.shape[1]):
        m0 = m1 = None
        for lv, d in enumerate(d2):
            if labels[lv, b]:
                m1 = d if m1 is None else torch.minimum(m1, d)
            else:
                m0 = d if m0 is None else torch.minimum(m0, d)
        outs.append(m1 - m0)
    return torch.stack(outs)


def demap_soft(symbols: torch.Tensor, noise_var: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """(..., S) complex symbols and (..., S) noise variances -> (..., S*Qm)
    float32 LLRs, in the mapper's bit order (I/Q interleaved)."""
    qm = bits_per_symbol(mod)
    shape = symbols.shape
    if qm == 1:  # project on (1 + j)/sqrt(2), after undoing the pi/2 rotation
        if mod == Modulation.PI_2_BPSK:
            symbols = symbols * pi2_rotation(shape[-1], symbols.device, conj=True)
        proj = (symbols.real + symbols.imag) / float(np.float32(np.sqrt(2.0)))
        return 4.0 * proj / noise_var
    if qm == 2:  # QPSK: the max-log LLR is linear, 2 sqrt(2) y / noise_var
        c = float(np.float32(2.0 * np.sqrt(2.0)))
        both = torch.stack([c * symbols.real / noise_var, c * symbols.imag / noise_var], dim=-1)
        return both.reshape(shape[:-1] + (shape[-1] * 2,))
    levels, labels = pam_levels(mod)
    inv_nv = 1.0 / noise_var
    li = _axis_llrs_closed(symbols.real, levels, labels) * inv_nv  # bits 0, 2, ...
    lq = _axis_llrs_closed(symbols.imag, levels, labels) * inv_nv  # bits 1, 3, ...
    both = torch.stack([li, lq], dim=-1)  # (m, ..., S, 2)
    both = torch.movedim(both, 0, -2)  # (..., S, m, 2)
    return both.reshape(shape[:-1] + (shape[-1] * qm,))


def quantize_llr(llrs: torch.Tensor, range_limit: float = 20.0) -> torch.Tensor:
    """Mid-tread uniform quantization of float LLRs to int8 in
    [-LLR_MAX, LLR_MAX]."""
    scaled = llrs * float(np.float32(LLR_MAX / range_limit))
    return torch.clamp(torch.round(scaled), -LLR_MAX, LLR_MAX).to(torch.int8)
