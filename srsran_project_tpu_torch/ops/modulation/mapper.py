"""Modulation mapping (TS 38.211 §5.1).

Port of ``srsran_project_tpu/ops/modulation/mapper.py``: ``Modulation`` is
the twin of the reference enum (same names and values), and QAM symbols
come from the nested Gray PAM recursion as float32 elementwise math, the
same operations as the reference, so the symbols are identical.
"""

from __future__ import annotations

import enum
import functools

import numpy as np
import torch

_QAM_SCALE = {4: 10.0, 6: 42.0, 8: 170.0}


class Modulation(enum.IntEnum):
    """Modulation schemes, value = bits per symbol Qm (pi/2-BPSK = 0)."""

    PI_2_BPSK = 0
    BPSK = 1
    QPSK = 2
    QAM16 = 4
    QAM64 = 6
    QAM256 = 8


def bits_per_symbol(mod: Modulation) -> int:
    return 1 if mod == Modulation.PI_2_BPSK else int(mod)


def _pam(bits: np.ndarray) -> np.ndarray:
    """Per-axis PAM amplitude from sign bit b0 and magnitude bits."""
    n, m = bits.shape
    amp = np.ones(n)
    for k in range(m - 1, 0, -1):
        amp = 2 ** (m - k) - (1 - 2 * bits[:, k]) * amp
    return (1 - 2 * bits[:, 0]) * amp


@functools.lru_cache(maxsize=None)
def constellation(mod: Modulation) -> np.ndarray:
    """(2^Qm,) complex64 LUT, index = bits MSB-first."""
    qm = bits_per_symbol(mod)
    idx = np.arange(1 << qm)
    bits = ((idx[:, None] >> (qm - 1 - np.arange(qm))) & 1).astype(np.int64)
    if mod in (Modulation.BPSK, Modulation.PI_2_BPSK):
        b = bits[:, 0]
        pts = ((1 - 2 * b) + 1j * (1 - 2 * b)) / np.sqrt(2)
    elif mod == Modulation.QPSK:
        pts = ((1 - 2 * bits[:, 0]) + 1j * (1 - 2 * bits[:, 1])) / np.sqrt(2)
    else:
        pts = (_pam(bits[:, 0::2]) + 1j * _pam(bits[:, 1::2])) / np.sqrt(_QAM_SCALE[qm])
    return pts.astype(np.complex64)


def pam_levels(mod: Modulation):
    """Sorted per-axis amplitudes with their axis bit labels:
    (levels (2^m,), labels (2^m, m))."""
    qm = bits_per_symbol(mod)
    m = max(qm // 2, 1)
    idx = np.arange(1 << m)
    bits = ((idx[:, None] >> (m - 1 - np.arange(m))) & 1).astype(np.int64)
    if qm <= 2:
        amp = (1 - 2 * bits[:, 0]).astype(np.float64)
        scale = np.sqrt(2.0)
    else:
        amp = _pam(bits).astype(np.float64)
        scale = np.sqrt(_QAM_SCALE[qm])
    levels = amp / scale
    order = np.argsort(levels)
    return levels[order], bits[order]


SQUARE_QAM = (Modulation.QPSK, Modulation.QAM16, Modulation.QAM64, Modulation.QAM256)


def check_square_qam(mod: Modulation) -> int:
    """Qm of a square QAM (QPSK included): the modulations whose symbols
    are the product of two PAM axes, as kernel K4 demaps them (the
    reference's plane path takes no other)."""
    if mod not in SQUARE_QAM:
        raise ValueError(f"{mod.name} is not a square QAM (QPSK, 16/64/256QAM)")
    return int(mod)


def pi2_rotation(n: int, device, conj: bool = False) -> torch.Tensor:
    """(n,) complex64 pi/2-BPSK rotation: 1 on even symbols, j (-j with
    ``conj``) on odd ones (TS 38.211 §5.1.1)."""
    odd = torch.arange(n, device=device) % 2 == 1
    one = torch.ones((), dtype=torch.complex64, device=device)
    return torch.where(odd, one * (-1j if conj else 1j), one)


def map_bits(bits: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """(..., E) bits -> (..., E/Qm) complex64 symbols."""
    qm = bits_per_symbol(mod)
    e = bits.shape[-1]
    group = bits.to(torch.float32).reshape(bits.shape[:-1] + (e // qm, qm))
    s2 = float(np.float32(1.0 / np.sqrt(2)))
    if qm == 1:  # BPSK and pi/2-BPSK: d = (1 - 2b)(1 + j)/sqrt(2)
        r = (1.0 - 2.0 * group[..., 0]) * s2
        syms = torch.complex(r, r)
        if mod == Modulation.PI_2_BPSK:
            syms = syms * pi2_rotation(syms.shape[-1], bits.device)
        return syms
    if qm == 2:
        return torch.complex((1.0 - 2.0 * group[..., 0]) * s2, (1.0 - 2.0 * group[..., 1]) * s2)
    m = qm // 2

    def pam(axis_bits):
        amp = torch.ones(axis_bits.shape[:-1], dtype=torch.float32, device=bits.device)
        for k in range(m - 1, 0, -1):
            amp = 2.0 ** (m - k) - (1.0 - 2.0 * axis_bits[..., k]) * amp
        return (1.0 - 2.0 * axis_bits[..., 0]) * amp

    s = float(np.float32(1.0 / np.sqrt(_QAM_SCALE[qm])))
    return torch.complex(pam(group[..., 0::2]) * s, pam(group[..., 1::2]) * s)
