"""Decision-directed EVM (port of ``srsran_project_tpu/ops/modulation/evm.py``).

The reference takes the nearest of all 2^Qm constellation points.  A
square QAM is the product of two PAM axes, so the nearest point's squared
distance is the sum of the nearest level's on each axis: the same quantity
without a (symbols x 2^Qm) distance table.  BPSK and pi/2-BPSK take the
reference's table of their two points (``constellation``: the pi/2
rotation is not in it, as in the reference).  ``hard_decision_bits`` is
the reference's nearest-point hard demap over that same table.
"""

from __future__ import annotations

import numpy as np
import torch

from .._tables import device_table
from .mapper import SQUARE_QAM, Modulation, bits_per_symbol, constellation, pam_levels

_levels_on = device_table(lambda mod: pam_levels(mod)[0].astype(np.float32))
_points_on = device_table(constellation)


def nearest_err2(symbols: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """Squared distance of each of the (..., S) symbols to the nearest
    constellation point -> (..., S) float32."""
    if mod not in SQUARE_QAM:
        d = symbols[..., None] - _points_on(symbols.device, mod)
        return (d.abs() ** 2).amin(dim=-1)
    levels = _levels_on(symbols.device, mod)
    err_re = ((symbols.real[..., None] - levels) ** 2).amin(dim=-1)
    err_im = ((symbols.imag[..., None] - levels) ** 2).amin(dim=-1)
    return err_re + err_im


def evm(symbols: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """RMS EVM of (..., S) symbols against the nearest constellation point
    -> (...,) float32."""
    return torch.sqrt(nearest_err2(symbols, mod).mean(dim=-1))


def hard_decision_bits(symbols: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """Nearest-point hard demap: (..., S) complex -> (..., S*Qm) uint8 bits,
    the label of the nearest of the 2^Qm points of ``constellation``
    (first of equals), most significant bit first."""
    points = _points_on(symbols.device, mod)
    dr = symbols.real[..., None] - points.real
    di = symbols.imag[..., None] - points.imag
    idx = torch.argmin(dr * dr + di * di, dim=-1)
    qm = bits_per_symbol(mod)
    shifts = torch.arange(qm - 1, -1, -1, device=symbols.device)
    bits = (idx[..., None] >> shifts) & 1
    return bits.reshape(symbols.shape[:-1] + (symbols.shape[-1] * qm,)).to(torch.uint8)
