"""Decision-directed EVM (port of ``srsran_project_tpu/ops/modulation/evm.py``).

The reference takes the nearest of all 2^Qm constellation points.  A
square QAM is the product of two PAM axes, so the nearest point's squared
distance is the sum of the nearest level's on each axis: the same quantity
without a (symbols x 2^Qm) distance table.  BPSK and pi/2-BPSK take the
reference's table of their two points (``constellation``: the pi/2
rotation is not in it, as in the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from .._tables import device_table
from .mapper import SQUARE_QAM, Modulation, constellation, pam_levels

_levels_on = device_table(lambda mod: pam_levels(mod)[0].astype(np.float32))
_points_on = device_table(constellation)


def evm(symbols: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """RMS EVM of (..., S) symbols against the nearest constellation point
    -> (...,) float32."""
    if mod not in SQUARE_QAM:
        d = symbols[..., None] - _points_on(symbols.device, mod)
        return torch.sqrt((d.abs() ** 2).amin(dim=-1).mean(dim=-1))
    levels = _levels_on(symbols.device, mod)
    err_re = ((symbols.real[..., None] - levels) ** 2).amin(dim=-1)
    err_im = ((symbols.imag[..., None] - levels) ** 2).amin(dim=-1)
    return torch.sqrt((err_re + err_im).mean(dim=-1))
