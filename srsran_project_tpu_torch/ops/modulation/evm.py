"""Decision-directed EVM (port of ``srsran_project_tpu/ops/modulation/evm.py``).

The reference takes the nearest of all 2^Qm constellation points.  A
square QAM is the product of two PAM axes, so the nearest point's squared
distance is the sum of the nearest level's on each axis: the same quantity
without a (symbols x 2^Qm) distance table.
"""

from __future__ import annotations

import numpy as np
import torch

from .._tables import device_table
from .mapper import Modulation, check_square_qam, pam_levels

_levels_on = device_table(lambda mod: pam_levels(mod)[0].astype(np.float32))


def evm(symbols: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """RMS EVM of (..., S) symbols against the nearest constellation point
    -> (...,) float32."""
    check_square_qam(mod)
    levels = _levels_on(symbols.device, mod)
    err_re = ((symbols.real[..., None] - levels) ** 2).amin(dim=-1)
    err_im = ((symbols.imag[..., None] - levels) ** 2).amin(dim=-1)
    return torch.sqrt((err_re + err_im).mean(dim=-1))
