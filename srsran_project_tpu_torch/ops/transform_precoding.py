"""Transform precoding for DFT-s-OFDM PUSCH (TS 38.211 §6.3.1.4).

Port of ``srsran_project_tpu/ops/transform_precoding.py``: precode is
y = DFT_M(x) / sqrt(M) over each symbol's M = 12 * n_prb samples, and
deprecode its inverse, both through ``torch.fft`` in complex64.  Valid M
are 2^a 3^b 5^c multiples of 12.
"""

from __future__ import annotations

import numpy as np
import torch


def is_valid_nof_prb(n_prb: int) -> bool:
    n = n_prb
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def precode(x: torch.Tensor) -> torch.Tensor:
    """(..., M) data symbols -> (..., M) frequency-domain samples."""
    m = x.shape[-1]
    return (torch.fft.fft(x) / float(np.sqrt(m))).to(torch.complex64)


def deprecode(y: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """(..., M) frequency-domain samples -> (..., M) data symbols (the IDFT
    along ``dim``)."""
    m = y.shape[dim]
    return (torch.fft.ifft(y, dim=dim) * float(np.sqrt(m))).to(torch.complex64)


def deprecode_noise_var(noise_var: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The IDFT spreads each symbol's noise evenly: every sample's variance
    becomes the mean over the M subcarriers along ``dim``."""
    return noise_var.mean(dim=dim, keepdim=True).expand_as(noise_var)
