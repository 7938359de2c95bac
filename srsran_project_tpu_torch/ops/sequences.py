"""Low-PAPR (Zadoff-Chu family) sequences (TS 38.211 §5.2.2).

Port of ``srsran_project_tpu/ops/sequences.py``.  The base sequences are
static per (u, v, length): host float64, cached (``base_sequence`` and
``group_hopping_params`` are copies of the reference's, with their own
copy of ``_low_papr_phi.npz``; tests/test_torch_pucch.py holds them
equal).  ``generate`` applies the cyclic-shift ramp exp(j alpha n) in
float32 on the device, as the reference does.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from . import scrambling
from ._tables import device_table


@functools.lru_cache(maxsize=1)
def _phi_tables():
    d = np.load(os.path.join(os.path.dirname(__file__), "_low_papr_phi.npz"))
    return {6: d["phi6"], 12: d["phi12"], 18: d["phi18"], 24: d["phi24"]}


def _largest_prime_below(n: int) -> int:
    def is_prime(x):
        if x < 2:
            return False
        for p in range(2, int(x**0.5) + 1):
            if x % p == 0:
                return False
        return True

    for c in range(n - 1, 1, -1):
        if is_prime(c):
            return c
    raise ValueError(n)


@functools.lru_cache(maxsize=None)
def base_sequence(u: int, v: int, length: int) -> np.ndarray:
    """r̄_{u,v}(n), complex128 host array of the given length.

    Lengths 6/12/18/24 use the phi tables (Tables 5.2.2.2-1..4); length 30
    uses the closed form; >= 36 uses the cyclically-extended ZC sequence.
    """
    if length in (6, 12, 18, 24):
        phi = _phi_tables()[length][u].astype(np.float64)
        return np.exp(1j * phi * np.pi / 4)
    if length == 30:
        n = np.arange(30, dtype=np.float64)
        arg = -np.pi * (u + 1) * (n + 1) * (n + 2) / 31.0
        return np.exp(1j * arg)
    assert length >= 36 and length % 6 == 0, length
    n_zc = _largest_prime_below(length)
    qbar = n_zc * (u + 1) / 31.0
    q = int(np.floor(qbar + 0.5)) + v * (-1) ** int(np.floor(2 * qbar))
    m = np.arange(length, dtype=np.float64) % n_zc
    arg = -np.pi * q * m * (m + 1) / n_zc
    return np.exp(1j * arg)


_base_on = device_table(lambda u, v, length: base_sequence(u, v, length).astype(np.complex64))


def generate(u: int, v: int, length: int, alpha, device: torch.device | str = "cuda"
             ) -> torch.Tensor:
    """r^{(alpha)}_{u,v}(n) = e^{j alpha n} r̄_{u,v}(n).

    alpha: float or (...,) float32 tensor of radians per sample (a tensor
    brings its own device; a float is made on ``device``).  Returns
    (..., length) complex64."""
    if isinstance(alpha, torch.Tensor):
        device = alpha.device
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)[..., None]
    n = torch.arange(length, dtype=torch.float32, device=device)
    phase = a * n
    ramp = torch.polar(torch.ones_like(phase), phase)
    return ramp * _base_on(torch.device(device), u, v, length)


def group_hopping_params(
    n_id: int, slot_in_frame: int, symbol: int, hopping: str = "neither"
) -> tuple[int, int]:
    """(u, v) sequence group / number for PUCCH low-PAPR sequences
    (TS 38.211 §6.3.2.2.1; reference low_papr_sequence usage in
    lib/phy/upper/channel_processors/pucch/).

    hopping:
    - "neither": u = n_id mod 30, v = 0.
    - "enable" (group hopping): f_gh from 8 Gold bits at position
      8*(14*n_s + l), c_init = floor(n_id/30); v = 0.
    - "disable" (sequence hopping): u = n_id mod 30; v = c(14*n_s + l)
      with c_init = 32*floor(n_id/30) + n_id mod 30.
    """
    if hopping == "neither":
        return n_id % 30, 0
    if hopping == "enable":
        pos = 8 * (14 * slot_in_frame + symbol)
        bits = scrambling.gold_ref(n_id // 30, pos + 8)[pos : pos + 8]
        f_gh = int(sum(int(b) << m for m, b in enumerate(bits))) % 30
        return (f_gh + n_id) % 30, 0
    if hopping == "disable":
        pos = 14 * slot_in_frame + symbol
        c_init = 32 * (n_id // 30) + (n_id % 30)
        v = int(scrambling.gold_ref(c_init, pos + 1)[pos])
        return n_id % 30, v
    raise ValueError(f"unknown hopping mode {hopping!r}")
