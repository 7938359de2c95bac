"""SRS generation (UE side, for tests) and channel estimation (gNB side).

Port of ``srsran_project_tpu/phy/srs.py`` (TS 38.211 §6.4.1.4): low-PAPR
sequences on a comb (K_TC = 2 or 4) over 1-4 symbols; the estimator
LS-correlates per rx port, averages over the symbols and reports the
per-subcarrier channel, the noise variance, the EPRE and a wideband delay
indicator (the phase slope across the comb).  With several antenna ports
each port's channel is isolated in the delay domain (``torch.fft``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import sequences
from ..ops._tables import device_table
from ..ran.constants import NRE


@dataclasses.dataclass(frozen=True)
class SrsConfig:
    """Twin of the reference's ``SrsConfig`` (same fields and defaults)."""

    rb_start: int
    rb_count: int
    start_symbol: int
    nof_symbols: int  # 1, 2, 4
    comb: int = 2  # K_TC
    comb_offset: int = 0
    sequence_id: int = 0  # n_SRS_ID
    cyclic_shift: int = 0
    nof_antenna_ports: int = 1  # N_ap^SRS: 1, 2 or 4
    nof_rx_ports: int = 1
    nof_grid_sc: int = 624
    nof_grid_symbols: int = 14

    @classmethod
    def from_reference(cls, ref) -> "SrsConfig":
        return cls(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)})

    @property
    def seq_length(self) -> int:
        return self.rb_count * NRE // self.comb

    @property
    def n_cs_max(self) -> int:
        return 8 if self.comb == 2 else 12

    def port_cyclic_shift(self, i_port: int) -> int:
        """n_SRS^{cs,i} = (cs + n_cs_max i / N_ap) mod n_cs_max
        (TS 38.211 6.4.1.4.2)."""
        return (self.cyclic_shift + (self.n_cs_max * i_port) // self.nof_antenna_ports
                ) % self.n_cs_max

    def port_comb_offset(self, i_port: int) -> int:
        """4-port transmissions with cs >= n_cs_max / 2 put ports 1 and 3 on
        the opposite comb."""
        k_tc = self.comb_offset
        if (self.nof_antenna_ports == 4 and self.cyclic_shift >= self.n_cs_max // 2
                and i_port in (1, 3)):
            k_tc = (k_tc + self.comb // 2) % self.comb
        return k_tc


@functools.lru_cache(maxsize=None)
def _sc_indices(cfg: SrsConfig, i_port: int = 0) -> np.ndarray:
    k0 = cfg.rb_start * NRE + cfg.port_comb_offset(i_port)
    return (k0 + cfg.comb * np.arange(cfg.seq_length)).astype(np.int64)


def _alpha(cfg: SrsConfig, i_port: int = 0) -> float:
    return 2.0 * np.pi * cfg.port_cyclic_shift(i_port) / cfg.n_cs_max


@functools.lru_cache(maxsize=None)
def _sequence(cfg: SrsConfig, i_port: int = 0) -> np.ndarray:
    """The port's SRS sequence (host, complex64)."""
    base = sequences.base_sequence(cfg.sequence_id % 30, 0, cfg.seq_length)
    ramp = np.exp(1j * _alpha(cfg, i_port) * np.arange(cfg.seq_length))
    return (base * ramp).astype(np.complex64)


_sc_on = device_table(_sc_indices)
_seq_on = device_table(_sequence)


def generate(cfg: SrsConfig, device: torch.device | str = "cuda") -> torch.Tensor:
    """UE-side SRS on ``device``: (N_ap, nof_grid_symbols, nof_grid_sc)
    complex64, squeezed to 2-D for a single port."""
    dev = torch.device(device)
    grid = torch.zeros((cfg.nof_antenna_ports, cfg.nof_grid_symbols, cfg.nof_grid_sc),
                       dtype=torch.complex64, device=dev)
    syms = slice(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols)
    for p in range(cfg.nof_antenna_ports):
        grid[p, syms, _sc_on(dev, cfg, p)] = _seq_on(dev, cfg, p)
    return grid[0] if cfg.nof_antenna_ports == 1 else grid


def _window_masks(n: int, nof_ports: int) -> tuple[np.ndarray, np.ndarray, float]:
    """Delay-domain masks of one port's window (+-n / (2 N_ap) bins around
    zero delay) and of its outer half (the noise bins), and that half's
    size."""
    half = max(n // (2 * nof_ports), 1)
    mask = np.zeros(n, np.float32)
    mask[: half + 1] = 1.0
    mask[n - half :] = 1.0
    outer = np.zeros(n, np.float32)
    outer[half // 2 : half + 1] = 1.0
    outer[n - half : n - half // 2] = 1.0
    return mask, outer, float(outer.sum())


_mask_on = device_table(lambda n, nof_ports, which: _window_masks(n, nof_ports)[which])


def _per_port(grid: torch.Tensor, cfg: SrsConfig, i_port: int):
    """(h (P, L), noise_var (P,), epre (P,), phase slope (P,)) of one SRS
    antenna port."""
    dev = grid.device
    y = grid[:, cfg.start_symbol : cfg.start_symbol + cfg.nof_symbols][..., _sc_on(dev, cfg, i_port)]
    ls = y * _seq_on(dev, cfg, i_port).conj()
    h = ls.mean(dim=1)  # (P, L)
    epre = (y.abs() ** 2).mean(dim=(1, 2))
    if cfg.nof_antenna_ports > 1:
        # The other ports' cyclic shifts sit at multiples of L / N_ap delay
        # bins: keep this port's window, read the noise off its outer half.
        d = torch.fft.ifft(h, dim=-1)
        n = d.shape[-1]
        h = torch.fft.fft(d * _mask_on(dev, n, cfg.nof_antenna_ports, 0), dim=-1)
        nbins = _window_masks(n, cfg.nof_antenna_ports)[2]
        noise_var = ((d * _mask_on(dev, n, cfg.nof_antenna_ports, 1)).abs() ** 2).sum(dim=-1) \
            * n / max(nbins, 1.0)
    elif cfg.nof_symbols > 1:
        resid = ls - h[:, None, :]
        noise_var = (resid.abs() ** 2).mean(dim=(1, 2)) * cfg.nof_symbols / (cfg.nof_symbols - 1)
    else:
        # One symbol: the noise from the high-delay half of the estimate's
        # delay spectrum.
        d = torch.fft.ifft(h, dim=-1)
        n = d.shape[-1]
        noise_var = 2.0 * (d[:, n // 4 : 3 * n // 4].abs() ** 2).sum(dim=-1) / (n / 2) * n / n
    slope = torch.angle((h[:, 1:] * h[:, :-1].conj()).sum(dim=-1))  # radians per comb step
    return h, noise_var, epre, slope


def estimate(grid: torch.Tensor, cfg: SrsConfig) -> dict:
    """(P, nsym, nsc) received grid -> dict of h (P, L) complex64, or
    (P, N_ap, L) with several antenna ports; noise_var (P,); epre (P,);
    phase_slope (P,) or (P, N_ap), radians per comb step."""
    if cfg.nof_antenna_ports == 1:
        h, noise_var, epre, slope = _per_port(grid, cfg, 0)
        return {"h": h, "noise_var": noise_var, "epre": epre, "phase_slope": slope}
    parts = [_per_port(grid, cfg, p) for p in range(cfg.nof_antenna_ports)]
    return {
        "h": torch.stack([p[0] for p in parts], dim=1),
        "noise_var": torch.stack([p[1] for p in parts], dim=1).mean(dim=1),
        "epre": parts[0][2],
        "phase_slope": torch.stack([p[3] for p in parts], dim=1),
    }
