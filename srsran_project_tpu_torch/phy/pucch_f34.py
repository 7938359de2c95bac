"""PUCCH formats 3 and 4: DFT-s-OFDM UCI (TS 38.211 §6.3.2.6).

Port of ``srsran_project_tpu/phy/pucch_f34.py``.  Format 3: QPSK or
pi/2-BPSK UCI symbols transform-precoded over 1-16 PRBs; format 4: one
PRB with a pre-DFT orthogonal cover code of length 2 or 4.  The DM-RS
symbols carry low-PAPR sequences at the positions of TS 38.211 Table
6.4.1.3.3.2-1, which change with intra-slot hopping and with additional
DM-RS.  The receiver estimates the channel per port and hop from that
hop's DM-RS symbols (per subcarrier for format 3, the PRB's mean for
format 4, which separates the UEs multiplexed on the PRB), combines the
ports (MRC), deprecodes each data symbol, despreads the OCC, demaps,
descrambles and decodes the payload through ``ops.uci`` (short block up
to 11 bits, polar above).
The sequences and RE indices are host plans per config, uploaded once
per device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import scrambling, sequences
from ..ops import transform_precoding as tp
from ..ops import uci as uci_mod
from ..ops._tables import device_table
from ..ops.modulation import Modulation, demap_soft, map_bits
from ..ran.constants import NRE

# DM-RS symbol indices within the PUCCH allocation (TS 38.211 Table
# 6.4.1.3.3.2-1, no additional DM-RS).  Frequency hopping only changes the
# 4-symbol entry (reference get_pucch_formats3_4_dmrs_symbol_mask).
_DMRS_POS = {4: (1,), 5: (0, 3), 6: (1, 4), 7: (1, 4), 8: (1, 5), 9: (1, 6),
             10: (2, 7), 11: (2, 7), 12: (2, 8), 13: (2, 9), 14: (3, 10)}
_DMRS_POS_HOP = {**_DMRS_POS, 4: (0, 2)}
# additionalDMRS doubles the DM-RS density for >= 10 symbols.
_DMRS_POS_ADD = {**_DMRS_POS, 10: (1, 3, 6, 8), 11: (1, 3, 6, 9),
                 12: (1, 4, 7, 10), 13: (1, 4, 7, 11), 14: (1, 5, 8, 12)}


@dataclasses.dataclass(frozen=True)
class PucchFormat34Config:
    """Twin of the reference's ``PucchFormat34Config`` (same fields,
    defaults and derived values)."""

    prb_start: int
    nof_prb: int  # 1 for format 4
    start_symbol: int
    nof_symbols: int  # 4..14
    nof_uci_bits: int
    rnti: int
    n_id: int = 0  # scrambling and sequence id
    occ_length: int = 1  # 1 => format 3; 2/4 => format 4
    occ_index: int = 0
    slot_in_frame: int = 0
    nof_rx_ports: int = 1
    nof_grid_sc: int = 624
    # Intra-slot frequency hopping: PRB start of the second hop (relative
    # symbols nof_symbols // 2 onward).
    second_hop_prb: int | None = None
    # additionalDMRS (TS 38.331): 4 DM-RS symbols for >= 10-symbol
    # allocations.
    additional_dmrs: bool = False
    # pi/2-BPSK data modulation instead of QPSK (TS 38.211 6.3.2.6.2).
    pi2_bpsk: bool = False

    @classmethod
    def from_reference(cls, ref) -> "PucchFormat34Config":
        return cls(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)})

    @property
    def data_symbols(self) -> tuple[int, ...]:
        dm = self.dmrs_symbols
        return tuple(i for i in range(self.nof_symbols) if i not in dm)

    @property
    def dmrs_symbols(self) -> tuple[int, ...]:
        if self.additional_dmrs and self.nof_symbols >= 10:
            return _DMRS_POS_ADD[self.nof_symbols]
        table = _DMRS_POS_HOP if self.second_hop_prb is not None else _DMRS_POS
        return table[self.nof_symbols]

    def prb_of(self, sym_rel: int) -> int:
        if self.second_hop_prb is not None and sym_rel >= self.nof_symbols // 2:
            return self.second_hop_prb
        return self.prb_start

    def hop_of(self, sym_rel: int) -> int:
        return 1 if (self.second_hop_prb is not None and sym_rel >= self.nof_symbols // 2) else 0

    @property
    def nof_data_sc(self) -> int:
        return self.nof_prb * NRE

    @property
    def modulation(self) -> Modulation:
        return Modulation.PI_2_BPSK if self.pi2_bpsk else Modulation.QPSK

    @property
    def nof_coded_bits(self) -> int:
        # QPSK (2 bits a RE) or pi/2-BPSK (1) over the data symbols; the OCC
        # divides the capacity.
        qm = 1 if self.pi2_bpsk else 2
        return qm * len(self.data_symbols) * self.nof_data_sc // self.occ_length


def _c_init(cfg: PucchFormat34Config) -> int:
    """Scrambling seed, reduced to 31 bits (it can exceed 2^31 - 1)."""
    return ((cfg.rnti << 15) + cfg.n_id) % (1 << 31)


# Format 4 DM-RS initial cyclic shift per OCC index (TS 38.211 Table
# 6.4.1.3.3.1-1; reference dmrs_pucch_estimator_formats3_4.cpp:34-50).
_F4_DMRS_M0 = {0: 0, 1: 6, 2: 3, 3: 9}


def _dmrs_seq(cfg: PucchFormat34Config, sym_rel: int) -> np.ndarray:
    """Low-PAPR DM-RS of one DM-RS symbol over the allocation (complex64,
    formed in float64 on the host as the reference does)."""
    base = sequences.base_sequence(cfg.n_id % 30, 0, cfg.nof_data_sc)
    # Per-symbol cyclic shift from the cell PRN (alpha hopping), plus the
    # OCC-dependent m0 of format 4.
    m0 = _F4_DMRS_M0[cfg.occ_index] if cfg.occ_length > 1 else 0
    sym_abs = cfg.start_symbol + sym_rel
    seq = scrambling.gold_ref(cfg.n_id % (1 << 31), 8 * 14 * (cfg.slot_in_frame + 1))
    pos = 8 * (14 * cfg.slot_in_frame + sym_abs)
    ncs = int(sum(int(b) << m for m, b in enumerate(seq[pos : pos + 8])))
    alpha = 2.0 * np.pi * ((m0 + ncs) % NRE) / NRE
    return (base * np.exp(1j * alpha * np.arange(cfg.nof_data_sc))).astype(np.complex64)


def _occ(cfg: PucchFormat34Config) -> np.ndarray:
    """Pre-DFT block weights w_i(m) = e^{-j2pi i m / n} (TS 38.211 Tables
    6.3.2.6.3-1/2)."""
    n = cfg.occ_length
    return np.exp(-2j * np.pi * cfg.occ_index * np.arange(n) / n).astype(np.complex64)


def _re_index(cfg: PucchFormat34Config, rels) -> np.ndarray:
    """(len(rels), M) flat (symbol, subcarrier) grid index of each listed
    symbol's allocation, at its hop's PRB."""
    return np.stack([(cfg.start_symbol + rel) * cfg.nof_grid_sc + cfg.prb_of(rel) * NRE
                     + np.arange(cfg.nof_data_sc) for rel in rels]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _plan(cfg: PucchFormat34Config):
    """(DM-RS RE index (Ndm, M), DM-RS sequences (Ndm, M), hop of each
    DM-RS symbol (Ndm,), data RE index (Nd, M), hop of each data symbol
    (Nd,), OCC (occ_length,))."""
    dm, data = cfg.dmrs_symbols, cfg.data_symbols
    return (_re_index(cfg, dm), np.stack([_dmrs_seq(cfg, rel) for rel in dm]),
            np.asarray([cfg.hop_of(rel) for rel in dm], np.int64), _re_index(cfg, data),
            np.asarray([cfg.hop_of(rel) for rel in data], np.int64), _occ(cfg))


_plan_on = device_table(lambda cfg, which: _plan(cfg)[which])


def generate(cfg: PucchFormat34Config, bits, device: torch.device | str = "cuda") -> torch.Tensor:
    """UE-side contribution: (14, nof_grid_sc) complex64 grid on
    ``device`` carrying the (nof_uci_bits,) payload."""
    device = torch.device(device)
    coded = uci_mod.encode_uci(torch.as_tensor(bits, dtype=torch.uint8, device=device),
                               cfg.nof_coded_bits)
    scr = scrambling.scramble_bits(coded, torch.tensor(_c_init(cfg), device=device))
    syms = map_bits(scr, cfg.modulation)  # (nof data REs,)
    blocks = syms.reshape(len(cfg.data_symbols), 1, cfg.nof_data_sc // cfg.occ_length)
    # Pre-DFT OCC spreading: the block repeated occ_length times, weighted.
    x = (blocks * _plan_on(device, cfg, 5)[None, :, None]).reshape(len(cfg.data_symbols), -1)
    grid = torch.zeros(14 * cfg.nof_grid_sc, dtype=torch.complex64, device=device)
    grid[_plan_on(device, cfg, 3)] = tp.precode(x)
    grid[_plan_on(device, cfg, 0)] = _plan_on(device, cfg, 1)
    return grid.reshape(14, cfg.nof_grid_sc)


def process(grid: torch.Tensor, cfg: PucchFormat34Config):
    """(P, 14, nsc) received grid -> (uci_bits (nof_uci_bits,) uint8, ok
    bool, snr_db float32), all tensors on the grid's device."""
    dev = grid.device
    gflat = grid.reshape(cfg.nof_rx_ports, -1)
    dm_idx, dm_seq, dm_hop, d_idx, d_hop, occ = (_plan_on(dev, cfg, i) for i in range(6))
    hops = sorted({cfg.hop_of(rel) for rel in range(cfg.nof_symbols)})

    # Channel per port and hop: the mean LS of the hop's DM-RS symbols; the
    # noise from the LS residuals (one degree of freedom per hop spent).
    ls = gflat[:, dm_idx] * dm_seq.conj()  # (P, Ndm, M)
    h = torch.stack([ls[:, dm_hop == hop].mean(dim=1) for hop in hops])  # (H, P, M)
    resid = ((ls - h[dm_hop].transpose(0, 1)).abs() ** 2).mean(dim=(0, 2)).sum()
    nvar = torch.clamp_min(resid / max(len(cfg.dmrs_symbols) - len(hops), 1), 1e-10)
    if cfg.occ_length > 1:
        # Format 4: the UEs multiplexed on the PRB send their DM-RS 3, 6 or
        # 9 cyclic shifts apart, and each adds h_other e^{j 2 pi s n / 12}
        # to every subcarrier's LS; the PRB's mean cancels it exactly (a
        # flat channel over the 12 subcarriers).  The reference keeps the
        # per-subcarrier estimate, which a second UE biases (ROADMAP Q3).
        # The noise above is unaffected: the other UEs' terms are the same
        # on every DM-RS symbol.
        h = h.mean(dim=-1, keepdim=True).expand_as(h)
    gain = (h.abs() ** 2).sum(dim=1).mean(dim=-1).mean()

    # MRC over the ports, deprecode and OCC despread each data symbol.
    h_d = h[d_hop].transpose(0, 1)  # (P, Nd, M)
    z = (h_d.conj() * gflat[:, d_idx]).sum(dim=0) / ((h_d.abs() ** 2).sum(dim=0) + 1e-12)
    xb = tp.deprecode(z).reshape(z.shape[0], cfg.occ_length, -1)
    x_all = (xb * occ.conj()[:, None]).mean(dim=1).reshape(-1)
    eq_nvar = (nvar / torch.clamp_min(gain, 1e-9)).expand(x_all.shape)
    llr = demap_soft(x_all, eq_nvar, cfg.modulation)
    seq = scrambling.gold_sequence(torch.tensor(_c_init(cfg), device=dev), llr.shape[-1])
    bits, ok = uci_mod.decode_uci(torch.where(seq == 1, -llr, llr), cfg.nof_uci_bits)
    return bits, ok, 10.0 * torch.log10(torch.clamp_min(gain / nvar, 1e-12))
