"""The benchmark's plain downlink slot: PDSCH grants rate matched around
reserved REs, the row-1 NZP-CSI-RS, and the whole slot's port grids.

PDSCH (TS 38.214 5.1.3.2, 5.1.4; TS 38.211 7.3.1): a ``DlGrant`` is
``link.Grant`` with the transport block sized at N_oh^PRB = ``n_oh``
(xOverhead) and its data REs less the reserved ones: G counts the REs
left, the codeword is ``link.codeword``'s, scrambled and mapped to QAM,
layer i % nl, onto the REs left in mapping order (subcarrier, then
symbol), the DM-RS ``link``'s, each port the float32 sum of its layers'
products (``link.precode``).  The reserved REs stay empty.

CSI-RS row 1 (TS 38.211 7.4.1.5, Table 7.4.1.5.3-1): one port, density 3
at k0, k0 + 4 and k0 + 8 of each PRB on one symbol, the sequence
r(m) of c_init = (2^10 (14 n_s + l + 1)(2 n_ID + 1) + n_ID) mod 2^31 at
m = 3 n + k' counted from CRB 0, unit amplitude.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import link, nr, pdcch

# Float32 products stay float32 on the card (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class DlGrant(link.Grant):
    """A PDSCH grant whose data skip ``reserved``: (symbol, subcarrier)
    pairs of the grant's window; its TBS at ``n_oh`` REs of overhead a PRB."""

    reserved: frozenset = frozenset()
    n_oh: int = 0

    @functools.cached_property
    def tbs(self) -> int:
        return nr.calculate_tbs(self.nof_rb, self.sym_count,
                                nr.NRE * len(self.dmrs_symbols) + self.n_oh, self.rate,
                                self.qm, self.layers)

    @functools.cached_property
    def data_res(self) -> np.ndarray:
        """Flat (14 * nsc) indices of the data REs, in mapping order."""
        return np.array([s * self.nsc + k for s in self.data_symbols for k in range(self.nsc)
                         if (s, k) not in self.reserved], np.int64)

    @property
    def g(self) -> int:
        return len(self.data_res) * self.qm * self.layers


def trs_res(symbols, k0: int, first_prb: int, nof_prb: int) -> frozenset:
    """The (symbol, subcarrier) REs of a row-1 CSI-RS on PRBs first_prb ..
    first_prb + nof_prb - 1 of a window."""
    return frozenset((s, rb * nr.NRE + k0 + 4 * j) for s in symbols
                     for rb in range(first_prb, first_prb + nof_prb) for j in range(3))


def pdsch(tb: torch.Tensor, rnti: torch.Tensor, w: torch.Tensor, g: DlGrant,
          rnd: link.Precision = link.FLOAT32) -> torch.Tensor:
    """(B, A) TB bits, (B,) RNTIs and (B, nl, P) precoders -> (B, P, 14,
    nsc) port grids of the grant's window."""
    b, nl, dev = tb.shape[0], g.layers, tb.device
    cw = link.codeword(tb, g) ^ nr.gold_sequence(nr.sch_c_init(rnti, g.n_id), g.g)
    syms = rnd(nr.map_bits(cw, g.qm))
    layered = syms.reshape(b, -1, nl).transpose(-1, -2)  # (B, nl, n_re)
    grid = torch.zeros((b, nl, 14 * g.nsc), dtype=torch.complex64, device=dev)
    grid[..., torch.from_numpy(g.data_res).to(dev)] = layered
    grid = grid.reshape(b, nl, 14, g.nsc)
    dmrs = torch.from_numpy(g.pilots[3]).to(dev)  # (nsym_d, nl, nsc)
    for i, s in enumerate(g.dmrs_symbols):
        grid[:, :, s] = dmrs[i]
    return link.precode(grid, w, rnd)


def csi_rs_row1(symbol: int, k0: int, crb_start: int, nof_crb: int, n_id: int, nof_sc: int,
                slot: int = 0) -> np.ndarray:
    """(14, nof_sc) complex64: one row-1 CSI-RS resource on CRBs crb_start ..
    crb_start + nof_crb - 1."""
    c_init = ((1 << 10) * (14 * slot + symbol + 1) * (2 * n_id + 1) + n_id) % (1 << 31)
    r = pdcch.qpsk_gold(c_init, 3 * (crb_start + nof_crb))
    out = np.zeros((14, nof_sc), np.complex128)
    for n in range(crb_start, crb_start + nof_crb):
        for j in range(3):
            out[symbol, n * nr.NRE + k0 + 4 * j] = r[3 * n + (k0 + 4 * j) * 3 // nr.NRE]
    return out.astype(np.complex64)
