"""The benchmark's plain PUCCH formats 1 and 2 (TS 38.211 6.3.2.4,
6.3.2.5, 6.4.1.3), sent and received.

Format 1: per symbol the length-12 low-PAPR sequence r_u,v(n) e^{j alpha n}
(5.2.2; u = n_ID mod 30, v = 0: no group or sequence hopping), alpha from
the initial cyclic shift and n_cs(n_s, l) (6.3.2.2.2), the BPSK or QPSK
symbol d on the data symbols (odd symbols of the allocation) and 1 on the
DM-RS (even ones), times the time-domain OCC w_i(m) of the symbol's hop;
with intra-slot hopping the first floor(N/2) symbols sit on the first PRB.
The receiver correlates each allocated UE's own sequence and OCC over its
12 subcarriers and the symbols of each hop: h (DM-RS) and z (data) per
port and hop, their means; corr = sum z conj(h), rho = |corr| /
sqrt(sum |h|^2 sum |z|^2), the bits the signs of corr (1 bit: of its
projection on 1 + j).

Format 2: QPSK of the scrambled UCI codeword (c_init = RNTI 2^15 + n_ID)
on the REs k mod 3 != 1, frequency first; the DM-RS, QPSK of the Gold
sequence of c_init = 2^17 (14 n_s + l + 1)(2 N_ID0 + 1) + 2 N_ID0, on k
mod 3 == 1, numbered from CRB 0.  The receiver: least squares at the
pilots, pairs of adjacent pilots averaged, the channel per port the mean
of the pairs of both symbols, MRC over the ports, QPSK LLRs, descrambling,
``uci.decode``; the SNR per port the pairs' mean power over the noise,
twice the mean squared residual of the pilots about their pair's mean,
averaged over the ports, in dB.

Departures from the spec:
- The spec defines no receiver: the DTX statistic rho, the format 2
  channel estimate and its SNR are this reference's, flat over a
  resource; the channel the benchmark applies is flat.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import nr, uci
from .link import FLOAT32, Precision

# Float32 products stay float32 on the card (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NRE = nr.NRE


@dataclasses.dataclass(frozen=True)
class F1:
    """One format 1 occasion: PRBs (second None without hopping), symbols,
    initial cyclic shift m0, OCC index, hopping id and its HARQ bits."""

    prb: int
    second_hop_prb: int | None
    start_symbol: int
    nof_symbols: int
    cyclic_shift: int
    occ: int
    n_id: int
    nof_bits: int
    slot: int = 0


@dataclasses.dataclass(frozen=True)
class F2:
    """One format 2 occasion on rb_count PRBs from rb_start, 1 or 2
    symbols, no hopping."""

    rb_start: int
    rb_count: int
    start_symbol: int
    nof_symbols: int
    nof_bits: int
    rnti: int
    n_id: int
    n_id0: int
    slot: int = 0


def low_papr_12(u: int) -> np.ndarray:
    """r_u,0(n) = e^{j phi(n) pi / 4}, n < 12 (Table 5.2.2.2-2), complex128."""
    phi = uci.tables()["low_papr_phi_12"][u].astype(np.float64)
    return np.exp(1j * np.pi * phi / 4.0)


def n_cs(n_id: int, slot: int, symbol: int) -> int:
    """n_cs(n_s, l) = sum_m 2^m c(8 N_symb n_s + 8 l + m), c_init = n_ID."""
    c = nr.gold_ref(n_id, 8 * (14 * slot + symbol) + 8)[8 * (14 * slot + symbol):]
    return int(sum(int(b) << m for m, b in enumerate(c)))


# phi(m) of w_i(m) = e^{j 2 pi phi(m) / N_SF}, Table 6.3.2.4.1-2, by N_SF
# and i.
OCC_PHI = {
    1: [[0]],
    2: [[0, 0], [0, 1]],
    3: [[0, 0, 0], [0, 1, 2], [0, 2, 1]],
    4: [[0, 0, 0, 0], [0, 2, 0, 2], [0, 0, 2, 2], [0, 2, 2, 0]],
    5: [[0, 0, 0, 0, 0], [0, 1, 2, 3, 4], [0, 2, 4, 1, 3], [0, 3, 1, 4, 2], [0, 4, 3, 2, 1]],
    6: [[0, 0, 0, 0, 0, 0], [0, 1, 2, 3, 4, 5], [0, 2, 4, 0, 2, 4], [0, 3, 0, 3, 0, 3],
        [0, 4, 2, 0, 4, 2], [0, 5, 4, 3, 2, 1]],
    7: [[0, 0, 0, 0, 0, 0, 0], [0, 1, 2, 3, 4, 5, 6], [0, 2, 4, 6, 1, 3, 5],
        [0, 3, 6, 2, 5, 1, 4], [0, 4, 1, 5, 2, 6, 3], [0, 5, 3, 1, 6, 4, 2],
        [0, 6, 5, 4, 3, 2, 1]],
}


def occ(n_sf: int, i: int) -> np.ndarray:
    """w_i(m), m < N_SF, complex128."""
    return np.exp(2j * np.pi * np.asarray(OCC_PHI[n_sf][i]) / n_sf)


def f1_hops(o: F1) -> list:
    """Per hop: (PRB, DM-RS symbols, data symbols)."""
    syms = list(range(o.start_symbol, o.start_symbol + o.nof_symbols))
    parts = ([(syms, o.prb)] if o.second_hop_prb is None else
             [(syms[:o.nof_symbols // 2], o.prb), (syms[o.nof_symbols // 2:], o.second_hop_prb)])
    return [(prb, [s for s in ss if (s - o.start_symbol) % 2 == 0],
             [s for s in ss if (s - o.start_symbol) % 2 == 1]) for ss, prb in parts]


@functools.lru_cache(maxsize=None)
def f1_sequences(o: F1) -> dict:
    """symbol -> (PRB, the (12,) complex128 sequence times its OCC weight)."""
    base = low_papr_12(o.n_id % 30)
    out = {}
    for prb, dmrs, data in f1_hops(o):
        for part in (dmrs, data):
            w = occ(len(part), o.occ)
            for m, sym in enumerate(part):
                alpha = 2.0 * np.pi / NRE * ((o.cyclic_shift + n_cs(o.n_id, o.slot, sym)) % NRE)
                out[sym] = (prb, w[m] * np.exp(1j * alpha * np.arange(NRE)) * base)
    return out


def f1_symbol(bits: torch.Tensor, nof_bits: int) -> torch.Tensor:
    """(B, nof_bits) -> (B,) complex64 BPSK or QPSK symbols (5.1.2, 5.1.3)."""
    b = 1.0 - 2.0 * bits.to(torch.float32)
    s = float(np.float32(1.0 / np.sqrt(2.0)))
    if nof_bits == 1:
        return torch.complex(b[:, 0] * s, b[:, 0] * s)
    return torch.complex(b[:, 0] * s, b[:, 1] * s)


def f1_transmit(o: F1, bits: torch.Tensor) -> dict:
    """symbol -> (PRB, (B, 12) complex64): the occasion's REs for (B,
    nof_bits) bits."""
    dmrs = {s for _p, d, _z in f1_hops(o) for s in d}
    d = f1_symbol(bits, o.nof_bits)
    out = {}
    for sym, (prb, seq) in f1_sequences(o).items():
        row = torch.from_numpy(seq.astype(np.complex64)).to(bits.device)
        out[sym] = (prb, row.expand(bits.shape[0], NRE) if sym in dmrs else d[:, None] * row)
    return out


def f1_receive(grid: torch.Tensor, o: F1, rnd: Precision = FLOAT32):
    """(B, P, 14, nsc) grids -> (bits (B, nof_bits) uint8, rho (B,))."""
    seqs = f1_sequences(o)
    corr = h_pow = z_pow = 0.0
    for prb, dmrs, data in f1_hops(o):
        sc = slice(prb * NRE, (prb + 1) * NRE)
        est = []
        for part in (dmrs, data):
            ref = torch.from_numpy(np.stack([seqs[s][1] for s in part]).astype(np.complex64)
                                   ).to(grid.device)
            est.append(rnd((grid[:, :, part, sc] * ref.conj()).mean(dim=(-2, -1))))  # (B, P)
        h, z = est
        corr = corr + (z * h.conj()).sum(dim=-1)
        h_pow = h_pow + (h.abs() ** 2).sum(dim=-1)
        z_pow = z_pow + (z.abs() ** 2).sum(dim=-1)
    corr = rnd(corr)
    rho = rnd(corr.abs() / torch.sqrt(h_pow * z_pow + 1e-24))
    if o.nof_bits == 1:
        bits = (corr.real + corr.imag < 0)[:, None]
    else:
        bits = torch.stack([corr.real < 0, corr.imag < 0], dim=-1)
    return bits.to(torch.uint8), rho


def f2_layout(o: F2):
    """(data REs (symbol, subcarrier) in mapping order, pilot REs per
    symbol, pilot values (nsym, 4 rb_count) complex64)."""
    data, pilots, values = [], [], []
    for sym in range(o.start_symbol, o.start_symbol + o.nof_symbols):
        ks = [k for k in range(o.rb_start * NRE, (o.rb_start + o.rb_count) * NRE)]
        data += [(sym, k) for k in ks if k % 3 != 1]
        pilots.append([k for k in ks if k % 3 == 1])
        c_init = ((1 << 17) * (14 * o.slot + sym + 1) * (2 * o.n_id0 + 1) + 2 * o.n_id0) % (1 << 31)
        m0, m1 = 4 * o.rb_start, 4 * (o.rb_start + o.rb_count)
        c = nr.gold_ref(c_init, 2 * m1).astype(np.float64)
        values.append((((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2))[m0:m1])
    return data, pilots, np.stack(values).astype(np.complex64)


def f2_transmit(o: F2, bits: torch.Tensor, nsc: int) -> torch.Tensor:
    """(B, nof_bits) UCI -> (B, 14, nsc) complex64 grids of the occasion."""
    data, pilots, values = f2_layout(o)
    dev, b = bits.device, bits.shape[0]
    e = 2 * len(data)
    coded = uci.encode(bits, e)
    scr = coded ^ nr.gold_sequence(torch.tensor(o.rnti << 15 | o.n_id, device=dev), e)
    grid = torch.zeros((b, 14, nsc), dtype=torch.complex64, device=dev)
    syms, ks = (torch.tensor(v, device=dev) for v in zip(*data))
    grid[:, syms, ks] = nr.map_bits(scr, 2)
    for i, sym in enumerate(range(o.start_symbol, o.start_symbol + o.nof_symbols)):
        grid[:, sym, torch.tensor(pilots[i], device=dev)] = torch.from_numpy(values[i]).to(dev)
    return grid


def f2_receive(grid: torch.Tensor, o: F2, rnd: Precision = FLOAT32):
    """(B, P, 14, nsc) grids -> (bits (B, nof_bits) uint8, ok (B,) bool,
    snr_db (B,))."""
    data, pilots, values = f2_layout(o)
    dev = grid.device
    syms = list(range(o.start_symbol, o.start_symbol + o.nof_symbols))
    y = torch.stack([grid[:, :, s, torch.tensor(pilots[i], device=dev)]
                     for i, s in enumerate(syms)], dim=2)  # (B, P, nsym, Np)
    ls = rnd(y * torch.from_numpy(values).to(dev).conj())
    pair = ls.reshape(ls.shape[:-1] + (-1, 2)).mean(dim=-1)  # (B, P, nsym, Np/2)
    resid = ls - pair.repeat_interleave(2, dim=-1)
    noise = rnd(2.0 * (resid.abs() ** 2).mean(dim=(-2, -1)))  # (B, P)
    rsrp = (pair.abs() ** 2).mean(dim=(-2, -1))
    snr_db = rnd(10.0 * torch.log10((rsrp / noise).mean(dim=-1)))
    h = rnd(pair.mean(dim=(-2, -1)))  # (B, P): flat over the resource
    ds, dk = (torch.tensor(v, device=dev) for v in zip(*data))
    yd = grid[:, :, ds, dk]  # (B, P, Nd)
    den = (h.abs() ** 2).sum(dim=-1)
    x = rnd((h.conj()[..., None] * yd).sum(dim=1) / den[:, None])
    llr = rnd(nr.demap_soft(x, (noise.mean(dim=-1) / den)[:, None], 2))
    c = nr.gold_sequence(torch.tensor(o.rnti << 15 | o.n_id, device=dev), llr.shape[-1])
    llr = torch.where(c == 1, -llr, llr)
    bits, ok = uci.decode(llr, o.nof_bits)
    return bits, ok, snr_db
