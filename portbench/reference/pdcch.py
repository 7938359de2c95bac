"""The benchmark's plain PDCCH transmitter and the downlink polar code it
shares with the PBCH (``ssb.py``).

TS 38.212 7.3.2-7.3.4: 24 ones prepended to the DCI, CRC24C (5.1), the
last 16 CRC bits masked by the RNTI, the ones dropped; the input
interleaver (5.3.1.1, I_IL = 1); polar coding with n_max 9 and no
parity-check bits (5.3.1); rate matching by sub-block interleaving and bit
selection without the channel interleaver (5.4.1, I_BIL = 0).  TS 38.211
7.3.2: scrambling with c_init = n_RNTI 2^16 + n_ID, QPSK, the CCEs' REGs
(time first in the CORESET, bundles interleaved or not, 7.3.2.2) filled
frequency first then symbol, outside the DM-RS, which sits on every fourth
RE from subcarrier 1 (7.4.1.3), its sequence counted from CRB 0.

The polar construction (``uci.polar_plan``: N, the frozen set, the rate
matcher's selection) is the uplink reference's at n_max 9.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import nr, uci

# Float32 products stay float32 on the card (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# CRC24C of TS 38.212 5.1: D^24 + D^23 + D^21 + D^20 + D^17 + D^15 + D^13 + D^12
# + D^8 + D^4 + D^2 + D + 1.
CRC24C = (0x1B2B117, 24)
# TS 38.212 Table 5.3.1.1-1: the input interleaver's pattern for K_IL^max = 164.
PI_IL_MAX = (
    0, 2, 4, 7, 9, 14, 19, 20, 24, 25, 26, 28, 31, 34, 42, 45, 49, 50, 51, 53, 54, 56, 58, 59,
    61, 62, 65, 66, 67, 69, 70, 71, 72, 76, 77, 81, 82, 83, 87, 88, 89, 91, 93, 95, 98, 101,
    104, 106, 108, 110, 111, 113, 115, 118, 119, 120, 122, 123, 126, 127, 129, 132, 134, 138,
    139, 140, 1, 3, 5, 8, 10, 15, 21, 27, 29, 32, 35, 43, 46, 52, 55, 57, 60, 63, 68, 73, 78,
    84, 90, 92, 94, 96, 99, 102, 105, 107, 109, 112, 114, 116, 121, 124, 128, 130, 133, 135,
    141, 6, 11, 16, 22, 30, 33, 36, 44, 47, 64, 74, 79, 85, 97, 100, 103, 117, 125, 131, 136,
    142, 12, 17, 23, 37, 48, 75, 80, 86, 137, 143, 13, 18, 38, 144, 39, 145, 40, 146, 41, 147,
    148, 149, 150, 151, 152, 153, 154, 155, 156, 157, 158, 159, 160, 161, 162, 163,
)
N_MAX_DL = 9


def crc(bits: torch.Tensor, poly: tuple = CRC24C) -> torch.Tensor:
    """(..., L) bits -> (..., n) CRC parity bits, by long division."""
    p, n = poly
    taps = torch.tensor([(p >> (n - 1 - i)) & 1 for i in range(n)], dtype=torch.uint8,
                        device=bits.device)
    reg = torch.zeros(bits.shape[:-1] + (n,), dtype=torch.uint8, device=bits.device)
    for i in range(bits.shape[-1]):
        fb = reg[..., 0] ^ bits[..., i].to(torch.uint8)
        reg = torch.cat([reg[..., 1:], torch.zeros_like(reg[..., :1])], dim=-1)
        reg = reg ^ (fb[..., None] * taps)
    return reg


@functools.lru_cache(maxsize=None)
def input_interleaver(k: int) -> tuple:
    """Pi(k) of 5.3.1.1: c'_i = c_{Pi(i)}."""
    off = len(PI_IL_MAX) - k
    return tuple(p - off for p in PI_IL_MAX if p >= off)


def polar_encode_dl(c: torch.Tensor, e: int) -> torch.Tensor:
    """(..., K) bits with their CRC -> (..., E) rate-matched polar bits:
    input interleaved, coded on N (n_max 9), sub-block interleaved and
    selected (repetition, puncturing or shortening)."""
    k = c.shape[-1]
    big_n, info, idx = uci.polar_plan(k, e, N_MAX_DL)
    u = torch.zeros(c.shape[:-1] + (big_n,), dtype=torch.uint8, device=c.device)
    u[..., list(info)] = c[..., list(input_interleaver(k))].to(torch.uint8)
    return uci._transform(u)[..., torch.from_numpy(idx).to(c.device)]


def rnti_bits(rnti: torch.Tensor) -> torch.Tensor:
    """(...,) RNTIs -> (..., 16) bits, the most significant first."""
    shifts = torch.arange(15, -1, -1, device=rnti.device)
    return ((rnti.to(torch.int64)[..., None] >> shifts) & 1).to(torch.uint8)


def dci_codeword(dci: torch.Tensor, rnti: torch.Tensor, e: int) -> torch.Tensor:
    """(..., A) DCI bits and (...,) RNTIs -> (..., E) coded bits (7.3.2-7.3.4)."""
    a = dci.to(torch.uint8)
    ones = torch.ones(a.shape[:-1] + (24,), dtype=torch.uint8, device=a.device)
    p = crc(torch.cat([ones, a], dim=-1))
    p = torch.cat([p[..., :8], p[..., 8:] ^ rnti_bits(rnti)], dim=-1)
    return polar_encode_dl(torch.cat([a, p], dim=-1), e)


@dataclasses.dataclass(frozen=True)
class Coreset:
    """A CORESET on the carrier: from CRB ``rb_start`` (a multiple of 6),
    ``rb_count`` PRBs, ``duration`` symbols from ``symbol``; REG bundles of
    ``bundle`` REGs, interleaved over ``rows`` rows with ``shift``, or not."""

    rb_start: int
    rb_count: int
    symbol: int = 0
    duration: int = 1
    interleaved: bool = False
    bundle: int = 6
    rows: int = 2
    shift: int = 0

    @property
    def nof_regs(self) -> int:
        return self.rb_count * self.duration


@dataclasses.dataclass(frozen=True)
class Dci:
    """One PDCCH: ``bits`` DCI bits at aggregation level ``level`` from CCE
    ``cce``; DM-RS scrambled by ``n_id``, data by ``n_id`` and ``n_rnti``."""

    bits: int
    level: int
    cce: int
    n_id: int
    n_rnti: int

    @property
    def e(self) -> int:
        return self.level * 6 * 9 * 2  # L CCEs x 6 REGs x 9 data REs x QPSK


@functools.lru_cache(maxsize=None)
def cce_regs(cs: Coreset, first_cce: int, level: int) -> tuple:
    """The REGs (CORESET numbering) of CCEs first_cce .. first_cce + level - 1."""
    n_bundle = cs.nof_regs // cs.bundle
    if cs.interleaved:
        c_cols = n_bundle // cs.rows
        f = {}
        for c in range(c_cols):
            for r in range(cs.rows):
                f[c * cs.rows + r] = (r * c_cols + c + cs.shift) % n_bundle
    else:
        f = {x: x for x in range(n_bundle)}
    per_cce = 6 // cs.bundle
    regs = []
    for j in range(first_cce, first_cce + level):
        for b in range(per_cce):
            bundle = f[j * per_cce + b]
            regs += range(bundle * cs.bundle, (bundle + 1) * cs.bundle)
    return tuple(regs)


@functools.lru_cache(maxsize=None)
def layout(cs: Coreset, d: Dci, nof_sc: int):
    """(data REs, DM-RS REs, DM-RS sequence index, DM-RS symbol): flat
    (14 * nof_sc) indices, data in mapping order (symbol, then
    subcarrier), DM-RS likewise."""
    data, pilots = [], []
    for reg in cce_regs(cs, d.cce, d.level):
        sym = cs.symbol + reg % cs.duration
        crb = cs.rb_start + reg // cs.duration
        for k in range(nr.NRE):
            at = (sym, crb * nr.NRE + k)
            if k % 4 == 1:
                pilots.append(at + (3 * crb + k // 4,))
            else:
                data.append(at)
    data.sort()
    pilots.sort()
    return (np.array([s * nof_sc + k for s, k in data], np.int64),
            np.array([s * nof_sc + k for s, k, _ in pilots], np.int64),
            np.array([m for _, _, m in pilots], np.int64),
            np.array([s for s, _, _ in pilots], np.int64))


def qpsk_gold(c_init: int, length: int) -> np.ndarray:
    """(length,) complex128 QPSK values of a Gold sequence (7.4.1)."""
    c = nr.gold_ref(c_init, 2 * length).astype(np.float64)
    return ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)


def dmrs_c_init(slot: int, sym: int, n_id: int) -> int:
    return ((1 << 17) * (14 * slot + sym + 1) * (2 * n_id + 1) + 2 * n_id) % (1 << 31)


def grid(cs: Coreset, d: Dci, dci: torch.Tensor, rnti: torch.Tensor, nof_sc: int,
         slot: int = 0, rnd=lambda t: t) -> torch.Tensor:
    """(B, A) DCI bits and (B,) RNTIs -> (B, 14, nof_sc) complex64: the
    PDCCH and its DM-RS on one port."""
    dev = dci.device
    b = dci.shape[0]
    coded = dci_codeword(dci, rnti, d.e)
    c_init = torch.full((b,), (d.n_rnti * (1 << 16) + d.n_id) % (1 << 31), device=dev)
    syms = rnd(nr.map_bits(coded ^ nr.gold_sequence(c_init, d.e), 2))
    data, pilots, seq, psym = layout(cs, d, nof_sc)
    vals = np.zeros(len(pilots), np.complex128)
    for sym in np.unique(psym):
        r = qpsk_gold(dmrs_c_init(slot, int(sym), d.n_id), int(seq.max()) + 1)
        vals[psym == sym] = r[seq[psym == sym]]
    out = torch.zeros((b, 14 * nof_sc), dtype=torch.complex64, device=dev)
    out[:, torch.from_numpy(data).to(dev)] = syms
    out[:, torch.from_numpy(pilots).to(dev)] = rnd(
        torch.from_numpy(vals.astype(np.complex64)).to(dev))
    return out.reshape(b, 14, nof_sc)
