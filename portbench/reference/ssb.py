"""The benchmark's plain SS/PBCH block transmitter (TS 38.211 7.4.2-7.4.3,
TS 38.212 7.1), at L_max 8 (case C below 6 GHz).

PSS and SSS (7.4.2.2-7.4.2.3); the PBCH payload: the 24 MIB bits and the
SFN's 4 LSBs, the half-frame bit and k_SSB's MSB (7.1.1), interleaved by
G(j), scrambled by the cell's Gold sequence at the offset of the SFN's 2nd
and 3rd LSBs, with those bits and the half-frame bit left clear (7.1.2);
CRC24C, the downlink polar code to 864 bits (``pdcch.polar_encode_dl``);
the second scrambling at the SSB index's offset (7.3.3.1), QPSK; the PBCH
DM-RS (7.4.1.4) on every fourth subcarrier from PCI mod 4; all at the
block's own subcarriers 0-239 (Table 7.4.3.1-1), unit amplitude.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import nr, pdcch

# TS 38.212 Table 7.1.1-1: the PBCH payload interleaver G(j).
G = (16, 23, 18, 17, 8, 30, 10, 6, 24, 7, 0, 5, 3, 2, 1, 4, 9, 11, 12, 13, 14, 15, 19, 20, 21,
     22, 25, 26, 27, 28, 29, 31)
A = 32
E = 864
NSC, NSYM = 240, 4


def _m_sequence(init: tuple, taps: tuple) -> np.ndarray:
    """x(i + 7) = sum of x(i + t) over taps, mod 2; x(0..6) = init."""
    x = list(init)
    for i in range(127 - 7):
        x.append(sum(x[i + t] for t in taps) % 2)
    return np.array(x, np.int64)


def pss(nid2: int) -> np.ndarray:
    x = _m_sequence((0, 1, 1, 0, 1, 1, 1), (4, 0))
    return 1.0 - 2.0 * x[(np.arange(127) + 43 * nid2) % 127]


def sss(nid1: int, nid2: int) -> np.ndarray:
    x0 = _m_sequence((1, 0, 0, 0, 0, 0, 0), (4, 0))
    x1 = _m_sequence((1, 0, 0, 0, 0, 0, 0), (1, 0))
    m0, m1 = 15 * (nid1 // 112) + 5 * nid2, nid1 % 112
    n = np.arange(127)
    return (1.0 - 2.0 * x0[(n + m0) % 127]) * (1.0 - 2.0 * x1[(n + m1) % 127])


def payload_j(mib: np.ndarray, sfn: int, hrf: int, k_ssb: int = 0) -> np.ndarray:
    """(32,) bits b_j, the payload bit that 7.1.1 writes to a'_{G(j)}: the
    SFN bits of the MIB and the SFN's 4 LSBs from j = 0, the half-frame bit
    at 10, k_SSB's MSB and two reserved bits from 11, the other MIB bits
    from 14."""
    mib = np.asarray(mib, np.uint8)
    abar = np.concatenate([mib, [(sfn >> s) & 1 for s in (3, 2, 1, 0)], [hrf & 1],
                           [(k_ssb >> 4) & 1, 0, 0]]).astype(np.uint8)
    sfn_bits = set(range(1, 7)) | set(range(24, 28))
    j_sfn, j_other = [], []
    for i, bit in enumerate(abar):
        if i in sfn_bits:
            j_sfn.append(bit)
        elif i < 24:
            j_other.append(bit)
    return np.array(j_sfn + [abar[28]] + list(abar[29:32]) + j_other, np.uint8)


@functools.lru_cache(maxsize=None)
def _first_scrambling(pci: int, v: int) -> np.ndarray:
    """s_i of 7.1.2 at L_max 4 or 8 (M = A - 3), on a'."""
    m = A - 3
    c = nr.gold_ref(pci, (v + 1) * m)[v * m:]
    clear = {G[7], G[8], G[10]}  # the SFN's 3rd and 2nd LSBs, the half-frame bit
    s, j = np.zeros(A, np.uint8), 0
    for i in range(A):
        if i not in clear:
            s[i] = c[j]
            j += 1
    return s


@functools.lru_cache(maxsize=None)
def _layout(pci: int):
    """(PBCH data REs, DM-RS REs): flat (4 * 240) indices, subcarrier then symbol."""
    v = pci % 4
    data, dmrs = [], []
    for sym, ranges in ((1, ((0, 240),)), (2, ((0, 48), (192, 240))), (3, ((0, 240),))):
        for lo, hi in ranges:
            for k in range(lo, hi):
                (dmrs if k % 4 == v else data).append(sym * NSC + k)
    return np.array(data, np.int64), np.array(dmrs, np.int64)


def block(payload: torch.Tensor, pci: int, ssb_index: int, sfn: int,
          rnd=lambda t: t) -> torch.Tensor:
    """(B, 32) payload bits b_j (``payload_j``) of SSB ``ssb_index`` in
    frame ``sfn`` -> (B, 4, 240) complex64."""
    dev = payload.device
    b = payload.shape[0]
    a1 = torch.zeros_like(payload, dtype=torch.uint8)
    a1[:, list(G)] = payload.to(torch.uint8)  # a'_{G(j)} = b_j
    v = 2 * ((sfn >> 2) & 1) + ((sfn >> 1) & 1)
    a2 = a1 ^ torch.from_numpy(_first_scrambling(pci, v)).to(dev)
    coded = pdcch.polar_encode_dl(torch.cat([a2, pdcch.crc(a2)], dim=-1), E)
    i_ssb = ssb_index & 7  # the index's 3 LSBs at L_max 8
    c2 = nr.gold_ref(pci, (i_ssb + 1) * E)[i_ssb * E:]
    syms = rnd(nr.map_bits(coded ^ torch.from_numpy(c2).to(dev), 2))
    out = torch.zeros((b, NSYM * NSC), dtype=torch.complex64, device=dev)
    data, dmrs = _layout(pci)
    out[:, torch.from_numpy(data).to(dev)] = syms
    fixed = np.zeros(NSYM * NSC, np.complex128)
    fixed[56:183] = pss(pci % 3)
    fixed[2 * NSC + 56:2 * NSC + 183] = sss(pci // 3, pci % 3)
    c_init = ((1 << 11) * (i_ssb + 1) * (pci // 4 + 1) + (1 << 6) * (i_ssb + 1) + pci % 4)
    fixed[dmrs] = pdcch.qpsk_gold(c_init, 144)
    out = out + rnd(torch.from_numpy(fixed.astype(np.complex64)).to(dev))
    return out.reshape(b, NSYM, NSC)
