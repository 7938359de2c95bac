"""The benchmark's plain UCI codes (TS 38.212 6.3.1): Reed-Muller for 3 to
11 bits (5.3.3.3, rate matched by repetition, 5.4.3) and polar with CRC11
for 20 bits and more (5.3.1, 5.4.1, 6.3.1.2), encoded and decoded.

The polar reliability sequence (Table 5.3.1.2-1) and the Reed-Muller basis
(Table 5.3.3.3-1) are data, in ``control_tables.npz``.  The decoders are
the plain textbook ones: Reed-Muller by maximum likelihood over all 2^K
codewords, polar by successive cancellation (min-sum) with the CRC
checked on the decoded bits.  Departures from the spec: the spec defines
no receiver, so the Reed-Muller verdict is this reference's own, the
winning correlation over the sum of the LLR magnitudes above
``RM_DTX_THRESHOLD``.  Covered: 3 to 11 bits, and 20 to 359 bits on one
polar segment without parity-check bits.
"""

from __future__ import annotations

import functools
import math
import pathlib

import numpy as np
import torch

# Float32 products stay float32 on the card (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_TABLES = pathlib.Path(__file__).resolve().parent / "control_tables.npz"

# The Reed-Muller verdict: normalized correlation of the ML codeword.
RM_DTX_THRESHOLD = 0.2
# CRC11 of UCI (TS 38.212 5.1): D^11 + D^10 + D^9 + D^5 + 1.
CRC11 = (0b111000100001, 11)
# Sub-block interleaver pattern P(i) (TS 38.212 Table 5.4.1.1-1).
SUBBLOCK_P = (0, 1, 2, 4, 3, 5, 6, 7, 8, 16, 9, 17, 10, 18, 11, 19, 12, 20, 13, 21, 14, 22, 15,
              23, 24, 25, 26, 28, 27, 29, 30, 31)


@functools.lru_cache(maxsize=1)
def tables() -> dict:
    with np.load(_TABLES) as d:
        return {k: d[k] for k in d.files}


# ---- CRC --------------------------------------------------------------------------

def crc11(bits: torch.Tensor) -> torch.Tensor:
    """(..., A) bits -> (..., 11) CRC parity bits, by long division."""
    poly, n = CRC11
    taps = torch.tensor([(poly >> (n - 1 - i)) & 1 for i in range(n)], dtype=torch.uint8,
                        device=bits.device)
    reg = torch.zeros(bits.shape[:-1] + (n,), dtype=torch.uint8, device=bits.device)
    for i in range(bits.shape[-1]):
        fb = reg[..., 0] ^ bits[..., i].to(torch.uint8)
        reg = torch.cat([reg[..., 1:], torch.zeros_like(reg[..., :1])], dim=-1)
        reg = reg ^ (fb[..., None] * taps)
    return reg


# ---- Reed-Muller (5.3.3.3, 5.4.3) -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rm_codebook(k: int):
    """(messages (2^K, K) a_0..a_{K-1}, codewords (2^K, 32))."""
    msgs = ((np.arange(1 << k)[:, None] >> np.arange(k)) & 1).astype(np.uint8)
    basis = tables()["reed_muller_basis_32x11"][:, :k]  # (32, K): M_{i,n}
    return msgs, (msgs.astype(np.int64) @ basis.T.astype(np.int64)) % 2


def rm_encode(bits: torch.Tensor, e: int) -> torch.Tensor:
    """(..., K) bits, 3 <= K <= 11 -> (..., E) coded bits."""
    basis = torch.from_numpy(tables()["reed_muller_basis_32x11"][:, :bits.shape[-1]]).to(
        bits.device)
    d = (bits.to(torch.uint8)[..., None, :] * basis).sum(dim=-1) % 2  # (..., 32)
    return d[..., torch.arange(e, device=bits.device) % 32].to(torch.uint8)


def rm_decode(llrs: torch.Tensor, k: int):
    """(..., E) LLRs (positive = bit 0) -> (bits (..., K) uint8, ok (...,)
    bool): the repetitions summed onto the 32 positions, every codeword
    scored by its correlation, the best one's verdict its score over the
    sum of the magnitudes."""
    e = llrs.shape[-1]
    msgs, words = _rm_codebook(k)
    folded = torch.zeros(llrs.shape[:-1] + (32,), dtype=torch.float32, device=llrs.device)
    folded = folded.index_add(-1, torch.arange(e, device=llrs.device) % 32,
                              llrs.to(torch.float32))
    signs = torch.from_numpy(1.0 - 2.0 * words.astype(np.float32)).to(llrs.device)
    scores = (folded[..., None, :] * signs).sum(dim=-1)  # (..., 2^K)
    best = scores.argmax(dim=-1)
    metric = scores.gather(-1, best[..., None])[..., 0] / (folded.abs().sum(dim=-1) + 1e-9)
    return torch.from_numpy(msgs).to(llrs.device)[best], metric > RM_DTX_THRESHOLD


# ---- polar (5.3.1, 5.4.1) ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def polar_plan(k: int, e: int, n_max: int = 10):
    """(N, information positions ascending, the rate matcher's (E,) indices
    into d) of K bits (CRC included) on E bits; repetition and
    puncturing/shortening as 5.4.1.1, frozen set as 5.3.1.2 without
    parity-check bits."""
    lg = math.ceil(math.log2(e))
    n1 = lg - 1 if (e <= 9 / 8 * 2 ** (lg - 1) and k / e < 9 / 16) else lg
    n = max(min(n1, math.ceil(math.log2(8 * k)), n_max), 5)
    big_n = 1 << n
    sub = big_n // 32
    j = np.array([SUBBLOCK_P[(32 * i) // big_n] * sub + i % sub for i in range(big_n)])
    frozen_rm = set()
    if e < big_n:
        if 16 * k <= 7 * e:  # puncturing
            frozen_rm |= set(j[:big_n - e].tolist())
            t = (math.ceil(3 * big_n / 4 - e / 2) if e >= 3 * big_n / 4
                 else math.ceil(9 * big_n / 16 - e / 4))
            frozen_rm |= set(range(t))
            idx = j[big_n - e:]
        else:  # shortening
            frozen_rm |= set(j[e:].tolist())
            idx = j[:e]
    else:  # repetition
        idx = j[np.arange(e) % big_n]
    q = [int(i) for i in tables()["polar_reliability_1024"] if i < big_n]
    usable = [i for i in q if i not in frozen_rm]
    return big_n, tuple(sorted(usable[-k:])), idx


def _transform(u: torch.Tensor) -> torch.Tensor:
    """x = u G_N over GF(2), G_N the n-fold Kronecker power of [[1, 0], [1, 1]]."""
    x = u.clone()
    n = x.shape[-1]
    half = 1
    while half < n:
        x = x.reshape(x.shape[:-1] + (n // (2 * half), 2, half))
        x = torch.stack([x[..., 0, :] ^ x[..., 1, :], x[..., 1, :]], dim=-2)
        x = x.reshape(x.shape[:-3] + (n,))
        half *= 2
    return x


def channel_interleave_indices(e: int) -> np.ndarray:
    """f_k = e_{perm[k]}: the triangular interleaver (5.4.1.3, I_BIL = 1)."""
    t = 0
    while t * (t + 1) // 2 < e:
        t += 1
    v = {}
    k = 0
    for i in range(t):
        for jj in range(t - i):
            if k < e:
                v[(i, jj)] = k
            k += 1
    return np.array([v[(i, jj)] for jj in range(t) for i in range(t - jj) if (i, jj) in v])


def polar_encode(bits: torch.Tensor, e: int) -> torch.Tensor:
    """(..., A) bits, 20 <= A < 360 -> (..., E) coded bits: CRC11 appended,
    polar coded, rate matched and channel interleaved."""
    c = torch.cat([bits.to(torch.uint8), crc11(bits)], dim=-1)
    big_n, info, idx = polar_plan(c.shape[-1], e)
    u = torch.zeros(c.shape[:-1] + (big_n,), dtype=torch.uint8, device=bits.device)
    u[..., list(info)] = c
    rm = _transform(u)[..., torch.from_numpy(idx).to(bits.device)]
    return rm[..., torch.from_numpy(channel_interleave_indices(e)).to(bits.device)]


def _sc(llr: torch.Tensor, frozen: np.ndarray, out: list):
    """Successive cancellation on (..., n) LLRs: appends the decided u bits
    to ``out`` and returns this node's codeword bits."""
    n = llr.shape[-1]
    if n == 1:
        if frozen[0]:
            bit = torch.zeros(llr.shape, dtype=torch.uint8, device=llr.device)
        else:
            bit = (llr < 0).to(torch.uint8)
        out.append(bit)
        return bit
    a, b = llr[..., :n // 2], llr[..., n // 2:]
    f = torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())
    left = _sc(f, frozen[:n // 2], out)
    g = b + (1.0 - 2.0 * left.to(torch.float32)) * a
    right = _sc(g, frozen[n // 2:], out)
    return torch.cat([left ^ right, right], dim=-1)


def polar_decode(llrs: torch.Tensor, a: int):
    """(..., E) LLRs -> (bits (..., A) uint8, CRC ok (...,) bool)."""
    e = llrs.shape[-1]
    k = a + CRC11[1]
    big_n, info, idx = polar_plan(k, e)
    dev = llrs.device
    inv = torch.empty(e, dtype=torch.int64)
    inv[torch.from_numpy(channel_interleave_indices(e))] = torch.arange(e)
    x = llrs.to(torch.float32)[..., inv.to(dev)]  # de-interleaved e
    # Repetitions summed; punctured bits unknown (0), shortened ones known 0.
    known = np.zeros(big_n, dtype=np.float32)
    if e < big_n and 16 * k > 7 * e:
        known[np.setdiff1d(np.arange(big_n), idx)] = 1e9
    d = torch.from_numpy(known).to(dev).expand(llrs.shape[:-1] + (big_n,))
    d = d.index_add(-1, torch.from_numpy(idx).to(dev), x)
    frozen = np.ones(big_n, dtype=bool)
    frozen[list(info)] = False
    out: list = []
    _sc(d, frozen, out)
    u = torch.cat(out, dim=-1)[..., list(info)]
    ok = (crc11(u[..., :a]) == u[..., a:]).all(dim=-1)
    return u[..., :a], ok


# ---- UCI (6.3.1) -------------------------------------------------------------------

def encode(bits: torch.Tensor, e: int) -> torch.Tensor:
    a = bits.shape[-1]
    if 3 <= a <= 11:
        return rm_encode(bits, e)
    if 20 <= a < 360:
        return polar_encode(bits, e)
    raise ValueError(f"the reference's UCI covers 3-11 and 20-359 bits, not {a}")


def decode(llrs: torch.Tensor, a: int):
    if 3 <= a <= 11:
        return rm_decode(llrs, a)
    if 20 <= a < 360:
        return polar_decode(llrs, a)
    raise ValueError(f"the reference's UCI covers 3-11 and 20-359 bits, not {a}")
