"""Gold-sequence generator and scrambling (TS 38.211 §5.2.1).

Port of ``srsran_project_tpu/ops/scrambling.py``.  The x2 LFSR state of
block j (31 outputs per block) is seed @ M^j over GF(2); a two-level split
j = a*T + b makes every block state two float32 matmuls against small host
banks (exact: each dot is a sum of <= 31 bit products).  The seed is a
runtime tensor — c_init depends on the RNTI — so the sequence is made on
the device of that tensor.  x1's seed is fixed, so its bits are a host
constant.  ``gold_ref`` is the direct LFSR oracle.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._tables import device_table

NC = 1600
_NBITS = 31

_X1_TAPS = (0, 3)
_X2_TAPS = (0, 1, 2, 3)


def _lfsr_step_block(state: np.ndarray, taps) -> np.ndarray:
    """Advance a (..., 31) LFSR window by 31 outputs."""
    x = np.concatenate([state, np.zeros(state.shape[:-1] + (_NBITS,), np.uint8)], axis=-1)
    for i in range(_NBITS):
        acc = x[..., i + taps[0]]
        for t in taps[1:]:
            acc = acc ^ x[..., i + t]
        x[..., _NBITS + i] = acc
    return x[..., _NBITS:]


@functools.lru_cache(maxsize=None)
def _adv31_matrix(taps) -> np.ndarray:
    """M (31, 31) with s_{t+31} = s_t @ M over GF(2)."""
    return _lfsr_step_block(np.eye(_NBITS, dtype=np.uint8), taps)


def gold_ref(c_init: int, length: int) -> np.ndarray:
    """Direct LFSR spec model (oracle): c(n) for n in [0, length)."""
    total = NC + length
    x1 = np.zeros(total + _NBITS, dtype=np.uint8)
    x2 = np.zeros(total + _NBITS, dtype=np.uint8)
    x1[0] = 1
    for i in range(_NBITS):
        x2[i] = (c_init >> i) & 1
    for i in range(total):
        x1[i + _NBITS] = x1[i + 3] ^ x1[i]
        x2[i + _NBITS] = x2[i + 3] ^ x2[i + 2] ^ x2[i + 1] ^ x2[i]
    return x1[NC : NC + length] ^ x2[NC : NC + length]


@functools.lru_cache(maxsize=None)
def _two_level_mats(taps, k: int):
    """(C (T,31,31), D (ceil(k/T),31,31), T) advance-matrix banks covering
    >= k blocks: state of block a*T + b = seed @ D[a] @ C[b]."""
    t_blk = 1 << max(0, (max(k, 1) - 1).bit_length() // 2)
    nof_a = -(-k // t_blk)
    m31 = _adv31_matrix(taps).astype(np.int64)
    c = np.empty((t_blk, _NBITS, _NBITS), np.float32)
    cur = np.eye(_NBITS, dtype=np.int64)
    for b in range(t_blk):
        c[b] = cur
        cur = (cur @ m31) % 2
    m31t = cur
    d = np.empty((nof_a, _NBITS, _NBITS), np.float32)
    cur = np.eye(_NBITS, dtype=np.int64)
    for a in range(nof_a):
        d[a] = cur
        cur = (cur @ m31t) % 2
    return c, d, t_blk


@functools.lru_cache(maxsize=None)
def _x1_bits(length: int) -> np.ndarray:
    """x1 output bits (seed fixed by TS 38.211)."""
    total = NC + length
    x1 = np.zeros(total + _NBITS, dtype=np.uint8)
    x1[0] = 1
    for i in range(total):
        x1[i + _NBITS] = x1[i + 3] ^ x1[i]
    return x1[NC : NC + length]


def _flat_bank(which: int, k: int) -> np.ndarray:
    """(31, n*31) flattening of bank C (which=0) or D (which=1)."""
    bank = _two_level_mats(_X2_TAPS, k)[which]
    return bank.transpose(1, 0, 2).reshape(_NBITS, -1)


_bank_on = device_table(_flat_bank)
_x1_on = device_table(_x1_bits)
_shifts_on = device_table(lambda: np.arange(_NBITS, dtype=np.int64))


def gold_sequence(c_init: torch.Tensor, length: int) -> torch.Tensor:
    """Gold sequence c(n), n in [0, length), for (...,) integer seeds.

    Returns (..., length) uint8 bits on the seed's device."""
    k = -(-(NC + length) // _NBITS)
    dev = c_init.device
    seed = ((c_init.to(torch.int64)[..., None] >> _shifts_on(dev)) & 1).to(torch.float32)
    s_a = (seed @ _bank_on(dev, 1, k)).to(torch.int32) & 1
    s_a = s_a.to(torch.float32).reshape(c_init.shape + (-1, _NBITS))
    states = ((s_a @ _bank_on(dev, 0, k)).to(torch.int32) & 1).to(torch.uint8)
    x2 = states.reshape(c_init.shape + (-1,))[..., NC : NC + length]
    return x2 ^ _x1_on(dev, length)


def scramble_bits(bits: torch.Tensor, c_init: torch.Tensor) -> torch.Tensor:
    """(..., N) bits XOR the Gold sequence of the (...,) seeds."""
    return bits.to(torch.uint8) ^ gold_sequence(c_init, bits.shape[-1])


def descramble_llrs(llrs: torch.Tensor, c_init: torch.Tensor) -> torch.Tensor:
    """Flip the sign of (..., N) int8 LLRs where the sequence bit of the
    (...,) seeds is 1 (``flip_llrs``)."""
    return flip_llrs(llrs, gold_sequence(c_init, llrs.shape[-1]))


def flip_llrs(llrs: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """Flip the sign of (..., N) int8 LLRs where the (..., N) sequence bit
    is 1; a flipped -128 saturates to +127 to stay in int8."""
    flipped = torch.where(llrs == -128, 127, -(llrs.to(torch.int16))).to(torch.int8)
    return torch.where(seq == 1, flipped, llrs)
