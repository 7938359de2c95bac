"""CRC calculators for 5G NR (TS 38.212 §5.1).

Port of ``srsran_project_tpu/ops/crc.py``.  A CRC over GF(2) is a linear
map of the message bits, so for a fixed length L it is ``(bits @ A) mod 2``
with A an (L, crc_len) 0/1 matrix.  The matmuls run in float32: every
product is 0 or 1 and every sum is an integer count far below 2^24, so
the result is exact (also under TF32, whose 10-bit mantissa holds 0 and 1
exactly and which accumulates in float32).  Megabit transport blocks take
the chunked path: 1024-bit chunk CRCs, then one fold matmul.

The generator, advance and fold matrices are the reference's host math,
copied value for value; ``crc_ref`` is the long-division oracle.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._tables import device_table

# Generator polynomials, including the leading x^len term (TS 38.212 §5.1).
POLYS = {
    "24A": (0x1864CFB, 24),
    "24B": (0x1800063, 24),
    "24C": (0x1B2B117, 24),
    "16": (0x11021, 16),
    "11": (0xE21, 11),
    "6": (0x61, 6),
}


def crc_ref(bits, name: str) -> np.ndarray:
    """Bit-exact long-division CRC (spec model / oracle): 1-D MSB-first
    0/1 message -> (crc_len,) uint8, MSB first."""
    poly, n = POLYS[name]
    reg = 0
    for b in np.asarray(bits, dtype=np.uint8):
        reg = (reg << 1) | int(b)
        if reg >> n:
            reg ^= poly
    for _ in range(n):
        reg <<= 1
        if reg >> n:
            reg ^= poly
    return np.array([(reg >> (n - 1 - i)) & 1 for i in range(n)], dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def generator_matrix(name: str, length: int) -> np.ndarray:
    """(length, crc_len) uint8 matrix A with A[i] = crc(e_i)."""
    poly, n = POLYS[name]
    out = np.empty((length, n), dtype=np.uint8)
    r = 1
    for _ in range(n):
        r <<= 1
        if r >> n:
            r ^= poly
    for k in range(length):
        out[length - 1 - k] = [(r >> (n - 1 - i)) & 1 for i in range(n)]
        r <<= 1
        if r >> n:
            r ^= poly
    return out


_CHUNK = 1024
# Messages up to this length take ONE generator matmul; longer ones (the
# megabit TB CRC) take the chunk-and-fold path.
_DIRECT_MAX = 16384


@functools.lru_cache(maxsize=None)
def _advance_matrix(name: str, nof_bits: int) -> np.ndarray:
    """(n, n) GF(2) matrix advancing a CRC state by nof_bits zero bits
    (nof_bits = _CHUNK * 2^j, built by squaring)."""
    poly, n = POLYS[name]
    if nof_bits > _CHUNK:
        assert nof_bits % 2 == 0
        t = _advance_matrix(name, nof_bits // 2)
        return (t.astype(np.int64) @ t.astype(np.int64) % 2).astype(np.uint8)
    out = np.empty((n, n), dtype=np.uint8)
    for b in range(n):
        r = 1 << (n - 1 - b)
        for _ in range(nof_bits):
            r <<= 1
            if r >> n:
                r ^= poly
        out[b] = [(r >> (n - 1 - i)) & 1 for i in range(n)]
    return out


@functools.lru_cache(maxsize=None)
def _fold_matrix(name: str, nof_chunks: int) -> np.ndarray:
    """(nof_chunks * n, n) fold matrix: row block j advances chunk j's
    partial CRC by the (nof_chunks-1-j) chunks that follow it."""
    _, n = POLYS[name]
    t_chunk = _advance_matrix(name, _CHUNK).astype(np.int64)
    out = np.empty((nof_chunks, n, n), dtype=np.uint8)
    cur = np.eye(n, dtype=np.int64)
    for j in range(nof_chunks):
        out[nof_chunks - 1 - j] = cur.astype(np.uint8)
        cur = (cur @ t_chunk) % 2
    return out.reshape(nof_chunks * n, n)


@functools.lru_cache(maxsize=None)
def _span_advance_matrix(name: str, nof_bits: int) -> np.ndarray:
    """(n, n) GF(2) advance matrix for an arbitrary span."""
    poly, n = POLYS[name]
    t1 = np.empty((n, n), dtype=np.int64)
    for b in range(n):
        r = (1 << (n - 1 - b)) << 1
        if r >> n:
            r ^= poly
        t1[b] = [(r >> (n - 1 - i)) & 1 for i in range(n)]
    acc = np.eye(n, dtype=np.int64)
    p = t1
    s = nof_bits
    while s:
        if s & 1:
            acc = (acc @ p) % 2
        p = (p @ p) % 2
        s >>= 1
    return acc.astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _concat_fold_matrix(name: str, nof_chunks: int, chunk_bits: int) -> np.ndarray:
    """(nof_chunks * n, n) fold matrix for equal chunk_bits-long chunks."""
    _, n = POLYS[name]
    t = _span_advance_matrix(name, chunk_bits).astype(np.int64)
    out = np.empty((nof_chunks, n, n), dtype=np.uint8)
    cur = np.eye(n, dtype=np.int64)
    for j in range(nof_chunks):
        out[nof_chunks - 1 - j] = cur.astype(np.uint8)
        cur = (cur @ t) % 2
    return out.reshape(nof_chunks * n, n)


_gen_f32 = device_table(lambda name, length: generator_matrix(name, length).astype(np.float32))
_fold_f32 = device_table(lambda name, k: _fold_matrix(name, k).astype(np.float32))
_concat_fold_f32 = device_table(
    lambda name, k, length: _concat_fold_matrix(name, k, length).astype(np.float32))


def _mod2(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32) & 1


def crc(bits: torch.Tensor, name: str) -> torch.Tensor:
    """CRC of (..., L) 0/1 messages -> (..., crc_len) uint8, MSB first."""
    length = bits.shape[-1]
    n = POLYS[name][1]
    dev = bits.device
    if length <= _DIRECT_MAX:
        return _mod2(bits.to(torch.float32) @ _gen_f32(dev, name, length)).to(torch.uint8)
    # Leading zeros do not change a CRC: front-pad to whole chunks.
    k = -(-length // _CHUNK)
    x = torch.nn.functional.pad(bits.to(torch.float32), (k * _CHUNK - length, 0))
    x = x.reshape(x.shape[:-1] + (k, _CHUNK))
    part = _mod2(x @ _gen_f32(dev, name, _CHUNK)).to(torch.float32)  # (..., k, n)
    if k == 1:
        return part[..., 0, :].to(torch.uint8)
    flat = part.reshape(part.shape[:-2] + (k * n,))
    return _mod2(flat @ _fold_f32(dev, name, k)).to(torch.uint8)


def crc_check_concat(chunks: torch.Tensor, name: str) -> torch.Tensor:
    """CRC pass/fail of the concatenation of equal-length chunks
    (..., C, L) 0/1 -> (...,) bool, without building the stream.  Trailing
    zero padding in the stream does not change the verdict."""
    c, length = chunks.shape[-2], chunks.shape[-1]
    n = POLYS[name][1]
    dev = chunks.device
    part = _mod2(chunks.to(torch.float32) @ _gen_f32(dev, name, length)).to(torch.float32)
    comb = _mod2(part.reshape(part.shape[:-2] + (c * n,))
                 @ _concat_fold_f32(dev, name, c, length))
    return comb.sum(dim=-1) == 0


def crc_append(bits: torch.Tensor, name: str) -> torch.Tensor:
    """(..., L) -> (..., L + crc_len) message with its CRC attached."""
    return torch.cat([bits.to(torch.uint8), crc(bits, name)], dim=-1)


def crc_check(bits_with_crc: torch.Tensor, name: str) -> torch.Tensor:
    """Per-message CRC pass/fail of (..., L + crc_len) inputs -> (...,) bool."""
    return (crc(bits_with_crc, name) == 0).all(dim=-1)
