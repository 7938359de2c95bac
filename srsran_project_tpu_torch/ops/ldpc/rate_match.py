"""LDPC rate matching (TS 38.212 §5.4.2).

Port of ``srsran_project_tpu/ops/ldpc/rate_match.py``.  For a static
(bg, Z, K', E, rv, Qm, N_cb) the bit selection is a handful of contiguous
runs of the circular buffer (circular start, filler splits, wrap-around),
so matching is static slices + concat, then the Qm-row block interleaver
as a reshape/transpose; dematching is the same map backwards with int8
saturation, and HARQ combining follows the reference's LLR arithmetic.
The run plans are the reference's host math, copied value for value; they
also feed the fused dematch of the decoder.  Everything here is integer,
so it is bit-exact with the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._tables import device_table
from . import graphs

# Redundancy-version starting offsets k0 = floor(num * N_cb / (den * Z)) * Z
# (TS 38.212 Table 5.4.2.1-2).
_RV_NUM = {graphs.BG1: (0, 17, 33, 56), graphs.BG2: (0, 13, 25, 43)}
_DEN = {graphs.BG1: 66, graphs.BG2: 50}

LLR_MAX = 120  # finite LLR cap
LLR_INF = 127  # marks known bits (filler positions)


def k0_offset(bg: int, z: int, rv: int, n_cb: int) -> int:
    return (_RV_NUM[bg][rv] * n_cb // (_DEN[bg] * z)) * z


@functools.lru_cache(maxsize=None)
def _filler_mask(bg: int, z: int, k_prime: int, n_cb: int) -> np.ndarray:
    g = graphs.get_graph(bg, z)
    m = np.zeros(n_cb, dtype=bool)
    m[k_prime - 2 * z : g.kb * z - 2 * z] = True
    return m


@functools.lru_cache(maxsize=None)
def _selection(bg: int, z: int, k_prime: int, e: int, rv: int, qm: int,
               n_cb: int | None) -> np.ndarray:
    g = graphs.get_graph(bg, z)
    if n_cb is None:
        n_cb = g.nof_codeword_bits
    is_filler = np.zeros(n_cb, dtype=bool)
    is_filler[k_prime - 2 * z : g.kb * z - 2 * z] = True
    order = (k0_offset(bg, z, rv, n_cb) + np.arange(n_cb)) % n_cb
    valid = order[~is_filler[order]]
    sel = np.tile(valid, -(-e // len(valid)))[:e].astype(np.int32)
    assert e % qm == 0, (e, qm)
    # Interleave: E viewed as (qm, E/qm), read column-major.
    return sel.reshape(qm, e // qm).T.reshape(-1)


_selection_on = device_table(_selection)


def selection_indices(bg: int, z: int, k_prime: int, e: int, rv: int, qm: int,
                      n_cb: int | None = None, device=None):
    """(E,) int32 gather indices into the N-bit circular buffer d: bit
    selection (circular from k0, skipping the filler positions) followed
    by the Qm-row block interleaver, out[j*qm + i] = e[i*(E/qm) + j].
    A numpy array, as the reference's, or with ``device`` a tensor there."""
    if device is None:
        return _selection(bg, z, k_prime, e, rv, qm, n_cb)
    return _selection_on(torch.device(device), bg, z, k_prime, e, rv, qm, n_cb)


@functools.lru_cache(maxsize=None)
def _valid_runs(bg: int, z: int, k_prime: int, rv: int, n_cb: int):
    """Maximal consecutive runs of the circular-buffer read order with the
    fillers skipped: ((buf_start, length), ...) in read order."""
    is_filler = _filler_mask(bg, z, k_prime, n_cb)
    order = (k0_offset(bg, z, rv, n_cb) + np.arange(n_cb)) % n_cb
    valid = order[~is_filler[order]]
    cuts = np.nonzero(np.diff(valid) != 1)[0] + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [len(valid)]])
    return tuple((int(valid[s]), int(e_ - s)) for s, e_ in zip(starts, ends))


def _chunk_segments(bg: int, z: int, k_prime: int, e: int, rv: int, n_cb: int):
    """Per-repetition-chunk segment maps for E transmitted positions:
    [[(buf_start, de_start, length), ...], ...], de indexing the
    de-interleaved stream; one chunk per pass over the usable buffer."""
    runs = _valid_runs(bg, z, k_prime, rv, n_cb)
    v = sum(ln for _, ln in runs)
    chunks = []
    off = 0
    while off < e:
        take = min(v, e - off)
        segs = []
        pos = 0
        for bs, ln in runs:
            if pos >= take:
                break
            ln_c = min(ln, take - pos)
            segs.append((bs, off + pos, ln_c))
            pos += ln_c
        chunks.append(segs)
        off += take
    return chunks


def rate_match(buffer: torch.Tensor, bg: int, z: int, k_prime: int, e: int, rv: int,
               qm: int, n_cb: int | None = None) -> torch.Tensor:
    """(..., N) codeword buffer -> (..., E) transmitted bits."""
    if n_cb is None:
        n_cb = graphs.get_graph(bg, z).nof_codeword_bits
    pieces = [buffer[..., bs : bs + ln]
              for segs in _chunk_segments(bg, z, k_prime, e, rv, n_cb)
              for bs, _ds, ln in segs]
    pre = torch.cat(pieces, dim=-1)  # (..., E) in pre-interleave order
    # Interleave: out[j*qm + i] = pre[i*(e//qm) + j].
    out = pre.reshape(pre.shape[:-1] + (qm, e // qm))
    return out.transpose(-1, -2).reshape(pre.shape[:-1] + (e,))


def _dematch_accumulate(llrs: torch.Tensor, bg: int, z: int, k_prime: int, e: int, rv: int,
                        qm: int, n_cb: int) -> torch.Tensor:
    """(..., E) int8 LLRs -> (..., N) int32 sums per buffer position, one
    term per repetition chunk (fillers and erasures left to the callers)."""
    n = graphs.get_graph(bg, z).nof_codeword_bits
    lead = llrs.shape[:-1]
    # De-interleave: de[i*(e//qm) + j] = llrs[j*qm + i].
    de = llrs.reshape(lead + (e // qm, qm)).transpose(-1, -2).reshape(lead + (e,))
    de = de.to(torch.int32)
    acc = torch.zeros(lead + (n,), dtype=torch.int32, device=llrs.device)
    for segs in _chunk_segments(bg, z, k_prime, e, rv, n_cb):
        for bs, ds, ln in segs:
            acc[..., bs : bs + ln] += de[..., ds : ds + ln]
    return acc


def _filler_mask_n(bg: int, z: int, k_prime: int, n_cb: int, device) -> torch.Tensor:
    """The filler mask padded to the full buffer length N."""
    n = graphs.get_graph(bg, z).nof_codeword_bits
    m = torch.zeros(n, dtype=torch.bool, device=device)
    m[:n_cb] = torch.from_numpy(_filler_mask(bg, z, k_prime, n_cb)).to(device)
    return m


def rate_dematch(llrs: torch.Tensor, bg: int, z: int, k_prime: int, e: int, rv: int,
                 qm: int, n_cb: int | None = None) -> torch.Tensor:
    """(..., E) int8 LLRs -> (..., N) int8 codeword-buffer LLRs: repeated
    positions add with saturation at +-LLR_MAX, fillers read +LLR_INF,
    positions never transmitted stay 0 (erasure)."""
    if n_cb is None:
        n_cb = graphs.get_graph(bg, z).nof_codeword_bits
    acc = _dematch_accumulate(llrs, bg, z, k_prime, e, rv, qm, n_cb)
    usable = sum(ln for _, ln in _valid_runs(bg, z, k_prime, rv, n_cb))
    if e > usable:  # repetition: saturate the combined sums
        acc = acc.clamp(-LLR_MAX, LLR_MAX)
    acc[..., _filler_mask_n(bg, z, k_prime, n_cb, llrs.device)] = LLR_INF
    return acc.to(torch.int8)


def rate_dematch_combine(buffer: torch.Tensor, llrs: torch.Tensor, bg: int, z: int,
                         k_prime: int, e: int, rv: int, qm: int,
                         n_cb: int | None = None) -> torch.Tensor:
    """Dematch (..., E) LLRs and add them into the codeblock buffer (...,
    N) with saturation at +-LLR_MAX; fillers keep +LLR_INF, untouched
    positions keep their value."""
    if n_cb is None:
        n_cb = graphs.get_graph(bg, z).nof_codeword_bits
    inc = _dematch_accumulate(llrs, bg, z, k_prime, e, rv, qm, n_cb)
    combined = (buffer.to(torch.int32) + inc).clamp(-LLR_MAX, LLR_MAX)
    combined[..., _filler_mask_n(bg, z, k_prime, n_cb, llrs.device)] = LLR_INF
    return combined.to(torch.int8)


def combine_harq(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Saturating int8 combine of a retransmission into the HARQ buffer:
    a == -b gives 0 (+inf + -inf included), an operand at +-LLR_INF gives
    that infinity, and otherwise the sum saturates at +-LLR_MAX."""
    a, b = old.to(torch.int16), new.to(torch.int16)
    s = (a + b).clamp(-LLR_MAX, LLR_MAX)
    s = torch.where(b.abs() == LLR_INF, b, s)
    s = torch.where(a.abs() == LLR_INF, a, s)
    return torch.where(a == -b, 0, s).to(torch.int8)
