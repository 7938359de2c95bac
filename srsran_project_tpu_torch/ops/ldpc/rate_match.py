"""LDPC rate matching (TS 38.212 §5.4.2).

Port of ``srsran_project_tpu/ops/ldpc/rate_match.py``.  For a static
(bg, Z, K', E, rv, Qm, N_cb) the bit selection is a handful of contiguous
runs of the circular buffer (circular start, filler splits, wrap-around),
so matching is static slices + concat, then the Qm-row block interleaver
as a reshape/transpose.  The run plans are the reference's host math,
copied value for value; they also feed the fused dematch of the decoder.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srsran_project_tpu.ops.ldpc import graphs

# Redundancy-version starting offsets k0 = floor(num * N_cb / (den * Z)) * Z
# (TS 38.212 Table 5.4.2.1-2).
_RV_NUM = {graphs.BG1: (0, 17, 33, 56), graphs.BG2: (0, 13, 25, 43)}
_DEN = {graphs.BG1: 66, graphs.BG2: 50}


def k0_offset(bg: int, z: int, rv: int, n_cb: int) -> int:
    return (_RV_NUM[bg][rv] * n_cb // (_DEN[bg] * z)) * z


@functools.lru_cache(maxsize=None)
def _filler_mask(bg: int, z: int, k_prime: int, n_cb: int) -> np.ndarray:
    g = graphs.get_graph(bg, z)
    m = np.zeros(n_cb, dtype=bool)
    m[k_prime - 2 * z : g.kb * z - 2 * z] = True
    return m


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
