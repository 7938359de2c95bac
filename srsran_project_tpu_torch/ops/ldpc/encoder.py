"""LDPC encoder (TS 38.212 §5.3.2), batched.

Port of ``srsran_project_tpu/ops/ldpc/encoder.py``: every base-graph
edge's "pick block c, rotate by s" is one row of a precomputed flat gather
table, so the syndromes of all check rows over the message columns are one
gather plus a popcount mod 2; the double-diagonal core is solved in closed
form; the extension parity rows are a second gather over [message | core
parity].  With LBRM (``n_cb``) the extension rows beyond the circular
buffer are not computed and read 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .graphs import LdpcGraph, get_graph

from .._tables import device_table


def _core_p0_rotation(graph: LdpcGraph) -> int:
    """Rotation r with roll(p0, -r) = XOR of the four core-row syndromes."""
    shifts = [s for s in graph.shifts[:4, graph.kb] if s >= 0]
    assert len(shifts) == 3, shifts
    a, b, c = sorted(shifts)
    if a == b:
        return c
    if b == c:
        return a
    raise AssertionError(f"unexpected p0 column shifts {shifts}")


@functools.lru_cache(maxsize=None)
def _gather_tables(bg: int, z: int):
    """(core_idx (4, D1, Z), ext_idx (M-4, D2, Z), core_back, rot): flat
    gather tables into [message | sink] and [message | core parity | sink],
    the back-substitution edges of core rows 0..2, and the p0 rotation."""
    g = get_graph(bg, z)
    kb, m = g.kb, g.m
    zidx = np.arange(z)

    def build(rows, max_col, sink):
        edge_lists = [[(c, s) for c, s in g.row_edges(r) if c < max_col] for r in rows]
        dmax = max(len(e) for e in edge_lists)
        idx = np.full((len(rows), dmax, z), sink, dtype=np.int32)
        for i, edges in enumerate(edge_lists):
            for e, (col, shift) in enumerate(edges):
                idx[i, e] = col * z + (zidx + shift) % z
        return idx

    core_idx = build(range(4), kb, kb * z)
    ext_idx = build(range(4, m), kb + 4, (kb + 4) * z)
    core_back = [[(c - kb, s) for c, s in g.row_edges(row) if c >= kb] for row in range(3)]
    return core_idx, ext_idx, core_back, _core_p0_rotation(g)


def _nof_ext_rows(g: LdpcGraph, n_cb: int | None) -> int:
    if n_cb is not None and n_cb < g.nof_codeword_bits:
        return max(0, -(-(n_cb + 2 * g.z) // g.z) - g.kb - 4)
    return g.m - 4


_core_idx_on = device_table(lambda bg, z: _gather_tables(bg, z)[0].astype(np.int64).reshape(-1))
_ext_idx_on = device_table(
    lambda bg, z, rows: _gather_tables(bg, z)[1][:rows].astype(np.int64).reshape(-1))


def encode(message: torch.Tensor, bg: int, z: int, n_cb: int | None = None) -> torch.Tensor:
    """(..., K_b*Z) message bits (fillers already 0) -> (..., n*Z) codeword
    over ALL variable nodes, the 2Z punctured ones included."""
    g = get_graph(bg, z)
    kb, m = g.kb, g.m
    batch = message.shape[:-1]
    dev = message.device
    _, ext_np, core_back, rot = _gather_tables(bg, z)
    nof_ext = _nof_ext_rows(g, n_cb)

    msg = message.to(torch.uint8)
    sink = torch.zeros(batch + (1,), dtype=torch.uint8, device=dev)

    def accumulate(flat, idx, rows):
        gathered = flat[..., idx].reshape(batch + (rows, -1, z))
        return (gathered.sum(dim=-2, dtype=torch.int32) & 1).to(torch.uint8)

    s_core = accumulate(torch.cat([msg, sink], dim=-1), _core_idx_on(dev, bg, z), 4)
    total = s_core[..., 0, :] ^ s_core[..., 1, :] ^ s_core[..., 2, :] ^ s_core[..., 3, :]
    parity = [torch.roll(total, rot, dims=-1)]
    for row in range(3):
        acc = s_core[..., row, :]
        for col_off, shift in core_back[row]:
            if col_off < len(parity):
                acc = acc ^ torch.roll(parity[col_off], -shift, dims=-1)
        parity.append(acc)

    head = torch.cat([msg, *parity], dim=-1)  # (..., (kb+4)*Z)
    pieces = [head]
    if nof_ext:
        pieces.append(accumulate(torch.cat([head, sink], dim=-1),
                                 _ext_idx_on(dev, bg, z, nof_ext), nof_ext)
                      .reshape(batch + (nof_ext * z,)))
    if nof_ext < m - 4:
        pieces.append(torch.zeros(batch + ((m - 4 - nof_ext) * z,), dtype=torch.uint8,
                                  device=dev))
    out = torch.cat(pieces, dim=-1)
    assert out.shape[-1] == g.n * z
    return out


def encode_to_buffer(message: torch.Tensor, bg: int, z: int,
                     n_cb: int | None = None) -> torch.Tensor:
    """Encode and drop the 2Z punctured systematic bits: the rate-matching
    circular buffer d_0..d_{N-1} of TS 38.212 §5.4.2.1."""
    return encode(message, bg, z, n_cb=n_cb)[..., 2 * z :]
