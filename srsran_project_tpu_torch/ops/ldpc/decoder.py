"""Fused LDPC rate dematch + layered normalized min-sum decode (kernel K1).

Port of ``decode_dematch_pallas`` (srsran_project_tpu/ops/ldpc/
decoder_pallas.py) with the numerics of ``ops/ldpc/decoder.py``: f32 state,
channel LLRs clamped to +-64, punctured 2Z prefix and erasures at 0,
fillers at +64, scaling 0.8 with the duplicate-minimum rule, hard bit = 1
iff the a-posteriori LLR < 0.  Only the check rows that can reach the
message bits run (``_active_layers``: 46 -> 16 rows at the flagship's LBRM
n_cb, bit-exact for the message).

``decode_dematch`` is the entry point: a CUDA tensor launches the
hand-written kernel (``csrc/ldpc_decode_dematch.cu``), a CPU tensor runs
the plain torch version below (``assemble_buffer`` + ``layered_min_sum``).

Two fixed choices keep the two bit-exact with each other and with the
reference at a fixed iteration budget:

* the update computes r = (+-0.8) * mag, stores r, then v + r, each
  rounded on its own (no fused multiply-add): the kernel is built with
  ``--fmad=false`` and uses ``__fmul_rn``/``__fadd_rn``;
* early stop is PER CODEBLOCK: a codeblock stops after a whole iteration
  in which the on-the-fly layered syndrome saw every check satisfied.
  The TPU kernel stops per batch tile of 16 codeblocks, so iteration
  counts (and the bits of a codeblock that never converges) differ from
  it by design; parity with the reference is tested at a fixed budget and,
  with early stop, on TB bits and CRC verdicts.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from srsran_project_tpu.ops.ldpc import graphs

from .. import cuda_lib
from .._tables import device_table
from .rate_match import _chunk_segments

SCALING = 0.8
INPUT_CLAMP = 64.0
_BIG = 3.0e38
MAX_ROW_DEGREE = 32  # bound of the kernel's per-thread edge array


def _edge_plan(bg: int, z: int, nof_layers: int):
    """([edges [(col, shift)] per layer], graph)."""
    g = graphs.get_graph(bg, z)
    return [g.row_edges(r) for r in range(nof_layers)], g


def _active_layers(g, n_cb: int | None, nof_layers: int | None) -> int:
    """Check rows that can influence the message bits for a length-n_cb
    circular buffer (LBRM): a row whose degree-1 extension parity column
    lies beyond n_cb never sends a nonzero message to data bits."""
    nl = g.m if nof_layers is None else nof_layers
    if n_cb is not None and n_cb < g.nof_codeword_bits:
        nl = min(nl, max(4, -(-(n_cb + 2 * g.z) // g.z) - g.kb))
    return nl


@functools.lru_cache(maxsize=None)
def _dematch_plane_plan(bg: int, z: int, k_prime: int, e: int, rv: int,
                        qm: int, n_cb: int):
    """Static copy plan of the dematch, on the qm de-interleave bit-planes
    (plane b, element j = llr[j*qm + b]): ((chunk_idx, plane_b, lo, hi,
    buf_start), ...) copies plane_b[lo:hi] to buffer [buf_start,
    buf_start + hi - lo); chunk_idx > 0 marks repetition."""
    epq = e // qm
    plan = []
    for ci, segs in enumerate(_chunk_segments(bg, z, k_prime, e, rv, n_cb)):
        for bs, ds, ln in segs:
            for b in range(qm):
                lo = max(ds, b * epq)
                hi = min(ds + ln, (b + 1) * epq)
                if hi > lo:
                    plan.append((ci, b, lo - b * epq, hi - b * epq, bs + (lo - ds)))
    return tuple(plan)


@dataclasses.dataclass(frozen=True)
class DematchDecodePlan:
    """Everything static about one E-group's fused dematch + decode."""

    z: int
    kb: int
    e: int
    qm: int
    ncols: int  # a-posteriori columns held: the assembled buffer + active rows
    layers: tuple  # ((col, shift), ...) per active check row
    copies: tuple  # ((plane_b, lo, hi, buf_start), ...)
    f_start: int  # filler range [f_start, f_end) in buffer coordinates
    f_end: int

    @property
    def total_edges(self) -> int:
        return sum(len(edges) for edges in self.layers)


@functools.lru_cache(maxsize=None)
def dematch_decode_plan(bg: int, z: int, k_prime: int, e: int, rv: int, qm: int,
                        n_cb: int | None = None) -> DematchDecodePlan:
    """Plan of ``decode_dematch``; raises ValueError on repetition (E above
    the usable circular buffer), which the fused dematch does not cover."""
    g = graphs.get_graph(bg, z)
    if n_cb is None:
        n_cb = g.nof_codeword_bits
    nof_layers = _active_layers(g, n_cb, None)
    plan = _dematch_plane_plan(bg, z, k_prime, e, rv, qm, n_cb)
    if any(ci > 0 for ci, *_ in plan):
        raise ValueError("decode_dematch covers the no-repetition case only "
                         "(E <= usable buffer)")
    layers, _ = _edge_plan(bg, z, nof_layers)
    assert max(len(edges) for edges in layers) <= MAX_ROW_DEGREE
    return DematchDecodePlan(
        z=z, kb=g.kb, e=e, qm=qm,
        ncols=max(g.kb + max(4, nof_layers), -(-(n_cb + 2 * z) // z)),
        layers=tuple(tuple(edges) for edges in layers),
        copies=tuple((b, lo, hi, bs) for _ci, b, lo, hi, bs in plan),
        f_start=k_prime - 2 * z, f_end=g.kb * z - 2 * z)


# ---- plain torch version ---------------------------------------------------

def _layer_index(plan: DematchDecodePlan) -> list[np.ndarray]:
    """Per layer, the (deg, Z) flat APP positions col*Z + (z + shift) mod Z
    of its edges: the circulant read (and write-back) of each row."""
    zi = np.arange(plan.z)
    return [np.stack([col * plan.z + (zi + shift) % plan.z for col, shift in edges])
            for edges in plan.layers]


_layer_index_on = device_table(
    lambda plan, li: _layer_index(plan)[li].astype(np.int64))


def assemble_buffer(llrs: torch.Tensor, plan: DematchDecodePlan) -> torch.Tensor:
    """(C, E) int8 rate-matched LLRs -> (C, ncols*Z) f32 a-posteriori start:
    punctured prefix and erasures 0, copies clamped to +-64, fillers +64."""
    z = plan.z
    app = torch.zeros((llrs.shape[0], plan.ncols * z), dtype=torch.float32,
                      device=llrs.device)
    planes = llrs.reshape(llrs.shape[0], plan.e // plan.qm, plan.qm)
    for b, lo, hi, bs in plan.copies:
        app[:, 2 * z + bs : 2 * z + bs + hi - lo] = (
            planes[:, lo:hi, b].to(torch.float32).clamp(-INPUT_CLAMP, INPUT_CLAMP))
    if plan.f_end > plan.f_start:
        app[:, 2 * z + plan.f_start : 2 * z + plan.f_end] = INPUT_CLAMP
    return app


def _iteration(app: torch.Tensor, r: torch.Tensor, plan: DematchDecodePlan,
               early_stop: bool) -> torch.Tensor:
    """One layered min-sum iteration in place on app (n, ncols*Z) and
    r (n, total_edges, Z); returns (n,) bool: some check was unsatisfied
    on entry to some layer (all False when early_stop is off)."""
    odd_any = torch.zeros(app.shape[0], dtype=torch.bool, device=app.device)
    base = 0
    for li, edges in enumerate(plan.layers):
        deg = len(edges)
        idx = _layer_index_on(app.device, plan, li)
        rot = app[:, idx]  # (n, deg, Z): rot[e, i] = APP[col_e, (i + s_e) mod Z]
        if early_stop:
            odd_any |= ((rot < 0).sum(dim=1) % 2 == 1).any(dim=1)
        v = rot - r[:, base : base + deg]
        absv = v.abs()
        m1 = absv.amin(dim=1, keepdim=True)
        is_min = absv == m1
        nof_min = is_min.sum(dim=1, keepdim=True)
        m2 = torch.where(is_min, _BIG, absv).amin(dim=1, keepdim=True)
        # Duplicate minima: the second-smallest equals the smallest.
        m2 = torch.where((nof_min > 1) | (m2 >= _BIG), m1, m2)
        neg = v < 0
        odd_total = neg.sum(dim=1, keepdim=True) % 2 == 1
        mag = torch.where(is_min, m2, m1)
        # Sign over the other edges = total parity xor own sign.
        r_new = torch.where(odd_total ^ neg, -SCALING, SCALING) * mag
        r[:, base : base + deg] = r_new
        app[:, idx] = v + r_new
        base += deg
    return odd_any


def layered_min_sum(app: torch.Tensor, plan: DematchDecodePlan, nof_iterations: int,
                    early_stop: bool):
    """Decode from an assembled (C, ncols*Z) buffer -> (bits (C, Kb*Z)
    uint8, iterations run (C,) int32), early stop per codeblock."""
    c, z = app.shape[0], plan.z
    app = app.clone()
    r = torch.zeros((c, plan.total_edges, z), dtype=torch.float32, device=app.device)
    iters = torch.zeros(c, dtype=torch.int32, device=app.device)
    active = torch.arange(c, device=app.device)
    for _ in range(nof_iterations):
        if active.numel() == 0:
            break
        if active.numel() == c:
            odd = _iteration(app, r, plan, early_stop)
        else:
            sub_app, sub_r = app[active], r[active]
            odd = _iteration(sub_app, sub_r, plan, early_stop)
            app[active], r[active] = sub_app, sub_r
        iters[active] += 1
        if early_stop:
            active = active[odd]
    return (app[:, : plan.kb * z] < 0).to(torch.uint8), iters


# ---- the CUDA kernel -------------------------------------------------------

_copies_on = device_table(
    lambda plan: np.asarray(plan.copies, np.int32).reshape(-1, 4))
_edges_on = device_table(
    lambda plan: np.asarray([cs for edges in plan.layers for cs in edges], np.int32))
_layer_off_on = device_table(
    lambda plan: np.cumsum([0] + [len(edges) for edges in plan.layers]).astype(np.int32))


def _launch(llrs: torch.Tensor, plan: DematchDecodePlan, nof_iterations: int,
            early_stop: bool):
    if not llrs.is_contiguous():
        raise ValueError("decode_dematch: llrs must be contiguous")
    lib = cuda_lib.library()
    dev = llrs.device
    c, z = llrs.shape[0], plan.z
    copies, edges, layer_off = _copies_on(dev, plan), _edges_on(dev, plan), _layer_off_on(dev, plan)
    r = torch.empty((c, plan.total_edges * z), dtype=torch.float32, device=dev)
    bits = torch.empty((c, plan.kb * z), dtype=torch.uint8, device=dev)
    iters = torch.empty((c,), dtype=torch.int32, device=dev)
    if c == 0:
        return bits, iters
    with torch.cuda.device(dev):
        status = lib.ldpc_decode_dematch(
            llrs.data_ptr(), c, plan.e, plan.qm,
            copies.data_ptr(), copies.shape[0], plan.f_start, plan.f_end,
            edges.data_ptr(), layer_off.data_ptr(), len(plan.layers), plan.total_edges,
            z, plan.ncols, plan.kb, nof_iterations, int(early_stop),
            r.data_ptr(), bits.data_ptr(), iters.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "ldpc_decode_dematch")
    decode_dematch.launches += 1
    return bits, iters


def decode_dematch(llrs: torch.Tensor, bg: int, z: int, k_prime: int, e: int, rv: int,
                   qm: int, n_cb: int | None = None, nof_iterations: int = 6,
                   early_stop: bool = False):
    """Rate dematch + decode of one E-group: (C, E) int8 rate-matched LLRs
    of each codeblock, in transmission order -> (bits (C, Kb*Z) uint8,
    iterations run (C,) int32).

    CUDA tensor: kernel K1 (one launch); CPU tensor: the plain version."""
    plan = dematch_decode_plan(bg, z, k_prime, e, rv, qm, n_cb)
    if llrs.dim() != 2 or llrs.shape[1] != e or llrs.dtype != torch.int8:
        raise ValueError(f"decode_dematch: want (C, {e}) int8, got "
                         f"{tuple(llrs.shape)} {llrs.dtype}")
    if llrs.device.type == "cuda":
        return _launch(llrs, plan, nof_iterations, early_stop)
    if llrs.device.type != "cpu":
        raise ValueError(f"decode_dematch: unsupported device {llrs.device}")
    return layered_min_sum(assemble_buffer(llrs, plan), plan, nof_iterations, early_stop)


decode_dematch.launches = 0
