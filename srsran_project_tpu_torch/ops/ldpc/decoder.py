"""Layered normalized min-sum LDPC decoding (kernels K1 and K2).

Port of ``decode_dematch_pallas`` (K1: fused rate dematch + decode) and
``decode_pallas`` (K2: decode of rate-dematched buffers), both in
srsran_project_tpu/ops/ldpc/decoder_pallas.py, with the numerics of
``ops/ldpc/decoder.py``: f32 state,
channel LLRs clamped to +-64, punctured 2Z prefix and erasures at 0,
fillers at +64, scaling 0.8 with the duplicate-minimum rule, hard bit = 1
iff the a-posteriori LLR < 0.  Only the check rows that can reach the
message bits run (``_active_layers``: 46 -> 16 rows at the flagship's LBRM
n_cb, bit-exact for the message).

``decode_dematch_groups`` (K1 over every E-group of a batch of transport
blocks), ``decode_dematch`` (K1 over one E-group) and ``decode`` (K2) are
the entry points: a CUDA tensor launches the hand-written kernel, once
per call (``csrc/ldpc_decode_dematch.cu``, ``csrc/ldpc_decode.cu``; both
run the layer loop of ``csrc/ldpc_layered.cuh``), a CPU tensor runs the
plain torch version (``decode_dematch_plain``, ``decode_plain``:
``assemble_buffer`` or ``decode_buffer``, then ``layered_min_sum``).  The
kernels keep the check messages in an exact compressed form, one 16-byte
record per (check row, z) in a global scratch.

Two fixed choices keep the two bit-exact with each other and with the
reference at a fixed iteration budget:

* the update stores r = (+-0.8) * mag rounded, and writes the
  a-posteriori LLR as ONE fused multiply-add, round((+-0.8) * mag + v):
  the reference's Pallas kernel, run through XLA on the CPU, contracts
  v + r into an FMA (its a-posteriori output shows it; ``_fma`` below
  reproduces it exactly).  The kernels are built with ``--fmad=false``
  and spell both out (``__fmul_rn``, ``__fmaf_rn``);
* early stop is PER CODEBLOCK: a codeblock stops after a whole iteration
  in which the on-the-fly layered syndrome saw every check satisfied.
  The TPU kernel stops per batch tile of 16 codeblocks, so iteration
  counts (and the bits of a codeblock that never converges) differ from
  it by design; parity with the reference is tested at a fixed budget and,
  with early stop, on TB bits and CRC verdicts.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ...support.tracing import l1_tracer
from .. import cuda_lib
from .._tables import device_table
from . import graphs
from .rate_match import _chunk_segments

SCALING = 0.8
INPUT_CLAMP = 64.0
_BIG = 3.0e38
# The check-row degrees of BG1 and BG2, each unrolled in the kernels'
# update_row<D> (csrc/ldpc_layered.cuh); at most 27 sign bits fit in a
# row's state word beside its 5-bit argmin.
ROW_DEGREES = (3, 4, 5, 6, 7, 8, 9, 10, 19)
MAX_GROUPS = 2  # E-groups one K1 launch takes (ldpc_decode_dematch.cu kMaxGroups): a TB has
# at most two distinct E (TS 38.212 5.4.2.1)


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


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


@dataclasses.dataclass(frozen=True)
class LayeredPlan:
    """The check rows a decode runs and the a-posteriori columns it holds."""

    z: int
    kb: int
    ncols: int  # a-posteriori columns held
    layers: tuple  # ((col, shift), ...) per active check row

    @property
    def total_edges(self) -> int:
        return sum(len(edges) for edges in self.layers)

    @property
    def shared_bytes(self) -> int:
        """A kernel block's dynamic shared memory (``ldpc::shared_bytes``
        in csrc/ldpc_layered.cuh): the edge table (8 bytes an edge) and
        layer offsets, then the a-posteriori columns."""
        app = _round16(8 * self.total_edges + 4 * (len(self.layers) + 1))
        return app + _round16(4 * self.ncols * self.z)


@dataclasses.dataclass(frozen=True)
class DematchDecodePlan(LayeredPlan):
    """Everything static about one E-group's fused dematch + decode (K1);
    ncols covers the assembled buffer and the active rows."""

    e: int
    qm: int
    copies: tuple  # ((plane_b, lo, hi, buf_start), ...)
    f_start: int  # filler range [f_start, f_end) in buffer coordinates
    f_end: int


@dataclasses.dataclass(frozen=True)
class DecodePlan(LayeredPlan):
    """Everything static about a decode of rate-dematched buffers (K2)."""

    n: int  # columns of the whole graph: the a-posteriori output is n*Z wide
    width_in: int  # input LLRs read per codeblock, behind the 2Z prefix


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
    return DematchDecodePlan(
        z=z, kb=g.kb, e=e, qm=qm,
        ncols=max(g.kb + max(4, nof_layers), -(-(n_cb + 2 * z) // z)),
        layers=_layers(bg, z, nof_layers),
        copies=tuple((b, lo, hi, bs) for _ci, b, lo, hi, bs in plan),
        f_start=k_prime - 2 * z, f_end=g.kb * z - 2 * z)


@functools.lru_cache(maxsize=None)
def decode_plan(bg: int, z: int, width: int, n_cb: int | None = None) -> DecodePlan:
    """Plan of ``decode`` for (C, width) input buffers: with an LBRM n_cb
    only the rows that reach the message bits run (``_active_layers``)."""
    g = graphs.get_graph(bg, z)
    nof_layers = _active_layers(g, n_cb, None)
    ncols = g.kb + max(4, nof_layers)
    return DecodePlan(z=z, kb=g.kb, ncols=ncols, layers=_layers(bg, z, nof_layers),
                      n=g.n, width_in=min(width, (ncols - 2) * z))


def _layers(bg: int, z: int, nof_layers: int) -> tuple:
    layers, _ = _edge_plan(bg, z, nof_layers)
    # The kernels fetch the next layer's state while a layer runs: two
    # layers at least, so that it is never the one being updated.
    assert len(layers) >= 2 and {len(edges) for edges in layers} <= set(ROW_DEGREES)
    return tuple(tuple(edges) for edges in layers)


# ---- plain torch version ---------------------------------------------------

def _layer_index(plan: LayeredPlan) -> list[np.ndarray]:
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


def decode_buffer(llrs: torch.Tensor, plan: DecodePlan) -> torch.Tensor:
    """(C, N) dematched LLRs -> (C, ncols*Z) f32 a-posteriori start:
    punctured prefix 0, the first width_in LLRs clamped to +-64."""
    z, w = plan.z, plan.width_in
    app = torch.zeros((llrs.shape[0], plan.ncols * z), dtype=torch.float32,
                      device=llrs.device)
    app[:, 2 * z : 2 * z + w] = llrs[:, :w].to(torch.float32).clamp(-INPUT_CLAMP, INPUT_CLAMP)
    return app


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded once (fmaf).  The product is exact in
    float64; the float64 sum s and its exact error e (TwoSum) give
    a*b + c = s + e, so rounding s to float32 is right except where s is
    exactly halfway between two floats and e breaks the tie."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    e = (p - (s - bv)) + (cd - bv)
    r = s.float()
    toward = torch.nextafter(r, torch.where(s > r.double(), torch.inf, -torch.inf).float())
    tie = (s != r.double()) & (toward.double() - s == s - r.double())
    flip = tie & (e != 0) & ((e > 0) == (toward > r))
    return torch.where(flip, toward, r)


def _iteration(app: torch.Tensor, r: torch.Tensor, plan: LayeredPlan,
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
        sign = torch.where(odd_total ^ neg, -SCALING, SCALING)
        r[:, base : base + deg] = sign * mag
        app[:, idx] = _fma(sign, mag, v)
        base += deg
    return odd_any


def layered_min_sum(app: torch.Tensor, plan: LayeredPlan, nof_iterations: int,
                    early_stop: bool):
    """Decode from an assembled (C, ncols*Z) buffer -> (final a-posteriori
    (C, ncols*Z) f32, iterations run (C,) int32), early stop per
    codeblock.  Hard bit = 1 iff the a-posteriori LLR < 0."""
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
    return app, iters


def hard_bits(app: torch.Tensor, plan: LayeredPlan) -> torch.Tensor:
    """(C, >= Kb*Z) a-posteriori LLRs -> (C, Kb*Z) uint8 message bits."""
    return (app[:, : plan.kb * plan.z] < 0).to(torch.uint8)


# ---- the CUDA kernels -----------------------------------------------------

_edges_on = device_table(
    lambda plan: np.asarray([(col * plan.z, shift) for edges in plan.layers
                             for col, shift in edges], np.int32))
_layer_off_on = device_table(
    lambda plan: np.cumsum([0] + [len(edges) for edges in plan.layers]).astype(np.int32))
_copies_on = device_table(
    lambda plans: np.concatenate([np.asarray(p.copies, np.int32).reshape(-1, 4)
                                  for p in plans]))


def _graph_args(plan: LayeredPlan, dev: torch.device) -> tuple:
    """The graph arguments both kernels take: edges (col * Z, shift),
    layer offsets, counts."""
    return (_edges_on(dev, plan).data_ptr(), _layer_off_on(dev, plan).data_ptr(),
            len(plan.layers), plan.total_edges, plan.z, plan.ncols, plan.kb)


def _state_scratch(plan: LayeredPlan, c: int, dev: torch.device) -> torch.Tensor:
    """The (C, L, Z, 4) int32 check-message records, uninitialized (a
    kernel reads a record only after writing it)."""
    return torch.empty((c, len(plan.layers), plan.z, 4), dtype=torch.int32, device=dev)


def blocks_per_sm(plan: LayeredPlan) -> int:
    """Resident blocks per SM of K1 (a ``DematchDecodePlan``) or K2 (a
    ``DecodePlan``) at this plan's shared memory, by the CUDA occupancy
    calculator on the current device."""
    lib = cuda_lib.library()
    fn = (lib.ldpc_decode_dematch_blocks_per_sm if isinstance(plan, DematchDecodePlan)
          else lib.ldpc_decode_blocks_per_sm)
    out = ctypes.c_int(0)
    cuda_lib.check(fn(len(plan.layers), plan.total_edges, plan.z, plan.ncols,
                      ctypes.byref(out)), "blocks_per_sm")
    return out.value


def group_views(llrs: torch.Tensor, groups, qm: int) -> list:
    """The E-groups of a batch of transport blocks as (B, qm, count, E/qm)
    int8 views, codeblock i of TB o reading plane b, element j at
    view[o, b, i, j].  llrs: the stream (B, G), plane b element j of a
    codeblock = its LLR j*qm + b; or the de-interleave planes (B, qm, G/qm)
    (``pusch._front_end_planes``).  groups: ((count, e), ...) in codeblock
    order."""
    views = []
    off = 0
    for count, e in groups:
        if llrs.dim() == 2:
            s0, s1 = llrs.stride()
            views.append(llrs.as_strided((llrs.shape[0], qm, count, e // qm),
                                         (s0, s1, e * s1, qm * s1),
                                         llrs.storage_offset() + off * s1))
        else:
            views.append(llrs[:, :, off // qm : (off + count * e) // qm].unflatten(
                2, (count, e // qm)))
        off += count * e
    return views


def _launch_dematch(views: list, plans: tuple, nof_iterations: int, early_stop: bool,
                    plane_layout: bool):
    """K1, one launch over every view (``group_views``): bits (B*C, Kb*Z)
    and iterations (B*C,) in TB order, C the codeblocks of all views."""
    if not 1 <= len(views) <= MAX_GROUPS:
        raise ValueError(f"decode_dematch: 1 to {MAX_GROUPS} E-groups a launch, "
                         f"got {len(views)}")
    lib = cuda_lib.library()
    plan = plans[0]
    dev = views[0].device
    b = views[0].shape[0]
    cbs = sum(v.shape[2] for v in views)
    c = b * cbs
    bits = torch.empty((c, plan.kb * plan.z), dtype=torch.uint8, device=dev)
    iters = torch.empty((c,), dtype=torch.int32, device=dev)
    if c == 0:
        return bits, iters
    rows = []
    blk0 = start = copy_off = 0
    for view, p in zip(views, plans):
        count = view.shape[2]
        rows += [view.data_ptr(), *view.stride(), blk0, count, start, copy_off,
                 len(p.copies)]
        blk0 += b * count
        start += count
        copy_off += len(p.copies)
    table = (ctypes.c_longlong * len(rows))(*rows)
    rec = _state_scratch(plan, c, dev)
    with torch.cuda.device(dev):
        status = lib.ldpc_decode_dematch(
            table, len(views), c, cbs, _copies_on(dev, plans).data_ptr(),
            plan.f_start, plan.f_end, *_graph_args(plan, dev), nof_iterations,
            int(early_stop), rec.data_ptr(), bits.data_ptr(), iters.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "ldpc_decode_dematch")
    decode_dematch.launches += 1
    decode_dematch.plane_launches += plane_layout
    return bits, iters


def decode_dematch_plain(llrs: torch.Tensor, bg: int, z: int, k_prime: int, e: int,
                         rv: int, qm: int, n_cb: int | None = None, nof_iterations: int = 6,
                         early_stop: bool = False):
    """Plain torch version of ``decode_dematch`` (same arguments), on the
    device of llrs: the plane layout reshapes back to the stream."""
    plan = dematch_decode_plan(bg, z, k_prime, e, rv, qm, n_cb)
    if llrs.dim() == 4:
        llrs = llrs.permute(0, 2, 3, 1).reshape(-1, e)
    app, iters = layered_min_sum(assemble_buffer(llrs, plan), plan, nof_iterations,
                                 early_stop)
    return hard_bits(app, plan), iters


def _dematch(views: list, es: list, bg, z, k_prime, rv, qm, n_cb, nof_iterations,
             early_stop, plane_layout: bool):
    """K1 over (B, qm, count, E/qm) views on a CUDA device, the plain
    version per view on the CPU; (bits (B*C, Kb*Z), iterations (B*C,))."""
    for v, e in zip(views, es):
        if v.dtype != torch.int8 or v.dim() != 4 or v.shape[1] != qm or v.shape[3] != e // qm:
            raise ValueError(f"decode_dematch: want (B, {qm}, count, {e // qm}) int8 views, "
                             f"got {tuple(v.shape)} {v.dtype}")
    if len({(v.shape[0], v.device) for v in views}) != 1:
        raise ValueError("decode_dematch: every E-group needs the same batch and device")
    dev = views[0].device
    if dev.type == "cpu":
        b = views[0].shape[0]
        outs = [decode_dematch_plain(v, bg, z, k_prime, e, rv, qm, n_cb, nof_iterations,
                                     early_stop) for v, e in zip(views, es)]
        bits = torch.cat([o[0].reshape(b, v.shape[2], -1) for o, v in zip(outs, views)], dim=1)
        iters = torch.cat([o[1].reshape(b, -1) for o in outs], dim=1)
        return bits.reshape(-1, bits.shape[-1]), iters.reshape(-1)
    if dev.type != "cuda":
        raise ValueError(f"decode_dematch: unsupported device {dev}")
    plans = tuple(dematch_decode_plan(bg, z, k_prime, e, rv, qm, n_cb) for e in es)
    return _launch_dematch(views, plans, nof_iterations, early_stop, plane_layout)


def decode_dematch_groups(llrs: torch.Tensor, groups, bg: int, z: int, k_prime: int, rv: int,
                          qm: int, n_cb: int | None = None, nof_iterations: int = 6,
                          early_stop: bool = False):
    """Rate dematch + decode of every E-group of a batch of transport
    blocks -> (bits (B*C, Kb*Z) uint8, iterations run (B*C,) int32), rows
    in TB order (TB o, codeblock i at row o*C + i).

    llrs: int8, the stream (B, G) in transmission order or the
    de-interleave planes (B, qm, G/qm) of ``pusch._front_end_planes``;
    groups: ((count, e), ...), the E-groups in codeblock order
    (``sch._e_groups``).  CUDA tensor: kernel K1, ONE launch for all the
    groups, reading either layout in place through strides
    (``decode_dematch.plane_launches`` counts the plane-layout ones); CPU
    tensor: the plain version, per group."""
    groups = tuple((int(count), int(e)) for count, e in groups)
    g = sum(count * e for count, e in groups)
    if llrs.dim() not in (2, 3) or llrs.shape[-1] * (1 if llrs.dim() == 2 else qm) != g:
        raise ValueError(f"decode_dematch_groups: want (B, {g}) or (B, {qm}, {g // qm}), "
                         f"got {tuple(llrs.shape)}")
    with l1_tracer.span("ldpc.decode") as span:
        bits, iters = _dematch(group_views(llrs, groups, qm), [e for _c, e in groups], bg, z,
                               k_prime, rv, qm, n_cb, nof_iterations, early_stop,
                               llrs.dim() == 3)
        span.count(iterations=iters, codeblocks=iters.shape[0])
    return bits, iters


def decode_dematch(llrs: torch.Tensor, bg: int, z: int, k_prime: int, e: int, rv: int,
                   qm: int, n_cb: int | None = None, nof_iterations: int = 6,
                   early_stop: bool = False):
    """Rate dematch + decode of one E-group -> (bits (C, Kb*Z) uint8,
    iterations run (C,) int32).

    llrs: int8 rate-matched LLRs of each codeblock, in one of two layouts:
    the stream, (C, E) in transmission order; or the de-interleave planes,
    a (B, qm, count, E/qm) view (C = B*count, codeblock o*count + i) of
    ``pusch._front_end_planes``' (B, qm, G/qm) output, any strides.

    CUDA tensor: kernel K1 (one launch, the one-group case of
    ``decode_dematch_groups``); CPU tensor: the plain version."""
    dematch_decode_plan(bg, z, k_prime, e, rv, qm, n_cb)  # raises on repetition
    stream = llrs.dim() == 2 and llrs.shape[1] == e
    if llrs.dtype != torch.int8 or not (stream or llrs.dim() == 4):
        raise ValueError(f"decode_dematch: want (C, {e}) or (B, {qm}, count, {e // qm}) "
                         f"int8, got {tuple(llrs.shape)} {llrs.dtype}")
    views = group_views(llrs, ((1, e),), qm) if stream else [llrs]
    return _dematch(views, [e], bg, z, k_prime, rv, qm, n_cb, nof_iterations, early_stop,
                    not stream)


decode_dematch.launches = 0
decode_dematch.plane_launches = 0


def _launch_decode(llrs: torch.Tensor, plan: DecodePlan, nof_iterations: int,
                   early_stop: bool, bits_only: bool):
    if llrs.stride(1) != 1:
        raise ValueError("decode: llrs rows must be contiguous")
    lib = cuda_lib.library()
    dev = llrs.device
    c, z = llrs.shape[0], plan.z
    if bits_only:
        out = torch.empty((c, plan.kb * z), dtype=torch.uint8, device=dev)
    else:
        out = torch.empty((c, plan.n * z), dtype=torch.float32, device=dev)
    iters = torch.empty((c,), dtype=torch.int32, device=dev)
    if c == 0:
        return out, iters
    rec = _state_scratch(plan, c, dev)
    with torch.cuda.device(dev):
        status = lib.ldpc_decode(
            llrs.data_ptr(), int(llrs.dtype == torch.float32), c, llrs.stride(0),
            plan.width_in, *_graph_args(plan, dev), plan.n, nof_iterations,
            int(early_stop), int(bits_only), rec.data_ptr(), out.data_ptr(), iters.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "ldpc_decode")
    decode.launches += 1
    return out, iters


def decode_plain(llrs: torch.Tensor, bg: int, z: int, nof_iterations: int = 6,
                 early_stop: bool = False, bits_only: bool = False,
                 n_cb: int | None = None):
    """Plain torch version of ``decode`` (same arguments), on the device of
    llrs."""
    plan = decode_plan(bg, z, llrs.shape[1], n_cb)
    app, iters = layered_min_sum(decode_buffer(llrs, plan), plan, nof_iterations, early_stop)
    if bits_only:
        return hard_bits(app, plan), None, iters
    full = torch.zeros((app.shape[0], plan.n * plan.z), dtype=torch.float32, device=app.device)
    full[:, : plan.ncols * plan.z] = app
    return hard_bits(app, plan), full, iters


def decode(llrs: torch.Tensor, bg: int, z: int, nof_iterations: int = 6,
           early_stop: bool = False, bits_only: bool = False, n_cb: int | None = None):
    """Decode rate-dematched codeword buffers: (C, N) int8 or float32 LLRs
    (N = (n-2)*Z, the punctured 2Z prefix left out) -> (bits (C, Kb*Z)
    uint8, a-posteriori (C, n*Z) float32 or None with ``bits_only``,
    iterations run (C,) int32).

    n_cb: the LBRM circular-buffer length; only the check rows that reach
    the message bits run, and the a-posteriori columns they leave out read
    0.  Early stop is per codeblock, as in ``decode_dematch``.

    CUDA tensor: kernel K2 (one launch); CPU tensor: the plain version."""
    if llrs.dim() != 2 or llrs.dtype not in (torch.int8, torch.float32):
        raise ValueError(f"decode: want (C, N) int8 or float32, got "
                         f"{tuple(llrs.shape)} {llrs.dtype}")
    if llrs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode: unsupported device {llrs.device}")
    with l1_tracer.span("ldpc.decode") as span:
        if llrs.device.type == "cpu":
            out = decode_plain(llrs, bg, z, nof_iterations, early_stop, bits_only, n_cb)
        else:
            plan = decode_plan(bg, z, llrs.shape[1], n_cb)
            app, iters = _launch_decode(llrs, plan, nof_iterations, early_stop, bits_only)
            out = (app, None, iters) if bits_only else (hard_bits(app, plan), app, iters)
        span.count(iterations=out[2], codeblocks=out[2].shape[0])
    return out


decode.launches = 0


def decode_count_iters(llrs: torch.Tensor, bg: int, z: int, nof_iterations: int = 6):
    """Like ``decode_plain`` on the whole graph without early stop, also
    counting per codeblock the first iteration (1-based) after which the
    hard decision satisfies every parity check, or ``nof_iterations`` if
    none does: every iteration runs, only the count reflects convergence
    (the reference's ``decode_count_iters``).  Plain torch on the device
    of llrs (C, N); returns (bits (C, Kb*Z) uint8, a-posteriori
    (C, n*Z) float32, iterations (C,) int32)."""
    plan = decode_plan(bg, z, llrs.shape[1])
    app = decode_buffer(llrs, plan)
    r = torch.zeros((app.shape[0], plan.total_edges, z), dtype=torch.float32,
                    device=app.device)
    first = torch.zeros(app.shape[0], dtype=torch.int32, device=app.device)
    for it in range(1, nof_iterations + 1):
        _iteration(app, r, plan, early_stop=False)
        hard = (app < 0).to(torch.int32)
        ok = first == 0
        for li in range(len(plan.layers)):
            ok &= (hard[:, _layer_index_on(app.device, plan, li)].sum(dim=1) % 2 == 0).all(dim=1)
        first = torch.where(ok, torch.full_like(first, it), first)
    iters = torch.where(first > 0, first, torch.full_like(first, nof_iterations))
    full = torch.zeros((app.shape[0], plan.n * z), dtype=torch.float32, device=app.device)
    full[:, : plan.ncols * z] = app
    return hard_bits(app, plan), full, iters


# ---- reference-exact int8 mode ----------------------------------------------

LLR_INF = 127  # fixed-bit marker (log_likelihood_ratio.h:250)
LLR_MAX = 120  # saturation bound (log_likelihood_ratio.h:255)
# The largest check-to-variable magnitude, floor(0.8f * LLR_MAX + 0.5).
_R_MAX = 96


def _i8_layer_index(bg: int, z: int, li: int) -> np.ndarray:
    """(deg*Z,) flat a-posteriori positions of check row li's edges,
    col*Z + (z + shift) mod Z edge by edge."""
    zi = np.arange(z)
    return np.concatenate([col * z + (zi + shift) % z
                           for col, shift in graphs.get_graph(bg, z).row_edges(li)])


def _i8_tables(which: str) -> np.ndarray:
    """The int8 decoder's two lookup tables (int32).

    "message": the signed check-to-variable message of a magnitude m in
    0..LLR_MAX, floor(0.8f m + 0.5) in float32 (the reference's
    scale_llr), at index m, and its negation at LLR_MAX + 1 + m.
    "promote": the reference's promotion sum of a variable-to-check value
    and its new message, s = v + r, at index s + LLR_INF + _R_MAX: s where
    |s| <= LLR_MAX, else +-LLR_INF.  (The sum's other branches cannot
    fire here: |r| <= _R_MAX < LLR_INF, a fixed +-LLR_INF v is kept
    apart, and v == -r gives s = 0 anyway.)"""
    if which == "message":
        m = np.arange(LLR_MAX + 1, dtype=np.float32)
        r = np.floor(m * np.float32(SCALING) + np.float32(0.5)).astype(np.int32)
        return np.concatenate([r, -r])
    s = np.arange(-LLR_INF - _R_MAX, LLR_INF + _R_MAX + 1, dtype=np.int32)
    return np.where(np.abs(s) > LLR_MAX, np.sign(s) * LLR_INF, s).astype(np.int32)


_i8_layer_on = device_table(lambda bg, z, li: _i8_layer_index(bg, z, li).astype(np.int64))
_i8_table_on = device_table(_i8_tables)


def decode_i8(llrs: torch.Tensor, bg: int, z: int, nof_iterations: int = 6,
              nof_layers: int | None = None):
    """Reference-exact int8 layered min-sum decode (port of the reference's
    ``decode_i8``, ldpc_decoder_generic.cpp semantics) on int32 lanes,
    where torch's int8 would wrap: every sum saturates explicitly.

    llrs: (C, N) int8 or int32 circular-buffer LLRs (N <= (n-2)*Z, the
    punctured 2Z prefix left out; missing tail positions are erasures).
    Returns (bits (C, Kb*Z) uint8, app (C, n*Z) int32 final LLRs).

    Numerics: input clamped to +-64; variable-to-check v = the saturated
    difference clip(APP - r, +-LLR_MAX), a fixed +-LLR_INF APP passing
    through (the reference's sum: r never reaches LLR_INF); check minima
    capped at LLR_MAX (the reference's min registers start there, so
    +-LLR_INF never wins the min), the smallest and second smallest with
    duplicates counted (two equal minima give every edge m1);
    check-to-variable magnitude floor(0.8f * min + 0.5) in float32 and
    sign the parity of the other edges; soft bits = the promotion sum
    (beyond +-LLR_MAX -> +-LLR_INF); hard bit = 1 iff LLR <= 0.  The
    message and the promotion are lookups in ``_i8_tables``.  Each layer
    gathers and writes back exactly its own edges (no padded columns), so
    the write-back has no duplicate index.  Plain torch on the device of
    the input: about twenty tensor operations a layer."""
    g = graphs.get_graph(bg, z)
    nl = g.m if nof_layers is None else nof_layers
    c, n_in = llrs.shape
    if n_in > (g.n - 2) * z:
        raise ValueError(f"decode_i8: {n_in} LLRs exceed the (n-2)*Z = {(g.n - 2) * z} "
                         "circular buffer")
    dev = llrs.device
    app = torch.zeros((c, g.n * z), dtype=torch.int32, device=dev)
    app[:, 2 * z : 2 * z + n_in] = llrs.to(torch.int32).clamp(-int(INPUT_CLAMP),
                                                               int(INPUT_CLAMP))
    message = _i8_table_on(dev, "message")
    promote = _i8_table_on(dev, "promote")
    idx = [_i8_layer_on(dev, bg, z, li) for li in range(nl)]
    r = [torch.zeros((c, ix.numel() // z, z), dtype=torch.int32, device=dev) for ix in idx]
    for _ in range(nof_iterations):
        for li, ix in enumerate(idx):
            a = app[:, ix].view(r[li].shape)
            fixed = a.abs() == LLR_INF
            v = torch.where(fixed, a, (a - r[li]).clamp_(-LLR_MAX, LLR_MAX))
            absv = v.abs().clamp_max_(LLR_MAX)
            two = absv.topk(2, dim=1, largest=False).values  # (m1, m2), duplicates counted
            mag = torch.where(absv == two[:, :1], two[:, 1:], two[:, :1])
            neg = v >> 31  # -1 where negative
            flip = (neg.sum(dim=1, keepdim=True, dtype=torch.int32) - neg) & 1
            r[li] = message[mag + flip * (LLR_MAX + 1)]
            out = promote[v + r[li] + (LLR_INF + _R_MAX)]
            app[:, ix] = torch.where(fixed, v, out).view(c, -1)
    return (app[:, : g.kb * z] <= 0).to(torch.uint8), app
