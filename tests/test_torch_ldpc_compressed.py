"""Kernels K1 and K2's layer loop (csrc/ldpc_layered.cuh) as the kernels
run it, and the plans that size their launches.

The kernels keep each check row's messages in an exact compressed form:
m1 and m2 (f32) and one word with the outgoing signs and the first argmin;
each layer runs two passes over the row's edges, the first keeping the
running two smallest |v|, the argmin, the signs and the hard-decision
parity, the second recomputing v from the rebuilt old message and writing
the APP.  ``_schedule_min_sum`` below emulates that per-thread schedule
(vectorized over codeblocks and threads z, sequential over edges as a
thread is) and must equal ``decoder.layered_min_sum``, the plain version,
bit for bit: APP (compared as int32 bit patterns, so -0.0 != +0.0) and
per-codeblock iteration counts.  The inputs are integer LLRs with many
ties and zeros, f32 LLRs with exact +0.0 and -0.0, and a clean codeword
(early stop after one iteration) beside them.

Then the shared-memory byte counts on the geometries of the three
chip_smoke paths, and the grouped K1 call (one launch over every E-group)
against one call per group on the CPU.
"""

import numpy as np
import pytest
import torch
from torch_parity import to_torch  # noqa: F401  (sets torch threads)

from srsran_project_tpu_torch.models.cell import CellConfig
from srsran_project_tpu_torch.ops.ldpc import decoder
from srsran_project_tpu_torch.phy import sch

SCALING = torch.tensor(0.8, dtype=torch.float32)
BIG = torch.tensor(3.0e38, dtype=torch.float32)
ARG_SHIFT = 27

# The five geometries of tests/test_torch_ldpc.py.
K1_CASES = {
    "bg1-single-cb": dict(tbs=3000, target_code_rate=0.5, qm=4, nof_layers=1,
                          nof_total_bits=6000, rv=0, tbs_lbrm_bytes=None),
    "bg1-two-cbs-two-e-groups": dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                                     nof_total_bits=20032, rv=0, tbs_lbrm_bytes=None),
    "bg2-low-rate": dict(tbs=2000, target_code_rate=0.2, qm=2, nof_layers=1,
                         nof_total_bits=9000, rv=0, tbs_lbrm_bytes=None),
    "bg1-rv2": dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                    nof_total_bits=20032, rv=2, tbs_lbrm_bytes=None),
    "bg1-lbrm": dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                     nof_total_bits=20032, rv=0, tbs_lbrm_bytes=2000),
}
# Two codeblocks in two E-groups (E 10016 and 10032), full and LBRM buffer.
TWO_E_GROUPS = dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2, nof_total_bits=20048,
                    rv=0, tbs_lbrm_bytes=None)


def _k1_plan(kw: dict) -> decoder.DematchDecodePlan:
    cfg = sch.SchConfig(**kw)
    seg = cfg.seg
    return decoder.dematch_decode_plan(seg.base_graph, seg.lifting_size,
                                       seg.nof_payload_bits_per_cb, cfg.cb_e_bits[-1], cfg.rv,
                                       cfg.qm, cfg.n_cb or seg.full_codeword_bits)


def _group_a_plan() -> decoder.DecodePlan:
    """The multi-UE slot's group A: BG1 Z=384, untruncated, 46 rows."""
    plan = decoder.decode_plan(1, 384, 66 * 384, None)
    assert len(plan.layers) == 46 and plan.total_edges == 316
    return plan


PLANS = {**{k: (lambda kw=kw: _k1_plan(kw)) for k, kw in K1_CASES.items()},
         "group-a-46-rows": _group_a_plan}


def _schedule_min_sum(app: torch.Tensor, plan, nof_iterations: int, early_stop: bool):
    """The kernels' per-thread schedule on an assembled (C, ncols*Z) APP ->
    (final APP, iterations run (C,) int32)."""
    c, z = app.shape[0], plan.z
    nl = len(plan.layers)
    app = app.clone()
    m1s = torch.zeros((c, nl, z), dtype=torch.float32)
    m2s = torch.zeros((c, nl, z), dtype=torch.float32)
    ws = torch.zeros((c, nl, z), dtype=torch.int64)
    iters = torch.zeros(c, dtype=torch.int32)
    active = torch.ones(c, dtype=torch.bool)
    zi = torch.arange(z)
    for _ in range(nof_iterations):
        if not active.any():
            break
        rows = active.nonzero()[:, 0]
        sub = app[rows]
        odd_any = torch.zeros(rows.numel(), dtype=torch.bool)
        for li, edges in enumerate(plan.layers):
            old_m1, old_m2, old_w = m1s[rows, li], m2s[rows, li], ws[rows, li]
            a1, a2 = SCALING * old_m1, SCALING * old_m2
            old_arg = old_w >> ARG_SHIFT
            idx = [col * z + (zi + shift) % z for col, shift in edges]

            def old_message(j):
                mag = torch.where(old_arg == j, a2, a1)
                return torch.where((old_w >> j) & 1 == 1, -mag, mag)

            m1 = BIG.expand(rows.numel(), z).clone()
            m2 = m1.clone()
            arg = torch.zeros((rows.numel(), z), dtype=torch.int64)
            neg = torch.zeros_like(arg)
            hard = torch.zeros((rows.numel(), z), dtype=torch.bool)
            for j in range(len(edges)):
                rot = sub[:, idx[j]]
                hard ^= rot < 0
                v = rot - old_message(j)
                neg |= (v < 0).long() << j
                a = v.abs()
                m2 = torch.minimum(m2, torch.maximum(m1, a))
                arg = torch.where(a < m1, j, arg)
                m1 = torch.minimum(m1, a)
            m2 = torch.where(m2 >= BIG, m1, m2)
            parity = torch.zeros_like(neg)
            for j in range(len(edges)):
                parity ^= (neg >> j) & 1
            mask = (1 << len(edges)) - 1
            sgn = torch.where(parity == 1, ~neg & mask, neg)
            for j in range(len(edges)):
                v = sub[:, idx[j]] - old_message(j)
                sign = torch.where((sgn >> j) & 1 == 1, -SCALING, SCALING)
                sub[:, idx[j]] = decoder._fma(sign, torch.where(arg == j, m2, m1), v)
            m1s[rows, li], m2s[rows, li] = m1, m2
            ws[rows, li] = sgn | (arg << ARG_SHIFT)
            odd_any |= hard.any(dim=1)
        app[rows] = sub
        iters[rows] += 1
        if early_stop:
            active[rows] = odd_any
    return app, iters


def _inputs(plan, kind: str) -> torch.Tensor:
    """Three codeblocks' (C, ncols*Z) a-posteriori start: two random, the
    third a clean all-zero codeword (every check satisfied).  "ties":
    integers in [-3, 3]; "signed-zeros": f32 from {+-0.0, +-1, +-2.5},
    with -0.0 in the clean codeblock too."""
    rng = np.random.default_rng(7)
    n = plan.ncols * plan.z
    if kind == "ties":
        vals = rng.integers(-3, 4, size=(2, n)).astype(np.float32)
        clean = rng.integers(1, 4, size=(1, n)).astype(np.float32)
    else:
        pool = np.array([0.0, -0.0, 1.0, -1.0, 2.5, -2.5], np.float32)
        vals = pool[rng.integers(0, len(pool), size=(2, n))]
        clean = np.where(rng.random((1, n)) < 0.3, np.float32(-0.0), np.float32(2.5))
    app = torch.from_numpy(np.concatenate([vals, clean]).astype(np.float32))
    app[:, : 2 * plan.z] = 0.0  # the punctured prefix
    return app


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("iters, early_stop", [(0, False), (1, False), (6, False), (6, True)],
                         ids=["0", "1", "6", "6-early-stop"])
@pytest.mark.parametrize("kind", ["ties", "signed-zeros"])
@pytest.mark.parametrize("geometry", list(PLANS))
def test_schedule_matches_plain(geometry, kind, iters, early_stop):
    plan = PLANS[geometry]()
    app = _inputs(plan, kind)
    want, want_it = decoder.layered_min_sum(app, plan, iters, early_stop)
    got, got_it = _schedule_min_sum(app, plan, iters, early_stop)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(got_it, want_it)
    if early_stop:
        assert int(got_it[2]) == 1 and int(got_it[:2].min()) > 1


def test_schedule_sees_signed_zeros_and_ties():
    """The inputs do reach the cases the kernels must get right: after one
    layer of group A, some v is -0.0, some +0.0, and some row has a
    duplicated minimum."""
    plan = _group_a_plan()
    app = _inputs(plan, "signed-zeros")
    z = plan.z
    zi = torch.arange(z)
    rot = torch.stack([app[:, col * z + (zi + s) % z] for col, s in plan.layers[0]])
    assert bool((_bits(rot) == _bits(torch.tensor(-0.0))).any())
    assert bool((_bits(rot) == 0).any())
    mags = rot.abs()
    assert bool(((mags == mags.amin(dim=0)).sum(dim=0) > 1).any())


# ---- plans: shared memory, E-groups ------------------------------------------

def _path_geometries():
    """(name, kernel, plan) of every K1 and K2 plan the three chip_smoke
    paths run: the flagship (float and plane path: K1 over both E-groups;
    K2 on its dematched buffers) and the multi-UE slot's three code
    groups (K2)."""
    import chip_smoke

    out = []
    fl = CellConfig().pusch_cfg.sch
    seg = fl.seg
    n_cb = fl.n_cb or seg.full_codeword_bits
    for _s, _count, e in sch._e_groups(fl.cb_e_bits):
        out.append((f"flagship K1 E={e}", "K1", decoder.dematch_decode_plan(
            seg.base_graph, seg.lifting_size, seg.nof_payload_bits_per_cb, e, fl.rv, fl.qm,
            n_cb)))
    out.append(("flagship K2", "K2", decoder.decode_plan(
        seg.base_graph, seg.lifting_size, seg.full_codeword_bits, fl.n_cb)))
    rb = 0
    for _n, layers, qm, rate, nof_rb in chip_smoke.UL_GROUPS:
        c = chip_smoke.ul_config(layers, qm, rate, nof_rb, rb).sch
        s = c.seg
        out.append((f"ul BG{s.base_graph} Z={s.lifting_size}", "K2", decoder.decode_plan(
            s.base_graph, s.lifting_size, s.full_codeword_bits, c.n_cb)))
        rb += nof_rb
    return out


def test_path_geometries_shared_memory():
    """A block's shared memory on every geometry of the three paths: the
    edge table, layer offsets and a-posteriori columns (the check-message
    state sits in global records), each under the 232,448 bytes a block
    may use on sm_90."""
    got = {name: (len(p.layers), p.z, p.ncols, p.total_edges, p.shared_bytes)
           for name, _k, p in _path_geometries()}
    e_groups = [n for n in got if n.startswith("flagship K1")]
    assert len(e_groups) == 2
    for name in e_groups + ["flagship K2"]:
        assert got[name] == (16, 384, 38, 164, 59760), got[name]
    assert got["ul BG1 Z=384"] == (46, 384, 68, 316, 107168)
    assert got["ul BG1 Z=288"] == (46, 288, 68, 316, 81056)
    assert got["ul BG2 Z=36"] == (42, 36, 52, 197, 9248)
    for name, (nl, z, ncols, edges, smem) in got.items():
        tables = -(-(8 * edges + 4 * (nl + 1)) // 16) * 16
        assert smem == tables + -(-(4 * ncols * z) // 16) * 16, name
        assert smem <= 232_448, name  # a block's limit on sm_90 (kMaxSharedBytes)


@pytest.mark.parametrize("kw", [K1_CASES["bg1-two-cbs-two-e-groups"], K1_CASES["bg1-lbrm"],
                                K1_CASES["bg2-low-rate"]],
                         ids=["two-e-groups", "lbrm", "bg2"])
def test_degree_and_layer_bounds(kw):
    """Every row degree of the plan has its unrolled kernel instance, and
    fits the state word (27 sign bits beside the argmin)."""
    plan = _k1_plan(kw)
    assert {len(edges) for edges in plan.layers} <= set(decoder.ROW_DEGREES)
    assert max(decoder.ROW_DEGREES) <= 27 and len(plan.layers) >= 4


def _flagship_like_llrs(cfg, b: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    tb = torch.from_numpy(rng.integers(0, 2, size=(b, cfg.tbs), dtype=np.uint8))
    cw = sch.encode_transport_block(tb, cfg).numpy()
    llr = (1.0 - 2.0 * cw.astype(np.float32)) * 6.0 + rng.normal(0.0, 4.0, size=cw.shape)
    return torch.from_numpy(np.clip(np.round(llr), -120, 120).astype(np.int8))


@pytest.mark.parametrize("layout", ["stream", "planes"])
@pytest.mark.parametrize("kw", [TWO_E_GROUPS, dict(TWO_E_GROUPS, tbs_lbrm_bytes=2000)],
                         ids=["two-e-groups", "lbrm"])
def test_grouped_decode_equals_per_group(kw, layout):
    """``_fused_decode`` / ``decode_from_planes``' one grouped call equals
    one ``decode_dematch`` call per E-group (stream spans), in TB order,
    with early stop; the group table covers every codeblock once."""
    cfg = sch.SchConfig(**kw)
    seg = cfg.seg
    llrs = _flagship_like_llrs(cfg, 3, 11)
    groups = sch._e_groups(cfg.cb_e_bits)
    assert len(groups) == 2 and sum(c for _s, c, _e in groups) == seg.nof_codeblocks
    src = llrs if layout == "stream" else llrs.reshape(3, -1, cfg.qm).transpose(1, 2)
    bits, iters = sch._decode_groups(src, cfg, 6, True)
    want_bits, want_iters = [], []
    off = 0
    for _s, count, e in groups:
        span = llrs[:, off : off + count * e].reshape(-1, e)
        b, i = decoder.decode_dematch(span, seg.base_graph, seg.lifting_size,
                                      seg.nof_payload_bits_per_cb, e, cfg.rv, cfg.qm,
                                      cfg.n_cb or seg.full_codeword_bits, 6, True)
        want_bits.append(b.reshape(3, count, -1))
        want_iters.append(i.reshape(3, count))
        off += count * e
    assert torch.equal(bits, torch.cat(want_bits, dim=1).reshape(bits.shape))
    assert torch.equal(iters, torch.cat(want_iters, dim=1).reshape(-1))
    assert bool((iters > 0).all()) and bool((iters < 6).any())


def test_group_views_cover_the_stream_and_planes():
    """Each E-group's (B, qm, count, E/qm) view reads plane b, element j of
    codeblock i of TB o at stream position off + i*E + j*qm + b, in both
    layouts, with no copy."""
    cfg = sch.SchConfig(**TWO_E_GROUPS)
    g = cfg.nof_total_bits
    stream = torch.arange(2 * g, dtype=torch.int64).reshape(2, g)
    planes = stream.reshape(2, -1, cfg.qm).transpose(1, 2)
    groups = [(count, e) for _s, count, e in sch._e_groups(cfg.cb_e_bits)]
    assert len(groups) == 2
    off = 0
    for vs, vp, (count, e) in zip(decoder.group_views(stream, groups, cfg.qm),
                                  decoder.group_views(planes, groups, cfg.qm), groups):
        o, b, i, j = torch.meshgrid(*(torch.arange(n) for n in vs.shape), indexing="ij")
        want = o * g + off + i * e + j * cfg.qm + b
        assert torch.equal(vs, want) and torch.equal(vp, want)
        assert vs.untyped_storage().data_ptr() == stream.untyped_storage().data_ptr()
        off += count * e


def test_grouped_decode_checks_its_input():
    cfg = sch.SchConfig(**TWO_E_GROUPS)
    seg = cfg.seg
    groups = tuple((count, e) for _s, count, e in sch._e_groups(cfg.cb_e_bits))
    args = (seg.base_graph, seg.lifting_size, seg.nof_payload_bits_per_cb, cfg.rv, cfg.qm)
    with pytest.raises(ValueError, match="want"):
        decoder.decode_dematch_groups(torch.zeros((1, cfg.nof_total_bits - 8), dtype=torch.int8),
                                      groups, *args)
    with pytest.raises(ValueError, match="int8"):
        decoder.decode_dematch_groups(torch.zeros((1, cfg.nof_total_bits), dtype=torch.int16),
                                      groups, *args)
