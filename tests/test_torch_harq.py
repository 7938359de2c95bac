"""The two-stage decode's modules against the JAX package: rate dematch,
HARQ combining and kernel K2's plain version.

Tolerances: everything integer (dematched buffers, HARQ buffers) is exact;
K2's plain version equals ``decode_pallas`` run in interpret mode bit for
bit in its hard bits, its a-posteriori LLRs and its iteration counts at a
fixed budget (both compute every float operation separately rounded, in
the same order).  The HARQ buffer equals the reference decoder's rx-buffer
soft bits of ``tests/golden/harq_retx`` after every transmission."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ldpc import CASES, noisy_llrs, position_llrs
from torch_parity import to_np, to_torch

from srsran_project_tpu.ops.ldpc import decoder_pallas as jdp
from srsran_project_tpu.ops.ldpc import rate_match as jrm
from srsran_project_tpu.phy import sch as jsch
from srsran_project_tpu_torch.ops.ldpc import decoder as tdec
from srsran_project_tpu_torch.ops.ldpc import rate_match as trm
from srsran_project_tpu_torch.phy import sch as tsch
from srsran_project_tpu_torch.phy.upper_phy import HarqBufferPool

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "harq_retx")

# E below, at and above the usable buffer (repetition), rv 0-3, LBRM.
DEMATCH_CASES = [
    pytest.param(dict(tbs=3000, target_code_rate=0.5, qm=4, nof_layers=1,
                      nof_total_bits=6000, rv=1, tbs_lbrm_bytes=None), id="bg1-rv1"),
    pytest.param(dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                      nof_total_bits=20032, rv=3, tbs_lbrm_bytes=2000), id="bg1-lbrm-rv3"),
    pytest.param(dict(tbs=300, target_code_rate=0.1, qm=2, nof_layers=1,
                      nof_total_bits=4000, rv=0, tbs_lbrm_bytes=None), id="bg2-repetition"),
    pytest.param(dict(tbs=2000, target_code_rate=0.2, qm=6, nof_layers=1,
                      nof_total_bits=30000, rv=2, tbs_lbrm_bytes=None), id="bg2-repetition-rv2"),
]


def _groups(cfg):
    seg = cfg.seg
    args = (seg.base_graph, seg.lifting_size, seg.nof_payload_bits_per_cb)
    off = 0
    for _start, count, e in tsch._e_groups(cfg.cb_e_bits):
        yield args, count, e, off
        off += count * e


@pytest.mark.parametrize("kw", DEMATCH_CASES)
def test_rate_dematch_and_combine_exact(kw):
    cfg = tsch.SchConfig(**kw)
    rng = np.random.default_rng(1)
    llrs = rng.integers(-127, 128, size=(2, cfg.nof_total_bits)).astype(np.int8)
    for args, count, e, off in _groups(cfg):
        span = llrs[:, off : off + count * e].reshape(2, count, e)
        want = np.asarray(jrm.rate_dematch(jnp.asarray(span), *args, e, cfg.rv, cfg.qm,
                                           cfg.n_cb))
        got = to_np(trm.rate_dematch(to_torch(span), *args, e, cfg.rv, cfg.qm, cfg.n_cb))
        np.testing.assert_array_equal(got, want)
        buf = rng.integers(-127, 128, size=want.shape).astype(np.int8)
        want = np.asarray(jrm.rate_dematch_combine(jnp.asarray(buf), jnp.asarray(span), *args,
                                                   e, cfg.rv, cfg.qm, cfg.n_cb))
        got = to_np(trm.rate_dematch_combine(to_torch(buf), to_torch(span), *args, e, cfg.rv,
                                             cfg.qm, cfg.n_cb))
        np.testing.assert_array_equal(got, want)


def test_combine_harq_every_pair():
    """Every int8 pair, the +-127 infinities and a == -b included."""
    a, b = np.meshgrid(np.arange(-128, 128), np.arange(-128, 128))
    a, b = a.astype(np.int8).ravel(), b.astype(np.int8).ravel()
    want = np.asarray(jrm.combine_harq(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(to_np(trm.combine_harq(to_torch(a), to_torch(b))), want)


@pytest.mark.parametrize("kw", DEMATCH_CASES)
def test_dematch_stage_with_harq_exact(kw):
    cfg_j, cfg_t = jsch.SchConfig(**kw), tsch.SchConfig(**kw)
    rng = np.random.default_rng(2)
    llrs = rng.integers(-120, 121, size=(2, cfg_t.nof_total_bits)).astype(np.int8)
    first, _ = jsch._dematch_stage(jnp.asarray(llrs), None, cfg_j)
    got = tsch._dematch_stage(to_torch(llrs), None, cfg_t)
    np.testing.assert_array_equal(to_np(got), np.asarray(first))
    want, _ = jsch._dematch_stage(jnp.asarray(llrs[::-1].copy()), first, cfg_j)
    got = tsch._dematch_stage(to_torch(llrs[::-1].copy()), got, cfg_t)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def _golden_cases():
    with open(os.path.join(GOLDEN, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("case_idx", range(5))
def test_harq_buffer_matches_golden(case_idx):
    """The HARQ buffer after every transmission of the reference decoder's
    rv 0-2-3-1 sequence equals its rx-buffer soft bits, bit for bit; the
    decoded TB equals the reference's once a CRC passes."""
    case = _golden_cases()[case_idx]
    tbs = case["tbs_bytes"] * 8
    tb_ref = np.unpackbits(np.fromfile(os.path.join(GOLDEN, case["tb"]), dtype=np.uint8))
    harq = None
    for t, rv in enumerate(int(x) for x in case["rv_seq"].split(",")):
        llr = np.fromfile(os.path.join(GOLDEN, f"llr{case['idx']}_{t}.dat"), dtype=np.int8)
        cfg = tsch.SchConfig(tbs=tbs, target_code_rate=tbs / case["g_bits"], qm=case["qm"],
                             nof_layers=1, nof_total_bits=case["g_bits"], rv=rv)
        tb, ok, harq = tsch.decode_transport_block(to_torch(llr), cfg, 6, harq, early_stop=True)
        assert harq.shape[0] == case["nof_cbs"]
        for cb in range(case["nof_cbs"]):
            ref = np.fromfile(os.path.join(GOLDEN, f"soft{case['idx']}_{t}_{cb}.dat"),
                              dtype=np.int8)
            np.testing.assert_array_equal(to_np(harq[cb, : case["full_length"]]), ref)
        if bool(ok):
            np.testing.assert_array_equal(to_np(tb), tb_ref[:tbs])
    assert bool(ok) == (case["verdicts"].split(",")[-1] == "1")


def _buffers(kw, f32: bool):
    """Dematched (2C, N) buffers of a noisy real codeword and of
    position-dependent LLRs, int8 or (scaled by 0.37) float32."""
    cfg = jsch.SchConfig(**kw)
    _, noisy = noisy_llrs(cfg)
    llrs = np.stack([noisy, position_llrs(cfg.nof_total_bits)])
    buf, _ = jsch._dematch_stage(jnp.asarray(llrs), None, cfg)
    buf = np.asarray(buf).reshape(-1, buf.shape[-1])
    return cfg, (buf.astype(np.float32) * np.float32(0.37)) if f32 else buf


@pytest.mark.parametrize("bits_only", [True, False], ids=["bits", "app"])
@pytest.mark.parametrize("f32", [False, True], ids=["int8", "f32"])
@pytest.mark.parametrize("iters", [0, 4])
@pytest.mark.parametrize("kw", [CASES[1], CASES[2], CASES[4]])
def test_k2_plain_matches_pallas(kw, iters, f32, bits_only):
    cfg, buf = _buffers(kw, f32)
    seg = cfg.seg
    args = (seg.base_graph, seg.lifting_size, iters)
    bits_j, app_j, it_j = jdp.decode_pallas(jnp.asarray(buf), *args, batch_tile=4,
                                            interpret=True, bits_only=bits_only, n_cb=cfg.n_cb)
    bits_t, app_t, it_t = tdec.decode(to_torch(buf), *args, bits_only=bits_only, n_cb=cfg.n_cb)
    np.testing.assert_array_equal(to_np(bits_t), np.asarray(bits_j))
    np.testing.assert_array_equal(to_np(it_t), np.asarray(it_j))
    if bits_only:
        assert app_t is None
    else:
        assert app_t.shape == app_j.shape
        np.testing.assert_array_equal(to_np(app_t), np.asarray(app_j))


def test_two_stage_decodes_repetition_and_retransmission():
    """A repetition geometry decodes through K2's plain version; a failed
    rv 0 followed by an rv 2 combined into its HARQ buffer passes, with the
    same verdicts as the reference."""
    kw = dict(tbs=300, target_code_rate=0.1, qm=2, nof_layers=1, nof_total_bits=4000,
              tbs_lbrm_bytes=None)
    rng = np.random.default_rng(3)
    tb = rng.integers(0, 2, size=(300,), dtype=np.uint8)
    harq_t = harq_j = None
    verdicts = []
    for rv in (0, 2):
        cfg_j, cfg_t = jsch.SchConfig(rv=rv, **kw), tsch.SchConfig(rv=rv, **kw)
        cw = np.asarray(jsch.encode_transport_block(jnp.asarray(tb), cfg_j))
        llr = (1.0 - 2.0 * cw) * 2.0 + rng.normal(0.0, 5.0, size=cw.shape)
        llr = np.clip(np.round(llr), -120, 120).astype(np.int8)
        tb_t, ok_t, harq_t = tsch.decode_transport_block(to_torch(llr), cfg_t, 6, harq_t,
                                                         early_stop=True)
        tb_j, ok_j, harq_j = jsch.decode_transport_block(jnp.asarray(llr), cfg_j, 6, harq_j,
                                                         early_stop=True)
        np.testing.assert_array_equal(to_np(harq_t), np.asarray(harq_j))
        assert bool(ok_t) == bool(ok_j)
        verdicts.append(bool(ok_t))
    assert not tsch._fused_decode_ok(cfg_t)
    assert verdicts == [False, True]
    np.testing.assert_array_equal(to_np(tb_t), tb)


def test_harq_buffer_pool():
    pool = HarqBufferPool(max_buffers=2)
    a, b, c = (torch.full((1, 4), v, dtype=torch.int8) for v in (1, 2, 3))
    pool.put(1, 0, a)
    pool.put(2, 0, b)
    assert pool.get(1, 0) is a and pool.get(3, 0) is None
    pool.put(2, 0, c)  # replacing a key evicts nothing
    assert pool.get(1, 0) is a and pool.get(2, 0) is c
    pool.put(3, 1, b)  # a new key beyond the limit evicts the oldest
    assert pool.get(1, 0) is None and pool.get(3, 1) is b
    pool.release(3, 1)
    assert pool.get(3, 1) is None
