"""UCI on PUSCH, codec by codec, against the JAX package: the port's copies
(``ran/ulsch_info``, ``ops/polar/{tables,code}`` with ``_tables.npz``, the
``ulsch_demux._layout`` host plan), the polar and short-block codecs and
``ops/uci``, and the UCI multiplexer.

Tolerances:
* copies, host plans, coded bits, decoded bits and CRC/ok verdicts: exact
  (decoded from the JAX side's own float LLRs; the SC decoder's f and g
  use only sign, min, abs and +-1 times a value, so they are exact);
* short-block metric: rtol 1e-5 (float32 correlations summed in another
  order; on integer LLRs both sides are exact).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np, to_torch

from srsran_project_tpu.ops import short_block as jsb
from srsran_project_tpu.ops import uci as juci
from srsran_project_tpu.ops.polar import code as jcode
from srsran_project_tpu.ops.polar import decoder as jpdec
from srsran_project_tpu.ops.polar import encoder as jpenc
from srsran_project_tpu.ops.polar import tables as jtables
from srsran_project_tpu.phy import allocation as jalloc
from srsran_project_tpu.phy import ulsch_demux as jdemux
from srsran_project_tpu.ran import ulsch_info as jinfo
from srsran_project_tpu_torch.ops import short_block as tsb
from srsran_project_tpu_torch.ops import uci as tuci
from srsran_project_tpu_torch.ops.polar import code as tcode
from srsran_project_tpu_torch.ops.polar import decoder as tpdec
from srsran_project_tpu_torch.ops.polar import encoder as tpenc
from srsran_project_tpu_torch.ops.polar import tables as ttables
from srsran_project_tpu_torch.phy import allocation as talloc
from srsran_project_tpu_torch.phy import ulsch_demux as tdemux
from srsran_project_tpu_torch.ran import ulsch_info as tinfo

# (K message bits incl. CRC, E) around each rate-matching mode, for
# payloads K_uci in {12, 19, 20, 40, 200} (+6 or +11 CRC bits).
POLAR_CASES = [(18, 40), (18, 64), (18, 144), (18, 300), (25, 48), (25, 144), (31, 64),
               (31, 100), (51, 96), (51, 192), (51, 400), (211, 256), (211, 600), (211, 1024)]
UCI_SIZES = [1, 2, 3, 11, 12, 19, 20, 40, 400]


def _e_of(k: int) -> int:
    return {1: 8, 2: 12, 3: 32, 11: 100, 12: 64, 19: 144, 20: 64, 40: 192, 400: 1376}[k]


def test_ulsch_info_copy():
    """G_ack / G_csi1 / G_csi2 over a grid of payloads, betas and geometries."""
    for o in (0, 1, 2, 5, 11, 12, 19, 20, 40, 400):
        for beta in (0, 4, 9, 15):
            for sum_kr, nre, qm, nl in ((300, 96, 2, 1), (21024, 2640, 6, 2),
                                        (344400, 12480, 8, 4), (2000, 4000, 4, 3)):
                g_ack = tinfo.nof_harq_ack_bits(o, beta, sum_kr, nre, qm, nl)
                assert g_ack == jinfo.nof_harq_ack_bits(o, beta, sum_kr, nre, qm, nl)
                g1 = tinfo.nof_csi1_bits(o, beta, sum_kr, nre, qm, nl, g_ack=g_ack)
                assert g1 == jinfo.nof_csi1_bits(o, beta, sum_kr, nre, qm, nl, g_ack=g_ack)
                g2 = tinfo.nof_csi2_bits(o, beta, sum_kr, nre, qm, nl, g_ack=g_ack, g_csi1=g1)
                assert g2 == jinfo.nof_csi2_bits(o, beta, sum_kr, nre, qm, nl, g_ack=g_ack,
                                                 g_csi1=g1)
    assert tinfo.BETA_HARQ_ACK == jinfo.BETA_HARQ_ACK and tinfo.BETA_CSI == jinfo.BETA_CSI


def test_polar_tables_copy():
    ours = np.load(os.path.join(os.path.dirname(ttables.__file__), "_tables.npz"))
    ref = np.load(os.path.join(os.path.dirname(jtables.__file__), "_tables.npz"))
    assert sorted(ours.files) == sorted(ref.files)
    for name in ref.files:
        np.testing.assert_array_equal(ours[name], ref[name])
        assert ours[name].dtype == ref[name].dtype
    for n in range(5, 11):
        np.testing.assert_array_equal(ttables.reliability_sequence(n), jtables.reliability_sequence(n))
        np.testing.assert_array_equal(ttables.subblock_interleaver(n),
                                      jtables.subblock_interleaver(n))
    for k in (1, 40, 164):
        np.testing.assert_array_equal(ttables.input_interleaver(k), jtables.input_interleaver(k))


@pytest.mark.parametrize("k, e", POLAR_CASES)
def test_polar_code_copy(k, e):
    """construct (with and without PC bits), pc_masks, rate_match_indices,
    the channel interleaver."""
    for n_pc, n_pc_wm in ((0, 0), (3, 0), (3, 1)):
        if k + n_pc > e:
            continue
        jc = jcode.construct(k, e, n_max=10, n_pc=n_pc, n_pc_wm=n_pc_wm)
        tc = tcode.construct(k, e, n_max=10, n_pc=n_pc, n_pc_wm=n_pc_wm)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        np.testing.assert_array_equal(tcode.pc_masks(tc), jcode.pc_masks(jc))
        np.testing.assert_array_equal(tcode.rate_match_indices(tc), jcode.rate_match_indices(jc))
    np.testing.assert_array_equal(tcode.channel_interleaver_pattern(e),
                                  jcode.channel_interleaver_pattern(e))


@pytest.mark.parametrize("k, e", [(18, 40), (31, 100), (211, 256), (51, 400)])
def test_polar_encode_dematch_decode(k, e):
    """Polar encode bit-exact; rate dematch equal; SC decode bits equal on
    the same float LLRs (noisy enough that some codewords fail)."""
    rng = np.random.default_rng(k + e)
    code_j = jcode.construct(k, e, n_max=10, n_pc=3 if k < 25 else 0)
    code_t = tcode.construct(k, e, n_max=10, n_pc=3 if k < 25 else 0)
    msg = rng.integers(0, 2, size=(6, k), dtype=np.uint8)
    cw = np.asarray(jpenc.encode(jnp.asarray(msg), code_j))
    np.testing.assert_array_equal(to_np(tpenc.encode(to_torch(msg), code_t)), cw)
    u = rng.integers(0, 2, size=(3, 64), dtype=np.uint8)
    np.testing.assert_array_equal(to_np(tpenc.polar_transform(to_torch(u))),
                                  np.asarray(jpenc.polar_transform(jnp.asarray(u))))
    llr = ((1.0 - 2.0 * cw) * 2.0 + rng.normal(0.0, 2.0, cw.shape)).astype(np.float32)
    lin = np.asarray(jpenc.rate_dematch_llrs(jnp.asarray(llr), code_j))
    np.testing.assert_array_equal(to_np(tpenc.rate_dematch_llrs(to_torch(llr), code_t)), lin)
    np.testing.assert_array_equal(to_np(tpdec.decode(to_torch(lin), code_t)),
                                  np.asarray(jpdec.decode(jnp.asarray(lin), code_j)))


def test_short_block_copy():
    for k in range(1, 12):
        np.testing.assert_array_equal(tsb._mother_codewords(k), jsb._mother_codewords(k))
    np.testing.assert_array_equal(tsb.BASIS, jsb.BASIS)


@pytest.mark.parametrize("k, e", [(1, 2), (1, 4), (2, 6), (2, 12)])
def test_short_block_placeholders(k, e):
    rng = np.random.default_rng(k * e)
    msg = rng.integers(0, 2, size=(5, k), dtype=np.uint8)
    np.testing.assert_array_equal(to_np(tsb.encode(to_torch(msg), e, placeholders=True)),
                                  np.asarray(jsb.encode(jnp.asarray(msg), e, placeholders=True)))


@pytest.mark.parametrize("k", UCI_SIZES)
def test_encode_uci(k):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, size=(4, k), dtype=np.uint8)
    e = _e_of(k)
    np.testing.assert_array_equal(to_np(tuci.encode_uci(to_torch(bits), e)),
                                  np.asarray(juci.encode_uci(jnp.asarray(bits), e)))
    assert tuci._is_segmented(k, e) == (k == 400)


@pytest.mark.parametrize("snr", [6.0, 1.2], ids=["clean", "noisy"])
@pytest.mark.parametrize("k", UCI_SIZES)
def test_decode_uci(k, snr):
    """Bits and ok exact on the JAX side's float LLRs; at the noisy point
    some codewords fail on both sides (or the short-block metric falls)."""
    rng = np.random.default_rng(100 + k)
    e = _e_of(k)
    bits = rng.integers(0, 2, size=(8, k), dtype=np.uint8)
    cw = np.asarray(juci.encode_uci(jnp.asarray(bits), e))
    llr = ((1.0 - 2.0 * cw) * snr + rng.normal(0.0, 2.0, cw.shape)).astype(np.float32)
    bj, okj = juci.decode_uci(jnp.asarray(llr), k)
    bt, okt = tuci.decode_uci(to_torch(llr), k)
    np.testing.assert_array_equal(to_np(bt), np.asarray(bj))
    np.testing.assert_array_equal(to_np(okt), np.asarray(okj))
    if snr > 5:
        assert to_np(okt).all()
        np.testing.assert_array_equal(to_np(bt), bits)
    if k <= 11:
        mj = np.asarray(jsb.detect(jnp.asarray(llr), k, e)[1])
        mt = to_np(tsb.detect(to_torch(llr), k, e)[1])
        np.testing.assert_allclose(mt, mj, rtol=1e-5)


def test_short_block_detect_is_exact_on_integer_llrs():
    """On int8-valued LLRs (the PUSCH front end's), the metric is bitwise
    the reference's: every sum is an integer."""
    rng = np.random.default_rng(3)
    llr = rng.integers(-120, 121, size=(16, 100)).astype(np.float32)
    for k in (1, 2, 6, 11):
        bj, mj = jsb.detect(jnp.asarray(llr), k, 100)
        bt, mt = tsb.detect(to_torch(llr), k, 100)
        np.testing.assert_array_equal(to_np(bt), np.asarray(bj))
        np.testing.assert_array_equal(to_np(mt), np.asarray(mj))


# ---- the UCI multiplexer -----------------------------------------------------

MUX_CASES = [
    # (rb_count, layers, qm, g_ack, g_csi1, g_csi2, nof_ack_bits, g_ack_rvd)
    (80, 4, 8, 32, 192, 1376, 2, 32),
    (22, 2, 6, 252, 144, 0, 11, 0),
    (8, 1, 2, 100, 0, 0, 1, 198),
    (4, 1, 4, 24, 40, 60, 1, 48),
    (6, 3, 4, 60, 96, 0, 3, 0),
]


def _mux_configs(rb, nl, qm, *g):
    kw = dict(rb_start=0, rb_count=rb, sym_start=1, sym_count=13, dmrs_symbols=(2,))
    common = dict(qm=qm, nof_layers=nl, nof_grid_symbols=14, nof_grid_sc=rb * 12,
                  g_ack=g[0], g_csi1=g[1], g_csi2=g[2], nof_ack_bits=g[3], g_ack_rvd=g[4])
    return (jdemux.UlschMuxConfig(alloc=jalloc.Allocation(**kw), **common),
            tdemux.UlschMuxConfig(alloc=talloc.Allocation(**kw), **common))


@pytest.mark.parametrize("case", MUX_CASES)
def test_layout_and_mux(case):
    """_layout value for value; multiplex equal; demultiplex equal, with
    the punctured ACK positions at 0 in the data stream."""
    jc, tc = _mux_configs(*case)
    for a, b in zip(tdemux._layout(tc), jdemux._layout(jc)):
        np.testing.assert_array_equal(a, b)
    assert (tc.g_total, tc.nof_data_bits, tc.ack_punctures) == (jc.g_total, jc.nof_data_bits,
                                                                 jc.ack_punctures)
    rng = np.random.default_rng(case[0])
    data = rng.integers(0, 2, size=(tc.nof_data_bits,), dtype=np.uint8)
    ack = rng.integers(0, 2, size=(case[6],), dtype=np.uint8)
    csi1 = rng.integers(0, 2, size=(20,), dtype=np.uint8)
    csi2 = rng.integers(0, 2, size=(30,), dtype=np.uint8)
    want = np.asarray(jdemux.multiplex(jnp.asarray(data), jnp.asarray(ack), jnp.asarray(csi1), jc,
                                       csi2_bits=jnp.asarray(csi2)))
    got = tdemux.multiplex(to_torch(data), to_torch(ack), to_torch(csi1), tc,
                           csi2_bits=to_torch(csi2))
    np.testing.assert_array_equal(to_np(got), want)
    llr = rng.integers(-120, 121, size=(2, tc.g_total)).astype(np.int8)
    for a, b in zip(tdemux.demultiplex(to_torch(llr), tc), jdemux.demultiplex(jnp.asarray(llr), jc)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
    if tc.g_ack and tc.ack_punctures:
        ack_pos, _, _, data_idx = tdemux._layout(tc)
        erased = np.isin(data_idx, ack_pos)
        assert erased.sum() == tc.g_ack
        assert (to_np(tdemux.demultiplex(to_torch(llr), tc)[0])[:, erased] == 0).all()
