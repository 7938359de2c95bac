"""PUCCH formats 0, 1 and 2 (phy/pucch.py, phy/pucch_f2.py) and the
low-PAPR sequences under them (ops/sequences.py) against the JAX package.

Tolerances:
* the copied host tables and plans (``_low_papr_phi.npz``,
  ``base_sequence``, ``group_hopping_params``, ``_re_layout``,
  ``_dmrs_pilots``): exact;
* ``sequences.generate`` and the UE-side grids of all three formats: 1e-6
  absolute on unit-modulus values (the float32 phase ramp's cos and sin
  round differently in the two libraries);
* detected values, HARQ bits, UCI bits and ok flags: exact (and the sent
  ones), on 1 and 4 ports, with and without a second hop;
* F0 metric and F1 rho: rtol 1e-4; F2 snr_db: atol 1e-3 (float32
  correlations and estimates summed in another order).  The SNR (10 dB per
  port) keeps every metric far from its DTX threshold;
* the batched F1 detector (``format1_detect_batch``): corr within 1e-4 of
  its largest value and rho within 1e-4 absolute of the reference's on
  every (shift, OCC) entry; each allocated entry's bits exact and its rho
  above the DTX threshold.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np, to_torch

from srsran_project_tpu.ops import sequences as jseq
from srsran_project_tpu.phy import pucch as jpucch
from srsran_project_tpu.phy import pucch_f2 as jf2
from srsran_project_tpu_torch.ops import sequences as tseq
from srsran_project_tpu_torch.phy import pucch as tpucch
from srsran_project_tpu_torch.phy import pucch_f2 as tf2

NSC = 48
SNR_DB = 10.0


def test_low_papr_tables_copy():
    ours = np.load(os.path.join(os.path.dirname(tseq.__file__), "_low_papr_phi.npz"))
    ref = np.load(os.path.join(os.path.dirname(jseq.__file__), "_low_papr_phi.npz"))
    assert sorted(ours.files) == sorted(ref.files)
    for name in ref.files:
        np.testing.assert_array_equal(ours[name], ref[name])
    for length in (6, 12, 18, 24, 30, 36, 48, 96):
        for u in (0, 7, 29):
            for v in ((0, 1) if length >= 72 else (0,)):
                np.testing.assert_array_equal(tseq.base_sequence(u, v, length),
                                              jseq.base_sequence(u, v, length))
    for hopping in ("neither", "enable", "disable"):
        for n_id in (0, 31, 1007):
            for slot, sym in ((0, 0), (3, 12), (19, 7)):
                assert (tseq.group_hopping_params(n_id, slot, sym, hopping)
                        == jseq.group_hopping_params(n_id, slot, sym, hopping))


def test_generate():
    for alpha in (0.0, 2 * np.pi / 12 * 5, 2 * np.pi / 12 * 11):
        want = np.asarray(jseq.generate(5, 0, 12, jnp.float32(alpha)))
        got = to_np(tseq.generate(5, 0, 12, float(np.float32(alpha)), device="cpu"))
        assert got.dtype == np.complex64 and np.abs(got - want).max() <= 1e-6


def _awgn(rng, shape):
    s = np.sqrt(0.5 * 10 ** (-SNR_DB / 10))
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * s).astype(np.complex64)


def _place(grid, sig, syms, prbs, h):
    for row, (s, prb) in enumerate(zip(syms, prbs)):
        grid[:, s, prb * 12 : prb * 12 + 12] += h[:, None] * sig[row]


def _h(rng, ports):
    h = rng.standard_normal(ports) + 1j * rng.standard_normal(ports)
    return (h / np.linalg.norm(h) * np.sqrt(ports)).astype(np.complex64)


F0_CASES = [
    dict(nof_harq_bits=1, second_hop_prb=None, sr_opportunity=False),
    dict(nof_harq_bits=2, second_hop_prb=3, sr_opportunity=False),
    dict(nof_harq_bits=1, second_hop_prb=None, sr_opportunity=True),
    dict(nof_harq_bits=2, second_hop_prb=2, sr_opportunity=True),
]


@pytest.mark.parametrize("ports", [1, 4])
@pytest.mark.parametrize("case", range(len(F0_CASES)))
def test_format0(case, ports):
    kw = dict(prb=1, start_symbol=12, nof_symbols=2, initial_cyclic_shift=3, n_id=77,
              slot_in_frame=5, nof_grid_sc=NSC, **F0_CASES[case])
    jc, tc = jpucch.PucchFormat0Config(**kw), tpucch.PucchFormat0Config(**kw)
    rng = np.random.default_rng(case * 10 + ports)
    sr = kw["sr_opportunity"]
    value = int(rng.integers(0, 2 ** kw["nof_harq_bits"]))
    want_sig = jpucch.format0_generate(jc, value, sr=sr)
    sig = to_np(tpucch.format0_generate(tc, value, sr=sr, device="cpu"))
    assert np.abs(sig - want_sig).max() <= 1e-6
    hop = kw["second_hop_prb"] if kw["second_hop_prb"] is not None else kw["prb"]
    grid = _awgn(rng, (ports, 14, NSC))
    _place(grid, want_sig, (12, 13), (kw["prb"], hop), _h(rng, ports))
    vj, mj, pj = jpucch.format0_detect(jnp.asarray(grid), jc)
    vt, mt, pt = tpucch.format0_detect(to_torch(grid), tc)
    expect = value + (len(tpucch._f0_candidates(tc)) // 2 if sr else 0)
    assert int(vt) == int(vj) == expect
    assert float(mt) > tpucch.F0_DTX_THRESHOLD
    np.testing.assert_allclose(float(mt), float(mj), rtol=1e-4)
    np.testing.assert_allclose(to_np(pt), np.asarray(pj), rtol=1e-4)


@pytest.mark.parametrize("ports", [1, 4])
@pytest.mark.parametrize("nbits, hop, nsym", [(1, None, 14), (2, None, 9), (1, 3, 14), (2, 2, 10)])
def test_format1(nbits, hop, nsym, ports):
    kw = dict(prb=1, start_symbol=14 - nsym, nof_symbols=nsym, initial_cyclic_shift=6,
              occ_index=1, n_id=300, slot_in_frame=2, nof_harq_bits=nbits, nof_grid_sc=NSC,
              second_hop_prb=hop)
    jc, tc = jpucch.PucchFormat1Config(**kw), tpucch.PucchFormat1Config(**kw)
    rng = np.random.default_rng(nbits * 100 + nsym + ports)
    bits = rng.integers(0, 2, size=(nbits,), dtype=np.uint8)
    want_sig = jpucch.format1_generate(jc, bits)
    sig = to_np(tpucch.format1_generate(tc, bits, device="cpu"))
    assert np.abs(sig - want_sig).max() <= 1e-6
    grid = _awgn(rng, (ports, 14, NSC))
    h = _h(rng, ports)
    for hop_syms, _d, _z, prb in jpucch._f1_hops(jc):
        rows = [s - kw["start_symbol"] for s in hop_syms]
        _place(grid, want_sig[rows], hop_syms, [prb] * len(rows), h)
    bj, lj, rj = jpucch.format1_detect(jnp.asarray(grid), jc)
    bt, lt, rt = tpucch.format1_detect(to_torch(grid), tc)
    np.testing.assert_array_equal(to_np(bt), bits)
    np.testing.assert_array_equal(to_np(bt), np.asarray(bj))
    assert float(rt) > tpucch.F1_DTX_THRESHOLD
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-4)
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), rtol=1e-4)


@pytest.mark.parametrize("ports", [1, 4])
@pytest.mark.parametrize("nbits, rbs, nsym, hop", [(6, 1, 1, None), (22, 2, 2, None),
                                                   (11, 2, 2, 1), (40, 3, 2, None)])
def test_format2(nbits, rbs, nsym, hop, ports):
    kw = dict(rb_start=0, rb_count=rbs, start_symbol=14 - nsym, nof_symbols=nsym,
              nof_uci_bits=nbits, rnti=0x4601 + nbits, n_id=5, n_id0=9, slot_in_frame=3,
              nof_rx_ports=ports, nof_grid_sc=NSC, second_hop_rb_start=hop)
    jc, tc = jf2.PucchFormat2Config(**kw), tf2.PucchFormat2Config(**kw)
    for a, b in zip(tf2._re_layout(tc), jf2._re_layout(jc)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tf2._dmrs_pilots(tc), jf2._dmrs_pilots(jc))
    rng = np.random.default_rng(nbits * 10 + ports)
    bits = rng.integers(0, 2, size=(nbits,), dtype=np.uint8)
    want = jf2.generate(jc, bits)
    sig = to_np(tf2.generate(tc, bits, device="cpu"))
    assert np.abs(sig - want).max() <= 1e-6
    grid = _awgn(rng, (ports, 14, NSC)) + _h(rng, ports)[:, None, None] * want[None]
    bj, okj, sj = jf2.process(jnp.asarray(grid), jc)
    bt, okt, st = tf2.process(to_torch(grid), tc)
    assert bool(okt) and bool(okj)
    np.testing.assert_array_equal(to_np(bt), bits)
    np.testing.assert_array_equal(to_np(bt), np.asarray(bj))
    np.testing.assert_allclose(float(st), float(sj), atol=1e-3)


# Four F1 UEs multiplexed on one PRB: (initial cyclic shift, OCC index,
# HARQ bits).
F1_BATCH = ((0, 0, 1), (3, 1, 2), (6, 0, 2), (9, 1, 1))


@pytest.mark.parametrize("ports", [1, 4])
@pytest.mark.parametrize("hop, nsym", [(None, 14), (3, 14), (None, 9)])
def test_format1_batch(hop, nsym, ports):
    """format1_detect_batch on four multiplexed F1 transmissions (the case
    the per-UE detector cannot separate): the bank against the
    reference's, and each UE's bits from its own entry."""
    rng = np.random.default_rng(7 + ports + nsym + (hop or 0))
    base = dict(prb=1, start_symbol=14 - nsym, nof_symbols=nsym, n_id=300, slot_in_frame=2,
                nof_grid_sc=NSC, second_hop_prb=hop)
    grid = _awgn(rng, (ports, 14, NSC))
    sent = []
    for m0, occ, nbits in F1_BATCH:
        jc = jpucch.PucchFormat1Config(initial_cyclic_shift=m0, occ_index=occ,
                                       nof_harq_bits=nbits, **base)
        bits = rng.integers(0, 2, size=(nbits,), dtype=np.uint8)
        sig = jpucch.format1_generate(jc, bits)
        h = _h(rng, ports)
        for hop_syms, _d, _z, prb in jpucch._f1_hops(jc):
            _place(grid, sig[[s - base["start_symbol"] for s in hop_syms]], hop_syms,
                   [prb] * len(hop_syms), h)
        sent.append((m0, occ, bits))
    kw = dict(initial_cyclic_shift=0, occ_index=0, **base)
    want = jpucch.format1_detect_batch(jnp.asarray(grid), jpucch.PucchFormat1Config(**kw))
    got = tpucch.format1_detect_batch(to_torch(grid), tpucch.PucchFormat1Config(**kw))
    corr_j = np.asarray(want["corr"])
    assert to_np(got["corr"]).shape == corr_j.shape and corr_j.shape[0] == 12
    assert np.abs(to_np(got["corr"]) - corr_j).max() <= 1e-4 * np.abs(corr_j).max()
    assert np.abs(to_np(got["rho"]) - np.asarray(want["rho"])).max() <= 1e-4
    np.testing.assert_array_equal(to_np(got["bits2"]), np.asarray(want["bits2"]))
    for m0, occ, bits in sent:
        np.testing.assert_array_equal(to_np(got["bits2"][m0, occ, : bits.size]), bits)
        assert float(got["rho"][m0, occ]) > tpucch.F1_DTX_THRESHOLD
