"""PUCCH formats 0, 1 and 2 (phy/pucch.py, phy/pucch_f2.py) and the
low-PAPR sequences under them (ops/sequences.py) against the JAX package.

Tolerances:
* the copied host tables and plans (``_low_papr_phi.npz``,
  ``base_sequence``, ``group_hopping_params``, ``_re_layout``,
  ``_dmrs_pilots``): exact;
* ``sequences.generate`` and the UE-side grids of all three formats: 1e-6
  absolute on unit-modulus values (the float32 phase ramp's cos and sin
  round differently in the two libraries); F1's also against the
  benchmark's plain reference (``portbench/reference/pucch.py``, the spec's
  tables in float64): 5e-6 (``SPEC_ATOL``).  Where a part of an F1 hop has
  4 symbols, Table 6.3.2.4.1-2's OCCs are Walsh's rows, which the program
  follows and the JAX package does not: there the program is held to the
  plain reference and to the sent bits alone;
* detected values, HARQ bits, UCI bits and ok flags: exact (and the sent
  ones), on 1 and 4 ports, with and without a second hop;
* F0 metric and F1 rho: rtol 1e-4; F2 snr_db: atol 1e-3 (float32
  correlations and estimates summed in another order).  The SNR (10 dB per
  port) keeps every metric far from its DTX threshold;
* the batched F1 detector (``format1_detect_batch``): corr within 1e-4 of
  its largest value and rho within 1e-4 absolute of the JAX package's on
  every (shift, OCC) entry where its OCCs are the spec's; rho within 1e-4
  of the plain reference's correlation of each (shift, OCC) sequence, and
  the bits where it detects; each allocated entry's bits exact and its
  rho above the DTX threshold.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np, to_torch

from portbench.reference import pucch as ref_pucch
from srsran_project_tpu.ops import sequences as jseq
from srsran_project_tpu.phy import pucch as jpucch
from srsran_project_tpu.phy import pucch_f2 as jf2
from srsran_project_tpu_torch.ops import sequences as tseq
from srsran_project_tpu_torch.phy import pucch as tpucch
from srsran_project_tpu_torch.phy import pucch_f2 as tf2

NSC = 48
SNR_DB = 10.0
# The program's F1 signal against the plain reference's: its float32
# phase ramp alpha n (alpha < 2 pi, n < 12) against a float64 one, at most
# half an ulp of alpha times 11 plus half an ulp of 70, 4.5e-6 rad.
SPEC_ATOL = 5e-6


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


def _four_symbol_parts(cfg) -> bool:
    """Whether a hop's DM-RS or data part has 4 symbols: there Table
    6.3.2.4.1-2's OCCs are Walsh's rows, which the program sends and the
    JAX package does not (it takes the DFT's rows at every length)."""
    return any(len(part) == 4 for _s, dmrs, data, _p in tpucch._f1_hops(cfg)
               for part in (dmrs, data))


def _spec_f1(kw) -> ref_pucch.F1:
    return ref_pucch.F1(prb=kw["prb"], second_hop_prb=kw["second_hop_prb"],
                        start_symbol=kw["start_symbol"], nof_symbols=kw["nof_symbols"],
                        cyclic_shift=kw["initial_cyclic_shift"], occ=kw["occ_index"],
                        n_id=kw["n_id"], nof_bits=kw.get("nof_harq_bits", 2),
                        slot=kw["slot_in_frame"])


def _spec_signal(kw, bits) -> np.ndarray:
    """The (nof_symbols, 12) signal of an F1 UE as the benchmark's plain
    reference sends it, from the spec's own tables."""
    o = _spec_f1(kw)
    tx = ref_pucch.f1_transmit(o, torch.from_numpy(np.asarray(bits, np.uint8))[None])
    return np.stack([tx[s][1][0].numpy()
                     for s in range(o.start_symbol, o.start_symbol + o.nof_symbols)])


@pytest.mark.parametrize("ports", [1, 4])
@pytest.mark.parametrize("nbits, hop, nsym", [(1, None, 14), (2, None, 9), (1, 3, 14), (2, 2, 10)])
def test_format1(nbits, hop, nsym, ports):
    kw = dict(prb=1, start_symbol=14 - nsym, nof_symbols=nsym, initial_cyclic_shift=6,
              occ_index=1, n_id=300, slot_in_frame=2, nof_harq_bits=nbits, nof_grid_sc=NSC,
              second_hop_prb=hop)
    jc, tc = jpucch.PucchFormat1Config(**kw), tpucch.PucchFormat1Config(**kw)
    jax_agrees = not _four_symbol_parts(tc)
    rng = np.random.default_rng(nbits * 100 + nsym + ports)
    bits = rng.integers(0, 2, size=(nbits,), dtype=np.uint8)
    sig = to_np(tpucch.format1_generate(tc, bits, device="cpu"))
    assert np.abs(sig - _spec_signal(kw, bits)).max() <= SPEC_ATOL
    if jax_agrees:
        assert np.abs(sig - jpucch.format1_generate(jc, bits)).max() <= 1e-6
    grid = _awgn(rng, (ports, 14, NSC))
    h = _h(rng, ports)
    for hop_syms, _d, _z, prb in tpucch._f1_hops(tc):
        rows = [s - kw["start_symbol"] for s in hop_syms]
        _place(grid, sig[rows], hop_syms, [prb] * len(rows), h)
    bt, lt, rt = tpucch.format1_detect(to_torch(grid), tc)
    np.testing.assert_array_equal(to_np(bt), bits)
    assert float(rt) > tpucch.F1_DTX_THRESHOLD
    ref_bits, _ = ref_pucch.f1_receive(torch.from_numpy(grid)[None], _spec_f1(kw))
    np.testing.assert_array_equal(ref_bits[0].numpy(), bits)
    if jax_agrees:
        bj, lj, rj = jpucch.format1_detect(jnp.asarray(grid), jc)
        np.testing.assert_array_equal(to_np(bt), np.asarray(bj))
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
    the per-UE detector cannot separate): the bank against the plain
    reference's correlation of each (shift, OCC) sequence and against the
    JAX package's where its OCCs are the spec's (OCC 0, or no 4-symbol
    part), and each UE's bits from its own entry."""
    rng = np.random.default_rng(7 + ports + nsym + (hop or 0))
    base = dict(prb=1, start_symbol=14 - nsym, nof_symbols=nsym, n_id=300, slot_in_frame=2,
                nof_grid_sc=NSC, second_hop_prb=hop)
    grid = _awgn(rng, (ports, 14, NSC))
    sent = []
    for m0, occ, nbits in F1_BATCH:
        tc = tpucch.PucchFormat1Config(initial_cyclic_shift=m0, occ_index=occ,
                                       nof_harq_bits=nbits, **base)
        bits = rng.integers(0, 2, size=(nbits,), dtype=np.uint8)
        sig = to_np(tpucch.format1_generate(tc, bits, device="cpu"))
        h = _h(rng, ports)
        for hop_syms, _d, _z, prb in tpucch._f1_hops(tc):
            _place(grid, sig[[s - base["start_symbol"] for s in hop_syms]], hop_syms,
                   [prb] * len(hop_syms), h)
        sent.append((m0, occ, bits))
    kw = dict(initial_cyclic_shift=0, occ_index=0, **base)
    cfg = tpucch.PucchFormat1Config(**kw)
    want = jpucch.format1_detect_batch(jnp.asarray(grid), jpucch.PucchFormat1Config(**kw))
    got = tpucch.format1_detect_batch(to_torch(grid), cfg)
    corr_j = np.asarray(want["corr"])
    assert to_np(got["corr"]).shape == corr_j.shape and corr_j.shape[0] == 12
    occs = slice(None) if not _four_symbol_parts(cfg) else slice(0, 1)
    scale = np.abs(corr_j).max()
    assert np.abs(to_np(got["corr"])[:, occs] - corr_j[:, occs]).max() <= 1e-4 * scale
    assert np.abs(to_np(got["rho"])[:, occs] - np.asarray(want["rho"])[:, occs]).max() <= 1e-4
    np.testing.assert_array_equal(to_np(got["bits2"])[:, occs], np.asarray(want["bits2"])[:, occs])
    # Every OCC that each part of the allocation can carry, at every shift.
    nof_occ = min(len(part) for _s, dmrs, data, _p in tpucch._f1_hops(cfg) for part in (dmrs, data))
    g = torch.from_numpy(grid)[None]
    for m0 in range(12):
        for occ in range(nof_occ):
            ref_bits, ref_rho = ref_pucch.f1_receive(
                g, _spec_f1(dict(kw, initial_cyclic_shift=m0, occ_index=occ)))
            assert abs(float(got["rho"][m0, occ]) - float(ref_rho[0])) <= 1e-4, (m0, occ)
            if float(ref_rho[0]) > tpucch.F1_DTX_THRESHOLD:
                np.testing.assert_array_equal(to_np(got["bits2"][m0, occ]), ref_bits[0].numpy())
    for m0, occ, bits in sent:
        np.testing.assert_array_equal(to_np(got["bits2"][m0, occ, : bits.size]), bits)
        assert float(got["rho"][m0, occ]) > tpucch.F1_DTX_THRESHOLD
