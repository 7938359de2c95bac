"""The five public helpers the port's ``ops`` modules took over from the
JAX package, each against the JAX function on the CPU:

* ``short_block.detect_ref``: the reference-exact short-block detector.
  It replays the ``short_block`` and ``uci_decoder`` golden suites with
  the JAX tests' bounds (``tests/vectors/test_golden_polar.py`` and
  ``test_golden_tail.py``): bits exact, and the ok flag equal to the
  reference's verdict. On random int8 LLRs it gives the JAX function's
  bits and flags exactly.
* ``modulation/evm.hard_decision_bits``: bits equal to the JAX
  function's for every modulation.
* ``ldpc/rate_match.selection_indices``: the indices equal, and the port's
  own rate matcher reads the circular buffer at exactly those positions.
* ``ldpc/segmenter.rate_matched_length``: the golden ``rm_length`` of
  every ``ldpc_segmenter`` case.
* ``ldpc/decoder.decode_count_iters``: bits, a-posteriori LLRs and
  per-codeblock counts equal to the JAX function's at a fixed seed.
  Both round the same float32 operations in the same order, the
  a-posteriori update as one fused multiply-add, so the tolerance is zero.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np

from srsran_project_tpu.ops import short_block as j_sb
from srsran_project_tpu.ops.ldpc import decoder as j_dec
from srsran_project_tpu.ops.ldpc import graphs
from srsran_project_tpu.ops.ldpc import rate_match as j_rm
from srsran_project_tpu.ops.ldpc import segmenter as j_seg
from srsran_project_tpu.ops.modulation import evm as j_evm
from srsran_project_tpu.ops.modulation import mapper as j_map
from srsran_project_tpu.support.file_vector import read_vector
from srsran_project_tpu_torch.ops import short_block as t_sb
from srsran_project_tpu_torch.ops.ldpc import decoder as t_dec
from srsran_project_tpu_torch.ops.ldpc import encoder as t_enc
from srsran_project_tpu_torch.ops.ldpc import rate_match as t_rm
from srsran_project_tpu_torch.ops.ldpc import segmenter as t_seg
from srsran_project_tpu_torch.ops.modulation import Modulation
from srsran_project_tpu_torch.ops.modulation import evm as t_evm
from srsran_project_tpu_torch.ops.modulation import mapper as t_map

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
QM = {"qpsk": 2, "qam16": 4, "qam64": 6, "qam256": 8}


def _suite(name: str) -> list:
    with open(os.path.join(GOLDEN, name, "manifest.json")) as f:
        return json.load(f)


def _vec(suite: str, fname: str, dtype: str) -> np.ndarray:
    return read_vector(os.path.join(GOLDEN, suite, fname), dtype)


# ---- short_block.detect_ref ------------------------------------------------------

def test_detect_ref_short_block_golden():
    """test_golden_polar.py::test_short_block_golden's detection on the
    port: every case's bits equal the reference's, its ok flag the
    reference's detect_ok; and both equal the JAX function's."""
    cases = _suite("short_block")
    assert len(cases) >= 40
    for case in cases:
        llrs = _vec("short_block", f"llrs{case['idx']}.dat", "i8")
        ref_det = _vec("short_block", f"det{case['idx']}.dat", "u8")
        bits, ok = t_sb.detect_ref(torch.from_numpy(llrs)[None], case["k"], case["e"], case["qm"])
        np.testing.assert_array_equal(to_np(bits)[0], ref_det, err_msg=f"detect {case}")
        assert int(to_np(ok)[0]) == case["detect_ok"], f"detect_ok {case}"
        jbits, jok = j_sb.detect_ref(jnp.asarray(llrs)[None], case["k"], case["e"], case["qm"])
        np.testing.assert_array_equal(to_np(bits), np.asarray(jbits))
        np.testing.assert_array_equal(to_np(ok), np.asarray(jok))


def test_detect_ref_uci_decoder_golden():
    """test_golden_tail.py::test_uci_decoder_golden's short-block cases
    (A <= 11) on the port: bits equal the reference's message, the ok flag
    the reference's status, and a valid decode the payload."""
    cases = [c for c in _suite("uci_decoder") if c["a"] <= 11]
    assert len(cases) >= 6
    for case in cases:
        a, e = case["a"], case["e"]
        llrs = _vec("uci_decoder", f"llrs{case['idx']}.dat", "i8")
        ref_msg = _vec("uci_decoder", f"message{case['idx']}.dat", "u8")
        payload = _vec("uci_decoder", f"payload{case['idx']}.dat", "u8")
        bits, ok = t_sb.detect_ref(torch.from_numpy(llrs)[None], a, e, QM[case["mod"]])
        np.testing.assert_array_equal(to_np(bits)[0], ref_msg, err_msg=f"short {case}")
        assert bool(to_np(ok)[0]) == (case["status"] == "valid"), case
        if case["status"] == "valid":
            np.testing.assert_array_equal(ref_msg, payload)


DETECT_CASES = [(1, 2, 2), (1, 17, 6), (1, 9, 1), (2, 3, 1), (2, 16, 4), (2, 50, 8), (2, 6, 2),
                (3, 32, 2), (4, 20, 4), (6, 64, 6), (7, 31, 1), (9, 100, 2), (11, 40, 8)]


@pytest.mark.parametrize("k, e, qm", DETECT_CASES)
def test_detect_ref_matches_jax(k, e, qm):
    """On random int8 LLRs (the +-127 markers, zeros and saturating folds
    among them), noisy codewords included, the bits and ok flags equal the
    JAX function's."""
    rng = np.random.default_rng(100 * k + e)
    noise = rng.integers(-127, 128, size=(64, e))
    cw = to_np(t_sb.encode(torch.from_numpy(rng.integers(0, 2, size=(64, k), dtype=np.uint8)), e))
    clean = np.where(cw[:, :e] == 1, -40, 40) + rng.integers(-30, 31, size=(64, e))
    llrs = np.concatenate([noise, clean]).clip(-127, 127).astype(np.int8)
    llrs[0] = 0
    llrs[1, ::3] = 127
    bits, ok = t_sb.detect_ref(torch.from_numpy(llrs), k, e, qm)
    jbits, jok = j_sb.detect_ref(jnp.asarray(llrs), k, e, qm)
    np.testing.assert_array_equal(to_np(bits), np.asarray(jbits))
    np.testing.assert_array_equal(to_np(ok), np.asarray(jok))
    assert bits.dtype == torch.uint8 and ok.dtype == torch.bool and bits.shape == (128, k)


# ---- modulation/evm.hard_decision_bits ---------------------------------------------

@pytest.mark.parametrize("mod", ["BPSK", "QPSK", "QAM16", "QAM64", "QAM256"])
def test_hard_decision_bits(mod):
    """tests/test_modulation.py's hard decision on the port (noisy mapped
    symbols give their bits back), and the JAX function's bits on symbols
    spread over the whole plane."""
    rng = np.random.default_rng(9)
    m = Modulation[mod]
    qm = t_map.bits_per_symbol(m)
    bits = rng.integers(0, 2, size=(3, 60 * qm), dtype=np.uint8)
    syms = t_map.map_bits(torch.from_numpy(bits), m)
    noisy = syms + torch.complex(*torch.from_numpy(0.01 * rng.standard_normal((2,) + tuple(
        syms.shape))).float())
    np.testing.assert_array_equal(to_np(t_evm.hard_decision_bits(noisy, m)), bits)
    spread = (1.3 * (rng.standard_normal((4, 500)) + 1j * rng.standard_normal((4, 500)))
              ).astype(np.complex64)
    got = t_evm.hard_decision_bits(torch.from_numpy(spread), m)
    want = j_evm.hard_decision_bits(jnp.asarray(spread), j_map.Modulation[mod])
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


# ---- ldpc/rate_match.selection_indices ---------------------------------------------

SELECTION_CASES = [(2, 10, None, 120, 0, 2, "full"), (2, 10, "2z", 200, 0, 1, "full"),
                   (1, 384, 8000, 25344, 2, 8, "full"), (1, 384, 8000, 30000, 3, 8, 25344),
                   (2, 36, 400, 2000, 2, 2, "full"), (1, 16, 300, 1200, 3, 4, 800),
                   (2, 20, None, 900, 1, 6, "full")]


@pytest.mark.parametrize("bg, z, k_prime, e, rv, qm, n_cb", SELECTION_CASES)
def test_selection_indices(bg, z, k_prime, e, rv, qm, n_cb):
    """The indices equal the JAX function's (tests/test_ldpc.py's two
    basic checks hold on them), as a tensor too, and the port's rate
    matcher transmits exactly the circular buffer's bits at them."""
    g = graphs.get_graph(bg, z)
    if k_prime is None:
        k_prime = g.kb * z
    elif k_prime == "2z":
        k_prime = g.kb * z - 2 * z
    n_cb = g.nof_codeword_bits if n_cb == "full" else n_cb
    idx = t_rm.selection_indices(bg, z, k_prime, e, rv, qm, n_cb)
    np.testing.assert_array_equal(idx, j_rm.selection_indices(bg, z, k_prime, e, rv, qm, n_cb))
    assert idx.dtype == np.int32 and idx.shape == (e,)
    on = t_rm.selection_indices(bg, z, k_prime, e, rv, qm, n_cb, device="cpu")
    np.testing.assert_array_equal(to_np(on), idx)
    f_lo, f_hi = k_prime - 2 * z, g.kb * z - 2 * z
    assert not np.any((idx >= f_lo) & (idx < f_hi))
    if rv == 0 and k_prime == g.kb * z:
        deint = idx.reshape(e // qm, qm).T.reshape(-1)
        np.testing.assert_array_equal(deint, np.arange(e) % n_cb)
    buf = np.random.default_rng(e).integers(0, 2, size=(2, n_cb), dtype=np.uint8)
    buf[:, f_lo:f_hi] = 0
    tx = t_rm.rate_match(torch.from_numpy(buf), bg, z, k_prime, e, rv, qm, n_cb)
    np.testing.assert_array_equal(to_np(tx), buf[:, idx])


# ---- ldpc/segmenter.rate_matched_length --------------------------------------------

def test_rate_matched_length_golden():
    """test_golden_coding.py's rm_length cross-check on the port: E_j of
    every ldpc_segmenter golden case, equal to the JAX function's."""
    cases = _suite("ldpc_segmenter")
    assert len(cases) >= 100
    for case in cases:
        tbs = 8 * case["tbs_bytes"]
        params = t_seg.compute_segment_params_bg(tbs, case["bg"])
        assert (params.nof_codeblocks, params.lifting_size) == (case["nof_cb"], case["ls"])
        args = (case["cb_index"], case["qm"], case["layers"], case["ch_symbols"])
        assert t_seg.rate_matched_length(params, *args) == case["rm_length"], case
        jparams = j_seg.compute_segment_params_bg(tbs=tbs, base_graph=case["bg"])
        assert j_seg.rate_matched_length(jparams, *args) == case["rm_length"]


# ---- ldpc/decoder.decode_count_iters -----------------------------------------------

COUNT_CASES = [(2, 16, 6), (2, 36, 6), (1, 8, 6), (1, 24, 3), (1, 16, 10)]


@pytest.mark.parametrize("bg, z, iters", COUNT_CASES)
def test_decode_count_iters(bg, z, iters):
    """Random codewords in AWGN, its level rising from codeblock to
    codeblock (some converge early, some late, some never): bits,
    a-posteriori LLRs and counts equal the JAX function's, every
    iteration runs (the a-posteriori LLRs equal the fixed-budget plain
    decode's), and a converged codeblock's bits are its message."""
    rng = np.random.default_rng(z + iters)
    g = graphs.get_graph(bg, z)
    msg = torch.from_numpy(rng.integers(0, 2, size=(8, g.kb * z), dtype=np.uint8))
    cw = to_np(t_enc.encode_to_buffer(msg, bg, z))
    sigma = 4.0 * (1.0 + 0.3 * np.arange(8))[:, None]
    llr = (1.0 - 2.0 * cw) * 8.0 + rng.normal(0.0, 1.0, size=cw.shape) * sigma
    llr = np.clip(np.round(llr), -120, 120).astype(np.float32)
    bits, app, count = t_dec.decode_count_iters(torch.from_numpy(llr), bg, z, iters)
    jbits, japp, jcount = j_dec.decode_count_iters(jnp.asarray(llr), bg, z, iters)
    np.testing.assert_array_equal(to_np(bits), np.asarray(jbits))
    np.testing.assert_array_equal(to_np(app), np.asarray(japp))
    np.testing.assert_array_equal(to_np(count), np.asarray(jcount))
    assert count.dtype == torch.int32 and app.shape == (8, g.n * z)
    pbits, papp, piters = t_dec.decode_plain(torch.from_numpy(llr), bg, z, iters)
    np.testing.assert_array_equal(to_np(papp), to_np(app))
    assert (to_np(piters) == iters).all()
    c = to_np(count)
    assert c.min() < iters, c  # some codeblock converged before the budget
    for i in np.nonzero(c < iters)[0]:
        np.testing.assert_array_equal(to_np(bits)[i], to_np(msg)[i])
