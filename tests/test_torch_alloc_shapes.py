"""General allocation shapes (ROADMAP Q1.8.11) against the JAX package:
data on the DM-RS symbols, DM-RS type 2, any first symbol and PRB.

* the scatter grid assembly (``pdsch._grid_chain``, through the port's
  ``pdsch.process``): equal within 1e-6 x RMS;
* the per-RE ``equalize`` (4x4 MMSE in the structure-of-arrays algebra,
  every other L <= 4 and P, MMSE and ZF): within 1e-4 x max(1, |.|)
  (XLA:CPU contracts the reference's products into FMAs, as for K3);
* the estimator's single-pair branch: within 1e-6;
* ``pusch.process`` on each shape (the port's UE side, random unitary
  channel, AWGN): int8 LLRs +-1 and >= 99.9 % equal, TB bits and CRC exact,
  snr_db within 1e-3; ``process_multi`` on two type-2 grants likewise;
* square ZF on channels of condition number about 100 (ROADMAP Q3): TB
  bits and CRC exact, each package's weights near a float64 numpy ZF, and
  the LLR agreement that distance justifies.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (assert_llr_gate, grant_configs, loopback, process_parity, to_np,
                          to_torch)

from srsran_project_tpu.ops import equalizer as jeq
from srsran_project_tpu.ops import estimator as jest
from srsran_project_tpu.phy import pdsch as jpdsch
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu_torch.ops import equalizer as teq
from srsran_project_tpu_torch.ops import estimator as test_
from srsran_project_tpu_torch.phy import pdsch as tpdsch
from srsran_project_tpu_torch.phy import pusch as tpusch

# name -> grant_configs arguments.
SHAPES = {
    # Type 1, one CDM group without data: CDM group 1 carries data on both
    # DM-RS symbols.
    "t1-cdm1": dict(dmrs_symbols=(2, 11), cdm_without_data=1),
    # Type 2 (chip_smoke path 5b's shape): 4 layers on CDM groups 0 and 1,
    # group 2 carries data on the DM-RS symbol.
    "t2-cdm2-4x4": dict(layers=4, ports=4, modulation=6, dmrs_type=2, sym_start=1,
                        sym_count=13),
    # Type 2 with all three CDM groups empty of data: full rows, but the
    # reference's scatter assembly (its fast rows take type 1 only).
    "t2-cdm3-2x2": dict(layers=2, ports=2, dmrs_type=2, cdm_without_data=3),
    # Type 2, one CDM group without data, a grant off the grid's origin.
    "t2-cdm1-offset": dict(dmrs_type=2, cdm_without_data=1, rb_start=3, sym_start=2,
                           sym_count=10, dmrs_symbols=(3,)),
    # Rank 2 ZF on 4 ports with data on the DM-RS symbols.
    "t1-cdm1-zf": dict(layers=2, ports=4, cdm_without_data=1, equalizer="zf"),
}


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.abs(x) ** 2)))


@pytest.mark.parametrize("name", list(SHAPES))
def test_scatter_grid(name):
    """The port's pdsch.process against the reference's on a random TB and
    a random (layers, P) precoding."""
    jtx, _ = grant_configs(**SHAPES[name])
    ttx = tpdsch.PdschConfig.from_reference(jtx)
    rng = np.random.default_rng(1)
    tb = rng.integers(0, 2, size=(ttx.tbs,), dtype=np.uint8)
    w = (rng.standard_normal((ttx.nof_layers, 3)) + 1j * rng.standard_normal(
        (ttx.nof_layers, 3))).astype(np.complex64)
    g_j = np.asarray(jpdsch.process(jnp.asarray(tb), jnp.uint32(0x4601), jnp.asarray(w), jtx))
    g_t = to_np(tpdsch.process(to_torch(tb), 0x4601, to_torch(w), ttx))
    assert g_t.shape == g_j.shape == (3, 14, jtx.nof_grid_sc)
    assert np.abs(g_t - g_j).max() <= 1e-6 * _rms(g_j)
    # The batched form is the same per element.
    g_b = to_np(tpdsch.process(to_torch(np.stack([tb, tb])), 0x4601, to_torch(w), ttx))
    np.testing.assert_array_equal(g_b[1], g_t)


@pytest.mark.parametrize("name", list(SHAPES))
def test_process(name):
    jtx, jrx = grant_configs(**SHAPES[name])
    tb, rnti, rx = loopback(jtx, jrx, seed=2, snr_db=28.0)
    process_parity(jrx, rx, rnti, tb)


# (ports, layers, method) of the per-RE equalizer.
EQ_CASES = [(4, 4, "mmse"), (4, 4, "zf"), (4, 2, "mmse"), (4, 3, "zf"), (2, 2, "zf"),
            (2, 1, "mmse"), (1, 1, "zf")]


@pytest.mark.parametrize("ports, layers, method", EQ_CASES)
def test_equalize_per_re(ports, layers, method):
    """Random channels of condition number below 20, as the weights' parity
    test takes them (tests/test_torch_equalizer.py): the float32 error of
    both sides grows with its square."""
    rng = np.random.default_rng(ports * 10 + layers)
    nre = 300
    h = ((rng.standard_normal((3 * 2 * nre, ports, layers))
          + 1j * rng.standard_normal((3 * 2 * nre, ports, layers))) * 0.5).astype(np.complex64)
    h = h[np.linalg.cond(h) < 20][: 2 * nre].reshape(2, nre, ports, layers)
    y = ((rng.standard_normal((2, nre, ports)) + 1j * rng.standard_normal((2, nre, ports)))
         * 0.5).astype(np.complex64)
    nv = np.asarray([[0.02], [1e-13]], np.float32)  # one noise variance per batch row
    x_j, ev_j = jeq.equalize(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nv), method=method)
    x_t, ev_t = teq.equalize(to_torch(y), to_torch(h), to_torch(nv), method=method)
    for a, b in ((x_j, x_t), (ev_j, ev_t)):
        a, b = np.asarray(a), to_np(b)
        assert b.shape == a.shape and b.dtype == a.dtype
        assert (np.abs(a - b) <= 1e-4 * np.maximum(1.0, np.abs(a))).all(), (
            float(np.abs(a - b).max()))


def test_estimator_single_pair():
    """One CDM pair: no slope, every subcarrier takes the smoothed pair
    value (the reference's estimate_channel on the same inputs)."""
    rng = np.random.default_rng(3)
    y = (rng.standard_normal((3, 2, 2)) + 1j * rng.standard_normal((3, 2, 2))).astype(np.complex64)
    ref = np.exp(1j * rng.uniform(0, 2 * np.pi, (2,))).astype(np.complex64)
    wf = np.asarray([1.0, -1.0], np.float32)
    h_j = np.asarray(jest.estimate_channel(jnp.asarray(y), jnp.asarray(ref), jnp.asarray(wf),
                                           (0.5,), 6)[0])
    h_t = to_np(test_.estimate_h(to_torch(y), to_torch(ref), to_torch(wf), (0.5,), 6)[0])
    np.testing.assert_allclose(h_t, h_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(h_t, np.broadcast_to(h_t[..., :1], h_t.shape))


def test_process_multi_type2():
    """Two type-2 grants with data on the DM-RS symbol, one batch in each
    package: the LLRs' gate through the front end, TB bits and CRC."""
    from torch_parity import unit_channel

    _, jrx = grant_configs(nof_rb=6, dmrs_type=2, cdm_without_data=1)
    rng = np.random.default_rng(4)
    grid = np.zeros((2, 14, 24 * 12), np.complex64)
    tbs, rbs, rntis = [], [0, 12], [0x4611, 0x4612]
    for rb0, rnti in zip(rbs, rntis):
        jtx_i = dataclasses.replace(
            grant_configs(nof_rb=6, dmrs_type=2, cdm_without_data=1, crb_start=rb0)[0])
        ttx = tpdsch.PdschConfig.from_reference(jtx_i)
        tb = rng.integers(0, 2, size=(ttx.tbs,), dtype=np.uint8)
        w = unit_channel(rng, 1, 2)
        grid[:, :, rb0 * 12 : rb0 * 12 + 72] += to_np(
            tpdsch.process(to_torch(tb), rnti, to_torch(w), ttx))
        tbs.append(tb)
    grid = grid + (0.02 * (rng.standard_normal(grid.shape)
                           + 1j * rng.standard_normal(grid.shape))).astype(np.complex64)
    trx = tpusch.PuschConfig.from_reference(jrx)
    res_j = jpusch.process_multi(jnp.asarray(grid), jnp.asarray(rntis, jnp.uint32), rbs, jrx)
    res_t = tpusch.process_multi(to_torch(grid), rntis, rbs, trx)
    for i, tb in enumerate(tbs):
        assert bool(res_t["tb_crc_ok"][i]) and bool(np.asarray(res_j["tb_crc_ok"])[i])
        np.testing.assert_array_equal(to_np(res_t["tb_bits"][i]), tb)
        np.testing.assert_array_equal(np.asarray(res_j["tb_bits"])[i], tb)
    np.testing.assert_allclose(to_np(res_t["snr_db"]), np.asarray(res_j["snr_db"]), atol=1e-3)


# ---- square ZF at high condition numbers (ROADMAP Q3) -----------------------

def _ill_conditioned(rng, n: int, cond: float) -> np.ndarray:
    """(n, n) complex channel U diag(s) V^H with singular values from
    sqrt(n) down to sqrt(n) / cond."""
    def unitary():
        return np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))[0]

    return (unitary() * (np.geomspace(1.0, 1.0 / cond, n) * np.sqrt(n))) @ unitary().conj().T


@pytest.mark.parametrize("n", [2, 4])
def test_square_zf_high_condition(n):
    """A ZF grant on an n x n channel of condition number 100 at 45 dB.

    The oracle: a float64 numpy ZF on the same (JAX) channel estimate and
    noise, applied in float64 to the same data rows, then the port's
    demap.  Both packages' float32 weights sit 1e-4 to 1e-3 x max|W| from
    it (the float32 inverse of a Gram matrix of condition number 1e4), and
    their LLRs differ from the oracle's by +-1 on a fraction f_jax, f_port
    of positions.  Pinned: the port's weights no further from the oracle
    than 1.5x the reference's; its LLRs within +-1 of the oracle's on at
    most 1.5 f_jax + 0.2 % of positions; port and reference within +-1 of
    each other on at most f_jax + f_port (the two disagreement sets
    together); TB bits and CRC exact."""
    rng = np.random.default_rng(100 + n)
    jtx, jrx = grant_configs(layers=n, ports=n, dmrs_symbols=(2,), sym_start=1, sym_count=13,
                             equalizer="zf")
    h = _ill_conditioned(rng, n, 100.0)  # (ports, layers)
    tb, rnti, rx = loopback(jtx, jrx, seed=5, snr_db=45.0, channel=h.T.astype(np.complex64))
    trx = tpusch.PuschConfig.from_reference(jrx)

    gflat_j, h_j, nv_j, _ = jpusch._estimate_stage(jnp.asarray(rx), jrx)
    hs = np.moveaxis(np.asarray(h_j), 0, 1)  # (nsc, P, L)
    w_j, _ = jeq.equalize_weights(jnp.asarray(hs), nv_j, method="zf")
    w_t, _ = teq.equalize_weights(to_torch(hs), torch.tensor(float(nv_j)), method="zf")
    h64 = hs.astype(np.complex128)
    hh = np.conj(np.swapaxes(h64, -1, -2))
    ci = np.linalg.inv(hh @ h64 + 1e-9 * np.eye(n))
    w64 = ci @ hh
    assert np.linalg.cond(h64).max() > 90.0
    scale = np.abs(w64).max()
    d_j = np.abs(np.asarray(w_j) - w64).max() / scale
    d_t = np.abs(to_np(w_t) - w64).max() / scale
    assert d_j < 1e-3 and d_t <= 1.5 * d_j, (d_j, d_t)

    # The oracle's LLRs: float64 weights on the data rows, the port's demap.
    a = jrx.alloc
    data_syms = [s for s in range(a.sym_start, a.sym_start + a.sym_count)
                 if s not in a.dmrs_symbols]
    y = np.asarray(gflat_j).reshape(n, 14, -1)[:, data_syms].astype(np.complex128)
    x64 = np.einsum("nlp,psn->snl", w64, y).reshape(1, -1, n)
    ev64 = float(nv_j) * np.real(np.einsum("nii->ni", ci))
    ev64 = np.broadcast_to(ev64, (len(data_syms),) + ev64.shape).reshape(1, -1, n)
    llr64 = to_np(tpusch._demap_stage(to_torch(x64.astype(np.complex64)),
                                      to_torch(ev64.astype(np.float32)),
                                      torch.tensor([rnti]), trx)[0][0]).astype(np.int32)

    gj, gt = jnp.asarray(rx), to_torch(rx)[None]
    llr_j = np.asarray(jpusch._front_end(gj, jnp.uint32(rnti), jrx)[0]).astype(np.int32)
    llr_t = to_np(tpusch._front_end(gt, torch.tensor([rnti]), trx)[0][0]).astype(np.int32)
    f_j, f_t = float((llr_j != llr64).mean()), float((llr_t != llr64).mean())
    assert np.abs(llr_j - llr64).max() <= 1 and np.abs(llr_t - llr64).max() <= 1
    assert f_t <= 1.5 * f_j + 2e-3, (f_j, f_t)
    d = np.abs(llr_j - llr_t)
    assert d.max() <= 1 and float((d != 0).mean()) <= f_j + f_t, (f_j, f_t, (d != 0).mean())
    res_t = tpusch.process(gt, torch.tensor([rnti]), trx)
    res_j = jpusch.process(gj, jnp.uint32(rnti), jrx)
    assert bool(res_t["tb_crc_ok"][0]) and bool(res_j["tb_crc_ok"])
    np.testing.assert_array_equal(to_np(res_t["tb_bits"][0]), tb)
    np.testing.assert_array_equal(np.asarray(res_j["tb_bits"]), tb)


def test_llr_gate_helper_rejects():
    """The shared LLR gate fails on a 2-step difference and on 0.2 % of
    +-1 differences."""
    a = np.zeros(2000, np.int8)
    b = a.copy()
    b[0] = 2
    with pytest.raises(AssertionError):
        assert_llr_gate(a, b)
    b[0], b[1:4] = 1, 1
    with pytest.raises(AssertionError):
        assert_llr_gate(a, b)
