"""PT-RS and PRS (phy/ptrs_prs.py) against the JAX package, and the
repaired PRS time-of-arrival estimate.

Tolerances:
* ``generate_ptrs`` and ``generate_prs``: exact (the same Gold bits and
  float32 QPSK values);
* ``prs_toa_estimate`` with rb_start = 0: toa within 1e-3 samples, rsrp
  and peak_power within rtol 1e-4 (float32 IDFTs of two libraries; the
  port's index_add_ adds the colliding comb bins in another order);
* with rb_start > 0 the port reads the delay within 0.5 sample (as
  tests/test_positioning.py holds the reference at rb_start = 0), where
  the reference, whose pilots start at PRB 0, reads -474.4 samples on an
  undelayed grid (ROADMAP Q3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import to_np, to_torch

from srsran_project_tpu.phy import ptrs_prs as jpp
from srsran_project_tpu_torch.phy import ptrs_prs as tpp


@pytest.mark.parametrize("kw", [dict(rb_start=0, rb_count=24, symbols=(3, 5, 7, 9)),
                                dict(rb_start=5, rb_count=40, symbols=(4, 8, 12), k_ptrs=4,
                                     re_offset=3, scrambling_id=1007, n_scid=1,
                                     slot_in_frame=9, nof_grid_sc=52 * 12)])
def test_generate_ptrs(kw):
    jc = jpp.PtrsConfig(**kw)
    tc = tpp.PtrsConfig.from_reference(jc)
    np.testing.assert_array_equal(to_np(tpp.generate_ptrs(tc, device="cpu")),
                                  np.asarray(jpp.generate_ptrs(jc)))


PRS_CASES = [
    dict(rb_start=0, rb_count=24, start_symbol=2, nof_symbols=4, comb_size=4, n_id_prs=42),
    dict(rb_start=3, rb_count=48, start_symbol=0, nof_symbols=12, comb_size=4, comb_offset=1,
         n_id_prs=4095, slot_in_frame=19, nof_grid_sc=52 * 12),
    dict(rb_start=10, rb_count=24, start_symbol=1, nof_symbols=6, comb_size=6, comb_offset=5,
         n_id_prs=1023, slot_in_frame=7),
    dict(rb_start=1, rb_count=12, start_symbol=2, nof_symbols=2, comb_size=2, n_id_prs=3000),
    dict(rb_start=2, rb_count=36, start_symbol=0, nof_symbols=12, comb_size=12,
         n_id_prs=2048, slot_in_frame=3),
]


@pytest.mark.parametrize("kw", PRS_CASES,
                         ids=lambda kw: f"comb{kw['comb_size']}-rb{kw['rb_start']}")
def test_generate_prs(kw):
    jc = jpp.PrsConfig(**kw)
    tc = tpp.PrsConfig.from_reference(jc)
    for s in range(tc.nof_symbols):
        assert tpp._prs_c_init(tc, tc.start_symbol + s) == jpp._prs_c_init(jc, jc.start_symbol + s)
    np.testing.assert_array_equal(to_np(tpp.generate_prs(tc, device="cpu")),
                                  np.asarray(jpp.generate_prs(jc)))


def _delayed(grid: np.ndarray, delay: float, dft: int, seed: int, snr_db: float = 20.0):
    """A pure delay (linear phase over the subcarriers) plus AWGN, as
    tests/test_positioning.py makes its grids."""
    k = np.arange(grid.shape[1])
    rng = np.random.default_rng(seed)
    noise = (rng.standard_normal(grid.shape) + 1j * rng.standard_normal(grid.shape))
    noise *= np.sqrt(10 ** (-snr_db / 10) / 2)
    return (grid * np.exp(-2j * np.pi * k * delay / dft)[None] + noise).astype(np.complex64)


TOA_CFG = dict(rb_count=24, start_symbol=2, nof_symbols=4, comb_size=4, n_id_prs=42,
               nof_grid_sc=624)


@pytest.mark.parametrize("delay", [0.0, 3.0, 17.5, -4.0, 37.3])
def test_prs_toa_estimate_matches_reference(delay):
    """rb_start = 0, where both packages read the same pilots."""
    jc = jpp.PrsConfig(rb_start=0, **TOA_CFG)
    tc = tpp.PrsConfig.from_reference(jc)
    rx = _delayed(np.asarray(jpp.generate_prs(jc)), delay, 2048, seed=int(10 * abs(delay)))
    want = jpp.prs_toa_estimate(jnp.asarray(rx), jc, dft_size=2048)
    got = tpp.prs_toa_estimate(to_torch(rx), tc, dft_size=2048)
    assert abs(float(got["toa_samples"]) - float(want["toa_samples"])) <= 1e-3
    assert abs(float(got["toa_samples"]) - delay) < 0.5
    for k in ("rsrp", "peak_power"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4)


@pytest.mark.parametrize("delay", [0.0, 12.3, -6.5])
def test_prs_toa_estimate_off_point_a(delay):
    """rb_start = 10: the port advances its pilots as generate_prs does and
    reads the delay; the reference reads -474.4 samples with a peak power
    of 7 on the undelayed, noise-free grid."""
    jc = jpp.PrsConfig(rb_start=10, **TOA_CFG)
    tc = tpp.PrsConfig.from_reference(jc)
    grid = np.asarray(jpp.generate_prs(jc))
    np.testing.assert_array_equal(to_np(tpp.generate_prs(tc, device="cpu")), grid)
    got = tpp.prs_toa_estimate(to_torch(_delayed(grid, delay, 2048, seed=3)), tc, dft_size=2048)
    assert abs(float(got["toa_samples"]) - delay) < 0.5
    assert float(got["peak_power"]) > 100.0
    ref = jpp.prs_toa_estimate(jnp.asarray(grid), jc, dft_size=2048)
    assert abs(float(ref["toa_samples"]) + 474.4) < 0.1
    assert float(ref["peak_power"]) < 10.0
