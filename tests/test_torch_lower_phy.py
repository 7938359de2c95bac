"""The lower-PHY helpers (ops/lower_phy.py) against the JAX package: the
PRACH window geometry, the PRACH demodulator and the amplitude
controller.

Tolerances:
* ``prach_window_params``: equal, over every preamble format of the
  reference, the PUSCH SCS it supports, several slots, start symbols,
  time and frequency occasions;
* ``prach_demodulate``: within 1e-5 of the largest output magnitude
  (float32 FFTs of two libraries);
* ``amplitude_control``: samples within 1e-6 x the largest magnitude,
  power metrics within 1e-4 dB, the clipping share exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np, to_torch

from srsran_project_tpu.ops import lower_phy as jl
from srsran_project_tpu_torch.ops import lower_phy as tl
from srsran_project_tpu_torch.phy import prach as tp


def test_tables_equal():
    """One table of preamble formats, shared with phy/prach."""
    assert tl.PRACH_PREAMBLES == jl.PRACH_PREAMBLES
    assert tl.PRACH_DURATION_SYMBOLS == jl.PRACH_DURATION_SYMBOLS
    assert tl.PRACH_FREQ_MAPPING == jl.PRACH_FREQ_MAPPING
    assert tp.PRACH_PREAMBLES is tl.PRACH_PREAMBLES


@pytest.mark.parametrize("fmt", list(jl.PRACH_PREAMBLES))
def test_prach_window_params(fmt):
    long = fmt in ("0", "1", "2", "3")
    l_ra = 839 if long else 139
    for scs in (15000, 30000, 60000):
        ra = jl.PRACH_PREAMBLES[fmt][2] or scs
        if (int(ra), scs) not in jl.PRACH_FREQ_MAPPING:
            continue
        for srate in (30.72e6, 122.88e6):
            for slot, sym, td, fd, rb in ((0, 0, 0, 0, 0), (1, 2, 1, 1, 10), (3, 7, 0, 2, 48),
                                          (0, 0, 2, 0, 100)):
                args = (fmt, scs, slot, sym, td, srate, rb, fd, 273, l_ra)
                assert tl.prach_window_params(*args) == jl.prach_window_params(*args), args


@pytest.mark.parametrize("l_ra, dft, nsym, cp, k0", [(839, 24576, 1, 3168, 20000),
                                                     (139, 1024, 12, 88, 1000),
                                                     (139, 2048, 2, 160, 0)])
def test_prach_demodulate(l_ra, dft, nsym, cp, k0):
    rng = np.random.default_rng(l_ra + nsym)
    n = cp + nsym * dft + 37
    s = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    kw = dict(l_ra=l_ra, dft_size=dft, nof_symbols=nsym, cp_samples=cp, k_offset=k0)
    want = np.asarray(jl.prach_demodulate(jnp.asarray(s), **kw))
    got = to_np(tl.prach_demodulate(to_torch(s), **kw))
    assert got.shape == want.shape == (2, l_ra)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("gain_db, ceiling_db, clip", [(0.0, -0.1, True), (6.0, -3.0, True),
                                                       (6.0, -3.0, False), (-20.0, -0.1, True)])
def test_amplitude_control(gain_db, ceiling_db, clip):
    rng = np.random.default_rng(3)
    s = (0.5 * (rng.standard_normal(4096) + 1j * rng.standard_normal(4096))).astype(np.complex64)
    xj, mj = jl.amplitude_control(jnp.asarray(s), gain_db, 1.0, ceiling_db, enable_clipping=clip)
    xt, mt = tl.amplitude_control(to_torch(s), gain_db, 1.0, ceiling_db, enable_clipping=clip)
    xj = np.asarray(xj)
    assert xt.dtype == torch.complex64
    assert np.abs(to_np(xt) - xj).max() <= 1e-6 * np.abs(xj).max()
    for k in ("avg_power_dbfs", "peak_power_dbfs"):
        assert abs(float(mt[k]) - float(mj[k])) <= 1e-4
    assert float(mt["clipping_prob"]) == float(mj["clipping_prob"])
