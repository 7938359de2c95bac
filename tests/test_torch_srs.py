"""The port's SRS generator and estimator against the JAX package's: the
sequences and the generated grids exact; the estimates on the same
received grid within rtol 1e-4 of their largest value (h, noise_var,
epre) and 1e-5 rad (phase slope): float32 FFTs of two libraries round
differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np

from srsran_project_tpu.phy import srs as jsrs
from srsran_project_tpu_torch.phy import srs as tsrs

# (rb_start, rb_count, start_symbol, nof_symbols, comb, comb_offset,
# sequence_id, cyclic_shift, antenna ports, rx ports)
CASES = [
    (0, 16, 13, 1, 2, 0, 3, 0, 1, 1),      # one symbol: delay-domain noise
    (4, 24, 10, 2, 4, 1, 11, 5, 1, 2),     # two symbols: residual noise
    (2, 48, 8, 4, 2, 1, 29, 3, 1, 2),      # four symbols
    (0, 40, 12, 2, 2, 0, 7, 1, 2, 2),      # two ports: delay windows
    (6, 32, 12, 1, 4, 2, 20, 7, 4, 2),     # four ports, ports 1 and 3 on the other comb
]


def _cfgs(case):
    rb0, nrb, sym0, nsym, comb, off, sid, cs, nap, nrx = case
    jc = jsrs.SrsConfig(rb_start=rb0, rb_count=nrb, start_symbol=sym0, nof_symbols=nsym,
                        comb=comb, comb_offset=off, sequence_id=sid, cyclic_shift=cs,
                        nof_antenna_ports=nap, nof_rx_ports=nrx, nof_grid_sc=624)
    return jc, tsrs.SrsConfig.from_reference(jc)


@pytest.mark.parametrize("case", CASES, ids=[f"{c[8]}ap-{c[3]}sym-comb{c[4]}" for c in CASES])
def test_generate_and_estimate(case):
    jc, tc = _cfgs(case)
    for p in range(jc.nof_antenna_ports):
        np.testing.assert_array_equal(tsrs._sequence(tc, p), jsrs._sequence(jc, p))
        np.testing.assert_array_equal(tsrs._sc_indices(tc, p), jsrs._sc_indices(jc, p))
    sig_j = np.asarray(jsrs.generate(jc))
    sig_t = to_np(tsrs.generate(tc, device="cpu"))
    np.testing.assert_array_equal(sig_t, sig_j)

    rng = np.random.default_rng(sum(case))
    sig = sig_j[None] if sig_j.ndim == 2 else sig_j
    nrx = jc.nof_rx_ports
    # A frequency-selective channel per (rx, tx): a few delay taps.
    k = np.arange(624)
    h = sum((rng.standard_normal((nrx, sig.shape[0], 1)) + 1j * rng.standard_normal(
        (nrx, sig.shape[0], 1))) * 0.5 * np.exp(-2j * np.pi * k * d / 4096) for d in (0, 3, 7))
    grid = np.einsum("rtk,tsk->rsk", h, sig)
    grid = (grid + 0.05 * (rng.standard_normal(grid.shape) + 1j * rng.standard_normal(
        grid.shape))).astype(np.complex64)
    ej = {k_: np.asarray(v) for k_, v in jsrs.estimate(jnp.asarray(grid), jc).items()}
    et = {k_: to_np(v) for k_, v in tsrs.estimate(torch.from_numpy(grid), tc).items()}
    assert et.keys() == ej.keys()
    for key in ("h", "noise_var", "epre"):
        assert et[key].shape == ej[key].shape, key
        assert np.abs(et[key] - ej[key]).max() <= 1e-4 * np.abs(ej[key]).max(), key
    np.testing.assert_allclose(et["phase_slope"], ej["phase_slope"], atol=1e-5)
