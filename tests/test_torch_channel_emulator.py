"""The port's TDL channel emulator against the JAX package's.

The two draw from different generators, so the draws are held by their
statistics (per-pair power, the frequency correlation the tap powers
give, the SINR of the noise); the deterministic parts are held against
the reference: the tap table and steering (exact), the symbol times
(exact), and on the JAX package's own draws the application of the
channel, the CFO rotation and the noise scaling (rtol 1e-5: float32
sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np

from srsran_project_tpu.phy import channel_emulator as jchem
from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
from srsran_project_tpu_torch.phy import channel_emulator as tchem
from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing as TScs


def _cfgs(**kw):
    jc = jchem.ChannelConfig(**kw)
    return jc, tchem.ChannelConfig.from_reference(jc)


def test_tables():
    assert tchem.PROFILES == jchem.PROFILES
    for profile in jchem.PROFILES:
        for scs in (JScs.KHZ15, JScs.KHZ30):
            for a, b in zip(tchem._tap_params(profile, 288, TScs(int(scs))),
                            jchem._tap_params(profile, 288, scs)):
                np.testing.assert_array_equal(a, b)
    for scs in (JScs.KHZ15, JScs.KHZ30, JScs.KHZ60):
        np.testing.assert_array_equal(tchem._symbol_times_s(TScs(int(scs)), 14),
                                      jchem._symbol_times_s(scs, 14))


def _grid(rng, ntx, nsc=288):
    return (rng.standard_normal((ntx, 14, nsc)) + 1j * rng.standard_normal((ntx, 14, nsc))
            ).astype(np.complex64) / np.sqrt(2)


@pytest.mark.parametrize("kw", [
    dict(profile="tdla", nof_tx_ports=2, nof_rx_ports=2, nof_sc=288),
    dict(profile="tdlc", nof_tx_ports=1, nof_rx_ports=2, nof_sc=288, cfo_hz=750.0,
         noise_convention="fixed"),
    dict(profile="tdlb", nof_tx_ports=2, nof_rx_ports=1, nof_sc=288, doppler_hz=100.0),
    dict(profile="single", nof_tx_ports=2, nof_rx_ports=2, nof_sc=288, cfo_hz=-300.0,
         doppler_hz=50.0),
], ids=["tdla", "tdlc-cfo-fixed", "tdlb-doppler", "single-cfo-doppler"])
def test_deterministic_parts_on_the_reference_draw(kw):
    """The JAX package's rx, h and noise variance from one key; with the
    same h and the same noise draw, the port's application, CFO rotation
    and noise scaling give the same rx and noise variance."""
    jc, tc = _cfgs(sinr_db=15.0, **kw)
    grid = _grid(np.random.default_rng(0), jc.nof_tx_ports)
    key = jax.random.PRNGKey(3)
    rx_j, h_j, nvar_j = (np.asarray(x) for x in jchem.apply_channel(jnp.asarray(grid), key, jc,
                                                                    slot_index=2))
    kh, kn = jax.random.split(key)
    draw = (jchem.draw_channel_doppler(kh, jc, 2) if jc.doppler_hz
            else jchem.draw_channel(kh, jc))
    np.testing.assert_array_equal(np.asarray(draw), h_j)
    noise = np.asarray(jax.random.normal(kn, rx_j.shape + (2,), dtype=jnp.float32))

    clean = tchem._apply_h(torch.from_numpy(grid), torch.from_numpy(h_j.copy()))
    if tc.cfo_hz:
        clean = clean * tchem._cfo_phases(tc, 14, clean.device)[None, :, None]
    nvar_t = float(tchem._noise_var(clean, tc))
    np.testing.assert_allclose(nvar_t, float(nvar_j), rtol=1e-5)
    rx_t = to_np(clean) + (noise[..., 0] + 1j * noise[..., 1]) * np.sqrt(nvar_t / 2)
    scale = np.abs(rx_j).max()
    assert np.abs(rx_t - rx_j).max() <= 1e-5 * scale


def test_steering_of_given_gains():
    """The port's tap sum (block and time-selective) against a float64
    oracle of the same gains."""
    jc, tc = _cfgs(profile="tdla", nof_tx_ports=2, nof_rx_ports=2, nof_sc=288)
    _, steer = jchem._tap_params("tdla", 288, JScs.KHZ30)
    rng = np.random.default_rng(1)
    g = (rng.standard_normal((2, 2, 12)) + 1j * rng.standard_normal((2, 2, 12))).astype(np.complex64)
    want = np.einsum("rtn,nk->rtk", g.astype(np.complex128), steer.astype(np.complex128))
    got = to_np(tchem._steer(torch.from_numpy(g), tc))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    g4 = (rng.standard_normal((2, 2, 12, 14)) + 1j * rng.standard_normal((2, 2, 12, 14))
          ).astype(np.complex64)
    want = np.einsum("rtns,nk->rtsk", g4.astype(np.complex128), steer.astype(np.complex128))
    got = to_np(tchem._steer(torch.from_numpy(g4), tc))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("profile", ["tdla", "tdlc"])
def test_draw_statistics(profile):
    """Over 3000 block-fading draws: unit power per (rx, tx) pair (1 / nrx
    under the "fixed" convention), and the frequency correlation at lags of
    1, 8 and 64 subcarriers equal to the profile's sum p_n exp(-j 2 pi d
    scs tau_n), within 0.05."""
    jc, tc = _cfgs(profile=profile, nof_tx_ports=2, nof_rx_ports=2, nof_sc=288)
    gen = torch.Generator().manual_seed(0)
    h = torch.stack([tchem.draw_channel(gen, tc) for _ in range(3000)]).numpy()
    assert abs(np.mean(np.abs(h) ** 2) - 1.0) < 0.05
    taps = jchem.PROFILES[profile]
    p = 10.0 ** (np.asarray([t[1] for t in taps]) / 10)
    p /= p.sum()
    tau = np.asarray([t[0] for t in taps]) * 1e-9
    for lag in (1, 8, 64):
        got = np.mean(h[..., lag:] * np.conj(h[..., :-lag]))
        want = np.sum(p * np.exp(-2j * np.pi * lag * 30e3 * tau))
        assert abs(got - want) < 0.05, (lag, got, want)
    _, tcf = _cfgs(profile=profile, nof_tx_ports=1, nof_rx_ports=4, nof_sc=288,
                   noise_convention="fixed")
    hf = torch.stack([tchem.draw_channel(gen, tcf) for _ in range(1000)]).numpy()
    assert abs(np.mean(np.abs(hf) ** 2) - 0.25) < 0.0125
    _, tcd = _cfgs(profile=profile, nof_tx_ports=1, nof_rx_ports=1, nof_sc=72, doppler_hz=300.0)
    hd = torch.stack([tchem.draw_channel_doppler(gen, tcd, 0) for _ in range(1000)]).numpy()
    assert abs(np.mean(np.abs(hd) ** 2) - 1.0) < 0.05


@pytest.mark.parametrize("convention, sinr_db", [("post_fading", 10.0), ("fixed", 20.0)])
def test_apply_channel_sinr(convention, sinr_db):
    """The noise the port adds sits at the configured SINR: against the
    faded signal's own power, or against the unit signal ("fixed")."""
    _, tc = _cfgs(profile="tdla", nof_tx_ports=2, nof_rx_ports=2, nof_sc=288, sinr_db=sinr_db,
                  noise_convention=convention, cfo_hz=500.0)
    grid = torch.from_numpy(_grid(np.random.default_rng(2), 2))
    gen = torch.Generator().manual_seed(5)
    rx, h, nvar = tchem.apply_channel(grid, gen, tc)
    assert rx.shape == (2, 14, 288) and h.shape == (2, 2, 288)
    clean = tchem._apply_h(grid, h) * tchem._cfo_phases(tc, 14, grid.device)[None, :, None]
    noise = (rx - clean).numpy()
    ref = 1.0 if convention == "fixed" else float((clean.abs() ** 2).mean())
    np.testing.assert_allclose(float(nvar), ref / 10 ** (sinr_db / 10), rtol=1e-6)
    measured = 10 * np.log10(ref / np.mean(np.abs(noise) ** 2))
    assert abs(measured - sinr_db) < 0.1, measured
    # The same generator state gives the same draw; another device raises.
    rx2 = tchem.apply_channel(grid, torch.Generator().manual_seed(5), tc)[0]
    np.testing.assert_array_equal(rx2.numpy(), rx.numpy())
    with pytest.raises(ValueError, match="generator"):
        tchem.apply_channel(grid.to("meta"), gen, tc)
