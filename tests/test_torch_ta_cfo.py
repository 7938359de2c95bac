"""The uplink's TA and CFO measurements against the JAX package: the
estimator's metrics (``estimate_ta_samples``, ``channel_metrics``),
PUSCH with ``compute_ta`` and ``cfo_compensation`` through ``process``,
``process_multi`` and ``ul_slot.process_slot``, the two other SINR and
noise methods, and the OFDM demodulator's window offsets.

Each grant's received grid is the port's UE side (``pdsch.process`` of
the PdschConfig twin) through a random channel, delayed by a phase ramp
exp(-j 2 pi k df tau) over the subcarriers and rotated by its CFO at each
symbol's start (as ``phy.channel_emulator`` applies it), plus AWGN.

Tolerances:
* TA peak bins: equal; ta_s: rtol 1e-6 (the same bins over the same
  float32 divisor);
* the CFO metric: atol 1e-5 rad; the other metrics rtol 1e-4;
* TB bits and CRC: exact; int8 LLRs: +-1 and equal on >= 99.9 %
  (``assert_llr_gate``); noise_var: rtol 1e-4; snr_db: atol 1e-3;
* demodulated grids: 1e-5 x RMS (float32 FFTs of two libraries).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_llr_gate, grant_configs, to_np, to_torch, unit_channel

from srsran_project_tpu.ops import estimator as jest
from srsran_project_tpu.ops import ofdm as jofdm
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu.phy import ul_slot as jul
from srsran_project_tpu.ran.constants import CyclicPrefix as JCp
from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
from srsran_project_tpu_torch.models import cell as tcell
from srsran_project_tpu_torch.ops import estimator as test_
from srsran_project_tpu_torch.ops import ofdm as tofdm
from srsran_project_tpu_torch.phy import pdsch as tpdsch
from srsran_project_tpu_torch.phy import pusch as tpusch
from srsran_project_tpu_torch.phy import ul_slot as tul
from srsran_project_tpu_torch.phy.channel_emulator import _symbol_times_s
from srsran_project_tpu_torch.ran.constants import CyclicPrefix, SubcarrierSpacing

RNTI = 0x4601


def _impaired(rx: np.ndarray, delay_s: float, cfo_hz: float, rng, snr_db: float = 30.0,
              scs_hz: float = 30e3) -> np.ndarray:
    """(P, 14, nsc) grid delayed by delay_s, rotated by cfo_hz, plus AWGN."""
    k = np.arange(rx.shape[-1])
    rx = rx * np.exp(-2j * np.pi * k * scs_hz * delay_s)[None, None, :]
    t = _symbol_times_s(SubcarrierSpacing.KHZ30, rx.shape[1])
    rx = rx * np.exp(2j * np.pi * cfo_hz * t)[None, :, None]
    sigma = np.sqrt(0.5 * 10 ** (-snr_db / 10))
    return (rx + sigma * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
            ).astype(np.complex64)


def _ue(jtx, jrx, seed: int, delay_s: float, cfo_hz: float, snr_db: float = 30.0):
    """(TB, RNTI, received grid) of one grant from the port's UE side."""
    rng = np.random.default_rng(seed)
    ttx = tpdsch.PdschConfig.from_reference(jtx)
    tb = rng.integers(0, 2, size=(ttx.tbs,), dtype=np.uint8)
    w = unit_channel(rng, ttx.nof_layers, jrx.nof_rx_ports)
    rx = to_np(tpdsch.process(torch.from_numpy(tb), RNTI + seed, torch.from_numpy(w), ttx))
    return tb, RNTI + seed, _impaired(rx, delay_s, cfo_hz, rng, snr_db)


# ---- the estimator's metrics --------------------------------------------------

@pytest.mark.parametrize("delay", [0.0, 3.0, 17.5, -4.0, -60.25, 200.0])
def test_estimate_ta_samples(delay):
    """The delay-profile peak bin of a pure delay, positive and negative."""
    nf = 96
    h = np.exp(-2j * np.pi * np.arange(nf) * delay / 4096)[None].astype(np.complex64)
    want = np.asarray(jest.estimate_ta_samples(jnp.asarray(h)))
    got = to_np(test_.estimate_ta_samples(to_torch(h)))
    np.testing.assert_array_equal(got, want)
    assert abs(float(got[0]) - delay) <= 1.0


@pytest.mark.parametrize("nsym_d", [1, 2, 3])
def test_estimate_channel_metrics(nsym_d):
    """estimate_channel with compute_ta and compute_cfo: every metric
    against the reference's, per (layer, port); the CFO metric is 0 with
    one DM-RS symbol."""
    rng = np.random.default_rng(nsym_d)
    shape = (2, 3, nsym_d, 48)  # (layer, port, DM-RS symbol, pilot)
    ramp = np.exp(-2j * np.pi * np.arange(48) * 2 * 7.3 / 4096)
    rot = np.exp(0.21j * np.arange(nsym_d))[:, None]
    y = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 0.1
         + ramp * rot).astype(np.complex64)
    ref = np.exp(2j * np.pi * rng.random((nsym_d, 48))).astype(np.complex64)
    wf = np.tile([1.0, -1.0], 24).astype(np.float32)
    pos = tuple(float(1 + 4 * i) for i in range(24))
    hj, nvj, mj = jest.estimate_channel(jnp.asarray(y), jnp.asarray(ref), jnp.asarray(wf), pos,
                                        96, compute_ta=True, compute_cfo=True)
    ht, nvt, mt = test_.estimate_channel(to_torch(y), to_torch(ref), to_torch(wf), pos, 96,
                                         compute_ta=True, compute_cfo=True)
    hj = np.asarray(hj)
    assert np.abs(to_np(ht) - hj).max() <= 1e-4 * np.sqrt(np.mean(np.abs(hj) ** 2))
    np.testing.assert_allclose(to_np(nvt), np.asarray(nvj), rtol=1e-4)
    assert set(mt) == set(mj) == {"epre", "rsrp", "snr", "cfo_phase_per_dmrs_symbol",
                                  "ta_peak_bin_4096"}
    np.testing.assert_array_equal(to_np(mt["ta_peak_bin_4096"]),
                                  np.asarray(mj["ta_peak_bin_4096"]))
    np.testing.assert_allclose(to_np(mt["cfo_phase_per_dmrs_symbol"]),
                               np.asarray(mj["cfo_phase_per_dmrs_symbol"]), atol=1e-5)
    if nsym_d == 1:
        assert not to_np(mt["cfo_phase_per_dmrs_symbol"]).any()
    for k in ("epre", "rsrp", "snr"):
        np.testing.assert_allclose(to_np(mt[k]), np.asarray(mj[k]), rtol=1e-4)


# ---- PUSCH ------------------------------------------------------------------

# name -> the receiver's fields.
RX_KINDS = {
    "ta": dict(compute_ta=True),
    "cfo": dict(cfo_compensation=True),
    "cfo-ta": dict(cfo_compensation=True, compute_ta=True),
    "pair-residual": dict(noise_method="pair_residual"),
    "channel-estimator": dict(sinr_method="channel_estimator"),
    "cfo-ta-both": dict(cfo_compensation=True, compute_ta=True, noise_method="pair_residual",
                        sinr_method="channel_estimator"),
}
# Two DM-RS symbols (2, 11): the CFO estimate needs two.
GRANT = dict(nof_rb=24, layers=2, ports=2, modulation=4, rate=0.5, dmrs_symbols=(2, 11))


def _both(jrx):
    return jrx, tpusch.PuschConfig.from_reference(jrx)


def _grant(res: dict, i: int = 0) -> dict:
    """Grant i of a batched result dict (JAX or torch), as numpy."""
    return {k: (to_np(v[i]) if isinstance(v, torch.Tensor) else np.asarray(v)[i])
            for k, v in res.items() if k != "harq_buffer"}


def _check(rj: dict, rt: dict, tb, jrx):
    """One grant's results of both packages (``_grant``): CRC passed in
    both, the TB sent, noise_var, snr_db and ta_s within the stated
    tolerances."""
    assert bool(rj["tb_crc_ok"]) and bool(rt["tb_crc_ok"])
    np.testing.assert_array_equal(rt["tb_bits"], tb)
    np.testing.assert_array_equal(rj["tb_bits"], tb)
    np.testing.assert_allclose(rt["noise_var"], rj["noise_var"], rtol=1e-4)
    assert abs(float(rt["snr_db"]) - float(rj["snr_db"])) <= 1e-3
    assert ("ta_s" in rt) == ("ta_s" in rj) == jrx.compute_ta
    if jrx.compute_ta:
        np.testing.assert_allclose(rt["ta_s"], rj["ta_s"], rtol=1e-6)


@pytest.mark.parametrize("kind", list(RX_KINDS))
def test_process(kind):
    """pusch.process and its front end on a grant delayed by 0.4 us with a
    CFO of 400 Hz: the LLR gate, TB, CRC, noise, SINR and TA (within one
    bin of the delay) against the reference."""
    jtx, jrx0 = grant_configs(**GRANT)
    jrx, trx = _both(dataclasses.replace(jrx0, **RX_KINDS[kind]))
    cfo = 400.0 if jrx.cfo_compensation else 0.0
    tb, rnti, rx = _ue(jtx, jrx, 1, 0.4e-6, cfo)
    gj, gt = jnp.asarray(rx), torch.from_numpy(rx)[None]
    fe_j = jpusch._front_end(gj, jnp.uint32(rnti), jrx)
    fe_t = tpusch._front_end(gt, torch.tensor([rnti]), trx)
    assert len(fe_t) == len(fe_j) == (4 if jrx.compute_ta else 3)
    assert_llr_gate(np.asarray(fe_j[0]), to_np(fe_t[0][0]), kind)
    res_j = {k: np.asarray(v) for k, v in jpusch.process(gj, jnp.uint32(rnti), jrx).items()}
    res_t = _grant(tpusch.process(gt, torch.tensor([rnti]), trx))
    _check(res_j, res_t, tb, jrx)
    if jrx.compute_ta:
        assert abs(float(res_t["ta_s"]) - 0.4e-6) < 1.0 / (4096 * 120e3)


def test_cfo_compensation_is_needed():
    """Without compensation the 400 Hz CFO of a 64QAM grant fails its CRC
    in both packages; with it both pass: the check above shows the
    derotation at work."""
    jtx, jrx0 = grant_configs(**dict(GRANT, modulation=6, rate=0.7))
    tb, rnti, rx = _ue(jtx, jrx0, 2, 0.0, 400.0)
    for cfo in (False, True):
        jrx, trx = _both(dataclasses.replace(jrx0, cfo_compensation=cfo))
        ok_j = bool(jpusch.process(jnp.asarray(rx), jnp.uint32(rnti), jrx)["tb_crc_ok"])
        ok_t = bool(tpusch.process(torch.from_numpy(rx)[None], torch.tensor([rnti]),
                                   trx)["tb_crc_ok"][0])
        assert ok_j == ok_t == cfo


def test_single_dmrs_symbol_skips_cfo():
    """One DM-RS symbol: no CFO estimate, nothing derotated (both
    packages), and the TA still reported."""
    jtx, jrx0 = grant_configs(nof_rb=12, ports=2, modulation=2)
    jrx, trx = _both(dataclasses.replace(jrx0, cfo_compensation=True, compute_ta=True))
    tb, rnti, rx = _ue(jtx, jrx, 3, -0.2e-6, 0.0)
    res_j = {k: np.asarray(v) for k, v in jpusch.process(jnp.asarray(rx), jnp.uint32(rnti),
                                                         jrx).items()}
    res_t = _grant(tpusch.process(torch.from_numpy(rx)[None], torch.tensor([rnti]), trx))
    _check(res_j, res_t, tb, jrx)
    assert abs(float(res_t["ta_s"]) + 0.2e-6) < 1.0 / (4096 * 120e3)


def test_process_multi_keeps_each_grants_ta_and_cfo():
    """process_multi over three equal-config grants, each with its own
    delay and CFO: per-grant TA and results equal to the reference's (no
    average over the batch)."""
    delays, cfos = (0.4e-6, -0.2e-6, 1.1e-6), (400.0, -250.0, 0.0)
    first_rbs = (0, 8, 16)
    jtx, jrx0 = grant_configs(nof_rb=8, ports=2, modulation=4, rate=0.5, dmrs_symbols=(2, 11))
    jrx, trx = _both(dataclasses.replace(jrx0, cfo_compensation=True, compute_ta=True))
    grid = np.zeros((2, 14, 24 * 12), np.complex64)
    tbs, rntis = [], []
    for i, rb0 in enumerate(first_rbs):
        tx_i = dataclasses.replace(jtx, alloc=dataclasses.replace(jtx.alloc, crb_start=rb0))
        tb, rnti, rx = _ue(tx_i, jrx, 10 + i, delays[i], cfos[i])
        grid[:, :, 12 * rb0 : 12 * rb0 + rx.shape[-1]] += rx
        tbs.append(tb)
        rntis.append(rnti)
    res_j = jpusch.process_multi(jnp.asarray(grid), np.asarray(rntis, np.uint32), first_rbs, jrx)
    res_t = tpusch.process_multi(torch.from_numpy(grid), rntis, first_rbs, trx)
    for i, tb in enumerate(tbs):
        _check(_grant(res_j, i), _grant(res_t, i), tb, jrx)
        assert abs(float(res_t["ta_s"][i]) - delays[i]) < 1.0 / (4096 * 120e3)


def test_process_slot_reports_each_grants_ta():
    """ul_slot.process_slot with two config groups (cfo + TA, and the
    default receiver): per-grant ta_s only where asked, equal to the
    reference's, and every CRC passes."""
    jtx, jrx0 = grant_configs(nof_rb=8, ports=2, modulation=4, rate=0.5, dmrs_symbols=(2, 11))
    measured = dataclasses.replace(jrx0, cfo_compensation=True, compute_ta=True)
    plan = [(0, measured, 0.3e-6, 300.0), (8, measured, -0.5e-6, -150.0), (16, jrx0, 0.0, 0.0)]
    grid = np.zeros((2, 14, 24 * 12), np.complex64)
    jpdus, tpdus, tbs = [], [], []
    for i, (rb0, jr, delay, cfo) in enumerate(plan):
        tx_i = dataclasses.replace(jtx, alloc=dataclasses.replace(jtx.alloc, crb_start=rb0))
        tb, rnti, rx = _ue(tx_i, jr, 20 + i, delay, cfo)
        grid[:, :, 12 * rb0 : 12 * rb0 + rx.shape[-1]] += rx
        jc = dataclasses.replace(jr, alloc=dataclasses.replace(jr.alloc, crb_start=rb0))
        jpdus.append(jul.UlSlotPdu(rnti=rnti, first_rb=rb0, config=jc))
        tpdus.append(tul.UlSlotPdu.from_reference(jpdus[-1], device="cpu"))
        tbs.append(tb)
    out_j = jul.process_slot(jnp.asarray(grid), jpdus)[0]
    out_t = tul.process_slot(torch.from_numpy(grid), tpdus)[0]
    for (rb0, jr, delay, _cfo), rj, rt, tb in zip(plan, out_j, out_t, tbs):
        rj = {k: np.asarray(v) for k, v in rj.items()}
        rt = {k: to_np(v) for k, v in rt.items()}
        _check(rj, rt, tb, jr)
        if jr.compute_ta:
            assert abs(float(rt["ta_s"]) - delay) < 1.0 / (4096 * 120e3)


def test_ptrs_with_cfo_compensation():
    """PT-RS with CFO compensation: the port tracks the common phase on
    the derotated grid and keeps the derotation, so the grant decodes
    under a 400 Hz CFO and a random phase per symbol.  The reference
    applies its common phase to the grid as it was before the CFO
    derotation, which undoes the derotation: its CRC fails (ROADMAP Q3)."""
    common = dict(nof_rb=12, layers=1, ports=2, modulation=6, rate=0.6, dmrs_symbols=(2, 11),
                  ptrs_enabled=True, ptrs_k=2)
    jtx, jrx0 = grant_configs(**common)
    jrx, trx = _both(dataclasses.replace(jrx0, cfo_compensation=True))
    rng = np.random.default_rng(5)
    ttx = tpdsch.PdschConfig.from_reference(jtx)
    tb = rng.integers(0, 2, size=(ttx.tbs,), dtype=np.uint8)
    rx = to_np(tpdsch.process(torch.from_numpy(tb), RNTI, torch.from_numpy(
        unit_channel(rng, 1, 2)), ttx))
    ph = rng.uniform(-0.3, 0.3, 14)
    ph[[2, 11]] = 0.0
    rx = _impaired(rx * np.exp(1j * ph)[None, :, None], 0.0, 400.0, rng)
    res = tpusch.process(torch.from_numpy(rx)[None], torch.tensor([RNTI]), trx)
    assert bool(res["tb_crc_ok"][0])
    np.testing.assert_array_equal(to_np(res["tb_bits"][0]), tb)
    assert not bool(jpusch.process(jnp.asarray(rx), jnp.uint32(RNTI), jrx)["tb_crc_ok"])


def test_plane_path_closed_to_cfo_compensation():
    """The plane path (K4 + K1 planes) takes no CFO compensation, as in
    the reference; the cell's float path does."""
    cfg = tcell.CellConfig(nof_rb=24, demapper="planes")
    assert tpusch._demap_planes_ok(cfg.pusch_cfg)
    assert not tpusch._demap_planes_ok(tcell.CellConfig(nof_rb=24, demapper="planes",
                                                        cfo_compensation=True).pusch_cfg)


# ---- the OFDM demodulator's window offsets ------------------------------------

@pytest.mark.parametrize("offset, samples", [(0.5, None), (0.25, None), (0.0, 8), (0.0, 30)])
def test_demodulate_window_offset(offset, samples):
    """demodulate_slot with the DFT window inside the CP: the grid equal to
    the reference's, and, on a modulated slot, equal to the grid without
    the offset (the phase ramp undoes the advance)."""
    rng = np.random.default_rng(7)
    nof_rb, dft = 24, 512
    grid = (rng.standard_normal((2, 14, nof_rb * 12))
            + 1j * rng.standard_normal((2, 14, nof_rb * 12))).astype(np.complex64)
    iq = to_np(tofdm.modulate_slot(torch.from_numpy(grid), SubcarrierSpacing.KHZ30, dft,
                                   CyclicPrefix.NORMAL, 1))
    kw = dict(window_offset=offset, window_offset_samples=samples)
    want = np.asarray(jofdm.demodulate_slot(jnp.asarray(iq), nof_rb, JScs.KHZ30, dft, JCp.NORMAL,
                                            1, **kw))
    got = to_np(tofdm.demodulate_slot(torch.from_numpy(iq), nof_rb, SubcarrierSpacing.KHZ30, dft,
                                      CyclicPrefix.NORMAL, 1, **kw))
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    assert np.abs(got - want).max() <= 1e-5 * rms
    assert np.abs(got - grid).max() <= 1e-5 * rms


def test_fd_occ_despreading_under_delay():
    """A known limit of the fast estimator, in both packages alike: the
    FD-OCC despreading of a CDM pair assumes one channel on its two
    pilots, so under a bulk delay the co-CDM layer leaks into the
    estimate.  A 4-layer 256QAM grant at 30 dB loses some 5 dB of SINR at
    0.4 us and fails its CRC, where one layer loses almost nothing
    (ROADMAP Q3)."""
    snr = {}
    for layers in (1, 4):
        jtx, jrx = grant_configs(nof_rb=24, layers=layers, ports=4, modulation=8, rate=0.69,
                                 dmrs_symbols=(2, 11), sym_start=1, sym_count=13)
        trx = tpusch.PuschConfig.from_reference(jrx)
        for delay in (0.0, 0.4e-6):
            tb, rnti, rx = _ue(jtx, jrx, 1, delay, 0.0)
            rj = jpusch.process(jnp.asarray(rx), jnp.uint32(rnti), jrx)
            rt = tpusch.process(torch.from_numpy(rx)[None], torch.tensor([rnti]), trx)
            assert bool(rj["tb_crc_ok"]) == bool(rt["tb_crc_ok"][0])
            assert abs(float(rj["snr_db"]) - float(rt["snr_db"][0])) <= 1e-3
            snr[layers, delay] = (float(rt["snr_db"][0]), bool(rt["tb_crc_ok"][0]))
    assert snr[1, 0.0][1] and snr[1, 0.4e-6][1] and snr[4, 0.0][1]
    assert snr[1, 0.0][0] - snr[1, 0.4e-6][0] < 0.5
    assert snr[4, 0.0][0] - snr[4, 0.4e-6][0] > 4.0 and not snr[4, 0.4e-6][1]
