"""PUSCH with UCI, at ranks 2 and 3, MMSE and ZF (phy/pusch.py), and the
estimator's noise and metrics (ops/estimator.py), against the JAX package
on a 24-PRB carrier with 4 RX ports at 30 dB:

* R2: rank 2, 64QAM, 8 PRB, MMSE, 2 HARQ-ACK bits (reserved, punctured),
  CSI part 1 of 19 bits (polar + CRC6 + PC bits), CSI part 2 of 40 bits;
  two grants of it at PRB 0 and 16 (process_multi);
* R3: rank 3 (two CDM groups, an odd layer in the second), 16QAM, 8 PRB,
  ZF, 5 HARQ-ACK bits (rate-matched) and CSI part 1 of 24 bits.

The grid is the port's ``transmit`` (with UCI) through random orthonormal
4-port channels plus numpy AWGN.

Tolerances:
* transmitted grids: 1e-5 x RMS; channel estimates: 1e-4 x RMS; noise_var
  and the estimator's snr: rtol 1e-4; snr_db atol 1e-3;
* int8 LLRs: within +-1 and equal on >= 99.9 % of positions (ROADMAP Q3);
* TB bits, CRC, UCI bits and _ok flags: exact (and the sent ones);
* HARQ buffers: within +-1 per transmission that went into them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np, to_torch

from srsran_project_tpu.models import cell as jcell
from srsran_project_tpu.ops import estimator as jest
from srsran_project_tpu.ops.modulation import Modulation as JModulation
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu.phy import sch as jsch
from srsran_project_tpu_torch.ops import estimator as test_
from srsran_project_tpu_torch.phy import pusch as tpusch
from srsran_project_tpu_torch.phy import sch as tsch

NOF_PRB = 24
PORTS = 4
SNR_DB = 30.0
# name -> (layers, qm, rate, equalizer, (ACK, CSI-1, CSI-2 bits))
SHAPES = {"R2": (2, 6, 567 / 1024, "mmse", (2, 19, 40)),
          "R3": (3, 4, 490 / 1024, "zf", (5, 24, 0))}
# (name, rnti, first_rb)
GRANTS = [("R2", 0x4701, 0), ("R3", 0x4702, 8), ("R2", 0x4703, 16)]


def jconfig(name, first_rb=0, rv=0):
    layers, qm, rate, eq, uci = SHAPES[name]
    pc = jcell.CellConfig(nof_rb=8, nof_ports=PORTS, nof_layers=layers,
                          modulation=JModulation(qm), target_code_rate=rate).pusch_cfg
    return dataclasses.replace(pc, alloc=dataclasses.replace(pc.alloc, crb_start=first_rb), rv=rv,
                               equalizer=eq, uci=jpusch.UciOnPuschConfig(*uci))


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.abs(x) ** 2)))


def _payloads(rng, cfg):
    return [rng.integers(0, 2, size=(n,), dtype=np.uint8) if n else None
            for n in (cfg.uci.nof_harq_ack_bits, cfg.uci.nof_csi1_bits, cfg.uci.nof_csi2_bits)]


def _transmit(cfg, tb, rnti, parts, w):
    return tpusch.transmit(to_torch(tb), torch.tensor(rnti), cfg,
                           *[None if p is None else to_torch(p) for p in parts],
                           precoding=to_torch(w))


def _channel(rng, layers, scale=1.0):
    h = rng.standard_normal((PORTS, layers)) + 1j * rng.standard_normal((PORTS, layers))
    return (np.linalg.qr(h)[0].T * scale).astype(np.complex64)  # (layers, ports)


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(7)
    grid = torch.zeros((PORTS, 14, NOF_PRB * 12), dtype=torch.complex64)
    ues = []
    for name, rnti, rb0 in GRANTS:
        jcfg = jconfig(name, rb0)
        tcfg = tpusch.PuschConfig.from_reference(jcfg)
        tb = rng.integers(0, 2, size=(tcfg.tbs,), dtype=np.uint8)
        parts = _payloads(rng, tcfg)
        w = _channel(rng, tcfg.nof_layers)
        sub = _transmit(tcfg, tb, rnti, parts, w)
        grid[:, :, rb0 * 12 : rb0 * 12 + tcfg.nof_grid_sc] += sub
        ues.append(dict(name=name, rnti=rnti, rb0=rb0, jcfg=jcfg, tcfg=tcfg, tb=tb, parts=parts,
                        w=w, sub=to_np(sub)))
    sigma = np.sqrt(0.5 * 10 ** (-SNR_DB / 10))
    noise = (rng.standard_normal(grid.shape) + 1j * rng.standard_normal(grid.shape)) * sigma
    grid = grid + torch.from_numpy(noise.astype(np.complex64))
    grid_j = jnp.asarray(to_np(grid))

    out = dict(ues=ues, grid=grid, single={})
    for u in ues[:2]:
        cfg_j, cfg_t = u["jcfg"], u["tcfg"]
        win = slice(u["rb0"] * 12, u["rb0"] * 12 + cfg_t.nof_grid_sc)
        _, h_j, nv_j, _ = jpusch._estimate_stage(grid_j[:, :, win], cfg_j)
        llr_j = jpusch._front_end(grid_j[:, :, win], jnp.uint32(u["rnti"]), cfg_j)[0]
        res_j = jpusch.process(grid_j[:, :, win], jnp.uint32(u["rnti"]), cfg_j)
        gt = grid[None, :, :, win]
        _, h_t, nv_t = tpusch._estimate_stage(gt, cfg_t)
        llr_t = tpusch._front_end(gt, torch.tensor([u["rnti"]]), cfg_t)[0]
        res_t = tpusch.process(gt, torch.tensor([u["rnti"]]), cfg_t)
        out["single"][u["name"]] = dict(
            h=(np.asarray(h_j), to_np(h_t[0])), nv=(float(nv_j), float(nv_t[0])),
            llr=(np.asarray(llr_j), to_np(llr_t[0])),
            res=({k: np.asarray(v) for k, v in res_j.items()},
                 {k: to_np(v[0]) for k, v in res_t.items()}))
    multi = [ues[0], ues[2]]
    rntis, rbs = [u["rnti"] for u in multi], [u["rb0"] for u in multi]
    res_j = jpusch.process_multi(grid_j, jnp.asarray(rntis, jnp.uint32), rbs, ues[0]["jcfg"])
    res_t = tpusch.process_multi(grid, rntis, rbs, ues[0]["tcfg"])
    out["multi"] = ({k: np.asarray(v) for k, v in res_j.items()},
                    {k: to_np(v) for k, v in res_t.items()})
    return out


def _check_uci(res, parts, index=None):
    for part, name in zip(parts, ("harq_ack", "csi1", "csi2")):
        if part is None:
            assert f"{name}_bits" not in res
            continue
        ok, bits = res[f"{name}_ok"], res[f"{name}_bits"]
        if index is not None:
            ok, bits = ok[index], bits[index]
        assert bool(ok), name
        np.testing.assert_array_equal(bits, part)


def test_config_twin_and_mux_sizes(run):
    for u in run["ues"]:
        jc, tc = u["jcfg"], u["tcfg"]
        assert dataclasses.asdict(tc.uci) == dataclasses.asdict(jc.uci)
        jm, tm = jc.uci_mux, tc.uci_mux
        for f in ("qm", "nof_layers", "g_ack", "g_csi1", "g_csi2", "nof_ack_bits", "g_ack_rvd"):
            assert getattr(tm, f) == getattr(jm, f), f
        assert (tm.g_total, tm.nof_data_bits) == (jm.g_total, jm.nof_data_bits)
        assert tc.sch.nof_total_bits == jc.sch.nof_total_bits == tm.nof_data_bits
        assert (tc.sch.cb_e_bits, tc.sch.n_cb) == (jc.sch.cb_e_bits, jc.sch.n_cb)
        assert tsch._fused_decode_ok(tc.sch) == jsch._fused_decode_ok(jc.sch)
        assert not tpusch._demap_planes_ok(dataclasses.replace(tc, demapper="planes"))
    assert run["ues"][0]["tcfg"].uci_mux.ack_punctures
    assert not run["ues"][1]["tcfg"].uci_mux.ack_punctures


def test_transmit_with_uci_matches_reference(run):
    for u in run["ues"][:2]:
        parts = [None if p is None else jnp.asarray(p) for p in u["parts"]]
        want = np.asarray(jpusch.transmit(jnp.asarray(u["tb"]), jnp.uint32(u["rnti"]), u["jcfg"],
                                          *parts, precoding=jnp.asarray(u["w"])))
        assert u["sub"].shape == want.shape
        assert np.abs(u["sub"] - want).max() <= 1e-5 * _rms(want)


@pytest.mark.parametrize("name", ["R2", "R3"])
def test_rank_2_and_3_front_end(run, name):
    """Channel estimate (both CDM groups at rank 3), second-difference
    noise and the int8 LLRs (MMSE at rank 2, ZF at rank 3)."""
    s = run["single"][name]
    (h_j, h_t), (nv_j, nv_t), (llr_j, llr_t) = s["h"], s["nv"], s["llr"]
    layers = SHAPES[name][0]
    assert h_t.shape == h_j.shape == (PORTS, 8 * 12, layers)
    assert np.abs(h_t - h_j).max() <= 1e-4 * _rms(h_j)
    np.testing.assert_allclose(nv_t, nv_j, rtol=1e-4)
    d = np.abs(llr_t.astype(np.int32) - llr_j.astype(np.int32))
    assert llr_t.shape == llr_j.shape and d.max() <= 1 and (d == 0).mean() >= 0.999


@pytest.mark.parametrize("name", ["R2", "R3"])
def test_process_with_uci(run, name):
    res_j, res_t = run["single"][name]["res"]
    u = next(u for u in run["ues"] if u["name"] == name)
    assert set(res_t) == set(res_j)
    assert bool(res_t["tb_crc_ok"]) and bool(res_j["tb_crc_ok"])
    np.testing.assert_array_equal(res_t["tb_bits"], u["tb"])
    np.testing.assert_array_equal(res_t["tb_bits"], res_j["tb_bits"])
    _check_uci(res_t, u["parts"])
    _check_uci(res_j, u["parts"])
    np.testing.assert_allclose(res_t["noise_var"], res_j["noise_var"], rtol=1e-4)
    np.testing.assert_allclose(res_t["snr_db"], res_j["snr_db"], atol=1e-3)


def test_process_multi_with_uci(run):
    res_j, res_t = run["multi"]
    assert set(res_t) == set(res_j)
    np.testing.assert_array_equal(res_t["tb_crc_ok"], [True, True])
    np.testing.assert_array_equal(res_t["tb_bits"], res_j["tb_bits"])
    for k, u in enumerate((run["ues"][0], run["ues"][2])):
        np.testing.assert_array_equal(res_t["tb_bits"][k], u["tb"])
        _check_uci(res_t, u["parts"], index=k)
        for key in ("harq_ack", "csi1", "csi2"):
            np.testing.assert_array_equal(res_t[f"{key}_bits"], res_j[f"{key}_bits"])
            np.testing.assert_array_equal(res_t[f"{key}_ok"], res_j[f"{key}_ok"])
    d = np.abs(res_t["harq_buffer"].astype(np.int32) - res_j["harq_buffer"].astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999


def test_two_bit_ack_retransmission_with_harq_buffer():
    """R2 (2-bit ACK punctures the data REs) attenuated so that rv 0 fails
    its CRC; rv 2 with the rv 0 buffer passes.  The punctured positions
    enter each combine as zeros, in both packages: the buffers agree within
    +-1 per transmission, and the ACK decodes on both passes."""
    rng = np.random.default_rng(11)
    rnti = 0x4711
    tb, w = None, None
    harq_j = harq_t = None
    for p, rv in enumerate((0, 2)):
        jcfg = jconfig("R2", 0, rv)
        tcfg = tpusch.PuschConfig.from_reference(jcfg)
        if tb is None:
            tb = rng.integers(0, 2, size=(tcfg.tbs,), dtype=np.uint8)
            parts = _payloads(rng, tcfg)
            w = _channel(rng, 2, scale=10 ** (-17.0 / 20))
        sub = _transmit(tcfg, tb, rnti, parts, w)
        sigma = np.sqrt(0.5 * 10 ** (-SNR_DB / 10))
        noise = (rng.standard_normal(sub.shape) + 1j * rng.standard_normal(sub.shape)) * sigma
        rx = sub + torch.from_numpy(noise.astype(np.complex64))
        want = jpusch.process(jnp.asarray(to_np(rx)), jnp.uint32(rnti), jcfg, harq_j)
        got = tpusch.process(rx[None], torch.tensor([rnti]), tcfg, harq_t)
        harq_j, harq_t = want["harq_buffer"], got["harq_buffer"]
        assert bool(got["tb_crc_ok"][0]) == bool(want["tb_crc_ok"]) == (rv == 2), p
        d = np.abs(to_np(harq_t[0]).astype(np.int32) - np.asarray(harq_j).astype(np.int32))
        assert d.max() <= p + 1 and (d == 0).mean() >= 0.999
        for key in ("harq_ack", "csi1", "csi2"):
            np.testing.assert_array_equal(to_np(got[f"{key}_bits"][0]),
                                          np.asarray(want[f"{key}_bits"]))
            assert bool(got[f"{key}_ok"][0]) == bool(want[f"{key}_ok"])
        np.testing.assert_array_equal(to_np(got["harq_ack_bits"][0]), parts[0])
    np.testing.assert_array_equal(to_np(got["tb_bits"][0]), tb)


@pytest.mark.parametrize("smooth", [True, False])
def test_estimator_noise_and_metrics(smooth):
    """estimate_channel: h, the pilot-residual noise_var and epre / rsrp /
    snr against the reference's, per (layer, port) on a 2-symbol DM-RS, and
    the TA and CFO metrics when asked for."""
    rng = np.random.default_rng(4)
    shape = (2, 3, 2, 48)  # (layer, port, DM-RS symbol, pilot)
    y = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 0.3
         + np.exp(0.05j * np.arange(48))).astype(np.complex64)
    ref = np.exp(2j * np.pi * rng.random((2, 48))).astype(np.complex64)
    wf = np.tile([1.0, -1.0], 24).astype(np.float32)
    pos = tuple(float(1 + 4 * i) for i in range(24))
    hj, nvj, mj = jest.estimate_channel(jnp.asarray(y), jnp.asarray(ref), jnp.asarray(wf), pos, 96,
                                        smooth=smooth)
    ht, nvt, mt = test_.estimate_channel(to_torch(y), to_torch(ref), to_torch(wf), pos, 96,
                                         smooth=smooth)
    assert np.abs(to_np(ht) - np.asarray(hj)).max() <= 1e-4 * _rms(np.asarray(hj))
    np.testing.assert_allclose(to_np(nvt), np.asarray(nvj), rtol=1e-4)
    assert set(mt) == set(mj) == {"epre", "rsrp", "snr"}
    for k in mt:
        np.testing.assert_allclose(to_np(mt[k]), np.asarray(mj[k]), rtol=1e-4)
    # With the TA and CFO metrics: the same TA bins, the CFO within 1e-5 rad.
    _, _, mj = jest.estimate_channel(jnp.asarray(y), jnp.asarray(ref), jnp.asarray(wf), pos, 96,
                                     smooth=smooth, compute_ta=True, compute_cfo=True)
    _, _, mt = test_.estimate_channel(to_torch(y), to_torch(ref), to_torch(wf), pos, 96,
                                      smooth=smooth, compute_ta=True, compute_cfo=True)
    np.testing.assert_array_equal(to_np(mt["ta_peak_bin_4096"]), np.asarray(mj["ta_peak_bin_4096"]))
    np.testing.assert_allclose(to_np(mt["cfo_phase_per_dmrs_symbol"]),
                               np.asarray(mj["cfo_phase_per_dmrs_symbol"]), atol=1e-5)


def test_two_step_csi_raises():
    """process_multi sends a two-step CSI grant away with ValueError, as
    the reference does (its part-2 size follows the decoded RI)."""
    from srsran_project_tpu.ran import csi as jcsi

    jcfg = dataclasses.replace(jconfig("R2"), uci=jpusch.UciOnPuschConfig(
        2, 6, 5, csi_report_cfg=jcsi.CsiReportConfig(nof_csi_rs_ports=4)))
    tcfg = tpusch.PuschConfig.from_reference(jcfg)
    with pytest.raises(ValueError, match="two-step CSI"):
        tpusch.process_multi(torch.zeros((PORTS, 14, 96), dtype=torch.complex64), [1], [0], tcfg)
