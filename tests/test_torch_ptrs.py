"""PT-RS on PxSCH (ROADMAP Q1.8.4) against the JAX package:

* ``pdsch.ptrs_layout`` and ``pusch._ptrs_bit_positions``: equal;
* the PT-RS REs on the transmitted grid: equal within 1e-6 x RMS;
* the common phase error per symbol (``pusch.cpe_phases``): within 1e-5
  rad of the phase the reference derotates by;
* ``pusch.process`` on PT-RS grants under a per-symbol phase error: int8
  LLRs +-1 and >= 99.9 % equal, TB bits and CRC exact;
* CPE recovery under phase noise (mirrors tests/test_ptrs_on_pxsch.py):
  with PT-RS the port decodes, without it the same phase noise breaks
  16QAM;
* ``ul_slot.process_slot`` with two PT-RS grants at different PRBs beside
  UCI and plain grants (mirrors tests/test_ul_slot.py::
  test_hetero_slot_folds_uci_on_pusch_and_ptrs): TB bits, CRC and UCI bits
  exact, snr_db within 1e-3 of the reference's slot and of the port's own
  per-PDU decode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import grant_configs, loopback, process_parity, to_np, to_torch

from srsran_project_tpu.ops.modulation import Modulation
from srsran_project_tpu.phy import pdsch as jpdsch
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu.phy import ul_slot as jul
from srsran_project_tpu.phy.allocation import Allocation
from srsran_project_tpu_torch.phy import pdsch as tpdsch
from srsran_project_tpu_torch.phy import pusch as tpusch
from srsran_project_tpu_torch.phy import ul_slot as tul

# name -> grant_configs arguments of a PT-RS grant.
GRANTS = {
    "1x1-16qam": dict(ports=1, ptrs_enabled=True),
    # chip_smoke path 5a's shape at 12 PRB: 4 layers 256QAM, K = 2.
    "4x4-256qam": dict(layers=4, ports=4, modulation=8, rate=0.7, sym_start=1, sym_count=13,
                       ptrs_enabled=True, ptrs_k=2),
    "2x2-k4-offset": dict(layers=2, ports=2, rb_start=2, crb_start=5, dmrs_symbols=(2, 11),
                          ptrs_enabled=True, ptrs_k=4, ptrs_re_offset=2, ptrs_k_rb_ref=1),
}


@pytest.mark.parametrize("name", list(GRANTS))
def test_layout_and_erasure_positions(name):
    jtx, jrx = grant_configs(**GRANTS[name])
    for a, b in zip(tpdsch.ptrs_layout(tpdsch.PdschConfig.from_reference(jtx)),
                    jpdsch.ptrs_layout(jtx)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    pos_t = tpusch._ptrs_bit_positions(tpusch.PuschConfig.from_reference(jrx))
    np.testing.assert_array_equal(pos_t, jpusch._ptrs_bit_positions(jrx))
    assert len(pos_t) and len(np.unique(pos_t)) == len(pos_t)


@pytest.mark.parametrize("name", list(GRANTS))
def test_grid_and_cpe(name):
    """The transmitted grid (PT-RS REs included), then the phase error the
    receiver estimates per symbol on it, under a random phase per symbol."""
    jtx, jrx = grant_configs(**GRANTS[name])
    ttx = tpdsch.PdschConfig.from_reference(jtx)
    rng = np.random.default_rng(3)
    tb = rng.integers(0, 2, size=(ttx.tbs,), dtype=np.uint8)
    w = np.eye(ttx.nof_layers, dtype=np.complex64)
    g_j = np.asarray(jpdsch.process(jnp.asarray(tb), jnp.uint32(0x4601), jnp.asarray(w), jtx))
    g_t = to_np(tpdsch.process(to_torch(tb), 0x4601, to_torch(w), ttx))
    rms = float(np.sqrt(np.mean(np.abs(g_j) ** 2)))
    assert np.abs(g_t - g_j).max() <= 1e-6 * rms
    idx, vals, _ = tpdsch.ptrs_layout(ttx)
    np.testing.assert_allclose(g_t[0].reshape(-1)[idx], vals, atol=1e-6)

    tb, rnti, rx = loopback(jtx, jrx, seed=4, snr_db=30.0, phase_noise=1.2)
    trx = tpusch.PuschConfig.from_reference(jrx)
    gflat_j = np.asarray(jpusch._estimate_stage(jnp.asarray(rx), jrx)[0])
    _, h_t, _ = tpusch._estimate_stage(to_torch(rx)[None], trx)
    phase_t = to_np(tpusch.cpe_phases(to_torch(rx).reshape(1, jrx.nof_rx_ports, -1), h_t, trx))[0]
    # The reference derotates symbol s by conj(phase): grid / its output.
    g = rx.reshape(jrx.nof_rx_ports, 14, -1)
    k = np.argmax(np.abs(g[0]), axis=-1)  # the strongest RE of each symbol
    rot = g[0, np.arange(14), k] / gflat_j.reshape(jrx.nof_rx_ports, 14, -1)[0, np.arange(14), k]
    d = np.angle(phase_t * np.conj(rot))
    assert np.abs(d).max() <= 1e-5, np.abs(d).max()
    a = jrx.alloc
    plain = [s for s in range(14) if not a.sym_start <= s < a.sym_start + a.sym_count
             or s in a.dmrs_symbols]
    np.testing.assert_array_equal(phase_t[plain], 1.0)


@pytest.mark.parametrize("name", list(GRANTS))
def test_process(name):
    jtx, jrx = grant_configs(**GRANTS[name])
    tb, rnti, rx = loopback(jtx, jrx, seed=5, snr_db=33.0, phase_noise=1.0)
    process_parity(jrx, rx, rnti, tb)


def test_cpe_recovery_under_phase_noise():
    """The port alone: 24 PRB, 1 port, 16QAM, DM-RS on symbol 2; a random
    phase per data symbol up to +-1.5 rad and noise 0.02.  With PT-RS the
    grant decodes; without, the same phase noise breaks it."""
    outs = {}
    for ptrs in (True, False):
        jtx, jrx = grant_configs(nof_rb=24, ports=1, rate=0.3, ptrs_enabled=ptrs)
        tb, rnti, rx = loopback(jtx, jrx, seed=1, snr_db=31.0, phase_noise=1.5,
                                channel=np.eye(1, dtype=np.complex64))
        trx = tpusch.PuschConfig.from_reference(jrx)
        out = tpusch.process(to_torch(rx)[None], torch.tensor([rnti]), trx)
        outs[ptrs] = (bool(out["tb_crc_ok"][0]), bool((to_np(out["tb_bits"][0]) == tb).all()))
    assert outs[True] == (True, True)
    assert outs[False][0] is False


def _slot_cfg(rb_count, mod, rate, tbs, crb, **kw):
    """A JAX PuschConfig of tests/test_ul_slot.py's slot (1 port, symbols
    0-13, slot 3) at absolute CRB ``crb``."""
    return jpusch.PuschConfig(
        tbs=tbs, target_code_rate=rate, modulation=mod,
        alloc=Allocation(rb_start=0, rb_count=rb_count, sym_start=0, sym_count=14,
                         dmrs_symbols=kw.pop("dmrs", (2, 11)), crb_start=crb),
        nof_layers=1, nof_rx_ports=1, nof_grid_symbols=14, nof_grid_sc=rb_count * 12,
        slot_in_frame=3, **kw)


def test_process_slot_with_ptrs():
    """8 grants on a 52-PRB carrier: plain 16QAM, one with HARQ-ACK + CSI
    part 1, two PT-RS grants (at PRB 30 and 36, DM-RS on symbol 2) that
    share a config but keep their own crb_start, all sent by the port's
    UE side; the port's slot against the reference's slot and against the
    port's per-PDU decode."""
    rng = np.random.default_rng(11)
    uci = jpusch.UciOnPuschConfig(nof_harq_ack_bits=2, nof_csi1_bits=4,
                                  beta_harq_ack_index=11, beta_csi_index=11)
    plan = [(0, {}), (6, {}), (12, {}), (18, dict(uci=uci)), (24, {}),
            (30, dict(ptrs_enabled=True, dmrs=(2,))), (36, dict(ptrs_enabled=True, dmrs=(2,))),
            (42, {})]
    ack_bits = np.asarray([1, 0], np.uint8)
    csi_bits = np.asarray([1, 1, 0, 1], np.uint8)
    grid = torch.zeros((1, 14, 52 * 12), dtype=torch.complex64)
    tbs, jpdus, tpdus = [], [], []
    for i, (rb0, kw) in enumerate(plan):
        jcfg = _slot_cfg(6, Modulation.QAM16, 0.4, 2048, rb0, **kw)
        tcfg = tpusch.PuschConfig.from_reference(jcfg)
        rnti = 0x4601 + i
        tb = rng.integers(0, 2, size=(tcfg.tbs,), dtype=np.uint8)
        if tcfg.ptrs_enabled:  # PT-RS goes out through the PDSCH twin
            sub = tpdsch.process(to_torch(tb), rnti, torch.eye(1, dtype=torch.complex64),
                                 tpusch._ptrs_twin(tcfg))
        else:
            parts = (to_torch(ack_bits), to_torch(csi_bits)) if tcfg.uci else ()
            sub = tpusch.transmit(to_torch(tb), torch.tensor(rnti), tcfg, *parts)
        grid[:, :, rb0 * 12 : rb0 * 12 + 72] += sub
        tbs.append(tb)
        jpdus.append(jul.UlSlotPdu(rnti=rnti, first_rb=rb0, config=jcfg))
        tpdus.append(tul.UlSlotPdu(rnti=rnti, first_rb=rb0, config=tcfg))
    noise = (rng.standard_normal(grid.shape) + 1j * rng.standard_normal(grid.shape)) * 0.02
    grid = grid + torch.from_numpy(noise.astype(np.complex64))
    groups = tul._config_groups(tpdus)
    assert sorted(len(v) for v in groups.values()) == [1, 1, 1, 5]  # the PT-RS two apart

    res_t = tul.process_slot(grid, tpdus)[0]
    res_j = jul.process_slot(jnp.asarray(to_np(grid)), jpdus)[0]
    for i, (rt, rj, tb, pdu) in enumerate(zip(res_t, res_j, tbs, tpdus)):
        assert bool(rt["tb_crc_ok"]) and bool(rj["tb_crc_ok"]), i
        np.testing.assert_array_equal(to_np(rt["tb_bits"]), tb)
        np.testing.assert_array_equal(np.asarray(rj["tb_bits"]), tb)
        assert abs(float(rt["snr_db"]) - float(rj["snr_db"])) <= 1e-3, i
        win = grid[None, :, :, pdu.first_rb * 12 : pdu.first_rb * 12 + 72]
        one = tpusch.process(win, torch.tensor([pdu.rnti]), pdu.config)
        np.testing.assert_array_equal(to_np(one["tb_bits"][0]), tb)
        assert abs(float(rt["snr_db"]) - float(one["snr_db"][0])) <= 1e-3, i
    r3 = res_t[3]
    np.testing.assert_array_equal(to_np(r3["harq_ack_bits"]), ack_bits)
    np.testing.assert_array_equal(to_np(r3["csi1_bits"]), csi_bits)
    assert bool(r3["harq_ack_ok"]) and bool(r3["csi1_ok"])


def test_ptrs_pdsch_twin_matches_reference():
    """``pusch._ptrs_twin`` is the PdschConfig the reference builds for a
    PT-RS grant's layout."""
    _, jrx = grant_configs(**GRANTS["2x2-k4-offset"])
    twin = tpusch._ptrs_twin(tpusch.PuschConfig.from_reference(jrx))
    ref = jpdsch.PdschConfig(
        tbs=jrx.tbs, target_code_rate=jrx.target_code_rate, modulation=jrx.modulation,
        alloc=jrx.alloc, nof_layers=jrx.nof_layers, nof_grid_symbols=jrx.nof_grid_symbols,
        nof_grid_sc=jrx.nof_grid_sc, slot_in_frame=jrx.slot_in_frame,
        dmrs_scrambling_id=jrx.dmrs_scrambling_id, n_scid=jrx.n_scid, ptrs_enabled=True,
        ptrs_k=jrx.ptrs_k, ptrs_re_offset=jrx.ptrs_re_offset, ptrs_k_rb_ref=jrx.ptrs_k_rb_ref)
    assert twin == tpdsch.PdschConfig.from_reference(ref)
    assert dataclasses.asdict(twin)["ptrs_enabled"]
