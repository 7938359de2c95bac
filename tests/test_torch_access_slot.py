"""Initial access and the MAC's remaining stages as a whole, in both
packages on the CPU: ``chip_smoke.py`` path 10's own sequences, at 52 PRB
and one port.

* ``test_initial_access_through_upper_phy``: path 10 (a), 4-step random
  access into connected data (``chip_smoke.p10_access_run``), with one
  ``chip_smoke.AccessCell`` over the JAX package's modules and one over
  the port's, both scheduled from one numpy seed, each through its own
  ``MessageBufferer`` and ``UpperPhy``; the UE side is the port's.  Per
  slot, every DL_TTI, TX_Data and UL_TTI the bufferers forward is equal
  field by field (TBs bitwise; a DCI the PDCCH allocator placed carries
  the allocator's CORESET in the port, ROADMAP Q3), the DL grids less
  their DCIs agree within 1e-6 x RMS (the reference's PDCCH encoder
  fails on the allocator's upper CCEs, so the JAX side's grid leaves the
  DCIs out), every DCI of the port's decodes back from its grid but where
  a PDSCH from symbol 1 (fallback, broadcast) shares its REs, and on the same received grid and PRACH buffer the
  indications agree: CRC verdicts, Rx_Data bits, RACH preambles and TA
  bins exactly.  Then path 10 (a)'s own checks run on the port's side,
  and the RA contexts, the fallback stage, the counters, the bufferer's
  stats and the schedulers' whole state are equal in both.
* ``test_slices_through_upper_phy``: path 10 (b)'s two slices (``rr`` and
  ``qos``, 2 UEs each here) for 20 slots, the RRM policy after slot 5:
  the requests, quotas, CRC verdicts and reports equal in both packages.
* ``test_mac_test_mode_40_slots``: ``MacTestModeAdapter`` over a 4-layer
  scheduler for 40 slots, the report and the state equal.

Host logic is exact.  int8 LLRs are not compared here (the PUSCH tests
do); the decoded bits and CRC verdicts are.
"""

import types

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_dl_slot import assert_grid_close
from test_torch_scheduler import assert_same_slot, state
from torch_parity import plain, to_np

import chip_smoke as smoke
from srsran_project_tpu.fapi import bufferer as j_buf
from srsran_project_tpu.fapi import messages as j_fapi
from srsran_project_tpu.l2 import mac_pdu as j_mac
from srsran_project_tpu.l2sim import common_scheduling as j_cs
from srsran_project_tpu.l2sim import fallback as j_fb
from srsran_project_tpu.l2sim import link_adaptation as j_la
from srsran_project_tpu.l2sim import ra as j_ra
from srsran_project_tpu.l2sim import scheduler as j_sched
from srsran_project_tpu.l2sim import si_paging as j_sp
from srsran_project_tpu.l2sim import slicing as j_slicing
from srsran_project_tpu.l2sim import test_mode as j_tm
from srsran_project_tpu.l2sim import ue_context_loops as j_ucl
from srsran_project_tpu.ops.modulation import Modulation as JModulation
from srsran_project_tpu.phy import allocation as j_alloc
from srsran_project_tpu.phy import prach as j_prach
from srsran_project_tpu.phy import pusch as j_pusch
from srsran_project_tpu.phy.upper_phy import UpperPhy as JUpperPhy
from srsran_project_tpu.phy.upper_phy import UpperPhyConfig as JUpperPhyConfig
from srsran_project_tpu.ran import csi as j_csi
from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
from srsran_project_tpu.ran.slot_point import SlotPoint as JSlot
from srsran_project_tpu_torch.l2sim import link_adaptation as t_la
from srsran_project_tpu_torch.l2sim import test_mode as t_tm
from srsran_project_tpu_torch.phy import pdcch as t_pdcch
from srsran_project_tpu_torch.phy.upper_phy import UpperPhy as TUpperPhy
from srsran_project_tpu_torch.phy.upper_phy import UpperPhyConfig as TUpperPhyConfig
from srsran_project_tpu_torch.ran import csi as t_csi

GEO = dict(nof_rb=52, ports=1, layers=1, ra_prbs=8, ues=2, mcs=20, srate_hz=30.72e6)
CPU = torch.device("cpu")
T = smoke.p10_modules()
J = types.SimpleNamespace(
    fapi=j_fapi, buf=j_buf, mac=j_mac, cs=j_cs, fb=j_fb, ra=j_ra, sched=j_sched, sp=j_sp,
    slicing=j_slicing, ucl=j_ucl, prach=j_prach, pusch=j_pusch, alloc=j_alloc,
    Modulation=JModulation, UpperPhy=JUpperPhy, UpperPhyConfig=JUpperPhyConfig, Slot=JSlot,
    Scs=JScs)


class JaxPhy:
    """The JAX package's UpperPhy behind the port's tensor interface.  Its
    DL grids leave the DCIs out: the reference's PDCCH PDU names a
    1-symbol CORESET, whose encoder fails on the allocator's upper CCEs
    (ROADMAP Q3, the port's one repair of the scheduler's requests)."""

    def __init__(self, nof_ports: int, nof_grid_sc: int):
        self.phy = JUpperPhy(JUpperPhyConfig(nof_ports=nof_ports, nof_grid_sc=nof_grid_sc))

    def process_dl_tti(self, req, tx):
        req = j_fapi.DlTtiRequest(slot=req.slot, pdsch=req.pdsch, ssb=req.ssb, csi_rs=req.csi_rs)
        return torch.from_numpy(np.array(self.phy.process_dl_tti(req, tx)))

    def process_ul_tti(self, req, grid, prach_fd=None):
        return self.phy.process_ul_tti(req, jnp.asarray(to_np(grid)), prach_fd=None
                                       if prach_fd is None else jnp.asarray(to_np(prach_fd)))


def _same_results(jres, tres, what: str) -> None:
    """Two packages' indications on one received grid: CRC verdicts,
    Rx_Data bits, RACH preambles and TA bins exactly; errors alike."""
    assert [(c.rnti, c.harq_id, c.tb_crc_ok) for c in tres.crc] == \
        [(c.rnti, c.harq_id, c.tb_crc_ok) for c in jres.crc], what
    assert len(tres.rx_data) == len(jres.rx_data), what
    for t, j in zip(tres.rx_data, jres.rx_data):
        assert (t.rnti, t.harq_id) == (j.rnti, j.harq_id), what
        np.testing.assert_array_equal(np.asarray(t.payload), np.asarray(j.payload), err_msg=what)
    assert [(r.preamble_index, r.ta_samples) for r in tres.rach] == \
        [(r.preamble_index, r.ta_samples) for r in jres.rach], what
    assert [e.message for e in tres.errors] == [e.message for e in jres.errors], what


def test_initial_access_through_upper_phy():
    """Path 10 (a)'s sequence (slots 136-164) at 52 PRB and one port in
    both packages, lockstep; see the module docstring."""
    nof_sc = GEO["nof_rb"] * 12
    jcell = smoke.AccessCell(J, GEO, JaxPhy(GEO["ports"], nof_sc))
    tcell = smoke.AccessCell(T, GEO, TUpperPhy(TUpperPhyConfig(
        nof_ports=GEO["ports"], nof_grid_sc=nof_sc, device="cpu")))
    rng = np.random.default_rng(10)
    ue = smoke.AccessUe(T, GEO, CPU, rng)
    channel = torch.from_numpy(np.exp(2j * np.pi * np.array([[0.3]])).astype(np.complex64))
    gen = torch.Generator().manual_seed(10)
    crc, dcis = [], []

    def on_slot(count, boxes, grids, results, seen):
        jbox, tbox = boxes
        names = ("DlTtiRequest", "TxDataRequest", "UlTtiRequest")
        assert_same_slot(tuple(jbox[n] for n in names) + ([],),
                         tuple(tbox[n] for n in names) + ([],), f"access slot {count}",
                         tcell.ue.coresets)
        # The DL grids without the DCIs agree (the JAX side's leaves them
        # out, see JaxPhy); every DCI of the port's decodes back from its
        # grid, but where it shares REs with a PDSCH from symbol 1.
        dl = tbox["DlTtiRequest"]
        ctl = tcell.phy.process_dl_tti(T.fapi.DlTtiRequest(slot=dl.slot, pdcch=dl.pdcch),
                                       T.fapi.TxDataRequest(slot=dl.slot))
        if dl.pdsch or dl.ssb or dl.csi_rs:
            assert_grid_close(to_np(grids[1] - ctl), to_np(grids[0]))
        else:  # a slot of the measurement gap with nothing to send
            assert not to_np(grids[0]).any() and not to_np(grids[1] - ctl).any()
        fb = [(p.first_rb, p.first_rb + p.config.alloc.rb_count) for p in dl.pdsch
              if p.config.alloc.sym_start < 2]  # fallback, RAR and broadcast PDSCH
        for p in dl.pdcch:
            bits, ok = t_pdcch.receive(grids[1][0], p.rnti, p.config)
            lo, hi = 3 * p.config.cce_index, 3 * (p.config.cce_index + p.config.aggregation_level)
            shared = any(a < hi and lo < b for a, b in fb)
            dcis.append((count, p.rnti, bool(ok), shared))
            if not shared:
                assert bool(ok) and np.array_equal(to_np(bits), p.payload), (count, p.rnti)
        _same_results(results[0], results[1], f"access slot {count}")
        crc.extend((count, c.rnti, c.tb_crc_ok) for c in results[1].crc)

    events = smoke.p10_access_run([jcell, tcell], ue, channel, gen, on_slot)
    smoke.p10_check_access(tcell, ue, events, crc, smoke.P10_END - smoke.P10_START + 1)
    assert jcell.cell.counters == tcell.cell.counters == smoke.P10_COUNTERS
    assert plain(vars(tcell.ra)) == plain(vars(jcell.ra))
    assert state(tcell.fallback) == state(jcell.fallback)
    assert plain(tcell.bufferer.stats) == plain(jcell.bufferer.stats)
    assert state(tcell.ue) == state(jcell.ue)
    assert plain(tcell.msg3_bits) == plain(jcell.msg3_bits)
    assert tcell.ue.report() == jcell.ue.report()
    assert len(dcis) > 20


def _slices(m, nof_rb=52):
    ss = m.slicing.SliceScheduler(
        m.sched.SchedulerConfig(nof_grid_sc=nof_rb * 12, nof_rb=nof_rb, max_ues_per_slot=2),
        [m.slicing.SliceConfig(**s) for s in smoke.P10_SLICES])
    for k, s in enumerate(smoke.P10_SLICES):
        for i in range(2):
            ss.add_ue(s["slice_id"], 0x700 + 0x10 * k + i, mcs=12 + 4 * i)
    return ss


def test_slices_through_upper_phy():
    """Path 10 (b)'s two slices at 52 PRB, one port, 2 UEs each, for 20
    slots through both packages' UpperPhy (the DL grid looped back with
    AWGN at 25 dB, the same numpy noise for both); the RRM policy raises
    slice 2's minimum to 50 % after slot 5.  Requests, quotas, CRC
    verdicts, reports and state equal in both; the slices' PRBs never
    overlap and every CRC passes; slice 2's grant configs keep the inner
    scheduler's crb_start (kept for parity).  The UE power controllers' SNRs, each
    package's own estimate, agree within 1e-3 dB."""
    js, ts = _slices(J), _slices(T)
    jphy, tphy = JaxPhy(1, 624), TUpperPhy(TUpperPhyConfig(nof_ports=1, device="cpu"))
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    noise_rng = np.random.default_rng(4)
    quotas = []
    for k in range(20):
        if k == smoke.P10_POLICY_AFTER:
            assert js.apply_rrm_policy(smoke.P10_POLICY) and ts.apply_rrm_policy(smoke.P10_POLICY)
        slot_j, slot_t = J.Slot.from_sfn_slot(J.Scs.KHZ30, k // 20, k % 20), \
            T.Slot.from_sfn_slot(T.Scs.KHZ30, k // 20, k % 20)
        ref, port = js.run_slot(slot_j, jrng), ts.run_slot(slot_t, trng)
        assert_same_slot(ref, port, f"slices slot {k}")
        assert ts.last_quotas == js.last_quotas
        quotas.append(dict(ts.last_quotas))
        dl, tx, ul, grants = port
        spans = sorted((p.first_rb, p.first_rb + p.config.alloc.rb_count) for p in dl.pdsch)
        assert all(b <= c for (_a, b), (c, _d) in zip(spans, spans[1:])) and spans[-1][1] <= 52
        # Kept for parity (ROADMAP Q3): slice 2's configs keep the inner
        # scheduler's crb_start while first_rb carries the slice offset.
        assert {p.config.alloc.crb_start == p.first_rb for p in dl.pdsch} == {True, False}
        grid = tphy.process_dl_tti(dl, tx)
        assert_grid_close(to_np(grid), to_np(jphy.process_dl_tti(ref[0], ref[1])))
        sigma = np.sqrt(0.5 * 10 ** (-25.0 / 10))
        rx = grid + torch.from_numpy((sigma * (noise_rng.standard_normal(grid.shape)
                                               + 1j * noise_rng.standard_normal(grid.shape))
                                      ).astype(np.complex64))
        tres, jres = tphy.process_ul_tti(ul, rx), jphy.process_ul_tti(ref[2], rx)
        _same_results(jres, tres, f"slices slot {k}")
        assert all(c.tb_crc_ok for c in tres.crc) and len(tres.crc) == len(grants) == 4
        js.handle_results(jres)
        ts.handle_results(tres)
        assert ts.report() == js.report()
    assert quotas[0] == {1: 26, 2: 26} and quotas[-1] == {1: 21, 2: 31}
    for sid in ts.inner:
        # The power controller keeps each package's PUSCH SNR estimates:
        # within 1e-3 dB, as the CRC indications' snr_db (the rest exact).
        tst, jst = state(ts.inner[sid]), state(js.inner[sid])
        tpc, jpc = tst.pop("power_control")[1]["ues"], jst.pop("power_control")[1]["ues"]
        assert tst == jst
        assert tpc.keys() == jpc.keys()
        for rnti in tpc:
            t_ue, j_ue = dict(tpc[rnti][1]), dict(jpc[rnti][1])
            assert abs(t_ue.pop("last_sinr_db") - j_ue.pop("last_sinr_db")) <= 1e-3
            assert t_ue == j_ue


def test_mac_test_mode_40_slots():
    """``MacTestModeAdapter`` over a 4-layer, 4-port scheduler with CSI
    every 4 slots for 40 slots in both packages: every request and
    synthetic result equal, the report equal, the scheduler's state equal."""
    def build(la, csi, sched, tm):
        s = sched.RoundRobinScheduler(sched.SchedulerConfig(
            nof_rb=52, max_ues_per_slot=3, nof_ports=4, nof_layers=4))
        s.link_adaptor = la.LinkAdaptor()
        s.csi_report_cfg = csi.CsiReportConfig(nof_csi_rs_ports=4)
        return s, tm.MacTestModeAdapter(tm.TestModeUeConfig(
            nof_ues=5, ri=4, cqi=9, i11=1, i2=1, csi_period_slots=4), s,
            csi_report_cfg=s.csi_report_cfg)

    (js, jtm), (ts, ttm) = build(j_la, j_csi, j_sched, j_tm), build(t_la, t_csi, T.sched, t_tm)
    jrng, trng = np.random.default_rng(6), np.random.default_rng(6)
    for k in range(40):
        jout = jtm.run_slot(J.Slot.from_sfn_slot(J.Scs.KHZ30, k // 20, k % 20), jrng)
        tout = ttm.run_slot(T.Slot.from_sfn_slot(T.Scs.KHZ30, k // 20, k % 20), trng)
        assert_same_slot(jout[:3] + ([],), tout[:3] + ([],), f"test mode slot {k}")
        assert plain(tout[3]) == plain(jout[3])
    assert ttm.report() == jtm.report() and ttm.report()["nof_uci"] == 5 * 10
    assert state(ts) == state(js)
