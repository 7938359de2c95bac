"""The port's schedulers against the JAX package's: ``RoundRobinScheduler``,
``CellScheduler`` (common channels) and ``MultiCellScheduler``, each built
in both packages from one config (the port's through ``from_reference``),
run 40 slots from one numpy seed, with the same synthetic CRC, SRS and
UCI indications fed back every slot.

Every DL_TTI, TX_Data and UL_TTI field is compared exactly, slot by slot
(the JAX request copied into the port's classes with the messages'
``from_reference``; TBs bitwise, arrays with their dtype), and so is every
report and the schedulers' whole state at the end: the scheduler is
integer and numpy host code, so the tolerance is zero.

Then the port's scheduler drives the port's ``UpperPhy`` on the CPU: a
24-PRB 1-port run beside the JAX package's (DL grids within 1e-6 x RMS,
every CRC passing in both, the same TB bits), the HARQ lifecycle (NACK at
-10 dB, then an rv-2 retransmission combining to an ACK), and the host
plan caches bounded over a long run."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dl_slot import assert_grid_close
from torch_parity import plain, to_np

from srsran_project_tpu.fapi import messages as j_fapi
from srsran_project_tpu.l2sim import common_scheduling as j_cs
from srsran_project_tpu.l2sim import link_adaptation as j_la
from srsran_project_tpu.l2sim import multi_cell as j_mc
from srsran_project_tpu.l2sim import scheduler as j_sched
from srsran_project_tpu.l2sim import ue_context_loops as j_ucl
from srsran_project_tpu.phy import prach as j_prach
from srsran_project_tpu.phy.upper_phy import UpperPhy as JUpperPhy
from srsran_project_tpu.phy.upper_phy import UpperPhyConfig as JUpperPhyConfig
from srsran_project_tpu.ran import csi as j_csi
from srsran_project_tpu.ran import tdd as j_tdd
from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
from srsran_project_tpu.ran.slot_point import SlotPoint as JSlot
from srsran_project_tpu_torch.fapi import messages as t_fapi
from srsran_project_tpu_torch.l2sim import common_scheduling as t_cs
from srsran_project_tpu_torch.l2sim import link_adaptation as t_la
from srsran_project_tpu_torch.l2sim import multi_cell as t_mc
from srsran_project_tpu_torch.l2sim import scheduler as t_sched
from srsran_project_tpu_torch.l2sim import ue_context_loops as t_ucl
from srsran_project_tpu_torch.phy import channel_emulator as t_chem
from srsran_project_tpu_torch.phy import pdsch as t_pdsch
from srsran_project_tpu_torch.phy import prach as t_prach
from srsran_project_tpu_torch.phy import pusch as t_pusch
from srsran_project_tpu_torch.phy.upper_phy import UpperPhy as TUpperPhy
from srsran_project_tpu_torch.phy.upper_phy import UpperPhyConfig as TUpperPhyConfig
from srsran_project_tpu_torch.ran import csi as t_csi
from srsran_project_tpu_torch.ran import tdd as t_tdd
from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing as TScs
from srsran_project_tpu_torch.ran.slot_point import SlotPoint as TSlot

J = types.SimpleNamespace(fapi=j_fapi, cs=j_cs, la=j_la, mc=j_mc, sched=j_sched, ucl=j_ucl,
                          prach=j_prach, csi=j_csi, tdd=j_tdd, Slot=JSlot, Scs=JScs)
T = types.SimpleNamespace(fapi=t_fapi, cs=t_cs, la=t_la, mc=t_mc, sched=t_sched, ucl=t_ucl,
                          prach=t_prach, csi=t_csi, tdd=t_tdd, Slot=TSlot, Scs=TScs)

NOF_SLOTS = 40
SEED = 5


def slot_point(m, n: int):
    return m.Slot.from_sfn_slot(m.Scs.KHZ30, (n // 20) % 1024, n % 20)


# ---- comparisons ---------------------------------------------------------------

def assert_same(a, b, path: str = "request") -> None:
    """a and b equal field by field: dataclasses of one class, arrays with
    their dtype and shape bitwise, sequences element by element."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a) is type(b), (path, type(a), type(b))
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert np.array_equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def repaired_dci(dl, coresets):
    """The port's one repair of the requests: a DCI the PDCCH allocator
    placed carries the allocator's CORESET (the reference's PDU says one
    symbol of ``coreset_rb_count`` RBs).  ``dl``: a reference DL_TTI
    copied into the port's classes."""
    for pdu in dl.pdcch:
        assert (pdu.config.duration, pdu.config.coreset_rb_count) == (1, 24)
        cs = coresets[1]
        pdu.config = dataclasses.replace(pdu.config, duration=cs.duration,
                                         coreset_rb_count=cs.nof_rbs)
    return dl


def assert_same_slot(ref, port, what: str, coresets=None) -> None:
    """One slot's (DL_TTI, TX_Data, UL_TTI, grants) of both packages;
    ``coresets``: the port scheduler's, when its PDCCH allocator is on."""
    (jdl, jtx, jul, jgr), (tdl, ttx, tul, tgr) = ref, port
    twin = t_fapi.DlTtiRequest.from_reference(jdl)
    if coresets is not None:
        twin = repaired_dci(twin, coresets)
    assert_same(twin, tdl, f"{what} DL_TTI")
    assert_same(t_fapi.TxDataRequest.from_reference(jtx), ttx, f"{what} TX_Data")
    assert_same(t_fapi.UlTtiRequest.from_reference(jul), tul, f"{what} UL_TTI")
    assert plain(jgr) == plain(tgr), what
    for req in (tdl, tul):
        assert isinstance(req.slot, TSlot)
    for pdu in tdl.pdsch:
        assert isinstance(pdu.config, t_pdsch.PdschConfig)
    for pdu in tul.pusch:
        assert isinstance(pdu.config, t_pusch.PuschConfig)


def state(obj) -> dict:
    """A scheduler's whole state as plain data (its TB hook left out)."""
    return plain({k: v for k, v in vars(obj).items() if k != "tb_source"})


# ---- configs ---------------------------------------------------------------------

def _all_loops(m) -> dict:
    return dict(nof_rb=52, max_ues_per_slot=4, nof_layers=2, nof_ports=4,
                use_pdcch_alloc=True, emit_dci=True, use_pucch_alloc=True, k1=3, use_srs=True,
                use_ta_manager=True,
                ta_manager_cfg=m.ucl.TaManagerConfig(measurement_period=8),
                drx=m.ucl.DrxConfig(long_cycle_ms=10, on_duration_ms=6, inactivity_ms=2),
                meas_gap=m.ucl.MeasGapConfig(mgrp_ms=20, mgl_ms=1.5, gap_offset_ms=7),
                srs_link_adaptation=True)


# name -> (SchedulerConfig kwargs from a package, UEs (rnti, mcs, QoS weight)).
CONFIGS = {
    "fdd_rr": (lambda m: dict(nof_rb=52, max_ues_per_slot=4),
               [(0x100 + i, 10, 1.0) for i in range(6)]),
    "qos": (lambda m: dict(nof_rb=52, max_ues_per_slot=2, policy="qos", pf_forgetting=0.1),
            [(0x200, 4, 1.0), (0x201, 12, 4.0), (0x202, 20, 1.0), (0x203, 27, 0.5)]),
    "tdd_7d2u": (lambda m: dict(nof_rb=52, max_ues_per_slot=3, tdd_pattern=m.tdd.PATTERN_7D2U),
                 [(0x300 + i, 10, 1.0) for i in range(5)]),
    "ntn_koffset": (lambda m: dict(nof_rb=24, nof_grid_sc=288, max_ues_per_slot=2,
                                   ntn_koffset=478), [(0x400, 6, 1.0), (0x401, 16, 1.0)]),
    "demand_sr_bsr": (lambda m: dict(nof_rb=48, max_ues_per_slot=2, ul_demand_driven=True),
                      [(0x500 + i, 9, 1.0) for i in range(4)]),
    "all_loops": (_all_loops, [(0x600 + i, 4 + 4 * i, 1.0) for i in range(6)]),
    "all_loops_tdd": (lambda m: dict(_all_loops(m), tdd_pattern=m.tdd.TddPattern(
        period_slots=5, nof_dl_slots=2, nof_ul_slots=2)), [(0x700 + i, 10, 1.0) for i in range(5)]),
}


def scheduler(m, name: str):
    make_kw, ues = CONFIGS[name]
    cfg = m.sched.SchedulerConfig(**make_kw(m))
    if m is T:
        # The port's config is the copy of the reference's.
        assert t_sched.SchedulerConfig.from_reference(
            j_sched.SchedulerConfig(**make_kw(J))) == cfg
    s = m.sched.RoundRobinScheduler(cfg)
    for rnti, mcs, weight in ues:
        s.add_ue(rnti, mcs=mcs, qos_weight=weight)
    if name.startswith("all_loops"):
        s.link_adaptor = m.la.LinkAdaptor()
        s.csi_report_cfg = m.csi.CsiReportConfig(nof_csi_rs_ports=4, ri_restriction=0b0011)
    if name == "qos":
        s.tb_source = lambda rnti, n: (np.arange(n) * 7 + rnti) % 3 % 2
    return s


def common_config(m, nof_rb: int = 52, nof_grid_sc: int = 624):
    return m.cs.CommonSchedulingConfig(
        ssb_period_slots=10, ssb_slot_offset=2, ssb_first_symbol=4, ssb_first_subcarrier=48,
        pci=7, sib1_period_slots=20, sib1_slot_offset=1, sib1_payload=b'{"sib1": 7}',
        paging_period_slots=16, prach_period_slots=10, prach_slot_offset=9,
        prach_config=m.prach.PrachConfig(l_ra=139, zero_correlation_zone=5),
        csi_rs_period_slots=8, csi_rs_slot_offset=3, nof_rb=nof_rb, nof_grid_sc=nof_grid_sc)


def cell_scheduler(m, name: str):
    ue = scheduler(m, name)
    cell = m.cs.CellScheduler(common_config(m), ue)
    if m is T:
        assert t_cs.CommonSchedulingConfig.from_reference(common_config(J)) == cell.common
    for i in range(12):
        cell.paging.page(0x1000 + i, "cs" if i % 3 else "ps")
    cell.cbs.warn(0x1100, bytes(range(200)), repetitions=2)
    cell.cbs.warn(0x1112, b"short warning")
    return cell


def multi_cell(m):
    cfgs = {0: m.sched.SchedulerConfig(**CONFIGS["fdd_rr"][0](m)),
            1: m.sched.SchedulerConfig(**CONFIGS["tdd_7d2u"][0](m)),
            2: m.sched.SchedulerConfig(**dict(_all_loops(m), nof_layers=1))}
    mc = m.mc.MultiCellScheduler(cfgs)
    for i in range(8):
        mc.add_ue(0x800 + i, i % 3, mcs=6 + 2 * i)
    mc.add_scell(0x800, 1, mcs=12)
    mc.add_scell(0x801, 2)
    return mc


# ---- synthetic indications -----------------------------------------------------

def indications(m, ul, k: int, csi_cfg=None, rntis=()):
    """The slot's indications, a function of the request and the slot
    index only: CRC (80 % ACK, an SNR and a TA), one SRS report per SRS
    PDU and, with a CSI report config, CSI parts 1 and 2 of every UE
    every fourth slot (and a UCI PDU that is invalid, one of a size that
    matches neither part)."""
    crc = [m.fapi.CrcIndicationPdu(p.rnti, p.harq_id, (k * 7 + i * 3) % 5 != 0,
                                   snr_db=float(3 + (k * 13 + i * 7) % 25),
                                   ta_s=((k + i) % 5 - 2) * 0.13e-6)
           for i, p in enumerate(ul.pusch)]
    srs = [m.fapi.SrsIndicationPdu(p.rnti, float(2 + (k * 11 + i) % 30), 0.0,
                                   np.zeros((1, 4), np.complex64))
           for i, p in enumerate(ul.srs)]
    uci = []
    if csi_cfg is not None and k % 4 == 1:
        for rnti in rntis:
            rank = 1 + (k // 4 + rnti) % 2
            p1 = m.csi.pack_part1(csi_cfg, 0, rank, (k + rnti) % 16)
            p2 = m.csi.pack_part2(csi_cfg, rank, i11=(k + rnti) % 8, i13=rnti % 2, i2=k % 2)
            uci += [m.fapi.UciIndicationPdu(rnti, p1, True, 1.0),
                    m.fapi.UciIndicationPdu(rnti, p2, True, 1.0)]
        uci += [m.fapi.UciIndicationPdu(rntis[0], np.ones(3, np.uint8), False, 0.0),
                m.fapi.UciIndicationPdu(rntis[-1], np.ones(17, np.uint8), True, 0.0)]
    return m.fapi.SlotResults(slot=ul.slot, crc=crc, srs=srs, uci=uci)


def events(s, k: int) -> None:
    """SR and BSR reports of the demand-driven config."""
    rntis = sorted(s.ues)
    if k % 7 == 3:
        s.handle_sr(rntis[k % len(rntis)])
    if k % 11 == 5:
        s.handle_bsr(rntis[(k + 1) % len(rntis)], 300 * (k % 4))
    s.handle_sr(0xDEAD)  # an unknown UE is ignored
    s.handle_bsr(0xDEAD, 5)


def drive(m, s, k: int, ue_sched, rng):
    out = s.run_slot(slot_point(m, k), rng)
    cfg = ue_sched.csi_report_cfg
    ue_sched.handle_results(indications(m, out[2], k, cfg, sorted(ue_sched.ues)))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_round_robin_scheduler(name):
    """40 slots of one RoundRobinScheduler config in both packages."""
    js, ts = scheduler(J, name), scheduler(T, name)
    jrng, trng = np.random.default_rng(SEED), np.random.default_rng(SEED)
    for k in range(NOF_SLOTS):
        if name == "demand_sr_bsr":
            events(js, k)
            events(ts, k)
        ref, port = drive(J, js, k, js, jrng), drive(T, ts, k, ts, trng)
        assert_same_slot(ref, port, f"{name} slot {k}", getattr(ts, "coresets", None))
        for rnti in sorted(js.ues):
            assert js.pop_ta_cmds(rnti) == ts.pop_ta_cmds(rnti)
        assert ts.report() == js.report()
    assert state(ts) == state(js)
    assert (ts.nof_pdcch_blocked, ts.nof_pucch_blocked) == (js.nof_pdcch_blocked,
                                                            js.nof_pucch_blocked)
    assert trng.integers(0, 1 << 30) == jrng.integers(0, 1 << 30)  # same draws


def _has(name, ts, what):
    return any(getattr(u, what) is not None for u in ts.ues.values())


def test_round_robin_features_reached():
    """The configs above reach what they are named for: TDD gating, the
    NTN offset, SR/BSR demand, PDCCH DCIs, PUCCH, SRS, TA commands and
    the CSI/PMI loop."""
    seen = {}
    for name in CONFIGS:
        s, rng = scheduler(T, name), np.random.default_rng(SEED)
        got = dict(pdsch=0, pusch=0, pdcch=0, pucch=0, srs=0, koffset=0, ta=0)
        for k in range(NOF_SLOTS):
            if name == "demand_sr_bsr":
                events(s, k)
            dl, _, ul, _ = drive(T, s, k, s, rng)
            got["pdsch"] += len(dl.pdsch)
            got["pusch"] += len(ul.pusch)
            got["pdcch"] += len(dl.pdcch)
            got["pucch"] += len(ul.pucch)
            got["srs"] += len(ul.srs)
            got["koffset"] += ul.slot.count - dl.slot.count
            got["ta"] += sum(len(s.pop_ta_cmds(r)) for r in list(s.ues))
        got["pmi"] = sum(u.dl_precoding is not None for u in s.ues.values())
        seen[name] = got
    assert seen["fdd_rr"]["pdsch"] == seen["fdd_rr"]["pusch"] == 4 * NOF_SLOTS
    assert seen["tdd_7d2u"]["pdsch"] == 3 * 28 and seen["tdd_7d2u"]["pusch"] == 3 * 8
    assert seen["ntn_koffset"]["koffset"] == 478 * NOF_SLOTS
    assert 0 < seen["demand_sr_bsr"]["pusch"] < seen["demand_sr_bsr"]["pdsch"]
    for name in ("all_loops", "all_loops_tdd"):
        g = seen[name]
        assert min(g["pdcch"], g["pucch"], g["srs"], g["ta"], g["pmi"]) > 0, (name, g)


@pytest.mark.parametrize("name", ["fdd_rr", "all_loops_tdd"])
def test_cell_scheduler(name):
    """40 slots of the common-channel CellScheduler around a UE
    scheduler: SSB, SIB1, paging, CBS, CSI-RS and PRACH occasions in both
    packages, and the CBS pages reassembled alike."""
    jc, tc = cell_scheduler(J, name), cell_scheduler(T, name)
    jrng, trng = np.random.default_rng(SEED), np.random.default_rng(SEED)
    cbs = ([], [])
    for k in range(NOF_SLOTS):
        ref = drive(J, jc, k, jc.ue_scheduler, jrng)
        port = drive(T, tc, k, tc.ue_scheduler, trng)
        assert_same_slot(ref, port, f"{name} common slot {k}",
                         getattr(tc.ue_scheduler, "coresets", None))
        for (dl, tx, _, _), pages in zip((ref, port), cbs):
            pages += [np.packbits(tx.payloads[p.tb_index]).tobytes() for p in dl.pdsch
                      if p.rnti == j_cs.CBS_RNTI]
        assert tc.counters == jc.counters
    assert tc.counters == {"ssb": 4, "sib1": 2, "paging": 2, "csi_rs": 5, "prach": 4, "cbs": 2,
                           "fallback": 0, "si": 0}
    assert t_cs.reassemble_cbs(cbs[1]) == j_cs.reassemble_cbs(cbs[0])
    # No optional stage was given: both packages' CellSchedulers hold None.
    assert all(getattr(tc, stage) is None
               for stage in ("fallback", "si_scheduler", "paging_po", "csi_rs_scheduler"))
    assert state(tc) == state(jc)


def test_multi_cell_scheduler():
    """40 slots of three cells (FDD, TDD, the loops) with eight UEs, two
    of them with an SCell, one moved to another cell half way."""
    jm, tm = multi_cell(J), multi_cell(T)
    jrng, trng = np.random.default_rng(SEED), np.random.default_rng(SEED)
    for k in range(NOF_SLOTS):
        if k == 20:
            jm.move_ue(0x805, 0)
            tm.move_ue(0x805, 0)
        jout, tout = jm.run_slot(slot_point(J, k), jrng), tm.run_slot(slot_point(T, k), trng)
        assert list(tout) == list(jout)
        for cid in jout:
            assert_same_slot(jout[cid], tout[cid], f"cell {cid} slot {k}",
                             getattr(tm.cells[cid], "coresets", None))
            jm.handle_results(cid, indications(J, jout[cid][2], k))
            tm.handle_results(cid, indications(T, tout[cid][2], k))
        assert tm.metrics_report() == jm.metrics_report()
    assert tm.carriers_of(0x800) == jm.carriers_of(0x800) == (0, 1)
    assert tm.serving == jm.serving and tm.scells == jm.scells
    assert plain(tm.ue_context(0x805)) == plain(jm.ue_context(0x805))
    for cid in jm.cells:
        assert state(tm.cells[cid]) == state(jm.cells[cid])
        assert tm.cells[cid].report() == jm.cells[cid].report()


def test_to_scheduler_config():
    """support/config.to_scheduler_config: the port's copy of the
    reference's, for the defaults, a TDD pattern, the engines and NTN."""
    from srsran_project_tpu.support import config as jconfig
    from srsran_project_tpu_torch.support import config as tconfig

    for ov in ({}, {"scheduler.tdd_period_slots": 10, "scheduler.tdd_dl_slots": 7,
                    "scheduler.tdd_ul_slots": 2, "scheduler.policy": "qos"},
               {"scheduler.use_pdcch_alloc": True, "scheduler.use_pucch_alloc": True,
                "scheduler.use_srs": True, "scheduler.k1": 2, "ntn.cell_specific_koffset": 40,
                "scheduler.ul_demand_driven": True, "cell.nof_rb": 52}):
        ref = jconfig.to_scheduler_config(jconfig.load_config(None, ov), nof_grid_sc=3300)
        port = tconfig.to_scheduler_config(tconfig.load_config(None, ov), nof_grid_sc=3300)
        assert port == t_sched.SchedulerConfig.from_reference(ref)
        assert plain(port) == plain(ref)


# ---- the port's scheduler driving the port's UpperPhy (CPU) ------------------------

E2E_PRB = 24


def _e2e_scheduler(m):
    s = m.sched.RoundRobinScheduler(m.sched.SchedulerConfig(
        nof_rb=E2E_PRB, nof_grid_sc=E2E_PRB * 12, max_ues_per_slot=2))
    for i in range(3):
        s.add_ue(0x900 + i, mcs=10 + 3 * i)
    return s


def test_end_to_end_against_the_reference():
    """Four slots of a 24-PRB 1-port cell, three UEs (two a slot): the
    same grants through both packages' UpperPhy, the port's DL grid
    within 1e-6 x RMS of the reference's, the port's received grid (one
    tap at 30 dB) decoded by both, every CRC passing in both with the
    scheduled TBs, and each package's indications fed back to its own
    scheduler."""
    js, ts = _e2e_scheduler(J), _e2e_scheduler(T)
    jphy = JUpperPhy(JUpperPhyConfig(nof_ports=1, nof_grid_sc=E2E_PRB * 12))
    tphy = TUpperPhy(TUpperPhyConfig(nof_ports=1, nof_grid_sc=E2E_PRB * 12, device="cpu"))
    ch = t_chem.ChannelConfig(profile="single", sinr_db=30.0, nof_sc=E2E_PRB * 12)
    gen = torch.Generator().manual_seed(3)
    jrng, trng = np.random.default_rng(SEED), np.random.default_rng(SEED)
    for k in range(4):
        ref, port = js.run_slot(slot_point(J, k), jrng), ts.run_slot(slot_point(T, k), trng)
        assert_same_slot(ref, port, f"e2e slot {k}")
        (jdl, jtx, jul, _), (tdl, ttx, tul, grants) = ref, port
        grid = tphy.process_dl_tti(tdl, ttx)
        assert_grid_close(to_np(grid), np.asarray(jphy.process_dl_tti(jdl, jtx)))
        rx, _, _ = t_chem.apply_channel(grid, gen, ch)
        tres = tphy.process_ul_tti(tul, rx)
        jres = jphy.process_ul_tti(jul, jnp.asarray(to_np(rx)))
        assert [c.tb_crc_ok for c in tres.crc] == [c.tb_crc_ok for c in jres.crc] == [True] * 2
        for t, j, (rnti, harq_id, tbs) in zip(tres.rx_data, jres.rx_data, grants):
            tb = ts.ues[rnti].harqs[harq_id].tb
            assert (t.rnti, t.harq_id, len(tb)) == (rnti, harq_id, tbs)
            np.testing.assert_array_equal(t.payload, tb)
            np.testing.assert_array_equal(np.asarray(j.payload), tb)
        for t, j in zip(tres.crc, jres.crc):
            assert abs(t.snr_db - j.snr_db) <= 1e-3
        js.handle_results(jres)
        ts.handle_results(tres)
        assert ts.report() == js.report()
    assert all(v["ul_bits_ok"] > 0 for v in ts.report().values())


# Channel seed -> (rv, CRC) of the three transmissions.  A 24-PRB QPSK r
# 0.59 grant's rv 2 is mostly parity: with seed 1 the -10 dB draw leaves
# the combine short and rv 3 passes (the JAX package's own test draw does
# the same), with seed 2 the rv 0 + rv 2 combine passes.
HARQ_LIFECYCLES = {1: ((0, False), (2, False), (3, True)), 2: ((0, False), (2, True), (0, True))}


@pytest.mark.parametrize("seed", sorted(HARQ_LIFECYCLES))
def test_harq_retransmission_lifecycle(seed):
    """The port's scheduler and UpperPhy (tests/test_scheduler_sim.py's
    lifecycle): slot 0 at -10 dB fails its CRC; the same HARQ process
    retransmits 8 slots later at rv 2 out of the HARQ pool, at 30 dB,
    until the combine passes; the pool releases the buffer on the ACK."""
    s = t_sched.RoundRobinScheduler(t_sched.SchedulerConfig(nof_rb=24, max_ues_per_slot=1))
    ue = s.add_ue(0x20, mcs=8)
    phy = TUpperPhy(TUpperPhyConfig(nof_ports=1, device="cpu"))
    rng, gen = np.random.default_rng(1), torch.Generator().manual_seed(seed)
    hist, harq_ids = [], set()
    for i, snr in enumerate((-10.0, 30.0, 30.0)):
        dl, tx, ul, grants = s.run_slot(TSlot.from_sfn_slot(TScs.KHZ30, 0, (i * 8) % 20), rng)
        harq_ids.add(grants[0][1])
        pdu = ul.pusch[0]
        assert pdu.new_data == (not hist or hist[-1][1])
        if not pdu.new_data:
            assert phy.harq_pool.get(0x20, pdu.harq_id) is not None
        rx, _, _ = t_chem.apply_channel(phy.process_dl_tti(dl, tx), gen,
                                        t_chem.ChannelConfig(profile="single", sinr_db=snr,
                                                             nof_sc=624))
        res = phy.process_ul_tti(ul, rx)
        hist.append((pdu.config.rv, res.crc[0].tb_crc_ok))
        s.handle_results(res)
    assert tuple(hist) == HARQ_LIFECYCLES[seed]
    assert harq_ids == {0} and ue.ul_bits_ok > 0
    assert phy.harq_pool.get(0x20, 0) is None  # released on the ACK


def test_grant_configs_stay_bounded():
    """Over 400 slots with NACKs and a link adaptor moving the MCS, the
    grants' configs (which key the host plans: crb_start = first_rb and
    the rv) number at most the PRB offsets x 4 rvs x the MCSs used, DL and
    UL; and over 12 slots through the port's UpperPhy, with NACKs cycling
    the rvs, its plan caches hold no more entries than those slots'
    configs."""
    def sched(la: bool):
        s = t_sched.RoundRobinScheduler(t_sched.SchedulerConfig(nof_rb=24, nof_grid_sc=288,
                                                                max_ues_per_slot=2))
        for i in range(3):
            s.add_ue(0xA00 + i, mcs=6 + 5 * i)
        if la:
            s.link_adaptor = t_la.LinkAdaptor()
            s.csi_report_cfg = t_csi.CsiReportConfig(nof_csi_rs_ports=1)
        return s

    def bounded(s, slots, on_slot):
        configs, offsets, mcss, rvs = set(), set(), set(), set()
        for k in slots:
            mcss.update(u.mcs for u in s.ues.values())
            dl, tx, ul, _ = s.run_slot(slot_point(T, k), rng)
            for p in list(dl.pdsch) + list(ul.pusch):
                configs.add(p.config)
                offsets.add(p.first_rb)
                rvs.add(p.config.rv)
                assert p.config.alloc.crb_start == p.first_rb
            res = on_slot(k, dl, tx, ul)
            s.handle_results(res)
        assert len(configs) <= 2 * len(offsets) * 4 * len(mcss)  # DL and UL
        return configs, offsets, mcss, rvs

    def csi(k, dl, tx, ul):
        res = indications(T, ul, k)
        if k % 4 == 1:
            res.uci = [t_fapi.UciIndicationPdu(r, t_csi.pack_part1(la_sched.csi_report_cfg, 0, 1,
                                                                   (k // 4 + r) % 10 + 3),
                                               True, 1.0) for r in la_sched.ues]
        return res

    rng = np.random.default_rng(0)
    la_sched = sched(la=True)
    _, offsets, mcss, rvs = bounded(la_sched, range(400), csi)
    assert len(offsets) == 2 and len(mcss) > 3 and {0, 2, 3} <= rvs

    caches = [t_pusch._estimate_constants, t_pdsch._scatter_plan, t_pdsch._multi_dmrs_bank,
              t_pusch._multi_pilot_bank]
    for c in caches:
        c.cache_clear()
    phy = TUpperPhy(TUpperPhyConfig(nof_ports=1, nof_grid_sc=288, device="cpu"))
    gen = torch.Generator().manual_seed(0)
    ch = t_chem.ChannelConfig(profile="single", sinr_db=30.0, nof_sc=288)

    def through_phy(k, dl, tx, ul):
        rx, _, _ = t_chem.apply_channel(phy.process_dl_tti(dl, tx), gen, ch)
        assert all(c.tb_crc_ok for c in phy.process_ul_tti(ul, rx).crc)
        return indications(T, ul, k)  # NACKs from the synthetic indications

    configs, _, _, rvs = bounded(sched(la=False), range(12), through_phy)
    assert len(rvs) > 1
    for c in caches:
        assert c.cache_info().currsize <= len(configs), (c, c.cache_info(), len(configs))
    assert sum(c.cache_info().currsize for c in caches) > 0


def test_retransmission_after_an_mcs_change_kept_for_parity():
    """Kept for parity (ROADMAP Q3): a retransmission takes the UE's
    current MCS for its config but the first transmission's TB, so after a
    link-adaptation MCS change both packages emit a PDSCH PDU whose TB is
    shorter than its config's TBS, and both UpperPhys refuse it."""
    got = []
    for m, phy in ((J, JUpperPhy(JUpperPhyConfig(nof_ports=1, nof_grid_sc=288))),
                   (T, TUpperPhy(TUpperPhyConfig(nof_ports=1, nof_grid_sc=288, device="cpu")))):
        s = m.sched.RoundRobinScheduler(m.sched.SchedulerConfig(nof_rb=24, nof_grid_sc=288,
                                                                max_ues_per_slot=1))
        ue = s.add_ue(0x30, mcs=6)
        rng = np.random.default_rng(0)
        _, _, ul, _ = s.run_slot(slot_point(m, 0), rng)
        s.handle_results(m.fapi.SlotResults(slot=ul.slot,
                                            crc=[m.fapi.CrcIndicationPdu(0x30, 0, False)]))
        ue.mcs = 12  # as a CSI report through the link adaptor sets it
        out = s.run_slot(slot_point(m, 8), rng)
        got.append(out)
        dl, tx, ul, _ = out
        assert not ul.pusch[0].new_data
        assert (dl.pdsch[0].config.tbs, len(tx.payloads[0])) == (5376, 2792)
        with pytest.raises((AssertionError, IndexError)):  # the LDPC encoder's shapes
            phy.process_dl_tti(dl, tx)
    assert_same_slot(*got, "retransmission after an MCS change")


def test_allocated_dci_coreset_repaired():
    """Repaired, not copied (ROADMAP Q3): with the PDCCH allocator and
    DCI 1_0 on, the reference's PDCCH PDU describes a 1-symbol CORESET of
    4 CCEs while the allocator placed the DCI in its 2-symbol CORESET of
    8, so the reference's UpperPhy fails on a DCI at CCE 4 or above; the
    port's PDU carries the allocator's CORESET, its UpperPhy encodes every
    DCI, and each decodes back from the grid with its bits.  (The
    allocator's CORESET takes symbols 0 and 1, so the PDSCH starts at 2.)"""
    from srsran_project_tpu_torch.phy import pdcch as t_pdcch

    kw = dict(nof_rb=52, max_ues_per_slot=4, use_pdcch_alloc=True, emit_dci=True, sym_start=2)
    js, ts = j_sched.RoundRobinScheduler(j_sched.SchedulerConfig(**kw)), \
        t_sched.RoundRobinScheduler(t_sched.SchedulerConfig(**kw))
    for s in (js, ts):
        for i in range(8):
            s.add_ue(0xB00 + i, mcs=20)
    jphy = JUpperPhy(JUpperPhyConfig(nof_ports=1))
    tphy = TUpperPhy(TUpperPhyConfig(nof_ports=1, device="cpu"))
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    high = 0
    for k in range(3):
        ref, port = js.run_slot(slot_point(J, k), jrng), ts.run_slot(slot_point(T, k), trng)
        assert_same_slot(ref, port, f"slot {k}", ts.coresets)
        (jdl, jtx, _, _), (tdl, ttx, _, _) = ref, port
        grid = tphy.process_dl_tti(tdl, ttx)
        for pdu in tdl.pdcch:
            assert (pdu.config.duration, pdu.config.nof_regs // 6) == (2, 8)
            bits, ok = t_pdcch.receive(grid[0], pdu.rnti, pdu.config)
            assert bool(ok) and np.array_equal(to_np(bits), pdu.payload)
        if any(p.config.cce_index >= 4 for p in tdl.pdcch):
            high += 1
            with pytest.raises(IndexError):
                jphy.process_dl_tti(jdl, jtx)
    assert high == 2


def test_unallocated_dci_kept_for_parity():
    """Kept for parity (ROADMAP Q3): DCI 1_0 without the PDCCH allocator
    places grant i's DCI at CCE 4i, aggregation level 4, in a 1-symbol
    CORESET of 24 RBs (4 CCEs), so with two or more grants both packages'
    UpperPhys fail on the second DCI."""
    got = []
    for m, phy in ((J, JUpperPhy(JUpperPhyConfig(nof_ports=1))),
                   (T, TUpperPhy(TUpperPhyConfig(nof_ports=1, device="cpu")))):
        s = m.sched.RoundRobinScheduler(m.sched.SchedulerConfig(max_ues_per_slot=2,
                                                                emit_dci=True))
        for i in range(2):
            s.add_ue(0xC00 + i)
        out = s.run_slot(slot_point(m, 0), np.random.default_rng(0))
        got.append(out)
        dl, tx = out[0], out[1]
        assert [(p.config.cce_index, p.config.aggregation_level, p.config.nof_regs // 6)
                for p in dl.pdcch] == [(0, 4, 4), (4, 4, 4)]
        with pytest.raises(IndexError):
            phy.process_dl_tti(dl, tx)
    assert_same_slot(*got, "DCI without the allocator")
