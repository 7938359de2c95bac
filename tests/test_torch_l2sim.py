"""The port's copies of the scheduler's building blocks against the JAX
package's: ``ran/{tdd,dci,precoding}``, link adaptation, power control,
the SRS slot wheel, the UE-context loops (TA, DRX, measurement gaps, SRS
channel state) and the PDCCH, PUCCH and UCI allocators.

Each test runs one sequence of calls on a namespace of modules, once with
the JAX package's and once with the port's, records every result as plain
data (dataclasses as their class name and fields, arrays with their dtype)
and asserts the two records equal exactly: every module here is integer
or numpy host code, so the tolerance is zero.  The allocator sequences
are those of ``tests/test_scheduler_adversarial.py`` and
``tests/test_scheduler_engines.py``."""

import json
import os
import types

import numpy as np
import pytest
from torch_parity import plain

from srsran_project_tpu.l2sim import link_adaptation as j_la
from srsran_project_tpu.l2sim import pdcch_alloc as j_pa
from srsran_project_tpu.l2sim import power_control as j_pc
from srsran_project_tpu.l2sim import pucch_alloc as j_pua
from srsran_project_tpu.l2sim import srs_alloc as j_srs
from srsran_project_tpu.l2sim import uci_alloc as j_ua
from srsran_project_tpu.l2sim import ue_context_loops as j_ucl
from srsran_project_tpu.ran import dci as j_dci
from srsran_project_tpu.ran import precoding as j_prec
from srsran_project_tpu.ran import tdd as j_tdd
from srsran_project_tpu_torch.l2sim import link_adaptation as t_la
from srsran_project_tpu_torch.l2sim import pdcch_alloc as t_pa
from srsran_project_tpu_torch.l2sim import power_control as t_pc
from srsran_project_tpu_torch.l2sim import pucch_alloc as t_pua
from srsran_project_tpu_torch.l2sim import srs_alloc as t_srs
from srsran_project_tpu_torch.l2sim import uci_alloc as t_ua
from srsran_project_tpu_torch.l2sim import ue_context_loops as t_ucl
from srsran_project_tpu_torch.ran import dci as t_dci
from srsran_project_tpu_torch.ran import precoding as t_prec
from srsran_project_tpu_torch.ran import tdd as t_tdd

J = types.SimpleNamespace(tdd=j_tdd, dci=j_dci, prec=j_prec, la=j_la, pc=j_pc, srs=j_srs,
                          ucl=j_ucl, pa=j_pa, pua=j_pua, ua=j_ua)
T = types.SimpleNamespace(tdd=t_tdd, dci=t_dci, prec=t_prec, la=t_la, pc=t_pc, srs=t_srs,
                          ucl=t_ucl, pa=t_pa, pua=t_pua, ua=t_ua)


def same(run):
    """run(J) and run(T) record the same plain data; returns it."""
    ref, port = plain(run(J)), plain(run(T))
    assert port == ref
    return ref


# ---- ran/tdd, ran/dci, ran/precoding ------------------------------------------

TDD_PATTERNS = [dict(), dict(period_slots=5, nof_dl_slots=3, nof_ul_slots=1),
                dict(period_slots=4, nof_dl_slots=2, nof_ul_slots=2, nof_dl_symbols=10,
                     nof_ul_symbols=2), dict(period_slots=20, nof_dl_slots=7, nof_ul_slots=12)]


@pytest.mark.parametrize("kw", TDD_PATTERNS)
def test_tdd_pattern(kw):
    def run(m):
        p = m.tdd.TddPattern(**kw)
        return [p, p.has_special_slot,
                [(p.direction(n), [p.is_dl_symbol(n, s) for s in range(14)],
                  [p.is_ul_symbol(n, s) for s in range(14)], p.is_ul_symbol(n, 3, 12))
                 for n in range(45)]]

    same(run)
    ref = j_tdd.TddPattern(**kw)
    assert t_tdd.TddPattern.from_reference(ref) == t_tdd.TddPattern(**kw)


def test_tdd_named_pattern_and_bad_pattern():
    assert t_tdd.TddPattern.from_reference(j_tdd.PATTERN_7D2U) == t_tdd.PATTERN_7D2U
    assert [d.value for d in map(t_tdd.PATTERN_7D2U.direction, range(10))] == \
        ["dl"] * 7 + ["special"] + ["ul"] * 2
    for m in (j_tdd, t_tdd):
        with pytest.raises(ValueError):
            m.TddPattern(period_slots=5, nof_dl_slots=4, nof_ul_slots=2)


@pytest.mark.parametrize("bwp", [6, 24, 52, 106, 273])
def test_dci_packing(bwp):
    """RIV both ways over every (start, count) of the BWP (a stride on the
    wide ones), DCI 1_0 and 0_0 packed, unpacked and size-aligned."""
    step = 1 if bwp <= 52 else 7

    def run(m):
        out = []
        for start in range(0, bwp, step):
            for count in range(1, bwp - start + 1, step):
                riv = m.dci.riv_encode(start, count, bwp)
                out.append((riv, m.dci.riv_decode(riv, bwp)))
        out.append(m.dci.dci_1_0_size(bwp))
        rng = np.random.default_rng(bwp)
        for _ in range(20):
            start = int(rng.integers(0, bwp))
            count = int(rng.integers(1, bwp - start + 1))
            d10 = m.dci.Dci10(rb_start=start, rb_count=count, mcs=int(rng.integers(0, 32)),
                              new_data=bool(rng.integers(0, 2)), rv=int(rng.integers(0, 4)),
                              harq_id=int(rng.integers(0, 16)), dai=int(rng.integers(0, 4)),
                              tpc=int(rng.integers(0, 4)),
                              pucch_resource=int(rng.integers(0, 8)),
                              harq_feedback_timing=int(rng.integers(0, 8)))
            bits = m.dci.pack_dci_1_0(d10, bwp)
            d00 = m.dci.Dci00(rb_start=start, rb_count=count, mcs=int(rng.integers(0, 32)),
                              rv=int(rng.integers(0, 4)), harq_id=int(rng.integers(0, 16)),
                              tpc=int(rng.integers(0, 4)))
            b00 = m.dci.pack_dci_0_0(d00, bwp)
            short = m.dci.pack_dci_0_0(d00, bwp, target_size=len(b00) - 2)
            out.append((bits, m.dci.unpack_dci_1_0(bits, bwp), b00,
                        m.dci.unpack_dci_0_0(b00, bwp), short,
                        m.dci.pack_dci_0_0(d00, bwp, target_size=len(b00) + 5)))
        return out

    same(run)


def _channels(seed: int, nrx: int, ntx: int, n: int = 4):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((nrx, ntx)) + 1j * rng.standard_normal((nrx, ntx))) / np.sqrt(2)
            for _ in range(n)]


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_precoding(ports):
    """Every PMI's weights at every rank, and the UE-side rank and PMI
    search on random channels."""
    def run(m):
        out = []
        for rank in range(1, ports + 1):
            for fields in m.prec.enumerate_pmis(ports, rank):
                out.append((rank, fields, m.prec.pmi_to_weights(ports, rank, fields)))
        for nrx in (1, 2, 4):
            for h in _channels(ports * 10 + nrx, nrx, ports):
                out.append(m.prec.select_rank_and_pmi(h, ports))
                out.append(m.prec.select_rank_and_pmi(h, ports, max_rank=2))
                out.append(m.prec.select_pmi(h, ports, 1))
        return out

    same(run)


# ---- link adaptation, power control, SRS wheel ---------------------------------

def test_link_adaptation():
    def run(m):
        out = [[m.la.cqi_to_mcs(c, t) for c in range(-1, 17)] for t in ("qam64", "qam256")]
        out.append([m.la.ul_mcs_from_snr(s, t, margin) for s in np.arange(-10.0, 40.0, 0.7)
                    for t in ("qam64", "qam256") for margin in (0.0, 2.0)])
        la = m.la.LinkAdaptor(target_bler=0.1, step_db=0.5, max_offset_db=3.0)
        rng = np.random.default_rng(7)
        for k in range(200):
            rnti = 0x100 + k % 3
            if k % 5 == 0:
                la.handle_csi(rnti, int(rng.integers(0, 16)))
            la.handle_crc(rnti, bool(rng.random() < 0.8))
            out.append((la.select_mcs(rnti, fallback=k % 7), la.olla.get(rnti)))
        out.append(m.la.LinkAdaptor("qam256").select_mcs(1))
        return out

    same(run)


@pytest.mark.parametrize("pucch", [False, True])
def test_power_control(pucch):
    def run(m):
        pc = (m.pc.PucchPowerController() if pucch
              else m.pc.PuschPowerController(m.pc.PowerControlConfig(prohibit_slots=7)))
        rng = np.random.default_rng(3)
        out = [pc.cfg]
        for slot in range(300):
            rnti = 0x10 + slot % 2
            if slot % 3 == 0:
                pc.handle_pusch_snr(rnti, slot, float(rng.uniform(-5, 35)))
            if slot % 40 == 0:
                pc.handle_phr(rnti, float(rng.uniform(-10, 10)))
            out.append((pc.compute_tpc(rnti, slot), pc.closed_loop_db(rnti),
                        pc.adapt_prbs_to_phr(rnti, 1 + slot % 100)))
        out.append(pc.ues)
        return out

    same(run)


def test_srs_wheel():
    def run(m):
        s = m.srs.SrsScheduler()
        out = [m.srs.SRS_PERIODS]
        for i in range(5):
            out.append(s.add_ue(0x4601 + i))
        out.append(s.add_ue(0x5000, m.srs.SrsResourceConfig(period_slots=5, offset_slots=3,
                                                            nof_symbols=2, comb=4)))
        s.rem_ue(0x4602)
        out.append([s.due(n) for n in range(45)])
        for bad in (dict(period_slots=3), dict(period_slots=10, offset_slots=10)):
            with pytest.raises(AssertionError):
                m.srs.SrsResourceConfig(**bad)
        return out

    same(run)


# ---- UE-context loops --------------------------------------------------------

@pytest.mark.parametrize("prohibit", [0, 30])
def test_ta_manager(prohibit):
    def run(m):
        cfg = m.ucl.TaManagerConfig(measurement_period=20, prohibit_period=prohibit,
                                    cmd_offset_threshold=2, sinr_threshold_db=3.0, target=0.5)
        ta = m.ucl.TaManager(cfg, mu=1)
        rng = np.random.default_rng(prohibit)
        out = []
        for slot in range(200):
            out.append((ta.slot_indication(slot), ta.state))
            for _ in range(int(rng.integers(0, 3))):
                if rng.random() < 0.5:
                    ta.handle_ta_seconds(float(rng.normal(0.4e-6, 0.2e-6)),
                                         float(rng.uniform(0, 20)))
                else:
                    ta.handle_ul_n_ta_update(float(rng.normal(-300, 500)),
                                             float(rng.uniform(0, 20)))
            out.append(list(ta.samples))
        return out

    same(run)


DRX_CONFIGS = [dict(), dict(long_cycle_ms=10, long_start_offset_ms=8, on_duration_ms=4,
                            inactivity_ms=0),
               dict(long_cycle_ms=20, long_start_offset_ms=18, on_duration_ms=5,
                    inactivity_ms=3)]


@pytest.mark.parametrize("kw", DRX_CONFIGS)
def test_drx(kw):
    """Active time over 150 slots with new-transmission PDCCHs and SR
    pendings, windows crossing the cycle boundary among them."""
    def run(m):
        drx = m.ucl.DrxController(m.ucl.DrxConfig(**kw), scs_mu=1)
        rng = np.random.default_rng(len(kw))
        out = []
        for slot in range(150):
            drx.sr_pending = slot % 37 == 5
            drx.slot_indication(slot)
            if rng.random() < 0.2:
                drx.on_new_tx_pdcch(slot)
            out.append((drx.is_pdcch_enabled(), drx.active_end))
        off = m.ucl.DrxController(None)
        off.slot_indication(3)
        off.on_new_tx_pdcch(3)
        out.append(off.is_pdcch_enabled())
        return out

    same(run)


@pytest.mark.parametrize("kw", [dict(), dict(mgrp_ms=20, mgl_ms=5.5, gap_offset_ms=17),
                                dict(mgrp_ms=40, mgl_ms=1.5, gap_offset_ms=3)])
def test_meas_gap(kw):
    def run(m):
        g = m.ucl.MeasGapController(m.ucl.MeasGapConfig(**kw), scs_mu=1)
        return ([(g.in_gap(n), g.is_schedulable(n)) for n in range(200)],
                m.ucl.MeasGapController(None).is_schedulable(4))

    same(run)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4)])
def test_srs_channel_state(shape):
    def run(m):
        out = []
        for max_rank in (1, 2, 4):
            st = m.ucl.SrsChannelState(max_rank=max_rank)
            for h in _channels(shape[0] * 7 + shape[1], *shape, n=3):
                st.update_srs_channel_matrix(h)
                out.append((st.wideband_snr_db, st.tpmi, st.rank,
                            getattr(st, "pmi_fields", None)))
            st.update_srs_channel_matrix(np.zeros(shape))
            out.append(st.wideband_snr_db)
        return out

    same(run)


# ---- PDCCH, PUCCH and UCI allocators -------------------------------------------

def test_pdcch_candidates():
    """The candidates' lowest CCEs over a grid of (AL, candidates, CORESET
    size, search space kind, CORESET id, RNTI, slot), and the reference's
    golden cases where they are present."""
    def run(m):
        m.pa.candidates_lowest_cce.cache_clear()
        return [m.pa.candidates_lowest_cce(al, nc, ncce, common, cs, rnti, slot)
                for al in m.pa.AGGREGATION_LEVELS for nc in (0, 1, 2, 4)
                for ncce in (2, 8, 16, 48) for common in (True, False) for cs in (0, 1, 2)
                for rnti in (0x4601, 0xFFFF) for slot in (0, 7, 19)]

    same(run)
    path = os.path.join(os.path.dirname(__file__), "golden", "pdcch_candidates",
                        "manifest.json")
    if os.path.exists(path):
        for case in json.load(open(path)):
            ref = tuple(int(x) for x in case["candidates"].split(",") if x != "")
            assert t_pa.candidates_lowest_cce(
                case["al"], case["nof_candidates"], case["nof_cces"],
                is_common=case["kind"] == "common", coreset_id=case.get("coreset_id", 0),
                rnti=case.get("rnti", 0), slot_index=case.get("slot_index", 0)) == ref, case


def test_pdcch_exhaustion_sequence():
    """test_scheduler_adversarial's exhaustion: 50 RNTIs at every AL into a
    24-RB CORESET, ten slots."""
    def run(m):
        coresets = {1: m.pa.CoresetConfig(id=1, rb_start=0, nof_rbs=24, duration=2)}
        sss = {2: m.pa.SearchSpaceConfig(id=2, coreset_id=1, is_common=False,
                                         nof_candidates=(4, 4, 2, 1, 0))}
        out = []
        for slot_index in range(10):
            alloc = m.pa.PdcchSlotAllocator(coresets, sss)
            for rnti in range(0x100, 0x100 + 50):
                for al in (8, 4, 2, 1):
                    out.append(alloc.alloc_dci(rnti, 2, al, slot_index=slot_index))
            out.append((alloc.nof_used_cces(1), alloc.grants))
        return out

    same(run)


def test_pdcch_allocation_and_cancel_sequence():
    """test_scheduler_engines' allocation, collision and cancel sequence on
    an 8-CCE CORESET, and the hashing across slots and RNTIs."""
    def run(m):
        coresets = {1: m.pa.CoresetConfig(id=1, rb_start=0, nof_rbs=48, duration=1)}
        sss = {1: m.pa.SearchSpaceConfig(id=1, coreset_id=1, is_common=True,
                                         nof_candidates=(0, 0, 2, 1, 0)),
               2: m.pa.SearchSpaceConfig(id=2, coreset_id=1, is_common=False,
                                         nof_candidates=(0, 4, 2, 1, 0))}
        alloc = m.pa.PdcchSlotAllocator(coresets, sss)
        out = [coresets[1].nof_cces, sss[2].candidates_for(2)]
        g1 = alloc.alloc_dci(0x4601, 1, 8)
        out += [g1, alloc.alloc_dci(0x4602, 1, 4), alloc.alloc_dci(0x4603, 2, 2)]
        alloc.cancel(g1)
        out.append(alloc.nof_used_cces(1))
        for rnti, ss, al in ((0x4601, 1, 4), (0x4602, 1, 4), (0x4603, 1, 4), (0x4604, 2, 2),
                             (0x4605, 2, 1)):
            out.append(alloc.alloc_dci(rnti, ss, al, slot_index=3))
        out.append((alloc.nof_used_cces(1), alloc.grants))
        big = {1: m.pa.CoresetConfig(id=1, rb_start=0, nof_rbs=48, duration=1)}
        ue_ss = {2: m.pa.SearchSpaceConfig(id=2, coreset_id=1, is_common=False,
                                           nof_candidates=(0, 0, 2, 0, 0))}
        for slot_index in range(8):
            out.append(m.pa.PdcchSlotAllocator(big, ue_ss).alloc_dci(0x4601, 2, 4,
                                                                     slot_index=slot_index))
        return out

    same(run)


def test_pucch_f1_capacity_sequence():
    """test_scheduler_adversarial's F1 code-multiplexing fill past capacity."""
    def run(m):
        alloc = m.pua.PucchSlotAllocator(m.pua.default_pucch_cell_config(52))
        return [alloc.alloc_harq_ack(0x200 + i, pri=i % 8, nof_bits=1) for i in range(200)] + \
            [alloc.grants]

    same(run)


def test_pucch_f2_collision_sequence():
    """test_scheduler_adversarial's CSI fill of the F2 resources."""
    def run(m):
        alloc = m.pua.PucchSlotAllocator(m.pua.default_pucch_cell_config(52))
        return [alloc.alloc_csi(0x300 + i, nof_bits=6) for i in range(100)] + [alloc.grants]

    same(run)


@pytest.mark.parametrize("nof_prb", [24, 52, 273])
def test_pucch_engine_sequences(nof_prb):
    """test_scheduler_engines' PUCCH ladders: HARQ growth to F2, code
    multiplexing and its collision, F2 blocking, SR + CSI multiplexing,
    and removal, on one cell resource map."""
    def run(m):
        cfg = m.pua.default_pucch_cell_config(nof_prb)
        out = [cfg, [r.prbs() for r in cfg.set0 + cfg.set1], [r.cells() for r in cfg.set1]]
        al = m.pua.PucchSlotAllocator(cfg)
        out += [al.alloc_harq_ack(0x4601, pri=3) for _ in range(3)]
        out += [al.alloc_harq_ack(0x4602, pri=0), al.alloc_harq_ack(0x4603, pri=1),
                al.alloc_harq_ack(0x4604, pri=3)]
        al = m.pua.PucchSlotAllocator(cfg)
        for i, rnti in enumerate((0x4601, 0x4602, 0x4603, 0x4604)):
            out += [al.alloc_harq_ack(rnti, pri=i) for _ in range(3)]
        out += [al.alloc_harq_ack(0x4605, pri=4) for _ in range(3)]
        al.remove_ue(0x4602)
        out += [al.alloc_csi(0x4606, 4), al.alloc_sr(0x4607), al.grants]
        al = m.pua.PucchSlotAllocator(cfg)
        out += [al.alloc_sr(0x4601), al.alloc_harq_ack(0x4601, pri=2), al.alloc_csi(0x4601, 4),
                al.alloc_sr(0x4601), al.alloc_csi(0x4608, 12), al.alloc_sr(0x4609),
                al.alloc_harq_ack(0x4609, pri=2, nof_bits=2), al.grants]
        out.append(m.pua.PucchGrant(1, cfg.set0[0], 2, True, 3).uci_bits)
        return out

    same(run)


def test_uci_sequences():
    """test_scheduler_engines' UCI-on-PUSCH moves and folds, and the
    periodic SR/CSI opportunities."""
    def run(m):
        cfg = m.pua.default_pucch_cell_config(52)
        al = m.pua.PucchSlotAllocator(cfg)
        uci = m.ua.UciSlotAllocator(al, pusch_rntis={0x4601})
        out = [uci.alloc_harq_ack(0x4601, pri=0), uci.alloc_csi(0x4601, 4),
               uci.alloc_sr(0x4601), uci.alloc_harq_ack(0x4602, pri=1), uci.alloc_sr(0x4603),
               uci.alloc_csi(0x4604, 6), uci.on_pusch, al.grants]
        al = m.pua.PucchSlotAllocator(cfg)
        al.alloc_harq_ack(0x4601, pri=0)
        al.alloc_csi(0x4602, 4)
        uci = m.ua.UciSlotAllocator(al, pusch_rntis={0x4601, 0x4602})
        out += [uci.alloc_harq_ack(0x4601, pri=0, nof_bits=1), uci.alloc_harq_ack(0x4602, 5),
                uci.on_pusch, al.grants]
        for pc in (m.ua.UciPeriodicConfig(), m.ua.UciPeriodicConfig(sr_period_slots=4, sr_offset=1,
                                                                    csi_period_slots=8,
                                                                    csi_offset=7)):
            out.append([m.ua.periodic_uci_opportunities(n, pc) for n in range(41)])
        return out

    same(run)
