"""The port's initial-access modules against the JAX package's: the RA
procedure (``l2sim/ra``), the SRB0/SRB1 fallback scheduler
(``l2sim/fallback``), the SI-window, PF/PO paging and CSI-RS engines
(``l2sim/si_paging``) and the ``CellScheduler`` stages that run them.

Each test runs the JAX package's own test (``tests/test_ra_procedure.py``,
``test_fallback_scheduler.py``, ``test_si_paging.py`` and the fallback
cases of ``test_common_scheduling.py``) on a namespace of modules, once
with the JAX package's and once with the port's, and the two records must
be equal as plain data: all of it is integer and numpy host code, so the
tolerance is zero.  Where a test goes through the PHY, each package runs
its own ``UpperPhy`` on the same numpy input, and the indications must be
equal (CRC verdicts, bits and TA bins exactly).

The slice as a whole (``test_initial_access_through_upper_phy``) is in
``test_torch_access_slot.py``.
"""

import json
import types

import numpy as np
import pytest
import torch
from test_torch_scheduler import assert_same_slot, state
from torch_parity import plain

from srsran_project_tpu.fapi import messages as j_fapi
from srsran_project_tpu.l2 import mac_pdu as j_mac
from srsran_project_tpu.l2sim import common_scheduling as j_cs
from srsran_project_tpu.l2sim import fallback as j_fb
from srsran_project_tpu.l2sim import link_adaptation as j_la
from srsran_project_tpu.l2sim import pdcch_alloc as j_pa
from srsran_project_tpu.l2sim import ra as j_ra
from srsran_project_tpu.l2sim import scheduler as j_sched
from srsran_project_tpu.l2sim import si_paging as j_sp
from srsran_project_tpu.l2sim import test_mode as j_tm
from srsran_project_tpu.phy import prach as j_prach
from srsran_project_tpu.phy.upper_phy import UpperPhy as JUpperPhy
from srsran_project_tpu.phy.upper_phy import UpperPhyConfig as JUpperPhyConfig
from srsran_project_tpu.ran import csi as j_csi
from srsran_project_tpu.ran import precoding as j_prec
from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
from srsran_project_tpu.ran.slot_point import SlotPoint as JSlot
from srsran_project_tpu_torch.fapi import messages as t_fapi
from srsran_project_tpu_torch.fapi import validators as t_fv
from srsran_project_tpu_torch.l2 import mac_pdu as t_mac
from srsran_project_tpu_torch.l2sim import common_scheduling as t_cs
from srsran_project_tpu_torch.l2sim import fallback as t_fb
from srsran_project_tpu_torch.l2sim import link_adaptation as t_la
from srsran_project_tpu_torch.l2sim import pdcch_alloc as t_pa
from srsran_project_tpu_torch.l2sim import ra as t_ra
from srsran_project_tpu_torch.l2sim import scheduler as t_sched
from srsran_project_tpu_torch.l2sim import si_paging as t_sp
from srsran_project_tpu_torch.l2sim import test_mode as t_tm
from srsran_project_tpu_torch.phy import prach as t_prach
from srsran_project_tpu_torch.phy.upper_phy import UpperPhy as TUpperPhy
from srsran_project_tpu_torch.phy.upper_phy import UpperPhyConfig as TUpperPhyConfig
from srsran_project_tpu_torch.ran import csi as t_csi
from srsran_project_tpu_torch.ran import precoding as t_prec
from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing as TScs
from srsran_project_tpu_torch.ran.slot_point import SlotPoint as TSlot

J = types.SimpleNamespace(fapi=j_fapi, mac=j_mac, cs=j_cs, fb=j_fb, la=j_la, pa=j_pa, ra=j_ra,
                          sched=j_sched, sp=j_sp, tm=j_tm, prach=j_prach, csi=j_csi, prec=j_prec,
                          Slot=JSlot, Scs=JScs)
T = types.SimpleNamespace(fapi=t_fapi, mac=t_mac, cs=t_cs, fb=t_fb, la=t_la, pa=t_pa, ra=t_ra,
                          sched=t_sched, sp=t_sp, tm=t_tm, prach=t_prach, csi=t_csi, prec=t_prec,
                          Slot=TSlot, Scs=TScs)


def same(run):
    """run(J) and run(T) record the same plain data; returns it."""
    ref, port = plain(run(J)), plain(run(T))
    assert port == ref
    return ref


def _slot(m, i):
    return m.Slot.from_sfn_slot(m.Scs.KHZ30, (i // 20) % 1024, i % 20)


def _ul_both(req_j, req_t, grid, prach_fd=None):
    """One UL_TTI through both packages' UpperPhy (one port) on the same
    numpy grid and PRACH buffer: (JAX results, port results)."""
    import jax.numpy as jnp

    jphy, tphy = JUpperPhy(JUpperPhyConfig(nof_ports=1)), TUpperPhy(
        TUpperPhyConfig(nof_ports=1, device="cpu"))
    jres = jphy.process_ul_tti(req_j, jnp.asarray(grid),
                               prach_fd=None if prach_fd is None else jnp.asarray(prach_fd))
    tres = tphy.process_ul_tti(req_t, torch.from_numpy(grid),
                               prach_fd=None if prach_fd is None else torch.from_numpy(prach_fd))
    return jres, tres


# ---- l2sim/ra ------------------------------------------------------------------------

def test_four_step_ra_through_phy():
    """tests/test_ra_procedure.py::test_four_step_ra_through_phy in both
    packages: the preamble through each package's UpperPhy (one RACH
    indication, preamble 23, the same TA bin, the metric within 1e-5
    relative), then Msg2's RAR TB, Msg3
    and Msg4 bitwise equal, and the RA contexts equal at every step."""
    fd = t_prach.generate_preamble(t_prach.PrachConfig(l_ra=839, zero_correlation_zone=1), 23,
                                   device="cpu").numpy()[None]
    reqs = {id(m): m.fapi.UlTtiRequest(slot=_slot(m, 0), prach=[m.fapi.UlPrachPdu(
        m.prach.PrachConfig(l_ra=839, zero_correlation_zone=1))]) for m in (J, T)}
    jres, tres = _ul_both(reqs[id(J)], reqs[id(T)], np.zeros((1, 14, 624), np.complex64), fd)
    results = {id(J): jres, id(T): tres}

    def run(m):
        res = results[id(m)]
        ra = m.ra.RaManager()
        assert len(res.rach) == 1 and res.rach[0].preamble_index == 23
        ctx = ra.handle_rach_indication(0, res.rach[0])
        assert ctx.tc_rnti == 0x4601
        rar_tb = ra.build_rar_tb(slot_count=2, tbs_bits=256)
        assert rar_tb is not None
        backoff, grants = m.mac.decode_rar_pdu(np.packbits(rar_tb).tobytes())
        assert backoff is None and grants[0].rapid == 23
        assert grants[0].tc_rnti == 0x4601 and grants[0].ta == ctx.ta_cmd
        ue_id = bytes.fromhex("a1b2c3d4e5f6")
        msg3 = m.mac.encode_mac_pdu([m.mac.MacSubPdu(int(m.mac.UlLcid.CCCH48), ue_id)],
                                    tb_size=32, uplink=True)
        got = ra.handle_msg3(4, np.unpackbits(np.frombuffer(msg3, np.uint8)))
        assert got is ctx and ctx.state == "msg3_received"
        subpdus = ra.build_msg4_subpdus(ctx)
        msg4 = m.mac.encode_mac_pdu(subpdus, tb_size=16)
        rx = m.mac.decode_mac_pdu(msg4)
        assert rx[0].lcid == int(m.mac.DlLcid.CON_RES_ID) and rx[0].payload == ue_id
        assert ra.resolved == [ctx] and not ra.pending
        return ([(r.preamble_index, r.ta_samples) for r in res.rach], rar_tb, msg3, msg4, ctx,
                vars(ra))

    same(run)
    # The detection metric: float32 FFTs round differently (1e-5 relative).
    assert abs(tres.rach[0].metric - jres.rach[0].metric) <= 1e-5 * abs(jres.rach[0].metric)


def test_ra_window_expiry():
    """tests/test_ra_procedure.py::test_ra_window_expiry in both packages,
    and the context expires exactly when the window has passed."""
    def run(m):
        ra = m.ra.RaManager()
        ra.handle_rach_indication(0, m.fapi.RachIndicationPdu(preamble_index=5, metric=10.0,
                                                              ta_samples=32.0))
        assert ra.build_rar_tb(1, 128) is not None
        assert ra.build_rar_tb(2, 128) is None  # nothing new to answer
        kept = []
        for slot in (5, 11):
            ra.expire(slot)
            kept.append(sorted(ra.pending))
        ra.expire(20)  # Msg3 never arrived
        assert not ra.pending
        return kept

    assert same(run) == [[5], [5]]


@pytest.mark.parametrize("ta_samples", [100.0, 0.0, 7.9, 8.0, 24.0, -40.0, 1007.0, 1009.0, 5000.0])
def test_ta_command_quantization(ta_samples):
    """tests/test_ra_procedure.py::test_ta_command_quantization in both
    packages, over the clip: a TA command is round(TA / 16) clipped to
    0..63 (the reference's, kept for parity)."""
    def run(m):
        ra = m.ra.RaManager()
        ctx = ra.handle_rach_indication(0, m.fapi.RachIndicationPdu(
            preamble_index=1, metric=9.0, ta_samples=ta_samples))
        return ctx.ta_cmd

    assert same(run) == max(0, min(63, round(ta_samples / 16)))


def test_msg3_matches_the_oldest_context_kept_for_parity():
    """Two preambles answered in one RAR; Msg3 carries no TC-RNTI, and
    ``handle_msg3`` gives it to the oldest context that got its RAR,
    whichever UE sent it (the reference's single-preamble shortcut,
    ``ra.py:79-85``, kept for parity; ROADMAP Q3).  Both packages agree;
    the second Msg3 goes to the second context, a third finds none."""
    def run(m):
        ra = m.ra.RaManager()
        first = ra.handle_rach_indication(0, m.fapi.RachIndicationPdu(5, 9.0, 2000.0))
        second = ra.handle_rach_indication(0, m.fapi.RachIndicationPdu(9, 9.0, 40.0))
        assert (first.ta_cmd, second.ta_cmd) == (63, 2)  # 2000 / 16 clipped to 63
        backoff, grants = m.mac.decode_rar_pdu(np.packbits(ra.build_rar_tb(1, 256)).tobytes())
        assert [(g.rapid, g.tc_rnti) for g in grants] == [(5, 0x4601), (9, 0x4602)]

        def msg3(ident):
            pdu = m.mac.encode_mac_pdu([m.mac.MacSubPdu(int(m.mac.UlLcid.CCCH48), ident)],
                                       tb_size=16, uplink=True)
            return np.unpackbits(np.frombuffer(pdu, np.uint8))

        # The UE of preamble 9 (TC-RNTI 0x4602) sends its Msg3 first.
        got = ra.handle_msg3(4, msg3(b"second"))
        assert got is first and first.ccch == b"second"
        assert ra.handle_msg3(5, msg3(b"firsts")) is second
        assert ra.handle_msg3(6, msg3(b"thirds")) is None
        no_ccch = m.mac.encode_mac_pdu([m.mac.MacSubPdu(int(m.mac.UlLcid.CRNTI), b"\x46\x01")],
                                       tb_size=8, uplink=True)
        assert ra.handle_msg3(7, np.unpackbits(np.frombuffer(no_ccch, np.uint8))) is None
        return vars(ra)

    same(run)


# ---- l2sim/fallback ------------------------------------------------------------------

def _fallback(m, nof_candidates=(0, 0, 2, 2, 0)):
    coresets = {0: m.pa.CoresetConfig(id=0, rb_start=0, nof_rbs=48, duration=1)}
    sss = {0: m.pa.SearchSpaceConfig(id=0, coreset_id=0, is_common=True,
                                     nof_candidates=nof_candidates)}
    return m.fb.FallbackScheduler(coresets, sss, nof_rb=52)


def test_srb0_carries_conres_ce_then_acks():
    """tests/test_fallback_scheduler.py's first case in both packages."""
    def run(m):
        fb = _fallback(m)
        ccch = bytes(range(6))
        fb.add_ue(0x4601, conres_id=ccch)
        rrc_setup = b"\x20" * 40
        fb.handle_dl_buffer_state(0x4601, rrc_setup, is_srb0=True)
        grants = fb.run_slot(0)
        assert len(grants) == 1
        g = grants[0]
        assert g.is_srb0 and not g.is_retx
        assert g.payload[:6] == m.mac.ce_con_res_id(ccch) and g.payload[6:] == rrc_setup
        assert fb.run_slot(1) == []
        fb.handle_ack(0x4601, g.harq_id, ack=True)
        assert fb.pending(0x4601) == 0
        return grants, fb.ues, fb._free_harqs

    same(run)


def test_nack_triggers_retx_until_budget_exhausted():
    """tests/test_fallback_scheduler.py's HARQ case in both packages."""
    def run(m):
        fb = _fallback(m)
        fb.add_ue(0x4601, conres_id=b"abcdef")
        fb.handle_dl_buffer_state(0x4601, b"\x01" * 20, is_srb0=True)
        g0 = fb.run_slot(0)[0]
        fb.handle_ack(0x4601, g0.harq_id, ack=False)
        g1 = fb.run_slot(1)[0]
        assert g1.is_retx and g1.harq_id == g0.harq_id
        fb.handle_ack(0x4601, g1.harq_id, ack=False)
        g2 = fb.run_slot(2)[0]
        assert g2.is_retx
        fb.handle_ack(0x4601, g2.harq_id, ack=False)
        assert fb.run_slot(3) == []
        assert fb.pending(0x4601) == 0
        return [g0, g1, g2], fb._free_harqs

    same(run)


def test_srb1_after_fallback_exit_is_not_scheduled():
    """tests/test_fallback_scheduler.py's exit case in both packages."""
    def run(m):
        fb = _fallback(m)
        fb.add_ue(0x17, conres_id=None)
        fb.handle_dl_buffer_state(0x17, b"\x02" * 10)  # SRB1
        first = fb.run_slot(0)
        assert len(first) == 1 and first[0].payload == b"\x02" * 10
        fb.exit_fallback(0x17)
        fb.handle_dl_buffer_state(0x17, b"\x03" * 10)
        assert fb.run_slot(1) == []
        fb.handle_dl_buffer_state(0x99, b"\x03")  # unknown UE: ignored
        fb.handle_ack(0x99, 0, True)
        return first, fb.pending(0x17), fb.pending(0x99)

    same(run)


def test_cce_congestion_defers_to_next_slot():
    """tests/test_fallback_scheduler.py's congestion case in both packages:
    the slots each UE got its grant in are equal."""
    def run(m):
        fb = _fallback(m, nof_candidates=(0, 0, 1, 0, 0))
        fb.add_ue(1, conres_id=b"\0" * 6)
        fb.add_ue(2, conres_id=b"\1" * 6)
        fb.handle_dl_buffer_state(1, b"a" * 8, is_srb0=True)
        fb.handle_dl_buffer_state(2, b"b" * 8, is_srb0=True)
        got = {}
        for slot in range(4):
            for g in fb.run_slot(slot):
                got[g.rnti] = (slot, g.cce_index, g.aggregation_level)
                fb.handle_ack(g.rnti, g.harq_id, ack=True)
            if len(got) == 2:
                break
        assert set(got) == {1, 2}
        return got

    same(run)


def test_shared_pdcch_allocator_exposes_cce_usage():
    """tests/test_fallback_scheduler.py's shared-allocator case in both."""
    def run(m):
        fb = _fallback(m)
        fb.add_ue(0x4601, conres_id=b"\0" * 6)
        fb.handle_dl_buffer_state(0x4601, b"x" * 8, is_srb0=True)
        shared = m.pa.PdcchSlotAllocator(fb.coresets, fb.search_spaces)
        grants = fb.run_slot(0, pdcch=shared)
        assert grants and shared.nof_used_cces(0) == grants[0].aggregation_level
        return grants, shared.nof_used_cces(0)

    same(run)


def test_fallback_band_and_harq_under_pressure():
    """tests/test_scheduler_adversarial.py's band-pressure case, extended:
    12 UEs on a 24-PRB band from PRB 6, NACKs and ACKs alternating, for 12
    slots; the grants (PRBs, CCEs, HARQ ids, retransmissions) are equal in
    both packages and never leave [6, 24) or overlap."""
    def run(m):
        fb = m.fb.FallbackScheduler(
            {0: m.pa.CoresetConfig(id=0, rb_start=0, nof_rbs=48, duration=2)},
            {0: m.pa.SearchSpaceConfig(id=0, coreset_id=0, is_common=True,
                                       nof_candidates=(0, 0, 8, 4, 0))},
            nof_rb=24, srb_rb_count=6)
        for i in range(12):
            fb.add_ue(0x500 + i, conres_id=bytes([i] * 6))
            fb.handle_dl_buffer_state(0x500 + i, b"\x11" * 16, is_srb0=True)
            fb.handle_dl_buffer_state(0x500 + i, b"\x22" * 8)
        out = []
        for slot in range(12):
            grants = fb.run_slot(slot, rb_start=6)
            spans = sorted((g.rb_start, g.rb_start + g.rb_count) for g in grants)
            assert all(6 <= a and b <= 24 for a, b in spans)
            assert all(b <= c for (_, b), (c, _) in zip(spans, spans[1:]))
            for k, g in enumerate(grants):
                fb.handle_ack(g.rnti, g.harq_id, ack=(slot + k) % 3 != 0)
            out.append(grants)
        return out, {r: fb.pending(r) for r in fb.ues}

    got = same(run)
    assert sum(len(g) for g in got[0]) > 12


# ---- CellScheduler with the fallback stage ---------------------------------------------

def test_cell_scheduler_runs_fallback_stage():
    """tests/test_common_scheduling.py::test_cell_scheduler_runs_fallback_stage
    in both packages: the SRB0 grant rides the DL_TTI as a PDSCH PDU, the
    requests equal field by field."""
    def build(m):
        fb = m.fb.FallbackScheduler(
            {0: m.pa.CoresetConfig(id=0, rb_start=0, nof_rbs=48, duration=1)},
            {0: m.pa.SearchSpaceConfig(id=0, coreset_id=0, is_common=True)}, nof_rb=52)
        fb.add_ue(0x4601, conres_id=b"abcdef")
        fb.handle_dl_buffer_state(0x4601, b"\x20" * 24, is_srb0=True)
        ue = m.sched.RoundRobinScheduler(m.sched.SchedulerConfig(nof_rb=52, max_ues_per_slot=1))
        return m.cs.CellScheduler(m.cs.CommonSchedulingConfig(nof_rb=52, nof_grid_sc=624), ue,
                                  fallback=fb)

    jc, tc = build(J), build(T)
    ref = jc.run_slot(_slot(J, 23), np.random.default_rng(0))
    port = tc.run_slot(_slot(T, 23), np.random.default_rng(0))
    assert_same_slot(ref, port, "fallback stage")
    assert [p.rnti for p in port[0].pdsch if p.rnti == 0x4601] == [0x4601]
    assert tc.counters == jc.counters and tc.counters["fallback"] == 1
    assert state(tc.fallback) == state(jc.fallback)


def test_fallback_grants_share_the_slot_resource_map():
    """tests/test_common_scheduling.py::test_fallback_grants_share_the_slot_resource_map
    in both packages: the fallback grant takes PRB 0 and the data UE starts
    after it, CCEs from one shared allocator, the merged DL_TTI passes
    the validator, and a SIB1 slot yields the band to the broadcast."""
    def build(m):
        ue = m.sched.RoundRobinScheduler(m.sched.SchedulerConfig(
            nof_rb=52, max_ues_per_slot=1, use_pdcch_alloc=True))
        ue.add_ue(0x10, mcs=20)
        fb = m.fb.FallbackScheduler(ue.coresets, ue.search_spaces, common_ss_id=2, nof_rb=52)
        fb.add_ue(0x4601, conres_id=b"abcdef")
        fb.handle_dl_buffer_state(0x4601, b"\x20" * 24, is_srb0=True)
        return m.cs.CellScheduler(m.cs.CommonSchedulingConfig(
            nof_rb=52, nof_grid_sc=624, sib1_period_slots=16, sib1_slot_offset=1), ue,
            fallback=fb)

    jc, tc = build(J), build(T)
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    ref, port = jc.run_slot(_slot(J, 23), jrng), tc.run_slot(_slot(T, 23), trng)
    assert_same_slot(ref, port, "shared map", tc.ue_scheduler.coresets)
    dl, tx = port[0], port[1]
    assert {0x10, 0x4601} <= {p.rnti for p in dl.pdsch}
    t_fv.validate_dl_tti(dl, tx, 624)
    fb_pdu = next(p for p in dl.pdsch if p.rnti == 0x4601)
    data_pdu = next(p for p in dl.pdsch if p.rnti == 0x10)
    assert fb_pdu.first_rb == 0
    assert data_pdu.first_rb >= fb_pdu.first_rb + fb_pdu.config.alloc.rb_count
    for c in (jc, tc):
        c.fallback.handle_dl_buffer_state(0x4601, b"\x21" * 24, is_srb0=False)
    ref, port = jc.run_slot(_slot(J, 1), jrng), tc.run_slot(_slot(T, 1), trng)
    assert_same_slot(ref, port, "SIB1 slot", tc.ue_scheduler.coresets)
    assert [p.rnti for p in port[0].pdsch] == [t_cs.SI_RNTI]
    t_fv.validate_dl_tti(port[0], port[1], 624)
    assert tc.counters == jc.counters


def test_fallback_pdsch_meets_the_coreset_kept_for_parity():
    """With the PDCCH allocator on, the fallback PDSCH starts at symbol 1
    on PRB 0 (``_bcast_pdsch``), inside the allocator's 2-symbol CORESET
    on symbols 0-1 from PRB 0: the two share the REs of symbol 1 on PRBs
    0-5, in both packages (kept for parity; ROADMAP Q3)."""
    def run(m):
        ue = m.sched.RoundRobinScheduler(m.sched.SchedulerConfig(
            nof_rb=52, max_ues_per_slot=2, use_pdcch_alloc=True, emit_dci=True, sym_start=2))
        for rnti in (0x10, 0x11):
            ue.add_ue(rnti, mcs=20)
        fb = m.fb.FallbackScheduler(ue.coresets, ue.search_spaces, common_ss_id=2, nof_rb=52)
        fb.add_ue(0x4601, conres_id=b"abcdef")
        fb.handle_dl_buffer_state(0x4601, b"\x20" * 24, is_srb0=True)
        cell = m.cs.CellScheduler(m.cs.CommonSchedulingConfig(nof_rb=52, nof_grid_sc=624), ue,
                                  fallback=fb)
        dl, _tx, _ul, _ = cell.run_slot(_slot(m, 23), np.random.default_rng(0))
        fb_alloc = next(p for p in dl.pdsch if p.rnti == 0x4601).config.alloc
        cs = ue.coresets[1]
        return ((fb_alloc.sym_start, fb_alloc.rb_count), (cs.rb_start, cs.nof_rbs, cs.duration),
                sorted(p.rnti for p in dl.pdcch))

    (sym, nof_rb), (cs_rb0, cs_rbs, duration), dcis = same(run)
    assert sym == 1 and duration == 2 and cs_rb0 == 0 and nof_rb <= cs_rbs
    assert dcis == [0x10, 0x11]  # the data UEs' DCIs ride the same CORESET


# ---- l2sim/si_paging -----------------------------------------------------------------

def test_si_windows_follow_ts38331_math():
    """tests/test_si_paging.py::test_si_windows_follow_ts38331_math in both."""
    def run(m):
        cfg = m.sp.SiSchedulerConfig(si_window_len_slots=5, messages=(
            m.sp.SiMessageConfig(period_radio_frames=8, payload=b"SIB2"),
            m.sp.SiMessageConfig(period_radio_frames=16, payload=b"SIB3"),
            m.sp.SiMessageConfig(period_radio_frames=8, payload=b"SIB4", si_window_position=5)))
        sched = m.sp.SiMessageScheduler(cfg)
        sent = {0: [], 1: [], 2: []}
        for i in range(16 * 20 * 2):
            out = sched.run_slot(_slot(m, i))
            if out is not None:
                sent[out[0]].append(i)
        assert sent[0] == [0, 8 * 20, 16 * 20, 24 * 20]
        assert sent[1] == [5, 16 * 20 + 5]
        assert sent[2] == [20, 9 * 20, 17 * 20, 25 * 20]
        assert sched.nof_windows == [4, 2, 4]
        return sent, vars(sched)

    same(run)


def test_si_windows_overlapping_messages():
    """Three messages whose windows overlap (window 8 slots, positions 1,
    2 and 2): one transmission a slot, the earlier message first, each
    still sent once a window; equal in both packages."""
    def run(m):
        cfg = m.sp.SiSchedulerConfig(si_window_len_slots=8, messages=tuple(
            m.sp.SiMessageConfig(period_radio_frames=p, payload=bytes([k]), si_window_position=w)
            for k, (p, w) in enumerate(((4, 1), (8, 2), (4, 2)))))
        sched = m.sp.SiMessageScheduler(cfg)
        return [sched.run_slot(_slot(m, i)) for i in range(8 * 20 * 2)], vars(sched)

    got = same(run)
    assert sum(x is not None for x in got[0]) > 8


def test_paging_pf_po_follow_ts38304_math():
    """tests/test_si_paging.py::test_paging_pf_po_follow_ts38304_math in both."""
    def run(m):
        cfg = m.sp.PagingConfig(drx_cycle_frames=32, nof_pf_per_drx=8, paging_frame_offset=0,
                                nof_po_per_pf=2)
        pg = m.sp.PagingOccasionScheduler(cfg)
        pg.page(13, {"domain": "ps"})
        hits = []
        for i in range(32 * 20 * 2):
            due = pg.run_slot(_slot(m, i))
            if due:
                hits.append((_slot(m, i).sfn, _slot(m, i).slot_in_frame, due))
        assert len(hits) == 1
        sfn, slot_in_frame, due = hits[0]
        assert sfn % 32 == 20 and slot_in_frame == 10 and due[0]["ue_paging_id"] == 13
        pg.page(13, {"k": 1})
        pg.page(5, {"k": 2})
        slots = {}
        for i in range(32 * 20):
            for r in pg.run_slot(_slot(m, i)):
                slots[r["k"]] = (_slot(m, i).sfn % 32, _slot(m, i).slot_in_frame)
        assert slots == {1: (20, 10), 2: (20, 0)}
        return hits, slots

    same(run)


def test_paging_overflow_stays_queued():
    """tests/test_si_paging.py::test_paging_overflow_stays_queued in both,
    with a frame offset and a second UE's records in the same PO."""
    def run(m):
        pg = m.sp.PagingOccasionScheduler(m.sp.PagingConfig(
            drx_cycle_frames=4, nof_pf_per_drx=4, nof_po_per_pf=1), max_records_per_po=2)
        for k in range(5):
            pg.page(0, {"k": k})
        got = [len(pg.run_slot(_slot(m, i))) for i in range(4 * 20 * 3)]
        assert [g for g in got if g] == [2, 2, 1]
        pg2 = m.sp.PagingOccasionScheduler(m.sp.PagingConfig(
            drx_cycle_frames=8, nof_pf_per_drx=2, paging_frame_offset=3, nof_po_per_pf=4),
            max_records_per_po=3)
        for k in range(4):
            pg2.page(1024 + 6, {"k": k})  # UE_ID 6 (mod 1024)
            pg2.page(2, {"j": k})
        drained = [(i, pg2.run_slot(_slot(m, i))) for i in range(8 * 20 * 4)]
        return got, [d for d in drained if d[1]]

    same(run)


def test_csi_rs_scheduler_periodicity():
    """tests/test_si_paging.py::test_csi_rs_scheduler_periodicity in both."""
    def run(m):
        res = [m.sp.CsiRsResourceConfig(period_slots=10, offset_slots=3),
               m.sp.CsiRsResourceConfig(period_slots=40, offset_slots=7, row=2)]
        sched = m.sp.CsiRsScheduler(res)
        due = {i: [r.row for r in sched.run_slot(_slot(m, i))] for i in range(80)}
        assert due[3] == [1] and due[13] == [1] and due[7] == [2] and due[47] == [2]
        assert due[0] == [] and due[8] == []
        return due

    same(run)


def _engine_cell(m):
    ue = m.sched.RoundRobinScheduler(m.sched.SchedulerConfig(nof_rb=48, max_ues_per_slot=1))
    ue.add_ue(0x10)
    si = m.sp.SiMessageScheduler(m.sp.SiSchedulerConfig(
        si_window_len_slots=5,
        messages=(m.sp.SiMessageConfig(period_radio_frames=8, payload=b"SIB2"),)))
    pg = m.sp.PagingOccasionScheduler(m.sp.PagingConfig(
        drx_cycle_frames=8, nof_pf_per_drx=8, nof_po_per_pf=1))
    csir = m.sp.CsiRsScheduler([m.sp.CsiRsResourceConfig(period_slots=16, offset_slots=4,
                                                         rb_count=48)])
    cell = m.cs.CellScheduler(
        m.cs.CommonSchedulingConfig(sib1_period_slots=640, sib1_slot_offset=1, nof_rb=48), ue,
        si_scheduler=si, paging_po=pg, csi_rs_scheduler=csir)
    pg.page(7, {"domain": "ps"})
    return cell


def test_cell_scheduler_with_spec_engines():
    """tests/test_si_paging.py::test_cell_scheduler_with_spec_engines in
    both packages, slot by slot: every DL_TTI, TX_Data and UL_TTI equal
    field by field (the SI and paging payloads bitwise), the counters and
    the whole state equal at the end."""
    jc, tc = _engine_cell(J), _engine_cell(T)
    seen_si = seen_pg = seen_csi = 0
    for i in range(8 * 20):
        ref = jc.run_slot(_slot(J, i), np.random.default_rng(0))
        port = tc.run_slot(_slot(T, i), np.random.default_rng(0))
        assert_same_slot(ref, port, f"engines slot {i}")
        rntis = [p.rnti for p in port[0].pdsch]
        if t_cs.SI_RNTI in rntis and i != 1:
            seen_si += 1
        if t_cs.P_RNTI in rntis:
            seen_pg += 1
            recs = json.loads(np.packbits(port[1].payloads[0]).tobytes())
            assert recs == {"paging_records": [{"domain": "ps", "ue_paging_id": 7}]}
            assert (_slot(T, i).sfn % 8, _slot(T, i).slot_in_frame) == (7, 0)
        if port[0].csi_rs:
            seen_csi += 1
    assert seen_si >= 1 and tc.counters["si"] >= 1
    assert seen_pg == 1 and tc.counters["paging"] == 1
    assert seen_csi == 10 and tc.counters["csi_rs"] == 10
    assert tc.counters == jc.counters
    assert state(tc) == state(jc)


def test_qos_soak_128_ues():
    """tests/test_si_paging.py::test_qos_soak_128_ues in both packages:
    the same served bits per UE over 1500 slots, and the JAX test's bounds
    (every UE served, bits scaling with the QoS weight, no gap above 128
    slots) on the port's."""
    def run(m):
        sched = m.sched.RoundRobinScheduler(m.sched.SchedulerConfig(
            nof_rb=48, max_ues_per_slot=8, policy="qos"))
        for i in range(128):
            sched.add_ue(0x100 + i, mcs=12, qos_weight=float(1 << (i % 3)))
        rng = np.random.default_rng(0)
        served = {0x100 + i: 0 for i in range(128)}
        last = {0x100 + i: -1 for i in range(128)}
        gaps = []
        for k in range(1500):
            dl, _tx, _ul, _ = sched.run_slot(_slot(m, k), rng)
            for p in dl.pdsch:
                served[p.rnti] += p.config.tbs
                if last[p.rnti] >= 0:
                    gaps.append(k - last[p.rnti])
                last[p.rnti] = k
        return served, max(gaps)

    served, max_gap = same(run)
    assert all(v > 0 for v in served.values())
    cls = {w: [served[0x100 + i] for i in range(128) if 1 << (i % 3) == w] for w in (1, 2, 4)}
    m1, m2, m4 = (np.mean(cls[w]) for w in (1, 2, 4))
    assert m2 > 1.3 * m1 and m4 > 1.3 * m2, (m1, m2, m4)
    assert max_gap <= 128


def _test_mode(m, nof_ues=4):
    sched = m.sched.RoundRobinScheduler(m.sched.SchedulerConfig(
        nof_rb=48, max_ues_per_slot=4, nof_ports=4, nof_layers=2))
    sched.link_adaptor = m.la.LinkAdaptor()
    sched.csi_report_cfg = m.csi.CsiReportConfig(nof_csi_rs_ports=4)
    return sched, m.tm.MacTestModeAdapter(
        m.tm.TestModeUeConfig(nof_ues=nof_ues, ri=2, cqi=12, i11=3, i2=1, csi_period_slots=8),
        sched, csi_report_cfg=sched.csi_report_cfg)


def test_mac_test_mode_adapter():
    """tests/test_si_paging.py::test_mac_test_mode_adapter in both packages:
    64 slots of synthetic indications; the requests, the results, the
    report and the scheduler's state equal, and the JAX test's checks
    (CSI closing the rank-2 PMI loop, HARQ clean) hold on the port."""
    (js, jtm), (ts, ttm) = _test_mode(J), _test_mode(T)
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    for k in range(64):
        jdl, jtx, jul, jres = jtm.run_slot(_slot(J, k), jrng)
        tdl, ttx, tul, tres = ttm.run_slot(_slot(T, k), trng)
        assert_same_slot((jdl, jtx, jul, []), (tdl, ttx, tul, []), f"test mode slot {k}")
        assert plain(tres) == plain(jres)
    rep = ttm.report()
    assert rep == jtm.report()
    assert rep["nof_crc"] >= 4 * 50 and rep["nof_uci"] >= 4 * 8
    assert rep["dl_bits"] > 0 and rep["ul_bits"] > 0
    for i in range(4):
        ue = ts.ues[0x44 + i]
        assert ue.dl_rank == 2
        np.testing.assert_allclose(ue.dl_precoding, t_prec.pmi_to_weights(
            4, 2, {"i11": 3, "i13": 0, "i2": 1}), atol=1e-7)
    assert all(not hp.active for ue in ts.ues.values() for hp in ue.harqs)
    assert state(ts) == state(js)


# ---- reference faults this slice's sequences meet, kept for parity --------------------

def test_retransmission_after_a_prb_change_kept_for_parity():
    """Kept for parity (ROADMAP Q3): a retransmission keeps the first
    transmission's TB but takes the slot's PRB share for its config, so
    when the scheduled UE count (or the fallback stage's PRBs) changes
    between the two, both packages emit a TB whose length is not its
    config's TBS (the LDPC encoder refuses it)."""
    def run(m):
        s = m.sched.RoundRobinScheduler(m.sched.SchedulerConfig(nof_rb=24, nof_grid_sc=288,
                                                                max_ues_per_slot=2))
        s.add_ue(0x30, mcs=10)
        rng = np.random.default_rng(0)
        _, _, ul, _ = s.run_slot(_slot(m, 0), rng)
        s.handle_results(m.fapi.SlotResults(slot=ul.slot,
                                            crc=[m.fapi.CrcIndicationPdu(0x30, 0, False)]))
        s.add_ue(0x31, mcs=10)  # two UEs a slot from now on: half the PRBs each
        out = s.run_slot(_slot(m, 8), rng)
        dl, tx, ul, _ = out
        retx = next(p for p in ul.pusch if p.rnti == 0x30)
        pdu = next(p for p in dl.pdsch if p.rnti == 0x30)
        assert not retx.new_data and retx.config.rv == 2
        assert len(tx.payloads[pdu.tb_index]) != pdu.config.tbs
        return out

    ref, port = run(J), run(T)
    assert_same_slot(ref, port, "retransmission after a PRB change")


def test_blocked_ul_dci_leaves_a_dl_only_tb_kept_for_parity():
    """Kept for parity (ROADMAP Q3): with the PDCCH allocator, a UE whose
    DL DCI is placed but whose UL DCI is blocked (here the slot's shared
    allocator already holds one of its two AL2 candidates) gets a PDSCH
    and no PUSCH; its HARQ process, shared by both directions and cleared
    only by a UL CRC, stays active, and 8 slots later the scheduler
    retransmits it on the UL at rv 2, though the UL never carried its
    first transmission.  Both packages do the same."""
    def run(m):
        s = m.sched.RoundRobinScheduler(m.sched.SchedulerConfig(
            nof_rb=24, nof_grid_sc=288, max_ues_per_slot=1, use_pdcch_alloc=True,
            emit_dci=True, sym_start=2))
        s.add_ue(0x30, mcs=20)
        rng = np.random.default_rng(0)
        shared = m.pa.PdcchSlotAllocator(s.coresets, s.search_spaces)
        assert shared.alloc_dci(0x30, 2, 2, slot_index=0) is not None
        out = []
        for k in range(9):
            dl, _tx, ul, _ = s.run_slot(_slot(m, k), rng, pdcch_slot=shared if k == 0 else None)
            out.append(([p.rnti for p in dl.pdsch],
                        [(p.rnti, p.harq_id, p.new_data, p.config.rv) for p in ul.pusch]))
            s.handle_results(m.fapi.SlotResults(slot=ul.slot, crc=[
                m.fapi.CrcIndicationPdu(p.rnti, p.harq_id, True) for p in ul.pusch]))
        return out, s.nof_pdcch_blocked

    out, blocked = same(run)
    assert out[0] == [[0x30], []] and blocked == 1
    assert out[8] == [[0x30], [[0x30, 0, False, 2]]]
