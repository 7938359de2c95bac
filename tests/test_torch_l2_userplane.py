"""The port's L2 user plane against the JAX package's: security (NEA1-3,
NIA1-3, the KDF), PDCP, RLC TM/UM/AM, SDAP, GTP-U, NR-U, the CU-UP chain
and the DU-high's TB assembly.

Every module here is host byte logic copied from the reference, so the
tolerance is zero: both packages are driven with one input sequence made
from a numpy seed (SDUs, losses, reordering, budgets, timer ticks), and
every PDU, status report, delivered SDU and the entities' whole state
must be equal, in order.  The DU-high's scheduler requests are compared
field by field through the port's ``from_reference`` copies and its TBs
bit by bit.  The reference's own tests (``test_l2``,
``test_l2_userplane``, ``test_du_cu_split``) also run on the port's
modules (``run_on_port``).
"""

import os

import numpy as np
import pytest
import test_du_cu_split as ref_split
import test_l2 as ref_l2
import test_l2_userplane as ref_up
from test_torch_scheduler import assert_same
from torch_parity import plain_state, reference_cases, run_on_port

from srsran_project_tpu.fapi import messages as j_fapi
from srsran_project_tpu.l2 import cu_up_sim as j_cu_up
from srsran_project_tpu.l2 import du_high_sim as j_du
from srsran_project_tpu.l2 import gtpu as j_gtpu
from srsran_project_tpu.l2 import nru as j_nru
from srsran_project_tpu.l2 import pdcp as j_pdcp
from srsran_project_tpu.l2 import rlc as j_rlc
from srsran_project_tpu.l2 import sdap as j_sdap
from srsran_project_tpu.l2 import security as j_sec
from srsran_project_tpu.l2sim import scheduler as j_sched
from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
from srsran_project_tpu.ran.slot_point import SlotPoint as JSlot
from srsran_project_tpu_torch.apps import ue_sim as t_ue
from srsran_project_tpu_torch.fapi import messages as t_fapi
from srsran_project_tpu_torch.l2 import cu_up_sim as t_cu_up
from srsran_project_tpu_torch.l2 import du_high_sim as t_du
from srsran_project_tpu_torch.l2 import gtpu as t_gtpu
from srsran_project_tpu_torch.l2 import mac_pdu as t_mac
from srsran_project_tpu_torch.l2 import nru as t_nru
from srsran_project_tpu_torch.l2 import pdcp as t_pdcp
from srsran_project_tpu_torch.l2 import rlc as t_rlc
from srsran_project_tpu_torch.l2 import sdap as t_sdap
from srsran_project_tpu_torch.l2 import security as t_sec
from srsran_project_tpu_torch.l2sim import scheduler as t_sched
from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing as TScs
from srsran_project_tpu_torch.ran.slot_point import SlotPoint as TSlot

PORT = dict(security=t_sec, pdcp=t_pdcp, rlc=t_rlc, sdap=t_sdap, gtpu=t_gtpu, nru=t_nru,
            mac_pdu=t_mac, cu_up_sim=t_cu_up, du_high_sim=t_du,
            SchedulerConfig=t_sched.SchedulerConfig, UeSim=t_ue.UeSim)


def _bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


# ---- the reference's own tests on the port's modules ---------------------------

@pytest.mark.parametrize("module,name,kwargs", reference_cases(ref_l2) + reference_cases(ref_up)
                         + reference_cases(ref_split))
def test_reference_tests_on_port(monkeypatch, module, name, kwargs):
    """The reference's L2 tests (3GPP/FIPS vectors, RLC, PDCP, SDAP, GTP-U,
    NR-U, the CU-UP/DU-high split) pass on the port's modules."""
    run_on_port(monkeypatch, module, name, kwargs, PORT)


# ---- security --------------------------------------------------------------------

def test_security_tables_copy():
    """The port's ``_security_tables.npz`` equals the reference's, array by array."""
    here = [os.path.join(os.path.dirname(m.__file__), "_security_tables.npz") for m in (j_sec, t_sec)]
    ref, port = (np.load(p) for p in here)
    assert sorted(ref.files) == sorted(port.files)
    for k in ref.files:
        assert ref[k].dtype == port[k].dtype and np.array_equal(ref[k], port[k]), k


@pytest.mark.parametrize("algo", [1, 2, 3])
def test_nea_matches_reference(algo):
    """NEA1-3 on random keys, COUNTs, bearers, directions and lengths (bit
    lengths that are not a multiple of 8 among them): the same bytes."""
    rng = np.random.default_rng(100 + algo)
    for _ in range(6):
        key, n = _bytes(rng, 16), int(rng.integers(1, 48))
        count, bearer, direction = int(rng.integers(0, 2**32)), int(rng.integers(0, 32)), \
            int(rng.integers(0, 2))
        data = _bytes(rng, n)
        for bits in (None, 8 * n - int(rng.integers(1, 8))):
            args = (key, count, bearer, direction, data)
            assert t_sec.CIPHERING[algo](*args, length_bits=bits) == \
                j_sec.CIPHERING[algo](*args, length_bits=bits)


@pytest.mark.parametrize("algo", [1, 2, 3])
def test_nia_matches_reference(algo):
    """NIA1-3 on random inputs (NIA1 and NIA3 also at bit lengths): the same MAC-I."""
    rng = np.random.default_rng(200 + algo)
    for _ in range(6):
        key, n = _bytes(rng, 16), int(rng.integers(0, 48))
        count, bearer, direction = int(rng.integers(0, 2**32)), int(rng.integers(0, 32)), \
            int(rng.integers(0, 2))
        args = (key, count, bearer, direction, _bytes(rng, n))
        assert t_sec.INTEGRITY[algo](*args) == j_sec.INTEGRITY[algo](*args)
        if algo != 2 and n:
            bits = 8 * n - int(rng.integers(1, 8))
            assert t_sec.INTEGRITY[algo](*args, bits) == j_sec.INTEGRITY[algo](*args, bits)


def test_kdf_and_algo_keys_match_reference():
    rng = np.random.default_rng(7)
    for _ in range(8):
        key = _bytes(rng, 32)
        params = [_bytes(rng, int(rng.integers(0, 9))) for _ in range(int(rng.integers(0, 4)))]
        fc = int(rng.integers(0, 256))
        assert t_sec.kdf(key, fc, *params) == j_sec.kdf(key, fc, *params)
        for algo_type in (t_sec.ALGO_TYPE_NRRC_ENC, t_sec.ALGO_TYPE_NRRC_INT,
                          t_sec.ALGO_TYPE_NUP_ENC, t_sec.ALGO_TYPE_NUP_INT):
            for algo_id in (0, 1, 2, 3):
                assert t_sec.derive_algo_key(key, algo_type, algo_id) == \
                    j_sec.derive_algo_key(key, algo_type, algo_id)


def test_security_engine_matches_reference():
    """protect/unprotect of every NEA x NIA pair, a body corrupted too."""
    rng = np.random.default_rng(8)
    for nea in (0, 1, 2, 3):
        for nia in (0, 1, 2, 3):
            ck, ik, bearer = _bytes(rng, 16), _bytes(rng, 16), int(rng.integers(0, 32))
            engines = [m.SecurityEngine(nea, nia, ck, ik, bearer=bearer) for m in (j_sec, t_sec)]
            count, hdr, payload = int(rng.integers(0, 2**20)), _bytes(rng, 2), _bytes(rng, 21)
            bodies = [e.protect(count, 1, hdr, payload) for e in engines]
            assert bodies[0] == bodies[1]
            bad = bytes([bodies[0][0] ^ 0x5A]) + bodies[0][1:]
            for body in (bodies[0], bad):
                assert engines[0].unprotect(count, 1, hdr, body) == \
                    engines[1].unprotect(count, 1, hdr, body)


# ---- PDCP --------------------------------------------------------------------------

def _lossy(rng, pdus: list[bytes]) -> list[bytes]:
    """The link of the parity tests: drops, duplicates, swaps neighbours and
    flips a byte, all drawn from ``rng``."""
    out = []
    for p in pdus:
        r = rng.random()
        if r < 0.12:
            continue
        if r < 0.18:
            p = p[:-1] + bytes([p[-1] ^ 0x01])
        out.append(p)
        if rng.random() < 0.08:
            out.append(p)
    for i in range(len(out) - 1):
        if rng.random() < 0.15:
            out[i], out[i + 1] = out[i + 1], out[i]
    return out


@pytest.mark.parametrize("sn_bits,nea,nia,is_srb,start", [
    (12, 1, 2, False, 0), (18, 2, 2, False, 0), (18, 3, 3, False, (1 << 18) - 6),
    (12, 2, 1, True, (1 << 12) - 5), (12, 0, 0, False, 0)])
def test_pdcp_matches_reference(sn_bits, nea, nia, is_srb, start):
    """One SDU sequence through a lossy, reordering link (from a numpy
    seed; ``start``: the first COUNT, an HFN rollover within the run):
    every PDU, the delivered SDUs at each tick, the status reports, the
    drop counters and the entities' state equal the reference's."""
    rng = np.random.default_rng(sn_bits + nea * 7 + nia * 3 + start % 97)
    runs = []
    for pk, sec in ((j_pdcp, j_sec), (t_pdcp, t_sec)):
        got = []
        eng = [sec.SecurityEngine(nea, nia, bytes(range(16)), bytes(range(16, 32)), bearer=2)
               if nea or nia else None for _ in range(2)]
        cfg = pk.PdcpConfig(sn_bits=sn_bits, is_srb=is_srb, t_reordering_slots=3,
                            integrity=bool(nia))
        tx = pk.PdcpEntity(cfg, eng[0], is_downlink_tx=True)
        rx = pk.PdcpEntity(cfg, eng[1], is_downlink_tx=False, on_rx_sdu=got.append)
        tx.tx_next = rx.rx_next = rx.rx_deliv = start
        runs.append((tx, rx, got))
    link_rng = [np.random.default_rng(1), np.random.default_rng(1)]
    sdu_rng = np.random.default_rng(2)
    for slot in range(14):
        sdus = [_bytes(sdu_rng, int(sdu_rng.integers(1, 60))) for _ in range(3)]
        trace = []
        for (tx, rx, got), lr in zip(runs, link_rng):
            pdus = [tx.tx_sdu(s) for s in sdus]
            for p in _lossy(lr, pdus):
                rx.rx_pdu(p)
            rx.tick(slot)
            trace.append((pdus, list(got), rx.build_status_report(), rx.rx_integrity_failures,
                          rx.rx_dropped, plain_state(tx), plain_state(rx)))
        assert trace[0] == trace[1], slot
    for pk in (j_pdcp, t_pdcp):
        assert pk.decode_status_report(runs[0][1].build_status_report()) == \
            j_pdcp.decode_status_report(runs[1][1].build_status_report())


# ---- RLC ---------------------------------------------------------------------------

def _rlc_pair(pk, mode: str, sn_bits: int, got: list):
    if mode == "am":
        return (pk.RlcAmEntity(sn_bits=sn_bits, poll_pdu=4, max_retx=3),
                pk.RlcAmEntity(sn_bits=sn_bits, on_rx_sdu=got.append))
    if mode == "um":
        return (pk.RlcUmEntity(sn_bits=sn_bits),
                pk.RlcUmEntity(sn_bits=sn_bits, on_rx_sdu=got.append, t_reassembly_slots=4))
    return pk.RlcTmEntity(), pk.RlcTmEntity(on_rx_sdu=got.append)


@pytest.mark.parametrize("mode,sn_bits", [("am", 12), ("am", 18), ("um", 6), ("um", 12),
                                          ("tm", 0)])
def test_rlc_matches_reference(mode, sn_bits):
    """SDUs segmented into PDUs under random ``pull_pdu`` budgets, a lossy
    link, status PDUs both ways every other slot (AM: NACKs and their
    retransmissions) and the UM reassembly timer: every PDU, status PDU,
    delivered SDU and the entities' state equal the reference's."""
    runs = []
    for pk in (j_rlc, t_rlc):
        got = []
        runs.append((*_rlc_pair(pk, mode, sn_bits, got), got, pk))
    rngs = [np.random.default_rng(3) for _ in runs]
    sdu_rng = np.random.default_rng(4)
    for slot in range(16):
        sdus = [_bytes(sdu_rng, int(sdu_rng.integers(1, 200)))
                for _ in range(int(sdu_rng.integers(0, 3)))]
        trace = []
        for (tx, rx, got, pk), lr in zip(runs, rngs):
            for s in sdus:
                tx.tx_sdu(s)
            pdus = []
            for _ in range(4):
                p = tx.pull_pdu(int(lr.integers(2, 90)) if mode != "tm" else 400)
                if p is not None:
                    pdus.append(p)
            for p in pdus:
                if lr.random() > 0.2 or mode == "tm":
                    rx.rx_pdu(p)
            statuses = []
            if mode == "um":
                rx.tick(slot)
            if mode == "am" and slot % 2:
                st = rx.build_status()
                statuses.append(st)
                tx.rx_status(pk.decode_status_pdu(st, sn_bits))
                statuses.append(rx.status_requested)
            trace.append((pdus, statuses, list(got), plain_state(tx), plain_state(rx)))
        assert trace[0] == trace[1], slot
    assert runs[0][2]  # something was delivered


def test_rlc_status_codec_matches_reference():
    """Random AM status PDUs (NACKs with and without segment offsets and
    ranges) encode to the same bytes and decode to the same fields."""
    rng = np.random.default_rng(9)
    for sn_bits in (12, 18):
        for _ in range(20):
            nacks = []
            for sn in sorted(rng.choice(200, int(rng.integers(0, 6)), replace=False)):
                kind = rng.integers(0, 3)
                nacks.append((int(sn), None, None) if kind == 0 else
                             (int(sn), int(rng.integers(0, 100)), int(rng.integers(100, 300)))
                             if kind == 1 else (int(sn), 0, 0xFFFF))
            ack = int(rng.integers(200, 400))
            data = [pk.encode_status_pdu(pk.AmStatus(ack_sn=ack, nacks=list(nacks)), sn_bits)
                    for pk in (j_rlc, t_rlc)]
            assert data[0] == data[1]
            assert plain_state(t_rlc.decode_status_pdu(data[0], sn_bits)) == \
                plain_state(j_rlc.decode_status_pdu(data[0], sn_bits))


# ---- SDAP, GTP-U, NR-U ----------------------------------------------------------

def test_sdap_matches_reference():
    for qfi in range(64):
        for rdi in (False, True):
            for rqi in (False, True):
                b = t_sdap.encode_dl_header(qfi, rdi, rqi)
                assert b == j_sdap.encode_dl_header(qfi, rdi, rqi)
                assert t_sdap.decode_dl_header(b[0]) == j_sdap.decode_dl_header(b[0])
        for dc in (False, True):
            b = t_sdap.encode_ul_header(qfi, dc)
            assert b == j_sdap.encode_ul_header(qfi, dc)
            assert t_sdap.decode_ul_header(b[0]) == j_sdap.decode_ul_header(b[0])
    out = []
    for pk in (j_sdap, t_sdap):
        got = []
        e = pk.SdapEntity(pk.SdapConfig(), on_rx_sdu=lambda q, s, g=got: g.append((q, s)))
        for qfi in (1, 5, 9):
            e.map_flow(qfi, qfi % 3)
        r = np.random.default_rng(10)
        pdus = []
        for _ in range(12):
            qfi, dl = int(r.choice([1, 5, 9])), bool(r.integers(0, 2))
            drb, pdu = e.tx_sdu(qfi, _bytes(r, int(r.integers(1, 30))), downlink=dl)
            pdus.append((drb, pdu, e.rx_pdu(pdu, downlink=dl)))
        out.append((pdus, got, plain_state(e)))
    assert out[0] == out[1]


def test_gtpu_matches_reference():
    """G-PDUs (with and without the PDU session container, both directions),
    echo and end marker encode to the same bytes, decode to the same
    fields; the demux routes the same frames to the same tunnels."""
    rng = np.random.default_rng(11)
    frames = []
    for _ in range(12):
        teid, payload = int(rng.integers(0, 2**32)), _bytes(rng, int(rng.integers(0, 80)))
        qfi = None if rng.random() < 0.3 else int(rng.integers(0, 64))
        dl = bool(rng.integers(0, 2))
        frames.append(t_gtpu.encode_gpdu(teid, payload, qfi=qfi, downlink=dl))
        assert frames[-1] == j_gtpu.encode_gpdu(teid, payload, qfi=qfi, downlink=dl)
    for fn, arg in (("encode_echo_request", 7), ("encode_echo_response", 9),
                    ("encode_end_marker", 0x1234)):
        frames.append(getattr(t_gtpu, fn)(arg))
        assert frames[-1] == getattr(j_gtpu, fn)(arg)
    for f in frames:
        assert plain_state(t_gtpu.decode(f)) == plain_state(j_gtpu.decode(f))
    routed = []
    for pk in (j_gtpu, t_gtpu):
        got = []
        d = pk.GtpuDemux()
        for teid in {pk.decode(f).teid for f in frames[:6]}:
            d.add_tunnel(teid, lambda g, t=teid, o=got: o.append((t, g.payload)))
        d.remove_tunnel(pk.decode(frames[0]).teid)
        for f in frames:
            d.rx(f)
        routed.append((got, plain_state(d)))
    assert routed[0] == routed[1]


def test_nru_matches_reference():
    rng = np.random.default_rng(12)
    for _ in range(12):
        d = dict(nru_sn=int(rng.integers(0, 2**24)), payload=_bytes(rng, int(rng.integers(0, 50))),
                 report_polling=bool(rng.integers(0, 2)), retransmission=bool(rng.integers(0, 2)))
        frames = [pk.encode_dl_user_data(pk.NruDlUserData(**d)) for pk in (j_nru, t_nru)]
        assert frames[0] == frames[1]
        assert plain_state(t_nru.decode_dl_user_data(frames[0])) == \
            plain_state(j_nru.decode_dl_user_data(frames[0]))
        lost = sorted(int(x) for x in rng.choice(1000, int(rng.integers(0, 4)), replace=False))
        st = dict(desired_buffer_size=int(rng.integers(0, 2**32)),
                  highest_delivered_pdcp_sn=None if rng.random() < 0.3 else int(rng.integers(0, 2**24)),
                  highest_transmitted_pdcp_sn=None if rng.random() < 0.3 else int(rng.integers(0, 2**24)),
                  lost_sn_ranges=tuple((a, a + int(rng.integers(0, 5))) for a in lost))
        frames = [pk.encode_dl_status(pk.NruDlStatus(**st)) for pk in (j_nru, t_nru)]
        assert frames[0] == frames[1]
        assert plain_state(t_nru.decode_dl_status(frames[0])) == \
            plain_state(j_nru.decode_dl_status(frames[0]))


# ---- the CU-UP chain and the DU-high ----------------------------------------------

def test_cu_up_matches_reference():
    """NG-U -> SDAP -> PDCP -> F1-U and F1-U -> PDCP -> SDAP -> NG-U through
    ``CuUpSim``: the same NR-U and GTP-U frames, in order."""
    rng = np.random.default_rng(13)
    pkts = [_bytes(rng, int(rng.integers(20, 300))) for _ in range(8)]
    out = []
    for pk, sec, pd in ((j_cu_up, j_sec, j_pdcp), (t_cu_up, t_sec, t_pdcp)):
        ngu, f1u = [], []
        cu = pk.CuUpSim(ue_id=3, ngu_tx=ngu.append, sec_cfg=(3, 1),
                        keys=(bytes(range(5, 21)), bytes(range(40, 56))))
        cu.setup_bearer(drb_id=1, qfi=9, teid_dl=0x100, teid_ul=0x200, f1u_tx=f1u.append)
        ue = pd.PdcpEntity(pd.PdcpConfig(sn_bits=18),
                           sec.SecurityEngine(3, 1, bytes(range(5, 21)), bytes(range(40, 56)),
                                              bearer=1), is_downlink_tx=False)
        for k, p in enumerate(pkts):
            gtpu_mod = j_gtpu if pk is j_cu_up else t_gtpu
            cu.rx_ngu(gtpu_mod.encode_gpdu(teid=0x100, payload=p, qfi=9))
            cu.rx_f1u_ul(1, ue.tx_sdu(bytes([0x40 | 9]) + p[::-1]))
            cu.tick(k)
        out.append((ngu, f1u, plain_state(cu)))
    assert out[0] == out[1]


def _slot(m, k):
    return m[0].from_sfn_slot(m[1].KHZ30, k // 20, k % 20)


def test_du_high_matches_reference():
    """The DU-high over the scheduler, without the PHY: two UEs, DL packets
    from each CU-UP and UL packets from each UE, both packages from one
    numpy seed.  The DL_TTI, TX_Data and UL_TTI requests are equal field by
    field, the TBs bit by bit, a numpy-drawn link loses some TBs both ways
    (the CRC indications say so, so HARQ retransmits them), and the
    packets delivered to each UE and to the core are equal at the end."""
    sides = []
    for pk in ("j", "t"):
        du_m, cu_m, gt, nr, sch, fapi, ue_cls, slot = (
            (j_du, j_cu_up, j_gtpu, j_nru, j_sched, j_fapi, ref_split.UeSim, (JSlot, JScs))
            if pk == "j" else
            (t_du, t_cu_up, t_gtpu, t_nru, t_sched, t_fapi, t_ue.UeSim, (TSlot, TScs)))
        core = []
        du = du_m.DuHighSim(sch.SchedulerConfig(nof_rb=24, max_ues_per_slot=2))
        du.scheduler.tb_source = du.build_dl_tb
        ues = {}
        for i, rnti in enumerate((0x4601, 0x4602)):
            cu = cu_m.CuUpSim(ue_id=i + 1, ngu_tx=core.append)
            du_ue = du.add_ue(rnti, mcs=9, on_rx_sdu=lambda pp, c=cu: c.rx_f1u_ul(1, pp))
            ent = du_ue.bearers[4].entity
            cu.setup_bearer(drb_id=1, qfi=9, teid_dl=0x10 + i, teid_ul=0x20 + i,
                            f1u_tx=lambda fr, e=ent, n=nr: e.tx_sdu(n.decode_dl_user_data(fr).payload))
            ues[rnti] = (ue_cls(rnti=rnti), cu)
        sides.append(dict(du=du, core=core, ues=ues, gt=gt, fapi=fapi, slot=slot))
    rng = np.random.default_rng(14)
    dl = {rnti: [_bytes(rng, int(rng.integers(30, 200))) for _ in range(4)] for rnti in (0x4601, 0x4602)}
    ul = {rnti: [_bytes(rng, int(rng.integers(30, 150))) for _ in range(3)] for rnti in (0x4601, 0x4602)}
    for s in sides:
        for i, (rnti, (ue, cu)) in enumerate(s["ues"].items()):
            for p in dl[rnti]:
                cu.rx_ngu(s["gt"].encode_gpdu(teid=0x10 + i, payload=p, qfi=9))
            for p in ul[rnti]:
                ue.send_ul(p)
    sched_rngs = [np.random.default_rng(15) for _ in sides]
    link = np.random.default_rng(16)
    for k in range(32):
        losses = link.random(8) < 0.15
        reqs = []
        for s, r in zip(sides, sched_rngs):
            dlr, txr, ulr, grants = s["du"].scheduler.run_slot(_slot(s["slot"], k), r)
            reqs.append((dlr, txr, ulr, grants))
        (jdl, jtx, jul, jgr), (tdl, ttx, tul, tgr) = reqs
        assert_same(t_fapi.DlTtiRequest.from_reference(jdl), tdl, f"slot {k} DL_TTI")
        assert_same(t_fapi.TxDataRequest.from_reference(jtx), ttx, f"slot {k} TX_Data")
        assert_same(t_fapi.UlTtiRequest.from_reference(jul), tul, f"slot {k} UL_TTI")
        assert [tuple(map(int, g)) for g in jgr] == [tuple(map(int, g)) for g in tgr]
        for s, (dlr, txr, ulr, grants) in zip(sides, reqs):
            fapi = s["fapi"]
            res = fapi.SlotResults(slot=dlr.slot)
            for j, pdu in enumerate(ulr.pusch):
                ok = not losses[j]
                res.crc.append(fapi.CrcIndicationPdu(pdu.rnti, pdu.harq_id, ok, snr_db=20.0))
                if ok:
                    tb = next(np.asarray(txr.payloads[p.tb_index]) for p in dlr.pdsch
                              if p.rnti == pdu.rnti)
                    s["ues"][pdu.rnti][0].handle_dl_tb(tb)
            s["du"].scheduler.handle_results(res)
            for j, (rnti, _, tbs) in enumerate(grants):
                ul_tb = s["ues"][rnti][0].build_ul_tb(tbs)
                s.setdefault("ul_tbs", []).append(ul_tb)
                if not losses[4 + j]:
                    s["du"].handle_ul_tb(rnti, ul_tb)
            for rnti, (ue, cu) in s["ues"].items():
                s["du"].exchange_am_status(rnti, 4, ue.rlc)
                ue.pdcp.tick(k)
                cu.tick(k)
        assert len(sides[0].get("ul_tbs", [])) == len(sides[1].get("ul_tbs", []))
        for a, b in zip(sides[0].get("ul_tbs", []), sides[1].get("ul_tbs", [])):
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    j_s, t_s = sides
    for rnti in (0x4601, 0x4602):
        assert t_s["ues"][rnti][0].delivered == j_s["ues"][rnti][0].delivered
        assert [p for _, p in t_s["ues"][rnti][0].delivered] == dl[rnti]
    assert t_s["core"] == j_s["core"]
    # UE 0x4602's first UL TB, which held all three of its RLC PDUs, is
    # lost, and RLC AM never retransmits a burst lost whole (kept for
    # parity: test_rlc_am_burst_lost_whole_stalls_kept_for_parity).
    assert [t_gtpu.decode(f).payload for f in t_s["core"]] == ul[0x4601]
    assert (t_s["du"].dl_bytes, t_s["du"].ul_bytes) == (j_s["du"].dl_bytes, j_s["du"].ul_bytes)


def test_rlc_am_burst_lost_whole_stalls_kept_for_parity():
    """Reference fault kept for parity: RLC AM has no t-PollRetransmit.
    When every PDU sent so far is lost, the receiver's status PDU is
    ACK_SN 0 with no NACK, so the transmitter retransmits nothing and the
    SDUs stay outstanding for good, in both packages
    (``srsran_project_tpu/l2/rlc.py`` ``rx_status`` / ``build_status``)."""
    for pk in (j_rlc, t_rlc):
        got = []
        tx, rx = pk.RlcAmEntity(), pk.RlcAmEntity(on_rx_sdu=got.append)
        for k in range(3):
            tx.tx_sdu(bytes([k]) * 40)
        while tx.pull_pdu(100) is not None:
            pass  # every PDU of the burst is lost
        for _ in range(5):
            status = rx.build_status()
            assert pk.decode_status_pdu(status) == pk.AmStatus(ack_sn=0)
            tx.rx_status(pk.decode_status_pdu(status))
            assert tx.pull_pdu(100) is None
        assert got == [] and len(tx._outstanding) == 3 and not tx.max_retx_reached
