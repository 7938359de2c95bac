"""The port's copies of the MAC PDU codecs (``l2/mac_pdu``), the FAPI
message bufferer (``fapi/bufferer``) and the RAN helpers
``ran/{band,sch_info}`` against the JAX package's.

Each test runs the JAX package's own test body (``tests/test_l2.py``'s
MAC part, ``tests/test_fapi_bufferer.py``, ``tests/test_ran_helpers.py``'s
band part, ``tests/vectors/test_golden_ran.py``'s SCH part against the
reference goldens) on the port, and the same calls on both packages,
whose results must be equal exactly: bytes bitwise, every number and
counter equal.  All of it is integer host code, so the tolerance is zero.
"""

import json
import os
import types

import numpy as np
import pytest
from torch_parity import plain

from srsran_project_tpu.fapi import bufferer as j_buf
from srsran_project_tpu.fapi import messages as j_fapi
from srsran_project_tpu.l2 import mac_pdu as j_mac
from srsran_project_tpu.ran import band as j_band
from srsran_project_tpu.ran import sch_info as j_sch
from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
from srsran_project_tpu.ran.slot_point import SlotPoint as JSlot
from srsran_project_tpu_torch.fapi import bufferer as t_buf
from srsran_project_tpu_torch.fapi import messages as t_fapi
from srsran_project_tpu_torch.l2 import mac_pdu as t_mac
from srsran_project_tpu_torch.ran import band as t_band
from srsran_project_tpu_torch.ran import sch_info as t_sch
from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing as TScs
from srsran_project_tpu_torch.ran.slot_point import SlotPoint as TSlot

J = types.SimpleNamespace(mac=j_mac, buf=j_buf, fapi=j_fapi, band=j_band, sch=j_sch, Slot=JSlot,
                          Scs=JScs)
T = types.SimpleNamespace(mac=t_mac, buf=t_buf, fapi=t_fapi, band=t_band, sch=t_sch, Slot=TSlot,
                          Scs=TScs)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def same(run):
    """run(J) and run(T) record the same plain data; returns it."""
    ref, port = plain(run(J)), plain(run(T))
    assert port == ref
    return ref


def _suite(name: str) -> list:
    with open(os.path.join(GOLDEN, name, "manifest.json")) as f:
        return json.load(f)


# ---- l2/mac_pdu ------------------------------------------------------------------

def _dl_subpdus(m):
    return [m.mac.MacSubPdu(int(m.mac.DlLcid.TA_CMD), m.mac.ce_ta_command(1, 33)),
            m.mac.MacSubPdu(int(m.mac.DlLcid.CON_RES_ID), m.mac.ce_con_res_id(b"abcdef")),
            m.mac.MacSubPdu(4, b"x" * 100),
            m.mac.MacSubPdu(5, b"y" * 300)]  # forces a 16-bit L field


def test_mac_pdu_roundtrip_dl():
    """tests/test_l2.py::test_mac_pdu_roundtrip_dl on both packages: the
    same PDU bytes, and either package decodes the other's."""
    def run(m):
        pdu = m.mac.encode_mac_pdu(_dl_subpdus(m), tb_size=600)
        assert len(pdu) == 600
        out = m.mac.decode_mac_pdu(pdu)
        assert out[0].payload == m.mac.ce_ta_command(1, 33)
        assert m.mac.parse_ta_command(out[0].payload) == (1, 33)
        assert out[1].payload == b"abcdef"
        assert out[2].payload == b"x" * 100 and out[3].payload == b"y" * 300
        assert out[-1].is_padding
        return pdu, [(s.lcid, s.payload) for s in out]

    pdu, _ = same(run)
    for a, b in ((J, T), (T, J)):
        assert ([(s.lcid, s.payload) for s in a.mac.decode_mac_pdu(pdu)]
                == [(s.lcid, s.payload) for s in b.mac.decode_mac_pdu(pdu)])


def test_mac_pdu_roundtrip_ul_ces():
    """tests/test_l2.py::test_mac_pdu_roundtrip_ul_ces on both packages."""
    def run(m):
        subs = [m.mac.MacSubPdu(3, b"data" * 10),
                m.mac.MacSubPdu(int(m.mac.UlLcid.CRNTI), m.mac.ce_crnti(0x4601)),
                m.mac.MacSubPdu(int(m.mac.UlLcid.SHORT_BSR), m.mac.ce_short_bsr(2, 17)),
                m.mac.MacSubPdu(int(m.mac.UlLcid.LONG_BSR), m.mac.ce_long_bsr({0: 5, 3: 200})),
                m.mac.MacSubPdu(int(m.mac.UlLcid.SINGLE_PHR), m.mac.ce_single_phr(40, 20))]
        pdu = m.mac.encode_mac_pdu(subs, uplink=True)
        out = m.mac.decode_mac_pdu(pdu, uplink=True)
        assert m.mac.parse_crnti(out[1].payload) == 0x4601
        assert m.mac.parse_short_bsr(out[2].payload) == (2, 17)
        assert m.mac.parse_long_bsr(out[3].payload) == {0: 5, 3: 200}
        assert m.mac.parse_single_phr(out[4].payload) == (40, 20)
        return pdu, [(s.lcid, s.payload) for s in out]

    same(run)


# Every MAC CE codec: (encoder, arguments, parser or None).
CE_CASES = [
    ("ce_ta_command", (3, 63), "parse_ta_command"),
    ("ce_ta_command", (0, 0), "parse_ta_command"),
    ("ce_con_res_id", (b"\x01\x02\x03",), None),
    ("ce_con_res_id", (bytes(range(10)),), None),
    ("ce_crnti", (0xFFFE,), "parse_crnti"),
    ("ce_short_bsr", (7, 31), "parse_short_bsr"),
    ("ce_long_bsr", ({1: 9, 2: 0, 7: 255},), "parse_long_bsr"),
    ("ce_single_phr", (63, 1), "parse_single_phr"),
]


@pytest.mark.parametrize("enc, args, parse", CE_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CE_CASES)])
def test_mac_ce_codecs(enc, args, parse):
    """Each CE's bytes are equal in both packages, and each package's
    parser reads the other's bytes back to the same fields."""
    def run(m):
        b = getattr(m.mac, enc)(*args)
        return b, (getattr(m.mac, parse)(b) if parse else None)

    b, fields = same(run)
    if parse:
        assert plain(getattr(t_mac, parse)(getattr(j_mac, enc)(*args))) == fields
        assert plain(getattr(j_mac, parse)(getattr(t_mac, enc)(*args))) == fields


@pytest.mark.parametrize("tb_size", [None, 27, 28, 29, 30, 64, 400])
@pytest.mark.parametrize("uplink", [False, True])
def test_mac_pdu_padding(tb_size, uplink):
    """Padding of 0, 1, 2 and more bytes (and an 8- and a 16-bit L field)
    gives the same PDU and subPDUs in both packages; an overfull TB raises
    in both."""
    def run(m):
        lcid_ce = int(m.mac.UlLcid.CRNTI) if uplink else int(m.mac.DlLcid.TA_CMD)
        subs = [m.mac.MacSubPdu(lcid_ce, b"\x12\x34" if uplink else b"\x21"),
                m.mac.MacSubPdu(7, bytes(range(22)))]
        if tb_size == 400:
            subs.append(m.mac.MacSubPdu(8, b"z" * 260))
        pdu = m.mac.encode_mac_pdu(subs, tb_size=tb_size, uplink=uplink)
        with pytest.raises(ValueError):
            m.mac.encode_mac_pdu(subs, tb_size=10, uplink=uplink)
        return pdu, [(s.lcid, s.payload) for s in m.mac.decode_mac_pdu(pdu, uplink=uplink)]

    same(run)


@pytest.mark.parametrize("nof_bytes", [0, 1, 10, 11, 142, 143, 150000, 150001, 10 ** 9])
def test_bsr_index(nof_bytes):
    """tests/test_l2.py::test_bsr_index on both packages."""
    got = same(lambda m: m.mac.bsr_index_from_bytes(nof_bytes))
    assert got == {0: 0, 10: 1, 11: 2, 10 ** 9: 31}.get(nof_bytes, got)


RAR_CASES = [
    ([(7, 100, 0x123456, 0x4601), (63, 4095, (1 << 27) - 1, 0xFFFF)], 5),
    ([(23, 6, 1, 0x4601)], None),
    ([], 3),
    ([(0, 0, 0, 0), (1, 1, 1, 1), (2, 2, 2, 2)], None),
]


@pytest.mark.parametrize("grants, backoff", RAR_CASES, ids=range(len(RAR_CASES)))
def test_rar_roundtrip(grants, backoff):
    """tests/test_l2.py::test_rar_roundtrip on both packages: the RAR PDU's
    bytes equal, and each package decodes the other's PDU to the same
    backoff index and grants."""
    def run(m):
        gs = [m.mac.RarGrant(rapid=r, ta=ta, ul_grant=u, tc_rnti=t) for r, ta, u, t in grants]
        pdu = m.mac.encode_rar_pdu(gs, backoff_ms_index=backoff)
        bo, out = m.mac.decode_rar_pdu(pdu)
        assert bo == backoff and [(g.rapid, g.ta, g.ul_grant, g.tc_rnti) for g in out] == grants
        return pdu

    pdu = same(run)
    for m in (J, T):
        bo, out = m.mac.decode_rar_pdu(pdu)
        assert (bo, [(g.rapid, g.ta, g.ul_grant, g.tc_rnti) for g in out]) == (backoff, grants)


# ---- fapi/bufferer -----------------------------------------------------------------

def _slot(m, n):
    return m.Slot(scs=m.Scs.KHZ30, count=n)


def _req(m, n):
    return m.fapi.UlTtiRequest(slot=_slot(m, n))


def test_on_time_messages_forward_immediately():
    def run(m):
        sent = []
        b = m.buf.MessageBufferer(sent.append, l2_nof_slots_ahead=2)
        b.on_slot_indication(_slot(m, 10))
        assert b.handle_message(_req(m, 10))
        assert len(sent) == 1 and sent[0].slot.count == 10
        assert b.stats.nof_forwarded == 1
        return b.stats

    same(run)


def test_early_messages_cached_until_their_slot():
    def run(m):
        sent = []
        b = m.buf.MessageBufferer(sent.append, l2_nof_slots_ahead=2)
        b.on_slot_indication(_slot(m, 10))
        assert b.handle_message(_req(m, 12))
        assert not sent
        b.on_slot_indication(_slot(m, 11))
        assert not sent
        b.on_slot_indication(_slot(m, 12))
        assert len(sent) == 1 and sent[0].slot.count == 12
        assert b.stats.nof_cached == 1 and b.stats.nof_forwarded == 1
        return b.stats

    same(run)


def test_late_and_too_early_rejected_with_error_indication():
    def run(m):
        sent, errors = [], []
        b = m.buf.MessageBufferer(sent.append, l2_nof_slots_ahead=2, on_error=errors.append)
        b.on_slot_indication(_slot(m, 10))
        assert not b.handle_message(_req(m, 9))  # late
        assert not b.handle_message(_req(m, 13))  # 3 > 2 ahead
        assert not sent
        assert b.stats.nof_late == 1 and b.stats.nof_too_early == 1
        assert errors[0].error_code == m.fapi.ErrorCode.MSG_SLOT_ERR
        assert errors[1].error_code == m.fapi.ErrorCode.MSG_INVALID_SFN
        return b.stats, [(e.slot.count, e.message, e.error_code) for e in errors]

    same(run)


def test_config_message_round_trip():
    """tests/test_fapi_bufferer.py::test_config_message_round_trip on the
    port's messages: the PARAM/CONFIG/START classes carry the same fields
    and defaults as the reference's."""
    def run(m):
        presp = m.fapi.ParamResponse()
        assert presp.error_code == m.fapi.ErrorCode.MSG_OK
        assert 30 in presp.supported_scs_khz
        creq = m.fapi.ConfigRequest(scs_khz=30, nof_prb=273, nof_tx_ports=4, nof_rx_ports=4)
        assert creq.cp_normal
        m.fapi.StartRequest(), m.fapi.StopRequest(), m.fapi.StopIndication()
        resp = m.fapi.DlTtiResponse(slot=_slot(m, 1),
                                    pdus=[m.fapi.DlTtiResponsePdu(handle=0, status=0)])
        assert resp.pdus[0].status == m.fapi.ErrorCode.MSG_OK
        return presp, creq

    same(run)


@pytest.mark.parametrize("ahead", [1, 2, 4])
def test_bufferer_random_traffic(ahead):
    """300 slots of messages stamped from 2 slots late to ahead + 2
    early, a few with no timing yet and some slot indications skipped:
    the forwarded sequence, the error indications and the stats are
    equal in both packages."""
    def run(m):
        rng = np.random.default_rng(ahead)
        sent, errors = [], []
        b = m.buf.MessageBufferer(sent.append, l2_nof_slots_ahead=ahead, on_error=errors.append)
        accepted = [b.handle_message(_req(m, 5)), b.handle_message(_req(m, 6))]
        for n in range(5, 305):
            if rng.random() < 0.9:
                b.on_slot_indication(_slot(m, n))
            for _ in range(int(rng.integers(0, 4))):
                accepted.append(b.handle_message(_req(m, n + int(rng.integers(-2, ahead + 3)))))
        return (accepted, [s.slot.count for s in sent],
                [(e.slot.count, e.error_code) for e in errors], b.stats)

    got = same(run)
    assert got[3][1]["nof_late"] > 0 and got[3][1]["nof_too_early"] > 0


# ---- ran/band ----------------------------------------------------------------------

def test_arfcn_raster_roundtrip():
    """tests/test_ran_helpers.py::test_arfcn_raster_roundtrip on the port,
    and the same ARFCNs and frequencies as the reference over the three
    raster ranges."""
    n = t_band.freq_to_arfcn(3.5e9)
    assert 600000 <= n <= 2016666
    assert abs(t_band.arfcn_to_freq_hz(n) - 3.5e9) < 15e3
    n = t_band.freq_to_arfcn(700e6)
    assert n < 600000
    assert t_band.arfcn_to_freq_hz(n) == 700e6
    n = t_band.freq_to_arfcn(28e9)
    assert abs(t_band.arfcn_to_freq_hz(n) - 28e9) < 60e3
    freqs = np.random.default_rng(0).uniform(1e6, 40e9, size=200).tolist() + [3e9, 24.25008e9]
    same(lambda m: [m.band.freq_to_arfcn(f) for f in freqs])
    same(lambda m: [m.band.arfcn_to_freq_hz(n) for n in range(0, 3279165, 9973)])
    for m in (J, T):
        with pytest.raises(ValueError):
            m.band.arfcn_to_freq_hz(-1)


def test_band_lookup():
    """tests/test_ran_helpers.py::test_band_lookup on the port, and the
    same band lists and duplex modes as the reference."""
    assert 78 in t_band.bands_for_freq(3.5e9)
    assert t_band.is_tdd_band(78)
    assert not t_band.is_tdd_band(1)
    assert 28 in t_band.bands_for_freq(780e6)
    same(lambda m: ([m.band.bands_for_freq(f) for f in np.arange(500e6, 30e9, 37e6)],
                    {b: m.band.is_tdd_band(b) for b in m.band.BANDS}, m.band.BANDS))


# ---- ran/sch_info ------------------------------------------------------------------

def _ulsch_config(m, case):
    return m.sch.UlschConfig(
        tbs=case["tbs"], qm=case["qm"], target_code_rate=case["rate1024"] / 1024.0,
        nof_harq_ack_bits=case["ack"], nof_csi_part1_bits=case["csi1"],
        nof_csi_part2_bits=case["csi2"], alpha_scaling=case["alpha"],
        beta_offset_harq_ack=case["beta_ack"], beta_offset_csi_part1=case["beta_csi1"],
        beta_offset_csi_part2=case["beta_csi2"], nof_rb=case["nof_rb"],
        start_symbol_index=case["start_sym"], nof_symbols=case["nof_symbols"],
        dmrs_type=case["dmrs_type"], dmrs_symbol_mask=case["dmrs_mask"],
        nof_cdm_groups_without_data=case["cdm_groups"], nof_layers=case["layers"],
        contains_dc=case["contains_dc"] == 1)


def test_ulsch_info_golden():
    """tests/vectors/test_golden_ran.py::test_ulsch_info_golden on the
    port (every reference golden case exact), and the same
    UlschInformation as the JAX package's."""
    for case in _suite("ulsch_info"):
        info = t_sch.get_ulsch_information(_ulsch_config(T, case))
        assert info.nof_ul_sch_bits == case["g_ulsch"], case
        assert info.nof_harq_ack_bits == case["g_ack"], case
        assert info.nof_harq_ack_rvd == case["g_ack_rvd"], case
        assert info.nof_csi_part1_bits == case["g_csi1"], case
        assert info.nof_csi_part2_bits == case["g_csi2"], case
        assert info.nof_harq_ack_re == case["q_ack"], case
        assert info.nof_csi_part1_re == case["q_csi1"], case
        assert info.nof_csi_part2_re == case["q_csi2"], case
        assert info.nof_dc_overlap_bits == case["dc_overlap_bits"], case
        if "sch_nof_cb" in case:
            assert info.sch is not None
            assert info.sch.nof_cb == case["sch_nof_cb"], case
            assert info.sch.nof_bits_per_cb == case["sch_bits_per_cb"], case
            assert info.sch.nof_filler_bits_per_cb == case["sch_filler_per_cb"], case
        same(lambda m: m.sch.get_ulsch_information(_ulsch_config(m, case)))


def test_dlsch_info_golden():
    """tests/vectors/test_golden_ran.py::test_dlsch_info_golden on the port,
    and the same (SchInfo, G) as the JAX package's."""
    for case in _suite("dlsch_info"):
        def config(m):
            return m.sch.DlschConfig(
                tbs=case["tbs"], qm=case["qm"], target_code_rate=case["rate1024"] / 1024.0,
                nof_rb=case["nof_rb"], start_symbol_index=case["start_sym"],
                nof_symbols=case["nof_symbols"], dmrs_type=1, dmrs_symbol_mask=case["dmrs_mask"],
                nof_cdm_groups_without_data=case["cdm_groups"], nof_layers=case["layers"])

        sch, g = t_sch.get_dlsch_information(config(T))
        assert g == case["g_dlsch"], case
        assert sch.nof_cb == case["sch_nof_cb"], case
        assert sch.nof_bits_per_cb == case["sch_bits_per_cb"], case
        assert sch.nof_filler_bits_per_cb == case["sch_filler_per_cb"], case
        same(lambda m: m.sch.get_dlsch_information(config(m)))


def test_sch_info_random_configs():
    """200 random UL-SCH configs (with and without SCH, every UCI size
    regime, both DM-RS types) and their DL-SCH counterparts give the same
    numbers in both packages."""
    rng = np.random.default_rng(11)
    for _ in range(200):
        dmrs_type = int(rng.integers(1, 3))
        start = int(rng.integers(0, 4))
        nsym = int(rng.integers(4, 14 - start + 1))
        mask = 0
        for s in rng.choice(np.arange(start, start + nsym), size=int(rng.integers(1, 4)),
                            replace=False):
            mask |= 1 << int(s)
        kw = dict(tbs=int(rng.choice([0, int(rng.integers(24, 200000))])),
                  qm=int(rng.choice([1, 2, 4, 6, 8])),
                  target_code_rate=float(rng.uniform(0.05, 0.93)),
                  nof_harq_ack_bits=int(rng.choice([0, 1, 2, 5, 11, 20])),
                  nof_csi_part1_bits=int(rng.choice([0, 4, 19, 40])),
                  nof_csi_part2_bits=int(rng.choice([0, 8, 100])),
                  alpha_scaling=float(rng.choice([0.5, 0.65, 0.8, 1.0])),
                  beta_offset_harq_ack=float(rng.uniform(1, 20)),
                  beta_offset_csi_part1=float(rng.uniform(1, 20)),
                  beta_offset_csi_part2=float(rng.uniform(1, 20)),
                  nof_rb=int(rng.integers(1, 274)), start_symbol_index=start,
                  nof_symbols=nsym, dmrs_type=dmrs_type, dmrs_symbol_mask=mask,
                  nof_cdm_groups_without_data=int(rng.integers(1, {1: 2, 2: 3}[dmrs_type] + 1)),
                  nof_layers=int(rng.integers(1, 5)), contains_dc=bool(rng.integers(0, 2)))
        same(lambda m: m.sch.get_ulsch_information(m.sch.UlschConfig(**kw)))
        if kw["tbs"]:
            dl = {k: kw[k] for k in ("tbs", "qm", "target_code_rate", "nof_rb",
                                     "start_symbol_index", "nof_symbols", "dmrs_type",
                                     "dmrs_symbol_mask", "nof_cdm_groups_without_data",
                                     "nof_layers", "contains_dc")}
            same(lambda m: m.sch.get_dlsch_information(m.sch.DlschConfig(**dl)))
