"""The port's ``UpperPhy`` against the JAX package's on the same FAPI
requests (the port's copies made with ``from_reference``) and the same
received grids: the cases of tests/test_upper_phy.py.

Tolerances: DL grids within 1e-6 x RMS; CRC verdicts, TB bits and UCI
bits exact; snr_db atol 1e-3 and PUCCH metrics rtol 1e-4 (as
tests/test_torch_ul_slot_uci.py); SRS h rtol 1e-4 of its largest value,
SNR atol 1e-3 dB and the phase slope atol 1e-5 rad (float32 FFTs of two
libraries); ta_s rtol 1e-6 (the same delay-profile bins); RACH
indications: the same preambles and TA bins, metric rtol 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dl_slot import assert_grid_close
from torch_parity import to_np

from srsran_project_tpu.fapi import messages as jfapi
from srsran_project_tpu.fapi import validators as jval
from srsran_project_tpu.ops.modulation import Modulation
from srsran_project_tpu.phy import pdcch as jpdcch
from srsran_project_tpu.phy import pdsch as jpdsch
from srsran_project_tpu.phy import pucch as jpucch
from srsran_project_tpu.phy import pucch_f2 as jf2
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu.phy import srs as jsrs
from srsran_project_tpu.phy import ssb as jssb
from srsran_project_tpu.phy.allocation import Allocation
from srsran_project_tpu.phy.upper_phy import UpperPhy as JUpperPhy
from srsran_project_tpu.phy.upper_phy import UpperPhyConfig as JUpperPhyConfig
from srsran_project_tpu.ran.constants import SubcarrierSpacing
from srsran_project_tpu.ran.slot_point import SlotPoint
from srsran_project_tpu.support import file_vector as jfv
from srsran_project_tpu_torch.fapi import messages as tfapi
from srsran_project_tpu_torch.fapi import validators as tval
from srsran_project_tpu_torch.phy import pdsch as tpdsch
from srsran_project_tpu_torch.phy import ul_slot as tul
from srsran_project_tpu_torch.phy.upper_phy import UpperPhy as TUpperPhy
from srsran_project_tpu_torch.phy.upper_phy import UpperPhyConfig as TUpperPhyConfig
from srsran_project_tpu_torch.support import file_vector as tfv


def _slot(n=0):
    return SlotPoint.from_sfn_slot(SubcarrierSpacing.KHZ30, 0, n)


def _phys(**kw):
    return JUpperPhy(JUpperPhyConfig(**kw)), TUpperPhy(TUpperPhyConfig(device="cpu", **kw))


def _pxsch_cfgs(tbs=1000, rb_start=2, rb=12, iters=10, nof_grid_sc=624, crb_start=0):
    alloc = Allocation(rb_start=rb_start, rb_count=rb, sym_start=1, sym_count=12,
                       dmrs_symbols=(2,), crb_start=crb_start)
    common = dict(tbs=tbs, target_code_rate=0.3, modulation=Modulation.QPSK, alloc=alloc,
                  nof_layers=1, nof_grid_symbols=14, nof_grid_sc=nof_grid_sc)
    return (jpdsch.PdschConfig(nof_ports=1, **common),
            jpusch.PuschConfig(nof_rx_ports=1, nof_ldpc_iterations=iters, **common))


def _dl_both(jphy, tphy, req, data):
    gj = np.asarray(jphy.process_dl_tti(req, data))
    gt = tphy.process_dl_tti(tfapi.DlTtiRequest.from_reference(req),
                             tfapi.TxDataRequest.from_reference(data))
    assert gt.device.type == "cpu"
    assert_grid_close(to_np(gt), gj)
    return gj, to_np(gt)


def _ul_both(jphy, tphy, req, grid, prach_fd=None):
    """Both packages' SlotResults of one UL_TTI.request on the same grid
    (and PRACH buffer), held equal; returns the port's."""
    rj = jphy.process_ul_tti(req, grid,
                             prach_fd=None if prach_fd is None else jnp.asarray(prach_fd))
    rt = tphy.process_ul_tti(tfapi.UlTtiRequest.from_reference(req), torch.from_numpy(grid),
                             prach_fd=None if prach_fd is None else torch.from_numpy(prach_fd))
    assert [(c.rnti, c.harq_id, c.tb_crc_ok) for c in rt.crc] == \
        [(c.rnti, c.harq_id, c.tb_crc_ok) for c in rj.crc]
    for ct, cj in zip(rt.crc, rj.crc):
        assert abs(ct.snr_db - cj.snr_db) <= 1e-3, (ct.snr_db, cj.snr_db)
        assert (ct.ta_s is None) == (cj.ta_s is None)
        if cj.ta_s is not None:
            np.testing.assert_allclose(ct.ta_s, cj.ta_s, rtol=1e-6)
    assert [(d.rnti, d.harq_id) for d in rt.rx_data] == [(d.rnti, d.harq_id) for d in rj.rx_data]
    for dt, dj in zip(rt.rx_data, rj.rx_data):
        np.testing.assert_array_equal(dt.payload, np.asarray(dj.payload))
    assert [(u.rnti, u.valid) for u in rt.uci] == [(u.rnti, u.valid) for u in rj.uci]
    for ut, uj in zip(rt.uci, rj.uci):
        np.testing.assert_array_equal(np.asarray(ut.uci_bits), np.asarray(uj.uci_bits))
        np.testing.assert_allclose(ut.metric, uj.metric, rtol=1e-4, atol=1e-3)
    assert [(s.rnti, s.report_type) for s in rt.srs] == [(s.rnti, s.report_type) for s in rj.srs]
    for st, sj in zip(rt.srs, rj.srs):
        h_j = np.asarray(sj.h)
        assert st.h.shape == h_j.shape
        assert np.abs(st.h - h_j).max() <= 1e-4 * np.abs(h_j).max()
        assert abs(st.snr_db - sj.snr_db) <= 1e-3
        assert abs(st.phase_slope - sj.phase_slope) <= 1e-5
    assert len(rt.errors) == len(rj.errors)
    assert [(r.preamble_index, r.ta_samples) for r in rt.rach] == \
        [(r.preamble_index, r.ta_samples) for r in rj.rach]
    for r_t, r_j in zip(rt.rach, rj.rach):
        np.testing.assert_allclose(r_t.metric, r_j.metric, rtol=1e-4)
    return rt


def test_dl_slot_multi_pdu():
    """PDSCH + PDCCH + SSB + CSI-RS in one DL_TTI."""
    jphy, tphy = _phys(nof_ports=1)
    tx_cfg, _ = _pxsch_cfgs()
    rng = np.random.default_rng(0)
    tb = rng.integers(0, 2, size=(tx_cfg.tbs,), dtype=np.uint8)
    req = jfapi.DlTtiRequest(
        slot=_slot(),
        pdsch=[jfapi.DlPdschPdu(tx_cfg, 0x4601, np.eye(1, dtype=np.complex64), 0)],
        pdcch=[jfapi.DlPdcchPdu(
            jpdcch.PdcchConfig(payload_bits=40, aggregation_level=2, cce_index=0,
                               coreset_rb_start=20, coreset_rb_count=24, symbol=0),
            0x4601, rng.integers(0, 2, size=(40,), dtype=np.uint8))],
        ssb=[jfapi.DlSsbPdu(jssb.SsbConfig(pci=42), rng.integers(0, 2, size=(32,), dtype=np.uint8),
                            first_subcarrier=360, first_symbol=1)],
        csi_rs=[jfapi.DlCsiRsPdu(row=1, rb_start=0, rb_count=10, symbol=13, scrambling_id=7)])
    _, gt = _dl_both(jphy, tphy, req, jfapi.TxDataRequest(slot=_slot(), payloads=[tb]))
    assert gt.shape == (1, 14, 624)
    assert np.abs(gt[0, 0, 20 * 12 : 26 * 12]).max() > 0.1  # PDCCH
    assert np.abs(gt[0, 13, 0:120]).max() > 0.1  # CSI-RS


@pytest.mark.parametrize("crb_matches", [True, False], ids=["batched", "crb0-offset"])
def test_dl_compact_grants(monkeypatch, crb_matches):
    """Four equal-config compact 2-port grants at four PRB offsets, plus a
    full-grid PT-RS PDU: with crb_start == first_rb the four take one
    batch (``multi_bit_chain``, ``process_multi``'s first half), with
    crb_start = 0 they go one by one; the grid equals the JAX package's
    either way."""
    rb, offs = 8, (0, 10, 20, 30)
    calls = []
    real = tpdsch.multi_bit_chain
    monkeypatch.setattr(tpdsch, "multi_bit_chain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(3)
    pdus, tbs = [], []
    for i, off in enumerate(offs):
        alloc = Allocation(rb_start=0, rb_count=rb, sym_start=1, sym_count=13, dmrs_symbols=(2,),
                           crb_start=off if crb_matches else 0)
        cfg = jpdsch.PdschConfig(tbs=2000, target_code_rate=0.5, modulation=Modulation.QAM16,
                                 alloc=alloc, nof_layers=2, nof_ports=2, nof_grid_sc=rb * 12)
        w = (rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))).astype(np.complex64)
        pdus.append(jfapi.DlPdschPdu(cfg, 0x4601 + i, w, i, first_rb=off))
        tbs.append(rng.integers(0, 2, size=(2000,), dtype=np.uint8))
    ptrs_cfg = jpdsch.PdschConfig(
        tbs=1500, target_code_rate=0.5, modulation=Modulation.QAM16,
        alloc=Allocation(rb_start=40, rb_count=8, sym_start=1, sym_count=13, dmrs_symbols=(2,)),
        nof_layers=1, nof_ports=2, nof_grid_sc=624, ptrs_enabled=True)
    pdus.append(jfapi.DlPdschPdu(ptrs_cfg, 0x4700, np.ones((1, 2), np.complex64), 4))
    tbs.append(rng.integers(0, 2, size=(1500,), dtype=np.uint8))
    req = jfapi.DlTtiRequest(slot=_slot(2), pdsch=pdus)
    jphy, tphy = _phys(nof_ports=2)
    _dl_both(jphy, tphy, req, jfapi.TxDataRequest(slot=_slot(2), payloads=tbs))
    assert len(calls) == (1 if crb_matches else 0)


def test_ul_slot_pusch_and_pucch():
    """One full-grid PUSCH and a PUCCH F0 (per-PDU path)."""
    jphy, tphy = _phys(nof_ports=1)
    tx_cfg, rx_cfg = _pxsch_cfgs()
    rng = np.random.default_rng(1)
    tb = rng.integers(0, 2, size=(tx_cfg.tbs,), dtype=np.uint8)
    grid = np.asarray(jpdsch.process(tb, np.uint32(0x17), np.eye(1, dtype=np.complex64), tx_cfg))
    f0 = jpucch.PucchFormat0Config(prb=50, start_symbol=13, nof_symbols=1,
                                   initial_cyclic_shift=0, n_id=3, nof_harq_bits=1)
    grid = grid.copy()
    grid[0, 13, 50 * 12 : 51 * 12] = jpucch.format0_generate(f0, 1)[0]
    grid = (grid + 1e-3 + 0.01 * rng.standard_normal(grid.shape)).astype(np.complex64)
    req = jfapi.UlTtiRequest(slot=_slot(), pusch=[jfapi.UlPuschPdu(rx_cfg, 0x17, harq_id=2)],
                             pucch=[jfapi.UlPucchPdu(f0, 0x99)])
    rt = _ul_both(jphy, tphy, req, grid)
    assert rt.crc[0].tb_crc_ok
    np.testing.assert_array_equal(rt.rx_data[0].payload, tb)
    assert rt.uci[0].valid and rt.uci[0].uci_bits[0] == 1


def test_ul_multi_ue_slot_with_pucch(monkeypatch):
    """Four compact grants (two configs) through ul_slot.process_slot in
    one call, and PUCCH F0, F1 and F2 through ul_slot.detect_pucch after
    it; a fifth grant with crb_start != first_rb takes the per-PDU path."""
    calls = []
    real = tul.process_slot
    monkeypatch.setattr(tul, "process_slot", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(4)
    grid = np.zeros((2, 14, 624), np.complex64)
    pdus = []
    for i, (off, rb, mod) in enumerate(((0, 8, Modulation.QPSK), (8, 8, Modulation.QPSK),
                                        (16, 12, Modulation.QAM16), (28, 12, Modulation.QAM16),
                                        (40, 6, Modulation.QPSK))):
        crb = off if i < 4 else 0
        alloc = Allocation(rb_start=0, rb_count=rb, sym_start=1, sym_count=13, dmrs_symbols=(2,),
                           crb_start=crb)
        common = dict(tbs=rb * 100, target_code_rate=0.5, modulation=mod, alloc=alloc,
                      nof_layers=1, nof_grid_sc=rb * 12)
        tx = jpdsch.PdschConfig(nof_ports=2, **common)
        rx = jpusch.PuschConfig(nof_rx_ports=2, **common)
        tb = rng.integers(0, 2, size=(rx.tbs,), dtype=np.uint8)
        w = (rng.standard_normal((1, 2)) + 1j * rng.standard_normal((1, 2))).astype(np.complex64)
        sub = np.asarray(jpdsch.process(tb, np.uint32(0x4601 + i), w / np.linalg.norm(w), tx))
        grid[:, :, off * 12 : (off + rb) * 12] += sub
        pdus.append(jfapi.UlPuschPdu(rx, 0x4601 + i, harq_id=i, first_rb=off))
    f0 = jpucch.PucchFormat0Config(prb=48, start_symbol=12, nof_symbols=2,
                                   initial_cyclic_shift=0, n_id=1, nof_harq_bits=2)
    f1 = jpucch.PucchFormat1Config(prb=49, start_symbol=0, nof_symbols=14,
                                   initial_cyclic_shift=3, occ_index=0, n_id=1, nof_harq_bits=1)
    f2 = jf2.PucchFormat2Config(rb_start=50, rb_count=2, start_symbol=12, nof_symbols=2,
                                nof_uci_bits=11, rnti=0x4711, n_id=1, n_id0=1, nof_rx_ports=2)
    grid[:, 12:14, 48 * 12 : 49 * 12] += np.asarray(jpucch.format0_generate(f0, 2))[None]
    f1_sig = np.asarray(jpucch.format1_generate(f1, np.asarray([1], np.uint8)))
    grid[:, :, 49 * 12 : 50 * 12] += f1_sig[None]
    f2_bits = rng.integers(0, 2, size=(11,), dtype=np.uint8)
    grid += np.asarray(jf2.generate(f2, f2_bits))[None] * np.asarray([1.0, 0.5])[:, None, None]
    grid = (grid + 0.02 * (rng.standard_normal(grid.shape) + 1j * rng.standard_normal(grid.shape))
            ).astype(np.complex64)
    req = jfapi.UlTtiRequest(slot=_slot(4), pusch=pdus,
                             pucch=[jfapi.UlPucchPdu(c, 0x4800 + k) for k, c in enumerate((f0, f1, f2))])
    jphy, tphy = _phys(nof_ports=2)
    rt = _ul_both(jphy, tphy, req, grid)
    assert len(calls) == 1
    assert all(c.tb_crc_ok for c in rt.crc) and len(rt.rx_data) == 5
    assert [u.valid for u in rt.uci] == [True, True, True]
    np.testing.assert_array_equal(rt.uci[2].uci_bits, f2_bits)


def test_harq_retransmission_combining():
    """rv 0 fails alone; the retransmission in a second call combines with
    the pooled buffer and passes, in both packages alike."""
    jphy, tphy = _phys(nof_ports=1)
    tx_cfg, rx_cfg = _pxsch_cfgs(tbs=1000, rb=12)
    rng = np.random.default_rng(2)
    tb = rng.integers(0, 2, size=(tx_cfg.tbs,), dtype=np.uint8)
    clean = np.asarray(jpdsch.process(tb, np.uint32(0x21), np.eye(1, dtype=np.complex64), tx_cfg))

    def noisy():
        return (clean + 0.9 * (rng.standard_normal(clean.shape)
                               + 1j * rng.standard_normal(clean.shape))).astype(np.complex64)

    oks = []
    for new_data in (True, False, False):
        req = jfapi.UlTtiRequest(slot=_slot(),
                                 pusch=[jfapi.UlPuschPdu(rx_cfg, 0x21, 0, new_data=new_data)])
        rt = _ul_both(jphy, tphy, req, noisy())
        oks.append(rt.crc[0].tb_crc_ok)
        if oks[-1]:
            break
        assert tphy.harq_pool.get(0x21, 0) is not None
    assert not oks[0] and oks[-1], oks
    assert tphy.harq_pool.get(0x21, 0) is None  # released on success


def test_srs_dispatch():
    jphy, tphy = _phys(nof_ports=2)
    rng = np.random.default_rng(6)
    grid = np.zeros((2, 14, 624), np.complex64)
    cfgs = [jsrs.SrsConfig(rb_start=0, rb_count=16, start_symbol=13, nof_symbols=1, comb=2,
                           sequence_id=3, nof_rx_ports=2),
            jsrs.SrsConfig(rb_start=20, rb_count=24, start_symbol=10, nof_symbols=2, comb=4,
                           comb_offset=1, sequence_id=11, nof_rx_ports=2),
            jsrs.SrsConfig(rb_start=4, rb_count=40, start_symbol=8, nof_symbols=1, comb=2,
                           comb_offset=1, sequence_id=5, cyclic_shift=1, nof_antenna_ports=2,
                           nof_rx_ports=2)]
    for c in cfgs:
        sig = np.asarray(jsrs.generate(c))
        sig = sig[None] if sig.ndim == 2 else sig
        h = (rng.standard_normal((2, sig.shape[0])) + 1j * rng.standard_normal((2, sig.shape[0])))
        grid += np.einsum("rt,tsk->rsk", 0.7 * h, sig).astype(np.complex64)
    grid = (grid + 0.01 * rng.standard_normal(grid.shape)).astype(np.complex64)
    req = jfapi.UlTtiRequest(slot=_slot(), srs=[jfapi.UlSrsPdu(c, 0x55 + k)
                                                for k, c in enumerate(cfgs)])
    rt = _ul_both(jphy, tphy, req, grid)
    assert [s.h.shape for s in rt.srs] == [(2, 96), (2, 72), (2, 2, 240)]


def test_rx_symbols_dump(tmp_path):
    jphy, tphy = _phys(nof_ports=1)
    jphy.cfg.rx_symbols_filename = str(tmp_path / "rx_j")
    tphy.cfg.rx_symbols_filename = str(tmp_path / "rx_t")
    grid = np.zeros((1, 14, 624), np.complex64)
    grid[0, 0, 0] = 1 + 1j
    grid[0, 5, 7] = 0.123456789 - 2.5j
    req = jfapi.UlTtiRequest(slot=_slot(7))
    _ul_both(jphy, tphy, req, grid)
    raw_t = (tmp_path / "rx_t.7").read_bytes()
    assert raw_t == (tmp_path / "rx_j.7").read_bytes()
    dumped = tfv.read_vector(str(tmp_path / "rx_t.7"), "cbf16")
    np.testing.assert_array_equal(dumped, jfv.read_vector(str(tmp_path / "rx_j.7"), "cbf16"))
    assert dumped.shape == (14 * 624,)


def test_ul_dci_request():
    jphy, tphy = _phys(nof_ports=2)
    cfg = jpdcch.PdcchConfig(payload_bits=40, aggregation_level=4, cce_index=0,
                             coreset_rb_start=0, coreset_rb_count=48, nof_grid_sc=624)
    rng = np.random.default_rng(0)
    req = jfapi.UlDciRequest(slot=_slot(), pdcch=[
        jfapi.DlPdcchPdu(cfg, 0x4601, rng.integers(0, 2, size=(40,), dtype=np.uint8))])
    treq = tfapi.UlDciRequest.from_reference(req)
    assert_grid_close(to_np(tphy.process_ul_dci(treq)), np.asarray(jphy.process_ul_dci(req)))
    base = (rng.standard_normal((2, 14, 624)) * 0.1).astype(np.complex64)
    base_t = torch.from_numpy(base)
    assert_grid_close(to_np(tphy.process_ul_dci(treq, base_t)),
                      np.asarray(jphy.process_ul_dci(req, jnp.asarray(base))))
    np.testing.assert_array_equal(to_np(base_t), base)


def test_phy_tap_observers():
    from srsran_project_tpu_torch.models import cell as tcell

    cell = tcell.tiny_cell()
    phy = TUpperPhy(TUpperPhyConfig(nof_ports=cell.nof_ports, nof_grid_sc=cell.nof_sc,
                                    device="cpu"))
    events = []
    phy.add_tap(lambda ev, slot, payload: events.append((ev, slot.count, type(payload).__name__)))
    tb = np.random.default_rng(0).integers(0, 2, size=(cell.tbs,), dtype=np.uint8)
    w = np.eye(cell.nof_layers, cell.nof_ports, dtype=np.complex64)
    slot = tfapi.SlotPoint.from_sfn_slot(cell.scs, 0, 1)
    dl = tfapi.DlTtiRequest(slot=slot, pdsch=[tfapi.DlPdschPdu(cell.pdsch_cfg, 0x4601, w, 0)])
    grid = phy.process_dl_tti(dl, tfapi.TxDataRequest(slot=slot, payloads=[tb]))
    ul = tfapi.UlTtiRequest(slot=slot, pusch=[tfapi.UlPuschPdu(cell.pusch_cfg, 0x4601)])
    res = phy.process_ul_tti(ul, grid)
    assert res.crc[0].tb_crc_ok
    assert events == [("dl_grid", 1, "Tensor"), ("ul_grid", 1, "Tensor"),
                      ("ul_results", 1, "SlotResults")]
    phy.remove_tap(phy._taps[0])
    assert not phy._taps


def test_validators():
    """A valid request passes both packages' validators; each broken one
    raises ValidationError in both, the port's through UpperPhy."""
    tx_cfg, rx_cfg = _pxsch_cfgs()
    tb = np.zeros(tx_cfg.tbs, np.uint8)
    pdsch = jfapi.DlPdschPdu(tx_cfg, 1, np.eye(1, dtype=np.complex64), 0)
    ok = (jfapi.DlTtiRequest(slot=_slot(), pdsch=[pdsch]),
          jfapi.TxDataRequest(slot=_slot(), payloads=[tb]))
    bad = [
        (jfapi.DlTtiRequest(slot=_slot(), pdsch=[pdsch]),
         jfapi.TxDataRequest(slot=_slot(1), payloads=[tb])),  # slots differ
        (jfapi.DlTtiRequest(slot=_slot(), pdsch=[pdsch, dataclasses.replace(pdsch, tb_index=1)]),
         jfapi.TxDataRequest(slot=_slot(), payloads=[tb, tb])),  # overlap
        (jfapi.DlTtiRequest(slot=_slot(), pdsch=[pdsch]),
         jfapi.TxDataRequest(slot=_slot(), payloads=[tb[:-8]])),  # TB size
        (jfapi.DlTtiRequest(slot=_slot(), ssb=[jfapi.DlSsbPdu(jssb.SsbConfig(pci=1),
                                                               np.zeros(32, np.uint8), 500, 0)]),
         jfapi.TxDataRequest(slot=_slot())),  # SSB outside the grid
    ]
    jval.validate_dl_tti(*ok, 624)
    tval.validate_dl_tti(tfapi.DlTtiRequest.from_reference(ok[0]),
                         tfapi.TxDataRequest.from_reference(ok[1]), 624)
    tphy = TUpperPhy(TUpperPhyConfig(device="cpu", validate_requests=True))
    for req, data in bad:
        with pytest.raises(jval.ValidationError):
            jval.validate_dl_tti(req, data, 624)
        with pytest.raises(tval.ValidationError):
            tphy.process_dl_tti(tfapi.DlTtiRequest.from_reference(req),
                                tfapi.TxDataRequest.from_reference(data))
    pusch = jfapi.UlPuschPdu(rx_cfg, 1)
    for req in (jfapi.UlTtiRequest(slot=_slot(), pusch=[pusch, dataclasses.replace(pusch, rnti=2)]),
                jfapi.UlTtiRequest(slot=_slot(), pusch=[dataclasses.replace(pusch, harq_id=16)])):
        with pytest.raises(jval.ValidationError):
            jval.validate_ul_tti(req, 624)
        with pytest.raises(tval.ValidationError):
            tphy.process_ul_tti(tfapi.UlTtiRequest.from_reference(req),
                                torch.zeros((1, 14, 624), dtype=torch.complex64))
    from srsran_project_tpu.phy import validators as jpv
    from srsran_project_tpu_torch.phy import validators as tpv

    for c in (tx_cfg, dataclasses.replace(tx_cfg, nof_layers=2), dataclasses.replace(tx_cfg, rv=4)):
        assert tpv.validate_pdsch(tpdsch.PdschConfig.from_reference(c)) == jpv.validate_pdsch(c)


def test_ul_tti_refuses_prach_and_other_devices():
    """A PRACH PDU without a PRACH buffer gets an ErrorIndication, as in
    the reference, and the rest of the request is still answered; a
    received grid or PRACH buffer on another device than the PHY's, or not
    a tensor, raises ValueError (no silent move)."""
    tphy = TUpperPhy(TUpperPhyConfig(device="cpu"))
    prach = tfapi.UlPrachPdu(tfapi.PrachConfig(l_ra=839, zero_correlation_zone=1))
    grid = torch.zeros((1, 14, 624), dtype=torch.complex64)
    res = tphy.process_ul_tti(tfapi.UlTtiRequest(slot=_slot(), prach=[prach]), grid)
    assert [e.message for e in res.errors] == ["PRACH requested, no buffer"] and not res.rach
    with pytest.raises(ValueError, match="lives on cpu"):
        TUpperPhy(TUpperPhyConfig(device="meta")).process_ul_tti(
            tfapi.UlTtiRequest(slot=_slot(), prach=[prach]),
            torch.zeros((1, 14, 624), device="meta"),
            prach_fd=torch.zeros((1, 839), dtype=torch.complex64))
    with pytest.raises(ValueError, match="torch tensor"):
        tphy.process_ul_tti(tfapi.UlTtiRequest(slot=_slot()), np.zeros((1, 14, 624), np.complex64))
    meta = TUpperPhy(TUpperPhyConfig(device="meta"))
    with pytest.raises(ValueError, match="lives on cpu"):
        meta.process_ul_tti(tfapi.UlTtiRequest(slot=_slot()), grid)
    with pytest.raises(ValueError, match="lives on cpu"):
        meta.process_ul_dci(tfapi.UlDciRequest(slot=_slot()), grid)
    assert TUpperPhyConfig().device == "cuda"


def test_pucch_f34_error_indication():
    """A PUCCH format without a detector (F3) gets an ErrorIndication, as
    in the reference."""
    from srsran_project_tpu.phy import pucch_f34 as jf34

    c = jf34.PucchFormat34Config(prb_start=10, nof_prb=1, start_symbol=0, nof_symbols=14,
                                 nof_uci_bits=4, rnti=1)
    req = jfapi.UlTtiRequest(slot=_slot(), pucch=[jfapi.UlPucchPdu(c, 0x77)])
    jphy, tphy = _phys(nof_ports=1)
    rt = _ul_both(jphy, tphy, req, np.zeros((1, 14, 624), np.complex64))
    assert len(rt.errors) == 1 and not rt.uci


def _prach_fd(cfg, preambles, ports: int, seed: int) -> np.ndarray:
    """(ports, L_RA) demodulated occasion: each (preamble, delay in bins
    of the dft_size-point profile) at unit power a subcarrier through a
    random gain per port, plus AWGN at 0 dB."""
    from srsran_project_tpu.phy import prach as jprach

    rng = np.random.default_rng(seed)
    n = np.arange(cfg.l_ra)
    rx = np.zeros((ports, cfg.l_ra), np.complex128)
    for pi, d in preambles:
        g = (rng.standard_normal(ports) + 1j * rng.standard_normal(ports)) / np.sqrt(2)
        rx += g[:, None] * (jprach.generate_preamble(cfg, pi) / np.sqrt(cfg.l_ra)
                            * np.exp(-2j * np.pi * n * d / cfg.dft_size))[None]
    rx += np.sqrt(0.5) * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    return rx.astype(np.complex64)


@pytest.mark.parametrize("case", ["two-preambles", "short", "noise-only"])
def test_ul_tti_prach(case):
    """A PUSCH grant and a PRACH PDU in one UL_TTI: both packages' CRC and
    RACH indications equal on the same prach_fd (PRACH processed after
    the rest), the sent preambles found with their TA bins."""
    from srsran_project_tpu.phy import prach as jprach

    kw, preambles = {
        "two-preambles": (dict(zero_correlation_zone=8, nof_rx_ports=2), ((5, 3), (50, 12))),
        "short": (dict(l_ra=139, zero_correlation_zone=7, nof_rx_ports=2, dft_size=256,
                       root_sequence_index=5), ((40, 4),)),
        "noise-only": (dict(zero_correlation_zone=8, nof_rx_ports=2), ()),
    }[case]
    pcfg = jprach.PrachConfig(**kw)
    tx_cfg, rx_cfg = _pxsch_cfgs(iters=6)
    rng = np.random.default_rng(11)
    tb = rng.integers(0, 2, size=(tx_cfg.tbs,), dtype=np.uint8)
    jphy, tphy = _phys(nof_ports=1)
    grid = np.asarray(jpdsch.process(jnp.asarray(tb), jnp.uint32(0x4601),
                                     jnp.eye(1, dtype=jnp.complex64), tx_cfg))
    req = jfapi.UlTtiRequest(slot=_slot(4), pusch=[jfapi.UlPuschPdu(rx_cfg, 0x4601, 0)],
                             prach=[jfapi.UlPrachPdu(pcfg)])
    rt = _ul_both(jphy, tphy, req, grid.astype(np.complex64),
                  prach_fd=_prach_fd(pcfg, preambles, 2, seed=len(case)))
    assert [c.tb_crc_ok for c in rt.crc] == [True] and not rt.errors
    assert [r.preamble_index for r in rt.rach] == sorted(pi for pi, _d in preambles)
    for r, (_pi, d) in zip(rt.rach, sorted(preambles)):
        assert 0 <= r.ta_samples - d <= 1


def test_ul_tti_reports_ta():
    """A grant with compute_ta: the CRC indication's ta_s equal to the
    reference's and within one bin of the delay."""
    tx_cfg, rx_cfg = _pxsch_cfgs(iters=6)
    rx_cfg = dataclasses.replace(rx_cfg, compute_ta=True)
    rng = np.random.default_rng(12)
    tb = rng.integers(0, 2, size=(tx_cfg.tbs,), dtype=np.uint8)
    grid = np.asarray(jpdsch.process(jnp.asarray(tb), jnp.uint32(0x4601),
                                     jnp.eye(1, dtype=jnp.complex64), tx_cfg))
    grid = (grid * np.exp(-2j * np.pi * np.arange(624) * 30e3 * 0.3e-6)).astype(np.complex64)
    jphy, tphy = _phys(nof_ports=1)
    req = jfapi.UlTtiRequest(slot=_slot(5), pusch=[jfapi.UlPuschPdu(rx_cfg, 0x4601, 0)])
    rt = _ul_both(jphy, tphy, req, grid)
    assert rt.crc[0].tb_crc_ok and abs(rt.crc[0].ta_s - 0.3e-6) < 1.0 / (4096 * 120e3)
