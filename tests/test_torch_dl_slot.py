"""The port's downlink channels against the JAX package: PDCCH (with the UE
side ``receive``), SSB/PBCH (with ``decode_pbch``), CSI-RS, the broadcast
assembly of ``dl_slot`` and ``pdsch.process_multi``.  Coded bits and
decoded bits are exact; grids agree within 1e-6 x their RMS (the same
float32 values, with the FMA contraction of XLA:CPU's precoding as the
only rounding difference)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np

from srsran_project_tpu.fapi import messages as jfapi
from srsran_project_tpu.ops import polar as jpolar
from srsran_project_tpu.ops import scrambling as jscr
from srsran_project_tpu.ops.modulation import Modulation as JMod
from srsran_project_tpu.phy import csi_rs as jcsi
from srsran_project_tpu.phy import dl_slot as jdl
from srsran_project_tpu.phy import pdcch as jpdcch
from srsran_project_tpu.phy import pdsch as jpdsch
from srsran_project_tpu.phy import ssb as jssb
from srsran_project_tpu.phy.allocation import Allocation as JAlloc
from srsran_project_tpu.phy.upper_phy import UpperPhyConfig as JUpperPhyConfig
from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
from srsran_project_tpu.ran.slot_point import SlotPoint as JSlot
from srsran_project_tpu_torch.fapi import messages as tfapi
from srsran_project_tpu_torch.ops import polar as tpolar
from srsran_project_tpu_torch.ops import scrambling as tscr
from srsran_project_tpu_torch.phy import csi_rs as tcsi
from srsran_project_tpu_torch.phy import dl_slot as tdl
from srsran_project_tpu_torch.phy import pdcch as tpdcch
from srsran_project_tpu_torch.phy import pdsch as tpdsch
from srsran_project_tpu_torch.phy import ssb as tssb
from srsran_project_tpu_torch.phy.upper_phy import UpperPhyConfig as TUpperPhyConfig


def assert_grid_close(got, want, rel=1e-6):
    """Every element within rel x the RMS of the reference grid."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    rms = float(np.sqrt(np.mean(np.abs(want) ** 2)))
    assert rms > 0
    err = float(np.abs(got - want).max())
    assert err <= rel * rms, (err, rms)


# (aggregation level, duration, interleaved, REG bundle, rows, CORESET PRBs,
# n_id, n_rnti, slot): aggregation levels 1-16, durations 1-3, the largest
# n_id / n_rnti (their c_init overflows 31 bits).
PDCCH_CASES = [
    (1, 1, False, 6, 2, 24, 0, 0, 0),
    (2, 1, True, 6, 2, 24, 1, 0x4601, 3),
    (4, 2, True, 2, 3, 24, 500, 77, 7),
    (8, 3, True, 3, 2, 24, 65535, 65535, 19),
    (16, 3, False, 6, 2, 36, 1007, 0xFFFF, 1),
    (16, 2, True, 6, 2, 48, 9, 12, 10),
]


def _pdcch_cfgs(case, nof_grid_sc=624, payload_bits=41):
    al, dur, il, bundle, rows, nrb, n_id, n_rnti, slot = case
    jc = jpdcch.PdcchConfig(payload_bits=payload_bits, aggregation_level=al, cce_index=0,
                            coreset_rb_start=2, coreset_rb_count=nrb, symbol=0, duration=dur,
                            interleaved=il, reg_bundle_size=bundle, interleaver_rows=rows,
                            shift_index=5 if il else 0, n_id=n_id, n_rnti=n_rnti,
                            nof_grid_sc=nof_grid_sc, slot_in_frame=slot)
    return jc, tpdcch.PdcchConfig.from_reference(jc)


@pytest.mark.parametrize("case", PDCCH_CASES, ids=[f"al{c[0]}-d{c[1]}-{'il' if c[2] else 'nil'}"
                                                   for c in PDCCH_CASES])
def test_pdcch_process_and_receive(case):
    jc, tc = _pdcch_cfgs(case)
    assert tpdcch._re_indices(tc)[0].tolist() == jpdcch._re_indices(jc)[0].tolist()
    rng = np.random.default_rng(case[0] * 10 + case[1])
    pay = rng.integers(0, 2, size=(jc.payload_bits,), dtype=np.uint8)
    rnti = 0xFFFF if case[7] == 0xFFFF else 0x4601 + case[0]
    # Coded bits (CRC + RNTI mask, polar, scrambling) exact.
    cw_j = np.asarray(jscr.scramble_bits(
        jpolar.encode(jpdcch._crc24c_with_rnti(jnp.asarray(pay), jnp.uint32(rnti)), jc.code,
                      interleave_input=True),
        (jnp.uint32(jc.n_rnti) << 16) + jnp.uint32(jc.n_id)))
    cw_t = to_np(tscr.scramble_bits(
        tpolar.encode(tpdcch._crc24c_with_rnti(torch.from_numpy(pay), torch.tensor(rnti)),
                      tc.code, interleave_input=True),
        torch.tensor((tc.n_rnti << 16) + tc.n_id)))
    np.testing.assert_array_equal(cw_t, cw_j)
    gj = np.asarray(jpdcch.process(jnp.asarray(pay), jnp.uint32(rnti), jc))
    gt = to_np(tpdcch.process(torch.from_numpy(pay), rnti, tc))
    assert_grid_close(gt, gj)
    # The UE side on a noisy, rotated grid: same bits and verdict; a wrong
    # RNTI fails the CRC in both.
    noisy = (gj * np.exp(0.4j) + 0.08 * (rng.standard_normal(gj.shape)
                                         + 1j * rng.standard_normal(gj.shape))).astype(np.complex64)
    for r, want_ok in ((rnti, True), (rnti ^ 0x0101, False)):
        bj, okj = jpdcch.receive(jnp.asarray(noisy), jnp.uint32(r), jc)
        bt, okt = tpdcch.receive(torch.from_numpy(noisy), r, tc)
        assert bool(okj) == bool(okt) == want_ok
        np.testing.assert_array_equal(to_np(bt), np.asarray(bj))
    np.testing.assert_array_equal(to_np(bt), pay)


@pytest.mark.parametrize("l_max, ssb_index, hrf, sfn_2lsb, pci",
                         [(4, 3, 1, 0, 0), (8, 5, 0, 2, 1007), (64, 37, 1, 3, 503)])
def test_ssb_and_pbch(l_max, ssb_index, hrf, sfn_2lsb, pci):
    jc = jssb.SsbConfig(pci=pci, ssb_index=ssb_index, l_max=l_max, sfn_2lsb=sfn_2lsb, hrf=hrf)
    tc = tssb.SsbConfig.from_reference(jc)
    rng = np.random.default_rng(ssb_index)
    mib = rng.integers(0, 2, size=(24,), dtype=np.uint8)
    pay = tssb.pbch_pack_payload(mib, sfn=4 * sfn_2lsb + 2, hrf=hrf, ssb_index=ssb_index,
                                 l_max=l_max, k_ssb=17)
    np.testing.assert_array_equal(
        pay, jssb.pbch_pack_payload(mib, sfn=4 * sfn_2lsb + 2, hrf=hrf, ssb_index=ssb_index,
                                    l_max=l_max, k_ssb=17))
    np.testing.assert_array_equal(tssb._first_scrambling_mask(tc), jssb._first_scrambling_mask(jc))
    for nid2 in range(3):
        np.testing.assert_array_equal(tssb.pss_sequence(nid2), jssb.pss_sequence(nid2))
    np.testing.assert_array_equal(tssb.sss_sequence(tc.nid1, tc.nid2),
                                  jssb.sss_sequence(jc.nid1, jc.nid2))
    cw_j = np.asarray(jssb.encode_pbch(jnp.asarray(pay), jc))
    np.testing.assert_array_equal(to_np(tssb.encode_pbch(torch.from_numpy(pay), tc)), cw_j)
    gj = np.asarray(jssb.assemble_ssb(jnp.asarray(pay), jc))
    assert_grid_close(to_np(tssb.assemble_ssb(torch.from_numpy(pay), tc)), gj)
    llr = ((1.0 - 2.0 * cw_j) * 2.0 + rng.standard_normal(cw_j.shape) * 1.2).astype(np.float32)
    pj, okj = jssb.decode_pbch(jnp.asarray(llr), jc)
    pt, okt = tssb.decode_pbch(torch.from_numpy(llr), tc)
    assert bool(okj) and bool(okt)
    np.testing.assert_array_equal(to_np(pt), np.asarray(pj))
    np.testing.assert_array_equal(to_np(pt), pay)


# (row, extra fields): single port (1, 2), FD-CDM2 (3, 4, 5), CDM4 (8, 14),
# CDM8 (15, 18: 32 ports), four symbol locations (13).
CSI_CASES = [(1, {}), (2, {"k0": 3}), (3, {"k0": 6}), (4, {}), (5, {}), (8, {}),
             (13, {"symbol2": 9}), (14, {"symbol2": 10}), (15, {}), (18, {})]


@pytest.mark.parametrize("row, extra", CSI_CASES, ids=[f"row{c[0]}" for c in CSI_CASES])
def test_csi_rs_generate(row, extra):
    jc = jcsi.CsiRsConfig(rb_start=2, rb_count=22, symbol=5, scrambling_id=1000 + row, row=row,
                          slot_in_frame=7, nof_grid_sc=288, **extra)
    tc = tcsi.CsiRsConfig.from_reference(jc)
    assert tc.nof_ports == jc.nof_ports
    gj = np.asarray(jcsi.generate(jc, 0.5))
    assert_grid_close(to_np(tcsi.generate(tc, 0.5, device="cpu")), gj)


def _broadcast_request(slot_in_frame=3):
    rng = np.random.default_rng(5)
    pc1 = jpdcch.PdcchConfig(payload_bits=40, aggregation_level=2, cce_index=0,
                             coreset_rb_start=20, coreset_rb_count=24, symbol=0,
                             slot_in_frame=slot_in_frame)
    pc2 = jpdcch.PdcchConfig(payload_bits=28, aggregation_level=2, cce_index=2,
                             coreset_rb_start=20, coreset_rb_count=24, symbol=0, duration=1,
                             interleaved=True, n_rnti=0x4602, slot_in_frame=slot_in_frame)
    return jfapi.DlTtiRequest(
        slot=JSlot.from_sfn_slot(JScs.KHZ30, 5, slot_in_frame),
        pdcch=[jfapi.DlPdcchPdu(pc1, 0x4601, rng.integers(0, 2, size=(40,), dtype=np.uint8)),
               jfapi.DlPdcchPdu(pc2, 0x4602, rng.integers(0, 2, size=(28,), dtype=np.uint8))],
        ssb=[jfapi.DlSsbPdu(jssb.SsbConfig(pci=42), rng.integers(0, 2, size=(32,), dtype=np.uint8),
                            first_subcarrier=360, first_symbol=1)],
        csi_rs=[jfapi.DlCsiRsPdu(row=1, rb_start=0, rb_count=10, symbol=13, scrambling_id=7),
                jfapi.DlCsiRsPdu(row=1, rb_start=12, rb_count=8, symbol=12, scrambling_id=9)])


def test_assemble_broadcast():
    """Two PDCCH (one interleaved), an SSB and two CSI-RS onto port 0 of a
    2-port grid that already holds data: equal to the JAX package's, and
    to the sum of each PDU's own function."""
    jreq = _broadcast_request()
    treq = tfapi.DlTtiRequest.from_reference(jreq)
    rng = np.random.default_rng(1)
    base = ((rng.standard_normal((2, 14, 624)) + 1j * rng.standard_normal((2, 14, 624)))
            * 0.1).astype(np.complex64)
    gj = np.asarray(jdl.assemble_broadcast(jnp.asarray(base), jreq,
                                           JUpperPhyConfig(nof_ports=2)))
    base_t = torch.from_numpy(base)
    gt = to_np(tdl.assemble_broadcast(base_t, treq, TUpperPhyConfig(nof_ports=2, device="cpu")))
    np.testing.assert_array_equal(to_np(base_t), base)  # the input grid is left alone
    assert_grid_close(gt, gj)
    want = base.copy()
    for p in treq.pdcch:
        want[0] += to_np(tpdcch.process(torch.from_numpy(p.payload), p.rnti, p.config))
    want[0, 1:5, 360:600] += to_np(tssb.assemble_ssb(torch.from_numpy(treq.ssb[0].payload),
                                                     treq.ssb[0].config))
    for p in treq.csi_rs:
        want[0] += to_np(tcsi.generate(tdl.csi_rs_config(p, 3, TUpperPhyConfig()), device="cpu"))
    np.testing.assert_array_equal(gt, want)


def test_assemble_broadcast_refuses_other_csi_rs_rows():
    """The reference's slot builds every CSI-RS PDU as row 1 whatever its
    row; the port refuses another row instead of sending row 1."""
    treq = tfapi.DlTtiRequest.from_reference(_broadcast_request())
    treq.csi_rs[1] = dataclasses.replace(treq.csi_rs[1], row=4)
    with pytest.raises(ValueError, match="row 4"):
        tdl.assemble_broadcast(torch.zeros((1, 14, 624), dtype=torch.complex64), treq,
                               TUpperPhyConfig(device="cpu"))


# (DM-RS type, CDM groups without data, DM-RS symbols): the fast rows, the
# scatter assembly with data on the DM-RS symbols, and DM-RS type 2.
MULTI_SHAPES = [(1, 2, (2,)), (1, 1, (2, 11)), (2, 3, (3,))]


@pytest.mark.parametrize("dmrs_type, cdm, dmrs_syms", MULTI_SHAPES,
                         ids=["fast-rows", "data-on-dmrs", "type2"])
def test_process_multi(dmrs_type, cdm, dmrs_syms):
    """Three equal-config compact grants at three PRB offsets, each with
    its own RNTI and precoding, added into an existing slot grid: coded
    bits exact, grid within 1e-6 x RMS of the JAX package's."""
    alloc = JAlloc(rb_start=0, rb_count=8, sym_start=1, sym_count=13, dmrs_symbols=dmrs_syms,
                   dmrs_config_type=dmrs_type, nof_cdm_groups_without_data=cdm)
    jc = jpdsch.PdschConfig(tbs=1800, target_code_rate=0.5, modulation=JMod.QAM16, alloc=alloc,
                            nof_layers=2, nof_ports=2, nof_grid_sc=96, slot_in_frame=3, n_id=7,
                            dmrs_scrambling_id=11)
    tc = tpdsch.PdschConfig.from_reference(jc)
    rng = np.random.default_rng(dmrs_type * 10 + cdm)
    tbs = rng.integers(0, 2, size=(3, jc.tbs), dtype=np.uint8)
    rntis = np.asarray([1, 0xFFFF, 0x4601], np.uint32)
    offs = [0, 8, 23]
    w = (rng.standard_normal((3, 2, 2)) + 1j * rng.standard_normal((3, 2, 2))).astype(np.complex64)
    base = (rng.standard_normal((2, 14, 372)) * 0.01).astype(np.complex64)
    bank_t = tpdsch._multi_dmrs_bank(tc, tuple(offs))
    np.testing.assert_array_equal(bank_t, jpdsch._multi_dmrs_bank(jc, tuple(offs)))
    for i in range(3):
        cw_j = np.asarray(jpdsch._bit_chain(jnp.asarray(tbs[i]), jnp.uint32(rntis[i]), jc))
        cw_t = to_np(tpdsch._bit_chain(torch.from_numpy(tbs), torch.from_numpy(
            rntis.astype(np.int64)), tc)[i])
        np.testing.assert_array_equal(cw_t, cw_j)
    gj = np.asarray(jpdsch.process_multi(tbs, rntis, offs, w, jc, grid=jnp.asarray(base)))
    gt = tpdsch.process_multi(torch.from_numpy(tbs), torch.from_numpy(rntis.astype(np.int64)),
                              offs, torch.from_numpy(w), tc, grid=torch.from_numpy(base))
    assert_grid_close(to_np(gt), gj)
    # Shared precoding, no grid given: the slot spans the last window.
    gj = np.asarray(jpdsch.process_multi(tbs, rntis, offs, w[0], jc))
    gt = to_np(tpdsch.process_multi(torch.from_numpy(tbs), rntis.astype(np.int64), offs,
                                    torch.from_numpy(w[0]), tc))
    assert gt.shape == (2, 14, 12 * 31)
    assert_grid_close(gt, gj)


def test_process_multi_refuses_ptrs():
    alloc = JAlloc(rb_start=0, rb_count=8, sym_start=1, sym_count=13, dmrs_symbols=(2,))
    jc = jpdsch.PdschConfig(tbs=1800, target_code_rate=0.5, modulation=JMod.QAM16, alloc=alloc,
                            nof_grid_sc=96, ptrs_enabled=True)
    with pytest.raises(ValueError, match="PT-RS"):
        tpdsch.process_multi(torch.zeros((2, 1800), dtype=torch.uint8), [1, 2], [0, 8],
                             torch.eye(1), tpdsch.PdschConfig.from_reference(jc))
