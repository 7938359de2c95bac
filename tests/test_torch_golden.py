"""The reference's conformance vectors (tests/golden, written by the
reference implementation's own processors) replayed through the port, with
the JAX package's vector tests' bounds:

* ``pdsch_processor``: all five grids through the port's ``pdsch.process``
  within 8e-3 (the cbf16 rounding of the stored grids;
  tests/vectors/test_golden_pdsch_processor.py), case 4 with data on the
  DM-RS symbols;
* ``pusch_processor_rx``: all six grids through the port's
  ``pusch.process``, CRC OK and the TB equal, cases 4 and 5 transform
  precoded with QPSK and pi/2-BPSK;
* ``transform_precoder``: the deprecode within 2e-4 and the noise
  averaging within rtol 2e-3 (tests/vectors/test_golden_tail.py);
* ``mod_mapper``: the pi/2-BPSK, BPSK and QPSK cases within 1e-6
  (tests/vectors/test_golden_modulation.py);
* ``pdcch_processor``, ``ssb_processor`` and ``csi_rs_generator``: the
  grids of the port's ``pdcch.process``, ``ssb.assemble_ssb`` and
  ``csi_rs.generate`` within 8e-3, silence outside the SSB block
  (tests/vectors/test_golden_dl_proc.py);
* ``srs_estimator``: the port's ``srs.estimate`` against the reference
  estimator's TA (3 ns), EPRE (0.4 dB), wideband coefficients (rtol 0.15,
  0.15 rad) and noise bound (tests/vectors/test_golden_srs.py);
* ``prach_generator``: every preamble of ``generate_preamble_ref`` within
  2e-5 (tests/vectors/test_golden_phy.py); ``prach_demodulator``: the
  port's ``prach_window_params`` + ``prach_demodulate`` within 2e-2 of the
  cbf16 buffers and correlated above 0.999
  (tests/vectors/test_golden_prach_demod.py); ``prach_detector``: the
  port's ``detect_ref`` with the same detected preambles, metric within
  rtol 0.02 and TA within 0.4 us
  (tests/vectors/test_golden_prach_detector.py);
* ``prs_generator``: ``generate_prs`` within 8e-3
  (tests/vectors/test_golden_dl_proc.py); ``pucch_format34``: the port's
  ``pucch_f34.process`` with the reference's ok flag and its bits
  (tests/vectors/test_golden_pucch.py).

The vectors are read with the JAX package's ``read_vector``; the port
itself reads none.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch_parity import to_np, to_torch

from srsran_project_tpu.support.file_vector import read_vector
from srsran_project_tpu_torch.ops import lower_phy as tlower
from srsran_project_tpu_torch.ops import transform_precoding as ttp
from srsran_project_tpu_torch.ops.modulation import Modulation
from srsran_project_tpu_torch.ops.modulation import mapper as tmap
from srsran_project_tpu_torch.phy import csi_rs as tcsi
from srsran_project_tpu_torch.phy import pdcch as tpdcch
from srsran_project_tpu_torch.phy import pdsch as tpdsch
from srsran_project_tpu_torch.phy import prach as tprach
from srsran_project_tpu_torch.phy import ptrs_prs as tprs
from srsran_project_tpu_torch.phy import pucch_f34 as tf34
from srsran_project_tpu_torch.phy import pusch as tpusch
from srsran_project_tpu_torch.phy import srs as tsrs
from srsran_project_tpu_torch.phy import ssb as tssb
from srsran_project_tpu_torch.phy.allocation import Allocation, nof_data_re

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
MODS = {1: Modulation.PI_2_BPSK, 2: Modulation.QPSK, 4: Modulation.QAM16, 6: Modulation.QAM64,
        8: Modulation.QAM256}


def _suite(name: str) -> list:
    with open(os.path.join(GOLDEN, name, "manifest.json")) as f:
        return json.load(f)


def _path(suite: str, fname: str) -> str:
    return os.path.join(GOLDEN, suite, fname)


def _c64(path: str) -> np.ndarray:
    f = read_vector(path, "f32")
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


@pytest.mark.parametrize("idx", range(5))
def test_pdsch_processor(idx):
    case = _suite("pdsch_processor")[idx]
    nof_sc, layers = case["bwp_rb"] * 12, case["layers"]
    ref = read_vector(_path("pdsch_processor", f"grid{idx}.dat"), "cf32").reshape(
        layers, 14, nof_sc)
    tb = np.unpackbits(read_vector(_path("pdsch_processor", f"tb{idx}.dat"), "u8"))
    dmrs = tuple(s for s in range(14) if (case["dmrs_mask"] >> s) & 1)
    alloc = Allocation(rb_start=case["rb_start"], rb_count=case["rb_count"],
                       sym_start=case["start_sym"], sym_count=case["nof_syms"],
                       dmrs_symbols=dmrs, dmrs_config_type=1,
                       nof_cdm_groups_without_data=case["cdm_groups"])
    # The code rate of the TB on the allocation's G (the JAX test's rule).
    rate = case["tbs_bits"] / (nof_data_re(alloc) * case["qm"] * layers)
    cfg = tpdsch.PdschConfig(
        tbs=case["tbs_bits"], target_code_rate=rate, modulation=MODS[case["qm"]], alloc=alloc,
        nof_layers=layers, nof_ports=layers, nof_grid_symbols=14, nof_grid_sc=nof_sc,
        n_id=case["n_id"], rv=case["rv"], slot_in_frame=case["slot_in_frame"],
        dmrs_scrambling_id=case["scrambling_id"])
    assert cfg.sch.seg.base_graph == case["bg"]
    w = torch.eye(layers, dtype=torch.complex64) / np.sqrt(layers)
    grid = to_np(tpdsch.process(to_torch(tb), case["rnti"], w, cfg))
    assert grid.shape == ref.shape
    assert np.abs(grid - ref).max() < 8e-3
    assert np.abs(ref).max() > 0.2


@pytest.mark.parametrize("idx", range(6))
def test_pusch_processor_rx(idx):
    case = _suite("pusch_processor_rx")[idx]
    nof_sc = case["nof_prb"] * 12
    grid = read_vector(_path("pusch_processor_rx", f"grid{idx}.dat"), "cf32").reshape(
        case["ports"], 14, nof_sc)
    tb = np.unpackbits(read_vector(_path("pusch_processor_rx", f"tb{idx}.dat"), "u8"))
    dmrs = tuple(s for s in range(14) if (case["dmrs_mask"] >> s) & 1)
    cfg = tpusch.PuschConfig(
        tbs=case["tbs_bytes"] * 8, target_code_rate=case["rate"], modulation=MODS[case["qm"]],
        alloc=Allocation(rb_start=0, rb_count=case["nof_prb"], sym_start=0, sym_count=14,
                         dmrs_symbols=dmrs, nof_cdm_groups_without_data=2),
        nof_layers=1, nof_rx_ports=case["ports"], nof_grid_symbols=14, nof_grid_sc=nof_sc,
        n_id=case["n_id"], slot_in_frame=case["slot_idx"],
        dmrs_scrambling_id=case["scrambling_id"],
        transform_precoding=bool(case["transform_precoding"]), n_rs_id=case["n_rs_id"])
    out = tpusch.process(to_torch(grid)[None], torch.tensor([case["rnti"]]), cfg)
    assert bool(out["tb_crc_ok"][0]) and case["ref_crc_ok"] == 1
    np.testing.assert_array_equal(to_np(out["tb_bits"][0]), tb)


def test_transform_precoder():
    cases = _suite("transform_precoder")
    assert len(cases) >= 9
    for case in cases:
        m = case["m_sc"]
        x = _c64(_path("transform_precoder", f"in{case['idx']}.dat"))
        y_ref = _c64(_path("transform_precoder", f"out{case['idx']}.dat"))
        y = to_np(ttp.deprecode(to_torch(x).reshape(-1, m))).reshape(-1)
        np.testing.assert_allclose(y, y_ref, atol=2e-4, err_msg=str(case))
        nv_in = read_vector(_path("transform_precoder", f"nvar_in{case['idx']}.dat"), "f32")
        nv_ref = read_vector(_path("transform_precoder", f"nvar_out{case['idx']}.dat"), "f32")
        nv = to_np(ttp.deprecode_noise_var(to_torch(nv_in).reshape(-1, m))).reshape(-1)
        np.testing.assert_allclose(np.broadcast_to(nv, nv_ref.shape), nv_ref, rtol=2e-3,
                                   err_msg=f"nvar {case}")


MAPPER_CASES = [c for c in _suite("mod_mapper") if c["mod"] in ("pi2bpsk", "bpsk", "qpsk")]


@pytest.mark.parametrize("case", MAPPER_CASES, ids=lambda c: f"{c['mod']}-{c['nsym']}")
def test_mod_mapper(case):
    mod = {"pi2bpsk": Modulation.PI_2_BPSK, "bpsk": Modulation.BPSK,
           "qpsk": Modulation.QPSK}[case["mod"]]
    bits = read_vector(_path("mod_mapper", case["bits"]), "u8")
    ref = read_vector(_path("mod_mapper", case["symbols"]), "cf32")
    got = to_np(tmap.map_bits(to_torch(bits), mod))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, err_msg=case["mod"])


@pytest.mark.parametrize("idx", range(4))
def test_pdcch_processor(idx):
    case = _suite("pdcch_processor")[idx]
    subc = case["bwp_rb"] * 12
    ref = read_vector(_path("pdcch_processor", f"grid{idx}.dat"), "cf32").reshape(14, subc)
    payload = read_vector(_path("pdcch_processor", f"payload{idx}.dat"), "u8")
    cfg = tpdcch.PdcchConfig(
        payload_bits=case["payload_bits"], aggregation_level=case["aggregation_level"],
        cce_index=case["cce_index"], coreset_rb_start=case["coreset_rb_start"],
        coreset_rb_count=case["coreset_rb_count"], symbol=case["start_sym"],
        duration=case["duration"], interleaved=bool(case["interleaved"]),
        reg_bundle_size=case["reg_bundle"], interleaver_rows=case["interleaver_rows"],
        shift_index=case["shift_index"], n_id=case["n_id"], n_rnti=case["n_rnti"],
        nof_grid_symbols=14, nof_grid_sc=subc, slot_in_frame=case["slot_idx"])
    got = to_np(tpdcch.process(to_torch(payload), case["rnti"], cfg))
    assert np.abs(got - ref).max() < 8e-3, case
    assert np.abs(ref).max() > 0.5


@pytest.mark.parametrize("idx", range(4))
def test_ssb_processor(idx):
    case = _suite("ssb_processor")[idx]
    subc = case["grid_rb"] * 12
    ref = read_vector(_path("ssb_processor", f"grid{idx}.dat"), "cf32").reshape(14, subc)
    mib = read_vector(_path("ssb_processor", f"mib{idx}.dat"), "u8")
    cfg = tssb.SsbConfig(pci=case["pci"], ssb_index=case["ssb_idx"], l_max=case["L_max"],
                         sfn_2lsb=2 * ((case["sfn"] >> 2) & 1) + ((case["sfn"] >> 1) & 1),
                         hrf=case["hrf"])
    payload = tssb.pbch_pack_payload(mib, sfn=case["sfn"], hrf=case["hrf"],
                                     ssb_index=case["ssb_idx"], l_max=case["L_max"],
                                     k_ssb=case["subcarrier_offset"])
    block = to_np(tssb.assemble_ssb(to_torch(payload), cfg))
    l0, k0 = case["l_start"], case["k_start"]
    assert np.abs(block - ref[l0 : l0 + 4, k0 : k0 + 240]).max() < 8e-3, case
    mask = np.ones_like(ref, bool)
    mask[l0 : l0 + 4, k0 : k0 + 240] = False
    assert np.abs(ref[mask]).max() == 0.0


@pytest.mark.parametrize("idx", range(5))
def test_csi_rs_generator(idx):
    case = _suite("csi_rs_generator")[idx]
    subc, ports = case["bwp_rb"] * 12, case["nof_ports"]
    ref = read_vector(_path("csi_rs_generator", f"grid{idx}.dat"), "cf32").reshape(ports, 14, subc)
    ki = tuple(case["ki"])
    cfg = tcsi.CsiRsConfig(
        rb_start=case["rb_start"], rb_count=case["rb_count"], symbol=case["l0"],
        scrambling_id=case["scrambling_id"], row=case["row"], k0=ki[0],
        ki=ki if len(ki) > 1 else (), symbol2=case["l1"] if case["l1"] else None,
        slot_in_frame=case["slot_idx"], nof_grid_symbols=14, nof_grid_sc=subc)
    # The stored grids carry the reference's identity precoding, 1/sqrt(ports).
    got = to_np(tcsi.generate(cfg, device="cpu")) / np.sqrt(ports)
    got = got[None] if got.ndim == 2 else got
    assert np.abs(got - ref).max() < 8e-3, case
    assert np.abs(ref).max() > 0.3


@pytest.mark.parametrize("idx", range(6))
def test_srs_estimator(idx):
    case = _suite("srs_estimator")[idx]
    subc, rx, tx = case["bwp_rb"] * 12, case["rx_ports"], case["tx_ports"]
    grid = read_vector(_path("srs_estimator", f"grid{idx}.dat"), "cf32").reshape(rx, 14, subc)
    h_ref = read_vector(_path("srs_estimator", f"h{idx}.dat"), "cf32").reshape(rx, tx)
    comb = case["comb"]
    comb_offset = case["k0"] % comb
    cfg = tsrs.SrsConfig(
        rb_start=(case["k0"] - comb_offset) // 12, rb_count=case["m_sc"] * comb // 12,
        start_symbol=case["start_symbol"], nof_symbols=case["nof_symbols"], comb=comb,
        comb_offset=comb_offset, sequence_id=case["sequence_id"],
        cyclic_shift=case["cyclic_shift"], nof_antenna_ports=tx, nof_rx_ports=rx,
        nof_grid_sc=subc)
    res = {k: to_np(v) for k, v in tsrs.estimate(to_torch(grid), cfg).items()}
    h = res["h"].reshape(rx, tx, -1)
    slope = res["phase_slope"].reshape(rx, tx)
    ta = float(np.mean(-slope / (2 * np.pi * comb * 30e3)))
    assert abs(ta - case["ref_ta_s"]) < 3e-9, (case, ta)
    assert abs(10 * np.log10(res["epre"].mean()) - case["ref_epre_db"]) < 0.4, case
    # Wideband coefficients: the TA-compensated mean of the LSE over the
    # noise standard deviation, as the reference normalizes them.
    i = np.arange(case["m_sc"])
    coeff = (h * np.exp(-1j * (slope / case["m_sc"])[..., None] * i)).mean(axis=-1)
    noise_std = max(np.sqrt(case["ref_noise_var"]),
                    0.01 * np.sqrt(float((np.abs(coeff) ** 2).sum())))
    pred = coeff / noise_std
    assert np.allclose(np.abs(pred), np.abs(h_ref), rtol=0.15), (case, pred, h_ref)
    assert np.abs(np.angle(pred * np.conj(h_ref))).max() < 0.15, case
    assert res["noise_var"].mean() < 2 * case["ref_noise_var"] + 1e-3, case


PRACH_GEN = _suite("prach_generator")


@pytest.mark.parametrize("chunk", range(4))
def test_prach_generator(chunk):
    """A quarter of the suite's preambles per case."""
    cases = PRACH_GEN[chunk::4]
    assert cases
    for case in cases:
        ref = read_vector(_path("prach_generator", case["seq"]), "cf32")
        got = to_np(tprach.generate_preamble_ref(case["format"], case["root"], case["preamble"],
                                                 case["zcz"], device="cpu"))
        assert got.shape == (case["len"],), case
        np.testing.assert_allclose(got, ref, atol=2e-5, err_msg=str(case))


@pytest.mark.parametrize("idx", range(5))
def test_prach_demodulator(idx):
    case = _suite("prach_demodulator")[idx]
    inp = to_torch(read_vector(_path("prach_demodulator", f"input{idx}.dat"), "cf32"))
    nsym = case["nof_symbols"]
    ref = read_vector(_path("prach_demodulator", f"buffer{idx}.dat"), "cf32").reshape(
        case["nof_td"], case["nof_fd"], nsym, case["l_ra"])
    for td in range(case["nof_td"]):
        for fd in range(case["nof_fd"]):
            p = tlower.prach_window_params(
                fmt=case["fmt"], pusch_scs_hz=30000, slot_in_subframe=case["slot_idx"],
                start_symbol=case["start_symbol"], td_occasion=td, srate_hz=case["srate_hz"],
                rb_offset=case["rb_offset"], fd_occasion=fd, nof_prb_ul_grid=case["nof_prb_ul"],
                l_ra=case["l_ra"])
            assert p["nof_symbols"] == nsym, (case, p)
            window = inp[p["sample_offset"]:]
            for sym in range(nsym):
                got = to_np(tlower.prach_demodulate(
                    window, l_ra=case["l_ra"], dft_size=p["dft_size"], nof_symbols=1,
                    cp_samples=p["cp_samples"] + sym * p["dft_size"], k_offset=p["k_offset"]))
                want = ref[td, fd, sym]
                assert np.abs(got - want).max() < 2e-2, (case, td, fd, sym)
                corr = np.abs(np.vdot(got, want)) / (np.linalg.norm(got) * np.linalg.norm(want)
                                                     + 1e-12)
                assert corr > 0.999, (case, td, fd, sym, corr)


@pytest.mark.parametrize("idx", range(9))
def test_prach_detector(idx):
    case = _suite("prach_detector")[idx]
    rx = read_vector(_path("prach_detector", case["rx"]), "cf32").reshape(
        case["ports"], case["nof_symbols"], case["l_ra"])
    res = tprach.detect_ref(to_torch(rx), fmt=case["format"],
                            root_sequence_index=case["root"],
                            zero_correlation_zone=case["zcz"], dft_size=1024)
    want = [int(x) for x in case["det_preambles"].split(",") if x]
    assert sorted(r["preamble_index"] for r in res) == sorted(want), (case, res)
    metrics = dict(zip(want, (float(m) for m in case["det_metrics"].split(",") if m)))
    tas = dict(zip(want, (float(t) for t in case["det_ta_us"].split(",") if t)))
    for r in res:
        pi = r["preamble_index"]
        assert np.isclose(r["metric"], metrics[pi], rtol=0.02), (case, r)
        assert abs(r["ta_s"] * 1e6 - tas[pi]) < 0.4, (case, r)


@pytest.mark.parametrize("idx", range(5))
def test_prs_generator(idx):
    case = _suite("prs_generator")[idx]
    subc = case["bwp_rb"] * 12
    ref = read_vector(_path("prs_generator", f"grid{idx}.dat"), "cf32").reshape(14, subc)
    cfg = tprs.PrsConfig(rb_start=case["rb_start"], rb_count=case["rb_count"],
                         start_symbol=case["start_symbol"], nof_symbols=case["nof_symbols"],
                         comb_size=case["comb_size"], comb_offset=case["comb_offset"],
                         n_id_prs=case["n_id_prs"], slot_in_frame=case["slot_idx"],
                         nof_grid_sc=subc, nof_grid_symbols=14)
    got = to_np(tprs.generate_prs(cfg, device="cpu"))
    assert np.abs(got - ref).max() < 8e-3, case
    assert np.abs(ref).max() > 0.5, case


@pytest.mark.parametrize("idx", range(10))
def test_pucch_format34(idx):
    case = _suite("pucch_format34")[idx]
    subc = case["bwp_rb"] * 12
    grid = read_vector(_path("pucch_format34", f"grid{idx}.dat"), "cf32").reshape(
        case["ports"], 14, subc)
    payload = read_vector(_path("pucch_format34", f"payload{idx}.dat"), "u8")
    ref_bits = read_vector(_path("pucch_format34", f"ref_bits{idx}.dat"), "u8")
    nof_uci = case["nof_harq"] + case["nof_sr"] + case["nof_csi1"]
    cfg = tf34.PucchFormat34Config(
        prb_start=case["prb"], nof_prb=case["nof_prb"], start_symbol=case["start_sym"],
        nof_symbols=case["nof_syms"], nof_uci_bits=nof_uci, rnti=case["rnti"],
        n_id=case["n_id"], occ_length=case["occ_length"], occ_index=case["occ_index"],
        slot_in_frame=case["slot_idx"], nof_rx_ports=case["ports"], nof_grid_sc=subc,
        second_hop_prb=case["second_hop_prb"] if case.get("second_hop_prb", -1) >= 0 else None,
        additional_dmrs=bool(case.get("additional_dmrs", 0)),
        pi2_bpsk=bool(case.get("pi2_bpsk", 0)))
    bits, ok, snr_db = tf34.process(to_torch(grid), cfg)
    assert bool(ok) == bool(case["ref_valid"]), case
    got = to_np(bits)[:nof_uci]
    np.testing.assert_array_equal(got, ref_bits)
    np.testing.assert_array_equal(got, payload)
    assert np.isfinite(float(snr_db))
