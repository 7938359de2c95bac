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
  (tests/vectors/test_golden_pucch.py);
* the reference-exact modes: ``estimator`` through the port's copy of the
  numpy oracle and through ``estimator_reftorch`` (CE within 2 % of the
  channel scale, EPRE rtol 2e-3, RSRP 5e-3, noise 2e-2 / 3e-2, SNR 3e-2 /
  5e-2, TA within 0.02 us, CFO within 1 Hz;
  tests/vectors/test_golden_estimator.py); ``demod_mapper``: every
  ``demap_llr_i8`` LLR bit-exact (tests/vectors/test_golden_modulation.py);
  ``equalizer``: ``equalize_ref`` within 0.008 a RE and the noise within
  rtol 5e-3 (tests/vectors/test_golden_phy.py); ``pusch_demodulator``:
  ``equalize_ref`` + ``demap_llr_i8`` + descrambling, more than 99 % of
  the codeword's LLRs exact and the rest bounded
  (tests/vectors/test_golden_pusch_demodulator.py); ``ldpc_decoder``:
  ``decode_i8`` bit-exact, and the message at 6 dB and above
  (tests/vectors/test_golden_ldpc_decoder.py); ``harq_retx``: the
  transmissions of each case through ``decoder="reference_i8"`` with early
  stop, per-transmission CRC verdicts, the combined buffers bit-exact and
  the TB (tests/vectors/test_golden_harq_retx.py); ``dmrs_pusch``:
  ``estimator="reference"`` through ``pusch._estimate_stage``, the
  channel within 2 % RMS and the noise within rtol 0.05
  (tests/vectors/test_golden_tail.py).

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
from srsran_project_tpu_torch.ops import equalizer as teq
from srsran_project_tpu_torch.ops import estimator_ref as tref
from srsran_project_tpu_torch.ops import estimator_reftorch as trefT
from srsran_project_tpu_torch.ops import lower_phy as tlower
from srsran_project_tpu_torch.ops import scrambling as tscr
from srsran_project_tpu_torch.ops import transform_precoding as ttp
from srsran_project_tpu_torch.ops.modulation import Modulation
from srsran_project_tpu_torch.ops.ldpc import decoder as tdec
from srsran_project_tpu_torch.ops.modulation import demapper_i8 as tdem
from srsran_project_tpu_torch.ops.modulation import mapper as tmap
from srsran_project_tpu_torch.phy import csi_rs as tcsi
from srsran_project_tpu_torch.phy import pdcch as tpdcch
from srsran_project_tpu_torch.phy import pdsch as tpdsch
from srsran_project_tpu_torch.phy import prach as tprach
from srsran_project_tpu_torch.phy import ptrs_prs as tprs
from srsran_project_tpu_torch.phy import pucch_f34 as tf34
from srsran_project_tpu_torch.phy import pusch as tpusch
from srsran_project_tpu_torch.phy import sch as tsch
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


# ---- the reference-exact modes ---------------------------------------------------

EST_PATTERNS = {1: tuple(range(0, 12, 2)), 3: (1, 4, 7, 10), 4: tuple(range(12))}


def _est_case(idx):
    """(case, its config fields, grid (14, nsc), pilots, reference CE)."""
    case = _suite("estimator")[idx]
    nsc = case["nof_prb"] * 12
    pattern = EST_PATTERNS[case["dmrs_type"]]
    nsym_d = bin(case["symbol_mask"]).count("1")
    grid = read_vector(_path("estimator", f"grid{case['idx']}.dat"), "cf32").reshape(14, nsc)
    pilots = read_vector(_path("estimator", f"pilots{case['idx']}.dat"), "cf32").reshape(
        case["layers"], nsym_d, case["nof_prb"] * len(pattern))
    ref_ce = read_vector(_path("estimator", f"ce{case['idx']}.dat"), "cf32").reshape(
        case["layers"], 14, nsc)
    fields = dict(scs_khz=30, nof_prb=case["nof_prb"], first_symbol=0, nof_symbols=14,
                  dmrs_symbol_mask=case["symbol_mask"], re_pattern=pattern,
                  re_pattern2=tuple(range(1, 12, 2)) if case.get("cdm_groups", 1) == 2 else None,
                  nof_layers=case["layers"], smoothing=case["smoothing"], td_strategy=case["td"],
                  compensate_cfo=case["cfo_comp"] == 1)
    return case, fields, grid, pilots, ref_ce


@pytest.mark.parametrize("idx", range(12))
def test_estimator(idx):
    """The port's copy of the numpy oracle and ``estimate_port_ref`` on one
    golden case, each at the reference's vector-test bounds."""
    case, fields, grid, pilots, ref_ce = _est_case(idx)
    scale = max(1.0, float(np.abs(ref_ce).max()))
    res = tref.estimate_port(grid, pilots, tref.EstimatorConfig(**fields))
    assert np.abs(res.ce - ref_ce).max() < 0.02 * scale, case
    assert np.isclose(res.epre, case["epre"], rtol=2e-3), case
    assert np.isclose(res.rsrp, case["rsrp"], rtol=5e-3), case
    assert np.isclose(res.noise_var, case["noise_var"], rtol=2e-2), case
    assert np.isclose(res.snr, case["snr_est"], rtol=3e-2), case
    assert abs(res.time_alignment_s * 1e6 - case["ta_us"]) < 0.02, case
    if case["cfo_comp"]:
        assert abs((res.cfo_hz or 0.0) - case["cfo_hz"]) < 1.0, case
    out = {k: to_np(v) for k, v in trefT.estimate_port_ref(
        to_torch(grid), to_torch(pilots), trefT.RefEstimatorConfig(**fields)).items()}
    assert np.abs(out["ce"] - ref_ce).max() < 0.02 * scale, case
    assert np.isclose(out["epre"], case["epre"], rtol=2e-3), case
    assert np.isclose(out["rsrp"], case["rsrp"], rtol=5e-3), case
    assert np.isclose(out["noise_var"], case["noise_var"], rtol=3e-2), case
    assert np.isclose(out["snr"], case["snr_est"], rtol=5e-2), case
    assert abs(float(out["ta_s"]) * 1e6 - case["ta_us"]) < 0.02, case


DEMOD_MODS = {"pi2bpsk": Modulation.PI_2_BPSK, "bpsk": Modulation.BPSK, "qpsk": Modulation.QPSK,
              "qam16": Modulation.QAM16, "qam64": Modulation.QAM64, "qam256": Modulation.QAM256}


@pytest.mark.parametrize("idx", range(12))
def test_demod_mapper(idx):
    case = _suite("demod_mapper")[idx]
    syms = read_vector(_path("demod_mapper", case["symbols"]), "cf32")
    nvar = read_vector(_path("demod_mapper", case["noise_vars"]), "f32")
    ref = read_vector(_path("demod_mapper", case["llrs"]), "i8")
    got = to_np(tdem.demap_llr_i8(to_torch(syms), to_torch(nvar), DEMOD_MODS[case["mod"]]))
    np.testing.assert_array_equal(got, ref, err_msg=case["mod"])


@pytest.mark.parametrize("idx", range(8))
def test_equalizer(idx):
    case = _suite("equalizer")[idx]
    ports, layers, nof_re = case["ports"], case["layers"], case["nof_re"]
    syms = read_vector(_path("equalizer", f"syms{case['idx']}.dat"), "cf32").reshape(ports, nof_re)
    est = read_vector(_path("equalizer", f"est{case['idx']}.dat"), "cf32").reshape(
        ports, layers, nof_re)
    nvar = read_vector(_path("equalizer", f"nvar{case['idx']}.dat"), "f32")
    ref_eq = read_vector(_path("equalizer", f"eq{case['idx']}.dat"), "cf32").reshape(nof_re,
                                                                                    layers)
    ref_nv = read_vector(_path("equalizer", f"eqnvar{case['idx']}.dat"), "f32").reshape(
        nof_re, layers)
    x, nv = teq.equalize_ref(to_torch(syms.T), to_torch(np.moveaxis(est, [0, 1, 2], [1, 2, 0])),
                             to_torch(nvar), 1.0, case["alg"])
    np.testing.assert_allclose(to_np(x), ref_eq, atol=0.008, err_msg=str(case))
    np.testing.assert_allclose(to_np(nv), ref_nv, rtol=5e-3, atol=1e-5, err_msg=str(case))


@pytest.mark.parametrize("idx", range(4))
def test_pusch_demodulator(idx):
    """equalize_ref (MMSE for 1 layer, ZF above) + demap_llr_i8 +
    descrambling against the reference demodulator's codeword LLRs, at
    its vector test's bounds."""
    case = _suite("pusch_demodulator")[idx]
    nsc = case["nof_prb"] * 12
    p, nl = case["ports"], case["layers"]
    grid = read_vector(_path("pusch_demodulator", f"grid{case['idx']}.dat"), "cf32").reshape(
        p, 14, nsc)
    est = read_vector(_path("pusch_demodulator", f"est{case['idx']}.dat"), "cf32").reshape(
        p, nl, 14, nsc)
    ref = read_vector(_path("pusch_demodulator", f"llrs{case['idx']}.dat"), "i8").astype(np.int32)
    dmrs = {s for s in range(14) if (case["dmrs_mask"] >> s) & 1}
    data = [s for s in range(case["start_sym"], case["start_sym"] + case["nof_syms"])
            if s not in dmrs]
    y = np.concatenate([grid[:, s, :].T for s in data])
    h = np.concatenate([np.moveaxis(est[:, :, s, :], [0, 1, 2], [1, 2, 0]) for s in data])
    x, eq_nv = teq.equalize_ref(to_torch(y), to_torch(h),
                                torch.full((p,), case["noise_var"], dtype=torch.float32), 1.0,
                                "mmse" if nl == 1 else "zf")
    llr = tdem.demap_llr_i8(x.reshape(-1), eq_nv.reshape(-1), MODS[case["qm"]])
    c_init = torch.tensor((case["rnti"] << 15) + case["n_id"])
    got = to_np(tscr.descramble_llrs(llr, c_init)).astype(np.int32)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    big = diff > 1
    assert float((diff == 0).mean()) > 0.99, case
    assert float(big.mean()) < 2e-3, case
    assert np.all(np.abs(ref[big]) <= 4), case
    assert diff.max() <= 8, case


LDPC_CASES = _suite("ldpc_decoder")


@pytest.mark.parametrize("idx", range(len(LDPC_CASES)))
def test_ldpc_decoder_i8(idx):
    case = LDPC_CASES[idx]
    llrs = read_vector(_path("ldpc_decoder", case["llrs"]), "i8")
    ref_bits = read_vector(_path("ldpc_decoder", case["output"]), "u8")
    bits, _ = tdec.decode_i8(to_torch(llrs)[None], case["bg"], case["ls"],
                             nof_iterations=case["max_iter"])
    np.testing.assert_array_equal(to_np(bits)[0], ref_bits, err_msg=str(case))
    if case["snr_db"] >= 6.0:
        msg = read_vector(_path("ldpc_decoder", case["message"]), "u8")
        np.testing.assert_array_equal(to_np(bits)[0], msg, err_msg=str(case))


@pytest.mark.parametrize("idx", range(5))
def test_harq_retx(idx):
    """The reference decoder's RV sequence 0-2-3-1 with a persistent
    buffer, through ``decoder="reference_i8"`` with early stop: each
    transmission's CRC verdict, the combined soft bits after each, and
    the TB."""
    case = _suite("harq_retx")[idx]
    tbs = case["tbs_bytes"] * 8
    tb_ref = np.unpackbits(np.fromfile(_path("harq_retx", case["tb"]), dtype=np.uint8))
    harq = None
    for t, (rv, want_ok) in enumerate(zip((int(x) for x in case["rv_seq"].split(",")),
                                          (int(x) for x in case["verdicts"].split(",")))):
        llr = np.fromfile(_path("harq_retx", f"llr{case['idx']}_{t}.dat"), dtype=np.int8)
        cfg = tsch.SchConfig(tbs=tbs, target_code_rate=tbs / case["g_bits"], qm=case["qm"],
                             nof_layers=1, nof_total_bits=case["g_bits"], rv=rv,
                             decoder="reference_i8")
        tb, ok, harq = tsch.decode_transport_block(to_torch(llr), cfg, nof_iterations=6,
                                                   harq_buffer=harq, early_stop=True)
        assert bool(ok) == bool(want_ok), (case["idx"], t, rv)
        buf = to_np(harq)
        assert buf.shape[0] == case["nof_cbs"]
        for cb in range(case["nof_cbs"]):
            soft = np.fromfile(_path("harq_retx", f"soft{case['idx']}_{t}_{cb}.dat"),
                               dtype=np.int8)
            np.testing.assert_array_equal(buf[cb, : case["full_length"]], soft,
                                          err_msg=f"case {case['idx']} tx {t} cb {cb}")
        if bool(ok):
            np.testing.assert_array_equal(to_np(tb), tb_ref[:tbs])


@pytest.mark.parametrize("idx", range(6))
def test_dmrs_pusch_reference_estimator(idx):
    """dmrs_pusch_estimator_impl parity through the port's PUSCH estimate
    with ``estimator="reference"``: the c_init / Gold draw, the type-1
    mapping of both CDM groups, the beta scaling and the filter/average
    estimate on the recorded grid."""
    case = _suite("dmrs_pusch")[idx]
    nsc = case["grid_prbs"] * 12
    grid = _c64(_path("dmrs_pusch", f"grid{case['idx']}.dat")).reshape(1, 1, 14, nsc)
    cfg = tpusch.PuschConfig(
        tbs=2048, target_code_rate=0.5, modulation=Modulation.QAM16,
        alloc=Allocation(rb_start=case["rb_start"], rb_count=case["nof_prb"], sym_start=0,
                         sym_count=14,
                         dmrs_symbols=tuple(s for s in range(14)
                                            if case["symbol_mask"] & (1 << s))),
        nof_layers=case["layers"], nof_rx_ports=1, nof_grid_symbols=14, nof_grid_sc=nsc,
        scs_khz=30, slot_in_frame=case["slot_idx"], dmrs_scrambling_id=case["scrambling_id"],
        n_scid=case["n_scid"], estimator="reference")
    _gflat, h, nv = tpusch._estimate_stage(to_torch(grid), cfg)
    h = to_np(h)[0, 0]  # (nof_sc, nl)
    ce_ref = _c64(_path("dmrs_pusch", f"ce{case['idx']}.dat")).reshape(case["layers"], nsc)
    band = slice(case["rb_start"] * 12, (case["rb_start"] + case["nof_prb"]) * 12)
    for layer in range(case["layers"]):
        ref_l = ce_ref[layer, band]
        scale = np.sqrt(np.mean(np.abs(ref_l) ** 2)) + 1e-12
        err = np.sqrt(np.mean(np.abs(h[:, layer] - ref_l) ** 2)) / scale
        assert err < 2e-2, (case, layer, err)
    assert np.isclose(float(nv[0]), case["noise_var"], rtol=0.05), case
