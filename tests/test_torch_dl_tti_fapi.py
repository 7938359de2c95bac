"""The whole FAPI downlink slot through ``UpperPhy.process_dl_tti`` and
``process_ul_dci`` on a small carrier, against the benchmark's plain
reference (``portbench/reference``: ``dl``, ``pdcch``, ``ssb``, which follow
TS 38.211/38.212/38.214 and import nothing of the port): a 52-PRB carrier
with 4 transmit ports holds 2 precoded PDSCH UEs rate matched around a
TRS, 4 DCIs in an interleaved CORESET and one SSB
(``portbench/tests/small_dl_tti.py``; the benchmark's generator makes the
slot from a seed).  Also the PDSCH's reserved REs through ``process`` and
``process_multi``, the grid without reserved REs unchanged, and the
reference's PDCCH, SSB and CSI-RS against srsRAN's golden vectors.

Tolerances:
* which REs are empty: exact (a RE empty on one side only is a mapping
  fault);
* grid values within 1e-6 x the reference's RMS: the same float32
  products and sums on both sides, in the same order (the CPU reads 0);
* srsRAN's golden grids within 8e-3, the port's own golden tests' bound:
  the vectors hold srsRAN's float arithmetic, whose QPSK and Gold-sequence
  values round otherwise than float32 here.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench.harness import cells, spec as spec_mod
from portbench.reference import dl as ref_dl
from portbench.reference import link
from portbench.reference import pdcch as ref_pdcch
from portbench.reference import ssb as ref_ssb
from portbench.tests import small_dl_tti
from srsran_project_tpu_torch.models.cell import CellConfig
from srsran_project_tpu_torch.ops.modulation import Modulation
from srsran_project_tpu_torch.phy import allocation, pdsch

CPU = torch.device("cpu")
SEED = 2147483647 + 23
GRID_REL = 1e-6
GOLDEN = spec_mod.ROOT / "tests" / "golden"


@pytest.fixture(scope="module")
def slot():
    spec = small_dl_tti.spec()
    entry = cells.entry(spec.config, spec.traffic, SEED, CPU)
    units = list(range(entry.units))
    got = {u: [entry.dispatch(entry.generate(u, 0, None))] for u in units}
    return entry, got, entry.expected(units, link.FLOAT32)


def test_the_fapi_slot_is_the_references(slot):
    entry, got, want = slot
    numbers = entry.compare(got, want)
    assert numbers["re_occupancy_mismatch"] == 0, numbers
    assert numbers["iq_gap"] <= GRID_REL, numbers


def test_the_trs_res_carry_the_csi_rs_alone(slot):
    """On the TRS REs inside the PDSCH windows port 0 holds the CSI-RS and
    ports 1-3 nothing: every PDSCH was rate matched around them."""
    entry, got, _ = slot
    t = entry.trs
    for s in t["symbols"]:
        csi = torch.from_numpy(ref_dl.csi_rs_row1(s, t["k0"], t["rb_start"], t["rb_count"],
                                                  entry.pci, entry.nsc))[s]
        ks = torch.nonzero(csi).flatten()
        assert len(ks) == 3 * t["rb_count"]
        for (grid,) in got.values():
            assert torch.equal(grid[0, s, ks], csi[ks])
            assert not grid[1:, s, ks].any()
            assert grid[1:, s].any()  # the PDSCH is there, around them


def test_every_channel_of_the_slot_is_on_the_grid(slot):
    """The SSB's PSS and each DCI's REGs are where the plan puts them, the
    DCIs on port 0 alone."""
    entry, got, _ = slot
    for (grid,) in got.values():
        sym, = [s for _, s in entry.ssb]
        pss = grid[0, sym, entry.ssb_sc0 + 56:entry.ssb_sc0 + 183]
        assert torch.equal(pss.real, torch.from_numpy(ref_ssb.pss(entry.pci % 3)).float())
        for _, d in entry.dcis:
            data, pilots, _, _ = ref_pdcch.layout(entry.coreset, d, entry.nsc)
            assert grid[0].reshape(-1)[torch.from_numpy(data)].abs().min() > 0.5
            assert not grid[1:].reshape(3, -1)[:, torch.from_numpy(pilots)].any()


def _grant_cfg(nof_rb: int, layers: int, qm: Modulation, rate: float, crb: int, reserved):
    """A compact PDSCH config of ``nof_rb`` PRBs at CRB ``crb``, 4 ports."""
    pc = CellConfig(nof_rb=nof_rb, nof_ports=4, nof_layers=layers, modulation=qm,
                    target_code_rate=rate, f_center_hz=0.0).pdsch_cfg
    return dataclasses.replace(pc, alloc=dataclasses.replace(pc.alloc, crb_start=crb),
                               reserved=reserved)


def _ref_grant(cfg, first_rb: int, res: frozenset) -> ref_dl.DlGrant:
    return ref_dl.DlGrant(nof_rb=cfg.alloc.rb_count, first_rb=first_rb,
                          layers=cfg.nof_layers, qm=int(cfg.modulation),
                          rate=cfg.target_code_rate, nof_ports=cfg.nof_ports, reserved=res)


# (PRBs, layers, modulation, rate, the TRS's PRBs in the window, symbols,
# RE offset): a TRS over the whole window and over part of it.
RESERVED_CASES = [(12, 2, Modulation.QAM64, 0.55, range(0, 12), (4, 8), 0),
                  (8, 1, Modulation.QPSK, 0.12, range(3, 8), (5, 9), 1),
                  (6, 4, Modulation.QAM256, 0.9, range(0, 6), (4, 8), 2)]


@pytest.mark.parametrize("nrb,nl,qm,rate,prbs,syms,k0", RESERVED_CASES,
                         ids=["whole-window", "part-of-window", "rank4"])
def test_reserved_res_through_process_are_the_references(nrb, nl, qm, rate, prbs, syms, k0):
    pattern = allocation.RePattern(prbs=tuple(prbs), re_mask=0b000100010001 << k0,
                                   symbol_mask=sum(1 << s for s in syms))
    cfg = _grant_cfg(nrb, nl, qm, rate, 16, (pattern,))
    g = _ref_grant(cfg, 16, ref_dl.trs_res(syms, k0, prbs.start, len(prbs)))
    assert cfg.sch.nof_total_bits == g.g
    assert cfg.nof_reserved_re == 3 * len(syms) * len(prbs)
    gen = torch.Generator().manual_seed(nrb)
    tb = torch.randint(0, 2, (2, cfg.tbs), generator=gen, dtype=torch.uint8)
    rnti = torch.tensor([0x4601, 0x4602])
    w = cells.channel("flat_orthonormal").draw(gen, 2, nl, 4, CPU, {})
    got = torch.stack([pdsch.process(tb[i], rnti[i], w[i], cfg) for i in range(2)])
    want = ref_dl.pdsch(tb, rnti, w, g)
    assert torch.equal(got == 0, want == 0)
    assert float((got - want).abs().max()) <= GRID_REL * float(want.abs().pow(2).mean().sqrt())
    # The reserved REs are empty on every port.
    for s, k in g.reserved:
        assert not got[..., s, k].any()


def test_reserved_res_through_process_multi_are_the_references():
    """Three grants of one config at PRB 0, 12 and 30 in one batch, each
    under its TRS, into a 44-PRB slot."""
    pattern = allocation.RePattern(prbs=tuple(range(12)), re_mask=0b000100010001,
                                   symbol_mask=(1 << 4) | (1 << 8))
    cfg = _grant_cfg(12, 2, Modulation.QAM16, 0.5, 0, (pattern,))
    first = (0, 12, 30)
    gen = torch.Generator().manual_seed(3)
    tb = torch.randint(0, 2, (3, cfg.tbs), generator=gen, dtype=torch.uint8)
    rnti = torch.tensor([17, 23, 0xFFEF])
    w = cells.channel("flat_orthonormal").draw(gen, 3, 2, 4, CPU, {})
    got = pdsch.process_multi(tb, rnti, first, w, cfg, nof_slot_sc=44 * 12)
    want = torch.zeros_like(got)
    res = ref_dl.trs_res((4, 8), 0, 0, 12)
    for i, rb in enumerate(first):
        g = _ref_grant(cfg, rb, res)
        want[..., rb * 12:(rb + 12) * 12] += ref_dl.pdsch(tb[i:i + 1], rnti[i:i + 1],
                                                          w[i:i + 1], g)[0]
    assert torch.equal(got == 0, want == 0)
    assert float((got - want).abs().max()) <= GRID_REL * float(want.abs().pow(2).mean().sqrt())


def test_without_reserved_res_the_grid_and_its_route_are_unchanged(monkeypatch):
    """``reserved=()`` on su_dl_b8's shape cut to 24 PRB (4 layers of
    256QAM on 4 ports): the scatter-free route (the scatter assembly never
    runs), the scatter plan's data REs those of ``data_re_indices`` without
    patterns, and the grid bitwise the plain reference's ``link.port_grid``,
    as su_dl_b8 holds it on the card."""
    cfg = _grant_cfg(24, 4, Modulation.QAM256, 948 / 1024, 0, ())
    assert cfg == dataclasses.replace(cfg, reserved=())
    assert cfg.nof_data_re == allocation.nof_data_re(cfg.alloc) and cfg.nof_reserved_re == 0
    assert np.array_equal(pdsch._scatter_plan(cfg)[0] % (14 * cfg.nof_grid_sc),
                          np.tile(allocation.data_re_indices(cfg.alloc, 14, cfg.nof_grid_sc),
                                  4))
    scattered = []
    monkeypatch.setattr(pdsch, "_grid_scatter", lambda *a, **k: scattered.append(1))
    gen = torch.Generator().manual_seed(8)
    tb = torch.randint(0, 2, (2, cfg.tbs), generator=gen, dtype=torch.uint8)
    rnti = torch.tensor([0x4601, 9])
    w = cells.channel("flat_orthonormal").draw(gen, 1, 4, 4, CPU, {})[0]
    got = pdsch.process(tb, rnti, w, cfg)
    assert not scattered
    g = link.Grant(nof_rb=24, first_rb=0, layers=4, qm=8, rate=948 / 1024, nof_ports=4)
    assert g.tbs == cfg.tbs
    assert torch.equal(got, link.port_grid(tb, rnti, w, g))


def _suite(name: str) -> list:
    return json.loads((GOLDEN / name / "manifest.json").read_text())


def _vector(name: str, file: str, dtype) -> np.ndarray:
    return np.fromfile(GOLDEN / name / file, dtype=dtype)


@pytest.mark.parametrize("idx", range(4))
def test_the_reference_pdcch_is_srsrans(idx):
    """srsRAN's ``pdcch_processor`` vectors: non-interleaved and interleaved
    CORESETs (bundles of 6 and 2, 2 and 6 rows, shifts), n_RNTI 0 and the
    C-RNTI, aggregation levels 1 to 8."""
    case = _suite("pdcch_processor")[idx]
    nsc = case["bwp_rb"] * 12
    want = _vector("pdcch_processor", f"grid{idx}.dat", np.complex64).reshape(14, nsc)
    dci = torch.from_numpy(_vector("pdcch_processor", f"payload{idx}.dat", np.uint8))
    cs = ref_pdcch.Coreset(rb_start=case["coreset_rb_start"], rb_count=case["coreset_rb_count"],
                           symbol=case["start_sym"], duration=case["duration"],
                           interleaved=bool(case["interleaved"]), bundle=case["reg_bundle"],
                           rows=case["interleaver_rows"], shift=case["shift_index"])
    d = ref_pdcch.Dci(bits=case["payload_bits"], level=case["aggregation_level"],
                      cce=case["cce_index"], n_id=case["n_id"], n_rnti=case["n_rnti"])
    got = ref_pdcch.grid(cs, d, dci[None], torch.tensor([case["rnti"]]), nsc,
                         slot=case["slot_idx"])[0].numpy()
    assert np.abs(got - want).max() < 8e-3, case
    assert np.array_equal(got == 0, want == 0)


@pytest.mark.parametrize("idx", [0, 1, 3])
def test_the_reference_ssb_is_srsrans(idx):
    """srsRAN's ``ssb_processor`` vectors at L_max 8 (SSB indices 0, 3 and
    5, SFN 16 and 109, k_SSB 0 and 2, both half-frames)."""
    case = _suite("ssb_processor")[idx]
    nsc = case["grid_rb"] * 12
    want = _vector("ssb_processor", f"grid{idx}.dat", np.complex64).reshape(14, nsc)
    mib = _vector("ssb_processor", f"mib{idx}.dat", np.uint8)
    payload = ref_ssb.payload_j(mib, case["sfn"], case["hrf"], case["subcarrier_offset"])
    if case["hrf"]:
        # The half-frame bit is the only difference from the first half-frame.
        assert payload[10] == 1
    block = ref_ssb.block(torch.from_numpy(payload)[None], case["pci"], case["ssb_idx"],
                          case["sfn"])[0].numpy()
    l0, k0 = case["l_start"], case["k_start"]
    assert np.abs(block - want[l0:l0 + 4, k0:k0 + 240]).max() < 8e-3, case
    assert np.abs(want).sum() == np.abs(want[l0:l0 + 4, k0:k0 + 240]).sum()


def test_the_reference_csi_rs_row1_is_srsrans():
    """srsRAN's ``csi_rs_generator`` vector of row 1 (k0 2, symbol 5, slot 3)."""
    case = _suite("csi_rs_generator")[0]
    assert case["row"] == 1
    nsc = case["bwp_rb"] * 12
    want = _vector("csi_rs_generator", "grid0.dat", np.complex64).reshape(14, nsc)
    got = ref_dl.csi_rs_row1(case["l0"], case["ki"][0], case["rb_start"], case["rb_count"],
                             case["scrambling_id"], nsc, slot=case["slot_idx"])
    assert np.abs(got - want).max() < 8e-3, case
    assert np.array_equal(got == 0, want == 0)
