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
  (tests/vectors/test_golden_modulation.py).

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
from srsran_project_tpu_torch.ops import transform_precoding as ttp
from srsran_project_tpu_torch.ops.modulation import Modulation
from srsran_project_tpu_torch.ops.modulation import mapper as tmap
from srsran_project_tpu_torch.phy import pdsch as tpdsch
from srsran_project_tpu_torch.phy import pusch as tpusch
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
