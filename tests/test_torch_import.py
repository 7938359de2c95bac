"""The PyTorch port imports no JAX, and its config twins and host plans
equal the JAX package's value for value."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_parity import to_torch  # noqa: F401  (sets torch threads)

from srsran_project_tpu.models import cell as jcell
from srsran_project_tpu.ops import crc as jcrc
from srsran_project_tpu.ops import estimator as jest
from srsran_project_tpu.ops import ofdm as jofdm
from srsran_project_tpu.ops import scrambling as jscr
from srsran_project_tpu.ops.ldpc import decoder_pallas as jdp
from srsran_project_tpu.ops.ldpc import graphs
from srsran_project_tpu.ops.ldpc import rate_match as jrm
from srsran_project_tpu.ops.ldpc import segmenter as jseg
from srsran_project_tpu.ops.modulation import mapper as jmap
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu.phy import sch as jsch
from srsran_project_tpu_torch.models import cell as tcell
from srsran_project_tpu_torch.ops import crc as tcrc
from srsran_project_tpu_torch.ops import estimator as test_
from srsran_project_tpu_torch.ops import ofdm as tofdm
from srsran_project_tpu_torch.ops import scrambling as tscr
from srsran_project_tpu_torch.ops.ldpc import decoder as tdec
from srsran_project_tpu_torch.ops.ldpc import rate_match as trm
from srsran_project_tpu_torch.ops.ldpc import segmenter as tseg
from srsran_project_tpu_torch.ops.modulation import mapper as tmap
from srsran_project_tpu_torch.phy import pdsch as tpdsch
from srsran_project_tpu_torch.phy import pusch as tpusch
from srsran_project_tpu_torch.phy import sch as tsch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELLS = [
    pytest.param(lambda m: m.CellConfig(), id="flagship"),
    pytest.param(lambda m: m.CellConfig(nof_rb=24, nof_ports=4, nof_layers=4), id="24prb-4x4"),
    pytest.param(lambda m: m.tiny_cell(), id="tiny"),
]


def test_package_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import srsran_project_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 20, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _same_fields(ref, twin):
    """Same field names; equal values (enums compared by value)."""
    a, b = _fields(ref), _fields(twin)
    assert a.keys() == b.keys()
    for k in a:
        va, vb = a[k], b[k]
        if hasattr(va, "value"):
            va, vb = int(va), int(vb)
        assert va == vb, (k, va, vb)


@pytest.mark.parametrize("make", CELLS)
def test_cell_config_twin(make):
    ref = make(jcell)
    twin = tcell.CellConfig.from_reference(ref)
    assert twin == make(tcell)
    _same_fields(ref, twin)
    assert (twin.dft_size, twin.nof_sc, twin.tbs) == (ref.dft_size, ref.nof_sc, ref.tbs)
    assert twin.alloc == ref.alloc
    for jc, tc in ((ref.pusch_cfg, twin.pusch_cfg), (ref.pdsch_cfg, twin.pdsch_cfg)):
        _same_fields(jc, tc)
        js, ts = jc.sch, tc.sch
        _same_fields(js, ts)
        _same_fields(js.seg, ts.seg)
        assert (ts.n_cb, ts.cb_e_bits) == (js.n_cb, js.cb_e_bits)
        assert tsch._e_groups(ts.cb_e_bits) == jsch._e_groups(js.cb_e_bits)
        assert tsch._fused_decode_ok(ts) == jsch._fused_decode_ok(js)
        assert ts.seg.full_codeword_bits == js.seg.full_codeword_bits
    assert twin.pusch_cfg.g_total == ref.pusch_cfg.g_total


@pytest.mark.parametrize("field, value", [
    ("equalizer", "mmse_ref"), ("demapper", "reference"), ("ldpc_decoder", "reference_i8"),
    ("equalizer", "zf"), ("sinr_method", "channel_estimator"),
    ("noise_method", "pair_residual"), ("cfo_compensation", True),
])
def test_out_of_slice_values_raise(field, value):
    cfg = tcell.CellConfig(**{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfg.pusch_cfg  # noqa: B018


@pytest.mark.parametrize("field", ["ptrs_enabled", "transform_precoding"])
def test_out_of_slice_pdsch_values_raise(field):
    alloc = tcell.CellConfig().alloc
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpdsch.PdschConfig(tbs=1000, target_code_rate=0.5, modulation=tmap.Modulation.QAM16,
                           alloc=alloc, **{field: True})


@pytest.mark.parametrize("field", ["uci", "ptrs_enabled", "transform_precoding", "compute_ta"])
def test_out_of_slice_pusch_values_raise(field):
    alloc = tcell.CellConfig().alloc
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpusch.PuschConfig(tbs=1000, target_code_rate=0.5, modulation=tmap.Modulation.QAM16,
                           alloc=alloc, **{field: object() if field == "uci" else True})


SEG_CASES = [(3000, 0.5), (9000, 0.45), (2000, 0.2), (300, 0.1), (1179864, 948 / 1024),
             (102416, 948 / 1024), (25000, 0.3), (3824, 0.7)]


def test_segment_params_and_rate_match_plans():
    for tbs, rate in SEG_CASES:
        js, ts = jseg.compute_segment_params(tbs, rate), tseg.compute_segment_params(tbs, rate)
        assert dataclasses.asdict(js) == dataclasses.asdict(ts)
        bg, z, kp = ts.base_graph, ts.lifting_size, ts.nof_payload_bits_per_cb
        n = ts.full_codeword_bits
        for n_cb in (n, max(kp, n * 2 // 3)):
            for rv in range(4):
                assert trm.k0_offset(bg, z, rv, n_cb) == jrm.k0_offset(bg, z, rv, n_cb)
                assert trm._valid_runs(bg, z, kp, rv, n_cb) == jrm._valid_runs(bg, z, kp, rv, n_cb)
                for e in (n_cb // 3 // 8 * 8, n_cb // 8 * 8, 2 * n_cb // 8 * 8):
                    assert (trm._chunk_segments(bg, z, kp, e, rv, n_cb)
                            == jrm._chunk_segments(bg, z, kp, e, rv, n_cb))
                    assert (tdec._dematch_plane_plan(bg, z, kp, e, rv, 8, n_cb)
                            == jdp._dematch_plane_plan(bg, z, kp, e, rv, 8, n_cb))
            np.testing.assert_array_equal(trm._filler_mask(bg, z, kp, n_cb),
                                          jrm._filler_mask(bg, z, kp, n_cb))


def test_decoder_layer_plans():
    for bg in (graphs.BG1, graphs.BG2):
        for z in (2, 15, 64, 384):
            g = graphs.get_graph(bg, z)
            for n_cb in (None, g.nof_codeword_bits, g.nof_codeword_bits // 3, 3 * z):
                for nl in (None, 5):
                    assert (tdec._active_layers(g, n_cb, nl)
                            == jdp._active_layers(g, n_cb, nl))
            nl = tdec._active_layers(g, g.nof_codeword_bits // 3, None)
            assert tdec._edge_plan(bg, z, nl)[0] == jdp._edge_plan(bg, z, nl)[0]


def test_crc_tables():
    for name in tcrc.POLYS:
        for length in (1, 40, 1024, 8392):
            np.testing.assert_array_equal(tcrc.generator_matrix(name, length),
                                          jcrc.generator_matrix(name, length))
        for nbits in (1024, 4096):
            np.testing.assert_array_equal(tcrc._advance_matrix(name, nbits),
                                          jcrc._advance_matrix(name, nbits))
        np.testing.assert_array_equal(tcrc._fold_matrix(name, 7), jcrc._fold_matrix(name, 7))
        np.testing.assert_array_equal(tcrc._span_advance_matrix(name, 8368),
                                      jcrc._span_advance_matrix(name, 8368))
        np.testing.assert_array_equal(tcrc._concat_fold_matrix(name, 5, 8368),
                                      jcrc._concat_fold_matrix(name, 5, 8368))
    rng = np.random.default_rng(0)
    msg = rng.integers(0, 2, 333)
    for name in ("24A", "24B", "16", "11", "6"):
        np.testing.assert_array_equal(tcrc.crc_ref(msg, name), jcrc.crc_ref(msg, name))


def test_gold_tables():
    for c_init in (0, 1, 0x4601 << 15, (1 << 31) - 1):
        np.testing.assert_array_equal(tscr.gold_ref(c_init, 500), jscr.gold_ref(c_init, 500))
    for taps in (tscr._X1_TAPS, tscr._X2_TAPS):
        np.testing.assert_array_equal(tscr._adv31_matrix(taps), jscr._adv31_matrix(taps))
    for k in (1, 100, 40633):
        for a, b in zip(tscr._two_level_mats(tscr._X2_TAPS, k), jscr._two_level_mats(jscr._X2_TAPS, k)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tscr._x1_bits(5000), jscr._x1_bits(5000))


@pytest.mark.parametrize("make", CELLS[:2])
def test_estimate_and_ofdm_constants(make):
    ref = make(jcell)
    twin = tcell.CellConfig.from_reference(ref)
    for a, b in zip(tpusch._estimate_constants(twin.pusch_cfg),
                    jpusch._estimate_constants(ref.pusch_cfg)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    args = (twin.scs, twin.dft_size, twin.cp, 0)
    assert tofdm._slot_geometry(*args) == jofdm._slot_geometry(*args)
    np.testing.assert_array_equal(tofdm._phase_comp(*args, twin.f_center_hz),
                                  jofdm._phase_comp(*args, ref.f_center_hz))
    assert tofdm.slot_nof_samples(*args) == jofdm.slot_nof_samples(*args)


def test_modulation_and_filter_tables():
    np.testing.assert_array_equal(test_._rc_filter_taps(), jest._rc_filter_taps())
    for mod in tmap.Modulation:
        jm = jmap.Modulation(int(mod))
        np.testing.assert_array_equal(tmap.constellation(mod), jmap.constellation(jm))
        for a, b in zip(tmap.pam_levels(mod), jmap.pam_levels(jm)):
            np.testing.assert_array_equal(a, b)
        assert tmap.bits_per_symbol(mod) == jmap.bits_per_symbol(jm)
