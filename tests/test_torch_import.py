"""The PyTorch port imports no JAX, and its config twins and host plans
equal the JAX package's value for value."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
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
from srsran_project_tpu_torch.ran import csi as tcsi
from srsran_project_tpu_torch.support import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELLS = [
    pytest.param(lambda m: m.CellConfig(), id="flagship"),
    pytest.param(lambda m: m.CellConfig(nof_rb=24, nof_ports=4, nof_layers=4), id="24prb-4x4"),
    pytest.param(lambda m: m.tiny_cell(), id="tiny"),
]


# Run in a fresh interpreter with the target's files as arguments: every
# absolute import in them (those inside functions too) must name neither
# jax nor the JAX package; then the files are loaded (a package's modules
# imported, a script executed as a module, not as __main__) together with
# every installed module they name, and sys.modules must hold neither.
_IMPORT_CHECK = """
import ast, importlib, importlib.util, pathlib, pkgutil, sys
FORBIDDEN = ("jax", "jaxlib", "srsran_project_tpu")
def forbidden(name):
    return name.split(".")[0] in FORBIDDEN
files = [pathlib.Path(f) for f in sys.argv[1:]]
named = set()
for f in files:
    for node in ast.walk(ast.parse(f.read_text())):
        if isinstance(node, ast.Import):
            named.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            named.add(node.module)
bad = sorted(n for n in named if forbidden(n))
assert not bad, ("imports", bad)
if files[0].name == "__init__.py":
    import srsran_project_tpu_torch as p
    loaded = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
    for n in loaded:
        importlib.import_module(n)
    assert len(loaded) >= 113, loaded
elif files[0].resolve().parts[-3] == "srsran_project_tpu_torch":
    importlib.import_module("srsran_project_tpu_torch." + files[0].resolve().parts[-2]
                            + "." + files[0].stem)
else:
    spec = importlib.util.spec_from_file_location(files[0].stem, files[0])
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for n in sorted(named):
    if importlib.util.find_spec(n.split(".")[0]) is not None:
        importlib.import_module(n)
bad = sorted(m for m in sys.modules if forbidden(m))
assert not bad, ("sys.modules", bad)
"""


def _import_targets(name: str) -> list[str]:
    if name == "package":
        pkg = os.path.join(REPO, "srsran_project_tpu_torch")
        files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
        return sorted(files, key=lambda f: not f.endswith(os.path.join(pkg, "__init__.py")))
    return [os.path.join(REPO, name)]


@pytest.mark.parametrize("target", ["package", "chip_smoke.py", "tools/profile_torch_paths.py",
                                    "srsran_project_tpu_torch/apps/du_low_sim.py",
                                    "srsran_project_tpu_torch/apps/bler_parity.py",
                                    "srsran_project_tpu_torch/apps/gnb_sim.py",
                                    "srsran_project_tpu_torch/apps/ue_sim.py",
                                    "srsran_project_tpu_torch/apps/cu_sim.py",
                                    "srsran_project_tpu_torch/apps/du_sim.py",
                                    "tests/torch_dist_worker.py"])
def test_package_imports_no_jax(target):
    """The port's package (its FAPI, DL channels, upper PHY, channel
    emulator, config and app modules, the reference-exact modes'
    estimator_ref / estimator_reftorch / demapper_i8, and the scheduler
    slice's modules, SLICE_MODULES below, among them),
    chip_smoke.py, the profiler and multi-GPU scripts and the apps (du_low_sim, the
    BLER-parity harness, gnb_sim and its UE side ue_sim, the split's
    cu_sim and du_sim; a module of the package's is imported by its dotted
    name) and the multi-rank tests' worker script name neither jax nor anything of
    srsran_project_tpu in any import, and loading them (with every module
    they name) in a fresh interpreter leaves both out of sys.modules."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK, *_import_targets(target)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# The scheduler slice's, the initial-access slice's, the RU slice's and the
# monolithic gNB slice's and the last slice's (the split, positioning, replay, the parallel
# layer) modules: each is among those the package check above loads in a fresh interpreter.
SLICE_MODULES = ["ran.tdd", "ran.dci", "ran.precoding", "l2sim", "l2sim.link_adaptation",
                 "l2sim.power_control", "l2sim.srs_alloc", "l2sim.ue_context_loops",
                 "l2sim.pdcch_alloc", "l2sim.pucch_alloc", "l2sim.uci_alloc", "l2sim.scheduler",
                 "l2sim.common_scheduling", "l2sim.multi_cell", "support.timers",
                 "support.metrics", "support.tracing", "support.logger", "phy.slot_pipeline",
                 "l2", "l2.mac_pdu", "l2sim.ra", "l2sim.fallback", "l2sim.si_paging",
                 "l2sim.slicing", "l2sim.test_mode", "fapi.bufferer", "ran.sch_info", "ran.band",
                 "ofh", "ofh.ethernet", "ofh.receiver", "ofh.timing", "ru", "ru.interface",
                 "ru.dummy", "ru.generic", "ru.ofh_ru", "ru.factory", "phy.lower_loop",
                 "support.native", "support.pcap", "support.remote_server",
                 "l2.security", "l2.pdcp", "l2.sdap", "l2.gtpu", "l2.nru", "l2.rlc",
                 "l2.cu_up_sim", "l2.du_high_sim", "l3", "l3.messages", "l3.amf_sim", "l3.rrc",
                 "l3.cu_cp", "l3.cu_up_e1", "l3.du_f1", "l3.mobility", "l3.cu_cp_sim",
                 "l3.e2_sim", "units", "apps.ue_sim", "apps.gnb_sim", "l3.transport",
                 "l3.positioning", "support.replay", "apps.cu_sim", "apps.du_sim", "parallel",
                 "parallel.mesh", "parallel.sharded_estimator", "parallel.sharded_decode",
                 "parallel.sharded_carrier", "parallel.sharded_encode", "parallel.multihost"]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_is_checked(module):
    """The module is one the package check walks, and no import in it
    (those inside functions too) names jax or the JAX package."""
    import ast
    import pkgutil

    import srsran_project_tpu_torch as p

    name = f"{p.__name__}.{module}"
    assert name in {m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")}
    path = os.path.join(REPO, p.__name__, *module.split("."))
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) else path + ".py"
    for node in ast.walk(ast.parse(open(path).read())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0
                 else [])
        assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                             "srsran_project_tpu")], (path, names)


# The JAX package's modules and functions that stay out of the port by its
# ground rules: file (or file:function) -> the words that name it in
# ROADMAP.md's stay-out list.
STAY_OUT = {
    "support/hostio.py": "`support/{hostio,staging}`",
    "support/staging.py": "`support/{hostio,staging}`",
    "ops/demap_pallas.py": "`*_pallas.py`",
    "ops/equalizer_pallas.py": "`*_pallas.py`",
    "ops/ldpc/decoder_pallas.py": "`*_pallas.py`",
    "ops/estimator_refjax.py": "`ops/estimator_refjax`",
    "ops/ofdm.py:_matmul_dft": "the matmul DFT",
    "parallel/sharded_encode.py:encode_hlo_text": "`sharded_encode.encode_hlo_text`",
}


def _roadmap_stay_outs() -> str:
    """The text of ROADMAP.md's stay-out list (from "these stay out:" to
    the next blank line)."""
    text = open(os.path.join(REPO, "ROADMAP.md")).read()
    start = text.index("these stay out:")
    return text[start : text.index("\n\n", start)]


def _top_level_names(path: str) -> set:
    import ast

    tree = ast.parse(open(path).read())
    return {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def test_every_reference_module_has_a_port_file():
    """Every module of the JAX package and every app at the root's apps/
    has its file in the port, or stands on ROADMAP's stay-out list."""
    ref = os.path.join(REPO, "srsran_project_tpu")
    port = os.path.join(REPO, "srsran_project_tpu_torch")
    modules = sorted(os.path.relpath(os.path.join(d, f), ref) for d, _, fs in os.walk(ref)
                     for f in fs if f.endswith(".py"))
    modules += sorted(os.path.join("apps", f) for f in os.listdir(os.path.join(REPO, "apps"))
                      if f.endswith(".py"))
    assert len(modules) > 140 and "apps/cu_sim.py" in modules
    missing = [m for m in modules if not os.path.isfile(os.path.join(port, m))]
    assert missing == sorted(k for k in STAY_OUT if ":" not in k)
    listed = _roadmap_stay_outs()
    for item, words in STAY_OUT.items():
        assert words in listed, (item, words)
    for item in (k for k in STAY_OUT if ":" in k):
        path, name = item.split(":")
        assert name in _top_level_names(os.path.join(ref, path))
        assert name not in _top_level_names(os.path.join(port, path))


# The last slice's modules: every public function and class of the
# reference's has its namesake in the port (the stay-outs excepted), and so
# do the private helpers the parallel layer's callers reach.
SLICE_FILES = ["l3/transport.py", "l3/positioning.py", "support/replay.py", "parallel/mesh.py",
               "parallel/sharded_estimator.py", "parallel/sharded_decode.py",
               "parallel/sharded_carrier.py", "parallel/sharded_encode.py",
               "parallel/multihost.py", "models/cell.py"]
SLICE_PRIVATE = {"_halo_exchange", "_check_shardable", "_local_geometry", "_global_pilots",
                 "_encode_tb_cb_sharded", "_flatten_arrays", "_slot_key"}
# The port's models/cell has one eager encode and decode for the
# reference's staged and fused programs (its docstring says which).
RENAMED = {"encode_slot_fused": "encode_slot", "decode_slot_fused": "decode_slot"}


@pytest.mark.parametrize("path", SLICE_FILES)
def test_slice_functions_have_port_namesakes(path):
    ref = _top_level_names(os.path.join(REPO, "srsran_project_tpu", path))
    port = _top_level_names(os.path.join(REPO, "srsran_project_tpu_torch", path))
    want = {n for n in ref if not n.startswith("_") or n in SLICE_PRIVATE}
    want -= {k.split(":")[1] for k in STAY_OUT if k.startswith(path + ":")}
    assert {RENAMED.get(n, n) for n in want} - port == set()


def test_native_build_and_ru_modes_import_no_jax(tmp_path):
    """In a fresh interpreter, building and loading the port's native
    library (into a fresh build directory) and a small RU-mode run of the
    app (--ru ofh: the serdes through it) leave jax and the JAX package
    out of sys.modules."""
    code = ("import sys\n"
            "from srsran_project_tpu_torch.support import native\n"
            f"native.BUILD_DIR = native.pathlib.Path({str(tmp_path)!r})\n"
            "native.get_lib()\n"
            "assert native.build_dir().parent == native.BUILD_DIR\n"
            "from srsran_project_tpu_torch.apps import du_low_sim\n"
            "rc = du_low_sim.main(sys.argv[1:])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'srsran_project_tpu'))\n"
            "assert not bad, bad\n"
            "sys.exit(rc)")
    args = ["--cpu", "--set", "cell.nof_rb=12", "--set", "cell.nof_ports=1", "--set",
            "cell.nof_layers=1", "--set", "cell.modulation=qpsk", "--channel", "single",
            "--snr-db", "30", "--slots", "1", "--ru", "ofh"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert "BLER=0.000" in proc.stderr
    assert [p.name for p in tmp_path.iterdir()] == [native.build_dir().name]


def test_app_runs_without_yaml():
    """The app's defaults and --set overrides need no PyYAML: with yaml made
    unimportable, a small CPU run in a fresh interpreter passes."""
    code = ("import sys; sys.modules['yaml'] = None\n"
            "from srsran_project_tpu_torch.apps import du_low_sim\n"
            "sys.exit(du_low_sim.main(sys.argv[1:]))")
    args = ["--cpu", "--set", "cell.nof_rb=12", "--set", "cell.nof_ports=1", "--set",
            "cell.nof_layers=1", "--set", "cell.modulation=qpsk", "--channel", "single",
            "--snr-db", "30", "--slots", "1"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BLER=0.000" in proc.stderr


# ---- the port's copies of the JAX package's host modules --------------------

@pytest.mark.parametrize("bg", [graphs.BG1, graphs.BG2])
def test_graph_tables_copy(bg):
    """ops/ldpc/graphs.py: every lifted graph, and the selection rules."""
    from srsran_project_tpu_torch.ops.ldpc import graphs as tgraphs

    assert tgraphs.ALL_LIFTING_SIZES == graphs.ALL_LIFTING_SIZES
    for z in graphs.ALL_LIFTING_SIZES:
        jg, tg = graphs.get_graph(bg, z), tgraphs.get_graph(bg, z)
        assert (tg.bg, tg.z, tg.m, tg.n, tg.kb) == (jg.bg, jg.z, jg.m, jg.n, jg.kb)
        np.testing.assert_array_equal(tg.shifts, jg.shifts)
        assert tg.shifts.dtype == jg.shifts.dtype
    for a in (100, 292, 293, 600, 3824, 3825, 20000):
        for rate in (0.2, 0.25, 0.5, 0.67, 0.7, 0.93):
            assert tgraphs.select_base_graph(a, rate) == graphs.select_base_graph(a, rate)
    for a in (100, 292, 600, 3000, 3824):
        for c in (1, 2, 5):
            assert tgraphs.base_graph_kb(bg, a) == graphs.base_graph_kb(bg, a)
            assert (tgraphs.select_lifting_size(bg, a, c)
                    == graphs.select_lifting_size(bg, a, c))


def test_tbs_and_constants_copy():
    """ran/tbs.py and ran/constants.py."""
    from srsran_project_tpu.ran import constants as jconst
    from srsran_project_tpu.ran import tbs as jtbs
    from srsran_project_tpu_torch.ran import constants as tconst
    from srsran_project_tpu_torch.ran import tbs as ttbs

    assert (ttbs._TABLES, ttbs._TP_TABLES) == (jtbs._TABLES, jtbs._TP_TABLES)
    for table, rows in jtbs._TABLES.items():
        for mcs in range(len(rows)):
            assert ttbs.mcs_to_qm_rate(mcs, table) == jtbs.mcs_to_qm_rate(mcs, table)
    for table, rows in jtbs._TP_TABLES.items():
        for mcs in range(len(rows)):
            for pi2 in (False, True):
                assert (ttbs.mcs_to_qm_rate(mcs, table, True, pi2)
                        == jtbs.mcs_to_qm_rate(mcs, table, True, pi2)), (table, mcs, pi2)
    for nof_prb in (1, 6, 24, 52, 106, 273):
        for nsym, dmrs_re in ((13, 12), (12, 6), (4, 12)):
            for qm, rate in ((2, 0.12), (4, 0.48), (6, 0.55), (8, 0.926)):
                for nl in (1, 2, 4):
                    args = (nof_prb, nsym, dmrs_re, rate, qm, nl)
                    assert ttbs.calculate_tbs(*args) == jtbs.calculate_tbs(*args), args
    assert ttbs.TBS_TABLE == jtbs.TBS_TABLE
    for name in ("NRE", "MAX_RB", "MAX_PORTS", "MAX_LAYERS", "KAPPA", "T_C"):
        assert getattr(tconst, name) == getattr(jconst, name)
    for scs in jconst.SubcarrierSpacing:
        ts = tconst.SubcarrierSpacing(int(scs))
        assert ts.name == scs.name
        assert tconst.nof_slots_per_frame(ts) == jconst.nof_slots_per_frame(scs)
        for cp in jconst.CyclicPrefix:
            tcp = tconst.CyclicPrefix(int(cp))
            assert tconst.nof_symbols_per_slot(tcp) == jconst.nof_symbols_per_slot(cp)
            for nof_rb in (24, 106, 273):
                dft = jconst.min_dft_size(nof_rb)
                assert tconst.min_dft_size(nof_rb) == dft
                assert tconst.cp_lengths(ts, dft, tcp) == jconst.cp_lengths(scs, dft, cp)
                assert tconst.sampling_rate_hz(ts, dft) == jconst.sampling_rate_hz(scs, dft)


def test_dmrs_and_allocation_copy():
    """ran/dmrs.py (masks, pilots, c_init) and phy/allocation.py (RE and
    pilot indices), on the flagship's and the multi-UE slot's allocations."""
    from srsran_project_tpu.phy import allocation as jalloc
    from srsran_project_tpu.ran import dmrs as jdmrs
    from srsran_project_tpu_torch.phy import allocation as talloc
    from srsran_project_tpu_torch.ran import dmrs as tdmrs

    for ct in (1, 2):
        assert tdmrs.pilots_per_prb(ct) == jdmrs.pilots_per_prb(ct)
        for ncdm in (1, 2, 3)[: 2 if ct == 1 else 3]:
            np.testing.assert_array_equal(tdmrs.data_subcarrier_mask(ct, ncdm),
                                          jdmrs.data_subcarrier_mask(ct, ncdm))
            assert tdmrs.sch_to_dmrs_beta(ncdm) == jdmrs.sch_to_dmrs_beta(ncdm)
        for port in range(4):
            assert tdmrs.cdm_group(ct, port) == jdmrs.cdm_group(ct, port)
            for a, b in zip(tdmrs.pilot_subcarriers(ct, port, 24, 3),
                            jdmrs.pilot_subcarriers(ct, port, 24, 3)):
                np.testing.assert_array_equal(a, b)
    for slot, sym, n_id, n_scid in ((0, 2, 0, 0), (7, 11, 1007, 1), (19, 3, 65535, 0)):
        assert (tdmrs.dmrs_c_init(slot, sym, n_id, n_scid)
                == jdmrs.dmrs_c_init(slot, sym, n_id, n_scid))
    for kw in (dict(rb_start=0, rb_count=273, sym_start=1, sym_count=13, dmrs_symbols=(2,)),
               dict(rb_start=0, rb_count=24, sym_start=1, sym_count=13, dmrs_symbols=(2,),
                    crb_start=160),
               dict(rb_start=4, rb_count=8, sym_start=0, sym_count=14, dmrs_symbols=(2, 11),
                    nof_cdm_groups_without_data=1)):
        ja, ta = jalloc.Allocation(**kw), talloc.Allocation(**kw)
        assert talloc.Allocation.from_fields(ja) == ta
        assert talloc.nof_data_re(ta) == jalloc.nof_data_re(ja)
        np.testing.assert_array_equal(talloc.data_re_indices(ta, 14, 3276),
                                      jalloc.data_re_indices(ja, 14, 3276))
        for port in range(4):
            for a, b in zip(talloc.pilot_re_indices(ta, port, 3276),
                            jalloc.pilot_re_indices(ja, port, 3276)):
                np.testing.assert_array_equal(a, b)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


# Fields a twin has beyond the reference's, with the value a copy of a
# reference config gives them: PdschConfig's reserved RE patterns.
_PORT_ONLY = {"reserved": ()}


def _same_fields(ref, twin):
    """Same field names, but for the twin's own ``_PORT_ONLY`` fields at
    their values; equal values (enums compared by value, nested
    dataclasses such as the two packages' Allocation field by field)."""
    a, b = _fields(ref), _fields(twin)
    assert a.keys() <= b.keys(), a.keys() - b.keys()
    for k in b.keys() - a.keys():
        assert b[k] == _PORT_ONLY[k], (k, b[k])
    for k in a:
        va, vb = a[k], b[k]
        if dataclasses.is_dataclass(va):
            _same_fields(va, vb)
            continue
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
    _same_fields(ref.alloc, twin.alloc)
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
    ("equalizer", "zf_ref"),
])
def test_out_of_slice_values_raise(field, value):
    """The CellConfig values that were outside the port before the
    reference-exact modes were ported now reach its PuschConfig and
    SchConfig as in the reference, and only unknown values raise."""
    cfg = tcell.CellConfig(**{field: value})
    ref = jcell.CellConfig(**{field: value})
    assert getattr(cfg.pusch_cfg, field) == value
    _same_fields(ref.pusch_cfg, cfg.pusch_cfg)
    _same_fields(ref.pusch_cfg.sch, cfg.pusch_cfg.sch)
    with pytest.raises(ValueError, match=field):
        tcell.CellConfig(**{field: value + "_unknown"}).pusch_cfg  # noqa: B018


def _pusch_field(field, value):
    return lambda: tpusch.PuschConfig(tbs=1000, target_code_rate=0.5,
                                      modulation=tmap.Modulation.QAM16,
                                      alloc=tcell.CellConfig().alloc, **{field: value})


# The reference-exact modes: (what takes the value, how to build it, the
# field and its value).
REFERENCE_MODES = [
    ("PuschConfig.equalizer", _pusch_field("equalizer", "mmse_ref"), "equalizer", "mmse_ref"),
    ("PuschConfig.estimator", _pusch_field("estimator", "reference"), "estimator", "reference"),
    ("PuschConfig.demapper", _pusch_field("demapper", "reference"), "demapper", "reference"),
    ("PuschConfig.ldpc_decoder", _pusch_field("ldpc_decoder", "reference_i8"), "ldpc_decoder",
     "reference_i8"),
    ("SchConfig.decoder", lambda: tsch.SchConfig(tbs=1000, target_code_rate=0.5, qm=4,
                                                 nof_layers=1, nof_total_bits=2400,
                                                 decoder="reference_i8"), "decoder",
     "reference_i8"),
]


@pytest.mark.parametrize("what, build, field, value", REFERENCE_MODES,
                         ids=[r[0] for r in REFERENCE_MODES])
def test_reference_mode_is_accepted(what, build, field, value):
    """Each reference-exact mode builds, carries its value, and equals the
    reference's config of the same fields; PuschConfig hands ldpc_decoder
    on to SchConfig.decoder."""
    cfg = build()
    assert getattr(cfg, field) == value
    if isinstance(cfg, tpusch.PuschConfig):
        ref = jpusch.PuschConfig(tbs=1000, target_code_rate=0.5,
                                 modulation=jmap.Modulation.QAM16,
                                 alloc=jcell.CellConfig().alloc, **{field: value})
        assert tpusch.PuschConfig.from_reference(ref) == cfg
        assert cfg.sch.decoder == ref.sch.decoder == cfg.ldpc_decoder


def test_every_raise_is_pinned():
    """The package raises NotImplementedError nowhere: every mode of the
    reference it meets is ported (the app's RU, pcap and remote-control
    flags were the last refusals).  A new refusal must name its ROADMAP
    sub-item and get a test of its own here."""
    pkg = os.path.join(REPO, "srsran_project_tpu_torch")
    sites = sorted(os.path.relpath(os.path.join(d, f), pkg) for d, _, fs in os.walk(pkg)
                   for f in fs if f.endswith(".py")
                   for line in open(os.path.join(d, f)) if "NotImplementedError" in line)
    assert sites == [], sites


# A UCI config with a CSI report configuration: two-step CSI.
_TWO_STEP_CSI = tpusch.UciOnPuschConfig(
    nof_harq_ack_bits=2, nof_csi1_bits=6, nof_csi2_bits=5,
    csi_report_cfg=tcsi.CsiReportConfig(nof_csi_rs_ports=4))


def test_two_step_csi_in_the_slot_raises():
    """process_slot sends a two-step CSI grant away with ValueError, as the
    reference's slot does (its part-2 size follows the decoded RI)."""
    from srsran_project_tpu_torch.phy import ul_slot as tul

    cfg = dataclasses.replace(tcell.CellConfig(nof_rb=4, nof_ports=1, nof_layers=1).pusch_cfg,
                              uci=_TWO_STEP_CSI)
    with pytest.raises(ValueError, match="two-step CSI"):
        tul.process_slot(torch.zeros((1, 14, 48), dtype=torch.complex64),
                         [tul.UlSlotPdu(rnti=1, first_rb=0, config=cfg)])


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


def test_slot_point_copy():
    """ran/slot_point.py: fields, arithmetic and wrap-around."""
    from srsran_project_tpu.ran import constants as jconst
    from srsran_project_tpu.ran.slot_point import SlotPoint as JSlot
    from srsran_project_tpu_torch.ran import constants as tconst
    from srsran_project_tpu_torch.ran.slot_point import SlotPoint as TSlot

    for scs in jconst.SubcarrierSpacing:
        ts = tconst.SubcarrierSpacing(int(scs))
        spf = jconst.nof_slots_per_frame(scs)
        for sfn, n in ((0, 0), (1023, spf - 1), (517, spf // 2), (1024 + 3, 1)):
            j, t = JSlot.from_sfn_slot(scs, sfn, n), TSlot.from_sfn_slot(ts, sfn, n)
            assert (t.count, t.sfn, t.slot_in_frame, t.slot_in_subframe, t.subframe) == \
                (j.count, j.sfn, j.slot_in_frame, j.slot_in_subframe, j.subframe)
            for d in (1, 7, spf * 1024 - 1, spf * 600):
                assert (t + d).count == (j + d).count
                assert (t + d) - t == (j + d) - j
            assert repr(t) == repr(j)
        with pytest.raises(ValueError):
            TSlot.from_sfn_slot(ts, 0, spf)
    assert TSlot.from_sfn_slot(tconst.SubcarrierSpacing.KHZ30, 1, 2) < \
        TSlot.from_sfn_slot(tconst.SubcarrierSpacing.KHZ30, 1, 3)


def test_file_vector_copy(tmp_path):
    """support/file_vector.py: the same bytes for every element type."""
    from srsran_project_tpu.support import file_vector as jfv
    from srsran_project_tpu_torch.support import file_vector as tfv

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(257) + 1j * rng.standard_normal(257)).astype(np.complex64) * 300
    for kind in ("cbf16", "cf32", "f32", "i16", "i8", "u8"):
        data = x if kind in ("cbf16", "cf32") else (x.real if kind == "f32" else x.real % 100)
        jfv.write_vector(str(tmp_path / "j"), data, kind)
        tfv.write_vector(str(tmp_path / "t"), data, kind)
        assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes(), kind
        np.testing.assert_array_equal(tfv.read_vector(str(tmp_path / "t"), kind),
                                      jfv.read_vector(str(tmp_path / "j"), kind))
