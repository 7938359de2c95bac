"""BENCHMARK.json against the benchmark's contract, every file it names
found by name, and the readers of the trace and of the metrics on
synthetic inputs."""

import copy
import json
import re
import types

import pytest
import torch

from portbench.harness import cells, spec as spec_mod, trace, window, yardstick
from portbench.reference import link

BENCH = json.loads((spec_mod.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_the_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len((spec_mod.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


def test_names_units_and_texts():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_and_reports_what_it_must(cell):
    spec = spec_mod.load(cell)
    e2e = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and spec.per_layer and spec.chips == 1
    for m in spec.per_layer:
        assert m["moves"] in e2e
        assert callable(spec_mod.metric_reader(m["name"]))
    assert hasattr(cells.generator(spec.traffic["generator"]), "Entry")
    cells.check_files(spec.config, spec.traffic, cells.generator(spec.traffic["generator"]))
    assert set(spec.limits) and all(v >= 0 for v in spec.limits.values())


def test_configuration_files_say_what_was_cut():
    for c in BENCH["configs"]:
        cfg = json.loads((spec_mod.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []


class _Event:
    def __init__(self, name, dev, start, end, annotation=False):
        self._v = (name, dev, start, end, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_the_trace_reader_takes_the_union_and_names_the_gaps():
    ev = [_Event("portbench.generator", "DeviceType.CPU", 0, 100),
          _Event("portbench.dispatch", "DeviceType.CPU", 100, 600),
          _Event("portbench.readback", "DeviceType.CPU", 600, 1000),
          _Event("portbench.dispatch", "DeviceType.CUDA", 100, 600, True),
          _Event("k1", "DeviceType.CUDA", 200, 400),
          _Event("k2", "DeviceType.CUDA", 300, 500),
          _Event("Memcpy DtoH", "DeviceType.CUDA", 700, 800)]
    tr = trace.read(ev)
    assert tr.window_s == pytest.approx(1000e-9) and tr.busy_s == pytest.approx(400e-9)
    assert [n for n, _ in tr.kernels] == ["k1", "k2"]
    gaps = dict(tr.idle_gaps)
    assert gaps["generator"] == pytest.approx(100e-9)
    assert gaps["dispatch"] == pytest.approx(200e-9)
    assert gaps["readback"] == pytest.approx(300e-9)


def _ctx(tr, entry=None, traced=(), reference=None, slots=8, dispatch_s=0.008):
    w = {"calls": 1, "slots": slots, "elapsed_s": 1.0, "latency_s": [0.1],
         "dispatch_s": dispatch_s, "slots_by_second": [slots]}
    return window.Context(w, tr, list(traced), slots, entry, reference or {}, 0)


def test_the_roofline_reader_counts_the_work_and_only_the_decoder_kernels():
    read = spec_mod.metric_reader("ldpc_decode_roofline_pct")
    roof = spec_mod.module("metrics", "ldpc_decode_roofline_pct")
    g = link.Grant(nof_rb=24, first_rb=0, layers=1, qm=2, rate=0.5, nof_ports=1)
    needed = torch.full((g.seg.c,), 2)
    entry = types.SimpleNamespace(
        ldpc_kernel="K1", decoded_tbs=lambda unit, step, ref: [(g, needed), (g, needed)])
    ops, nbytes = roof.work([(g, needed)] * 2, buffer_input=False)
    least = yardstick.bound_s(nbytes, ops)
    tr = types.SimpleNamespace(kernels=[
        ("(anonymous namespace)::decode_dematch_kernel((anonymous namespace)::Args)",
         4 * least),
        ("void at::native::reduce_kernel<512>(...)", 9.0)])
    assert read(_ctx(tr, entry, [(0, 0)])) == pytest.approx(25.0)
    assert read(_ctx(tr, entry, [])) is None
    k2 = types.SimpleNamespace(ldpc_kernel="K2", decoded_tbs=entry.decoded_tbs)
    assert roof.launches(_ctx(tr, k2, [(0, 0)])) == [roof.work([(g, needed)] * 2, True)]
    assert yardstick.bound_s(3.35e12, 1.0) == pytest.approx(1.0)


def test_device_metrics_read_nothing_without_a_device_trace():
    ctx = _ctx(trace.Trace(1.0, 0.0, [], [], []))
    for name in ("ul_kernels_per_slot", "device_idle_pct.ul", "device_idle_pct.dl",
                 "ldpc_decode_roofline_pct", "ul_kernels_per_slot.latency",
                 "device_idle_pct.latency", "ldpc_decode_roofline_pct.latency"):
        assert spec_mod.metric_reader(name)(ctx) is None
    for name in ("ul_host_ms_per_slot", "dl_host_ms_per_slot", "ul_host_ms_per_slot.latency"):
        assert spec_mod.metric_reader(name)(ctx) == pytest.approx(1.0)
    assert spec_mod.metric_reader("ul_slots_per_s.latency")(ctx) == pytest.approx(8.0)


@pytest.mark.parametrize("config", [c["file"] for c in BENCH["configs"]])
def test_each_configuration_states_its_grants(config):
    """The TBS, codeblocks, base graph and lifting size that a configuration
    states are its grants' (no program needed)."""
    cfg = json.loads((spec_mod.ROOT / config).read_text())
    grants = [cells.grant(cfg, ue) for ue in cells.ue_layout(cfg)]
    cells.check_geometry(cfg, grants, [g.tbs for g in grants])
    wrong = copy.deepcopy(cfg)
    wrong["expected"]["codeblocks"][0] += 1
    with pytest.raises(ValueError, match="states"):
        cells.check_geometry(wrong, grants, [g.tbs for g in grants])


@pytest.mark.parametrize("where,key,value", [
    ((), "loop", "open"), (("carrier",), "cyclic_prefix", "extended"),
    (("channel",), "doppler_hz", 5.0), (("ues", 0), "mcs", 27),
    (("receiver",), "demapper", "planes"), (("carrier",), "scs_khz", 120)])
def test_a_key_no_code_reads_or_a_value_not_covered_is_refused(where, key, value):
    spec = spec_mod.load("su_ul_b8")
    cfg = copy.deepcopy(spec.config)
    d = cfg
    for k in where:
        d = d[k]
    d[key] = value
    with pytest.raises(ValueError):
        cells.check_files(cfg, spec.traffic, cells.generator("decode_slot"))
    with pytest.raises(ValueError, match="no code reads"):
        cells.check_files(spec.config, dict(spec.traffic, loop="open"),
                          cells.generator("decode_slot"))
    with pytest.raises(KeyError):
        cells.channel("tdl_a")
