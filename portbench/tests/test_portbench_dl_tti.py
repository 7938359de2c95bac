"""The ``fapi_dl_tti`` cell on the CPU at the small sizes
(``small_dl_tti.py``): its files found by name and every key read, a sound
traced run correct with the new per-layer metrics read, the spans' self
times adding up to the entries' time, each fault of the timed path
refused, the bfloat16 control refused, and the run's path and the new
reference loading nothing of JAX or the JAX package."""

import copy
import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from portbench.harness import cells, spec as spec_mod, window
from portbench.reference import link
from portbench.tests import small_dl_tti
from srsran_project_tpu_torch.phy import pdcch, pdsch, ssb
from srsran_project_tpu_torch.support import tracing

CPU = torch.device("cpu")
NEW_METRICS = ("dl_pdcch_ms_per_slot", "dl_broadcast_ms_per_slot", "dl_fapi_ms_per_slot")


def _run(traced: bool = False) -> dict:
    return window.run(small_dl_tti.spec(), 2147483647 + 43, 0.05, traced, CPU, 0.0)


def test_the_cell_loads_and_its_numbers_are_its_limits():
    spec = spec_mod.load("fapi_dl_tti")
    cells.check_files(spec.config, spec.traffic, cells.generator(spec.traffic["generator"]))
    assert spec.chips == 1 and spec.config["reduced"] == []
    assert {m["name"] for m in spec.end_to_end} == {"dl_slots_per_s", "setup_s"}
    assert set(NEW_METRICS) | {"dl_host_ms_per_slot", "device_idle_pct.dl",
                               "dl_bit_chain_ms_per_slot", "dl_grid_ms_per_slot"} == {
        m["name"] for m in spec.per_layer}
    small = small_dl_tti.spec()
    entry, _order, sampled = window.build(small, 3, CPU)
    numbers, _ = window.check(entry, window.Driver(entry, set(sampled)), sampled, small.limits)
    assert set(numbers) == set(spec.limits) == {"iq_gap", "re_occupancy_mismatch"}


@pytest.mark.parametrize("where,key,value", [
    ("trs", "nzp_id", 3), ("coreset", "precoder_granularity", "all"), ("ssb", "beta_pss_db", 3),
    ("dci", "search_space", 2)])
def test_a_key_no_code_reads_is_refused(where, key, value):
    spec = small_dl_tti.spec()
    cfg = copy.deepcopy(spec.config)
    cfg[where][key] = value
    with pytest.raises(ValueError, match="read by no code"):
        cells.entry(cfg, spec.traffic, 3, CPU)


@pytest.mark.parametrize("where,key,value", [
    ("ssb", "first_symbols", [0]), ("pdsch_first_rb", None, 10), ("trs", "k0", 1),
    ("dci", "aggregation_levels", [4, 4])],
    ids=["ssb-on-coreset", "pdsch-on-ssb", "trs-k0", "cces-beyond-coreset"])
def test_a_plan_the_program_cannot_take_is_refused(where, key, value):
    spec = small_dl_tti.spec()
    cfg = copy.deepcopy(spec.config)
    if key is None:
        cfg[where] = value
    else:
        cfg[where][key] = value
    with pytest.raises(ValueError):
        cells.entry(cfg, spec.traffic, 3, CPU)


def test_a_sound_traced_run_is_correct_and_reads_the_new_metrics():
    tracing.l1_tracer.take()
    res = _run(traced=True)
    assert res["correct"], res["numbers"]
    assert res["numbers"] == {"iq_gap": 0.0, "re_occupancy_mismatch": 0}
    for m in small_dl_tti.spec().per_layer:
        if m["source"] in ("program_span", "program_counter"):
            value = res["metrics"][m["name"]]["value"]
            assert isinstance(value, float) and value > 0, m["name"]


def test_the_spans_self_times_add_up_to_the_entries_time():
    """Every span of a call nests in ``upper_phy.process_dl_tti`` or
    ``upper_phy.process_ul_dci``, so their self times sum to the entries'
    time: no span counted twice and no stretch lost."""
    spec = small_dl_tti.spec()
    entry = cells.entry(spec.config, spec.traffic, 2147483647 + 47, CPU)
    tracing.l1_tracer.take()
    tracing.l1_tracer.enabled = True
    try:
        for unit in range(entry.units):
            entry.dispatch(entry.generate(unit, 0, None))
    finally:
        tracing.l1_tracer.enabled = False
    t = tracing.l1_tracer.take().totals
    assert t["upper_phy.process_dl_tti"].spans == t["upper_phy.process_ul_dci"].spans == 2
    assert {"pdsch.bit_chain", "pdsch.grid", "pdcch.encode", "ssb.assemble",
            "csi_rs.generate"} <= set(t)
    assert sum(x.self_ns for x in t.values()) == (t["upper_phy.process_dl_tti"].total_ns
                                                  + t["upper_phy.process_ul_dci"].total_ns)


def _bits_over_the_trs(fn):
    """The PDSCH mapped over the TRS (with ``_grid_over_the_trs``): its
    reserved REs dropped."""
    def broken(tbs, rntis, cfg):
        return fn(tbs, rntis, dataclasses.replace(cfg, reserved=()))
    return broken


def _grid_over_the_trs(fn):
    def broken(grid, first_rbs, cfg, cw, precoding):
        return fn(grid, first_rbs, dataclasses.replace(cfg, reserved=()), cw, precoding)
    return broken


def _dci_bit_flipped(fn):
    def broken(payload, rnti, cfg):
        payload = payload.clone()
        payload[..., 0] ^= 1
        return fn(payload, rnti, cfg)
    return broken


def _dci_at_the_wrong_cce(fn):
    def broken(payload, rnti, cfg):
        cce = cfg.cce_index + cfg.aggregation_level
        if cce + cfg.aggregation_level > cfg.nof_regs // 6:
            cce = cfg.cce_index - cfg.aggregation_level
        return fn(payload, rnti, dataclasses.replace(cfg, cce_index=cce))
    return broken


def _ssb_dropped(fn):
    def broken(payload, cfg, beta=1.0, first_mask=None):
        return torch.zeros_like(fn(payload, cfg, beta, first_mask))
    return broken


def _precoders_swapped(fn):
    def broken(grid, first_rbs, cfg, cw, precoding):
        return fn(grid, first_rbs, cfg, cw, precoding.flip(0))
    return broken


@pytest.mark.parametrize("faults", [
    [(pdsch, "multi_bit_chain", _bits_over_the_trs), (pdsch, "add_multi_grid", _grid_over_the_trs)],
    [(pdcch, "process", _dci_bit_flipped)],
    [(pdcch, "process", _dci_at_the_wrong_cce)],
    [(ssb, "assemble_ssb", _ssb_dropped)],
    [(pdsch, "add_multi_grid", _precoders_swapped)],
], ids=["pdsch-over-trs", "dci-bit", "dci-wrong-cce", "ssb-dropped", "precoders-swapped"])
def test_a_broken_path_is_not_correct(monkeypatch, faults):
    for module, name, fault in faults:
        monkeypatch.setattr(module, name, fault(getattr(module, name)))
    res = _run()
    assert not res["correct"], res["numbers"]


def test_the_control_is_refused_on_the_cpu():
    spec = small_dl_tti.spec()
    entry, _order, sampled = window.build(spec, 5, CPU)
    got = entry.expected(sampled, link.BFLOAT16)
    numbers = window.check(entry, window.Driver(entry, set(sampled)), sampled, spec.limits,
                           got=got)[0]
    assert numbers["iq_gap"] > spec.limits["iq_gap"], numbers
    assert not window.verdict(numbers, spec.limits)


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(tracing, "l1_tracer", object())
    ctx = window.Context({"slots": 8}, object(), [(0, 0)], 8, None, {}, 0)
    for name in NEW_METRICS:
        assert spec_mod.metric_reader(name)(ctx) is None


def test_the_run_path_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", """
import json, sys, torch
from portbench.harness import window
from portbench.tests import small_dl_tti
res = window.run(small_dl_tti.spec(), 7, 0.05, True, torch.device("cpu"), 0.0)
assert res["correct"], res["numbers"]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""], cwd=spec_mod.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "srsran_project_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "srsran_project_tpu"}


def test_the_new_reference_loads_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", """
import json, sys
from portbench.reference import dl, pdcch, ssb
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""], cwd=spec_mod.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "srsran_project_tpu", "srsran_project_tpu_torch"}
    assert torch.backends.cuda.matmul.allow_tf32 is False
