"""The per-layer metrics that read the program's own spans, on traced runs
of the small cells on the CPU: each reports a number in every cell that
lists it, the stages and the entry's unspanned time add up to the entry
spans' time, and the program's LDPC iterations a codeblock are the ones the
reference decoder ran on the same codeblocks."""

import pytest
import torch

from portbench.harness import spans, spec as spec_mod, window
from portbench.tests import small
from srsran_project_tpu_torch.support import tracing

CPU = torch.device("cpu")
ENTRIES = ("cell.decode_slot", "ul_slot.process_slot", "cell.encode_slot")
CELLS = [w["name"] for w in small.BENCH["workloads"]]


def _program_metrics(spec) -> list:
    return [m["name"] for m in spec.per_layer
            if m["source"] in ("program_span", "program_counter")]


@pytest.fixture
def traced_run(monkeypatch):
    """A traced run of a small cell: (its result, the readers' context)."""
    seen = []
    reader = spec_mod.metric_reader

    def recording(name):
        def read(ctx):
            seen.append(ctx)
            return reader(name)(ctx)
        return read

    monkeypatch.setattr(spec_mod, "metric_reader", recording)

    def run(workload):
        tracing.l1_tracer.take()  # nothing kept from before the run
        res = window.run(small.spec(workload), 2147483647 + 23, 0.05, True, CPU, 0.0)
        return res, seen[-1]
    return run


@pytest.mark.parametrize("workload", CELLS)
def test_each_span_metric_reports_a_number(traced_run, workload):
    res, ctx = traced_run(workload)
    names = _program_metrics(small.spec(workload))
    assert names and res["correct"]
    for name in names:
        value = res["metrics"].get(name, {}).get("value")
        assert isinstance(value, float) and value > 0, (name, value)
    totals = spans.totals(ctx)
    entry_ns = sum(totals[n].total_ns for n in ENTRIES if n in totals)
    assert sum(t.self_ns for t in totals.values()) == entry_ns
    shown = sum(v["value"] for k, v in res["metrics"].items()
                if k in names and k.endswith(("ms_per_slot", "ms_per_slot.latency")))
    assert shown == pytest.approx(entry_ns / 1e6 / ctx.traced_slots, rel=1e-9)


@pytest.mark.parametrize("workload", ["su_ul_b8", "mu8_ul", "su_ul_b8_bler10", "su_ul_b1"])
def test_the_iterations_are_those_the_reference_ran(traced_run, workload):
    """The reference reports the iterations each codeblock needed; one that
    stopped early ran one more (``test_portbench_reference``), one that did
    not ran the whole budget."""
    res, ctx = traced_run(workload)
    ran = codeblocks = 0
    for unit, step in ctx.traced:
        for g, needed in ctx.entry.decoded_tbs(unit, step, ctx.reference):
            ran += int(torch.clamp(torch.as_tensor(needed) + 1, max=g.nof_iterations).sum())
            codeblocks += int(torch.as_tensor(needed).numel())
    name = "ldpc_iterations_per_cb" + (".latency" if workload == "su_ul_b1" else "")
    assert res["metrics"][name]["value"] == pytest.approx(ran / codeblocks, rel=0.01)


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    """Against a program whose tracer keeps no spans (one without ``take``),
    every span metric reads None and raises nothing."""
    monkeypatch.setattr(tracing, "l1_tracer", object())
    ctx = window.Context({"slots": 8}, object(), [(0, 0)], 8, None, {}, 0)
    spec = small.spec("mu8_ul")
    for name in _program_metrics(spec):
        assert spec_mod.metric_reader(name)(ctx) is None
