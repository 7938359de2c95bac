"""One run of a cell: set-up, warm-up, the measured window, the traced
stretch, and the comparison of the program's answers with the reference.

The window is a closed loop over a seeded order of the pool's units: each
call is made (the ``dispatch`` span, from the call until it returns) and
its answer read back (``readback``: the CRC verdicts on the host, or a
synchronize) before the next is generated (``generator``).  Calls start
until ``seconds`` have passed; every slot of every call counts, over the
time from the first call's start to the last answer.

The comparison takes a seeded sample of ``check_units`` pool units, keeps
the answers the window gave for them (the last of each), and, once the
window has closed and the device's peak memory has been read, runs the
reference on the same inputs.  A sampled unit that the window did not
reach is run after it.  Every compared number has its limit in
``portbench/limits/<workload>.json``; ``correct`` is true when none is
over its limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import statistics
import time

import numpy as np
import torch

from portbench.harness import cells, spec as spec_mod, trace as trace_mod
from portbench.reference import link


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads.

    ``window``: the measured window's record (``measure``): ``calls``,
    ``slots``, ``elapsed_s``, ``latency_s`` (each call's, submission to
    answer), ``dispatch_s`` (the host's time inside the program's calls),
    ``slots_by_second``.  ``trace``: the traced stretch's device trace, or
    None in an untraced run.  ``traced``: the (unit, step) of each call of
    the traced stretch, ``traced_slots`` their slots.  ``entry``: the
    generator's entry (its grants, its ``decoded_tbs`` and
    ``ldpc_kernel``).  ``reference``: the reference's results of the
    sampled units, which the traced stretch replays.  ``peak_bytes``: the
    device's peak memory over set-up and the window."""

    window: dict
    trace: trace_mod.Trace | None
    traced: list
    traced_slots: int
    entry: object
    reference: dict
    peak_bytes: int


def _span(tracing: bool, name: str):
    if tracing:
        return torch.profiler.record_function(trace_mod.SPAN_PREFIX + name)
    return contextlib.nullcontext()


class Driver:
    """Drives an entry's calls and keeps the answers of the sampled units."""

    def __init__(self, entry, sampled: set):
        self.entry = entry
        self.sampled = sampled
        self.kept: dict = {}
        self.prev = None

    def call(self, unit: int, step: int, tracing: bool = False):
        e = self.entry
        t_gen = time.perf_counter()
        with _span(tracing, "generator"):
            args = e.generate(unit, step, self.prev)
        t_sub = time.perf_counter()
        with _span(tracing, "dispatch"):
            out = e.dispatch(args)
        t_ret = time.perf_counter()
        with _span(tracing, "readback"):
            e.readback(out)
        t_done = time.perf_counter()
        self.prev = out
        if unit in self.sampled:
            self.kept.setdefault(unit, [None] * e.calls_per_unit)[step] = out
        return t_gen, t_sub, t_ret, t_done

    def unit(self, unit: int, tracing: bool = False) -> None:
        for step in range(self.entry.calls_per_unit):
            self.call(unit, step, tracing)


def measure(driver: Driver, order: list, seconds: float) -> dict:
    """The measured window: calls over ``order`` (cycled; a unit's calls in
    sequence) until ``seconds`` have passed."""
    e = driver.entry
    lat, done, dispatch, calls = [], [], 0.0, 0
    t0 = time.perf_counter()
    t_last = t0
    while t_last - t0 < seconds:
        unit = order[(calls // e.calls_per_unit) % len(order)]
        _, t_sub, t_ret, t_last = driver.call(unit, calls % e.calls_per_unit)
        lat.append(t_last - t_sub)
        done.append(t_last - t0)
        dispatch += t_ret - t_sub
        calls += 1
    per_second = [0] * (int(t_last - t0) + 1)
    for t in done:
        per_second[int(t)] += e.slots_per_call
    return {"t0": t0, "calls": calls, "slots": calls * e.slots_per_call,
            "elapsed_s": t_last - t0, "latency_s": lat, "dispatch_s": dispatch,
            "slots_by_second": per_second}


def p95(values: list) -> float:
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def end_to_end(name: str, w: dict, setup_s: float):
    """The value of an end-to-end metric from the window."""
    if name == "setup_s":
        return setup_s
    if name in ("ul_slots_per_s", "dl_slots_per_s"):
        return w["slots"] / w["elapsed_s"]
    if name == "ul_slot_p95_ms":
        return 1e3 * p95(w["latency_s"])
    raise KeyError(f"no end-to-end metric {name!r}")


def check(entry, driver: Driver, sampled: list, limits: dict, got: dict | None = None):
    """(numbers compared, the reference's results) for the sampled units:
    the program's answers (or ``got``, e.g. the control's) against the
    reference in float32."""
    if got is None:
        for u in sampled:
            if u not in driver.kept or None in driver.kept[u]:
                driver.unit(u)  # a unit the window did not reach is run now
        got = {u: driver.kept[u] for u in sampled}
    want = entry.expected(sampled, link.FLOAT32)
    numbers = entry.compare(got, want)
    missing = set(limits) ^ set(numbers)
    if missing:
        raise KeyError(f"numbers and limits differ: {sorted(missing)}")
    return numbers, want


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)


def build(spec: spec_mod.Spec, seed: int, dev: torch.device):
    """The cell's entry with its pool made from the seed, the window's
    order of units and the sampled units."""
    t = spec.traffic
    entry = cells.entry(spec.config, t, seed, dev)
    rng = np.random.default_rng(seed)
    order = [int(u) for u in rng.permutation(entry.units)]
    sampled = sorted(int(u) for u in rng.choice(entry.units, int(t["check_units"]),
                                                 replace=False))
    return entry, order, sampled


def warm_up(driver: Driver, order: list, calls: int) -> None:
    """``calls`` calls, and at least one unit's every call, over the order."""
    e = driver.entry
    n = max(calls, e.calls_per_unit)
    for i in range(n):
        driver.call(order[(i // e.calls_per_unit) % len(order)], i % e.calls_per_unit)
    cells.sync(e.dev)


def run(spec: spec_mod.Spec, seed: int, seconds: float, traced: bool, dev: torch.device,
        t_start: float) -> dict:
    """One run; returns the result's fields and the compared numbers."""
    t_build = time.perf_counter()
    entry, order, sampled = build(spec, seed, dev)
    driver = Driver(entry, set(sampled))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_warm = time.perf_counter()
    warm_up(driver, order, int(spec.traffic["warmup_calls"]))
    gc.collect()
    setup_s = time.perf_counter() - t_start
    phases = {"start": t_build - t_start, "inputs": t_warm - t_build,
              "warm_up": t_start + setup_s - t_warm}
    w = measure(driver, order, seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    tr, traced_calls = None, []
    if traced:
        rounds = int(spec.traffic["trace_rounds"])
        traced_calls = [(u, s) for _ in range(rounds) for u in sampled
                        for s in range(entry.calls_per_unit)]

        def stretch():
            for u, s in traced_calls:
                driver.call(u, s, tracing=True)
            cells.sync(dev)

        cells.sync(dev)
        tr = trace_mod.profile(stretch)

    numbers, want = check(entry, driver, sampled, spec.limits)
    if traced:
        ctx = Context(w, tr, traced_calls, len(traced_calls) * entry.slots_per_call, entry, want,
                      int(peak))
        metrics = {}
        for m in spec.per_layer:
            value = spec_mod.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": end_to_end(m["name"], w, setup_s), "unit": m["unit"]}
                   for m in spec.end_to_end}
    correct = verdict(numbers, spec.limits)
    checked = len(sampled) * entry.calls_per_unit * entry.slots_per_call
    return {"numbers": numbers, "metrics": metrics, "window": w, "peak": peak, "trace": tr,
            "setup_s": setup_s, "phases": phases, "correct": correct, "failed": 0 if correct else checked}
