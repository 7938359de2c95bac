"""The port's runtime support against the JAX package's: ``support/timers``,
``support/metrics`` and ``support/logger`` on the same call sequences (the
clocks replaced by one fake clock in both, so nothing depends on
wall-clock speed; every value compared exactly), ``support/tracing`` on its
own contract (the port's tracer has the stage spans and the profiler's
clock, which the JAX package's has not), and
``phy/slot_pipeline``'s deadline accounting and depth-limited dispatch on
the port's UpperPhy on the CPU, with deadlines of now + 30 s and now - 1 s
only."""

import io
import json
import time
import types

import numpy as np
import pytest
from torch_parity import plain

from srsran_project_tpu.fapi import messages as j_fapi
from srsran_project_tpu.ops.modulation import Modulation as JModulation
from srsran_project_tpu.phy import pdsch as j_pdsch
from srsran_project_tpu.phy.allocation import Allocation as JAllocation
from srsran_project_tpu.phy.slot_pipeline import SlotPipeline as JSlotPipeline
from srsran_project_tpu.phy.upper_phy import UpperPhy as JUpperPhy
from srsran_project_tpu.phy.upper_phy import UpperPhyConfig as JUpperPhyConfig
from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
from srsran_project_tpu.ran.slot_point import SlotPoint as JSlot
from srsran_project_tpu.support import logger as j_log
from srsran_project_tpu.support import metrics as j_metrics
from srsran_project_tpu.support import timers as j_timers
from srsran_project_tpu_torch.fapi import messages as t_fapi
from srsran_project_tpu_torch.phy import slot_pipeline as t_pipeline_mod
from srsran_project_tpu_torch.phy.slot_pipeline import SlotPipeline as TSlotPipeline
from srsran_project_tpu_torch.phy.upper_phy import UpperPhy as TUpperPhy
from srsran_project_tpu_torch.phy.upper_phy import UpperPhyConfig as TUpperPhyConfig
from srsran_project_tpu_torch.support import logger as t_log
from srsran_project_tpu_torch.support import metrics as t_metrics
from srsran_project_tpu_torch.support import timers as t_timers
from srsran_project_tpu_torch.support import tracing as t_tracing


class FakeClock:
    """time.monotonic / time.time stand-in: each read advances by a fixed
    step of 1.25 ms."""

    def __init__(self, start: float = 100.0, step: float = 1.25e-3):
        self.now, self.step = start, step

    def __call__(self) -> float:
        self.now += self.step
        return self.now


def fake_time(clock) -> types.SimpleNamespace:
    return types.SimpleNamespace(monotonic=clock, time=clock, strftime=time.strftime,
                                 localtime=time.localtime, sleep=lambda s: None)


# ---- timers --------------------------------------------------------------------

def _timer_sequence(m):
    out = []
    mgr = m.TimerManager()
    fired = []
    t = mgr.create_timer()
    t.set(3, lambda: fired.append(("basic", mgr.now)))
    out += [mgr.tick(2), t.is_running, mgr.tick(1), t.is_running]
    t2 = mgr.create_timer()
    t2.set(2, lambda: fired.append(("stopped", mgr.now)))
    t2.stop()
    out += [mgr.tick(5), t2.is_running]
    t3 = mgr.create_timer()
    t3.set(2, lambda: fired.append(("rearmed", mgr.now)))
    mgr.tick(1)
    t3.set(5)
    out += [mgr.tick(3), mgr.tick(2)]
    t4 = mgr.create_timer()
    t4.set(4, lambda: fired.append(("run", mgr.now)))
    mgr.tick(4)
    t4.run()
    out.append(mgr.tick(4))
    ts = [mgr.create_timer() for _ in range(100)]
    for i, tt in enumerate(ts):
        tt.set(1 + (i % 7), lambda i=i: fired.append(("many", i)))
    out += [mgr.nof_running_timers, mgr.tick(7), mgr.nof_expiries, mgr.nof_running_timers]
    periodic = mgr.create_timer()

    def again():
        fired.append(("periodic", mgr.now))
        periodic.run()

    periodic.set(10, again)
    out += [mgr.tick(45), mgr.now, fired]
    with pytest.raises(AssertionError):
        mgr.create_timer().run()
    return out


def test_timers():
    """tests/test_timers.py's sequences, and a self re-arming periodic
    timer (the app's metrics report), in both packages."""
    ref, port = _timer_sequence(j_timers), _timer_sequence(t_timers)
    assert port == ref
    assert [n for kind, n in port[-1] if kind == "periodic"] == [39, 49, 59, 69]


# ---- metrics -------------------------------------------------------------------

def _metrics_sequence(m, monkeypatch):
    """The JAX package's collector: three calls through its timing decorator,
    two recorded durations and one plain timed call, on the fake clock."""
    monkeypatch.setattr(m, "time", fake_time(FakeClock()))
    c = m.MetricsCollector()

    @c.timed("op", units_fn=lambda r: 100.0 * r)
    def op(x):
        return x

    for x in (1, 2, 3):
        op(x)
    c.record("dl_slot_dispatch", 0.5e-3)
    c.record("dl_slot_dispatch", 2.0e-3, units=7)
    c.timed("plain")(lambda: None)()
    out = [c.report(), json.loads(c.report_json()), m.Aggregator().report()]
    c.reset()
    return out + [c.report()]


def _port_metrics_sequence():
    """The same sequence on the port's collector, which has no decorator: its
    callers record what they time, here on the same fake clock."""
    clock = FakeClock()
    c = t_metrics.MetricsCollector()

    def timed(name, units=0.0):
        t0 = clock()
        c.record(name, clock() - t0, units)

    for x in (1, 2, 3):
        timed("op", 100.0 * x)
    c.record("dl_slot_dispatch", 0.5e-3)
    c.record("dl_slot_dispatch", 2.0e-3, units=7)
    timed("plain")
    out = [c.report(), json.loads(c.report_json()), t_metrics.Aggregator().report()]
    c.reset()
    return out + [c.report()]


def test_metrics(monkeypatch):
    """Durations recorded in the port's collector report as the JAX
    package's decorator reports them: count, mean, min, max and rate."""
    ref = _metrics_sequence(j_metrics, monkeypatch)
    port = _port_metrics_sequence()
    assert port == ref
    assert port[0]["op"]["count"] == 3 and port[0]["op"]["rate_per_s"] > 0
    assert not hasattr(t_metrics.MetricsCollector, "timed")


# ---- tracing -------------------------------------------------------------------

def test_tracing(monkeypatch, tmp_path):
    """The port's tracer on a fake ``time_ns`` (1.25 ms a read): nested spans
    kept with their parent, request id and counts (a device-style tensor
    summed only when read), per-name self time, the Chrome JSON in us on
    the same clock; ``take`` and ``write`` drain the kept spans; an off
    tracer hands out one shared null context and keeps nothing."""
    import torch

    ns = iter(range(1_700_000_000_000_000_000, 1_800_000_000_000_000_000, 1_250_000))
    monkeypatch.setattr(t_tracing, "time", types.SimpleNamespace(time_ns=lambda: next(ns)))
    t = t_tracing.EventTracer(enabled=True)
    with t.span("cell.decode_slot") as entry:
        entry.count(slots=2)
        with t.span("pusch.estimate"):
            pass
        with t.span("ldpc.decode") as dec:
            dec.count(iterations=torch.tensor([2, 3, 6], dtype=torch.int32), codeblocks=3)
    with t.span("cell.decode_slot") as entry:
        entry.count(slots=1)
    got = t.take()
    assert [s.name for s in got.spans] == ["pusch.estimate", "ldpc.decode", "cell.decode_slot",
                                           "cell.decode_slot"]
    est, dec, first, second = got.spans
    assert (est.parent, dec.parent, first.parent, second.parent) == (first.id, first.id, 0, 0)
    assert {est.request, dec.request, first.request} == {first.id} and second.request == second.id
    assert [s.end_ns - s.start_ns for s in got.spans] == [1_250_000, 1_250_000, 6_250_000,
                                                          1_250_000]
    assert dec.args == {"iterations": 11, "codeblocks": 3}
    tot = got.totals["cell.decode_slot"]
    assert (tot.spans, tot.total_ns, tot.self_ns, tot.counts) == (2, 7_500_000, 5_000_000,
                                                                  {"slots": 3})
    assert got.totals["ldpc.decode"].counts == {"iterations": 11, "codeblocks": 3}
    assert t.take().spans == []

    with t.span("ofdm.modulate"):
        pass
    t.write(str(tmp_path / "t.json"))
    (ev,) = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert ev["ph"] == "X" and ev["cat"] == "L1" and ev["name"] == "ofdm.modulate"
    assert ev["dur"] == 1250.0
    assert ev["ts"] == (1_700_000_000_000_000_000 + 8 * 1_250_000) / 1e3
    assert ev["args"]["parent"] == 0 and ev["args"]["request"] == ev["args"]["id"]
    t.write(str(tmp_path / "empty.json"))
    assert json.loads((tmp_path / "empty.json").read_text()) == {"traceEvents": []}

    off = t_tracing.EventTracer()
    with off.span("never") as a:
        a.count(slots=1)
    assert off.span("other") is a and off.take().spans == []
    assert not hasattr(t_tracing, "enable_all") and not hasattr(t_tracing, "up_tracer")


# ---- logger --------------------------------------------------------------------

def _log_sequence(m, monkeypatch):
    monkeypatch.setattr(m, "time", fake_time(FakeClock(start=1_700_000_000.0)))
    be = m.Backend()
    js, txt = io.StringIO(), io.StringIO()
    be.add_sink(m.JsonSink(js))
    be.add_sink(m.StreamSink(txt))
    ch = m.LogChannel("PHY", backend=be, level="info", context={"cell": 1})
    ch.info("slot %d: %s", 42, "ok")
    ch.debug("hidden %d", 1)
    ch.warning("crc", rnti=0x4601)
    ch.error("%d", "not-an-int")
    ch.set_level("debug")
    ch.debug("now shown")
    for i in range(50):
        ch.info("m%d", i)
    be.flush()
    with pytest.raises(ValueError):
        ch.set_level("verbose")
    a, b = m.fetch_channel("TEST-PORT-CH"), m.fetch_channel("TEST-PORT-CH")
    small = m.Backend(capacity=1)
    small._ensure_started = lambda: None  # no writer: the queue fills
    lc = m.LogChannel("MAC", backend=small, level="debug")
    for _ in range(3):
        lc.info("x")
    return [[json.loads(line) for line in js.getvalue().splitlines()], txt.getvalue(),
            a is b, small._dropped, m.hex_dump(bytes(range(4))),
            m.hex_dump(bytes(100), max_bytes=8), m.LEVELS]


def test_logger(monkeypatch):
    """tests/test_logger.py's channels, levels, lazy formatting, context,
    order, sinks, registry, hex dump and drop-on-full in both packages."""
    ref = _log_sequence(j_log, monkeypatch)
    port = _log_sequence(t_log, monkeypatch)
    assert port == ref
    msgs = [r["msg"] for r in port[0]]
    assert msgs[:4] == ["slot 42: ok", "crc", "%d ('not-an-int',)", "now shown"]
    assert port[3] == 2


# ---- slot pipeline --------------------------------------------------------------

def _dl_request(m, n: int, tb):
    alloc = m.Allocation(rb_start=0, rb_count=6, sym_start=1, sym_count=12, dmrs_symbols=(2,))
    cfg = m.pdsch.PdschConfig(tbs=304, target_code_rate=0.3, modulation=m.Modulation.QPSK,
                              alloc=alloc, nof_layers=1, nof_ports=1, nof_grid_symbols=14,
                              nof_grid_sc=624)
    slot = m.Slot.from_sfn_slot(m.Scs.KHZ30, 0, n % 20)
    return (m.fapi.DlTtiRequest(slot=slot, pdsch=[
        m.fapi.DlPdschPdu(cfg, 0x11, np.eye(1, dtype=np.complex64), 0)]),
        m.fapi.TxDataRequest(slot=slot, payloads=[tb]))


def _pipeline_run(m, pipe):
    rng = np.random.default_rng(0)
    now = time.monotonic()
    out = []
    for i in range(5):
        pipe.push_dl_slot(*_dl_request(m, i, rng.integers(0, 2, size=(304,), dtype=np.uint8)),
                          deadline_s=now + 30.0)
        out.append(len(pipe._inflight))
    grids = pipe.flush()
    out += [len(grids), pipe.report(), pipe.flush()]
    pipe.push_dl_slot(*_dl_request(m, 5, rng.integers(0, 2, size=(304,), dtype=np.uint8)),
                      deadline_s=now - 1.0)
    out += [len(pipe.flush()), {k: v for k, v in pipe.report().items() if k != "mean_lateness_us"},
            pipe.report()["mean_lateness_us"] >= 1e6, len(pipe.errors),
            pipe.errors[0].error_code, pipe.errors[0].slot.count,
            pipe.errors[0].message.startswith("slot late by ")]
    return out, grids


def test_slot_pipeline_deadlines():
    """tests/test_runtime.py's deadline case on both packages: five DL
    slots at depth 2 with a deadline 30 s ahead are materialized on time
    (each push first drains to depth - 1 in flight), the grids come back in
    dispatch order and equal to UpperPhy's own; one slot whose deadline
    passed a second ago is late and raises an error indication."""
    m = types.SimpleNamespace(fapi=j_fapi, pdsch=j_pdsch, Allocation=JAllocation,
                              Modulation=JModulation, Slot=JSlot, Scs=JScs)
    ref, _ = _pipeline_run(m, JSlotPipeline(JUpperPhy(JUpperPhyConfig(nof_ports=1)), depth=2))
    from srsran_project_tpu_torch.ops.modulation import Modulation as TModulation
    from srsran_project_tpu_torch.phy import pdsch as t_pdsch
    from srsran_project_tpu_torch.phy.allocation import Allocation as TAllocation
    from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing as TScs
    from srsran_project_tpu_torch.ran.slot_point import SlotPoint as TSlot

    m = types.SimpleNamespace(fapi=t_fapi, pdsch=t_pdsch, Allocation=TAllocation,
                              Modulation=TModulation, Slot=TSlot, Scs=TScs)
    phy = TUpperPhy(TUpperPhyConfig(nof_ports=1, device="cpu"))
    port, grids = _pipeline_run(m, TSlotPipeline(phy, depth=2))
    assert plain(port) == plain(ref)
    assert port[:5] == [1, 2, 2, 2, 2] and port[6]["late"] == 0 and port[9]["late"] == 1
    rng = np.random.default_rng(0)
    for i, grid in enumerate(grids):
        want = phy.process_dl_tti(*_dl_request(m, i, rng.integers(0, 2, size=(304,),
                                                                  dtype=np.uint8)))
        assert grid.dtype == want.dtype and bool((grid == want).all())


def test_slot_pipeline_uplink_and_metrics(monkeypatch):
    """A UL slot is stamped complete at dispatch: drained after its
    deadline has passed, it is not late; DL and UL dispatch times go to
    the metrics collector, and spans to the L1 tracer when it is on."""
    from srsran_project_tpu_torch.ops.modulation import Modulation as TModulation
    from srsran_project_tpu_torch.phy import pdsch as t_pdsch
    from srsran_project_tpu_torch.phy.allocation import Allocation as TAllocation
    from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing as TScs
    from srsran_project_tpu_torch.ran.slot_point import SlotPoint as TSlot
    import torch

    m = types.SimpleNamespace(fapi=t_fapi, pdsch=t_pdsch, Allocation=TAllocation,
                              Modulation=TModulation, Slot=TSlot, Scs=TScs)
    collector = t_metrics.MetricsCollector()
    tracer = t_tracing.EventTracer(enabled=True)
    monkeypatch.setattr(t_pipeline_mod, "collector", collector)
    monkeypatch.setattr(t_pipeline_mod, "l1_tracer", tracer)
    phy = TUpperPhy(TUpperPhyConfig(nof_ports=1, device="cpu"))
    pipe = TSlotPipeline(phy, depth=4)
    now = time.monotonic()
    dl, tx = _dl_request(m, 0, np.zeros(304, np.uint8))
    pipe.push_dl_slot(dl, tx, deadline_s=now + 30.0)
    ul = t_fapi.UlTtiRequest(slot=dl.slot)
    clock = {"now": now + 0.5}
    monkeypatch.setattr(t_pipeline_mod, "time", fake_time(lambda: clock["now"]))
    pipe.push_ul_slot(ul, torch.zeros((1, 14, 624), dtype=torch.complex64),
                      deadline_s=now + 1.0)
    clock["now"] = now + 2.0  # drained after the UL deadline
    out = pipe.flush()
    assert isinstance(out[0], torch.Tensor) and isinstance(out[1], t_fapi.SlotResults)
    assert pipe.report() == {"slots": 2, "late": 0, "late_ratio": 0.0, "mean_lateness_us": 0.0}
    rep = collector.report()
    assert rep["dl_slot_dispatch"]["count"] == rep["ul_slot_dispatch"]["count"] == 1
    assert [s.name for s in tracer.take().spans] == ["dl_slot_0", "ul_slot_0"]
