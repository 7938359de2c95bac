"""The port's stage spans on tiny cells on the CPU: which spans the slot
entries record and how they nest, the LDPC iteration counts they carry,
their clock against torch.profiler's (in the app's Chrome JSON too), and
that a span that is off keeps nothing and opens no profiler range."""

import collections
import dataclasses
import inspect

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from srsran_project_tpu_torch.models import cell
from srsran_project_tpu_torch.ops.ldpc import decoder
from srsran_project_tpu_torch.ops.modulation import Modulation
from srsran_project_tpu_torch.phy import pusch, sch, ul_slot
from srsran_project_tpu_torch.support import tracing

UL_STAGES = ["pusch.estimate", "pusch.equalize", "pusch.demap", "ldpc.decode", "sch.desegment"]
# Per entry: the spans one call records (two config groups of one code
# group each in ``process_slot``).
SPANS = {
    "decode_slot": ["cell.decode_slot", "ofdm.demodulate"] + UL_STAGES,
    "process_slot": ["ul_slot.process_slot"] + 2 * (UL_STAGES + ["sch.dematch", "ul_slot.group"]),
    "encode_slot": ["cell.encode_slot", "pdsch.bit_chain", "pdsch.grid", "ofdm.modulate"],
}


@pytest.fixture
def tracer(monkeypatch):
    """The L1 tracer off and empty, its state restored afterwards."""
    tr = tracing.l1_tracer
    monkeypatch.setattr(tr, "_kept", [])
    monkeypatch.setattr(tr, "enabled", False)
    return tr


def _ul_configs():
    """Two grants' compact configs of 6 PRBs, QPSK and 16QAM."""
    return [cell.CellConfig(nof_rb=6, nof_ports=1, nof_layers=1, modulation=m,
                            target_code_rate=r, f_center_hz=0.0).pusch_cfg
            for m, r in ((Modulation.QPSK, 0.3), (Modulation.QAM16, 0.5))]


def _calls() -> dict:
    """entry -> a call of it on a tiny cell; the multi-UE slot's second
    grant retransmits with the HARQ buffer of a first call."""
    gen = torch.Generator().manual_seed(7)
    cfg = cell.tiny_cell()
    tb = torch.randint(0, 2, (2, cfg.tbs), generator=gen, dtype=torch.uint8)
    rnti = torch.tensor([0x4601, 77])
    prec = torch.eye(1, dtype=torch.complex64)
    iq = cell.encode_slot(tb, rnti, prec, cfg)
    cfgs, rntis, first_rbs = _ul_configs(), (17, 23), (0, 6)
    grids = []
    for c, r, rb0 in zip(cfgs, rntis, first_rbs):
        at = dataclasses.replace(c, alloc=dataclasses.replace(c.alloc, crb_start=rb0))
        bits = torch.randint(0, 2, (c.tbs,), generator=gen, dtype=torch.uint8)
        grids.append(pusch.transmit(bits, torch.tensor(r), at))
    grid = torch.cat(grids, dim=-1)
    pdus = [ul_slot.UlSlotPdu(r, rb0, c) for c, r, rb0 in zip(cfgs, rntis, first_rbs)]
    pdus[1].harq_buffer = ul_slot.process_slot(grid, pdus)[0][1]["harq_buffer"]
    return {"decode_slot": lambda: cell.decode_slot(iq, rnti, cfg),
            "process_slot": lambda: ul_slot.process_slot(grid, pdus),
            "encode_slot": lambda: cell.encode_slot(tb, rnti, prec, cfg)}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


@pytest.mark.parametrize("entry", sorted(SPANS))
def test_an_entry_records_its_stage_spans_under_the_profiler(tracer, entry):
    """Under torch.profiler the tracer keeps exactly the entry's spans: the
    entry outermost, each stage a child of it, one request id a call."""
    call = _calls()[entry]
    _profiled(lambda: [call(), call()])
    spans = tracer.take().spans
    names = sorted(s.name for s in spans)
    assert names == sorted(2 * SPANS[entry])
    outer = [s for s in spans if s.parent == 0]
    assert [s.name for s in outer] == 2 * SPANS[entry][:1]
    for s in spans:
        if s.parent:
            assert s.parent == s.request and s.request in {o.id for o in outer}
            o = next(o for o in outer if o.id == s.request)
            assert o.start_ns <= s.start_ns <= s.end_ns <= o.end_ns
    assert all(o.request == o.id for o in outer)
    assert all(o.args == {"slots": 2 if entry != "process_slot" else 1} for o in outer)
    assert tracer.take().spans == []


def _recording(monkeypatch, module, name: str, seen: list):
    """Wraps ``module.name`` to record each call's arguments, bound by name,
    and its iteration counts."""
    fn = getattr(module, name)
    sig = inspect.signature(fn)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        seen.append((bound.arguments, out[-1]))
        return out

    monkeypatch.setattr(module, name, wrapped)


def _plain_iterations(entry: str, args: dict) -> torch.Tensor:
    """The plain decoders' iteration counts on one call's inputs."""
    if entry == "process_slot":
        return decoder.decode_plain(args["llrs"], args["bg"], args["z"], args["nof_iterations"],
                                    args["early_stop"], args["bits_only"], args["n_cb"])[2]
    views = decoder.group_views(args["llrs"], args["groups"], args["qm"])
    return torch.cat([decoder.decode_dematch_plain(
        v, args["bg"], args["z"], args["k_prime"], e, args["rv"], args["qm"], args["n_cb"],
        args["nof_iterations"], args["early_stop"])[1]
        for v, (_count, e) in zip(views, args["groups"])])


@pytest.mark.parametrize("entry", ["decode_slot", "process_slot"])
def test_the_ldpc_span_counts_the_decoders_iterations(tracer, monkeypatch, entry):
    """``ldpc.decode``'s ``iterations`` and ``codeblocks``, summed when read,
    are the decoder's own (C,) counts: their sum equals what the plain
    decoder returns on the same inputs, codeblock for codeblock."""
    seen: list = []
    if entry == "decode_slot":
        _recording(monkeypatch, sch, "decode_dematch_groups", seen)
    else:
        _recording(monkeypatch, ul_slot, "decode", seen)
    call = _calls()[entry]
    seen.clear()
    tracer.enabled = True
    call()
    counts = tracer.take().totals["ldpc.decode"].counts
    plain = [_plain_iterations(entry, args) for args, _ in seen]
    assert all(torch.equal(p, it) for p, (_, it) in zip(plain, seen))
    assert counts == {"iterations": int(sum(int(p.sum()) for p in plain)),
                      "codeblocks": sum(p.numel() for p in plain)}
    assert counts["iterations"] >= counts["codeblocks"] > 0


@pytest.mark.parametrize("entry", ["decode_slot", "process_slot"])
def test_the_estimate_span_counts_its_grants(tracer, entry):
    """``pusch.estimate`` counts the grants of each call (two slots of the
    tiny cell; two config groups of one grant each) and those kernel K7
    estimated: none on the CPU."""
    call = _calls()[entry]
    tracer.enabled = True
    call()
    counts = tracer.take().totals["pusch.estimate"].counts
    assert counts == {"grants": 2, "kernel_grants": 0}


@pytest.mark.parametrize("entry", ["decode_slot", "process_slot"])
def test_the_equalize_span_counts_its_res(tracer, entry):
    """``pusch.equalize`` counts the data REs it equalized, ``res`` (two
    slots of the tiny cell; two config groups of one grant each), and
    those kernel K8 equalized, ``kernel_res``: none on the CPU."""
    cfgs = [cell.tiny_cell().pusch_cfg] * 2 if entry == "decode_slot" else _ul_configs()
    call = _calls()[entry]
    tracer.enabled = True
    call()
    counts = tracer.take().totals["pusch.equalize"].counts
    assert counts == {"res": sum(c.g_total // (c.sch.qm * c.nof_layers) for c in cfgs),
                      "kernel_res": 0}


def test_spans_lie_on_the_profilers_clock(tracer):
    """Each kept span starts and ends within 50 us of the profiler's event
    of the same span (the range the span opened)."""
    calls = _calls()
    prof = _profiled(lambda: [calls[e]() for e in sorted(SPANS)])
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if "CPU" in str(e.device_type()):
            events[e.name()].append((e.start_ns(), e.end_ns()))
    spans = collections.defaultdict(list)
    for s in tracer.take().spans:
        spans[s.name].append((s.start_ns, s.end_ns))
    assert set(spans) == {n for names in SPANS.values() for n in names}
    for name, kept in spans.items():
        assert len(events[name]) == len(kept), name
        for (s0, s1), (p0, p1) in zip(sorted(kept), sorted(events[name])):
            assert abs(s0 - p0) <= 50_000 and abs(s1 - p1) <= 50_000, (name, s0 - p0, s1 - p1)


@pytest.mark.parametrize("enabled", [False, True])
def test_no_record_function_without_a_profiler(tracer, monkeypatch, enabled):
    """With no profiler running no span opens a profiler range; an off
    tracer keeps nothing, an enabled one every span."""
    calls = _calls()

    def refused(name):
        raise AssertionError(f"a profiler range {name!r} opened with no profiler")

    monkeypatch.setattr(tracing, "_range", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    tracer.enabled = enabled
    for e in sorted(SPANS):
        calls[e]()
    names = sorted(s.name for s in tracer.take().spans)
    assert names == (sorted(n for e in SPANS for n in SPANS[e]) if enabled else [])


def test_the_apps_trace_merges_with_a_profiler_export(tracer, tmp_path):
    """``du_low_sim --trace``'s Chrome JSON beside torch.profiler's export of
    the same run, its times moved by the export's ``baseTimeNanoseconds``:
    each slot span holds the operators its slot ran, and each stage span
    lies within 50 us of the profiler's event of that stage."""
    import json

    from srsran_project_tpu_torch.apps import du_low_sim

    argv = ["--cpu", "--set", "cell.nof_rb=24", "--set", "cell.nof_ports=1", "--set",
            "cell.nof_layers=1", "--channel", "single", "--snr-db", "30", "--slots", "2",
            "--trace", str(tmp_path / "spans.json")]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert du_low_sim.main(argv) == 0
    prof.export_chrome_trace(str(tmp_path / "profile.json"))
    exported = json.loads((tmp_path / "profile.json").read_text())
    base_us = exported["baseTimeNanoseconds"] / 1e3
    ops = [(base_us + e["ts"], e["dur"], e["name"]) for e in exported["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    spans = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    slots = [s for s in spans if s["args"]["parent"] == 0]
    assert [s["name"] for s in slots] == ["dl_slot_0", "ul_slot_0", "dl_slot_1", "ul_slot_1"]
    for s in spans:
        mirror = [o for o in ops if o[2] == s["name"]]
        if s["args"]["parent"]:
            assert min(abs(o[0] - s["ts"]) + abs(o[0] + o[1] - s["ts"] - s["dur"])
                       for o in mirror) <= 50.0, s["name"]
        else:
            inside = {o[2] for o in ops if s["ts"] <= o[0] and o[0] + o[1] <= s["ts"] + s["dur"]}
            stages = {c["name"] for c in spans if c["args"]["parent"] == s["args"]["id"]}
            assert stages and stages <= inside and any(n.startswith("aten::") for n in inside)


@pytest.fixture(scope="module")
def ul_tti():
    """One whole FAPI uplink slot (``portbench/tests/small_ul_tti.py``: 2
    PUSCH UEs, 4 F1 UEs on one resource, 2 F2, a PRACH occasion) and a
    call of ``UpperPhy.process_ul_tti`` on it."""
    from portbench.harness import cells
    from portbench.tests import small_ul_tti

    spec = small_ul_tti.spec()
    entry = cells.entry(spec.config, spec.traffic, 19, torch.device("cpu"))
    return entry, lambda: entry.dispatch(entry.generate(0, 0, None))


# The FAPI entry's spans and their parents; ``ul_slot.process_slot``'s own
# (two config groups, one code group each) nest in it unchanged.  Every
# channel's device work runs before ``upper_phy.indications``, which only
# reads: compute, then read.
UL_TTI_PARENTS = {"upper_phy.process_ul_tti": None,
                  "ul_slot.process_slot": "upper_phy.process_ul_tti",
                  "pucch.f1": "upper_phy.process_ul_tti", "pucch.f2": "upper_phy.process_ul_tti",
                  "upper_phy.indications": "upper_phy.process_ul_tti",
                  "prach.detect": "upper_phy.process_ul_tti"}


def test_the_fapi_entry_records_its_spans_and_counts(tracer, ul_tti, tmp_path):
    import json

    entry, call = ul_tti
    _profiled(call).export_chrome_trace(str(tmp_path / "profile.json"))
    reading = tracer.take()
    by_id = {s.id: s for s in reading.spans}
    names = collections.Counter(s.name for s in reading.spans)
    assert names == collections.Counter(
        dict.fromkeys(UL_TTI_PARENTS, 1),
        **{n: 2 for n in SPANS["process_slot"][1:]})
    for s in reading.spans:
        if s.name in UL_TTI_PARENTS:
            parent = by_id[s.parent].name if s.parent else None
            assert parent == UL_TTI_PARENTS[s.name], s.name
        else:  # the slot program's stages
            assert by_id[s.parent].name == "ul_slot.process_slot", s.name
    t = reading.totals
    assert t["upper_phy.process_ul_tti"].counts == {"slots": 1, "pusch": 2, "pucch": 6,
                                                   "prach": 1}
    assert t["pucch.f1"].counts == {"occasions": 4, "resources": 1}
    assert t["pucch.f2"].counts == {"occasions": 2, "polar": 1, "short_block": 1,
                                    "kernel_occasions": 0}
    assert t["pusch.estimate"].counts == {"grants": 2, "kernel_grants": 0}
    assert t["prach.detect"].counts == {"roots": 8, "detected": 2}
    # Per PUSCH PDU its CRC verdict, SINR and (passed) TB; per F1 occasion
    # its bits and rho, per F2 its bits, CRC verdict and SNR; the PRACH's
    # three vectors.
    assert t["upper_phy.indications"].counts == {"host_syncs": 3 * 2 + 2 * 4 + 3 * 2 + 3}
    # Compute, then read: the operators inside the indications are the host
    # reads' alone (``upper_phy._host``: a detach and a copy to numpy).
    exported = json.loads((tmp_path / "profile.json").read_text())
    base_us = exported["baseTimeNanoseconds"] / 1e3
    ind = next(s for s in reading.spans if s.name == "upper_phy.indications")
    inside = {e["name"] for e in exported["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "cpu_op"
              and ind.start_ns / 1e3 <= base_us + e["ts"] <= ind.end_ns / 1e3}
    assert inside <= {"detach", "aten::detach", "aten::to", "aten::resolve_conj",
                      "aten::resolve_neg"}, inside


def test_the_fapi_entry_is_off_without_a_profiler(tracer, monkeypatch, ul_tti):
    """With the tracer off and no profiler, no span of the FAPI entry is
    made: every ``span`` call hands out the shared off context, which
    formats, launches and syncs nothing."""
    _entry, call = ul_tti

    def refused(*args, **kwargs):
        raise AssertionError("a span was made with the tracer off")

    monkeypatch.setattr(tracing, "_On", refused)
    monkeypatch.setattr(tracing, "_range", refused)
    call()
    assert tracer.take().spans == []
    assert tracing.l1_tracer.span("upper_phy.process_ul_tti") is tracing._OFF


@pytest.fixture(scope="module")
def dl_tti():
    """One whole FAPI downlink slot (``portbench/tests/small_dl_tti.py``: 2
    PDSCH UEs of one config under a TRS, 2 DCIs in the DL_TTI.request and 2
    in the UL_DCI.request, an SSB, the TRS's 2 CSI-RS resources) and a call
    of ``UpperPhy.process_dl_tti`` and ``process_ul_dci`` on it."""
    from portbench.harness import cells
    from portbench.tests import small_dl_tti

    spec = small_dl_tti.spec()
    entry = cells.entry(spec.config, spec.traffic, 23, torch.device("cpu"))
    return entry, lambda: entry.dispatch(entry.generate(0, 0, None))


# The downlink FAPI entries' spans: name -> (parent, spans a call).
DL_TTI_SPANS = {"upper_phy.process_dl_tti": (None, 1), "upper_phy.process_ul_dci": (None, 1),
                "pdsch.bit_chain": ("upper_phy.process_dl_tti", 1),
                "pdsch.grid": ("upper_phy.process_dl_tti", 1),
                "ssb.assemble": ("upper_phy.process_dl_tti", 1),
                "csi_rs.generate": ("upper_phy.process_dl_tti", 2)}


def test_the_downlink_fapi_entry_records_its_spans_and_counts(tracer, dl_tti):
    entry, call = dl_tti
    _profiled(call)
    reading = tracer.take()
    by_id = {s.id: s for s in reading.spans}
    names = collections.Counter(s.name for s in reading.spans)
    assert names == collections.Counter({n: k for n, (_, k) in DL_TTI_SPANS.items()},
                                        **{"pdcch.encode": 4})
    parents = collections.Counter()
    for s in reading.spans:
        parent = by_id[s.parent].name if s.parent else None
        if s.name == "pdcch.encode":
            parents[parent] += 1
        else:
            assert parent == DL_TTI_SPANS[s.name][0], s.name
    # The DCI 1_1s inside the DL_TTI.request, the DCI 0_1s inside the UL_DCI.request.
    assert parents == {"upper_phy.process_dl_tti": 2, "upper_phy.process_ul_dci": 2}
    t = reading.totals
    assert t["upper_phy.process_dl_tti"].counts == {"slots": 1, "pdsch": 2, "pdcch": 2, "ssb": 1,
                                                   "csi_rs": 2, "pdsch_batches": 1}
    assert t["upper_phy.process_ul_dci"].counts == {"pdcch": 2}
    assert t["pdcch.encode"].counts == {"pdus": 4}
    assert t["ssb.assemble"].counts == {"ssbs": 1}
    assert t["csi_rs.generate"].counts == {"resources": 2, "ports": 2}
    # Two grants of 12 PRB, each with 3 REs of 2 TRS symbols a PRB left empty.
    assert t["pdsch.grid"].counts == {"reserved_res": 2 * 12 * 3 * 2}
    assert sum(x.self_ns for x in t.values()) == (t["upper_phy.process_dl_tti"].total_ns
                                                  + t["upper_phy.process_ul_dci"].total_ns)


def test_a_grant_without_reserved_res_counts_none(tracer):
    """``encode_slot``'s grant has no reserved REs: ``pdsch.grid`` counts 0."""
    _profiled(_calls()["encode_slot"])
    assert tracer.take().totals["pdsch.grid"].counts == {"reserved_res": 0}


def test_the_downlink_fapi_entry_is_off_without_a_profiler(tracer, monkeypatch, dl_tti):
    """With the tracer off and no profiler, no span of the downlink FAPI
    entries is made."""
    _entry, call = dl_tti

    def refused(*args, **kwargs):
        raise AssertionError("a span was made with the tracer off")

    monkeypatch.setattr(tracing, "_On", refused)
    monkeypatch.setattr(tracing, "_range", refused)
    call()
    assert tracer.take().spans == []
