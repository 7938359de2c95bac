"""The ``fapi_ul_tti`` cell on the CPU at the small sizes
(``small_ul_tti.py``): its files found by name and every key read, a sound
traced run correct with the new per-layer metrics read, the spans' self
times adding up to the entry's time, each fault of the timed path refused,
the bfloat16 control refused, and the reference's PUCCH, UCI and PRACH
held against the port's reference-parity helpers and the repository's
golden vectors of the UCI decoder."""

import copy
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.harness import cells, spec as spec_mod, window
from portbench.reference import link
from portbench.reference import prach as ref_prach
from portbench.reference import uci as ref_uci
from portbench.tests import small_ul_tti
from srsran_project_tpu_torch.phy import prach, pucch, pucch_f2
from srsran_project_tpu_torch.support import tracing

CPU = torch.device("cpu")
NEW_METRICS = ("ul_pucch_ms_per_slot", "ul_prach_ms_per_slot", "ul_fapi_ms_per_slot")


def _run(traced: bool = False, spec=None) -> dict:
    return window.run(spec or small_ul_tti.spec(), 2147483647 + 31, 0.05, traced, CPU, 0.0)


def test_the_cell_loads_and_its_numbers_are_its_limits():
    spec = spec_mod.load("fapi_ul_tti")
    gen = cells.generator(spec.traffic["generator"])
    cells.check_files(spec.config, spec.traffic, gen)
    assert spec.chips == 1 and spec.config["reduced"] == []
    assert {m["name"] for m in spec.end_to_end} == {"ul_slots_per_s", "ul_slot_p95_ms", "setup_s"}
    for name in NEW_METRICS:
        assert name in {m["name"] for m in spec.per_layer}
    small = small_ul_tti.spec()
    entry, _order, sampled = window.build(small, 3, CPU)
    numbers, _ = window.check(entry, window.Driver(entry, set(sampled)), sampled, small.limits)
    assert set(numbers) == set(spec.limits)


@pytest.mark.parametrize("where,key,value", [
    ("pucch_f1", "group_hopping", "enable"), ("pucch_f2", "second_hop_rb_start", 40),
    ("prach", "restricted_set", "type_a")])
def test_a_key_no_code_reads_is_refused(where, key, value):
    spec = small_ul_tti.spec()
    cfg = copy.deepcopy(spec.config)
    cfg[where][key] = value
    with pytest.raises(ValueError, match="read by no code"):
        cells.entry(cfg, spec.traffic, 3, CPU)


def test_a_plan_that_overlaps_itself_is_refused():
    spec = small_ul_tti.spec()
    cfg = copy.deepcopy(spec.config)
    cfg["prach"]["first_rb"] = 10  # onto the PUSCH from PRB 16
    with pytest.raises(ValueError, match="overlaps"):
        cells.entry(cfg, spec.traffic, 3, CPU)


def test_a_sound_traced_run_is_correct_and_reads_the_new_metrics():
    tracing.l1_tracer.take()
    res = _run(traced=True)
    assert res["correct"], res["numbers"]
    for m in small_ul_tti.spec().per_layer:
        if m["source"] in ("program_span", "program_counter"):
            value = res["metrics"][m["name"]]["value"]
            assert isinstance(value, float) and value > 0, m["name"]


def test_the_spans_self_times_add_up_to_the_entrys_time():
    """Every span of a FAPI slot nests in ``upper_phy.process_ul_tti``, so
    their self times sum to the entry's time: no span is counted twice and
    no stretch lost (the invariant the per-layer metrics' split rests on)."""
    spec = small_ul_tti.spec()
    entry = cells.entry(spec.config, spec.traffic, 2147483647 + 37, CPU)
    tracing.l1_tracer.take()
    tracing.l1_tracer.enabled = True
    try:
        for unit in range(entry.units):
            entry.dispatch(entry.generate(unit, 0, None))
    finally:
        tracing.l1_tracer.enabled = False
    t = tracing.l1_tracer.take().totals
    assert t["upper_phy.process_ul_tti"].spans == entry.units
    assert {"ul_slot.process_slot", "pucch.f1", "pucch.f2", "prach.detect",
            "upper_phy.indications"} <= set(t)
    assert sum(x.self_ns for x in t.values()) == t["upper_phy.process_ul_tti"].total_ns


def _flip_f2_bit(fn):
    def broken(grid, cfg):
        bits, ok, snr = fn(grid, cfg)
        bits = bits.clone()
        bits[0] ^= 1
        return bits, ok, snr
    return broken


def _flip_dtx_verdict(fn):
    """The silent occasion of the resource read as detected."""
    def broken(grid, cfgs):
        out = fn(grid, cfgs)
        if out:
            out[-1] = (out[-1][0], torch.ones_like(out[-1][1]))
        return out
    return broken


def _drop_preamble(fn):
    def broken(rx_fd, cfg):
        out = dict(fn(rx_fd, cfg))
        det = out["detected"].clone()
        det[int(torch.nonzero(det)[0])] = False
        out["detected"] = det
        return out
    return broken


def _detected_alone(_fn):
    """Every F1 occasion through ``format1_detect``, the multiplexed ones
    too (the routing taken away)."""
    def broken(grid, cfgs):
        return [pucch.format1_detect(grid, c)[::2] for c in cfgs]
    return broken


@pytest.mark.parametrize("module,name,fault", [
    (pucch_f2, "process", _flip_f2_bit),
    (pucch, "format1_detect_all", _flip_dtx_verdict),
    (prach, "detect", _drop_preamble),
    (pucch, "format1_detect_all", _detected_alone),
], ids=["uci-bit", "f1-dtx-verdict", "preamble-dropped", "f1-detected-alone"])
def test_a_broken_path_is_not_correct(monkeypatch, module, name, fault):
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    res = _run()
    assert not res["correct"], res["numbers"]


def test_the_control_is_refused_on_the_cpu():
    spec = small_ul_tti.spec()
    entry, _order, sampled = window.build(spec, 5, CPU)
    got = entry.expected(sampled, link.BFLOAT16)
    numbers = window.check(entry, window.Driver(entry, set(sampled)), sampled, spec.limits,
                           got=got)[0]
    assert not window.verdict(numbers, spec.limits), numbers


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(tracing, "l1_tracer", object())
    ctx = window.Context({"slots": 8}, object(), [(0, 0)], 8, None, {}, 0)
    for name in NEW_METRICS:
        assert spec_mod.metric_reader(name)(ctx) is None


def test_the_reference_prach_agrees_with_the_ports_reference_parity_helpers():
    """The reference's preambles are ``prach.generate_preamble_ref``'s (srsRAN's
    generator) at unit power per subcarrier, and the reference detects each
    one alone at its delay.  ``prach.detect_ref`` (srsRAN's detector, its
    own thresholds and windows, on B4's 12 repetitions, which it sums)
    finds it too; on these synthetic repetitions its validated threshold
    also passes other hypotheses, so only the sent one is held to."""
    gen = torch.Generator().manual_seed(7)
    root, zcz, fmt = 37, 8, "B4"
    for idx, delay_bins in ((5, 20), (40, 3), (63, 50)):
        ref = ref_prach.preamble(root, zcz, idx)
        np.testing.assert_allclose(ref * np.sqrt(ref_prach.L_RA),
                                   prach.generate_preamble_ref(fmt, root, idx, zcz,
                                                               device="cpu").numpy(), atol=2e-4)
        tau = torch.tensor(delay_bins / (1024 * 30e3))
        h = 0.5 * torch.randn(4, generator=gen, dtype=torch.complex64)
        rx = h[:, None] * torch.from_numpy(ref) * ref_prach.delay_ramp(tau, 30e3)
        rx = rx[:, None] + 0.5 * torch.randn((4, 12, ref_prach.L_RA), generator=gen,
                                             dtype=torch.complex64)
        det = ref_prach.detect(rx.sum(dim=1)[None], root, zcz, 1024, 0.8, 1e-3)
        assert torch.nonzero(det["detected"][0]).flatten().tolist() == [idx]
        assert abs(float(det["delay"][0, idx]) - delay_bins) <= 1
        assert idx in [f["preamble_index"] for f in prach.detect_ref(rx, fmt, root, zcz)]


def _golden(name: str, idx: int, dtype) -> np.ndarray:
    return np.fromfile(spec_mod.ROOT / "tests" / "golden" / "uci_decoder" / f"{name}{idx}.dat",
                       dtype=dtype)


def test_the_reference_uci_decodes_the_golden_vectors():
    """The UCI decoder's golden vectors (srsRAN's ``uci_decoder`` at 8 dB)
    that the reference covers: Reed-Muller 5 and 11 bits, polar 20 to 200
    bits on one segment.  The message is decoded and the verdict valid."""
    cases = json.loads((spec_mod.ROOT / "tests" / "golden" / "uci_decoder"
                        / "manifest.json").read_text())
    covered = [c for c in cases if 3 <= c["a"] <= 11 or 20 <= c["a"] < 360]
    assert [c["a"] for c in covered] == [5, 11, 20, 45, 100, 200]
    for c in covered:
        llrs = torch.from_numpy(_golden("llrs", c["idx"], np.int8).astype(np.float32))
        want = _golden("message", c["idx"], np.uint8)
        bits, ok = ref_uci.decode(llrs[None], c["a"])
        np.testing.assert_array_equal(bits[0].numpy(), want, err_msg=str(c))
        assert bool(ok[0]) == (c["status"] == "valid"), c


def test_the_new_reference_loads_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", """
import json, sys
from portbench.reference import prach, pucch, uci
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""], cwd=spec_mod.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "srsran_project_tpu", "srsran_project_tpu_torch"}
    assert torch.backends.cuda.matmul.allow_tf32 is False
