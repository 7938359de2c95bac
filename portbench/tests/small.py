"""Small cells for the CPU tests: the benchmark's own configurations and
traffic files with the carrier, the grants and the pools cut down, so
that a whole run (set-up, window, traced stretch, comparison) takes
seconds on a CPU.  The limits are the cells' own."""

from __future__ import annotations

import copy
import json

from portbench.harness import cells, spec as spec_mod

BENCH = json.loads((spec_mod.ROOT / "BENCHMARK.json").read_text())


def _file(*parts) -> dict:
    return json.loads(spec_mod.BENCH.joinpath(*parts).read_text())


def _expected(config: dict) -> dict:
    """The configuration's ``expected`` recomputed for its cut-down UEs."""
    rows = sorted({(g.tbs, g.seg.c, g.seg.bg, g.seg.z)
                   for g in (cells.grant(config, ue) for ue in cells.ue_layout(config))})
    config["expected"] = dict(zip(("tbs", "codeblocks", "base_graph", "lifting_size"),
                                  map(list, zip(*rows))))
    return config


def su_config(name: str = "nr100_4x4_256qam_su") -> dict:
    """A single-UE configuration on 12 PRBs with 2 ports and 2 layers of
    64QAM."""
    c = copy.deepcopy(_file("configs", f"{name}.json"))
    c["carrier"]["nof_rb"] = 12
    c["nof_rx_ports"] = 2
    c["ues"] = [dict(c["ues"][0], nof_rb=12, layers=2, modulation_order=6,
                     target_code_rate_x1024=567)]
    return _expected(c)


def mu_config(name: str = "nr100_4rx_mu8_mixed") -> dict:
    """A multi-UE configuration on 24 PRBs: a 2-layer 64QAM UE, two
    1-layer 16QAM UEs (the second retransmitting) and a QPSK UE."""
    c = copy.deepcopy(_file("configs", f"{name}.json"))
    c["carrier"]["nof_rb"] = 24
    c["nof_rx_ports"] = 2
    c["ues"] = [
        {"count": 1, "layers": 2, "modulation_order": 6, "target_code_rate_x1024": 567,
         "nof_rb": 8},
        {"count": 2, "layers": 1, "modulation_order": 4, "target_code_rate_x1024": 490,
         "nof_rb": 6},
        {"count": 1, "layers": 1, "modulation_order": 2, "target_code_rate_x1024": 120,
         "nof_rb": 4}]
    c["retransmitted_ue"] = 2
    c["retransmitted_ue_atten_db"] = 6.0
    return _expected(c)


def spec(workload: str) -> spec_mod.Spec:
    """The cell ``workload`` at the small sizes."""
    cell = next(w for w in BENCH["workloads"] if w["name"] == workload)
    multi = "retransmitted_ue" in _file("configs", f"{cell['config']}.json")
    config = (mu_config if multi else su_config)(cell["config"])
    traffic = _file("traffic", f"{cell['traffic']}.json")
    traffic.update(pool_units=2, check_units=2, warmup_calls=1, trace_rounds=1)
    if traffic.get("slots_per_call", 1) > 1:
        traffic["slots_per_call"] = 2
    full = spec_mod.load(workload)
    return spec_mod.Spec(workload, 1, config, traffic, full.limits, full.end_to_end,
                         full.per_layer)
