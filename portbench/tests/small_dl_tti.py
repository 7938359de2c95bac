"""The ``fapi_dl_tti`` cell cut down for the CPU tests: a 52-PRB carrier
with 4 transmit ports, two PDSCH UEs of 2 layers of 64QAM on 12 PRB each
from PRB 20 (one ``process_multi`` batch) under a TRS on PRB 20-51; 4 DCIs
at aggregation levels 1 and 2 in an interleaved CORESET of 48 PRB (8
CCEs); one SSB at CRB 0-19; pools of 2 slots.  The limits are the cell's
own."""

from __future__ import annotations

import copy
import dataclasses

from portbench.harness import cells, spec as spec_mod
from portbench.reference import dl

CELL = "fapi_dl_tti"


def config() -> dict:
    c = copy.deepcopy(spec_mod.load(CELL).config)
    c["carrier"]["nof_rb"] = 52
    c["ues"] = [{"count": 2, "layers": 2, "modulation_order": 6, "target_code_rate_x1024": 567,
                 "nof_rb": 12}]
    c["trs"].update(rb_start=20, rb_count=32)
    c["coreset"].update(rb_count=48, interleaved=True)
    c["dci"]["aggregation_levels"] = [1, 2]
    c["ssb"].update(indices=[0], first_symbols=[2])
    return _expected(c)


def _expected(c: dict) -> dict:
    """``expected`` of the cut-down UEs at the cell's N_oh."""
    rows = set()
    for ue in cells.ue_layout(c):
        g = cells.grant(c, ue)
        g = dl.DlGrant(**{f.name: getattr(g, f.name) for f in dataclasses.fields(g)},
                       n_oh=c["pdsch_x_overhead"])
        rows.add((g.tbs, g.seg.c, g.seg.bg, g.seg.z))
    c["expected"] = dict(zip(("tbs", "codeblocks", "base_graph", "lifting_size"),
                             map(list, zip(*sorted(rows)))))
    return c


def spec() -> spec_mod.Spec:
    full = spec_mod.load(CELL)
    traffic = dict(full.traffic, pool_units=2, check_units=2, warmup_calls=1, trace_rounds=1)
    return spec_mod.Spec(CELL, 1, config(), traffic, full.limits, full.end_to_end, full.per_layer)
