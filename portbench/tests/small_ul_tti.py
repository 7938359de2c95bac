"""The ``fapi_ul_tti`` cell cut down for the CPU tests: a 52-PRB carrier
with 4 receive ports, two PUSCH UEs (2 layers of 64QAM on 12 PRB, QPSK on
8), one F1 resource with hopping and 4 code-multiplexed UEs (shifts 0 and
6 x OCC 0 and 1; the last one allocated and silent), one polar F2 (22
bits) and one Reed-Muller F2 (6 bits), and the B4 PRACH occasion with 2
preambles, in pools of 2 slots.  The limits are the cell's own."""

from __future__ import annotations

import copy

from portbench.harness import spec as spec_mod
from portbench.tests import small

CELL = "fapi_ul_tti"


def config() -> dict:
    c = copy.deepcopy(spec_mod.load(CELL).config)
    c["carrier"]["nof_rb"] = 52
    c["ues"] = [{"count": 1, "layers": 2, "modulation_order": 6, "target_code_rate_x1024": 567,
                 "nof_rb": 12},
                {"count": 1, "layers": 1, "modulation_order": 2, "target_code_rate_x1024": 120,
                 "nof_rb": 8}]
    c["pusch_first_rb"] = 16
    c["pucch_f1"].update(resources=[[0, 51]], cyclic_shifts=[0, 6], occ=[0, 1],
                         harq_bits=[1, 2, 2, 1], dtx=[3])
    c["pucch_f2"]["occasions"] = [{"rb_start": 2, "nof_uci_bits": 22},
                                  {"rb_start": 46, "nof_uci_bits": 6}]
    c["prach"]["first_rb"] = 4
    return small._expected(c)


def spec() -> spec_mod.Spec:
    full = spec_mod.load(CELL)
    traffic = dict(full.traffic, pool_units=2, check_units=2, warmup_calls=1, trace_rounds=1)
    return spec_mod.Spec(CELL, 1, config(), traffic, full.limits, full.end_to_end, full.per_layer)
