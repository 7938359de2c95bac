"""The readings that a cell's limits are set from, many seeds in one
process on the card:

    python3 portbench/tools/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 1

For each of ``--seeds``: the cell's inputs from the seed, a short window at
the cell's own load, and the numbers that compare the program's answers
with the reference (the lower readings).  For each of ``--control-seeds``:
the same numbers with the reference computed in bfloat16 put in the
program's place (the control, whose smallest reading is the upper one).
One JSON line per seed on standard output, each with the card's name
and power limit.  Exits 2 without a reading when no CUDA card is there.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("readings: needs a CUDA card; the limits are set from the card's readings",
              file=sys.stderr)
        return 2
    from portbench.harness import spec as spec_mod, window, yardstick
    from portbench.reference import link

    spec = spec_mod.load(args.workload)
    dev = torch.device("cuda", 0)
    card = yardstick.card_line()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for kind, seed in [("program", s) for s in seeds] + [("control", s) for s in controls]:
        t = time.perf_counter()
        entry, order, sampled = window.build(spec, seed, dev)
        driver = window.Driver(entry, set(sampled))
        if kind == "program":
            window.warm_up(driver, order, int(spec.traffic["warmup_calls"]))
            w = window.measure(driver, order, args.seconds)
            numbers, _ = window.check(entry, driver, sampled, spec.limits)
            extra = {"slots": w["slots"]}
        else:
            got = entry.expected(sampled, link.BFLOAT16)
            numbers, _ = window.check(entry, driver, sampled, spec.limits, got=got)
            extra = {}
        print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                          "numbers": numbers, "seconds": time.perf_counter() - t, "card": card,
                          **extra}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
