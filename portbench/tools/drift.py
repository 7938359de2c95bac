"""What the host and the card do in each second of a cell's window, to find
why a run's slot rate drifts:

    python3 portbench/tools/drift.py --workload <cell> --seed <n> --seconds 30 \
        --gc on|disable|freeze

Runs the cell's set-up and window as ``portbench/run.py`` does, with
Python's garbage collector left on, disabled for the window, or with the
set-up's objects frozen out of it (``gc.freeze``).  Beside it, once a
second: the card's SM and memory clocks, power and throttle reasons
(``nvidia-smi -lms 1000`` in its own process), the host's mean core clock
(``/proc/cpuinfo``), the share of the host's CPU time stolen by its
hypervisor and the share spent idle (``/proc/stat``), and this process's
CPU seconds.  Prints one JSON line: the slots and the readings of every
second, and the collector's passes over the window.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))


def _cpu_mhz() -> float:
    vals = [float(ln.split(":")[1]) for ln in open("/proc/cpuinfo") if ln.startswith("cpu MHz")]
    return sum(vals) / len(vals) if vals else float("nan")


def _stat() -> list:
    with open("/proc/stat") as f:
        return [int(v) for v in f.readline().split()[1:]]


class HostSampler(threading.Thread):
    """Once a second: mean core MHz, stolen and idle shares of all cores,
    and this process's CPU seconds in that second."""

    def __init__(self):
        super().__init__(daemon=True)
        self.rows, self.stop = [], threading.Event()

    def run(self):
        prev, pcpu = _stat(), time.process_time()
        t0 = time.perf_counter()
        while not self.stop.wait(1.0):
            cur, c = _stat(), time.process_time()
            d = [b - a for a, b in zip(prev, cur)]
            total = sum(d) or 1
            self.rows.append({"t": round(time.perf_counter() - t0, 3),
                              "cpu_mhz": round(_cpu_mhz(), 1),
                              "steal_pct": round(100.0 * d[7] / total, 2) if len(d) > 7 else None,
                              "idle_pct": round(100.0 * (d[3] + d[4]) / total, 2),
                              "proc_cpu_s": round(c - pcpu, 3)})
            prev, pcpu = cur, c


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--gc", choices=("on", "disable", "freeze"), default="on")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("drift: needs a CUDA card", file=sys.stderr)
        return 2
    from portbench.harness import spec as spec_mod, window

    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    spec = spec_mod.load(args.workload)
    entry, order, sampled = window.build(spec, args.seed, dev)
    driver = window.Driver(entry, set(sampled))
    window.warm_up(driver, order, int(spec.traffic["warmup_calls"]))
    gc.collect()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu,"
         "clocks_throttle_reasons.active", "--format=csv,noheader,nounits", "-lms", "1000"],
        stdout=subprocess.PIPE, text=True)
    host = HostSampler()
    host.start()
    if args.gc == "freeze":
        gc.freeze()
    elif args.gc == "disable":
        gc.disable()
    before = [s["collections"] for s in gc.get_stats()]
    w = window.measure(driver, order, args.seconds)
    passes = [s["collections"] - b for s, b in zip(gc.get_stats(), before)]
    gc.enable()
    host.stop.set()
    host.join()
    smi.terminate()
    card_rows = [ln.strip() for ln in smi.communicate(timeout=30)[0].splitlines() if ln.strip()]
    print(json.dumps({"workload": args.workload, "seed": args.seed, "gc": args.gc,
                      "slots_per_s": w["slots"] / w["elapsed_s"],
                      "slots_by_second": w["slots_by_second"], "gc_passes": passes,
                      "host": host.rows, "card": card_rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
