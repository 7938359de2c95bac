"""The benchmark of ``srsran_project_tpu_torch`` on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: makes the
cell's inputs from the seed, warms up its shapes, measures for
``--seconds``, checks the answers against the plain reference in
``portbench/reference``, and prints one JSON line as the last line of its
standard output (with ``--trace 1`` the per-layer metrics from a traced
stretch after the window, else the end-to-end ones).  The numbers compared
with the reference are printed beside their limits as the last lines of
standard error and under the result's last key, ``checks``.

Exits 2 without a result when no CUDA card (or fewer than the cell asks
for) is there, and 3 when the JAX package or JAX is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "srsran_project_tpu")


def forbidden_modules(names=None) -> list:
    """The modules (by default the loaded ones) whose top-level name,
    compared whole, is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Build and kernel caches at fixed paths inside the checkout (the
    # program's kernels build into build/ beside its package).
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness import spec as spec_mod, window, yardstick

    spec = spec_mod.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"portbench: the cell {args.workload} needs {spec.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    res = window.run(spec, args.seed, args.seconds, bool(args.trace), dev, T_START)

    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": spec.chips,
              "memory_peak_bytes": int(res["peak"])}
    line = {"correct": res["correct"], "attempted": res["window"]["slots"],
            "failed": res["failed"], "metrics": res["metrics"], "device": device}
    tr = res["trace"]
    if tr is not None:
        device["busy_s"], device["window_s"] = tr.busy_s, tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    checks = {k: {"value": v, "limit": spec.limits[k]} for k, v in res["numbers"].items()}
    line["checks"] = checks
    w = res["window"]
    print(f"portbench: {args.workload} seed {args.seed} on {yardstick.card_line()}: "
          f"{w['calls']} calls, {w['slots']} slots in {w['elapsed_s']:.3f} s, set-up "
          f"{res['setup_s']:.3f} s (" + ", ".join(f"{k} {v:.3f} s" for k, v in res["phases"].items())
          + ")", file=sys.stderr)
    print(f"portbench: slots completed in each second of the window: {w['slots_by_second']}",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"portbench check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
