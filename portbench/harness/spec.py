"""A cell of the benchmark, found by name: its entry of ``BENCHMARK.json``,
its configuration file, its traffic file, its limits file and the metrics
it reports.  Files are found by the names in ``BENCHMARK.json``:

- ``portbench/configs/<config>.json`` (the ``file`` of the configuration);
- ``portbench/traffic/<traffic>.json``, whose ``generator`` names
  ``portbench/generators/<generator>.py``;
- ``portbench/channels/<kind>.py``, the configuration's ``channel.kind``;
- ``portbench/limits/<workload>.json``: the limit of each number that the
  comparison with the reference reads;
- ``portbench/metrics/<metric>.py``: the reader of a per-layer metric.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Spec:
    workload: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _reports(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load(workload: str, bench_file: pathlib.Path | None = None) -> Spec:
    """The cell named ``workload``; raises KeyError if there is none."""
    bench = json.loads((bench_file or ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Spec(workload, int(cell["chips"]), config, traffic, limits, e2e, per_layer)


@functools.lru_cache(maxsize=None)
def module(folder: str, name: str):
    """The module ``portbench/<folder>/<name>.py``, loaded once from its file."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no file {path.relative_to(ROOT)}")
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``portbench/metrics/<name>.py``."""
    return module("metrics", name).read
