"""What the benchmark loads: no JAX and no JAX package in a run, nothing
of the program in the reference.  Module names are compared by their
whole top-level name: ``srsran_project_tpu_torch`` is the program, not
the JAX package ``srsran_project_tpu``."""

import json
import subprocess
import sys

from portbench import run
from portbench.harness import spec as spec_mod

FORBIDDEN = {"jax", "jaxlib", "flax", "srsran_project_tpu"}


def _top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=spec_mod.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    """Every cell's whole run path, at the small sizes on the CPU, in a
    fresh interpreter."""
    loaded = _top_level_modules("""
import json, sys, torch
import portbench.run
from portbench.harness import window
from portbench.tests import small
for name, traced in (("mu8_ul", True), ("su_ul_b1", False), ("su_dl_b8", True)):
    window.run(small.spec(name), 7, 0.05, traced, torch.device("cpu"), 0.0)
assert portbench.run.forbidden_modules() == []
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""")
    assert not loaded & FORBIDDEN
    assert "srsran_project_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_modules("""
import json, sys
from portbench.reference import ldpc, link, nr
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""")
    assert not loaded & (FORBIDDEN | {"srsran_project_tpu_torch"})


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["srsran_project_tpu_torch.models.cell", "torch"]) == []
    assert run.forbidden_modules(["srsran_project_tpu.ops", "jaxlib.xla_client", "jax"]) == [
        "jax", "jaxlib", "srsran_project_tpu"]
