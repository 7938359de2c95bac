"""The control: the reference computed in bfloat16, put in the program's
place, has to be refused by every cell's comparison.  On the CPU at the
small sizes; on the card at the cells' own sizes, three seeds each, the
program's own answers accepted on the same seeds (``cuda`` marker; run on
a machine with a card by
``python -m pytest --noconftest portbench/tests/test_portbench_control.py -m cuda``)."""

import pytest
import torch

from portbench.harness import spec as spec_mod, window
from portbench.reference import link
from portbench.tests import small

CELLS = ("su_ul_b8", "mu8_ul", "su_ul_b1", "su_dl_b8", "su_ul_b8_bler10")


def _control(spec, seed: int, dev: torch.device) -> dict:
    entry, _order, sampled = window.build(spec, seed, dev)
    driver = window.Driver(entry, set(sampled))
    got = entry.expected(sampled, link.BFLOAT16)
    return window.check(entry, driver, sampled, spec.limits, got=got)[0]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_refused_on_the_cpu(workload):
    spec = small.spec(workload)
    numbers = _control(spec, 5, torch.device("cpu"))
    assert not window.verdict(numbers, spec.limits), numbers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_refused_and_the_program_accepted_on_the_card(card, workload):
    spec = spec_mod.load(workload)
    for seed in (2147483001, 2147483002, 2147483003):
        numbers = _control(spec, seed, card)
        assert not window.verdict(numbers, spec.limits), (seed, numbers)
        res = window.run(spec, seed, 1.0, False, card, 0.0)
        assert res["correct"], (seed, res["numbers"])
