"""``support/stage_graphs`` and the downlink FAPI entry's plans.

On the CPU: ``StageGraphs`` runs every stage as it is and ``upload`` makes
plain tensors; ``UpperPhy`` plans a request's structure once and gives the
grid the parent's composition gave (``process_multi`` per batch, then
``dl_slot.assemble_broadcast``) bit for bit.

On the card (marker ``cuda``, skipped without one): the replayed graphs
give the eager route's grid bit for bit, every stage is captured by the
third call of a structure and never again, a replayed stage keeps its span
and counts, and a stage whose inputs sit elsewhere at each call runs
eagerly.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import cuda_device  # noqa: F401

from portbench.harness import cells
from portbench.tests import small_dl_tti
from srsran_project_tpu_torch.fapi import messages as fapi
from srsran_project_tpu_torch.phy import dl_slot, pdsch, upper_phy
from srsran_project_tpu_torch.support import tracing
from srsran_project_tpu_torch.support.stage_graphs import StageGraphs

SEED = 2147483647 + 2323


def _entry(device: str):
    spec = small_dl_tti.spec()
    return cells.entry(spec.config, spec.traffic, SEED, torch.device(device))


def test_stages_run_as_they_are_on_the_cpu():
    st = StageGraphs("cpu")
    calls = []

    def fn(x):
        calls.append(x)
        return x + 1

    x = torch.arange(3)
    for _ in range(3):
        assert torch.equal(st.run("stage", {}, "key", fn, x), x + 1)
    assert len(calls) == 3 and not st._graphs and not st._seen


def test_upload_stacks_and_casts_on_the_cpu():
    st = StageGraphs("cpu")
    rows = [np.arange(4, dtype=np.int64), np.ones(4, dtype=np.int64)]
    w = np.full((2, 2), 1 + 2j, dtype=np.complex128)
    a, b, c = st.upload([(rows, np.uint8), ([5, 6], np.int64), (w, np.complex64)])
    assert a.dtype == torch.uint8 and a.tolist() == [[0, 1, 2, 3], [1, 1, 1, 1]]
    assert b.dtype == torch.int64 and b.tolist() == [5, 6]
    assert c.dtype == torch.complex64 and torch.equal(c, torch.full((2, 2), 1 + 2j))


def test_a_request_structure_is_planned_once():
    """Requests whose PDUs hold the same config objects share one plan; a
    unit whose SSB config differs has its own; equal stage keys share one
    token."""
    entry = _entry("cpu")
    phy = entry.phy
    for _ in range(2):
        entry.dispatch(entry.requests[0])
    assert len(phy._plans) == 2  # the DL_TTI.request's and the UL_DCI.request's
    entry.dispatch(entry.requests[1])
    plans = [p for p in phy._plans.values() if isinstance(p, upper_phy._DlPlan)]
    assert len(plans) == 2
    assert plans[0].batches[0].bit_key is plans[1].batches[0].bit_key
    assert plans[0].pdcch[1] is plans[1].pdcch[1]
    assert plans[0].ssb[2] is plans[1].ssb[2]  # sfn_2lsb 0 in both: one SSB stage


def test_a_changed_csi_rs_pdu_is_planned_anew():
    entry = _entry("cpu")
    dl, tx, _ = entry.requests[0]
    first = entry.phy.process_dl_tti(dl, tx)
    pdu = dl.csi_rs[0]
    moved = dataclasses.replace(dl, csi_rs=[dataclasses.replace(pdu, symbol=pdu.symbol + 1)]
                                + list(dl.csi_rs[1:]))
    second = entry.phy.process_dl_tti(moved, tx)
    assert len(entry.phy._plans) == 2
    s0, s1 = pdu.symbol, pdu.symbol + 1
    assert first[0, s0].ne(second[0, s0]).any() and first[0, s1].ne(second[0, s1]).any()


def _composed(phy, dl, tx, ul):
    """The slot as the parent composed it: one ``process_multi`` per batch
    onto a zero grid, then ``dl_slot.assemble_broadcast``, then the UL_DCI's
    PDCCH added on port 0 of a copy."""
    cfg = phy.cfg
    grid = torch.zeros((cfg.nof_ports, cfg.nof_grid_symbols, cfg.nof_grid_sc),
                       dtype=torch.complex64)
    groups = collections.defaultdict(list)
    for p in dl.pdsch:
        groups[dataclasses.replace(p.config, alloc=dataclasses.replace(p.config.alloc,
                                                                       crb_start=0))].append(p)
    for c, pdus in groups.items():
        grid = pdsch.process_multi(
            torch.stack([torch.as_tensor(tx.payloads[p.tb_index]) for p in pdus]),
            torch.tensor([p.rnti for p in pdus]), [p.first_rb for p in pdus],
            torch.stack([torch.as_tensor(p.precoding) for p in pdus]), c, grid=grid)
    grid = dl_slot.assemble_broadcast(grid, dl, cfg)
    grid = dl_slot.assemble_broadcast(grid, fapi.DlTtiRequest(slot=ul.slot, pdcch=ul.pdcch), cfg)
    return grid


def test_the_entry_gives_the_parents_composition():
    entry = _entry("cpu")
    for u in range(entry.units):
        dl, tx, ul = entry.requests[u]
        got = entry.phy.process_ul_dci(ul, entry.phy.process_dl_tti(dl, tx))
        assert torch.equal(got, _composed(entry.phy, dl, tx, ul))


@pytest.mark.cuda
def test_the_replayed_slot_is_the_eager_slot(cuda_device):
    dev = cuda_device
    entry = _entry(str(dev))
    eager = upper_phy.UpperPhy(entry.phy.cfg)
    eager._stages.enabled = False
    st = entry.phy._stages
    counts = []
    for call in range(6):
        dl, tx, ul = entry.requests[call % entry.units]
        got = entry.phy.process_ul_dci(ul, entry.phy.process_dl_tti(dl, tx))
        want = eager.process_ul_dci(ul, eager.process_dl_tti(dl, tx))
        assert torch.equal(got, want), call
        counts.append(len(st._graphs))
    # A batch's bit chain and grid chain, the DL_TTI's and the UL_DCI's
    # PDCCH, the SSB, the CSI-RS: six stages.  The second call captures all
    # but the grid chain, whose codewords come from the bit chain's graph
    # from then on; the third captures that one.
    assert counts == [0, 5, 6, 6, 6, 6], counts


@pytest.mark.cuda
def test_a_replayed_stage_keeps_its_span(monkeypatch, cuda_device):
    dev = cuda_device
    entry = _entry(str(dev))
    for _ in range(3):
        entry.dispatch(entry.requests[0])
    tr = tracing.l1_tracer
    monkeypatch.setattr(tr, "_kept", [])
    monkeypatch.setattr(tr, "enabled", True)
    entry.dispatch(entry.requests[0])
    torch.cuda.synchronize()
    t = tr.take().totals
    assert t["pdcch.encode"].spans == 2 and t["pdcch.encode"].counts == {"pdus": 4}
    assert t["ssb.assemble"].counts == {"ssbs": 1}
    assert t["csi_rs.generate"].spans == 1
    assert t["csi_rs.generate"].counts == {"resources": 2, "ports": 2}
    assert t["pdsch.bit_chain"].spans == t["pdsch.grid"].spans == 1
    assert t["pdsch.grid"].counts == {"reserved_res": 2 * 12 * 3 * 2}


@pytest.mark.cuda
def test_inputs_elsewhere_run_eagerly(cuda_device):
    """Inputs at new addresses at each call make a new key each time: the
    stage runs eagerly and nothing is captured."""
    dev = cuda_device
    st = StageGraphs(dev)
    calls, held = [], []

    def fn(x):
        calls.append(1)
        return x * 2

    for i in range(4):
        held.append(torch.full((8,), float(i), device=dev))
        assert torch.equal(st.run("stage", {}, "key", fn, held[-1]), held[-1] * 2)
    assert len(calls) == 4 and not st._graphs
