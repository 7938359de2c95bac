"""A whole run of each cell at the small sizes on the CPU (the harness's
look for a card skipped), once sound and once with the timed path broken
underneath: ``correct`` has to come out true, then false, for each fault
that the cell can have.  One chip has no exchange between chips to leave
out; the single-UE cells carry no state from call to call."""

import pytest
import torch

from portbench.harness import window
from portbench.tests import small
from srsran_project_tpu_torch.models import cell
from srsran_project_tpu_torch.phy import ul_slot

CPU = torch.device("cpu")


def _run(workload: str, traced: bool = False) -> dict:
    return window.run(small.spec(workload), 2147483647 + 11, 0.05, traced, CPU, 0.0)


@pytest.mark.parametrize("workload,traced", [("su_ul_b8", True), ("mu8_ul", False),
                                             ("su_ul_b8_bler10", True),
                                             ("su_ul_b1", False), ("su_dl_b8", True)])
def test_a_sound_run_is_correct(workload, traced):
    res = _run(workload, traced)
    assert res["correct"], res["numbers"]
    assert res["failed"] == 0 and res["window"]["slots"] > 0


def _half_batch(fn):
    """The batch's first half computed, the second half's answers copied
    from it."""
    def broken(x, rnti, *args):
        h = x.shape[0] // 2
        out = fn(x[:h], rnti[:h], *args)
        rep = lambda t: torch.cat([t, t[: x.shape[0] - h]])  # noqa: E731
        return {k: rep(v) for k, v in out.items()} if isinstance(out, dict) else rep(out)
    return broken


def _flip_bit(fn):
    def broken(*args):
        out = fn(*args)
        out["tb_bits"] = out["tb_bits"].clone()
        out["tb_bits"].view(-1)[0] ^= 1
        return out
    return broken


def _flip_crc(fn):
    def broken(*args):
        out = fn(*args)
        out["tb_crc_ok"] = ~out["tb_crc_ok"]
        return out
    return broken


def _alter_iq(fn):
    def broken(tb, rnti, precoding, cfg):
        iq = fn(tb, rnti, precoding, cfg).clone()
        iq.view(-1)[iq.numel() // 3] *= -1
        return iq
    return broken


def _state_unchanged(fn):
    """The HARQ buffer returned as it came in (zeros for new data)."""
    def broken(grid, pdus, *args):
        res = fn(grid, pdus, *args)
        for r, pdu in zip(res[0], pdus):
            buf = pdu.harq_buffer
            r["harq_buffer"] = torch.zeros_like(r["harq_buffer"]) if buf is None else buf
        return res
    return broken


def _ue_answer_altered(fn):
    def broken(grid, pdus, *args):
        res = fn(grid, pdus, *args)
        r = res[0][0]
        r["tb_bits"] = r["tb_bits"].clone()
        r["tb_bits"][0] ^= 1
        return res
    return broken


@pytest.mark.parametrize("workload,module,name,fault", [
    ("su_ul_b8", cell, "decode_slot", _half_batch),
    ("su_ul_b8", cell, "decode_slot", _flip_bit),
    ("su_ul_b1", cell, "decode_slot", _flip_bit),
    ("su_ul_b1", cell, "decode_slot", _flip_crc),
    ("mu8_ul", ul_slot, "process_slot", _state_unchanged),
    ("mu8_ul", ul_slot, "process_slot", _ue_answer_altered),
    ("su_dl_b8", cell, "encode_slot", _half_batch),
    ("su_dl_b8", cell, "encode_slot", _alter_iq),
], ids=["b8-half-batch", "b8-bit", "b1-bit", "b1-crc", "mu8-state-unchanged", "mu8-bit",
        "dl-half-batch", "dl-iq"])
def test_a_broken_path_is_not_correct(monkeypatch, workload, module, name, fault):
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    res = _run(workload)
    assert not res["correct"], res["numbers"]
