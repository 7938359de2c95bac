"""Every PUCCH F2 occasion of a call in one receive (``phy/pucch_f2.
process_all`` over ``ops/pucch_f2_rx.receive``; kernel K6 on a CUDA grid).

On the CPU: ``process_all`` equals the eager chain an occasion at a time
(``pucch_f2_rx._receive_one``, which ``process`` ran before) bit for bit
in bits, ok and snr_db, on polar occasions with CRC11 and with CRC6 and
its parity-check bits (``n_pc_wm`` 0 and 1), Reed-Muller ones, all three
rate-match modes, 1 and 2 symbols, with and without a second hop, on 1, 2
and 4 ports, alone and mixed in one call; the kernel's host tables (the
rate dematch plan composed with the channel de-interleaver, the SSC walk
as instructions, the short-block basis) run through a numpy model of the
kernel's decode stage and give ``uci.decode_uci``'s bits and verdicts; the
span and the entry points call and count once per call; and
``short_block.detect`` reads nothing on the host.

On the card (marker ``cuda``, skips without one): K6 against the plain
version on the CPU on the same batches, one launch a call.  Bits and ok
exact; snr_db within 1e-4 dB: the kernel sums the slope, the noise and
RSRP means and the ports in index order where torch reduces in its own,
and its atan2f / cosf / sinf / log10f round in the last place otherwise
(the CPU-emulated kernel reads gaps of at most 2.4e-6 dB).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_parity import cuda_device  # noqa: F401

from srsran_project_tpu_torch.ops import pucch_f2_rx as rx
from srsran_project_tpu_torch.ops import short_block, uci
from srsran_project_tpu_torch.phy import pucch, pucch_f2, ul_slot, upper_phy
from srsran_project_tpu_torch.support import tracing

NSC = 273 * 12
SNR_DB = 10.0

# (nof_uci_bits, rb_count, nof_symbols, hop): each polar case's rate-match
# mode and parity-check variant in its id.
CASES = {
    "polar-crc11-repetition": (22, 2, 2, False),
    "polar-crc11-shortening": (40, 3, 2, False),
    "polar-crc11-puncturing-hop": (22, 7, 2, True),
    "polar-crc11-n512": (40, 16, 2, False),
    "polar-crc11-shortening-1sym": (40, 7, 1, False),
    "polar-crc6-repetition-wm0": (12, 2, 2, False),
    "polar-crc6-puncturing-wm0-1sym": (15, 3, 1, False),
    "polar-crc6-puncturing-wm1-hop": (19, 7, 2, True),
    "polar-crc6-repetition-wm1": (12, 8, 2, False),
    "polar-crc6-shortening-1sym": (19, 3, 1, False),
    "rm-3-1sym": (3, 1, 1, False),
    "rm-6": (6, 2, 2, False),
    "rm-11-hop": (11, 2, 2, True),
    "rm-11-1sym": (11, 2, 1, False),
}


def _placed(names, ports: int) -> list:
    """The configurations of ``names`` on disjoint PRBs of one slot."""
    cfgs, rb = [], 0
    for i, name in enumerate(names):
        k, rbs, nsym, hop = CASES[name]
        cfgs.append(pucch_f2.PucchFormat2Config(
            rb_start=rb, rb_count=rbs, start_symbol=14 - nsym, nof_symbols=nsym,
            nof_uci_bits=k, rnti=0x4601 + 37 * i, n_id=5 + i, n_id0=9, slot_in_frame=3,
            nof_rx_ports=ports, nof_grid_sc=NSC, second_hop_rb_start=rb + rbs if hop else None))
        rb += rbs * (2 if hop else 1)
    return cfgs


def _grid(cfgs, ports: int, seed: int, snr_db: float = SNR_DB):
    """(P, 14, NSC) complex64: every occasion's UE through its own flat
    channel (a random phase of unit gain on every port), plus AWGN at
    ``snr_db`` per port; and the sent bits."""
    rng = np.random.default_rng(seed)
    s = np.sqrt(0.5 * 10 ** (-snr_db / 10))
    grid = (rng.standard_normal((ports, 14, NSC)) + 1j * rng.standard_normal((ports, 14, NSC))) * s
    sent = []
    for cfg in cfgs:
        bits = rng.integers(0, 2, size=(cfg.nof_uci_bits,), dtype=np.uint8)
        h = np.exp(2j * np.pi * rng.random(ports))
        grid = grid + h[:, None, None] * pucch_f2.generate(cfg, bits, device="cpu").numpy()[None]
        sent.append(bits)
    return torch.from_numpy(grid.astype(np.complex64)), sent


def test_the_cases_cover_every_code_variant():
    modes, wm = set(), set()
    for k, rbs, nsym, _hop in CASES.values():
        e = 16 * rbs * nsym
        if k > 11:
            modes.add(uci._uci_code(k, e).rm_mode)
            if k <= 19:
                wm.add(int(e - (k + 6) + 3 > 192))
    assert modes == {"repetition", "puncturing", "shortening"} and wm == {0, 1}


@pytest.mark.parametrize("ports", [1, 2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_one_occasion_is_the_eager_chain(name, ports):
    cfgs = _placed([name], ports)
    grid, sent = _grid(cfgs, ports, seed=ports)
    bits, ok, snr = pucch_f2.process(grid, cfgs[0])
    want = rx._receive_one(grid, cfgs[0])
    assert torch.equal(bits, want[0]) and torch.equal(ok, want[1]) and torch.equal(snr, want[2])
    assert bits.dtype == torch.uint8 and ok.dtype == torch.bool and snr.dtype == torch.float32
    assert bool(ok)
    np.testing.assert_array_equal(bits.numpy(), sent[0])


@pytest.mark.parametrize("snr_db", [SNR_DB, -3.0], ids=["10dB", "-3dB"])
@pytest.mark.parametrize("ports", [1, 2, 4])
def test_a_mixed_call_is_the_eager_chain_per_occasion(ports, snr_db):
    """Every case in one call: each result bitwise the per-occasion
    ``process``'s and the eager chain's, at -3 dB where CRCs fail too."""
    cfgs = _placed(list(CASES), ports)
    grid, sent = _grid(cfgs, ports, seed=10 + ports, snr_db=snr_db)
    got = pucch_f2.process_all(grid, cfgs)
    assert len(got) == len(cfgs)
    for cfg, (bits, ok, snr), bits_sent in zip(cfgs, got, sent):
        for want in (pucch_f2.process(grid, cfg), rx._receive_one(grid, cfg)):
            assert torch.equal(bits, want[0]) and torch.equal(ok, want[1])
            assert torch.equal(snr, want[2])
        if snr_db == SNR_DB:
            assert bool(ok)
            np.testing.assert_array_equal(bits.numpy(), bits_sent)


def _model_decode(llr: np.ndarray, cfg):
    """A numpy model of K6's decode stage on (E,) float32 LLRs, read from
    the parameter buffer as the kernel reads it -> (bits (K,), ok)."""
    tab = rx.params((cfg,))
    hd = tab[rx._GLOBAL_WORDS : rx._GLOBAL_WORDS + rx._HDR_WORDS]
    k, e = hd[rx.H_K], hd[rx.H_E]
    if not hd[rx.H_POLAR]:
        n = hd[rx.H_N]
        basis = tab[hd[rx.H_PROG] : hd[rx.H_PROG] + k].view(np.uint32)
        x = np.zeros(-(-e // n) * n, np.float32)
        x[:e] = llr
        folded = x.reshape(-1, n).sum(axis=0, dtype=np.float32)
        best, best_m = -np.inf, 0
        for m in range(1 << k):
            cw = np.bitwise_xor.reduce([basis[t] for t in range(k) if (m >> t) & 1] or [0])
            score = np.float32(sum(-folded[j] if (int(cw) >> j) & 1 else folded[j]
                                   for j in range(n)))
            if score > best:
                best, best_m = score, m
        metric = best / (np.abs(folded).sum() + np.float32(1e-9))
        return np.array([(best_m >> t) & 1 for t in range(k)], np.uint8), metric > 0.2
    nval, reps = hd[rx.H_N], hd[rx.H_REPS]
    dm = tab[hd[rx.H_DEMATCH] : hd[rx.H_DEMATCH] + reps * nval].reshape(reps, nval)
    tree = np.zeros(2 * nval, np.float32)
    for pos in range(nval):
        v = np.float32(llr[dm[0, pos]] if dm[0, pos] >= 0 else 0.0)
        for r in range(1, reps):
            v = v + np.float32(llr[dm[r, pos]] if dm[r, pos] >= 0 else 0.0)
        tree[nval + pos] = 1e9 if dm[0, pos] == -2 else v
    part, u, acc = np.zeros(nval, np.uint8), np.zeros(nval, np.uint8), 0
    prog = tab[hd[rx.H_PROG] : hd[rx.H_PROG] + 3 * hd[rx.H_NOPS]].reshape(-1, 3)
    for op, lo, size in prog:
        h = size // 2
        a, b = tree[size : size + h].copy(), tree[size + h : 2 * size].copy()
        if op == rx.OP_F:
            tree[h:size] = np.sign(a) * np.sign(b) * np.minimum(np.abs(a), np.abs(b))
        elif op == rx.OP_G:
            tree[h:size] = np.where(part[lo : lo + h] == 1, b - a, b + a)
        elif op == rx.OP_ZERO:
            part[lo : lo + size] = u[lo : lo + size] = 0
        elif op == rx.OP_PC:
            part[lo] = u[lo] = (acc >> (lo % 5)) & 1
        elif op == rx.OP_INFO:
            part[lo] = u[lo] = tree[1] < 0
            acc ^= int(u[lo]) << (lo % 5)
        elif op == rx.OP_RATE1:
            x = (tree[size : 2 * size] < 0).astype(np.uint8)
            part[lo : lo + size] = x
            step = 1
            while step < size:
                x = x.reshape(-1, 2, step)
                x[:, 0] ^= x[:, 1]
                x, step = x.reshape(-1), 2 * step
            u[lo : lo + size] = x
            for j in range(size):
                acc ^= int(u[lo + j]) << ((lo + j) % 5)
        else:
            part[lo : lo + h] ^= part[lo + h : lo + size]
    info = tab[hd[rx.H_INFO] : hd[rx.H_INFO] + k + hd[rx.H_CRC_LEN]]
    msg = u[info]
    reg, crc_len = 0, hd[rx.H_CRC_LEN]
    for bit in list(msg) + [0] * crc_len:
        reg = (reg << 1) | int(bit)
        if reg >> crc_len:
            reg ^= int(hd[rx.H_CRC_POLY])
    return msg[:k], reg == 0


@pytest.mark.parametrize("noise", [0.0, 1.5, 4.0], ids=["clean", "noisy", "failing"])
@pytest.mark.parametrize("name", list(CASES))
def test_the_kernel_tables_decode_as_decode_uci(name, noise):
    """K6's decode stage, modelled in numpy on its parameter buffer, gives
    ``uci.decode_uci``'s bits and verdict on the same LLRs: clean,
    noisy, and noisy enough that CRCs fail."""
    cfg = _placed([name], 1)[0]
    rng = np.random.default_rng(len(name) + int(10 * noise))
    e = cfg.nof_coded_bits
    for _ in range(3):
        bits = torch.from_numpy(rng.integers(0, 2, size=(cfg.nof_uci_bits,), dtype=np.uint8))
        cw = uci.encode_uci(bits, e).numpy().astype(np.float32)
        llr = ((1.0 - 2.0 * cw) * 2.0 + noise * rng.standard_normal(e)).astype(np.float32)
        want_bits, want_ok = uci.decode_uci(torch.from_numpy(llr), cfg.nof_uci_bits)
        got_bits, got_ok = _model_decode(llr, cfg)
        np.testing.assert_array_equal(got_bits, want_bits.numpy())
        assert bool(got_ok) == bool(want_ok)


def test_the_parameter_buffer_refuses_what_k6_cannot_take():
    cfg = _placed(["rm-6"], 4)[0]
    for bad in (dict(nof_rx_ports=5), dict(rb_count=17), dict(nof_symbols=3, start_symbol=11),
                dict(rb_start=NSC // 12 - 1)):
        with pytest.raises(ValueError):
            rx.params((dataclasses.replace(cfg, **bad),))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("k", [1, 2, 3, 6, 11])
def test_short_block_detect_reads_nothing_on_the_host(k):
    """The winning message's bits are gathered on the device: no
    ``_local_scalar_dense`` (a 0-d index would read it on the host), and
    the bits are those of the argmax, batched or not."""
    rng = np.random.default_rng(k)
    llrs = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    for x in (llrs, llrs[0]):
        with _Ops() as ops:
            bits, metric = short_block.detect(x, k, 40)
        assert not any("_local_scalar_dense" in n for n in ops.names), ops.names
        signs = short_block._signs_on(torch.device("cpu"), k)
        n = signs.shape[1]
        xp = torch.nn.functional.pad(x, (0, -(-40 // n) * n - 40))
        folded = xp.reshape(x.shape[:-1] + (-1, n)).sum(dim=-2)
        best = torch.argmax((folded[..., None, :] * signs).sum(dim=-1), dim=-1)
        want = (best[..., None] >> torch.arange(k)) & 1
        assert bits.shape == x.shape[:-1] + (k,) and torch.equal(bits, want.to(torch.uint8))


@pytest.fixture
def tracer():
    tr = tracing.l1_tracer
    tr.take()
    tr.enabled = True
    yield tr
    tr.enabled = False
    tr.take()


def test_one_span_a_call_and_its_counts(tracer):
    cfgs = _placed(["polar-crc11-repetition", "rm-6", "polar-crc6-repetition-wm0"], 4)
    grid, _ = _grid(cfgs, 4, seed=3)
    pucch_f2.process_all(grid, cfgs)
    pucch_f2.process(grid, cfgs[1])
    assert pucch_f2.process_all(grid, []) == []
    reading = tracer.take()
    assert [s.name for s in reading.spans] == ["pucch.f2", "pucch.f2"]
    assert [s.args for s in reading.spans] == [
        {"occasions": 3, "polar": 2, "short_block": 1, "kernel_occasions": 0},
        {"occasions": 1, "polar": 0, "short_block": 1, "kernel_occasions": 0}]


@pytest.fixture(scope="module")
def ul_tti():
    """``portbench/tests/small_ul_tti.py``'s slot: 2 PUSCH UEs, 4 F1, a
    polar and a Reed-Muller F2, a PRACH occasion, on the CPU."""
    from portbench.harness import cells
    from portbench.tests import small_ul_tti

    spec = small_ul_tti.spec()
    return cells.entry(spec.config, spec.traffic, 2147483647 + 20, torch.device("cpu"))


@pytest.mark.parametrize("pusch", [True, False], ids=["in-slot-program", "without-pusch"])
def test_the_fapi_entry_calls_process_all_once_a_slot(monkeypatch, ul_tti, pusch):
    """With ``ul_slot.process_slot`` (two PUSCH grants) and without it,
    ``UpperPhy.process_ul_tti`` receives its F2 occasions in one call and
    its F1 occasions in one ``format1_detect_all`` call, and hands
    ``process_slot`` no PUCCH occasion; the F2 indications carry the sent
    bits."""
    calls, f1_calls, slot_calls = [], [], []
    inner, f1_inner, slot_inner = (pucch_f2.process_all, pucch.format1_detect_all,
                                   ul_slot.process_slot)

    def counted(grid, cfgs):
        calls.append(len(cfgs))
        return inner(grid, cfgs)

    def f1_counted(grid, cfgs):
        f1_calls.append(len(cfgs))
        return f1_inner(grid, cfgs)

    def slot_counted(grid, pdus, *pucch_cfgs):
        slot_calls.append(pucch_cfgs)
        return slot_inner(grid, pdus, *pucch_cfgs)

    monkeypatch.setattr(pucch_f2, "process_all", counted)
    monkeypatch.setattr(pucch, "format1_detect_all", f1_counted)
    monkeypatch.setattr(ul_slot, "process_slot", slot_counted)
    entry = ul_tti
    n_f1 = sum(isinstance(p.config, pucch.PucchFormat1Config) for p in entry.requests[0].pucch)
    assert n_f1 > 1
    phy = upper_phy.UpperPhy(upper_phy.UpperPhyConfig(nof_ports=4, nof_grid_sc=entry.nsc,
                                                      device="cpu"))
    for unit in range(2):
        req = entry.requests[unit]
        if not pusch:
            req = dataclasses.replace(req, pusch=[])
        calls.clear()
        f1_calls.clear()
        slot_calls.clear()
        res = phy.process_ul_tti(req, entry.grid[unit], entry.prach_fd[unit])
        assert calls == [len(entry.f2)]
        assert f1_calls == [n_f1]
        assert slot_calls == ([()] if pusch else [])
        f2_ind = res.uci[-len(entry.f2):]
        for ind, bits in zip(f2_ind, entry.f2_bits):
            assert ind.valid
            np.testing.assert_array_equal(ind.uci_bits, bits[unit].numpy())


# ---- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("snr_db", [SNR_DB, -3.0], ids=["10dB", "-3dB"])
@pytest.mark.parametrize("ports", [1, 2, 4])
def test_k6_is_the_plain_version(cuda_device, tracer, ports, snr_db):  # noqa: F811
    cfgs = _placed(list(CASES), ports)
    grid, _ = _grid(cfgs, ports, seed=20 + ports, snr_db=snr_db)
    want = rx.receive_plain(grid, cfgs)
    before = rx.receive.launches
    got = rx.receive(grid.to(cuda_device), cfgs)
    torch.cuda.synchronize()
    assert rx.receive.launches == before + 1
    bits, ok, snr = (t.cpu() for t in got)
    assert torch.equal(bits, want[0]) and torch.equal(ok, want[1])
    assert float((snr - want[2]).abs().max()) <= 1e-4
    tracer.take()
    outs = pucch_f2.process_all(grid.to(cuda_device), cfgs)
    assert rx.receive.launches == before + 2
    for (b, o, s), cfg, i in zip(outs, cfgs, range(len(cfgs))):
        assert torch.equal(b.cpu(), want[0][i, : cfg.nof_uci_bits]) and bool(o) == bool(want[1][i])
    (span,) = tracer.take().spans
    assert span.args["kernel_occasions"] == span.args["occasions"] == len(cfgs)
