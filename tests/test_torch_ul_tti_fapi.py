"""The whole FAPI uplink slot through ``UpperPhy.process_ul_tti`` on a
small carrier, against the benchmark's plain reference
(``portbench/reference``, which follows TS 38.211/38.212 and imports
nothing of the port): a 52-PRB carrier with 4 receive ports holds 2 PUSCH
UEs, one F1 resource with 4 UEs code-multiplexed by cyclic shift and OCC
(one allocated and silent), one polar F2 (22 bits + CRC11), one
Reed-Muller F2 (6 bits) and a B4 PRACH occasion with 2 preambles
(``portbench/tests/small_ul_tti.py``; the benchmark's generator makes the
slot from a seed).

Tolerances:
* TB bits, CRC verdicts, UCI bits (where the reference detects the
  occasion), F1 DTX and F2 CRC verdicts, detected preambles and their
  delay bins: exact, and the sent ones;
* noise variance rtol 1e-4 and SINR atol 1e-3 dB, the multi-UE cell's
  limits (the same float32 front end on both sides);
* F1 rho and F2 SNR in dB atol 1e-4: the program despreads every shift by
  a DFT and every OCC by the table's rows at once, and smooths the F2
  channel; the reference correlates each
  UE's own sequence and takes the mean, so float32 sums run in another
  order (readings about 4e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.harness import cells
from portbench.reference import link
from portbench.tests import small_ul_tti
from srsran_project_tpu_torch.phy import pucch, upper_phy

CPU = torch.device("cpu")
SEED = 2147483647 + 19


@pytest.fixture(scope="module")
def slot():
    spec = small_ul_tti.spec()
    entry = cells.entry(spec.config, spec.traffic, SEED, CPU)
    units = list(range(entry.units))
    got = {u: [entry.dispatch(entry.generate(u, 0, None))] for u in units}
    return entry, got, entry.expected(units, link.FLOAT32), spec.limits


def test_the_fapi_slot_is_the_references(slot):
    entry, got, want, _ = slot
    numbers = entry.compare(got, want)
    assert {k: numbers[k] for k in ("crc_mismatch", "tb_bit_mismatch", "uci_bit_mismatch",
                                    "uci_verdict_mismatch", "prach_mismatch", "prach_ta_gap")
            } == dict.fromkeys(("crc_mismatch", "tb_bit_mismatch", "uci_bit_mismatch",
                                "uci_verdict_mismatch", "prach_mismatch", "prach_ta_gap"), 0)
    assert numbers["noise_var_gap"] <= 1e-4 and numbers["snr_db_gap"] <= 1e-3, numbers
    assert numbers["pucch_metric_gap"] <= 1e-4, numbers


def test_the_indications_carry_what_was_sent(slot):
    entry, got, _, _ = slot
    for u, (out,) in got.items():
        res, _outs = out
        assert [c.tb_crc_ok for c in res.crc] == [True] * len(entry.ues)
        f1 = res.uci[:len(entry.f1)]
        for i, ind in enumerate(f1):
            assert ind.valid == (i not in entry.dtx), (u, i, ind)
            if ind.valid:
                np.testing.assert_array_equal(ind.uci_bits, entry.f1_bits[i][u].numpy())
        for ind, bits in zip(res.uci[len(entry.f1):], entry.f2_bits, strict=True):
            assert ind.valid
            np.testing.assert_array_equal(ind.uci_bits, bits[u].numpy())
        assert sorted(r.preamble_index for r in res.rach) == sorted(entry.preambles[u].tolist())


def test_format1_detect_alone_misreads_the_multiplexed_resource(slot):
    """Each F1 occasion of the shared resource detected on its own
    (per-subcarrier channel estimate), as before the routing: the other
    UEs' energy pulls rho under the DTX threshold or flips bits."""
    entry, got, want, _ = slot
    wrong = 0
    for u in got:
        res, _ = got[u][0]
        grid = entry.grid[u]
        for j, pdu in enumerate(entry.requests[u].pucch[:len(entry.f1)]):
            bits, _llr, rho = pucch.format1_detect(grid, pdu.config)
            wb, wv, _wm = want[u][0]["uci"][j]
            valid = float(rho) > pucch.F1_DTX_THRESHOLD
            wrong += int(valid != wv or (wv and not np.array_equal(bits.numpy(), wb)))
            assert res.uci[j].valid == wv
    assert wrong >= len(got)


def _lone_f1_request(entry, unit: int, pusch: bool):
    """The unit's request with its F1 occasions moved onto PRBs of their
    own (one hop each, PRBs 36 to 39), with or without its PUSCH."""
    req = entry.requests[unit]
    f1 = [dataclasses.replace(p, config=dataclasses.replace(
        p.config, prb=36 + j, second_hop_prb=None)) for j, p in enumerate(req.pucch[:4])]
    return dataclasses.replace(req, pusch=req.pusch if pusch else [], pucch=f1, prach=[])


@pytest.mark.parametrize("pusch", [True, False], ids=["in-slot-program", "without-pusch"])
def test_lone_f1_occasions_keep_their_results(slot, pusch):
    """Occasions on resources of their own take ``format1_detect``, bit
    for bit, inside the slot program (two PUSCH grants) and without it."""
    entry = slot[0]
    grid = entry.grid[0]
    req = _lone_f1_request(entry, 0, pusch)
    phy = upper_phy.UpperPhy(upper_phy.UpperPhyConfig(nof_ports=4, nof_grid_sc=entry.nsc,
                                                      device="cpu"))
    res = phy.process_ul_tti(req, grid)
    assert len(res.uci) == 4
    for pdu, ind in zip(req.pucch, res.uci):
        bits, _llr, rho = pucch.format1_detect(grid, pdu.config)
        np.testing.assert_array_equal(ind.uci_bits, bits.numpy())
        assert ind.metric == float(rho)
        assert ind.valid == (float(rho) > pucch.F1_DTX_THRESHOLD)
    outs = pucch.format1_detect_all(grid, [p.config for p in req.pucch])
    for pdu, (bits, rho) in zip(req.pucch, outs):
        want = pucch.format1_detect(grid, pdu.config)
        assert torch.equal(bits, want[0]) and torch.equal(rho, want[2])


def test_the_batch_rho_on_noise_follows_its_beta_law():
    """The DTX statistic of a multiplexed occasion on noise alone: n = 4
    ports x 2 hops despread values, rho^2 ~ Beta(1, n - 1), mean 1/8, and
    F1_DTX_THRESHOLD crossed with probability (1 - 0.75^2)^7 = 0.30 %."""
    gen = torch.Generator().manual_seed(19)
    cfg = pucch.PucchFormat1Config(prb=0, start_symbol=0, nof_symbols=14,
                                   initial_cyclic_shift=0, occ_index=0, n_id=1,
                                   nof_grid_sc=24, second_hop_prb=1)
    cfgs = [dataclasses.replace(cfg, initial_cyclic_shift=s, occ_index=o)
            for s in (0, 3, 6, 9) for o in (0, 1)]
    rho2 = []
    for _ in range(250):
        grid = torch.randn((4, 14, 24), generator=gen, dtype=torch.complex64)
        rho2 += [float(r) ** 2 for _b, r in pucch.format1_detect_all(grid, cfgs)]
    rho2 = np.asarray(rho2)
    assert abs(rho2.mean() - 1 / 8) < 0.01  # 2000 draws: standard error 0.0025
    assert (rho2 > pucch.F1_DTX_THRESHOLD ** 2).sum() <= 16  # 6 expected



# (ports, second hop): n = ports x hops despread values, and the rate at
# which a silent multiplexed occasion reads as detected, (1 - 0.75^2)^(n - 1).
SILENT = [(4, None), (2, 1), (2, None), (1, 1), (1, None)]


@pytest.mark.parametrize("ports,hop", SILENT, ids=[f"{p}-ports-{'hop' if h else 'no-hop'}"
                                                    for p, h in SILENT])
def test_a_silent_multiplexed_occasion_at_fewer_ports(ports, hop):
    """What the slot path does with an allocated, silent F1 occasion that
    shares its resource with active ones, on 1 to 4 ports, with and without
    hopping: its rho follows the same Beta law, so F1_DTX_THRESHOLD reads it
    as detected (DTX read as ACK) at 8.4 % with n = 4, 44 % with n = 2 and
    always with n = 1 (rho = 1).  The active occasions stay right."""
    gen = torch.Generator().manual_seed(ports * 10 + (hop or 0))
    cfg = pucch.PucchFormat1Config(prb=0, start_symbol=0, nof_symbols=14,
                                   initial_cyclic_shift=0, occ_index=0, n_id=1,
                                   nof_harq_bits=2, nof_grid_sc=24, second_hop_prb=hop)
    active = [dataclasses.replace(cfg, initial_cyclic_shift=s) for s in (0, 3, 6)]
    silent = dataclasses.replace(cfg, initial_cyclic_shift=9)
    n = ports * (2 if hop is not None else 1)
    draws, read_as_ack = 400, 0
    for _ in range(draws):
        grid = 0.1 * torch.randn((ports, 14, 24), generator=gen, dtype=torch.complex64)
        sent = torch.randint(0, 2, (len(active), 2), generator=gen, dtype=torch.uint8)
        for c, bits in zip(active, sent):
            sig = pucch.format1_generate(c, bits.tolist(), device="cpu")
            h = torch.randn((ports,), generator=gen, dtype=torch.complex64)
            for hop_syms, _d, _z, prb in pucch._f1_hops(c):
                grid[:, hop_syms, prb * 12:(prb + 1) * 12] += h[:, None, None] * sig[hop_syms]
        *outs, (_bits, rho) = pucch.format1_detect_all(grid, active + [silent])
        for (bits, r), want in zip(outs, sent):
            assert float(r) > pucch.F1_DTX_THRESHOLD and torch.equal(bits, want)
        read_as_ack += float(rho) > pucch.F1_DTX_THRESHOLD
    rate = (1 - pucch.F1_DTX_THRESHOLD ** 2) ** (n - 1)
    # Binomial: within 4 standard errors of the law's rate.
    assert abs(read_as_ack / draws - rate) <= 4 * np.sqrt(rate * (1 - rate) / draws) + 1e-9
