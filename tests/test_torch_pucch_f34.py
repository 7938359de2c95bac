"""PUCCH formats 3 and 4 (phy/pucch_f34.py) against the JAX package: the
UE-side grid and the receiver, with hopping, additional DM-RS,
pi/2-BPSK and the format-4 OCC, on 1 and 2 ports of a 52-PRB grid.

Tolerances:
* ``generate``: within 1e-5 absolute (unit-modulus symbols through
  float32 DFTs of two libraries);
* ``process``: UCI bits and ``ok`` exact and equal to the payload sent;
  snr_db within 0.01 dB for format 3 (float32 estimates summed in another
  order) and 0.2 dB for format 4, whose channel estimate is the PRB's
  mean in the port (the reference's per-subcarrier estimate cannot
  separate two UEs multiplexed on the PRB: ``test_f4_two_ues``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import to_np, to_torch

from srsran_project_tpu.phy import pucch_f34 as jf34
from srsran_project_tpu_torch.phy import pucch_f34 as tf34

NSC = 52 * 12

# name -> the configs of the UEs sharing the grid (fields of
# PucchFormat34Config without the ports and grid width).
CASES = {
    "f3-hop-add-dmrs-polar": [dict(prb_start=2, nof_prb=16, start_symbol=0, nof_symbols=14,
                                   nof_uci_bits=100, rnti=0x4701, n_id=11, second_hop_prb=30,
                                   additional_dmrs=True)],
    "f3-pi2bpsk": [dict(prb_start=40, nof_prb=1, start_symbol=0, nof_symbols=14,
                        nof_uci_bits=12, rnti=0x4702, n_id=11, pi2_bpsk=True)],
    "f3-4sym-hop": [dict(prb_start=5, nof_prb=3, start_symbol=10, nof_symbols=4,
                         nof_uci_bits=7, rnti=0x4703, n_id=3, second_hop_prb=45)],
    "f3-short-block": [dict(prb_start=8, nof_prb=2, start_symbol=3, nof_symbols=10,
                            nof_uci_bits=11, rnti=0x4704, n_id=1000, slot_in_frame=7)],
    "f4-occ4": [dict(prb_start=50, nof_prb=1, start_symbol=0, nof_symbols=14,
                     nof_uci_bits=8, rnti=0x4705, n_id=11, occ_length=4, occ_index=2)],
    "f4-occ2-hop": [dict(prb_start=20, nof_prb=1, start_symbol=0, nof_symbols=12,
                         nof_uci_bits=5, rnti=0x4707, n_id=4, occ_length=2, occ_index=1,
                         second_hop_prb=21, additional_dmrs=True)],
}


def test_config_twin():
    kw = dict(CASES["f3-hop-add-dmrs-polar"][0], nof_rx_ports=2, nof_grid_sc=NSC)
    jc = jf34.PucchFormat34Config(**kw)
    tc = tf34.PucchFormat34Config.from_reference(jc)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for c in (tc, dataclasses.replace(tc, additional_dmrs=False),
              dataclasses.replace(tc, second_hop_prb=None, nof_symbols=4)):
        j = jf34.PucchFormat34Config(**dataclasses.asdict(c))
        assert (c.dmrs_symbols, c.data_symbols, c.nof_coded_bits, int(c.modulation)) == \
            (j.dmrs_symbols, j.data_symbols, j.nof_coded_bits, int(j.modulation))
        assert tf34._c_init(c) == jf34._c_init(j)


def _received(cases, ports: int, rng, snr_db: float = 20.0):
    """The UEs' configs (both packages), payloads and the received grid:
    each UE's reference-generated signal (held equal to the port's) through
    a random gain per port, plus AWGN."""
    grid = np.zeros((ports, 14, NSC), np.complex64)
    ues = []
    for kw in cases:
        jc = jf34.PucchFormat34Config(nof_rx_ports=ports, nof_grid_sc=NSC, **kw)
        tc = tf34.PucchFormat34Config.from_reference(jc)
        bits = rng.integers(0, 2, size=(jc.nof_uci_bits,), dtype=np.uint8)
        want = np.asarray(jf34.generate(jc, bits))
        got = to_np(tf34.generate(tc, bits, device="cpu"))
        assert got.shape == want.shape and np.abs(got - want).max() <= 1e-5
        h = (rng.standard_normal(ports) + 1j * rng.standard_normal(ports)) / np.sqrt(2)
        grid += (h[:, None, None] * want[None]).astype(np.complex64)
        ues.append((jc, tc, bits))
    sigma = np.sqrt(0.5 * 10 ** (-snr_db / 10))
    grid += (sigma * (rng.standard_normal(grid.shape) + 1j * rng.standard_normal(grid.shape))
             ).astype(np.complex64)
    return ues, grid


@pytest.mark.parametrize("ports", [1, 2])
@pytest.mark.parametrize("name", list(CASES))
def test_generate_and_process(name, ports):
    ues, grid = _received(CASES[name], ports, np.random.default_rng(len(name) + ports))
    for jc, tc, bits in ues:
        bj, okj, snrj = jf34.process(jnp.asarray(grid), jc)
        bt, okt, snrt = tf34.process(to_torch(grid), tc)
        np.testing.assert_array_equal(to_np(bt), np.asarray(bj))
        np.testing.assert_array_equal(to_np(bt), bits)
        assert bool(okt) == bool(okj) is True
        assert abs(float(snrt) - float(snrj)) <= (0.01 if jc.occ_length == 1 else 0.2)


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_f4_two_ues(ports):
    """Two format-4 UEs on one PRB, OCC length 4, indices 0 and 2: the
    port decodes both (its PRB-mean estimate cancels the other UE's
    DM-RS).  On 2 ports of this draw the reference's per-subcarrier
    estimate, biased by the other UE, loses a payload (ROADMAP Q3)."""
    two = [dict(CASES["f4-occ4"][0], occ_index=0, rnti=0x4706), CASES["f4-occ4"][0]]
    ues, grid = _received(two, ports, np.random.default_rng(40 + ports))
    ref_ok = []
    for jc, tc, bits in ues:
        bt, okt, _snr = tf34.process(to_torch(grid), tc)
        np.testing.assert_array_equal(to_np(bt), bits)
        assert bool(okt)
        bj, okj, _ = jf34.process(jnp.asarray(grid), jc)
        ref_ok.append(bool(okj) and np.array_equal(np.asarray(bj), bits))
    if ports == 2:
        assert not all(ref_ok)
