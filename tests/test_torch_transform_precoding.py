"""Transform precoding (DFT-s-OFDM, ROADMAP Q1.8.5) and BPSK / pi/2-BPSK
(Q1.8.1) against the JAX package:

* ``is_valid_nof_prb``: equal on 1-275 PRB;
* precode / deprecode: within 1e-6 x RMS; the deprecoded noise variance
  within rtol 1e-6;
* the low-PAPR DM-RS: ``_estimate_constants`` equal, the transmitted
  grid within 1e-6 x RMS;
* BPSK and pi/2-BPSK map (and QPSK beside them) and soft demap within
  1e-6 (demap relative to max(1, |LLR|)); the EVM within 1e-6;
* ``pusch.process`` with transform precoding, pi/2-BPSK, QPSK and 16QAM
  (the pi/2-BPSK grant on 24 PRB, 4 RX ports): int8 LLRs +-1 and
  >= 99.9 % equal, TB bits and CRC exact; a DFT-s grant in
  ``ul_slot.process_slot`` beside a CP-OFDM grant likewise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import grant_configs, loopback, process_parity, to_np, to_torch

from srsran_project_tpu.ops import transform_precoding as jtp
from srsran_project_tpu.ops.modulation import Modulation as JModulation
from srsran_project_tpu.ops.modulation import demapper as jdemap
from srsran_project_tpu.ops.modulation import evm as jevm
from srsran_project_tpu.ops.modulation import mapper as jmap
from srsran_project_tpu.phy import pdsch as jpdsch
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu.phy import ul_slot as jul
from srsran_project_tpu_torch.ops import transform_precoding as ttp
from srsran_project_tpu_torch.ops.modulation import Modulation
from srsran_project_tpu_torch.ops.modulation import demapper as tdemap
from srsran_project_tpu_torch.ops.modulation import evm as tevm
from srsran_project_tpu_torch.ops.modulation import mapper as tmap
from srsran_project_tpu_torch.phy import pdsch as tpdsch
from srsran_project_tpu_torch.phy import pusch as tpusch
from srsran_project_tpu_torch.phy import ul_slot as tul


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.abs(x) ** 2)))


def test_valid_nof_prb():
    assert [ttp.is_valid_nof_prb(n) for n in range(1, 276)] == [
        jtp.is_valid_nof_prb(n) for n in range(1, 276)]
    assert max(n for n in range(1, 274) if ttp.is_valid_nof_prb(n)) == 270


@pytest.mark.parametrize("nof_prb", [1, 3, 5, 24, 45])
def test_precode_deprecode(nof_prb):
    rng = np.random.default_rng(nof_prb)
    m = 12 * nof_prb
    x = (rng.standard_normal((3, m)) + 1j * rng.standard_normal((3, m))).astype(np.complex64)
    for jf, tf in ((jtp.precode, ttp.precode), (jtp.deprecode, ttp.deprecode)):
        a, b = np.asarray(jf(jnp.asarray(x))), to_np(tf(to_torch(x)))
        assert b.dtype == np.complex64 and np.abs(a - b).max() <= 1e-6 * _rms(a)
    back = to_np(ttp.deprecode(ttp.precode(to_torch(x))))
    assert np.abs(back - x).max() <= 1e-5 * _rms(x)
    nv = rng.uniform(0.01, 1.0, (3, m)).astype(np.float32)
    np.testing.assert_allclose(to_np(ttp.deprecode_noise_var(to_torch(nv))),
                               np.asarray(jtp.deprecode_noise_var(jnp.asarray(nv), m)),
                               rtol=1e-6)


@pytest.mark.parametrize("n_rs_id", [0, 17, 1007])
def test_low_papr_dmrs(n_rs_id):
    """The receiver's pilots and the transmitted grid of a DFT-s grant
    (1 layer, two CDM groups without data, DM-RS on symbols 2 and 11)."""
    jtx, jrx = grant_configs(nof_rb=6, crb_start=3, dmrs_symbols=(2, 11),
                             transform_precoding=True, n_rs_id=n_rs_id)
    trx = tpusch.PuschConfig.from_reference(jrx)
    for a, b in zip(tpusch._estimate_constants(trx), jpusch._estimate_constants(jrx)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    rng = np.random.default_rng(n_rs_id)
    ttx = tpdsch.PdschConfig.from_reference(jtx)
    tb = rng.integers(0, 2, size=(ttx.tbs,), dtype=np.uint8)
    w = np.eye(1, dtype=np.complex64)
    g_j = np.asarray(jpdsch.process(jnp.asarray(tb), jnp.uint32(0x4601), jnp.asarray(w), jtx))
    g_t = to_np(tpdsch.process(to_torch(tb), 0x4601, to_torch(w), ttx))
    assert np.abs(g_t - g_j).max() <= 1e-6 * _rms(g_j)


@pytest.mark.parametrize("mod", [Modulation.PI_2_BPSK, Modulation.BPSK, Modulation.QPSK])
def test_map_demap_evm(mod):
    rng = np.random.default_rng(int(mod))
    qm = tmap.bits_per_symbol(mod)
    bits = rng.integers(0, 2, size=(2, 30 * qm), dtype=np.uint8)
    jm = JModulation(int(mod))
    s_j = np.asarray(jmap.map_bits(jnp.asarray(bits), jm))
    s_t = to_np(tmap.map_bits(to_torch(bits), mod))
    assert s_t.dtype == np.complex64
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-6)
    y = (s_j + 0.3 * (rng.standard_normal(s_j.shape) + 1j * rng.standard_normal(s_j.shape))
         ).astype(np.complex64)
    nv = rng.uniform(0.05, 0.5, y.shape).astype(np.float32)
    l_j = np.asarray(jdemap.demap_soft(jnp.asarray(y), jnp.asarray(nv), jm))
    l_t = to_np(tdemap.demap_soft(to_torch(y), to_torch(nv), mod))
    assert l_t.shape == l_j.shape == (2, 30 * qm)
    assert (np.abs(l_t - l_j) <= 1e-6 * np.maximum(1.0, np.abs(l_j))).all()
    np.testing.assert_allclose(to_np(tevm.evm(to_torch(y), mod)),
                               np.asarray(jevm.evm(jnp.asarray(y), jm)), rtol=1e-6)


# name -> grant_configs arguments of a DFT-s grant.
GRANTS = {
    "pi2bpsk-24prb-4rx": dict(nof_rb=24, ports=4, modulation=0, rate=0.3, n_rs_id=17),
    "qpsk": dict(modulation=2, rate=0.4, dmrs_symbols=(2, 11), n_rs_id=5),
    "16qam-offset": dict(nof_rb=5, rb_start=2, sym_start=1, sym_count=13, n_rs_id=29),
}


@pytest.mark.parametrize("name", list(GRANTS))
def test_process(name):
    jtx, jrx = grant_configs(transform_precoding=True, **GRANTS[name])
    tb, rnti, rx = loopback(jtx, jrx, seed=6, snr_db=20.0)
    process_parity(jrx, rx, rnti, tb)


def test_process_slot_with_dft_s():
    """A pi/2-BPSK DFT-s grant (PRB 0-11) and a CP-OFDM 16QAM grant (PRB
    12-23) on one 24-PRB, 2-port grid: the port's slot against the
    reference's slot, TB bits and CRC exact, snr_db within 1e-3."""
    from torch_parity import unit_channel

    rng = np.random.default_rng(8)
    grid = np.zeros((2, 14, 24 * 12), np.complex64)
    specs = [(0, dict(modulation=0, rate=0.3, transform_precoding=True, n_rs_id=3)),
             (12, dict(modulation=4, rate=0.5))]
    tbs, jpdus, tpdus = [], [], []
    for i, (rb0, kw) in enumerate(specs):
        jtx, jrx = grant_configs(crb_start=rb0, **kw)
        ttx = tpdsch.PdschConfig.from_reference(jtx)
        tb = rng.integers(0, 2, size=(ttx.tbs,), dtype=np.uint8)
        rnti = 0x4621 + i
        grid[:, :, rb0 * 12 : rb0 * 12 + 144] += to_np(tpdsch.process(
            to_torch(tb), rnti, to_torch(unit_channel(rng, 1, 2)), ttx))
        tbs.append(tb)
        jpdus.append(jul.UlSlotPdu(rnti=rnti, first_rb=rb0, config=jrx))
        tpdus.append(tul.UlSlotPdu(rnti=rnti, first_rb=rb0,
                                   config=tpusch.PuschConfig.from_reference(jrx)))
    grid = (grid + 0.05 * (rng.standard_normal(grid.shape)
                           + 1j * rng.standard_normal(grid.shape))).astype(np.complex64)
    res_t = tul.process_slot(to_torch(grid), tpdus)[0]
    res_j = jul.process_slot(jnp.asarray(grid), jpdus)[0]
    for rt, rj, tb in zip(res_t, res_j, tbs):
        assert bool(rt["tb_crc_ok"]) and bool(rj["tb_crc_ok"])
        np.testing.assert_array_equal(to_np(rt["tb_bits"]), tb)
        np.testing.assert_array_equal(np.asarray(rj["tb_bits"]), tb)
        assert abs(float(rt["snr_db"]) - float(rj["snr_db"])) <= 1e-3


def test_transmit_keeps_the_reference_semantics():
    """``pusch.transmit`` builds its PdschConfig without PT-RS or transform
    precoding, as the reference does: a DFT-s config sent through it
    carries a CP-OFDM grid, equal to the reference's."""
    _, jrx = grant_configs(modulation=2, rate=0.4, transform_precoding=True, n_rs_id=5)
    trx = tpusch.PuschConfig.from_reference(jrx)
    rng = np.random.default_rng(9)
    tb = rng.integers(0, 2, size=(trx.tbs,), dtype=np.uint8)
    g_j = np.asarray(jpusch.transmit(jnp.asarray(tb), jnp.uint32(0x4601), jrx))
    g_t = to_np(tpusch.transmit(to_torch(tb), torch.tensor(0x4601), trx))
    assert np.abs(g_t - g_j).max() <= 1e-6 * _rms(g_j)
