"""The heterogeneous multi-UE uplink slot (phy/ul_slot.py) and the PUSCH
paths under it, against the JAX package on a small carrier: 24 PRB, 2
ports, four rank-1 grants in three configs (two 64QAM grants sharing one,
a QPSK MCS-0 grant with repetition, a 16QAM grant), then a second slot
that retransmits UE 1 at rv 2 with its HARQ buffer from the first
(tests/torch_parity.py builds both slots with the port's transmitter).

Tolerances:
* transmitted grids: 1e-5 x RMS (the same float32 mapping and precoding);
* TB bits and CRC verdicts: exact (and the expected verdicts: every grant
  passes but UE 1's rv 0, which passes once combined with its rv 2);
* noise_var: rtol 1e-4; snr_db: atol 1e-3;
* HARQ buffers: within +-1 per LLR that went into them: the int8 LLRs of
  a float front end are within +-1 of the reference's (tests/
  test_torch_slice.py), and a buffer position adds one LLR per
  transmission and repetition, so within +-1 x that count, and equal on
  >= 99.9 % of positions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (RETX_UE, SLOT_PLAN, SLOT_PORTS, SLOT_PRB, slot_config, small_slot, to_np,
                          to_torch)

from srsran_project_tpu.ops.modulation import Modulation as JModulation
from srsran_project_tpu.ops.modulation import demap_soft as jdemap
from srsran_project_tpu.ops.modulation import map_bits as jmap
from srsran_project_tpu.ops.modulation.evm import evm as jevm
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu.phy import ul_slot as jul
from srsran_project_tpu.phy.allocation import Allocation as JAllocation
from srsran_project_tpu_torch.ops.ldpc import rate_match as trm
from srsran_project_tpu_torch.ops.modulation import Modulation, demap_soft, map_bits
from srsran_project_tpu_torch.ops.modulation.evm import evm
from srsran_project_tpu_torch.phy import pusch as tpusch
from srsran_project_tpu_torch.phy import ul_slot as tul


def _jax_pdus(cfgs, harq=None):
    pdus = []
    for i, ((rnti, rb0, nrb, mcs), cfg) in enumerate(zip(SLOT_PLAN, cfgs)):
        jcfg = slot_config(jpusch, JModulation, nrb, mcs, rb0, cfg.rv)
        buf = None if harq is None or i != RETX_UE else jnp.asarray(harq)
        pdus.append(jul.UlSlotPdu(rnti=rnti, first_rb=rb0, config=jcfg, harq_buffer=buf))
    return pdus


def _repeats(cfg) -> int:
    """LLRs summed per buffer position of one transmission: 1, or 2 and
    more where E exceeds the usable buffer."""
    seg = cfg.sch.seg
    n_cb = cfg.sch.n_cb or seg.full_codeword_bits
    usable = sum(ln for _, ln in trm._valid_runs(seg.base_graph, seg.lifting_size,
                                                   seg.nof_payload_bits_per_cb, cfg.rv, n_cb))
    return -(-max(cfg.sch.cb_e_bits) // usable)


@pytest.fixture(scope="module")
def slots():
    """Both packages through both slots."""
    out = []
    harq_j = harq_t = None
    for rv, noise_seed in ((None, 0), (2, 1)):
        cfgs, tbs, grid = small_slot(rv_retx=rv, noise_seed=noise_seed)
        jpdus = _jax_pdus(cfgs, harq_j)
        res_j, _, _ = jul.process_slot(jnp.asarray(to_np(grid)), jpdus)
        tpdus = [tul.UlSlotPdu.from_reference(p, device="cpu") for p in jpdus]
        if harq_t is not None:  # the port's own buffer, not the reference's
            tpdus[RETX_UE].harq_buffer = harq_t
        res_t, _, _ = tul.process_slot(grid, tpdus)
        harq_j = np.asarray(res_j[RETX_UE]["harq_buffer"])
        harq_t = res_t[RETX_UE]["harq_buffer"]
        out.append(dict(cfgs=cfgs, tbs=tbs, grid=grid, jpdus=jpdus, tpdus=tpdus,
                        res_j=[{k: np.asarray(v) for k, v in r.items()} for r in res_j],
                        res_t=[{k: to_np(v) for k, v in r.items()} for r in res_t]))
    return out


def test_pdu_and_config_from_reference(slots):
    s = slots[1]
    for jp, tp, cfg in zip(s["jpdus"], s["tpdus"], s["cfgs"]):
        assert tp.config == cfg and (tp.rnti, tp.first_rb) == (jp.rnti, jp.first_rb)
        assert (tp.config.sch.cb_e_bits, tp.config.sch.n_cb) == (jp.config.sch.cb_e_bits,
                                                                 jp.config.sch.n_cb)
    assert s["jpdus"][RETX_UE].harq_buffer is not None


@pytest.mark.parametrize("slot", [0, 1], ids=["new-data", "retransmission"])
def test_process_slot_matches_reference(slots, slot):
    s = slots[slot]
    want_ok = [True] * len(SLOT_PLAN)
    want_ok[RETX_UE] = slot == 1
    for i, (rj, rt, tb) in enumerate(zip(s["res_j"], s["res_t"], s["tbs"])):
        assert bool(rt["tb_crc_ok"]) == bool(rj["tb_crc_ok"]) == want_ok[i], i
        np.testing.assert_array_equal(rt["tb_bits"], rj["tb_bits"])
        if want_ok[i]:
            np.testing.assert_array_equal(rt["tb_bits"], tb)
        np.testing.assert_allclose(rt["noise_var"], rj["noise_var"], rtol=1e-4)
        np.testing.assert_allclose(rt["snr_db"], rj["snr_db"], rtol=0, atol=1e-3)
        bound = _repeats(s["cfgs"][i]) * (2 if (slot == 1 and i == RETX_UE) else 1)
        d = np.abs(rt["harq_buffer"].astype(np.int32) - rj["harq_buffer"].astype(np.int32))
        assert d.max() <= bound and (d == 0).mean() >= 0.999, (i, d.max())


def test_slot_has_repetition_and_three_code_groups(slots):
    cfgs = slots[0]["cfgs"]
    assert [_repeats(c) > 1 for c in cfgs] == [False, False, True, False]
    keys = {(c.sch.seg.base_graph, c.sch.seg.lifting_size, c.sch.n_cb) for c in cfgs}
    assert len(keys) == 3


def test_transmit_matches_reference(slots):
    for (rnti, _rb0, _nrb, _mcs), cfg, jp, tb in zip(SLOT_PLAN, slots[0]["cfgs"],
                                                     slots[0]["jpdus"], slots[0]["tbs"]):
        w = np.eye(1, SLOT_PORTS, k=1, dtype=np.complex64)
        want = np.asarray(jpusch.transmit(jnp.asarray(tb), jnp.uint32(rnti), jp.config,
                                          precoding=jnp.asarray(w)))
        got = to_np(tpusch.transmit(to_torch(tb), torch.tensor(rnti), cfg, precoding=to_torch(w)))
        assert got.shape == want.shape
        rms = float(np.sqrt(np.mean(np.abs(want) ** 2)))
        assert np.abs(got - want).max() <= 1e-5 * rms


def test_process_and_process_multi_match_reference(slots):
    """The single-grant and equal-config batched entry points on the
    retransmission slot: UE 1 alone with its buffer (process), UEs 0-1
    with UE 0's buffer zero (process_multi)."""
    s = slots[1]
    grid_t = s["grid"]
    grid_j = jnp.asarray(to_np(grid_t))
    cfg = s["cfgs"][RETX_UE]
    rnti, rb0 = SLOT_PLAN[RETX_UE][:2]
    win = slice(rb0 * 12, rb0 * 12 + cfg.nof_grid_sc)
    harq = s["jpdus"][RETX_UE].harq_buffer
    want = jpusch.process(grid_j[:, :, win], jnp.uint32(rnti), s["jpdus"][RETX_UE].config, harq)
    got = tpusch.process(grid_t[None, :, :, win], torch.tensor([rnti]), cfg,
                         to_torch(harq)[None])
    assert bool(got["tb_crc_ok"][0]) == bool(want["tb_crc_ok"]) is True
    np.testing.assert_array_equal(to_np(got["tb_bits"][0]), s["tbs"][RETX_UE])
    np.testing.assert_allclose(to_np(got["noise_var"][0]), np.asarray(want["noise_var"]),
                               rtol=1e-4)

    jcfg = dataclasses.replace(s["jpdus"][0].config, rv=2)
    tcfg = tpusch.PuschConfig.from_reference(jcfg)
    rntis = [SLOT_PLAN[0][0], rnti]
    rbs = [SLOT_PLAN[0][1], rb0]
    bufs = np.stack([np.zeros_like(np.asarray(harq)), np.asarray(harq)])
    want = jpusch.process_multi(grid_j, jnp.asarray(rntis, jnp.uint32), rbs, jcfg,
                                jnp.asarray(bufs))
    got = tpusch.process_multi(grid_t, rntis, rbs, tcfg, to_torch(bufs))
    np.testing.assert_array_equal(to_np(got["tb_crc_ok"]), np.asarray(want["tb_crc_ok"]))
    np.testing.assert_array_equal(to_np(got["tb_bits"]), np.asarray(want["tb_bits"]))
    assert bool(got["tb_crc_ok"][1])
    np.testing.assert_allclose(to_np(got["snr_db"]), np.asarray(want["snr_db"]), atol=1e-3)


def test_qpsk_map_demap_evm_match_reference():
    """QPSK symbols exact; LLRs and EVM at rtol 1e-6 (one float32
    multiply and divide each)."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=(3, 64), dtype=np.uint8)
    want = np.asarray(jmap(jnp.asarray(bits), JModulation.QPSK))
    np.testing.assert_array_equal(to_np(map_bits(to_torch(bits), Modulation.QPSK)), want)
    sym = (rng.standard_normal((3, 32)) + 1j * rng.standard_normal((3, 32))).astype(np.complex64)
    nv = (0.1 + rng.random((3, 32))).astype(np.float32)
    np.testing.assert_allclose(to_np(demap_soft(to_torch(sym), to_torch(nv), Modulation.QPSK)),
                               np.asarray(jdemap(jnp.asarray(sym), jnp.asarray(nv),
                                                 JModulation.QPSK)), rtol=1e-6)
    np.testing.assert_allclose(to_np(evm(to_torch(sym), Modulation.QPSK)),
                               np.asarray(jevm(jnp.asarray(sym), JModulation.QPSK)), rtol=1e-6)


def test_chip_smoke_slot_rates_are_the_mcs_table():
    """chip_smoke.py's uplink slot uses MCS 20 and MCS 0 of the 64QAM table."""
    import chip_smoke
    from srsran_project_tpu.ran import tbs as tbs_mod

    (_, _, qm_a, rate_a, _), (_, _, qm_b, rate_b, _), (_, _, qm_c, rate_c, _) = \
        chip_smoke.UL_GROUPS
    assert (qm_a, rate_a) == (8, 948.0 / 1024.0)
    assert (qm_b, rate_b) == tbs_mod.mcs_to_qm_rate(20, "qam64")
    assert (qm_c, rate_c) == tbs_mod.mcs_to_qm_rate(0, "qam64")


@pytest.mark.parametrize("atten_db", [17.0, 19.0, 21.0])
def test_chip_smoke_retransmission_pair(atten_db):
    """chip_smoke.py's UE 3 at its own geometry (24 PRB, 4 ports, 64QAM),
    seed, channel and noise, attenuated across the range its docstring
    states (19 dB is the one chip_smoke uses): rv 0 fails its CRC and
    rv 0 + rv 2 passes, in the JAX package and in the port (CPU), with
    equal TB bits once it passes and HARQ buffers within +-2 (two
    transmissions of +-1 LLRs)."""
    import chip_smoke

    assert chip_smoke.UL_RETX_ATTEN_DB == 19.0
    ues, noise = chip_smoke.ul_slot_plan(atten_db=atten_db)
    ue = ues[chip_smoke.UL_RETX_UE]
    sc0 = 12 * ue["first_rb"]
    harq_j = harq_t = None
    for p, rv in enumerate((0, 2)):
        tcfg = chip_smoke.ul_config(*ue["shape"], ue["first_rb"], rv)
        kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
        jcfg = jpusch.PuschConfig(**{**kw, "modulation": JModulation(int(tcfg.modulation)),
                                     "alloc": JAllocation(**dataclasses.asdict(tcfg.alloc))})
        rx = noise[p][:, :, sc0 : sc0 + tcfg.nof_grid_sc]
        grid_j = np.asarray(jpusch.transmit(jnp.asarray(ue["tb"]), jnp.uint32(ue["rnti"]), jcfg,
                                            precoding=jnp.asarray(ue["channel"]))) + rx
        want = jpusch.process(jnp.asarray(grid_j), jnp.uint32(ue["rnti"]), jcfg, harq_j)
        grid_t = tpusch.transmit(to_torch(ue["tb"]), torch.tensor(ue["rnti"]), tcfg,
                                 precoding=to_torch(ue["channel"])) + to_torch(rx)
        got = tpusch.process(grid_t[None], torch.tensor([ue["rnti"]]), tcfg, harq_t)
        harq_j, harq_t = want["harq_buffer"], got["harq_buffer"]
        assert bool(got["tb_crc_ok"][0]) == bool(want["tb_crc_ok"]) == (rv == 2)
        d = np.abs(to_np(harq_t[0]).astype(np.int32) - np.asarray(harq_j).astype(np.int32))
        assert d.max() <= 2
    np.testing.assert_array_equal(to_np(got["tb_bits"][0]), ue["tb"])


def test_pucch_in_the_slot_raises(slots):
    """PUCCH occasions in the slot are decoded, beside the PUSCH grants:
    a 1-symbol F0 (1 HARQ bit) and a 1-symbol F2 (6 UCI bits) on symbol 0,
    which the grants leave free, of the first slot's grid.  The occasions
    return the sent value and bits above the DTX threshold, the tuple grows
    to four lists with F2, and the PUSCH results stay the same."""
    from srsran_project_tpu_torch.phy import pucch as tpucch
    from srsran_project_tpu_torch.phy import pucch_f2 as tf2

    s = slots[0]
    f0 = tpucch.PucchFormat0Config(prb=5, start_symbol=0, nof_symbols=1, initial_cyclic_shift=2,
                                   n_id=9, nof_grid_sc=SLOT_PRB * 12)
    f2 = tf2.PucchFormat2Config(rb_start=10, rb_count=2, start_symbol=0, nof_symbols=1,
                                nof_uci_bits=6, rnti=0x4620, nof_rx_ports=SLOT_PORTS,
                                nof_grid_sc=SLOT_PRB * 12)
    bits = np.array([1, 0, 0, 1, 1, 0], np.uint8)
    w = torch.tensor([0.8, 0.6j], dtype=torch.complex64)[:, None]
    grid = s["grid"].clone()
    grid[:, 0, 60:72] += w * tpucch.format0_generate(f0, 1, device="cpu")[0]
    grid[:, 0] += w * tf2.generate(f2, bits, device="cpu")[0]
    res, f1_out, f0_out, f2_out = tul.process_slot(grid, s["tpdus"], (), (f0,), (f2,))
    assert f1_out == [] and len(f0_out) == len(f2_out) == 1
    assert int(f0_out[0][0]) == 1 and float(f0_out[0][1]) > tpucch.F0_DTX_THRESHOLD
    assert bool(f2_out[0][1])
    np.testing.assert_array_equal(to_np(f2_out[0][0]), bits)
    for r, want in zip(res, s["res_t"]):
        assert set(r) == set(want)
        np.testing.assert_array_equal(to_np(r["tb_bits"]), want["tb_bits"])
        assert bool(r["tb_crc_ok"]) == bool(want["tb_crc_ok"])
