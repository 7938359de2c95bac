"""The whole uplink slot (phy/ul_slot.process_slot) with UCI on PUSCH,
ranks 1-4, MMSE and ZF, and PUCCH F0/F1/F2 occasions, against the JAX
package: chip_smoke.py's path 4 scaled down to a 52-PRB carrier with 4 RX
ports, one grant per group (the same UCI sizes), one more grant at rank 3
with ZF, and one occasion of each PUCCH format.  The grid is built by the
port's transmitters (``pusch.transmit`` with UCI, ``pucch.format*_generate``,
``pucch_f2.generate``) plus AWGN at 30 dB, and both packages decode it.

Tolerances:
* TB bits, CRC verdicts, UCI bits and _ok flags, PUCCH values and bits:
  exact (and the sent ones);
* noise_var rtol 1e-4, snr_db atol 1e-3 (as tests/test_torch_ul_slot.py);
* HARQ buffers: within +-1 per LLR and equal on >= 99.9 % of positions
  (the int8 LLRs of a float front end, ROADMAP Q3);
* PUCCH metrics (F0 metric, F1 rho) rtol 1e-4, F2 snr_db atol 1e-3: float32
  correlations summed in another order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np, to_torch

from srsran_project_tpu.models import cell as jcell
from srsran_project_tpu.ops.modulation import Modulation as JModulation
from srsran_project_tpu.phy import pucch as jpucch
from srsran_project_tpu.phy import pucch_f2 as jf2
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu.phy import ul_slot as jul
from srsran_project_tpu_torch.phy import pucch as tpucch
from srsran_project_tpu_torch.phy import pucch_f2 as tf2
from srsran_project_tpu_torch.phy import pusch as tpusch
from srsran_project_tpu_torch.phy import ul_slot as tul

NOF_PRB = 52
PORTS = 4
SNR_DB = 30.0
# (rnti, first_rb, rb_count, layers, qm, rate, equalizer, (ACK, CSI-1, CSI-2 bits)):
# path 4's groups A-C, one grant each, and a rank-3 ZF grant.
GRANTS = [
    (0x4601, 0, 12, 4, 8, 948 / 1024, "mmse", (2, 40, 400)),
    (0x4602, 12, 8, 2, 6, 567 / 1024, "mmse", (11, 19, 0)),
    (0x4603, 20, 4, 1, 2, 120 / 1024, "mmse", (1, 0, 0)),
    (0x4604, 24, 8, 3, 4, 490 / 1024, "zf", (3, 12, 0)),
]
F2 = dict(rb_start=40, rb_count=2, start_symbol=12, nof_symbols=2, nof_uci_bits=22, rnti=0x4611,
          n_id=7, n_id0=3, nof_rx_ports=PORTS, nof_grid_sc=NOF_PRB * 12)
F1 = dict(prb=44, start_symbol=0, nof_symbols=14, initial_cyclic_shift=6, occ_index=0, n_id=11,
          nof_harq_bits=2, nof_grid_sc=NOF_PRB * 12, second_hop_prb=51)
F0 = dict(prb=46, start_symbol=12, nof_symbols=2, initial_cyclic_shift=0, n_id=11,
          nof_harq_bits=1, sr_opportunity=True, nof_grid_sc=NOF_PRB * 12)


def grant_config(rb0, nrb, layers, qm, rate, equalizer, uci, rv=0):
    """The JAX package's PuschConfig of one grant (compact window at rb0)."""
    pc = jcell.CellConfig(nof_rb=nrb, nof_ports=PORTS, nof_layers=layers,
                          modulation=JModulation(qm), target_code_rate=rate).pusch_cfg
    return dataclasses.replace(pc, alloc=dataclasses.replace(pc.alloc, crb_start=rb0), rv=rv,
                               equalizer=equalizer, uci=jpusch.UciOnPuschConfig(*uci))


def _channel(rng, rows):
    h = rng.standard_normal((rows, PORTS)) + 1j * rng.standard_normal((rows, PORTS))
    if rows > 1:
        return np.linalg.qr(h.T)[0].T.astype(np.complex64)  # orthonormal rows
    return (h / np.linalg.norm(h)).astype(np.complex64)


def build_slot(seed=0):
    """JAX configs, payloads and the received (4, 14, 624) grid."""
    rng = np.random.default_rng(seed)
    grid = torch.zeros((PORTS, 14, NOF_PRB * 12), dtype=torch.complex64)
    ues = []
    for rnti, rb0, nrb, layers, qm, rate, eq, uci in GRANTS:
        jcfg = grant_config(rb0, nrb, layers, qm, rate, eq, uci)
        tcfg = tpusch.PuschConfig.from_reference(jcfg)
        tb = rng.integers(0, 2, size=(tcfg.tbs,), dtype=np.uint8)
        parts = [rng.integers(0, 2, size=(n,), dtype=np.uint8) if n else None for n in uci]
        sub = tpusch.transmit(to_torch(tb), torch.tensor(rnti), tcfg,
                              *[None if p is None else to_torch(p) for p in parts],
                              precoding=to_torch(_channel(rng, layers)))
        grid[:, :, rb0 * 12 : rb0 * 12 + tcfg.nof_grid_sc] += sub
        ues.append(dict(rnti=rnti, rb0=rb0, jcfg=jcfg, tcfg=tcfg, tb=tb, uci=parts))

    f2_bits = rng.integers(0, 2, size=(F2["nof_uci_bits"],), dtype=np.uint8)
    f2_grid = tf2.generate(tf2.PucchFormat2Config(**F2), f2_bits, device="cpu")
    grid += to_torch(_channel(rng, 1))[0][:, None, None] * f2_grid
    f1_cfg = tpucch.PucchFormat1Config(**F1)
    f1_bits = np.array([1, 0], np.uint8)
    f1_sig = tpucch.format1_generate(f1_cfg, f1_bits, device="cpu")
    h = to_torch(_channel(rng, 1))[0]
    for hop_syms, _d, _z, prb in tpucch._f1_hops(f1_cfg):
        for s in hop_syms:
            grid[:, s, prb * 12 : prb * 12 + 12] += h[:, None] * f1_sig[s]
    f0_cfg = tpucch.PucchFormat0Config(**F0)
    f0_sig = tpucch.format0_generate(f0_cfg, 1, sr=True, device="cpu")
    h = to_torch(_channel(rng, 1))[0]
    for i, s in enumerate(range(F0["start_symbol"], F0["start_symbol"] + F0["nof_symbols"])):
        grid[:, s, F0["prb"] * 12 : F0["prb"] * 12 + 12] += h[:, None] * f0_sig[i]

    sigma = np.sqrt(0.5 * 10 ** (-SNR_DB / 10))
    noise = (rng.standard_normal(grid.shape) + 1j * rng.standard_normal(grid.shape)) * sigma
    grid = grid + torch.from_numpy(noise.astype(np.complex64))
    sent = {"f2": f2_bits, "f1": f1_bits, "f0": 1 + 2}  # HARQ 1 with positive SR
    return ues, grid, sent


@pytest.fixture(scope="module")
def slot():
    ues, grid, sent = build_slot()
    jpdus = [jul.UlSlotPdu(rnti=u["rnti"], first_rb=u["rb0"], config=u["jcfg"]) for u in ues]
    jres = jul.process_slot(jnp.asarray(to_np(grid)), jpdus, (jpucch.PucchFormat1Config(**F1),),
                            (jpucch.PucchFormat0Config(**F0),), (jf2.PucchFormat2Config(**F2),))
    tpdus = [tul.UlSlotPdu.from_reference(p, device="cpu") for p in jpdus]
    tres = tul.process_slot(grid, tpdus, (tpucch.PucchFormat1Config(**F1),),
                            (tpucch.PucchFormat0Config(**F0),), (tf2.PucchFormat2Config(**F2),))
    return dict(ues=ues, grid=grid, sent=sent, jpdus=jpdus, tpdus=tpdus, jres=jres, tres=tres)


def test_slot_shape_and_groups(slot):
    assert len(slot["jres"]) == len(slot["tres"]) == 4
    assert [len(x) for x in slot["tres"][1:]] == [1, 1, 1]
    assert len({p.config for p in slot["tpdus"]}) == len(GRANTS)
    segmented = slot["ues"][0]["tcfg"].uci_mux.g_csi2
    assert segmented >= 1088


def test_pusch_results_match_reference(slot):
    keys = ("tb_bits", "tb_crc_ok", "harq_buffer", "noise_var", "snr_db", "harq_ack_bits",
            "harq_ack_ok", "csi1_bits", "csi1_ok", "csi2_bits", "csi2_ok")
    for u, rj, rt in zip(slot["ues"], slot["jres"][0], slot["tres"][0]):
        assert set(rt) == set(rj) and set(rt) <= set(keys)
        assert bool(rt["tb_crc_ok"]) and bool(rj["tb_crc_ok"])
        np.testing.assert_array_equal(to_np(rt["tb_bits"]), u["tb"])
        np.testing.assert_array_equal(to_np(rt["tb_bits"]), np.asarray(rj["tb_bits"]))
        for part, name in zip(u["uci"], ("harq_ack", "csi1", "csi2")):
            if part is None:
                continue
            assert bool(rt[f"{name}_ok"]) and bool(rj[f"{name}_ok"]), name
            np.testing.assert_array_equal(to_np(rt[f"{name}_bits"]), part)
            np.testing.assert_array_equal(to_np(rt[f"{name}_bits"]), np.asarray(rj[f"{name}_bits"]))
        np.testing.assert_allclose(to_np(rt["noise_var"]), np.asarray(rj["noise_var"]), rtol=1e-4)
        np.testing.assert_allclose(to_np(rt["snr_db"]), np.asarray(rj["snr_db"]), atol=1e-3)
        d = np.abs(to_np(rt["harq_buffer"]).astype(np.int32)
                   - np.asarray(rj["harq_buffer"]).astype(np.int32))
        assert d.max() <= 1 and (d == 0).mean() >= 0.999


def test_pucch_results_match_reference(slot):
    (_, f1_j, f0_j, f2_j), (_, f1_t, f0_t, f2_t) = slot["jres"], slot["tres"]
    sent = slot["sent"]
    bits, rho = f1_t[0]
    np.testing.assert_array_equal(to_np(bits), sent["f1"])
    np.testing.assert_array_equal(to_np(bits), np.asarray(f1_j[0][0]))
    assert float(rho) > tpucch.F1_DTX_THRESHOLD
    np.testing.assert_allclose(float(rho), float(f1_j[0][1]), rtol=1e-4)
    val, metric = f0_t[0]
    assert int(val) == int(f0_j[0][0]) == sent["f0"]
    assert float(metric) > tpucch.F0_DTX_THRESHOLD
    np.testing.assert_allclose(float(metric), float(f0_j[0][1]), rtol=1e-4)
    bits, ok, snr_db = f2_t[0]
    assert bool(ok) and bool(f2_j[0][1])
    np.testing.assert_array_equal(to_np(bits), sent["f2"])
    np.testing.assert_array_equal(to_np(bits), np.asarray(f2_j[0][0]))
    np.testing.assert_allclose(float(snr_db), float(f2_j[0][2]), atol=1e-3)
