"""The slice end to end: the PyTorch port against the JAX package on the
24-PRB 4x4 cell (256QAM r~0.926, 13 codeblocks in two E-groups, DFT 512),
identity precoding, RNTI 0x4601, AWGN at 30 dB drawn with numpy and added
to both sides' IQ.

Tolerances, each relative to the reference's RMS or value:
* DL codeword bits: exact.
* Grid and IQ: 1e-4 x RMS — the same float32 mapping and precoding; the
  two FFT libraries (pocketfft under torch, XLA's under JAX) round the
  last bits differently.
* Channel estimate: 1e-4 x RMS (the FFT difference carried through the
  LS / smoothing / interpolation chain).
* noise_var and post-equalization SINR: 1e-3 relative.
* int8 LLRs: within +-1 everywhere and equal on >= 99.9 % of positions —
  quantization rounds to integers, so a float difference in the last bit
  moves a value sitting at a rounding boundary by 1.
* TB bits and CRC verdicts: exact (and CRC-clean).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np, to_torch

from srsran_project_tpu.models import cell as jcell
from srsran_project_tpu.ops import ofdm as jofdm
from srsran_project_tpu.phy import pdsch as jpdsch
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu_torch.models import cell as tcell
from srsran_project_tpu_torch.ops import ofdm as tofdm
from srsran_project_tpu_torch.phy import pdsch as tpdsch
from srsran_project_tpu_torch.phy import pusch as tpusch

RNTI = 0x4601
SNR_DB = 30.0


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.abs(x) ** 2)))


@pytest.fixture(scope="module")
def run():
    """Both packages through the whole slot, with the intermediate stages."""
    jc = jcell.CellConfig(nof_rb=24, nof_ports=4, nof_layers=4)
    tc = tcell.CellConfig.from_reference(jc)
    rng = np.random.default_rng(0)
    tb = rng.integers(0, 2, size=(jc.tbs,), dtype=np.uint8)
    w = np.eye(4, dtype=np.complex64)
    r = {"jc": jc, "tc": tc, "tb": tb}

    # Reference (JAX, CPU).
    jrnti = jnp.uint32(RNTI)
    r["cw_j"] = np.asarray(jpdsch._bit_chain(jnp.asarray(tb), jrnti, jc.pdsch_cfg))
    r["grid_j"] = np.asarray(jpdsch._grid_chain(jnp.asarray(r["cw_j"]), jnp.asarray(w),
                                                jc.pdsch_cfg))
    iq_j = np.asarray(jcell.encode_slot_fused(jnp.asarray(tb), jrnti, jnp.asarray(w), jc))
    noise = ((rng.standard_normal(iq_j.shape) + 1j * rng.standard_normal(iq_j.shape))
             * np.sqrt(0.5 * np.mean(np.abs(iq_j) ** 2) * 10 ** (-SNR_DB / 10)))
    r["iq_j"], r["noise"] = iq_j, noise.astype(np.complex64)
    rx_j = jnp.asarray(iq_j + r["noise"])
    grid_rx = jofdm.demodulate_slot(rx_j, jc.nof_rb, jc.scs, jc.dft_size, jc.cp, 0,
                                    f_center_hz=jc.f_center_hz)
    _, h_j, nv_j, _ = jpusch._estimate_stage(grid_rx, jc.pusch_cfg)
    llr_j, _, sinr_j = jpusch._front_end(grid_rx, jrnti, jc.pusch_cfg)
    out_j = jcell.decode_slot_fused(rx_j, jrnti, jc)
    r.update(h_j=np.asarray(h_j), nv_j=float(nv_j), llr_j=np.asarray(llr_j),
             sinr_j=float(sinr_j), out_j={k: np.asarray(v) for k, v in out_j.items()})

    # Port (torch, CPU), same inputs.
    trnti = torch.tensor(RNTI)
    r["cw_t"] = to_np(tpdsch._bit_chain(to_torch(tb), trnti, tc.pdsch_cfg))
    r["grid_t"] = to_np(tpdsch._grid_chain(to_torch(r["cw_t"]), to_torch(w), tc.pdsch_cfg))
    iq_t = tcell.encode_slot(to_torch(tb), RNTI, to_torch(w), tc)
    r["iq_t"] = to_np(iq_t)
    rx_t = iq_t + to_torch(r["noise"])
    grid_t = tofdm.demodulate_slot(rx_t[None], tc.nof_rb, tc.scs, tc.dft_size, tc.cp, 0,
                                   f_center_hz=tc.f_center_hz)
    _, h_t, nv_t = tpusch._estimate_stage(grid_t, tc.pusch_cfg)
    llr_t, _, sinr_t = tpusch._front_end(grid_t, trnti[None], tc.pusch_cfg)
    out_t = tcell.decode_slot(rx_t, RNTI, tc)
    r.update(h_t=to_np(h_t[0]), nv_t=float(nv_t[0]), llr_t=to_np(llr_t[0]),
             sinr_t=float(sinr_t[0]), out_t={k: to_np(v) for k, v in out_t.items()},
             rx_t=rx_t)
    return r


def test_dl_codeword_exact(run):
    np.testing.assert_array_equal(run["cw_t"], run["cw_j"])


def test_grid_and_iq_close(run):
    for name in ("grid", "iq"):
        ref, got = run[f"{name}_j"], run[f"{name}_t"]
        assert got.shape == ref.shape and got.dtype == np.complex64
        assert np.abs(got - ref).max() <= 1e-4 * _rms(ref), name


def test_channel_estimate_close(run):
    ref, got = run["h_j"], run["h_t"]
    assert got.shape == ref.shape == (4, 24 * 12, 4)
    assert np.abs(got - ref).max() <= 1e-4 * _rms(ref)


def test_noise_and_sinr_close(run):
    out_j, out_t = run["out_j"], run["out_t"]
    assert abs(run["nv_t"] / run["nv_j"] - 1) <= 1e-3
    assert abs(float(out_t["noise_var"]) / float(out_j["noise_var"]) - 1) <= 1e-3
    assert abs(run["sinr_t"] / run["sinr_j"] - 1) <= 1e-3
    lin = lambda db: 10.0 ** (float(db) / 10.0)  # noqa: E731
    assert abs(lin(out_t["snr_db"]) / lin(out_j["snr_db"]) - 1) <= 1e-3


def test_llrs_within_one(run):
    ref, got = run["llr_j"].astype(np.int32), run["llr_t"].astype(np.int32)
    assert got.shape == ref.shape == (run["tc"].pusch_cfg.g_total,)
    assert np.abs(got - ref).max() <= 1
    assert np.mean(got == ref) >= 0.999


def test_tb_bits_and_crc_equal(run):
    out_j, out_t = run["out_j"], run["out_t"]
    np.testing.assert_array_equal(out_t["tb_bits"], out_j["tb_bits"])
    assert bool(out_t["tb_crc_ok"]) == bool(out_j["tb_crc_ok"]) is True
    np.testing.assert_array_equal(out_t["tb_bits"], run["tb"])


def test_two_slot_batch_matches_single_calls(run):
    """A leading slot batch gives each slot's single-call result."""
    tc = run["tc"]
    rng = np.random.default_rng(1)
    tbs = torch.from_numpy(rng.integers(0, 2, size=(2, tc.tbs), dtype=np.uint8))
    rntis = torch.tensor([RNTI, 0x1234])
    w = torch.eye(4, dtype=torch.complex64)
    iq = tcell.encode_slot(tbs, rntis, w, tc)
    noise = to_torch(np.stack([run["noise"], run["noise"][:, ::-1].copy()]))
    out = tcell.decode_slot(iq + noise, rntis, tc)
    for s in range(2):
        iq_s = tcell.encode_slot(tbs[s], int(rntis[s]), w, tc)
        assert torch.allclose(iq_s, iq[s], rtol=0, atol=1e-6 * _rms(to_np(iq_s)))
        one = tcell.decode_slot(iq[s] + noise[s], rntis[s], tc)
        np.testing.assert_array_equal(to_np(out["tb_bits"][s]), to_np(one["tb_bits"]))
        assert bool(out["tb_crc_ok"][s]) == bool(one["tb_crc_ok"]) is True
        np.testing.assert_array_equal(to_np(out["tb_bits"][s]), to_np(tbs[s]))
        for k in ("noise_var", "snr_db"):
            assert torch.allclose(out[k][s], one[k], rtol=1e-5), k
