"""The port's CUDA kernels on the card against their plain torch versions,
and the 24-PRB 4x4 slice and the small multi-UE slot on the card against
the port's CPU path.

The reference-exact modes (plain torch on both devices) are held against
the CPU the same way: decode_i8 and the int8 demapper bitwise, the
reference estimator within 1e-4 x RMS.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs on a GPU host that has
none; there, skip the suite's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: K1 and K2 bits, a-posteriori LLRs and iteration counts exact;
K3's W and eq_nvar, K4's planes and err2, and K5's LLRs, err2 and the
SINR made from them bitwise (both sides round the same float operations
in the same order), and so the slot entries with K5 and with its plain
version on the card; K8's x_hat and eq_nvar at 4 layers bitwise, at 1 and 2
layers within 1e-4 x RMS and 1e-5 x (1 + eq_nvar) (its real algebra against
torch's complex division and reciprocal), and so the front end's LLRs
bitwise at 4 layers, 99.9 % equal and within +-1 at 1;
IQ 1e-4 x RMS and int8 LLRs within +-1 (cuFFT and pocketfft round
differently); TB bits and CRC exact; noise_var and SINR 1e-3 relative;
HARQ buffers within +-2 (two +-1 LLRs combined); UCI codewords, decoded
bits, ok flags and short-block metrics bitwise between card and CPU on the
same int8-valued LLRs (every sum is an integer, exact in any order).
K7 against its plain version on the card: h within 1e-5 x RMS(h) and the
noise variance within 1e-5 relative (the slope's and the noise's sums
reduce in another order, and atan2 / sin / cos / hypot round in their own
last place, so not bitwise); the front end's int8 LLRs equal on at least
99.9 % of lanes and within +-1 (h's float32 rounding moves 0.04-0.05 % of
256QAM lanes across a quantizer step: 4,560 of 10,063,872 at 8 flagship
slots on an H100); TB bits and CRC verdicts exact; two K7 runs on the same
inputs bitwise equal, and a strided grid gives what its contiguous copy
gives.
"""

import numpy as np
import pytest
import torch
from test_torch_demap_llrs import SQUARE, _inputs
from test_torch_pusch_estimate import estimate_args, rx_grids
from torch_parity import RETX_UE, SLOT_PLAN, cuda_device, small_slot, to_np, to_torch  # noqa: F401

from srsran_project_tpu_torch.models import cell
from srsran_project_tpu_torch.ops import demap_llrs as dl
from srsran_project_tpu_torch.ops import demap_planes as dp
from srsran_project_tpu_torch.ops import equalizer, ofdm, short_block, uci
from srsran_project_tpu_torch.ops import pusch_estimate as pe
from srsran_project_tpu_torch.ops.ldpc import decoder
from srsran_project_tpu_torch.ops.modulation import Modulation
from srsran_project_tpu_torch.phy import pusch, sch, ul_slot
from srsran_project_tpu_torch.support import tracing

pytestmark = pytest.mark.cuda

K1_CASES = [
    pytest.param(dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                      nof_total_bits=20032, rv=0, tbs_lbrm_bytes=None), id="bg1-two-e-groups"),
    pytest.param(dict(tbs=2000, target_code_rate=0.2, qm=2, nof_layers=1,
                      nof_total_bits=9000, rv=2, tbs_lbrm_bytes=None), id="bg2-rv2"),
]


def _noisy_llrs(cfg, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    tb = torch.from_numpy(rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8))
    cw = to_np(sch.encode_transport_block(tb, cfg))
    llr = (1.0 - 2.0 * cw.astype(np.float32)) * 14.0 + rng.normal(0.0, 4.0, size=cw.shape)
    return torch.from_numpy(np.clip(np.round(llr), -120, 120).astype(np.int8))


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("kw", K1_CASES)
def test_k1_matches_plain(cuda_device, kw, early_stop):  # noqa: F811
    cfg = sch.SchConfig(**kw)
    seg = cfg.seg
    llrs = torch.stack([_noisy_llrs(cfg, 6), _noisy_llrs(cfg, 7)])
    off = 0
    for _s, count, e in sch._e_groups(cfg.cb_e_bits):
        span = llrs[:, off : off + count * e].reshape(-1, e).contiguous()
        args = (seg.base_graph, seg.lifting_size, seg.nof_payload_bits_per_cb, e, cfg.rv,
                cfg.qm, seg.full_codeword_bits, 6, early_stop)
        before = decoder.decode_dematch.launches
        bits_k, it_k = decoder.decode_dematch(span.to(cuda_device), *args)
        assert decoder.decode_dematch.launches == before + 1
        bits_p, it_p = decoder.decode_dematch(span, *args)
        np.testing.assert_array_equal(to_np(bits_k), to_np(bits_p))
        np.testing.assert_array_equal(to_np(it_k), to_np(it_p))
        off += count * e


@pytest.mark.parametrize("nsc", [3276, 97])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_k3_matches_plain(cuda_device, layout, batch, nsc):  # noqa: F811
    """K3 equals its plain version on the card bitwise (W and eq_nvar), on
    a contiguous (B, nsc, P, L) input and on the (B, nsc, P, L) view of a
    (B, P, nsc, L) estimate, noise variances from 1e-13 (clamped to 1e-12)
    to 1."""
    rng = np.random.default_rng(7)
    h = ((rng.standard_normal((batch, 4, nsc, 4)) + 1j * rng.standard_normal((batch, 4, nsc, 4)))
         * 0.5).astype(np.complex64)
    nv = np.array([1e-13, 0.013, 1.0][-batch:], np.float32)
    h_t = to_torch(h).to(cuda_device).transpose(1, 2)
    if layout == "contiguous":
        h_t = h_t.contiguous()
    nv_t = to_torch(nv).to(cuda_device)
    before = equalizer.mmse_weights_4x4.launches
    w_k, e_k = equalizer.mmse_weights_4x4(h_t, nv_t)
    assert equalizer.mmse_weights_4x4.launches == before + 1
    w_p, e_p = equalizer.mmse_weights_4x4_plain(h_t, nv_t)
    np.testing.assert_array_equal(to_np(torch.view_as_real(w_k)).view(np.int32),
                                  to_np(torch.view_as_real(w_p)).view(np.int32))
    np.testing.assert_array_equal(to_np(e_k).view(np.int32), to_np(e_p).view(np.int32))


def test_slice_on_card_matches_cpu(cuda_device):  # noqa: F811
    cfg = cell.CellConfig(nof_rb=24, nof_ports=4, nof_layers=4)
    rng = np.random.default_rng(0)
    tb = torch.from_numpy(rng.integers(0, 2, size=(2, cfg.tbs), dtype=np.uint8))
    rnti = torch.tensor([0x4601, 0x4602])
    w = torch.eye(4, dtype=torch.complex64)
    iq_c = cell.encode_slot(tb, rnti, w, cfg)
    iq_g = cell.encode_slot(tb.to(cuda_device), rnti.to(cuda_device), w, cfg)
    rms = float(iq_c.abs().pow(2).mean().sqrt())
    assert float((iq_g.cpu() - iq_c).abs().max()) <= 1e-4 * rms
    noise = ((rng.standard_normal(iq_c.shape) + 1j * rng.standard_normal(iq_c.shape))
             * np.sqrt(0.5) * rms * 10 ** (-30 / 20)).astype(np.complex64)
    rx = iq_c + to_torch(noise)

    k1, k3 = decoder.decode_dematch.launches, equalizer.mmse_weights_4x4.launches
    k8 = equalizer.mmse_equalize.launches
    out_g = cell.decode_slot(rx.to(cuda_device), rnti.to(cuda_device), cfg)
    assert decoder.decode_dematch.launches - k1 == 1  # every E-group in one launch
    assert equalizer.mmse_equalize.launches - k8 == 1  # the weights and their apply
    assert equalizer.mmse_weights_4x4.launches - k3 == 0
    out_c = cell.decode_slot(rx, rnti, cfg)
    np.testing.assert_array_equal(to_np(out_g["tb_bits"]), to_np(tb))
    assert to_np(out_g["tb_crc_ok"]).all() and to_np(out_c["tb_crc_ok"]).all()
    np.testing.assert_array_equal(to_np(out_g["tb_bits"]), to_np(out_c["tb_bits"]))

    grid = ofdm.demodulate_slot(rx, cfg.nof_rb, cfg.scs, cfg.dft_size, cfg.cp, 0,
                                     f_center_hz=cfg.f_center_hz)
    llr_c, _, _ = pusch._front_end(grid, rnti, cfg.pusch_cfg)
    llr_g, _, _ = pusch._front_end(grid.to(cuda_device), rnti.to(cuda_device), cfg.pusch_cfg)
    diff = (llr_g.cpu().int() - llr_c.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999

    # The plane path still takes K3's weights into K4.
    k3, k8 = equalizer.mmse_weights_4x4.launches, equalizer.mmse_equalize.launches
    pusch._front_end_planes(grid.to(cuda_device), rnti.to(cuda_device), cfg.pusch_cfg)
    assert equalizer.mmse_weights_4x4.launches - k3 == 1
    assert equalizer.mmse_equalize.launches - k8 == 0


K2_CASES = [
    pytest.param(dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                      nof_total_bits=20032, rv=0, tbs_lbrm_bytes=None), id="bg1-full-graph"),
    pytest.param(dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                      nof_total_bits=20032, rv=0, tbs_lbrm_bytes=2000), id="bg1-lbrm"),
    pytest.param(dict(tbs=300, target_code_rate=0.1, qm=2, nof_layers=1,
                      nof_total_bits=4000, rv=0, tbs_lbrm_bytes=None), id="bg2-repetition"),
    # BG1 Z=384 on the untruncated graph: 46 check rows, 107 KB of shared
    # memory a block.
    pytest.param(dict(tbs=8000, target_code_rate=0.9, qm=2, nof_layers=1,
                      nof_total_bits=9000, rv=0, tbs_lbrm_bytes=None), id="bg1-z384-full-graph"),
    # chip_smoke.py path 4, group B: rank 2, 64QAM, 22 PRB, rate-matched
    # around UCI (37,620 SCH bits), BG1 Z=320, 3 codeblocks.
    pytest.param(dict(tbs=21000, target_code_rate=567 / 1024, qm=6, nof_layers=2,
                      nof_total_bits=37620, rv=0), id="path4-group-b"),
]


@pytest.mark.parametrize("f32", [False, True], ids=["int8", "f32"])
@pytest.mark.parametrize("kw", K2_CASES)
def test_k2_matches_plain(cuda_device, kw, f32):  # noqa: F811
    cfg = sch.SchConfig(**kw)
    seg = cfg.seg
    llrs = torch.stack([_noisy_llrs(cfg, 8), _noisy_llrs(cfg, 9)])
    buf = sch._dematch_stage(llrs, None, cfg).reshape(-1, seg.full_codeword_bits)
    if f32:
        buf = buf.to(torch.float32) * 0.37
        buf[:, ::5] = -0.0
    for bits_only in (True, False):
        for iters, early_stop in ((0, False), (1, False), (6, False), (6, True)):
            args = (seg.base_graph, seg.lifting_size, iters, early_stop, bits_only, cfg.n_cb)
            before = decoder.decode.launches
            bits_k, app_k, it_k = decoder.decode(buf.to(cuda_device), *args)
            assert decoder.decode.launches == before + 1
            bits_p, app_p, it_p = decoder.decode(buf, *args)
            np.testing.assert_array_equal(to_np(bits_k), to_np(bits_p))
            np.testing.assert_array_equal(to_np(it_k), to_np(it_p))
            if not bits_only:  # bitwise: -0.0 and +0.0 differ
                np.testing.assert_array_equal(to_np(app_k.view(torch.int32)),
                                              to_np(app_p.view(torch.int32)))


@pytest.mark.parametrize("n", [97, 3276])
@pytest.mark.parametrize("l, p", [(1, 4), (2, 4), (3, 3), (4, 4), (1, 2), (2, 2)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16, Modulation.QAM64,
                                 Modulation.QAM256], ids=lambda m: m.name)
def test_k4_matches_plain(cuda_device, mod, l, p, n):  # noqa: F811
    """K4 equals its plain version on the card bitwise, planes and err2,
    for every square QAM at 1-4 layers, batch 3: 4 ports; 3 at 3 layers
    (the odd-port path); and 2 ports at 1 and 2 layers (one port pair
    per float4 of weights)."""
    rng = np.random.default_rng(11)
    b, s, qm = 3, 12, int(mod)
    y = (rng.standard_normal((b, p, s, n)) + 1j * rng.standard_normal((b, p, s, n)))
    w = (rng.standard_normal((b, n, l, p)) + 1j * rng.standard_normal((b, n, l, p))) * 0.3
    ev = (0.05 + rng.random((b, n, l))).astype(np.float32)
    c = rng.integers(0, 2, size=(b, s * n * l * qm), dtype=np.uint8)
    ins = [to_torch(y.astype(np.complex64)).to(cuda_device),
           to_torch(w.astype(np.complex64)).to(cuda_device), to_torch(ev).to(cuda_device),
           to_torch(c).to(cuda_device)]
    before = dp.demap_planes.launches
    planes_k, err_k = dp.demap_planes(*ins, mod)
    assert dp.demap_planes.launches == before + 1
    planes_p, err_p = dp.demap_planes_plain(*ins, mod)
    np.testing.assert_array_equal(to_np(planes_k), to_np(planes_p))
    np.testing.assert_array_equal(to_np(err_k).view(np.int32), to_np(err_p).view(np.int32))


def _sinr(err2: torch.Tensor) -> torch.Tensor:
    """The demap stage's SINR of per-lane squared distances."""
    e = torch.sqrt(err2.mean(dim=-1))
    return 1.0 / torch.clamp_min(e * e, 1e-12)


@pytest.mark.parametrize("range_limit", [20.0, 7.5])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("layers", [1, 2, 3, 4])
@pytest.mark.parametrize("mod", SQUARE, ids=lambda m: m.name)
def test_k5_matches_plain(cuda_device, mod, layers, batch, range_limit):  # noqa: F811
    """K5 equals its plain version on the card bitwise (LLRs, err2 and the
    SINR made from err2) in one launch, on the CPU tests' inputs: symbols
    on the quantizer's half-points, saturating LLRs, tiny eq_nvar."""
    x, ev, c_init = _inputs(mod, layers, batch)
    from srsran_project_tpu_torch.ops import scrambling

    c = scrambling.gold_sequence(c_init, x.shape[1] * layers * int(mod))
    ins = [t.to(cuda_device) for t in (x, ev, c)]
    before = dl.demap_llrs.launches
    llr_k, err_k = dl.demap_llrs(*ins, mod, range_limit)
    assert dl.demap_llrs.launches == before + 1
    llr_p, err_p = dl.demap_llrs_plain(*ins, mod, range_limit)
    np.testing.assert_array_equal(to_np(llr_k), to_np(llr_p))
    np.testing.assert_array_equal(to_np(err_k).view(np.int32), to_np(err_p).view(np.int32))
    np.testing.assert_array_equal(to_np(_sinr(err_k)).view(np.int32),
                                  to_np(_sinr(err_p)).view(np.int32))
    llr_c, err_c = dl.demap_llrs_plain(x, ev, c, mod, range_limit)  # the CPU's
    np.testing.assert_array_equal(to_np(llr_k), to_np(llr_c))
    np.testing.assert_array_equal(to_np(err_k).view(np.int32), to_np(err_c).view(np.int32))


def test_k5_at_the_flagship_in_the_demap_stage(cuda_device, monkeypatch):  # noqa: F811
    """``_demap_stage`` at the flagship's shape (8 slots, 39,312 data REs,
    4 layers, 256QAM) launches K5 once a call, its span's ``kernel_lanes``
    equals ``lanes``, and its LLRs and SINR equal the stage's with K5's
    plain version on the card; the LLRs equal the CPU's."""
    cfg = cell.CellConfig().pusch_cfg
    rng = np.random.default_rng(4)
    b, nd, nl = 8, 39312, 4
    x = ((rng.standard_normal((b, nd, nl)) + 1j * rng.standard_normal((b, nd, nl))) * 0.6
         ).astype(np.complex64)
    ev = (0.001 + 0.05 * rng.random((b, nd, nl))).astype(np.float32)
    rnti = torch.arange(0x4601, 0x4601 + b)
    ins = (to_torch(x).to(cuda_device), to_torch(ev).to(cuda_device), rnti.to(cuda_device))
    tracer = tracing.l1_tracer
    monkeypatch.setattr(tracer, "_kept", [])
    monkeypatch.setattr(tracer, "enabled", True)
    before = dl.demap_llrs.launches
    llr_k, sinr_k = pusch._demap_stage(*ins, cfg)
    assert dl.demap_llrs.launches == before + 1
    counts = tracer.take().totals["pusch.demap"].counts
    assert counts == {"lanes": b * nd * nl, "kernel_lanes": b * nd * nl}
    monkeypatch.setattr(pusch, "demap_llrs", dl.demap_llrs_plain)
    llr_p, sinr_p = pusch._demap_stage(*ins, cfg)
    assert dl.demap_llrs.launches == before + 1
    np.testing.assert_array_equal(to_np(llr_k), to_np(llr_p))
    np.testing.assert_array_equal(to_np(sinr_k).view(np.int32), to_np(sinr_p).view(np.int32))
    llr_c, _ = pusch._demap_stage(to_torch(x), to_torch(ev), rnti, cfg)
    np.testing.assert_array_equal(to_np(llr_k), to_np(llr_c))


def _entry_runs(entry):
    """(run(device) -> outputs to compare, the number of demap stages a
    call) for the 24-PRB 4x4 slice's ``decode_slot`` and the small
    multi-UE slot's ``process_slot``."""
    if entry == "decode_slot":
        cfg = cell.CellConfig(nof_rb=24, nof_ports=4, nof_layers=4)
        rng = np.random.default_rng(1)
        tb = torch.from_numpy(rng.integers(0, 2, size=(2, cfg.tbs), dtype=np.uint8))
        rnti = torch.tensor([0x4601, 0x4602])
        iq = cell.encode_slot(tb, rnti, torch.eye(4, dtype=torch.complex64), cfg)
        rms = float(iq.abs().pow(2).mean().sqrt())
        noise = ((rng.standard_normal(iq.shape) + 1j * rng.standard_normal(iq.shape))
                 * np.sqrt(0.5) * rms * 10 ** (-30 / 20)).astype(np.complex64)
        rx = iq + to_torch(noise)

        def run(dev):
            out = cell.decode_slot(rx.to(dev), rnti.to(dev), cfg)
            return {k: out[k] for k in ("tb_bits", "tb_crc_ok", "noise_var", "snr_db")}
        return run, 1
    cfgs, _tbs, grid = small_slot()

    def run(dev):
        pdus = [ul_slot.UlSlotPdu(rnti=r, first_rb=rb0, config=c)
                for (r, rb0, _n, _m), c in zip(SLOT_PLAN, cfgs)]
        outs, _, _ = ul_slot.process_slot(grid.to(dev), pdus)
        return {f"{i}.{k}": o[k] for i, o in enumerate(outs)
                for k in ("tb_bits", "tb_crc_ok", "noise_var", "snr_db", "harq_buffer")}
    return run, None


@pytest.mark.parametrize("entry", ["decode_slot", "process_slot"])
def test_entries_with_k5_match_plain_route_on_card(cuda_device, monkeypatch, entry):  # noqa: F811
    """``decode_slot`` and ``process_slot`` on the card launch K5 once per
    demap stage, and give what they give with K5's plain version in its
    place on the card, bitwise (TB bits, CRC, noise, SINR, HARQ buffers);
    TB bits and CRC verdicts equal the CPU's."""
    run, want_stages = _entry_runs(entry)
    stages = []
    real_stage = pusch._demap_stage
    monkeypatch.setattr(pusch, "_demap_stage",
                        lambda *a: stages.append(1) or real_stage(*a))
    before = dl.demap_llrs.launches
    got = run(cuda_device)
    assert dl.demap_llrs.launches - before == len(stages) >= 1
    if want_stages is not None:
        assert len(stages) == want_stages
    with monkeypatch.context() as m:
        m.setattr(pusch, "demap_llrs", dl.demap_llrs_plain)
        plain = run(cuda_device)
    assert dl.demap_llrs.launches - before == len(stages) // 2
    for k in got:
        a, b = to_np(got[k]), to_np(plain[k])
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)
    cpu = run("cpu")
    for k in got:
        if k.endswith("tb_bits") or k.endswith("tb_crc_ok"):
            np.testing.assert_array_equal(to_np(got[k]), to_np(cpu[k]), err_msg=k)


# Shape -> (PRBs, layers, ports, first PRBs of the batch's grants: with a
# per-grant pilot bank unless all 0, DM-RS symbols): the flagship, the
# config groups of mu8_ul and fapi_ul_tti, and a grant on two DM-RS symbols.
K7_SHAPES = {
    "flagship-b1": (273, 4, 4, (0,), (2,)),
    "flagship-b8": (273, 4, 4, (0,) * 8, (2,)),
    "mu8-rank4-80prb": (80, 4, 4, (0, 80), (2,)),
    "mu8-rank1-24prb": (24, 1, 4, (160, 184, 208, 232), (2,)),
    "mu8-rank1-8prb": (8, 1, 4, (256, 264), (2,)),
    "fapi-rank4-72prb": (72, 4, 4, (18, 90), (2,)),
    "fapi-rank1-20prb": (20, 1, 4, (162, 182, 202, 222), (2,)),
    "fapi-rank1-8prb": (8, 1, 4, (242, 250), (2,)),
    "two-dmrs-symbols": (24, 2, 2, (0, 0), (2, 11)),
}
K7_H_TOL = 1e-5  # max |dh| / RMS(h)
K7_NV_RTOL = 1e-5
K7_LLR_EQUAL = 0.999  # share of the front end's int8 LLRs equal to the plain route's


def _k7_case(shape, dev):
    """(PuschConfig, grid on dev, estimate's arguments after the grid on
    dev) of a K7_SHAPES entry."""
    import dataclasses

    nof_rb, layers, ports, first_rbs, dmrs = K7_SHAPES[shape]
    cfg = cell.CellConfig(nof_rb=nof_rb, nof_ports=ports, nof_layers=layers).pusch_cfg
    cfg = dataclasses.replace(cfg, alloc=dataclasses.replace(cfg.alloc, dmrs_symbols=dmrs))
    assert pusch._fused_estimate_ok(cfg)
    bank = (pusch._pilot_bank_on(dev, cfg, first_rbs) if any(first_rbs) else None)
    grid = rx_grids(cfg, first_rbs, seed=len(shape)).to(dev)
    return cfg, grid, estimate_args(cfg, dev, bank)


@pytest.mark.parametrize("shape", sorted(K7_SHAPES))
def test_k7_matches_plain(cuda_device, shape):  # noqa: F811
    """K7 (two launches) against its plain version on the card: h within
    K7_H_TOL x RMS(h), the noise within K7_NV_RTOL; h in the (B, nof_sc,
    P, nl) memory the equalizer reads; a second run bitwise the first."""
    _cfg, grid, args = _k7_case(shape, cuda_device)
    before = pe.estimate.launches
    h_k, nv_k = pe.estimate(grid, *args)
    assert pe.estimate.launches == before + 2
    h_p, nv_p = pe.estimate_plain(grid, *args)
    assert h_k.shape == h_p.shape and h_k.transpose(1, 2).is_contiguous()
    rms = float(h_p.abs().pow(2).mean().sqrt())
    assert float((h_k - h_p).abs().max()) <= K7_H_TOL * rms, shape
    assert float(((nv_k - nv_p).abs() / nv_p).max()) <= K7_NV_RTOL, shape
    h_k2, nv_k2 = pe.estimate(grid, *args)
    assert torch.equal(torch.view_as_real(h_k2), torch.view_as_real(h_k))
    assert torch.equal(nv_k2.view(torch.int32), nv_k.view(torch.int32))


@pytest.mark.parametrize("shape", ["flagship-b8", "mu8-rank4-80prb", "fapi-rank1-20prb"])
def test_k7_in_the_front_end(cuda_device, monkeypatch, shape):  # noqa: F811
    """The front end with K7 and with its plain version in its place, on
    the card: the span's ``kernel_grants`` equals ``grants``, the int8
    LLRs equal on a K7_LLR_EQUAL share of lanes and within +-1, the noise
    within K7_NV_RTOL, and the decoded TB bits and CRC verdicts equal."""
    cfg, grid, args = _k7_case(shape, cuda_device)
    b = grid.shape[0]
    rnti = torch.arange(0x4601, 0x4601 + b, device=cuda_device)
    r = args[1] if args[1].shape[0] == b else None
    tracer = tracing.l1_tracer
    monkeypatch.setattr(tracer, "_kept", [])
    monkeypatch.setattr(tracer, "enabled", True)

    def run():
        llr, nv, snr = pusch._after_estimate(*pusch._estimate(grid, cfg, r), rnti, cfg)
        return llr, nv, pusch.finish(llr, nv, snr, cfg)

    llr_k, nv_k, out_k = run()
    assert tracer.take().totals["pusch.estimate"].counts == {"grants": b, "kernel_grants": b}
    with monkeypatch.context() as m:
        m.setattr(pe, "estimate", pe.estimate_plain)
        llr_p, nv_p, out_p = run()
    diff = (llr_k.int() - llr_p.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= K7_LLR_EQUAL, shape
    assert float(((nv_k - nv_p).abs() / nv_p).max()) <= K7_NV_RTOL
    for k in ("tb_bits", "tb_crc_ok"):
        np.testing.assert_array_equal(to_np(out_k[k]), to_np(out_p[k]), err_msg=k)
    assert to_np(out_k["tb_crc_ok"]).all()


# K8 at the uplink cells' shapes (4 receive ports: K7_SHAPES but the last).
K8_SHAPES = [name for name, (_rb, _l, ports, _f, _d) in K7_SHAPES.items() if ports == 4]
# K8's 1- and 2-layer weights are separately rounded real algebra (the
# reciprocal scaled as torch's complex division scales it); the plain
# version's torch complex products round their own way, so mu, x_hat and
# eq_nvar agree to a few units in the last place, not bitwise.  eq_nvar =
# (1 - mu) / mu carries mu's error, whose unit in the last place is 6e-8
# near mu = 1: at 30 dB that is 3e-4 of eq_nvar, so its tolerance is on
# (1 + eq_nvar); the 2x2 inverse scales both errors by the channel's
# condition.  Measured on a CPU model of the kernel against the plain
# version on the CPU, channels of 3e-7 to 1e7: 1 layer 9e-9 x RMS(x) and
# 1e-7 x (1 + eq_nvar), 2 layers 6e-6 and 1e-6.
K8_X_TOL = 1e-4  # max |dx| / RMS(x), 1 and 2 layers
K8_EV_TOL = 1e-5  # max |d eq_nvar| / (1 + eq_nvar), 1 and 2 layers


def _k8_case(shape, dev):
    """(PuschConfig, the equalizer's inputs from K7's estimate on dev) of
    a K8_SHAPES entry."""
    cfg, grid, args = _k7_case(shape, dev)
    r = args[1] if args[1].shape[0] == grid.shape[0] else None
    gflat, h, nv = pusch._estimate_stage(grid, cfg, r)
    return cfg, (pusch._grid_of(gflat, cfg), h, nv, pusch._data_symbols(cfg), cfg.alloc.sc_start)


def _assert_k8_close(x_k, ev_k, x_p, ev_p, layers, what):
    if layers == 4:
        assert torch.equal(torch.view_as_real(x_k).view(torch.int32),
                           torch.view_as_real(x_p).view(torch.int32)), what
        assert torch.equal(ev_k.view(torch.int32), ev_p.view(torch.int32)), what
        return
    rms = float(x_p.abs().pow(2).mean().sqrt())
    assert float((x_k - x_p).abs().max()) <= K8_X_TOL * rms, what
    assert float(((ev_k - ev_p).abs() / (1.0 + ev_p)).max()) <= K8_EV_TOL, what


@pytest.mark.parametrize("shape", K8_SHAPES)
def test_k8_matches_plain(cuda_device, shape):  # noqa: F811
    """K8 (one launch) against its plain version on the card, on K7's
    estimate of the shape's grants: 4 layers bitwise (x_hat and eq_nvar),
    1 layer within K8_X_TOL and K8_EV_TOL; 4 layers also bitwise the
    plain version on the CPU; a second run bitwise the first."""
    cfg, ins = _k8_case(shape, cuda_device)
    before = equalizer.mmse_equalize.launches
    x_k, ev_k = equalizer.mmse_equalize(*ins)
    assert equalizer.mmse_equalize.launches == before + 1
    b, ndata = ins[0].shape[0], len(ins[3]) * cfg.alloc.nof_sc
    assert x_k.shape == ev_k.shape == (b, ndata, cfg.nof_layers)
    x_p, ev_p = equalizer.mmse_equalize_plain(*ins)
    _assert_k8_close(x_k, ev_k, x_p, ev_p, cfg.nof_layers, shape)
    if cfg.nof_layers == 4:
        x_c, ev_c = equalizer.mmse_equalize_plain(*(t.cpu() if torch.is_tensor(t) else t
                                                    for t in ins))
        _assert_k8_close(x_k.cpu(), ev_k.cpu(), x_c, ev_c, 4, shape + " (CPU)")
    x_k2, ev_k2 = equalizer.mmse_equalize(*ins)
    assert torch.equal(torch.view_as_real(x_k2), torch.view_as_real(x_k))
    assert torch.equal(ev_k2.view(torch.int32), ev_k.view(torch.int32))


@pytest.mark.parametrize("layers", [1, 2])
def test_k8_at_one_and_two_layers(cuda_device, layers):  # noqa: F811
    """K8 against its plain version on random 1- and 2-layer channels of
    3 grants on 24 PRB at sc_start 36 of a wider grid, noise variances
    from 1e-3 to 0.3."""
    rng = np.random.default_rng(layers)
    nsc = 288

    def cplx(shape):
        return to_torch(((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 0.5
                         ).astype(np.complex64)).to(cuda_device)

    grid = cplx((3, 4, 14, 624))
    h = cplx((3, nsc, 4, layers)).transpose(1, 2)
    nv = torch.tensor([1e-3, 0.013, 0.3], device=cuda_device)
    syms = [1] + list(range(3, 14))
    x_k, ev_k = equalizer.mmse_equalize(grid, h, nv, syms, 36)
    x_p, ev_p = equalizer.mmse_equalize_plain(grid, h, nv, syms, 36)
    _assert_k8_close(x_k, ev_k, x_p, ev_p, layers, f"{layers} layers")


@pytest.mark.parametrize("scale", [1e-5, 1e5])
@pytest.mark.parametrize("layers", [1, 2])
def test_k8_over_the_channel_range(cuda_device, layers, scale):  # noqa: F811
    """K8 against its plain version with channels and grids of 1e-5 and
    1e5 (the noise 20 dB below the channel, clamped to 1e-12), where a
    2x2 determinant of about 1e-20 or 1e20 leaves an unscaled
    conj(d) / |d|^2 outside float32's range: within K8_X_TOL and
    K8_EV_TOL, every value finite."""
    rng = np.random.default_rng(layers + 7)

    def cplx(shape):
        return to_torch(((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                         * 0.5 * scale).astype(np.complex64)).to(cuda_device)

    grid = cplx((3, 4, 14, 288))
    h = cplx((3, 288, 4, layers)).transpose(1, 2)
    nv = torch.full((3,), max(0.01 * scale**2, 1e-12), device=cuda_device)
    syms = [1] + list(range(3, 14))
    x_k, ev_k = equalizer.mmse_equalize(grid, h, nv, syms, 0)
    x_p, ev_p = equalizer.mmse_equalize_plain(grid, h, nv, syms, 0)
    assert bool(torch.isfinite(torch.view_as_real(x_k)).all() and torch.isfinite(ev_k).all())
    _assert_k8_close(x_k, ev_k, x_p, ev_p, layers, f"{layers} layers at {scale:g}")


@pytest.mark.parametrize("shape", ["flagship-b8", "mu8-rank4-80prb", "fapi-rank1-20prb"])
def test_k8_in_the_front_end(cuda_device, monkeypatch, shape):  # noqa: F811
    """The front end with K8 and with its plain version in its place, on
    the card: the span's ``kernel_res`` equals ``res``; 4 layers: the int8
    LLRs, noise and SINR bitwise; 1 layer: the LLRs equal on a
    K7_LLR_EQUAL share of lanes and within +-1; the decoded TB bits and
    CRC verdicts equal."""
    cfg, grid, args = _k7_case(shape, cuda_device)
    b = grid.shape[0]
    rnti = torch.arange(0x4601, 0x4601 + b, device=cuda_device)
    r = args[1] if args[1].shape[0] == b else None
    est = pusch._estimate(grid, cfg, r)
    tracer = tracing.l1_tracer
    monkeypatch.setattr(tracer, "_kept", [])
    monkeypatch.setattr(tracer, "enabled", True)

    def run():
        llr, nv, snr = pusch._after_estimate(*est, rnti, cfg)
        return llr, snr, pusch.finish(llr, nv, snr, cfg)

    before = equalizer.mmse_equalize.launches
    llr_k, snr_k, out_k = run()
    assert equalizer.mmse_equalize.launches == before + 1
    res = b * len(pusch._data_symbols(cfg)) * cfg.alloc.nof_sc
    assert tracer.take().totals["pusch.equalize"].counts == {"res": res, "kernel_res": res}
    with monkeypatch.context() as m:
        m.setattr(pusch, "mmse_equalize", equalizer.mmse_equalize_plain)
        llr_p, snr_p, out_p = run()
    if cfg.nof_layers == 4:
        assert torch.equal(llr_k, llr_p)
        assert torch.equal(snr_k.view(torch.int32), snr_p.view(torch.int32))
    else:
        diff = (llr_k.int() - llr_p.int()).abs()
        assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= K7_LLR_EQUAL
    for k in ("tb_bits", "tb_crc_ok"):
        np.testing.assert_array_equal(to_np(out_k[k]), to_np(out_p[k]), err_msg=k)
    assert to_np(out_k["tb_crc_ok"]).all()


@pytest.mark.parametrize("layers", [1, 4])
def test_k8_on_a_strided_grid(cuda_device, layers):  # noqa: F811
    """K8 reads the grid and the channel through their strides: symbol and
    subcarrier axes swapped in memory, and a contiguous channel, give
    bitwise what the contiguous grid and K7's channel layout give."""
    cfg, ins = _k8_case("mu8-rank4-80prb" if layers == 4 else "mu8-rank1-24prb", cuda_device)
    grid, h = ins[0], ins[1]
    swapped = grid.transpose(2, 3).contiguous().transpose(2, 3)
    x_v, ev_v = equalizer.mmse_equalize(swapped, h.contiguous(), *ins[2:])
    x_c, ev_c = equalizer.mmse_equalize(grid.contiguous(), h, *ins[2:])
    assert torch.equal(torch.view_as_real(x_v), torch.view_as_real(x_c))
    assert torch.equal(ev_v.view(torch.int32), ev_c.view(torch.int32))


@pytest.mark.parametrize("layout", ["subcarrier-window", "transposed", "port-strided"])
def test_k7_on_a_strided_grid(cuda_device, layout):  # noqa: F811
    """K7 reads the grid through its strides: a view (a window of a wider
    grid, symbol and subcarrier axes swapped in memory, every other port
    of a wider stack) gives bitwise what its contiguous copy gives."""
    _cfg, grid, args = _k7_case("mu8-rank4-80prb", cuda_device)
    view = {"subcarrier-window": lambda g: torch.cat([g, g], -1)[..., : g.shape[-1]],
            "transposed": lambda g: g.transpose(2, 3).contiguous().transpose(2, 3),
            "port-strided": lambda g: torch.stack([g, g], 2).flatten(1, 2)[:, ::2]}[layout](grid)
    assert not view.is_contiguous()
    h_v, nv_v = pe.estimate(view, *args)
    h_c, nv_c = pe.estimate(view.contiguous(), *args)
    assert torch.equal(torch.view_as_real(h_v), torch.view_as_real(h_c))
    assert torch.equal(nv_v.view(torch.int32), nv_c.view(torch.int32))


def test_k3_k4_occupancy_on_card(cuda_device):  # noqa: F811
    """The occupancy entry points answer for K3, K8 at 1, 2 and 4 layers and
    every K4 and K5 instance."""
    k3 = equalizer.occupancy()
    assert k3["registers"] > 0 and k3["blocks_per_sm"] >= 1
    for l in equalizer.MMSE_EQUALIZE_LAYERS:
        k8 = equalizer.mmse_equalize_occupancy(l)
        assert k8["registers"] > 0 and k8["blocks_per_sm"] >= 1, (l, k8)
    for mod in (Modulation.QPSK, Modulation.QAM16, Modulation.QAM64, Modulation.QAM256):
        for l in (1, 2, 3, 4):
            for occupancy in (dp.occupancy, dl.occupancy):
                k = occupancy(mod, l)
                assert k["registers"] > 0 and k["blocks_per_sm"] >= 1, (mod, l, k)


def test_k1_plane_layout_on_card(cuda_device):  # noqa: F811
    cfg = sch.SchConfig(**K1_CASES[0].values[0])
    seg = cfg.seg
    llrs = torch.stack([_noisy_llrs(cfg, 6), _noisy_llrs(cfg, 7)])
    planes = llrs.reshape(2, -1, cfg.qm).transpose(1, 2).contiguous().to(cuda_device)
    off = 0
    for _s, count, e in sch._e_groups(cfg.cb_e_bits):
        args = (seg.base_graph, seg.lifting_size, seg.nof_payload_bits_per_cb, e, cfg.rv,
                cfg.qm, seg.full_codeword_bits, 6, True)
        view = planes[:, :, off // cfg.qm : (off + count * e) // cfg.qm].unflatten(
            2, (count, e // cfg.qm))
        before = decoder.decode_dematch.plane_launches
        bits_v, it_v = decoder.decode_dematch(view, *args)
        assert decoder.decode_dematch.plane_launches == before + 1
        span = llrs[:, off : off + count * e].reshape(-1, e).contiguous()
        bits_s, it_s = decoder.decode_dematch(span.to(cuda_device), *args)
        np.testing.assert_array_equal(to_np(bits_v), to_np(bits_s))
        np.testing.assert_array_equal(to_np(it_v), to_np(it_s))
        off += count * e


TWO_E_GROUPS = dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2, nof_total_bits=20048,
                    rv=0, tbs_lbrm_bytes=None)


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("layout", ["stream", "planes"])
@pytest.mark.parametrize("kw", [TWO_E_GROUPS, dict(TWO_E_GROUPS, tbs_lbrm_bytes=2000)],
                         ids=["full", "lbrm"])
def test_k1_grouped_matches_plain(cuda_device, kw, layout, early_stop):  # noqa: F811
    """Both E-groups of a batch of 3 TBs in ONE K1 launch, against the CPU
    path's one plain call per group: bits and iterations equal."""
    cfg = sch.SchConfig(**kw)
    llrs = torch.stack([_noisy_llrs(cfg, s) for s in (6, 7, 8)])
    src = llrs if layout == "stream" else llrs.reshape(3, -1, cfg.qm).transpose(1, 2)
    assert len(sch._e_groups(cfg.cb_e_bits)) == 2
    before = (decoder.decode_dematch.launches, decoder.decode_dematch.plane_launches)
    bits_k, it_k = sch._decode_groups(src.contiguous().to(cuda_device), cfg, 6, early_stop)
    assert decoder.decode_dematch.launches == before[0] + 1
    assert decoder.decode_dematch.plane_launches == before[1] + (layout == "planes")
    bits_p, it_p = sch._decode_groups(src, cfg, 6, early_stop)
    np.testing.assert_array_equal(to_np(bits_k), to_np(bits_p))
    np.testing.assert_array_equal(to_np(it_k), to_np(it_p))


def test_blocks_per_sm_on_card(cuda_device):  # noqa: F811
    """The occupancy the kernels' shared memory and registers allow: the
    flagship's K1 plan (59,760 B) two 384-thread blocks per SM; K2 on the
    untruncated BG1 graph at Z=384 (107 KB) at least one."""
    fl = cell.CellConfig().pusch_cfg.sch
    seg = fl.seg
    e = fl.cb_e_bits[0]
    k1 = decoder.dematch_decode_plan(seg.base_graph, seg.lifting_size,
                                     seg.nof_payload_bits_per_cb, e, fl.rv, fl.qm, fl.n_cb)
    assert (k1.shared_bytes, decoder.blocks_per_sm(k1)) == (59760, 2)
    full = decoder.decode_plan(1, 384, 66 * 384, None)
    assert len(full.layers) == 46 and decoder.blocks_per_sm(full) >= 1


def test_ul_slot_on_card_matches_cpu(cuda_device):  # noqa: F811
    """The small multi-UE slot and its retransmission: one K2 launch per
    code group and no K1 launch; TB bits and CRC equal to the CPU run."""
    harq = {"cpu": None, "cuda": None}
    for rv, noise_seed in ((None, 0), (2, 1)):
        cfgs, tbs, grid = small_slot(rv_retx=rv, noise_seed=noise_seed)
        outs = {}
        for dev in ("cpu", cuda_device):
            key = "cpu" if dev == "cpu" else "cuda"
            pdus = [ul_slot.UlSlotPdu(rnti=r, first_rb=rb0, config=c,
                                      harq_buffer=harq[key] if i == RETX_UE else None)
                    for i, ((r, rb0, _n, _m), c) in enumerate(zip(SLOT_PLAN, cfgs))]
            k1, k2 = decoder.decode_dematch.launches, decoder.decode.launches
            outs[key], _, _ = ul_slot.process_slot(grid.to(dev), pdus)
            if key == "cuda":
                assert decoder.decode_dematch.launches == k1
                assert decoder.decode.launches - k2 == 3
            harq[key] = outs[key][RETX_UE]["harq_buffer"]
        for i, (rc, rg, tb) in enumerate(zip(outs["cpu"], outs["cuda"], tbs)):
            want_ok = rv is not None or i != RETX_UE
            assert bool(rg["tb_crc_ok"]) == bool(rc["tb_crc_ok"]) == want_ok, i
            np.testing.assert_array_equal(to_np(rg["tb_bits"]), to_np(rc["tb_bits"]))
            for k in ("noise_var", "snr_db"):
                assert abs(float(rg[k]) / float(rc[k]) - 1) <= 1e-3, (i, k)
            d = (rg["harq_buffer"].cpu().int() - rc["harq_buffer"].int()).abs()
            assert int(d.max()) <= 2, (i, int(d.max()))


@pytest.mark.parametrize("k, e", [(1, 100), (2, 24), (6, 64), (11, 252), (19, 144), (22, 64),
                                  (40, 192), (400, 1376)])
def test_uci_codecs_on_card_match_cpu(cuda_device, k, e):  # noqa: F811
    """encode_uci, decode_uci (short block, polar with CRC6 + PC bits, CRC11,
    two segments) and short-block detect on the card against the CPU, on
    the same int8-valued LLRs, noisy enough that some codewords fail."""
    rng = np.random.default_rng(k)
    bits = torch.from_numpy(rng.integers(0, 2, size=(6, k), dtype=np.uint8))
    cw = uci.encode_uci(bits, e)
    assert torch.equal(uci.encode_uci(bits.to(cuda_device), e).cpu(), cw)
    llr = (1.0 - 2.0 * to_np(cw).astype(np.float32)) * 6.0 + rng.normal(0.0, 12.0, cw.shape)
    x = torch.from_numpy(np.clip(np.round(llr), -120, 120).astype(np.float32))
    b_c, ok_c = uci.decode_uci(x, k)
    b_g, ok_g = uci.decode_uci(x.to(cuda_device), k)
    assert torch.equal(b_g.cpu(), b_c) and torch.equal(ok_g.cpu(), ok_c)
    if k <= 11:
        b_c, m_c = short_block.detect(x, k, e)
        b_g, m_g = short_block.detect(x.to(cuda_device), k, e)
        assert torch.equal(b_g.cpu(), b_c)
        assert torch.equal(m_g.cpu().view(torch.int32), m_c.view(torch.int32))


# ---- every allocation shape and waveform ------------------------------------

def _shape_configs(nof_rb=12, layers=1, ports=2, mod=Modulation.QAM16, rate=0.5, dmrs_type=1,
                   cdm=2, **extra):
    """(PdschConfig, PuschConfig) of one grant of the port (no JAX here):
    symbols 1-13, DM-RS on symbol 2; ``extra`` sets PT-RS and transform
    precoding on both."""
    from srsran_project_tpu_torch.phy import pdsch
    from srsran_project_tpu_torch.phy.allocation import Allocation
    from srsran_project_tpu_torch.ran import tbs as tbs_mod

    qm = 1 if mod == Modulation.PI_2_BPSK else int(mod)
    alloc = Allocation(rb_start=0, rb_count=nof_rb, sym_start=1, sym_count=13,
                       dmrs_symbols=(2,), dmrs_config_type=dmrs_type,
                       nof_cdm_groups_without_data=cdm)
    common = dict(tbs=tbs_mod.calculate_tbs(nof_rb, 13, 12, rate, qm, layers),
                  target_code_rate=rate, modulation=mod, alloc=alloc, nof_layers=layers,
                  nof_grid_symbols=14, nof_grid_sc=12 * nof_rb, n_rs_id=5, **extra)
    return (pdsch.PdschConfig(nof_ports=ports, **common),
            pusch.PuschConfig(nof_rx_ports=ports, **common))


def _shape_grid(tx, seed: int, snr_db: float, phase: float = 0.0):
    """A received CPU grid of a grant: the port's pdsch.process through a
    random unitary channel, a random common phase per data symbol up to
    +-phase, AWGN.  Returns (TB bits, grid (1, P, 14, nsc))."""
    from srsran_project_tpu_torch.phy import pdsch

    rng = np.random.default_rng(seed)
    tb = rng.integers(0, 2, size=(tx.tbs,), dtype=np.uint8)
    h = rng.standard_normal((tx.nof_ports, tx.nof_layers)) + 1j * rng.standard_normal(
        (tx.nof_ports, tx.nof_layers))
    w = (np.linalg.qr(h)[0].T * np.sqrt(tx.nof_ports / tx.nof_layers)).astype(np.complex64)
    g = to_np(pdsch.process(torch.from_numpy(tb), 0x4601, torch.from_numpy(w), tx))
    ph = rng.uniform(-phase, phase, 14)
    ph[list(tx.alloc.dmrs_symbols)] = 0.0
    g = g * np.exp(1j * ph)[None, :, None]
    g = g + np.sqrt(0.5 * 10 ** (-snr_db / 10)) * (rng.standard_normal(g.shape)
                                                  + 1j * rng.standard_normal(g.shape))
    return tb, torch.from_numpy(g.astype(np.complex64))[None]


@pytest.mark.parametrize("case", ["qm1-pi2bpsk", "qm2", "ptrs-erased"])
def test_k1_new_inputs_match_plain(cuda_device, case):  # noqa: F811
    """K1 on inputs of this slice's grants against its plain version: qm = 1
    (pi/2-BPSK) and qm = 2 streams, and a 16QAM stream whose PT-RS bits
    the receiver erased to 0; bits and iterations equal, one launch."""
    mod, extra = {"qm1-pi2bpsk": (Modulation.PI_2_BPSK, dict(transform_precoding=True)),
                  "qm2": (Modulation.QPSK, dict(transform_precoding=True)),
                  "ptrs-erased": (Modulation.QAM16, dict(ptrs_enabled=True))}[case]
    _tx, cfg = _shape_configs(nof_rb=24, mod=mod, rate=0.4 if mod != Modulation.PI_2_BPSK
                              else 0.234, **extra)
    llrs = torch.stack([_noisy_llrs(cfg.sch, 8), _noisy_llrs(cfg.sch, 9)])
    if cfg.ptrs_enabled:
        llrs[:, torch.from_numpy(pusch._ptrs_bit_positions(cfg).astype(np.int64))] = 0
    assert sch._fused_decode_ok(cfg.sch)
    for early in (False, True):
        before = decoder.decode_dematch.launches
        bits_k, it_k = sch._fused_decode(llrs.to(cuda_device), cfg.sch, 6, early)
        assert decoder.decode_dematch.launches == before + 1
        bits_p, it_p = sch._fused_decode(llrs, cfg.sch, 6, early)
        np.testing.assert_array_equal(to_np(bits_k), to_np(bits_p))
        np.testing.assert_array_equal(to_np(it_k), to_np(it_p))


@pytest.mark.parametrize("ports, layers, method", [(4, 4, "mmse"), (4, 2, "zf"), (2, 1, "mmse")])
def test_equalize_per_re_card_matches_cpu(cuda_device, ports, layers, method):  # noqa: F811
    """The per-RE equalizer on the card against the CPU, channels of
    condition number below 20: within 1e-4 x max(1, |.|)."""
    rng = np.random.default_rng(layers)
    h = ((rng.standard_normal((3000, ports, layers)) + 1j * rng.standard_normal(
        (3000, ports, layers))) * 0.5).astype(np.complex64)
    h = h[np.linalg.cond(h) < 20][:1000]
    y = ((rng.standard_normal((len(h), ports)) + 1j * rng.standard_normal((len(h), ports)))
         * 0.5).astype(np.complex64)
    ins = (torch.from_numpy(y), torch.from_numpy(h), torch.tensor(0.02))
    cpu = equalizer.equalize(*ins, method=method)
    gpu = equalizer.equalize(*(t.to(cuda_device) for t in ins), method=method)
    for a, b in zip(cpu, gpu):
        a, b = to_np(a), to_np(b)
        assert (np.abs(a - b) <= 1e-4 * np.maximum(1.0, np.abs(a))).all()


def test_deprecode_and_cpe_card_match_cpu(cuda_device):  # noqa: F811
    """The DFT-s deprecode stage (1e-5 x RMS, noise rtol 1e-6) and the PT-RS
    common phase per symbol (1e-5 rad) on the card against the CPU."""
    _tx, cfg = _shape_configs(nof_rb=12, mod=Modulation.QPSK, transform_precoding=True)
    rng = np.random.default_rng(2)
    n = 12 * 12 * 12
    x = torch.from_numpy((rng.standard_normal((2, n, 1)) + 1j * rng.standard_normal((2, n, 1)))
                         .astype(np.complex64))
    nv = torch.from_numpy(rng.uniform(0.01, 1.0, (2, n, 1)).astype(np.float32))
    xc, nc = pusch._deprecode_stage(x, nv, cfg)
    xg, ng = pusch._deprecode_stage(x.to(cuda_device), nv.to(cuda_device), cfg)
    rms = float(xc.abs().pow(2).mean().sqrt())
    assert float((xg.cpu() - xc).abs().max()) <= 1e-5 * rms
    np.testing.assert_allclose(to_np(ng), to_np(nc), rtol=1e-6)

    tx, cfg = _shape_configs(nof_rb=24, layers=4, ports=4, mod=Modulation.QAM256, rate=0.7,
                             ptrs_enabled=True)
    _tb, grid = _shape_grid(tx, seed=3, snr_db=30.0, phase=1.0)
    phases = {}
    for dev in ("cpu", cuda_device):
        g = grid.to(dev)
        _gf, h, _nv = pusch._estimate_stage(g, cfg)
        phases[str(dev)] = pusch.cpe_phases(g.reshape(1, 4, -1), h, cfg).cpu()
    d = (phases[str(cuda_device)] * phases["cpu"].conj()).angle().abs().max()
    assert float(d) <= 1e-5


@pytest.mark.parametrize("shape", ["type2-4x4", "ptrs-4x4", "dfts-pi2bpsk", "cdm1-zf"])
def test_new_shapes_on_card_match_cpu(cuda_device, shape):  # noqa: F811
    """pusch.process on the card against the CPU for each new shape: int8
    LLRs within +-1, TB bits and CRC equal (and right)."""
    kw = {"type2-4x4": dict(layers=4, ports=4, mod=Modulation.QAM64, dmrs_type=2),
          "ptrs-4x4": dict(layers=4, ports=4, mod=Modulation.QAM256, rate=0.7,
                           ptrs_enabled=True),
          "dfts-pi2bpsk": dict(ports=4, mod=Modulation.PI_2_BPSK, rate=0.234,
                               transform_precoding=True),
          "cdm1-zf": dict(layers=2, ports=4, cdm=1)}[shape]
    tx, cfg = _shape_configs(**kw)
    if shape == "cdm1-zf":
        cfg = pusch.dataclasses.replace(cfg, equalizer="zf")
    tb, grid = _shape_grid(tx, seed=4, snr_db=30.0, phase=1.0 if cfg.ptrs_enabled else 0.0)
    outs, llrs = {}, {}
    for dev in ("cpu", cuda_device):
        rnti = torch.tensor([0x4601], device=dev)
        llrs[str(dev)] = pusch._front_end(grid.to(dev), rnti, cfg)[0].cpu()
        outs[str(dev)] = pusch.process(grid.to(dev), rnti, cfg)
    d = (llrs["cpu"].int() - llrs[str(cuda_device)].int()).abs()
    assert int(d.max()) <= 1
    for key in ("cpu", str(cuda_device)):
        assert bool(outs[key]["tb_crc_ok"][0])
        np.testing.assert_array_equal(to_np(outs[key]["tb_bits"][0].cpu()), tb)


# ---- the reference-exact conformance modes -----------------------------------------

def test_decode_i8_card_matches_cpu(cuda_device):  # noqa: F811
    """decode_i8 on the card: bits and a-posteriori LLRs equal to the CPU's
    (integer lanes; the only float step, floor(0.8f m + 0.5), is one
    rounding on either device)."""
    from srsran_project_tpu_torch.ops.ldpc import graphs

    for bg, z in ((1, 384), (2, 52)):
        rng = np.random.default_rng(bg)
        n = (graphs.get_graph(bg, z).n - 2) * z
        x = torch.from_numpy(np.round(rng.standard_normal((4, n)) * 30).clip(-127, 127)
                             .astype(np.int8))
        cpu = decoder.decode_i8(x, bg, z, 6)
        gpu = decoder.decode_i8(x.to(cuda_device), bg, z, 6)
        for a, b in zip(cpu, gpu):
            assert torch.equal(a, b.cpu()), (bg, z)


@pytest.mark.parametrize("mod", [Modulation.PI_2_BPSK, Modulation.QPSK, Modulation.QAM16,
                                 Modulation.QAM64, Modulation.QAM256])
def test_demap_llr_i8_card_matches_cpu(cuda_device, mod):  # noqa: F811
    """The int8 interval demapper on the card: every LLR equal to the CPU's."""
    from srsran_project_tpu_torch.ops.modulation import demapper_i8

    rng = np.random.default_rng(int(mod))
    x = torch.from_numpy(((rng.standard_normal(20000) + 1j * rng.standard_normal(20000)) * 0.8)
                         .astype(np.complex64))
    nv = torch.from_numpy(np.abs(rng.standard_normal(20000) * 0.3).astype(np.float32))
    nv[:50] = 0.0
    cpu = demapper_i8.demap_llr_i8(x, nv, mod)
    gpu = demapper_i8.demap_llr_i8(x.to(cuda_device), nv.to(cuda_device), mod)
    assert torch.equal(cpu, gpu.cpu())


@pytest.mark.parametrize("kw", [dict(layers=4, ports=4, mod=Modulation.QAM256, rate=0.7),
                                dict(layers=2, ports=2, mod=Modulation.QAM64)],
                         ids=["ref-est-4x4", "conformance-2x2"])
def test_reference_modes_on_card_match_cpu(cuda_device, kw):  # noqa: F811
    """The reference estimator (4x4: then K3 and K1) and the whole
    conformance chain (reference estimator, zf_ref, the int8 demapper,
    decode_i8) through pusch.process on the card against the CPU: the
    estimate within 1e-4 x its RMS (cuFFT and pocketfft round apart),
    int8 LLRs within +-1, TB bits and CRC equal (and right)."""
    tx, cfg = _shape_configs(**kw)
    fields = dict(estimator="reference")
    if kw["layers"] == 2:
        fields.update(equalizer="zf_ref", demapper="reference", ldpc_decoder="reference_i8")
    cfg = pusch.dataclasses.replace(cfg, **fields)
    tb, grid = _shape_grid(tx, seed=5, snr_db=30.0)
    outs, llrs, hs = {}, {}, {}
    for dev in ("cpu", cuda_device):
        rnti = torch.tensor([0x4601], device=dev)
        hs[str(dev)] = pusch._estimate_stage(grid.to(dev), cfg)[1].cpu()
        llrs[str(dev)] = pusch._front_end(grid.to(dev), rnti, cfg)[0].cpu()
        outs[str(dev)] = pusch.process(grid.to(dev), rnti, cfg)
    h_cpu, h_gpu = hs["cpu"], hs[str(cuda_device)]
    assert float((h_cpu - h_gpu).abs().max()) <= 1e-4 * float(h_cpu.abs().pow(2).mean().sqrt())
    assert int((llrs["cpu"].int() - llrs[str(cuda_device)].int()).abs().max()) <= 1
    for key in ("cpu", str(cuda_device)):
        assert bool(outs[key]["tb_crc_ok"][0])
        np.testing.assert_array_equal(to_np(outs[key]["tb_bits"][0].cpu()), tb)


def test_slot_pipeline_waits_on_the_card(cuda_device):  # noqa: F811
    """SlotPipeline on the card: a DL slot in flight carries a CUDA event
    recorded at dispatch; the flushed grids equal UpperPhy's own, in
    dispatch order; a slot whose deadline passed a second ago is late."""
    import time

    from srsran_project_tpu_torch.fapi import messages as fapi
    from srsran_project_tpu_torch.phy.allocation import Allocation
    from srsran_project_tpu_torch.phy.pdsch import PdschConfig
    from srsran_project_tpu_torch.phy.slot_pipeline import SlotPipeline
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig
    from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing
    from srsran_project_tpu_torch.ran.slot_point import SlotPoint

    cfg = PdschConfig(tbs=304, target_code_rate=0.3, modulation=Modulation.QPSK,
                      alloc=Allocation(rb_start=0, rb_count=6, sym_start=1, sym_count=12,
                                       dmrs_symbols=(2,)))
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(4):
        slot = SlotPoint.from_sfn_slot(SubcarrierSpacing.KHZ30, 0, i)
        tb = rng.integers(0, 2, size=(304,), dtype=np.uint8)
        reqs.append((fapi.DlTtiRequest(slot=slot, pdsch=[
            fapi.DlPdschPdu(cfg, 0x11, np.eye(1, dtype=np.complex64), 0)]),
            fapi.TxDataRequest(slot=slot, payloads=[tb])))
    phy = UpperPhy(UpperPhyConfig(nof_ports=1, device="cuda"))
    pipe = SlotPipeline(phy, depth=2)
    now = time.monotonic()
    for req in reqs[:3]:
        pipe.push_dl_slot(*req, deadline_s=now + 30.0)
        assert isinstance(pipe._inflight[-1][2][1], torch.cuda.Event)
    grids = pipe.flush()
    assert pipe.report()["late"] == 0 and len(grids) == 3
    for grid, req in zip(grids, reqs):
        assert grid.is_cuda and torch.equal(grid, phy.process_dl_tti(*req))
    pipe.push_dl_slot(*reqs[3], deadline_s=now - 1.0)
    pipe.flush()
    assert pipe.report()["late"] == 1 and pipe.errors


def test_scheduled_slot_on_card_matches_cpu(cuda_device):  # noqa: F811
    """Two slots of the port's RoundRobinScheduler (24 PRB, 2 grants a
    slot) through UpperPhy on the card (K2 for the two grants) and on the
    CPU, on the same received grid: the same CRCs and TB bits."""
    from srsran_project_tpu_torch.l2sim.scheduler import RoundRobinScheduler, SchedulerConfig
    from srsran_project_tpu_torch.phy import channel_emulator as chem
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig
    from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing
    from srsran_project_tpu_torch.ran.slot_point import SlotPoint

    s = RoundRobinScheduler(SchedulerConfig(nof_rb=24, nof_grid_sc=288, max_ues_per_slot=2))
    for i in range(3):
        s.add_ue(0x900 + i, mcs=12)
    phys = {d: UpperPhy(UpperPhyConfig(nof_ports=1, nof_grid_sc=288, device=d))
            for d in ("cpu", "cuda")}
    ch = chem.ChannelConfig(profile="single", sinr_db=30.0, nof_sc=288)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    for k in range(2):
        dl, tx, ul, grants = s.run_slot(SlotPoint(SubcarrierSpacing.KHZ30, k), rng)
        rx, _, _ = chem.apply_channel(phys["cpu"].process_dl_tti(dl, tx), gen, ch)
        before = decoder.decode.launches
        got = {d: phy.process_ul_tti(ul, rx.to(d)) for d, phy in phys.items()}
        assert decoder.decode.launches == before + 1
        for c_cpu, c_gpu in zip(got["cpu"].crc, got["cuda"].crc):
            assert c_cpu.tb_crc_ok and c_gpu.tb_crc_ok
        for r_cpu, r_gpu in zip(got["cpu"].rx_data, got["cuda"].rx_data):
            np.testing.assert_array_equal(r_cpu.payload, r_gpu.payload)
        s.handle_results(got["cuda"])


@pytest.mark.parametrize("early_stop", [False, True])
def test_k1_msg3_grant_matches_plain(cuda_device, early_stop):  # noqa: F811
    """K1 at a Msg3-sized grant (72 bits, QPSK, one layer, 2 PRB: BG2,
    no repetition, so the fused path takes it) against its plain version:
    bits and iterations equal."""
    from srsran_project_tpu_torch.phy.allocation import Allocation

    cfg = pusch.PuschConfig(
        tbs=72, target_code_rate=0.25, modulation=Modulation.QPSK,
        alloc=Allocation(rb_start=0, rb_count=2, sym_start=2, sym_count=12, dmrs_symbols=(2,)),
        nof_layers=1, nof_rx_ports=4, nof_grid_sc=24).sch
    assert sch._fused_decode_ok(cfg)
    llrs = torch.stack([_noisy_llrs(cfg, s) for s in (3, 4, 5)])
    before = decoder.decode_dematch.launches
    bits_k, it_k = sch._decode_groups(llrs.to(cuda_device), cfg, 6, early_stop)
    assert decoder.decode_dematch.launches == before + 1
    bits_p, it_p = sch._decode_groups(llrs, cfg, 6, early_stop)
    np.testing.assert_array_equal(to_np(bits_k), to_np(bits_p))
    np.testing.assert_array_equal(to_np(it_k), to_np(it_p))


@pytest.mark.parametrize("bg, z", [(1, 384), (2, 36)])
def test_decode_count_iters_card_matches_cpu(cuda_device, bg, z):  # noqa: F811
    """decode_count_iters (plain torch, no kernel) on a CUDA tensor: bits,
    a-posteriori LLRs and counts equal its CPU result exactly."""
    from srsran_project_tpu_torch.ops.ldpc import encoder, graphs

    g = graphs.get_graph(bg, z)
    rng = np.random.default_rng(z)
    msg = torch.from_numpy(rng.integers(0, 2, size=(6, g.kb * z), dtype=np.uint8))
    cw = to_np(encoder.encode_to_buffer(msg, bg, z))
    sigma = 4.0 * (1.0 + 0.3 * np.arange(6))[:, None]
    llr = np.clip(np.round((1.0 - 2.0 * cw) * 8.0 + rng.normal(0.0, 1.0, cw.shape) * sigma),
                  -120, 120).astype(np.int8)
    got = decoder.decode_count_iters(torch.from_numpy(llr).to(cuda_device), bg, z, 6)
    want = decoder.decode_count_iters(torch.from_numpy(llr), bg, z, 6)
    for a, b in zip(got, want):
        assert a.is_cuda and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("k, e, qm", [(1, 8, 2), (2, 16, 4), (3, 32, 2), (11, 252, 8)])
def test_detect_ref_card_matches_cpu(cuda_device, k, e, qm):  # noqa: F811
    """short_block.detect_ref on CUDA int8 LLRs: bits and ok flags equal
    its CPU result exactly (integer scores, the same float32 metric)."""
    x = torch.from_numpy(np.random.default_rng(k).integers(-127, 128, size=(2048, e))
                         .astype(np.int8))
    got = short_block.detect_ref(x.to(cuda_device), k, e, qm)
    want = short_block.detect_ref(x, k, e, qm)
    for a, b in zip(got, want):
        assert a.is_cuda and torch.equal(a.cpu(), b)


# ---- the RU path -------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["0", "B4"])
def test_generic_ru_on_card_matches_cpu(cuda_device, fmt):  # noqa: F811
    """RuGeneric on CUDA tensors (DL grid, UL samples with a PRACH window)
    equals the same RU on the CPU: modulated samples, demodulated grid and
    PRACH buffer within 1e-4 x RMS (cuFFT against pocketfft), each left on
    its device."""
    from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing
    from srsran_project_tpu_torch.ran.slot_point import SlotPoint
    from srsran_project_tpu_torch.ru import (PrachBufferContext, ResourceGridContext,
                                             RuGeneric, RuGenericConfig)

    class Col:
        def __init__(self):
            self.grid, self.prach = None, None

        def on_new_uplink_symbol(self, context, grid, is_valid):
            self.grid = grid

        def on_new_prach_window_data(self, context, buffer):
            self.prach = buffer

    rng = np.random.default_rng(3)
    grid = (rng.standard_normal((4, 14, 3276)) + 1j * rng.standard_normal((4, 14, 3276))
            ).astype(np.complex64)
    slot = SlotPoint.from_sfn_slot(SubcarrierSpacing.KHZ30, 2, 1)
    tail = (rng.standard_normal((4, 61440)) + 1j * rng.standard_normal((4, 61440))
            ).astype(np.complex64)
    out = {}
    for dev in ("cpu", cuda_device):
        col, sent = Col(), {}
        ru = RuGeneric(RuGenericConfig(dft_size=4096, nof_rb=273, device=str(dev)), col,
                       transmit_cb=sent.__setitem__)
        ctx = ResourceGridContext(slot=slot)
        ru.handle_dl_data(ctx, torch.from_numpy(grid).to(dev))
        ru.advance_slot(slot)
        samples = sent[slot]
        assert samples.device.type == torch.device(dev).type
        # A format-0 occasion (1 ms) runs into the next slot: push two
        # slots of baseband, numpy in, moved to the RU's device.
        ru.push_ul_samples(slot, np.concatenate([to_np(samples), tail], axis=-1))
        ru.handle_new_uplink_slot(ctx)
        ru.handle_prach_occasion(PrachBufferContext(slot=slot, format=fmt, rb_offset=258
                                                    if fmt == "0" else 200))
        ru.advance_slot(slot)
        assert col.grid.device.type == col.prach.device.type == torch.device(dev).type
        out[str(dev)] = [to_np(x) for x in (samples, col.grid, col.prach)]
    for got, want in zip(out[str(cuda_device)], out["cpu"]):
        rms = np.sqrt(np.mean(np.abs(want) ** 2))
        assert np.abs(got - want).max() <= 1e-4 * rms


def test_apply_channel_time_on_card_matches_cpu(cuda_device):  # noqa: F811
    """The time-domain TDL's applying part on the card equals the CPU on
    the same draws within 1e-5 x RMS; the card's own draws run there."""
    from srsran_project_tpu_torch.phy import channel_emulator as chem

    cfg = chem.ChannelConfig(profile="tdla", sinr_db=20.0, nof_tx_ports=4, nof_rx_ports=4)
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((4, 61440)) + 1j * rng.standard_normal((4, 61440))).astype(np.complex64)
    gen = torch.Generator().manual_seed(2)
    gains = chem.draw_channel_time(gen, cfg, 122.88e6)
    noise = chem._complex_normal((4, 61440), gen)
    want = to_np(chem.apply_channel_time_taps(torch.from_numpy(x), gains, noise, cfg, 122.88e6))
    got = to_np(chem.apply_channel_time_taps(torch.from_numpy(x).to(cuda_device),
                                             gains.to(cuda_device), noise.to(cuda_device), cfg,
                                             122.88e6))
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    assert np.abs(got - want).max() <= 1e-5 * rms
    y = chem.apply_channel_time(torch.from_numpy(x).to(cuda_device),
                                torch.Generator(device=cuda_device).manual_seed(2), cfg, 122.88e6)
    assert y.device.type == cuda_device.type and y.shape == (4, 61440) and torch.isfinite(y).all()


def test_gnb_slot_pair_on_card_matches_cpu(cuda_device, monkeypatch):  # noqa: F811
    """Two slots of the monolithic gNB (``apps/gnb_sim.run``, 2 UEs) on the
    card and on the CPU, given one numpy-drawn channel: every UpperPhy
    call's DL grid within 1e-5 x RMS, its CRCs and decoded TB bits exactly.
    Every K1 and K2 launch of the card run (the slot's two grants through
    K2, each UL-leg grant alone through K1) equals its plain version on the
    same inputs bitwise."""
    from srsran_project_tpu_torch.apps import gnb_sim
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy

    def channel(seed):
        rng = np.random.default_rng(seed)

        def apply(grid):
            x = to_np(grid)
            sigma = np.sqrt(10.0 ** (-25.0 / 10.0) / 2.0)
            noise = sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
            return torch.from_numpy((x + noise).astype(np.complex64)).to(grid.device)
        return apply

    launches = []

    def capture(mod, name):
        fn = getattr(mod, name)

        def wrapped(llrs, *a, **kw):
            out = fn(llrs, *a, **kw)
            if llrs.is_cuda:
                launches.append((fn, llrs.clone(), a, kw, out))
            return out
        monkeypatch.setattr(mod, name, wrapped)

    capture(sch, "decode_dematch_groups")
    capture(sch, "decode")
    capture(ul_slot, "decode")
    runs = {}
    for dev in ("cpu", "cuda"):
        calls = []
        dl, ul = UpperPhy.process_dl_tti, UpperPhy.process_ul_tti
        monkeypatch.setattr(UpperPhy, "process_dl_tti",
                            lambda self, r, t, f=dl, c=calls: c.append(f(self, r, t)) or c[-1])
        monkeypatch.setattr(UpperPhy, "process_ul_tti",
                            lambda self, r, g, f=ul, c=calls: c.append(f(self, r, g)) or c[-1])
        argv = ["--ues", "2", "--packets", "2", "--slots", "2"] + (["--cpu"] if dev == "cpu" else [])
        k1, k2 = decoder.decode_dematch.launches, decoder.decode.launches
        gnb_sim.run(gnb_sim._parser().parse_args(argv), channel=channel(3))
        runs[dev] = (calls, decoder.decode_dematch.launches - k1, decoder.decode.launches - k2)
        monkeypatch.setattr(UpperPhy, "process_dl_tti", dl)
        monkeypatch.setattr(UpperPhy, "process_ul_tti", ul)
    (cpu, _, _), (gpu, n_k1, n_k2) = runs["cpu"], runs["cuda"]
    assert len(cpu) == len(gpu) >= 4 and n_k1 >= 1 and n_k2 >= 1
    for a, b in zip(cpu, gpu):
        if isinstance(a, torch.Tensor):
            assert b.is_cuda
            rms = float(a.abs().pow(2).mean().sqrt())
            assert float((b.cpu() - a).abs().max()) <= 1e-5 * rms
        else:
            assert [(c.rnti, c.tb_crc_ok) for c in a.crc] == [(c.rnti, c.tb_crc_ok) for c in b.crc]
            for x, y in zip(a.rx_data, b.rx_data):
                np.testing.assert_array_equal(x.payload, y.payload)
    assert len(launches) == n_k1 + n_k2
    for fn, llrs, a, kw, out in launches:
        want = fn(llrs.cpu(), *a, **kw)
        for x, y in zip(out, want):
            if x is not None:
                np.testing.assert_array_equal(to_np(x), to_np(y))
