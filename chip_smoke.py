#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its flagship slot on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``srsran_project_tpu_torch/csrc``
(into ``build/``), checks each kernel against its plain torch version on
the card at the flagship shapes, then drives the flagship cell (273 PRB,
30 kHz, 4x4, 256QAM r~0.926, LBRM) end to end through the port's public
entry points: 8 random transport blocks -> ``encode_slot`` -> AWGN at
30 dB -> ``decode_slot``, every CRC and every bit checked, and the
kernels' launch counters read around that one decode.  It then times the
encode and decode per slot, the decode's stages, and each kernel against
its plain version.

Output: progress and timing lines, then one JSON line with the kernels,
the card's name and power limit, and as the LAST line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises (non-zero exit, no result line).  There is no CPU
path: without a CUDA device the script exits non-zero.  JAX is never
imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

SNR_DB = 30.0
NOF_SLOTS = 8
RNTI = 0x4601
SEED = 0


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() in ms: CUDA events around `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(card: str):
    """K1 and K3 against their plain versions on the card, at the flagship
    shapes; returns the per-kernel entries of the JSON line (without
    launch counts)."""
    import torch

    from srsran_project_tpu_torch.models.cell import CellConfig
    from srsran_project_tpu_torch.ops import equalizer
    from srsran_project_tpu_torch.ops.ldpc import decoder
    from srsran_project_tpu_torch.phy import sch as sch_mod

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    cfg = CellConfig().pusch_cfg.sch
    seg = cfg.seg
    n_cb = cfg.n_cb or seg.full_codeword_bits

    # K1: int8 LLRs around a valid flagship codeword, per E-group.
    tb = torch.from_numpy(rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8)).to(dev)
    cw = sch_mod.encode_transport_block(tb, cfg).cpu().numpy()
    llr = (1.0 - 2.0 * cw.astype(np.float32)) * 14.0 + rng.normal(0.0, 4.0, size=cw.shape)
    llr = torch.from_numpy(np.clip(np.round(llr), -120, 120).astype(np.int8)).to(dev)
    groups = []
    off = 0
    for _start, count, e in sch_mod._e_groups(cfg.cb_e_bits):
        groups.append((llr[off : off + count * e].reshape(count, e).contiguous(), e))
        off += count * e
    args = (seg.base_graph, seg.lifting_size, seg.nof_payload_bits_per_cb)

    def k1(span, e, iters, early):
        return decoder.decode_dematch(span, *args, e, cfg.rv, cfg.qm, n_cb, iters, early)

    def k1_plain(span, e, iters, early):
        plan = decoder.dematch_decode_plan(*args, e, cfg.rv, cfg.qm, n_cb)
        return decoder.layered_min_sum(decoder.assemble_buffer(span, plan), plan, iters, early)

    k1_err = 0
    for span, e in groups:
        for early in (False, True):
            bits_k, it_k = k1(span, e, 6, early)
            bits_p, it_p = k1_plain(span, e, 6, early)
            torch.cuda.synchronize()
            nbad = int((bits_k != bits_p).sum())
            k1_err = max(k1_err, int((bits_k.int() - bits_p.int()).abs().max()))
            if nbad:
                fail(f"K1 E={e} early_stop={early}: {nbad} bits differ from the plain version")
            if early and not torch.equal(it_k, it_p):
                fail(f"K1 E={e}: per-codeblock iteration counts differ from the plain version")
            if not early and not bool((it_k == 6).all()):
                fail("K1: fixed-budget iteration count is not 6")
        print(f"# K1 E={e} C={span.shape[0]}: bits equal (6 iterations; early stop: bits and "
              f"iterations equal, mean {it_k.float().mean().item():.2f} iterations)")
    k1_ms = sum(cuda_ms(lambda s=s, e=e: k1(s, e, 6, True), reps=20) for s, e in groups)
    k1_plain_ms = sum(cuda_ms(lambda s=s, e=e: k1_plain(s, e, 6, True), reps=3)
                      for s, e in groups)
    print(f"# [{card}] K1 decode_dematch, flagship slot (2 E-groups, early stop): "
          f"kernel {k1_ms:.4f} ms, plain torch {k1_plain_ms:.4f} ms")

    # K3: random 4x4 channels at the flagship's 3276 subcarriers.
    nsc, nv = 3276, 0.013
    h_np = ((rng.standard_normal((nsc, 4, 4)) + 1j * rng.standard_normal((nsc, 4, 4)))
            * 0.5).astype(np.complex64)
    h = torch.from_numpy(h_np).to(dev)
    nv_t = torch.tensor(nv, dtype=torch.float32, device=dev)
    w_k, ev_k = equalizer.mmse_weights_4x4(h, nv_t)
    w_p, ev_p = equalizer.equalize_weights(h, nv_t)
    torch.cuda.synchronize()
    k3_err = float((w_k - w_p).abs().max())
    scale = max(1.0, float(w_p.abs().max()))
    ev_err = float((ev_k - ev_p).abs().max())
    if not (k3_err <= 1e-4 * scale and ev_err <= 1e-4):
        fail(f"K3 vs plain: max|dW| {k3_err:.3e} (limit {1e-4 * scale:.3e}), "
             f"max|d eq_nvar| {ev_err:.3e} (limit 1e-4)")
    w64, ev64 = _mmse_oracle64(h_np, nv)
    o_err = max(float(np.abs(w_k.cpu().numpy() - w64).max()),
                float(np.abs(ev_k.cpu().numpy() - ev64).max()))
    if not o_err <= 1e-2:
        fail(f"K3 vs float64 oracle: {o_err:.3e} > 1e-2")
    print(f"# K3 nsc={nsc}: vs plain max|dW| {k3_err:.3e}, max|d eq_nvar| {ev_err:.3e}; "
          f"vs f64 oracle {o_err:.3e}")
    k3_ms = cuda_ms(lambda: equalizer.mmse_weights_4x4(h, nv_t), reps=50)
    k3_plain_ms = cuda_ms(lambda: equalizer.equalize_weights(h, nv_t), reps=10)
    print(f"# [{card}] K3 mmse_weights_4x4, one slot (3276 subcarriers): "
          f"kernel {k3_ms:.4f} ms, plain torch {k3_plain_ms:.4f} ms")

    return [
        {"name": "decode_dematch", "route": "cuda",
         "source": "srsran_project_tpu_torch/csrc/ldpc_decode_dematch.cu",
         "replaces": "srsran_project_tpu/ops/ldpc/decoder_pallas.py:322",
         "max_abs_err": float(k1_err), "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "mmse_weights_4x4", "route": "cuda",
         "source": "srsran_project_tpu_torch/csrc/mmse_weights_4x4.cu",
         "replaces": "srsran_project_tpu/ops/equalizer_pallas.py:132",
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms},
    ]


def _mmse_oracle64(h, nv):
    """float64 MMSE weights and post-equalization noise (numpy oracle)."""
    hh = h.astype(np.complex128)
    hH = np.conj(np.swapaxes(hh, -1, -2))
    g = hH @ hh
    ci = np.linalg.inv(g + nv * np.eye(4))
    mu = np.clip(np.real(np.einsum("nij,nji->ni", ci, g)), 1e-9, 1 - 1e-9)
    return (ci @ hH) / mu[..., None], (1.0 - mu) / mu


def slice_phase(card: str):
    """The flagship slot end to end; returns the launch counts of the one
    batched decode."""
    import torch

    from srsran_project_tpu_torch.models import cell
    from srsran_project_tpu_torch.ops import equalizer, ofdm
    from srsran_project_tpu_torch.ops.ldpc import decoder
    from srsran_project_tpu_torch.phy import pusch, sch as sch_mod

    dev = torch.device("cuda")
    cfg = cell.CellConfig()
    rng = np.random.default_rng(SEED + 1)
    tb = torch.from_numpy(rng.integers(0, 2, size=(NOF_SLOTS, cfg.tbs), dtype=np.uint8)).to(dev)
    w = torch.eye(cfg.nof_layers, cfg.nof_ports, dtype=torch.complex64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    iq = cell.encode_slot(tb, RNTI, w, cfg)
    sig_pow = (iq.abs() ** 2).mean(dim=(1, 2), keepdim=True)
    noise = torch.randn(iq.shape, dtype=torch.complex64, device=dev, generator=gen)
    rx = iq + noise * torch.sqrt(sig_pow * 10.0 ** (-SNR_DB / 10.0))
    torch.cuda.synchronize()

    decoder.decode_dematch.launches = 0
    equalizer.mmse_weights_4x4.launches = 0
    out = cell.decode_slot(rx, RNTI, cfg)
    torch.cuda.synchronize()
    launches = {"decode_dematch": decoder.decode_dematch.launches,
                "mmse_weights_4x4": equalizer.mmse_weights_4x4.launches}

    nof_groups = len(sch_mod._e_groups(cfg.pusch_cfg.sch.cb_e_bits))
    if launches != {"decode_dematch": nof_groups, "mmse_weights_4x4": 1}:
        fail(f"launch counts {launches}, want {nof_groups} K1 and 1 K3 per batched decode")
    if tuple(out["tb_bits"].shape) != (NOF_SLOTS, cfg.tbs):
        fail(f"tb_bits shape {tuple(out['tb_bits'].shape)}")
    crc_ok = out["tb_crc_ok"].cpu().numpy()
    bit_errors = (out["tb_bits"] != tb).sum(dim=1).cpu().numpy()
    snr_db = out["snr_db"].cpu().numpy()
    noise_var = out["noise_var"].cpu().numpy()
    print(f"# slice: {NOF_SLOTS} flagship slots, CRC ok {crc_ok.tolist()}, bit errors "
          f"{bit_errors.tolist()}, SINR dB {np.round(snr_db, 2).tolist()}")
    if not crc_ok.all() or bit_errors.any():
        fail("flagship decode is not CRC-clean with every bit right")
    if not (np.isfinite(noise_var).all() and np.isfinite(snr_db).all()):
        fail("non-finite noise_var / snr_db")
    if not ((snr_db > SNR_DB - 5).all() and (snr_db < SNR_DB + 5).all()):
        fail(f"post-equalization SINR {snr_db} far from the {SNR_DB} dB channel")

    # Timing: per-slot encode and decode at batch 1 and 8 (device time
    # between CUDA events; the eager host launches are inside it).
    for b in (1, NOF_SLOTS):
        enc = cuda_ms(lambda: cell.encode_slot(tb[:b], RNTI, w, cfg), reps=5) / b
        dec = cuda_ms(lambda: cell.decode_slot(rx[:b], RNTI, cfg), reps=5) / b
        print(f"# [{card}] flagship batch {b}: encode {enc:.4f} ms/slot, "
              f"decode {dec:.4f} ms/slot, encode+decode {1000.0 / (enc + dec):.1f} slots/s")

    # Where the decode time goes, stage by stage, at batch 8.
    pc = cfg.pusch_cfg
    rnti_t = torch.full((NOF_SLOTS,), RNTI, dtype=torch.int64, device=dev)
    grid = ofdm.demodulate_slot(rx, cfg.nof_rb, cfg.scs, cfg.dft_size, cfg.cp, 0,
                                f_center_hz=cfg.f_center_hz)
    gflat, h, nv = pusch._estimate_stage(grid, pc)
    x_hat, eq_nvar = pusch._equalize_stage(gflat, h, nv, pc)
    llr_i8, _ = pusch._demap_stage(x_hat, eq_nvar, rnti_t, pc)
    bits, _ = sch_mod._fused_decode(llr_i8, pc.sch, pc.nof_ldpc_iterations, True)
    stages = {
        "ofdm_demod": lambda: ofdm.demodulate_slot(rx, cfg.nof_rb, cfg.scs, cfg.dft_size,
                                                   cfg.cp, 0, f_center_hz=cfg.f_center_hz),
        "estimate": lambda: pusch._estimate_stage(grid, pc),
        "equalize": lambda: pusch._equalize_stage(gflat, h, nv, pc),
        "demap": lambda: pusch._demap_stage(x_hat, eq_nvar, rnti_t, pc),
        "ldpc": lambda: sch_mod._fused_decode(llr_i8, pc.sch, pc.nof_ldpc_iterations, True),
        "desegment_crc": lambda: sch_mod._desegment_stage(bits, pc.sch, (NOF_SLOTS,)),
    }
    parts = {k: cuda_ms(fn, reps=5) / NOF_SLOTS for k, fn in stages.items()}
    print(f"# [{card}] decode stages at batch {NOF_SLOTS}, ms/slot: "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs an NVIDIA GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "srsran_project_tpu_torch")):
        fail("run from a checkout of the repository (srsran_project_tpu_torch/ missing)")
    sys.path.insert(0, here)
    card = card_line()
    print(f"# card: {card}")
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    from srsran_project_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    built = not cuda_lib.library_path().exists()
    cuda_lib.library()
    print(f"# kernels {'built' if built else 'found'} in {time.perf_counter() - t0:.1f} s: "
          f"{cuda_lib.library_path().name}")
    log = cuda_lib.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"#   ptxas: {line.strip()}")

    kernels = kernel_phase(card)
    launches = slice_phase(card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
