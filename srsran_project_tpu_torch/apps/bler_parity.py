"""BLER parity against the reference, at the reference's own operating points.

Port of ``benchmarks/bler_parity.py``'s ``run_case``: each operating point
of a BLER-parity manifest (the reference's pusch chain measured through
its TDL channel emulator: CRC BLER and LDPC iteration statistics per
point) is replayed through the port's chain, ``chunk`` slots at a time
along the leading dimension: ``pusch.transmit`` -> the TDL (A/B/C) or
single-tap emulator under the "fixed" noise convention, one channel draw
a slot -> ``pusch._front_end`` -> rate dematch -> ``decode`` (kernel K2 on
the card, 6 iterations, early stop per codeblock) -> desegment + CRC.

TBs come from a numpy generator and channels from a ``torch.Generator``,
both seeded, so the draws differ from the reference's: agreement is
statistical (a binomial bound around the manifest's BLER).

Usage:
  python -m srsran_project_tpu_torch.apps.bler_parity MANIFEST [--slots N]
      [--cases 0,7,8] [--fast] [--cpu]

It prints one row per case and writes no file.  It runs on the GPU unless
``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

RNTI = 0x4601
SEED = 0xB1E5  # the TBs' numpy generator; the channels' torch.Generator takes SEED + 1
PROFILES = {"TDLA": "tdla", "TDLB": "tdlb", "TDLC": "tdlc", "single-tap": "single"}


def case_config(case: dict, parity_kernels: bool):
    """(PuschConfig, ChannelConfig) of one manifest row: the whole slot
    (symbols 0-13, DM-RS on 2 and 11) on nof_prb PRB, one port per layer;
    with ``parity_kernels`` the reference estimator; ZF where the
    reference measured with ZF."""
    from ..ops.modulation import Modulation
    from ..phy import channel_emulator as chem
    from ..phy import pusch
    from ..phy.allocation import Allocation

    nof_prb, nl = case["nof_prb"], int(case.get("layers", 1))
    extra = {}
    if parity_kernels:
        extra["estimator"] = "reference"
    if case.get("equalizer") == "zf" and not case.get("ref_unsupported"):
        extra["equalizer"] = "zf"
    cfg = pusch.PuschConfig(
        tbs=case["tbs"], target_code_rate=case["rate"], modulation=Modulation(case["qm"]),
        alloc=Allocation(rb_start=0, rb_count=nof_prb, sym_start=0, sym_count=14,
                         dmrs_symbols=(2, 11)),
        nof_layers=nl, nof_rx_ports=nl, nof_grid_symbols=14, nof_grid_sc=nof_prb * 12,
        slot_in_frame=1, dmrs_scrambling_id=1, n_id=1, **extra)
    ch = chem.ChannelConfig(profile=PROFILES[case["profile"]], sinr_db=case["sinr_db"],
                            nof_tx_ports=nl, nof_rx_ports=nl, nof_sc=nof_prb * 12,
                            noise_convention="fixed")
    return cfg, ch


def received_buffers(tb: torch.Tensor, cfg, ch, generator: torch.Generator) -> torch.Tensor:
    """(n, A) TBs of n slots over the air -> their (n*C, N) int8 rate
    dematched codeword buffers, the decoder's input: transmit, one channel
    draw a slot from ``generator``, the front end, the dematch."""
    from ..phy import channel_emulator as chem
    from ..phy import pusch
    from ..phy.sch import _dematch_stage

    rnti = torch.full((tb.shape[0],), RNTI, dtype=torch.int64, device=tb.device)
    grid = pusch.transmit(tb, rnti, cfg)
    rx = torch.stack([chem.apply_channel(g, generator, ch)[0] for g in grid])
    buf = _dematch_stage(pusch._front_end(rx, rnti, cfg)[0], None, cfg.sch)
    return buf.reshape((-1,) + buf.shape[-1:])


def run_case(case: dict, nof_slots: int, chunk: int = 50, parity_kernels: bool = False,
             device: str | torch.device = "cuda") -> dict:
    """Replay one manifest row for nof_slots slots -> {"crc_bler",
    "data_bler" (CRC passed and the TB equal), "iter_mean", "iter_min",
    "iter_max" (per codeblock), "nof_slots"}."""
    from ..ops.ldpc.decoder import decode
    from ..phy.sch import _desegment_stage

    dev = torch.device(device)
    cfg, ch = case_config(case, parity_kernels)
    seg = cfg.sch.seg
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    crc_err = data_err = 0
    iters = []
    done = 0
    while done < nof_slots:
        n = min(chunk, nof_slots - done)
        tb = torch.from_numpy(rng.integers(0, 2, size=(n, case["tbs"]), dtype=np.uint8)).to(dev)
        bits, _app, it = decode(received_buffers(tb, cfg, ch, gen), seg.base_graph,
                                seg.lifting_size, 6, early_stop=True, bits_only=True,
                                n_cb=cfg.sch.n_cb)
        tb_hat, ok = _desegment_stage(bits, cfg.sch, (n,))
        data_ok = ok & (tb_hat == tb).all(dim=-1)
        crc_err += int((~ok).sum())
        data_err += int((~data_ok).sum())
        iters.append(it.cpu().numpy())
        done += n
    it = np.concatenate(iters)
    return {"crc_bler": crc_err / nof_slots, "data_bler": data_err / nof_slots,
            "iter_mean": float(it.mean()), "iter_min": int(it.min()),
            "iter_max": int(it.max()), "nof_slots": nof_slots}


def bler_bound(case: dict, nof_slots: int) -> float:
    """The agreement bound on CRC BLER: 3 binomial sigmas (variance at
    least 0.02) at nof_slots, plus 0.02."""
    ref = case["crc_bler"]
    return 3.0 * np.sqrt(max(ref * (1 - ref), 0.02) / nof_slots) + 0.02


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="bler_parity", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("manifest", help="BLER-parity manifest (JSON list of operating points)")
    ap.add_argument("--slots", type=int, default=300)
    ap.add_argument("--cases", default=None, help="comma-separated row indices (default: all)")
    ap.add_argument("--fast", action="store_true",
                    help="the fast estimator instead of the reference one")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("bler_parity: no CUDA device; pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    with open(args.manifest) as f:
        cases = json.load(f)
    rows = range(len(cases)) if args.cases is None else [int(i) for i in args.cases.split(",")]
    worst = 0.0
    for i in rows:
        case = cases[i]
        ours = run_case(case, args.slots, parity_kernels=not args.fast,
                        device="cpu" if args.cpu else "cuda")
        miss = abs(ours["crc_bler"] - case["crc_bler"]) / bler_bound(case, args.slots)
        worst = max(worst, miss)
        print(f"{i:2d} {case['profile']:>10} r{case.get('layers', 1)} {case['sinr_db']:5.1f} dB "
              f"mcs{case['mcs']:>2}: ref {case['crc_bler']:.3f} (it {case['iter_mean']:.2f}) | "
              f"port {ours['crc_bler']:.3f} data {ours['data_bler']:.3f} "
              f"(it {ours['iter_min']}/{ours['iter_mean']:.2f}/{ours['iter_max']}) "
              f"| {'within' if miss <= 1 else 'OUTSIDE'} bound", flush=True)
    return 0 if worst <= 1 else 1


if __name__ == "__main__":
    sys.exit(main())
