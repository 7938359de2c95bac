"""du_low_sim: the standalone DU-low (upper PHY) over a simulated channel.

Port of the single-UE mode of ``apps/du_low_sim.py``: every slot is a
DL_TTI.request with one full-band PDSCH PDU through
``UpperPhy.process_dl_tti``, the grid through the TDL channel emulator,
and the received grid decoded as a UL_TTI.request with one PUSCH PDU of
the same shape through ``UpperPhy.process_ul_tti`` (the loopback the
reference's app runs).  It prints slots, seconds, slot-pairs/s and the
BLER, and exits 1 when no slot passed its CRC.

Usage:
  python -m srsran_project_tpu_torch.apps.du_low_sim --slots 20
  python -m srsran_project_tpu_torch.apps.du_low_sim --cpu --slots 3 \\
      --set cell.nof_rb=24 --set cell.nof_ports=1 --set cell.nof_layers=1 \\
      --set cell.modulation=qam16 --channel single --snr-db 30

It runs on the GPU unless ``--cpu`` is given.  The reference's other
modes (scheduler, multi-cell, RU, pcap, remote control, tracing and
metrics) are accepted by the parser and exit with the ROADMAP item that
ports them.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

RNTI = 0x4601

# Flag -> (its default, the ROADMAP sub-item that ports the mode it opens).
DEFERRED = {
    "ues": (0, "Q1.10.3"),
    "policy": ("rr", "Q1.10.3"),
    "tdd": (False, "Q1.10.3"),
    "common": (False, "Q1.10.3"),
    "cells": (1, "Q1.10.4"),
    "ru": ("none", "Q1.10.5"),
    "pcap": (None, "Q1.10.6"),
    "remote_port": (None, "Q1.10.7"),
    "trace": (None, "Q1.10.2"),
    "metrics_json": (False, "Q1.10.2"),
    "metrics_interval_slots": (0, "Q1.10.2"),
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="du_low_sim", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None, help="YAML cell config (needs PyYAML)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted config override, e.g. cell.nof_rb=52")
    ap.add_argument("--slots", type=int, default=10)
    ap.add_argument("--snr-db", type=float, default=25.0)
    ap.add_argument("--channel", default="tdla", choices=["single", "tdla", "tdlb", "tdlc"])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the TBs (numpy) and of the channel (torch, seed + 1)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument("--dump-config", action="store_true")
    # The reference's other modes: parsed, not ported.
    ap.add_argument("--trace", default=None)
    ap.add_argument("--ues", type=int, default=0)
    ap.add_argument("--cells", type=int, default=1)
    ap.add_argument("--tdd", action="store_true")
    ap.add_argument("--policy", default="rr", choices=["rr", "qos"])
    ap.add_argument("--common", action="store_true")
    ap.add_argument("--pcap", default=None)
    ap.add_argument("--metrics-json", action="store_true")
    ap.add_argument("--metrics-interval-slots", type=int, default=0)
    ap.add_argument("--remote-port", type=int, default=None)
    ap.add_argument("--ru", default="none", choices=["none", "generic", "ofh"])
    return ap


def check_deferred(args: argparse.Namespace) -> None:
    """Raise NotImplementedError naming the ROADMAP sub-item of the first
    flag that asks for a mode the port does not run yet."""
    for name, (default, item) in DEFERRED.items():
        if getattr(args, name) != default:
            flag = "--" + name.replace("_", "-")
            raise NotImplementedError(
                f"du_low_sim {flag}={getattr(args, name)!r} is not ported yet (ROADMAP {item}); "
                "the port runs the single-UE mode")


def _overrides(items: list[str]) -> dict:
    out = {}
    for s in items:
        k, v = s.split("=", 1)
        for conv in (int, float):
            try:
                v = conv(v)
                break
            except ValueError:
                pass
        out[k] = v
    return out


def slot_requests(cell, i: int, tb: np.ndarray):
    """Slot i's (DL_TTI.request, TX_Data.request, UL_TTI.request): one
    full-band PDSCH PDU of ``cell`` carrying ``tb`` (identity precoding),
    and the PUSCH PDU of the same shape that decodes it."""
    from ..fapi import messages as fapi
    from ..ran.slot_point import SlotPoint

    slot = SlotPoint.from_sfn_slot(cell.scs, i // 20, i % 20)
    w = np.eye(cell.nof_layers, cell.nof_ports, dtype=np.complex64)
    return (fapi.DlTtiRequest(slot=slot, pdsch=[fapi.DlPdschPdu(cell.pdsch_cfg, RNTI, w, 0)]),
            fapi.TxDataRequest(slot=slot, payloads=[tb]),
            fapi.UlTtiRequest(slot=slot, pusch=[fapi.UlPuschPdu(cell.pusch_cfg, RNTI)]))


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    check_deferred(args)
    from ..phy import channel_emulator as chem
    from ..phy.upper_phy import UpperPhy, UpperPhyConfig
    from ..support import config as cfg_mod

    du_cfg = cfg_mod.load_config(args.config, _overrides(args.set))
    if args.dump_config:
        print(cfg_mod.dump_config(du_cfg))
        return 0
    if not args.cpu and not torch.cuda.is_available():
        print("du_low_sim: no CUDA device; pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    cell = cfg_mod.to_cell_config(du_cfg)
    phy = UpperPhy(UpperPhyConfig(nof_ports=cell.nof_ports, nof_grid_sc=cell.nof_sc,
                                  device=str(device)))
    ch_cfg = chem.ChannelConfig(profile=args.channel, sinr_db=args.snr_db,
                                nof_tx_ports=cell.nof_ports, nof_rx_ports=cell.nof_ports,
                                nof_sc=cell.nof_sc, scs=cell.scs)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    print(f"# cell: {cell.nof_rb} PRB, {cell.nof_ports}x{cell.nof_layers}, tbs={cell.tbs} bits, "
          f"channel={args.channel}@{args.snr_db}dB, device={device}", file=sys.stderr)

    def run_slot(i: int) -> bool:
        tb = rng.integers(0, 2, size=(cell.tbs,), dtype=np.uint8)
        dl, tx_data, ul = slot_requests(cell, i, tb)
        rx_grid, _, _ = chem.apply_channel(phy.process_dl_tti(dl, tx_data), gen, ch_cfg)
        return phy.process_ul_tti(ul, rx_grid).crc[0].tb_crc_ok

    t_start = time.monotonic()
    crc_ok = sum(int(run_slot(i)) for i in range(args.slots))
    elapsed = time.monotonic() - t_start
    bler = 1.0 - crc_ok / args.slots
    print(f"# {args.slots} slots in {elapsed:.2f}s ({args.slots / elapsed:.1f} slot-pairs/s), "
          f"BLER={bler:.3f}", file=sys.stderr)
    return 0 if bler < 1.0 else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NotImplementedError as e:
        sys.exit(f"du_low_sim: {e}")
