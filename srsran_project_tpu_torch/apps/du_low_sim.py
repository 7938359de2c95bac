"""du_low_sim: the standalone DU-low (upper PHY) over a simulated channel.

Port of ``apps/du_low_sim.py`` in three modes:

- single UE (``--ues 0``, the default): every slot is a DL_TTI.request
  with one full-band PDSCH PDU through ``UpperPhy.process_dl_tti``, the
  grid through the TDL channel emulator, and the received grid decoded as
  a UL_TTI.request with one PUSCH PDU of the same shape through
  ``UpperPhy.process_ul_tti`` (the loopback the reference's app runs);
- scheduler (``--ues N``): the l2sim ``RoundRobinScheduler`` (``--policy
  rr|qos``, ``--tdd`` for the 7D1S2U pattern, ``--common`` to wrap it in
  the ``CellScheduler`` of SSB, SIB1, paging, CSI-RS and PRACH occasions)
  picks up to 4 UEs a slot with HARQ; the DL grid loops back as the
  uplink, and a UL-only TDD slot synthesizes the UEs' PUSCH with
  ``pusch.transmit``.  ``--metrics-interval-slots`` prints a periodic
  report through a ``TimerManager`` ticked once a slot;
- multi-cell (``--ues N --cells C``): one scheduler, ``UpperPhy`` and FAPI
  stream per cell (``MultiCellScheduler``), per-cell metrics at the end.

It prints the slots, seconds and BLER, and exits 1 when no grant passed
its CRC.  ``--trace`` writes the L1 tracer's Chrome JSON (its spans are
the single-UE loop's, as in the reference) and ``--metrics-json`` prints
the metrics collector (multi-cell mode: the per-cell metrics).

Usage:
  python -m srsran_project_tpu_torch.apps.du_low_sim --slots 20
  python -m srsran_project_tpu_torch.apps.du_low_sim --cpu --slots 3 \\
      --set cell.nof_rb=24 --set cell.nof_ports=1 --set cell.nof_layers=1 \\
      --set cell.modulation=qam16 --channel single --snr-db 30
  python -m srsran_project_tpu_torch.apps.du_low_sim --cpu --ues 2 --policy qos \\
      --set cell.nof_rb=24 --set cell.nof_ports=1 --channel single --snr-db 30

It runs on the GPU unless ``--cpu`` is given.  The reference's RU, pcap
and remote-control options are accepted by the parser and exit with the
ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

RNTI = 0x4601

# Flag -> (its default, the ROADMAP sub-item that ports the mode it opens).
DEFERRED = {
    "ru": ("none", "Q1.10.5"),
    "pcap": (None, "Q1.10.6"),
    "remote_port": (None, "Q1.10.7"),
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
    ap.add_argument("--trace", default=None, help="write Chrome trace JSON here")
    ap.add_argument("--ues", type=int, default=0,
                    help="multi-UE scheduler mode: number of UEs (0 = single full-band UE)")
    ap.add_argument("--cells", type=int, default=1,
                    help="scheduler-mode cell count: one per-cell scheduler + PHY + FAPI "
                         "stream each")
    ap.add_argument("--tdd", action="store_true", help="7D1S2U TDD pattern (scheduler mode)")
    ap.add_argument("--policy", default="rr", choices=["rr", "qos"])
    ap.add_argument("--common", action="store_true",
                    help="schedule common channels too (SSB/SIB1/paging/CSI-RS/PRACH "
                         "occasions via CellScheduler)")
    ap.add_argument("--metrics-json", action="store_true", help="print metrics JSON line")
    ap.add_argument("--metrics-interval-slots", type=int, default=0,
                    help="scheduler mode: emit a periodic metrics JSON line every N slots")
    # The reference's other modes: parsed, not ported.
    ap.add_argument("--pcap", default=None)
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
                "the port runs the single-UE, scheduler and multi-cell modes")


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


def _slot_point(cell, i: int):
    from ..ran.slot_point import SlotPoint

    return SlotPoint.from_sfn_slot(cell.scs, i // 20, i % 20)


def slot_requests(cell, i: int, tb: np.ndarray):
    """Slot i's (DL_TTI.request, TX_Data.request, UL_TTI.request): one
    full-band PDSCH PDU of ``cell`` carrying ``tb`` (identity precoding),
    and the PUSCH PDU of the same shape that decodes it."""
    from ..fapi import messages as fapi

    slot = _slot_point(cell, i)
    w = np.eye(cell.nof_layers, cell.nof_ports, dtype=np.complex64)
    return (fapi.DlTtiRequest(slot=slot, pdsch=[fapi.DlPdschPdu(cell.pdsch_cfg, RNTI, w, 0)]),
            fapi.TxDataRequest(slot=slot, payloads=[tb]),
            fapi.UlTtiRequest(slot=slot, pusch=[fapi.UlPuschPdu(cell.pusch_cfg, RNTI)]))


def scheduler_config(cell, args: argparse.Namespace):
    """The scheduler mode's SchedulerConfig (1 layer, up to 4 UEs a slot,
    7D1S2U with ``--tdd``), as the reference's app builds it."""
    from ..l2sim.scheduler import SchedulerConfig
    from ..ran.tdd import PATTERN_7D2U

    return SchedulerConfig(nof_grid_sc=cell.nof_sc, nof_rb=cell.nof_rb,
                           max_ues_per_slot=min(args.ues, 4), nof_layers=1,
                           nof_ports=cell.nof_ports,
                           tdd_pattern=PATTERN_7D2U if args.tdd else None,
                           policy=args.policy)


def synthesize_ul(sched, request, cell, device) -> torch.Tensor:
    """The UEs' transmit grid of a UL-only slot (no DL grid to loop back):
    each PUSCH PDU's TB (its HARQ process's) through ``pusch.transmit``,
    added at the PDU's first PRB."""
    from ..phy import pusch as pusch_mod

    tx = torch.zeros((cell.nof_ports, 14, cell.nof_sc), dtype=torch.complex64, device=device)
    for pdu in request.pusch:
        tb = sched.ues[pdu.rnti].harqs[pdu.harq_id].tb
        sub = pusch_mod.transmit(torch.as_tensor(tb, device=device),
                                 torch.tensor(pdu.rnti, dtype=torch.int64, device=device),
                                 pdu.config)
        off = (pdu.first_rb or 0) * 12
        tx[:, :, off:off + sub.shape[2]] += sub
    return tx


def _multi_cell(args, cell, ch_cfg, rng, gen, device) -> int:
    """Multi-cell scheduler mode (the reference's cell_scheduler per cell):
    each cell its own scheduler, PHY, channel draw and FAPI stream; UEs
    attach round-robin across the cells."""
    from ..l2sim.multi_cell import MultiCellScheduler
    from ..l2sim.scheduler import SchedulerConfig
    from ..phy import channel_emulator as chem
    from ..phy.upper_phy import UpperPhy, UpperPhyConfig

    cell_ids = list(range(args.cells))
    msched = MultiCellScheduler({cid: SchedulerConfig(
        nof_grid_sc=cell.nof_sc, nof_rb=cell.nof_rb, max_ues_per_slot=4, nof_layers=1,
        nof_ports=cell.nof_ports, policy=args.policy) for cid in cell_ids})
    for i in range(args.ues):
        msched.add_ue(0x100 + i, cell_ids[i % args.cells], mcs=10)
    phys = {cid: UpperPhy(UpperPhyConfig(nof_ports=cell.nof_ports, nof_grid_sc=cell.nof_sc,
                                         device=str(device))) for cid in cell_ids}
    t_start = time.monotonic()
    crc_ok = nof_grants = 0
    for i in range(args.slots):
        for cid, (dl, txd, ulr, _grants) in msched.run_slot(_slot_point(cell, i), rng).items():
            if not dl.pdsch:
                continue
            rx_grid, _, _ = chem.apply_channel(phys[cid].process_dl_tti(dl, txd), gen, ch_cfg)
            res = phys[cid].process_ul_tti(ulr, rx_grid)
            msched.handle_results(cid, res)
            crc_ok += sum(c.tb_crc_ok for c in res.crc)
            nof_grants += len(res.crc)
    elapsed = time.monotonic() - t_start
    for cid, mrep in msched.metrics_report().items():
        print(f"# cell {cid}: {mrep}", file=sys.stderr)
    print(f"# multi-cell mode: {args.cells} cells, {args.ues} UEs, {nof_grants} grants, "
          f"{crc_ok} CRC OK in {elapsed:.2f}s", file=sys.stderr)
    bler = 1.0 - crc_ok / max(nof_grants, 1)
    if args.metrics_json:
        print(json.dumps({"cells": msched.metrics_report(), "slots": args.slots, "bler": bler}))
    return 0 if bler < 1.0 else 1


def _scheduler(args, cell, phy, ch_cfg, rng, gen, device) -> int:
    """Scheduler-driven multi-UE mode: RR/QoS policy + HARQ lifecycle,
    optionally under the common-channel CellScheduler."""
    from ..l2sim.scheduler import RoundRobinScheduler
    from ..phy import channel_emulator as chem
    from ..support import tracing
    from ..support.metrics import collector
    from ..support.timers import TimerManager

    sched = RoundRobinScheduler(scheduler_config(cell, args))
    for i in range(args.ues):
        sched.add_ue(0x100 + i, mcs=10)
    ue_sched = sched
    if args.common:
        from ..l2sim.common_scheduling import CellScheduler, CommonSchedulingConfig

        sched = CellScheduler(CommonSchedulingConfig(nof_rb=cell.nof_rb,
                                                     nof_grid_sc=cell.nof_sc), ue_sched)
        sched.ues = ue_sched.ues  # report/harq access passthrough
        sched.handle_results = ue_sched.handle_results
        sched.report = ue_sched.report
    # Periodic metrics reports: a TimerManager ticked once per slot
    # re-arms itself (reference periodic_metrics_report_controller).
    tm = TimerManager()
    if args.metrics_interval_slots > 0:
        report_timer = tm.create_timer()

        def _periodic_report():
            print(json.dumps({"slot": tm.now, "type": "periodic", **sched.report()}))
            report_timer.run()

        report_timer.set(args.metrics_interval_slots, _periodic_report)
    t_start = time.monotonic()
    crc_ok = nof_grants = 0
    for i in range(args.slots):
        slot = _slot_point(cell, i)
        tm.tick()
        dl, txd, ulr, _grants = sched.run_slot(slot, rng)
        rx_grid = None
        if dl.pdsch:
            rx_grid, _, _ = chem.apply_channel(phy.process_dl_tti(dl, txd), gen, ch_cfg)
        if ulr.pusch:
            if rx_grid is None:
                rx_grid, _, _ = chem.apply_channel(synthesize_ul(sched, ulr, cell, device),
                                                   gen, ch_cfg)
            res = phy.process_ul_tti(ulr, rx_grid)
            sched.handle_results(res)
            crc_ok += sum(c.tb_crc_ok for c in res.crc)
            nof_grants += len(res.crc)
    elapsed = time.monotonic() - t_start
    if args.common:
        print(f"# common channels: {sched.counters}", file=sys.stderr)
    rep = sched.report()
    tput = sum(v["ul_bits_ok"] for v in rep.values()) / elapsed / 1e6
    print(f"# scheduler mode: {args.ues} UEs, {nof_grants} grants, {crc_ok} CRC OK, "
          f"{tput:.1f} Mbps UL", file=sys.stderr)
    bler = 1.0 - crc_ok / max(nof_grants, 1)
    print(f"# {args.slots} slots in {elapsed:.2f}s, BLER={bler:.3f}", file=sys.stderr)
    if args.metrics_json:
        print(collector.report_json())
    if args.trace:
        tracing.l1_tracer.write(args.trace)
    return 0 if bler < 1.0 else 1


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    check_deferred(args)
    from ..phy import channel_emulator as chem
    from ..phy.slot_pipeline import SlotPipeline
    from ..phy.upper_phy import UpperPhy, UpperPhyConfig
    from ..support import config as cfg_mod
    from ..support import tracing
    from ..support.metrics import collector

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
    if args.trace:
        tracing.enable_all()
    phy = UpperPhy(UpperPhyConfig(nof_ports=cell.nof_ports, nof_grid_sc=cell.nof_sc,
                                  device=str(device)))
    # Built as the reference's app builds it; no mode pushes a slot through
    # it, so the metrics collector stays empty (kept for parity).
    SlotPipeline(phy, slot_duration_s=500e-6,
                 depth=du_cfg.expert_phy.max_processing_delay_slots)
    ch_cfg = chem.ChannelConfig(profile=args.channel, sinr_db=args.snr_db,
                                nof_tx_ports=cell.nof_ports, nof_rx_ports=cell.nof_ports,
                                nof_sc=cell.nof_sc, scs=cell.scs)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    print(f"# cell: {cell.nof_rb} PRB, {cell.nof_ports}x{cell.nof_layers}, tbs={cell.tbs} bits, "
          f"channel={args.channel}@{args.snr_db}dB, device={device}", file=sys.stderr)

    if args.ues > 0 and args.cells > 1:
        return _multi_cell(args, cell, ch_cfg, rng, gen, device)
    if args.ues > 0:
        return _scheduler(args, cell, phy, ch_cfg, rng, gen, device)

    def run_slot(i: int) -> bool:
        tb = rng.integers(0, 2, size=(cell.tbs,), dtype=np.uint8)
        dl, tx_data, ul = slot_requests(cell, i, tb)
        with tracing.l1_tracer.span(f"dl_slot_{i}"):
            grid = phy.process_dl_tti(dl, tx_data)
        rx_grid, _, _ = chem.apply_channel(grid, gen, ch_cfg)
        with tracing.l1_tracer.span(f"ul_slot_{i}"):
            res = phy.process_ul_tti(ul, rx_grid)
        return res.crc[0].tb_crc_ok

    t_start = time.monotonic()
    crc_ok = sum(int(run_slot(i)) for i in range(args.slots))
    elapsed = time.monotonic() - t_start
    bler = 1.0 - crc_ok / args.slots
    print(f"# {args.slots} slots in {elapsed:.2f}s ({args.slots / elapsed:.1f} slot-pairs/s), "
          f"BLER={bler:.3f}", file=sys.stderr)
    if args.metrics_json:
        print(collector.report_json())
    if args.trace:
        tracing.l1_tracer.write(args.trace)
    return 0 if bler < 1.0 else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NotImplementedError as e:
        sys.exit(f"du_low_sim: {e}")
