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
its CRC.  ``--trace`` writes the L1 tracer's Chrome JSON: the single-UE
loop's slot spans (as in the reference) and the stage spans of the slot
path nested in them, on torch.profiler's clock; ``--metrics-json`` prints
the metrics collector (multi-cell mode: the per-cell metrics).

Usage:
  python -m srsran_project_tpu_torch.apps.du_low_sim --slots 20
  python -m srsran_project_tpu_torch.apps.du_low_sim --cpu --slots 3 \\
      --set cell.nof_rb=24 --set cell.nof_ports=1 --set cell.nof_layers=1 \\
      --set cell.modulation=qam16 --channel single --snr-db 30
  python -m srsran_project_tpu_torch.apps.du_low_sim --cpu --ues 2 --policy qos \\
      --set cell.nof_rb=24 --set cell.nof_ports=1 --channel single --snr-db 30

``--ru generic|ofh`` routes the single-UE loop's grids through the RU
layer: ``generic`` OFDM-modulates the DL grid to baseband
(``ru.RuGeneric``), loops it back with AWGN at ``--snr-db`` and
demodulates it as the uplink; ``ofh`` frames the grid as paced eCPRI
C-/U-plane messages (``ru.RuOfh``: T1a windows against a per-symbol OTA
clock, BFP compression), loops the wire back as the RU's uplink and adds
the AWGN to the reassembled grid.  The TBs and the loopback noise come
from the one numpy stream, in the reference app's order; the noise is
drawn on the host and added on the device.  In scheduler mode ``--pcap``
writes each DL TB as a MAC-NR pcap record and ``--remote-port`` serves
the remote-control WebSocket (``metrics``, ``metrics_subscribe``, which
also receives the periodic reports, and ``quit``, which ends the run).

It runs on the GPU unless ``--cpu`` is given.

  python -m srsran_project_tpu_torch.apps.du_low_sim --cpu --ru ofh --slots 3 \\
      --set cell.nof_rb=24 --set cell.nof_ports=1 --set cell.nof_layers=1 \\
      --channel single --snr-db 30
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np
import torch

RNTI = 0x4601


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
    ap.add_argument("--pcap", default=None,
                    help="scheduler mode: write a MAC-NR pcap of the DL TBs here")
    ap.add_argument("--remote-port", type=int, default=None,
                    help="scheduler mode: serve the remote-control WebSocket endpoint here "
                         "(0 = ephemeral)")
    ap.add_argument("--ru", default="none", choices=["none", "generic", "ofh"],
                    help="single-UE mode: route DL/UL through the RU layer ('generic': "
                         "OFDM baseband loopback through RuGeneric; 'ofh': paced eCPRI "
                         "C/U-plane frames with BFP through RuOfh, the wire looped back)")
    return ap


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


# ---- the RU loop (--ru generic|ofh) -----------------------------------------

class RuCollector:
    """The RU's uplink notifications: the valid grid of each slot."""

    def __init__(self):
        self.rx = {}

    def on_new_uplink_symbol(self, context, grid, is_valid) -> None:
        if is_valid:
            self.rx[context.slot] = grid

    def on_new_prach_window_data(self, context, buffer) -> None:
        pass


def add_awgn(x: torch.Tensor, snr_db: float, rng: np.random.Generator,
             occupied: bool) -> torch.Tensor:
    """x plus AWGN at snr_db: the noise drawn on the host from rng (every
    real part, then every imaginary part, as the reference app draws it)
    and added on x's device.  The signal power is the mean over the
    nonzero samples (``occupied``: the zero REs of a partly filled grid
    must not dilute it) or over all of them."""
    power = x.abs() ** 2
    if occupied:
        power = power[power > 0]
    sig = float(power.mean()) if power.numel() else 1.0
    nstd = np.sqrt(sig * 10.0 ** (-snr_db / 10.0) / 2.0)
    shape = tuple(x.shape)
    noise = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x + float(nstd) * torch.from_numpy(noise).to(x.device)


class RuLoop:
    """One slot's grid through the RU layer and back as the uplink grid,
    with the AWGN of the reference app's RU modes.

    ``generic``: ``RuGeneric`` modulates the DL grid to baseband, which
    loops back with AWGN against the occupied samples' power and is
    demodulated through the RU's uplink plane.  ``ofh``: the DL data is
    submitted one slot ahead of air time, as a DU would; ``RuOfh`` paces
    its C-/U-plane frames in their T1a windows against the OTA symbol
    clock ticked through this slot and the air slot, every U-plane frame
    loops back as the RU's uplink on the same eAxC map, and the
    reassembled grid gets the AWGN."""

    def __init__(self, kind: str, cell, device: torch.device):
        from ..ru import RuGeneric, RuGenericConfig, RuOfh, RuOfhConfig

        self.kind = kind
        self.collector = RuCollector()
        self.sent = {}
        self.wire = []
        if kind == "generic":
            self.ru = RuGeneric(RuGenericConfig(scs=cell.scs, dft_size=cell.dft_size,
                                                nof_rb=cell.nof_rb, device=str(device)),
                                self.collector, transmit_cb=self.sent.__setitem__)
        else:
            self.ru = RuOfh(RuOfhConfig(scs=cell.scs, nof_prb=cell.nof_rb,
                                        nof_ports=cell.nof_ports, device=str(device)),
                            self.collector, send_frame=self.wire.append)
        self.ru.start()

    def run(self, slot, grid: torch.Tensor, snr_db: float,
            rng: np.random.Generator) -> torch.Tensor:
        from ..ru import ResourceGridContext

        ru = self.ru
        if self.kind == "generic":
            ctx = ResourceGridContext(slot=slot)
            ru.handle_dl_data(ctx, grid)
            ru.handle_new_uplink_slot(ctx)
            ru.advance_slot(slot)  # transmits; this UL request has no samples yet
            ru.push_ul_samples(slot, add_awgn(self.sent.pop(slot), snr_db, rng, occupied=True))
            ru.handle_new_uplink_slot(ctx)
            ru.advance_slot(slot)
            return self.collector.rx.pop(slot)
        air = slot + 1
        ru.ota_tick(slot)
        ru.handle_new_uplink_slot(ResourceGridContext(slot=air))
        ru.handle_dl_data(ResourceGridContext(slot=air), grid)
        for tick_slot in (slot, air):
            for sym in range(14):
                ru.ota_tick(tick_slot, sym)
                while self.wire:
                    frame = self.wire.pop(0)
                    if frame[1] == 0x00:  # U-plane (eCPRI message type 0)
                        ru.push_uplane_frame(frame)
        return add_awgn(self.collector.rx.pop(air), snr_db, rng, occupied=False)


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
    # Remote control (reference remote_server.cpp): JSON commands over a
    # WebSocket; subscribed clients get the periodic metrics lines, and
    # "quit" stops the slot loop.
    stop_flag = threading.Event()
    remote = None
    if args.remote_port is not None:
        from ..support.remote_server import RemoteServer

        remote = RemoteServer("127.0.0.1", args.remote_port,
                              commands={"metrics": lambda msg: {"report": sched.report()}},
                              on_quit=stop_flag.set)
        remote.start()
        print(f"# remote control: ws://127.0.0.1:{remote.port}", file=sys.stderr)
    if args.metrics_interval_slots > 0:
        report_timer = tm.create_timer()

        def _periodic_report():
            line = json.dumps({"slot": tm.now, "type": "periodic", **sched.report()})
            print(line)
            if remote is not None:
                remote.broadcast_metrics(line)
            report_timer.run()

        report_timer.set(args.metrics_interval_slots, _periodic_report)
    pcap_w = None
    if args.pcap:
        from ..support.pcap import MacNrPcapWriter

        pcap_w = MacNrPcapWriter(args.pcap)
    t_start = time.monotonic()
    try:
        crc_ok, nof_grants = _scheduler_loop(args, cell, phy, sched, tm, ch_cfg, rng, gen,
                                             device, stop_flag, pcap_w)
    finally:
        if remote is not None:
            remote.stop()
    elapsed = time.monotonic() - t_start
    if pcap_w is not None:
        pcap_w.close()
        print(f"# pcap: {pcap_w.nof_packets} MAC PDUs -> {args.pcap}", file=sys.stderr)
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


def _scheduler_loop(args, cell, phy, sched, tm, ch_cfg, rng, gen, device, stop_flag,
                    pcap_w) -> tuple[int, int]:
    """The scheduler mode's slots until ``--slots`` or a remote "quit":
    each slot's DL grid loops back as its uplink (a UL-only TDD slot
    synthesizes the UEs' PUSCH), every DL TB goes to the pcap.  Returns
    (CRCs OK, grants)."""
    from ..phy import channel_emulator as chem
    from ..support.pcap import DIRECTION_DOWNLINK

    crc_ok = nof_grants = 0
    for i in range(args.slots):
        if stop_flag.is_set():
            break
        slot = _slot_point(cell, i)
        tm.tick()
        dl, txd, ulr, _grants = sched.run_slot(slot, rng)
        rx_grid = None
        if dl.pdsch:
            if pcap_w is not None:
                for pdu, tb in zip(dl.pdsch, txd.payloads):
                    pcap_w.write_pdu(np.packbits(tb).tobytes(), rnti=pdu.rnti,
                                     direction=DIRECTION_DOWNLINK, sfn=slot.sfn,
                                     slot=slot.slot_in_frame)
            rx_grid, _, _ = chem.apply_channel(phy.process_dl_tti(dl, txd), gen, ch_cfg)
        if ulr.pusch:
            if rx_grid is None:
                rx_grid, _, _ = chem.apply_channel(synthesize_ul(sched, ulr, cell, device),
                                                   gen, ch_cfg)
            res = phy.process_ul_tti(ulr, rx_grid)
            sched.handle_results(res)
            crc_ok += sum(c.tb_crc_ok for c in res.crc)
            nof_grants += len(res.crc)
    return crc_ok, nof_grants


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
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
        tracing.l1_tracer.enabled = True
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

    ru = RuLoop(args.ru, cell, device) if args.ru != "none" else None

    def run_slot(i: int) -> bool:
        tb = rng.integers(0, 2, size=(cell.tbs,), dtype=np.uint8)
        dl, tx_data, ul = slot_requests(cell, i, tb)
        with tracing.l1_tracer.span(f"dl_slot_{i}"):
            grid = phy.process_dl_tti(dl, tx_data)
        if ru is not None:
            rx_grid = ru.run(dl.slot, grid, args.snr_db, rng)
        else:
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
    sys.exit(main())
