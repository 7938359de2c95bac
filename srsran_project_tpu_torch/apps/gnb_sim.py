"""gnb_sim — monolithic gNB simulator: CU-CP + CU-UP + DU + the port's PHY.

Port of ``apps/gnb_sim.py`` (the reference's apps/gnb, SURVEY.md section
3.1): brings up the whole stack in one process with in-process connectors
— AMF sim, NG setup, F1/E1 setup, N UEs attaching through the full RRC
choreography (security mode with derived keys, PDU sessions, bearer
contexts), then a traffic phase where downlink IP packets enter via GTP-U
and ride SDAP -> PDCP -> F1-U -> RLC -> MAC TBs through ``UpperPhy``
(PDSCH encode -> fading channel -> PUSCH decode) and back up the UE stack;
uplink runs the reverse.  Prints per-UE delivery stats and a metrics JSON
line, as the reference's app does.

The grids and the channel stay on the device; the channel is
``channel_emulator.apply_channel`` drawing from a ``torch.Generator`` on
the grid's device seeded with 1 (the reference draws from
``jax.random.PRNGKey(0)``).  The TBs and the packet lengths come from the
numpy stream ``default_rng(0)``, in the reference's order.  The decoded TB
bits reach the host once per PDU (``RxDataIndicationPdu.payload``), and
each goes to the UE of its RNTI (a repair, ROADMAP Q3).

It runs on the GPU unless ``--cpu`` is given.  ``run(args, channel=...)``
takes another channel: a callable from a DL grid to the received grid.

Usage:
  python -m srsran_project_tpu_torch.apps.gnb_sim --ues 2 --packets 8 --slots 40 --snr-db 25
  python -m srsran_project_tpu_torch.apps.gnb_sim --ues 1 --handover --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ues", type=int, default=1)
    ap.add_argument("--packets", type=int, default=6, help="DL+UL packets per UE")
    ap.add_argument("--slots", type=int, default=60)
    ap.add_argument("--snr-db", type=float, default=25.0)
    ap.add_argument("--mcs", type=int, default=6)
    ap.add_argument("--channel", default="single", choices=["single", "tdla", "tdlb", "tdlc"])
    ap.add_argument("--handover", action="store_true",
                    help="after traffic, hand every UE over to a second DU")
    ap.add_argument("--e2", action="store_true",
                    help="attach an E2 agent + RIC double; print KPM indications")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument("--testmode", type=int, default=0, metavar="N",
                    help="MAC test mode: N synthetic UEs at the FAPI "
                         "boundary (UCI/PUSCH/CRC synthesized, no "
                         "UE/channel/PHY — reference mac_test_mode_adapter)")
    ap.add_argument("--metrics-json", action="store_true")
    ap.add_argument("--pcap-dir", default=None,
                    help="write ngap/f1ap/e1ap/e2ap/gtpu pcaps into this directory")
    return ap


@dataclasses.dataclass
class GnbRun:
    """What one run left: its exit verdict, the stack's objects (for
    checks) and the traffic loop's host time (``time.perf_counter`` at its
    start, and its seconds)."""

    ok: bool
    metrics: dict
    ues: list = dataclasses.field(default_factory=list)  # (UeRrcAgent, UeSim)
    core_rx: list = dataclasses.field(default_factory=list)  # GTP-U frames at the core
    cucp: object = None
    ric: object = None
    phy: object = None
    pcaps: list = dataclasses.field(default_factory=list)  # closed PcapWriters
    loop_t0: float = 0.0
    loop_s: float = 0.0
    slots_run: int = 0


def _device(args) -> torch.device:
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("gnb_sim: no CUDA device; pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return device


def _attach_pcaps(pcap_dir: str) -> list:
    """A writer per protocol in ``pcap_dir``; [(detach, writer)]."""
    from ..l2 import gtpu
    from ..l3 import messages as m
    from ..l3.e2_sim import PROTO_E2AP
    from ..support import pcap as pcap_mod

    os.makedirs(pcap_dir, exist_ok=True)
    writers = []
    for proto, mk, name in (
        (m.PROTO_NGAP, pcap_mod.ngap_pcap, "ngap"),
        (m.PROTO_F1AP, pcap_mod.f1ap_pcap, "f1ap"),
        (m.PROTO_E1AP, pcap_mod.e1ap_pcap, "e1ap"),
        (PROTO_E2AP, pcap_mod.e2ap_pcap, "e2ap"),
    ):
        w = mk(os.path.join(pcap_dir, f"gnb_{name}.pcap"))
        m.attach_pcap(proto, w)
        writers.append((lambda p=proto: m.detach_pcap(p), w))
    wg = pcap_mod.gtpu_pcap(os.path.join(pcap_dir, "gnb_gtpu.pcap"))
    gtpu.attach_pcap(wg)
    writers.append((gtpu.detach_pcap, wg))
    return writers


def _test_mode(args) -> GnbRun:
    """MAC test mode (reference mac_test_mode_adapter / testmode.yml):
    synthetic UEs in connected state, every UL_TTI answered with CRC-OK
    PUSCH + UCI at the configured CQI/RI — full L2 load, zero PHY."""
    from ..l2sim.link_adaptation import LinkAdaptor
    from ..l2sim.scheduler import RoundRobinScheduler, SchedulerConfig
    from ..l2sim.test_mode import MacTestModeAdapter, TestModeUeConfig
    from ..ran import csi as csi_mod
    from ..ran.constants import SubcarrierSpacing
    from ..ran.slot_point import SlotPoint

    t0 = time.time()
    rng = np.random.default_rng(0)
    sched = RoundRobinScheduler(SchedulerConfig(
        nof_rb=48, max_ues_per_slot=min(8, args.testmode),
        nof_ports=4, nof_layers=2))
    sched.link_adaptor = LinkAdaptor()
    sched.csi_report_cfg = csi_mod.CsiReportConfig(nof_csi_rs_ports=4)
    tm = MacTestModeAdapter(
        TestModeUeConfig(nof_ues=args.testmode, ri=2, cqi=12),
        sched, csi_report_cfg=sched.csi_report_cfg)

    def tm_slot(k):
        return SlotPoint.from_sfn_slot(SubcarrierSpacing.KHZ30,
                                       (k // 20) % 1024, k % 20)

    for k in range(args.slots):
        tm.run_slot(tm_slot(k), rng)
    dt = time.time() - t0
    rep = tm.report()
    print(f"[gnb_sim] test mode: {args.testmode} UEs, {args.slots} slots "
          f"in {dt:.2f}s ({args.slots / dt:.0f} slots/s), "
          f"{rep['nof_crc']} CRC ind, {rep['nof_uci']} UCI ind, "
          f"DL {rep['dl_bits'] / 1e6:.1f} Mbit / UL {rep['ul_bits'] / 1e6:.1f} Mbit")
    metrics = {"testmode_ues": args.testmode, "slots": args.slots,
               "slots_per_s": round(args.slots / dt, 1), **rep}
    if args.metrics_json:
        print(json.dumps(metrics))
    return GnbRun(ok=True, metrics=metrics, loop_s=dt, slots_run=args.slots)


def run(args, channel: Callable[[torch.Tensor], torch.Tensor] | None = None) -> GnbRun:
    """The app's whole run on parsed arguments.  ``channel``: a callable
    from a DL grid (on the PHY's device) to the received grid, in place of
    ``apply_channel`` with ``--channel`` and ``--snr-db``.  The pcap
    writers of ``--pcap-dir`` are detached and closed however it ends."""
    device = None if args.testmode else _device(args)
    pcap_writers = _attach_pcaps(args.pcap_dir) if args.pcap_dir else []
    pcaps = []
    try:
        out = _test_mode(args) if args.testmode else _traffic(args, channel, device)
    finally:
        for detach, w in pcap_writers:
            detach()
            w.close()
            pcaps.append(w)
    out.pcaps = pcaps
    for w in pcaps:
        print(f"[gnb_sim] pcap: {w.path} ({w.nof_packets} packets)")
    return out


def _traffic(args, channel, device: torch.device) -> GnbRun:
    """Bring-up, attach and the traffic loop over the PHY on ``device``."""
    from ..fapi import messages as fapi
    from ..l2 import cu_up_sim, du_high_sim, gtpu, nru, pdcp, security
    from ..l2sim.scheduler import SchedulerConfig
    from ..l3.cu_cp_sim import AmfSim, CuCpSim, CuUpE1Agent, DuF1Sim
    from ..phy import channel_emulator as chem
    from ..phy.upper_phy import UpperPhy, UpperPhyConfig
    from ..ran.constants import SubcarrierSpacing
    from ..ran.slot_point import SlotPoint
    from .ue_sim import UeRrcAgent, UeSim

    t0 = time.time()
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(1)

    # ---- control plane bring-up --------------------------------------------
    amf = AmfSim()
    links = {}
    cucp = CuCpSim(send_to_amf=lambda b: amf.rx(b),
                   send_to_du=lambda b: links["du0"].rx(b),
                   send_to_cuup=lambda b: links["e1"].rx(b))
    amf.send = cucp.rx_from_amf
    du_f1 = DuF1Sim(send_to_cucp=lambda b: cucp.rx_from_du(b, du_id=0), gnb_du_id=1)
    du1_f1 = DuF1Sim(send_to_cucp=lambda b: cucp.rx_from_du(b, du_id=1), gnb_du_id=2)
    cucp.add_du(1, lambda b: du1_f1.rx(b))

    core_rx: list[bytes] = []
    du = du_high_sim.DuHighSim(SchedulerConfig(nof_rb=48,
                                               max_ues_per_slot=min(4, args.ues)))
    cu_ups = {}
    rnti_by_cu_up: dict[int, int] = {}

    class _E1Shim:
        """Adapts CuUpSim to the E1 agent's pending_setup/dl-teid protocol."""

        def __init__(self, cu_up):
            self.cu_up = cu_up
            self.pending_setup = None

        def on_f1u_dl_teids(self, teids):
            s, f1u_ul = self.pending_setup
            # wire F1-U DL: CU-UP pushes NR-U frames into the DU RLC bearer
            rnti = rnti_by_cu_up[self.cu_up.ue_id]
            bearer = du.ues[rnti].bearers[4].entity
            self.cu_up.setup_bearer(
                drb_id=s["drb_id"], qfi=s["qfi"], teid_dl=0x10 + self.cu_up.ue_id,
                teid_ul=s["ngu_ul_teid"],
                f1u_tx=lambda fr, b=bearer: b.tx_sdu(nru.decode_dl_user_data(fr).payload))

    def make_cu_up(ue_id, keys, nea, nia):
        c = cu_up_sim.CuUpSim(ue_id=ue_id, ngu_tx=core_rx.append,
                              sec_cfg=(nea, nia), keys=keys)
        cu_ups[ue_id] = c
        return _E1Shim(c)

    e1 = CuUpE1Agent(send_to_cucp=cucp.rx_from_cuup, make_cu_up=make_cu_up)
    links["du0"], links["e1"] = du_f1, e1

    cucp.start()
    du_f1.setup(cells=[{"pci": 1, "nr_cgi": "00101-1", "dl_arfcn": 632628,
                        "bandwidth_rb": 48}])
    du1_f1.setup(cells=[{"pci": 2, "nr_cgi": "00101-2", "dl_arfcn": 632628,
                         "bandwidth_rb": 48}])

    # ---- UE attach ----------------------------------------------------------
    ues = []
    for i in range(args.ues):
        rnti = 0x4601 + i
        cu_ue_id = i + 1
        rnti_by_cu_up[cu_ue_id] = rnti  # CuUpE1Agent allocates ue ids in order
        ue_stack = UeSim(rnti=rnti)
        du.add_ue(rnti, mcs=args.mcs,
                  on_rx_sdu=lambda pp, uid=cu_ue_id: cu_ups[uid].rx_f1u_ul(1, pp))
        rrc = UeRrcAgent(du_f1, c_rnti=rnti,
                         k_gnb_provider=lambda uid=cu_ue_id: security.kdf(
                             amf.k_amf, 0x6E, uid.to_bytes(4, "big")))
        rrc.connect()
        assert rrc.state == "connected", f"UE {i} attach failed: {rrc.state}"
        # re-key the UE user-plane stack with the real derived UP keys
        k_gnb = security.kdf(amf.k_amf, 0x6E, cu_ue_id.to_bytes(4, "big"))
        nea, nia = 2, 2
        k_enc = security.derive_algo_key(k_gnb, security.ALGO_TYPE_NUP_ENC, nea)
        k_int = security.derive_algo_key(k_gnb, security.ALGO_TYPE_NUP_INT, nia)
        eng = security.SecurityEngine(nea, nia, k_enc, k_int, bearer=1)
        ue_stack.pdcp = pdcp.PdcpEntity(pdcp.PdcpConfig(sn_bits=18), eng,
                                        is_downlink_tx=False,
                                        on_rx_sdu=lambda s, u=ue_stack: u.sdap.rx_pdu(s, downlink=True))
        ue_stack.rlc.on_rx_sdu = ue_stack.pdcp.rx_pdu
        ues.append((rrc, ue_stack))
    print(f"[gnb_sim] {args.ues} UE(s) attached "
          f"(NG+F1+E1 up, sessions: {amf.sessions_done})")

    # ---- E2 agent (optional) --------------------------------------------------
    ric = agent = None
    if args.e2:
        from ..l3 import e2_sim
        ric = e2_sim.RicSim()
        agent = e2_sim.E2Agent(gnb_id=411, send_to_ric=ric.rx)
        ric.agent_tx = agent.rx
        agent.kpm.register("DRB.UEThpUl",
                           lambda: sum(u.ul_bits_ok for u in du.scheduler.ues.values()))
        agent.kpm.register("DRB.RlcSduTransmittedVolumeDL", lambda: du.dl_bytes)
        agent.kpm.register("RRU.PrbTotDl", lambda: 48.0)
        agent.start()
        ric.subscribe(req_id=1, period=2,
                      measurements=["DRB.UEThpUl", "DRB.RlcSduTransmittedVolumeDL",
                                    "RRU.PrbTotDl"])

    # ---- traffic over the PHY ----------------------------------------------
    du.scheduler.tb_source = du.build_dl_tb
    phy = UpperPhy(UpperPhyConfig(nof_ports=1, device=str(device)))
    if channel is None:
        ch = chem.ChannelConfig(profile=args.channel, sinr_db=args.snr_db, nof_sc=624)

        def channel(grid):
            return chem.apply_channel(grid, gen, ch)[0]

    dl_expect = {}
    ul_expect = {}
    for i, (rrc, ue_stack) in enumerate(ues):
        cu_ue_id = i + 1
        pkts = [bytes([i + 1, k]) * rng.integers(40, 300) for k in range(args.packets)]
        dl_expect[i] = pkts
        for p in pkts:
            cu_ups[cu_ue_id].rx_ngu(gtpu.encode_gpdu(teid=0x10 + cu_ue_id, payload=p, qfi=9))
        ul_expect[i] = [bytes([0x80 | (i + 1), k]) * rng.integers(40, 200)
                        for k in range(args.packets)]

    def slot_point(k):
        return SlotPoint.from_sfn_slot(SubcarrierSpacing.KHZ30, k // 20, k % 20)

    rnti_to_ue = {0x4601 + i: u for i, (_, u) in enumerate(ues)}
    done_slot = None
    slots_run = 0
    t_loop = time.perf_counter()
    for k in range(args.slots):
        slots_run += 1
        for i, (rrc, ue_stack) in enumerate(ues):
            if k < len(ul_expect[i]):
                ue_stack.send_ul(ul_expect[i][k])
        dl, tx, ul, grants = du.scheduler.run_slot(slot_point(k), rng)
        grid = phy.process_dl_tti(dl, tx)
        res = phy.process_ul_tti(ul, channel(grid))
        du.scheduler.handle_results(res)
        # each decoded TB to the UE of its own RNTI (the reference pairs
        # rx_data with ul.pusch by position, which hands a UE another UE's
        # TB once an earlier grant's CRC fails)
        for rxd in res.rx_data:
            rnti_to_ue[rxd.rnti].handle_dl_tb(np.asarray(rxd.payload))
        # UL leg per granted UE
        for rnti, harq_id, tbs in grants:
            u = rnti_to_ue[rnti]
            ul_tb = u.build_ul_tb(tbs)
            gpdu = [p for p in dl.pdsch if p.rnti == rnti]
            tx2 = fapi.TxDataRequest(slot=dl.slot, payloads=[ul_tb])
            ul2 = fapi.UlTtiRequest(slot=dl.slot,
                                    pusch=[p for p in ul.pusch if p.rnti == rnti])
            if not gpdu or not ul2.pusch:
                continue
            dl2 = fapi.DlTtiRequest(slot=dl.slot, pdsch=[fapi.DlPdschPdu(
                gpdu[0].config, rnti, gpdu[0].precoding, 0, first_rb=gpdu[0].first_rb)])
            grid2 = phy.process_dl_tti(dl2, tx2)
            res2 = phy.process_ul_tti(ul2, channel(grid2))
            for rxd in res2.rx_data:
                du.handle_ul_tb(rnti, np.asarray(rxd.payload))
        for i, (rrc, u) in enumerate(ues):
            du.exchange_am_status(0x4601 + i, 4, u.rlc)
            u.pdcp.tick(k)
        for c in cu_ups.values():
            c.tick(k)
        if agent is not None:
            agent.tick(k)
        got_all = all(len(u.delivered) >= args.packets for _, u in ues) \
            and len(core_rx) >= args.ues * args.packets
        if got_all:
            done_slot = k
            break
    loop_s = time.perf_counter() - t_loop

    # ---- results -------------------------------------------------------------
    ok = True
    for i, (rrc, u) in enumerate(ues):
        dl_ok = [s for _, s in u.delivered] == dl_expect[i]
        print(f"[gnb_sim] UE{i}: DL {len(u.delivered)}/{args.packets} "
              f"{'bytes-exact' if dl_ok else 'MISMATCH'}")
        ok &= dl_ok
    ul_got = [gtpu.decode(x).payload for x in core_rx]
    ul_want = [p for i in range(args.ues) for p in ul_expect[i]]
    ul_ok = sorted(ul_got) == sorted(ul_want)
    print(f"[gnb_sim] UL at core: {len(ul_got)}/{len(ul_want)} "
          f"{'bytes-exact' if ul_ok else 'MISMATCH'}")
    ok &= ul_ok

    if args.handover:
        for i, (rrc, u) in enumerate(ues):
            t_id = du1_f1.allocate_ue(rrc.deliver_dl)
            cucp.start_handover(cu_ue_id=i + 1, target_du_id=1,
                                target_du_ue_id=t_id, target_pci=2)
            ctx = cucp.ues[i + 1]
            print(f"[gnb_sim] UE{i} handover -> DU2: state={ctx.state} "
                  f"du_id={ctx.du_id}")
            ok &= ctx.du_id == 1

    if ric is not None:
        print(f"[gnb_sim] E2: {len(ric.indications)} KPM indications, last records: "
              f"{ric.indications[-1].records if ric.indications else {}}")

    metrics = {"ues": args.ues, "dl_packets": sum(len(u.delivered) for _, u in ues),
               "ul_packets": len(ul_got), "slots_used": done_slot,
               "wall_s": round(time.time() - t0, 2), "ok": ok}
    if args.metrics_json:
        print(json.dumps(metrics))
    return GnbRun(ok=ok, metrics=metrics, ues=ues, core_rx=core_rx, cucp=cucp, ric=ric,
                  phy=phy, loop_t0=t_loop, loop_s=loop_s, slots_run=slots_run)


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    try:
        out = run(args)
    except RuntimeError as e:
        if not str(e).startswith("gnb_sim: no CUDA device"):
            raise
        print(e, file=sys.stderr)
        return 2
    return 0 if out.ok else 1


if __name__ == "__main__":
    sys.exit(main())
