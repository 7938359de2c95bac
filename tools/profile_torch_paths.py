#!/usr/bin/env python3
"""Profile the PyTorch port's decode paths on a CUDA card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/profile_torch_paths.py

It builds the port's kernels (as chip_smoke.py does), then

1. times the flagship float and plane decodes at batch 8 in turns (float,
   plane, plane, float), the 8-UE uplink slot twice and chip_smoke.py's
   path 4 (the whole uplink slot: UCI on PUSCH, ranks 4/2/1, six PUCCH
   occasions) twice, with CUDA events around 10 calls after 2 warm-ups;
2. runs torch.profiler over 5 calls of each path (after 3 warm-ups) and
   prints per call the wall time, the device-busy time (the sum of the
   device kernels' self time), their share, the number of device kernels,
   the six that take the most device time, and the device time and
   launches of each of the port's own kernels (K1 ``decode_dematch_kernel``,
   K2 ``decode_kernel``, K3 ``mmse_weights_4x4_kernel``, K4
   ``demap_planes_kernel``).

The calls of chip_smoke.py's path 5 (a PT-RS grant, a DM-RS type-2 grant
with data on the DM-RS symbol, DFT-s-OFDM with pi/2-BPSK and QPSK, the
slot of narrower grants of those shapes, a two-step CSI grant) are
profiled as well, on chip_smoke.py's inputs.

So are the calls of chip_smoke.py's path 6, the DU-low's FAPI entry
point: its DL_TTI call and its first UL_TTI call through ``UpperPhy``
(timed in turns against path 4 as well), and the UL_TTI call's parts,
each alone on the call's own inputs: ``ul_slot.process_slot`` with the
PUCCH occasions, the two-step CSI grant's ``pusch.process``, and the
SRS estimate.

So are the calls of chip_smoke.py's path 7: its first UL_TTI call (two
PUSCH grants with TA and CFO compensation and a format-0 PRACH occasion,
its demodulation included; timed in turns as well) and that call's
parts, each alone on the call's own inputs: ``ul_slot.process_slot``,
the PRACH demodulation (``lower_phy.prach_demodulate``), ``prach.detect``
and the indications (CRC and RxData of both grants, the RACH
indications); and path 7's PUCCH F3/F4 occasions, batched F1 detector
and PRS estimate.

Path 4 is also split into its host-heavy parts, each profiled alone on
the slot's own inputs: the UCI decodes of its three config groups (short
block and the polar SC decoder on the demultiplexed LLRs), and the six
PUCCH detections.

The inputs are chip_smoke.py's: its uplink slot plans (new data) and 8
random flagship slots at about 30 dB.  Every line starts with ``#``; the
card's name and power limit come first.  The profiler inflates the wall
times it reads.
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The port's kernels by the name of their __global__ function in csrc/.
KERNELS = {"K1": "decode_dematch_kernel", "K2": "decode_kernel",
           "K3": "mmse_weights_4x4_kernel", "K4": "demap_planes_kernel"}


def main() -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from srsran_project_tpu_torch.models import cell
    from srsran_project_tpu_torch.ops import cuda_lib
    from srsran_project_tpu_torch.phy import pucch, pucch_f2, pusch, ul_slot, ulsch_demux

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_paths: needs a CUDA device")
    dev = torch.device("cuda")
    print("#", cs.card_line())
    cuda_lib.library()
    ues, noise = cs.ul_slot_plan()
    grid, cfgs = cs.ul_grid(ues, noise[0], dev)
    pdus = [ul_slot.UlSlotPdu(rnti=u["rnti"], first_rb=u["first_rb"], config=c)
            for u, c in zip(ues, cfgs)]

    ues4, pucch4, noise4 = cs.ul4_plan()
    grid4, cfgs4 = cs.ul4_grid(ues4, pucch4, noise4, dev)
    pdus4 = [ul_slot.UlSlotPdu(rnti=u["rnti"], first_rb=u["first_rb"], config=c)
             for u, c in zip(ues4, cfgs4)]
    f1, f0, f2 = cs.ul4_pucch()
    # The demultiplexed UCI LLRs of each path-4 config group.
    groups4 = ul_slot._config_groups(pdus4)
    uci_llrs = []
    for cfg, idxs in groups4.items():
        rb = tuple(pdus4[i].first_rb for i in idxs)
        rn = torch.tensor([pdus4[i].rnti for i in idxs], device=dev)
        llrs = pusch._multi_front_end(grid4, rn, [12 * r for r in rb],
                                      pusch._pilot_bank_on(dev, cfg, rb), cfg)[0]
        uci_llrs.append((cfg, ulsch_demux.demultiplex(llrs, cfg.uci_mux)[1:]))

    def uci_decodes():
        for cfg, (ack, csi1, csi2) in uci_llrs:
            ulsch_demux.decode_uci_parts(ack, csi1, cfg.uci.nof_harq_ack_bits,
                                         cfg.uci.nof_csi1_bits, csi2_llrs=csi2,
                                         nof_csi2_bits=cfg.uci.nof_csi2_bits)

    def pucch_detections():
        for c in f1:
            pucch.format1_detect(grid4, c)
        for c in f0:
            pucch.format0_detect(grid4, c)
        for c in f2:
            pucch_f2.process(grid4, c)

    fl = cell.CellConfig()
    pl = cell.CellConfig(demapper="planes")
    rng = np.random.default_rng(1)
    tb = torch.from_numpy(rng.integers(0, 2, size=(8, fl.tbs), dtype=np.uint8)).to(dev)
    iq = cell.encode_slot(tb, cs.RNTI, torch.eye(4, dtype=torch.complex64, device=dev), fl)
    rx = iq + 0.03 * torch.randn(iq.shape, dtype=torch.complex64, device=dev) * iq.abs().mean()

    # chip_smoke.py's path 5: each allocation shape and waveform.
    singles5, (grid5, pdus5, _slot5), (_two, cfg5e, grid5e, rnti5e) = cs.p5_inputs(dev)
    shapes = {f"shapes {ue['shape']}": (lambda g=g, r=r, c=c: pusch.process(g, r, c))
              for ue, c, g, r in singles5}
    shapes["shapes slot"] = lambda: ul_slot.process_slot(grid5, pdus5)
    shapes["shapes two-step CSI"] = lambda: pusch.process(grid5e, rnti5e, cfg5e)

    # chip_smoke.py's path 6: the DU-low's FAPI calls and the UL_TTI call's parts.
    from srsran_project_tpu_torch.phy import srs
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig

    phy = UpperPhy(UpperPhyConfig(nof_ports=cs.UL_NOF_PORTS, nof_grid_sc=cs.UL_NOF_PRB * 12))
    dl_req, dl_data, _noise6 = cs.p6_dl_request()
    grid6, ul_req = cs.p6_ul_call(0, cs.p6_ul_plan(), dev)
    pdus6 = cs.p6_slot_pdus(ul_req)
    two6 = ul_req.pusch[-1]
    win6 = grid6[None, :, :, 12 * two6.first_rb : 12 * two6.first_rb + two6.config.nof_grid_sc]
    rnti6 = torch.tensor([two6.rnti], device=dev)
    srs6 = ul_req.srs[0].config
    fapi = {
        "fapi DL_TTI": lambda: phy.process_dl_tti(dl_req, dl_data),
        "fapi UL_TTI": lambda: phy.process_ul_tti(ul_req, grid6),
        "fapi UL_TTI process_slot": lambda: ul_slot.process_slot(grid6, pdus6, f1, f0, f2),
        "fapi UL_TTI two-step CSI": lambda: pusch.process(win6, rnti6, two6.config),
        "fapi UL_TTI SRS": lambda: srs.estimate(grid6, srs6),
    }

    # chip_smoke.py's path 7: the UL_TTI call with PRACH and its parts.
    from srsran_project_tpu_torch.fapi import messages as fapi_msg
    from srsran_project_tpu_torch.phy import prach, ptrs_prs, pucch_f34, upper_phy

    ues7, noise7 = cs.p7_plan()
    grid7 = cs.p7_grid(ues7, noise7, dev)
    samples7 = cs.p7_prach_samples("a", cs.SEED + 70, dev)
    req7 = cs.p7_request("a", ues7)
    fd7 = cs.p7_prach_fd("a", samples7)
    pdus7 = [ul_slot.UlSlotPdu(rnti=u["rnti"], first_rb=u["first_rb"], config=u["config"])
             for u in ues7]
    pcfg7 = req7.prach[0].config
    outs7 = ul_slot.process_slot(grid7, pdus7)[0]
    det7 = prach.detect(fd7, pcfg7)

    def indications7():
        res = fapi_msg.SlotResults(slot=req7.slot)
        for pdu, out in zip(req7.pusch, outs7):
            phy._pusch_indications(res, pdu, out)
        upper_phy.rach_indications(res, det7)

    f34_7, f1_7, _n7 = plan7 = cs.p7_pucch_plan()
    g34_7, g1_7 = cs.p7_pucch_grids(plan7, dev)
    prs7 = ptrs_prs.PrsConfig(**cs.P7_PRS)
    prs_grid7 = ptrs_prs.generate_prs(prs7, device=dev)
    path7 = {
        "prach UL_TTI": lambda: phy.process_ul_tti(req7, grid7,
                                                   prach_fd=cs.p7_prach_fd("a", samples7)),
        "prach UL_TTI process_slot": lambda: ul_slot.process_slot(grid7, pdus7),
        "prach UL_TTI PRACH demodulation": lambda: cs.p7_prach_fd("a", samples7),
        "prach UL_TTI detect": lambda: prach.detect(fd7, pcfg7),
        "prach UL_TTI indications": indications7,
        "pucch F3/F4": lambda: [pucch_f34.process(g34_7, c) for c, _b, _h in f34_7],
        "pucch F1 batch": lambda: pucch.format1_detect_batch(g1_7, f1_7[0][0]),
        "prs": lambda: ptrs_prs.prs_toa_estimate(prs_grid7, prs7, dft_size=4096),
    }

    calls = {
        **path7,
        **shapes,
        **fapi,
        "ul_slot": lambda: ul_slot.process_slot(grid, pdus),
        "ul_slot_uci": lambda: ul_slot.process_slot(grid4, pdus4, f1, f0, f2),
        "ul_slot_uci UCI decodes": uci_decodes,
        "ul_slot_uci PUCCH": pucch_detections,
        "float b=1": lambda: cell.decode_slot(rx[:1], cs.RNTI, fl),
        "plane b=1": lambda: cell.decode_slot(rx[:1], cs.RNTI, pl),
        "float b=8": lambda: cell.decode_slot(rx, cs.RNTI, fl),
        "plane b=8": lambda: cell.decode_slot(rx, cs.RNTI, pl),
    }
    for name in ("float b=8", "plane b=8", "plane b=8", "float b=8", "ul_slot", "ul_slot",
                 "ul_slot_uci", "ul_slot_uci", "shapes slot", "shapes slot", "fapi UL_TTI",
                 "ul_slot_uci", "ul_slot_uci", "fapi UL_TTI", "fapi DL_TTI", "fapi DL_TTI",
                 "prach UL_TTI", "fapi UL_TTI", "fapi UL_TTI", "prach UL_TTI"):
        print(f"# turn {name}: {cs.cuda_ms(calls[name], reps=10, warmup=2):.4f} ms/call")

    reps = 5
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        dev_ev = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in dev_ev) / 1e3 / reps
        nk = sum(e.count for e in dev_ev) / reps
        print(f"# profile {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
              f"({100 * busy / wall:.1f} %), {nk:.0f} device kernels per call")
        top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:6]
        print("#   top: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / (1e3 * reps):.4f} ms x{e.count // reps}"
            for e in top))
        ours = []
        for k, fn in KERNELS.items():
            # Demangled names read "...::decode_kernel<true>(...)", mangled
            # ones "...13decode_kernel..."; either way decode_kernel does
            # not match decode_dematch_kernel.
            hits = [e for e in dev_ev if f"::{fn}" in e.key or f"{len(fn)}{fn}" in e.key]
            if hits:
                ms = sum(e.self_device_time_total for e in hits) / (1e3 * reps)
                ours.append(f"{k} {ms:.4f} ms x{sum(e.count for e in hits) / reps:g}")
        print(f"#   kernels per call: {'; '.join(ours) or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
