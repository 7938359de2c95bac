#!/usr/bin/env python3
"""Profile the PyTorch port's decode paths on a CUDA card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/profile_torch_paths.py

It builds the port's kernels (as chip_smoke.py does), then

1. times the flagship float and plane decodes at batch 8 in turns (float,
   plane, plane, float) and the 8-UE uplink slot twice, with CUDA events
   around 10 calls after 2 warm-ups;
2. runs torch.profiler over 5 calls of each path (after 3 warm-ups) and
   prints per call the wall time, the device-busy time (the sum of the
   device kernels' self time), their share, the number of device kernels,
   the six that take the most device time, and the device time and
   launches of each of the port's own kernels (K1 ``decode_dematch_kernel``,
   K2 ``decode_kernel``, K3 ``mmse_weights_4x4_kernel``, K4
   ``demap_planes_kernel``).

The inputs are chip_smoke.py's: its uplink slot plan (new data) and 8
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
    from srsran_project_tpu_torch.phy import ul_slot

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_paths: needs a CUDA device")
    dev = torch.device("cuda")
    print("#", cs.card_line())
    cuda_lib.library()
    ues, noise = cs.ul_slot_plan()
    grid, cfgs = cs.ul_grid(ues, noise[0], dev)
    pdus = [ul_slot.UlSlotPdu(rnti=u["rnti"], first_rb=u["first_rb"], config=c)
            for u, c in zip(ues, cfgs)]

    fl = cell.CellConfig()
    pl = cell.CellConfig(demapper="planes")
    rng = np.random.default_rng(1)
    tb = torch.from_numpy(rng.integers(0, 2, size=(8, fl.tbs), dtype=np.uint8)).to(dev)
    iq = cell.encode_slot(tb, cs.RNTI, torch.eye(4, dtype=torch.complex64, device=dev), fl)
    rx = iq + 0.03 * torch.randn(iq.shape, dtype=torch.complex64, device=dev) * iq.abs().mean()

    calls = {
        "ul_slot": lambda: ul_slot.process_slot(grid, pdus),
        "float b=1": lambda: cell.decode_slot(rx[:1], cs.RNTI, fl),
        "plane b=1": lambda: cell.decode_slot(rx[:1], cs.RNTI, pl),
        "float b=8": lambda: cell.decode_slot(rx, cs.RNTI, fl),
        "plane b=8": lambda: cell.decode_slot(rx, cs.RNTI, pl),
    }
    for name in ("float b=8", "plane b=8", "plane b=8", "float b=8", "ul_slot", "ul_slot"):
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
