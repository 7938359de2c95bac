#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its uplink and downlink
paths on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

or, on a host with N cards, path 13 (b) alone with one NCCL rank a card
(the ranks are processes of this script, joined on a free localhost port):

    python3 chip_smoke.py --world 4

It builds the port's CUDA kernels from ``srsran_project_tpu_torch/csrc``
(into ``build/``, one ``nvcc`` per source, side by side), checks each
kernel against its plain torch version on the card at the shapes of the
paths below, then drives thirteen paths through the port's public entry
points, each with every kernel launch counter set to 0 just before it and
read just after.  The float paths equalize in K8 (the MMSE weights and
their apply, one launch a config group of 1, 2 or 4 layers on 4 ports
over full data rows), whose launches every path counts; K3 runs on the
plane paths (3, 13 (a)) and where a check holds it against its plain
version on a path's own estimate, and its count is 0 on every other path:

1. the flagship cell (273 PRB, 30 kHz, 4x4, 256QAM r~0.926, LBRM): 8 random
   transport blocks -> ``encode_slot`` -> AWGN at 30 dB -> ``decode_slot``
   (kernel K1, one launch over both E-groups, K8, and K5 and K7, whose
   launches are counted on this path alone), K5 and K1 held against their
   plain versions on the batch's own tensors;
2. a heterogeneous 8-UE uplink slot on the same 273-PRB carrier with 4 RX
   ports -> ``ul_slot.process_slot`` (kernel K2 once per code group, and
   K8): two 4-layer 256QAM grants, four rank-1 64QAM grants and two
   rank-1 QPSK grants whose E exceeds the circular buffer (repetition);
   then the same grid again with UE 3 retransmitted at rv 2 and its HARQ
   buffer attached: UE 3 is attenuated so that rv 0 fails its CRC and the
   rv 0 + rv 2 combine passes.  On each pass K2 is held against its plain
   version on every code group's buffers (BG1 Z=384 and Z=288 on the
   untruncated graph, BG2 Z=36);
3. the flagship decode with ``demapper="planes"`` on the slots of path 1
   (kernels K3, K4 and one K1 launch reading the bit-plane layout), whose
   TB bits must equal the float path's; K4 and K1 are held against their
   plain versions on that batch's own tensors;
4. the whole uplink slot on the same carrier -> ``ul_slot.process_slot``
   (K2 once per code group, K8 a config group): two 4-layer 256QAM grants with 2
   HARQ-ACK bits (reserved, punctured), CSI part 1 of 40 bits and CSI part
   2 of 400 bits (two polar segments); four rank-2 64QAM grants with 11
   HARQ-ACK bits (short block, rate-matched) and CSI part 1 of 19 bits
   (polar + CRC6 + PC bits); two rank-1 QPSK grants with repetition and 1
   HARQ-ACK bit; and six PUCCH occasions: F2 with 22 and 6 UCI bits, F1
   with 1 and 2 HARQ bits (one hopping), F0 with 1 HARQ bit and a positive
   SR and with 2 HARQ bits, both F2 in one K6 launch (counted on this path
   alone).  The UE side is the port's own (``pusch.transmit``
   with UCI, ``pucch.format0/1_generate``, ``pucch_f2.generate``).  K2 is
   held against its plain version on the slot's code groups (BG1 Z=384,
   Z=320, BG2 Z=36);
5. every allocation shape and waveform on the same carrier and 4 RX
   ports, the UE side the port's own (``pdsch.process`` with a
   PdschConfig twin): (a) ``pusch.process`` on a 273-PRB 4x4 256QAM grant
   with PT-RS (K = 2) under a random common phase per symbol (K8, K1);
   (b) a 273-PRB 4x4 64QAM grant with DM-RS type 2 and data on the DM-RS
   symbol (the per-RE equalizer, K1); (c) 270-PRB DFT-s-OFDM grants with
   pi/2-BPSK and with QPSK and the low-PAPR DM-RS (K1 at qm = 1 and 2);
   (d) narrower grants of those shapes side by side through
   ``ul_slot.process_slot``, two PT-RS grants at different PRBs (K2 once
   per code group, K8 once per PT-RS group); (e) a 273-PRB rank-2 grant
   with two-step CSI (RI, part-2 size and bits checked).  K1 is held
   against its plain version on (a)-(c) and (e)'s own LLRs, K3 on (a)'s
   channel estimate, K2 on (d)'s code groups;
6. the DU-low's FAPI entry point (``phy.upper_phy.UpperPhy``) on the same
   carrier with 4 ports: (a) one DL_TTI.request (four equal-config compact
   4-layer 256QAM PDSCH grants in one ``pdsch.process_multi`` batch, a
   PT-RS PDSCH, two PDCCH (one interleaved), an SSB and two CSI-RS on REs
   they do not share) through ``process_dl_tti``: the grid against the sum
   of each PDU's own processor, every DCI back through ``pdcch.receive``
   and the PBCH payload through ``ssb.decode_pbch`` at 20 dB, every PDSCH
   grant CRC-clean through ``pusch.process`` at 30 dB (no kernel in the
   DL_TTI call itself); (b) two UL_TTI.requests through
   ``process_ul_tti``: path 4's shapes narrowed to make room for a
   two-step CSI grant (the per-PDU path, K1) and an SRS, path 4's six
   PUCCH occasions, one UE failing its CRC in the first call and passing
   in the second as an rv-2 retransmission out of the HARQ pool (K2 per
   code group, K8 and K1 each call; K2 held against its plain version on
   both calls' code groups, K3 on group A's estimate, K1 on the two-step
   grant's LLRs); every CRC, RxData, UCI and SRS indication checked;
   (c) the port's ``apps/du_low_sim`` in-process: its defaults (the
   flagship on TDL-A at 25 dB, 8 slots: K1 and K8 a slot), whose exit code
   must match its BLER, and 273 PRB with 4 ports and 1 layer on one tap at
   30 dB (4 slots, K1 a slot), which must be CRC-clean;
7. random access and the rest of the uplink's measurements on the same
   carrier with 4 ports: (a) one UL_TTI.request through
   ``process_ul_tti(request, rx_grid, prach_fd=...)`` with two compact
   4-layer 64QAM grants of 128 PRB (DM-RS on symbols 2 and 11, TA and CFO
   compensation on; per UE a random unitary channel, a delay of +0.40 or
   -0.20 us and a CFO of +400 or -250 Hz, 30 dB; K2 once, K8 once) and a
   format-0 PRACH occasion at PRB 258 carrying preambles 5 and 50 at 2.0
   and 9.0 us, built at 122.88 MHz on the card and demodulated by
   ``lower_phy.prach_demodulate``: both CRCs, each ta_s within 10 ns of
   its delay, the same grid without CFO compensation failing both CRCs,
   exactly the two preambles with their TA, K2 and K3 against their plain
   versions on the call's inputs; (b) a B4 occasion (L_RA 139, 12
   symbols) with one preamble at 0.5 us; (c) a format-0 occasion of noise
   alone, no preamble; (d) ``pucch_f34.process`` on F3 over 16 PRB with
   hopping, additional DM-RS and 100 bits, F3 on 1 PRB with pi/2-BPSK,
   and two F4 UEs on one PRB (OCC 4, indices 0 and 2) at 20 dB; (e)
   ``pucch.format1_detect_batch`` on four F1 UEs on one PRB (shifts
   0/3/6/9, OCC 0/1); (f) ``prs_toa_estimate`` on a 270-PRB comb-4 PRS
   delayed by 37.3 samples.  (b)-(f) launch no kernel;
8. the reference-exact conformance modes: (a) ``pusch.process`` on the
   flagship grant (273 PRB, 4x4 over a random unitary channel, 256QAM r
   948/1024, DM-RS on symbol 2, 30 dB) with ``estimator="reference"``: K8
   and K1 once each, K3 and K1 held against their plain versions on the
   call's inputs; (b) the whole conformance chain (reference estimator,
   ``zf_ref`` / ``mmse_ref``, the int8 demapper, ``decode_i8`` without
   early stop) on 273-PRB 64QAM MCS 20 grants, 2 layers on 2 ports and 1
   layer on 4 ports, DM-RS on symbols 2 and 11: no kernel; (c) the
   BLER-parity harness (``apps/bler_parity.run_case``, reference
   estimator) on manifest rows 0 (TDL-A 9 dB), 7 (one tap, 60 dB) and 8
   (TDL-A 12 dB, rank 2) at 60, 30 and 60 slots, each CRC BLER within 3
   binomial sigmas + 0.02 of the reference's: K2 once per 30-slot chunk,
   held against its plain version on one chunk's buffers; (d)
   ``apps/du_low_sim`` with ``configs/conformance_parity.yml`` for 20
   slots, exit 0 and BLER below 1: no kernel;
9. the DU-low's scheduler mode on the app's default cell (273 PRB, 30
   kHz, 4 ports): (a) ``du_low_sim --ues 8 --tdd --policy qos --common
   --slots 40 --metrics-json --metrics-interval-slots 10`` in-process on
   TDL-A at 25 dB: exit 0 with BLER below 1, four periodic reports, the
   common-channel counters of 40 slots (SSB 1, SIB1 1, CSI-RS 1, PRACH 2,
   each PRACH PDU an error indication without a buffer), and K2 once per
   code group on every UL slot of two or more grants (K2 held against its
   plain version on the first such call's code groups); (b) ``--ues 8
   --cells 2 --slots 20``: per-cell reports, exit 0, K2 in each cell's UL
   calls; (c) ``l2sim.RoundRobinScheduler`` at 4 layers on 4 ports, 8 UEs
   at MCS 20, with PDCCH allocation and DCI 1_0, PUCCH, SRS and TA loops,
   20 FDD slots through ``SlotPipeline(depth=2)`` and ``UpperPhy`` over a
   random unitary channel at 30 dB: every grant CRC-clean, one DCI per DL
   grant decoding back from the DL grid, K2 and K3 held against their
   plain versions on one slot's inputs, the pipeline's late ratio against
   0.5 ms printed.  Every UL_TTI call's launches are checked against the
   ones its grants imply (K2 per code group with two or more grants, else
   K1; K3 never).
10. initial access and the MAC's remaining stages on the app's default
   cell (273 PRB, 30 kHz, 4 ports): (a) 4-step random access into
   connected data, slots 136-164 through ``CellScheduler`` with every
   stage (the RR data scheduler at 4 layers and MCS 20 with PDCCH
   allocation, three UEs connected, one a slot; the fallback stage; the SI,
   PF/PO paging and CSI-RS engines) and ``RaManager``, every request
   reaching ``UpperPhy`` through ``MessageBufferer(l2_nof_slots_ahead=2)``:
   a format-0 preamble delayed 25 us through ``lower_phy.prach_demodulate``,
   the RAR read back (RAPID, TC-RNTI, TA command), Msg3 alone in its
   UL_TTI (K1), Msg4 with the ConRes CE NACKed once and retransmitted,
   SRB1, then the UE's data grants (K1 and K8 a call), every CRC OK; the
   SI and paging PDSCH read back, the counters, the bufferer's stats and
   each UL_TTI call's launches checked; K1 and K3 against their plain
   versions on the calls' inputs; (b) ``SliceScheduler`` over an ``rr``
   and a ``qos`` slice of 4 UEs each for 10 FDD slots, the RRM policy
   raising slice 2's minimum after slot 5: quotas, disjoint PRBs, every
   CRC, each call's launches (slice 1's grants through ``process_slot``,
   K2 and K8; slice 2's, whose window is not at their crb_start, one by
   one, K1 and K8), K2 and K3 against their plain versions; (c) the
   helpers on CUDA tensors against their CPU results: ``decode_count_iters``
   on the flagship's 141 codeblocks (beside K1's iterations on the same
   LLRs), ``detect_ref``, ``hard_decision_bits`` and ``selection_indices``.
11. the radio-unit path on the app's default cell (273 PRB, 4 ports, 4
   layers, 256QAM r 948/1024, a 4096-point DFT at 122.88 MHz): (a)
   ``du_low_sim --ru generic --slots 10 --snr-db 30`` in-process (the DL
   grid OFDM-modulated by ``ru.RuGeneric``, looped back with AWGN and
   demodulated as the uplink): every CRC OK, K1 + K8 in each UL_TTI call,
   both against their plain versions on its first call's grid; the RU's
   modulate and demodulate on one slot against the CPU within 1e-4 x RMS;
   a format-0 PRACH occasion (path 7's two preambles) through the RU at
   122.88 MHz, detected with its delays (no kernel); (b) ``--ru ofh``
   (``ru.RuOfh``: paced C-/U-plane frames with 9-bit BFP from the port's
   native library, the wire looped back): every CRC OK, K1 + K8 a call, no
   late, early, lost or evicted frame, 8 C-plane and 112 U-plane frames a
   slot; then one slot replayed stage by stage (DL_TTI, the grid's copy to
   the host, serdes, the copy back, UL_TTI); (c) one 273-PRB 4-layer
   16QAM grant through the RU and the time-domain TDL-A
   (``apply_channel_time_taps`` on the card against the CPU on the same
   draws), CRC OK (K1 + K8); (d) the scheduler mode with ``--pcap`` and
   ``--remote-port 0``: a WebSocket client subscribes, reads a periodic
   report, asks for the metrics and quits the run; the pcap holds one
   record per scheduled DL TB (K2 per code group in each UL_TTI call).
12. the monolithic gNB (``apps/gnb_sim.run``: AMF, CU-CP with mobility,
   CU-UP, DU-high, E2 and the UE side; a 48-PRB scheduler on a 624-
   subcarrier grid, 1 port, MCS 6): (a) ``--ues 4 --packets 8 --slots 80
   --snr-db 25 --handover --e2 --pcap-dir``: 32/32 IP packets each way
   bytes-exact through GTP-U, SDAP, PDCP (NEA2/NIA2), NR-U, RLC AM, MAC and
   ``UpperPhy``; every UE on DU 2 after the handover; KPM indications; the
   NGAP, F1AP, E1AP, E2AP and GTP-U pcaps written; every UL_TTI call's
   launches as its grants imply (K2 per code group for two or more grants,
   K1 for one new-data grant, K2 for a retransmission, no K3); K2 and K1
   against their plain versions on the first UL slot's grid; the host time
   of a slot split between the PHY calls, the scheduler and the ciphers;
   (b) the same on TDL-A with 2 UEs and 4 packets; (c) ``--testmode 16
   --slots 200`` (no PHY): its counters equal the ``--cpu`` run's; (d)
   ``units.compose_gnb(with_phy=True)``: the upper PHY on the card.
13. the last slice: (a) ``cell.encode_slots_scan`` / ``decode_slots_scan``
   at the flagship, 2 chunks of 4 slots: the energies against the
   per-slot ``encode_slot``'s (``P13_ENERGY_RTOL``), every decode
   CRC-clean with no bit error at 30 dB, K1 and K8 once a chunk, and with
   ``demapper="planes"`` K1 (planes), K3 and K4 once a chunk; K1, K3 and
   K4 against their plain versions on chunk 0's tensors; ms a chunk and
   slots/s; (b) the parallel layer on a world of one (``parallel.mesh.
   init_world``: NCCL, rank 0, the card; ``--world N``: N ranks): the
   halo-exchange smoothing; ``sharded_transmit`` -> ``sharded_decode`` at
   the flagship's PUSCH config, with the whole TB decoded (K1) and with the
   codeblocks sharded (K2), against the port's unsharded front end (LLRs
   within 1, 99.9 % equal; noise variance and SNR within
   ``P13_METRIC_RTOL``) and decode (TB bits and CRC exact); K1 and K2
   against their plain versions on the path's LLRs; on an even world the
   sp x dp composition; ``metrics_allreduce`` of a known batch; the
   process group destroyed in a ``finally``; (c) the port's ``apps.cu_sim`` and ``apps.du_sim`` as two
   processes over UDP on a free port, 4 UEs attached with DRB 1 (host
   code); (d) ``support.replay``: 4 UL slots at 273 PRB and 1 port through
   ``UpperPhy`` on the card sequentially and then one thread a slot (K1
   once a slot), ``diff_traces`` of the two empty, K1 against its plain
   version on slot 0's grant; (e) three TRPs through
   ``l3.positioning.PositioningProcedure`` with ``prs_toa_estimate`` on the
   card (273-PRB comb-4 PRS), every RSTD within 0.7 samples (no kernel).

Every CRC, every TB and UCI bit, every ``_ok`` flag and every PUCCH value
is checked, and each PUCCH metric against its DTX threshold.  It then times each path per slot and
the flagship decode's stages (CUDA events around eager calls, host
included), each kernel's device time (``kernel_ms``: calls queued behind a
sleep kernel, so they run back to back) and its plain version's time
(events, host included).

Output: progress and timing lines, then one JSON line with the kernels
(time, plain version's time, the bound computed from this run's inputs,
launches per path, device time and bound at path 5's shapes
("shapes_ms") and, for K2 and K3, on path 7 (a)'s inputs
("prach_ul_tti_ms"), and for K1, K2 and K3 on path 8's inputs
("refmodes_ms", "refmodes_bound_ms"); K6 at ``fapi_ul_tti``'s four F2
occasions; K7 at the flagship and at every config group of ``mu8_ul`` and
``fapi_ul_tti``, K8 at the flagship and at ``mu8_ul``'s config groups
("shapes"); the resident blocks per SM, and for K3, K4, K5, K6, K7 and K8
the registers a thread and the same three numbers at 8 flagship slots, "b8_",
K3 also at the uplink slot's group A, "group_a_"), the
card's name and power limit, and as the LAST line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises (non-zero exit, no result line).  There is no CPU
path: without a CUDA device the script exits non-zero.  JAX is never
imported.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SNR_DB = 30.0
NOF_SLOTS = 8
RNTI = 0x4601
SEED = 0
DEVICE = "cuda"  # every path's tensors live here

# The heterogeneous uplink slot: one 273-PRB carrier, 4 RX ports, every
# grant on the flagship's symbols 1-13 with DM-RS on symbol 2.  Per group:
# (UEs, layers, bits per symbol, code rate, PRBs each).  The rates are
# MCS 20 and MCS 0 of the 64QAM MCS table (TS 38.214 Table 5.1.3.1-1):
# 567/1024 (benchmarks/multi_ue_bench.py's MCS) and 120/1024.
UL_NOF_PRB = 273
UL_NOF_PORTS = 4
UL_GROUPS = (
    (2, 4, 8, 948.0 / 1024.0, 80),  # A: UEs 0-1, PRB 0-159
    (4, 1, 6, 567.0 / 1024.0, 24),  # B: UEs 2-5, PRB 160-255
    (2, 1, 2, 120.0 / 1024.0, 8),   # C: UEs 6-7, PRB 256-271, repetition
)
UL_RETX_UE = 3
UL_RETX_ATTEN_DB = 19.0  # rv 0 alone fails, rv 0 + rv 2 passes (see ul_slot_plan)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line(index: int = 0) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
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


def kernel_ms(fn, reps: int = 20) -> float:
    """Mean device time of one kernel call fn() in ms, without the host's
    share: a sleep kernel holds the stream while the host queues a warm-up
    and `reps` calls, so they run back to back between the CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # about 25 ms at 2 GHz, longer than the queueing
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s
# and float32 operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# No single PyTorch call computes any of the kernels' functions
# (min-sum decoding, 4x4 MMSE weights with their post-equalization noise,
# fused [apply +] max-log demap + quantize + descramble, the F2 receiver,
# the DM-RS estimate with its second-difference noise), so library_ms is
# null for all.
LIBRARY_MS = None


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(the least time in ms the card could take: the larger of bytes
    moved over HBM's rate and float32 operations over its peak, which of
    the two bounds it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def ldpc_bound(plan, iters, inputs, outputs) -> tuple[float, str]:
    """K1 and K2: each input and output once; 9 float32 operations per
    edge, z and iteration run (v = APP - r, the three-operation running
    two-minimum update, the argmin, sign and hard-decision compares, the
    fused multiply-add as 2) and 2 per check row (0.8 m1, 0.8 m2), at the
    iterations each codeblock ran."""
    per_iter = (9 * plan.total_edges + 2 * len(plan.layers)) * plan.z
    return bound(nbytes(*inputs, *outputs), per_iter * float(iters.sum()))


# ---- launch counters ---------------------------------------------------------

def _counted():
    """(name, wrapper, attribute) of every kernel launch counter."""
    from srsran_project_tpu_torch.ops import demap_planes, equalizer
    from srsran_project_tpu_torch.ops.ldpc import decoder

    return (("decode_dematch", decoder.decode_dematch, "launches"),
            ("decode_dematch_planes", decoder.decode_dematch, "plane_launches"),
            ("decode", decoder.decode, "launches"),
            ("mmse_weights_4x4", equalizer.mmse_weights_4x4, "launches"),
            ("mmse_equalize", equalizer.mmse_equalize, "launches"),
            ("demap_planes", demap_planes.demap_planes, "launches"))


def k8_launches(cfgs) -> int:
    """K8's launches for one front end of each of these PuschConfigs: MMSE
    on 4 ports at 1, 2 or 4 layers over full data rows."""
    from srsran_project_tpu_torch.phy import pusch

    return sum(1 for c in cfgs if c.equalizer == "mmse" and c.nof_rx_ports == 4
               and c.nof_layers in (1, 2, 4) and pusch.pdsch_mod.uniform_data_rows(c.alloc))


def reset_counts() -> None:
    for _name, fn, attr in _counted():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    """Launches per kernel since the last reset; decode_dematch counts the
    stream layout only, decode_dematch_planes the plane layout."""
    counts = {name: getattr(fn, attr) for name, fn, attr in _counted()}
    counts["decode_dematch"] -= counts["decode_dematch_planes"]
    return counts


def expect_counts(path: str, got: dict, want: dict) -> None:
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        fail(f"{path}: kernel launches {got}, want {want}")
    print(f"# {path}: kernel launches {got}")


# ---- the uplink slot ---------------------------------------------------------

def ul_config(layers: int, qm: int, rate: float, nof_rb: int, first_rb: int, rv: int = 0):
    """The port's PuschConfig of one grant: a compact window of nof_rb PRBs
    (rb_start 0, crb_start first_rb for the DM-RS) with the flagship's
    symbols, DM-RS, TBS rule and decoder settings."""
    from srsran_project_tpu_torch.models.cell import CellConfig
    from srsran_project_tpu_torch.ops.modulation import Modulation

    pc = CellConfig(nof_rb=nof_rb, nof_ports=UL_NOF_PORTS, nof_layers=layers,
                    modulation=Modulation(qm), target_code_rate=rate).pusch_cfg
    return dataclasses.replace(pc, alloc=dataclasses.replace(pc.alloc, crb_start=first_rb),
                               rv=rv)


def ul_slot_plan(seed: int = SEED, atten_db: float = UL_RETX_ATTEN_DB):
    """Everything random about the two passes of the uplink slot, made with
    numpy from ``seed``: per UE a dict of rnti, first_rb, (layers, qm, rate,
    nof_rb), TB bits and its (layers, 4) channel (a random unitary matrix
    for 4 layers, a random unit-norm row for one, UE 3's scaled down by
    ``atten_db``); and the complex noise of each pass, (2, 4, 14, 3276) at
    SNR_DB per RE and port.  On seed 0, UE 3 (64QAM r 0.55, post-MRC SNR
    30 - atten_db) fails at rv 0 and passes once rv 2 is combined in for
    atten_db from 17 to 21 dB, in the JAX package and in the port alike on
    the CPU; 19 dB sits in the middle
    (tests/test_torch_ul_slot.py::test_chip_smoke_retransmission_pair)."""
    rng = np.random.default_rng(seed)
    ues = []
    rb = 0
    for nof_ues, layers, qm, rate, nof_rb in UL_GROUPS:
        for _ in range(nof_ues):
            ue = len(ues)
            cfg = ul_config(layers, qm, rate, nof_rb, rb)
            tb = rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8)
            h = rng.standard_normal((layers, layers if layers > 1 else UL_NOF_PORTS, 2))
            h = h[..., 0] + 1j * h[..., 1]
            if layers > 1:
                h = np.linalg.qr(h)[0]
            else:
                h = h / np.linalg.norm(h)
            if ue == UL_RETX_UE:
                h = h * 10 ** (-atten_db / 20)
            ues.append(dict(rnti=RNTI + ue, first_rb=rb, shape=(layers, qm, rate, nof_rb),
                            tb=tb, channel=h.astype(np.complex64)))
            rb += nof_rb
    sigma = np.sqrt(0.5 * 10 ** (-SNR_DB / 10))
    noise = rng.standard_normal((2, UL_NOF_PORTS, 14, UL_NOF_PRB * 12, 2)) * sigma
    return ues, (noise[..., 0] + 1j * noise[..., 1]).astype(np.complex64)


def ul_grid(ues, noise, device, retx_rv: int | None = None):
    """The received (4, 14, 3276) grid of one pass, built on ``device`` with
    the port's transmitter, and each UE's config (UE 3 at retx_rv when
    given)."""
    import torch

    from srsran_project_tpu_torch.phy import pusch

    grid = torch.from_numpy(noise).to(device)
    cfgs = []
    for i, ue in enumerate(ues):
        rv = retx_rv if (retx_rv is not None and i == UL_RETX_UE) else 0
        cfg = ul_config(*ue["shape"], ue["first_rb"], rv)
        sub = pusch.transmit(torch.from_numpy(ue["tb"]).to(device),
                             torch.tensor(ue["rnti"], device=device), cfg,
                             precoding=torch.from_numpy(ue["channel"]).to(device))
        sc0 = 12 * ue["first_rb"]
        grid[:, :, sc0 : sc0 + cfg.nof_grid_sc] += sub
        cfgs.append(cfg)
    return grid, cfgs


# K2's checks: (iterations, early stop), each with bits only and with the
# a-posteriori LLRs.
K2_SETTINGS = ((0, False), (1, False), (6, False), (6, True))


def check_k2(llrs, bg: int, z: int, n_cb, name: str) -> float:
    """K2 against its plain version on (C, N) buffers at every K2_SETTINGS:
    bits, per-codeblock iterations and a-posteriori LLRs equal (bitwise).
    Returns the largest a-posteriori difference."""
    import torch

    from srsran_project_tpu_torch.ops.ldpc import decoder

    plan = decoder.decode_plan(bg, z, llrs.shape[-1], n_cb)
    err = 0.0
    for iters, early in K2_SETTINGS:
        for bits_only in (True, False):
            args = (llrs, bg, z, iters, early, bits_only, n_cb)
            bits_k, app_k, it_k = decoder.decode(*args)
            bits_p, app_p, it_p = decoder.decode_plain(*args)
            torch.cuda.synchronize()
            what = (f"K2 {name} BG{bg} Z={z} C={llrs.shape[0]} iterations={iters} "
                    f"early_stop={early} bits_only={bits_only}")
            if not torch.equal(bits_k, bits_p):
                fail(f"{what}: {int((bits_k != bits_p).sum())} bits differ from the plain "
                     f"version")
            if not torch.equal(it_k, it_p):
                fail(f"{what}: iteration counts differ from the plain version")
            if not early and not bool((it_k == iters).all()):
                fail(f"{what}: fixed-budget iteration count is not {iters}")
            if not bits_only:
                err = max(err, float((app_k - app_p).abs().max()))
                if not torch.equal(app_k.view(torch.int32), app_p.view(torch.int32)):
                    fail(f"{what}: a-posteriori LLRs differ (max {err:.3e})")
    print(f"# K2 {name} BG{bg} Z={z} C={llrs.shape[0]} rows={len(plan.layers)} n_cb={n_cb} "
          f"{plan.shared_bytes} B shared: bits, iterations (mean "
          f"{it_k.float().mean().item():.2f} with early stop) and a-posteriori LLRs equal the "
          f"plain version at {len(K2_SETTINGS)} settings")
    return err


def check_code_groups(grid, pdus, name: str) -> tuple[float, list]:
    """K2 against its plain version on the very buffers ``process_slot``
    hands it for ``grid`` and ``pdus``, per code group.  Returns the
    largest a-posteriori difference and the groups as "BG<bg> Z=<z>"."""
    from srsran_project_tpu_torch.phy import ul_slot

    groups = ul_slot._config_groups(pdus)
    cfgs = tuple(groups)
    fronts = ul_slot._slot_front(grid, groups, pdus)
    err, geometries = 0.0, []
    for (bg, z, _iters, _early, n_cb), _gis, _sizes, llrs in ul_slot._code_groups(cfgs, fronts):
        err = max(err, check_k2(llrs, bg, z, n_cb, name))
        geometries.append(f"BG{bg} Z={z}")
    return err, geometries


def ul_slot_phase(card: str) -> tuple[dict, float]:
    """Path 2: the 8-UE slot and UE 3's retransmission, with the launch
    counters read around each pass and K2 checked against its plain
    version on each pass's code groups; returns the launch counts of the
    first pass and K2's largest a-posteriori difference."""
    import torch

    from srsran_project_tpu_torch.phy import ul_slot

    dev = torch.device(DEVICE)
    ues, noise = ul_slot_plan()
    results, counts = [], None
    harq = None
    k2_err = 0.0
    for p, (rv, pass_noise) in enumerate(((None, noise[0]), (2, noise[1]))):
        grid, cfgs = ul_grid(ues, pass_noise, dev, retx_rv=rv)
        pdus = [ul_slot.UlSlotPdu(rnti=ue["rnti"], first_rb=ue["first_rb"], config=cfg,
                                  harq_buffer=harq if i == UL_RETX_UE else None)
                for i, (ue, cfg) in enumerate(zip(ues, cfgs))]
        torch.cuda.synchronize()
        reset_counts()
        res, _, _ = ul_slot.process_slot(grid, pdus)
        torch.cuda.synchronize()
        got = read_counts()
        codes = {(c.sch.seg.base_graph, c.sch.seg.lifting_size, c.nof_ldpc_iterations,
                  c.ldpc_early_stop, c.sch.n_cb) for c in cfgs}
        if len(codes) != 3:
            fail(f"ul_slot pass {p}: {len(codes)} code groups, want 3")
        expect_counts(f"ul_slot pass {p}", got, {
            "decode": len(codes), "mmse_equalize": k8_launches(ul_slot._config_groups(pdus))})
        err, geometries = check_code_groups(grid, pdus, f"ul_slot pass {p}")
        want = ["BG1 Z=384", "BG1 Z=288", "BG2 Z=36"]
        if sorted(geometries) != sorted(want):
            fail(f"ul_slot pass {p}: K2 code groups {geometries}, want {want}")
        k2_err = max(k2_err, err)
        if counts is None:
            counts = got
            first = (grid, pdus)
        harq = res[UL_RETX_UE]["harq_buffer"]
        results.append(res)

    for p, res in enumerate(results):
        ok = [bool(r["tb_crc_ok"]) for r in res]
        errs = [int((r["tb_bits"].cpu().numpy() != ue["tb"]).sum()) for r, ue in zip(res, ues)]
        snr = [round(float(r["snr_db"]), 2) for r in res]
        print(f"# ul_slot pass {p} ({'new data' if p == 0 else 'UE 3 at rv 2 + HARQ'}): "
              f"CRC ok {ok}, bit errors {errs}, SINR dB {snr}")
        for i, (r, e) in enumerate(zip(res, errs)):
            want = p == 1 or i != UL_RETX_UE
            if ok[i] != want or (want and e):
                fail(f"ul_slot pass {p}, UE {i}: CRC {ok[i]} with {e} bit errors, "
                     f"want CRC {want}" + (" and every bit right" if want else ""))
            if not (np.isfinite(float(r["noise_var"])) and np.isfinite(float(r["snr_db"]))):
                fail(f"ul_slot pass {p}, UE {i}: non-finite noise_var / snr_db")
    repeated = [i for i, c in enumerate(cfgs) if not _fused_ok(c)]
    if repeated != [6, 7]:
        fail(f"ul_slot: repetition geometry at UEs {repeated}, want [6, 7]")

    grid, pdus = first
    ms = cuda_ms(lambda: ul_slot.process_slot(grid, pdus), reps=5)
    print(f"# [{card}] ul_slot: 8 UEs, 3 configs, 273 PRB x 4 ports: {ms:.4f} ms/slot")
    return counts, k2_err


def _fused_ok(cfg) -> bool:
    from srsran_project_tpu_torch.phy.sch import _fused_decode_ok

    return _fused_decode_ok(cfg.sch)


# ---- the whole uplink slot ---------------------------------------------------

# Path 4 on the same carrier and grant symbols: per group (UEs, layers,
# bits per symbol, code rate, PRBs each, (HARQ-ACK, CSI part 1, CSI part 2)
# payload bits on PUSCH), beta offset indices 9 (the defaults).
UL4_GROUPS = (
    (2, 4, 8, 948.0 / 1024.0, 80, (2, 40, 400)),  # A: UEs 0-1, PRB 0-159 (K3)
    (4, 2, 6, 567.0 / 1024.0, 22, (11, 19, 0)),   # B: UEs 2-5, PRB 160-247
    (2, 1, 2, 120.0 / 1024.0, 8, (1, 0, 0)),      # C: UEs 6-7, PRB 248-263, repetition
)
UL4_RNTI = 0x4701
UL4_NID = 1  # PUCCH hopping / scrambling id
# Per group: TBS, G_ack, reserved ACK bits, G_csi1, G_csi2, SCH data bits
# (the JAX package's PuschConfig.uci_mux on these grants).
UL4_MUX = ((344376, 32, 32, 192, 1376, 367072), (21000, 252, 0, 144, 0, 37620),
           (272, 100, 198, 0, 0, 2304))


def ul4_pucch():
    """Path 4's PUCCH occasions: (F1 configs, F0 configs, F2 configs)."""
    from srsran_project_tpu_torch.phy import pucch, pucch_f2

    nsc = UL_NOF_PRB * 12
    f2 = dict(start_symbol=12, nof_symbols=2, n_id=UL4_NID, n_id0=UL4_NID,
              nof_rx_ports=UL_NOF_PORTS, nof_grid_sc=nsc)
    f1 = dict(start_symbol=0, nof_symbols=14, occ_index=0, n_id=UL4_NID, nof_grid_sc=nsc)
    f0 = dict(start_symbol=12, nof_symbols=2, initial_cyclic_shift=0, n_id=UL4_NID,
              nof_grid_sc=nsc)
    # F1 #1 starts on PRB 267, not on F1 #0's PRB: the lone-occasion F1
    # detector (``pucch.format1_detect``, the reference's) estimates the
    # channel per subcarrier, so a second F1 on the same PRB would add its
    # own d |h|^2 to the correlation and pull rho under the DTX threshold.
    # Occasions that share a resource go through the batch detector instead
    # (``pucch.format1_detect_all``, the routing ``ul_slot.process_slot`` and
    # ``UpperPhy`` take); this path keeps one occasion a resource.
    return ((pucch.PucchFormat1Config(prb=266, initial_cyclic_shift=0, nof_harq_bits=1, **f1),
             pucch.PucchFormat1Config(prb=267, initial_cyclic_shift=6, nof_harq_bits=2,
                                      second_hop_prb=272, **f1)),
            (pucch.PucchFormat0Config(prb=268, nof_harq_bits=1, sr_opportunity=True, **f0),
             pucch.PucchFormat0Config(prb=269, nof_harq_bits=2, **f0)),
            (pucch_f2.PucchFormat2Config(rb_start=264, rb_count=2, nof_uci_bits=22,
                                         rnti=0x4711, **f2),
             pucch_f2.PucchFormat2Config(rb_start=270, rb_count=2, nof_uci_bits=6,
                                         rnti=0x4712, **f2)))


def ul4_config(layers: int, qm: int, rate: float, nof_rb: int, uci: tuple, first_rb: int):
    """A path-4 grant: ``ul_config`` with UCI on PUSCH."""
    from srsran_project_tpu_torch.phy.pusch import UciOnPuschConfig

    return dataclasses.replace(ul_config(layers, qm, rate, nof_rb, first_rb),
                               uci=UciOnPuschConfig(*uci))


def _unit_rows(rng, rows: int) -> np.ndarray:
    """(rows, 4) complex64 channel: a random unitary matrix (4 rows),
    orthonormal rows (2), a unit-norm row (1)."""
    h = rng.standard_normal((UL_NOF_PORTS, rows, 2))
    h = h[..., 0] + 1j * h[..., 1]
    h = np.linalg.qr(h)[0] if rows > 1 else h / np.linalg.norm(h)
    return h.T.astype(np.complex64)


def ul4_plan(seed: int = SEED):
    """Everything random about path 4, made with numpy from ``seed``: per UE
    a dict of rnti, first_rb, shape, UCI sizes, TB bits, UCI payloads and
    channel; per PUCCH occasion (in the order F1, F0, F2) its payload and
    (1, 4) channel; the (4, 14, 3276) noise at SNR_DB per RE and port."""
    rng = np.random.default_rng(seed + 4)
    ues, rb = [], 0
    for nof_ues, layers, qm, rate, nof_rb, uci in UL4_GROUPS:
        for _ in range(nof_ues):
            cfg = ul4_config(layers, qm, rate, nof_rb, uci, rb)
            ues.append(dict(rnti=UL4_RNTI + len(ues), first_rb=rb,
                            shape=(layers, qm, rate, nof_rb, uci),
                            tb=rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8),
                            uci=[rng.integers(0, 2, size=(n,), dtype=np.uint8) if n else None
                                 for n in uci],
                            channel=_unit_rows(rng, layers)))
            rb += nof_rb
    f1, f0, f2 = ul4_pucch()
    pucch = {"f1": [(rng.integers(0, 2, size=(c.nof_harq_bits,), dtype=np.uint8),
                     _unit_rows(rng, 1)) for c in f1],
             "f0": [(v, _unit_rows(rng, 1)) for v in (1, 2)],  # F0 #0 with a positive SR
             "f2": [(rng.integers(0, 2, size=(c.nof_uci_bits,), dtype=np.uint8),
                     _unit_rows(rng, 1)) for c in f2]}
    sigma = np.sqrt(0.5 * 10 ** (-SNR_DB / 10))
    noise = rng.standard_normal((UL_NOF_PORTS, 14, UL_NOF_PRB * 12, 2)) * sigma
    return ues, pucch, (noise[..., 0] + 1j * noise[..., 1]).astype(np.complex64)


def ul4_grid(ues, pucch_plan, noise, device):
    """The received (4, 14, 3276) grid of path 4, built on ``device`` by the
    port's own UE-side code (``pusch.transmit`` with UCI,
    ``pucch.format0/1_generate``, ``pucch_f2.generate``), and each UE's
    config (``ul4_config`` of its shape, or the UE's own "config")."""
    import torch

    from srsran_project_tpu_torch.phy import pucch, pucch_f2, pusch

    def on(x):
        return torch.from_numpy(x).to(device)

    grid = on(noise)
    cfgs = []
    for ue in ues:
        cfg = ue["config"] if "config" in ue else ul4_config(*ue["shape"], ue["first_rb"])
        sub = pusch.transmit(on(ue["tb"]), torch.tensor(ue["rnti"], device=device), cfg,
                             *[None if u is None else on(u) for u in ue["uci"]],
                             precoding=on(ue["channel"]))
        sc0 = 12 * ue["first_rb"]
        grid[:, :, sc0 : sc0 + cfg.nof_grid_sc] += sub
        cfgs.append(cfg)
    f1, f0, f2 = ul4_pucch()
    for c, (bits, h) in zip(f1, pucch_plan["f1"]):
        sig = pucch.format1_generate(c, bits, device=device)
        for syms, _dmrs, _data, prb in pucch._f1_hops(c):
            for s in syms:
                grid[:, s, 12 * prb : 12 * prb + 12] += on(h[0])[:, None] * sig[s - c.start_symbol]
    for c, (value, h) in zip(f0, pucch_plan["f0"]):
        sig = pucch.format0_generate(c, value, sr=c.sr_opportunity, device=device)
        for i in range(c.nof_symbols):
            grid[:, c.start_symbol + i, 12 * c.prb : 12 * c.prb + 12] += on(h[0])[:, None] * sig[i]
    for c, (bits, h) in zip(f2, pucch_plan["f2"]):
        grid += on(h[0])[:, None, None] * pucch_f2.generate(c, bits, device=device)
    return grid, cfgs


def ul4_phase(card: str) -> tuple[dict, float]:
    """Path 4: the 8-UE slot with UCI on PUSCH at ranks 1, 2 and 4 and six
    PUCCH occasions (F0, F1, F2) through ``ul_slot.process_slot``, with
    the launch counters read around it and K2 checked against its plain
    version on the slot's code groups; returns the launch counts and K2's
    largest a-posteriori difference."""
    import torch

    from srsran_project_tpu_torch.ops import pucch_f2_rx
    from srsran_project_tpu_torch.phy import pucch, ul_slot

    dev = torch.device(DEVICE)
    ues, pucch_plan, noise = ul4_plan()
    grid, cfgs = ul4_grid(ues, pucch_plan, noise, dev)
    f1, f0, f2 = ul4_pucch()
    pdus = [ul_slot.UlSlotPdu(rnti=ue["rnti"], first_rb=ue["first_rb"], config=cfg)
            for ue, cfg in zip(ues, cfgs)]
    for g, (nof_ues, *_rest) in enumerate(UL4_GROUPS):
        c = cfgs[sum(n for n, *_r in UL4_GROUPS[:g])]
        m = c.uci_mux
        got = (c.tbs, m.g_ack, m.g_ack_rvd, m.g_csi1, m.g_csi2, m.nof_data_bits)
        if got != UL4_MUX[g]:
            fail(f"ul_slot_uci group {'ABC'[g]}: (TBS, G_ack, reserved, G_csi1, G_csi2, data) "
                 f"{got}, want {UL4_MUX[g]}")
        print(f"# ul_slot_uci group {'ABC'[g]} ({nof_ues} UEs): TBS {got[0]}, G_ack {got[1]} "
              f"(reserved {got[2]}), G_csi1 {got[3]}, G_csi2 {got[4]}, SCH data bits {got[5]}, "
              f"{c.sch.seg.nof_codeblocks} codeblocks BG{c.sch.seg.base_graph} "
              f"Z={c.sch.seg.lifting_size}")

    def run():
        return ul_slot.process_slot(grid, pdus, f1, f0, f2)

    torch.cuda.synchronize()
    reset_counts()
    k6_before = pucch_f2_rx.receive.launches
    res, f1_out, f0_out, f2_out = run()
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("ul_slot_uci", counts, {
        "decode": 3, "mmse_equalize": k8_launches(ul_slot._config_groups(pdus))})
    # K6 is counted on this path alone: both F2 occasions in one launch.
    counts["pucch_f2_rx"] = pucch_f2_rx.receive.launches - k6_before
    if counts["pucch_f2_rx"] != 1:
        fail(f"ul_slot_uci: {counts['pucch_f2_rx']} K6 launches for the two F2 occasions, want 1")
    k2_err, geometries = check_code_groups(grid, pdus, "ul_slot_uci")
    want = ["BG1 Z=384", "BG1 Z=320", "BG2 Z=36"]
    if sorted(geometries) != sorted(want):
        fail(f"ul_slot_uci: K2 code groups {geometries}, want {want}")

    for i, (r, ue) in enumerate(zip(res, ues)):
        errs = int((r["tb_bits"].cpu().numpy() != ue["tb"]).sum())
        flags = {}
        for part, name in zip(ue["uci"], ("harq_ack", "csi1", "csi2")):
            if part is None:
                continue
            ok = bool(r[f"{name}_ok"])
            wrong = int((r[f"{name}_bits"].cpu().numpy() != part).sum())
            flags[name] = (ok, wrong)
            if not ok or wrong:
                fail(f"ul_slot_uci UE {i}: {name} ok {ok} with {wrong} of {part.size} bits wrong")
        print(f"# ul_slot_uci UE {i} (rank {ue['shape'][0]}): CRC {bool(r['tb_crc_ok'])}, "
              f"bit errors {errs}, UCI (ok, wrong bits) {flags}, "
              f"SINR {float(r['snr_db']):.2f} dB")
        if not bool(r["tb_crc_ok"]) or errs:
            fail(f"ul_slot_uci UE {i}: CRC {bool(r['tb_crc_ok'])} with {errs} bit errors")
        if not (np.isfinite(float(r["noise_var"])) and np.isfinite(float(r["snr_db"]))):
            fail(f"ul_slot_uci UE {i}: non-finite noise_var / snr_db")
    for j, ((bits, rho), (sent, _h)) in enumerate(zip(f1_out, pucch_plan["f1"])):
        print(f"# ul_slot_uci F1 #{j}: bits {bits.tolist()} (sent {sent.tolist()}), "
              f"rho {float(rho):.4f} (DTX threshold {pucch.F1_DTX_THRESHOLD})")
        if bits.cpu().numpy().tolist() != sent.tolist() or not float(rho) > pucch.F1_DTX_THRESHOLD:
            fail(f"ul_slot_uci F1 #{j}: bits {bits.tolist()}, rho {float(rho):.4f}")
    for j, ((value, metric), (sent, _h), c) in enumerate(zip(f0_out, pucch_plan["f0"], f0)):
        want_value = sent + (len(pucch._f0_candidates(c)) // 2 if c.sr_opportunity else 0)
        print(f"# ul_slot_uci F0 #{j}: value {int(value)} (sent {want_value}), metric "
              f"{float(metric):.4f} (DTX threshold {pucch.F0_DTX_THRESHOLD})")
        if int(value) != want_value or not float(metric) > pucch.F0_DTX_THRESHOLD:
            fail(f"ul_slot_uci F0 #{j}: value {int(value)}, metric {float(metric):.4f}")
    for j, ((bits, ok, snr_db), (sent, _h)) in enumerate(zip(f2_out, pucch_plan["f2"])):
        wrong = int((bits.cpu().numpy() != sent).sum())
        print(f"# ul_slot_uci F2 #{j}: {sent.size} UCI bits, ok {bool(ok)}, {wrong} wrong, "
              f"SNR {float(snr_db):.2f} dB")
        if not bool(ok) or wrong:
            fail(f"ul_slot_uci F2 #{j}: ok {bool(ok)} with {wrong} bits wrong")

    ms = cuda_ms(run, reps=5)
    print(f"# [{card}] ul_slot_uci: 8 UEs (UCI on PUSCH, ranks 4/2/1) + 6 PUCCH occasions, "
          f"273 PRB x 4 ports: {ms:.4f} ms/slot")
    print(f"# [{card}] ul_slot_uci: {profile_call(run)[0]} device kernels per call")
    return counts, k2_err


def profile_call(fn) -> tuple[str, float, float]:
    """One call of fn under torch.profiler (after a warm-up call): (the
    device kernels it launches, "not measured" where the profiler sees no
    device activity; their summed device time in ms; the call's wall time
    in ms, which the profiler inflates)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    n = sum(e.count for e in dev_ev)
    return (str(n) if n else "not measured",
            sum(e.self_device_time_total for e in dev_ev) / 1e3, wall)


def report_call(card: str, name: str, fn) -> None:
    """Time one call (CUDA events, host included) and profile it; print
    ms a call, device kernels a call and the device's busy share."""
    ms = cuda_ms(fn, reps=5)
    kernels, busy, wall = profile_call(fn)
    print(f"# [{card}] {name}: {ms:.4f} ms a call; {kernels} device kernels per call, device "
          f"busy {busy:.4f} of {wall:.4f} ms profiled ({100 * busy / wall:.1f} %)")


# ---- every allocation shape and waveform --------------------------------------

# Path 5 on the same carrier and 4 RX ports.  Shapes: name -> (layers,
# modulation, MCS (table, index, pi/2-BPSK), DM-RS type, CDM groups without
# data, transform precoding, PT-RS).  Rates from TS 38.214 Tables
# 5.1.3.1-2 (256QAM MCS 21, 711/1024), 5.1.3.1-1 (64QAM MCS 20, 567/1024)
# and 6.1.4.1-1 (transform precoding, 64QAM table: MCS 0 pi/2-BPSK
# 240/1024, MCS 6 QPSK 449/1024).
P5_SHAPES = {
    "ptrs": (4, ("qam256", 21, False), 1, 2, False, True),
    "type2": (4, ("qam64", 20, False), 2, 2, False, False),
    "dfts_bpsk": (1, ("qam64", 0, True), 1, 2, True, False),
    "dfts_qpsk": (1, ("qam64", 6, False), 1, 2, True, False),
}
# Per shape: PRBs of the single grant (path 5 a-c) and the SNR per RE and
# port; the common phase error per data symbol of the PT-RS grants, up to
# +-P5_CPE_RAD (none on the DM-RS symbol).
P5_NOF_PRB = {"ptrs": 273, "type2": 273, "dfts_bpsk": 270, "dfts_qpsk": 270}
P5_SNR_DB = {"ptrs": 32.0, "type2": 28.0, "dfts_bpsk": 6.0, "dfts_qpsk": 6.0}
P5_CPE_RAD = 1.0
P5_RNTI = 0x4801
P5_N_RS_ID = 17
# Path 5d: narrower grants of the shapes side by side on one grid, (shape,
# first PRB, PRBs): two PT-RS grants at different PRBs (separate config
# groups: their PT-RS values follow the absolute CRB), two type-2 grants
# sharing a config, and one of each DFT-s shape (48 and 45 PRB are
# 2^a 3^b 5^c).  SNR 32 dB.
P5_SLOT = (("ptrs", 0, 40), ("ptrs", 40, 40), ("type2", 80, 48), ("dfts_bpsk", 128, 48),
           ("dfts_qpsk", 176, 45), ("type2", 221, 48))
P5_SLOT_SNR_DB = 32.0
# Path 5e: two-step CSI (a 4-port CSI-RS report: RI from 4 ranks) on a
# rank-2 16QAM grant of 273 PRB with 2 HARQ-ACK bits, at 25 dB.
P5_CSI_NOF_PRB = 273
P5_CSI_RANK = 3
P5_CSI_SNR_DB = 25.0


def p5_configs(shape: str, nof_rb: int, first_rb: int = 0, uci=None):
    """(the UE side's PdschConfig, the receiver's PuschConfig) of a path-5
    grant: a compact window of nof_rb PRBs at crb_start first_rb, on the
    flagship's symbols 1-13 with DM-RS on symbol 2."""
    from srsran_project_tpu_torch.ops.modulation import Modulation
    from srsran_project_tpu_torch.phy import pdsch, pusch
    from srsran_project_tpu_torch.phy.allocation import Allocation
    from srsran_project_tpu_torch.ran import tbs as tbs_mod

    layers, (table, mcs, pi2), ctype, ncdm, tp, ptrs = P5_SHAPES[shape]
    qm, rate = tbs_mod.mcs_to_qm_rate(mcs, table, tp, pi2)
    mod = Modulation.PI_2_BPSK if pi2 and qm == 1 else Modulation(qm)
    alloc = Allocation(rb_start=0, rb_count=nof_rb, sym_start=1, sym_count=13,
                       dmrs_symbols=(2,), dmrs_config_type=ctype,
                       nof_cdm_groups_without_data=ncdm, crb_start=first_rb)
    common = dict(tbs=tbs_mod.calculate_tbs(nof_rb, 13, 12, rate, qm, layers),
                  target_code_rate=rate, modulation=mod, alloc=alloc, nof_layers=layers,
                  nof_grid_symbols=14, nof_grid_sc=12 * nof_rb, ptrs_enabled=ptrs, ptrs_k=2,
                  transform_precoding=tp, n_rs_id=P5_N_RS_ID)
    return (pdsch.PdschConfig(nof_ports=UL_NOF_PORTS, **common),
            pusch.PuschConfig(nof_rx_ports=UL_NOF_PORTS, uci=uci, **common))


def p5_csi_configs():
    """Path 5e: the rank-2 16QAM grant with two-step CSI, (PuschConfig,
    the CSI report config)."""
    from srsran_project_tpu_torch.models.cell import CellConfig
    from srsran_project_tpu_torch.ops.modulation import Modulation
    from srsran_project_tpu_torch.phy.pusch import UciOnPuschConfig
    from srsran_project_tpu_torch.ran import csi

    report = csi.CsiReportConfig(nof_csi_rs_ports=4)
    uci = UciOnPuschConfig(nof_harq_ack_bits=2, nof_csi1_bits=csi.part1_bitwidth(report),
                           nof_csi2_bits=csi.part2_min_max(report)[1], csi_report_cfg=report)
    pc = CellConfig(nof_rb=P5_CSI_NOF_PRB, nof_ports=UL_NOF_PORTS, nof_layers=2,
                    modulation=Modulation.QAM16, target_code_rate=0.5).pusch_cfg
    return dataclasses.replace(pc, uci=uci), report


def p5_plan(seed: int = SEED):
    """Everything random about path 5, made with numpy from ``seed``: per
    single grant (a, b, c) and per slot grant (d) a dict of rnti, first_rb,
    shape, PRBs, SNR, TB bits, channel (layers, 4) and the common phase
    per symbol; the two-step CSI grant's TB, payloads and channel; and
    unit complex noise (4, 14, 3276) for each of the three grids."""
    rng = np.random.default_rng(seed + 5)

    def grant(i, shape, first_rb, nof_rb, snr):
        _tx, rx = p5_configs(shape, nof_rb, first_rb)
        phase = np.zeros(14)
        if rx.ptrs_enabled:
            phase[3:] = rng.uniform(-P5_CPE_RAD, P5_CPE_RAD, 11)
            phase[1] = rng.uniform(-P5_CPE_RAD, P5_CPE_RAD)
        return dict(rnti=P5_RNTI + i, first_rb=first_rb, shape=shape, nof_rb=nof_rb, snr=snr,
                    tb=rng.integers(0, 2, size=(rx.tbs,), dtype=np.uint8),
                    channel=_unit_rows(rng, rx.nof_layers), phase=phase)

    singles = [grant(i, s, 0, P5_NOF_PRB[s], P5_SNR_DB[s]) for i, s in enumerate(P5_SHAPES)]
    slot = [grant(10 + i, s, rb, n, P5_SLOT_SNR_DB) for i, (s, rb, n) in enumerate(P5_SLOT)]
    cfg, report = p5_csi_configs()
    from srsran_project_tpu_torch.ran import csi

    ri_off, ri_w, sizes = csi.part2_correspondence(report)
    v = report.allowed_ranks.index(P5_CSI_RANK)
    csi1 = rng.integers(0, 2, size=(csi.part1_bitwidth(report),), dtype=np.uint8)
    csi1[ri_off : ri_off + ri_w] = [(v >> (ri_w - 1 - k)) & 1 for k in range(ri_w)]
    two = dict(rnti=P5_RNTI + 20, tb=rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8),
               ack=rng.integers(0, 2, size=(2,), dtype=np.uint8), csi1=csi1,
               csi2=rng.integers(0, 2, size=(sizes[v],), dtype=np.uint8),
               channel=_unit_rows(rng, 2))
    noise = rng.standard_normal((3, UL_NOF_PORTS, 14, UL_NOF_PRB * 12, 2)) * np.sqrt(0.5)
    return singles, slot, two, (noise[..., 0] + 1j * noise[..., 1]).astype(np.complex64)


def p5_signal(ue, device):
    """The (4, 14, 12 nof_rb) grid of one path-5 grant as received, before
    noise: the port's own UE side (``pdsch.process`` with the grant's
    PdschConfig, its channel as the precoding), times the common phase
    per symbol."""
    import torch

    from srsran_project_tpu_torch.phy import pdsch

    tx, _rx = p5_configs(ue["shape"], ue["nof_rb"], ue["first_rb"])
    sig = pdsch.process(torch.from_numpy(ue["tb"]).to(device), ue["rnti"],
                        torch.from_numpy(ue["channel"]).to(device), tx)
    return sig * torch.polar(torch.ones(14, device=device),
                             torch.from_numpy(ue["phase"]).float().to(device))[:, None]


def p5_noise(noise, snr_db: float, nof_sc: int, device):
    import torch

    return torch.from_numpy(noise[..., :nof_sc]).to(device) * float(10 ** (-snr_db / 20))


def check_p5_result(what: str, res: dict, tb, idx: int = 0) -> None:
    crc = bool(res["tb_crc_ok"][idx])
    errs = int((res["tb_bits"][idx].cpu().numpy() != tb).sum())
    snr = float(res["snr_db"][idx])
    print(f"# shapes {what}: CRC {crc}, bit errors {errs}, SINR {snr:.2f} dB")
    if not crc or errs:
        fail(f"shapes {what}: CRC {crc} with {errs} bit errors")
    if not (np.isfinite(float(res["noise_var"][idx])) and np.isfinite(snr)):
        fail(f"shapes {what}: non-finite noise_var / snr_db")


def check_k3_on(h, nv, what: str):
    """K3 against its plain version on (B, nsc, 4, 4) channels ``h`` (any
    strides) and (B,) noise variances: one launch, W and eq_nvar bitwise
    equal.  Returns (the largest absolute difference, W, eq_nvar)."""
    import torch

    from srsran_project_tpu_torch.ops import equalizer

    before = equalizer.mmse_weights_4x4.launches
    w_k, ev_k = equalizer.mmse_weights_4x4(h, nv)
    w_p, ev_p = equalizer.mmse_weights_4x4_plain(h, nv)
    torch.cuda.synchronize()
    if equalizer.mmse_weights_4x4.launches != before + 1:
        fail(f"{what}: not one launch")
    err = max_abs_diff((w_k, w_p), (ev_k, ev_p))
    if not math.isfinite(err):
        fail(f"{what}: non-finite W or eq_nvar")
    if not (torch.equal(torch.view_as_real(w_k).view(torch.int32),
                        torch.view_as_real(w_p).view(torch.int32))
            and torch.equal(ev_k.view(torch.int32), ev_p.view(torch.int32))):
        fail(f"{what}: W / eq_nvar differ from the plain version (max|dW| "
             f"{float((w_k - w_p).abs().max()):.3e}, max|d eq_nvar| "
             f"{float((ev_k - ev_p).abs().max()):.3e})")
    print(f"# {what} {tuple(h.shape)}: W and eq_nvar bitwise equal to the plain version")
    return err, w_k, ev_k


def check_k3_group(grid, pdus, what: str) -> float:
    """K3 against its plain version on the channel estimate of the first
    config group of ``pdus`` (UlSlotPdus) in ``grid``, each grant's pilots
    from its first PRB, as ``process_slot`` estimates them.  Returns the
    largest difference."""
    import torch

    from srsran_project_tpu_torch.phy import pusch, ul_slot

    cfg, idx = next(iter(ul_slot._config_groups(pdus).items()))
    first_rbs = tuple(pdus[i].first_rb for i in idx)
    win = torch.stack([grid[:, :, 12 * r : 12 * r + cfg.nof_grid_sc] for r in first_rbs])
    _g, h, nv = pusch._estimate_stage(win, cfg, r_override=pusch._pilot_bank_on(
        grid.device, cfg, first_rbs))
    return check_k3_on(h.transpose(1, 2), nv, what)[0]


def check_k1_grant(grid, pdu, what: str) -> float:
    """K1 against its plain version on the LLRs of one compact PUSCH PDU
    (its window of ``grid``; the whole grid when its ``first_rb`` is None),
    as ``pusch.process`` decodes it.  Returns the largest bit difference."""
    import torch

    from srsran_project_tpu_torch.phy import pusch, sch as sch_mod

    cfg = pdu.config
    sc0 = 12 * (pdu.first_rb or 0)
    llr = pusch._front_end(grid[None, :, :, sc0 : sc0 + cfg.nof_grid_sc],
                           torch.tensor([pdu.rnti], device=grid.device), cfg)[0]
    data, _ = pusch.split_uci(llr, cfg)
    bits, iters = sch_mod._fused_decode(data, cfg.sch, cfg.nof_ldpc_iterations,
                                        cfg.ldpc_early_stop)
    return check_k1_batch(data, bits, iters, cfg, what)


def p5_inputs(device):
    """Path 5's received grids on ``device``, built from ``p5_plan``: a
    list of (plan entry, PuschConfig, (1, 4, 14, nsc) grid, (1,) RNTIs) for
    (a)-(c); the slot's (grid, its UlSlotPdus); and (e)'s (plan entry,
    PuschConfig, grid, RNTIs)."""
    import torch

    from srsran_project_tpu_torch.phy import pusch, ul_slot

    singles, slot, two, noise = p5_plan()
    out = []
    for ue in singles:
        _tx, cfg = p5_configs(ue["shape"], ue["nof_rb"])
        grid = p5_signal(ue, device) + p5_noise(noise[0], ue["snr"], cfg.nof_grid_sc, device)
        out.append((ue, cfg, grid[None], torch.tensor([ue["rnti"]], device=device)))
    grid = p5_noise(noise[1], P5_SLOT_SNR_DB, UL_NOF_PRB * 12, device).clone()
    pdus = []
    for ue in slot:
        _tx, cfg = p5_configs(ue["shape"], ue["nof_rb"], ue["first_rb"])
        sc0 = 12 * ue["first_rb"]
        grid[:, :, sc0 : sc0 + cfg.nof_grid_sc] += p5_signal(ue, device)
        pdus.append(ul_slot.UlSlotPdu(rnti=ue["rnti"], first_rb=ue["first_rb"], config=cfg))
    cfg, _report = p5_csi_configs()

    def on(x):
        return torch.from_numpy(x).to(device)

    sig = pusch.transmit(on(two["tb"]), torch.tensor(two["rnti"], device=device), cfg,
                         on(two["ack"]), on(two["csi1"]), on(two["csi2"]),
                         precoding=on(two["channel"]))
    grid_e = sig + p5_noise(noise[2], P5_CSI_SNR_DB, cfg.nof_grid_sc, device)
    return (out, (grid, pdus, slot),
            (two, cfg, grid_e[None], torch.tensor([two["rnti"]], device=device)))


def shapes_phase(card: str) -> tuple[dict, dict, dict]:
    """Path 5: (a) a PT-RS grant, (b) a DM-RS type-2 grant with data on the
    DM-RS symbol, (c) DFT-s-OFDM with pi/2-BPSK and with QPSK, each through
    ``pusch.process``; (d) narrower grants of those shapes through
    ``ul_slot.process_slot``; (e) two-step CSI through ``pusch.process``.
    Each with the launch counters read around it, K1 held against its plain
    version on (a)-(c) and (e)'s own LLRs, K3 on (a)'s channel estimate, K2
    on (d)'s code groups.  Returns the launch counts summed over the path,
    the kernels' largest differences, and each kernel's device times at
    these shapes with their bounds."""
    import torch

    from srsran_project_tpu_torch.ops import equalizer
    from srsran_project_tpu_torch.ops.ldpc import decoder
    from srsran_project_tpu_torch.phy import pusch, sch as sch_mod, ul_slot

    dev = torch.device(DEVICE)
    singles, (slot_grid, pdus, slot), (two, cfg_e, grid_e, rnti_e) = p5_inputs(dev)
    total: dict = {}
    errs = {"decode_dematch": 0.0, "mmse_weights_4x4": 0.0, "decode": 0.0}
    times: dict = {"decode_dematch": {}, "mmse_weights_4x4": {}, "decode": {}}

    def counted(name, fn, want):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = read_counts()
        expect_counts(f"shapes {name}", got, want)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return out

    def report(name, fn):
        report_call(card, f"shapes {name}", fn)

    def k1_on(name, llr, cfg):
        data, _ = pusch.split_uci(llr, cfg)
        bits, iters = sch_mod._fused_decode(data, cfg.sch, cfg.nof_ldpc_iterations,
                                            cfg.ldpc_early_stop)
        errs["decode_dematch"] = max(errs["decode_dematch"],
                                     check_k1_batch(data, bits, iters, cfg, f"shapes {name}"))
        seg = cfg.sch.seg
        e0 = sch_mod._e_groups(cfg.sch.cb_e_bits)[0][2]
        plan = decoder.dematch_decode_plan(seg.base_graph, seg.lifting_size,
                                           seg.nof_payload_bits_per_cb, e0, cfg.sch.rv,
                                           cfg.sch.qm, cfg.sch.n_cb or seg.full_codeword_bits)
        times["decode_dematch"][name] = dict(
            ms=kernel_ms(lambda: sch_mod._fused_decode(data, cfg.sch, cfg.nof_ldpc_iterations,
                                                       cfg.ldpc_early_stop)),
            bound_ms=ldpc_bound(plan, iters, (data,), (bits, iters))[0], qm=cfg.sch.qm,
            codeblocks=int(iters.numel()), mean_iterations=float(iters.float().mean()))

    # (a)-(c): one grant each through pusch.process.
    for ue, cfg, grid, rnti in singles:
        if not _fused_ok(cfg):
            fail(f"shapes {ue['shape']}: repetition geometry, K1 would not run")
        res = counted(ue["shape"], lambda: pusch.process(grid, rnti, cfg),
                      {"decode_dematch": 1, "mmse_equalize": k8_launches([cfg])})
        check_p5_result(f"{ue['shape']} ({ue['nof_rb']} PRB, {cfg.nof_layers} layers, "
                        f"{cfg.modulation.name}, G {cfg.g_total})", res, ue["tb"])
        llr = pusch._front_end(grid, rnti, cfg)[0]
        k1_on(ue["shape"], llr, cfg)
        if cfg.ptrs_enabled:
            _g, h, nv = pusch._estimate_stage(grid, cfg)
            hs = h.transpose(1, 2)
            err, w_k, ev_k = check_k3_on(hs, nv, "shapes ptrs K3")
            errs["mmse_weights_4x4"] = max(errs["mmse_weights_4x4"], err)
            times["mmse_weights_4x4"]["ptrs"] = dict(
                ms=kernel_ms(lambda: equalizer.mmse_weights_4x4(hs, nv), reps=50),
                bound_ms=bound(nbytes(hs, nv, w_k, ev_k), 1500.0 * hs.shape[1])[0])
            got = pusch.cpe_phases(grid.reshape(1, UL_NOF_PORTS, -1), h, cfg)[0]
            got = got.angle().cpu().numpy()
            cpe_err = float(np.abs(np.angle(np.exp(1j * (got - ue["phase"])))).max())
            print(f"# shapes ptrs: common phase error recovered within {cpe_err:.4f} rad "
                  f"(up to {P5_CPE_RAD} rad per symbol)")
            if not cpe_err < 0.05:
                fail(f"shapes ptrs: CPE off by {cpe_err:.4f} rad")
        report(ue["shape"], lambda: pusch.process(grid, rnti, cfg))

    # (d): the narrower grants side by side through process_slot.
    grid = slot_grid
    groups = ul_slot._config_groups(pdus)
    cfgs = tuple(groups)
    codes = {(c.sch.seg.base_graph, c.sch.seg.lifting_size, c.nof_ldpc_iterations,
              c.ldpc_early_stop, c.sch.n_cb) for c in cfgs}
    groups_4x4 = sum(1 for c in cfgs if (c.nof_layers, c.nof_rx_ports) == (4, 4)
                     and pusch.pdsch_mod.uniform_data_rows(c.alloc))
    if len(groups) != 5 or groups_4x4 != 2:
        fail(f"shapes slot: {len(groups)} config groups and {groups_4x4} 4x4 full-row groups, "
             f"want 5 and 2")
    res, _, _ = counted("slot", lambda: ul_slot.process_slot(grid, pdus),
                        {"decode": len(codes), "mmse_equalize": k8_launches(cfgs)})
    for i, (r, ue) in enumerate(zip(res, slot)):
        check_p5_result(f"slot UE {i} ({ue['shape']}, PRB {ue['first_rb']}+{ue['nof_rb']})",
                        {k: v[None] for k, v in r.items()}, ue["tb"])
    k2_err, geometries = check_code_groups(grid, pdus, "shapes slot")
    errs["decode"] = k2_err
    fronts = ul_slot._slot_front(grid, groups, pdus)
    for (bg, z, iters, early, n_cb), _gis, _sizes, llrs in ul_slot._code_groups(cfgs, fronts):
        plan = decoder.decode_plan(bg, z, llrs.shape[-1], n_cb)
        bits, _, its = decoder.decode(llrs, bg, z, iters, early, True, n_cb)
        times["decode"][f"BG{bg} Z={z} C={llrs.shape[0]}"] = dict(
            ms=kernel_ms(lambda: decoder.decode(llrs, bg, z, iters, early, True, n_cb)),
            bound_ms=ldpc_bound(plan, its, (llrs,), (bits, its))[0])
    print(f"# shapes slot: {len(pdus)} grants in {len(groups)} config groups, K2 code groups "
          f"{geometries}")
    report("slot", lambda: ul_slot.process_slot(grid, pdus))

    # (e): two-step CSI through pusch.process.
    cfg, grid, rnti = cfg_e, grid_e, rnti_e
    res = counted("two-step CSI", lambda: pusch.process(grid, rnti, cfg),
                  {"decode_dematch": 1, "mmse_equalize": k8_launches([cfg])})
    check_p5_result(f"two-step CSI ({P5_CSI_NOF_PRB} PRB, 2 layers, QAM16)", res, two["tb"])
    n2 = int(res["nof_csi2_bits"][0])
    flags = {"rank": int(res["csi_rank"][0]), "nof_csi2_bits": n2}
    for name, sent in (("harq_ack", two["ack"]), ("csi1", two["csi1"]), ("csi2", two["csi2"])):
        got = res[f"{name}_bits"][0].cpu().numpy()[: sent.size]
        flags[name] = (bool(res[f"{name}_ok"][0]), int((got != sent).sum()))
    print(f"# shapes two-step CSI: {flags} (sent rank {P5_CSI_RANK}, part 2 of "
          f"{two['csi2'].size} bits)")
    if (flags["rank"], n2) != (P5_CSI_RANK, two["csi2"].size) or any(
            not ok or wrong for ok, wrong in (flags[k] for k in ("harq_ack", "csi1", "csi2"))):
        fail(f"shapes two-step CSI: {flags}")
    k1_on("two_step_csi", pusch._front_end(grid, rnti, cfg)[0], cfg)
    report("two-step CSI", lambda: pusch.process(grid, rnti, cfg))
    return total, errs, times


# ---- the kernels against their plain versions ---------------------------------

def noisy_llrs(cfg, rng, dev):
    """int8 LLRs around a valid codeword of a random TB (|LLR| 14, noise 4)."""
    import torch

    from srsran_project_tpu_torch.phy import sch as sch_mod

    tb = torch.from_numpy(rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8)).to(dev)
    cw = sch_mod.encode_transport_block(tb, cfg).cpu().numpy()
    llr = (1.0 - 2.0 * cw.astype(np.float32)) * 14.0 + rng.normal(0.0, 4.0, size=cw.shape)
    return torch.from_numpy(np.clip(np.round(llr), -120, 120).astype(np.int8)).to(dev)


def kernel_phase(card: str):
    """K1 (both layouts), K2, K3, K4 and K5 against their plain versions on the
    card, at the shapes of the three paths, K6 at ``fapi_ul_tti``'s F2
    occasions, K7 at the uplink cells' estimate shapes and K8 at the
    flagship's and ``mu8_ul``'s equalizer shapes; returns the per-kernel
    entries of the JSON line (without launch counts)."""
    import torch

    from srsran_project_tpu_torch.models.cell import CellConfig
    from srsran_project_tpu_torch.ops import demap_llrs as dl
    from srsran_project_tpu_torch.ops import demap_planes as dp
    from srsran_project_tpu_torch.ops import equalizer, pucch_f2_rx, pusch_estimate
    from srsran_project_tpu_torch.ops.ldpc import decoder
    from srsran_project_tpu_torch.ops.modulation import Modulation
    from srsran_project_tpu_torch.phy import sch as sch_mod

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    cfg = CellConfig().pusch_cfg.sch
    seg = cfg.seg
    n_cb = cfg.n_cb or seg.full_codeword_bits

    # K1: int8 LLRs around a valid flagship codeword, read as the (1, G)
    # stream and as the (1, qm, G/qm) bit-planes, both E-groups in one
    # launch, against the plain version of each group (its (C, E) spans).
    llr = noisy_llrs(cfg, rng, dev)[None]
    planes = llr.reshape(1, -1, cfg.qm).transpose(1, 2).contiguous()
    e_groups = tuple((count, e) for _s, count, e in sch_mod._e_groups(cfg.cb_e_bits))
    args = (seg.base_graph, seg.lifting_size, seg.nof_payload_bits_per_cb, cfg.rv, cfg.qm, n_cb)

    def k1(src, iters, early):
        return decoder.decode_dematch_groups(src, e_groups, *args, iters, early)

    def k1_plain(iters, early, src=llr):
        """The plain version of each E-group's view of src (stream or
        planes: the stream's views reshape in the plain version to its
        (C, E) spans, the planes' views transpose back to them)."""
        outs = [decoder.decode_dematch_plain(v, seg.base_graph, seg.lifting_size,
                                             seg.nof_payload_bits_per_cb, e, cfg.rv, cfg.qm,
                                             n_cb, iters, early)
                for v, (_c, e) in zip(decoder.group_views(src, e_groups, cfg.qm), e_groups)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    k1_err = 0
    for early in (False, True):
        bits_p, it_p = k1_plain(6, early)
        for layout, src in (("stream", llr), ("planes", planes)):
            before = decoder.decode_dematch.launches
            bits_k, it_k = k1(src, 6, early)
            torch.cuda.synchronize()
            if decoder.decode_dematch.launches != before + 1:
                fail(f"K1 {layout}: {decoder.decode_dematch.launches - before} launches for "
                     f"{len(e_groups)} E-groups, want 1")
            nbad = int((bits_k != bits_p).sum())
            k1_err = max(k1_err, int((bits_k.int() - bits_p.int()).abs().max()))
            if nbad:
                fail(f"K1 {layout} early_stop={early}: {nbad} bits differ from the plain version")
            if not torch.equal(it_k, it_p):
                fail(f"K1 {layout} early_stop={early}: per-codeblock iteration counts differ "
                     f"from the plain version")
            if not early and not bool((it_k == 6).all()):
                fail("K1: fixed-budget iteration count is not 6")
    k1_plan = decoder.dematch_decode_plan(seg.base_graph, seg.lifting_size,
                                          seg.nof_payload_bits_per_cb, e_groups[0][1], cfg.rv,
                                          cfg.qm, n_cb)
    k1_geo = {"blocks_per_sm": decoder.blocks_per_sm(k1_plan)}
    print(f"# K1 E-groups {e_groups} C={it_k.numel()} in one launch, stream and planes: bits and "
          f"iterations equal the plain version per group (6 iterations; early stop, mean "
          f"{it_k.float().mean().item():.2f}); {k1_plan.shared_bytes} B shared, "
          f"{k1_geo['blocks_per_sm']} block(s) per SM")
    k1_ms = kernel_ms(lambda: k1(llr, 6, True))
    k1v_ms = kernel_ms(lambda: k1(planes, 6, True))
    k1_plain_ms = cuda_ms(lambda: k1_plain(6, True), reps=3)
    k1v_plain_ms = cuda_ms(lambda: k1_plain(6, True, planes), reps=3)
    k1_bound = ldpc_bound(k1_plan, it_k, (llr,), (bits_k, it_k))
    print(f"# [{card}] K1 decode_dematch, flagship slot (2 E-groups in one launch, early stop): "
          f"kernel {k1_ms:.4f} ms, planes {k1v_ms:.4f} ms, plain torch {k1_plain_ms:.4f} ms, "
          f"on the planes {k1v_plain_ms:.4f} ms; bound {k1_bound[0]:.5f} ms ({k1_bound[1]})")

    # K2: the flagship's dematched buffers (LBRM-truncated graph) and those
    # of the uplink slot's group A (41 codeblocks, untruncated BG1 graph).
    cfg_a = ul_config(*UL_GROUPS[0][1:], 0).sch
    k2_cases = []
    for name, c, src in (("flagship", cfg, llr[0]), ("group A", cfg_a, None)):
        buf = sch_mod._dematch_stage(src if src is not None else noisy_llrs(c, rng, dev), None, c)
        k2_cases.append((name, c, buf))
    k2_err = 0.0
    k2_geo = {}
    for name, c, buf in k2_cases:
        k2_err = max(k2_err, check_k2(buf, c.seg.base_graph, c.seg.lifting_size, c.n_cb, name))
        plan = decoder.decode_plan(c.seg.base_graph, c.seg.lifting_size, buf.shape[-1], c.n_cb)
        k2_geo[name] = {"blocks_per_sm": decoder.blocks_per_sm(plan)}
    k2_times = {}
    for name, c, buf in k2_cases:
        kargs = (c.seg.base_graph, c.seg.lifting_size, 6, True, True, c.n_cb)
        plan = decoder.decode_plan(c.seg.base_graph, c.seg.lifting_size, buf.shape[-1], c.n_cb)
        bits, _, its = decoder.decode(buf, *kargs)
        k2_times[name] = (kernel_ms(lambda b=buf, a=kargs: decoder.decode(b, *a)),
                          cuda_ms(lambda b=buf, a=kargs: decoder.decode_plain(b, *a), reps=3),
                          ldpc_bound(plan, its, (buf,), (bits, its)))
    print(f"# [{card}] K2 decode (bits only, early stop): " + "; ".join(
        f"{n} kernel {k:.4f} ms, plain torch {p:.4f} ms, bound {bd[0]:.5f} ms ({bd[1]}), "
        f"{k2_geo[n]['blocks_per_sm']} block(s) per SM"
        for n, (k, p, bd) in k2_times.items()))

    # K3 and K4 at one flagship slot, at the batch-8 decode's 8 slots, and
    # K3 at the uplink slot's group A (2 grants of 80 PRB).
    k3_shapes = {"b1": (1, 3276), "b8": (NOF_SLOTS, 3276), "group A": (2, 960)}
    k3 = {name: check_k3(rng, dev, b, nsc, name) for name, (b, nsc) in k3_shapes.items()}
    k3_err = max(r[3] for r in k3.values())
    k3_occ = equalizer.occupancy()
    print(f"# [{card}] K3 mmse_weights_4x4: " + "; ".join(
        f"{name} {k3_shapes[name]} kernel {ms:.4f} ms, plain torch {pms:.4f} ms, bound "
        f"{bd[0]:.5f} ms ({bd[1]})" for name, (ms, pms, bd, _e) in k3.items())
        + f"; {k3_occ['registers']} registers, {k3_occ['blocks_per_sm']} blocks of 256 per SM")
    k4 = {name: check_k4(rng, dev, b, name) for name, b in (("b1", 1), ("b8", NOF_SLOTS))}
    k4_err = max(r[3] for r in k4.values())
    k4_occ = dp.occupancy(Modulation.QAM256, 4)
    print(f"# [{card}] K4 demap_planes, 256QAM x 4 layers: " + "; ".join(
        f"{name} kernel {ms:.4f} ms, plain torch {pms:.4f} ms, bound {bd[0]:.5f} ms ({bd[1]})"
        for name, (ms, pms, bd, _e) in k4.items())
        + f"; {k4_occ['registers']} registers, {k4_occ['blocks_per_sm']} blocks of 128 per SM")

    k5 = {name: check_k5(rng, dev, b, name) for name, b in (("b1", 1), ("b8", NOF_SLOTS))}
    k5_err = max(r[3] for r in k5.values())
    k5_occ = dl.occupancy(Modulation.QAM256, 4)
    print(f"# [{card}] K5 demap_llrs, 256QAM x 4 layers: " + "; ".join(
        f"{name} kernel {ms:.4f} ms, plain torch {pms:.4f} ms, bound {bd[0]:.5f} ms ({bd[1]})"
        for name, (ms, pms, bd, _e) in k5.items())
        + f"; {k5_occ['registers']} registers, {k5_occ['blocks_per_sm']} blocks of 128 per SM")

    k6_ms, k6_plain_ms, k6_bound, k6_err = check_k6(rng, dev)
    k6_occ = pucch_f2_rx.occupancy()
    print(f"# [{card}] K6 pucch_f2_rx, fapi_ul_tti's 4 F2 occasions: kernel {k6_ms:.4f} ms, "
          f"plain torch {k6_plain_ms:.4f} ms, bound {k6_bound[0]:.6f} ms ({k6_bound[1]}); "
          f"{k6_occ['registers']} registers, {k6_occ['blocks_per_sm']} blocks of 256 per SM")

    k7 = {name: check_k7(rng, dev, name) for name in K7_SHAPES}
    k7_occ = pusch_estimate.occupancy()
    print(f"# [{card}] K7 pusch_estimate: " + "; ".join(
        f"{name} kernel {ms:.4f} ms, plain torch {pms:.4f} ms, bound {bd[0]:.6f} ms ({bd[1]})"
        for name, (ms, pms, bd, _e) in k7.items())
        + f"; {k7_occ['registers']} registers, {k7_occ['blocks_per_sm']} blocks of 256 per SM")

    k8 = {name: check_k8(rng, dev, name) for name in K8_SHAPES}
    k8_occ = {f"layers_{l}": equalizer.mmse_equalize_occupancy(l) for l in (1, 2, 4)}
    print(f"# [{card}] K8 mmse_equalize: " + "; ".join(
        f"{name} kernel {ms:.4f} ms, plain torch {pms:.4f} ms, bound {bd[0]:.6f} ms ({bd[1]})"
        for name, (ms, pms, bd, _e) in k8.items())
        + "; " + ", ".join(f"{l}: {o['registers']} registers, {o['blocks_per_sm']} blocks per SM"
                           for l, o in k8_occ.items()))

    k2_ms, k2_plain_ms, k2_bound = k2_times["group A"]

    def entry(name, src, replaces, err, ms, plain_ms, bd, **extra):
        return {"name": name, "route": "cuda", "source": f"srsran_project_tpu_torch/csrc/{src}",
                "replaces": replaces, "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bd[0], "bound_by": bd[1], "library_ms": LIBRARY_MS, **extra}

    k1_src, k1_tpu = "ldpc_decode_dematch.cu", "srsran_project_tpu/ops/ldpc/decoder_pallas.py:322"
    return [
        entry("decode_dematch", k1_src, k1_tpu, k1_err, k1_ms, k1_plain_ms, k1_bound, **k1_geo),
        entry("decode_dematch_planes", k1_src, k1_tpu, k1_err, k1v_ms, k1v_plain_ms, k1_bound,
              **k1_geo),
        entry("decode", "ldpc_decode.cu", "srsran_project_tpu/ops/ldpc/decoder_pallas.py:172",
              k2_err, k2_ms, k2_plain_ms, k2_bound, **k2_geo["group A"],
              flagship_ms=k2_times["flagship"][0], flagship_bound_ms=k2_times["flagship"][2][0],
              flagship_blocks_per_sm=k2_geo["flagship"]["blocks_per_sm"]),
        entry("mmse_weights_4x4", "mmse_weights_4x4.cu",
              "srsran_project_tpu/ops/equalizer_pallas.py:132", k3_err, *k3["b1"][:3],
              b8_ms=k3["b8"][0], b8_plain_ms=k3["b8"][1], b8_bound_ms=k3["b8"][2][0],
              group_a_ms=k3["group A"][0], group_a_plain_ms=k3["group A"][1],
              group_a_bound_ms=k3["group A"][2][0], **k3_occ),
        entry("demap_planes", "demap_planes.cu", "srsran_project_tpu/ops/demap_pallas.py:45",
              k4_err, *k4["b1"][:3], b8_ms=k4["b8"][0], b8_plain_ms=k4["b8"][1],
              b8_bound_ms=k4["b8"][2][0], **k4_occ),
        entry("demap_llrs", "demap_llrs.cu",
              "srsran_project_tpu_torch/phy/pusch.py:_demap_stage (eager demap_soft, "
              "quantize_llr, descramble_llrs, evm)",
              k5_err, *k5["b1"][:3], b8_ms=k5["b8"][0], b8_plain_ms=k5["b8"][1],
              b8_bound_ms=k5["b8"][2][0], **k5_occ),
        entry("pucch_f2_rx", "pucch_f2_rx.cu",
              "srsran_project_tpu_torch/phy/pucch_f2.py:process (the eager chain an occasion "
              "at a time: estimate_channel, MRC, demap_soft, descrambling, uci.decode_uci)",
              k6_err, k6_ms, k6_plain_ms, k6_bound, **k6_occ),
        entry("pusch_estimate", "pusch_estimate.cu",
              "srsran_project_tpu_torch/phy/pusch.py:_estimate_fast (eager estimate_h and "
              "the second-difference noise)",
              max(r[3]["h_abs"] for r in k7.values()), *k7["flagship-b1"][:3],
              b8_ms=k7["flagship-b8"][0], b8_plain_ms=k7["flagship-b8"][1],
              b8_bound_ms=k7["flagship-b8"][2][0],
              h_rel_err=max(r[3]["h_rel"] for r in k7.values()),
              noise_rel_err=max(r[3]["nv_rel"] for r in k7.values()),
              shapes={name: {"ms": ms, "plain_ms": pms, "bound_ms": bd[0]}
                      for name, (ms, pms, bd, _e) in k7.items()}, **k7_occ),
        entry("mmse_equalize", "mmse_equalize.cu",
              "srsran_project_tpu_torch/phy/pusch.py:_equalize_stage (the data-row gather, "
              "K3 or equalize_weights, the eager weight apply and eq_nvar's copy)",
              max(r[3] for r in k8.values()), *k8["flagship-b1"][:3],
              b8_ms=k8["flagship-b8"][0], b8_plain_ms=k8["flagship-b8"][1],
              b8_bound_ms=k8["flagship-b8"][2][0],
              shapes={name: {"ms": ms, "plain_ms": pms, "bound_ms": bd[0]}
                      for name, (ms, pms, bd, _e) in k8.items()}, occupancy=k8_occ),
    ]


def check_k3(rng, dev, batch: int, nsc: int, name: str):
    """K3 against its plain version on random 4x4 channels of ``batch``
    slots: W and eq_nvar bitwise equal, on the channel estimate's layout
    ((B, L, P, nsc) in memory, handed over as its (B, nsc, P, L) view) and
    on a contiguous copy; and near a float64 oracle.  Returns (kernel ms,
    plain ms, bound) on the estimate's layout and the largest absolute
    difference from the plain version."""
    import torch

    from srsran_project_tpu_torch.ops import equalizer

    h_np = ((rng.standard_normal((batch, 4, 4, nsc)) + 1j * rng.standard_normal((batch, 4, 4, nsc)))
            * 0.5).astype(np.complex64)  # (B, L, P, nsc)
    h = torch.from_numpy(h_np).to(dev).permute(0, 3, 2, 1)  # (B, nsc, P, L) view
    # One noise variance a slot, 1e-13 (clamped to 1e-12) to 1; 0.013 alone.
    nv_np = np.geomspace(1e-13, 1.0, batch) if batch > 1 else np.array([0.013])
    nv = torch.from_numpy(nv_np.astype(np.float32)).to(dev)
    err = 0.0
    for layout, hh in (("estimate layout", h), ("contiguous", h.contiguous())):
        d, w_k, ev_k = check_k3_on(hh, nv, f"K3 {name} {layout}")
        err = max(err, d)
    i = int(np.argmax(nv_np))  # the oracle's float32 gap grows as nv falls
    w64, ev64 = _mmse_oracle64(h_np[i].transpose(2, 1, 0), float(nv[i]))
    o_err = max(float(np.abs(w_k[i].cpu().numpy() - w64).max()),
                float(np.abs(ev_k[i].cpu().numpy() - ev64).max()))
    if not o_err <= 1e-2:
        fail(f"K3 {name} vs float64 oracle: {o_err:.3e} > 1e-2")
    print(f"# K3 {name} ({batch} x {nsc}): W and eq_nvar bitwise equal to the plain version on "
          f"the estimate's layout and contiguous; vs f64 oracle {o_err:.3e} at nv {float(nv[i]):.3g}")
    ms = kernel_ms(lambda: equalizer.mmse_weights_4x4(h, nv), reps=50)
    plain_ms = cuda_ms(lambda: equalizer.mmse_weights_4x4_plain(h, nv), reps=10)
    # About 1.5k float32 operations a subcarrier: the gram about 510, the
    # blocked inverse about 460, mu, W and eq_nvar about 600.
    bd = bound(nbytes(h, nv, w_k, ev_k), 1500.0 * batch * nsc)
    return ms, plain_ms, bd, err


def check_k4(rng, dev, batch: int, name: str):
    """K4 against its plain version at the flagship's shape (4 ports, 12
    data symbols, 3276 subcarriers, 4 layers, 256QAM) for ``batch`` slots
    of random weights, noise and Gold bits: planes and err2 bitwise equal.
    Returns (kernel ms, plain ms, bound, largest absolute difference from
    the plain version)."""
    import torch

    from srsran_project_tpu_torch.ops import demap_planes as dp
    from srsran_project_tpu_torch.ops.modulation import Modulation

    p, s, nsc, l, qm = 4, 12, 3276, 4, 8
    y = rng.standard_normal((batch, p, s, nsc, 2)) * 0.5
    w = rng.standard_normal((batch, nsc, l, p, 2)) * 0.5
    ins = (torch.from_numpy((y[..., 0] + 1j * y[..., 1]).astype(np.complex64)).to(dev),
           torch.from_numpy((w[..., 0] + 1j * w[..., 1]).astype(np.complex64)).to(dev),
           torch.from_numpy((0.01 + 0.1 * rng.random((batch, nsc, l))).astype(np.float32)).to(dev),
           torch.from_numpy(rng.integers(0, 2, size=(batch, s * nsc * l * qm), dtype=np.uint8))
           .to(dev))
    err = check_k4_on(ins, Modulation.QAM256, 20.0, f"K4 {name}")
    planes_k, err_k = dp.demap_planes(*ins, Modulation.QAM256)
    ms = kernel_ms(lambda: dp.demap_planes(*ins, Modulation.QAM256), reps=50)
    plain_ms = cuda_ms(lambda: dp.demap_planes_plain(*ins, Modulation.QAM256), reps=10)
    # Float32 operations a lane: 8 per port (the complex apply), 8 per PAM
    # level (the distances and label min trees of both axes), 4 per bit.
    lanes = batch * s * nsc * l
    bd = bound(nbytes(*ins, planes_k, err_k),
               lanes * (8.0 * p + 8.0 * 2 ** (qm // 2) + 4.0 * qm))
    return ms, plain_ms, bd, err


def check_k5(rng, dev, batch: int, name: str):
    """K5 against its plain version at the flagship's shape (39,312 data
    REs, 4 layers, 256QAM) for ``batch`` slots of random symbols, noise and
    Gold bits: LLRs and err2 bitwise equal.  Returns (kernel ms, plain ms,
    bound, largest absolute difference from the plain version)."""
    import torch

    from srsran_project_tpu_torch.ops import demap_llrs as dl
    from srsran_project_tpu_torch.ops.modulation import Modulation

    nd, l, qm = 12 * 3276, 4, 8
    x = rng.standard_normal((batch, nd, l, 2)) * 0.6
    ins = (torch.from_numpy((x[..., 0] + 1j * x[..., 1]).astype(np.complex64)).to(dev),
           torch.from_numpy((0.001 + 0.05 * rng.random((batch, nd, l))).astype(np.float32))
           .to(dev),
           torch.from_numpy(rng.integers(0, 2, size=(batch, nd * l * qm), dtype=np.uint8))
           .to(dev))
    err = check_k5_on(ins, Modulation.QAM256, 20.0, f"K5 {name}")
    llr_k, err_k = dl.demap_llrs(*ins, Modulation.QAM256)
    ms = kernel_ms(lambda: dl.demap_llrs(*ins, Modulation.QAM256), reps=50)
    plain_ms = cuda_ms(lambda: dl.demap_llrs_plain(*ins, Modulation.QAM256), reps=10)
    # Float32 operations a lane, as for K4 without the apply: 8 per PAM
    # level (the distances and label min trees of both axes), 4 per bit.
    lanes = batch * nd * l
    bd = bound(nbytes(*ins, llr_k, err_k), lanes * (8.0 * 2 ** (qm // 2) + 4.0 * qm))
    return ms, plain_ms, bd, err


# ``fapi_ul_tti``'s F2 occasions (portbench/configs/nr100_4rx_ul_tti_pucch_prach.json):
# (rb_start, UCI bits), 2 PRB on symbols 12-13, 4 ports, n_id = n_id0 = 1.
K6_OCCASIONS = ((2, 22), (4, 22), (267, 6), (269, 6))
# K6's snr_db against the plain version's: both sum in their own order and
# round atan2 / cos / sin / log10 in their own last place.
K6_SNR_DB_ATOL = 1e-4


def check_k6(rng, dev):
    """K6 against its plain version (on the CPU) at ``fapi_ul_tti``'s four
    F2 occasions on a full-carrier grid, each UE through a random
    unit-norm row over the ports, 15 dB above a port's noise as in the
    cell: one launch, bits and ok exact and the sent ones, snr_db within
    K6_SNR_DB_ATOL.  Returns (kernel ms, plain ms on the card, bound,
    largest snr_db gap)."""
    import torch

    from srsran_project_tpu_torch.ops import pucch_f2_rx as rx
    from srsran_project_tpu_torch.phy import pucch_f2

    nsc, ports = UL_NOF_PRB * 12, UL_NOF_PORTS
    cfgs = [pucch_f2.PucchFormat2Config(rb_start=rb, rb_count=2, start_symbol=12, nof_symbols=2,
                                        nof_uci_bits=k, rnti=0x4601 + i, n_id=1, n_id0=1,
                                        nof_rx_ports=ports, nof_grid_sc=nsc)
            for i, (rb, k) in enumerate(K6_OCCASIONS)]
    s = np.sqrt(0.5 * 10 ** (-15.0 / 10))
    grid = (rng.standard_normal((ports, 14, nsc)) + 1j * rng.standard_normal((ports, 14, nsc))) * s
    sent = []
    for c in cfgs:
        bits = rng.integers(0, 2, size=(c.nof_uci_bits,), dtype=np.uint8)
        h = rng.standard_normal(ports) + 1j * rng.standard_normal(ports)
        h = h / np.linalg.norm(h)
        grid = grid + h[:, None, None] * pucch_f2.generate(c, bits, device="cpu").numpy()[None]
        sent.append(bits)
    grid_cpu = torch.from_numpy(grid.astype(np.complex64))
    grid = grid_cpu.to(dev)
    before = rx.receive.launches
    bits_k, ok_k, snr_k = rx.receive(grid, cfgs)
    bits_p, ok_p, snr_p = rx.receive_plain(grid_cpu, cfgs)
    torch.cuda.synchronize()
    if rx.receive.launches != before + 1:
        fail("K6: not one launch for the four occasions")
    err = float((snr_k.cpu() - snr_p).abs().max())
    if not (torch.equal(bits_k.cpu(), bits_p) and torch.equal(ok_k.cpu(), ok_p)):
        fail(f"K6: bits or ok differ from the plain version: {ok_k.tolist()} / {ok_p.tolist()}")
    if not err <= K6_SNR_DB_ATOL:
        fail(f"K6: snr_db {snr_k.tolist()} against the plain version's {snr_p.tolist()}")
    for c, b, o, want in zip(cfgs, bits_k.cpu(), ok_k.cpu(), sent):
        if not bool(o) or not np.array_equal(b[: c.nof_uci_bits].numpy(), want):
            fail(f"K6: occasion at PRB {c.rb_start} ok {bool(o)}, not the sent bits")
    print(f"# K6 {len(cfgs)} occasions: bits and ok equal the plain version's and the sent ones, "
          f"snr_db {[round(v, 3) for v in snr_k.tolist()]} within {err:.2e} dB")
    ms = kernel_ms(lambda: rx.receive(grid, cfgs), reps=50)
    plain_ms = cuda_ms(lambda: rx.receive_plain(grid, cfgs), reps=5)
    # Bytes once: the REs the occasions read, the parameter buffer, the outputs.
    read = sum(c.nof_rx_ports * c.nof_symbols * c.rb_count * 12 * 8 for c in cfgs)
    table = rx._params_on(grid.device, tuple(cfgs))
    return ms, plain_ms, bound(read + nbytes(table, bits_k, ok_k, snr_k), 0.0), err


# K7's shapes: (PRBs, layers, ports, first PRBs of the batch's grants, with
# a per-grant pilot bank unless all 0, DM-RS symbols): the flagship at 1
# and 8 slots, the config groups of mu8_ul and of fapi_ul_tti, and a grant
# on two DM-RS symbols.
K7_SHAPES = {
    "flagship-b1": (273, 4, 4, (0,), (2,)),
    "flagship-b8": (273, 4, 4, (0,) * NOF_SLOTS, (2,)),
    "mu8-rank4-80prb": (80, 4, 4, (0, 80), (2,)),
    "mu8-rank1-24prb": (24, 1, 4, (160, 184, 208, 232), (2,)),
    "mu8-rank1-8prb": (8, 1, 4, (256, 264), (2,)),
    "fapi-rank4-72prb": (72, 4, 4, (18, 90), (2,)),
    "fapi-rank1-20prb": (20, 1, 4, (162, 182, 202, 222), (2,)),
    "fapi-rank1-8prb": (8, 1, 4, (242, 250), (2,)),
    "two-dmrs-symbols": (24, 2, 2, (0, 0), (2, 11)),
}
# K7 against its plain version: the slope's and the noise's sums reduce in
# another order, and atan2 / sin / cos / hypot round in their own last place.
K7_H_TOL = 1e-5  # max |dh| over RMS(h)
K7_NV_RTOL = 1e-5


def check_k7(rng, dev, name: str):
    """K7 against its plain version on the card at K7_SHAPES[name]: each
    grant through its own random flat channel with orthonormal columns at
    SNR_DB, its DM-RS from its own CRB; two launches, h within K7_H_TOL x
    RMS(h), the noise within K7_NV_RTOL, a second run bitwise the first.
    Returns (kernel ms, plain ms, bound, {"h_abs", "h_rel", "nv_rel"})."""
    import torch

    from srsran_project_tpu_torch.models.cell import CellConfig
    from srsran_project_tpu_torch.ops import pusch_estimate as pe
    from srsran_project_tpu_torch.phy import pusch
    from srsran_project_tpu_torch.ran import dmrs as dmrs_mod

    nof_rb, layers, ports, first_rbs, dmrs = K7_SHAPES[name]
    cfg = CellConfig(nof_rb=nof_rb, nof_ports=ports, nof_layers=layers).pusch_cfg
    cfg = dataclasses.replace(cfg, alloc=dataclasses.replace(cfg.alloc, dmrs_symbols=dmrs))
    if not pusch._fused_estimate_ok(cfg):
        fail(f"K7 {name}: not on K7's route")
    grids = []
    for k, rb0 in enumerate(first_rbs):
        at = dataclasses.replace(cfg, alloc=dataclasses.replace(cfg.alloc, crb_start=rb0))
        tb = torch.from_numpy(rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8)).to(dev)
        x = pusch.transmit(tb, torch.tensor(RNTI + k, device=dev), at)  # (nl, nsym, nsc)
        q = np.linalg.qr(rng.standard_normal((ports, layers))
                         + 1j * rng.standard_normal((ports, layers)))[0]
        y = torch.einsum("pl,lsk->psk", torch.from_numpy(q.astype(np.complex64)).to(dev), x)
        s = float(y.abs().pow(2).mean().sqrt()) * 10 ** (-SNR_DB / 20) * math.sqrt(0.5)
        noise = rng.standard_normal((2, *y.shape)).astype(np.float32)
        grids.append(y + s * torch.complex(*torch.from_numpy(noise).to(dev)))
    grid = torch.stack(grids)
    r = (pusch._pilot_bank_on(dev, cfg, first_rbs) if any(first_rbs)
         else pusch._est_on(dev, cfg, 2)[None])
    beta2 = dmrs_mod.sch_to_dmrs_beta(cfg.alloc.nof_cdm_groups_without_data) ** 2
    args = (pusch._est_on(dev, cfg, 0), r, pusch._est_on(dev, cfg, 1),
            pusch._estimate_constants(cfg)[3], cfg.alloc.nof_sc, beta2)
    before = pe.estimate.launches
    h_k, nv_k = pe.estimate(grid, *args)
    h_p, nv_p = pe.estimate_plain(grid, *args)
    h_k2, nv_k2 = pe.estimate(grid, *args)
    torch.cuda.synchronize()
    if pe.estimate.launches != before + 4:
        fail(f"K7 {name}: not two launches a call")
    err = {"h_abs": float((h_k - h_p).abs().max())}
    err["h_rel"] = err["h_abs"] / float(h_p.abs().pow(2).mean().sqrt())
    err["nv_rel"] = float(((nv_k - nv_p).abs() / nv_p).max())
    if not (err["h_rel"] <= K7_H_TOL and err["nv_rel"] <= K7_NV_RTOL):
        fail(f"K7 {name}: h {err['h_rel']:.3e} x RMS, noise {err['nv_rel']:.3e} relative "
             "from the plain version")
    if not (torch.equal(torch.view_as_real(h_k), torch.view_as_real(h_k2))
            and torch.equal(nv_k.view(torch.int32), nv_k2.view(torch.int32))):
        fail(f"K7 {name}: two runs on the same inputs differ")
    print(f"# K7 {name} {tuple(h_k.shape)}: h within {err['h_rel']:.2e} x RMS, noise "
          f"{err['nv_rel']:.2e} relative of the plain version; deterministic")
    ms = kernel_ms(lambda: pe.estimate(grid, *args), reps=50)
    plain_ms = cuda_ms(lambda: pe.estimate_plain(grid, *args), reps=10)
    # Bytes once: the distinct pilot REs of each grid's ports, the pilot,
    # OCC, index and interpolation tables, h and the noise.
    pilot_res = int(torch.unique(args[0]).numel())
    plan = pe._plan_on(dev, tuple(args[3]), args[4])
    read = grid.shape[0] * ports * pilot_res * 8 + nbytes(*args[:3], *plan)
    return ms, plain_ms, bound(read + nbytes(h_k, nv_k), 0.0), err


# The data symbols of a grant on symbols 1-13: the flagship's (DM-RS on
# symbol 2) and path 7's (DM-RS on symbols 2 and 11).
K8_DATA_SYMBOLS = [1] + list(range(3, 14))
K8_DATA_SYMBOLS_2DMRS = [1] + list(range(3, 11)) + [12, 13]
# K8 at the flagship (one slot, 8 slots), at mu8_ul's three config groups,
# at the rank-2 grants of paths 4 (group B) and 5 (e), and at path 7's two
# DM-RS symbols: name -> (grants, subcarriers, layers, data symbols).
K8_SHAPES = {
    "flagship-b1": (1, 3276, 4, K8_DATA_SYMBOLS),
    "flagship-b8": (NOF_SLOTS, 3276, 4, K8_DATA_SYMBOLS),
    "mu8-rank4-80prb": (2, 960, 4, K8_DATA_SYMBOLS),
    "mu8-rank1-24prb": (4, 288, 1, K8_DATA_SYMBOLS),
    "mu8-rank1-8prb": (2, 96, 1, K8_DATA_SYMBOLS),
    "p4-rank2-22prb": (4, 264, 2, K8_DATA_SYMBOLS),
    "p5e-rank2-273prb": (1, 3276, 2, K8_DATA_SYMBOLS),
    "p7-rank4-128prb-2dmrs": (2, 1536, 4, K8_DATA_SYMBOLS_2DMRS),
}
# K8 against its plain version at 1 and 2 layers (4 layers: bitwise): its
# real closed forms against torch's complex products; mu's last place
# near 1 moves eq_nvar = (1 - mu) / mu, so that tolerance is on
# (1 + eq_nvar).
K8_X_TOL = 1e-4  # max |dx| over RMS(x)
K8_EV_TOL = 1e-5  # max |d eq_nvar| over (1 + eq_nvar)


def check_k8(rng, dev, name: str):
    """K8 against its plain version on the card at K8_SHAPES[name]: random
    grids and channels in K7's layout ((B, nsc, P, L) in memory), noise
    variances from 1e-3 to 0.3; one launch, 4 layers bitwise, 1 and 2
    within K8_X_TOL and K8_EV_TOL, a second run bitwise the first.
    Returns (kernel ms, plain ms, bound, the largest difference)."""
    import torch

    from srsran_project_tpu_torch.ops import equalizer

    b, nsc, nl, syms = K8_SHAPES[name]

    def cplx(shape):
        return torch.complex(*torch.from_numpy(
            (rng.standard_normal((2, *shape)) * 0.5).astype(np.float32)).to(dev))

    grid = cplx((b, 4, 14, nsc))
    h = cplx((b, nsc, 4, nl)).transpose(1, 2)
    nv = torch.from_numpy(np.geomspace(1e-3, 0.3, b).astype(np.float32)).to(dev)
    ins = (grid, h, nv, syms, 0)
    before = equalizer.mmse_equalize.launches
    x_k, ev_k = equalizer.mmse_equalize(*ins)
    x_p, ev_p = equalizer.mmse_equalize_plain(*ins)
    x_k2, ev_k2 = equalizer.mmse_equalize(*ins)
    torch.cuda.synchronize()
    if equalizer.mmse_equalize.launches != before + 2:
        fail(f"K8 {name}: not one launch a call")
    err = max_abs_diff((x_k, x_p), (ev_k, ev_p))
    if not math.isfinite(err):
        fail(f"K8 {name}: non-finite x_hat or eq_nvar")
    if nl == 4:
        if not (torch.equal(torch.view_as_real(x_k).view(torch.int32),
                            torch.view_as_real(x_p).view(torch.int32))
                and torch.equal(ev_k.view(torch.int32), ev_p.view(torch.int32))):
            fail(f"K8 {name}: x_hat / eq_nvar differ from the plain version ({err:.3e})")
        how = "bitwise equal to"
    else:
        dx = float((x_k - x_p).abs().max()) / float(x_p.abs().pow(2).mean().sqrt())
        dev_ = float(((ev_k - ev_p).abs() / (1.0 + ev_p)).max())
        if not (dx <= K8_X_TOL and dev_ <= K8_EV_TOL):
            fail(f"K8 {name}: x_hat {dx:.3e} x RMS, eq_nvar {dev_:.3e} x (1 + eq_nvar) from "
                 "the plain version")
        how = f"within {dx:.2e} x RMS and {dev_:.2e} x (1 + eq_nvar) of"
    if not (torch.equal(torch.view_as_real(x_k), torch.view_as_real(x_k2))
            and torch.equal(ev_k.view(torch.int32), ev_k2.view(torch.int32))):
        fail(f"K8 {name}: two runs on the same inputs differ")
    print(f"# K8 {name} ({b} x {nsc}, {nl} layers): x_hat and eq_nvar {how} the plain version; "
          "deterministic")
    ms = kernel_ms(lambda: equalizer.mmse_equalize(*ins), reps=50)
    plain_ms = cuda_ms(lambda: equalizer.mmse_equalize_plain(*ins), reps=10)
    # Bytes once: h, the data REs of the 4 ports, the noise, x_hat and
    # eq_nvar.  Operations: the weights about 1.5k a subcarrier at 4 layers
    # (K3's), 0.2k at 1; the apply 32 an RE and layer.
    y_bytes = b * 4 * len(syms) * nsc * 8
    ops = b * nsc * ((1500.0 if nl == 4 else 200.0) + 32.0 * nl * len(syms))
    return ms, plain_ms, bound(nbytes(h, nv, x_k, ev_k) + y_bytes, ops), err


def check_k5_on(ins, mod, range_limit: float, what: str) -> float:
    """K5 against its plain version on ``ins`` (x_hat, eq_nvar, Gold bits):
    one launch, LLRs and err2 bitwise equal.  Returns the largest absolute
    difference of the LLRs and err2 from the plain version."""
    import torch

    from srsran_project_tpu_torch.ops import demap_llrs as dl

    before = dl.demap_llrs.launches
    llr_k, err_k = dl.demap_llrs(*ins, mod, range_limit)
    llr_p, err_p = dl.demap_llrs_plain(*ins, mod, range_limit)
    torch.cuda.synchronize()
    if dl.demap_llrs.launches != before + 1:
        fail(f"{what}: not one launch")
    err = max_abs_diff((llr_k, llr_p), (err_k, err_p))
    if not math.isfinite(err):
        fail(f"{what}: non-finite err2")
    if not (torch.equal(llr_k, llr_p)
            and torch.equal(err_k.view(torch.int32), err_p.view(torch.int32))):
        fail(f"{what}: LLRs or err2 differ from the plain version (max {err:.3e})")
    print(f"# {what} {tuple(ins[0].shape)}: LLRs and err2 bitwise equal to the plain version")
    return err


def check_k4_on(ins, mod, range_limit: float, what: str) -> float:
    """K4 against its plain version on ``ins`` (y, w, eq_nvar, Gold bits):
    one launch, planes and err2 bitwise equal.  Returns the largest
    absolute difference of planes and err2 from the plain version."""
    import torch

    from srsran_project_tpu_torch.ops import demap_planes as dp

    before = dp.demap_planes.launches
    planes_k, err_k = dp.demap_planes(*ins, mod, range_limit)
    planes_p, err_p = dp.demap_planes_plain(*ins, mod, range_limit)
    torch.cuda.synchronize()
    if dp.demap_planes.launches != before + 1:
        fail(f"{what}: not one launch")
    err = max_abs_diff((planes_k, planes_p), (err_k, err_p))
    if not math.isfinite(err):
        fail(f"{what}: non-finite err2")
    if not (torch.equal(planes_k, planes_p)
            and torch.equal(err_k.view(torch.int32), err_p.view(torch.int32))):
        fail(f"{what} {tuple(planes_k.shape)}: planes max |d| "
             f"{int((planes_k.int() - planes_p.int()).abs().max())}, err2 max |d| "
             f"{float((err_k - err_p).abs().max()):.3e} against the plain version")
    print(f"# {what} {tuple(planes_k.shape)}: planes and err2 bitwise equal to the plain version")
    return err


def max_abs_diff(*pairs) -> float:
    """The largest |a - b| over the (kernel, plain) tensor pairs, in
    float64; NaN if either side holds a value that is not finite."""
    import torch

    err = 0.0
    for a, b in pairs:
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            return math.nan
        wide = torch.complex128 if a.is_complex() else torch.float64
        err = max(err, float((a.to(wide) - b.to(wide)).abs().max()))
    return err


def _mmse_oracle64(h, nv):
    """float64 MMSE weights and post-equalization noise (numpy oracle)."""
    hh = h.astype(np.complex128)
    hH = np.conj(np.swapaxes(hh, -1, -2))
    g = hH @ hh
    ci = np.linalg.inv(g + nv * np.eye(4))
    mu = np.clip(np.real(np.einsum("nij,nji->ni", ci, g)), 1e-9, 1 - 1e-9)
    return (ci @ hH) / mu[..., None], (1.0 - mu) / mu


# ---- the flagship cell ----------------------------------------------------------

def slice_phase(card: str):
    """Path 1: the flagship slot end to end.  Returns the launch counts of
    the one batched decode, and (rx, tb, decoded TB bits) for path 3."""
    import torch

    from srsran_project_tpu_torch.models import cell
    from srsran_project_tpu_torch.ops import demap_llrs as dl
    from srsran_project_tpu_torch.ops import ofdm, scrambling
    from srsran_project_tpu_torch.ops import pusch_estimate as pe
    from srsran_project_tpu_torch.phy import pusch, sch as sch_mod

    dev = torch.device(DEVICE)
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

    reset_counts()
    k5_before, k7_before = dl.demap_llrs.launches, pe.estimate.launches
    out = cell.decode_slot(rx, RNTI, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    if len(sch_mod._e_groups(cfg.pusch_cfg.sch.cb_e_bits)) != 2:
        fail("flagship: want two E-groups, decoded by one K1 launch")
    expect_counts("flagship decode", launches, {"decode_dematch": 1, "mmse_equalize": 1})
    # K5 and K7 are counted on this path alone (the other paths'
    # expectations predate them).
    launches["demap_llrs"] = dl.demap_llrs.launches - k5_before
    if launches["demap_llrs"] != 1:
        fail(f"flagship decode: {launches['demap_llrs']} K5 launches, want 1")
    launches["pusch_estimate"] = pe.estimate.launches - k7_before
    if launches["pusch_estimate"] != 2:
        fail(f"flagship decode: {launches['pusch_estimate']} K7 launches, want 2")
    print(f"# flagship decode: K5 launches {launches['demap_llrs']}, K7 launches "
          f"{launches['pusch_estimate']}")
    check_flagship(out, tb, cfg, "flagship")

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
    c = scrambling.gold_sequence(pusch._pusch_c_init(rnti_t, pc.n_id), llr_i8.shape[-1])
    check_k5_on((x_hat, eq_nvar, c), pc.modulation, pc.llr_range_limit, "flagship K5")
    bits, iters = sch_mod._fused_decode(llr_i8, pc.sch, pc.nof_ldpc_iterations, True)
    check_k1_batch(llr_i8, bits, iters, pc, "flagship")
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
    return launches, (rx, tb, out["tb_bits"])


def check_k1_batch(llrs, bits_k, it_k, pc, path: str) -> int:
    """K1's output for a whole batch, (B*C, K) bits and (B*C,) iterations
    from ONE launch over both E-groups of ``llrs`` (the (B, G) stream or
    the (B, qm, G/qm) planes), against the plain version of each group's
    (B, qm, count, E/qm) view: bits and iterations equal.  Returns the
    largest bit difference (0 after the check)."""
    import torch

    from srsran_project_tpu_torch.ops.ldpc import decoder
    from srsran_project_tpu_torch.phy import sch as sch_mod

    seg = pc.sch.seg
    n_cb = pc.sch.n_cb or seg.full_codeword_bits
    e_groups = [(count, e) for _s, count, e in sch_mod._e_groups(pc.sch.cb_e_bits)]
    args = (seg.base_graph, seg.lifting_size, seg.nof_payload_bits_per_cb, pc.sch.rv,
            pc.sch.qm, n_cb, pc.nof_ldpc_iterations, pc.ldpc_early_stop)
    b = llrs.shape[0]
    outs = [decoder.decode_dematch_plain(v, *args[:3], e, *args[3:])
            for v, (_c, e) in zip(decoder.group_views(llrs, e_groups, pc.sch.qm), e_groups)]
    bits_p = torch.cat([o[0].reshape(b, c, -1) for o, (c, _e) in zip(outs, e_groups)], dim=1)
    it_p = torch.cat([o[1].reshape(b, c) for o, (c, _e) in zip(outs, e_groups)], dim=1)
    torch.cuda.synchronize()
    what = f"{path} K1 {tuple(llrs.shape)} E-groups {e_groups}"
    if not (torch.equal(bits_k, bits_p.reshape(bits_k.shape))
            and torch.equal(it_k, it_p.reshape(-1))):
        fail(f"{what}: {int((bits_k != bits_p.reshape(bits_k.shape)).sum())} bits differ from "
             f"the plain version, iterations equal {torch.equal(it_k, it_p.reshape(-1))}")
    print(f"# {what} in one launch: bits and iterations (mean "
          f"{it_k.float().mean().item():.2f}) equal the plain version per group")
    return int(max_abs_diff((bits_k, bits_p.reshape(bits_k.shape))))


def check_flagship(out: dict, tb, cfg, path: str) -> None:
    """Every CRC clean, every bit right, finite metrics near the channel."""
    if tuple(out["tb_bits"].shape) != (NOF_SLOTS, cfg.tbs):
        fail(f"{path}: tb_bits shape {tuple(out['tb_bits'].shape)}")
    crc_ok = out["tb_crc_ok"].cpu().numpy()
    bit_errors = (out["tb_bits"] != tb).sum(dim=1).cpu().numpy()
    snr_db = out["snr_db"].cpu().numpy()
    noise_var = out["noise_var"].cpu().numpy()
    print(f"# {path}: {NOF_SLOTS} flagship slots, CRC ok {crc_ok.tolist()}, bit errors "
          f"{bit_errors.tolist()}, SINR dB {np.round(snr_db, 2).tolist()}")
    if not crc_ok.all() or bit_errors.any():
        fail(f"{path}: the decode is not CRC-clean with every bit right")
    if not (np.isfinite(noise_var).all() and np.isfinite(snr_db).all()):
        fail(f"{path}: non-finite noise_var / snr_db")
    if not ((snr_db > SNR_DB - 5).all() and (snr_db < SNR_DB + 5).all()):
        fail(f"{path}: post-equalization SINR {snr_db} far from the {SNR_DB} dB channel")


def plane_phase(card: str, rx, tb, float_bits) -> tuple[dict, dict]:
    """Path 3: the flagship slots of path 1 through ``decode_slot`` with
    ``demapper="planes"``, then K4 and K1 in plane layout against their
    plain versions on the path's own batch tensors; returns its launch
    counts and those kernels' largest differences."""
    import torch

    from srsran_project_tpu_torch.models import cell
    from srsran_project_tpu_torch.ops import demap_planes as dp
    from srsran_project_tpu_torch.ops import ofdm
    from srsran_project_tpu_torch.phy import pusch, sch as sch_mod

    cfg = cell.CellConfig(demapper="planes")
    pc = cfg.pusch_cfg
    torch.cuda.synchronize()
    reset_counts()
    out = cell.decode_slot(rx, RNTI, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    expect_counts("plane decode", launches, {"decode_dematch_planes": 1,
                                             "mmse_weights_4x4": 1, "demap_planes": 1})
    check_flagship(out, tb, cfg, "plane path")
    if not torch.equal(out["tb_bits"], float_bits):
        fail("plane path: TB bits differ from the float path's")
    print("# plane path: TB bits equal to the float path's")

    # K4 and K1 (plane layout) on the tensors the batch decode hands them.
    grid = ofdm.demodulate_slot(rx, cfg.nof_rb, cfg.scs, cfg.dft_size, cfg.cp, 0,
                                f_center_hz=cfg.f_center_hz)
    rntis = torch.full((rx.shape[0],), RNTI, dtype=torch.int64, device=rx.device)
    ins, _ = pusch._plane_inputs(grid, rntis, pc)
    k4_err = check_k4_on(ins, pc.modulation, pc.llr_range_limit, "plane path K4")
    planes_k, _ = dp.demap_planes(*ins, pc.modulation, pc.llr_range_limit)
    # K1: one launch over both E-groups of the batch's planes.
    bits_k, it_k = sch_mod._decode_groups(planes_k, pc.sch, pc.nof_ldpc_iterations,
                                          pc.ldpc_early_stop)
    k1_err = check_k1_batch(planes_k, bits_k, it_k, pc, "plane path")

    for b in (1, NOF_SLOTS):
        dec = cuda_ms(lambda: cell.decode_slot(rx[:b], RNTI, cfg), reps=5) / b
        print(f"# [{card}] plane path batch {b}: decode {dec:.4f} ms/slot")
    return launches, {"demap_planes": k4_err, "decode_dematch_planes": k1_err}


# ---- the DU-low's FAPI entry point ------------------------------------------------

P6_RNTI = 0x4901
P6_SLOT = (5, 0)  # (SFN, slot): every DL config below is for slot 0 of its frame
# (a) One DL_TTI on the 273-PRB carrier with 4 ports: four equal-config
# compact 4-layer 256QAM grants of 40 PRB (MCS 21 of the 256QAM table,
# 711/1024) at PRB 0, 40, 80 and 120 (one process_multi batch), a full-grid
# PT-RS grant of the same shape at PRB 160-219, two PDCCH on symbol 0 (one
# interleaved), an SSB at PRB 222-241 on symbols 2-5, and two row-1 CSI-RS
# at PRB 244-257 (symbol 13) and 258-271 (symbol 12): no RE is shared.
P6_DL_FIRST_RBS = (0, 40, 80, 120)
P6_DL_NOF_PRB = 40
P6_PTRS_PRB = (160, 60)
P6_SSB_AT = (2, 222 * 12)  # (first symbol, first subcarrier)
P6_CSI_RS = ((244, 14, 13), (258, 14, 12))  # (first PRB, PRBs, symbol)
P6_DL_SNR_DB = 30.0  # the PDSCH grants' loopback decodes
P6_CTRL_SNR_DB = 20.0  # PDCCH and PBCH on the UE side
# (b) Two UL_TTI calls on the same carrier: path 4's shapes, narrower, so
# that a two-step CSI grant (rank 2, 16QAM r 0.5, 2 HARQ-ACK bits) fits at
# PRB 248-263 and the SRS (comb 2, one antenna port) on symbol 0 of PRB
# 0-247; path 4's six PUCCH occasions at PRB 264-272.  Per group: (UEs,
# layers, bits per symbol, code rate, PRBs each, UCI sizes).  UE 5 carries
# no UCI: attenuated by P6_RETX_ATTEN_DB, its rv 0 fails in the first call
# and its rv 2 combined with the pooled buffer passes in the second.
P6_UL_GROUPS = (
    (2, 4, 8, 948.0 / 1024.0, 72, (2, 40, 400)),  # A: UEs 0-1, PRB 0-143 (K3)
    (4, 2, 6, 567.0 / 1024.0, 22, (11, 19, 0)),   # B: UEs 2-5, PRB 144-231
    (2, 1, 2, 120.0 / 1024.0, 8, (1, 0, 0)),      # C: UEs 6-7, PRB 232-247, repetition
)
P6_RETX_UE = 5
P6_RETX_ATTEN_DB = 19.0  # rv 0 alone passes at 15 dB, the combine fails at 22 (CPU run)
P6_CSI_GRANT = (248, 16)  # (first PRB, PRBs)
P6_CSI_RANK = 2
P6_SRS_PRB = (0, 248)
# (c) The app: its defaults (the flagship on TDL-A at 25 dB) for 8 slots,
# then 273 PRB with 4 ports and 1 layer on one tap at 30 dB for 4 slots.
P6_APP_RUNS = ((["--slots", "8"], None),
               (["--set", "cell.nof_layers=1", "--channel", "single", "--snr-db", "30",
                 "--slots", "4"], 0.0))


def p6_slot():
    from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing
    from srsran_project_tpu_torch.ran.slot_point import SlotPoint

    return SlotPoint.from_sfn_slot(SubcarrierSpacing.KHZ30, *P6_SLOT)


def p6_dl_configs(first_rb: int | None, ptrs: bool = False):
    """(PdschConfig, the PuschConfig that decodes it) of a path-6 DL grant:
    4 layers of 256QAM MCS 21 on symbols 1-13, DM-RS on symbol 2; a compact
    window of 40 PRB at crb_start first_rb, or (first_rb None) the PT-RS
    grant on the full grid."""
    from srsran_project_tpu_torch.ops.modulation import Modulation
    from srsran_project_tpu_torch.phy import pdsch, pusch
    from srsran_project_tpu_torch.phy.allocation import Allocation
    from srsran_project_tpu_torch.ran import tbs as tbs_mod

    qm, rate = tbs_mod.mcs_to_qm_rate(21, "qam256")
    if first_rb is None:
        rb0, nrb = P6_PTRS_PRB
        alloc = Allocation(rb_start=rb0, rb_count=nrb, sym_start=1, sym_count=13,
                           dmrs_symbols=(2,))
        nsc = UL_NOF_PRB * 12
    else:
        nrb = P6_DL_NOF_PRB
        alloc = Allocation(rb_start=0, rb_count=nrb, sym_start=1, sym_count=13,
                           dmrs_symbols=(2,), crb_start=first_rb)
        nsc = nrb * 12
    common = dict(tbs=tbs_mod.calculate_tbs(nrb, 13, 12, rate, qm, 4), target_code_rate=rate,
                  modulation=Modulation(qm), alloc=alloc, nof_layers=4, nof_grid_symbols=14,
                  nof_grid_sc=nsc, ptrs_enabled=ptrs, ptrs_k=2)
    return (pdsch.PdschConfig(nof_ports=UL_NOF_PORTS, **common),
            pusch.PuschConfig(nof_rx_ports=UL_NOF_PORTS, **common))


def p6_pdcch_configs():
    from srsran_project_tpu_torch.phy import pdcch

    common = dict(symbol=0, duration=1, n_id=101, nof_grid_sc=UL_NOF_PRB * 12,
                  slot_in_frame=P6_SLOT[1])
    return (pdcch.PdcchConfig(payload_bits=39, aggregation_level=4, cce_index=0,
                              coreset_rb_start=0, coreset_rb_count=48, **common),
            pdcch.PdcchConfig(payload_bits=57, aggregation_level=8, cce_index=8,
                              coreset_rb_start=48, coreset_rb_count=96, interleaved=True,
                              reg_bundle_size=6, interleaver_rows=2, shift_index=1,
                              n_rnti=P6_RNTI + 9, **common))


def p6_dl_request(seed: int = SEED):
    """Path 6 (a): the DL_TTI.request and TX_Data.request (numpy payloads,
    made from ``seed``), and unit complex noise (4, 14, 3276)."""
    from srsran_project_tpu_torch.fapi import messages as fapi
    from srsran_project_tpu_torch.phy import ssb

    rng = np.random.default_rng(seed + 6)
    slot = p6_slot()
    pdsch_pdus, tbs = [], []
    for i, rb0 in enumerate(P6_DL_FIRST_RBS + (None,)):
        tx, _rx = p6_dl_configs(rb0, ptrs=rb0 is None)
        tbs.append(rng.integers(0, 2, size=(tx.tbs,), dtype=np.uint8))
        pdsch_pdus.append(fapi.DlPdschPdu(tx, P6_RNTI + i, _unit_rows(rng, 4), i, first_rb=rb0))
    pdcch_pdus = [fapi.DlPdcchPdu(c, P6_RNTI + 10 + k,
                                  rng.integers(0, 2, size=(c.payload_bits,), dtype=np.uint8))
                  for k, c in enumerate(p6_pdcch_configs())]
    mib = rng.integers(0, 2, size=(24,), dtype=np.uint8)
    scfg = ssb.SsbConfig(pci=1, ssb_index=0, l_max=8, sfn_2lsb=(P6_SLOT[0] >> 1) & 3)
    payload = ssb.pbch_pack_payload(mib, sfn=P6_SLOT[0], hrf=0, ssb_index=0, l_max=8)
    ssb_pdu = fapi.DlSsbPdu(scfg, payload, first_subcarrier=P6_SSB_AT[1],
                            first_symbol=P6_SSB_AT[0])
    csi = [fapi.DlCsiRsPdu(row=1, rb_start=rb0, rb_count=n, symbol=sym, scrambling_id=300 + k)
           for k, (rb0, n, sym) in enumerate(P6_CSI_RS)]
    req = fapi.DlTtiRequest(slot=slot, pdsch=pdsch_pdus, pdcch=pdcch_pdus, ssb=[ssb_pdu],
                            csi_rs=csi)
    noise = rng.standard_normal((UL_NOF_PORTS, 14, UL_NOF_PRB * 12, 2)) * np.sqrt(0.5)
    return (req, fapi.TxDataRequest(slot=slot, payloads=tbs),
            (noise[..., 0] + 1j * noise[..., 1]).astype(np.complex64))


def p6_dl_by_pdu(req, data, phy_cfg, device):
    """The sum of each PDU's own port function on ``device``: every PDSCH
    through ``pdsch.process`` (placed at its first_rb), every PDCCH, SSB and
    CSI-RS through its processor onto port 0."""
    import torch

    from srsran_project_tpu_torch.phy import csi_rs, dl_slot, pdcch, pdsch, ssb

    def on(x):
        return torch.from_numpy(np.asarray(x)).to(device)

    grid = torch.zeros((UL_NOF_PORTS, 14, UL_NOF_PRB * 12), dtype=torch.complex64,
                       device=device)
    for p in req.pdsch:
        sub = pdsch.process(on(data.payloads[p.tb_index]), p.rnti, on(p.precoding), p.config)
        sc0 = 12 * (p.first_rb or 0)
        grid[:, :, sc0 : sc0 + sub.shape[-1]] += sub
    for p in req.pdcch:
        grid[0] += pdcch.process(on(p.payload), p.rnti, p.config)
    for p in req.ssb:
        grid[0, p.first_symbol : p.first_symbol + ssb.SSB_NSYM,
             p.first_subcarrier : p.first_subcarrier + ssb.SSB_NSC] += ssb.assemble_ssb(
                 on(p.payload), p.config)
    for p in req.csi_rs:
        grid[0] += csi_rs.generate(dl_slot.csi_rs_config(p, req.slot.slot_in_frame, phy_cfg),
                                   device=device)
    return grid




def fapi_dl_phase(card: str) -> dict:
    """Path 6 (a): one DL_TTI through ``UpperPhy.process_dl_tti``; the grid
    against the per-PDU sum, the PDCCH and PBCH through the UE-side
    receivers at 20 dB, every PDSCH grant through ``pusch.process`` at 30
    dB.  Returns the launch counts of the DL_TTI call (none: the downlink
    has no kernel)."""
    import torch

    from srsran_project_tpu_torch.phy import pdcch, pusch, ssb
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig

    dev = torch.device(DEVICE)
    req, data, noise = p6_dl_request()
    phy = UpperPhy(UpperPhyConfig(nof_ports=UL_NOF_PORTS, nof_grid_sc=UL_NOF_PRB * 12,
                                  device=DEVICE))
    torch.cuda.synchronize()
    reset_counts()
    grid = phy.process_dl_tti(req, data)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("fapi DL_TTI", counts, {})
    want = p6_dl_by_pdu(req, data, phy.cfg, dev)
    rms = float(want.abs().pow(2).mean().sqrt())
    err = float((grid - want).abs().max())
    print(f"# fapi DL_TTI: {len(req.pdsch)} PDSCH (4 in one process_multi batch, 1 PT-RS), "
          f"{len(req.pdcch)} PDCCH, {len(req.ssb)} SSB, {len(req.csi_rs)} CSI-RS: grid "
          f"{tuple(grid.shape)} within {err:.3e} of the per-PDU sum (RMS {rms:.4f})")
    if not err <= 1e-6 * rms:
        fail(f"fapi DL_TTI: grid off the per-PDU sum by {err:.3e} (RMS {rms:.4f})")
    unit = torch.from_numpy(noise).to(dev)
    rx20 = grid + unit * float(10 ** (-P6_CTRL_SNR_DB / 20))
    for k, p in enumerate(req.pdcch):
        bits, ok = pdcch.receive(rx20[0], p.rnti, p.config)
        wrong = int((bits.cpu().numpy() != p.payload).sum())
        print(f"# fapi DL_TTI PDCCH #{k} (AL {p.config.aggregation_level}, interleaved "
              f"{p.config.interleaved}): CRC {bool(ok)}, {wrong} of {p.payload.size} DCI bits "
              f"wrong at {P6_CTRL_SNR_DB} dB")
        if not bool(ok) or wrong:
            fail(f"fapi DL_TTI PDCCH #{k}: CRC {bool(ok)}, {wrong} bits wrong")
    for p in req.ssb:
        block = rx20[0, p.first_symbol : p.first_symbol + ssb.SSB_NSYM,
                     p.first_subcarrier : p.first_subcarrier + ssb.SSB_NSC].reshape(-1)
        d = block[torch.from_numpy(ssb._ssb_re_layout(p.config.pci)[0].astype(np.int64)).to(dev)]
        llrs = torch.stack([d.real, d.imag], dim=-1).reshape(-1) * 4.0
        payload, ok = ssb.decode_pbch(llrs, p.config)
        wrong = int((payload.cpu().numpy() != p.payload).sum())
        print(f"# fapi DL_TTI PBCH (pci {p.config.pci}): CRC {bool(ok)}, {wrong} of 32 payload "
              f"bits wrong at {P6_CTRL_SNR_DB} dB")
        if not bool(ok) or wrong:
            fail(f"fapi DL_TTI PBCH: CRC {bool(ok)}, {wrong} bits wrong")
    rx30 = grid + unit * float(10 ** (-P6_DL_SNR_DB / 20))
    for p in req.pdsch:
        _tx, rx_cfg = p6_dl_configs(p.first_rb, ptrs=p.first_rb is None)
        sc0 = 12 * (p.first_rb or 0)
        win = rx30[:, :, sc0 : sc0 + rx_cfg.nof_grid_sc] if p.first_rb is not None else rx30
        res = pusch.process(win[None], torch.tensor([p.rnti], device=dev), rx_cfg)
        check_p5_result(f"fapi DL_TTI PDSCH rnti {p.rnti:#x} (PRB {sc0 // 12 + rx_cfg.alloc.rb_start}, "
                        f"{rx_cfg.alloc.rb_count} PRB, PT-RS {rx_cfg.ptrs_enabled}) decoded",
                        res, data.payloads[p.tb_index])
    report_call(card, "fapi DL_TTI", lambda: phy.process_dl_tti(req, data))
    return counts


def p6_csi_config():
    """Path 6 (b)'s two-step CSI grant: a compact window (PuschConfig, the
    CSI report config)."""
    from srsran_project_tpu_torch.phy.pusch import UciOnPuschConfig
    from srsran_project_tpu_torch.ran import csi

    report = csi.CsiReportConfig(nof_csi_rs_ports=4)
    uci = UciOnPuschConfig(nof_harq_ack_bits=2, nof_csi1_bits=csi.part1_bitwidth(report),
                           nof_csi2_bits=csi.part2_min_max(report)[1], csi_report_cfg=report)
    rb0, nrb = P6_CSI_GRANT
    return dataclasses.replace(ul_config(2, 4, 0.5, nrb, rb0), uci=uci), report


def p6_ul_plan(seed: int = SEED):
    """Everything random about path 6 (b), made with numpy from ``seed``:
    the UEs (as ``ul4_plan``'s, with their configs), the PUCCH payloads,
    the two-step CSI grant, the SRS channel (4,) and noise (2, 4, 14,
    3276) at SNR_DB for the two calls."""
    from srsran_project_tpu_torch.ran import csi

    rng = np.random.default_rng(seed + 60)
    ues, rb = [], 0
    for nof_ues, layers, qm, rate, nof_rb, uci in P6_UL_GROUPS:
        for _ in range(nof_ues):
            i = len(ues)
            uci_i = (0, 0, 0) if i == P6_RETX_UE else uci
            cfg = ul4_config(layers, qm, rate, nof_rb, uci_i, rb)
            ch = _unit_rows(rng, layers)
            if i == P6_RETX_UE:
                ch = ch * np.float32(10 ** (-P6_RETX_ATTEN_DB / 20))
            ues.append(dict(rnti=P6_RNTI + 20 + i, first_rb=rb, shape=(layers, qm, rate, nof_rb,
                                                                       uci_i),
                            config=cfg, tb=rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8),
                            uci=[rng.integers(0, 2, size=(n,), dtype=np.uint8) if n else None
                                 for n in uci_i],
                            channel=ch))
            rb += nof_rb
    f1, f0, f2 = ul4_pucch()
    pucch = {"f1": [(rng.integers(0, 2, size=(c.nof_harq_bits,), dtype=np.uint8),
                     _unit_rows(rng, 1)) for c in f1],
             "f0": [(v, _unit_rows(rng, 1)) for v in (1, 2)],
             "f2": [(rng.integers(0, 2, size=(c.nof_uci_bits,), dtype=np.uint8),
                     _unit_rows(rng, 1)) for c in f2]}
    cfg, report = p6_csi_config()
    ri_off, ri_w, sizes = csi.part2_correspondence(report)
    v = report.allowed_ranks.index(P6_CSI_RANK)
    csi1 = rng.integers(0, 2, size=(csi.part1_bitwidth(report),), dtype=np.uint8)
    csi1[ri_off : ri_off + ri_w] = [(v >> (ri_w - 1 - k)) & 1 for k in range(ri_w)]
    two = dict(rnti=P6_RNTI + 40, tb=rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8),
               ack=rng.integers(0, 2, size=(2,), dtype=np.uint8), csi1=csi1,
               csi2=rng.integers(0, 2, size=(sizes[v],), dtype=np.uint8),
               channel=_unit_rows(rng, 2))
    srs_h = _unit_rows(rng, 1)[0]
    sigma = np.sqrt(0.5 * 10 ** (-SNR_DB / 10))
    noise = rng.standard_normal((2, UL_NOF_PORTS, 14, UL_NOF_PRB * 12, 2)) * sigma
    return ues, pucch, two, srs_h, (noise[..., 0] + 1j * noise[..., 1]).astype(np.complex64)


def p6_srs_config():
    from srsran_project_tpu_torch.phy import srs

    return srs.SrsConfig(rb_start=P6_SRS_PRB[0], rb_count=P6_SRS_PRB[1], start_symbol=0,
                         nof_symbols=1, comb=2, sequence_id=7, nof_rx_ports=UL_NOF_PORTS,
                         nof_grid_sc=UL_NOF_PRB * 12)


def p6_ul_call(call: int, plan, device):
    """Path 6 (b)'s received grid of call 0 or 1 on ``device`` and its
    UL_TTI.request; in call 1 UE P6_RETX_UE sends rv 2 as a retransmission."""
    import torch

    from srsran_project_tpu_torch.fapi import messages as fapi
    from srsran_project_tpu_torch.phy import pusch, srs

    ues, pucch_plan, two, srs_h, noise = plan
    if call:
        ues = [dict(ue, config=dataclasses.replace(ue["config"], rv=2))
               if i == P6_RETX_UE else ue for i, ue in enumerate(ues)]
    grid, cfgs = ul4_grid(ues, pucch_plan, noise[call], device)
    cfg, _report = p6_csi_config()

    def on(x):
        return torch.from_numpy(x).to(device)

    sc0 = 12 * P6_CSI_GRANT[0]
    grid[:, :, sc0 : sc0 + cfg.nof_grid_sc] += pusch.transmit(
        on(two["tb"]), torch.tensor(two["rnti"], device=device), cfg, on(two["ack"]),
        on(two["csi1"]), on(two["csi2"]), precoding=on(two["channel"]))
    grid += on(srs_h)[:, None, None] * srs.generate(p6_srs_config(), device=device)
    f1, f0, f2 = ul4_pucch()
    pdus = [fapi.UlPuschPdu(c, ue["rnti"], harq_id=i, new_data=not (call and i == P6_RETX_UE),
                            first_rb=ue["first_rb"]) for i, (ue, c) in enumerate(zip(ues, cfgs))]
    pdus.append(fapi.UlPuschPdu(cfg, two["rnti"], harq_id=15, first_rb=P6_CSI_GRANT[0]))
    req = fapi.UlTtiRequest(
        slot=p6_slot() + 4 + call,
        pusch=pdus, pucch=[fapi.UlPucchPdu(c, P6_RNTI + 50 + k)
                           for k, c in enumerate(f1 + f0 + f2)],
        srs=[fapi.UlSrsPdu(p6_srs_config(), P6_RNTI + 60)])
    return grid, req


def p6_expected_uci(plan, req) -> list:
    """The UCI indications the call must give, in order: per PUSCH PDU its
    HARQ-ACK, CSI part 1 and part 2 bits (part 2 of the two-step grant as
    sent, a prefix of the padded indication), then per PUCCH PDU its bits
    (F0: the HARQ bits and the SR bit)."""
    from srsran_project_tpu_torch.phy import pucch

    ues, pucch_plan, two, _srs_h, _noise = plan
    out = []
    for ue in ues:
        out.extend(u for u in ue["uci"] if u is not None)
    out.extend([two["ack"], two["csi1"], two["csi2"]])
    f1, f0, _f2 = ul4_pucch()
    out.extend(bits for bits, _h in pucch_plan["f1"])
    for (value, _h), c in zip(pucch_plan["f0"], f0):
        bits = [(value >> i) & 1 for i in range(c.nof_harq_bits)]
        out.append(np.asarray(bits + ([1] if c.sr_opportunity else []), np.uint8))
    out.extend(bits for bits, _h in pucch_plan["f2"])
    return out


def p6_check_results(name: str, res, req, plan, retx_ok: bool) -> None:
    """Every CRC, RxData, UCI and SRS indication of one UL_TTI call against
    what was sent."""
    ues, _pucch, two, srs_h, _noise = plan
    sent_tbs = [ue["tb"] for ue in ues] + [two["tb"]]
    crc = [c.tb_crc_ok for c in res.crc]
    want_crc = [retx_ok if i == P6_RETX_UE else True for i in range(len(sent_tbs))]
    snrs = [round(c.snr_db, 2) for c in res.crc]
    print(f"# {name}: CRC {crc}, SINR dB {snrs}")
    if crc != want_crc or [c.rnti for c in res.crc] != [p.rnti for p in req.pusch]:
        fail(f"{name}: CRC {crc}, want {want_crc}")
    if not all(np.isfinite(c.snr_db) for c in res.crc):
        fail(f"{name}: non-finite SINR")
    got_rx = {d.rnti: d.payload for d in res.rx_data}
    for p, tb, ok in zip(req.pusch, sent_tbs, want_crc):
        if ok and not np.array_equal(got_rx.get(p.rnti), tb):
            fail(f"{name}: RxData of rnti {p.rnti:#x} differs from the TB sent")
    if len(got_rx) != sum(want_crc):
        fail(f"{name}: {len(got_rx)} RxData indications, want {sum(want_crc)}")
    want_uci = p6_expected_uci(plan, req)
    if len(res.uci) != len(want_uci):
        fail(f"{name}: {len(res.uci)} UCI indications, want {len(want_uci)}")
    bad = [k for k, (u, w) in enumerate(zip(res.uci, want_uci))
           if not u.valid or not np.array_equal(np.asarray(u.uci_bits)[: w.size], w)]
    print(f"# {name}: {len(res.uci)} UCI indications (PUSCH UCI, two-step CSI, 6 PUCCH), "
          f"{len(bad)} wrong or invalid")
    if bad:
        fail(f"{name}: UCI indications {bad} wrong or invalid")
    if res.errors or len(res.srs) != 1:
        fail(f"{name}: errors {res.errors}, {len(res.srs)} SRS indications")
    s = res.srs[0]
    h = np.asarray(s.h)
    rel = float(np.abs(h.mean(axis=-1) - srs_h).max() / np.abs(srs_h).max())
    print(f"# {name}: SRS h {h.shape}, wideband mean within {rel:.4f} of the channel sent, "
          f"SNR {s.snr_db:.2f} dB")
    if h.shape != (UL_NOF_PORTS, P6_SRS_PRB[1] * 6) or not rel < 0.02 or not s.snr_db > 20.0:
        fail(f"{name}: SRS h {h.shape}, off by {rel:.4f}, SNR {s.snr_db:.2f} dB")


def p6_slot_pdus(req, pool=None):
    """The UlSlotPdus that ``UpperPhy`` hands ``process_slot`` for ``req``
    (HARQ buffers from ``pool`` for retransmissions)."""
    from srsran_project_tpu_torch.phy import ul_slot

    return [ul_slot.UlSlotPdu(rnti=p.rnti, first_rb=p.first_rb, config=p.config,
                              harq_buffer=None if p.new_data else pool.get(p.rnti, p.harq_id))
            for p in req.pusch if p.config.uci is None or p.config.uci.csi_report_cfg is None]


def fapi_ul_phase(card: str) -> tuple[dict, dict]:
    """Path 6 (b): two UL_TTI calls through ``UpperPhy.process_ul_tti``,
    the retransmission out of the pool in the second; K2 held against its
    plain version on each call's code groups, K3 on group A's estimate, K1
    on the two-step CSI grant's LLRs.  Returns the launch counts of both
    calls and the kernels' largest differences."""
    import torch

    from srsran_project_tpu_torch.phy import ul_slot
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig

    dev = torch.device(DEVICE)
    plan = p6_ul_plan()
    phy = UpperPhy(UpperPhyConfig(nof_ports=UL_NOF_PORTS, nof_grid_sc=UL_NOF_PRB * 12,
                                  device=DEVICE))
    total: dict = {}
    errs = {"decode": 0.0, "mmse_weights_4x4": 0.0, "decode_dematch": 0.0}
    calls = []
    for call in (0, 1):
        grid, req = p6_ul_call(call, plan, dev)
        slot_pdus = p6_slot_pdus(req, phy.harq_pool)
        codes = {(c.sch.seg.base_graph, c.sch.seg.lifting_size, c.nof_ldpc_iterations,
                  c.ldpc_early_stop, c.sch.n_cb) for c in ul_slot._config_groups(slot_pdus)}
        torch.cuda.synchronize()
        reset_counts()
        res = phy.process_ul_tti(req, grid)
        torch.cuda.synchronize()
        counts = read_counts()
        name = f"fapi UL_TTI call {call + 1}"
        per_pdu = [p.config for p in req.pusch
                   if p.config.uci is not None and p.config.uci.csi_report_cfg is not None]
        k8 = k8_launches(list(ul_slot._config_groups(slot_pdus)) + per_pdu)
        expect_counts(name, counts, {"decode": len(codes), "decode_dematch": 1,
                                     "mmse_equalize": k8})
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        retx = plan[0][P6_RETX_UE]
        pooled = phy.harq_pool.get(retx["rnti"], P6_RETX_UE) is not None
        p6_check_results(name, res, req, plan, retx_ok=bool(call))
        if pooled == bool(call):
            fail(f"{name}: UE {P6_RETX_UE}'s HARQ buffer pooled {pooled}")
        k2_err, geometries = check_code_groups(grid, slot_pdus, name)
        errs["decode"] = max(errs["decode"], k2_err)
        print(f"# {name}: K2 code groups {geometries}")
        calls.append((grid, req))
    # K3 on group A's estimate and K1 on the two-step CSI grant's LLRs, from
    # the first call's grid.
    grid, req = calls[0]
    errs["mmse_weights_4x4"] = check_k3_group(grid, p6_slot_pdus(req), "fapi UL_TTI group A K3")
    errs["decode_dematch"] = check_k1_grant(grid, req.pusch[-1], "fapi UL_TTI two-step CSI")
    timing = UpperPhy(UpperPhyConfig(nof_ports=UL_NOF_PORTS, nof_grid_sc=UL_NOF_PRB * 12,
                                     device=DEVICE))
    report_call(card, "fapi UL_TTI (call 1's request: 8 PUSCH, a two-step CSI grant, 6 PUCCH, "
                "1 SRS)", lambda: timing.process_ul_tti(req, grid))
    return total, errs


def app_phase(card: str) -> dict:
    """Path 6 (c): the port's du_low_sim in-process (``main``), twice; each
    run's return code and BLER line checked, its launch counts read around
    it.  Returns the launches summed over both runs."""
    import contextlib
    import io
    import re

    import torch

    from srsran_project_tpu_torch.apps import du_low_sim

    total: dict = {}
    for argv, want_bler in P6_APP_RUNS:
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        with contextlib.redirect_stderr(buf):
            rc = du_low_sim.main(list(argv))
        torch.cuda.synchronize()
        counts = read_counts()
        text = buf.getvalue()
        for line in text.splitlines():
            print(f"# du_low_sim {' '.join(argv)}: {line.lstrip('# ')}")
        m = re.search(r"# (\d+) slots in ([0-9.]+)s \(([0-9.]+) slot-pairs/s\), BLER=([0-9.]+)",
                      text)
        if m is None:
            fail(f"du_low_sim {argv}: no summary line (rc {rc})")
        slots, bler = int(m.group(1)), float(m.group(4))
        print(f"# [{card}] du_low_sim {' '.join(argv)}: rc {rc}, BLER {bler:.3f}, "
              f"{m.group(3)} slot-pairs/s")
        if rc != (0 if bler < 1.0 else 1):
            fail(f"du_low_sim {argv}: rc {rc} with BLER {bler}")
        if want_bler is not None and (rc != 0 or bler != want_bler):
            fail(f"du_low_sim {argv}: rc {rc}, BLER {bler}, want rc 0 and BLER {want_bler}")
        # 4 ports at 4 layers and at 1: K8 a slot in both runs.
        expect_counts(f"du_low_sim {' '.join(argv)}", counts,
                      {"decode_dematch": slots, "mmse_equalize": slots})
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


# ---- random access and the rest of the uplink's measurements ------------------

P7_RNTI = 0x4A01
P7_SLOT = (7, 0)  # (SFN, slot)
# (a) Two compact 4-layer 64QAM grants (MCS 17 of the 256QAM table,
# 772/1024) of 128 PRB at PRB 0 and 128 on symbols 1-13 with DM-RS on
# symbols 2 and 11, both with TA and CFO compensation; per UE its delay
# (a phase ramp over the subcarriers) and CFO (a phase per symbol at the
# symbol's start, as phy/channel_emulator applies it); 30 dB.  Not 256QAM:
# under a bulk delay the fast estimator's FD-OCC despreading leaks the
# co-CDM layer (ROADMAP Q3), which holds a 4-layer grant delayed by 0.40
# us near 23.5 dB SINR in both packages, below what MCS 21 needs.
P7_FIRST_RBS = (0, 128)
P7_NOF_PRB = 128
P7_MCS = (17, "qam256")
P7_DELAYS_S = (0.40e-6, -0.20e-6)
P7_CFOS_HZ = (400.0, -250.0)
P7_TA_TOL_S = 10e-9
# The PRACH occasions, sampled at 122.88 MHz: (format, zero-correlation
# zone, logical root, PRB offset, start symbol, the (preamble, delay)
# pairs sent, SNR in dB per preamble subcarrier and port).  (a) format 0
# (L_RA 839, 1.25 kHz, N_CS 46: 18 shifts a root, 4 roots) at PRB 258;
# (b) B4 (L_RA 139, 30 kHz, 12 symbols, 12 PRB) at PRB 200; (c) format 0
# with noise only.
P7_SRATE_HZ = 122.88e6
P7_PRACH = {
    "a": ("0", 8, 0, 258, 0, ((5, 2.0e-6), (50, 9.0e-6)), 0.0),
    "b": ("B4", 7, 3, 200, 0, ((17, 0.5e-6),), 0.0),
    "c": ("0", 8, 0, 258, 0, (), 0.0),
}
# (d) PUCCH F3 and F4 at 20 dB: (PucchFormat34Config fields): F3 over 16
# PRB with hopping and additional DM-RS and 100 UCI bits (polar), F3 on 1
# PRB with pi/2-BPSK and 12 bits, F4 with OCC length 4 and indices 0 and
# 2 on one PRB.
P7_F34 = (
    dict(prb_start=200, nof_prb=16, start_symbol=0, nof_symbols=14, nof_uci_bits=100,
         second_hop_prb=240, additional_dmrs=True),
    dict(prb_start=220, nof_prb=1, start_symbol=0, nof_symbols=14, nof_uci_bits=12,
         pi2_bpsk=True),
    dict(prb_start=230, nof_prb=1, start_symbol=0, nof_symbols=14, nof_uci_bits=8,
         occ_length=4, occ_index=0),
    dict(prb_start=230, nof_prb=1, start_symbol=0, nof_symbols=14, nof_uci_bits=10,
         occ_length=4, occ_index=2),
)
P7_PUCCH_SNR_DB = 20.0
# (e) Four F1 occasions on PRB 262: (initial cyclic shift, OCC, HARQ bits).
P7_F1_PRB = 262
P7_F1 = ((0, 0, 1), (3, 1, 2), (6, 0, 2), (9, 1, 1))
# (f) A comb-4 PRS of 270 PRB from PRB 3 over symbols 2-13, delayed by
# 37.3 samples of the 4096-point domain, at 20 dB.
P7_PRS = dict(rb_start=3, rb_count=270, start_symbol=2, nof_symbols=12, comb_size=4,
              n_id_prs=42, slot_in_frame=P7_SLOT[1], nof_grid_sc=UL_NOF_PRB * 12)
P7_PRS_DELAY = 37.3


def p7_slot():
    from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing
    from srsran_project_tpu_torch.ran.slot_point import SlotPoint

    return SlotPoint.from_sfn_slot(SubcarrierSpacing.KHZ30, *P7_SLOT)


def p7_config(first_rb: int, measured: bool = True):
    """The port's PuschConfig of one path-7 grant: a compact window of 128
    PRB at crb_start first_rb, with (measured) or without TA and CFO
    compensation."""
    from srsran_project_tpu_torch.ops.modulation import Modulation
    from srsran_project_tpu_torch.phy import pusch
    from srsran_project_tpu_torch.phy.allocation import Allocation
    from srsran_project_tpu_torch.ran import tbs as tbs_mod

    qm, rate = tbs_mod.mcs_to_qm_rate(*P7_MCS)
    alloc = Allocation(rb_start=0, rb_count=P7_NOF_PRB, sym_start=1, sym_count=13,
                       dmrs_symbols=(2, 11), crb_start=first_rb)
    return pusch.PuschConfig(
        tbs=tbs_mod.calculate_tbs(P7_NOF_PRB, 13, 24, rate, qm, 4), target_code_rate=rate,
        modulation=Modulation(qm), alloc=alloc, nof_layers=4, nof_rx_ports=UL_NOF_PORTS,
        nof_grid_symbols=14, nof_grid_sc=P7_NOF_PRB * 12, compute_ta=measured,
        cfo_compensation=measured)


def p7_prach_config(name: str):
    """The detector's PrachConfig of occasion ``name``."""
    from srsran_project_tpu_torch.phy import prach

    fmt, zcz, root = P7_PRACH[name][:3]
    return prach.PrachConfig(l_ra=839 if fmt == "0" else 139, root_sequence_index=root,
                             zero_correlation_zone=zcz, nof_rx_ports=UL_NOF_PORTS)


def p7_window(name: str) -> dict:
    from srsran_project_tpu_torch.ops import lower_phy

    fmt, _zcz, _root, rb0, sym0 = P7_PRACH[name][:5]
    return lower_phy.prach_window_params(fmt, 30000, P7_SLOT[1] % 2, sym0, 0, P7_SRATE_HZ, rb0,
                                         0, UL_NOF_PRB, 839 if fmt == "0" else 139)


def p7_prach_samples(name: str, seed: int, device):
    """Occasion ``name``'s (4, samples) baseband at 122.88 MHz, built on
    ``device``: each preamble (``prach.generate_preamble_ref``, unit power
    a subcarrier) delayed by a phase ramp over its DC-relative
    frequencies and through a random gain per port, one unitary IDFT, the
    symbol repeated and its CP prepended; plus white noise at the SNR per
    subcarrier and port.  Everything random from numpy with ``seed``."""
    import torch

    from srsran_project_tpu_torch.phy import prach

    fmt, zcz, root, _rb0, _sym0, preambles, snr_db = P7_PRACH[name]
    p = p7_window(name)
    dft, l_ra, scs = p["dft_size"], p["l_ra"], P7_SRATE_HZ / p["dft_size"]
    rng = np.random.default_rng(seed)
    bins = (p["k_offset"] + np.arange(l_ra)) % dft
    freq = np.where(bins >= dft // 2, bins - dft, bins) * scs
    spec = torch.zeros((UL_NOF_PORTS, dft), dtype=torch.complex64, device=device)
    idx = torch.from_numpy(bins.astype(np.int64)).to(device)
    for pi, tau in preambles:
        g = rng.standard_normal(UL_NOF_PORTS) + 1j * rng.standard_normal(UL_NOF_PORTS)
        g = g / np.sqrt(2)
        ramp = np.exp(-2j * np.pi * freq * tau) / np.sqrt(l_ra)
        y = prach.generate_preamble_ref(fmt, root, pi, zcz, device=device)
        spec[:, idx] += (torch.from_numpy(g.astype(np.complex64)).to(device)[:, None]
                         * (y * torch.from_numpy(ramp.astype(np.complex64)).to(device))[None])
    sym = torch.fft.ifft(spec, dim=-1) * float(np.sqrt(dft))
    body = sym.repeat(1, p["nof_symbols"])
    sig = torch.cat([body[:, body.shape[-1] - p["cp_samples"]:], body], dim=-1)
    sigma = np.sqrt(0.5 * 10 ** (-snr_db / 10))
    noise = rng.standard_normal((UL_NOF_PORTS, sig.shape[-1], 2)).astype(np.float32) * sigma
    return sig + torch.view_as_complex(torch.from_numpy(noise)).to(device)


def p7_prach_fd(name: str, samples):
    """The occasion's (4, L_RA) preamble subcarriers through
    ``lower_phy.prach_demodulate``."""
    from srsran_project_tpu_torch.ops import lower_phy

    p = p7_window(name)
    return lower_phy.prach_demodulate(samples[..., p["sample_offset"]:], l_ra=p["l_ra"],
                                      dft_size=p["dft_size"], nof_symbols=p["nof_symbols"],
                                      cp_samples=p["cp_samples"], k_offset=p["k_offset"])


def p7_plan(seed: int = SEED):
    """Path 7 (a)'s UEs, made with numpy from ``seed``: per UE rnti,
    first_rb, TB bits, (4, 4) unitary channel, delay and CFO; and the (4,
    14, 3276) noise at SNR_DB."""
    rng = np.random.default_rng(seed + 7)
    ues = []
    for i, rb0 in enumerate(P7_FIRST_RBS):
        cfg = p7_config(rb0)
        ues.append(dict(rnti=P7_RNTI + i, first_rb=rb0, config=cfg,
                        tb=rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8),
                        channel=_unit_rows(rng, 4), delay=P7_DELAYS_S[i], cfo=P7_CFOS_HZ[i]))
    sigma = np.sqrt(0.5 * 10 ** (-SNR_DB / 10))
    noise = rng.standard_normal((UL_NOF_PORTS, 14, UL_NOF_PRB * 12, 2)) * sigma
    return ues, (noise[..., 0] + 1j * noise[..., 1]).astype(np.complex64)


def p7_grid(ues, noise, device):
    """Path 7 (a)'s received (4, 14, 3276) grid on ``device``: each UE's
    ``pusch.transmit`` through its channel, delay and CFO, plus the noise."""
    import torch

    from srsran_project_tpu_torch.phy import channel_emulator, pusch

    grid = torch.tensor(noise, device=device)  # a copy, also on the CPU
    k = np.arange(UL_NOF_PRB * 12)
    for ue in ues:
        cfg = ue["config"]
        sub = pusch.transmit(torch.from_numpy(ue["tb"]).to(device),
                             torch.tensor(ue["rnti"], device=device), cfg,
                             precoding=torch.from_numpy(ue["channel"]).to(device))
        sc0 = 12 * ue["first_rb"]
        ramp = np.exp(-2j * np.pi * k[sc0 : sc0 + cfg.nof_grid_sc] * 30e3 * ue["delay"])
        cfo = channel_emulator._cfo_phases(channel_emulator.ChannelConfig(cfo_hz=ue["cfo"]), 14,
                                           torch.device(device))
        grid[:, :, sc0 : sc0 + cfg.nof_grid_sc] += (
            sub * torch.from_numpy(ramp.astype(np.complex64)).to(device)[None, None]
            * cfo[None, :, None])
    return grid


def p7_request(name: str, ues=()):
    """The UL_TTI.request of call ``name``: the UEs' PUSCH PDUs and the
    occasion's PRACH PDU."""
    from srsran_project_tpu_torch.fapi import messages as fapi

    return fapi.UlTtiRequest(
        slot=p7_slot() + "abc".index(name),
        pusch=[fapi.UlPuschPdu(ue["config"], ue["rnti"], harq_id=i, first_rb=ue["first_rb"])
               for i, ue in enumerate(ues)],
        prach=[fapi.UlPrachPdu(p7_prach_config(name))])


def p7_expected_ta(name: str) -> dict:
    """Preamble index -> the TA bin ``detect`` should read: the delay in
    bins of the dft_size-point profile plus the fraction of a bin at which
    the preamble's shift window starts (the window starts at its floor)."""
    cfg = p7_prach_config(name)
    scs = P7_SRATE_HZ / p7_window(name)["dft_size"]
    out = {}
    for pi, tau in P7_PRACH[name][5]:
        v = pi % cfg.nof_shifts
        start = ((cfg.l_ra - v * cfg.n_cs) * cfg.dft_size / cfg.l_ra) % cfg.dft_size
        out[pi] = tau * cfg.dft_size * scs + (start - math.floor(start))
    return out


def p7_check_rach(what: str, res, name: str) -> None:
    """Exactly the sent preambles, each TA within one bin of its delay."""
    want = p7_expected_ta(name)
    got = {r.preamble_index: r.ta_samples for r in res.rach}
    bin_s = 1.0 / (p7_prach_config(name).dft_size * P7_SRATE_HZ / p7_window(name)["dft_size"])
    found = [(r.preamble_index, round(r.metric, 2), r.ta_samples) for r in res.rach]
    print(f"# {what}: RACH {found} (bin {bin_s * 1e6:.4f} us), want preambles {sorted(want)} "
          f"at TA bins {[round(v, 2) for v in want.values()]}")
    if sorted(got) != sorted(want):
        fail(f"{what}: detected preambles {sorted(got)}, want {sorted(want)}")
    for pi, ta in got.items():
        if not abs(ta - want[pi]) <= 1.0:
            fail(f"{what}: preamble {pi} TA {ta} bins, want {want[pi]:.2f} within one bin")


def prach_ul_phase(card: str) -> tuple[dict, dict, dict, dict]:
    """Path 7 (a)-(c): three UL_TTI calls through
    ``UpperPhy.process_ul_tti`` with the PRACH occasions' buffers.  Returns
    the launch counts of (a) and of (b) + (c), K2's and K3's largest
    differences from their plain versions on (a)'s inputs, and their
    device ms and bounds there."""
    import torch

    from srsran_project_tpu_torch.ops import equalizer
    from srsran_project_tpu_torch.ops.ldpc import decoder
    from srsran_project_tpu_torch.phy import pusch, ul_slot
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig

    dev = torch.device(DEVICE)
    ues, noise = p7_plan()
    grid = p7_grid(ues, noise, dev)
    phy = UpperPhy(UpperPhyConfig(nof_ports=UL_NOF_PORTS, nof_grid_sc=UL_NOF_PRB * 12,
                                  device=DEVICE))
    samples = {n: p7_prach_samples(n, SEED + 70 + i, dev) for i, n in enumerate("abc")}
    req_a = p7_request("a", ues)

    torch.cuda.synchronize()
    reset_counts()
    fd_a = p7_prach_fd("a", samples["a"])
    res = phy.process_ul_tti(req_a, grid, prach_fd=fd_a)
    torch.cuda.synchronize()
    counts_a = read_counts()
    expect_counts("prach UL_TTI (a)", counts_a, {"decode": 1, "mmse_equalize": 1})
    crc = [c.tb_crc_ok for c in res.crc]
    tas = [c.ta_s for c in res.crc]
    print(f"# prach UL_TTI (a): prach_fd {tuple(fd_a.shape)}, CRC {crc}, SINR dB "
          f"{[round(c.snr_db, 2) for c in res.crc]}, ta_s {tas} (delays {list(P7_DELAYS_S)})")
    if crc != [True, True] or res.errors:
        fail(f"prach UL_TTI (a): CRC {crc}, errors {res.errors}")
    for ue, c, d in zip(ues, res.crc, res.rx_data):
        if not np.array_equal(d.payload, ue["tb"]):
            fail(f"prach UL_TTI (a): rnti {ue['rnti']:#x} RxData differs from the TB sent")
        if not abs(c.ta_s - ue["delay"]) <= P7_TA_TOL_S:
            fail(f"prach UL_TTI (a): rnti {c.rnti:#x} ta_s {c.ta_s}, want {ue['delay']} within "
                 f"{P7_TA_TOL_S}")
    p7_check_rach("prach UL_TTI (a)", res, "a")

    # The same grid without CFO compensation: both CRCs fail.
    plain = [ul_slot.UlSlotPdu(rnti=ue["rnti"], first_rb=ue["first_rb"],
                               config=p7_config(ue["first_rb"], measured=False)) for ue in ues]
    crc_plain = [bool(r["tb_crc_ok"]) for r in ul_slot.process_slot(grid, plain)[0]]
    print(f"# prach UL_TTI (a) without CFO compensation: CRC {crc_plain}")
    if any(crc_plain):
        fail(f"prach UL_TTI (a): without CFO compensation CRC {crc_plain}: the check shows "
             f"nothing")

    # K2 on the call's code group and K3 on its estimate.
    slot_pdus = [ul_slot.UlSlotPdu(rnti=ue["rnti"], first_rb=ue["first_rb"], config=ue["config"])
                 for ue in ues]
    k2_err, geometries = check_code_groups(grid, slot_pdus, "prach UL_TTI (a)")
    cfg_a, _idx = next(iter(ul_slot._config_groups(slot_pdus).items()))
    first_rbs = tuple(ue["first_rb"] for ue in ues)
    win = torch.stack([grid[:, :, 12 * r : 12 * r + cfg_a.nof_grid_sc] for r in first_rbs])
    _g, h, nv = pusch._estimate_stage(win, cfg_a, r_override=pusch._pilot_bank_on(
        dev, cfg_a, first_rbs))
    k3_err = check_k3_on(h.transpose(1, 2), nv, "prach UL_TTI (a) K3")[0]
    groups = ul_slot._config_groups(slot_pdus)
    fronts = ul_slot._slot_front(grid, groups, slot_pdus)
    (bg, z, iters, early, n_cb), _gis, _sizes, llrs = ul_slot._code_groups(tuple(groups),
                                                                           fronts)[0]
    bits, _, its = decoder.decode(llrs, bg, z, iters, early, True, n_cb)
    hs = h.transpose(1, 2)
    w, ev = equalizer.mmse_weights_4x4(hs, nv)
    times = {"decode": dict(
        ms=kernel_ms(lambda: decoder.decode(llrs, bg, z, iters, early, True, n_cb)),
        bound_ms=ldpc_bound(decoder.decode_plan(bg, z, llrs.shape[-1], n_cb), its, (llrs,),
                            (bits, its))[0]),
        "mmse_weights_4x4": dict(ms=kernel_ms(lambda: equalizer.mmse_weights_4x4(hs, nv)),
                                 bound_ms=bound(nbytes(hs, nv, w, ev),
                                                1500.0 * hs.shape[0] * hs.shape[1])[0])}
    print(f"# [{card}] prach UL_TTI (a): K2 ({geometries[0]}, C={llrs.shape[0]}) "
          f"{times['decode']['ms']:.4f} ms (bound {times['decode']['bound_ms']:.5f}), K3 "
          f"({tuple(hs.shape)}) {times['mmse_weights_4x4']['ms']:.4f} ms (bound "
          f"{times['mmse_weights_4x4']['bound_ms']:.5f}) device time")

    total = {}
    for name in "bc":
        req = p7_request(name)
        torch.cuda.synchronize()
        reset_counts()
        fd = p7_prach_fd(name, samples[name])
        res = phy.process_ul_tti(req, grid, prach_fd=fd)
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"prach UL_TTI ({name})", counts, {})
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if res.crc or res.errors:
            fail(f"prach UL_TTI ({name}): CRC {res.crc}, errors {res.errors}")
        p7_check_rach(f"prach UL_TTI ({name}) {P7_PRACH[name][0]}", res, name)

    timing = UpperPhy(UpperPhyConfig(nof_ports=UL_NOF_PORTS, nof_grid_sc=UL_NOF_PRB * 12,
                                     device=DEVICE))
    report_call(card, "prach UL_TTI (a): 2 PUSCH with TA and CFO, PRACH format 0 (demodulation "
                "included)", lambda: timing.process_ul_tti(
                    req_a, grid, prach_fd=p7_prach_fd("a", samples["a"])))
    for name in "bc":
        req = p7_request(name)
        report_call(card, f"prach UL_TTI ({name}): PRACH {P7_PRACH[name][0]} only (demodulation "
                    "included)", lambda req=req, name=name: timing.process_ul_tti(
                        req, grid, prach_fd=p7_prach_fd(name, samples[name])))
    return counts_a, total, {"decode": k2_err, "mmse_weights_4x4": k3_err}, times


def p7_pucch_plan(seed: int = SEED):
    """(d) and (e): the F3/F4 configs with payloads and (4,) channels, the
    F1 configs with bits and channels, and unit noise (2, 4, 14, 3276)."""
    from srsran_project_tpu_torch.phy import pucch, pucch_f34

    rng = np.random.default_rng(seed + 71)
    f34 = []
    for i, kw in enumerate(P7_F34):
        c = pucch_f34.PucchFormat34Config(rnti=P7_RNTI + 10 + i, n_id=11,
                                          slot_in_frame=P7_SLOT[1], nof_rx_ports=UL_NOF_PORTS,
                                          nof_grid_sc=UL_NOF_PRB * 12, **kw)
        f34.append((c, rng.integers(0, 2, size=(c.nof_uci_bits,), dtype=np.uint8),
                    _unit_rows(rng, 1)[0]))
    f1 = []
    for m0, occ, nbits in P7_F1:
        c = pucch.PucchFormat1Config(prb=P7_F1_PRB, start_symbol=0, nof_symbols=14,
                                     initial_cyclic_shift=m0, occ_index=occ, n_id=11,
                                     slot_in_frame=P7_SLOT[1], nof_harq_bits=nbits,
                                     nof_grid_sc=UL_NOF_PRB * 12)
        f1.append((c, rng.integers(0, 2, size=(nbits,), dtype=np.uint8), _unit_rows(rng, 1)[0]))
    noise = rng.standard_normal((2, UL_NOF_PORTS, 14, UL_NOF_PRB * 12, 2)) * np.sqrt(0.5)
    return f34, f1, (noise[..., 0] + 1j * noise[..., 1]).astype(np.complex64)


def p7_pucch_grids(plan, device):
    """(d)'s and (e)'s received grids on ``device``, at P7_PUCCH_SNR_DB."""
    import torch

    from srsran_project_tpu_torch.phy import pucch, pucch_f34

    f34, f1, noise = plan
    scale = float(10 ** (-P7_PUCCH_SNR_DB / 20))
    g34 = torch.from_numpy(noise[0]).to(device) * scale
    for c, bits, h in f34:
        g34 += torch.from_numpy(h).to(device)[:, None, None] * pucch_f34.generate(c, bits, device)
    g1 = torch.from_numpy(noise[1]).to(device) * scale
    for c, bits, h in f1:
        sig = pucch.format1_generate(c, bits, device=device)
        h_t = torch.from_numpy(h).to(device)
        g1[:, :, 12 * c.prb : 12 * c.prb + 12] += h_t[:, None, None] * sig
    return g34, g1


def pucch_f34_phase(card: str) -> tuple[dict, dict]:
    """Path 7 (d) and (e): ``pucch_f34.process`` on each F3/F4 occasion and
    ``pucch.format1_detect_batch`` on the four F1 UEs, every bit and flag
    checked.  Returns the launch counts of (d) and (e)."""
    import torch

    from srsran_project_tpu_torch.phy import pucch, pucch_f34

    dev = torch.device(DEVICE)
    plan = p7_pucch_plan()
    g34, g1 = p7_pucch_grids(plan, dev)
    f34, f1, _noise = plan
    torch.cuda.synchronize()
    reset_counts()
    outs = [pucch_f34.process(g34, c) for c, _b, _h in f34]
    torch.cuda.synchronize()
    counts_d = read_counts()
    expect_counts("pucch F3/F4 (d)", counts_d, {})
    for (c, bits, _h), (got, ok, snr) in zip(f34, outs):
        what = (f"pucch F{3 if c.occ_length == 1 else 4} (d) {c.nof_prb} PRB at {c.prb_start}, "
                f"{c.nof_uci_bits} bits, hop {c.second_hop_prb}, add. DM-RS {c.additional_dmrs}, "
                f"pi/2-BPSK {c.pi2_bpsk}, OCC {c.occ_length}/{c.occ_index}")
        wrong = int((got.cpu().numpy() != bits).sum())
        print(f"# {what}: ok {bool(ok)}, {wrong} bits wrong, SNR {float(snr):.2f} dB")
        if not bool(ok) or wrong:
            fail(f"{what}: ok {bool(ok)}, {wrong} bits wrong")
    torch.cuda.synchronize()
    reset_counts()
    batch = pucch.format1_detect_batch(g1, f1[0][0])
    torch.cuda.synchronize()
    counts_e = read_counts()
    expect_counts("pucch F1 batch (e)", counts_e, {})
    for c, bits, _h in f1:
        m0, occ = c.initial_cyclic_shift, c.occ_index
        got = batch["bits2"][m0, occ, : bits.size].cpu().numpy()
        rho = float(batch["rho"][m0, occ])
        print(f"# pucch F1 batch (e) shift {m0} OCC {occ}: bits {got.tolist()} (sent "
              f"{bits.tolist()}), rho {rho:.3f}")
        if not np.array_equal(got, bits) or not rho > pucch.F1_DTX_THRESHOLD:
            fail(f"pucch F1 batch (e) shift {m0} OCC {occ}: bits {got}, sent {bits}, rho {rho}")
    report_call(card, "pucch F3/F4 (d): 4 occasions",
                lambda: [pucch_f34.process(g34, c) for c, _b, _h in f34])
    report_call(card, "pucch F1 batch (e)", lambda: pucch.format1_detect_batch(g1, f1[0][0]))
    return counts_d, counts_e


def prs_phase(card: str) -> dict:
    """Path 7 (f): a 270-PRB comb-4 PRS delayed by 37.3 samples, read back
    by ``prs_toa_estimate`` within 0.5 sample.  Returns its launch
    counts."""
    import torch

    from srsran_project_tpu_torch.phy import ptrs_prs

    dev = torch.device(DEVICE)
    cfg = ptrs_prs.PrsConfig(**P7_PRS)
    rng = np.random.default_rng(SEED + 72)
    k = np.arange(cfg.nof_grid_sc)
    ramp = np.exp(-2j * np.pi * k * P7_PRS_DELAY / 4096).astype(np.complex64)
    noise = rng.standard_normal((14, cfg.nof_grid_sc, 2)) * np.sqrt(0.5 * 10 ** (-20.0 / 10))
    rx = (ptrs_prs.generate_prs(cfg, device=dev) * torch.from_numpy(ramp).to(dev)[None]
          + torch.from_numpy((noise[..., 0] + 1j * noise[..., 1]).astype(np.complex64)).to(dev))
    torch.cuda.synchronize()
    reset_counts()
    out = ptrs_prs.prs_toa_estimate(rx, cfg, dft_size=4096)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("prs (f)", counts, {})
    toa = float(out["toa_samples"])
    print(f"# prs (f) {cfg.rb_count} PRB from {cfg.rb_start}, comb {cfg.comb_size}, "
          f"{cfg.nof_symbols} symbols: toa {toa:.3f} samples (delay {P7_PRS_DELAY}), peak power "
          f"{float(out['peak_power']):.1f}, rsrp {float(out['rsrp']):.4f}")
    if not abs(toa - P7_PRS_DELAY) < 0.5:
        fail(f"prs (f): toa {toa}, want {P7_PRS_DELAY} within 0.5")
    report_call(card, "prs (f)", lambda: ptrs_prs.prs_toa_estimate(rx, cfg, dft_size=4096))
    return counts


# ---- the reference-exact conformance modes -------------------------------------

P8_RNTI = 0x4B01
P8_SNR_DB = 30.0
# (b): the whole conformance chain (reference estimator, equalizer, int8
# demapper and int8 min-sum decoder) on the 273-PRB carrier, symbols 0-13
# with DM-RS on 2 and 11, 64QAM MCS 20 (567/1024), no early stop:
# name -> (layers, RX ports, equalizer).
P8_CHAIN = {"b1": (2, 2, "zf_ref"), "b2": (1, 4, "mmse_ref")}
# (c): BLER-parity manifest rows and their slots; the harness batches
# P8_CHUNK slots a decode (one K2 launch).
P8_BLER = ((0, 60), (7, 30), (8, 60))
P8_CHUNK = 30
P8_APP = ["--config", "configs/conformance_parity.yml", "--slots", "20"]


def p8_channel(rng, layers: int, ports: int) -> np.ndarray:
    """(layers, ports) complex64: a random unitary matrix (layers = ports)
    or orthonormal rows scaled to unit power a port."""
    h = rng.standard_normal((ports, layers)) + 1j * rng.standard_normal((ports, layers))
    return (np.linalg.qr(h)[0].T * np.sqrt(ports / layers)).astype(np.complex64)


def p8_received(cfg, rng, device):
    """One slot of ``cfg`` over a random channel at P8_SNR_DB a port, the
    port's own UE side: (TB (1, A), received (1, P, 14, nsc))."""
    import torch

    from srsran_project_tpu_torch.phy import pusch

    tb = torch.from_numpy(rng.integers(0, 2, size=(1, cfg.tbs), dtype=np.uint8)).to(device)
    w = torch.from_numpy(p8_channel(rng, cfg.nof_layers, cfg.nof_rx_ports)).to(device)
    grid = pusch.transmit(tb, torch.tensor([P8_RNTI], device=device), cfg, precoding=w)
    noise = rng.standard_normal(tuple(grid.shape) + (2,)) * np.sqrt(0.5 * 10 ** (-P8_SNR_DB / 10))
    noise = torch.from_numpy((noise[..., 0] + 1j * noise[..., 1]).astype(np.complex64))
    return tb, grid + noise.to(device)


def p8_check(what: str, out: dict, tb) -> None:
    crc = bool(out["tb_crc_ok"][0])
    errs = int((out["tb_bits"][0] != tb[0]).sum())
    snr = float(out["snr_db"][0])
    print(f"# refmodes {what}: CRC {crc}, bit errors {errs}, SINR {snr:.2f} dB")
    if not crc or errs:
        fail(f"refmodes {what}: CRC {crc} with {errs} bit errors")
    if not (np.isfinite(float(out["noise_var"][0])) and np.isfinite(snr)):
        fail(f"refmodes {what}: non-finite noise_var / snr_db")


def refmodes_phase(card: str) -> tuple[dict, dict, dict, dict, dict, dict]:
    """Path 8: the reference-exact conformance modes.  (a) the flagship
    grant through ``pusch.process`` with the reference estimator (K1 and
    K8 once, K1 and K3 held against their plain versions on the call's
    inputs); (b) the whole conformance chain, no kernel; (c) the
    BLER-parity harness on three manifest rows (K2 once a chunk, held
    against its plain version on one chunk's buffers); (d) du_low_sim
    with the conformance profile.  Returns the launch counts of (a), (b),
    (c) and (d), the kernels' largest differences and their device times
    and bounds on these inputs."""
    import contextlib
    import io
    import json as json_mod
    import re

    import torch

    from srsran_project_tpu_torch.apps import bler_parity, du_low_sim
    from srsran_project_tpu_torch.models import cell
    from srsran_project_tpu_torch.ops import equalizer
    from srsran_project_tpu_torch.ops.ldpc import decoder
    from srsran_project_tpu_torch.ops.modulation import Modulation
    from srsran_project_tpu_torch.phy import pusch, sch as sch_mod
    from srsran_project_tpu_torch.phy.allocation import Allocation
    from srsran_project_tpu_torch.ran import tbs as tbs_mod

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 80)
    errs, times = {}, {}

    # (a) The flagship grant (273 PRB, 4x4, 256QAM r 948/1024, DM-RS on
    # symbol 2) with the reference estimator: K3 weights, K1 decode.
    pc = dataclasses.replace(cell.CellConfig().pusch_cfg, estimator="reference")
    tb, rx = p8_received(pc, rng, dev)
    rnti = torch.tensor([P8_RNTI], device=dev)
    torch.cuda.synchronize()
    reset_counts()
    out = pusch.process(rx, rnti, pc)
    torch.cuda.synchronize()
    counts_a = read_counts()
    expect_counts("refmodes (a)", counts_a, {"decode_dematch": 1, "mmse_equalize": 1})
    p8_check("(a) flagship, estimator=reference", out, tb)
    _gflat, h, nv = pusch._estimate_stage(rx, pc)
    hs = h.transpose(1, 2)
    errs["mmse_weights_4x4"], w_k, ev_k = check_k3_on(hs, nv, "refmodes (a) K3")
    llr_i8 = pusch._front_end(rx, rnti, pc)[0]
    bits, iters = sch_mod._fused_decode(llr_i8, pc.sch, pc.nof_ldpc_iterations, True)
    errs["decode_dematch"] = check_k1_batch(llr_i8, bits, iters, pc, "refmodes (a)")
    seg = pc.sch.seg
    e_groups = sch_mod._e_groups(pc.sch.cb_e_bits)
    k1_plan = decoder.dematch_decode_plan(seg.base_graph, seg.lifting_size,
                                          seg.nof_payload_bits_per_cb, e_groups[0][2],
                                          pc.sch.rv, pc.sch.qm,
                                          pc.sch.n_cb or seg.full_codeword_bits)
    times["decode_dematch"] = (
        kernel_ms(lambda: sch_mod._fused_decode(llr_i8, pc.sch, 6, True)),
        ldpc_bound(k1_plan, iters, (llr_i8,), (bits, iters))[0])
    # K3's bound as in check_k3: about 1.5k float32 operations a subcarrier.
    times["mmse_weights_4x4"] = (kernel_ms(lambda: equalizer.mmse_weights_4x4(hs, nv)),
                                 bound(nbytes(hs, nv, w_k, ev_k),
                                       1500.0 * hs.shape[0] * hs.shape[1])[0])
    report_call(card, "refmodes (a) pusch.process, 273 PRB 4x4 256QAM, estimator=reference",
                lambda: pusch.process(rx, rnti, pc))
    report_call(card, "refmodes (a) estimate stage, estimator=reference",
                lambda: pusch._estimate_stage(rx, pc))
    fast = dataclasses.replace(pc, estimator="fast")
    report_call(card, "refmodes (a) estimate stage, estimator=fast (same grid)",
                lambda: pusch._estimate_stage(rx, fast))

    # (b) The conformance chain: no kernel of the port runs.
    counts_b = {}
    for name, (layers, ports, eq) in P8_CHAIN.items():
        rate = 567.0 / 1024.0
        alloc = Allocation(rb_start=0, rb_count=273, sym_start=0, sym_count=14,
                           dmrs_symbols=(2, 11))
        cfg = pusch.PuschConfig(
            tbs=tbs_mod.calculate_tbs(273, 14, 24, rate, 6, layers), target_code_rate=rate,
            modulation=Modulation.QAM64, alloc=alloc, nof_layers=layers, nof_rx_ports=ports,
            nof_grid_sc=273 * 12, estimator="reference", equalizer=eq, demapper="reference",
            ldpc_decoder="reference_i8", ldpc_early_stop=False)
        tb_b, rx_b = p8_received(cfg, rng, dev)
        torch.cuda.synchronize()
        reset_counts()
        out = pusch.process(rx_b, rnti, cfg)
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"refmodes ({name})", counts, {})
        p8_check(f"({name}) conformance chain {layers} layer(s) x {ports} ports, {eq}, "
                 f"C={cfg.sch.seg.nof_codeblocks}", out, tb_b)
        for k, v in counts.items():
            counts_b[k] = counts_b.get(k, 0) + v
        report_call(card, f"refmodes ({name}) pusch.process, conformance chain {layers}x{ports}",
                    lambda c=cfg, r=rx_b: pusch.process(r, rnti, c))
        llr_b = pusch._front_end(rx_b, rnti, cfg)[0]
        buf = sch_mod._dematch_stage(llr_b, None, cfg.sch)
        report_call(card, f"refmodes ({name}) decode_i8, {buf.shape[-2]} codeblocks, 6 iterations",
                    lambda b=buf, c=cfg: sch_mod._decode_i8_stage(b, c.sch, 6, False))

    # (c) The BLER-parity harness: K2 once a chunk.
    manifest = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                            "bler_parity", "manifest.json")
    with open(manifest) as f:
        cases = json_mod.load(f)
    counts_c = {}
    for row, slots in P8_BLER:
        case = cases[row]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = bler_parity.run_case(case, slots, chunk=P8_CHUNK, parity_kernels=True,
                                   device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        expect_counts(f"refmodes (c) row {row}", counts, {"decode": -(-slots // P8_CHUNK)})
        lim = bler_parity.bler_bound(case, slots)
        print(f"# [{card}] refmodes (c) row {row} {case['profile']} {case['sinr_db']} dB "
              f"MCS {case['mcs']} rank {case.get('layers', 1)}: CRC BLER {res['crc_bler']:.4f} "
              f"(reference {case['crc_bler']:.4f}, bound +-{lim:.4f}), data BLER "
              f"{res['data_bler']:.4f}, iterations {res['iter_min']}/{res['iter_mean']:.3f}/"
              f"{res['iter_max']} (reference mean {case['iter_mean']:.3f}); {slots} slots in "
              f"{wall:.3f} s")
        if not abs(res["crc_bler"] - case["crc_bler"]) <= lim:
            fail(f"refmodes (c) row {row}: CRC BLER {res['crc_bler']} outside "
                 f"{case['crc_bler']} +- {lim:.4f}")
        for k, v in counts.items():
            counts_c[k] = counts_c.get(k, 0) + v
    # K2 on one chunk of row 0's buffers.
    cfg0, ch0 = bler_parity.case_config(cases[0], True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 81)
    tb0 = torch.from_numpy(rng.integers(0, 2, size=(P8_CHUNK, cfg0.tbs), dtype=np.uint8)).to(dev)
    buf0 = bler_parity.received_buffers(tb0, cfg0, ch0, gen)
    s0 = cfg0.sch.seg
    errs["decode"] = check_k2(buf0, s0.base_graph, s0.lifting_size, cfg0.sch.n_cb,
                              "refmodes (c) row 0 chunk")
    kargs = (s0.base_graph, s0.lifting_size, 6, True, True, cfg0.sch.n_cb)
    bits0, _, its0 = decoder.decode(buf0, *kargs)
    plan0 = decoder.decode_plan(s0.base_graph, s0.lifting_size, buf0.shape[-1], cfg0.sch.n_cb)
    times["decode"] = (kernel_ms(lambda: decoder.decode(buf0, *kargs)),
                       ldpc_bound(plan0, its0, (buf0,), (bits0, its0))[0])
    report_call(card, f"refmodes (c) one chunk of row 0 ({P8_CHUNK} slots)",
                lambda: bler_parity.run_case(cases[0], P8_CHUNK, chunk=P8_CHUNK,
                                             parity_kernels=True, device=DEVICE))

    # (d) du_low_sim with the conformance profile: no kernel.
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stderr(buf):
        rc = du_low_sim.main(list(P8_APP))
    torch.cuda.synchronize()
    counts_d = read_counts()
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"# du_low_sim {' '.join(P8_APP)}: {line.lstrip('# ')}")
    m = re.search(r"# (\d+) slots in ([0-9.]+)s \(([0-9.]+) slot-pairs/s\), BLER=([0-9.]+)", text)
    if m is None:
        fail(f"du_low_sim {P8_APP}: no summary line (rc {rc})")
    bler = float(m.group(4))
    print(f"# [{card}] refmodes (d) du_low_sim conformance profile: rc {rc}, BLER {bler:.3f}, "
          f"{m.group(3)} slot-pairs/s")
    if rc != 0 or not bler < 1.0:
        fail(f"refmodes (d) du_low_sim: rc {rc}, BLER {bler}, want rc 0 and BLER < 1")
    expect_counts("refmodes (d)", counts_d, {})

    def one_slot():
        with contextlib.redirect_stderr(io.StringIO()):
            du_low_sim.main([*P8_APP[:2], "--slots", "1"])

    report_call(card, "refmodes (d) du_low_sim, one slot (DL, channel and UL)", one_slot)
    return counts_a, counts_b, counts_c, counts_d, errs, times


# ---- the DU-low's scheduler mode ---------------------------------------------

# (a) The app's scheduler mode on its default cell (273 PRB, 30 kHz, 4
# ports; 1 layer, as the app sets it), TDL-A at 25 dB: 8 UEs, 7D1S2U, PF
# with QoS, the common channels, a periodic report every 10 slots.
P9_APP_TDD = ["--ues", "8", "--tdd", "--policy", "qos", "--common", "--slots", "40",
              "--metrics-json", "--metrics-interval-slots", "10"]
# The common-channel occasions CommonSchedulingConfig's defaults give in 40
# slots (SSB and CSI-RS every 40 at 0 and 10, SIB1 at 1, PRACH at 19 and 39).
P9_COMMON = {"ssb": 1, "sib1": 1, "csi_rs": 1, "prach": 2, "paging": 0, "cbs": 0,
             "fallback": 0, "si": 0}
# (b) The multi-cell mode: two cells of 4 UEs each, FDD.
P9_APP_CELLS = ["--ues", "8", "--cells", "2", "--slots", "20"]
# (c) RoundRobinScheduler driven directly: 4 layers on 4 ports, MCS 20 of
# the 64QAM table, every allocator and loop that needs no CSI report, 20
# FDD slots through SlotPipeline(depth=2); the DL grid loops back through
# one random unitary 4x4 channel and AWGN at 30 dB per RE and port.
P9_RNTI = 0x4C01
P9_UES = 8
P9_MCS = 20
P9_SLOTS = 20
P9_SNR_DB = 30.0
P9_SLOT_S = 500e-6


def p9_slot(i: int):
    from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing
    from srsran_project_tpu_torch.ran.slot_point import SlotPoint

    return SlotPoint.from_sfn_slot(SubcarrierSpacing.KHZ30, i // 20, i % 20)


def p9_expected(pdus) -> dict:
    """The kernel launches ``UpperPhy.process_ul_tti`` makes for a request
    of these compact grants: two or more whose window starts at their
    crb_start go through ``process_slot``, K2 once per code group and K8
    once per config group of MMSE on 4 ports at 1, 2 or 4 layers; every
    other grant through ``pusch.process``: K1 (K2 where its geometry
    repeats) and K8 for such a grant.  K3 never."""
    from srsran_project_tpu_torch.phy import ul_slot

    want = {"decode_dematch": 0, "decode": 0, "mmse_equalize": 0}
    batch = [p for p in pdus if p.config.alloc.crb_start == p.first_rb]
    if len(batch) >= 2:
        groups = ul_slot._config_groups(batch)
        codes = {(c.sch.seg.base_graph, c.sch.seg.lifting_size, c.nof_ldpc_iterations,
                  c.ldpc_early_stop, c.sch.n_cb) for c in groups}
        want["decode"] += len(codes)
        want["mmse_equalize"] += k8_launches(groups)
    for p in pdus:
        if len(batch) < 2 or p not in batch:
            want["decode_dematch" if _fused_ok(p.config) else "decode"] += 1
            want["mmse_equalize"] += k8_launches([p.config])
    return want


class UlTtiRecorder:
    """While active, observes every ``UpperPhy.process_ul_tti`` call: its
    request, received grid, the UlSlotPdus of its compact grants (HARQ
    buffers as the pool held them before the call), its results and the
    kernel launches it made (counter differences; nothing is reset)."""

    def __enter__(self):
        from srsran_project_tpu_torch.phy.upper_phy import UpperPhy

        self.calls = []
        self._orig = orig = UpperPhy.process_ul_tti

        def observed(phy, request, rx_grid, prach_fd=None):
            pdus = p6_slot_pdus(request, phy.harq_pool)
            before = read_counts()
            res = orig(phy, request, rx_grid, prach_fd=prach_fd)
            after = read_counts()
            self.calls.append(dict(req=request, grid=rx_grid, pdus=pdus, res=res,
                                   launches={k: after[k] - before[k] for k in after}))
            return res

        UpperPhy.process_ul_tti = observed
        return self

    def __exit__(self, *exc):
        from srsran_project_tpu_torch.phy.upper_phy import UpperPhy

        UpperPhy.process_ul_tti = self._orig
        return False


def p9_check_calls(what: str, calls: list, total: dict, expected=p9_expected) -> None:
    """Every recorded UL_TTI call made the launches its grants imply
    (``expected``), K2 on every call of two or more grants; and they add
    up to the path's counts."""
    summed = {k: 0 for k in total}
    for n, call in enumerate(calls):
        want = expected(call["pdus"])
        got = {k: v for k, v in call["launches"].items() if v}
        if got != {k: v for k, v in want.items() if v}:
            fail(f"{what} UL_TTI call {n} (slot {call['req'].slot.count}, "
                 f"{len(call['pdus'])} grants): kernel launches {got}, want {want}")
        if len(call["pdus"]) >= 2 and not got.get("decode"):
            fail(f"{what} UL_TTI call {n}: {len(call['pdus'])} grants and no K2 launch")
        for k, v in call["launches"].items():
            summed[k] += v
    if summed != total:
        fail(f"{what}: the calls' launches {summed} do not add up to the path's {total}")
    multi = sum(len(c["pdus"]) >= 2 for c in calls)
    print(f"# {what}: {len(calls)} UL_TTI calls, {multi} with two or more grants, each with "
          f"the launches its grants imply")


def p9_run_app(argv) -> tuple[int, str, str, dict, list]:
    """du_low_sim.main(argv) in-process with its stdout and stderr
    captured and its UL_TTI calls recorded; returns (rc, stdout, stderr,
    the launch counts of the run, the calls)."""
    import contextlib
    import io

    import torch

    from srsran_project_tpu_torch.apps import du_low_sim

    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with UlTtiRecorder() as rec, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = du_low_sim.main(list(argv))
    torch.cuda.synchronize()
    counts = read_counts()
    for line in err.getvalue().splitlines() + out.getvalue().splitlines():
        print(f"# du_low_sim {' '.join(argv)}: {line.lstrip('# ')}")
    return rc, out.getvalue(), err.getvalue(), counts, rec.calls


def p9_report_ul_call(card: str, name: str, call) -> None:
    """Time and profile one recorded UL_TTI request again on a new
    UpperPhy (retransmissions decode without a pooled buffer)."""
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig

    grid = call["grid"]
    phy = UpperPhy(UpperPhyConfig(nof_ports=grid.shape[0], nof_grid_sc=grid.shape[2],
                                  device=DEVICE))
    report_call(card, name, lambda: phy.process_ul_tti(call["req"], grid))


def sched_app_phase(card: str) -> tuple[dict, dict, float]:
    """Path 9 (a) and (b): du_low_sim's scheduler mode (TDD, QoS, common
    channels, periodic reports) and its multi-cell mode in-process on the
    app's default cell.  Returns the launch counts of (a) and (b) and K2's
    largest a-posteriori difference on (a)'s first multi-grant call."""
    import ast
    import re

    # (a)
    rc, out, err, counts_a, calls = p9_run_app(P9_APP_TDD)
    m = re.search(r"# scheduler mode: (\d+) UEs, (\d+) grants, (\d+) CRC OK", err)
    s = re.search(r"# (\d+) slots in ([0-9.]+)s, BLER=([0-9.]+)", err)
    c = re.search(r"# common channels: (\{.*\})", err)
    if m is None or s is None or c is None:
        fail(f"sched (a): summary lines missing (rc {rc})")
    grants, bler = int(m.group(2)), float(s.group(3))
    if rc != 0 or not bler < 1.0:
        fail(f"sched (a): rc {rc} with BLER {bler}, want rc 0 and BLER < 1")
    counters = ast.literal_eval(c.group(1))
    if counters != P9_COMMON:
        fail(f"sched (a): common-channel counters {counters}, want {P9_COMMON}")
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    periodic = [x for x in lines if x.get("type") == "periodic"]
    if [p["slot"] for p in periodic] != [10, 20, 30, 40] or len(lines) != 5:
        fail(f"sched (a): periodic reports at {[p['slot'] for p in periodic]} and "
             f"{len(lines)} JSON lines, want slots 10/20/30/40 and the metrics line")
    if any(len(p) != 2 + P9_UES for p in periodic):
        fail("sched (a): a periodic report does not cover the 8 UEs")
    if sum(len(x["res"].crc) for x in calls) != grants or len(calls) != 8:
        fail(f"sched (a): {len(calls)} UL_TTI calls with {grants} grants, want the 8 UL slots")
    if sum(len(x["res"].errors) for x in calls) != P9_COMMON["prach"]:
        fail("sched (a): want one error indication per PRACH occasion (no PRACH buffer)")
    p9_check_calls("sched (a)", calls, counts_a)
    first = next(x for x in calls if len(x["pdus"]) >= 2)
    k2_err, geometries = check_code_groups(first["grid"], first["pdus"], "sched (a) UL_TTI")
    slots = int(s.group(1))
    print(f"# [{card}] sched (a) du_low_sim {' '.join(P9_APP_TDD)}: rc {rc}, {grants} grants, "
          f"{m.group(3)} CRC OK, BLER {bler:.3f}, {1e3 * float(s.group(2)) / slots:.2f} ms a "
          f"slot (host clock, {slots} slots); K2 code groups {geometries}")
    p9_report_ul_call(card, f"sched (a) UL_TTI of {len(first['pdus'])} scheduled grants "
                      f"(slot {first['req'].slot.count})", first)

    # (b)
    rc, out, err, counts_b, calls = p9_run_app(P9_APP_CELLS)
    m = re.search(r"# multi-cell mode: (\d+) cells, (\d+) UEs, (\d+) grants, (\d+) CRC OK in "
                  r"([0-9.]+)s", err)
    cells = re.findall(r"# cell (\d+): (\{.*\})", err)
    if m is None or [int(cid) for cid, _ in cells] != [0, 1]:
        fail(f"sched (b): summary or per-cell lines missing (rc {rc})")
    grants, ok = int(m.group(3)), int(m.group(4))
    bler = 1.0 - ok / max(grants, 1)
    if rc != 0 or not bler < 1.0:
        fail(f"sched (b): rc {rc} with BLER {bler}")
    for cid, rep in cells:
        rep = ast.literal_eval(rep)
        if rep["nof_ul_grants"] != 4 * 20 or rep["nof_crc_ok"] + rep["nof_crc_nok"] != 4 * 20:
            fail(f"sched (b) cell {cid}: {rep}, want 80 UL grants and their CRCs")
    if len(calls) != 2 * 20:
        fail(f"sched (b): {len(calls)} UL_TTI calls, want one per cell and slot")
    p9_check_calls("sched (b)", calls, counts_b)
    print(f"# [{card}] sched (b) du_low_sim {' '.join(P9_APP_CELLS)}: rc {rc}, {grants} grants, "
          f"{ok} CRC OK, {1e3 * float(m.group(5)) / 20:.2f} ms a slot of both cells (host clock)")
    p9_report_ul_call(card, "sched (b) UL_TTI of one cell's 4 grants", calls[-1])
    return counts_a, counts_b, k2_err


def sched_pipeline_phase(card: str) -> tuple[dict, dict]:
    """Path 9 (c): the RoundRobinScheduler with PDCCH (DCI 1_0), PUCCH, SRS
    and TA loops on, 4 layers on 4 ports, driving ``UpperPhy`` through
    ``SlotPipeline(depth=2)`` for 20 FDD slots.  Every grant passes its
    CRC, every DL grant that got its PDCCH carries one DCI, which decodes
    back from the DL grid with its bits, and K2 and K3
    are held against their plain versions on one slot's own inputs.
    Returns the launch counts and the kernels' largest differences."""
    import torch

    from srsran_project_tpu_torch.l2sim.scheduler import RoundRobinScheduler, SchedulerConfig
    from srsran_project_tpu_torch.phy import pdcch
    from srsran_project_tpu_torch.phy.slot_pipeline import SlotPipeline
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig

    dev = torch.device(DEVICE)
    nof_sc = UL_NOF_PRB * 12
    # The PDCCH allocator's CORESET takes symbols 0 and 1: PDSCH and PUSCH
    # start at symbol 2, their DM-RS symbol.
    cfg = SchedulerConfig(nof_grid_sc=nof_sc, nof_rb=UL_NOF_PRB, sym_start=2,
                          max_ues_per_slot=4, nof_layers=4, nof_ports=UL_NOF_PORTS,
                          use_pdcch_alloc=True,
                          emit_dci=True, use_pucch_alloc=True, use_srs=True, use_ta_manager=True)

    def build():
        sched = RoundRobinScheduler(cfg)
        for i in range(P9_UES):
            sched.add_ue(P9_RNTI + i, mcs=P9_MCS)
        phy = UpperPhy(UpperPhyConfig(nof_ports=UL_NOF_PORTS, nof_grid_sc=nof_sc, device=DEVICE))
        seen = {}
        phy.add_tap(lambda event, _slot, payload: seen.__setitem__(event, payload))
        return sched, phy, seen

    rng = np.random.default_rng(SEED + 9)
    u = torch.from_numpy(_unit_rows(rng, UL_NOF_PORTS)).to(dev)  # (4, 4) unitary
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    sigma = math.sqrt(0.5 * 10 ** (-P9_SNR_DB / 10))

    def channel(grid):
        noise = torch.randn((2,) + tuple(grid.shape), generator=gen, device=dev) * sigma
        return torch.einsum("rp,psk->rsk", u, grid) + torch.complex(noise[0], noise[1])

    sched, phy, seen = build()
    pipe = SlotPipeline(phy, slot_duration_s=P9_SLOT_S, depth=2)
    nof_grants = nof_dl = nof_pdcch = nof_pucch = nof_srs = 0
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.monotonic()
    with UlTtiRecorder() as rec:
        for i in range(P9_SLOTS):
            dl, tx, ul, grants = sched.run_slot(p9_slot(i), rng)
            if [p.rnti for p in dl.pdcch] != [p.rnti for p in dl.pdsch]:
                fail(f"sched (c) slot {i}: PDCCH for {[p.rnti for p in dl.pdcch]}, PDSCH for "
                     f"{[p.rnti for p in dl.pdsch]}: want one DCI per DL grant")
            deadline = t0 + (i + 1) * P9_SLOT_S
            pipe.push_dl_slot(dl, tx, deadline)
            for p in dl.pdcch:  # every DCI back from the DL grid
                bits, ok = pdcch.receive(seen["dl_grid"][0], p.rnti, p.config)
                if not bool(ok) or not np.array_equal(bits.cpu().numpy(), p.payload):
                    fail(f"sched (c) slot {i}: the DCI of {p.rnti:#x} does not decode back")
            pipe.push_ul_slot(ul, channel(seen["dl_grid"]), deadline)
            res = seen["ul_results"]
            sched.handle_results(res)
            bad = [(c.rnti, c.harq_id) for c in res.crc if not c.tb_crc_ok]
            if bad or len(res.crc) != len(grants):
                fail(f"sched (c) slot {i}: CRC failed for {bad} of {len(res.crc)} grants")
            nof_grants += len(grants)
            nof_dl += len(dl.pdsch)
            nof_pdcch += len(dl.pdcch)
            nof_pucch += len(ul.pucch)
            nof_srs += len(ul.srs)
        pipe.flush()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    p9_check_calls("sched (c)", rec.calls, counts)
    if min(nof_pucch, nof_srs, nof_grants) == 0:
        fail(f"sched (c): {nof_grants} grants, {nof_pucch} PUCCH, {nof_srs} SRS PDUs")
    rep = pipe.report()
    print(f"# [{card}] sched (c) RoundRobinScheduler + SlotPipeline(depth=2): {P9_SLOTS} slots, "
          f"{nof_dl} DL grants with {nof_pdcch} DCIs ({sched.nof_pdcch_blocked} PDCCH "
          f"allocations blocked), {nof_grants} UL grants all CRC OK, {nof_pucch} PUCCH and "
          f"{nof_srs} SRS PDUs; {1e3 * wall / P9_SLOTS:.2f} ms a slot (host clock); pipeline "
          f"{rep['slots']} slots, late ratio {rep['late_ratio']:.3f} against "
          f"{P9_SLOT_S * 1e3:.1f} ms, mean lateness {rep['mean_lateness_us']:.0f} us")

    # K2 and K3 against their plain versions on one multi-grant slot's inputs.
    call = next(c for c in rec.calls if len(c["pdus"]) >= 2)
    errs = {}
    errs["decode"], geometries = check_code_groups(call["grid"], call["pdus"], "sched (c)")
    errs["mmse_weights_4x4"] = check_k3_group(call["grid"], call["pdus"], "sched (c) K3")
    print(f"# sched (c): K2 code groups {geometries} of slot {call['req'].slot.count}")

    # One slot (DL_TTI, channel, UL_TTI) again on a new UpperPhy.
    dl, tx, ul, _ = sched.run_slot(p9_slot(P9_SLOTS), rng)
    timing = UpperPhy(UpperPhyConfig(nof_ports=UL_NOF_PORTS, nof_grid_sc=nof_sc, device=DEVICE))
    report_call(card, f"sched (c) one slot: DL_TTI of {len(dl.pdsch)} PDSCH + "
                f"{len(dl.pdcch)} PDCCH, channel, UL_TTI of {len(ul.pusch)} PUSCH + "
                f"{len(ul.pucch)} PUCCH + {len(ul.srs)} SRS",
                lambda: timing.process_ul_tti(ul, channel(timing.process_dl_tti(dl, tx))))
    return counts, errs


# ---- initial access and the MAC's remaining stages ------------------------------

# Path 10 (a): 4-step random access into connected data, on the app's
# default cell (273 PRB, 30 kHz, 4 RX ports).  The data scheduler keeps the
# top RA band (12 PRB) free: Msg2 goes there, and Msg3 on its first 2 PRB
# (QPSK, 72 bits: a CCCH48 subPDU and padding).  The three connected UEs
# (4 layers, MCS 20, PDCCH allocation and DCI 1_0) take one grant a slot
# in turn, the whole data band, and share a measurement gap of 8 slots
# every 80 (counts 144-151): Msg3's UL_TTI carries it alone, and the
# fallback grants never move the data grants' PRBs.  One UE a slot keeps
# every DL and UL DCI clear of CCE blocking: a UL DCI blocked leaves a TB
# sent on the DL only, which the scheduler later retransmits on the UL at
# rv 2 with no first transmission to combine (ROADMAP Q3).
# Slot counts 136-164 (SFN 6 slot 16 to SFN 8 slot 4) hold a PRACH
# occasion at 139 (and a noise-only one at 159), the paged UE's PO at 140,
# CSI-RS at 148 and 164, the SSB and the SI window at 160.
P10_A = dict(nof_rb=273, ports=4, layers=4, ra_prbs=12, ues=3, mcs=20, srate_hz=122.88e6)
P10_RNTI = 0x4D01
P10_START, P10_END = 136, 164
P10_GAP = dict(mgrp_ms=40, mgl_ms=4.0, gap_offset_ms=32)
P10_PREAMBLE = 23
P10_ZCZ = 8
P10_DELAY_S = 25e-6  # 32 bins of the detector's 1024-point profile: TA command 2
P10_MSG3_DELAY = 4  # slots from the RAR to Msg3
P10_MSG3_PRBS = 2
P10_MSG3_TBS = 72
P10_RAR_TBS = 128
P10_IDENTITY = bytes.fromhex("5a1e0c3f9b27")  # the UE's 48-bit CCCH identity
P10_RRC_SETUP = bytes(range(0x20, 0x20 + 24))
P10_RRC_SRB1 = bytes(range(0x60, 0x60 + 16))
P10_SIB2 = b"SIB2"
P10_PAGED = 7  # UE_ID paged: PF at SFN mod 8 = 7, PO slot 0
P10_SNR_DB = 30.0
P10_COUNTERS = {"ssb": 1, "sib1": 0, "paging": 1, "csi_rs": 2, "prach": 2, "cbs": 0,
                "fallback": 3, "si": 1}
# (b) RAN slicing: two slices of 4 UEs each (4 layers, MCS 20), 10 FDD
# slots, slice 2's minimum raised to 50 % after slot 5.
P10_SLICES = (dict(slice_id=1, min_ratio=0.3, max_ratio=0.7, policy="rr", sd=0),
              dict(slice_id=2, min_ratio=0.3, max_ratio=0.7, policy="qos", sd=1))
P10_SLICE_SLOTS = 10
P10_POLICY_AFTER = 5
P10_POLICY = {"members": [{"sst": 1, "sd": 1}], "min_ratio": 50, "max_ratio": 70}
P10_QUOTAS = ({1: 137, 2: 136}, {1: 109, 2: 164})  # before and after the policy


def p10_modules():
    """The port's modules path 10 runs, as one namespace (the CPU tests
    build the same namespace of the JAX package's)."""
    import types

    from srsran_project_tpu_torch.fapi import bufferer, messages
    from srsran_project_tpu_torch.l2 import mac_pdu
    from srsran_project_tpu_torch.l2sim import (common_scheduling, fallback, ra, scheduler,
                                                si_paging, slicing, ue_context_loops)
    from srsran_project_tpu_torch.ops.modulation import Modulation
    from srsran_project_tpu_torch.phy import allocation, prach, pusch, upper_phy
    from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing
    from srsran_project_tpu_torch.ran.slot_point import SlotPoint

    return types.SimpleNamespace(
        fapi=messages, buf=bufferer, mac=mac_pdu, cs=common_scheduling, fb=fallback, ra=ra,
        sched=scheduler, sp=si_paging, slicing=slicing, ucl=ue_context_loops, prach=prach,
        pusch=pusch, alloc=allocation, Modulation=Modulation, UpperPhy=upper_phy.UpperPhy,
        UpperPhyConfig=upper_phy.UpperPhyConfig, Slot=SlotPoint, Scs=SubcarrierSpacing)


def p10_slot(m, n: int):
    return m.Slot.from_sfn_slot(m.Scs.KHZ30, (n // 20) % 1024, n % 20)


class AccessCell:
    """The gNB of path 10 (a) over the modules of namespace ``m``: a
    ``CellScheduler`` with every stage (the data scheduler, the fallback
    stage on the data scheduler's CORESET, the SI, paging and CSI-RS
    engines), the ``RaManager`` with the RA band's Msg2 and Msg3, and the
    FAPI boundary: each slot's DL_TTI, TX_Data and UL_TTI go through a
    ``MessageBufferer`` two slots ahead to ``phy`` (an ``UpperPhy``)."""

    def __init__(self, m, geo: dict, phy):
        self.m, self.geo, self.phy = m, geo, phy
        nof_rb, sc = geo["nof_rb"], geo["nof_rb"] * 12
        self.ra_rb0 = nof_rb - geo["ra_prbs"]
        self.ue = m.sched.RoundRobinScheduler(m.sched.SchedulerConfig(
            nof_grid_sc=sc, nof_rb=self.ra_rb0, sym_start=2, max_ues_per_slot=1,
            nof_layers=geo["layers"], nof_ports=geo["ports"], use_pdcch_alloc=True,
            emit_dci=True, meas_gap=m.ucl.MeasGapConfig(**P10_GAP)))
        for i in range(geo["ues"]):
            self.ue.add_ue(P10_RNTI + i, mcs=geo["mcs"])
        self.fallback = m.fb.FallbackScheduler(self.ue.coresets, self.ue.search_spaces,
                                               common_ss_id=2, nof_rb=nof_rb)
        self.paging = m.sp.PagingOccasionScheduler(m.sp.PagingConfig(
            drx_cycle_frames=8, nof_pf_per_drx=8, nof_po_per_pf=1))
        self.paging.page(P10_PAGED, {"domain": "ps"})
        self.cell = m.cs.CellScheduler(
            m.cs.CommonSchedulingConfig(
                nof_rb=nof_rb, nof_grid_sc=sc, sib1_period_slots=640, sib1_slot_offset=1,
                prach_config=m.prach.PrachConfig(l_ra=839, zero_correlation_zone=P10_ZCZ,
                                                 nof_rx_ports=geo["ports"])),
            self.ue, fallback=self.fallback,
            si_scheduler=m.sp.SiMessageScheduler(m.sp.SiSchedulerConfig(
                si_window_len_slots=5,
                messages=(m.sp.SiMessageConfig(period_radio_frames=8, payload=P10_SIB2),))),
            paging_po=self.paging,
            csi_rs_scheduler=m.sp.CsiRsScheduler([m.sp.CsiRsResourceConfig(
                period_slots=16, offset_slots=4, rb_count=nof_rb)]))
        self.ra = m.ra.RaManager()
        self.inbox: dict[int, dict] = {}
        self.bufferer = m.buf.MessageBufferer(self._deliver, l2_nof_slots_ahead=2)
        self.msg3_due: dict[int, list] = {}
        self.fb_harq: dict[int, tuple] = {}  # slot -> (rnti, HARQ id) of its fallback grant
        self.ul_tbs: dict[int, list] = {}  # slot -> each PUSCH's TB (None for Msg3)
        self.msg3_bits: dict[int, np.ndarray] = {}  # slot -> the Msg3 TB received

    def _deliver(self, msg) -> None:
        self.inbox.setdefault(msg.slot.count, {})[type(msg).__name__] = msg

    def msg3_config(self):
        m = self.m
        return m.pusch.PuschConfig(
            tbs=P10_MSG3_TBS, target_code_rate=0.25, modulation=m.Modulation.QPSK,
            alloc=m.alloc.Allocation(rb_start=0, rb_count=P10_MSG3_PRBS, sym_start=2,
                                     sym_count=12, dmrs_symbols=(2,), crb_start=self.ra_rb0),
            nof_layers=1, nof_rx_ports=self.geo["ports"], nof_grid_symbols=14,
            nof_grid_sc=P10_MSG3_PRBS * 12)

    def schedule(self, count: int, rng) -> tuple:
        """The MAC for slot ``count``: the cell scheduler's requests, Msg2
        in the RA band on the first slot without a broadcast after a RACH
        indication, Msg3's PUSCH P10_MSG3_DELAY slots after its RAR; the
        three messages handed to the bufferer.  Returns them and the
        grants."""
        m = self.m
        slot = p10_slot(m, count)
        dl, tx, ul, grants = self.cell.run_slot(slot, rng)
        pdsch, payloads, pusch = list(dl.pdsch), list(tx.payloads), list(ul.pusch)
        tbs = [self.ue.ues[p.rnti].harqs[p.harq_id].tb.copy() for p in pusch]
        if not any(p.rnti in (m.cs.SI_RNTI, m.cs.P_RNTI, m.cs.CBS_RNTI) for p in pdsch):
            bits = self.ra.build_rar_tb(count, P10_RAR_TBS)
            if bits is not None:
                cfg, _ = m.cs._bcast_pdsch(self.geo["ra_prbs"], self.geo["ra_prbs"] * 12,
                                           np.packbits(bits).tobytes())
                pdsch.append(m.fapi.DlPdschPdu(cfg, self.ra.ra_rnti,
                                               np.eye(1, dtype=np.complex64), len(payloads),
                                               first_rb=self.ra_rb0))
                payloads.append(bits)
                self.msg3_due[count + P10_MSG3_DELAY] = [
                    c.tc_rnti for c in self.ra.pending.values() if c.rar_slot == count]
        for tc_rnti in self.msg3_due.pop(count, []):
            pusch.append(m.fapi.UlPuschPdu(self.msg3_config(), tc_rnti, harq_id=0,
                                           first_rb=self.ra_rb0))
            tbs.append(None)
        for rnti, ue in self.fallback.ues.items():
            for p in ue.queue:
                if p.awaiting_ack and any(q.rnti == rnti for q in pdsch):
                    self.fb_harq[count] = (rnti, p.harq_id)
        dl = m.fapi.DlTtiRequest(slot=slot, pdsch=pdsch, pdcch=dl.pdcch, ssb=dl.ssb,
                                 csi_rs=dl.csi_rs)
        tx = m.fapi.TxDataRequest(slot=slot, payloads=payloads)
        ul = m.fapi.UlTtiRequest(slot=slot, pusch=pusch, pucch=ul.pucch, prach=ul.prach,
                                 srs=ul.srs)
        for msg in (dl, tx, ul):
            if not self.bufferer.handle_message(msg):
                fail(f"access slot {count}: the bufferer refused {type(msg).__name__}")
        self.ul_tbs[count] = tbs
        return dl, tx, ul, grants

    def downlink(self, count: int):
        """Slot indication ``count``: the bufferer forwards the slot's
        requests; the DL_TTI and TX_Data through ``process_dl_tti``."""
        self.bufferer.on_slot_indication(p10_slot(self.m, count))
        box = self.inbox[count]
        if set(box) != {"DlTtiRequest", "TxDataRequest", "UlTtiRequest"}:
            fail(f"access slot {count}: the bufferer forwarded {sorted(box)}")
        return self.phy.process_dl_tti(box["DlTtiRequest"], box["TxDataRequest"])

    def uplink(self, count: int, grid, prach_fd):
        """The slot's UL_TTI through ``process_ul_tti``; the MAC takes its
        indications: RACH to the RaManager, a CRC-clean Msg3 to
        ``handle_msg3`` (its UE into the fallback stage with its ConRes
        identity and RRC Setup on SRB0), the data CRCs to the scheduler."""
        box = self.inbox.pop(count)
        res = self.phy.process_ul_tti(box["UlTtiRequest"], grid, prach_fd=prach_fd)
        for r in res.rach:
            self.ra.handle_rach_indication(count, r)
        ok = {(c.rnti, c.harq_id): c.tb_crc_ok for c in res.crc}
        for rx in res.rx_data:
            if rx.rnti in self.ue.ues or not ok[(rx.rnti, rx.harq_id)]:
                continue
            bits = np.asarray(rx.payload).astype(np.uint8)
            ctx = self.ra.handle_msg3(count, bits)
            if ctx is None:
                fail(f"access slot {count}: Msg3 of {rx.rnti:#x} matched no RA context")
            self.msg3_bits[count] = bits
            (ce,) = self.ra.build_msg4_subpdus(ctx)
            self.fallback.add_ue(ctx.tc_rnti, conres_id=ce.payload)
            self.fallback.handle_dl_buffer_state(ctx.tc_rnti, self.m.mac.encode_mac_pdu(
                [self.m.mac.MacSubPdu(int(self.m.mac.DlLcid.CCCH), P10_RRC_SETUP)]),
                is_srb0=True)
        self.ue.handle_results(res)
        return res

    def feedback(self, count: int, ack: bool) -> None:
        """The UE's HARQ feedback on slot ``count``'s fallback grant; an
        ACK moves the UE on: SRB1 after SRB0, then out of fallback and into
        the data scheduler."""
        rnti, harq_id = self.fb_harq.pop(count)
        queue = self.fallback.ues[rnti].queue
        srb0 = next(p.is_srb0 for p in queue if p.harq_id == harq_id)
        self.fallback.handle_ack(rnti, harq_id, ack)
        if ack and srb0:
            self.fallback.handle_dl_buffer_state(rnti, self.m.mac.encode_mac_pdu(
                [self.m.mac.MacSubPdu(1, P10_RRC_SRB1)]))
        elif ack:
            self.fallback.exit_fallback(rnti)
            self.ue.add_ue(rnti, mcs=self.geo["mcs"])


def p10_rx_config(cfg, ports: int):
    """The UE side's receiver of a PDSCH config: the PUSCH twin of its
    fields (the PDSCH and PUSCH chains share coding, scrambling and DM-RS)."""
    from srsran_project_tpu_torch.phy import pusch

    shared = ("tbs", "target_code_rate", "modulation", "alloc", "nof_layers",
              "nof_grid_symbols", "nof_grid_sc", "n_id", "rv", "slot_in_frame",
              "dmrs_scrambling_id", "n_scid")
    return pusch.PuschConfig(nof_rx_ports=ports, **{f: getattr(cfg, f) for f in shared})


def p10_prach_fd(geo: dict, preamble, rng, device):
    """The PRACH occasion's (ports, 839) subcarriers through
    ``lower_phy.prach_demodulate``: format 0 at the RA band's first PRB,
    sampled at geo's rate and built on ``device`` as path 7 (a) builds it;
    ``preamble`` (index, delay in s) or None for noise alone, at 0 dB a
    subcarrier and port."""
    import torch

    from srsran_project_tpu_torch.ops import lower_phy
    from srsran_project_tpu_torch.phy import prach

    ports, srate = geo["ports"], geo["srate_hz"]
    p = lower_phy.prach_window_params("0", 30000, 1, 0, 0, srate, geo["nof_rb"] - geo["ra_prbs"],
                                      0, geo["nof_rb"], 839)
    dft, l_ra = p["dft_size"], p["l_ra"]
    bins = (p["k_offset"] + np.arange(l_ra)) % dft
    freq = np.where(bins >= dft // 2, bins - dft, bins) * (srate / dft)
    spec = torch.zeros((ports, dft), dtype=torch.complex64, device=device)
    if preamble is not None:
        index, tau = preamble
        g = (rng.standard_normal(ports) + 1j * rng.standard_normal(ports)) / np.sqrt(2)
        ramp = np.exp(-2j * np.pi * freq * tau) / np.sqrt(l_ra)
        y = prach.generate_preamble_ref("0", 0, index, P10_ZCZ, device=device)
        spec[:, torch.from_numpy(bins.astype(np.int64)).to(device)] += (
            torch.from_numpy(g.astype(np.complex64)).to(device)[:, None]
            * (y * torch.from_numpy(ramp.astype(np.complex64)).to(device))[None])
    body = (torch.fft.ifft(spec, dim=-1) * float(np.sqrt(dft))).repeat(1, p["nof_symbols"])
    sig = torch.cat([body[:, body.shape[-1] - p["cp_samples"]:], body], dim=-1)
    noise = rng.standard_normal((ports, sig.shape[-1], 2)).astype(np.float32) * np.sqrt(0.5)
    sig = sig + torch.view_as_complex(torch.from_numpy(noise)).to(device)
    return lower_phy.prach_demodulate(sig[..., p["sample_offset"]:], l_ra=l_ra, dft_size=dft,
                                      nof_symbols=p["nof_symbols"], cp_samples=p["cp_samples"],
                                      k_offset=p["k_offset"])


class AccessUe:
    """The UE side of path 10 (a), on the port's functions: the preamble
    at the first PRACH occasion, the RAR read from the RA-RNTI PDSCH, Msg3
    (a CCCH48 subPDU of its identity), and every TC-RNTI, SI-RNTI and
    P-RNTI PDSCH decoded from port 0 of the DL grid at P10_SNR_DB."""

    def __init__(self, m, geo: dict, device, rng):
        self.m, self.geo, self.device, self.rng = m, geo, device, rng
        self.tc_rnti = self.rar = self.msg3 = None
        self.decoded: list = []  # (slot, rnti, CRC, bytes) of every PDSCH read
        self.launches: dict = {}  # the kernel launches of its reads

    def decode(self, count: int, grid, pdu, data):
        import torch

        cfg = p10_rx_config(pdu.config, 1)
        sc0 = 12 * pdu.first_rb
        win = grid[0:1, :, sc0 : sc0 + cfg.nof_grid_sc]
        sigma = math.sqrt(0.5 * 10 ** (-P10_SNR_DB / 10))
        noise = self.rng.standard_normal((2,) + tuple(win.shape)).astype(np.float32) * sigma
        win = win + torch.complex(*torch.from_numpy(noise).to(self.device))
        before = read_counts()
        res = self.m.pusch.process(win[None], torch.tensor([pdu.rnti], device=self.device), cfg)
        for k, v in read_counts().items():
            self.launches[k] = self.launches.get(k, 0) + v - before[k]
        ok = bool(res["tb_crc_ok"][0])
        bits = res["tb_bits"][0].cpu().numpy()
        if ok and not np.array_equal(bits, np.asarray(data.payloads[pdu.tb_index])):
            fail(f"access slot {count}: PDSCH of {pdu.rnti:#x} CRC-clean with other bits")
        out = np.packbits(bits).tobytes()
        self.decoded.append((count, pdu.rnti, ok, out))
        return ok, out

    def downlink(self, count: int, box, grid, ra_rnti: int) -> dict:
        """Reads this slot's PDSCH for the RA-RNTI (while waiting for its
        RAR), its TC-RNTI and the broadcast RNTIs.  Returns {rnti: (CRC,
        bytes)} of what it read."""
        m = self.m
        seen = {}
        for pdu in box["DlTtiRequest"].pdsch:
            want = (pdu.rnti in (m.cs.SI_RNTI, m.cs.P_RNTI) or pdu.rnti == self.tc_rnti
                    or (pdu.rnti == ra_rnti and self.tc_rnti is None))
            if not want:
                continue
            ok, data = self.decode(count, grid, pdu, box["TxDataRequest"])
            seen[pdu.rnti] = (ok, data)
            if pdu.rnti == ra_rnti and ok:
                _backoff, grants = m.mac.decode_rar_pdu(data)
                mine = [g for g in grants if g.rapid == P10_PREAMBLE]
                if len(mine) == 1:
                    self.rar = (count, mine[0])
                    self.tc_rnti = mine[0].tc_rnti
                    pdu3 = m.mac.encode_mac_pdu(
                        [m.mac.MacSubPdu(int(m.mac.UlLcid.CCCH48), P10_IDENTITY)],
                        tb_size=P10_MSG3_TBS // 8, uplink=True)
                    self.msg3 = (count + P10_MSG3_DELAY,
                                 np.unpackbits(np.frombuffer(pdu3, np.uint8)))
        return seen

    def uplink(self, count: int, box, tbs, channel, gen):
        """The slot's received grid: every PUSCH's ``pusch.transmit`` (the
        data UEs' TBs, this UE's Msg3) at its first PRB, through the
        (ports x ports) channel, plus AWGN at P10_SNR_DB; and the PRACH
        buffer on an occasion (this UE's preamble until its RAR)."""
        import torch

        m, geo = self.m, self.geo
        req = box["UlTtiRequest"]
        tx = torch.zeros((geo["ports"], 14, geo["nof_rb"] * 12), dtype=torch.complex64,
                         device=self.device)
        for pdu, tb in zip(req.pusch, tbs):
            if tb is None:
                if self.msg3 is None or self.msg3[0] != count or pdu.rnti != self.tc_rnti:
                    fail(f"access slot {count}: a Msg3 grant the UE did not expect")
                tb = self.msg3[1]
            sub = m.pusch.transmit(torch.from_numpy(np.asarray(tb)).to(self.device),
                                   torch.tensor(pdu.rnti, device=self.device), pdu.config)
            sc0 = 12 * pdu.first_rb
            tx[:, :, sc0 : sc0 + sub.shape[-1]] += sub
        sigma = math.sqrt(0.5 * 10 ** (-P10_SNR_DB / 10))
        noise = torch.randn((2,) + tuple(tx.shape), generator=gen, device=self.device) * sigma
        grid = torch.einsum("rp,psk->rsk", channel, tx) + torch.complex(noise[0], noise[1])
        fd = None
        if req.prach:
            fd = p10_prach_fd(geo, None if self.tc_rnti else (P10_PREAMBLE, P10_DELAY_S),
                              self.rng, self.device)
        return grid, fd


def p10_access_run(cells, ue, channel, gen, on_slot) -> dict:
    """Path 10 (a)'s sequence: every cell in ``cells`` (one per package
    under test, the port's last) scheduled from its own numpy generator of
    one seed, two slots ahead of the bufferer; per slot the DL grids, the
    UE side on the last cell's, one received grid and PRACH buffer for
    all cells' UL_TTI, and the UE's HARQ feedback on its fallback grants
    (the first NACKed).  ``on_slot(count, boxes, dl_grids, results)``
    sees each slot.  Returns the UE's events."""
    rngs = [np.random.default_rng(SEED + 10) for _ in cells]
    for count in (P10_START, P10_START + 1):
        for c, r in zip(cells, rngs):
            c.schedule(count, r)
    events = dict(fallback=[], rach=None, msg3_slot=None)
    nacked = False
    for count in range(P10_START, P10_END + 1):
        dl_grids = [c.downlink(count) for c in cells]
        port = cells[-1]
        box = port.inbox[count]
        seen = ue.downlink(count, box, dl_grids[-1], port.ra.ra_rnti)
        boxes = [dict(c.inbox[count]) for c in cells]
        grid, fd = ue.uplink(count, box, port.ul_tbs[count], channel, gen)
        results = [c.uplink(count, grid, fd) for c in cells]
        if results[-1].rach:
            events["rach"] = (count, results[-1].rach)
        if count in port.msg3_bits:
            events["msg3_slot"] = count
        if count in port.fb_harq:
            ok = seen.get(ue.tc_rnti, (False, b""))[0]
            ack = ok and nacked
            nacked = True
            events["fallback"].append((count, ok, ack))
            for c in cells:
                c.feedback(count, ack)
        on_slot(count, boxes, dl_grids, results, seen)
        if count + 2 <= P10_END:
            for c, r in zip(cells, rngs):
                c.schedule(count + 2, r)
    return events


def access_phase(card: str) -> tuple[dict, dict]:
    """Path 10 (a) on the card: the sequence of ``p10_access_run`` through
    the port's ``UpperPhy`` at P10_A, with every check of the procedure,
    the common channels, the bufferer and the launches of each UL_TTI
    call; K1 (on Msg3's call and a connected UE's) and K3 (the connected
    UE's) against their plain versions on the calls' own inputs.  Returns
    the launch counts and the kernels' largest differences."""
    import torch

    m, geo, dev = p10_modules(), P10_A, torch.device(DEVICE)
    sc = geo["nof_rb"] * 12
    cell = AccessCell(m, geo, m.UpperPhy(m.UpperPhyConfig(nof_ports=geo["ports"],
                                                          nof_grid_sc=sc, device=DEVICE)))
    rng = np.random.default_rng(SEED + 10)
    ue = AccessUe(m, geo, dev, rng)
    channel = torch.from_numpy(_unit_rows(rng, geo["ports"])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    crc = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.monotonic()
    with UlTtiRecorder() as rec:
        events = p10_access_run([cell], ue, channel, gen, lambda count, boxes, grids, results,
                                seen: crc.extend((count, c.rnti, c.tb_crc_ok)
                                                 for c in results[-1].crc))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    nslots = P10_END - P10_START + 1
    p10_check_access(cell, ue, events, crc, nslots)
    # The UE side reads its PDSCH through pusch.process on the card too.
    p9_check_calls("access", rec.calls, {k: v - ue.launches.get(k, 0) for k, v in counts.items()})
    print(f"# access: the UE side's {len(ue.decoded)} PDSCH reads launched "
          f"{ {k: v for k, v in ue.launches.items() if v} }")
    print(f"# [{card}] access: {nslots} slots through MessageBufferer(2) and UpperPhy in "
          f"{wall:.2f} s, {1e3 * wall / nslots:.2f} ms a slot (host clock, the UE side's "
          f"decodes and transmits included)")

    msg3 = next(c for c in rec.calls if c["req"].slot.count == events["msg3_slot"])
    data = next(c for c in reversed(rec.calls) if c["req"].pusch
                and c["req"].pusch[0].config.nof_layers == 4)
    errs = {"decode_dematch": max(
        check_k1_grant(c["grid"], c["req"].pusch[0], f"access {what} (slot "
                       f"{c['req'].slot.count})")
        for what, c in (("Msg3", msg3), ("a connected UE's grant", data))),
        "mmse_weights_4x4": check_k3_group(data["grid"], data["pdus"], "access K3")}
    p9_report_ul_call(card, f"access UL_TTI of one connected UE's grant (slot "
                      f"{data['req'].slot.count})", data)
    p9_report_ul_call(card, f"access UL_TTI of Msg3 alone (slot {events['msg3_slot']})", msg3)
    return counts, errs


def p10_check_access(cell, ue, events, crc, nslots: int) -> None:
    """Path 10 (a)'s checks on the port's cell and UE side."""
    m = cell.m
    rach = events["rach"]
    if rach is None or rach[0] != 139 or [r.preamble_index for r in rach[1]] != [P10_PREAMBLE]:
        fail(f"access: RACH indications {rach}, want preamble {P10_PREAMBLE} at slot 139")
    want_ta = P10_DELAY_S * 1024 * 1250.0
    ta = rach[1][0].ta_samples
    if not abs(ta - want_ta) <= 1.5:
        fail(f"access: TA {ta} bins, want {want_ta:.1f}")
    (ctx,) = cell.ra.resolved
    slot_rar, grant = ue.rar
    if (grant.rapid, grant.tc_rnti, grant.ta) != (P10_PREAMBLE, ctx.tc_rnti, ctx.ta_cmd) or \
            ctx.ta_cmd != round(ta / 16):
        fail(f"access: RAR {grant} at slot {slot_rar}, want RAPID {P10_PREAMBLE}, TC-RNTI "
             f"{ctx.tc_rnti:#x} and TA command {ctx.ta_cmd} = round({ta} / 16)")
    if events["msg3_slot"] != slot_rar + P10_MSG3_DELAY or not np.array_equal(
            cell.msg3_bits[events["msg3_slot"]], ue.msg3[1]) or ctx.ccch != P10_IDENTITY:
        fail(f"access: Msg3 at {events['msg3_slot']}, CCCH {ctx.ccch!r}")
    fb = events["fallback"]
    if [(ok, ack) for _s, ok, ack in fb] != [(True, False), (True, True), (True, True)]:
        fail(f"access: fallback grants (slot, CRC, ACK) {fb}, want Msg4 NACKed once, its "
             f"retransmission and SRB1 ACKed")
    reads = {s: data for s, rnti, ok, data in ue.decoded if rnti == ctx.tc_rnti and ok}
    msg4, retx, srb1 = (reads[s] for s, _ok, _ack in fb)
    sub = m.mac.decode_mac_pdu(msg4[6:])
    if msg4[:6] != P10_IDENTITY or msg4 != retx or (sub[0].lcid, sub[0].payload) != (
            int(m.mac.DlLcid.CCCH), P10_RRC_SETUP):
        fail(f"access: Msg4 {msg4.hex()} (retransmission {retx.hex()}), want the ConRes "
             f"identity {P10_IDENTITY.hex()} and RRC Setup on CCCH")
    sub1 = m.mac.decode_mac_pdu(srb1)
    if (sub1[0].lcid, sub1[0].payload) != (1, P10_RRC_SRB1):
        fail(f"access: SRB1 {srb1.hex()}")
    new = [(s, ok) for s, rnti, ok in crc if rnti == ctx.tc_rnti and s > events["msg3_slot"]]
    bad = [(s, hex(r)) for s, r, ok in crc if not ok]
    if bad or len({s for s, _ok in new}) < 2 or ctx.tc_rnti not in cell.ue.ues:
        fail(f"access: CRC failures {bad}; the new UE's UL grants {new}")
    bcast = {rnti: (s, ok, data) for s, rnti, ok, data in ue.decoded
             if rnti in (m.cs.SI_RNTI, m.cs.P_RNTI)}
    si, pg = bcast.get(m.cs.SI_RNTI), bcast.get(m.cs.P_RNTI)
    if si is None or si[:2] != (160, True) or si[2] != P10_SIB2:
        fail(f"access: SI read {si}, want {P10_SIB2!r} at 160")
    if pg is None or pg[:2] != (140, True) or json.loads(pg[2]) != {
            "paging_records": [{"domain": "ps", "ue_paging_id": P10_PAGED}]}:
        fail(f"access: paging read {pg}, want UE {P10_PAGED} at 140")
    if cell.cell.counters != P10_COUNTERS:
        fail(f"access: counters {cell.cell.counters}, want {P10_COUNTERS}")
    st = cell.bufferer.stats
    if (st.nof_late, st.nof_too_early, st.nof_unsent_overwritten) != (0, 0, 0) or \
            st.nof_forwarded != 3 * nslots or st.nof_cached != 3 * nslots:
        fail(f"access: bufferer {st}, want {3 * nslots} cached and forwarded, none late")
    print(f"# access: RACH preamble {P10_PREAMBLE} at 139, TA {ta} bins; RAR at {slot_rar} "
          f"(TC-RNTI {ctx.tc_rnti:#x}, TA command {ctx.ta_cmd}); Msg3 CRC OK at "
          f"{events['msg3_slot']}; Msg4 (ConRes {msg4[:6].hex()}) at {fb[0][0]}, NACKed, its "
          f"retransmission at {fb[1][0]} and SRB1 at {fb[2][0]} ACKed; the UE connected with "
          f"{len(new)} UL grants, every one of the run's {len(crc)} CRCs OK; SI at 160 and "
          f"paging at 140 read back; counters {cell.cell.counters}; bufferer {st}")


def slicing_phase(card: str) -> tuple[dict, float, dict]:
    """Path 10 (b): ``SliceScheduler`` over two slices of 4 UEs at 4
    layers, MCS 20, 10 FDD slots through ``UpperPhy`` with the DL grid
    looped back through a random unitary channel at 30 dB, the RRM policy
    applied after slot 5.  Checks quotas, disjoint PRBs, every CRC and
    the launches of each UL_TTI call; K2 and K3 against their plain
    versions on one call's inputs.  Returns the launch counts, the ms a
    slot and the kernels' largest differences."""
    import torch

    from srsran_project_tpu_torch.l2sim.scheduler import SchedulerConfig
    from srsran_project_tpu_torch.l2sim.slicing import SliceConfig, SliceScheduler
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig

    dev = torch.device(DEVICE)
    nof_sc = UL_NOF_PRB * 12
    ss = SliceScheduler(SchedulerConfig(nof_grid_sc=nof_sc, nof_rb=UL_NOF_PRB, max_ues_per_slot=4,
                                        nof_layers=4, nof_ports=UL_NOF_PORTS),
                        [SliceConfig(**s) for s in P10_SLICES])
    for k, s in enumerate(P10_SLICES):
        for i in range(4):
            ss.add_ue(s["slice_id"], P10_RNTI + 0x100 * (k + 1) + i, mcs=P9_MCS)
    phy = UpperPhy(UpperPhyConfig(nof_ports=UL_NOF_PORTS, nof_grid_sc=nof_sc, device=DEVICE))
    rng = np.random.default_rng(SEED + 11)
    u = torch.from_numpy(_unit_rows(rng, UL_NOF_PORTS)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    sigma = math.sqrt(0.5 * 10 ** (-P9_SNR_DB / 10))

    def channel(grid):
        noise = torch.randn((2,) + tuple(grid.shape), generator=gen, device=dev) * sigma
        return torch.einsum("rp,psk->rsk", u, grid) + torch.complex(noise[0], noise[1])

    quotas, nof_grants = [], 0
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.monotonic()
    with UlTtiRecorder() as rec:
        for i in range(P10_SLICE_SLOTS):
            if i == P10_POLICY_AFTER and not ss.apply_rrm_policy(P10_POLICY):
                fail("slicing: the RRM policy matched no slice")
            dl, tx, ul, grants = ss.run_slot(p9_slot(i), rng)
            quotas.append(dict(ss.last_quotas))
            spans = sorted((p.first_rb, p.first_rb + p.config.alloc.rb_count) for p in dl.pdsch)
            if any(b > c for (_a, b), (c, _d) in zip(spans, spans[1:])) or spans[-1][1] > UL_NOF_PRB:
                fail(f"slicing slot {i}: PRB spans {spans} overlap or leave the carrier")
            for sid, q in ss.last_quotas.items():
                used = [p for g, p in zip(grants, dl.pdsch) if g[0] == sid]
                if sum(p.config.alloc.rb_count for p in used) > q:
                    fail(f"slicing slot {i}: slice {sid} uses more than its {q} PRB")
            res = phy.process_ul_tti(ul, channel(phy.process_dl_tti(dl, tx)))
            ss.handle_results(res)
            bad = [(c.rnti, c.harq_id) for c in res.crc if not c.tb_crc_ok]
            if bad or len(res.crc) != len(grants):
                fail(f"slicing slot {i}: CRC failed for {bad} of {len(res.crc)} grants")
            nof_grants += len(grants)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    want = [P10_QUOTAS[i >= P10_POLICY_AFTER] for i in range(P10_SLICE_SLOTS)]
    if quotas != want:
        fail(f"slicing: quotas {quotas}, want {want}")
    p9_check_calls("slicing", rec.calls, counts)
    rep = ss.report()
    if any(v["ul_bits_ok"] == 0 for r in rep.values() for v in r.values()):
        fail(f"slicing: a UE with no bit delivered: {rep}")
    ms = 1e3 * wall / P10_SLICE_SLOTS
    print(f"# [{card}] slicing: 2 slices x 4 UEs, {P10_SLICE_SLOTS} slots, {nof_grants} grants "
          f"all CRC OK, quotas {P10_QUOTAS[0]} then {P10_QUOTAS[1]} after the RRM policy; "
          f"{ms:.2f} ms a slot (host clock)")
    errs = {}
    call = rec.calls[-1]
    # Slice 1's grants (window at their crb_start) go through process_slot.
    batch = [p for p in call["pdus"] if p.config.alloc.crb_start == p.first_rb]
    errs["decode"], geometries = check_code_groups(call["grid"], batch, "slicing")
    errs["mmse_weights_4x4"] = check_k3_group(call["grid"], batch, "slicing K3")
    print(f"# slicing: K2 code groups {geometries} of the last slot")
    p9_report_ul_call(card, f"slicing UL_TTI of {len(call['pdus'])} grants (last slot)", call)
    return counts, ms, errs


def helpers_phase(card: str, rx) -> None:
    """Path 10 (c): the Q1.8.12 helpers on CUDA tensors against their CPU
    results: ``decode_count_iters`` on the flagship's 141 codeblocks at 30
    dB (path 1's first received slot ``rx``, its LLRs rate-dematched; the
    counts printed beside K1's per-codeblock iterations on the same LLRs),
    ``detect_ref``, ``hard_decision_bits`` and ``selection_indices``."""
    import torch

    from srsran_project_tpu_torch.models import cell
    from srsran_project_tpu_torch.ops import ofdm, short_block
    from srsran_project_tpu_torch.ops.ldpc import decoder, graphs, rate_match
    from srsran_project_tpu_torch.ops.modulation import Modulation, evm
    from srsran_project_tpu_torch.phy import pusch, sch as sch_mod

    dev = torch.device(DEVICE)
    cfg = cell.CellConfig()
    pc = cfg.pusch_cfg
    sc, seg = pc.sch, pc.sch.seg
    grid = ofdm.demodulate_slot(rx[:1], cfg.nof_rb, cfg.scs, cfg.dft_size, cfg.cp, 0,
                                f_center_hz=cfg.f_center_hz)
    llrs = pusch._front_end(grid, torch.tensor([RNTI], device=dev), pc)[0]  # (1, G) int8
    n_cb = sc.n_cb or seg.full_codeword_bits
    z = seg.lifting_size
    full = torch.zeros((seg.nof_codeblocks, (graphs.get_graph(seg.base_graph, z).n - 2) * z),
                       dtype=torch.int8, device=dev)
    row = off = 0
    for _s, count, e in sch_mod._e_groups(sc.cb_e_bits):
        span = llrs[0, off : off + count * e].reshape(count, e)
        full[row : row + count] = rate_match.rate_dematch(
            span, seg.base_graph, z, seg.nof_payload_bits_per_cb, e, sc.rv, sc.qm, n_cb)
        row, off = row + count, off + count * e
    got = decoder.decode_count_iters(full, seg.base_graph, z, 6)
    torch.cuda.synchronize()
    want = decoder.decode_count_iters(full.cpu(), seg.base_graph, z, 6)
    for a, b, what in zip(got, want, ("bits", "a-posteriori LLRs", "counts")):
        if not torch.equal(a.cpu(), b):
            fail(f"helpers: decode_count_iters {what} differ between the card and the CPU")
    rng = np.random.default_rng(SEED + 12)
    _bits, it_k1 = sch_mod._fused_decode(llrs, sc, 6, True)
    torch.cuda.synchronize()
    counts = got[2].cpu().numpy()
    k1 = it_k1.cpu().numpy()
    diff = np.nonzero(counts != k1)[0]
    print(f"# helpers: decode_count_iters on the flagship's {len(counts)} codeblocks (BG"
          f"{seg.base_graph} Z={z}, n_cb {n_cb}, {SNR_DB} dB) equals the CPU; counts "
          f"{np.bincount(counts).tolist()} by iteration, K1's early-stop iterations "
          f"{np.bincount(k1).tolist()}; they differ on {len(diff)} codeblocks "
          f"{[(int(i), int(counts[i]), int(k1[i])) for i in diff[:8]]}")
    for k, e, qm in ((1, 8, 2), (2, 24, 4), (6, 64, 6), (11, 252, 8)):
        x = torch.from_numpy(rng.integers(-127, 128, size=(4096, e)).astype(np.int8))
        a, b = short_block.detect_ref(x.to(dev), k, e, qm), short_block.detect_ref(x, k, e, qm)
        if not all(torch.equal(u.cpu(), v) for u, v in zip(a, b)):
            fail(f"helpers: detect_ref K={k} E={e} differs between the card and the CPU")
    for mod in (Modulation.QPSK, Modulation.QAM16, Modulation.QAM64, Modulation.QAM256):
        s = torch.from_numpy((rng.standard_normal((4, 3276)) + 1j * rng.standard_normal(
            (4, 3276))).astype(np.complex64))
        if not torch.equal(evm.hard_decision_bits(s.to(dev), mod).cpu(),
                           evm.hard_decision_bits(s, mod)):
            fail(f"helpers: hard_decision_bits {mod.name} differs between the card and the CPU")
    args = (seg.base_graph, seg.lifting_size, seg.nof_payload_bits_per_cb, sc.cb_e_bits[0],
            sc.rv, sc.qm, n_cb)
    if not np.array_equal(rate_match.selection_indices(*args, device=dev).cpu().numpy(),
                          rate_match.selection_indices(*args)):
        fail("helpers: selection_indices differ between the card and the CPU")
    print("# helpers: detect_ref (K 1/2/6/11), hard_decision_bits (QPSK to 256QAM) and "
          "selection_indices (the flagship's first E) equal their CPU results")


# ---- the radio-unit path -------------------------------------------------------

# (a) and (b): the app's single-UE mode on its default cell (273 PRB, 30
# kHz, 4 ports, 4 layers, 256QAM r 948/1024, a 4096-point DFT at 122.88
# MHz) through the generic RU (OFDM baseband looped back with AWGN) and
# the OFH RU (paced C-/U-plane frames with 9-bit BFP looped back, AWGN on
# the reassembled grid).  Each UL_TTI: K1 + K8.
P11_APP = {"generic": ["--ru", "generic", "--slots", "10", "--snr-db", "30"],
           "ofh": ["--ru", "ofh", "--slots", "10", "--snr-db", "30"]}
P11_SLOTS = 10
# The RU against the CPU: modulated samples, demodulated grid and PRACH
# buffer within this share of the CPU result's RMS (cuFFT and pocketfft
# round differently).
P11_RU_TOL = 1e-4
# Frames a slot at 273 PRB and 4 ports: per port a DL and a UL C-plane
# message, and 14 symbols x 2 U-plane sections (255 + 18 PRB).
P11_FRAMES = {"c": 2 * UL_NOF_PORTS, "u": 14 * 2 * UL_NOF_PORTS}
# (c) One UL grant of the full carrier through the RU and the time-domain
# TDL-A (4x4, 122.88 MHz, the taps' delays 0-36 samples): 4 layers of
# 16QAM at r 0.5 and 30 dB.  A CPU rehearsal decodes it on channel seeds
# 0-7 and 11 (the one used), as it does 64QAM r 0.55; 64QAM r 0.7 fails
# on one seed of the eight.  The channel is drawn on the CPU from the
# seed (the same draws as the rehearsal's) and applied on the card.
P11_TDL = dict(layers=4, qm=4, rate=0.5, snr_db=30.0, seed=SEED + 11, rnti=0x4E01)
# (d) The scheduler mode with a MAC-NR pcap and the remote-control
# endpoint: a client subscribes, reads a periodic report, asks for the
# metrics and quits the run long before its last slot.
P11_SCHED = ["--ues", "4", "--slots", "400", "--metrics-interval-slots", "5",
             "--remote-port", "0"]


class OfhRecorder:
    """While active, each ``RuOfh`` built keeps itself in ``rus`` and
    counts the C-plane and U-plane frames it puts on the wire."""

    def __enter__(self):
        from srsran_project_tpu_torch.ru import ofh_ru

        self.rus, self.frames = [], {"c": 0, "u": 0}
        self._orig = orig = ofh_ru.RuOfh.__init__
        rec = self

        def init(ru, *a, **kw):
            orig(ru, *a, **kw)
            send = ru.send_frame

            def counted(frame):
                rec.frames["u" if frame[1] == 0x00 else "c"] += 1
                send(frame)

            ru.send_frame = counted
            rec.rus.append(ru)

        ofh_ru.RuOfh.__init__ = init
        return self

    def __exit__(self, *exc):
        from srsran_project_tpu_torch.ru import ofh_ru

        ofh_ru.RuOfh.__init__ = self._orig
        return False


def p11_check_app(what: str, rc: int, err: str, calls: list, counts: dict) -> float:
    """An RU run of the app: exit 0, BLER 0, every UL_TTI call one grant
    with its CRC OK and K1 and K8 launched.  Returns the ms a slot on the
    host's clock."""
    import re

    m = re.search(r"# (\d+) slots in ([0-9.]+)s \(([0-9.]+) slot-pairs/s\), BLER=([0-9.]+)", err)
    if m is None or rc != 0 or float(m.group(4)) != 0.0:
        fail(f"{what}: rc {rc}, summary {m and m.group(0)}, want rc 0 and BLER 0.000")
    crcs = [bool(c.tb_crc_ok) for x in calls for c in x["res"].crc]
    if len(calls) != P11_SLOTS or crcs != [True] * P11_SLOTS:
        fail(f"{what}: {len(calls)} UL_TTI calls with CRCs {crcs}, want {P11_SLOTS} all OK")
    for n, call in enumerate(calls):
        got = {k: v for k, v in call["launches"].items() if v}
        if got != {"decode_dematch": 1, "mmse_equalize": 1}:
            fail(f"{what} UL_TTI call {n}: kernel launches {got}, want K1 1 and K8 1")
    expect_counts(what, counts, {"decode_dematch": P11_SLOTS, "mmse_equalize": P11_SLOTS})
    return 1e3 * float(m.group(2)) / int(m.group(1))


def p11_slot_kernels(call, what: str) -> dict:
    """K1 and K3 against their plain versions on one recorded UL_TTI call's
    received grid (its one full-band grant)."""
    import types

    from srsran_project_tpu_torch.phy import ul_slot

    pdu = call["req"].pusch[0]
    grant = types.SimpleNamespace(config=pdu.config, rnti=pdu.rnti, first_rb=0)
    return {"decode_dematch": check_k1_grant(call["grid"], grant, f"{what} K1"),
            "mmse_weights_4x4": check_k3_group(
                call["grid"], [ul_slot.UlSlotPdu(rnti=pdu.rnti, first_rb=0, config=pdu.config)],
                f"{what} K3")}


def p11_close(what: str, got, want, tol: float = P11_RU_TOL) -> float:
    """got (card) within tol x the RMS of want (CPU); returns the ratio."""
    got, want = got.detach().cpu(), want.detach().cpu()
    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} on the card, {tuple(want.shape)} on the CPU")
    rms = float(want.abs().pow(2).mean().sqrt())
    err = float((got - want).abs().max()) / rms
    if not err <= tol:
        fail(f"{what}: the card's result is {err:.3e} x RMS from the CPU's, above {tol}")
    return err


def p11_generic_ru(device, ru_cls, cfg_cls, slot, grid):
    """One slot through a RuGeneric on ``device`` (273 PRB, 4096-point DFT):
    modulate ``grid``; returns (the RU, its collector, the samples)."""
    from srsran_project_tpu_torch.apps.du_low_sim import RuCollector
    from srsran_project_tpu_torch.ru import ResourceGridContext

    col, sent = RuCollector(), {}
    ru = ru_cls(cfg_cls(dft_size=4096, nof_rb=UL_NOF_PRB, device=str(device)), col,
                transmit_cb=sent.__setitem__)
    ru.handle_dl_data(ResourceGridContext(slot=slot), grid)
    ru.advance_slot(slot)
    return ru, col, sent.pop(slot)


def ru_generic_phase(card: str) -> tuple[dict, dict]:
    """Path 11 (a): ``du_low_sim --ru generic`` on the card (every CRC, K1
    and K8 a UL_TTI), K1 and K3 against their plain versions on its first
    call's received grid; the RU's modulate and demodulate on one slot
    against the CPU; a format-0 PRACH occasion through the RU at 122.88
    MHz, detected with its delays.  Returns the run's launch counts and
    the kernels' largest differences."""
    import torch

    from srsran_project_tpu_torch.apps import du_low_sim
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig
    from srsran_project_tpu_torch.ru import (PrachBufferContext, ResourceGridContext,
                                             RuGeneric, RuGenericConfig)
    from srsran_project_tpu_torch.support import config as cfg_mod

    argv = P11_APP["generic"]
    rc, _out, err, counts, calls = p9_run_app(argv)
    ms = p11_check_app("ru generic", rc, err, calls, counts)
    errs = p11_slot_kernels(calls[0], "ru generic UL_TTI slot 0")
    print(f"# [{card}] ru generic du_low_sim {' '.join(argv)}: {ms:.2f} ms a slot pair "
          f"(host clock, {P11_SLOTS} slots: DL_TTI, modulate, AWGN, demodulate, UL_TTI)")
    p9_report_ul_call(card, "ru generic UL_TTI of the full-band 4-layer grant", calls[0])

    # The RU's modulate and demodulate on slot 0's DL grid, card against CPU.
    dev = torch.device(DEVICE)
    cell = cfg_mod.to_cell_config(cfg_mod.load_config())
    tb = np.random.default_rng(SEED).integers(0, 2, size=(cell.tbs,), dtype=np.uint8)
    dl, tx_data, _ul = du_low_sim.slot_requests(cell, 0, tb)
    grid = UpperPhy(UpperPhyConfig(nof_ports=cell.nof_ports, nof_grid_sc=cell.nof_sc,
                                   device=DEVICE)).process_dl_tti(dl, tx_data)
    slot = dl.slot
    ru, col, samples = p11_generic_ru(dev, RuGeneric, RuGenericConfig, slot, grid)
    ru_c, col_c, samples_c = p11_generic_ru("cpu", RuGeneric, RuGenericConfig, slot, grid.cpu())
    e_mod = p11_close("ru generic modulate", samples, samples_c)
    noisy = du_low_sim.add_awgn(samples, SNR_DB, np.random.default_rng(SEED + 11), occupied=True)
    for r, c, s in ((ru, col, noisy), (ru_c, col_c, noisy.cpu())):
        r.push_ul_samples(slot, s)
        r.handle_new_uplink_slot(ResourceGridContext(slot=slot))
        r.advance_slot(slot)
    e_demod = p11_close("ru generic demodulate", col.rx[slot], col_c.rx[slot])
    if col.rx[slot].device.type != dev.type or samples.device.type != dev.type:
        fail("ru generic: the RU's samples or grid left the card")

    def slot_pair():
        ru.handle_dl_data(ResourceGridContext(slot=slot), grid)
        ru.push_ul_samples(slot, noisy)
        ru.handle_new_uplink_slot(ResourceGridContext(slot=slot))
        ru.advance_slot(slot)

    print(f"# ru generic: modulate {tuple(samples.shape)} and demodulate on the card within "
          f"{e_mod:.2e} and {e_demod:.2e} x RMS of the CPU (tolerance {P11_RU_TOL})")
    report_call(card, "ru generic modulate + demodulate of one slot (4 ports, 4096-point)",
                slot_pair)

    # A format-0 PRACH occasion through the RU, at path 7's slot: its two
    # preambles at 2.0 and 9.0 us come back through prach.detect.
    p7 = p7_slot()
    samples = p7_prach_samples("a", SEED + 11, dev)
    buffers = []
    col = du_low_sim.RuCollector()
    col.on_new_prach_window_data = lambda ctx, buf: buffers.append(buf)
    prach_ru = RuGeneric(RuGenericConfig(dft_size=4096, nof_rb=UL_NOF_PRB, device=DEVICE), col)
    _fmt, _zcz, _root, rb0, sym0 = P7_PRACH["a"][:5]
    prach_ru.handle_prach_occasion(PrachBufferContext(slot=p7, start_symbol=sym0, format="0",
                                                      rb_offset=rb0))
    prach_ru.push_ul_samples(p7, samples)
    torch.cuda.synchronize()
    reset_counts()
    prach_ru.advance_slot(p7)
    buf = buffers[0]
    want = p7_prach_fd("a", samples.to(torch.complex64))  # the RU keeps complex64
    if buf.shape != (UL_NOF_PORTS, 1, 839) or not torch.equal(buf[:, 0], want):
        fail(f"ru generic PRACH: buffer {tuple(buf.shape)} is not lower_phy.prach_demodulate's")
    phy = UpperPhy(UpperPhyConfig(nof_ports=UL_NOF_PORTS, nof_grid_sc=UL_NOF_PRB * 12,
                                  device=DEVICE))
    res = phy.process_ul_tti(p7_request("a"), torch.zeros(
        (UL_NOF_PORTS, 14, UL_NOF_PRB * 12), dtype=torch.complex64, device=dev),
        prach_fd=buf[:, 0])
    torch.cuda.synchronize()
    expect_counts("ru generic PRACH occasion", read_counts(), {})
    p7_check_rach("ru generic format-0 PRACH at 122.88 MHz", res, "a")
    return counts, errs


def ru_ofh_phase(card: str) -> tuple[dict, dict]:
    """Path 11 (b): ``du_low_sim --ru ofh`` on the card: every CRC, K1 and
    K8 a UL_TTI, no late frame and no eviction, the frames a slot; K1 and
    K3 against their plain versions on its first call's grid; then one
    slot replayed stage by stage (the DL_TTI call, the grid's copy to the
    host, serdes, the copy back, the UL_TTI call).  Returns the run's
    launch counts and the kernels' largest differences."""
    import torch

    from srsran_project_tpu_torch.apps import du_low_sim
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig
    from srsran_project_tpu_torch.ru import ResourceGridContext, RuOfh, RuOfhConfig
    from srsran_project_tpu_torch.support import config as cfg_mod

    argv = P11_APP["ofh"]
    with OfhRecorder() as ofh:
        rc, _out, err, counts, calls = p9_run_app(argv)
    ms = p11_check_app("ru ofh", rc, err, calls, counts)
    if len(ofh.rus) != 1:
        fail(f"ru ofh: {len(ofh.rus)} RuOfh built, want 1")
    ru = ofh.rus[0]
    m = ru.get_metrics()
    late = (m.late_dl_requests, m.late_ul_requests, m.late_prach_requests, m.late_ul_frames,
            ru.window.stats.early, ru.window.stats.late, ru.seqid.lost, ru.seqid.duplicates)
    if any(late) or ru._ul_pending or ru._tx_queue:
        fail(f"ru ofh: late/evicted/early/lost counts {late}, pending {len(ru._ul_pending)}, "
             f"queued {len(ru._tx_queue)}; want none")
    per_slot = {k: v / P11_SLOTS for k, v in ofh.frames.items()}
    if per_slot != P11_FRAMES:
        fail(f"ru ofh: frames a slot {per_slot}, want {P11_FRAMES}")
    errs = p11_slot_kernels(calls[0], "ru ofh UL_TTI slot 0")
    print(f"# [{card}] ru ofh du_low_sim {' '.join(argv)}: {ms:.2f} ms a slot pair (host "
          f"clock, {P11_SLOTS} slots); {per_slot['c']:.0f} C-plane and {per_slot['u']:.0f} "
          f"U-plane frames a slot, {ru.window.stats.on_time} U-plane frames on time, none "
          f"late, early, lost or evicted")
    p9_report_ul_call(card, "ru ofh UL_TTI of the full-band 4-layer grant", calls[0])

    # One slot replayed stage by stage, each stage synchronized.
    dev = torch.device(DEVICE)
    cell = cfg_mod.to_cell_config(cfg_mod.load_config())
    phy = UpperPhy(UpperPhyConfig(nof_ports=cell.nof_ports, nof_grid_sc=cell.nof_sc,
                                  device=DEVICE))
    tb = np.random.default_rng(SEED).integers(0, 2, size=(cell.tbs,), dtype=np.uint8)
    dl, tx_data, ul = du_low_sim.slot_requests(cell, 0, tb)
    col, wire = du_low_sim.RuCollector(), []
    ru = RuOfh(RuOfhConfig(scs=cell.scs, nof_prb=cell.nof_rb, nof_ports=cell.nof_ports,
                           device=DEVICE), col, send_frame=wire.append)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    stages = {}
    for rep in range(3):  # the last repetition is kept
        slot = dl.slot + 2 * rep
        air = slot + 1
        grid, stages["DL_TTI call"] = timed(lambda: phy.process_dl_tti(dl, tx_data))
        host, stages["grid to host"] = timed(lambda: grid.cpu().numpy())

        def serdes():
            ru.ota_tick(slot)
            ru.handle_new_uplink_slot(ResourceGridContext(slot=air))
            ru.handle_dl_data(ResourceGridContext(slot=air), host)
            for tick in (slot, air):
                for sym in range(14):
                    ru.ota_tick(tick, sym)
                    while wire:
                        f = wire.pop(0)
                        if f[1] == 0x00:
                            ru.push_uplane_frame(f)
            return col.rx.pop(air)

        rx, stages["serdes (frames out and back)"] = timed(serdes)
        back = rx.cpu().numpy()
        _x, stages["grid back to the card"] = timed(lambda: torch.from_numpy(back).to(dev))
        stages["serdes (frames out and back)"] -= stages["grid back to the card"]
        res, stages["UL_TTI call"] = timed(lambda: phy.process_ul_tti(ul, rx))
        if not res.crc[0].tb_crc_ok:
            fail("ru ofh replay: the slot's CRC failed")
    print(f"# [{card}] ru ofh one slot by stage (host clock, synchronized): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()))
    return counts, errs


def ru_tdl_phase(card: str) -> tuple[dict, dict]:
    """Path 11 (c): one full-carrier UL grant (P11_TDL) transmitted by the
    UE side through a RuGeneric, the time-domain TDL-A (4x4, 122.88 MHz,
    the draws made on the CPU from the seed, applied on the card), the RU's
    demodulator and ``UpperPhy.process_ul_tti``: CRC OK and TB bits equal,
    K1 + K8.  Returns the launch counts and K3's difference on its
    estimate."""
    import torch

    from srsran_project_tpu_torch.fapi import messages as fapi
    from srsran_project_tpu_torch.phy import channel_emulator as chem
    from srsran_project_tpu_torch.phy import pusch, ul_slot
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig
    from srsran_project_tpu_torch.ru import ResourceGridContext, RuGeneric, RuGenericConfig

    dev = torch.device(DEVICE)
    t = P11_TDL
    cfg = ul_config(t["layers"], t["qm"], t["rate"], UL_NOF_PRB, 0)
    rng = np.random.default_rng(t["seed"])
    tb = rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8)
    slot = p7_slot() + 4
    tx = pusch.transmit(torch.from_numpy(tb).to(dev), torch.tensor(t["rnti"], device=dev), cfg)
    ru, col, samples = p11_generic_ru(dev, RuGeneric, RuGenericConfig, slot, tx)
    ch = chem.ChannelConfig(profile="tdla", sinr_db=t["snr_db"], nof_tx_ports=UL_NOF_PORTS,
                            nof_rx_ports=UL_NOF_PORTS, nof_sc=UL_NOF_PRB * 12)
    gen = torch.Generator().manual_seed(t["seed"])
    gains = chem.draw_channel_time(gen, ch, 122.88e6)
    noise = chem._complex_normal(tuple(samples.shape), gen)
    rx = chem.apply_channel_time_taps(samples, gains.to(dev), noise.to(dev), ch, 122.88e6)
    want = chem.apply_channel_time_taps(samples.cpu(), gains, noise, ch, 122.88e6)
    e_ch = p11_close("ru tdl apply_channel_time_taps", rx, want, 1e-5)
    ru.push_ul_samples(slot, rx)
    ru.handle_new_uplink_slot(ResourceGridContext(slot=slot))
    ru.advance_slot(slot)
    grid = col.rx.pop(slot)
    phy = UpperPhy(UpperPhyConfig(nof_ports=UL_NOF_PORTS, nof_grid_sc=UL_NOF_PRB * 12,
                                  device=DEVICE))
    req = fapi.UlTtiRequest(slot=slot, pusch=[fapi.UlPuschPdu(cfg, t["rnti"], first_rb=0)])
    torch.cuda.synchronize()
    reset_counts()
    res = phy.process_ul_tti(req, grid)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("ru tdl UL_TTI", counts, {"decode_dematch": 1, "mmse_equalize": 1})
    ok = bool(res.crc[0].tb_crc_ok)
    if not ok or not np.array_equal(np.asarray(res.rx_data[0].payload), tb):
        fail(f"ru tdl: CRC {ok} on the TDL-A grant, want OK and the TB back")
    k3 = check_k3_group(grid, [ul_slot.UlSlotPdu(rnti=t["rnti"], first_rb=0, config=cfg)],
                        "ru tdl K3")
    print(f"# [{card}] ru tdl: a {UL_NOF_PRB}-PRB {t['layers']}-layer qm {t['qm']} r "
          f"{t['rate']} grant ({cfg.tbs} bits) through RuGeneric and the time-domain TDL-A "
          f"(taps at {chem._time_taps('tdla', 122.88e6)[0]} samples) at {t['snr_db']} dB: CRC "
          f"OK, SNR {res.crc[0].snr_db:.2f} dB; the channel on the card within {e_ch:.2e} x "
          f"RMS of the CPU")
    return counts, {"mmse_weights_4x4": k3}


def ru_sched_phase(card: str) -> dict:
    """Path 11 (d): the scheduler mode with ``--pcap`` and ``--remote-port
    0`` on the app's default cell: a WsClient subscribes, reads a periodic
    report, asks for the metrics and sends "quit", which ends the run
    long before its last slot; the pcap holds one record per DL TB the
    scheduler put in a DL_TTI call, with its RNTI, SFN and slot.  Returns
    the run's launch counts."""
    import queue
    import threading

    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy
    from srsran_project_tpu_torch.support import pcap
    from srsran_project_tpu_torch.support import remote_server as rs

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "build", "path11_mac.pcap")
    if os.path.exists(path):
        os.remove(path)
    started, got, dl_tbs = queue.Queue(), {}, []
    orig_start, orig_dl = rs.RemoteServer.start, UpperPhy.process_dl_tti

    def start(server):
        orig_start(server)
        started.put(server)

    def process_dl_tti(phy, request, tx_data):
        dl_tbs.extend((p.rnti, request.slot.sfn, request.slot.slot_in_frame, bytes(
            np.packbits(tb))) for p, tb in zip(request.pdsch, tx_data.payloads))
        return orig_dl(phy, request, tx_data)

    def client():
        try:
            srv = started.get(timeout=120)
            cli = rs.WsClient("127.0.0.1", srv.port, timeout=30.0)
            try:
                def until(pred):
                    for _ in range(1000):
                        msg = cli.recv_json()
                        if pred(msg):
                            return msg
                    raise RuntimeError("no such message")

                cli.send_json({"cmd": "metrics_subscribe"})
                until(lambda m: m.get("cmd") == "metrics_subscribe")
                got["report"] = until(lambda m: m.get("type") == "periodic")
                cli.send_json({"cmd": "metrics"})
                got["metrics"] = until(lambda m: m.get("cmd") == "metrics")
                cli.send_json({"cmd": "quit"})
                got["quit"] = until(lambda m: m.get("cmd") == "quit")
            finally:
                cli.close()
        except Exception as e:  # reported by the main thread
            got["error"] = repr(e)

    argv = P11_SCHED + ["--pcap", path]
    thread = threading.Thread(target=client, daemon=True)
    rs.RemoteServer.start, UpperPhy.process_dl_tti = start, process_dl_tti
    try:
        thread.start()
        rc, out, err, counts, calls = p9_run_app(argv)
    finally:
        rs.RemoteServer.start, UpperPhy.process_dl_tti = orig_start, orig_dl
    thread.join(timeout=60)
    if thread.is_alive() or "error" in got or got.get("quit", {}).get("cmd") != "quit":
        fail(f"ru sched: the remote-control client did not finish: {got}")
    periodic = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    if rc != 0 or got["report"] not in periodic or not 1 <= len(periodic) < 400 // 5:
        fail(f"ru sched: rc {rc}, {len(periodic)} periodic reports, want rc 0 and the run "
             f"quit early with the client's report among them")
    if sorted(got["metrics"]["report"]) != [str(0x100 + i) for i in range(4)]:
        fail(f"ru sched: metrics command answered {got['metrics']}")
    dlt, pkts = pcap.read_pcap(path)
    recs = []
    for _ts, payload in pkts:
        ctx, pdu = pcap.parse_mac_nr_context(payload)
        recs.append((ctx["rnti"], ctx["sfn"], ctx["slot"], pdu))
    if dlt != pcap.DLT_USER_2 or recs != dl_tbs or not recs:
        fail(f"ru sched: {len(recs)} pcap records, {len(dl_tbs)} DL TBs scheduled; want one "
             f"record per TB with its RNTI, SFN, slot and bytes")
    crc = [c.tb_crc_ok for x in calls for c in x["res"].crc]
    p9_check_calls("ru sched", calls, counts)
    print(f"# [{card}] ru sched du_low_sim {' '.join(P11_SCHED)} --pcap: quit by the remote "
          f"client after {len(calls)} UL slots and {len(periodic)} periodic reports; "
          f"{len(recs)} pcap records = the {len(dl_tbs)} DL TBs scheduled; {sum(crc)} of "
          f"{len(crc)} grants CRC OK (TDL-A at 25 dB)")
    return counts


# ---- path 12: the monolithic gNB -------------------------------------------

# (a) at the size the reference app was rehearsed at; (b) on TDL-A; (c) the
# MAC test mode, no PHY, against the same run with --cpu.
P12_APP = ["--ues", "4", "--packets", "8", "--slots", "80", "--snr-db", "25", "--handover",
           "--e2", "--metrics-json"]
P12_TDLA = ["--channel", "tdla", "--ues", "2", "--packets", "4", "--slots", "60",
            "--metrics-json"]
P12_TESTMODE = ["--testmode", "16", "--slots", "200", "--metrics-json"]
P12_PCAPS = ("gnb_e1ap.pcap", "gnb_e2ap.pcap", "gnb_f1ap.pcap", "gnb_gtpu.pcap",
             "gnb_ngap.pcap")


def p12_expected(pdus) -> dict:
    """The launches ``UpperPhy.process_ul_tti`` makes for the gNB's 1-layer
    grants: two or more through ``process_slot`` (``p9_expected``: K2 per
    code group, K8 per config group); a single grant through
    ``pusch.process``: K1 for new data, K2 for a retransmission combined
    with its HARQ buffer, and K8; never K3."""
    if len(pdus) >= 2:
        return p9_expected(pdus)
    want = {"decode_dematch": 0, "decode": 0, "mmse_equalize": 0}
    for p in pdus:
        fused = p.harq_buffer is None and _fused_ok(p.config)
        want["decode_dematch" if fused else "decode"] += 1
        want["mmse_equalize"] += k8_launches([p.config])
    return want


class HostSplit:
    """While active, times (host clock, the card synchronized at the end of
    each call) every UpperPhy DL_TTI and UL_TTI call, the channel, the scheduler's
    ``run_slot`` (with the DL TB assembly from RLC it calls) and every
    PDCP/SRB protect and unprotect (the pure-Python ciphers and integrity),
    and keeps each DL_TTI request.  ``seconds(t0, t1)``: the time of each
    kind in the calls that started in [t0, t1) (``time.perf_counter``)."""

    def __enter__(self):
        import torch

        from srsran_project_tpu_torch.l2 import security
        from srsran_project_tpu_torch.l2sim.scheduler import RoundRobinScheduler
        from srsran_project_tpu_torch.phy import channel_emulator
        from srsran_project_tpu_torch.phy.upper_phy import UpperPhy

        self.events = []  # (kind, start, seconds)
        self.dl_requests = []
        self._orig = [(cls, name, getattr(cls, name)) for cls, name in (
            (UpperPhy, "process_dl_tti"), (UpperPhy, "process_ul_tti"),
            (channel_emulator, "apply_channel"), (RoundRobinScheduler, "run_slot"), (security.SecurityEngine, "protect"),
            (security.SecurityEngine, "unprotect"))]

        def timed(kind, fn):
            def wrapped(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if kind in ("dl_tti", "ul_tti", "channel"):
                    torch.cuda.synchronize()
                self.events.append((kind, t0, time.perf_counter() - t0))
                if kind == "dl_tti":
                    self.dl_requests.append(a[1:3])
                return out
            return wrapped

        for (cls, name, fn), kind in zip(self._orig, ("dl_tti", "ul_tti", "channel",
                                                      "scheduler", "crypto", "crypto")):
            setattr(cls, name, timed(kind, fn))
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._orig:
            setattr(cls, name, fn)
        return False

    def seconds(self, t0: float, t1: float) -> dict:
        out = {"dl_tti": 0.0, "ul_tti": 0.0, "channel": 0.0, "scheduler": 0.0, "crypto": 0.0}
        for kind, start, dt in self.events:
            if t0 <= start < t1:
                out[kind] += dt
        return out


def p12_run(argv, host_split: bool = False):
    """``gnb_sim.run`` in-process with its output captured and every UL_TTI
    call recorded: (GnbRun, stdout, launch counts, UL_TTI calls, HostSplit
    or None)."""
    import contextlib
    import io

    import torch

    from srsran_project_tpu_torch.apps import gnb_sim

    args = gnb_sim._parser().parse_args(list(argv))
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    split = HostSplit() if host_split else contextlib.nullcontext()
    with UlTtiRecorder() as rec, split, contextlib.redirect_stdout(out):
        run = gnb_sim.run(args)
    torch.cuda.synchronize()
    counts = read_counts()
    for line in out.getvalue().splitlines():
        print(f"# gnb_sim {' '.join(argv)}: {line}")
    return run, out.getvalue(), counts, rec.calls, split if host_split else None


def p12_check_delivery(what: str, run, ues: int, packets: int) -> None:
    m = run.metrics
    if not run.ok or (m["dl_packets"], m["ul_packets"]) != (ues * packets, ues * packets):
        fail(f"{what}: ok {run.ok}, {m['dl_packets']} DL and {m['ul_packets']} UL packets, "
             f"want ok and {ues * packets} each way bytes-exact")


def gnb_phase(card: str) -> tuple[dict, float]:
    """Path 12 (a): the monolithic gNB at the reference's rehearsed size:
    every packet bytes-exact both ways, every UE on DU 2 after the
    handover, KPM indications, every pcap written, each UL_TTI call's
    launches as its grants imply; K2 and K1 against their plain versions
    on the first UL slot's grid; the slot's host time split between the
    PHY calls and the L2/L3.  Returns the launch counts and the largest K2
    a-posteriori difference."""
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    pcap_dir = os.path.join(here, "build", "path12_pcap")
    shutil.rmtree(pcap_dir, ignore_errors=True)
    from srsran_project_tpu_torch.support import pcap

    argv = P12_APP + ["--pcap-dir", pcap_dir]
    run, out, counts, calls, split = p12_run(argv, host_split=True)
    p12_check_delivery("gnb (a)", run, 4, 8)
    if [c.du_id for c in run.cucp.ues.values()] != [1] * 4:
        fail(f"gnb (a): UEs on DUs {[c.du_id for c in run.cucp.ues.values()]}, want all on DU 2")
    if not run.ric.indications:
        fail("gnb (a): no KPM indication")
    sizes = {os.path.basename(w.path): w.nof_packets for w in run.pcaps}
    if sorted(sizes) != list(P12_PCAPS) or not all(sizes.values()):
        fail(f"gnb (a): pcaps {sizes}, want {P12_PCAPS} each with packets")
    for name in P12_PCAPS:
        if len(pcap.read_pcap(os.path.join(pcap_dir, name))[1]) != sizes[name]:
            fail(f"gnb (a): {name} does not read back its {sizes[name]} packets")
    p9_check_calls("gnb (a)", calls, counts, p12_expected)
    retx = sum(p.harq_buffer is not None for c in calls for p in c["pdus"])
    print(f"# gnb (a): {retx} retransmitted grants among the calls' "
          f"{sum(len(c['pdus']) for c in calls)}")
    first = next(c for c in calls if len(c["pdus"]) >= 2)
    k2_err, geometries = check_code_groups(first["grid"], first["pdus"], "gnb (a) UL_TTI")
    single = next(c for c in calls if len(c["pdus"]) == 1 and c["pdus"][0].harq_buffer is None)
    p = single["req"].pusch[0]
    check_k1_grant(single["grid"], p, f"gnb (a) UL_TTI slot {single['req'].slot.count}")
    slots = run.slots_run
    s = split.seconds(run.loop_t0, run.loop_t0 + run.loop_s)
    phy_s = s["dl_tti"] + s["ul_tti"]
    l2l3 = run.loop_s - phy_s - s["channel"]
    print(f"# [{card}] gnb (a) gnb_sim {' '.join(P12_APP)}: ok, 32/32 DL and 32/32 UL packets "
          f"bytes-exact in {slots} slots, {len(run.ric.indications)} KPM indications, pcaps "
          f"{sizes}; K2 code groups {geometries}")
    print(f"# [{card}] gnb (a) host clock: {1e3 * run.loop_s / slots:.3f} ms a slot "
          f"({slots} slots, {run.loop_s:.3f} s); of it the PHY calls {1e3 * phy_s / slots:.3f} "
          f"ms a slot (DL_TTI {1e3 * s['dl_tti'] / slots:.3f}, UL_TTI "
          f"{1e3 * s['ul_tti'] / slots:.3f}, each call ended by a synchronize), the channel "
          f"{1e3 * s['channel'] / slots:.3f} and the rest, the L2/L3 and the UEs' stacks, "
          f"{1e3 * l2l3 / slots:.3f} ms a slot, of which the scheduler's "
          f"run_slot with the DL TB assembly {1e3 * s['scheduler'] / slots:.3f} and the "
          f"PDCP ciphering and integrity {1e3 * s['crypto'] / slots:.3f} (the bring-up and "
          f"the DL packets' ciphering before the loop not counted)")
    phy = run.phy
    dl_req = next(r for r in split.dl_requests if len(r[0].pdsch) >= 2)
    report_call(card, f"gnb (a) DL_TTI of {len(dl_req[0].pdsch)} PDSCH grants",
                lambda: phy.process_dl_tti(*dl_req))
    p9_report_ul_call(card, f"gnb (a) UL_TTI of {len(first['pdus'])} grants "
                      f"(slot {first['req'].slot.count})", first)
    p9_report_ul_call(card, f"gnb (a) UL_TTI of one new-data grant (slot "
                      f"{single['req'].slot.count})", single)
    return counts, k2_err


def gnb_more_phase(card: str) -> tuple[dict, dict]:
    """Path 12 (b) TDL-A, (c) the test mode against its CPU run, (d) the
    composed gNB's upper PHY on the card.  Returns (b)'s and (c)'s launch
    counts."""
    import torch

    from srsran_project_tpu_torch import units

    run, _out, counts_b, calls, _ = p12_run(P12_TDLA)
    p12_check_delivery("gnb (b)", run, 2, 4)
    p9_check_calls("gnb (b)", calls, counts_b, p12_expected)
    print(f"# [{card}] gnb (b) gnb_sim {' '.join(P12_TDLA)}: ok, 8/8 packets each way in "
          f"{run.slots_run} slots, {1e3 * run.loop_s / run.slots_run:.3f} ms a slot (host clock)")

    run_c, _out, counts_c, calls, _ = p12_run(P12_TESTMODE)
    run_cpu, _out, _counts, _calls, _ = p12_run(P12_TESTMODE + ["--cpu"])
    keys = ("testmode_ues", "slots", "nof_crc", "nof_uci", "dl_bits", "ul_bits")
    got, want = ({k: r.metrics[k] for k in keys} for r in (run_c, run_cpu))
    if got != want or calls or any(counts_c.values()):
        fail(f"gnb (c): counters {got}, with --cpu {want}; {len(calls)} UL_TTI calls and "
             f"launches {counts_c}, want equal counters and no PHY")
    print(f"# [{card}] gnb (c) gnb_sim {' '.join(P12_TESTMODE)}: counters {got} equal the "
          f"--cpu run's; {run_c.metrics['slots_per_s']} slots/s "
          f"({run_cpu.metrics['slots_per_s']} with --cpu)")

    comp = units.compose_gnb(with_phy=True)
    phy = comp.instances["upper_phy"]
    if phy.device.type != "cuda" or not torch.zeros(1, device=phy.device).is_cuda:
        fail(f"gnb (d): the composed upper PHY runs on {phy.device}, want cuda")
    print(f"# gnb (d) compose_gnb(with_phy=True): units {list(comp.units)}, the upper PHY on "
          f"{phy.device}")
    return counts_b, counts_c


# ---- the last slice: the scans, the parallel layer, the split, replay, positioning ----

# (a) The flagship scans: k chunks of B slots.  The scan's energies against
# the per-slot encodes' within this relative tolerance (float32 sums of
# the same samples; cuFFT may plan a batch of 4 slots and one slot apart).
P13_CHUNKS = (2, 4)
P13_ENERGY_RTOL = 1e-5
# (b) The parallel layer (a world of one; ``--world N`` on N cards): the
# halo-exchange smoothing within this absolute tolerance of the unsharded
# smoother; against the port's unsharded front end, int8 LLRs within 1
# with this share equal (ROADMAP's standing rule), noise variance and SNR
# within this relative tolerance (the CPU tests' bounds at 2 and 4 ranks);
# every rank ended within this time.
P13_HALO_ATOL = 1e-5
P13_LLR_EQUAL = 0.999
P13_METRIC_RTOL = 1e-4
P13_RANKS_TIMEOUT_S = 600
# (c) The split: UEs attached over UDP.
P13_UES = 4
# (d) Replay: UL slots through UpperPhy, sequentially and from threads, at
# 273 PRB with 1 port (256QAM r 948/1024, 30 dB; K1 a slot).
P13_REPLAY_SLOTS = 4
# (e) Positioning: a 273-PRB comb-4 PRS per TRP, delays in samples of a
# 4096-point DFT, 20 dB; RSTD within 0.7 samples (the reference test's
# bound).
P13_PRS = dict(rb_start=0, rb_count=273, start_symbol=2, nof_symbols=4, comb_size=4,
               n_id_prs=42, nof_grid_sc=273 * 12)
P13_DELAYS = {1: 5.0, 2: 9.0, 3: 1.0}
P13_RSTD_TOL = 0.7


def scan_phase(card: str) -> tuple[dict, dict, dict]:
    """Path 13 (a): ``encode_slots_scan`` and ``decode_slots_scan`` at the
    flagship, k = 2 chunks of B = 4 slots: the energies against the
    per-slot ``encode_slot``'s; every decode CRC-clean with no bit error at
    30 dB, one K1 and one K3 a chunk, and on the plane path one K1 (plane
    layout), one K3 and one K4 a chunk; K1, K3 and K4 against their plain
    versions on chunk 0's tensors.  Returns both runs' launch counts and
    the kernels' largest differences."""
    import torch

    from srsran_project_tpu_torch.models import cell
    from srsran_project_tpu_torch.ops import ofdm
    from srsran_project_tpu_torch.phy import pusch, sch as sch_mod

    dev = torch.device(DEVICE)
    k, b = P13_CHUNKS
    cfg = cell.CellConfig()
    rng = np.random.default_rng(SEED + 13)
    tb = torch.from_numpy(rng.integers(0, 2, size=(k, b, cfg.tbs), dtype=np.uint8)).to(dev)
    rnti = torch.full((k, b), RNTI, dtype=torch.int64, device=dev)
    w = torch.eye(cfg.nof_layers, cfg.nof_ports, dtype=torch.complex64, device=dev)
    energy = cell.encode_slots_scan(tb, rnti, w, cfg)
    each = torch.stack([torch.stack([(cell.encode_slot(tb[i, j], RNTI, w, cfg).abs() ** 2).sum()
                                     for j in range(b)]) for i in range(k)])
    torch.cuda.synchronize()
    rel = float(((energy - each).abs() / each).max())
    if tuple(energy.shape) != (k, b) or not rel <= P13_ENERGY_RTOL:
        fail(f"scan: encode_slots_scan energies {tuple(energy.shape)} off the per-slot "
             f"encodes by {rel:.3e} (want (k, B) within {P13_ENERGY_RTOL})")
    print(f"# scan: encode_slots_scan of {k} x {b} flagship slots: energies within {rel:.3e} "
          f"of the per-slot encode_slot's")

    # Every slot carries tb[0, 0], the decode scan's one expected payload.
    iq = cell.encode_slot(tb[0, 0].expand(b, -1).contiguous(), RNTI, w, cfg)
    sig_pow = (iq.abs() ** 2).mean(dim=(1, 2), keepdim=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    noise = torch.randn((k,) + tuple(iq.shape), dtype=torch.complex64, device=dev, generator=gen)
    rx = iq[None] + noise * torch.sqrt(sig_pow * 10.0 ** (-SNR_DB / 10.0))
    out = {}
    for name, demapper, want in (
            ("scan", "float", {"decode_dematch": k, "mmse_equalize": k}),
            ("scan_planes", "planes", {"decode_dematch_planes": k, "mmse_weights_4x4": k,
                                       "demap_planes": k})):
        c = cell.CellConfig(demapper=demapper)
        torch.cuda.synchronize()
        reset_counts()
        ok, errs = cell.decode_slots_scan(rx, rnti, tb[0, 0], c)
        torch.cuda.synchronize()
        out[name] = read_counts()
        expect_counts(f"{name} decode_slots_scan", out[name], want)
        if ok.dtype != torch.int32 or tuple(ok.shape) != (k, b) or not bool(ok.all()) \
                or bool(errs.any()):
            fail(f"{name}: crc_ok {ok.tolist()}, bit_errors {errs.tolist()}, want all 1 and 0")
        print(f"# {name}: decode_slots_scan of {k} x {b} flagship slots at {SNR_DB} dB: crc_ok "
              f"{ok.tolist()}, bit_errors {errs.tolist()}")

    # The kernels against their plain versions on chunk 0's tensors.
    pc = cfg.pusch_cfg
    grid = ofdm.demodulate_slot(rx[0], cfg.nof_rb, cfg.scs, cfg.dft_size, cfg.cp, 0,
                                f_center_hz=cfg.f_center_hz)
    gflat, h, nv = pusch._estimate_stage(grid, pc)
    k3_err = check_k3_on(h.transpose(1, 2), nv, "scan chunk 0 K3")[0]
    x_hat, eq_nvar = pusch._equalize_stage(gflat, h, nv, pc)
    llr_i8, _ = pusch._demap_stage(x_hat, eq_nvar, rnti[0], pc)
    bits, iters = sch_mod._fused_decode(llr_i8, pc.sch, pc.nof_ldpc_iterations,
                                        pc.ldpc_early_stop)
    k1_err = check_k1_batch(llr_i8, bits, iters, pc, "scan chunk 0")
    ppc = cell.CellConfig(demapper="planes").pusch_cfg
    ins, _ = pusch._plane_inputs(grid, rnti[0], ppc)
    k4_err = check_k4_on(ins, ppc.modulation, ppc.llr_range_limit, "scan chunk 0 K4")

    enc = cuda_ms(lambda: cell.encode_slots_scan(tb, rnti, w, cfg), reps=3) / k
    dec = cuda_ms(lambda: cell.decode_slots_scan(rx, rnti, tb[0, 0], cfg), reps=3) / k
    pcfg = cell.CellConfig(demapper="planes")
    decp = cuda_ms(lambda: cell.decode_slots_scan(rx, rnti, tb[0, 0], pcfg), reps=3) / k
    print(f"# [{card}] scans, {k} chunks of {b} flagship slots: encode_slots_scan {enc:.4f} ms "
          f"a chunk ({1000.0 * b / enc:.1f} slots/s), decode_slots_scan {dec:.4f} ms a chunk "
          f"({1000.0 * b / dec:.1f} slots/s), on the plane path {decp:.4f} ms a chunk "
          f"({1000.0 * b / decp:.1f} slots/s)")
    return out["scan"], out["scan_planes"], {"decode_dematch": k1_err, "mmse_weights_4x4": k3_err,
                                             "demap_planes": k4_err}


def parallel_phase(card: str, rank: int = 0, world: int = 1,
                   port: int | None = None) -> tuple[dict, dict, dict]:
    """Path 13 (b): the parallel layer on ``world`` ranks, one card each
    (NCCL; this rank on ``cuda:rank``, joined on localhost ``port`` when
    there are several), every rank drawing the same inputs from the same
    seeds: the halo-exchange smoothing against ``smooth_freq_reference``
    (no P2P on a world of one); ``sharded_transmit``'s block against its
    slice of ``pusch.transmit`` at the flagship's PUSCH config (273 PRB
    pad to 69 a shard on 4 ranks); the sharded front end against the
    port's unsharded one on the whole grid; ``sharded_decode`` with the
    whole TB decoded (K1) and with the codeblocks sharded (K2), each
    against the unsharded decode; K1 and K2 against their plain versions
    on the path's LLRs; on an even world the sp x dp composition on a (2,
    world/2) mesh; ``metrics_allreduce`` of a known batch.  The process
    group is destroyed in a ``finally``.  Returns both decodes' launch
    counts, the kernels' largest differences and this rank's results."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from srsran_project_tpu_torch.models import cell
    from srsran_project_tpu_torch.ops import scrambling
    from srsran_project_tpu_torch.parallel import (mesh, multihost, sharded_carrier,
                                                   sharded_encode, sharded_estimator)
    from srsran_project_tpu_torch.phy import pusch, sch as sch_mod

    dev_type = torch.device(DEVICE).type
    mesh.init_world(dev_type, rank=rank, world_size=world,
                    init_method=None if world == 1 else f"tcp://127.0.0.1:{port}")
    try:
        if dist.get_backend() != mesh.backend_of(dev_type) or dist.get_world_size() != world:
            fail(f"parallel: backend {dist.get_backend()}, world {dist.get_world_size()}, "
                 f"want {mesh.backend_of(dev_type)} and {world} ranks")
        sp = init_device_mesh(dev_type, (world,), mesh_dim_names=("sp",))
        dev = mesh.device_of(sp)
        res = {"rank": rank, "device": str(dev)}
        tag = f"parallel rank {rank} of {world}"

        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 13)
        h = torch.randn((3, world * 64), dtype=torch.complex64, device=dev, generator=gen)
        dp = mesh.make_mesh(tp=1, device_type=dev_type)
        mine = slice(rank * 64, (rank + 1) * 64)
        err = float((sharded_estimator.smooth_freq_sharded(h[:, mine], dp, "dp")
                     - sharded_estimator.smooth_freq_reference(h)[:, mine]).abs().max())
        if err > P13_HALO_ATOL:
            fail(f"{tag}: halo-exchange smoothing off by {err} (want {P13_HALO_ATOL})")
        res["halo_err"] = err

        cfg = cell.CellConfig().pusch_cfg
        sharded_carrier._check_shardable(cfg, world)  # raises naming the field it refuses
        rng = np.random.default_rng(SEED + 14)
        tb = torch.from_numpy(rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8)).to(dev)
        rnti_t = torch.tensor([RNTI], device=dev)
        full = pusch.transmit(tb, rnti_t[0], cfg)
        block = sharded_encode.sharded_transmit(tb, RNTI, cfg, sp)
        want_block = sharded_encode.sc_slice(full, sp)
        if block.device != dev or not torch.equal(block, want_block):
            fail(f"{tag}: sharded_transmit's block differs from its slice of pusch.transmit's "
                 f"grid (max {float((block - want_block).abs().max()):.3e})")
        gen.manual_seed(SEED + 14)
        sig_pow = (full.abs() ** 2).mean()
        rx_full = full + torch.randn(full.shape, dtype=torch.complex64, device=dev,
                                     generator=gen) * torch.sqrt(sig_pow * 10.0 ** (-SNR_DB / 10.0))
        rx = sharded_encode.sc_slice(rx_full, sp)
        res["local_sc"] = rx.shape[-1]

        # The unsharded front end and decode of the same grid.
        llr_u, nv_u, snr_u = pusch._front_end(rx_full[None], rnti_t, cfg)
        ref = {k: v[0] for k, v in pusch.process(rx_full[None], rnti_t, cfg).items()
               if k in ("tb_bits", "tb_crc_ok", "noise_var", "snr_db")}
        llr, nv, snr = sharded_carrier.sharded_front_end(rx, cfg, sp)
        llr = scrambling.descramble_llrs(llr, pusch._pusch_c_init(rnti_t[0], cfg.n_id))
        diff = (llr.int() - llr_u[0].int()).abs()
        equal = float((diff == 0).float().mean())
        rel = [float((a - b).abs() / b.abs()) for a, b in ((nv, nv_u[0]), (snr, snr_u[0]))]
        torch.cuda.synchronize()
        if int(diff.max()) > 1 or equal < P13_LLR_EQUAL or max(rel) > P13_METRIC_RTOL:
            fail(f"{tag}: sharded front end LLRs max |d| {int(diff.max())}, {equal:.5f} "
                 f"equal, noise variance / SNR off by {rel} against the unsharded (want 1, "
                 f"{P13_LLR_EQUAL}, {P13_METRIC_RTOL})")
        res.update(llr_max_diff=int(diff.max()), llr_equal=equal, metric_rel=max(rel))
        res["front_end_ms"] = cuda_ms(lambda: sharded_carrier.sharded_front_end(rx, cfg, sp), 3)
        print(f"# [{card}] {tag}: halo smoothing within {err:.2e}; sharded front end "
              f"({rx.shape[-1]} subcarriers a rank) against the unsharded: LLRs within "
              f"{int(diff.max())}, {100 * equal:.4f} % equal; noise variance and SNR within "
              f"{max(rel):.2e}; {res['front_end_ms']:.4f} ms a call")

        counts, errs = {}, {}
        for sharded_ldpc, name, want in ((False, "parallel_k1", {"decode_dematch": 1}),
                                         (True, "parallel_k2", {"decode": 1})):
            torch.cuda.synchronize()
            reset_counts()
            out = sharded_carrier.sharded_decode(rx, RNTI, cfg, sp, sharded_ldpc=sharded_ldpc)
            torch.cuda.synchronize()
            counts[name] = read_counts()
            expect_counts(f"{tag} {name} sharded_decode(sharded_ldpc={sharded_ldpc})",
                          counts[name], want)
            if not (bool(out["tb_crc_ok"]) and torch.equal(out["tb_bits"], tb)
                    and torch.equal(out["tb_bits"], ref["tb_bits"])
                    and bool(ref["tb_crc_ok"])):
                fail(f"{tag} {name}: CRC {bool(out['tb_crc_ok'])} (unsharded "
                     f"{bool(ref['tb_crc_ok'])}), TB bits equal to the sent / unsharded: "
                     f"{torch.equal(out['tb_bits'], tb)} / "
                     f"{torch.equal(out['tb_bits'], ref['tb_bits'])}")
            for key in ("noise_var", "snr_db"):
                r = float((out[key] - ref[key]).abs() / ref[key].abs())
                if r > P13_METRIC_RTOL:
                    fail(f"{tag} {name}: {key} {float(out[key])} against the unsharded "
                         f"{float(ref[key])}")
            res[f"{name}_ms"] = cuda_ms(lambda: sharded_carrier.sharded_decode(
                rx, RNTI, cfg, sp, sharded_ldpc=sharded_ldpc), 3)
            print(f"# [{card}] {tag} {name}: sharded_decode(sharded_ldpc={sharded_ldpc}) of "
                  f"the flagship grant: CRC ok, TB bits equal to the unsharded decode's, "
                  f"{res[name + '_ms']:.4f} ms a call")

        # K1 and K2 against their plain versions on the sharded path's LLRs.
        sc = cfg.sch
        bits, iters = sch_mod._fused_decode(llr[None], sc, cfg.nof_ldpc_iterations, False)
        errs["decode_dematch"] = check_k1_batch(
            llr[None], bits, iters, dataclasses.replace(cfg, ldpc_early_stop=False),
            f"{tag} K1")
        flat = sch_mod._dematch_stage(llr, None, sc)
        errs["decode"] = check_k2(flat, sc.seg.base_graph, sc.seg.lifting_size, None,
                                  f"{tag} sharded codeblocks")

        if world % 2 == 0:
            m2 = init_device_mesh(dev_type, (2, world // 2), mesh_dim_names=("sp", "dp"))
            block2 = sharded_encode.sharded_transmit(tb, RNTI, cfg, m2, cb_axis="dp",
                                                     sc_axis="sp")
            if not torch.equal(block2, sharded_encode.sc_slice(full, m2, "sp")):
                fail(f"{tag}: the sp x dp encode's block differs from pusch.transmit's slice")
            out = sharded_carrier.sharded_decode(sharded_encode.sc_slice(rx_full, m2, "sp"),
                                                 RNTI, cfg, m2, axis="sp", sharded_ldpc=True,
                                                 decode_axis=("sp", "dp"))
            if not (bool(out["tb_crc_ok"]) and torch.equal(out["tb_bits"], tb)):
                fail(f"{tag}: the sp x dp decode: CRC {bool(out['tb_crc_ok'])}")
            print(f"# {tag}: sp x dp on a (2, {world // 2}) mesh: the encode's block and the "
                  f"decode's TB right")

        hm = multihost.host_mesh(nof_hosts=2 if world % 2 == 0 else 1, device_type=dev_type)
        cells = torch.arange(8.0, device=dev).reshape(8, 1)
        per = 8 // world
        total = multihost.metrics_allreduce(hm)(multihost.global_batch(
            hm, cells[rank * per : (rank + 1) * per]))
        if total.device != dev or total.tolist() != [[28.0]]:
            fail(f"{tag}: metrics_allreduce of 0..7 gave {total.tolist()} on {total.device}")
        print(f"# {tag}: host_mesh {tuple(hm.mesh.shape)} {hm.mesh_dim_names}, "
              f"metrics_allreduce of 0..7 over 8 cells: {total.tolist()} on {total.device}")
        return counts, errs, res
    finally:
        dist.destroy_process_group()


def parallel_ranks(world: int) -> int:
    """Path 13 (b) on ``world`` cards of one host: the kernels built once,
    then ``world`` processes of this script (``--rank r``), one NCCL rank
    a card, joined on a free localhost port; each rank's output is printed
    after the cards' names and power limits, and the run fails if a rank
    failed or did not end within ``P13_RANKS_TIMEOUT_S``."""
    import socket
    import tempfile

    import torch

    from srsran_project_tpu_torch.ops import cuda_lib

    if torch.cuda.device_count() < world:
        fail(f"parallel: {torch.cuda.device_count()} cards, want {world}")
    for i in range(world):
        print(f"# card {i}: {card_line(i)}")
    cuda_lib.library()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--world", str(world),
                               "--rank", str(r), "--port", str(port)], stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True, cwd=here)
             for r in range(world)]
    bad = []
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, P13_RANKS_TIMEOUT_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                bad.append(f"rank {r} did not end in {P13_RANKS_TIMEOUT_S} s")
                continue
            if p.returncode:
                bad.append(f"rank {r} rc {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, log in enumerate(logs):
        log.seek(0)
        print(f"# ---- rank {r}\n{log.read()[-6000:]}", end="")
        log.close()
    if bad:
        fail(f"parallel on {world} cards: {'; '.join(bad)}")
    print(f"# parallel on {world} cards: every rank passed, {time.perf_counter() - t0:.1f} s")
    return 0


def split_phase(card: str) -> None:
    """Path 13 (c): the port's cu_sim and du_sim as two processes on a free
    UDP port, ``P13_UES`` UEs attached, each with DRB 1."""
    import socket

    here = os.path.dirname(os.path.abspath(__file__))
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=here)
    app = [sys.executable, "-m", "srsran_project_tpu_torch.apps."]
    t0 = time.perf_counter()
    cu = subprocess.Popen([*app[:-1], app[-1] + "cu_sim", "--f1-port", str(port),
                           "--expect-ues", str(P13_UES), "--timeout", "60"],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=here,
                          env=env)
    try:
        first = cu.stdout.readline()
        if "F1-C listening" not in first:
            fail(f"split: cu_sim did not come up: {first!r} {cu.stderr.read()[-2000:]}")
        du = subprocess.run([*app[:-1], app[-1] + "du_sim", "--cu-port", str(port), "--ues",
                             str(P13_UES), "--timeout", "60"], capture_output=True, text=True,
                            timeout=120, cwd=here, env=env)
        cu_out, cu_err = cu.communicate(timeout=120)
    finally:
        if cu.poll() is None:
            cu.kill()
            cu.communicate()
    if du.returncode or cu.returncode:
        fail(f"split: du_sim rc {du.returncode}, cu_sim rc {cu.returncode}\n{du.stdout}"
             f"{du.stderr[-2000:]}{cu_out}{cu_err[-2000:]}")
    du_res, cu_res = json.loads(du.stdout.splitlines()[-1]), json.loads(cu_out.splitlines()[-1])
    drbs = [[d["drb_id"] for d in u["drbs"]] for u in du_res["ues"]]
    if not (du_res["ok"] and cu_res["ok"] and drbs == [[1]] * P13_UES
            and cu_res["connected_ues"] == list(range(1, P13_UES + 1))
            and all(u["state"] == "connected" for u in du_res["ues"])):
        fail(f"split: du_sim {du_res}, cu_sim {cu_res}")
    print(f"# [{card}] split: cu_sim and du_sim as two processes over UDP: {P13_UES} UEs "
          f"connected, DRB ids {drbs}, sessions {cu_res['sessions']}, "
          f"{time.perf_counter() - t0:.2f} s with the interpreters' start")


def p13_replay_run(recorder, threaded: bool) -> list:
    """``P13_REPLAY_SLOTS`` UL slots through the port's UpperPhy on the card,
    one per thread when ``threaded``, tapped by ``recorder``; returns each
    slot's CRC, and slot 0's received grid and PUSCH PDU."""
    import threading

    import torch

    from srsran_project_tpu_torch.fapi import messages as fapi
    from srsran_project_tpu_torch.models import cell
    from srsran_project_tpu_torch.phy import pdsch
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig
    from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing
    from srsran_project_tpu_torch.ran.slot_point import SlotPoint

    dev = torch.device(DEVICE)
    c = cell.CellConfig(nof_ports=1, nof_layers=1)
    phy = UpperPhy(UpperPhyConfig(nof_ports=1, nof_grid_sc=c.nof_sc, device=DEVICE))
    phy.add_tap(recorder.tap)
    grids = []
    for i in range(P13_REPLAY_SLOTS):  # per-slot seeds: the same inputs every run
        rng = np.random.default_rng(SEED + 100 + i)
        tb = torch.from_numpy(rng.integers(0, 2, size=(c.tbs,), dtype=np.uint8)).to(dev)
        g = pdsch.process(tb, 0x41 + i, torch.eye(1, dtype=torch.complex64), c.pdsch_cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 100 + i)
        scale = torch.sqrt((g.abs() ** 2).mean() * 10.0 ** (-SNR_DB / 10.0))
        grids.append(g + scale * torch.randn(g.shape, dtype=torch.complex64, device=dev,
                                             generator=gen))
    torch.cuda.synchronize()
    crc = [None] * P13_REPLAY_SLOTS
    pdus = [fapi.UlPuschPdu(c.pusch_cfg, 0x41 + i, harq_id=0) for i in range(len(grids))]

    def one_slot(i):
        req = fapi.UlTtiRequest(slot=SlotPoint.from_sfn_slot(SubcarrierSpacing.KHZ30, 0, i),
                                pusch=[pdus[i]])
        crc[i] = phy.process_ul_tti(req, grids[i]).crc[0].tb_crc_ok

    if threaded:
        threads = [threading.Thread(target=one_slot, args=(i,)) for i in range(len(grids))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        if any(t.is_alive() for t in threads):
            fail("replay: a slot's thread did not finish in 120 s")
    else:
        for i in range(len(grids)):
            one_slot(i)
    torch.cuda.synchronize()
    return crc, grids[0], pdus[0]


def replay_phase(card: str) -> tuple[dict, dict, float]:
    """Path 13 (d): the port's UpperPhy on the card over ``P13_REPLAY_SLOTS``
    UL slots, sequentially and then from one thread a slot: both runs
    CRC-clean, K1 once a slot, and ``diff_traces`` of their tapped digests
    empty; K1 against its plain version on slot 0's grant (1 port, 1
    layer, 273 PRB, 256QAM).  Returns both runs' launch counts and K1's
    largest bit difference."""
    import torch

    from srsran_project_tpu_torch.support import replay

    counts, recs = {}, {}
    for name, threaded in (("replay_sequential", False), ("replay_threaded", True)):
        recs[name] = replay.SlotRecorder()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        crc, grid0, pdu0 = p13_replay_run(recs[name], threaded)
        dt = time.perf_counter() - t0
        counts[name] = read_counts()
        expect_counts(name, counts[name], {"decode_dematch": P13_REPLAY_SLOTS})
        if crc != [True] * P13_REPLAY_SLOTS:
            fail(f"{name}: CRCs {crc}")
        print(f"# [{card}] {name}: {P13_REPLAY_SLOTS} UL slots through UpperPhy on the card "
              f"(273 PRB, 1 port), CRC {crc}, {len(recs[name].entries)} taps, {dt:.3f} s with "
              f"the grids' set-up")
    problems = replay.diff_traces(recs["replay_sequential"], recs["replay_threaded"])
    if problems:
        fail("replay: the threaded run's digests differ from the sequential golden:\n  "
             + "\n  ".join(problems))
    print("# replay: diff_traces(sequential, threaded) is empty")
    k1_err = check_k1_grant(grid0, pdu0, "replay slot 0")
    return counts["replay_sequential"], counts["replay_threaded"], k1_err


def positioning_phase(card: str) -> dict:
    """Path 13 (e): three TRPs through ``PositioningProcedure`` with
    ``prs_toa_estimate`` on the card (a 273-PRB comb-4 PRS each, delayed
    and at 20 dB): every RSTD within ``P13_RSTD_TOL`` samples of the true
    delays; no kernel.  Returns the launch counts."""
    import torch

    from srsran_project_tpu_torch.l3 import messages as m
    from srsran_project_tpu_torch.l3 import positioning as pos
    from srsran_project_tpu_torch.phy import ptrs_prs

    dev = torch.device(DEVICE)
    cfg = ptrs_prs.PrsConfig(**P13_PRS)
    dft = 4096
    base = ptrs_prs.generate_prs(cfg, device=dev)
    k = torch.arange(cfg.nof_grid_sc, device=dev, dtype=torch.float64)
    devices = []

    def measure(trp):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 200 + trp)
        phase = torch.polar(torch.ones_like(k), -2 * math.pi * k * P13_DELAYS[trp] / dft)
        noise = torch.randn(base.shape, dtype=torch.complex64, device=dev, generator=gen)
        grid = base * phase.to(torch.complex64) + noise * math.sqrt(10 ** (-20 / 10))
        devices.append(grid.device.type)
        return ptrs_prs.prs_toa_estimate(grid, cfg, dft_size=dft)

    proc = pos.PositioningProcedure(measure)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    resp = m.decode(proc.rx(m.encode(pos.PositioningMeasurementRequest(
        lmf_meas_id=13, trp_ids=sorted(P13_DELAYS)))))
    dt = time.perf_counter() - t0
    counts = read_counts()
    expect_counts("positioning", counts, {})
    rstd = {x["trp_id"]: x["rstd_samples"] for x in resp.measurements}
    first = min(P13_DELAYS)
    off = {t: rstd[t] - (P13_DELAYS[t] - P13_DELAYS[first]) for t in P13_DELAYS}
    if devices != [dev.type] * len(P13_DELAYS) or max(abs(v) for v in off.values()) > P13_RSTD_TOL:
        fail(f"positioning: RSTD {rstd} against delays {P13_DELAYS} on {devices}")
    print(f"# [{card}] positioning: 3 TRPs through PositioningProcedure on the card, RSTD "
          f"{ {t: round(v, 3) for t, v in rstd.items()} } samples (off the true delays by at "
          f"most {max(abs(v) for v in off.values()):.3f}), {1e3 * dt:.3f} ms for the request")
    return counts


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="The port's smoke run on the card: every path, or "
                                 "with --world N path 13 (b) alone on N cards of this host.")
    ap.add_argument("--world", type=int, default=1,
                    help="run only the parallel layer, one NCCL rank a card on this many cards")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)  # one rank of --world
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs an NVIDIA GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "srsran_project_tpu_torch")):
        fail("run from a checkout of the repository (srsran_project_tpu_torch/ missing)")
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if args.rank is not None:
        print(json.dumps(parallel_phase(card_line(args.rank), args.rank, args.world,
                                        args.port)[2]))
        return 0
    if args.world > 1:
        return parallel_ranks(args.world)
    card = card_line()
    print(f"# card: {card}")
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from srsran_project_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"# kernels ready in {time.perf_counter() - t0:.1f} s: {cuda_lib.build_dir()}")
    for log in sorted(cuda_lib.build_dir().glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"#   ptxas {log.stem}: {line.strip()}")

    kernels = kernel_phase(card)
    per_path = {}
    per_path["flagship"], (rx, tb, float_bits) = slice_phase(card)
    per_path["ul_slot"], k2_err = ul_slot_phase(card)
    errs = {"decode": k2_err}
    per_path["plane"], plane_errs = plane_phase(card, rx, tb, float_bits)
    errs.update(plane_errs)
    per_path["ul_slot_uci"], k2_err4 = ul4_phase(card)
    errs["decode"] = max(errs["decode"], k2_err4)
    per_path["shapes"], errs5, times5 = shapes_phase(card)
    for name, err in errs5.items():
        errs[name] = max(errs.get(name, 0.0), err)
    per_path["fapi_dl_tti"] = fapi_dl_phase(card)
    per_path["fapi_ul_tti"], errs6 = fapi_ul_phase(card)
    for name, err in errs6.items():
        errs[name] = max(errs.get(name, 0.0), err)
    per_path["du_low_sim"] = app_phase(card)
    per_path["prach_ul_tti"], per_path["prach_only"], errs7, times7 = prach_ul_phase(card)
    for name, err in errs7.items():
        errs[name] = max(errs.get(name, 0.0), err)
    per_path["pucch_f34"], per_path["pucch_f1_batch"] = pucch_f34_phase(card)
    per_path["prs"] = prs_phase(card)
    (per_path["refmodes_a"], per_path["refmodes_b"], per_path["refmodes_c"],
     per_path["refmodes_d"], errs8, times8) = refmodes_phase(card)
    for name, err in errs8.items():
        errs[name] = max(errs.get(name, 0.0), err)
    per_path["sched_app_tdd"], per_path["sched_app_cells"], k2_err9 = sched_app_phase(card)
    errs["decode"] = max(errs["decode"], k2_err9)
    per_path["sched_pipeline"], errs9 = sched_pipeline_phase(card)
    for name, err in errs9.items():
        errs[name] = max(errs.get(name, 0.0), err)
    per_path["access"], errs10 = access_phase(card)
    per_path["slicing"], _slicing_ms, errs10b = slicing_phase(card)
    for name, err in list(errs10.items()) + list(errs10b.items()):
        errs[name] = max(errs.get(name, 0.0), err)
    helpers_phase(card, rx)
    per_path["ru_generic"], errs11a = ru_generic_phase(card)
    per_path["ru_ofh"], errs11b = ru_ofh_phase(card)
    per_path["ru_tdl"], errs11c = ru_tdl_phase(card)
    per_path["ru_sched"] = ru_sched_phase(card)
    for name, err in list(errs11a.items()) + list(errs11b.items()) + list(errs11c.items()):
        errs[name] = max(errs.get(name, 0.0), err)
    per_path["gnb"], k2_err12 = gnb_phase(card)
    errs["decode"] = max(errs["decode"], k2_err12)
    per_path["gnb_tdla"], per_path["gnb_testmode"] = gnb_more_phase(card)
    t13 = time.perf_counter()
    per_path["scan"], per_path["scan_planes"], errs13a = scan_phase(card)
    counts13b, errs13b, _res13b = parallel_phase(card)
    per_path.update(counts13b)
    for name, err in list(errs13a.items()) + list(errs13b.items()):
        errs[name] = max(errs.get(name, 0.0), err)
    split_phase(card)
    per_path["replay_sequential"], per_path["replay_threaded"], k1_err13d = replay_phase(card)
    errs["decode_dematch"] = max(errs["decode_dematch"], k1_err13d)
    per_path["positioning"] = positioning_phase(card)
    print(f"# path 13 took {time.perf_counter() - t13:.1f} s")
    # Each kernel's launches on the path it serves (one call of it), and
    # on every path.
    home = {"decode_dematch": "flagship", "mmse_weights_4x4": "plane", "decode": "ul_slot",
            "mmse_equalize": "flagship",
            "decode_dematch_planes": "plane", "demap_planes": "plane", "demap_llrs": "flagship",
            "pucch_f2_rx": "ul_slot_uci", "pusch_estimate": "flagship"}
    for k in kernels:
        k["launches"] = per_path[home[k["name"]]][k["name"]]
        k["launches_per_path"] = {path: c[k["name"]] for path, c in per_path.items()
                                  if k["name"] in c}
        k["max_abs_err"] = max(k["max_abs_err"], errs.get(k["name"], 0.0))
        if k["name"] in times5:  # device ms and bound at path 5's shapes
            k["shapes_ms"] = times5[k["name"]]
        if k["name"] in times7:  # and on path 7 (a)'s inputs
            k["prach_ul_tti_ms"] = times7[k["name"]]
        if k["name"] in times8:  # device ms and bound on path 8's inputs
            k["refmodes_ms"], k["refmodes_bound_ms"] = times8[k["name"]]
    print(f"# chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
