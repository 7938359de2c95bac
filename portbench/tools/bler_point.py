"""The block error rate of a single-UE configuration against its SNR, by
the benchmark's reference receiver, to find the SNR at which a cell sits
at an operating point (link adaptation aims at a BLER of 0.1, TS 38.214
5.2.2.1):

    python3 portbench/tools/bler_point.py --config <file> --snr 24,25,26 \
        --seed <n> --slots 64

For each SNR: ``--slots`` slots of the configuration's UE made by the
reference transmitter from the seed, received by the reference receiver
in float32.  One JSON line per SNR: the share of TBs whose CRC fails and
the LDPC iterations that the codeblocks needed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--snr", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--slots", type=int, default=64)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bler_point: needs a CUDA card", file=sys.stderr)
        return 2
    from portbench.harness import cells, yardstick
    from portbench.reference import link

    dev = torch.device("cuda", 0)
    base = json.loads((ROOT / args.config).read_text())
    card = yardstick.card_line()
    for snr in [float(s) for s in args.snr.split(",")]:
        config = dict(base, channel=dict(base["channel"], snr_db=snr))
        traffic = {"generator": "decode_slot", "slots_per_call": 8,
                   "pool_units": max(1, args.slots // 8)}
        entry = cells.generator(traffic["generator"]).Entry(config, traffic, args.seed, dev)
        want = entry.expected(list(range(entry.units)), link.FLOAT32)
        ok = torch.cat([want[u][0]["tb_crc_ok"].cpu() for u in want])
        needed = torch.cat([want[u][0]["iterations_needed"].cpu().flatten() for u in want])
        print(json.dumps({"snr_db": snr, "tbs": int(ok.numel()),
                          "bler": 1.0 - float(ok.float().mean()),
                          "iterations_needed_mean": float(needed.float().mean()),
                          "iterations_needed_max": int(needed.max()), "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
