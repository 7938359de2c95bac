#!/usr/bin/env python3
"""du_sim — standalone DU with F1-C over UDP to a remote cu_sim.

Port of ``apps/du_sim.py`` (the reference's apps/du): brings the DU F1
agent up against a remote CU-CP, attaches --ues simulated UEs through the
full RRC choreography (containers riding the UDP F1 link), and reports.
The UEs are the port's own ``apps.ue_sim.UeRrcAgent``; the wire format is
the reference's, so either package's cu_sim can serve it.

Usage (after starting cu_sim):
  python -m srsran_project_tpu_torch.apps.du_sim --cu-addr 127.0.0.1 --cu-port 38472 --ues 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..l2 import security
from ..l3.cu_cp_sim import DuF1Sim
from ..l3.transport import UdpLink
from .ue_sim import UeRrcAgent


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cu-addr", default="127.0.0.1")
    ap.add_argument("--cu-port", type=int, default=38472)
    ap.add_argument("--ues", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)

    link = UdpLink(("127.0.0.1", 0), remote=(args.cu_addr, args.cu_port))
    try:
        return _run(link, args)
    finally:
        link.close()


def _run(link: UdpLink, args) -> int:
    du = DuF1Sim(send_to_cucp=link.send)
    link.rx_handler = du.rx

    du.setup(cells=[{"pci": 1, "nr_cgi": "00101-1", "dl_arfcn": 632628,
                     "bandwidth_rb": 52}])
    t0 = time.time()
    while not du.f1_ready and time.time() - t0 < args.timeout:
        link.poll()
    if not du.f1_ready:
        print(json.dumps({"ok": False, "reason": "F1 setup timeout"}), flush=True)
        return 1
    print("[du_sim] F1 up", flush=True)

    # NAS key agreement stand-in must mirror cu_sim's AmfSim derivation
    k_amf = bytes(range(32))
    ues = []
    for i in range(args.ues):
        ue = UeRrcAgent(du, c_rnti=0x4601 + i,
                        k_gnb_provider=lambda uid=i + 1: security.kdf(
                            k_amf, 0x6E, uid.to_bytes(4, "big")))
        ue.connect()
        ues.append(ue)
    while time.time() - t0 < args.timeout:
        link.poll()
        if all(u.state == "connected" for u in ues):
            print(json.dumps({"ok": True,
                              "ues": [{"rnti": u.c_rnti, "state": u.state,
                                       "drbs": u.drb_configs} for u in ues]}), flush=True)
            return 0
    print(json.dumps({"ok": False, "reason": "attach timeout"}), flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
