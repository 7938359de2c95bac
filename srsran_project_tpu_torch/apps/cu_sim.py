#!/usr/bin/env python3
"""cu_sim — standalone CU (CU-CP + CU-UP + AMF stub) with F1 over UDP.

Port of ``apps/cu_sim.py`` (the reference's apps/cu): terminates NG at an
in-process AMF simulator, serves F1-C on a UDP socket for a remote du_sim,
runs the full attach/bearer choreography, and exits once --expect-ues UEs
are connected (or after --timeout).  The wire format is the reference's
(``l3.transport``'s header, ``l3.messages``' framing), so either package's
du_sim can attach to it.

Usage:
  python -m srsran_project_tpu_torch.apps.cu_sim --f1-port 38472 --expect-ues 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..l3.cu_cp_sim import AmfSim, CuCpSim, CuUpE1Agent
from ..l3.transport import UdpLink


class _CuUpStub:
    def __init__(self, ue_id, keys, nea, nia):
        self.ue_id, self.keys, self.nea, self.nia = ue_id, keys, nea, nia
        self.pending_setup = None

    def on_f1u_dl_teids(self, teids):
        pass


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--f1-port", type=int, default=38472)
    ap.add_argument("--expect-ues", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)

    link = UdpLink(("127.0.0.1", args.f1_port))
    amf = AmfSim()
    cucp = CuCpSim(send_to_amf=lambda b: amf.rx(b), send_to_du=link.send,
                   send_to_cuup=lambda b: e1.rx(b))
    amf.send = cucp.rx_from_amf
    e1 = CuUpE1Agent(send_to_cucp=cucp.rx_from_cuup, make_cu_up=_CuUpStub)
    link.rx_handler = cucp.rx_from_du
    cucp.start()
    print(f"[cu_sim] NG up, F1-C listening on udp:{args.f1_port}", flush=True)

    try:
        t0 = time.time()
        while time.time() - t0 < args.timeout:
            link.poll()
            connected = [c.cu_ue_id for c in cucp.ues.values() if c.state == "connected"]
            if len(connected) >= args.expect_ues:
                print(json.dumps({"connected_ues": connected,
                                  "sessions": amf.sessions_done, "ok": True}), flush=True)
                return 0
        print(json.dumps({"connected_ues": [], "ok": False}), flush=True)
        return 1
    finally:
        link.close()


if __name__ == "__main__":
    sys.exit(main())
