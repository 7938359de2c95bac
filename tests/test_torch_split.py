"""The port's CU/DU split over UDP (``l3.transport`` and the apps
``cu_sim`` / ``du_sim``) against the reference's: the links' wire format,
an attach over a socket pair in one process, and the two apps as separate
processes, the port's against the reference's in both directions."""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

from srsran_project_tpu.l3 import transport as jtransport
from srsran_project_tpu_torch.apps.cu_sim import _CuUpStub
from srsran_project_tpu_torch.apps.ue_sim import UeRrcAgent
from srsran_project_tpu_torch.l2 import security
from srsran_project_tpu_torch.l3.cu_cp_sim import AmfSim, CuCpSim, CuUpE1Agent, DuF1Sim
from srsran_project_tpu_torch.l3.transport import UdpLink

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOF_UES = 2


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair(a_cls, b_cls):
    a = a_cls(("127.0.0.1", 0))
    b = b_cls(("127.0.0.1", 0), remote=("127.0.0.1", a.local_port))
    a.remote = ("127.0.0.1", b.local_port)
    return a, b


@pytest.mark.parametrize("tx,rx", [(UdpLink, UdpLink), (UdpLink, jtransport.UdpLink),
                                   (jtransport.UdpLink, UdpLink)],
                         ids=["port-port", "port-reference", "reference-port"])
def test_udp_link_roundtrip_and_loss_counter(tx, rx):
    """Frames cross between the packages' links; a gap in the sequence
    numbers counts as lost datagrams on the receiver, as the reference's
    link counts them."""
    a, b = _pair(tx, rx)
    try:
        got = []
        b.rx_handler = got.append
        a.send(b"hello")
        a.send(b"world")
        deadline = time.time() + 5
        while len(got) < 2 and time.time() < deadline:
            b.poll()
        assert got == [b"hello", b"world"] and b.lost == 0 and b.rx_count == 2
        a._seq += 3  # three datagrams never sent
        a.send(b"after")
        while len(got) < 3 and time.time() < deadline:
            b.poll()
        assert got[-1] == b"after" and b.lost == 3
    finally:
        a.close()
        b.close()


def test_link_header_is_the_reference_s():
    assert UdpLink.__module__.startswith("srsran_project_tpu_torch")
    from srsran_project_tpu_torch.l3 import transport

    assert transport._HDR.format == jtransport._HDR.format == "!IH"


def test_attach_over_udp_f1():
    """F1AP rides a real UDP socket pair between the port's CU-CP and DU,
    with the port's UE agent (the reference's test, on the port)."""
    cu_link, du_link = _pair(UdpLink, UdpLink)
    try:
        amf = AmfSim()
        cucp = CuCpSim(send_to_amf=lambda b: amf.rx(b), send_to_du=cu_link.send,
                       send_to_cuup=lambda b: e1.rx(b))
        amf.send = cucp.rx_from_amf
        e1 = CuUpE1Agent(send_to_cucp=cucp.rx_from_cuup, make_cu_up=_CuUpStub)
        du = DuF1Sim(send_to_cucp=du_link.send)
        cu_link.rx_handler = cucp.rx_from_du
        du_link.rx_handler = du.rx

        def pump():
            while cu_link.poll() + du_link.poll():
                pass

        cucp.start()
        du.setup(cells=[{"pci": 1, "nr_cgi": "x", "dl_arfcn": 1, "bandwidth_rb": 52}])
        pump()
        assert du.f1_ready and cucp.f1_cells
        ue = UeRrcAgent(du, c_rnti=0x4601, k_gnb_provider=lambda: security.kdf(
            amf.k_amf, 0x6E, (1).to_bytes(4, "big")))
        ue.connect()
        for _ in range(30):
            pump()
            if ue.state == "connected":
                break
        assert ue.state == "connected" and cucp.ues[1].state == "connected"
        assert amf.sessions_done == [1]
    finally:
        cu_link.close()
        du_link.close()


def _app(pkg: str, name: str, args: list) -> list:
    if pkg == "port":
        return [sys.executable, "-m", f"srsran_project_tpu_torch.apps.{name}", *args]
    return [sys.executable, os.path.join(REPO, "apps", f"{name}.py"), *args]


@pytest.mark.parametrize("cu,du", [("port", "port"), ("port", "reference"),
                                   ("reference", "port")])
def test_split_apps_interoperate(cu, du):
    """cu_sim and du_sim as two processes on a free port: every UE attaches
    with its DRB, whichever package each side comes from."""
    port = _free_udp_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    cu_p = subprocess.Popen(_app(cu, "cu_sim", ["--f1-port", str(port), "--expect-ues",
                                                str(NOF_UES), "--timeout", "60"]),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=REPO, env=env)
    try:
        # The CU is up once it prints its first line.
        assert "F1-C listening" in cu_p.stdout.readline()
        du_p = subprocess.run(_app(du, "du_sim", ["--cu-port", str(port), "--ues", str(NOF_UES),
                                                  "--timeout", "40"]),
                              capture_output=True, text=True, timeout=90, cwd=REPO, env=env)
        assert du_p.returncode == 0, du_p.stdout + du_p.stderr
        du_out = json.loads(du_p.stdout.splitlines()[-1])
        assert du_out["ok"]
        assert [u["rnti"] for u in du_out["ues"]] == [0x4601 + i for i in range(NOF_UES)]
        assert all(u["state"] == "connected" and [d["drb_id"] for d in u["drbs"]] == [1]
                   for u in du_out["ues"])
        cu_rest, cu_err = cu_p.communicate(timeout=60)
        assert cu_p.returncode == 0, cu_rest + cu_err
        cu_out = json.loads(cu_rest.splitlines()[-1])
        assert cu_out == {"connected_ues": [1, 2], "sessions": [1, 2], "ok": True}
    finally:
        if cu_p.poll() is None:
            cu_p.kill()
            cu_p.communicate()
