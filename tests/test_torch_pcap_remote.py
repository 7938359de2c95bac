"""The port's pcap writers and remote-control WebSocket server against the
JAX package's.

The pcap files the port writes are byte-identical to the reference's for
the same packets and timestamps, and each package reads the other's; the
remote-control server speaks the same JSON over RFC 6455 to either
package's client.  Each test of the JAX package's ``tests/test_pcap.py``
and ``tests/test_remote_server.py`` has its counterpart here.  Every
client socket has a 5 s timeout and every wait a bound, so a hang fails
one test.
"""

import struct
import threading

import pytest

from srsran_project_tpu.support import pcap as jpcap
from srsran_project_tpu.support import remote_server as jremote
from srsran_project_tpu_torch.support import pcap
from srsran_project_tpu_torch.support import remote_server as remote
from srsran_project_tpu_torch.support.remote_server import RemoteServer, WsClient


def _same_file(tmp_path, write):
    """write(module, path) through both packages -> the two files' bytes."""
    a, b = tmp_path / "port.pcap", tmp_path / "ref.pcap"
    write(pcap, str(a))
    write(jpcap, str(b))
    return a.read_bytes(), b.read_bytes()


def test_pcap_container_roundtrip(tmp_path):
    def write(m, p):
        with m.PcapWriter(p, dlt=m.DLT_USER_0) as w:
            w.write_packet(b"hello", ts=1000.5)
            w.write_packet(b"\x00" * 32, ts=1001.0)

    mine, ref = _same_file(tmp_path, write)
    assert mine == ref
    dlt, pkts = pcap.read_pcap(str(tmp_path / "port.pcap"))
    assert dlt == pcap.DLT_USER_0
    assert [p for _, p in pkts] == [b"hello", b"\x00" * 32]
    assert abs(pkts[0][0] - 1000.5) < 1e-3
    assert jpcap.read_pcap(str(tmp_path / "port.pcap")) == (dlt, pkts)


def test_global_header_fields(tmp_path):
    p = str(tmp_path / "h.pcap")
    with pcap.PcapWriter(p, dlt=149) as w:
        w.write_packet(b"x")
    raw = open(p, "rb").read()
    magic, vmaj, vmin, _, _, snaplen, dlt = struct.unpack_from("<IHHiIII", raw)
    assert (magic, vmaj, vmin, snaplen, dlt) == (0xA1B2C3D4, 2, 4, 65535, 149)
    (tmp_path / "bad.pcap").write_bytes(b"\x00" * 24)
    with pytest.raises(ValueError, match="magic"):
        pcap.read_pcap(str(tmp_path / "bad.pcap"))


def test_mac_nr_framing_roundtrip(tmp_path):
    pdu = bytes(range(16))

    def write(m, p):
        with m.MacNrPcapWriter(p) as w:
            w.write_pdu(pdu, rnti=0x4601, direction=m.DIRECTION_DOWNLINK, harq_id=3, sfn=100,
                        slot=7, ueid=1, ts=5.25)

    mine, ref = _same_file(tmp_path, write)
    assert mine == ref
    dlt, pkts = pcap.read_pcap(str(tmp_path / "port.pcap"))
    assert dlt == pcap.DLT_USER_2
    ctx, got = pcap.parse_mac_nr_context(pkts[0][1])
    assert got == pdu
    assert ctx == {"radio_type": pcap.TDD_RADIO, "direction": pcap.DIRECTION_DOWNLINK,
                   "rnti_type": pcap.C_RNTI, "rnti": 0x4601, "ueid": 1, "harq_id": 3,
                   "sfn": 100, "slot": 7}
    assert jpcap.parse_mac_nr_context(pkts[0][1]) == (ctx, got)


def test_mac_nr_minimal_context(tmp_path):
    def write(m, p):
        with m.MacNrPcapWriter(p, radio_type=m.FDD_RADIO) as w:
            w.write_pdu(b"\xab", rnti=17, direction=m.DIRECTION_UPLINK, ts=1.0)

    mine, ref = _same_file(tmp_path, write)
    assert mine == ref
    _, pkts = pcap.read_pcap(str(tmp_path / "port.pcap"))
    ctx, got = pcap.parse_mac_nr_context(pkts[0][1])
    assert got == b"\xab" and ctx["rnti"] == 17 and ctx["radio_type"] == pcap.FDD_RADIO
    assert "harq_id" not in ctx and "sfn" not in ctx
    for bad in (b"xx", pcap.MAC_NR_START_STRING + b"\x01\x00\x03\x09"):
        with pytest.raises(ValueError):
            pcap.parse_mac_nr_context(bad)


def test_write_after_close_raises(tmp_path):
    w = pcap.PcapWriter(str(tmp_path / "c.pcap"))
    w.close()
    w.close()  # closing twice is harmless
    with pytest.raises(ValueError, match="closed"):
        w.write_packet(b"x")


def test_protocol_pcap_writers(tmp_path):
    """The per-protocol DLT writers (the reference's dlt_pcap_impl.cpp DLTs
    152-156) write the same files as the reference's.  The L3 and GTP-U
    layers that attach them in the JAX package are not ported yet."""
    for name, dlt in (("ngap", 152), ("e1ap", 153), ("f1ap", 154), ("e2ap", 155), ("gtpu", 156)):
        def write(m, p):
            with getattr(m, f"{name}_pcap")(p) as w:
                w.write_packet(name.encode() + b"-frame", ts=2.0)

        mine, ref = _same_file(tmp_path, write)
        assert mine == ref
        got_dlt, pkts = pcap.read_pcap(str(tmp_path / "port.pcap"))
        assert got_dlt == dlt == getattr(pcap, f"PCAP_{name.upper()}_DLT")
        assert pkts == [(2.0, name.encode() + b"-frame")]


# ---- remote control --------------------------------------------------------

@pytest.fixture
def server():
    """start(commands=..., on_quit=...) -> a started port RemoteServer,
    stopped after the test."""
    servers = []

    def start(**kw):
        srv = RemoteServer("127.0.0.1", 0, **kw)
        srv.start()
        servers.append(srv)
        return srv

    yield start
    for srv in servers:
        srv.stop()
        assert not srv._accept_thread.is_alive()
        assert not any(t.is_alive() for t in srv._threads)


def test_unknown_and_malformed_commands(server):
    srv = server()
    cli = WsClient("127.0.0.1", srv.port)
    try:
        resp = cli.command("no_such_cmd")
        assert resp["error"] == "Unknown command: no_such_cmd" and resp["cmd"] == "no_such_cmd"
        assert "timestamp" in resp
        cli.sock.sendall(remote._encode_frame(b"{not json", mask=True))
        assert cli.recv_json()["error"] == "Invalid JSON command"
        cli.send_json({"no": "cmd"})
        assert cli.recv_json()["error"] == "Command is missing the cmd field"
    finally:
        cli.close()


def test_custom_command_success_and_error(server):
    seen = {}

    def set_gain(msg):
        if "gain" not in msg:
            raise ValueError("missing gain field")
        seen["gain"] = msg["gain"]
        return {"applied": msg["gain"]}

    srv = server(commands={"tx_gain": set_gain})
    # The reference's client against the port's server: the same protocol.
    cli = jremote.WsClient("127.0.0.1", srv.port)
    try:
        resp = cli.command("tx_gain", gain=30.0)
        assert resp["cmd"] == "tx_gain" and resp["applied"] == 30.0
        assert seen["gain"] == 30.0
        assert cli.command("tx_gain")["error"] == "missing gain field"
        cli.sock.sendall(jremote._encode_frame(b"hi", remote._OP_PING, mask=True))
        assert remote._decode_frame(cli.sock) == (remote._OP_PONG, b"hi")
    finally:
        cli.close()


def test_metrics_subscribe_broadcast_unsubscribe(server):
    srv = server()
    sub = WsClient("127.0.0.1", srv.port)
    other = WsClient("127.0.0.1", srv.port)
    try:
        assert sub.command("metrics_subscribe")["cmd"] == "metrics_subscribe"
        srv.broadcast_metrics('{"m": 1}')
        assert sub.recv_json() == {"m": 1}
        assert other.command("no_cmd")["cmd"] == "no_cmd"
        assert sub.command("metrics_unsubscribe")["cmd"] == "metrics_unsubscribe"
        srv.broadcast_metrics('{"m": 2}')
        assert sub.command("nop").get("cmd") == "nop"
        # A line above 64 KiB takes the 64-bit length form.
        assert sub.command("metrics_subscribe")["cmd"] == "metrics_subscribe"
        line = '{"m": "' + "x" * 70000 + '"}'
        srv.broadcast_metrics(line)
        assert sub.recv_json()["m"] == "x" * 70000
    finally:
        sub.close()
        other.close()


def test_quit_invokes_callback(server):
    fired = threading.Event()
    srv = server(on_quit=fired.set)
    cli = WsClient("127.0.0.1", srv.port)
    try:
        assert cli.command("quit")["cmd"] == "quit"
        assert fired.wait(timeout=5)
    finally:
        cli.close()


def test_stop_ends_every_server_thread(server):
    """stop() wakes the accept thread and every client thread (shutdown
    before close) and joins them.  The reference's stop() closes the
    listening socket only, which does not wake a thread blocked in accept
    (it depends on where the thread is, so it is not pinned here; a fault
    the port repairs, ROADMAP Q3).  The port's client works against the
    reference's server."""
    srv = server()
    clients = [WsClient("127.0.0.1", srv.port) for _ in range(2)]
    try:
        assert clients[0].command("metrics_subscribe")["cmd"] == "metrics_subscribe"
        assert clients[1].command("nop")["cmd"] == "nop"
        srv.stop()
        assert not srv._accept_thread.is_alive()
        assert len(srv._threads) == 2 and not any(t.is_alive() for t in srv._threads)
        with pytest.raises(ConnectionError):
            clients[1].recv_json()
    finally:
        for c in clients:
            c.close()
    fired = threading.Event()
    jsrv = jremote.RemoteServer("127.0.0.1", 0, on_quit=fired.set)
    jsrv.start()
    try:
        cli = WsClient("127.0.0.1", jsrv.port)
        try:
            assert cli.command("quit")["cmd"] == "quit"
            assert fired.wait(timeout=5)
        finally:
            cli.close()
    finally:
        jsrv.stop()
