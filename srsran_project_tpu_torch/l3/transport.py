"""Control-plane byte transports: UDP datagram links for F1/NG/E1/E2.

Counterpart of the reference's SCTP/UDP gateways + io_broker
(lib/gateways/sctp_network_gateway_impl.cpp, SURVEY.md section 5.8): the
typed-JSON procedure messages (messages.py) ride real sockets so the
CU-CP / CU-UP / DU simulators can run disaggregated across processes
(apps/cu_sim.py + apps/du_sim.py), not just over in-process callables.

UDP datagrams stand in for SCTP streams (message-oriented, no segmentation
needed at these message sizes); a light length+seq header detects drops,
and poll() drains the socket into the registered handler — the io_broker
role, without a thread (callers pump it from their slot loop or use
serve() for a pump thread).

A copy of ``srsran_project_tpu/l3/transport.py`` (no JAX in it): the same
``!IH`` header, so the port's links talk to the reference's.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable

_HDR = struct.Struct("!IH")  # length, seq


class UdpLink:
    """One bidirectional message link over UDP."""

    def __init__(self, local: tuple[str, int], remote: tuple[str, int] | None = None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(local)
        self.sock.settimeout(0.2)
        self.remote = remote
        self._seq = 0
        self.rx_handler: Callable[[bytes], None] | None = None
        self.rx_count = 0
        self.lost = 0
        self._expect = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def local_port(self) -> int:
        return self.sock.getsockname()[1]

    def send(self, data: bytes) -> None:
        if self.remote is None:
            raise RuntimeError("UdpLink.send: remote not set")
        self.sock.sendto(_HDR.pack(len(data), self._seq & 0xFFFF) + data, self.remote)
        self._seq += 1

    def poll(self, max_msgs: int = 64) -> int:
        """Drain pending datagrams into rx_handler; returns count."""
        n = 0
        for _ in range(max_msgs):
            try:
                pkt, addr = self.sock.recvfrom(65536)
            except (socket.timeout, BlockingIOError):
                break
            if self.remote is None:
                self.remote = addr  # learn the peer (server role)
            length, seq = _HDR.unpack_from(pkt)
            body = pkt[_HDR.size : _HDR.size + length]
            if self._expect is not None and seq != self._expect:
                self.lost += (seq - self._expect) & 0xFFFF
            self._expect = (seq + 1) & 0xFFFF
            self.rx_count += 1
            n += 1
            if self.rx_handler:
                self.rx_handler(body)
        return n

    def serve(self) -> None:
        """Background pump thread (io_broker role)."""
        def loop():
            while not self._stop.is_set():
                self.poll()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)
        self.sock.close()
