"""Remote control WebSocket server.

A copy of ``srsran_project_tpu/support/remote_server.py``.

Counterpart of the reference's remote control service
(apps/services/remote_control/remote_server.cpp:34 — a uWebSockets app):
clients connect over WebSocket and send JSON commands
``{"cmd": "<name>", ...}``; the server answers
``{"cmd": <name>, "timestamp": ...}`` on success or
``{"error": <msg>, "cmd": <name>, "timestamp": ...}`` on failure, and
broadcasts the periodic metrics JSON lines to subscribed clients.

Built-in commands mirror the reference: ``quit`` (remote_server.cpp
quit_remote_command — stops the app), ``metrics_subscribe`` /
``metrics_unsubscribe`` (remote_server.cpp metrics_*_command). Apps
register extra commands as name -> callable(payload dict) like the
reference's remote_command plugins.

The WebSocket layer is a dependency-free RFC 6455 implementation
(handshake + text/ping/close frames), standing in for the vendored
uWebSockets.
"""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
import threading
import time
from typing import Callable

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# Frame opcodes (RFC 6455 §5.2).
_OP_TEXT = 0x1
_OP_CLOSE = 0x8
_OP_PING = 0x9
_OP_PONG = 0xA


def _timestamp() -> float:
    return time.time()


def _accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _WS_MAGIC).encode()).digest()
    return base64.b64encode(digest).decode()


def _encode_frame(payload: bytes, opcode: int = _OP_TEXT, mask: bool = False) -> bytes:
    head = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head.append(mask_bit | n)
    elif n < 1 << 16:
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = struct.pack(">I", int(time.monotonic_ns()) & 0xFFFFFFFF)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _decode_frame(sock: socket.socket) -> tuple[int, bytes]:
    """Read one frame; returns (opcode, payload). Raises on close/EOF."""
    b0, b1 = _read_exact(sock, 2)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", _read_exact(sock, 2))
    elif n == 127:
        (n,) = struct.unpack(">Q", _read_exact(sock, 8))
    key = _read_exact(sock, 4) if masked else None
    payload = _read_exact(sock, n)
    if key:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, payload


class RemoteServer:
    """WebSocket JSON-command server with metrics broadcast.

    commands: extra name -> callable(payload: dict) -> None | str handlers;
    a handler may raise ValueError to produce an error response (the
    reference's error_type<std::string> return).
    """

    def __init__(
        self,
        bind_addr: str = "127.0.0.1",
        port: int = 0,
        commands: dict[str, Callable[[dict], object]] | None = None,
        on_quit: Callable[[], None] | None = None,
        enable_metrics_subscription: bool = True,
    ):
        self._commands = dict(commands or {})
        self._on_quit = on_quit
        self._enable_metrics = enable_metrics_subscription
        self._subscribers: set[socket.socket] = set()
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((bind_addr, port))
        self._lsock.listen(8)
        self.port = self._lsock.getsockname()[1]
        self._threads: list[threading.Thread] = []
        self._accept_thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def stop(self) -> None:
        """Stop accepting, end every client connection and join the server's
        threads.  Closing a listening socket does not wake a thread blocked
        in ``accept`` on Linux (nor closing a connection one blocked in
        ``recv``): each is shut down first."""
        self._stopping.set()
        with self._lock:
            socks = [self._lsock, *self._conns]
            self._subscribers.clear()
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2)
        for t in self._threads:
            t.join(timeout=2)

    # -- metrics fan-out ----------------------------------------------------

    def broadcast_metrics(self, json_line: str) -> None:
        """Send a metrics JSON line to every subscribed client
        (the reference's remote_server_sink write path)."""
        frame = _encode_frame(json_line.encode())
        with self._lock:
            socks = list(self._subscribers)
        for s in socks:
            try:
                s.sendall(frame)
            except OSError:
                with self._lock:
                    self._subscribers.discard(s)

    # -- internals -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            with self._lock:
                if self._stopping.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            t = threading.Thread(target=self._serve_client, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _handshake(self, conn: socket.socket) -> bool:
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = conn.recv(4096)
            if not chunk:
                return False
            data += chunk
        headers = {}
        for line in data.decode(errors="replace").split("\r\n")[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        key = headers.get("sec-websocket-key")
        if not key:
            conn.sendall(b"HTTP/1.1 400 Bad Request\r\n\r\n")
            return False
        resp = (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {_accept_key(key)}\r\n\r\n"
        )
        conn.sendall(resp.encode())
        return True

    def _respond(self, conn: socket.socket, obj: dict) -> None:
        obj["timestamp"] = _timestamp()
        conn.sendall(_encode_frame(json.dumps(obj).encode()))

    def _execute(self, conn: socket.socket, text: str) -> None:
        try:
            msg = json.loads(text)
        except json.JSONDecodeError:
            self._respond(conn, {"error": "Invalid JSON command"})
            return
        if not isinstance(msg, dict) or "cmd" not in msg:
            self._respond(conn, {"error": "Command is missing the cmd field"})
            return
        name = msg["cmd"]
        if name == "quit":
            self._respond(conn, {"cmd": name})
            if self._on_quit:
                self._on_quit()
            return
        if name == "metrics_subscribe" and self._enable_metrics:
            with self._lock:
                self._subscribers.add(conn)
            self._respond(conn, {"cmd": name})
            return
        if name == "metrics_unsubscribe" and self._enable_metrics:
            with self._lock:
                self._subscribers.discard(conn)
            self._respond(conn, {"cmd": name})
            return
        handler = self._commands.get(name)
        if handler is None:
            self._respond(conn, {"error": f"Unknown command: {name}", "cmd": name})
            return
        try:
            result = handler(msg)
        except ValueError as e:  # handler-signalled error (error_type return)
            self._respond(conn, {"error": str(e), "cmd": name})
            return
        resp = {"cmd": name}
        if isinstance(result, dict):
            resp.update(result)
        self._respond(conn, resp)

    def _serve_client(self, conn: socket.socket) -> None:
        try:
            if not self._handshake(conn):
                conn.close()
                return
            while not self._stopping.is_set():
                opcode, payload = _decode_frame(conn)
                if opcode == _OP_CLOSE:
                    conn.sendall(_encode_frame(payload, _OP_CLOSE))
                    break
                if opcode == _OP_PING:
                    conn.sendall(_encode_frame(payload, _OP_PONG))
                    continue
                if opcode == _OP_TEXT:
                    self._execute(conn, payload.decode())
        except (ConnectionError, OSError):
            pass
        finally:
            with self._lock:
                self._subscribers.discard(conn)
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass


class WsClient:
    """Minimal WebSocket client for tests and CLI tooling."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(b"srsran-tpu-ws-cli!").decode()
        req = (
            f"GET / HTTP/1.1\r\nHost: {host}:{port}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
        )
        self.sock.sendall(req.encode())
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("handshake failed")
            data += chunk
        status = data.split(b"\r\n", 1)[0]
        if b"101" not in status:
            raise ConnectionError(f"handshake rejected: {status!r}")
        expect = _accept_key(key).encode()
        if expect not in data:
            raise ConnectionError("bad Sec-WebSocket-Accept")

    def send_json(self, obj: dict) -> None:
        self.sock.sendall(_encode_frame(json.dumps(obj).encode(), mask=True))

    def recv_json(self) -> dict:
        while True:
            opcode, payload = _decode_frame(self.sock)
            if opcode == _OP_TEXT:
                return json.loads(payload.decode())
            if opcode == _OP_CLOSE:
                raise ConnectionError("server closed")

    def command(self, cmd: str, **kw) -> dict:
        self.send_json({"cmd": cmd, **kw})
        return self.recv_json()

    def close(self) -> None:
        try:
            self.sock.sendall(_encode_frame(b"", _OP_CLOSE, mask=True))
        except OSError:
            pass
        self.sock.close()
