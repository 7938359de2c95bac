"""srslog counterpart: asynchronous, channel-based structured logging.

The reference carries its own logging framework (srslog: lib/srslog/,
include/srsran/srslog/srslog.h) with log channels, severity levels, an
asynchronous backend (dedicated writer thread draining a lock-free queue so
the real-time path never blocks on IO), pluggable sinks, and text/JSON
formatters.  This module provides the same shape natively in Python:

- ``LogChannel``: named channel with a level; formatting is LAZY — the
  fmt/args tuple is enqueued and rendered on the backend thread, keeping
  the caller's cost to one queue put (the srslog real-time rule).
- ``Backend``: daemon writer thread draining a queue to sinks.
- Sinks: ``StreamSink`` (text lines), ``FileSink``, ``JsonSink`` (one JSON
  object per line — srslog's JSON formatter).
- ``fetch_channel(name)`` registry + ``set_level`` — srslog's
  fetch_basic_logger API shape.
- ``hex_dump(data)`` — srslog's byte-buffer dump formatting.

A copy of ``srsran_project_tpu/support/logger.py``.
"""

from __future__ import annotations

import json
import queue
import sys
import threading
import time
from typing import Any, TextIO

LEVELS = {"none": 0, "error": 1, "warning": 2, "info": 3, "debug": 4}


def hex_dump(data: bytes, max_bytes: int = 64) -> str:
    """srslog-style hex dump: space-separated bytes, elided after max_bytes."""
    shown = data[:max_bytes]
    s = " ".join(f"{b:02x}" for b in shown)
    if len(data) > max_bytes:
        s += f" ... ({len(data)} bytes)"
    return s


class StreamSink:
    """Text sink: ``<timestamp> [CHAN] [LEVEL] message``."""

    def __init__(self, stream: TextIO | None = None):
        self.stream = stream if stream is not None else sys.stderr

    def write(self, rec: dict) -> None:
        ts = time.strftime("%H:%M:%S", time.localtime(rec["ts"]))
        frac = int((rec["ts"] % 1) * 1e6)
        self.stream.write(
            f"{ts}.{frac:06d} [{rec['channel']:<8s}] [{rec['level'][0].upper()}] "
            f"{rec['msg']}\n")

    def flush(self) -> None:
        self.stream.flush()


class FileSink(StreamSink):
    def __init__(self, path: str):
        super().__init__(open(path, "a"))

    def close(self) -> None:
        self.stream.close()


class JsonSink:
    """One JSON object per line (srslog's JSON formatter shape)."""

    def __init__(self, stream: TextIO | None = None):
        self.stream = stream if stream is not None else sys.stderr

    def write(self, rec: dict) -> None:
        self.stream.write(json.dumps(rec, default=str) + "\n")

    def flush(self) -> None:
        self.stream.flush()


class Backend:
    """Asynchronous log backend: one daemon thread drains the record queue.

    Mirrors srslog's backend (lib/srslog/backend_worker.cpp): producers only
    enqueue (bounded queue, drop-on-full like srslog's non-blocking mode);
    the worker formats and writes."""

    def __init__(self, capacity: int = 8192):
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._sinks: list[Any] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None

    def add_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def _ensure_started(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="srslog-backend")
            self._thread.start()

    def push(self, rec_lazy: tuple) -> None:
        self._ensure_started()
        try:
            self._q.put_nowait(rec_lazy)
        except queue.Full:
            self._dropped += 1  # never block the real-time caller

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            ts, channel, level, fmt, args, ctx = item
            try:
                msg = fmt % args if args else str(fmt)
            except (TypeError, ValueError):
                msg = f"{fmt} {args}"
            rec = {"ts": ts, "channel": channel, "level": level, "msg": msg}
            if ctx:
                rec.update(ctx)
            with self._lock:
                sinks = list(self._sinks)
            for s in sinks:
                try:
                    s.write(rec)
                except Exception:
                    pass
            self._q.task_done()

    def flush(self) -> None:
        """Block until every queued record is written, then flush sinks."""
        if self._thread is None or not self._thread.is_alive():
            return
        self._q.join()
        with self._lock:
            sinks = list(self._sinks)
        for s in sinks:
            s.flush()


_default_backend = Backend()


class LogChannel:
    """Named log channel with a severity level and optional static context."""

    def __init__(self, name: str, backend: Backend | None = None,
                 level: str = "warning", context: dict | None = None):
        self.name = name
        self.backend = backend if backend is not None else _default_backend
        self.level = level
        self.context = context or {}

    def set_level(self, level: str) -> None:
        if level not in LEVELS:
            raise ValueError(f"unknown log level {level!r}")
        self.level = level

    def _log(self, level: str, fmt, *args, **ctx) -> None:
        if LEVELS[level] > LEVELS[self.level]:
            return
        merged = {**self.context, **ctx} if (self.context or ctx) else None
        self.backend.push((time.time(), self.name, level, fmt, args, merged))

    def error(self, fmt, *args, **ctx) -> None:
        self._log("error", fmt, *args, **ctx)

    def warning(self, fmt, *args, **ctx) -> None:
        self._log("warning", fmt, *args, **ctx)

    def info(self, fmt, *args, **ctx) -> None:
        self._log("info", fmt, *args, **ctx)

    def debug(self, fmt, *args, **ctx) -> None:
        self._log("debug", fmt, *args, **ctx)


_channels: dict[str, LogChannel] = {}
_registry_lock = threading.Lock()


def fetch_channel(name: str, level: str = "warning") -> LogChannel:
    """Get-or-create a channel by name (srslog::fetch_basic_logger shape)."""
    with _registry_lock:
        ch = _channels.get(name)
        if ch is None:
            ch = _channels[name] = LogChannel(name, level=level)
        return ch


def set_default_sink(sink) -> None:
    _default_backend.add_sink(sink)


def flush() -> None:
    _default_backend.flush()
