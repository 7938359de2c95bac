"""Rx-timestamp-paced baseband processing loop.

A copy of ``srsran_project_tpu/phy/lower_loop.py``.

Counterpart of the reference lower_phy_baseband_processor
(lib/phy/lower/lower_phy_baseband_processor.cpp:52-196): an RX thread
pulls timestamped baseband buffers from the receiver gateway and feeds the
uplink processor; a TX thread produces downlink baseband ahead of time,
paced so the transmit timestamp never runs more than `rx_to_tx_max_delay`
samples ahead of the last received timestamp (bounded tx-buffer latency),
and stamps each transmission `tx_time_offset` samples into the future.

The heavy per-slot compute (OFDM modulate/demodulate + upper PHY) stays in
the device code handed in as callables; this loop is the real-time pacing
shell around them.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Protocol


class BasebandReceiver(Protocol):
    def receive(self) -> tuple[object, int]:
        """Returns (samples, timestamp) — timestamp in samples.  Blocks
        until data is available; raises StopIteration when closed."""


class BasebandTransmitter(Protocol):
    def transmit(self, samples, timestamp: int) -> None: ...


@dataclasses.dataclass
class BasebandLoopConfig:
    srate_hz: float
    buffer_size: int  # samples per processing buffer
    rx_to_tx_max_delay: int  # samples the TX may run ahead of RX
    tx_time_offset: int = 0  # samples added to the TX timestamp
    # Slow the loop to real time when the gateway has no own clock
    # (reference system_time_throttling knob); 0 = free-running.
    system_time_throttling: float = 0.0


class BasebandLoop:
    """Two-thread RX/TX baseband loop with timestamp pacing."""

    def __init__(
        self,
        cfg: BasebandLoopConfig,
        receiver: BasebandReceiver,
        transmitter: BasebandTransmitter,
        ul_processor: Callable[[object, int], None],
        dl_producer: Callable[[int, int], object],
    ):
        self.cfg = cfg
        self.receiver = receiver
        self.transmitter = transmitter
        self.ul_processor = ul_processor
        self.dl_producer = dl_producer
        self._stop = threading.Event()
        self._last_rx_ts = 0
        self._rx_thread: threading.Thread | None = None
        self._tx_thread: threading.Thread | None = None
        self.stats = {"rx_buffers": 0, "tx_buffers": 0, "tx_waits": 0,
                      "max_tx_lead": 0}

    # -- lifecycle ----------------------------------------------------------

    def start(self, init_time: int = 0) -> None:
        self._last_rx_ts = init_time
        self._stop.clear()
        self._rx_thread = threading.Thread(target=self._rx_loop, daemon=True)
        self._tx_thread = threading.Thread(
            target=self._tx_loop, args=(init_time + self.cfg.rx_to_tx_max_delay,),
            daemon=True)
        self._rx_thread.start()
        self._tx_thread.start()

    def stop(self) -> None:
        self._stop.set()
        for t in (self._rx_thread, self._tx_thread):
            if t is not None:
                t.join(timeout=5.0)

    # -- threads ------------------------------------------------------------

    def _rx_loop(self) -> None:
        while not self._stop.is_set():
            try:
                samples, ts = self.receiver.receive()
            except StopIteration:
                self._stop.set()
                return
            self._last_rx_ts = ts
            self.stats["rx_buffers"] += 1
            self.ul_processor(samples, ts)

    def _tx_loop(self, init_timestamp: int) -> None:
        cfg = self.cfg
        timestamp = init_timestamp
        last_tx_wall = None
        while not self._stop.is_set():
            # Pace: do not run further than rx_to_tx_max_delay ahead of the
            # receiver (bounded transmit-buffer latency; reference
            # lower_phy_baseband_processor.cpp:83-96 with 2-slot timeout).
            deadline = time.monotonic() + 2.0 * cfg.buffer_size / cfg.srate_hz + 0.1
            waited = False
            while (timestamp > self._last_rx_ts + cfg.rx_to_tx_max_delay
                   and time.monotonic() < deadline and not self._stop.is_set()):
                waited = True
                time.sleep(10e-6)
            if waited:
                self.stats["tx_waits"] += 1
            if self._stop.is_set():
                return
            # Optional system-time throttling (free-running gateways).
            if cfg.system_time_throttling > 0 and last_tx_wall is not None:
                minimum = cfg.buffer_size / cfg.srate_hz * cfg.system_time_throttling
                leftover = last_tx_wall + minimum - time.monotonic()
                if leftover > 0:
                    time.sleep(leftover)
            last_tx_wall = time.monotonic()
            samples = self.dl_producer(timestamp, cfg.buffer_size)
            self.transmitter.transmit(samples, timestamp + cfg.tx_time_offset)
            self.stats["tx_buffers"] += 1
            self.stats["max_tx_lead"] = max(
                self.stats["max_tx_lead"], timestamp - self._last_rx_ts)
            timestamp += cfg.buffer_size


class LoopbackGateway:
    """In-process baseband gateway with a sample clock: the receiver hands
    out zero (or injected) buffers at a simulated sample rate; transmitted
    buffers are recorded with their timestamps (ZMQ-sim / RU-emulator
    role for loop tests)."""

    def __init__(self, cfg: BasebandLoopConfig, nof_buffers: int,
                 realtime: bool = False):
        self.cfg = cfg
        self.nof_buffers = nof_buffers
        self.realtime = realtime
        self._rx_count = 0
        self.tx_log: list[tuple[int, object]] = []
        self._lock = threading.Lock()

    def receive(self):
        if self._rx_count >= self.nof_buffers:
            raise StopIteration
        if self.realtime:
            time.sleep(self.cfg.buffer_size / self.cfg.srate_hz)
        ts = self._rx_count * self.cfg.buffer_size
        self._rx_count += 1
        return None, ts

    def transmit(self, samples, timestamp: int) -> None:
        with self._lock:
            self.tx_log.append((timestamp, samples))
