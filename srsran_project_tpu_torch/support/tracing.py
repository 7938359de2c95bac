"""Chrome Trace Event tracing for the host slot runtime.

Counterpart of the reference's event tracer
(lib/support/tracing/event_tracing.cpp:299: "ph":"X" duration events with
tid/ts/dur) with named categories (L1/L2-style) and threshold gating.
Device-side profiling is torch.profiler's (its Chrome trace export); this
traces the host pipeline around it in the same JSON format so both views
line up.  A copy of ``srsran_project_tpu/support/tracing.py``.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager


class EventTracer:
    def __init__(self, enabled: bool = False, threshold_us: float = 0.0):
        self.enabled = enabled
        self.threshold_us = threshold_us
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    def _now_us(self) -> float:
        return (time.monotonic() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, category: str = "L1"):
        if not self.enabled:
            yield
            return
        start = self._now_us()
        try:
            yield
        finally:
            dur = self._now_us() - start
            if dur >= self.threshold_us:
                ev = {
                    "name": name,
                    "cat": category,
                    "ph": "X",
                    "ts": start,
                    "dur": dur,
                    "pid": 0,
                    "tid": threading.get_ident() % 100000,
                }
                with self._lock:
                    self._events.append(ev)

    def instant(self, name: str, category: str = "L1") -> None:
        if not self.enabled:
            return
        with self._lock:
            self._events.append(
                {"name": name, "cat": category, "ph": "i", "ts": self._now_us(),
                 "pid": 0, "tid": threading.get_ident() % 100000, "s": "t"}
            )

    def write(self, path: str) -> None:
        with self._lock:
            events = list(self._events)
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)


# Named tracer singletons per domain, like the reference's
# lib/instrumentation/traces/*.cpp categories.
l1_tracer = EventTracer()
up_tracer = EventTracer()
ru_tracer = EventTracer()


def enable_all(threshold_us: float = 0.0) -> None:
    for t in (l1_tracer, up_tracer, ru_tracer):
        t.enabled = True
        t.threshold_us = threshold_us
