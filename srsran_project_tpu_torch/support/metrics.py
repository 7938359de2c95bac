"""PHY metrics: per-block latency/throughput aggregation.

Counterpart of the reference's metrics decorators + aggregators
(lib/phy/metrics/phy_metrics_*_decorator.h,
lib/phy/upper/metrics/aggregators/): timings recorded under a name feed
its aggregator; a collector renders the report (dict / JSON line),
standing in for the reference's stdout/JSON consumers and the remote
WebSocket endpoint.  Port of ``srsran_project_tpu/support/metrics.py``
without its timing decorator, which nothing calls.
"""

from __future__ import annotations

import json
import threading
from collections import defaultdict


class Aggregator:
    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0
        self.units = 0.0  # user units (bits, REs, ...)

    def record(self, elapsed_s: float, units: float = 0.0) -> None:
        self.count += 1
        self.total_s += elapsed_s
        self.min_s = min(self.min_s, elapsed_s)
        self.max_s = max(self.max_s, elapsed_s)
        self.units += units

    def report(self) -> dict:
        if not self.count:
            return {"count": 0}
        mean = self.total_s / self.count
        out = {
            "count": self.count,
            "mean_us": mean * 1e6,
            "min_us": self.min_s * 1e6,
            "max_us": self.max_s * 1e6,
        }
        if self.units:
            out["rate_per_s"] = self.units / self.total_s
        return out


class MetricsCollector:
    def __init__(self):
        self._aggs: dict[str, Aggregator] = defaultdict(Aggregator)
        self._lock = threading.Lock()

    def record(self, name: str, elapsed_s: float, units: float = 0.0) -> None:
        with self._lock:
            self._aggs[name].record(elapsed_s, units)

    def report(self) -> dict:
        with self._lock:
            return {k: v.report() for k, v in self._aggs.items()}

    def report_json(self) -> str:
        return json.dumps(self.report())

    def reset(self) -> None:
        with self._lock:
            self._aggs.clear()


collector = MetricsCollector()
