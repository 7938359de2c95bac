"""Reading a ``torch.profiler`` trace of the traced stretch: the device
operations, the busy time (the union of their intervals) inside the
window that the benchmark's own host spans cover, the longest device
operations by name, and the idle time by the host span it fell in."""

from __future__ import annotations

import bisect
import dataclasses

SPAN_PREFIX = "portbench."
_NOT_KERNELS = ("Memcpy", "Memset")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list  # (name, seconds) of every device kernel in the window
    device_ops: list  # [[name, seconds]], the 10 names that took most device time
    idle_gaps: list  # [[host span, seconds]], the idle time inside each host span


def profile(run) -> Trace:
    """Run ``run()`` under the profiler (CPU and CUDA activities) and read
    the trace."""
    from torch.profiler import ProfilerActivity, profile as _profile

    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    return read(prof.profiler.kineto_results.events())


def read(events) -> Trace:
    spans, device = [], []
    for e in events:
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            if "CPU" in str(e.device_type()):
                spans.append((e.start_ns(), e.end_ns(), name[len(SPAN_PREFIX):]))
        elif "CUDA" in str(e.device_type()) and not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), name))
    if not spans:
        return Trace(0.0, 0.0, [], [], [])
    spans.sort()
    t0, t1 = spans[0][0], max(s[1] for s in spans)
    inside = sorted((max(a, t0), min(b, t1), n) for a, b, n in device if b > t0 and a < t1)
    busy, gaps, cur_end = 0, [], t0
    by_name: dict = {}
    for a, b, n in inside:
        by_name[n] = by_name.get(n, 0) + (b - a)
        if a > cur_end:
            gaps.append((cur_end, a))
        if b > cur_end:
            busy += b - max(a, cur_end)
            cur_end = b
    if t1 > cur_end:
        gaps.append((cur_end, t1))
    starts = [s[0] for s in spans]
    idle: dict = {}
    for a, b in gaps:
        covered = 0
        for s0, s1, name in spans[max(0, bisect.bisect_right(starts, a) - 1):]:
            if s0 >= b:
                break
            part = min(b, s1) - max(a, s0)
            if part > 0:
                idle[name] = idle.get(name, 0) + part
                covered += part
        if b - a > covered:
            idle["between_spans"] = idle.get("between_spans", 0) + (b - a - covered)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Trace(
        window_s=(t1 - t0) * 1e-9, busy_s=busy * 1e-9,
        kernels=[(n, (b - a) * 1e-9) for a, b, n in inside if not n.startswith(_NOT_KERNELS)],
        device_ops=[[n[:160], v * 1e-9] for n, v in top],
        idle_gaps=[[n, v * 1e-9] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]])
