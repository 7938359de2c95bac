"""Host spans of the slot path, on torch.profiler's clock.

A span records its name, its start and end as ``time.time_ns()`` (the
Unix-epoch clock torch.profiler stamps its events with), the span that
opened it, a request id (the id of the outermost span open on its thread)
and optional counts (``Span.count``).  It is on while the tracer is enabled
(``du_low_sim --trace``) or a torch profiler records; while the profiler
records it also opens a profiler range of its name, so the stage sits in
the profiler's trace around the operations and kernel launches it made.
The range is the profiler's fast record function (``_RecordFunctionFast``,
an operator event): ``torch.profiler.record_function`` dispatches an
operator at each end, which the profiler records too, and moved its event
5-117 us from the span's own stamps on a CPU host, against 0.1-5 us.  A
span that is off is one shared null context: it formats nothing, launches
nothing and syncs nothing.

Spans that were on are kept in memory until ``write`` (Chrome trace JSON:
``ph: "X"``, ``ts`` and ``dur`` in us on the Unix epoch, the counts under
``args``) or ``take`` (the spans and their per-name totals) hands them out.
Counts that are device tensors are summed only then.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time

import torch

_profiling = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast


class _Off:
    """The shared context of a span that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


@dataclasses.dataclass
class Span:
    """A kept span: times in ns on ``time.time_ns()``'s clock; ``parent``
    0 for an outermost span; ``args`` the counts as given (ints or device
    tensors)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    request: int
    tid: int
    args: dict


@dataclasses.dataclass
class Totals:
    """Per-name sums over kept spans: their number, durations, self time (a
    span's duration less the part its children cover) and counts."""

    spans: int = 0
    total_ns: int = 0
    self_ns: int = 0
    counts: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Reading:
    spans: list
    totals: dict  # name -> Totals


def _value(v) -> int | float:
    return v.sum().item() if isinstance(v, torch.Tensor) else v


class _On:
    __slots__ = ("tracer", "name", "id", "parent", "request", "args", "start_ns", "record")

    def __init__(self, tracer: "EventTracer", name: str):
        self.tracer, self.name, self.args, self.record = tracer, name, {}, None

    def __enter__(self):
        stack = self.tracer._stack()
        self.id = next(self.tracer._ids)
        self.parent = stack[-1].id if stack else 0
        self.request = stack[0].id if stack else self.id
        stack.append(self)
        if _profiling():
            self.record = _range(self.name)
            self.record.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        if self.record is not None:
            self.record.__exit__(*exc)
        self.tracer._stack().pop()
        span = Span(self.name, self.start_ns, end, self.id, self.parent, self.request,
                    threading.get_ident(), self.args)
        with self.tracer._lock:
            self.tracer._kept.append(span)
        return False

    def count(self, **counts) -> None:
        self.args.update(counts)


class EventTracer:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._kept: list[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str):
        """A context for one span; ``with tracer.span(...) as s: s.count(k=v)``
        adds counts."""
        if self.enabled or _profiling():
            return _On(self, name)
        return _OFF

    def take(self) -> Reading:
        """The kept spans, in the order they closed, and their per-name
        totals; the tracer keeps none of them afterwards."""
        with self._lock:
            spans, self._kept = self._kept, []
        for s in spans:
            s.args = {k: _value(v) for k, v in s.args.items()}
        covered: dict = {}
        for s in spans:
            if s.parent:
                covered[s.parent] = covered.get(s.parent, 0) + s.end_ns - s.start_ns
        totals: dict = {}
        for s in spans:
            t = totals.setdefault(s.name, Totals())
            dur = s.end_ns - s.start_ns
            t.spans += 1
            t.total_ns += dur
            t.self_ns += dur - covered.get(s.id, 0)
            for k, v in s.args.items():
                t.counts[k] = t.counts.get(k, 0) + v
        return Reading(spans, totals)

    def write(self, path: str) -> None:
        """The kept spans as Chrome trace JSON, then none kept."""
        events = [{"name": s.name, "cat": "L1", "ph": "X", "ts": s.start_ns / 1e3,
                   "dur": (s.end_ns - s.start_ns) / 1e3, "pid": 0, "tid": s.tid % 100000,
                   "args": {"id": s.id, "parent": s.parent, "request": s.request, **s.args}}
                  for s in self.take().spans]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)


# The slot path's tracer (its events in the reference's L1 category).
l1_tracer = EventTracer()
