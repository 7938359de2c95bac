"""The program's own spans over the traced stretch.

While the profiler records, the program keeps a span for each of its slot
entries and each stage inside them (``srsran_project_tpu_torch.support
.tracing.l1_tracer``: name, start and end on the profiler's clock, parent,
counts).  The traced stretch is the only profiled part of a run, so what the
tracer keeps when the metrics are read is the stretch's.  The first reader
of a run takes it; the others read the same totals.  A program whose tracer
keeps no spans, and an untraced run, read None."""

from __future__ import annotations

# The run whose spans were taken last, and their totals.
_taken: list = [None, None]


def _take():
    from srsran_project_tpu_torch.support import tracing

    take = getattr(tracing.l1_tracer, "take", None)
    return (take().totals or None) if take is not None else None


def totals(ctx):
    """name -> the tracer's ``Totals`` (``spans``, ``total_ns``, ``self_ns``,
    ``counts``) over the traced stretch, or None."""
    if ctx.trace is None:
        return None
    if _taken[0] is not ctx:
        _taken[:] = [ctx, _take()]
    return _taken[1]


def ms_per_slot(ctx, *names: str):
    """The self time of the spans named, in ms over the traced slots; None
    where none of them was kept."""
    t = totals(ctx)
    found = [t[n] for n in names if n in t] if t and ctx.traced_slots else []
    if not found:
        return None
    return sum(x.self_ns for x in found) / 1e6 / ctx.traced_slots
