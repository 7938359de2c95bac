"""Host milliseconds a slot spends in desegmentation and the TB CRC: the
self time of the program's ``sch.desegment`` spans (``phy/sch._desegment_stage``)
over the traced stretch, which the profiler slows by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "sch.desegment")
