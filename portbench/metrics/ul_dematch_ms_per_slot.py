"""Host milliseconds a slot spends in rate dematching and the HARQ
combine: the self time of the program's ``sch.dematch`` spans
(``phy/sch._dematch_stage``) over the traced stretch, which the profiler slows
by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "sch.dematch")
