"""Host milliseconds a slot spends detecting PRACH preambles: the self time
of the program's ``prach.detect`` spans (``phy/prach.detect``) over the
traced stretch, which the profiler slows by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "prach.detect")
