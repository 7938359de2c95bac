"""Host milliseconds a slot spends in the PUSCH channel estimate: the self
time of the program's ``pusch.estimate`` spans (``phy/pusch._estimate``) over the
traced stretch, which the profiler slows by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "pusch.estimate")
