"""Host milliseconds a slot spends in the PUSCH equalizer (K3 and the
weights' application): the self time of the program's ``pusch.equalize`` spans
(``phy/pusch._equalize_stage``) over the traced stretch, which the profiler
slows by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "pusch.equalize")
