"""Host milliseconds a slot spends in the PUSCH demapper (soft demap,
quantize, descramble, EVM): the self time of the program's ``pusch.demap`` spans
(``phy/pusch._demap_stage``) over the traced stretch, which the profiler slows
by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "pusch.demap")
