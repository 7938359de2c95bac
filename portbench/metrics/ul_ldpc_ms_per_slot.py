"""Host milliseconds a slot spends in the LDPC decoder's calls (K1 or K2
launched): the self time of the program's ``ldpc.decode`` spans
(``ops/ldpc/decoder.decode_dematch_groups``, ``decoder.decode``) over the traced
stretch, which the profiler slows by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "ldpc.decode")
