"""Host milliseconds a slot spends in the PDSCH bit chain (segment, LDPC
encode, rate match, scramble): the self time of the program's
``pdsch.bit_chain`` spans (``phy/pdsch._bit_chain``) over the traced stretch,
which the profiler slows by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "pdsch.bit_chain")
