"""Host milliseconds a slot spends in ``encode_slot`` outside every stage
span: the self time of the program's ``cell.encode_slot`` spans over the
traced stretch, which the profiler slows by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "cell.encode_slot")
