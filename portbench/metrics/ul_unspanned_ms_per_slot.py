"""Host milliseconds a slot spends in the uplink entry's call outside every
stage span: the self time of the program's ``cell.decode_slot`` and
``ul_slot.process_slot`` spans over the traced stretch, which the profiler slows
by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "cell.decode_slot", "ul_slot.process_slot")
