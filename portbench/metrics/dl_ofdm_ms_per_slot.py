"""Host milliseconds a slot spends in the downlink's OFDM modulation: the
self time of the program's ``ofdm.modulate`` spans (``ops/ofdm.modulate_slot``)
over the traced stretch, which the profiler slows by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "ofdm.modulate")
