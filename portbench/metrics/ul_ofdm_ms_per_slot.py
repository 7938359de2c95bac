"""Host milliseconds a slot spends in the uplink's OFDM demodulation: the
self time of the program's ``ofdm.demodulate`` spans (``ops/ofdm.demodulate_slot``)
over the traced stretch, which the profiler slows by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "ofdm.demodulate")
