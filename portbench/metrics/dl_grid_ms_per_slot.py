"""Host milliseconds a slot spends in the PDSCH grid assembly (modulate,
layer map, DM-RS, precode): the self time of the program's ``pdsch.grid``
spans (``phy/pdsch._grid_chain``) over the traced stretch, which the profiler
slows by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "pdsch.grid")
