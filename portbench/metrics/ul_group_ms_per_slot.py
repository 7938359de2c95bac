"""Host milliseconds a slot spends grouping a multi-UE slot's grants by
configuration and by code (with the concatenation of each code group's
buffers): the self time of the program's ``ul_slot.group`` spans
(``phy/ul_slot._config_groups``, ``_code_groups``) over the traced stretch, which
the profiler slows by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "ul_slot.group")
