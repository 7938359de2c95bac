"""Host milliseconds a slot spends detecting PUCCH: the self time of the
program's ``pucch.f1`` spans (``phy/pucch.format1_detect_all``: every F1
occasion of a slot, code-multiplexed ones a resource at a time) and
``pucch.f2`` spans (``phy/pucch_f2.process``: each F2 occasion with its UCI
decode) over the traced stretch, which the profiler slows by its cost per
operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "pucch.f1", "pucch.f2")
