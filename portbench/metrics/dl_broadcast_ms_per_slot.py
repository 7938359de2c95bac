"""Host milliseconds a slot spends on its broadcast signals: the self time
of the program's ``ssb.assemble`` spans (``phy/ssb.assemble_ssb``: PSS,
SSS, the PBCH chain and its DM-RS) and ``csi_rs.generate`` spans
(``phy/csi_rs.generate``) over the traced stretch, which the profiler
slows by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "ssb.assemble", "csi_rs.generate")
