"""Host milliseconds a slot spends encoding its PDCCHs: the self time of the
program's ``pdcch.encode`` spans (``phy/pdcch.process``, one a DCI: CRC
with the RNTI, polar code, scrambling, QPSK, the REG layout and DM-RS)
over the traced stretch, which the profiler slows by its cost per
operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "pdcch.encode")
