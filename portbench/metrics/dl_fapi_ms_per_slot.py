"""Host milliseconds a slot spends in the downlink FAPI entry outside its
channels' spans: the self time of the program's
``upper_phy.process_dl_tti`` and ``upper_phy.process_ul_dci`` spans (the
PDUs' routing and batching, the payloads moved to the device, the grid's
zeros and clones and each PDU's add onto it) over the traced stretch,
which the profiler slows by its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "upper_phy.process_dl_tti", "upper_phy.process_ul_dci")
