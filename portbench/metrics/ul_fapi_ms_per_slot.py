"""Host milliseconds a slot spends in the FAPI entry outside its channels'
spans: the self time of the program's ``upper_phy.process_ul_tti`` spans
(the request's checks and routing) and ``upper_phy.indications`` spans
(the indications assembled on the host, each device value read there a
wait for the device) over the traced stretch, which the profiler slows by
its cost per operation."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_slot(ctx, "upper_phy.process_ul_tti", "upper_phy.indications")
