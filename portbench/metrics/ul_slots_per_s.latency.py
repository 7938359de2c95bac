"""Uplink slots a second over the measured window (all its slots over all
its time, as ``ul_slots_per_s`` counts them), in the cells where the host's
drift leaves the rate too unsteady to hold to a bound end to end."""


def read(ctx):
    if not ctx.window["slots"] or ctx.window["elapsed_s"] <= 0:
        return None
    return ctx.window["slots"] / ctx.window["elapsed_s"]
