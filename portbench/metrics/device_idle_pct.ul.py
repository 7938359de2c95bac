"""Share of the traced stretch in which no operation ran on the device:
100 x (1 - the union of the device operations' intervals / the stretch),
the stretch being what the benchmark's host spans cover."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
