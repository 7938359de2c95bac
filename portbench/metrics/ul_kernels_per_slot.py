"""Device kernels a slot launches: every kernel in the profiler's trace of
the traced stretch (the hand-written ones and PyTorch's alike; copies and
fills left out), over the slots of that stretch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or not ctx.traced_slots:
        return None
    return len(ctx.trace.kernels) / ctx.traced_slots
