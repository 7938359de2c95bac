"""Host milliseconds a slot spends inside the entry's call
(``models.cell.decode_slot``, ``phy.ul_slot.process_slot`` or
``models.cell.encode_slot``), from the call until it returns and before
the benchmark reads the answer back or synchronizes: the eager dispatch.
Read from the benchmark's own host spans over the measured window of the
traced run."""


def read(ctx):
    if not ctx.window["slots"]:
        return None
    return 1e3 * ctx.window["dispatch_s"] / ctx.window["slots"]
