"""Share of the traced assessment window in which no kernel, copy or set ran
on the card: 100 × (1 − union of device intervals ÷ window)."""


def read(ctx):
    if ctx.kind != "assess" or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
