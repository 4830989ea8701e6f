"""Share of the window in which no operation ran on the device, from the
trace (1 - busy / window), in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
