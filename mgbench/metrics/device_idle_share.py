"""The card's idle share of the traced window: 1 minus the union of its
operations' intervals over the window, in %."""


def read(ctx):
    if ctx.trace.window_s <= 0.0:
        return None
    return (1.0 - ctx.trace.busy_s / ctx.trace.window_s) * 100.0
