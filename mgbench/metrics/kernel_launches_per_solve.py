"""Launches per solve that the port's kernel wrappers count (the sum of
their ``launches`` counters over the traced window). Fewer means dispatch
sent work to plain torch."""


def read(ctx):
    if not ctx.solves:
        return None
    return ctx.launches / ctx.solves
