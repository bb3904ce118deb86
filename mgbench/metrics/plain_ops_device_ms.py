"""Device ms per solve of every operation that no kernel file names: the
plain-torch float64 residuals, norms, casts, fills, copies and updates."""


def read(ctx):
    if not ctx.solves:
        return None
    return ctx.trace.plain_seconds / ctx.solves * 1e3
