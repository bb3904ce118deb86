"""Device ms per solve of the coarse-tail kernel (D; the stage "tail")."""


def read(ctx):
    seconds = ctx.trace.seconds_by_stage.get("tail", 0.0)
    if not ctx.solves or seconds <= 0.0:
        return None
    return seconds / ctx.solves * 1e3
