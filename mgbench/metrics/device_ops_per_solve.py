"""Device operations per solve in the profile: each one the host issued."""


def read(ctx):
    if not ctx.solves:
        return None
    return ctx.trace.ops_in_solves / ctx.solves
