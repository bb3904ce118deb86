"""Outer iterations per solve: refinement steps under ``ir_solve`` and
``ir_solve3d``, cycles under ``mg_solve3d`` (the mean of the solves'
``info["iterations"]`` in the traced window)."""


def read(ctx):
    return ctx.mean_iterations() if ctx.iterations else None
