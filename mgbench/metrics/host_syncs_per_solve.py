"""The host's reads of a residual norm per solve, each a wait for the
card: the port's ``outer_iterate.readbacks`` counter over every solve the
run made, its warm-up solves included (the runner resets only the launch
counters). None where the port has no such counter."""

from mgbench.harness import runner, spec


def read(ctx):
    outer = spec.resolve(runner.port_module(),
                         "solvers.multigrid.outer_iterate")
    count = getattr(outer, "readbacks", None)
    solves = ctx.mix["warmup"] + len(ctx.iterations)
    if not isinstance(count, int) or not solves:
        return None
    return count / solves
