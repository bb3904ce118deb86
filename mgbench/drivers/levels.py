"""A solver entry that takes a hierarchy built once: the window calls
``entry(levels, f, u0, cfg, **kwargs)`` on the same levels for every
right-hand side.

The configuration gives the grid, boundary and hierarchy builder by their
dotted names in the port, the levels' dtype and the solver's settings.
An optional ``coefficient`` names a problem factory of the port and its
arguments; the problem's coefficient field ``a`` and its ``lam`` feed the
hierarchy builder (its grid and boundary must be the configuration's).
The mix gives the entry, its keyword arguments and its solver settings.
"""

from __future__ import annotations

from typing import Dict

import torch

from mgbench.harness.spec import resolve


class LevelsCell:
    """The system under test for one configuration and one mix: the
    hierarchy, the solver's settings and the entry that the window
    calls."""

    def __init__(self, port, conf: Dict, mix: Dict, device: torch.device):
        n, dims = conf["n"], conf["dims"]
        grid = resolve(port, conf["grid"])(*(n,) * dims)
        bcs = resolve(port, conf["boundary"])()
        cfg_cls = resolve(port, "solvers.multigrid.MultigridConfig")
        self.cfg = cfg_cls(**conf["multigrid"], **mix["multigrid"])
        extra = {}
        if conf.get("coefficient"):
            c = conf["coefficient"]
            problem = resolve(port, c["factory"])(*c.get("args", ()),
                                                  **c.get("kwargs", {}))
            extra = {"a": problem.a, "lam": problem.lam}
        build = resolve(port, conf["hierarchy"])
        self.levels = build(grid, bcs, dtype=getattr(torch,
                                                     conf["level_dtype"]),
                            device=device, cfg=self.cfg, **extra)
        self.entry = resolve(port, mix["entry"])
        self.kwargs = dict(mix.get("kwargs", {}))
        self.u0 = torch.zeros((n,) * dims, dtype=torch.float64,
                              device=device)

    def solve(self, f: torch.Tensor):
        """(u, info) of one solve of ``f`` from the zero guess."""
        return self.entry(self.levels, f, self.u0, self.cfg, **self.kwargs)


def setup(port, conf: Dict, mix: Dict, device: torch.device) -> LevelsCell:
    return LevelsCell(port, conf, mix, device)
