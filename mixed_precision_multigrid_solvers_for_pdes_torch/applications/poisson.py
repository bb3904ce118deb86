"""The solve record of the Poisson front ends.

Counterpart of ``PoissonResult`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/applications/poisson.py``.
The 2D front end (``solve_poisson``, ``convergence_study``) is ROADMAP
item 8.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class PoissonResult:
    """Solution and solve metadata."""

    u: Any
    info: Dict[str, Any]
    errors: Optional[Dict[str, float]] = None
    solve_time: float = 0.0

    @property
    def iterations(self) -> int:
        return self.info["iterations"]

    @property
    def converged(self) -> bool:
        return self.info["converged"]
