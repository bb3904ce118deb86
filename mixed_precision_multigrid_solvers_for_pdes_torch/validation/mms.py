"""Method-of-Manufactured-Solutions validation suite.

Counterpart of ``MMSResult`` and ``MMSValidator`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/validation/mms.py``:
steady 2D and 3D and time-dependent 2D and 3D convergence studies over grid
ladders, observed-order checks and reports. Every row is a real solve of
this package (``convergence_study``, ``convergence_study3d``,
``solve_heat``, ``solve_heat3d``) on ``device`` (the card when None), on
the CUDA kernels where the configuration allows. Problems come from
``models.problems``, ``models.problems3d``, ``applications.heat_problems``
and ``applications.heat3d``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..applications import heat as heat_mod
from ..applications.heat import HeatConfig, solve_heat
from ..applications.poisson import convergence_study, observed_order
from ..solvers.multigrid import MultigridConfig


@dataclasses.dataclass
class MMSResult:
    problem: str
    kind: str                     # 'steady' | 'time_dependent'
    sizes: List[int]
    l2_errors: List[float]
    observed_order: float
    expected_order: float
    passed: bool
    iterations: List[int]
    wall_s: float
    h1_order: float = float("nan")  # observed H1-seminorm order (steady only)
    exact_floor: bool = False       # errors at round-off: orders are noise

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class MMSValidator:
    """Run MMS convergence studies on ``device`` (the card when None) and
    aggregate a pass/fail report."""

    def __init__(
        self,
        cfg: MultigridConfig = MultigridConfig(smoother="rbgs", omega=1.0),
        *,
        expected_order: float = 2.0,
        order_tolerance: float = 0.3,
        precision: str = "fp64",
        device=None,
    ):
        self.cfg = cfg
        self.device = device
        self.expected_order = expected_order
        self.order_tolerance = order_tolerance
        self.precision = precision
        self.results: List[MMSResult] = []

    # ---- steady problems --------------------------------------------------

    def validate_steady(
        self,
        factory: Callable[[int], Any],
        sizes: Sequence[int] = (17, 33, 65, 129),
        name: Optional[str] = None,
        expected_order: Optional[float] = None,
        order_tolerance: Optional[float] = None,
    ) -> MMSResult:
        t0 = time.perf_counter()
        study = convergence_study(factory, list(sizes),
                                  precision=self.precision, cfg=self.cfg,
                                  device=self.device)
        order = study["order_l2"]
        expect = expected_order if expected_order is not None else self.expected_order
        tol = order_tolerance if order_tolerance is not None else self.order_tolerance
        # problems whose truncation error vanishes (e.g. bi-quadratics under
        # the 5-point stencil) sit at the round-off floor: order is noise there
        exact_discretization = max(study["l2"]) < 1e-9
        res = MMSResult(
            problem=name or factory(sizes[0]).name,
            kind="steady",
            sizes=list(sizes),
            l2_errors=[float(e) for e in study["l2"]],
            observed_order=float(order),
            expected_order=expect,
            passed=bool(study["converged"]
                        and (exact_discretization
                             or abs(order - expect) <= tol)),
            iterations=study["iterations"],
            wall_s=time.perf_counter() - t0,
            # at the round-off floor the fitted orders are noise — blank the
            # H1 column rather than print a meaningless number
            h1_order=(float("nan") if exact_discretization
                      else float(study.get("order_h1", float("nan")))),
            exact_floor=bool(exact_discretization),
        )
        self.results.append(res)
        return res

    # ---- 3D steady problems -------------------------------------------------

    def validate_steady3d(
        self,
        factory: Callable[[int], Any],
        sizes: Sequence[int] = (9, 17, 33),
        name: Optional[str] = None,
        expected_order: Optional[float] = None,
    ) -> MMSResult:
        """3D convergence study via real 3D solves (through
        applications.poisson3d.convergence_study3d)."""
        from ..applications.poisson3d import convergence_study3d

        t0 = time.perf_counter()
        study = convergence_study3d(factory, list(sizes),
                                    precision=self.precision, cfg=self.cfg,
                                    device=self.device)
        order = study["order_l2"]
        expect = expected_order if expected_order is not None else self.expected_order
        exact_discretization = max(study["l2"]) < 1e-9
        res = MMSResult(
            problem=name or factory(sizes[0]).name,
            kind="steady_3d",
            sizes=list(sizes),
            l2_errors=[float(e) for e in study["l2"]],
            observed_order=float(order),
            expected_order=expect,
            passed=bool(study["converged"]
                        and (exact_discretization
                             or abs(order - expect) <= self.order_tolerance)),
            iterations=study["iterations"],
            wall_s=time.perf_counter() - t0,
            h1_order=(float("nan") if exact_discretization
                      else float(study["order_h1"])),
            exact_floor=bool(exact_discretization),
        )
        self.results.append(res)
        return res

    # ---- time-dependent problems ------------------------------------------

    def validate_heat(
        self,
        factory: Callable[[int], heat_mod.HeatProblem],
        sizes: Sequence[int] = (17, 33, 65),
        *,
        t_final: float = 0.02,
        dt: float = 5e-4,
        scheme: str = "crank_nicolson",
        name: Optional[str] = None,
        expected_order: Optional[float] = None,
    ) -> MMSResult:
        """Spatial-order study at small fixed dt (dt error subdominant)."""
        t0 = time.perf_counter()
        errs: List[float] = []
        for n in sizes:
            prob = factory(n)
            cfg = HeatConfig(scheme=scheme, cycles_per_step=2, dtype="float64")
            r = solve_heat(prob, t_final=t_final, dt=dt, cfg=cfg,
                           device=self.device)
            errs.append(r.errors["l2"])
        hs = 1.0 / (np.asarray(sizes, dtype=float) - 1)
        order = observed_order(hs, np.asarray(errs))
        expect = expected_order if expected_order is not None else self.expected_order
        res = MMSResult(
            problem=name or factory(sizes[0]).name,
            kind="time_dependent",
            sizes=list(sizes),
            l2_errors=errs,
            observed_order=float(order),
            expected_order=expect,
            passed=bool(abs(order - expect) <= self.order_tolerance),
            iterations=[],
            wall_s=time.perf_counter() - t0,
        )
        self.results.append(res)
        return res

    def validate_heat3d(
        self,
        factory: Callable[[int], Any],
        sizes: Sequence[int] = (9, 17),
        *,
        t_final: float = 0.01,
        dt: float = 5e-4,
        scheme: str = "crank_nicolson",
        name: Optional[str] = None,
        expected_order: Optional[float] = None,
    ) -> MMSResult:
        """3D spatial-order study at small fixed dt via real solve_heat3d
        runs."""
        from ..applications.heat3d import solve_heat3d

        t0 = time.perf_counter()
        errs: List[float] = []
        for n in sizes:
            prob = factory(n)
            cfg = HeatConfig(scheme=scheme, cycles_per_step=2,
                             dtype="float64")
            out = solve_heat3d(prob, t_final=t_final, dt=dt, cfg=cfg,
                               device=self.device)
            errs.append(float(out["errors"]["l2"]))
        hs = 1.0 / (np.asarray(sizes, dtype=float) - 1)
        order = observed_order(hs, np.asarray(errs))
        expect = expected_order if expected_order is not None else self.expected_order
        res = MMSResult(
            problem=name or factory(sizes[0]).name,
            kind="time_dependent_3d",
            sizes=list(sizes),
            l2_errors=errs,
            observed_order=float(order),
            expected_order=expect,
            passed=bool(abs(order - expect) <= self.order_tolerance),
            iterations=[],
            wall_s=time.perf_counter() - t0,
        )
        self.results.append(res)
        return res

    # ---- suite driver + report ---------------------------------------------

    def run_standard_suite(self, sizes=(17, 33, 65, 129),
                           heat_sizes=(17, 33, 65),
                           sizes3d=(9, 17, 33)) -> List[MMSResult]:
        """The standard battery: polynomial, trig, high-frequency,
        inhomogeneous and exponential steady problems, Helmholtz, variable
        coefficients, Neumann sides, mixed segments, the boundary layer and
        the two singular corner problems, two 3D problems and three heat
        problems (two 2D, one 3D)."""
        from ..models import problems as P

        for key in ("polynomial", "trigonometric", "high_frequency",
                    "mixed", "exponential", "helmholtz",
                    "variable_coefficient", "neumann_test",
                    "mixed_segments_mms", "boundary_layer"):
            self.validate_steady(P.CATALOGUE[key], sizes, name=key)
        # Singular problems: L2 order is limited by H^(1+2/3) corner regularity. The sharp diagnostic is
        # the H1-seminorm order = 2/3 (checked by the report consumer); the
        # L2 expectation documents the measured reduced order.
        self.validate_steady(P.CATALOGUE["corner_singularity"], sizes,
                             name="corner_singularity",
                             expected_order=1.6, order_tolerance=0.35)
        self.validate_steady(P.CATALOGUE["l_shaped"], sizes,
                             name="l_shaped",
                             expected_order=4.0 / 3.0, order_tolerance=0.3)
        from ..models import problems3d as P3

        self.validate_steady3d(P3.poisson3d_mms_sinsinsin, sizes3d,
                               name="poisson3d")
        self.validate_steady3d(P3.varcoef3d_mms, sizes3d, name="varcoef3d")
        from ..applications import heat_problems as HP

        self.validate_heat(HP.pure_diffusion, heat_sizes, name="heat_pure_diffusion")
        self.validate_heat(HP.oscillating, heat_sizes, name="heat_oscillating")
        from ..applications.heat3d import oscillating3d

        self.validate_heat3d(oscillating3d, sizes3d[:2], name="heat3d_oscillating")
        return self.results

    def summary(self) -> Dict[str, Any]:
        return {
            "total": len(self.results),
            "passed": sum(r.passed for r in self.results),
            "failed": [r.problem for r in self.results if not r.passed],
            "results": [r.to_dict() for r in self.results],
        }

    def report_markdown(self) -> str:
        lines = [
            "# MMS validation report",
            "",
            "All rows are REAL solves (no simulated data).",
            "",
            "| problem | kind | sizes | observed order (L2) | H1 order | expected | passed |",
            "|---|---|---|---|---|---|---|",
        ]
        for r in self.results:
            h1 = "" if np.isnan(r.h1_order) else f"{r.h1_order:.2f}"
            # exact-discretization rows sit at the round-off floor: the
            # fitted order is noise, so label the row instead
            obs = ("exact (round-off floor)" if r.exact_floor
                   else f"{r.observed_order:.2f}")
            lines.append(
                f"| {r.problem} | {r.kind} | {r.sizes} | "
                f"{obs} | {h1} | {r.expected_order:.2f} | "
                f"{'PASS' if r.passed else 'FAIL'} |"
            )
        return "\n".join(lines)

    def save(self, path) -> None:
        path = Path(path)
        if path.suffix == ".md":
            path.write_text(self.report_markdown())
        else:
            path.write_text(json.dumps(self.summary(), indent=2))
