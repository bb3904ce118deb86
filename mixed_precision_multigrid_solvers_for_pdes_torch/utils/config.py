"""Configuration tree with validation and JSON/YAML round-trip.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/utils/
config.py``, built on this package's ``Grid``, ``Precision`` /
``PrecisionPolicy``, ``MultigridConfig`` and heat ``SCHEMES``. The solver's
own config is ``solvers.multigrid.MultigridConfig``; this module is the
user-facing layer that validates and builds it, and the grid, precision
and time-stepping settings, from files. The files are the JAX package's:
one written there loads here, except that the solver backend is one of
this package's (``ops.dispatch.BACKENDS``: 'auto', the CUDA kernels where
they apply, or 'torch'); a file naming the JAX package's 'xla' or 'pallas'
is refused, never remapped. YAML needs ``pyyaml``, imported on use.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional

from ..core.grid import Grid
from ..core.precision import Precision, PrecisionPolicy
from ..ops.dispatch import BACKENDS
from ..solvers.multigrid import MultigridConfig


@dataclasses.dataclass
class GridConfig:
    """Grid settings (reference config/settings.py:14-36)."""

    nx: int = 129
    ny: int = 129
    domain: tuple = (0.0, 1.0, 0.0, 1.0)

    def validate(self) -> None:
        if self.nx < 3 or self.ny < 3:
            raise ValueError("grid must be at least 3x3")
        x0, x1, y0, y1 = self.domain
        if x1 <= x0 or y1 <= y0:
            raise ValueError("domain must have positive extent")

    def build(self) -> Grid:
        return Grid(self.nx, self.ny, tuple(self.domain))


@dataclasses.dataclass
class PrecisionConfig:
    """Precision settings (reference config/settings.py:37-57)."""

    mode: str = "fp32"          # bf16 | fp32 | fp64 | mixed | adaptive
    fine: str = "fp32"
    coarse: str = "bf16"
    convergence_threshold: float = 1e-6

    def validate(self) -> None:
        Precision(self.mode)
        Precision(self.fine)
        Precision(self.coarse)

    def build(self) -> PrecisionPolicy:
        return PrecisionPolicy(
            mode=Precision(self.mode),
            fine=Precision(self.fine),
            coarse=Precision(self.coarse),
            convergence_threshold=self.convergence_threshold,
        )


@dataclasses.dataclass
class SolverConfig:
    """Solver settings (reference config/settings.py:58-106)."""

    cycle: str = "V"
    pre_sweeps: int = 2
    post_sweeps: int = 2
    smoother: str = "rbgs"
    omega: float = 1.0
    max_levels: int = 32
    max_iterations: int = 100
    tol: float = 1e-10
    restriction: str = "full_weighting"
    prolongation: str = "bilinear"
    backend: str = "auto"
    use_fmg: bool = False

    def validate(self, grid: Optional[GridConfig] = None) -> None:
        if self.cycle not in ("V", "W", "F"):
            raise ValueError(f"unknown cycle {self.cycle!r}")
        if self.smoother not in ("jacobi", "rbgs", "sor", "gauss_seidel",
                                 "red_black", "line_x", "line_y", "adi", "chebyshev"):
            raise ValueError(f"unknown smoother {self.smoother!r}")
        if not (0.0 < self.omega < 2.0):
            raise ValueError("omega must be in (0, 2)")
        if self.max_iterations < 1 or self.max_levels < 1:
            raise ValueError("max_iterations and max_levels must be >= 1")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}: this package's backends "
                f"are {BACKENDS} ('torch' is the plain path the JAX "
                f"package's 'xla' names, 'auto' the kernels)")
        if grid is not None:
            # cross-validation: requested levels must fit the grid
            # (reference settings.py:140-154)
            n = min(grid.nx, grid.ny)
            feasible = 1
            while (n - 1) % 2 == 0 and (n - 1) // 2 + 1 >= 3:
                n = (n - 1) // 2 + 1
                feasible += 1
            if self.max_levels > 64:
                raise ValueError("max_levels unreasonably large")
            self._feasible_levels = feasible

    def build(self) -> MultigridConfig:
        return MultigridConfig(
            cycle=self.cycle, pre_sweeps=self.pre_sweeps,
            post_sweeps=self.post_sweeps, smoother=self.smoother,
            omega=self.omega, max_levels=self.max_levels,
            restriction=self.restriction, prolongation=self.prolongation,
            max_iterations=self.max_iterations, tol=self.tol,
            backend=self.backend,
        )


@dataclasses.dataclass
class TimeSteppingConfig:
    """Heat-equation stepping settings (reference heat_solver.py:47-56)."""

    scheme: str = "crank_nicolson"
    theta: float = 0.5
    dt: Optional[float] = None
    t_final: float = 1.0
    cycles_per_step: int = 2
    adaptive_dt: bool = False
    dt_tol: float = 1e-5
    save_every: int = 0

    def validate(self) -> None:
        from ..applications.heat import SCHEMES

        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}")
        if self.t_final <= 0:
            raise ValueError("t_final must be positive")


@dataclasses.dataclass
class LoggingConfig:
    """Logging settings (reference config/settings.py:122-139)."""

    level: str = "INFO"
    log_file: Optional[str] = None
    colored: bool = True

    def validate(self) -> None:
        import logging

        if not hasattr(logging, self.level.upper()):
            raise ValueError(f"unknown log level {self.level!r}")


@dataclasses.dataclass
class FrameworkConfig:
    """Top-level config tree (reference config/settings.py:107-320)."""

    grid: GridConfig = dataclasses.field(default_factory=GridConfig)
    precision: PrecisionConfig = dataclasses.field(default_factory=PrecisionConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    time_stepping: TimeSteppingConfig = dataclasses.field(
        default_factory=TimeSteppingConfig
    )
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)

    def validate(self) -> None:
        self.grid.validate()
        self.precision.validate()
        self.solver.validate(self.grid)
        self.time_stepping.validate()
        self.logging.validate()

    # ---- serialization (reference settings.py:218-290) -------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FrameworkConfig":
        def sub(klass, key):
            block = dict(d.get(key, {}))
            if key == "grid" and "domain" in block:
                block["domain"] = tuple(block["domain"])
            names = {f.name for f in dataclasses.fields(klass)}
            unknown = set(block) - names
            if unknown:
                raise ValueError(f"unknown {key} config keys: {sorted(unknown)}")
            return klass(**block)

        return cls(
            grid=sub(GridConfig, "grid"),
            precision=sub(PrecisionConfig, "precision"),
            solver=sub(SolverConfig, "solver"),
            time_stepping=sub(TimeSteppingConfig, "time_stepping"),
            logging=sub(LoggingConfig, "logging"),
        )

    def save(self, path) -> None:
        path = Path(path)
        d = self.to_dict()
        if path.suffix in (".yml", ".yaml"):
            import yaml

            path.write_text(yaml.safe_dump(d, sort_keys=False))
        else:
            path.write_text(json.dumps(d, indent=2))

    @classmethod
    def load(cls, path) -> "FrameworkConfig":
        path = Path(path)
        text = path.read_text()
        if path.suffix in (".yml", ".yaml"):
            import yaml

            d = yaml.safe_load(text)
        else:
            d = json.loads(text)
        cfg = cls.from_dict(d or {})
        cfg.validate()
        return cfg


def create_default_config() -> FrameworkConfig:
    """Balanced defaults (reference settings.py:291-299)."""
    return FrameworkConfig()


def create_performance_config() -> FrameworkConfig:
    """Speed-first: fp32+bf16 mixed, V(1,1), looser tolerance
    (reference settings.py:300-310)."""
    cfg = FrameworkConfig()
    cfg.precision.mode = "mixed"
    cfg.solver.pre_sweeps = 1
    cfg.solver.post_sweeps = 1
    cfg.solver.tol = 1e-7
    return cfg


def create_accuracy_config() -> FrameworkConfig:
    """Accuracy-first: fp64 everywhere, W-cycle, tight tolerance
    (reference settings.py:311-320)."""
    cfg = FrameworkConfig()
    cfg.precision.mode = "fp64"
    cfg.solver.cycle = "W"
    cfg.solver.tol = 1e-12
    return cfg
