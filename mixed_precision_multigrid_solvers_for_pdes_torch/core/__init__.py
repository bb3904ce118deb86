"""Grid metadata, boundary conditions and precision tiers."""

from . import bc, grid, precision  # noqa: F401
