"""Grid metadata, boundary conditions and precision tiers."""

from . import bc, bc3d, device, domain, grid, grid3d, precision  # noqa: F401
