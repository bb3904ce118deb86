"""||f - A u|| / ||f|| over the interior nodes, with the plain reference's
float64 5- or 7-point operator (``mgbench/reference/poisson.py``), which
it builds from n alone. The limit is the tolerance that the mix states
for the solve."""

from mgbench.reference import poisson


def read(u, f, k, conf):
    return poisson.relative_residual(u, f)
