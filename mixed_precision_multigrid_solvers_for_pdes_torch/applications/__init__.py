"""One-call front ends: a problem in, a checked solution out."""

from . import poisson, poisson3d, precision_analysis  # noqa: F401
