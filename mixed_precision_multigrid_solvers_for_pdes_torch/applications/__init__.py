"""One-call front ends: a problem in, a checked solution out."""

from . import poisson, poisson3d  # noqa: F401
