"""Problem definitions."""

from . import problems  # noqa: F401
