"""Problem definitions."""

from . import problems, problems3d  # noqa: F401
