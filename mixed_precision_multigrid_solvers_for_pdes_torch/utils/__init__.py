"""Support utilities (timing)."""

from . import timing  # noqa: F401
