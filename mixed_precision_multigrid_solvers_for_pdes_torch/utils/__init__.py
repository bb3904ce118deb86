"""Support utilities (timing, checkpoints)."""

from . import checkpoint, timing  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401
