"""Stencil, norms, smoothers, transfers, and the kernel dispatch."""

from . import dispatch, norms, smooth, stencil, transfer  # noqa: F401
