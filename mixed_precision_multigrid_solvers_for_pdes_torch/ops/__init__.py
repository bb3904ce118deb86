"""Stencil, norms, smoothers, transfers, and the kernel dispatch."""

from . import (  # noqa: F401
    dispatch, norms, planes, smooth, smooth3d, stencil, stencil3d, transfer,
    transfer3d,
)
