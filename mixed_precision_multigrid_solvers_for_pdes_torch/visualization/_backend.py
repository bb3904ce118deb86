"""Shared matplotlib setup: lazy import, headless-safe, and fields moved to
the host.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/
visualization/_backend.py``. matplotlib is imported on first use, with the
Agg backend where no display is present, so the package imports without it.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def get_plt():
    import matplotlib

    if not os.environ.get("DISPLAY") and matplotlib.get_backend().lower() not in (
        "agg",
        "module://matplotlib_inline.backend_inline",
    ):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def host(field) -> np.ndarray:
    """A field as a host numpy array: a tensor (on any device, any dtype)
    is moved once and widened to float64; anything else goes through
    ``np.asarray``."""
    if isinstance(field, torch.Tensor):
        return field.detach().to("cpu", torch.float64).numpy()
    return np.asarray(field)


def finish(fig, save=None, show: bool = False):
    """Common save/show epilogue; returns the figure."""
    if save:
        fig.savefig(save, dpi=150, bbox_inches="tight")
    if show:
        get_plt().show()
    return fig
