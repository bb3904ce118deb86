"""Grid norms with float64 accumulation.

Counterpart of ``scaled_l2``, ``max_norm``, ``masked_scaled_l2``,
``h1_seminorm`` and ``h1_seminorm3d`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/norms.py`` and of the
3D solvers' ``_norm3``: the sum is always taken in float64 whatever the
field's dtype. The l2 norms take one spacing per axis (hx, hy in 2D; hx, hy,
hz in 3D) and scale by their product. The results are 0-d tensors on the
field's device, so a caller reads them back only when it needs the value on
the host.
"""

from __future__ import annotations

import math

import torch


def scaled_l2(r: torch.Tensor, *h: float) -> torch.Tensor:
    """sqrt(prod(h)*sum(r^2)), accumulated in float64."""
    r64 = r.to(torch.float64)
    return torch.sqrt(math.prod(h) * torch.sum(r64 * r64))


def max_norm(r: torch.Tensor) -> torch.Tensor:
    """max |r| over the field, in r's dtype."""
    return torch.max(torch.abs(r))


def masked_scaled_l2(r: torch.Tensor, mask: torch.Tensor,
                     *h: float) -> torch.Tensor:
    """scaled_l2 over the nodes where ``mask`` is True."""
    r64 = torch.where(mask, r, torch.zeros((), dtype=r.dtype,
                                           device=r.device)).to(torch.float64)
    return torch.sqrt(math.prod(h) * torch.sum(r64 * r64))


def h1_seminorm(e: torch.Tensor, mask: torch.Tensor,
                *h: float) -> torch.Tensor:
    """sqrt(prod(h) * sum |grad_h e|^2) by forward differences along each
    axis (one spacing per axis), counting only edges whose both endpoints
    are in ``mask``; float64."""
    e64 = torch.where(mask, e, torch.zeros((), dtype=e.dtype,
                                           device=e.device)).to(torch.float64)
    s = torch.zeros((), dtype=torch.float64, device=e.device)
    for ax, hk in enumerate(h):
        n = e64.shape[ax]
        d = (e64.narrow(ax, 1, n - 1) - e64.narrow(ax, 0, n - 1)) / hk
        m = mask.narrow(ax, 1, n - 1) & mask.narrow(ax, 0, n - 1)
        s = s + torch.sum(torch.where(m, d * d, 0.0))
    return torch.sqrt(math.prod(h) * s)


h1_seminorm3d = h1_seminorm  # the 3D name of the JAX package
