"""Grid norms with float64 accumulation.

Counterpart of ``scaled_l2`` and ``masked_scaled_l2`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/norms.py``: the sum is
always taken in float64 whatever the field's dtype. The results are 0-d
tensors on the field's device, so a caller reads them back only when it needs
the value on the host.
"""

from __future__ import annotations

import torch


def scaled_l2(r: torch.Tensor, hx: float, hy: float) -> torch.Tensor:
    """sqrt(hx*hy*sum(r^2)), accumulated in float64."""
    r64 = r.to(torch.float64)
    return torch.sqrt(hx * hy * torch.sum(r64 * r64))


def masked_scaled_l2(r: torch.Tensor, mask: torch.Tensor, hx: float,
                     hy: float) -> torch.Tensor:
    """scaled_l2 over the nodes where ``mask`` is True."""
    r64 = torch.where(mask, r, torch.zeros((), dtype=r.dtype,
                                           device=r.device)).to(torch.float64)
    return torch.sqrt(hx * hy * torch.sum(r64 * r64))
