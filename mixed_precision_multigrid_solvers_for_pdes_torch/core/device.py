"""Where the entry points run: on the CUDA card unless the caller asks for
another device.

``solve_poisson``, ``convergence_study``, ``solve_poisson3d``,
``build_hierarchy`` and ``build_hierarchy3d`` take ``device=None``, which
means the card. Without a card they raise rather than fall back to the
plain CPU path; a caller who wants the CPU passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is ``torch.device("cuda")``,
    which needs a CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available, and the solvers run "
                           "on the card unless asked otherwise: pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda")
