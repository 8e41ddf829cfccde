"""Plain-PyTorch oracles for the port's kernels (§4.2 of the paper).

The same semantics as ``repro.kernels.ref``; also the ``ssrcfg``-off path
of :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import torch


def dot_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Reduction (dot product): the paper's running example."""
    return torch.sum(x.to(torch.float32) * y.to(torch.float32))


def relu_ref(x: torch.Tensor) -> torch.Tensor:
    """max(0, x) with ``jnp.maximum``'s signed zeros: -0.0 → +0.0, NaN kept."""
    return torch.where((x > 0) | torch.isnan(x), x, x.new_zeros(()))


def gemv_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float32), x.to(torch.float32))


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))
