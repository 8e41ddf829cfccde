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


# -- fused (chained and DAG) oracles ------------------------------------------


def gemv_relu_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return relu_ref(gemv_ref(a, x))


def sum_sq_diff_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Reduction-of-map: Σ (x − y)² — the fused map→reduce chain."""
    d = x.to(torch.float32) - y.to(torch.float32)
    return torch.sum(d * d)


def axpy_dot_ref(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
                 alpha: float = 1.0) -> torch.Tensor:
    """axpy→dot chain: (α·x + y) · w."""
    t = alpha * x.to(torch.float32) + y.to(torch.float32)
    return torch.sum(t * w.to(torch.float32))


def layernorm_ref(x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Per-row layernorm (no affine): (x − μ)·rsqrt(var + ε)."""
    xf = x.to(torch.float32)
    c = xf - xf.mean(dim=-1, keepdim=True)
    var = (c * c).mean(dim=-1, keepdim=True)
    return c * torch.rsqrt(var + eps)


def softmax_xent_ref(z: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Σ_rows softmax cross-entropy, targets ``p`` summing to 1 per row."""
    zf, pf = z.to(torch.float32), p.to(torch.float32)
    lse = torch.logsumexp(zf, dim=-1)
    return torch.sum(lse - torch.sum(pf * zf, dim=-1))


def mlp_block_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """2-layer MLP block with residual on the activation: HW₂+b₂+H."""
    f = torch.float32
    h = relu_ref(torch.matmul(x.to(f), w1.to(f)) + b1.to(f))
    return torch.matmul(h, w2.to(f)) + b2.to(f) + h
