"""Plain-PyTorch oracles for the port's kernels (§4.2 of the paper).

The same semantics as ``repro.kernels.ref``; also the ``ssrcfg``-off path
of :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

from typing import Optional

import torch


def dot_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Reduction (dot product): the paper's running example."""
    return torch.sum(x.to(torch.float32) * y.to(torch.float32))


def scan_ref(x: torch.Tensor) -> torch.Tensor:
    """All prefix sums (inclusive), in f32."""
    return torch.cumsum(x.to(torch.float32), 0)


def relu_ref(x: torch.Tensor) -> torch.Tensor:
    """max(0, x) with ``jnp.maximum``'s signed zeros: -0.0 → +0.0, NaN kept."""
    return torch.where((x > 0) | torch.isnan(x), x, x.new_zeros(()))


def stencil1d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """11-point star stencil: y[i] = Σ_j w[j]·x[i+j], valid region only.

    ``x`` is the padded input of length n + taps − 1; output length n.
    """
    taps = w.shape[0]
    n = x.shape[0] - taps + 1
    xf = x.to(torch.float32)
    acc = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for j in range(taps):
        acc = acc + w[j].to(torch.float32) * xf[j:j + n]
    return acc


def stencil2d_ref(x: torch.Tensor, wx: torch.Tensor,
                  wy: torch.Tensor) -> torch.Tensor:
    """Star-shaped 2-D stencil (cross of two 1-D arms, diameter = len(w)).

    ``x`` padded by r = taps//2 on all sides; arms share the centre point, so
    the centre coefficient is wx[r] + wy[r].
    """
    taps = wx.shape[0]
    r = taps // 2
    h, wgrid = x.shape[0] - 2 * r, x.shape[1] - 2 * r
    xf = x.to(torch.float32)
    acc = torch.zeros((h, wgrid), dtype=torch.float32, device=x.device)
    for j in range(taps):
        acc = acc + wx[j].to(torch.float32) * xf[r:r + h, j:j + wgrid]
        acc = acc + wy[j].to(torch.float32) * xf[j:j + h, r:r + wgrid]
    return acc


def gemv_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float32), x.to(torch.float32))


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def fft_ref(re: torch.Tensor,
            im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward DFT (no normalisation), split real/imag, f32.  Rows of 0
    points give the empty pair, as ``jnp.fft.fft`` does (``torch.fft``
    refuses them)."""
    re, im = re.to(torch.float32), im.to(torch.float32)
    if re.shape[-1] == 0:
        return torch.empty_like(re), torch.empty_like(im)
    z = torch.fft.fft(torch.complex(re, im))
    return z.real.contiguous(), z.imag.contiguous()


def sort_ref(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort along the last axis (NaN last)."""
    return torch.sort(x).values


# -- fused (chained and DAG) oracles ------------------------------------------


def gemv_relu_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return relu_ref(gemv_ref(a, x))


def stencil1d_relu_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return relu_ref(stencil1d_ref(x, w))


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


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Attention oracle: softmax(q·kᵀ·scale + mask)·v, per head.

    ``window``: sliding-window (h2o-danube style) — query i attends to keys
    in (i − window, i].  Query rows align to the keys' end (row i is key
    position i + sk − sq).  Masked scores are −inf.  Computed in f32
    regardless of input dtype.  Leading dims of q (…, sq, d) and k, v
    (…, sk, d) are heads.
    """
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    f = torch.float32
    logits = torch.einsum("...qd,...kd->...qk", q.to(f), k.to(f)) * scale
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kj = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    logits = torch.where(mask, logits, torch.tensor(-torch.inf, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p, v.to(f))
