"""Shared layer primitives: norms, RoPE, FFNs, embeddings, initialisers.

The reference asks ``jnp.dot`` for ``preferred_element_type=f32`` in the
FFNs and the head: the product of bf16 operands is summed and returned in
f32, unrounded.  A bf16 ``torch.matmul`` rounds its output to bf16, so the
port computes those products through :func:`dot_f32` (and the attention's
through :func:`bmm_f32`), which pick per device: the CUDA backend has the
``out_dtype=torch.float32`` overloads of ``mm``/``bmm`` (f32 sums, f32
result); the CPU backend has no kernel for them (``aten::mm.dtype``), so
there both operands are upcast, which is exact, bf16 values being f32
values.

The card's ``out_dtype`` overloads have no derivative, so there the
products are :class:`F32Product`, whose backward computes each cotangent
product as the reference's gradient of a ``preferred_element_type=f32``
dot does: the f32 cotangent times the other operand upcast to f32, summed
in f32, then cast to the operand's dtype.  That is the CPU's upcast path's
gradient, so both devices round a gradient alike.  TF32 must be off for
these products (``torch.backends.cuda.matmul.allow_tf32``), as for the
forward.

``remat`` wraps a function in ``torch.utils.checkpoint`` (non-reentrant)
where the model asks for it and autograd is recording, the port's
counterpart of the reference's ``jax.checkpoint``: backward keeps the
function's inputs and recomputes the rest.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device

#: the meta device: parameters and caches as shapes and dtypes only
META = torch.device("meta")


class Init:
    """Where parameters are drawn: from ``generator`` on ``device``, or as
    shapes only on the meta device (``generator`` None)."""

    def __init__(self, generator: Optional[torch.Generator],
                 device: torch.device):
        self.generator = generator
        self.device = device

    @classmethod
    def of(cls, key, device=None) -> "Init":
        """``key`` is an int seed or a ``torch.Generator``; ``device`` is
        resolved as every entry point's is (``"meta"`` draws nothing)."""
        if device is not None and torch.device(device) == META:
            return cls(None, META)
        if isinstance(key, torch.Generator):
            dev = resolve_device(device if device is not None
                                 else key.device)
            if key.device.type != dev.type:
                raise ValueError(f"the generator is on {key.device}, the "
                                 f"parameters on {dev}")
            return cls(key, dev)
        dev = resolve_device(device)
        return cls(torch.Generator(device=dev).manual_seed(int(key)), dev)

    def normal(self, shape: Tuple[int, ...], std: float,
               dtype: torch.dtype) -> torch.Tensor:
        """N(0, std²) drawn in f32, then cast (as the reference draws)."""
        if self.generator is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return x.mul_(std).to(dtype)

    def ones(self, shape: Tuple[int, ...], dtype: torch.dtype
             ) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype, device=self.device)

    def zeros(self, shape: Tuple[int, ...], dtype: torch.dtype
              ) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16`` and so on."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def init_dense(init: Init, d_in: int, d_out: int, dtype: torch.dtype,
               scale: float = 1.0) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    return init.normal((d_in, d_out), std, dtype)


def init_embed(init: Init, vocab: int, d: int, dtype: torch.dtype
               ) -> torch.Tensor:
    return init.normal((vocab, d), 0.02, dtype)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(x, w)``: the operands promoted to one dtype, the result in
    it."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


class F32Product(torch.autograd.Function):
    """``a @ b`` of two 2-D or two 3-D (batched) operands of one dtype,
    summed and returned in f32, with the reference's gradient: each
    cotangent product is the f32 cotangent times the other operand upcast
    to f32, summed in f32 and cast to its operand's dtype.

    Forward is the card's ``out_dtype=torch.float32`` overload of
    ``mm``/``bmm``; on the CPU, which has no kernel for it, the upcast
    product (the same sums, as ``dot_f32`` computes there).
    """

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        mm = torch.mm if a.ndim == 2 else torch.bmm
        if a.device.type == "cuda":
            return mm(a, b, out_dtype=torch.float32)
        return mm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        g = g.float()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        return ga, gb


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over x's last axis, summed and returned in f32."""
    if x.dtype != w.dtype:
        x, w = x.float(), w.float()
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.device.type == "cuda":
        out = F32Product.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` (3-D operands), summed and returned in f32."""
    if a.dtype != b.dtype:
        a, b = a.float(), b.float()
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return F32Product.apply(a, b)
    return torch.bmm(a.float(), b.float())


def remat(fn: Callable, *args, enabled: bool):
    """``fn(*args)``; with ``enabled`` and autograd recording, under
    ``torch.utils.checkpoint``, so backward saves only ``args`` and
    recomputes the rest (the models draw no random numbers, so no RNG
    state is kept)."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions; shapes (..., head_dim//2)."""
    half = head_dim // 2
    steps = torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = 1.0 / torch.pow(theta, steps)     # f32: theta is a Python float
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x1, x2) = (x[..., :h], x[..., h:]).

    ``x``: (..., positions, heads, head_dim); cos/sin: (..., positions, h/2)
    broadcast over heads.
    """
    half = x.shape[-1] // 2
    c = cos[..., None, :]
    s = sin[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = dot_f32(x, w_gate)
    u = dot_f32(x, w_up)
    h = (F.silu(g) * u).to(x.dtype)
    return dot_f32(h, w_down).to(x.dtype)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh form; torch's is the exact erf one
    h = F.gelu(dot_f32(x, w_up), approximate="tanh")
    return dot_f32(h.to(x.dtype), w_down).to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy in f32; labels (B, S) int, logits (B, S, V)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
