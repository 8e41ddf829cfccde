"""Int8 gradient compression with error feedback.

Gradients are quantised to int8 with a per-leaf absmax scale, and the
quantisation error is fed back into the next step's gradients (error
feedback keeps SGD/Adam convergence).  ``quantize``, ``dequantize``,
``compress_leaf`` and ``init_residuals`` are the reference's, bit for bit:
both round half to even.  The all-reduce over a mesh axis,
``compressed_psum``, belongs to the multi-device layer (port slice 9d).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from .. import keypaths


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 scale): x / scale rounded half to even into
    [−127, 127], scale = max(max |x|, 1e-12) / 127."""
    tiny = torch.full((), 1e-12, dtype=x.dtype, device=x.device)
    scale = torch.maximum(torch.amax(torch.abs(x)), tiny) \
        / torch.full((), 127.0, dtype=x.dtype, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_leaf(g: torch.Tensor, residual: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (quantised, scale, new_residual) with error feedback."""
    gf = g.float() + residual
    q, scale = quantize(gf)
    new_res = gf - dequantize(q, scale)
    return q, scale, new_res


def init_residuals(grads: Any) -> Any:
    return keypaths.map_with_path(
        lambda _, g: torch.zeros(g.shape, dtype=torch.float32,
                                 device=g.device), grads)


def compressed_psum(grads: Any, residuals: Any, axis_name: str):
    """The int8 all-reduce-mean over a mesh axis: port slice 9d."""
    raise NotImplementedError(
        "compressed_psum is a collective over a mesh axis; the multi-device "
        "layer is port slice 9d")
