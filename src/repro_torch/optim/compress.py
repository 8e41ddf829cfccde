"""Int8 gradient compression with error feedback.

Gradients are quantised to int8 with a per-leaf absmax scale, and the
quantisation error is fed back into the next step's gradients (error
feedback keeps SGD/Adam convergence).  ``quantize``, ``dequantize``,
``compress_leaf`` and ``init_residuals`` are the reference's, bit for bit:
both round half to even.  ``compressed_psum`` is the all-reduce-mean over
one mesh axis, on every rank along it (``parallel/collectives.py``): a MAX
all-reduce of the scales, each rank's values requantised against the
shared scale, a SUM all-reduce in int32, and the mean.
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


def compressed_psum(grads: Any, residuals: Any, axis_name: str, *,
                    mesh=None) -> Tuple[Any, Any]:
    """All-reduce-mean ``grads`` over ``axis_name`` in int8 (+error
    feedback) → (the mean tree, the new residual tree).

    Every rank along the axis calls it (explicit SPMD); ``mesh`` defaults
    to the ambient one (``parallel.activations.activation_mesh``).  int8
    summands are widened to int32 for the reduction (n ≤ 2^23 ranks before
    overflow at |q| ≤ 127) and rescaled by the max scale across the axis
    so all peers dequantise identically.
    """
    from ..parallel import collectives
    from ..parallel.activations import get_activation_mesh

    mesh = mesh if mesh is not None else get_activation_mesh()
    if mesh is None:
        raise ValueError("compressed_psum needs a mesh: pass mesh= or set "
                         "one with parallel.activations.activation_mesh")
    n = mesh.shape[axis_name]

    def one(g, r):
        q, scale, new_r = compress_leaf(g, r)
        scale_max = collectives.all_reduce(scale, mesh, axis_name, op="max")
        # requantise against the shared scale so the sum is well-defined
        q_shared = torch.clamp(
            torch.round(dequantize(q, scale) / scale_max), -127, 127
        ).to(torch.int32)
        total = collectives.all_reduce(q_shared, mesh, axis_name)
        mean = total.float() * scale_max / torch.full(
            (), n, dtype=torch.float32, device=total.device)
        return mean.to(g.dtype), new_r

    flat_r = {keypaths.key(p): r
              for p, r in keypaths.leaves_with_path(residuals)}
    outs = {}
    for path, g in keypaths.leaves_with_path(grads):
        outs[keypaths.key(path)] = one(g, flat_r[keypaths.key(path)])
    return (keypaths.map_with_path(lambda p, _: outs[keypaths.key(p)][0],
                                   grads),
            keypaths.map_with_path(lambda p, _: outs[keypaths.key(p)][1],
                                   grads))
