"""ReLU over a vector — paper §4.2 (max(0, x) over 1024 values).

The simplest stream kernel: a 1-D
:func:`~repro_torch.core.compiler.elementwise_nest` compiled through the
§3.2 pipeline — one read stream in, the map-mode dense write stream out.
On the card it runs as the ``map_relu`` Hopper kernel
(``csrc/map_relu.cu``); ``ssr_elementwise`` takes any unary body on the
CPU, and on the card only a :class:`~repro_torch.core.ssr.KernelBody`
whose op has a kernel.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import compiler
from ..core.ssr import KernelBody
from .frontend import NestKernel
from .registry import KernelEntry, register_kernel
from .ref import relu_ref


def relu_block(x: torch.Tensor) -> torch.Tensor:
    """Block→block ReLU, dtype kept (int32 above 2**24 stays exact)."""
    return relu_ref(x)


RELU = KernelBody(relu_block, "relu")

_ssr = NestKernel(
    "relu",
    prepare=lambda x, fn=RELU: ({"X": x}, (x.shape[0], fn, x.dtype), None),
    nest=lambda static: compiler.elementwise_nest(static[0]),
    body=lambda static: static[1],
    mode="map",
    # dtype-preserving, so the streamed engine is bit-exact with the oracle
    out_dtype=lambda static: static[2])


def ssr_elementwise(x: torch.Tensor, fn: Callable, *, schedule=None,
                    device=None) -> torch.Tensor:
    """Streamed elementwise unary: one read stream, one write stream."""
    return _ssr(x, fn, schedule=schedule, device=device)


def ssr_relu(x: torch.Tensor, *, schedule=None,
             device=None) -> torch.Tensor:
    return _ssr(x, schedule=schedule, device=device)


@register_kernel("relu")
def _entry() -> KernelEntry:
    def example(rng: np.random.Generator, odd: bool = False):
        n = 1025 if odd else 1024
        return ((torch.from_numpy(rng.standard_normal(n).astype(np.float32)),),
                {})

    return KernelEntry(name="relu", ssr=ssr_relu, ref=relu_ref,
                       example=example, tol={"rtol": 0.0, "atol": 0.0},
                       problem="max(0,x), n=1024")
