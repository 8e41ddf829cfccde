"""ReLU over a vector — paper §4.2 (max(0, x) over 1024 values).

The simplest stream kernel: a 1-D
:func:`~repro_torch.core.compiler.elementwise_nest` compiled through the
§3.2 pipeline — one read stream in, the map-mode dense write stream out.
On the card it runs as the ``map_relu`` Hopper kernel
(``csrc/map_relu.cu``); ``ssr_elementwise`` takes any unary body on the
CPU, and on the card only a :class:`~repro_torch.core.ssr.KernelBody`
whose op has a kernel.

Baseline variant: the reference's monolithic kernel — x padded to
(rows, 128), each (8, 128) block loaded explicitly and its relu stored in
its place.  On the card it runs as the ``base_relu`` Hopper kernel
(``csrc/base_relu.cu``); a custom ``fn`` has no baseline kernel there.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..core import compiler, hopper
from ..core.ssr import KernelBody
from .frontend import (MonolithicKernel, NestKernel, on_device, pad_vector,
                       trim_vector)
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


def _prepare_base(x, fn=RELU):
    return (pad_vector(x),), fn, x.shape[0]


def _baseline_body(fn):
    """``fn`` on every block of the padded layout; the ``base_relu`` kernel
    runs it on the card when ``fn`` is tagged ``relu``."""
    plain = functools.partial(hopper.plain_base_map, fn)
    return KernelBody(plain, "relu") if getattr(fn, "op", None) == "relu" \
        else plain


_base = MonolithicKernel(
    "relu", prepare=_prepare_base, body=_baseline_body,
    out_dtype=lambda fn, x2d: x2d.dtype, finish=trim_vector)


def ssr_elementwise(x: torch.Tensor, fn: Callable, *, schedule=None,
                    device=None) -> torch.Tensor:
    """Streamed elementwise unary: one read stream, one write stream."""
    return _ssr(x, fn, schedule=schedule, device=device)


def ssr_relu(x: torch.Tensor, *, schedule=None,
             device=None) -> torch.Tensor:
    return _ssr(x, schedule=schedule, device=device)


def baseline_relu(x: torch.Tensor, *, device=None) -> torch.Tensor:
    """The monolithic baseline of relu, dtype kept."""
    return _base(x, device=device)


def cluster_relu(x: torch.Tensor, *, cores: int,
                 device=None) -> torch.Tensor:
    """ReLU on a C-core cluster (paper §5.3): a pure map split C ways.

    Each core streams its view of x through the §3.2 compiler path (K2 on
    the card), dtype kept as ``ssr_relu`` keeps it; the output tiles
    concatenate along the split with no combine, because an elementwise
    map shares nothing between cores.
    """
    from ..parallel.cluster import cluster_call, pad_to_cores

    (x,) = on_device((x,), resolve_device(device))
    n = x.shape[0]
    (x,), n_pad = pad_to_cores((x,), cores)
    out = cluster_call(compiler.elementwise_nest(n_pad), RELU, {"X": x},
                       mode="map", cores=cores, out_dtype=x.dtype,
                       device=device)
    return out[:n]


@register_kernel("relu")
def _entry() -> KernelEntry:
    def example(rng: np.random.Generator, odd: bool = False):
        n = 1025 if odd else 1024
        return ((torch.from_numpy(rng.standard_normal(n).astype(np.float32)),),
                {})

    return KernelEntry(name="relu", ssr=ssr_relu, baseline=baseline_relu,
                       ref=relu_ref, cluster=cluster_relu,
                       example=example, tol={"rtol": 0.0, "atol": 0.0},
                       problem="max(0,x), n=1024")
