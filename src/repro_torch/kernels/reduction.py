"""Reduction (dot product) — the paper's running example (Fig. 4, §4.1).

Declared as the Fig. 4 :func:`~repro_torch.core.compiler.dot_product_nest`
and compiled through ``ssrify``/``lower_plan``/``ssr_call``: both operands
become read streams walked in lockstep by the AGU, the body multiplies two
(8, 128) blocks, and the reduce epilogue is the accumulator register ``%x``
of Fig. 4.  On the card the schedule runs as the ``reduce_mul`` Hopper
kernel (``csrc/reduce_mul.cu``).

Baseline variant: the reference's monolithic kernel — both vectors padded
to (rows, 128), the body walks the (8, 128) blocks with an explicit load
pair per block and sums at once, with no run-ahead.  On the card it runs
as the ``base_reduce`` Hopper kernel (``csrc/base_reduce.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import compiler, hopper
from ..core.ssr import KernelBody
from .frontend import (MonolithicKernel, NestKernel, on_device, pad_vector,
                       promote)
from .registry import KernelEntry, register_kernel


def _mul(x_blk, y_blk):
    # block-shaped partial: the reduce epilogue accumulates the whole
    # (rows, lanes) block every step and folds to the scalar once
    return promote(x_blk) * promote(y_blk)


MUL = KernelBody(_mul, "mul")

_ssr = NestKernel(
    "reduction",
    prepare=lambda x, y: ({"A": x, "B": y}, x.shape[0], None),
    nest=compiler.dot_product_nest,
    body=lambda static: MUL,
    mode="reduce")


def _prepare_base(x, y):
    return (pad_vector(x), pad_vector(y)), None, None


#: The baseline body: the block walk over the padded layouts, whose device
#: kernel is ``base_reduce``.
BASE_MUL = KernelBody(hopper.plain_base_reduce, "mul")

_base = MonolithicKernel(
    "reduction", prepare=_prepare_base, body=lambda static: BASE_MUL,
    out_dtype=lambda static, *layouts: torch.float32,
    finish=lambda out, _: out[0, 0])


def ssr_dot(x: torch.Tensor, y: torch.Tensor, *, schedule=None,
            device=None) -> torch.Tensor:
    """Streamed dot product; n is padded up to a whole number of blocks."""
    return _ssr(x, y, schedule=schedule, device=device)


def cluster_dot(x: torch.Tensor, y: torch.Tensor, *, cores: int,
                device=None) -> torch.Tensor:
    """Dot product on a C-core cluster (paper §5.3/Fig. 10).

    The Fig. 4 nest split C ways on its (only) loop level; each core runs
    K1 on its views of x and y (on the card), and the per-core partials
    meet in the one combine.  Zero padding makes any n divisible and is
    reduce-neutral.
    """
    from ..parallel.cluster import cluster_call, pad_to_cores

    x, y = on_device((x, y), resolve_device(device))
    (x, y), n_pad = pad_to_cores((x, y), cores)
    return cluster_call(compiler.dot_product_nest(n_pad), MUL,
                        {"A": x, "B": y}, mode="reduce", cores=cores,
                        device=device)


def baseline_dot(x: torch.Tensor, y: torch.Tensor, *,
                 device=None) -> torch.Tensor:
    """The monolithic baseline of the dot product."""
    return _base(x, y, device=device)


@register_kernel("reduction")
def _entry() -> KernelEntry:
    from . import ref

    def example(rng: np.random.Generator, odd: bool = False):
        n = 5000 if odd else 2048
        return ((torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
                 torch.from_numpy(rng.standard_normal(n).astype(np.float32))),
                {})

    return KernelEntry(name="reduction", ssr=ssr_dot, baseline=baseline_dot,
                       ref=ref.dot_ref, cluster=cluster_dot,
                       example=example, tol={"rtol": 1e-2, "atol": 1e-2},
                       problem="dot product, n=2048")
