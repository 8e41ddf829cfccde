"""Reduction (dot product) — the paper's running example (Fig. 4, §4.1).

Declared as the Fig. 4 :func:`~repro_torch.core.compiler.dot_product_nest`
and compiled through ``ssrify``/``lower_plan``/``ssr_call``: both operands
become read streams walked in lockstep by the AGU, the body multiplies two
(8, 128) blocks, and the reduce epilogue is the accumulator register ``%x``
of Fig. 4.  On the card the schedule runs as the ``reduce_mul`` Hopper
kernel (``csrc/reduce_mul.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import compiler
from ..core.ssr import KernelBody
from .frontend import NestKernel, promote
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


def ssr_dot(x: torch.Tensor, y: torch.Tensor, *, schedule=None,
            device=None) -> torch.Tensor:
    """Streamed dot product; n is padded up to a whole number of blocks."""
    return _ssr(x, y, schedule=schedule, device=device)


@register_kernel("reduction")
def _entry() -> KernelEntry:
    from . import ref

    def example(rng: np.random.Generator, odd: bool = False):
        n = 5000 if odd else 2048
        return ((torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
                 torch.from_numpy(rng.standard_normal(n).astype(np.float32))),
                {})

    return KernelEntry(name="reduction", ssr=ssr_dot, ref=ref.dot_ref,
                       example=example, tol={"rtol": 1e-2, "atol": 1e-2},
                       problem="dot product, n=2048")
