"""Dense matrix-vector product (GEMV) — paper §4.2 (64×64 · 64).

Nest-lowered, as in the reference: the matrix walks both loops dense, x is
a *repeat* stream (coefficient 0 on the row level — the paper's repeat
register), and y is revisited across the column walk, so ``lower_nest``
carries it in an accumulator.  On the card the schedule runs as the
``contract_gemv`` Hopper kernel (``csrc/contract_gemv.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import compiler
from ..core.ssr import KernelBody
from .frontend import NestKernel, promote
from .registry import KernelEntry, register_kernel


def matvec_block(a, x):
    """(rows, n)·(1, n)ᵀ row-panel product → (rows, 1), in f32."""
    return torch.matmul(promote(a), promote(x).mT)


MATVEC = KernelBody(matvec_block, "matvec")

_ssr = NestKernel(
    "gemv",
    prepare=lambda a, x: ({"A": a, "x": x}, tuple(a.shape), None),
    nest=lambda static: compiler.gemv_nest(*static),
    body=lambda static: MATVEC)


def ssr_gemv(a: torch.Tensor, x: torch.Tensor, *, schedule=None,
             device=None) -> torch.Tensor:
    """Streamed GEMV through the full compiler path."""
    return _ssr(a, x, schedule=schedule, device=device)


@register_kernel("gemv")
def _entry() -> KernelEntry:
    from . import ref

    def example(rng: np.random.Generator, odd: bool = False):
        m, n = (60, 64) if odd else (64, 64)
        return ((torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)),
                 torch.from_numpy(rng.standard_normal(n).astype(np.float32))),
                {})

    return KernelEntry(name="gemv", ssr=ssr_gemv, ref=ref.gemv_ref,
                       example=example, tol={"rtol": 1e-3, "atol": 1e-3},
                       problem="64×64 · 64")
