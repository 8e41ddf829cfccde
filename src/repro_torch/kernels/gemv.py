"""Dense matrix-vector product (GEMV) — paper §4.2 (64×64 · 64).

Nest-lowered, as in the reference: the matrix walks both loops dense, x is
a *repeat* stream (coefficient 0 on the row level — the paper's repeat
register), and y is revisited across the column walk, so ``lower_nest``
carries it in an accumulator.  On the card the schedule runs as the
``contract_gemv`` Hopper kernel (``csrc/contract_gemv.cu``).

Baseline variant: the reference's monolithic kernel — A's rows padded to a
multiple of 8, x as (1, n), each 8-row panel loaded explicitly and
multiplied by x read whole again, into an (m8, 1) f32 output trimmed to
m.  On the card it runs as the ``base_gemv`` Hopper kernel
(``csrc/base_gemv.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import compiler, hopper
from ..core.ssr import KernelBody
from .frontend import (ROWS, MonolithicKernel, NestKernel, on_device,
                       pad_leading, promote)
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


def cluster_gemv(a: torch.Tensor, x: torch.Tensor, *, cores: int,
                 device=None) -> torch.Tensor:
    """GEMV on a C-core cluster (paper §5.3): row-block split.

    GEMV is a reduction *per row*, so the nest-level map/reduce modes do
    not apply; instead the output rows split across cores
    (``cluster_kernel``): each core runs the unchanged streamed GEMV (K4
    on the card) on its view of a row panel of A with x replicated (the
    TCDM broadcast), and the row tiles concatenate with no combine.  A is
    padded (copied) only where ``cores · ROWS`` does not divide its rows.
    """
    from ..parallel.cluster import cluster_kernel

    a, x = on_device((a, x), resolve_device(device))
    m = a.shape[0]
    a = pad_leading(a, cores * ROWS)
    out = cluster_kernel(
        lambda ac, xc: ssr_gemv(ac, xc, device=device),
        (a, x), cores=cores, in_dims=(0, None), out_dim=0)
    return out.reshape(-1)[:m]


def _prepare_base(a, x):
    m, n = a.shape
    return (pad_leading(a, ROWS).contiguous(), x.reshape(1, n)), None, m


#: The baseline body: the panel walk over the padded layouts, whose device
#: kernel is ``base_gemv``.
BASE_MATVEC = KernelBody(hopper.plain_base_gemv, "matvec")

_base = MonolithicKernel(
    "gemv", prepare=_prepare_base, body=lambda static: BASE_MATVEC,
    out_dtype=lambda static, a, x: torch.float32,
    finish=lambda out, m: out.reshape(-1)[:m])


def baseline_gemv(a: torch.Tensor, x: torch.Tensor, *,
                  device=None) -> torch.Tensor:
    """The monolithic baseline of y = A·x, f32 out."""
    return _base(a, x, device=device)


@register_kernel("gemv")
def _entry() -> KernelEntry:
    from . import ref

    def example(rng: np.random.Generator, odd: bool = False):
        m, n = (60, 64) if odd else (64, 64)
        return ((torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)),
                 torch.from_numpy(rng.standard_normal(n).astype(np.float32))),
                {})

    return KernelEntry(name="gemv", ssr=ssr_gemv, baseline=baseline_gemv,
                       ref=ref.gemv_ref, cluster=cluster_gemv,
                       example=example, tol={"rtol": 1e-3, "atol": 1e-3},
                       problem="64×64 · 64")
