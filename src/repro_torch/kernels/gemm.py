"""Tiled GEMM — paper §4.2 (32×32·32×32) and the stack's ``ssr_matmul``.

Fully compiler-scheduled, as in the reference: the module declares only
:func:`~repro_torch.core.compiler.gemm_nest` (three AGU loops m, n, k; two
read streams; one write ref revisited across k) and the block product, and
``ssrify``/``lower_nest``/``ssr_call`` derive the grid, the index maps (A
repeats across n; B's storage order (k, n) permutes the loop order) and
the f32 accumulator over the k walk.  On the card the schedule runs as the
``contract_gemm`` Hopper kernel (``csrc/contract_gemm.cu``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import compiler
from ..core.ssr import KernelBody
from .frontend import NestKernel, promote
from .registry import KernelEntry, register_kernel


def _dot(a_blk, b_blk):
    # one output-block partial per grid step: C[i,j] += A[i,k]·B[k,j], in f32
    return torch.matmul(promote(a_blk), promote(b_blk))


DOT = KernelBody(_dot, "dot")


def _prepare(a, b, bm=None, bn=None, bk=None, out_dtype=None):
    m, kdim = a.shape
    k2, n = b.shape
    if kdim != k2:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    # Degenerate n/k zero-pad to 2 so every ref keeps its rank-2 storage
    # order (the body's (tm, tk)·(tk, tn) orientation); finish trims back.
    if n < 2:
        b = F.pad(b, (0, 2 - n))
    if kdim < 2:
        a = F.pad(a, (0, 2 - kdim))
        b = F.pad(b, (0, 0, 0, 2 - kdim))
    # bm/bn/bk are accepted for call-site compatibility; tiles come from
    # the lowering schedule
    return ({"A": a, "B": b}, (m, max(n, 2), max(kdim, 2)),
            (m, n, out_dtype))


def _finish(out, final):
    m, n, dtype = final
    return out[:m, :n].to(dtype)


_ssr = NestKernel("gemm", prepare=_prepare,
                  nest=lambda static: compiler.gemm_nest(*static),
                  body=lambda static: DOT, finish=_finish)


def ssr_matmul(a: torch.Tensor, b: torch.Tensor, *,
               bm: int | None = None, bn: int | None = None,
               bk: int | None = None, out_dtype=None, schedule=None,
               device=None) -> torch.Tensor:
    """C = A·B through the full compiler path (nest → plan → kernel)."""
    return _ssr(a, b, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype,
                schedule=schedule, device=device)


@register_kernel("gemm")
def _entry() -> KernelEntry:
    from . import ref

    def _ref(a, b, out_dtype=None, **tile_kw):
        # tile kwargs (bm/bn/bk) only steer the streamed engine
        return ref.matmul_ref(a, b).to(out_dtype or a.dtype)

    def example(rng: np.random.Generator, odd: bool = False):
        m, n, k = (100, 130, 70) if odd else (32, 32, 32)
        return ((torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)),
                 torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))),
                {"out_dtype": torch.float32})

    return KernelEntry(name="gemm", ssr=ssr_matmul, ref=_ref,
                       example=example, tol={"rtol": 2e-4, "atol": 2e-4},
                       problem="32×32 · 32×32")
