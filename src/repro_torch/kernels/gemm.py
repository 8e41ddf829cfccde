"""Tiled GEMM — paper §4.2 (32×32·32×32) and the stack's ``ssr_matmul``.

Fully compiler-scheduled, as in the reference: the module declares only
:func:`~repro_torch.core.compiler.gemm_nest` (three AGU loops m, n, k; two
read streams; one write ref revisited across k) and the block product, and
``ssrify``/``lower_nest``/``ssr_call`` derive the grid, the index maps (A
repeats across n; B's storage order (k, n) permutes the loop order) and
the f32 accumulator over the k walk.  On the card the schedule runs as the
``contract_gemm`` Hopper kernel (``csrc/contract_gemm.cu``).

Baseline variant: the reference's monolithic kernel — k zero-padded to a
multiple of 128, the body walks k in ``min(k, 128)`` chunks with explicit
loads of A[:, kc] and B[kc, :] and an f32 accumulator cast to
``out_dtype`` once.  On the card it runs as the ``base_gemm`` Hopper kernel
(``csrc/base_gemm.cu``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core import compiler, hopper
from ..core.ssr import KernelBody
from .frontend import MonolithicKernel, NestKernel, on_device, promote
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


def _prepare_base(a, b, out_dtype=None):
    out_dtype = out_dtype or a.dtype
    pk = (-a.shape[1]) % 128
    if pk:
        a = F.pad(a, (0, pk))
        b = F.pad(b, (0, 0, 0, pk))
    return (a.contiguous(), b.contiguous()), out_dtype, None


#: The baseline body: the k-chunk walk over the padded layouts, whose
#: device kernel is ``base_gemm``.
BASE_DOT = KernelBody(hopper.plain_base_gemm, "dot")

_base = MonolithicKernel(
    "gemm", prepare=_prepare_base, body=lambda out_dtype: BASE_DOT,
    out_dtype=lambda out_dtype, a, b: out_dtype)


def baseline_matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
                    device=None) -> torch.Tensor:
    """The monolithic baseline of C = A·B."""
    return _base(a, b, out_dtype=out_dtype, device=device)


def cluster_matmul(a: torch.Tensor, b: torch.Tensor, *, cores: int,
                   out_dtype=None, device=None) -> torch.Tensor:
    """GEMM on a C-core cluster (paper §5.3): the 2-D row×col split.

    The iteration space splits on *both* parallel levels: cores factor into
    a (rows × cols) grid (closest to square), each core takes a view of a
    row panel of A and of a column panel of B and runs the unchanged
    compiled GEMM (K3 on the card) on its (m/Cr, n/Cc) output tile — the
    contraction (k) stays core-local, so there is no combine.  A column
    panel of B is a strided view, which the lowering lays out contiguous
    for K3, one copy a core.  ``cores=1`` is ``ssr_matmul``.
    """
    from ..parallel.cluster import cluster_kernel2d, factor_cores

    if cores == 1:
        return ssr_matmul(a, b, out_dtype=out_dtype, device=device)
    a, b = on_device((a, b), resolve_device(device))
    cr, cc = factor_cores(cores)
    m, n = a.shape[0], b.shape[1]
    pm, pn = (-m) % cr, (-n) % cc
    if pm:
        a = F.pad(a, (0, 0, 0, pm))
    if pn:
        b = F.pad(b, (0, pn))
    out = cluster_kernel2d(
        lambda ac, bc: ssr_matmul(ac, bc, out_dtype=out_dtype,
                                  device=device),
        (a, b), cores=cores, in_dims=((0, None), (None, 1)), out_dims=(0, 1))
    return out[:m, :n]


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

    return KernelEntry(name="gemm", ssr=ssr_matmul,
                       baseline=baseline_matmul, ref=_ref,
                       cluster=cluster_matmul, example=example, tol={"rtol": 2e-4, "atol": 2e-4},
                       problem="32×32 · 32×32")
