"""Star-shaped stencils (discrete Laplace style, diameter 11) — paper §4.2.

Both stencils are nest-lowered, as in ``repro.kernels.stencil``: the module
declares only the loop nest (a windowed READ ref — ``MemRef.window`` — plus
invariant coefficient streams) and the tap-loop body; ``lower_nest`` serves
the halo as ``2**k`` +1-shifted twin streams per windowed ref (k halo'd
levels), and the body sees one widened block per step.  The tap loop is
unrolled with static slices.

On the card the 1-D stencil runs as K9 ``halo_stencil1d``
(``csrc/halo_stencil1d.cu``) and the 2-D one as K10 ``halo_stencil2d``
(``csrc/halo_stencil2d.cu``); each reads the widened block straight from
the first slot's walk, so the twins stay in the plan and its accounting but
are never read.  A schedule deeper than 2 runs them as the ring kernels R10
``ring_halo_stencil1d`` and R11 ``ring_halo_stencil2d``: the same
arithmetic, the widened items or windows arriving through an N-deep ring
at the first slot's depth.  The 1-D baseline is the reference's monolithic kernel (one
explicit dynamic-slice load per tap), on the card B5 ``base_stencil1d``
(``csrc/base_stencil1d.cu``).  ``cluster_stencil1d`` runs the 1-D
stencil on C cores (``parallel/cluster.py``), each core on an overlapping
view of x.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core import compiler, hopper
from ..core.lowering import Schedule
from ..core.ssr import KernelBody
from .frontend import MonolithicKernel, NestKernel, on_device, promote
from .registry import KernelEntry, register_kernel

TAPS = 11


def _check_taps(w: torch.Tensor) -> None:
    if w.shape[0] != TAPS:
        raise ValueError(f"stencil diameter fixed at {TAPS} (paper §4.2)")


# -- 1-D --------------------------------------------------------------------


def stencil1d_block(x_wide: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """The tap loop over one widened ``(1, t + TAPS - 1)`` halo block.

    Shared with the fused (chained) variant; the output width comes from
    the block itself, so the schedule's geometry flows through.
    """
    t = x_wide.shape[-1] - (TAPS - 1)
    acc = promote(w2d[0, 0]) * promote(x_wide[:, 0:t])
    for j in range(1, TAPS):
        acc = acc + promote(w2d[0, j]) * promote(x_wide[:, j:j + t])
    return acc


STENCIL1D = KernelBody(stencil1d_block, "stencil1d")


def _prepare_1d(x, w):
    _check_taps(w)
    n = x.shape[0] - (TAPS - 1)
    return {"x": x, "w": w}, n, None


def _nest_1d(n):
    return compiler.stencil_nest(n, TAPS)


_ssr_1d = NestKernel("stencil1d", prepare=_prepare_1d, nest=_nest_1d,
                     body=lambda n: STENCIL1D)


def ssr_stencil1d(x: torch.Tensor, w: torch.Tensor, *,
                  schedule: Optional[Schedule] = None,
                  device=None) -> torch.Tensor:
    """y[i] = Σ_j w[j]·x[i+j] for i in [0, n); x has length n + TAPS − 1.

    ``x`` is a windowed ref (halo ``TAPS``) served by a +1-shifted twin
    stream; ``w`` rides as an invariant coefficient block.  ``schedule=None``
    resolves a tuned schedule from the autotuner's cache; every legal
    schedule computes the same values.
    """
    return _ssr_1d(x, w, schedule=schedule, device=device)


def _prepare_base_1d(x, w):
    _check_taps(w)
    n = x.shape[0] - (TAPS - 1)
    return ((x.reshape(1, -1).contiguous(),
             promote(w).reshape(1, TAPS).contiguous()), n, None)


#: The baseline body: the tap loop of dynamic-slice loads over (1, n + 10),
#: whose device kernel is ``base_stencil1d``.
BASE_STENCIL1D = KernelBody(hopper.plain_base_stencil1d, "stencil1d")

_base_1d = MonolithicKernel(
    "stencil1d", prepare=_prepare_base_1d, body=lambda n: BASE_STENCIL1D,
    out_dtype=lambda n, *arrs: torch.float32,
    finish=lambda out, _: out.reshape(-1))


def baseline_stencil1d(x: torch.Tensor, w: torch.Tensor, *,
                       device=None) -> torch.Tensor:
    """Monolithic variant: one explicit dynamic-slice load per tap."""
    return _base_1d(x, w, device=device)


def cluster_stencil1d(x: torch.Tensor, w: torch.Tensor, *, cores: int,
                      device=None) -> torch.Tensor:
    """1-D stencil on a C-core cluster (paper §5.3): output-tile split.

    Each core owns a contiguous slab of ``tile`` outputs and reads its slab
    plus a ``TAPS − 1`` halo of input — the shared-TCDM neighbourhood the
    paper's cores read for free.  Core c's input is the view
    ``x[c·tile : c·tile + tile + TAPS − 1]`` (C overlapping views of one
    tensor, where the reference gathers C tiles); each core runs the
    unchanged streamed stencil (K9 on the card) on it, and the output slabs
    concatenate with no combine (per-element tap sums are the single-core
    walk's, so the split is exact).  x is padded (copied) only where C
    slabs reach past it.
    """
    from ..parallel.cluster import cluster_kernel

    if cores == 1:
        return ssr_stencil1d(x, w, device=device)
    _check_taps(w)
    x, w = on_device((x, w), resolve_device(device))
    n = x.shape[0] - (TAPS - 1)
    tile = -(-n // cores)
    need = cores * tile + TAPS - 1
    if need > x.shape[0]:
        x = F.pad(x, (0, need - x.shape[0]))
    tiles = x.contiguous().as_strided((cores, tile + TAPS - 1), (tile, 1))
    out = cluster_kernel(
        lambda xt, wt: ssr_stencil1d(xt[0], wt, device=device)[None, :],
        (tiles, w), cores=cores, in_dims=(0, None), out_dim=0)
    return out.reshape(-1)[:n]


# -- 2-D --------------------------------------------------------------------


def stencil2d_block(x_wide: torch.Tensor, wx_blk: torch.Tensor,
                    wy_blk: torch.Tensor) -> torch.Tensor:
    """Both arms over one widened ``(h + 10, w + 10)`` block: per tap j the
    wx arm, then the wy arm, accumulated in f32 from zero."""
    r = TAPS // 2
    h = x_wide.shape[0] - (TAPS - 1)
    wd = x_wide.shape[1] - (TAPS - 1)
    x = promote(x_wide)
    acc = torch.zeros((h, wd), dtype=torch.float32, device=x.device)
    for j in range(TAPS):
        acc = acc + promote(wx_blk[0, j]) * x[r:r + h, j:j + wd]
        acc = acc + promote(wy_blk[0, j]) * x[j:j + h, r:r + wd]
    return acc


STENCIL2D = KernelBody(stencil2d_block, "stencil2d")


def _prepare_2d(x, wx, wy):
    _check_taps(wx)
    _check_taps(wy)
    r = TAPS // 2
    h, wd = x.shape[0] - 2 * r, x.shape[1] - 2 * r
    return {"x": x, "wx": wx, "wy": wy}, (h, wd), None


_ssr_2d = NestKernel(
    "stencil2d", prepare=_prepare_2d,
    nest=lambda static: compiler.stencil2d_nest(*static, TAPS),
    body=lambda static: STENCIL2D)


def ssr_stencil2d(x: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor, *,
                  schedule: Optional[Schedule] = None,
                  device=None) -> torch.Tensor:
    """Star stencil over a padded grid ``x`` (pad r = TAPS//2 each side).

    Nest-lowered with a ``(TAPS, TAPS)`` halo window on both levels: the
    lowering emits 4 shifted streams of the padded grid.
    """
    return _ssr_2d(x, wx, wy, schedule=schedule, device=device)


def _f32(rng: np.random.Generator, *shape, scale: float = 1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


@register_kernel("stencil1d")
def _entry_1d() -> KernelEntry:
    from . import ref

    def example(rng: np.random.Generator, odd: bool = False):
        n = 500 if odd else 1024
        return (_f32(rng, n + TAPS - 1), _f32(rng, TAPS, scale=0.3)), {}

    return KernelEntry(name="stencil1d", ssr=ssr_stencil1d,
                       baseline=baseline_stencil1d, ref=ref.stencil1d_ref,
                       cluster=cluster_stencil1d,
                       example=example, tol={"rtol": 1e-3, "atol": 1e-4},
                       problem="11-point star, n=1024")


@register_kernel("stencil2d")
def _entry_2d() -> KernelEntry:
    from . import ref

    def example(rng: np.random.Generator, odd: bool = False):
        hw = (42, 74) if odd else (74, 74)
        return ((_f32(rng, *hw), _f32(rng, TAPS, scale=0.3),
                 _f32(rng, TAPS, scale=0.3)), {})

    return KernelEntry(name="stencil2d", ssr=ssr_stencil2d,
                       ref=ref.stencil2d_ref, example=example,
                       tol={"rtol": 1e-3, "atol": 1e-3},
                       problem="11-point star, 64×64")
