"""Scan (all prefix sums) over a long vector — paper §4.2, 4096 values.

SSR structure, as in ``repro.kernels.scan``: one read stream and one write
stream walk the padded vector's (8, 128) blocks in lockstep; the carry
lives in scratch across the grid steps, whose one axis is ``arbitrary``
(sequential).  A waivered :class:`~repro_torch.kernels.frontend.
StreamKernel`: on the CPU the Launch runs as the in-order block walk, on
the card as K14 ``stream_scan`` (``csrc/stream_scan.cu``), whose CTAs run
concurrently, so the carry is combined by a deterministic second pass
over the tiles' totals.  A ``schedule=`` of ``buffer_depth`` above 2 on a
grid of more than one step pipelines it: on the CPU the walk takes the
stage ring's blocks, on the card R15 ``ring_stream_scan`` runs K14's
scan in one pass that reads x once, its tiles through a ring of
shared-memory slots and each tile's offset found from its predecessors'
published totals, to K14's bits.

Baseline variant: the reference's monolithic kernel — the body walks the
blocks with an explicit load per block and the carry in a register; on
the card B8 ``base_scan`` (``csrc/base_scan.cu``), on K14's CTAs and
tiles.

Inputs are promoted to f32, so f32, bf16 and int32 all give an f32 prefix
sum.  The vector is 1-D, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import hopper
from ..core.ssr import BlockStream, KernelBody
from ..core.stream import Direction
from .frontend import (LANES, ROWS, Launch, MonolithicKernel, ShapeDtype,
                       StreamKernel, pad_vector, promote, trim_vector)
from .registry import KernelEntry, register_kernel


def _prepare(x):
    return (pad_vector(x),), None, x.shape[0]


def _scan_block(i, x_blk, carry):
    """One step: the block's prefix sums plus the carry, and the carry
    plus the block's total (zeroed at the first step)."""
    if i == 0:
        carry = torch.zeros_like(carry)
    csum = torch.cumsum(promote(x_blk).reshape(-1), 0)
    y = (csum + carry[0, 0]).reshape(ROWS, LANES)
    return (y,), ((carry[0, 0] + csum[-1]).reshape(1, 1),)


SCAN = KernelBody(_scan_block, "scan")


def _launch(static, x2d):
    return Launch(
        grid=(x2d.shape[0] // ROWS,),
        in_streams=(BlockStream((ROWS, LANES), lambda i: (i, 0), name="x"),),
        out_streams=(BlockStream((ROWS, LANES), lambda i: (i, 0),
                                 Direction.WRITE, name="y"),),
        out_shapes=(ShapeDtype(tuple(x2d.shape), torch.float32),),
        scratch_shapes=(ShapeDtype((1, 1), torch.float32),),
        dimension_semantics=("arbitrary",),
    )


_ssr = StreamKernel(
    "scan", prepare=_prepare, launch=_launch, body=lambda static: SCAN,
    finish=trim_vector,
    lowering_waiver=(
        "loop-carried dependence: block i+1's prefix needs block i's total "
        "— a sequenced VMEM carry register, not an affine stream walk a "
        "LoopNest can express"))

#: The baseline body: the block walk over the padded layout, whose device
#: kernel is ``base_scan``.
BASE_SCAN = KernelBody(hopper.plain_base_scan, "scan")

_base = MonolithicKernel(
    "scan", prepare=_prepare, body=lambda static: BASE_SCAN,
    out_dtype=lambda static, *layouts: torch.float32, finish=trim_vector)


def ssr_scan(x: torch.Tensor, *, schedule=None,
             device=None) -> torch.Tensor:
    """Inclusive prefix sum; input padded to whole blocks, result trimmed."""
    return _ssr(x, schedule=schedule, device=device)


def baseline_scan(x: torch.Tensor, *, device=None) -> torch.Tensor:
    """The monolithic baseline of the prefix sum."""
    return _base(x, device=device)


@register_kernel("scan")
def _entry() -> KernelEntry:
    from . import ref

    def example(rng: np.random.Generator, odd: bool = False):
        n = 3000 if odd else 4096
        return ((torch.from_numpy(rng.standard_normal(n).astype(np.float32)),),
                {})

    return KernelEntry(name="scan", ssr=ssr_scan, baseline=baseline_scan,
                       ref=ref.scan_ref, example=example,
                       tol={"rtol": 1e-3, "atol": 1e-3},
                       problem="prefix sums, n=4096")
