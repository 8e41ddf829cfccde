"""Bitonic sort network — paper §4.2 (1024 values).

As in ``repro.kernels.bitonic``: the compare-exchange pattern is fixed, so
every stage's partner access is a power-of-two strided stream; each
stage's pairing is a reshape to (n/2j, 2, j) and the direction comes from
an iota.  A waivered :class:`~repro_torch.kernels.frontend.StreamKernel`:
on the CPU the Launch runs as the block walk, on the card as K16
``stream_bitonic`` (``csrc/stream_bitonic.cu``).

Min and max follow ``jnp.minimum``/``jnp.maximum`` exactly, which
``torch.minimum``/``torch.maximum`` do not: a NaN propagates (so one NaN
turns every output of the network to NaN, as the reference's ``ssr_sort``
does; its oracle ``sort_ref`` sorts NaN last), and −0 orders below +0.
The dtype is kept (f32, bf16, int32).  Leading dims are a batch of rows
(the counterpart of ``jax.vmap(ssr_sort)``), each sorted alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.ssr import BlockStream, KernelBody
from ..core.stream import Direction
from .frontend import Launch, ShapeDtype, StreamKernel, require_power_of_two
from .registry import KernelEntry, register_kernel


def _prepare(x):
    require_power_of_two(x.shape[-1], "bitonic network")
    return (x.reshape(-1, x.shape[-1]),), None, tuple(x.shape)


def min_max(a: torch.Tensor, b: torch.Tensor):
    """(jnp.minimum(a, b), jnp.maximum(a, b)), selected, never computed: a
    NaN operand is both results (a's where both are NaN), and a pair of
    zeros orders −0 below +0."""
    if not a.is_floating_point():
        lt = a < b
        return torch.where(lt, a, b), torch.where(lt, b, a)
    lt = (a < b) | ((a == b) & torch.signbit(a) & ~torch.signbit(b))
    nan = torch.where(torch.isnan(a), a, b)
    either = torch.isnan(a) | torch.isnan(b)
    return (torch.where(either, nan, torch.where(lt, a, b)),
            torch.where(either, nan, torch.where(lt, b, a)))


def _network(i, x_blk):
    n = x_blk.shape[1]
    x = x_blk.reshape(n)
    stages = int(math.log2(n))
    for ks in range(1, stages + 1):        # k = 2**ks
        k = 1 << ks
        for js in range(ks - 1, -1, -1):   # j = 2**js
            j = 1 << js
            X = x.reshape(n // (2 * j), 2, j)
            a, b = X[:, 0, :], X[:, 1, :]
            # ascending iff (i & k) == 0; i = q·2j + h·j + r and k ≥ 2j,
            # so the k-bit of i is carried entirely by q
            q = torch.arange(n // (2 * j), device=x.device).reshape(-1, 1)
            asc = ((q * 2 * j) & k) == 0
            lo, hi = min_max(a, b)
            first = torch.where(asc, lo, hi)
            second = torch.where(asc, hi, lo)
            x = torch.stack([first, second], dim=1).reshape(n)
    return (x.reshape(1, n),), ()


BITONIC = KernelBody(_network, "bitonic")


def _launch(static, x2d):
    rows, n = x2d.shape
    return Launch(
        grid=(rows,),
        in_streams=(BlockStream((1, n), lambda i: (i, 0), name="x"),),
        out_streams=(BlockStream((1, n), lambda i: (i, 0),
                                 Direction.WRITE, name="y"),),
        out_shapes=(ShapeDtype((rows, n), x2d.dtype),),
        dimension_semantics=("parallel",),
    )


_ssr = StreamKernel(
    "bitonic", prepare=_prepare, launch=_launch,
    body=lambda static: BITONIC,
    finish=lambda out, shape: out.reshape(shape),
    lowering_waiver=(
        "compare-exchange network: each stage pairs elements at a "
        "different power-of-two distance — data-oblivious and affine per "
        "stage, but not one dense block walk over a single LoopNest"))


def ssr_sort(x: torch.Tensor, *, schedule=None,
             device=None) -> torch.Tensor:
    """Ascending sort of a power-of-two length vector (each row of a
    batch)."""
    return _ssr(x, schedule=schedule, device=device)


@register_kernel("bitonic")
def _entry() -> KernelEntry:
    from . import ref

    def example(rng: np.random.Generator, odd: bool = False):
        n = 64 if odd else 1024    # no odd sizes: the network requires 2^k
        return ((torch.from_numpy(rng.standard_normal(n).astype(np.float32)),),
                {})

    return KernelEntry(name="bitonic", ssr=ssr_sort, ref=ref.sort_ref,
                       example=example, tol={"rtol": 0.0, "atol": 0.0},
                       problem="sort network, n=1024")
