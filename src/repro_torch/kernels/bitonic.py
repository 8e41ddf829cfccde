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

K16 walks the network in passes over the row, each CTA one tile of
``hopper.SORT_TILE`` elements in shared memory: :func:`sort_passes` lists
them (tile sort, group passes, tile merges, each with its stages and every
CTA's index set), :func:`register_runs` the runs of stages a thread holds
in registers inside a pass, and :func:`run_passes` executes the network
pass by pass through those index sets — the plain mirror of the kernel's
schedule, equal to :func:`_network` to the bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..core.hopper import SORT_GROUP, SORT_REG_LOG2, SORT_TILE
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


def network_stages(n: int) -> List[Tuple[int, int]]:
    """The network's (k, j) stages in order: k = 2, 4, …, n, for each
    j = k/2, …, 1 (:func:`_network` runs them)."""
    stages = n.bit_length() - 1
    return [(1 << ks, 1 << js) for ks in range(1, stages + 1)
            for js in range(ks - 1, -1, -1)]


def _network(i, x_blk):
    n = x_blk.shape[1]
    x = x_blk.reshape(n)
    for k, j in network_stages(n):
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


# -- K16's schedule, mirrored ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SortPass:
    """One K16 launch over ``rows`` rows of ``n`` laid end to end: every CTA
    loads a tile of ``2**len_log2`` elements, runs ``stages`` on it and
    writes it back.  Bits ``[0, lo)`` of the tile index are the flat
    index's bits ``[0, lo)``, bits ``[lo, len_log2)`` its bits ``[jlo,
    …)``; the CTA's number fills the flat index's other bits."""

    kind: str                                # tile_sort, group, tile_merge
    stages: Tuple[Tuple[int, int], ...]      # (k, j) in network order
    n: int
    rows: int
    len_log2: int
    lo: int
    jlo: int

    @property
    def ctas(self) -> int:
        return (self.rows * self.n) >> self.len_log2

    def tile_bit(self, bit: int) -> int:
        """The tile bit holding the flat index's ``bit``, or -1."""
        if bit < self.lo:
            return bit
        d = bit - self.jlo
        return self.lo + d if 0 <= d < self.len_log2 - self.lo else -1

    def index_sets(self) -> torch.Tensor:
        """(ctas, 2**len_log2) int64: each CTA's flat indices, by tile
        index."""
        cta = torch.arange(self.ctas, dtype=torch.int64)
        a_bits = self.jlo - self.lo
        base = (((cta & ((1 << a_bits) - 1)) << self.lo)
                | ((cta >> a_bits) << (self.jlo + self.len_log2 - self.lo)))
        tile = torch.arange(1 << self.len_log2, dtype=torch.int64)
        local = (tile & ((1 << self.lo) - 1)) | ((tile >> self.lo) << self.jlo)
        return base[:, None] | local[None, :]


def _tile_log2(n: int, rows: int, tile: int) -> int:
    """log2 of K16's tile: the largest power of two up to ``tile`` that
    divides rows · n (a tile of short rows holds several)."""
    log2n = n.bit_length() - 1
    twos = (rows & -rows).bit_length() - 1
    return min(tile.bit_length() - 1, log2n + twos)


def sort_passes(n: int, rows: int = 1, tile: int = SORT_TILE,
                group: int = SORT_GROUP) -> List[SortPass]:
    """K16's launches for ``rows`` rows of ``n`` (``n`` a power of two), as
    ``csrc/stream_bitonic.cu``'s ``launch`` makes them: one tile sort (every
    stage with k up to the tile); then for each k above the tile, group
    passes over the stages j ≥ tile, at most ``group`` adjacent stages
    each (from the top), and one tile merge (j = tile/2 … 1).  Pure
    Python: no tensor is built until :meth:`SortPass.index_sets`."""
    require_power_of_two(n, "bitonic network")
    require_power_of_two(tile, "K16 tile")
    log2n = n.bit_length() - 1
    t = _tile_log2(n, rows, tile)
    kmax = min(t, log2n)
    passes = [SortPass("tile_sort", tuple(
        (1 << ks, 1 << js) for ks in range(1, kmax + 1)
        for js in range(ks - 1, -1, -1)), n, rows, t, t, t)]
    for ks in range(t + 1, log2n + 1):
        for jhi in range(ks - 1, t - 1, -group):
            g = min(group, jhi - t + 1)
            passes.append(SortPass("group", tuple(
                (1 << ks, 1 << js) for js in range(jhi, jhi - g, -1)),
                n, rows, t, t - g, jhi - g + 1))
        passes.append(SortPass("tile_merge", tuple(
            (1 << ks, 1 << js) for js in range(t - 1, -1, -1)),
            n, rows, t, t, t))
    return passes


def register_runs(p: SortPass, reg_log2: int = SORT_REG_LOG2
                  ) -> List[Tuple[int, Tuple[Tuple[int, int], ...]]]:
    """The runs of a pass as K16's host code plans them: (mask, stages),
    where mask is the ``reg_log2`` tile bits a thread holds in registers
    (32 slots; the other bits number the threads) and stages the stretch
    of the pass's stages whose bits fit it.  A run takes stages while their
    bits fit, then is padded with the bits above its highest, then below
    its lowest; the tile crosses shared memory once a run.  A tile under
    ``2**reg_log2`` elements has no runs: K16 runs it a stage at a time in
    shared memory."""
    if p.len_log2 < reg_log2:
        return []
    runs, i = [], 0
    while i < len(p.stages):
        mask, e = 0, i
        while e < len(p.stages):
            b = p.tile_bit(p.stages[e][1].bit_length() - 1)
            if not mask >> b & 1:
                if bin(mask).count("1") == reg_log2:
                    break
                mask |= 1 << b
            e += 1
        b = mask.bit_length()
        while bin(mask).count("1") < reg_log2 and b < p.len_log2:
            mask, b = mask | 1 << b, b + 1
        b = (mask & -mask).bit_length() - 2
        while bin(mask).count("1") < reg_log2:
            mask, b = mask | 1 << b, b - 1
        runs.append((mask, p.stages[i:e]))
        i = e
    return runs


def run_passes(x2d: torch.Tensor, passes: List[SortPass]) -> torch.Tensor:
    """The network on every row of ``x2d`` (rows, n), pass by pass: each
    CTA's elements gathered through its index set, the pass's stages run
    on the tile in tile-index order (:func:`min_max`, ascending where bit k
    of the position in the row is clear), the tile scattered back."""
    rows, n = x2d.shape
    flat = x2d.reshape(-1).clone()
    for p in passes:
        idx = p.index_sets()
        tile, pos = flat[idx], idx & (n - 1)
        ctas, length = idx.shape
        for k, j in p.stages:
            jl = 1 << p.tile_bit(j.bit_length() - 1)
            pairs = tile.reshape(ctas, length // (2 * jl), 2, jl)
            asc = (pos.reshape(ctas, length // (2 * jl), 2, jl)[:, :, 0]
                   & k) == 0
            lo, hi = min_max(pairs[:, :, 0], pairs[:, :, 1])
            tile = torch.stack([torch.where(asc, lo, hi),
                                torch.where(asc, hi, lo)], dim=2
                               ).reshape(ctas, length)
        flat[idx] = tile
    return flat.reshape(rows, n)


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
