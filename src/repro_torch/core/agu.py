"""Address-generation unit (AGU) model (paper §3.1, Fig. 3), in numpy/torch.

``StreamSpec.addresses()`` is the plain-Python oracle; this module provides
the tensor equivalents, with the same results as ``repro.core.agu``:

* **verification** — :func:`address_sequence` enumerates the element
  addresses a stream touches; :func:`gather_stream`/:func:`scatter_stream`
  materialise what a read stream delivers or a write stream leaves behind;
* **kernel construction** — :func:`block_grid` and
  :func:`affine_coefficients` turn a block schedule back into the AGU's
  base/stride programming, and :class:`BlockAGU` carries that programming to
  the kernels: the CUDA kernels take it as arguments, and the plain versions
  gather blocks with it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import numpy as np
import torch

from .stream import MAX_DIMS, StreamSpec

#: Grid axes a kernel's AGU programming carries: one per loop level.
SSR_MAX_AXES = MAX_DIMS


def address_sequence(spec: StreamSpec) -> torch.Tensor:
    """All emitted addresses (including ``repeat``) as an int32 vector.

    Vectorised odometer: iteration ``t``'s multi-index is the mixed-radix
    decomposition of ``t`` over ``bounds`` (innermost fastest), so

        addr(t) = base + Σ_k ((t // Π_{j>k} L_j) mod L_k) · stride_k
    """
    bounds = np.asarray(spec.bounds, dtype=np.int64)
    strides = np.asarray(spec.strides, dtype=np.int64)
    n = int(np.prod(bounds))
    place = np.concatenate([np.cumprod(bounds[::-1])[::-1][1:], [1]])
    t = np.arange(n, dtype=np.int64)
    digits = (t[:, None] // place) % bounds
    addrs = spec.base + digits @ strides
    if spec.repeat > 1:
        addrs = np.repeat(addrs, spec.repeat)
    return torch.from_numpy(addrs.astype(np.int32))


def gather_stream(data: torch.Tensor, spec: StreamSpec) -> torch.Tensor:
    """Materialise the operand sequence a read stream would deliver."""
    idx = address_sequence(spec).to(device=data.device, dtype=torch.int64)
    return torch.take(data.reshape(-1), idx)


def scatter_stream(out_size: int, values: torch.Tensor,
                   spec: StreamSpec) -> torch.Tensor:
    """Materialise the memory image a write stream produces.

    Later writes to the same address win (the FIFO drains in order);
    addresses outside ``[0, out_size)`` are dropped.
    """
    addrs = address_sequence(spec).numpy().astype(np.int64)
    flat = values.reshape(-1)
    keep = np.nonzero((addrs >= 0) & (addrs < out_size))[0]
    # last occurrence of each address among the kept writes
    rev = keep[::-1]
    uniq, first_in_rev = np.unique(addrs[rev], return_index=True)
    last = rev[first_in_rev]
    out = torch.zeros((out_size,), dtype=values.dtype, device=values.device)
    out[torch.from_numpy(uniq).to(values.device)] = \
        flat[torch.from_numpy(last).to(values.device)]
    return out


def block_grid(spec: StreamSpec, block: Tuple[int, ...]) -> Tuple[int, ...]:
    """Grid extent when the innermost dims of ``spec`` are tiled by ``block``.

    ``block`` must tile the innermost ``len(block)`` bounds exactly.
    """
    if len(block) > spec.ndim:
        raise ValueError("block rank exceeds stream rank")
    inner = spec.bounds[spec.ndim - len(block):]
    for b, blk in zip(inner, block):
        if blk <= 0 or b % blk != 0:
            raise ValueError(f"block {block} does not tile bounds {inner}")
    outer = spec.bounds[: spec.ndim - len(block)]
    tiled = tuple(b // blk for b, blk in zip(inner, block))
    return tuple(outer) + tiled


def affine_coefficients(index_map, grid: Tuple[int, ...]):
    """Probe an index_map and return (offset, coeffs) if affine, else None.

    Probes f(0), f(e_i) and verifies f(g) == f(0) + Σ g_i·c_i on a corner
    sample — the proof that a block schedule is expressible by the paper's
    AGU (which only supports affine patterns).
    """
    zero = tuple(0 for _ in grid)
    f0 = np.asarray(index_map(*zero), dtype=np.int64)
    coeffs = []
    for i in range(len(grid)):
        if grid[i] <= 1:
            coeffs.append(np.zeros_like(f0))
            continue
        e = list(zero)
        e[i] = 1
        coeffs.append(np.asarray(index_map(*e), dtype=np.int64) - f0)
    probes = [tuple(g - 1 for g in grid)]
    probes.append(tuple((g - 1) if i % 2 == 0 else 0 for i, g in enumerate(grid)))
    for p in probes:
        want = f0 + sum(np.asarray(p[i]) * coeffs[i] for i in range(len(grid)))
        got = np.asarray(index_map(*p), dtype=np.int64)
        if not np.array_equal(want, got):
            return None
    return f0, coeffs


def grid_steps(grid: Tuple[int, ...], device=None) -> torch.Tensor:
    """(steps, len(grid)) multi-indices of every grid step, row-major order."""
    flat = torch.arange(math.prod(grid), dtype=torch.int64, device=device)
    cols = []
    place = math.prod(grid)
    for g in grid:
        place //= g
        cols.append((flat // place) % g)
    if not cols:
        return flat.reshape(-1, 0)
    return torch.stack(cols, dim=1)


def _row_major_strides(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out, acc = [], 1
    for e in reversed(shape):
        out.append(acc)
        acc *= e
    return tuple(reversed(out))


@dataclasses.dataclass(frozen=True)
class BlockAGU:
    """One stream's block walk as the AGU programs it.

    At grid step ``g`` the stream delivers the block whose block index is
    ``offset + Σ_k g_k · coeffs[k]`` (bound/stride programming at block
    granularity).  Element ``e`` of that block lives at flat position
    ``Σ_d (index_d · block_d + e_d) · stride_d`` of the row-major layout the
    stream addresses — the only addressing the kernels do.
    """

    block: Tuple[int, ...]
    offset: Tuple[int, ...]
    coeffs: Tuple[Tuple[int, ...], ...]   # one per grid axis

    @classmethod
    def of(cls, index_map: Callable, block: Tuple[int, ...],
           grid: Tuple[int, ...], name: str = "stream") -> "BlockAGU":
        got = affine_coefficients(index_map, grid)
        if got is None:
            raise ValueError(
                f"stream '{name}': index_map is not affine in the grid "
                "indices — not expressible by the SSR AGU (bound/stride model)")
        f0, coeffs = got
        return cls(block=tuple(int(b) for b in block),
                   offset=tuple(int(x) for x in f0),
                   coeffs=tuple(tuple(int(x) for x in c) for c in coeffs))

    def element_index(self, grid: Tuple[int, ...], layout: Tuple[int, ...],
                      device=None) -> torch.Tensor:
        """(steps, *block) flat layout positions of every step's block."""
        rank = len(self.block)
        strides = _row_major_strides(layout)
        steps = grid_steps(grid, device)
        coeffs = torch.tensor(self.coeffs, dtype=torch.int64,
                              device=device).reshape(len(grid), rank)
        # int64 products summed by hand: CUDA matmul has no int64 kernel
        index = (torch.tensor(self.offset, dtype=torch.int64, device=device)
                 + (steps[:, :, None] * coeffs[None]).sum(1))
        origin = index * torch.tensor(self.block, dtype=torch.int64,
                                      device=device)
        flat = (origin * torch.tensor(strides, dtype=torch.int64,
                                      device=device)).sum(1)
        flat = flat.reshape(-1, *([1] * rank))
        for d in range(rank):
            shape = [1] * (rank + 1)
            shape[d + 1] = self.block[d]
            intra = torch.arange(self.block[d], dtype=torch.int64,
                                 device=device) * strides[d]
            flat = flat + intra.reshape(shape)
        return flat

    def check_within(self, grid: Tuple[int, ...], layout: Tuple[int, ...],
                     name: str = "stream") -> None:
        """Raise unless every block of the walk lies inside ``layout``.

        The walk is affine, so its extreme block indices sit at grid
        corners: per dimension, the offset plus every negative (for the
        least) or positive (for the most) coefficient times its last step.
        """
        if len(layout) != len(self.block):
            raise ValueError(
                f"stream '{name}': layout rank {len(layout)} != block rank "
                f"{len(self.block)}")
        for d, (blk, ext) in enumerate(zip(self.block, layout)):
            span = [c[d] * (g - 1) for c, g in zip(self.coeffs, grid)]
            lo = self.offset[d] + sum(s for s in span if s < 0)
            hi = self.offset[d] + sum(s for s in span if s > 0)
            if lo < 0 or (hi + 1) * blk > ext:
                raise ValueError(
                    f"stream '{name}': block walk covers rows/cols "
                    f"[{lo * blk}, {(hi + 1) * blk}) of dim {d}, outside the "
                    f"layout {tuple(layout)}")

    def gather(self, layout: torch.Tensor,
               grid: Tuple[int, ...]) -> torch.Tensor:
        """(steps, *block) — every block the stream delivers, in grid order."""
        if layout.dim() != len(self.block):
            raise ValueError(
                f"layout rank {layout.dim()} != block rank {len(self.block)}")
        idx = self.element_index(grid, tuple(layout.shape), layout.device)
        return layout.reshape(-1)[idx]


@dataclasses.dataclass(frozen=True)
class StreamGeometry:
    """Everything a streamed kernel is programmed with, besides its body.

    ``grid`` runs row-major with ``contraction_axes`` (if any) trailing, so
    all visits of one output block are consecutive steps; ``ins``/``out``
    are the streams' AGU programming and ``out_shape`` the output layout.
    """

    grid: Tuple[int, ...]
    ins: Tuple[BlockAGU, ...]
    out: BlockAGU
    out_shape: Tuple[int, ...]
    contraction_axes: Tuple[int, ...] = ()

    @property
    def steps(self) -> int:
        return math.prod(self.grid)

    @property
    def contraction_steps(self) -> int:
        return math.prod(self.grid[a] for a in self.contraction_axes)
