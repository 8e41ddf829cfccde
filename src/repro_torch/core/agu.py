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
  gather blocks with it.  :class:`GatherAGU` is the indirection extension's
  address program: an index stream's values scaled into a table.
  :class:`RingProgram` is the data mover's FIFO: the N-deep ring a
  pipelined kernel delivers its read streams through.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

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


def stream_vmem_bytes(block_bytes: int, depth: int = 2) -> int:
    """In-flight footprint of one stream's blocks: ``depth`` buffers.

    The one accounting helper for the per-stream working set, as in the
    reference (``repro.core.ssr.stream_vmem_bytes``): the emitter's
    :class:`~repro_torch.core.ssr.StreamReport`, the tuner's working-set
    count and a pipelined kernel's ring (:class:`RingProgram`) all call it.
    """
    return depth * block_bytes


def stream_is_invariant(index_map: Callable, grid: Tuple[int, ...]) -> bool:
    """True when the index map ignores every grid axis (the repeat
    register): the reference's ``_stream_is_invariant``.  A pipelined
    kernel fetches such a stream once, into slot 0 of its ring."""
    affine = affine_coefficients(index_map, grid)
    if affine is None:
        return False
    _, coeffs = affine
    return all(int(x) == 0 for dim in coeffs for x in dim)


@dataclasses.dataclass(frozen=True)
class RingProgram:
    """The N-deep ring through which a pipelined kernel delivers its read
    streams (the reference's ``_pipelined_call``).

    Read stream ``i`` has ``depths[i]`` slots.  Over a run of consecutive
    grid steps, the run's first step primes :meth:`prime` fetches; at step
    ``s`` of the run the stream starts the fetch of step ``s + depths[i] −
    1`` (if the run has it) into slot ``(s + depths[i] − 1) % depths[i]``,
    then waits on slot ``s % depths[i]``.  An ``invariant`` stream is
    fetched once into slot 0 and re-read from there.  ``slot_bytes[i]`` is
    one slot of stream ``i`` — the kernel's tile of it — and ``ring_bytes``
    the whole ring, each stream at its full depth (the reference budgets an
    invariant stream so too).
    """

    depths: Tuple[int, ...]
    invariant: Tuple[bool, ...]
    slot_bytes: Tuple[int, ...] = ()

    @property
    def ring_bytes(self) -> int:
        return sum(stream_vmem_bytes(b, d)
                   for b, d in zip(self.slot_bytes, self.depths))

    def prime(self, i: int, run: int) -> int:
        """Fetches stream ``i`` issues at the first step of a ``run``-step
        run, before it computes."""
        return 1 if self.invariant[i] else min(self.depths[i] - 1, run)


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
                      device=None,
                      steps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(steps, *block) flat layout positions of every step's block, or
        of the steps given as rows of :func:`grid_steps`."""
        rank = len(self.block)
        strides = _row_major_strides(layout)
        if steps is None:
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
        for d, ((lo, hi), ext) in enumerate(zip(self.span(grid), layout)):
            if lo < 0 or hi > ext:
                raise ValueError(
                    f"stream '{name}': block walk covers rows/cols "
                    f"[{lo}, {hi}) of dim {d}, outside the layout "
                    f"{tuple(layout)}")

    def span(self, grid: Tuple[int, ...]) -> Tuple[Tuple[int, int], ...]:
        """Per dimension, the [first, end) rows or columns the walk's
        blocks cover."""
        out = []
        for d, blk in enumerate(self.block):
            steps = [c[d] * (g - 1) for c, g in zip(self.coeffs, grid)]
            lo = self.offset[d] + sum(s for s in steps if s < 0)
            hi = self.offset[d] + sum(s for s in steps if s > 0)
            out.append((lo * blk, (hi + 1) * blk))
        return tuple(out)

    def check_extent_within(self, grid: Tuple[int, ...],
                            layout: Tuple[int, ...],
                            extent: Tuple[int, int],
                            name: str = "stream") -> None:
        """Raise unless every position a reader bounded by ``extent``
        (rows, cols) reads lies inside ``layout``: the walk starts at no
        negative block and the extent fits.  A walk may pass the layout's
        ends where its blocks hold no data (K12 on unpadded planes)."""
        spans = self.span(grid)
        walk_fits = all(hi <= ext for (_, hi), ext in zip(spans, layout))
        extent_fits = extent[0] <= layout[0] and extent[1] <= layout[1]
        if len(layout) != 2 or any(lo < 0 for lo, _ in spans) or not (
                walk_fits or extent_fits):
            raise ValueError(
                f"stream '{name}': the walk's extent {tuple(extent)} leaves "
                f"the layout {tuple(layout)}")

    def gather(self, layout: torch.Tensor, grid: Tuple[int, ...],
               steps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(steps, *block) — every block the stream delivers, in grid order
        (or at the given rows of :func:`grid_steps`)."""
        if layout.dim() != len(self.block):
            raise ValueError(
                f"layout rank {layout.dim()} != block rank {len(self.block)}")
        idx = self.element_index(grid, tuple(layout.shape), layout.device,
                                 steps)
        return layout.reshape(-1)[idx]


@dataclasses.dataclass(frozen=True)
class GatherAGU:
    """One gather's address program (the lowering's ``IndirectGather``).

    At grid step ``g``, the element of the index stream's block (slot
    ``index`` of the kernel's read streams) holding value ``v`` addresses
    the flattened table (slot ``table``: the whole array at every step) at

        scale·v + Σ_l coeffs[l]·(g[grid_pos[l]]·tiles[l] + i_l) + offset

    where each affine level ``l`` prepends one block dimension ``i_l <
    tiles[l]`` (outermost first), and the address is clipped into the
    table, as the reference's ``_gather_block`` does.  ``extent`` are the
    (rows, cols) of the index stream's layout that hold data: a position
    outside it is lowering padding and gathers 0 (the kernels skip it).
    """

    index: int
    table: int
    scale: int
    offset: int
    grid_pos: Tuple[int, ...] = ()
    tiles: Tuple[int, ...] = ()
    coeffs: Tuple[int, ...] = ()
    extent: Tuple[int, int] = (0, 0)

    def gather(self, index_agu: BlockAGU, grid: Tuple[int, ...],
               index_layout: torch.Tensor, table: torch.Tensor,
               steps: torch.Tensor) -> torch.Tensor:
        """(len(steps), *tiles, *index block): the gathered blocks at the
        given rows of :func:`grid_steps`, in the table's dtype."""
        pos = index_agu.element_index(grid, tuple(index_layout.shape),
                                      index_layout.device, steps)
        return self._gathered(index_layout.reshape(-1)[pos], pos,
                              index_layout.shape[-1], table, steps)

    def gather_delivered(self, index_blocks: torch.Tensor,
                         index_agu: BlockAGU, grid: Tuple[int, ...],
                         index_shape: Tuple[int, ...], table: torch.Tensor,
                         steps: torch.Tensor) -> torch.Tensor:
        """:meth:`gather` with the index values taken from ``index_blocks``
        (len(steps), *index block), the blocks a ring delivered to those
        steps: the addresses come from the delivered values, the extent mask
        and the affine levels from the steps that compute, as R13 and R14
        compute them (``index_shape``: the index stream's layout)."""
        pos = index_agu.element_index(grid, tuple(index_shape),
                                      index_blocks.device, steps)
        return self._gathered(index_blocks, pos, index_shape[-1], table,
                              steps)

    def _gathered(self, values: torch.Tensor, pos: torch.Tensor, pitch: int,
                  table: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
        """The table's elements at the addresses of index ``values`` held
        at layout positions ``pos`` (pitch ``pitch``) of the given steps; 0
        outside the extent."""
        dev = values.device
        valid = (pos // pitch < self.extent[0]) & \
            (pos % pitch < self.extent[1])
        addr = values.to(torch.int64) * self.scale + self.offset
        k = steps.shape[0]
        for p, tile, coeff in zip(reversed(self.grid_pos),
                                  reversed(self.tiles),
                                  reversed(self.coeffs)):
            lead = (steps[:, p] * tile).reshape(k, *([1] * addr.dim()))
            intra = torch.arange(tile, dtype=torch.int64, device=dev)
            addr = addr[:, None] + coeff * (
                lead + intra.reshape(1, tile, *([1] * (addr.dim() - 1))))
        flat = table.reshape(-1)
        got = flat[addr.clamp(0, flat.numel() - 1)]
        valid = valid.reshape(k, *([1] * len(self.tiles)), *valid.shape[1:])
        return torch.where(valid, got, torch.zeros((), dtype=got.dtype,
                                                   device=dev))


@dataclasses.dataclass(frozen=True)
class StreamGeometry:
    """Everything a streamed kernel is programmed with, besides its body.

    ``grid`` runs row-major with ``contraction_axes`` (if any) trailing, so
    all visits of one output block are consecutive steps; ``ins``/``out``
    are the streams' AGU programming and ``out_shape`` the output layout.
    ``halos`` are the lowering's ``HaloRead``\\ s: each windowed read's
    shifted streams (their slots in ``ins``), widened into one block per
    step.  ``level_tiles`` gives, per loop level, its grid axis and tile:
    the global offsets a rescale body receives (empty for other calls).
    ``gathers`` are the indirect refs' address programs; their tables are
    the trailing read streams, and the body receives the gathered blocks
    after the other streams' blocks.
    """

    grid: Tuple[int, ...]
    ins: Tuple[BlockAGU, ...]
    out: BlockAGU
    out_shape: Tuple[int, ...]
    contraction_axes: Tuple[int, ...] = ()
    halos: Tuple[Any, ...] = ()
    level_tiles: Tuple[Tuple[int, int], ...] = ()
    gathers: Tuple[GatherAGU, ...] = ()

    @property
    def steps(self) -> int:
        return math.prod(self.grid)

    @property
    def contraction_steps(self) -> int:
        return math.prod(self.grid[a] for a in self.contraction_axes)
