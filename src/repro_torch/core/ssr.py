"""The SSR emitter: block streams, their accounting, and the launcher.

The PyTorch counterpart of ``repro.core.ssr``.  The correspondence with
the paper (DESIGN.md §2) is unchanged:

* **stream register** → a :class:`BlockStream` whose delivery schedule the
  framework owns; the body reads whole blocks with no address arithmetic;
* **AGU (bound/stride/repeat)** → the grid plus an affine ``index_map``,
  proven affine by :func:`agu.affine_coefficients` and handed to the kernel
  as its base/stride programming (:class:`~repro_torch.core.agu.BlockAGU`);
* **repeat register** → an index map that revisits a block across grid
  steps (a GEMM A panel, GEMV's x).

What changes on Hopper is the emitter.  :func:`ssr_kernel` returns an
:class:`SsrKernel` that runs on whatever device its operands are on: a CUDA
tensor goes to the hand-written kernel for the body's ``op``
(:mod:`repro_torch.core.hopper`), a CPU tensor to the plain version of the
same lowered computation.  A body without a device kernel raises on CUDA; it
never drops to the CPU.

The lowered blocks are the streams' unit of delivery in device memory, not
shared-memory buffers: :class:`StreamReport` counts the same bytes as the
reference, and checks no budget.  Each CUDA kernel checks its own CTA
configuration against the card.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Sequence, Tuple

import torch

from . import agu, hopper
from .stream import Direction


class LoweringError(ValueError):
    """The plan's access pattern has no whole-block streamed schedule."""


#: The data mover's FIFO depth bounds.  Depth 2 is the classic double-
#: buffered pipeline; the schedule validates and accounts it as the
#: reference does, but the slice-1 kernels do not stage by it yet.
DEFAULT_BUFFER_DEPTH = 2
MAX_BUFFER_DEPTH = 8


def stream_vmem_bytes(block_bytes: int,
                      depth: int = DEFAULT_BUFFER_DEPTH) -> int:
    """In-flight footprint of one stream's blocks: ``depth`` buffers.

    The one accounting helper for the per-stream working set, as in the
    reference (the name is kept so the two reports compare line by line).
    """
    return depth * block_bytes


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class KernelBody:
    """A block body that names its device kernel.

    ``fn`` is the PyTorch body (blocks in, partial out) that the plain
    version runs; ``op`` names the CUDA kernel that computes the same thing
    on the card (see :data:`hopper.DEVICE_KERNELS`).  A CUDA kernel cannot
    take an arbitrary callable, so only tagged bodies run on the card.
    """

    fn: Callable[..., torch.Tensor]
    op: str

    def __call__(self, *blocks, **kw):
        return self.fn(*blocks, **kw)


@dataclasses.dataclass(frozen=True)
class BlockStream:
    """One SSR lane at block granularity.

    ``index_map(*grid_indices) -> block indices`` must be affine — the AGU
    constraint.
    """

    block_shape: Tuple[int, ...]
    index_map: Callable[..., Tuple[Any, ...]]
    direction: Direction = Direction.READ
    name: str = "stream"

    def block_bytes(self, dtype) -> int:
        return math.prod(self.block_shape) * _itemsize(dtype)

    def agu(self, grid: Tuple[int, ...]) -> agu.BlockAGU:
        return agu.BlockAGU.of(self.index_map, self.block_shape, grid,
                               self.name)


@dataclasses.dataclass(frozen=True)
class StreamReport:
    """Static data-movement accounting for one streamed kernel.

    The software analogue of the paper's Fig. 8 right axis: bytes the data
    movers stream per invocation, the in-flight working set at the
    schedule's FIFO depth, and the FIFO-reuse savings from repeat maps.
    """

    grid: Tuple[int, ...]
    vmem_bytes: int
    hbm_bytes_streamed: int
    hbm_bytes_unique: int
    scratch_bytes: int = 0   # kernel-resident accumulators

    @property
    def reuse_factor(self) -> float:
        return self.hbm_bytes_streamed / max(1, self.hbm_bytes_unique)


def _unique_blocks(stream: BlockStream, grid: Tuple[int, ...]) -> int:
    """Number of distinct blocks the AGU touches over the whole grid."""
    total = math.prod(grid)
    if total > 65536:  # closed form for very large grids
        affine = agu.affine_coefficients(stream.index_map, grid)
        if affine is None:
            return total
        _, coeffs = affine
        distinct = 1
        for dim, c in enumerate(coeffs):
            if any(int(x) != 0 for x in c):
                distinct *= grid[dim]
        return distinct
    seen = set()
    for idx in itertools.product(*[range(g) for g in grid]):
        seen.add(tuple(int(x) for x in stream.index_map(*idx)))
    return len(seen)


def _depths(buffer_depth, n_in: int) -> Tuple[int, ...]:
    """Per-input FIFO depths, validated as the reference validates them."""
    if isinstance(buffer_depth, (tuple, list)):
        depths = tuple(int(d) for d in buffer_depth)
        if len(depths) != n_in:
            raise ValueError(
                f"buffer_depth tuple has {len(depths)} entries for {n_in} "
                "input streams; give one depth per stream")
        check = depths
    else:
        depths = (int(buffer_depth),) * n_in
        check = (int(buffer_depth),)
    for d in check:
        if not DEFAULT_BUFFER_DEPTH <= d <= MAX_BUFFER_DEPTH:
            raise ValueError(
                f"buffer_depth {d} outside [{DEFAULT_BUFFER_DEPTH}, "
                f"{MAX_BUFFER_DEPTH}] — depth < 2 cannot overlap fetch with "
                f"compute, deeper than {MAX_BUFFER_DEPTH} is not searched")
    return depths


class SsrKernel:
    """A lowered streamed kernel: geometry plus body, runnable anywhere.

    ``mode`` picks the epilogue — ``"reduce"`` (carried accumulator folded
    to a (1, 1) scalar), ``"map"`` (one block per step through the dense
    write stream) or ``"nest"`` (level-mapped; an accumulator over the
    trailing ``contraction_axes`` drained once per output block).
    """

    def __init__(self, body: Callable, *, mode: str,
                 grid: Tuple[int, ...],
                 in_streams: Sequence[BlockStream],
                 out_stream: BlockStream,
                 out_shape: Tuple[int, ...],
                 out_dtype: torch.dtype,
                 acc_dtype: torch.dtype = torch.float32,
                 contraction_axes: Tuple[int, ...] = (),
                 scratch_bytes: int = 0,
                 buffer_depth=DEFAULT_BUFFER_DEPTH):
        if mode not in hopper.PLAIN:
            raise ValueError(f"unknown ssr_call mode {mode!r}")
        for s in in_streams:
            if s.direction != Direction.READ:
                raise ValueError(f"input stream '{s.name}' must be a read "
                                 "stream")
        if out_stream.direction != Direction.WRITE:
            raise ValueError(f"output stream '{out_stream.name}' must be a "
                             "write stream")
        self.body = body
        self.mode = mode
        self.grid = tuple(grid)
        self.in_streams = tuple(in_streams)
        self.out_stream = out_stream
        self.out_dtype = out_dtype
        self.acc_dtype = acc_dtype
        self.scratch_bytes = scratch_bytes
        self.depths = _depths(buffer_depth, len(in_streams))
        self.geometry = agu.StreamGeometry(
            grid=self.grid,
            ins=tuple(s.agu(self.grid) for s in in_streams),
            out=out_stream.agu(self.grid),
            out_shape=tuple(out_shape),
            contraction_axes=tuple(contraction_axes))

    def device_kernel(self) -> Callable[..., torch.Tensor]:
        """The CUDA kernel for this body, or a LoweringError naming it."""
        op = getattr(self.body, "op", None)
        kernel = hopper.DEVICE_KERNELS.get((self.mode, op))
        if kernel is None:
            have = ", ".join(f"{m}/{o}" for m, o in hopper.DEVICE_KERNELS)
            raise LoweringError(
                f"no Hopper kernel for a {self.mode}-mode body with op "
                f"{op!r} ({self.body!r}); the device kernels are {have} — "
                "wrap the body in KernelBody(fn, op) or run on the CPU")
        return kernel

    def __call__(self, *layouts: torch.Tensor) -> torch.Tensor:
        devices = {t.device for t in layouts}
        if len(devices) != 1:
            raise ValueError(f"operands on several devices: {devices}")
        if layouts[0].device.type == "cpu":
            return hopper.PLAIN[self.mode](self.body, self.geometry, layouts,
                                           self.out_dtype, self.acc_dtype)
        return self.device_kernel()(self.geometry, layouts, self.out_dtype,
                                    self.acc_dtype)

    def report(self, dtypes: Sequence[Any]) -> StreamReport:
        """Bytes per invocation: one dtype per stream (inputs, then out)."""
        streams = (*self.in_streams, self.out_stream)
        if len(dtypes) != len(streams):
            raise ValueError("one dtype per stream")
        steps = math.prod(self.grid)
        max_depth = max(self.depths) if self.depths else DEFAULT_BUFFER_DEPTH
        vmem = streamed = unique = 0
        for idx, (s, dt) in enumerate(zip(streams, dtypes)):
            bb = s.block_bytes(dt)
            d = self.depths[idx] if idx < len(self.in_streams) else max_depth
            vmem += stream_vmem_bytes(bb, d)
            streamed += bb * steps
            unique += bb * _unique_blocks(s, self.grid)
        return StreamReport(grid=self.grid, vmem_bytes=vmem,
                            hbm_bytes_streamed=streamed,
                            hbm_bytes_unique=unique,
                            scratch_bytes=self.scratch_bytes)


def scratch_bytes(shape: Tuple[int, ...], dtype) -> int:
    """Bytes of one kernel-resident accumulator block."""
    return math.prod(shape) * _itemsize(dtype)


def auto_block(dim: int, target: int, align: int) -> int:
    """Largest aligned block ≤ target that tiles ``dim`` exactly."""
    b = min(dim, max(align, (target // align) * align))
    while b > align and dim % b != 0:
        b -= align
    if dim % b != 0:
        b = math.gcd(dim, b) or dim
    return b


def probe_part_shape(body: Callable, in_shapes: Sequence[Tuple[int, ...]],
                     dtype: torch.dtype) -> Tuple[int, ...]:
    """The shape of ``body``'s partial for one step, from one step on zeros.

    The flat path's blocks are small (rows × lanes), so one CPU step costs
    microseconds; PyTorch's meta device would cost seconds on first use.
    """
    blocks = [torch.zeros(s, dtype=dtype) for s in in_shapes]
    return tuple(torch.as_tensor(body(*blocks)).shape)
