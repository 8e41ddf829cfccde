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
never drops to the CPU.  A fused chain or DAG is a :class:`StageKernel`: the
stage bodies plus a :class:`StageProgram` naming each stage's op and where
its blocks come from, looked up on the card by the tuple of stage ops.

The lowered blocks are the streams' unit of delivery in device memory:
:class:`StreamReport` counts the same bytes as the reference, and checks no
budget.  Each CUDA kernel checks its own CTA configuration against the
card.  A schedule deeper than 2 (``buffer_depth`` or ``stream_depths``)
makes a kernel :attr:`SsrKernel.pipelined` where its family stages — the
reference's ``_pipelined_call``: its read streams then arrive through an
N-deep ring (:class:`~repro_torch.core.agu.RingProgram`), on the card in
shared memory (the ring kernels R1–R4 and R6–R9 of
:data:`hopper.RING_KERNELS`), on the CPU in :func:`hopper.plain_ring`.
The chains of K5 and the DAGs of K6–K8 stage too (each a
:class:`StageKernel`); the halo, attention, gather and stream kernels run
synchronously at any depth.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import os
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from . import agu, hopper
from .agu import stream_vmem_bytes
from .stream import Direction


class LoweringError(ValueError):
    """The plan's access pattern has no whole-block streamed schedule."""


#: The data mover's FIFO depth bounds.  Depth 2 is the classic double-
#: buffered pipeline (the sync kernels); a deeper one runs ``depth − 1``
#: fetches ahead of the body through a ring, where the kernel's family
#: stages (:attr:`SsrKernel.pipelined`).
DEFAULT_BUFFER_DEPTH = 2
MAX_BUFFER_DEPTH = 8


def pipeline_supported() -> bool:
    """Whether a schedule deeper than 2 may run through a ring here.

    Always, but for ``REPRO_DISABLE_PIPELINE``: a switch kept for parity
    with the reference's opt-out, under which every kernel runs its
    synchronous (depth-2) version, on the card K1–K8 in place of R1–R4
    and R6–R9, K17 in place of R5.
    Semantics are identical either way; ``chip_smoke.py`` refuses to run
    under it, since its rings would not run.
    """
    return not os.environ.get("REPRO_DISABLE_PIPELINE")


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class KernelBody:
    """A block body that names its device kernel.

    ``fn`` is the PyTorch body (blocks in, partial out) that the plain
    version runs; ``op`` names the CUDA kernel that computes the same thing
    on the card (see :data:`hopper.DEVICE_KERNELS`).  A CUDA kernel cannot
    take an arbitrary callable, so only tagged bodies run on the card.

    ``params`` are the body's scalar parameters (axpy's α), passed to ``fn``
    after the blocks and to the kernel as arguments; being fields, they key
    the kernel caches, so two values never share an entry.  ``perm`` is set
    on a body whose caller passes its blocks in another order (a DAG cut
    turns carried blocks into streams): argument ``i`` of ``fn`` is block
    ``perm[i]``, and blocks past ``len(perm)`` (uniforms) trail unpermuted.
    ``drain`` is applied once to each drained accumulator block of a
    level-mapped call, never to a partial (``matvec_relu``'s relu).
    """

    fn: Callable[..., torch.Tensor]
    op: str
    params: Tuple[Any, ...] = ()
    perm: Optional[Tuple[int, ...]] = None
    drain: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __call__(self, *blocks, **kw):
        if self.perm is not None:
            blocks = (*(blocks[i] for i in self.perm),
                      *blocks[len(self.perm):])
        return self.fn(*blocks, *self.params, **kw)

    def reordered(self, perm: Tuple[int, ...]) -> "KernelBody":
        """The same body (op, params, drain) taking its blocks in the
        caller's order: argument ``i`` is the caller's block ``perm[i]``."""
        if self.perm is not None:
            raise ValueError(f"body {self.op!r} is reordered already")
        return dataclasses.replace(self, perm=tuple(perm))


@dataclasses.dataclass(frozen=True)
class StageProgram:
    """What a fused kernel runs besides its geometry: its stages by name.

    ``ops[k]`` is stage ``k``'s body op; ``sources[k]`` the blocks its body
    receives, in the order the caller passes them: ``("stage", j)`` is the
    value stage ``j`` produced this step (kept on chip), ``("stream", i)``
    the block of read stream ``i``.  The ``n_uniform`` uniform arrays trail
    the ``n_streams`` streams and every stage's arguments.  ``perms`` and
    ``params`` are the bodies' (:class:`KernelBody`); ``slots[k]`` is the
    scratch slot of stage ``k``'s product (``None`` for the final stage)
    and ``n_slots`` the peak of live carried blocks (``_dag_slots``);
    ``block`` is the policy block every carried value fills; ``mode`` the
    call mode of the final stage's epilogue.
    A single-body ``ssr_call`` is the one-stage program.
    """

    ops: Tuple[Optional[str], ...]
    sources: Tuple[Tuple[Tuple[str, int], ...], ...]
    n_streams: int
    n_uniform: int = 0
    mode: str = "map"
    perms: Tuple[Optional[Tuple[int, ...]], ...] = ()
    params: Tuple[Tuple[Any, ...], ...] = ()
    slots: Tuple[Optional[int], ...] = ()
    n_slots: int = 0
    block: Tuple[int, ...] = ()

    @classmethod
    def of(cls, bodies: Sequence[Callable],
           sources: Sequence[Sequence[Tuple[str, int]]], n_streams: int,
           n_uniform: int = 0, slots: Sequence[Optional[int]] = (),
           n_slots: int = 0, block: Tuple[int, ...] = (),
           mode: str = "map") -> "StageProgram":
        return cls(ops=tuple(getattr(b, "op", None) for b in bodies),
                   sources=tuple(tuple(s) for s in sources),
                   n_streams=n_streams, n_uniform=n_uniform, mode=mode,
                   perms=tuple(getattr(b, "perm", None) for b in bodies),
                   params=tuple(tuple(getattr(b, "params", ()))
                                for b in bodies),
                   slots=tuple(slots), n_slots=n_slots, block=tuple(block))

    @classmethod
    def single(cls, body: Callable, n_in: int, n_uniform: int = 0,
               mode: str = "map") -> "StageProgram":
        """The program of one body over ``n_in`` read streams, the last
        ``n_uniform`` of them uniforms."""
        n_streams = n_in - n_uniform
        return cls.of((body,), (tuple(("stream", i)
                                      for i in range(n_streams)),),
                      n_streams, n_uniform, (None,), mode=mode)

    def canonical(self, k: int) -> Tuple[Tuple[str, int], ...]:
        """Stage ``k``'s sources in the order its unpermuted body takes
        them, the uniforms (``("uniform", j)``) last."""
        src = self.sources[k]
        perm = self.perms[k] if self.perms else None
        named = src if perm is None else tuple(src[i] for i in perm)
        return named + tuple(("uniform", j) for j in range(self.n_uniform))

    @property
    def plain(self) -> bool:
        """One stage over its streams in order: what a single-op kernel
        of slices 1-2 takes (no permutation, parameters or uniforms)."""
        return (len(self.ops) == 1 and self.n_uniform == 0
                and not any(self.params) and not any(
                    p is not None and p != tuple(range(len(p)))
                    for p in self.perms))


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


def _depths(buffer_depth, n_in: int,
            beyond: str = "is not searched") -> Tuple[int, ...]:
    """Per-input FIFO depths, validated as the reference validates them;
    ``beyond`` ends the message for a depth past the bounds (the
    reference's lowering and its ``ssr_pallas`` word it differently)."""
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
                f"compute, deeper than {MAX_BUFFER_DEPTH} {beyond}")
    return depths


class SsrKernel:
    """A lowered streamed kernel: geometry plus body, runnable anywhere.

    ``mode`` picks the epilogue — ``"reduce"`` (carried accumulator folded
    to a (1, 1) scalar), ``"map"`` (one block per step through the dense
    write stream) or ``"nest"`` (level-mapped; an accumulator over the
    trailing ``contraction_axes`` drained once per output block).  The last
    ``n_uniform`` read streams are uniforms: whole arrays, the same block
    at every step.  ``halos`` (the lowering's ``HaloRead``\\ s) widen
    shifted read streams into one block per step; ``rescale`` makes the
    nest accumulator the online-softmax (m, l, acc) triple, whose body also
    receives the per-level global offsets (``level_tiles``).  ``gathers``
    (:class:`~repro_torch.core.agu.GatherAGU`) are the indirect refs'
    address programs: their tables are the trailing read streams (whole
    arrays at every step), and the body receives the gathered blocks after
    the other streams' blocks.
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
                 buffer_depth=DEFAULT_BUFFER_DEPTH,
                 n_uniform: int = 0,
                 program: Optional[StageProgram] = None,
                 halos: Tuple[Any, ...] = (),
                 rescale: bool = False,
                 level_tiles: Tuple[Tuple[int, int], ...] = (),
                 gathers: Tuple[agu.GatherAGU, ...] = ()):
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
        self.rescale = rescale
        self.depths = _depths(buffer_depth, len(in_streams))
        self.program = program or StageProgram.single(
            body, len(in_streams), n_uniform, mode)
        self.geometry = agu.StreamGeometry(
            grid=self.grid,
            ins=tuple(s.agu(self.grid) for s in in_streams),
            out=out_stream.agu(self.grid),
            out_shape=tuple(out_shape),
            contraction_axes=tuple(contraction_axes),
            halos=tuple(halos), level_tiles=tuple(level_tiles),
            gathers=tuple(gathers))

    @functools.cached_property
    def invariant(self) -> Tuple[bool, ...]:
        """Per read stream: whether its block never moves over the grid."""
        return tuple(agu.stream_is_invariant(s.index_map, self.grid)
                     for s in self.in_streams)

    @property
    def pipelined(self) -> bool:
        """Whether the read streams arrive through an N-deep ring: a depth
        above 2, a grid of more than one step, :func:`pipeline_supported`
        and a family that stages (:data:`hopper.RING_KERNELS`).  The same
        on the CPU and on the card."""
        return (max(self.depths, default=DEFAULT_BUFFER_DEPTH)
                > DEFAULT_BUFFER_DEPTH and self.geometry.steps > 1
                and pipeline_supported()
                and self.device_key in hopper.RING_KERNELS)

    @property
    def ring(self) -> agu.RingProgram:
        """The ring's depths and invariant streams (its slots are sized by
        whoever runs it: the plain ring, or a ring kernel's tile)."""
        return agu.RingProgram(depths=self.depths, invariant=self.invariant)

    @property
    def plain_kind(self) -> str:
        """The key of this kernel's plain version in :data:`hopper.PLAIN`."""
        return "rescale" if self.rescale else self.mode

    @property
    def device_key(self) -> tuple:
        """(call mode, body op): the key of :data:`hopper.DEVICE_KERNELS`."""
        return (self.mode, getattr(self.body, "op", None))

    def device_kernel(self) -> Callable[..., torch.Tensor]:
        """The CUDA kernel for this body, or a LoweringError naming it."""
        kernel = hopper.DEVICE_KERNELS.get(self.device_key)
        if kernel is None:
            have = ", ".join(f"{m}/{o}" for m, o in hopper.DEVICE_KERNELS)
            raise LoweringError(
                f"no Hopper kernel for a {self.mode}-mode body with op "
                f"{self.device_key[1]!r} ({self.body!r}); the device kernels "
                f"are {have} — wrap the body in KernelBody(fn, op) or run on "
                "the CPU")
        return kernel

    def plain(self, layouts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The plain PyTorch version of this kernel, on any device: through
        the ring (:func:`hopper.plain_ring`) when :attr:`pipelined`."""
        if self.pipelined:
            return hopper.plain_ring(self.body, self.geometry, layouts,
                                     self.out_dtype, self.acc_dtype,
                                     mode=self.mode, ring=self.ring)[0]
        return hopper.PLAIN[self.plain_kind](self.body, self.geometry,
                                             layouts, self.out_dtype,
                                             self.acc_dtype)

    def device_args(self) -> dict:
        """The keywords the device kernel takes besides the geometry,
        layouts and dtypes: the program, and the ring when pipelined."""
        kw = {"program": self.program}
        if self.pipelined:
            kw["ring"] = self.ring
        return kw

    def __call__(self, *layouts: torch.Tensor) -> torch.Tensor:
        devices = {t.device for t in layouts}
        if len(devices) != 1:
            raise ValueError(f"operands on several devices: {devices}")
        if layouts[0].device.type == "cpu":
            return self.plain(layouts)
        return self.device_kernel()(self.geometry, layouts, self.out_dtype,
                                    self.acc_dtype, **self.device_args())

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


class StageKernel(SsrKernel):
    """A fused chain or DAG: several stage bodies over one grid, each
    step's intermediates kept on chip, one map/reduce epilogue.

    ``bodies[k]`` receives the blocks ``program.sources[k]`` names (carried
    values and stream blocks) followed by the uniforms; the final stage's
    value feeds the epilogue of ``mode``.  On the card the kernel is looked
    up by ``(mode, tuple of stage ops)``; on the CPU the plain version runs
    the stages in order on every step's blocks.  A fused chain of K5's
    families, and a DAG of K6–K8's, is :attr:`pipelined` at a depth above
    2 (R6–R9 on the card, the stages over the ring's blocks on the CPU).
    """

    def __init__(self, bodies: Sequence[Callable], program: StageProgram,
                 **kw):
        super().__init__(bodies[-1], program=program, **kw)
        self.bodies = tuple(bodies)

    @property
    def device_key(self) -> tuple:
        return (self.mode, tuple(self.program.ops))

    def plain(self, layouts: Sequence[torch.Tensor]) -> torch.Tensor:
        inputs = hopper.ring_delivery(self.geometry, layouts, self.ring)[0] \
            if self.pipelined else None
        return hopper.plain_stages(self.bodies, self.program, self.mode,
                                   self.geometry, layouts, self.out_dtype,
                                   self.acc_dtype, inputs=inputs)


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
