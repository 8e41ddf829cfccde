"""Lower compiler :class:`StreamPlan`\\ s to streamed kernels, and run them.

The PyTorch counterpart of ``repro.core.lowering``.  It closes the §3.2
loop the paper's LLVM pass closes in MIR:

    LoopNest ──ssrify()──► StreamPlan ──lower_plan()/lower_nest()──►
        (grid, BlockStreams) ──ssr_call()──► one streamed kernel

The geometry is the reference's, line for line: the same grid, tiles,
semantics, contraction axes, block shapes, padded layouts and affine index
maps for the same nest and :class:`Schedule` (the tests hold the two
packages to equality).  Two lowering paths cover the AGU model at block
granularity:

**Flat (``lower_plan``)** — read-only map/reduce nests whose operands walk
the iteration space in loop order: a unit-stride innermost walk with dense
row-major outer levels, levels with coefficient 0 (the repeat register) and
loop-invariant operands.

**Level-mapped (``lower_nest``)** — nests with an explicit output WRITE
ref: one grid axis per loop level, storage orders that permute the loop
order (GEMM's B), and an output revisited across trailing contraction axes,
carried in an accumulator (init on the first visit, drain on the last).

What runs the schedule is :class:`~repro_torch.core.ssr.SsrKernel`: the
hand-written Hopper kernel for the body's ``op`` on a CUDA device, the plain
PyTorch version of the same lowered computation on the CPU.  PyTorch runs
eagerly, so there is no jit: a call pads the operands, runs the kernel and
trims the result.  Plans, lowerings and built kernels are cached on the
nest, the schedule and the body (:func:`_body_key`).

Not in this port yet, each a :class:`LoweringError` naming the slice that
brings it: halo reads, gathers and the online-softmax accumulator of
``lower_nest``; chains and DAGs; schedules from the autotuner's cache
(``ssr_call`` runs :data:`DEFAULT_SCHEDULE` or the ``schedule=`` given).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import DeviceLike, resolve_device, to_device
from . import agu, nest_analysis
from .compiler import Allocation, LoopNest, StreamPlan, _dense_strides, ssrify
from .ssr import (BlockStream, LoweringError, SsrKernel, auto_block,
                  probe_part_shape, scratch_bytes)
from .stream import Direction, StreamSpec

__all__ = ["LoweringError", "BlockPolicy", "Schedule", "DEFAULT_POLICY",
           "DEFAULT_SCHEDULE", "lower_plan", "lower_nest", "ssr_call"]


@dataclasses.dataclass(frozen=True)
class BlockPolicy:
    """How element streams are blocked into tiles: (rows × lanes)."""

    rows: int = 8
    lanes: int = 128

    @property
    def block_elems(self) -> int:
        return self.rows * self.lanes

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (self.rows, self.lanes)


DEFAULT_POLICY = BlockPolicy()


#: Per-level tile targets, in units of the policy's lane/sublane widths.
_LANES_TILE_FACTOR = 4
_ROWS_TILE_FACTOR = 32


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One complete block-scheduling decision for a lowered kernel.

    The same fields, defaults and JSON form as the reference's
    ``Schedule``, so a schedule crosses between the packages unchanged:

    * ``rows``/``lanes`` — the block geometry (the policy);
    * ``lanes_tile_factor``/``rows_tile_factor`` — per-level tile targets
      of the level-mapped path, in units of ``lanes``/``rows``;
    * ``axis_order`` — the grid iteration order of the loop levels
      (level-mapped path only; contraction axes stay trailing);
    * ``acc_dtype`` — the contraction accumulator dtype, by name;
    * ``buffer_depth``/``stream_depths`` — the data mover's FIFO depth,
      uniform or per read stream.  Validated (2..8) and accounted in
      :class:`~repro_torch.core.ssr.StreamReport`; the Hopper kernels of
      this port do not stage by it yet;
    * ``cut_edges`` — for fused-DAG calls, which this port does not run
      yet; kept so the JSON round trip is exact.
    """

    rows: int = 8
    lanes: int = 128
    lanes_tile_factor: int = _LANES_TILE_FACTOR
    rows_tile_factor: int = _ROWS_TILE_FACTOR
    axis_order: Optional[Tuple[int, ...]] = None
    acc_dtype: str = "float32"
    buffer_depth: int = 2
    stream_depths: Optional[Tuple[int, ...]] = None
    cut_edges: Optional[Tuple[int, ...]] = None

    @property
    def policy(self) -> BlockPolicy:
        return BlockPolicy(rows=self.rows, lanes=self.lanes)

    @property
    def block_elems(self) -> int:
        return self.rows * self.lanes

    @property
    def torch_acc_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.acc_dtype, None)
        if not isinstance(dt, torch.dtype):
            raise LoweringError(f"schedule.acc_dtype {self.acc_dtype!r} is "
                                "not a torch dtype name")
        return dt

    @classmethod
    def from_policy(cls, policy: BlockPolicy, **kw) -> "Schedule":
        return cls(rows=policy.rows, lanes=policy.lanes, **kw)

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["axis_order"] = list(self.axis_order) if self.axis_order else None
        d["stream_depths"] = (list(self.stream_depths)
                              if self.stream_depths else None)
        d["cut_edges"] = (list(self.cut_edges)
                          if self.cut_edges is not None else None)
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Schedule":
        ao = d.get("axis_order")
        sd = d.get("stream_depths")
        ce = d.get("cut_edges")
        return cls(rows=int(d["rows"]), lanes=int(d["lanes"]),
                   lanes_tile_factor=int(d.get("lanes_tile_factor",
                                               _LANES_TILE_FACTOR)),
                   rows_tile_factor=int(d.get("rows_tile_factor",
                                              _ROWS_TILE_FACTOR)),
                   axis_order=tuple(int(a) for a in ao) if ao else None,
                   acc_dtype=str(d.get("acc_dtype", "float32")),
                   buffer_depth=int(d.get("buffer_depth", 2)),
                   stream_depths=(tuple(int(x) for x in sd)
                                  if sd else None),
                   cut_edges=(tuple(int(x) for x in ce)
                              if ce is not None else None))


DEFAULT_SCHEDULE = Schedule()


def _depths_for(sched: Schedule, n_in: int):
    """The FIFO depth argument: uniform, or one per read stream."""
    if sched.stream_depths is None:
        return sched.buffer_depth
    if len(sched.stream_depths) != n_in:
        raise LoweringError(
            f"schedule.stream_depths has {len(sched.stream_depths)} entries "
            f"for {n_in} read streams; give one depth per stream "
            "(allocation order)")
    return tuple(sched.stream_depths)


def _resolve_schedule(policy: BlockPolicy,
                      schedule: Optional[Schedule]) -> Schedule:
    """``schedule`` wins; a bare policy is promoted to a default Schedule."""
    if schedule is not None:
        return schedule
    if policy is DEFAULT_POLICY:
        return DEFAULT_SCHEDULE
    return Schedule.from_policy(policy)


def _pad_last(view: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(view, (0, pad)) if pad else view


@dataclasses.dataclass(frozen=True)
class LoweredStream:
    """One allocation lowered to block granularity (flat path).

    ``logical_shape`` is the operand view before padding (``None`` = a
    loop-invariant stream, taken as-is); ``prepare`` turns the user's
    array into the 2-D padded layout whose row-blocks the index map
    addresses.
    """

    name: str
    stream: BlockStream
    spec: StreamSpec
    logical_shape: Optional[Tuple[int, ...]]
    padded_last: int
    policy: BlockPolicy
    offset: int = 0

    def prepare(self, arr: torch.Tensor) -> torch.Tensor:
        """Pad + reshape ``arr`` into the (rows, lanes) layout streamed."""
        lanes = self.policy.lanes
        if self.logical_shape is None:
            # the AGU base pointer shifts the view: the block starts at
            # data[offset], as the spec's repeat walk emits
            flat = arr.reshape(-1)[self.offset:]
            pad = (-flat.shape[0]) % lanes if flat.shape[0] else lanes
            return _pad_last(flat, pad).reshape(-1, lanes)
        want = math.prod(self.logical_shape)
        flat = arr.reshape(-1)
        if flat.shape[0] != want:
            raise ValueError(
                f"stream '{self.name}': operand has {flat.shape[0]} elements, "
                f"plan expects logical shape {self.logical_shape}")
        view = flat.reshape(self.logical_shape)
        pad = self.padded_last - self.logical_shape[-1]
        return _pad_last(view, pad).reshape(-1, lanes)


@dataclasses.dataclass(frozen=True)
class LoweredPlan:
    """A StreamPlan turned into a launchable flat schedule."""

    plan: StreamPlan
    policy: BlockPolicy
    grid: Tuple[int, ...]
    in_streams: Tuple[LoweredStream, ...]
    out_streams: Tuple[LoweredStream, ...]
    schedule: Schedule = DEFAULT_SCHEDULE

    @property
    def steps(self) -> int:
        return math.prod(self.grid)


def _inner_steps_of(bounds: Tuple[int, ...], policy: BlockPolicy) -> int:
    return -(-bounds[-1] // policy.block_elems)


def _lower_allocation(alloc: Allocation, nest: LoopNest,
                      policy: BlockPolicy) -> LoweredStream:
    """Turn one lane's affine access into a BlockStream over row-blocks."""
    coeffs = alloc.ref.coeffs
    if coeffs is None:
        raise LoweringError(f"stream '{alloc.ref.name}' is not affine")
    d = len(nest.bounds)
    E = policy.block_elems
    steps_inner = _inner_steps_of(nest.bounds, policy)
    padded_inner = steps_inner * E

    varying = [k for k, c in enumerate(coeffs) if c != 0]
    if not varying:
        # loop-invariant operand: one block revisited by every grid step
        return LoweredStream(
            name=alloc.ref.name,
            stream=BlockStream(block_shape=(1, policy.lanes),
                               index_map=lambda *_g: (0, 0),
                               direction=alloc.ref.kind,
                               name=alloc.ref.name),
            spec=alloc.spec, logical_shape=None, padded_last=policy.lanes,
            policy=policy, offset=alloc.ref.offset)

    if varying[-1] != d - 1 or coeffs[d - 1] != 1:
        raise LoweringError(
            f"stream '{alloc.ref.name}': innermost coefficient "
            f"{coeffs[d - 1]} is not a unit-stride walk of the innermost "
            "loop — the word-granular AGU supports it, whole-block DMA does "
            "not; use a hand-scheduled 2-D block kernel")

    # dense row-major check for the outer varying levels
    expect = nest.bounds[d - 1]
    for k in reversed(varying[:-1]):
        if coeffs[k] != expect:
            raise LoweringError(
                f"stream '{alloc.ref.name}': level-{k} coefficient "
                f"{coeffs[k]} != dense row-major stride {expect}; the "
                "operand layout is not a contiguous array over its varying "
                "loops")
        expect *= nest.bounds[k]
    if alloc.ref.offset % E:
        raise LoweringError(
            f"stream '{alloc.ref.name}': base offset {alloc.ref.offset} is "
            f"not block-aligned (block = {E} elements)")

    logical_shape = tuple(nest.bounds[k] for k in varying)
    base_block = alloc.ref.offset // E
    block_coeff: Dict[int, int] = {}
    stride_blocks = steps_inner
    for k in reversed(varying[:-1]):
        block_coeff[k] = stride_blocks
        stride_blocks *= nest.bounds[k]

    def index_map(*g):
        row = base_block + g[d - 1]
        for k, bc in block_coeff.items():
            row = row + g[k] * bc
        return (row, 0)

    return LoweredStream(
        name=alloc.ref.name,
        stream=BlockStream(block_shape=policy.block_shape,
                           index_map=index_map,
                           direction=alloc.ref.kind,
                           name=alloc.ref.name),
        spec=alloc.spec,
        logical_shape=logical_shape,
        padded_last=padded_inner,
        policy=policy)


def _canonical_grid(bounds: Tuple[int, ...],
                    policy: BlockPolicy) -> Tuple[int, ...]:
    """Grid for a nest's iteration space, innermost level tiled by blocks,
    derived through :func:`agu.block_grid` on the canonical dense spec."""
    E = policy.block_elems
    padded_inner = _inner_steps_of(bounds, policy) * E
    padded_bounds = tuple(bounds[:-1]) + (padded_inner,)
    canonical = StreamSpec(bounds=padded_bounds,
                           strides=_dense_strides(padded_bounds))
    return agu.block_grid(canonical, (E,))


def lower_plan(plan: StreamPlan,
               policy: BlockPolicy = DEFAULT_POLICY, *,
               schedule: Optional[Schedule] = None) -> LoweredPlan:
    """Lower every allocated lane of ``plan`` to flat block schedules.

    The flat path honours only the schedule's block geometry; a
    non-``None`` ``axis_order`` is rejected, as in the reference.
    """
    sched = _resolve_schedule(policy, schedule)
    if sched.axis_order is not None:
        raise LoweringError(
            "schedule.axis_order applies to the level-mapped path "
            "(lower_nest) only; the flat schedule's grid IS the AGU walk")
    policy = sched.policy
    if not plan.allocations:
        raise LoweringError(
            "plan has no stream allocations (Eq. (3) verdict was 'keep "
            "baseline'); lower the force=True plan for the runtime-decision "
            "path")
    nest = plan.nest
    for r in nest.refs:
        if r.is_indirect():
            raise LoweringError(
                f"indirect ref '{r.name}': gathers take the level-mapped "
                "nest path (lower_nest); give the nest an explicit WRITE "
                "ref so ssr_call routes it there")
    grid = _canonical_grid(nest.bounds, policy)
    lowered = [_lower_allocation(a, nest, policy) for a in plan.allocations]
    ins = tuple(s for s in lowered if s.stream.direction == Direction.READ)
    outs = tuple(s for s in lowered if s.stream.direction == Direction.WRITE)
    return LoweredPlan(plan=plan, policy=policy, grid=grid,
                       in_streams=ins, out_streams=outs, schedule=sched)


# --------------------------------------------------------------------------
# Level-mapped lowering: multi-level nests with contraction axes.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NestStream:
    """One allocation lowered to a level-mapped block schedule.

    ``levels`` is the ref's dense storage order (outermost first);
    ``logical_shape``/``padded_shape`` the operand before/after per-level
    padding; ``layout_shape`` the (at least 2-D) array the stream
    addresses — rank-1 refs gain a leading singleton, loop-invariant refs
    collapse to one ``(1, lanes)`` block.
    """

    name: str
    stream: BlockStream
    levels: Tuple[int, ...]
    logical_shape: Tuple[int, ...]
    padded_shape: Tuple[int, ...]
    layout_shape: Tuple[int, ...]
    policy: BlockPolicy
    offset: int = 0

    def prepare(self, arr: torch.Tensor) -> torch.Tensor:
        """Pad + reshape ``arr`` into the layout the index_map addresses."""
        lanes = self.policy.lanes
        if not self.levels:
            flat = arr.reshape(-1)[self.offset:]
            if flat.shape[0] == 0:
                raise ValueError(
                    f"stream '{self.name}': loop-invariant operand has no "
                    f"elements past offset {self.offset} — the block would "
                    "be all padding")
            if flat.shape[0] > lanes:
                raise ValueError(
                    f"stream '{self.name}': loop-invariant operand has "
                    f"{flat.shape[0]} elements past offset {self.offset}, "
                    f"but an invariant stream serves one (1, {lanes}) block; "
                    "give the operand a varying loop level instead")
            return _pad_last(flat, (-flat.shape[0]) % lanes).reshape(-1, lanes)
        want = math.prod(self.logical_shape)
        flat = arr.reshape(-1)
        if flat.shape[0] != want:
            raise ValueError(
                f"stream '{self.name}': operand has {flat.shape[0]} "
                f"elements, plan expects logical shape {self.logical_shape}")
        view = flat.reshape(self.logical_shape)
        pads: Tuple[int, ...] = ()
        for l, p in zip(reversed(self.logical_shape),
                        reversed(self.padded_shape)):
            pads += (0, p - l)
        if any(pads):
            view = F.pad(view, pads)
        return view.reshape(self.layout_shape)


@dataclasses.dataclass(frozen=True)
class LoweredNest:
    """A StreamPlan with an output ref, lowered level by level.

    ``grid[k]`` covers loop level ``axis_order[k]``; ``tiles`` and
    ``padded_bounds`` stay in loop-level order.  ``contraction_axes`` are
    the output's revisited levels as grid-axis positions (``arbitrary``,
    trailing); every other axis is ``parallel``.
    """

    plan: StreamPlan
    policy: BlockPolicy
    grid: Tuple[int, ...]
    tiles: Tuple[int, ...]
    in_streams: Tuple[NestStream, ...]
    out_stream: NestStream
    contraction_axes: Tuple[int, ...]
    schedule: Schedule = DEFAULT_SCHEDULE
    axis_order: Tuple[int, ...] = ()
    padded_bounds: Tuple[int, ...] = ()

    @property
    def semantics(self) -> Tuple[str, ...]:
        return tuple("arbitrary" if l in self.contraction_axes else "parallel"
                     for l in range(len(self.grid)))

    @property
    def steps(self) -> int:
        return math.prod(self.grid)


def _storage_order_or_raise(ref, nest: LoopNest) -> Tuple[int, ...]:
    order = nest_analysis.storage_order(ref, nest)
    if order is None:
        raise LoweringError(
            f"stream '{ref.name}': coefficients {ref.coeffs} admit no dense "
            "row-major storage order — overlapping or strided layouts are "
            "word-granular AGU territory, not whole-block DMA")
    return order


def _nest_tiles(nest: LoopNest, orders: Dict[str, Tuple[int, ...]],
                sched: Schedule) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per-level (tile, padded bound) from the streams' storage roles.

    A level that is the last storage dim of any stream is a lanes level
    (aligned to ``lanes``, target ``lanes·lanes_tile_factor``); a level in
    outer positions only is a sublane level (aligned to ``rows``, target
    ``rows·rows_tile_factor``); a level no stream varies with has tile 1.
    """
    policy = sched.policy
    roles: Dict[int, str] = {}
    for order in orders.values():
        if order:
            roles[order[-1]] = "lanes"
    for order in orders.values():
        for lvl in order[:-1]:
            roles.setdefault(lvl, "sublane")
    tiles, padded = [], []
    for lvl, b in enumerate(nest.bounds):
        role = roles.get(lvl)
        if role == "lanes":
            align = policy.lanes
            target = policy.lanes * sched.lanes_tile_factor
        elif role == "sublane":
            align = policy.rows
            target = policy.rows * sched.rows_tile_factor
        else:
            tiles.append(1)
            padded.append(b)
            continue
        pb = -(-b // align) * align
        tiles.append(auto_block(pb, target, align))
        padded.append(pb)
    return tuple(tiles), tuple(padded)


def _grid_axis_order(sched: Schedule, d: int,
                     zaxes: Tuple[int, ...]) -> Tuple[int, ...]:
    """Validated grid-axis order: a permutation keeping contractions last."""
    order = sched.axis_order
    if order is None:
        return tuple(range(d))
    if sorted(order) != list(range(d)):
        raise LoweringError(
            f"schedule.axis_order {order} is not a permutation of the "
            f"{d} loop levels")
    if zaxes and set(order[d - len(zaxes):]) != set(zaxes):
        raise LoweringError(
            f"schedule.axis_order {order} does not keep the contraction "
            f"axes {zaxes} trailing; the accumulator's revisits must be "
            "consecutive grid steps")
    return tuple(order)


def _lower_nest_stream(alloc: Allocation, nest: LoopNest,
                       tiles: Tuple[int, ...], padded: Tuple[int, ...],
                       policy: BlockPolicy,
                       pos: Dict[int, int]) -> NestStream:
    """One lane's level-mapped block walk (``pos[lvl]`` = its grid axis)."""
    ref = alloc.ref
    order = _storage_order_or_raise(ref, nest)
    if not order:
        # loop-invariant: a read is one block revisited by every step; a
        # write is the scalar accumulator drained once at the end
        shape = (1, 1) if ref.kind == Direction.WRITE else (1, policy.lanes)
        return NestStream(
            name=ref.name,
            stream=BlockStream(shape, lambda *_g: (0, 0),
                               direction=ref.kind, name=ref.name),
            levels=(), logical_shape=(), padded_shape=(),
            layout_shape=shape, policy=policy, offset=ref.offset)
    if ref.offset:
        raise LoweringError(
            f"stream '{ref.name}': base offset {ref.offset} cannot shift a "
            "level-mapped block walk; fold it into the operand view")
    logical = tuple(nest.bounds[l] for l in order)
    pad_shape = tuple(padded[l] for l in order)
    if len(order) == 1:
        lvl = order[0]
        block = (1, tiles[lvl])
        layout = (1, pad_shape[0])

        def index_map(*g, _p=pos[lvl]):
            return (0, g[_p])
    else:
        block = tuple(tiles[l] for l in order)
        layout = pad_shape

        def index_map(*g, _ps=tuple(pos[l] for l in order)):
            return tuple(g[p] for p in _ps)

    return NestStream(
        name=ref.name,
        stream=BlockStream(block, index_map, direction=ref.kind,
                           name=ref.name),
        levels=order, logical_shape=logical, padded_shape=pad_shape,
        layout_shape=layout, policy=policy)


def lower_nest(plan: StreamPlan,
               policy: BlockPolicy = DEFAULT_POLICY, *,
               schedule: Optional[Schedule] = None) -> LoweredNest:
    """Lower a plan with an output WRITE ref to a level-mapped schedule.

    Requirements (each a :class:`LoweringError` otherwise): exactly one
    WRITE ref, affine and allocated; a dense storage order for every
    allocated ref; the output's contraction axes innermost, so one
    accumulator carries all revisits of an output block.
    """
    sched = _resolve_schedule(policy, schedule)
    policy = sched.policy
    nest = plan.nest
    try:
        out_ref = nest_analysis.output_ref(nest)
    except ValueError as e:
        raise LoweringError(str(e)) from e
    if out_ref is None:
        raise LoweringError(
            "nest has no WRITE ref; use lower_plan with an ssr_call "
            "map/reduce mode to synthesise the output")
    if not out_ref.is_affine():
        raise LoweringError(
            f"output ref '{out_ref.name}' is not affine; it cannot be "
            "served by a write stream")
    out_allocs = [a for a in plan.allocations
                  if a.ref.kind == Direction.WRITE]
    if not out_allocs:
        raise LoweringError(
            f"output ref '{out_ref.name}' was not allocated a lane "
            f"({len(plan.allocations)} lanes used); raise num_lanes so the "
            "write stream gets a data mover")

    zaxes = nest_analysis.contraction_axes(out_ref, nest)
    out_varying = nest_analysis.varying_levels(out_ref)
    if zaxes and out_varying and max(out_varying) > min(zaxes):
        raise LoweringError(
            f"output ref '{out_ref.name}': contraction axes {zaxes} are not "
            f"the innermost levels (output varies with {out_varying}); the "
            "accumulator would be drained and re-initialised mid-reduction")
    if out_ref.acc_kind == "online_softmax":
        raise LoweringError(
            f"output ref '{out_ref.name}': the online-softmax accumulator "
            "arrives with port slice 4 (halo reads and online softmax)")
    for r in nest.refs:
        if r.is_indirect():
            raise LoweringError(
                f"indirect ref '{r.name}': gathers arrive with port slice 5 "
                "(indirection streams)")
        if r.has_window():
            raise LoweringError(
                f"windowed ref '{r.name}': halo reads arrive with port "
                "slice 4 (halo reads and online softmax)")

    orders = {a.ref.name: _storage_order_or_raise(a.ref, nest)
              for a in plan.allocations}
    tiles, padded = _nest_tiles(nest, orders, sched)
    axis_order = _grid_axis_order(sched, len(nest.bounds), zaxes)
    pos = {lvl: k for k, lvl in enumerate(axis_order)}
    grid = tuple(padded[l] // tiles[l] for l in axis_order)

    ins, outs = [], []
    for a in plan.allocations:
        s = _lower_nest_stream(a, nest, tiles, padded, policy, pos)
        (outs if s.stream.direction == Direction.WRITE else ins).append(s)

    return LoweredNest(plan=plan, policy=policy, grid=grid, tiles=tiles,
                       in_streams=tuple(ins), out_stream=outs[0],
                       contraction_axes=tuple(sorted(pos[z] for z in zaxes)),
                       schedule=sched, axis_order=axis_order,
                       padded_bounds=tuple(padded))


# --------------------------------------------------------------------------
# End-to-end execution: ssr_call
# --------------------------------------------------------------------------


#: One bound for every cache of this layer.
CACHE_MAX = 256


@functools.lru_cache(maxsize=CACHE_MAX)
def _plan_for(nest: LoopNest, num_lanes: int) -> StreamPlan:
    """Plan cache (force=True: the caller asked to execute streamed)."""
    return ssrify(nest, num_lanes=num_lanes, force=True)


@functools.lru_cache(maxsize=CACHE_MAX)
def _lowered_for(plan: StreamPlan, sched: Schedule, nested: bool):
    """Lowered-schedule cache: the pure-Python lowering per (plan, sched)."""
    if nested:
        return lower_nest(plan, schedule=sched)
    return lower_plan(plan, schedule=sched)


_PLAN_CACHES = (_plan_for, _lowered_for)

#: ``builds`` counts streamed kernels built (cache misses), ``calls``
#: counts ``ssr_call`` entries.  A repeated identical call moves
#: ``calls`` only.
DISPATCH_STATS: Dict[str, int] = {"builds": 0, "calls": 0}


def reset_dispatch_stats() -> None:
    for k in DISPATCH_STATS:
        DISPATCH_STATS[k] = 0


def _body_key(body: Callable) -> Any:
    """Stable cache identity for a block body.

    An inline lambda is a fresh object every call, but Python compiles its
    code once per source location, so ``(code, bound self, closure
    values, defaults, kw-defaults)`` identifies its behaviour.  Unhashable
    contents fall back to object identity: never stale, just uncached.
    """
    code = getattr(body, "__code__", None)
    if code is None:
        return body
    cells = getattr(body, "__closure__", None) or ()
    kwdefs = getattr(body, "__kwdefaults__", None) or {}
    try:
        key = (code, getattr(body, "__self__", None),
               tuple(c.cell_contents for c in cells),
               getattr(body, "__defaults__", None) or (),
               tuple(sorted(kwdefs.items())))
        hash(key)
    except (TypeError, ValueError):
        return body
    return key


_kernel_cache: "collections.OrderedDict[Any, SsrKernel]" = \
    collections.OrderedDict()


def _kernel_cache_get(key) -> Optional[SsrKernel]:
    fn = _kernel_cache.get(key)
    if fn is not None:
        _kernel_cache.move_to_end(key)
    return fn


def _kernel_cache_put(key, fn: SsrKernel) -> None:
    _kernel_cache[key] = fn
    _kernel_cache.move_to_end(key)
    while len(_kernel_cache) > CACHE_MAX:
        _kernel_cache.popitem(last=False)


def clear_caches() -> None:
    """Empty every lowering-layer cache: plans, lowerings, built kernels."""
    for c in _PLAN_CACHES:
        c.cache_clear()
    _kernel_cache.clear()


def _build_kernel(lowered: LoweredPlan, body: Callable, mode: str,
                  out_dtype: torch.dtype) -> SsrKernel:
    """A flat map/reduce kernel: ``body(*stream_blocks)`` per grid step.

    Reduce mode accumulates into a (rows, lanes) vector accumulator when
    the partial is a multi-element 2-D block, folded to the scalar once;
    a scalar partial keeps a (1, 1) accumulator.  Map mode writes one
    block per step through a dense row-major write stream.
    """
    policy = lowered.policy
    depths = _depths_for(lowered.schedule, len(lowered.in_streams))
    ins = [s.stream for s in lowered.in_streams]
    if mode == "reduce":
        part = probe_part_shape(body, [s.block_shape for s in ins], out_dtype)
        vector = len(part) == 2 and math.prod(part) > 1
        out = BlockStream((1, 1), lambda *g: (0, 0), Direction.WRITE,
                          name="acc")
        return SsrKernel(body, mode=mode, grid=lowered.grid, in_streams=ins,
                         out_stream=out, out_shape=(1, 1),
                         out_dtype=out_dtype,
                         scratch_bytes=scratch_bytes(
                             part if vector else (1, 1), out_dtype),
                         buffer_depth=depths)
    if mode == "map":
        place = _dense_strides(lowered.grid)

        def out_map(*g):
            row = g[0] * place[0]
            for k in range(1, len(g)):
                row = row + g[k] * place[k]
            return (row, 0)

        out = BlockStream(policy.block_shape, out_map, Direction.WRITE,
                          name="out")
        return SsrKernel(body, mode=mode, grid=lowered.grid, in_streams=ins,
                         out_stream=out,
                         out_shape=(lowered.steps * policy.rows,
                                    policy.lanes),
                         out_dtype=out_dtype, buffer_depth=depths)
    raise ValueError(f"unknown ssr_call mode {mode!r}")


def _build_nest_kernel(lowered: LoweredNest, body: Callable,
                       out_dtype: torch.dtype) -> SsrKernel:
    """A level-mapped kernel: ``body(*read_blocks)`` is one output-block
    partial per step, accumulated in ``schedule.acc_dtype`` over the
    contraction axes and cast to ``out_dtype`` on the drain."""
    acc_dtype = lowered.schedule.torch_acc_dtype
    acc_shape = lowered.out_stream.stream.block_shape
    return SsrKernel(
        body, mode="nest", grid=lowered.grid,
        in_streams=[s.stream for s in lowered.in_streams],
        out_stream=lowered.out_stream.stream,
        out_shape=lowered.out_stream.layout_shape,
        out_dtype=out_dtype, acc_dtype=acc_dtype,
        contraction_axes=lowered.contraction_axes,
        scratch_bytes=(scratch_bytes(acc_shape, acc_dtype)
                       if lowered.contraction_axes else 0),
        buffer_depth=_depths_for(lowered.schedule, len(lowered.in_streams)))


def _trim_nest_output(out: torch.Tensor, lowered: LoweredNest) -> torch.Tensor:
    """Drop per-level padding; return the output's logical nd array."""
    ns = lowered.out_stream
    if not ns.levels:
        return out[0, 0]
    if len(ns.levels) == 1:
        return out[0, :ns.logical_shape[0]]
    return out[tuple(slice(0, e) for e in ns.logical_shape)]


def _trim_output(out: torch.Tensor, bounds: Tuple[int, ...], mode: str,
                 policy: BlockPolicy) -> torch.Tensor:
    if mode == "reduce":
        return out[0, 0]
    # map: drop the inner-level padding, then one value per nest iteration
    padded_inner = _inner_steps_of(bounds, policy) * policy.block_elems
    out_nd = out.reshape(*bounds[:-1], padded_inner)
    return out_nd[..., :bounds[-1]].reshape(-1)


@dataclasses.dataclass(frozen=True)
class PreparedCall:
    """One ``ssr_call`` up to the launch: the built kernel, its operands in
    their padded layouts, and what trims the kernel's output."""

    kernel: SsrKernel
    layouts: Tuple[torch.Tensor, ...]
    lowered: Any                     # LoweredPlan | LoweredNest
    bounds: Tuple[int, ...]

    def finish(self, out: torch.Tensor) -> torch.Tensor:
        if self.kernel.mode == "nest":
            return _trim_nest_output(out, self.lowered)
        return _trim_output(out, self.bounds, self.kernel.mode,
                            self.lowered.policy)

    def run(self) -> torch.Tensor:
        return self.finish(self.kernel(*self.layouts))


def prepare_call(nest: LoopNest, body: Callable[..., torch.Tensor],
                 operands: Dict[str, Any], *,
                 mode: str = "reduce",
                 out_dtype: torch.dtype = torch.float32,
                 policy: BlockPolicy = DEFAULT_POLICY,
                 schedule: Optional[Schedule] = None,
                 num_lanes: Optional[int] = None,
                 device: DeviceLike = None) -> PreparedCall:
    """Everything :func:`ssr_call` does before the launch (same arguments)."""
    dev = resolve_device(device)
    sched = _resolve_schedule(policy, schedule)
    num_lanes = nest_analysis.auto_lanes(nest, num_lanes)
    plan = _plan_for(nest, num_lanes)
    has_output = any(r.kind == Direction.WRITE for r in nest.refs)
    if has_output:
        mode = "nest"          # the output ref, not the mode, shapes the call
    DISPATCH_STATS["calls"] += 1

    lowered = _lowered_for(plan, sched, has_output)
    missing = [s.name for s in lowered.in_streams if s.name not in operands]
    if missing:
        raise ValueError(f"missing operands for streams {missing}")
    arrays = [to_device(operands[s.name], dev) for s in lowered.in_streams]
    key = (nest, sched, mode, _body_key(body), out_dtype,
           tuple((tuple(a.shape), a.dtype) for a in arrays), num_lanes)
    kernel = _kernel_cache_get(key)
    if kernel is None:
        if has_output:
            kernel = _build_nest_kernel(lowered, body, out_dtype)
        else:
            kernel = _build_kernel(lowered, body, mode, out_dtype)
        DISPATCH_STATS["builds"] += 1
        _kernel_cache_put(key, kernel)
    layouts = tuple(s.prepare(a) for s, a in zip(lowered.in_streams, arrays))
    return PreparedCall(kernel=kernel, layouts=layouts, lowered=lowered,
                        bounds=tuple(nest.bounds))


def ssr_call(nest: LoopNest, body: Callable[..., torch.Tensor],
             operands: Dict[str, Any], *,
             mode: str = "reduce",
             out_dtype: torch.dtype = torch.float32,
             policy: BlockPolicy = DEFAULT_POLICY,
             schedule: Optional[Schedule] = None,
             num_lanes: Optional[int] = None,
             device: DeviceLike = None) -> torch.Tensor:
    """Execute a :class:`LoopNest` as one streamed kernel.

    ``body(*blocks)`` receives one block per allocated read stream (in
    allocation order) and returns

    * ``mode="reduce"`` — a partial accumulated across all grid steps; a
      block-shaped partial uses a (rows, lanes) vector accumulator folded
      to the scalar once, a scalar partial a (1, 1) one;
    * ``mode="map"`` — one output block per step, written to a dense write
      stream; the result is trimmed to the nest's iteration count.

    A nest with an explicit output WRITE ref takes the level-mapped path
    instead (``mode`` is ignored) and returns the output ref's logical nd
    array (``(m, n)`` for GEMM).

    ``operands`` maps MemRef names to tensors (or numpy arrays), which move
    to ``device`` (default: :func:`repro_torch.default_device`).  On a
    CUDA device the body must be a :class:`~repro_torch.core.ssr.KernelBody`
    whose ``op`` has a Hopper kernel; on the CPU any PyTorch body runs
    through the plain version.  Zero padding is applied per stream, so
    bodies must be padding-neutral for ``reduce`` and for contraction axes.
    """
    return prepare_call(nest, body, operands, mode=mode, out_dtype=out_dtype,
                        policy=policy, schedule=schedule,
                        num_lanes=num_lanes, device=device).run()
