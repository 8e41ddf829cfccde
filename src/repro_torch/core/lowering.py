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

With no ``schedule=`` and the default policy, ``ssr_call`` and
:func:`prepare_call` resolve the schedule from the autotuner's cache
(:func:`repro_torch.core.autotune.lookup`); a tuned schedule that fails to
lower or build with a typed error (:mod:`~repro_torch.core.resilience`) is
quarantined and the call runs again under :data:`DEFAULT_SCHEDULE`.

Chains and DAGs (:func:`lower_chain`, :func:`ssr_chain_call`,
:func:`ssr_dag_call`) fuse several nests over one grid into one
:class:`~repro_torch.core.ssr.StageKernel` whose intermediates stay on chip;
a committed ``Schedule.cut_edges`` runs a DAG as one kernel per component.
``ssr_call`` and the DAG call take ``uniforms=``: whole arrays delivered at
every step as one block with a constant walk.

``lower_nest`` also serves halo reads (a windowed READ ref becomes
``2**k`` +1-shifted streams, widened into one block per step), the
online-softmax accumulator (the flash-attention m/l/acc recurrence over one
contraction axis) and gathers (an indirect ref's addresses come off an
index stream; its table rides whole, after the streamed operands).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import DeviceLike, resolve_device, to_device
from . import agu, nest_analysis, resilience
from .compiler import (Allocation, ChainDAG, ChainedPlan, LoopNest,
                       StreamPlan, _dense_strides, chain, chain_dag, ssrify)
from .ssr import (BlockStream, KernelBody, LoweringError, SsrKernel,
                  StageKernel, StageProgram, auto_block, probe_part_shape,
                  scratch_bytes)
from .stream import Direction, StreamSpec

__all__ = ["LoweringError", "BlockPolicy", "Schedule", "DEFAULT_POLICY",
           "DEFAULT_SCHEDULE", "lower_plan", "lower_nest", "lower_chain",
           "ssr_call", "ssr_chain_call", "ssr_dag_call"]


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
      :class:`~repro_torch.core.ssr.StreamReport`; above 2 the kernels of
      K1–K11's families run their ring kernels (R1–R4, R6–R12), the others
      stay synchronous (:attr:`~repro_torch.core.ssr.SsrKernel.pipelined`);
    * ``cut_edges`` — for fused-DAG calls (:func:`ssr_dag_call`), the
      graph cut: the edges whose intermediates go through device memory,
      one kernel per remaining component (``()`` is all-fused, as ``None``).
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
    resilience.inject("lowering")
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

    def prepare(self, arr: torch.Tensor,
                lead: Tuple[int, ...] = ()) -> torch.Tensor:
        """Pad + reshape ``arr`` into the layout the index_map addresses.

        ``lead`` are leading batch dims that ``arr`` carries in front of
        the operand (a head batch): each batch entry is laid out alike.
        """
        lanes = self.policy.lanes
        if lead and not self.levels:
            raise ValueError(f"stream '{self.name}': a loop-invariant "
                             "operand takes no batch dims")
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
        flat = arr.reshape(*lead, -1)
        if flat.shape[-1] != want:
            raise ValueError(
                f"stream '{self.name}': operand has {flat.shape[-1]} "
                f"elements, plan expects logical shape {self.logical_shape}")
        view = flat.reshape(*lead, *self.logical_shape)
        pads: Tuple[int, ...] = ()
        for l, p in zip(reversed(self.logical_shape),
                        reversed(self.padded_shape)):
            pads += (0, p - l)
        if any(pads):
            view = F.pad(view, pads)
            LAYOUT_COPIES["padded"] += 1
        return view.reshape(*lead, *self.layout_shape)

    def plane(self, arr: torch.Tensor) -> torch.Tensor:
        """``arr`` as its (rows, cols) logical plane, unpadded: a view of a
        contiguous operand, which a kernel reading its rows at pitch cols
        takes as it is (K12's and K13's ELL planes, :func:`device_layouts`)."""
        if len(self.logical_shape) != 2 or \
                arr.numel() != math.prod(self.logical_shape):
            raise ValueError(
                f"stream '{self.name}': operand of shape {tuple(arr.shape)} "
                f"is no plane of logical shape {self.logical_shape}")
        return arr.reshape(self.logical_shape)


@dataclasses.dataclass(frozen=True)
class HaloRead:
    """One windowed READ ref lowered to shifted streams + in-kernel taps.

    A ref with ``window[l] = w > 1`` revisits ``w - 1`` neighbouring
    elements per step on level ``l`` — the stencil halo.  A block walk
    addresses whole tiles, so the lowering emits ``2**k`` copies of the
    stream (``k`` halo'd levels): slot bit ``j`` adds a +1 grid shift on
    halo level ``j``.  The plain version concatenates each shifted pair
    along the level's block axis and keeps the first ``tile + w - 1``
    columns — the widened block the body sees; a Hopper kernel loads that
    widened block straight from the first slot's walk.

    ``slots`` are the shifted streams' positions in ``in_streams`` (binary
    order, bit 0 first); ``axes``/``tiles``/``windows`` are per halo'd
    level, in slot-bit order.
    """

    name: str
    slots: Tuple[int, ...]
    axes: Tuple[int, ...]
    tiles: Tuple[int, ...]
    windows: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class IndirectGather:
    """One indirect ref lowered to an in-kernel gather (arXiv 2011.08070).

    The index stream arrives as a normal dense block (``index_pos`` names
    its position in ``in_streams``); the gather *table* (the indirectly
    addressed operand) rides along whole as a trailing invariant block.
    Per index-block element the kernel computes::

        addr = scale · index_value + Σ_l coeffs[l]·(g[grid_pos[l]]·tiles[l]
                                                    + intra_l) + offset

    and serves the body the gathered block of the flattened table — each
    affine additive level prepends one block dimension.
    """

    name: str
    index_of: str
    index_pos: int               # index stream's slot in in_streams
    scale: int
    offset: int
    levels: Tuple[int, ...]      # affine additive levels (outermost first)
    grid_pos: Tuple[int, ...]    # grid-axis position per level
    tiles: Tuple[int, ...]       # tile extent per level
    coeffs: Tuple[int, ...]      # address coefficient per level


@dataclasses.dataclass(frozen=True)
class LoweredNest:
    """A StreamPlan with an output ref, lowered level by level.

    ``grid[k]`` covers loop level ``axis_order[k]``; ``tiles`` and
    ``padded_bounds`` stay in loop-level order.  ``contraction_axes`` are
    the output's revisited levels as grid-axis positions (``arbitrary``,
    trailing); every other axis is ``parallel``.  ``halos`` are the plan's
    windowed reads; ``rescale`` marks the online-softmax accumulator.
    ``gathers`` are the plan's indirect refs: the body receives their
    gathered blocks *after* the ``in_streams`` blocks, in declaration
    order.
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
    gathers: Tuple[IndirectGather, ...] = ()
    halos: Tuple[HaloRead, ...] = ()
    rescale: bool = False

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

    A halo'd level (some ref reads a ``window[l] = w > 1`` neighbourhood)
    needs ``w - 1`` overlap columns served by one +1-shifted neighbour
    block, so its tile target is raised to at least the aligned overlap;
    a tile that still undershoots it fails in :func:`_lower_halo_streams`
    (and the autotuner filters it).
    """
    policy = sched.policy
    roles: Dict[int, str] = {}
    for order in orders.values():
        if order:
            roles[order[-1]] = "lanes"
    for order in orders.values():
        for lvl in order[:-1]:
            roles.setdefault(lvl, "sublane")
    halo_need: Dict[int, int] = {}
    for ref in nest.refs:
        if ref.name in orders and ref.has_window():
            for lvl, w in enumerate(ref.window):
                if w > 1:
                    halo_need[lvl] = max(halo_need.get(lvl, 0), w - 1)
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
        need = halo_need.get(lvl, 0)
        if need:
            target = max(target, -(-need // align) * align)
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


def _lower_halo_streams(alloc: Allocation, nest: LoopNest,
                        tiles: Tuple[int, ...], padded: Tuple[int, ...],
                        policy: BlockPolicy, pos: Dict[int, int]
                        ) -> Tuple[list, Tuple[int, ...], Tuple[int, ...],
                                   Tuple[int, ...]]:
    """Lower one windowed READ ref to ``2**k`` shifted streams.

    A block walk addresses whole tiles, so it cannot deliver a
    ``tile + w - 1`` widened block: each halo'd level doubles the stream,
    the copy's index map shifted +1 grid step on that level.  The operand
    layout is padded by one extra tile per halo'd level so the shifted walk
    stays in range at the grid edge.

    Returns ``(streams, axes, halo_tiles, windows)`` — the shifted
    :class:`NestStream`\\ s in binary slot order plus the per-halo'd-level
    metadata of :class:`HaloRead` (block axis, tile, window width).
    """
    ref = alloc.ref
    order = _storage_order_or_raise(ref, nest)
    if ref.offset:
        raise LoweringError(
            f"stream '{ref.name}': base offset {ref.offset} cannot shift a "
            "level-mapped block walk; fold it into the operand view")
    halo_lvls = tuple(lvl for lvl, w in enumerate(ref.window) if w > 1)
    for lvl in halo_lvls:
        w = ref.window[lvl]
        if w - 1 > tiles[lvl]:
            raise LoweringError(
                f"stream '{ref.name}': halo window {ref.window} needs "
                f"{w - 1} overlap columns on level {lvl}, but the block "
                f"tile is only {tiles[lvl]} wide; widen the tile so one "
                "block plus its +1-shifted neighbour covers the window")
    halo_set = set(halo_lvls)
    logical = tuple(nest_analysis.level_extent(ref, nest, l) for l in order)
    pad_shape = tuple(padded[l] + (tiles[l] if l in halo_set else 0)
                      for l in order)
    streams = []
    for m in range(1 << len(halo_lvls)):
        shift = {lvl: (m >> j) & 1 for j, lvl in enumerate(halo_lvls)}
        if len(order) == 1:
            lvl = order[0]
            block = (1, tiles[lvl])
            layout = (1, pad_shape[0])

            def index_map(*g, _p=pos[lvl], _s=shift[lvl]):
                return (0, g[_p] + _s)
        else:
            block = tuple(tiles[l] for l in order)
            layout = pad_shape

            def index_map(*g, _ps=tuple(pos[l] for l in order),
                          _ss=tuple(shift.get(l, 0) for l in order)):
                return tuple(g[p] + s for p, s in zip(_ps, _ss))

        streams.append(NestStream(
            name=ref.name,
            stream=BlockStream(block, index_map, direction=ref.kind,
                               name=ref.name),
            levels=order, logical_shape=logical, padded_shape=pad_shape,
            layout_shape=layout, policy=policy))
    axes = tuple(1 if len(order) == 1 else order.index(lvl)
                 for lvl in halo_lvls)
    return (streams, axes, tuple(tiles[lvl] for lvl in halo_lvls),
            tuple(ref.window[lvl] for lvl in halo_lvls))


def lower_nest(plan: StreamPlan,
               policy: BlockPolicy = DEFAULT_POLICY, *,
               schedule: Optional[Schedule] = None) -> LoweredNest:
    """Lower a plan with an output WRITE ref to a level-mapped schedule.

    Requirements (each a :class:`LoweringError` otherwise): exactly one
    WRITE ref, affine and allocated; a dense storage order for every
    allocated ref; the output's contraction axes innermost, so one
    accumulator carries all revisits of an output block.  An
    ``online_softmax`` output needs exactly one contraction axis, two
    varying levels whose lanes level is served in one step, and an f32
    accumulator.  An indirect ref must be allocated, its index stream must
    itself be an allocated read stream, and its affine levels may not be
    levels its index stream varies with.
    """
    resilience.inject("lowering")
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

    rescale = out_ref.acc_kind == "online_softmax"
    if rescale:
        if len(zaxes) != 1:
            raise LoweringError(
                f"output ref '{out_ref.name}': online_softmax needs exactly "
                f"one contraction axis to carry the (m, l, acc) triple "
                f"across, got {zaxes}")
        if set(out_varying) | set(zaxes) != set(range(len(nest.bounds))):
            raise LoweringError(
                f"output ref '{out_ref.name}': online_softmax requires the "
                "output plus the contraction axis to cover every loop "
                f"level (output varies with {out_varying}, contraction "
                f"{zaxes}, nest depth {len(nest.bounds)})")

    for r in plan.residual:
        if r.is_indirect():
            raise LoweringError(
                f"indirect ref '{r.name}' was not allocated a lane; a "
                "gather cannot stay residual on the block path — raise "
                "num_lanes so every indirect ref gets a data mover")
    ind_allocs = [a for a in plan.allocations if a.ref.is_indirect()]
    dense_allocs = [a for a in plan.allocations if not a.ref.is_indirect()]

    orders = {a.ref.name: _storage_order_or_raise(a.ref, nest)
              for a in dense_allocs}
    tiles, padded = _nest_tiles(nest, orders, sched)
    axis_order = _grid_axis_order(sched, len(nest.bounds), zaxes)
    pos = {lvl: k for k, lvl in enumerate(axis_order)}
    grid = tuple(padded[l] // tiles[l] for l in axis_order)

    if rescale:
        out_order = orders[out_ref.name]
        if len(out_order) != 2:
            raise LoweringError(
                f"output ref '{out_ref.name}': online_softmax carries a "
                "(rows, lanes) accumulator block, so the output needs "
                f"exactly two varying levels, got storage order {out_order}")
        lanes_lvl = out_order[-1]
        if padded[lanes_lvl] != tiles[lanes_lvl]:
            raise LoweringError(
                f"output ref '{out_ref.name}': online_softmax needs the "
                f"lanes level {lanes_lvl} served in one grid step "
                f"(padded {padded[lanes_lvl]} vs tile {tiles[lanes_lvl]}); "
                "the rescaled accumulator cannot split its lane dim")
        if sched.torch_acc_dtype != torch.float32:
            raise LoweringError(
                f"output ref '{out_ref.name}': online_softmax pins "
                f"acc_dtype=float32 (running max/sum rescaling is not "
                f"stable in {sched.acc_dtype}); adjust the schedule")

    ins: list = []
    outs: list = []
    halos: list = []
    in_slot: Dict[str, int] = {}
    for a in dense_allocs:
        ref = a.ref
        if ref.kind == Direction.READ and ref.has_window():
            streams, axes, htiles, hwins = _lower_halo_streams(
                a, nest, tiles, padded, policy, pos)
            slots = tuple(range(len(ins), len(ins) + len(streams)))
            in_slot.setdefault(ref.name, slots[0])
            ins.extend(streams)
            halos.append(HaloRead(name=ref.name, slots=slots, axes=axes,
                                  tiles=htiles, windows=hwins))
            continue
        s = _lower_nest_stream(a, nest, tiles, padded, policy, pos)
        if s.stream.direction == Direction.WRITE:
            outs.append(s)
        else:
            in_slot.setdefault(s.name, len(ins))
            ins.append(s)

    gathers = []
    for a in ind_allocs:
        ref = a.ref
        if ref.index_of not in in_slot:
            raise LoweringError(
                f"indirect ref '{ref.name}': its index stream "
                f"'{ref.index_of}' must itself be an allocated read "
                "stream — the gather addresses come off that lane")
        idx_ref = nest_analysis.index_stream_of(ref, nest)
        affine_lvls = tuple(k for k, c in enumerate(ref.coeffs) if c != 0)
        overlap = set(affine_lvls) & set(
            nest_analysis.varying_levels(idx_ref))
        if overlap:
            raise LoweringError(
                f"indirect ref '{ref.name}': affine additive levels "
                f"{sorted(overlap)} coincide with the index stream's "
                "varying levels; the gather address would double-count "
                "those loop indices")
        gathers.append(IndirectGather(
            name=ref.name, index_of=ref.index_of,
            index_pos=in_slot[ref.index_of],
            scale=ref.index_scale, offset=ref.offset,
            levels=affine_lvls,
            grid_pos=tuple(pos[l] for l in affine_lvls),
            tiles=tuple(tiles[l] for l in affine_lvls),
            coeffs=tuple(ref.coeffs[l] for l in affine_lvls)))

    return LoweredNest(plan=plan, policy=policy, grid=grid, tiles=tiles,
                       in_streams=tuple(ins), out_stream=outs[0],
                       contraction_axes=tuple(sorted(pos[z] for z in zaxes)),
                       schedule=sched, axis_order=axis_order,
                       padded_bounds=tuple(padded), gathers=tuple(gathers),
                       halos=tuple(halos), rescale=rescale)


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
def plan_stats(nest: LoopNest, num_lanes: int = 2) -> StreamPlan:
    """The static-verdict plan (no force) — Eq. (1)–(3) cost accounting."""
    return ssrify(nest, num_lanes=num_lanes)


@functools.lru_cache(maxsize=CACHE_MAX)
def _lowered_for(plan: StreamPlan, sched: Schedule, nested: bool):
    """Lowered-schedule cache: the pure-Python lowering per (plan, sched)."""
    if nested:
        return lower_nest(plan, schedule=sched)
    return lower_plan(plan, schedule=sched)


_PLAN_CACHES = (_plan_for, plan_stats, _lowered_for)

#: ``builds`` counts streamed kernels built (cache misses), ``calls``
#: counts ``ssr_call``/``prepare_call`` entries.  A repeated identical call
#: moves ``calls`` only.  ``fallbacks`` counts schedule lookups abandoned
#: for the default (a cache fault before any kernel was built);
#: ``degraded`` counts tuned schedules that failed to lower or build and
#: were quarantined and re-run on the default.  Both stay 0 when healthy.
DISPATCH_STATS: Dict[str, int] = {"builds": 0, "calls": 0, "fallbacks": 0,
                                  "degraded": 0}


def _record_fallback(site: str, error: BaseException, *,
                     from_schedule: str, to_schedule: str,
                     key: Optional[str] = None,
                     counter: str = "fallbacks") -> None:
    """Count and log one degradation step (see ``core/resilience.py``)."""
    DISPATCH_STATS[counter] += 1
    resilience.record_fallback(seam=resilience.classify(error), site=site,
                               error=error, from_schedule=from_schedule,
                               to_schedule=to_schedule, key=key)


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
    """Empty every lowering-layer cache: plans, lowerings, built kernels,
    resolved schedules."""
    for c in _PLAN_CACHES:
        c.cache_clear()
    _kernel_cache.clear()
    _resolved_schedules.clear()
    _resolved_dag_schedules.clear()


def _uniform_streams(uniforms: Sequence[Tuple[int, ...]]) -> list:
    """Each uniform as a read stream whose one block is the whole array,
    the same at every step: its AGU coefficients are all 0."""
    def _whole(nd: int):
        return lambda *_g: (0,) * nd

    return [BlockStream(tuple(u), _whole(len(u)), Direction.READ,
                        name=f"_uniform{i}")
            for i, u in enumerate(uniforms)]


def _depths_with_uniforms(sched: Schedule, n_in: int, n_uniform: int):
    """The FIFO depths of the streams, uniforms (depth 2) appended."""
    depths = _depths_for(sched, n_in)
    if isinstance(depths, tuple):
        depths = depths + (2,) * n_uniform
    return depths


def _build_kernel(lowered: LoweredPlan, body: Callable, mode: str,
                  out_dtype: torch.dtype,
                  uniforms: Sequence[Tuple[int, ...]] = ()) -> SsrKernel:
    """A flat map/reduce kernel: ``body(*stream_blocks, *uniforms)`` per
    grid step.

    Reduce mode accumulates into a (rows, lanes) vector accumulator when
    the partial is a multi-element 2-D block, folded to the scalar once;
    a scalar partial keeps a (1, 1) accumulator.  Map mode writes one
    block per step through a dense row-major write stream.  Each uniform
    (its shape in ``uniforms``) trails the streamed inputs as one whole
    block delivered at every step.
    """
    policy = lowered.policy
    depths = _depths_with_uniforms(lowered.schedule,
                                   len(lowered.in_streams), len(uniforms))
    ins = [s.stream for s in lowered.in_streams] + _uniform_streams(uniforms)
    common = dict(grid=lowered.grid, in_streams=ins, out_dtype=out_dtype,
                  buffer_depth=depths, n_uniform=len(uniforms))
    if mode == "reduce":
        part = probe_part_shape(body, [s.block_shape for s in ins], out_dtype)
        vector = len(part) == 2 and math.prod(part) > 1
        return SsrKernel(body, mode=mode, out_stream=_acc_stream(),
                         out_shape=(1, 1),
                         scratch_bytes=scratch_bytes(
                             part if vector else (1, 1), out_dtype),
                         **common)
    if mode == "map":
        return SsrKernel(body, mode=mode,
                         out_stream=_map_out_stream(lowered.grid, policy),
                         out_shape=(lowered.steps * policy.rows,
                                    policy.lanes),
                         **common)
    raise ValueError(f"unknown ssr_call mode {mode!r}")


def _acc_stream() -> BlockStream:
    """The reduce epilogue's (1, 1) output: the folded accumulator."""
    return BlockStream((1, 1), lambda *g: (0, 0), Direction.WRITE,
                       name="acc")


def _map_out_stream(grid: Tuple[int, ...], policy: BlockPolicy) -> BlockStream:
    """The map epilogue's dense row-major write stream: one block a step."""
    place = _dense_strides(grid)

    def out_map(*g):
        row = g[0] * place[0]
        for k in range(1, len(g)):
            row = row + g[k] * place[k]
        return (row, 0)

    return BlockStream(policy.block_shape, out_map, Direction.WRITE,
                       name="out")


def _table_view_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The ≥2-D view a gather table takes (rank-1 gains a row)."""
    return shape if len(shape) >= 2 else (1,) + tuple(shape)


def _index_extent(ns: NestStream) -> Tuple[int, int]:
    """(rows, cols) of a stream's 2-D layout that hold its operand."""
    if not ns.levels:
        return tuple(ns.layout_shape)
    if len(ns.levels) == 1:
        return (1, ns.logical_shape[0])
    return (math.prod(ns.logical_shape[:-1]), ns.logical_shape[-1])


def _gather_agus(lowered: LoweredNest) -> Tuple[agu.GatherAGU, ...]:
    """Each gather's address program; its table is read stream
    ``len(in_streams) + i``."""
    n_in = len(lowered.in_streams)
    return tuple(
        agu.GatherAGU(index=g.index_pos, table=n_in + i, scale=g.scale,
                      offset=g.offset, grid_pos=g.grid_pos, tiles=g.tiles,
                      coeffs=g.coeffs,
                      extent=_index_extent(lowered.in_streams[g.index_pos]))
        for i, g in enumerate(lowered.gathers))


def _table_streams(lowered: LoweredNest,
                   tables: Sequence[Tuple[int, ...]]) -> list:
    """Each gather table as a read stream whose one block is the whole
    (≥2-D) table, revisited by every step."""
    return [BlockStream(tuple(t), lambda *_g, _nd=len(t): (0,) * _nd,
                        direction=Direction.READ, name=g.name)
            for g, t in zip(lowered.gathers, tables)]


def _build_nest_kernel(lowered: LoweredNest, body: Callable,
                       out_dtype: torch.dtype,
                       tables: Sequence[Tuple[int, ...]] = ()) -> SsrKernel:
    """A level-mapped kernel: ``body(*read_blocks)`` is one output-block
    partial per step, accumulated in ``schedule.acc_dtype`` over the
    contraction axes and cast to ``out_dtype`` on the drain.

    With ``lowered.gathers``, ``tables`` gives one (≥2-D) shape per gather:
    each table rides as a trailing read stream whose block is the whole
    table at every step (FIFO depth 2, as the reference accounts it), and
    the body receives the gathered blocks after the streamed ones.

    A halo'd ref's shifted streams reach the body as ONE widened block.
    With ``lowered.rescale`` the accumulator is the online-softmax triple:
    ``body(*blocks, offs)`` (``offs`` the per-level global offsets of the
    step, for the masks) returns the masked score block ``s`` (rows ×
    contraction tile) and the value block ``v``; the kernel carries
    ``m' = max(m, rowmax s)``, ``α = e^{m−m'}``, ``l' = αl + Σ e^{s−m'}``,
    ``acc' = α·acc + e^{s−m'}·v`` and drains ``acc / max(l, 1e-30)``; its
    scratch is m and l, (rows, 1), and acc, (rows, lanes), all f32.
    """
    acc_dtype = lowered.schedule.torch_acc_dtype
    acc_shape = lowered.out_stream.stream.block_shape
    scratch = (scratch_bytes(acc_shape, acc_dtype)
               if lowered.contraction_axes else 0)
    level_tiles: Tuple[Tuple[int, int], ...] = ()
    if lowered.rescale:
        if lowered.gathers:
            raise LoweringError(
                "the online-softmax accumulator takes no gathers in this "
                "port; give the nest dense streams")
        scratch += 2 * scratch_bytes((acc_shape[0], 1), acc_dtype)
        pos = {lvl: k for k, lvl in enumerate(lowered.axis_order)}
        level_tiles = tuple((pos[l], t) for l, t in enumerate(lowered.tiles))
    if len(tables) != len(lowered.gathers):
        raise ValueError(f"{len(lowered.gathers)} gathers, got "
                         f"{len(tables)} table shapes")
    depths = _depths_for(lowered.schedule, len(lowered.in_streams))
    if lowered.gathers:
        if isinstance(depths, int):
            depths = (depths,) * len(lowered.in_streams)
        depths = tuple(depths) + (2,) * len(lowered.gathers)
    return SsrKernel(
        body, mode="nest", grid=lowered.grid,
        in_streams=[s.stream for s in lowered.in_streams]
        + _table_streams(lowered, tables),
        out_stream=lowered.out_stream.stream,
        out_shape=lowered.out_stream.layout_shape,
        out_dtype=out_dtype, acc_dtype=acc_dtype,
        contraction_axes=lowered.contraction_axes,
        scratch_bytes=scratch, buffer_depth=depths,
        halos=lowered.halos, rescale=lowered.rescale,
        level_tiles=level_tiles, gathers=_gather_agus(lowered))


def _trim_nest_output(out: torch.Tensor, lowered: LoweredNest) -> torch.Tensor:
    """Drop per-level padding; return the output's logical nd array (with
    any leading batch dims of a multi-level output kept)."""
    ns = lowered.out_stream
    if not ns.levels:
        return out[0, 0]
    if len(ns.levels) == 1:
        return out[0, :ns.logical_shape[0]]
    return out[(..., *(slice(0, e) for e in ns.logical_shape))]


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
    the layouts it reads (padded, or the unpadded planes where
    :attr:`planes`), and what trims the kernel's output."""

    kernel: SsrKernel
    layouts: Tuple[torch.Tensor, ...]
    lowered: Any                     # LoweredPlan | LoweredNest
    bounds: Tuple[int, ...]
    #: whether the read streams' layouts are their operands' unpadded
    #: planes (a kernel that takes them, on the card: :func:`device_layouts`)
    planes: bool = False

    def finish(self, out: torch.Tensor) -> torch.Tensor:
        if self.kernel.mode == "nest":
            return _trim_nest_output(out, self.lowered)
        return _trim_output(out, self.bounds, self.kernel.mode,
                            self.lowered.policy)

    def run(self) -> torch.Tensor:
        return self.finish(self.kernel(*self.layouts))

    def padded_layouts(self) -> Tuple[torch.Tensor, ...]:
        """:attr:`layouts` with every read stream in its padded layout:
        what the kernels that read whole blocks take (R13 or R14, on a call
        whose K12 or K13 reads the unpadded planes); :attr:`layouts`
        themselves where
        they are padded already."""
        if not self.planes:
            return self.layouts
        n = len(self.lowered.in_streams) + len(self.lowered.gathers)
        return stream_layouts(self.lowered, self.layouts[:n]) + \
            self.layouts[n:]


def build_kernel(lowered: Any, body: Callable, mode: str,
                 out_dtype: torch.dtype,
                 uniforms: Sequence[Tuple[int, ...]] = (),
                 tables: Sequence[Tuple[int, ...]] = ()) -> SsrKernel:
    """The :class:`SsrKernel` of a lowered schedule (flat or level-mapped):
    its geometry is what the Hopper kernel is programmed with.  ``tables``
    are the gather tables' (≥2-D) shapes of a level-mapped call."""
    if isinstance(lowered, LoweredNest):
        return _build_nest_kernel(lowered, body, out_dtype, tables)
    return _build_kernel(lowered, body, mode, out_dtype, uniforms)


def _uniform_items(uniforms: Optional[Dict[str, Any]],
                   dev: torch.device) -> Tuple[Tuple[str, torch.Tensor], ...]:
    """A uniforms dict as ``((name, tensor on dev), ...)`` in dict order.

    1-D arrays gain a leading singleton (a block is at least 2-D); scalars
    are rejected — a Python float in the body's closure (or a
    :class:`KernelBody` parameter) is already hashable and free.
    """
    if not uniforms:
        return ()
    items = []
    for name, arr in uniforms.items():
        a = to_device(arr, dev)
        if a.dim() == 0:
            raise ValueError(
                f"uniform {name!r} is a scalar; close over the Python "
                "value instead — scalar closures hash and cache fine")
        if a.dim() == 1:
            a = a.reshape(1, -1)
        items.append((name, a.contiguous()))
    return tuple(items)


def _uniform_sig(items: Tuple[Tuple[str, torch.Tensor], ...]) -> Tuple:
    return tuple((nm, tuple(a.shape), a.dtype) for nm, a in items)


#: Read streams laid out by a copy into their padded layouts (the
#: ``F.pad`` of :meth:`NestStream.prepare`); the card's K12 and K13 take a
#: gather's planes as they are and add none (:func:`device_layouts`).
LAYOUT_COPIES: Dict[str, int] = {"padded": 0}


def stream_layouts(lowered: Any, arrays: Sequence[torch.Tensor],
                   lead: Tuple[int, ...] = (),
                   planes: bool = False) -> Tuple[torch.Tensor, ...]:
    """Each read stream's padded layout of its operand (with ``lead``
    leading batch dims on a level-mapped call).  A halo'd ref's shifted
    streams address one layout, laid out once and shared.  Arrays past the
    read streams are the gather tables, in ``lowered.gathers`` order: each
    is passed whole, as its contiguous ≥2-D view.  With ``planes`` (a call
    with gathers) the read streams are their operands' unpadded (rows,
    cols) planes instead (:meth:`NestStream.plane`)."""
    n_in = len(lowered.in_streams)
    gathers = getattr(lowered, "gathers", ())
    if len(arrays) != n_in + len(gathers):
        raise ValueError(f"{n_in} read streams and {len(gathers)} gather "
                         f"tables, got {len(arrays)} operands")
    if lead and gathers:
        raise ValueError("a call with gathers takes no batch dims")
    twin = {s: h.slots[0] for h in getattr(lowered, "halos", ())
            for s in h.slots[1:]}
    out: list = []
    for k, (s, a) in enumerate(zip(lowered.in_streams, arrays)):
        if k in twin:
            out.append(out[twin[k]])
        elif planes and gathers:
            out.append(s.plane(a))
        else:
            out.append(s.prepare(a, lead) if lead else s.prepare(a))
    for t in arrays[n_in:]:
        out.append(t.reshape(_table_view_shape(tuple(t.shape))).contiguous())
    return tuple(out)


def device_layouts(kernel: Any, lowered: Any,
                   arrays: Sequence[torch.Tensor],
                   dev: torch.device) -> Tuple[torch.Tensor, ...]:
    """The layouts ``kernel`` runs on, on ``dev``: the padded layouts of
    :func:`stream_layouts`, but on a CUDA device for a kernel that
    :attr:`~SsrKernel.takes_planes` (K12, K13), which reads the operands'
    unpadded planes as they are (no layout copy).  The CPU executor takes
    the padded layouts.  Pure: it reads ``dev``'s type and touches no
    device."""
    return stream_layouts(lowered, arrays, planes=_on_planes(kernel, dev))


def _on_planes(kernel: Any, dev: torch.device) -> bool:
    return torch.device(dev).type == "cuda" and kernel.takes_planes


def _prepare(nest: LoopNest, body: Callable, operands: Dict[str, Any],
             mode: str, out_dtype: torch.dtype, sched: Schedule,
             num_lanes: int, dev: torch.device,
             uni: Tuple[Tuple[str, torch.Tensor], ...] = ()) -> PreparedCall:
    """Lower under ``sched``, build (or reuse) the kernel, lay out the
    operands: everything up to the launch."""
    plan = _plan_for(nest, num_lanes)
    has_output = any(r.kind == Direction.WRITE for r in nest.refs)
    if has_output:
        mode = "nest"          # the output ref, not the mode, shapes the call
    lowered = _lowered_for(plan, sched, has_output)
    gathers = lowered.gathers if has_output else ()
    missing = [s.name for s in lowered.in_streams if s.name not in operands]
    missing += [g.name for g in gathers if g.name not in operands]
    if missing:
        raise ValueError(f"missing operands for streams {missing}")
    # gather tables travel after the streamed operands
    arrays = [to_device(operands[s.name], dev)
              for s in (*lowered.in_streams, *gathers)]
    key = (nest, sched, mode, _body_key(body), out_dtype,
           tuple((tuple(a.shape), a.dtype) for a in arrays),
           _uniform_sig(uni), num_lanes)
    kernel = _kernel_cache_get(key)
    if kernel is None:
        resilience.inject("compile")
        kernel = build_kernel(
            lowered, body, mode, out_dtype,
            tuple(tuple(a.shape) for _, a in uni),
            tuple(_table_view_shape(tuple(a.shape))
                  for a in arrays[len(lowered.in_streams):]))
        DISPATCH_STATS["builds"] += 1
        _kernel_cache_put(key, kernel)
    planes = _on_planes(kernel, dev)
    layouts = stream_layouts(lowered, arrays, planes=planes)
    return PreparedCall(kernel=kernel, layouts=layouts + tuple(
        a for _, a in uni), lowered=lowered, bounds=tuple(nest.bounds),
        planes=planes)


#: ``ssr_call``'s resolved schedules: (epoch, nest, operand shapes and
#: dtypes, mode, output dtype, device) → (schedule, tuned key or None).
#: Keyed on :func:`autotune.epoch`, as ``NestKernel``'s entries are, so a
#: commit, quarantine or new cache directory in this process resolves anew;
#: another process's commit is adopted by :func:`autotune.refresh`.
_resolved_schedules: Dict[Any, Tuple[Schedule, Optional[str]]] = {}


def _tuned_schedule(nest: LoopNest, operands: Dict[str, Any], mode: str,
                    out_dtype: torch.dtype, dev: torch.device,
                    site: str = "ssr_call") -> Tuple[Schedule, Optional[str]]:
    """(schedule, tuned key) from the autotuner's cache, memoised per
    epoch; the key is None when the schedule is the default."""
    from . import autotune

    memo = (autotune.epoch(), nest,
            tuple((k, tuple(v.shape), v.dtype)
                  for k, v in sorted(operands.items())),
            mode, out_dtype, dev)
    hit = _resolved_schedules.get(memo)
    if hit is not None:
        return hit
    try:
        schedule = autotune.lookup(nest, operands, mode=mode,
                                   out_dtype=out_dtype, device=dev)
    except resilience.fallback_error_types() as e:
        _record_fallback(site, e, from_schedule="tuned-lookup",
                         to_schedule="default")
        return DEFAULT_SCHEDULE, None     # not memoised: the next call retries
    key = None if schedule == DEFAULT_SCHEDULE else autotune.cache_key(
        nest, operands, mode=mode, out_dtype=out_dtype, device=dev)
    if len(_resolved_schedules) >= CACHE_MAX:
        _resolved_schedules.clear()
    _resolved_schedules[memo] = (schedule, key)
    return schedule, key


def _resolved(nest: LoopNest, operands: Dict[str, Any], mode: str,
              out_dtype: torch.dtype, policy: BlockPolicy,
              schedule: Optional[Schedule], dev: torch.device,
              attempt: Callable[[Schedule], Any],
              site: str = "ssr_call") -> Any:
    """Run ``attempt(schedule)`` under the resolved schedule, with the
    tuned → default ladder.

    With no ``schedule`` and the default ``policy`` the autotuner's cache is
    consulted on the call's device (:func:`_tuned_schedule`).  A failed
    lookup falls back to the default (``fallbacks``); a tuned schedule whose
    attempt fails with a typed error (:func:`resilience.fallback_error_types`)
    is quarantined and the attempt runs again under the default
    (``degraded``).  A kernel build or launch error is not typed: it
    propagates.
    """
    tuned_key: Optional[str] = None
    if schedule is None and policy is DEFAULT_POLICY:
        schedule, tuned_key = _tuned_schedule(nest, operands, mode,
                                              out_dtype, dev, site)
    DISPATCH_STATS["calls"] += 1
    sched = _resolve_schedule(policy, schedule)
    if tuned_key is None:
        return attempt(sched)
    try:
        return attempt(sched)
    except resilience.fallback_error_types() as e:
        from . import autotune

        autotune.global_cache().quarantine(tuned_key)
        _record_fallback(site, e, from_schedule="tuned",
                         to_schedule="default", key=tuned_key,
                         counter="degraded")
        return attempt(DEFAULT_SCHEDULE)


def prepare_call(nest: LoopNest, body: Callable[..., torch.Tensor],
                 operands: Dict[str, Any], *,
                 mode: str = "reduce",
                 out_dtype: torch.dtype = torch.float32,
                 policy: BlockPolicy = DEFAULT_POLICY,
                 schedule: Optional[Schedule] = None,
                 num_lanes: Optional[int] = None,
                 device: DeviceLike = None,
                 uniforms: Optional[Dict[str, Any]] = None) -> PreparedCall:
    """Everything :func:`ssr_call` does before the launch (same arguments,
    the same schedule resolution and ladder)."""
    dev = resolve_device(device)
    lanes = nest_analysis.auto_lanes(nest, num_lanes)
    uni = _checked_uniforms(nest, uniforms, dev)
    return _resolved(
        nest, operands, mode, out_dtype, policy, schedule, dev,
        lambda s: _prepare(nest, body, operands, mode, out_dtype, s, lanes,
                           dev, uni))


def _checked_uniforms(nest: LoopNest, uniforms: Optional[Dict[str, Any]],
                      dev: torch.device):
    uni = _uniform_items(uniforms, dev)
    if uni and any(r.kind == Direction.WRITE for r in nest.refs):
        raise LoweringError(
            "uniform operands are not supported on the level-mapped "
            "(explicit WRITE ref) path; use a map/reduce nest")
    return uni


def ssr_call(nest: LoopNest, body: Callable[..., torch.Tensor],
             operands: Dict[str, Any], *,
             mode: str = "reduce",
             out_dtype: torch.dtype = torch.float32,
             policy: BlockPolicy = DEFAULT_POLICY,
             schedule: Optional[Schedule] = None,
             num_lanes: Optional[int] = None,
             device: DeviceLike = None,
             uniforms: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Execute a :class:`LoopNest` as one streamed kernel.

    ``body(*blocks, *uniforms)`` receives one block per allocated read
    stream (in allocation order), then every ``uniforms`` array whole (in
    dict order; a 1-D array as ``(1, n)``, a scalar is refused), and
    returns

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

    With no ``schedule`` (and the default ``policy``) the schedule comes
    from the autotuner's cache, resolved once per problem and
    :func:`autotune.epoch` like ``NestKernel``'s, so every entry point runs
    the same winner for the same problem; a failing tuned schedule degrades
    to the default (see :func:`_resolved`).
    """
    dev = resolve_device(device)
    lanes = nest_analysis.auto_lanes(nest, num_lanes)
    uni = _checked_uniforms(nest, uniforms, dev)
    return _resolved(
        nest, operands, mode, out_dtype, policy, schedule, dev,
        lambda s: _prepare(nest, body, operands, mode, out_dtype, s, lanes,
                           dev, uni).run())


# --------------------------------------------------------------------------
# Stream chaining: a ChainedPlan or ChainDAG lowers to ONE kernel whose
# intermediates stay on chip and never touch device memory.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LoweredChain:
    """A ChainedPlan *or* ChainDAG turned into one launchable schedule.

    All stages share one grid (the unified iteration space, innermost level
    tiled by the policy block).  ``stage_in_streams[k]`` are stage k's
    external read streams; the link intermediates have *no* streams at all —
    they exist only on chip inside the kernel.  For a ChainDAG the scratch
    slots are refcounted: a produced block's slot is reused once its last
    consumer stage has read it (see ``_dag_slots``).
    """

    chained: Any                    # ChainedPlan | ChainDAG
    policy: BlockPolicy
    grid: Tuple[int, ...]
    stage_in_streams: Tuple[Tuple[LoweredStream, ...], ...]
    schedule: Schedule = DEFAULT_SCHEDULE

    @property
    def in_streams(self) -> Tuple[LoweredStream, ...]:
        return tuple(s for stage in self.stage_in_streams for s in stage)

    @property
    def steps(self) -> int:
        return math.prod(self.grid)


def lower_chain(chained, policy: BlockPolicy = DEFAULT_POLICY, *,
                schedule: Optional[Schedule] = None) -> LoweredChain:
    """Lower a chain (or chain DAG) to one fused schedule.

    Accepts a linear :class:`ChainedPlan` or a :class:`ChainDAG` — both
    expose ``stages``/``links``/``bounds``, and the stage emission is
    topologically ordered either way.  Block-granular chaining requires each
    link to walk the canonical dense row-major pattern of the shared
    iteration space: then grid step ``g``'s produced block is *exactly* the
    block the consumer eats at step ``g``, so the intermediate can stay on
    chip.  Anything else raises :class:`LoweringError`.
    """
    resilience.inject("lowering")
    sched = _resolve_schedule(policy, schedule)
    if sched.axis_order is not None:
        raise LoweringError(
            "schedule.axis_order applies to the level-mapped path "
            "(lower_nest) only; a chain's grid IS the unified AGU walk")
    policy = sched.policy
    bounds = chained.bounds
    dense = _dense_strides(bounds)
    for link in chained.links:
        if link.coeffs != dense or link.offset != 0:
            raise LoweringError(
                f"link '{link.name}': intermediate walk {link.coeffs}+"
                f"{link.offset} is not the dense row-major walk {dense}+0 of "
                "the iteration space — the producer's block is not the "
                "consumer's block, so the intermediate cannot stay in VMEM")
    if not any(p.allocations for p in chained.stages):
        raise LoweringError(
            "chained plan has no stream allocations (every stage kept the "
            "baseline verdict); chain with force=True for the "
            "runtime-decision path")

    stage_streams = []
    for k, plan in enumerate(chained.stages):
        lowered = [_lower_allocation(a, plan.nest, policy)
                   for a in plan.allocations]
        writes = [s.name for s in lowered
                  if s.stream.direction == Direction.WRITE]
        if writes:
            raise LoweringError(
                f"chain stage {k} carries write streams {writes}; only the "
                "final output (synthesised from the call mode) may leave "
                "the fused region")
        stage_streams.append(tuple(lowered))

    return LoweredChain(chained=chained, policy=policy,
                        grid=_canonical_grid(bounds, policy),
                        stage_in_streams=tuple(stage_streams),
                        schedule=sched)


@functools.lru_cache(maxsize=CACHE_MAX)
def _chain_for(nests: Tuple[LoopNest, ...],
               num_lanes: Optional[int]) -> ChainedPlan:
    """Chained-plan cache (force=True: the caller asked to execute fused)."""
    return chain(nests, num_lanes=num_lanes, force=True)


@functools.lru_cache(maxsize=CACHE_MAX)
def _dag_for(nests: Tuple[LoopNest, ...],
             num_lanes: Optional[int]) -> ChainDAG:
    """Chain-DAG cache (force=True: the caller asked to execute fused)."""
    return chain_dag(nests, num_lanes=num_lanes, force=True)


@functools.lru_cache(maxsize=CACHE_MAX)
def _lowered_chain_for(chained: Any, sched: Schedule) -> LoweredChain:
    return lower_chain(chained, schedule=sched)


_PLAN_CACHES += (_chain_for, _dag_for, _lowered_chain_for)


def _stage_offsets(lowered: LoweredChain) -> Tuple[list, list]:
    counts = [len(stage) for stage in lowered.stage_in_streams]
    offsets = [0]
    for c in counts[:-1]:
        offsets.append(offsets[-1] + c)
    return counts, offsets


def _chain_stage_shapes(lowered: LoweredChain, bodies: Sequence[Callable],
                        out_dtype: torch.dtype,
                        require_final_block: bool = False) -> Tuple[int, ...]:
    """Shape-check every stage by one step on zeros; return the final
    partial's shape.

    Each linked intermediate must fill exactly one policy block — the
    on-chip block the next stage reads.  ``require_final_block`` extends
    the check to the last stage (map mode, where the value feeds the dense
    write stream).
    """
    policy = lowered.policy
    shape: Tuple[int, ...] = ()
    for k, stage in enumerate(lowered.stage_in_streams):
        ins = [s.stream.block_shape for s in stage]
        carried = [policy.block_shape] if k else []
        shape = probe_part_shape(bodies[k], carried + ins, out_dtype)
        must_block = k < len(bodies) - 1 or require_final_block
        if must_block and math.prod(shape) != policy.block_elems:
            what = ("a linked intermediate" if k < len(bodies) - 1
                    else "the map-mode output")
            raise LoweringError(
                f"chain stage {k} body returns shape {shape} "
                f"({math.prod(shape)} elements); {what} "
                f"must fill one {policy.block_shape} VMEM block")
    return shape


def _stage_kernel(lowered: LoweredChain, bodies: Sequence[Callable],
                  sources: Sequence[Sequence[Tuple[str, int]]], mode: str,
                  out_dtype: torch.dtype, part: Tuple[int, ...],
                  uniforms: Sequence[Tuple[int, ...]] = (),
                  slots: Sequence[Optional[int]] = (),
                  n_slots: int = 0) -> StageKernel:
    """The :class:`StageKernel` of a lowered chain or DAG with the map or
    reduce epilogue of ``mode``."""
    policy = lowered.policy
    n_streams = len(lowered.in_streams)
    ins = [s.stream for s in lowered.in_streams] + _uniform_streams(uniforms)
    program = StageProgram.of(bodies, sources, n_streams, len(uniforms),
                              slots, n_slots, policy.block_shape, mode)
    block = scratch_bytes(policy.block_shape, out_dtype)
    common = dict(mode=mode, grid=lowered.grid, in_streams=ins,
                  out_dtype=out_dtype,
                  buffer_depth=_depths_with_uniforms(
                      lowered.schedule, n_streams, len(uniforms)),
                  n_uniform=len(uniforms))
    if mode == "reduce":
        vector = len(part) == 2 and math.prod(part) > 1
        return StageKernel(bodies, program, out_stream=_acc_stream(),
                           out_shape=(1, 1),
                           scratch_bytes=n_slots * block + scratch_bytes(
                               part if vector else (1, 1), out_dtype),
                           **common)
    if mode == "map":
        return StageKernel(bodies, program,
                           out_stream=_map_out_stream(lowered.grid, policy),
                           out_shape=(lowered.steps * policy.rows,
                                      policy.lanes),
                           scratch_bytes=n_slots * block, **common)
    raise ValueError(f"unknown ssr_call mode {mode!r}")


def _build_chain_kernel(lowered: LoweredChain, bodies: Sequence[Callable],
                        mode: str, out_dtype: torch.dtype) -> StageKernel:
    """Fuse all stage bodies into ONE kernel.

    Per grid step: stage 0 computes its block from its read streams; each
    intermediate stays on chip and is the next stage's first argument the
    same step; the final stage's value feeds the map/reduce epilogue.
    """
    counts, offsets = _stage_offsets(lowered)
    final = _chain_stage_shapes(lowered, bodies, out_dtype,
                                require_final_block=(mode == "map"))
    sources = [([("stage", k - 1)] if k else [])
               + [("stream", offsets[k] + j) for j in range(counts[k])]
               for k in range(len(bodies))]
    n_links = len(lowered.chained.links)
    return _stage_kernel(lowered, bodies, sources, mode, out_dtype, final,
                         slots=[0] * n_links + [None],
                         n_slots=min(n_links, 1))


def _dag_slots(dag: ChainDAG) -> Tuple[Dict[str, int], int]:
    """Refcounted scratch-slot assignment for a ChainDAG's values.

    Walking the stages in (topological) order: a produced block takes a
    slot; once its *last* consumer stage has read it the slot returns to
    the free list and the next producer reuses it.  Returns ``(slot_of,
    n_slots)``: the per-intermediate slot index and the peak number of live
    blocks (a diamond needs 2 slots, not one per edge).
    """
    slot_of: Dict[str, int] = {}
    free: list = []
    n_slots = 0
    n = len(dag.stages)
    for k in range(n):
        for name in sorted({e.name for e in dag.in_edges(k)}):
            if dag.last_consumer(name) == k:
                free.append(slot_of[name])
        if k == n - 1:
            continue        # the final value exits via the call epilogue
        produced = sorted({e.name for e in dag.out_edges(k)})
        if len(produced) != 1:
            raise LoweringError(
                f"dag stage {k} produces intermediates {produced}; a stage "
                "body returns one block, so each non-final stage must "
                "write exactly one intermediate")
        if free:
            slot_of[produced[0]] = free.pop()
        else:
            slot_of[produced[0]] = n_slots
            n_slots += 1
    return slot_of, n_slots


def _dag_stage_shapes(lowered: LoweredChain, bodies: Sequence[Callable],
                      out_dtype: torch.dtype,
                      require_final_block: bool = False,
                      uniforms: Sequence[Tuple[int, ...]] = ()
                      ) -> Tuple[int, ...]:
    """Shape-check every DAG stage by one step on zeros; return the final
    partial's shape.

    Stage ``k``'s body receives one carried block per incoming edge (in
    ``ChainDAG.in_edges`` order), its external stream blocks, then every
    uniform array; every non-final stage must return exactly one policy
    block — the on-chip block its consumers read.
    """
    policy = lowered.policy
    dag = lowered.chained
    shape: Tuple[int, ...] = ()
    for k, stage in enumerate(lowered.stage_in_streams):
        carried = [policy.block_shape for _ in dag.in_edges(k)]
        ins = [s.stream.block_shape for s in stage]
        shape = probe_part_shape(bodies[k], carried + ins + list(uniforms),
                                 out_dtype)
        must_block = k < len(bodies) - 1 or require_final_block
        if must_block and math.prod(shape) != policy.block_elems:
            what = ("a dag intermediate" if k < len(bodies) - 1
                    else "the map-mode output")
            raise LoweringError(
                f"dag stage {k} body returns shape {shape} "
                f"({math.prod(shape)} elements); {what} "
                f"must fill one {policy.block_shape} VMEM block")
    return shape


def _build_dag_kernel(lowered: LoweredChain, bodies: Sequence[Callable],
                      mode: str, out_dtype: torch.dtype,
                      uniforms: Sequence[Tuple[int, ...]] = ()
                      ) -> StageKernel:
    """Fuse a ChainDAG's stage bodies into ONE kernel.

    Topologically-ordered stages: per grid step each stage reads its carried
    blocks (the values of its incoming edges' producers, this step), its
    stream blocks and the uniforms, and computes; a multi-consumer value is
    produced once and read by every consumer on chip.  The program records
    each product's refcounted scratch slot (:func:`_dag_slots`).
    """
    dag = lowered.chained
    counts, offsets = _stage_offsets(lowered)
    slot_of, n_slots = _dag_slots(dag)
    final = _dag_stage_shapes(lowered, bodies, out_dtype,
                              require_final_block=(mode == "map"),
                              uniforms=uniforms)
    sources = [[("stage", e.producer_stage) for e in dag.in_edges(k)]
               + [("stream", offsets[k] + j) for j in range(counts[k])]
               for k in range(len(bodies))]
    slots = [slot_of[dag.out_edges(k)[0].name] if k < len(bodies) - 1
             else None for k in range(len(bodies))]
    return _stage_kernel(lowered, bodies, sources, mode, out_dtype, final,
                         uniforms, slots, n_slots)


def _check_bodies(nests: Tuple[LoopNest, ...], bodies: Tuple) -> None:
    if len(bodies) != len(nests):
        raise ValueError(
            f"need one body per nest, got {len(bodies)} bodies for "
            f"{len(nests)} nests")


def _prepare_stages(lowered: LoweredChain, key: Any,
                    build: Callable[[], Any], operands: Dict[str, Any], uni,
                    dev: torch.device, bounds: Tuple[int, ...]
                    ) -> PreparedCall:
    """Lay out a chain's or DAG's operands and build (or reuse) its kernel
    under ``key`` + the operand signature: everything up to the launch."""
    flat = lowered.in_streams
    missing = sorted({s.name for s in flat} - set(operands))
    if missing:
        raise ValueError(f"missing operands for streams {missing}")
    arrays = [to_device(operands[s.name], dev) for s in flat]
    key = key + (tuple((tuple(a.shape), a.dtype) for a in arrays),
                 _uniform_sig(uni))
    kernel = _kernel_cache_get(key)
    if kernel is None:
        resilience.inject("compile")
        kernel = build()
        DISPATCH_STATS["builds"] += 1
        _kernel_cache_put(key, kernel)
    layouts = tuple(s.prepare(a) for s, a in zip(flat, arrays))
    return PreparedCall(kernel=kernel, layouts=layouts + tuple(
        a for _, a in uni), lowered=lowered, bounds=tuple(bounds))


def _prepare_chain(nests: Tuple[LoopNest, ...], bodies: Tuple,
                   operands: Dict[str, Any], mode: str,
                   out_dtype: torch.dtype, sched: Schedule,
                   num_lanes: Optional[int], dev: torch.device
                   ) -> PreparedCall:
    chained = _chain_for(nests, num_lanes)
    lowered = _lowered_chain_for(chained, sched)
    return _prepare_stages(
        lowered, ("chain", nests, sched, mode,
                  tuple(_body_key(b) for b in bodies), out_dtype, num_lanes),
        lambda: _build_chain_kernel(lowered, bodies, mode, out_dtype),
        operands, (), dev, chained.bounds)


def _prepare_dag(nests: Tuple[LoopNest, ...], bodies: Tuple,
                 operands: Dict[str, Any], mode: str,
                 out_dtype: torch.dtype, sched: Schedule,
                 num_lanes: Optional[int], dev: torch.device, uni
                 ) -> PreparedCall:
    dag = _dag_for(nests, num_lanes)
    lowered = _lowered_chain_for(dag, sched)
    return _prepare_stages(
        lowered, ("dag", nests, sched, mode,
                  tuple(_body_key(b) for b in bodies), out_dtype, num_lanes),
        lambda: _build_dag_kernel(lowered, bodies, mode, out_dtype,
                                  tuple(tuple(a.shape) for _, a in uni)),
        operands, uni, dev, dag.bounds)


def prepare_chain_call(nests: Sequence[LoopNest],
                       bodies: Sequence[Callable[..., torch.Tensor]],
                       operands: Dict[str, Any], *, mode: str = "map",
                       out_dtype: torch.dtype = torch.float32,
                       schedule: Schedule = DEFAULT_SCHEDULE,
                       num_lanes: Optional[int] = None,
                       device: DeviceLike = None) -> PreparedCall:
    """:func:`ssr_chain_call` up to the launch, under ``schedule``: the
    fused kernel and its operands' layouts."""
    nests, bodies = tuple(nests), tuple(bodies)
    _check_bodies(nests, bodies)
    return _prepare_chain(nests, bodies, operands, mode, out_dtype, schedule,
                          num_lanes, resolve_device(device))


def prepare_dag_call(nests: Sequence[LoopNest],
                     bodies: Sequence[Callable[..., torch.Tensor]],
                     operands: Dict[str, Any], *, mode: str = "map",
                     out_dtype: torch.dtype = torch.float32,
                     schedule: Schedule = DEFAULT_SCHEDULE,
                     num_lanes: Optional[int] = None,
                     device: DeviceLike = None,
                     uniforms: Optional[Dict[str, Any]] = None
                     ) -> PreparedCall:
    """:func:`ssr_dag_call` all-fused, up to the launch, under
    ``schedule`` (whose ``cut_edges`` must be empty): the fused kernel and
    its operands' layouts, uniforms last.  A cut's kernels are those of
    :func:`dag_components`."""
    nests, bodies = tuple(nests), tuple(bodies)
    _check_bodies(nests, bodies)
    if schedule.cut_edges:
        raise LoweringError(
            f"prepare_dag_call runs the DAG all-fused; schedule.cut_edges "
            f"{schedule.cut_edges} asks for one kernel per component")
    dev = resolve_device(device)
    return _prepare_dag(nests, bodies, operands, mode, out_dtype,
                        dataclasses.replace(schedule, cut_edges=None),
                        num_lanes, dev, _uniform_items(uniforms, dev))


def ssr_chain_call(nests: Sequence[LoopNest],
                   bodies: Sequence[Callable[..., torch.Tensor]],
                   operands: Dict[str, Any], *,
                   mode: str = "map",
                   out_dtype: torch.dtype = torch.float32,
                   policy: BlockPolicy = DEFAULT_POLICY,
                   schedule: Optional[Schedule] = None,
                   num_lanes: Optional[int] = None,
                   device: DeviceLike = None) -> torch.Tensor:
    """Execute a producer→consumer chain of nests as ONE kernel.

    ``nests[k]`` and ``nests[k+1]`` must be chainable (see
    :func:`repro_torch.core.compiler.chain`): the producer's WRITE ref
    unifies with the consumer's READ ref over one shared iteration space.
    The intermediates stay on chip — never stored to, or re-loaded from,
    device memory.

    ``bodies[0](*stage0_blocks)`` computes the first intermediate;
    ``bodies[k](carried_block, *stagek_blocks)`` receives the previous
    stage's block first.  ``mode`` applies to the *final* stage, with the
    same contract as :func:`ssr_call`.  Reduce bodies must be
    padding-neutral at every stage.  On the card the kernel is the one of
    ``(mode, tuple of the bodies' ops)`` (:data:`hopper.DEVICE_KERNELS`).

    With no ``schedule`` the autotuner's cache is consulted under the
    stage-0 nest's key, once per problem and :func:`autotune.epoch` as
    :func:`ssr_call` does (the reference probes on every call); a failing
    tuned schedule degrades to the default.
    """
    nests = tuple(nests)
    bodies = tuple(bodies)
    _check_bodies(nests, bodies)
    dev = resolve_device(device)
    return _resolved(
        nests[0], operands, mode, out_dtype, policy, schedule, dev,
        lambda s: _prepare_chain(nests, bodies, operands, mode, out_dtype, s,
                                 num_lanes, dev).run(),
        site="ssr_chain_call")


def _dag_components(dag: ChainDAG,
                    cut: frozenset) -> Tuple[Tuple[int, ...], ...]:
    """Connected stage components over the *non-cut* edges, ordered by
    their maximum stage index — a valid topological order of the
    partition (every cut edge points from one component's exit to a
    higher-indexed stage of a later component)."""
    parent = list(range(len(dag.stages)))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, e in enumerate(dag.edges):
        if i not in cut:
            parent[find(e.producer_stage)] = find(e.consumer_stage)
    groups: Dict[int, list] = {}
    for s in range(len(dag.stages)):
        groups.setdefault(find(s), []).append(s)
    return tuple(sorted((tuple(sorted(g)) for g in groups.values()),
                        key=max))


def _component_exit(dag: ChainDAG, comp: Tuple[int, ...],
                    cut: frozenset) -> int:
    """The component's unique exit stage — the one whose value leaves.

    A value leaves through a cut out-edge or by being the whole DAG's
    final stage; a legal cut gives every component exactly one such stage
    (otherwise more than one buffer would have to exit a single fused
    kernel, which the map/reduce epilogue cannot express).
    """
    inside = set(comp)
    exits = set()
    for i, e in enumerate(dag.edges):
        if i in cut and e.producer_stage in inside:
            exits.add(e.producer_stage)
    if len(dag.stages) - 1 in inside:
        exits.add(len(dag.stages) - 1)
    if len(exits) != 1:
        raise LoweringError(
            f"cut {tuple(sorted(cut))} gives component {comp} exit stages "
            f"{sorted(exits)}; a legal cut leaves each fused component "
            "exactly one stage whose value exits the kernel")
    return exits.pop()


def _reorder_body(body: Callable, callee_names: Sequence[str],
                  want_names: Sequence[str], where: str) -> Callable:
    """Adapt a DAG-convention body to a callee's block-argument order.

    ``callee_names`` is the order the executing kernel passes blocks in;
    ``want_names`` is the order ``body`` expects (incoming-edge blocks in
    ``in_edges`` order, then the stage's external streams in allocation
    order).  Cut edges turn carried blocks into external operand streams,
    so the two orders differ per partition — the adapter permutes by name.
    A :class:`KernelBody` stays one, with its op and the permutation (its
    kernel permutes its stream pointers); trailing uniforms pass through
    unpermuted.
    """
    pos = {nm: i for i, nm in enumerate(callee_names)}
    missing = [nm for nm in want_names if nm not in pos]
    if missing or len(callee_names) != len(want_names):
        raise LoweringError(
            f"{where}: body expects blocks {list(want_names)} but the "
            f"partitioned kernel streams {list(callee_names)}")
    perm = tuple(pos[nm] for nm in want_names)
    if perm == tuple(range(len(perm))):
        return body
    if isinstance(body, KernelBody):
        return body.reordered(perm)
    return lambda *blocks, _b=body, _p=perm: _b(
        *(blocks[i] for i in _p), *blocks[len(_p):])


def _stage_arg_names(dag: ChainDAG, k: int) -> list:
    """Stage ``k``'s body-argument names in the fused-DAG convention."""
    return ([e.name for e in dag.in_edges(k)]
            + [a.ref.name for a in dag.stages[k].allocations])


@dataclasses.dataclass(frozen=True)
class DagComponent:
    """One kernel of a DAG run under a cut: its stages, the mode of its
    epilogue, the intermediate it exports (``None`` for the final one), and
    its nests and bodies, reordered to the kernel's block order.  A single
    stage runs as an :func:`ssr_call`, several as an :func:`ssr_dag_call`.
    """

    stages: Tuple[int, ...]
    mode: str
    exported: Optional[str]
    nests: Tuple[LoopNest, ...]
    bodies: Tuple[Callable, ...]


def dag_components(dag: ChainDAG, nests: Tuple[LoopNest, ...],
                   bodies: Tuple[Callable, ...], cut: Sequence[int], *,
                   mode: str, num_lanes: Optional[int] = None,
                   schedule: Schedule = DEFAULT_SCHEDULE
                   ) -> Tuple[DagComponent, ...]:
    """The kernels a DAG runs as under ``cut``, in topological order."""
    cutset = frozenset(int(i) for i in cut)
    for i in cutset:
        if not 0 <= i < len(dag.edges):
            raise LoweringError(
                f"schedule.cut_edges index {i} is out of range for a dag "
                f"with {len(dag.edges)} edges")
    sub_sched = _sub_schedule(schedule)
    n = len(nests)
    out = []
    for comp in _dag_components(dag, cutset):
        exit_stage = _component_exit(dag, comp, cutset)
        final = (n - 1) in comp
        exported = None if final else dag.out_edges(exit_stage)[0].name
        sub_nests = []
        for s in comp:
            nest = nests[s]
            if exported is not None and s == exit_stage:
                refs = tuple(r for r in nest.refs
                             if not (r.kind == Direction.WRITE
                                     and r.name == exported))
                nest = dataclasses.replace(nest, refs=refs)
            sub_nests.append(nest)
        if len(comp) == 1:
            s = comp[0]
            lanes = nest_analysis.auto_lanes(sub_nests[0], num_lanes)
            lowered = _lowered_for(_plan_for(sub_nests[0], lanes), sub_sched,
                                   False)
            sub_bodies = [_reorder_body(
                bodies[s], [st.name for st in lowered.in_streams],
                _stage_arg_names(dag, s), f"dag stage {s}")]
        else:
            sub_dag = _dag_for(tuple(sub_nests), num_lanes)
            lowered = _lowered_chain_for(sub_dag, sub_sched)
            sub_bodies = []
            for j, s in enumerate(comp):
                callee = ([e.name for e in sub_dag.in_edges(j)]
                          + [st.name for st in lowered.stage_in_streams[j]])
                sub_bodies.append(_reorder_body(
                    bodies[s], callee, _stage_arg_names(dag, s),
                    f"dag stage {s}"))
        out.append(DagComponent(comp, mode if final else "map", exported,
                                tuple(sub_nests), tuple(sub_bodies)))
    return tuple(out)


def _sub_schedule(sched: Schedule) -> Schedule:
    """A component's schedule: the committed geometry and depth carry
    over, the partition fields do not (sub-calls are separate kernels with
    their own stream counts)."""
    return dataclasses.replace(sched, cut_edges=None, stream_depths=None)


def component_kernel(comp: DagComponent, *, out_dtype: torch.dtype,
                     num_lanes: Optional[int] = None,
                     schedule: Schedule = DEFAULT_SCHEDULE,
                     uniforms: Sequence[Tuple[int, ...]] = ()) -> SsrKernel:
    """The kernel one component of a cut builds (no operands needed)."""
    sched = _sub_schedule(schedule)
    if len(comp.stages) == 1:
        nest = comp.nests[0]
        lanes = nest_analysis.auto_lanes(nest, num_lanes)
        return build_kernel(_lowered_for(_plan_for(nest, lanes), sched,
                                         False),
                            comp.bodies[0], comp.mode, out_dtype, uniforms)
    lowered = _lowered_chain_for(_dag_for(comp.nests, num_lanes), sched)
    return _build_dag_kernel(lowered, comp.bodies, comp.mode, out_dtype,
                             uniforms)


def _dag_partition_call(dag: ChainDAG, nests: Tuple[LoopNest, ...],
                        bodies: Tuple[Callable, ...],
                        operands: Dict[str, Any], sched: Schedule, *,
                        mode: str, out_dtype: torch.dtype,
                        num_lanes: Optional[int], dev: torch.device,
                        uniforms: Optional[Dict[str, Any]] = None
                        ) -> torch.Tensor:
    """Execute a ChainDAG under a committed cut: one kernel per component.

    Each cut edge materialises its intermediate as a flat array in device
    memory (a map-mode output) that downstream components stream back in as
    a plain dense operand; within a component the DAG fuses as usual.
    Components run in topological order, so by the time one launches every
    cut value it reads already exists.
    """
    sub_sched = _sub_schedule(sched)
    env = dict(operands)
    result: Optional[torch.Tensor] = None
    for comp in dag_components(dag, nests, bodies, sched.cut_edges or (),
                               mode=mode, num_lanes=num_lanes,
                               schedule=sched):
        if len(comp.stages) == 1:
            result = ssr_call(comp.nests[0], comp.bodies[0], env,
                              mode=comp.mode, out_dtype=out_dtype,
                              schedule=sub_sched, num_lanes=num_lanes,
                              device=dev, uniforms=uniforms)
        else:
            result = ssr_dag_call(comp.nests, comp.bodies, env,
                                  mode=comp.mode, out_dtype=out_dtype,
                                  schedule=sub_sched, num_lanes=num_lanes,
                                  device=dev, uniforms=uniforms)
        if comp.exported is not None:
            env[comp.exported] = result
    assert result is not None
    return result


#: ``ssr_dag_call``'s resolved schedules, as :data:`_resolved_schedules`
#: is ``ssr_call``'s: (epoch, nests, operand and uniform signatures, mode,
#: output dtype, device) → (schedule, tuned key or None).
_resolved_dag_schedules: Dict[Any, Tuple[Schedule, Optional[str]]] = {}


def _tuned_dag_schedule(nests: Tuple[LoopNest, ...],
                        operands: Dict[str, Any], uni, mode: str,
                        out_dtype: torch.dtype, dev: torch.device
                        ) -> Tuple[Schedule, Optional[str]]:
    """(schedule, tuned key) of a DAG from the autotuner's cache, memoised
    per epoch; the key is None when the schedule is the default."""
    from . import autotune

    uniforms = dict(uni)
    memo = (autotune.epoch(), nests,
            tuple((k, tuple(v.shape), v.dtype)
                  for k, v in sorted(operands.items())),
            _uniform_sig(uni), mode, out_dtype, dev)
    hit = _resolved_dag_schedules.get(memo)
    if hit is not None:
        return hit
    try:
        schedule = autotune.lookup_dag(nests, operands, mode=mode,
                                       out_dtype=out_dtype,
                                       uniforms=uniforms, device=dev)
    except resilience.fallback_error_types() as e:
        _record_fallback("ssr_dag_call", e, from_schedule="tuned-lookup",
                         to_schedule="default")
        return DEFAULT_SCHEDULE, None     # not memoised: the next call retries
    key = None if schedule == DEFAULT_SCHEDULE else autotune.dag_cache_key(
        nests, operands, mode=mode, out_dtype=out_dtype, uniforms=uniforms,
        device=dev)
    if len(_resolved_dag_schedules) >= CACHE_MAX:
        _resolved_dag_schedules.clear()
    _resolved_dag_schedules[memo] = (schedule, key)
    return schedule, key


def ssr_dag_call(nests: Sequence[LoopNest],
                 bodies: Sequence[Callable[..., torch.Tensor]],
                 operands: Dict[str, Any], *,
                 mode: str = "map",
                 out_dtype: torch.dtype = torch.float32,
                 policy: BlockPolicy = DEFAULT_POLICY,
                 schedule: Optional[Schedule] = None,
                 num_lanes: Optional[int] = None,
                 device: DeviceLike = None,
                 uniforms: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Execute a DAG of nests — diamonds included — as ONE kernel.

    Dataflow is discovered by name (see
    :func:`repro_torch.core.compiler.chain_dag`): a ref WRITTEN by stage p
    and READ by any later stages becomes on-chip edges; one producer may
    feed several consumers.

    ``bodies[k]`` receives stage ``k``'s *incoming-edge blocks first* (in
    ``ChainDAG.in_edges`` order), then its external stream blocks in
    allocation order, then every ``uniforms`` array (in dict order) —
    whole arrays such as MLP weights, one loop-invariant block each,
    appended to EVERY stage body's arguments.  ``mode`` applies to the
    final stage with the :func:`ssr_call` contract.  On the card the kernel
    is the one of ``(mode, tuple of the bodies' ops)``.

    **Transparent partitioning**: with no ``schedule`` (and the default
    ``policy``) the autotuner's cache is consulted under the DAG's own key
    (:func:`autotune.lookup_dag`), once per problem and
    :func:`autotune.epoch` (the reference probes on every call); a committed
    ``Schedule.cut_edges`` splits the graph into one kernel per component,
    each cut intermediate through device memory, and ``()`` runs the same
    kernel as ``None``.  A failing tuned schedule is quarantined
    (:func:`autotune.quarantine_dag`) and the call runs all-fused.
    """
    nests = tuple(nests)
    bodies = tuple(bodies)
    _check_bodies(nests, bodies)
    dev = resolve_device(device)
    dag = _dag_for(nests, num_lanes)
    uni = _uniform_items(uniforms, dev)
    if uni:
        clash = sorted({nm for nm, _ in uni} & set(operands))
        if clash:
            raise ValueError(
                f"uniform names {clash} collide with streamed operands; "
                "uniforms are a separate argument namespace")
    tuned_key: Optional[str] = None
    if schedule is None and policy is DEFAULT_POLICY:
        schedule, tuned_key = _tuned_dag_schedule(nests, operands, uni, mode,
                                                  out_dtype, dev)

    def attempt(resolved: Schedule) -> torch.Tensor:
        sched = resolved
        if sched.cut_edges:
            return _dag_partition_call(dag, nests, bodies, operands, sched,
                                       mode=mode, out_dtype=out_dtype,
                                       num_lanes=num_lanes, dev=dev,
                                       uniforms=dict(uni))
        if sched.cut_edges is not None:  # () — all-fused, same kernel as None
            sched = dataclasses.replace(sched, cut_edges=None)
        DISPATCH_STATS["calls"] += 1
        return _prepare_dag(nests, bodies, operands, mode, out_dtype, sched,
                            num_lanes, dev, uni).run()

    sched = _resolve_schedule(policy, schedule)
    if tuned_key is None:
        return attempt(sched)
    try:
        return attempt(sched)
    except resilience.fallback_error_types() as e:
        from . import autotune

        autotune.global_cache().quarantine(tuned_key)
        _record_fallback("ssr_dag_call", e, from_schedule="tuned",
                         to_schedule="default", key=tuned_key,
                         counter="degraded")
        return attempt(DEFAULT_SCHEDULE)
