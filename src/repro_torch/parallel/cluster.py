"""Cluster execution layer: streamed kernels sharded across C cores.

The paper's multi-core results (§5.3–§5.5, Fig. 10/11) run the SSR kernels
on an 8-core RISC-V cluster sharing one TCDM: each core streams its tile of
the iteration space, and reductions finish through the shared memory and a
hardware barrier.  ``repro.parallel.cluster`` runs that cluster on a JAX
device mesh; this module runs it on one CUDA device (or the CPU):

* a **core** is one shard of the outermost loop level.  Every shard runs
  the port's single-core path (:func:`~repro_torch.core.lowering.ssr_call`
  / :func:`~repro_torch.core.lowering.ssr_chain_call`) on its tile, in core
  order on the caller's stream.  ``mesh`` is an optional sequence of
  ``cores`` torch devices, one a core; with none, every core runs on the
  call's device;
* a core's operand is a **view** of rows ``[c·t, (c+1)·t)`` of the
  operand reshaped to its stream's logical shape (:func:`_shard_layout`);
  a ref with coefficient 0 on the split level (GEMV's x) is passed to
  every core as it is — the TCDM broadcast;
* the **shared-TCDM combine** of a reduction is one fixed-order sum of the
  per-core partials, core 0 first, inside the profiler range
  :data:`COMBINE_RANGE` — the only op that reads more than one core's
  output.  Map-mode tiles concatenate along the split level, which
  :func:`repro_torch.launch.audit.check_cluster_locality` audits.

``cores=1`` degenerates to the plain single-core call, bit-identical to
``ssr_call``.  Unlike the reference, which needs one device a core and
raises :class:`ClusterError` without them, ``cores > 1`` runs on one
device.  The matching cost model is
:func:`repro_torch.core.compiler.cluster_cost`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import DeviceLike, resolve_device, to_device
from ..core import autotune, resilience
from ..core.compiler import LoopNest, MemRef
from ..core.lowering import (CACHE_MAX, DEFAULT_POLICY, DEFAULT_SCHEDULE,
                             BlockPolicy, Schedule, _record_fallback,
                             ssr_call, ssr_chain_call)
from ..core.stream import Direction


class ClusterError(ValueError):
    """The nest/operands cannot be partitioned across the requested cores."""


CORES_AXIS = "cores"

#: The profiler range around a reduction's combine, and nothing else.
COMBINE_RANGE = "cluster.all-reduce"

#: Provenance of the most recent ``cluster_call``/``cluster_chain_call``:
#: the per-core schedule dispatched (tuned or default), the core count and
#: the per-core tile bounds.  Callers ``clear()`` it before the call they
#: want attributed.
LAST_DISPATCH: Dict[str, object] = {}

#: The cluster scopes now open, innermost last: ``("core", c)`` while core
#: c runs its tile, ``("combine", None)`` and ``("assemble", None)`` while
#: the partials or tiles meet.  The locality audit reads it.
SCOPES: List[Tuple[str, Optional[int]]] = []


@contextlib.contextmanager
def _scope(kind: str, core: Optional[int] = None):
    SCOPES.append((kind, core))
    try:
        if kind == "combine":
            with torch.profiler.record_function(COMBINE_RANGE):
                yield
        else:
            yield
    finally:
        SCOPES.pop()


def _record_dispatch(schedule: Optional[Schedule], cores: int,
                     bounds: Tuple[int, ...],
                     policy: BlockPolicy = DEFAULT_POLICY) -> None:
    # `tuned` means "came from the autotuner, not the default geometry":
    # an explicitly pinned DEFAULT_SCHEDULE (or a legacy policy=) is still
    # an untuned dispatch
    if schedule is None:
        effective = DEFAULT_SCHEDULE if policy is DEFAULT_POLICY \
            else Schedule.from_policy(policy)
    else:
        effective = schedule
    LAST_DISPATCH.update(
        schedule=effective,
        tuned=schedule is not None and schedule != DEFAULT_SCHEDULE,
        cores=cores, tile_bounds=tuple(bounds))


def _core_devices(cores: int, mesh: Optional[Sequence[DeviceLike]],
                  dev: Optional[torch.device]
                  ) -> Tuple[Optional[torch.device], ...]:
    """The device of each core: ``mesh``'s, else ``dev`` for every core."""
    if mesh is None:
        return (dev,) * cores
    mesh = tuple(mesh)
    if len(mesh) != cores:
        raise ClusterError(
            f"mesh of {len(mesh)} devices does not provide a "
            f"'{CORES_AXIS}' axis of size {cores}")
    return tuple(resolve_device(d) for d in mesh)


def _on(t: torch.Tensor, dev: Optional[torch.device]) -> torch.Tensor:
    return t if dev is None else to_device(t, dev)


def pad_to_cores(arrays: Sequence[torch.Tensor],
                 cores: int) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """Zero-pad 1-D operands so ``cores`` divides their length.

    The kernel-wrapper companion to :func:`cluster_call`'s divisibility
    requirement: returns the padded tensors and the padded length; where
    ``cores`` divides the length already, the tensors themselves.  Only
    valid where zero padding is semantics-neutral — sum-like reductions
    (pad contributes 0) and maps whose tail the caller trims.
    """
    n = arrays[0].shape[0]
    pad = (-n) % cores
    if pad:
        arrays = [F.pad(a, (0, pad)) for a in arrays]
    return tuple(arrays), n + pad


def _split_level0(nest: LoopNest, cores: int) -> LoopNest:
    """The per-core tile: the outermost level split ``cores`` ways."""
    b0 = nest.bounds[0]
    if b0 % cores:
        raise ClusterError(
            f"outer bound {b0} not divisible by {cores} cores; pad the "
            "iteration space (zero padding is reduce-neutral) or pick a "
            "divisor core count")
    return dataclasses.replace(
        nest, bounds=(b0 // cores,) + nest.bounds[1:])


def _operand_ref(nests: Sequence[LoopNest],
                 name: str) -> Tuple[MemRef, LoopNest]:
    """The read ref named ``name`` and the nest that owns it."""
    for nest in nests:
        for ref in nest.refs:
            if ref.name == name and ref.kind == Direction.READ:
                return ref, nest
    raise ClusterError(f"operand {name!r} matches no read ref in the nest(s)")


def _shard_layout(ref: MemRef,
                  nest: LoopNest) -> Optional[Tuple[int, ...]]:
    """Logical shape to shard on dim 0, or ``None`` to replicate.

    A ref varying with the outermost level is partitioned with it: because
    lowering requires dense row-major layout over the varying levels, core
    ``c``'s tile is exactly rows ``[c·t, (c+1)·t)`` of the logical array.
    A ref with coefficient 0 at the split level (repeat/loop-invariant
    streams, e.g. GEMV's x) is replicated — every core streams it whole,
    the TCDM-broadcast of the paper's cluster.
    """
    if ref.coeffs is None:
        raise ClusterError(
            f"ref {ref.name!r} is not affine; it cannot be streamed, let "
            "alone sharded")
    if ref.coeffs[0] == 0:
        return None
    if ref.offset:
        raise ClusterError(
            f"ref {ref.name!r}: base offset {ref.offset} cannot be "
            "partitioned on the outer level")
    return tuple(b for b, c in zip(nest.bounds, ref.coeffs) if c != 0)


def _prepare_operands(nests: Sequence[LoopNest],
                      operands: Dict[str, torch.Tensor]):
    """(names, each operand reshaped to its logical layout, each one's
    split dim: 0, or ``None`` for a replicated operand), names sorted."""
    names = sorted(operands)
    prepared, dims = [], []
    for name in names:
        ref, owner = _operand_ref(nests, name)
        layout = _shard_layout(ref, owner)
        arr = operands[name]
        if layout is None:
            prepared.append(arr)
            dims.append(None)
            continue
        # layout[0] is the outer bound; callers run _split_level0 first,
        # which guarantees `cores` divides it
        try:
            view = arr.reshape(layout)
        except RuntimeError as e:    # torch raises RuntimeError on a bad
            raise ClusterError(      # reshape
                f"operand {name!r} has {arr.numel()} elements, its stream "
                f"walks {layout}") from e
        prepared.append(view)
        dims.append(0)
    return names, tuple(prepared), tuple(dims)


def _validate(cores: int, mode: str) -> None:
    if cores < 1:
        raise ClusterError(f"cores must be >= 1, got {cores}")
    if mode not in ("reduce", "map"):
        raise ClusterError(f"unknown cluster mode {mode!r}")


def _shard_operand_sig(nests: Sequence[LoopNest],
                       operands: Dict[str, torch.Tensor],
                       cores: int) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Per-shard (shape, dtype name) of every operand — what one core
    streams.

    Sharded refs (nonzero outer coefficient) split their leading logical
    dim C ways; replicated refs keep their global shape.  This is the
    schedule-cache identity of the *per-core tile*, so a winner tuned for
    the tile size is found regardless of the cluster-global shapes.
    """
    sig: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for name, arr in operands.items():
        ref, owner = _operand_ref(nests, name)
        layout = _shard_layout(ref, owner)
        dtype = autotune.dtype_name(arr.dtype)
        if layout is None:
            sig[name] = (tuple(arr.shape), dtype)
        else:
            sig[name] = ((layout[0] // cores,) + tuple(layout[1:]), dtype)
    return sig


#: The lookups resolved: (epoch, nest, operand signature, mode, output
#: dtype, device) → schedule or None.  Keyed on :func:`autotune.epoch`, as
#: ``ssr_call``'s are, so a commit in this process is seen on the next call
#: (the reference probes the cache on every call).
_RESOLVED: Dict[tuple, Optional[Schedule]] = {}


def _signature(operands) -> tuple:
    """Sorted (name, shape, dtype name) of tensors or (shape, dtype)
    pairs."""
    sig = []
    for name in sorted(operands):
        v = operands[name]
        shape, dtype = (v.shape, v.dtype) if hasattr(v, "dtype") else v
        sig.append((name, tuple(shape), autotune.dtype_name(dtype)))
    return tuple(sig)


def _safe_lookup(nest: LoopNest, operands, *, mode: str, out_dtype,
                 site: str, device: DeviceLike = None) -> Optional[Schedule]:
    """Cache lookup, keyed on ``device`` and resolved once per problem and
    epoch, that degrades to the default on typed dispatch faults.

    A broken cache must cost the cluster layer its tuned geometry, never
    the call: cache I/O errors and injected faults are recorded (one
    ``fallbacks`` tick + a :class:`~repro_torch.core.resilience.
    FallbackEvent`) and resolve to ``None`` — the default per-core
    schedule — unremembered, so the next call looks again.  Returns
    ``None`` too on an ordinary miss.
    """
    out = autotune.dtype_name(out_dtype)
    memo = (autotune.epoch(), nest, _signature(operands), mode, out, device)
    if memo in _RESOLVED:
        return _RESOLVED[memo]
    try:
        sched = autotune.lookup(nest, operands, mode=mode, out_dtype=out,
                                device=device)
    except resilience.fallback_error_types() as e:
        _record_fallback(site, e, from_schedule="tuned-lookup",
                         to_schedule="default")
        return None
    if len(_RESOLVED) >= CACHE_MAX:
        _RESOLVED.clear()
    _RESOLVED[memo] = None if sched == DEFAULT_SCHEDULE else sched
    return _RESOLVED[memo]


def _core_schedule(subs: Sequence[LoopNest],
                   operands: Dict[str, torch.Tensor], *, mode: str,
                   out_dtype, device: DeviceLike = None
                   ) -> Optional[Schedule]:
    """The tuned schedule for one core's tile on ``device``, or ``None``
    (default).

    The per-core tile is a single-core problem of the *sharded* bounds, so
    the lookup keys on the sub-nest + per-shard operand shapes with
    ``cores=1`` — what the tuner commits when it tunes that problem size.
    The signature holds no tensor, so the device is passed to the key.
    """
    try:
        sig = _shard_operand_sig(subs, operands, 1)  # subs are already split
    except ClusterError:
        return None
    # A chain keys on its stage-0 sub-nest; the operand signature (which
    # spans every stage) disambiguates chains sharing a producer shape.
    return _safe_lookup(subs[0], sig, mode=mode, out_dtype=out_dtype,
                        site="cluster:_core_schedule", device=device)


def _combine(parts: Sequence, dev: Optional[torch.device]):
    """The shared-TCDM combine: one fixed-order sum of the partials, core 0
    first, leaf by leaf for a tuple of them."""
    with _scope("combine"):
        if isinstance(parts[0], (tuple, list)):
            return type(parts[0])(_fold([p[i] for p in parts], dev)
                                  for i in range(len(parts[0])))
        return _fold(parts, dev)


def _fold(parts: Sequence[torch.Tensor],
          dev: Optional[torch.device]) -> torch.Tensor:
    acc = _on(parts[0], dev)
    for p in parts[1:]:
        acc = acc + _on(p, dev)
    return acc


def _assemble(tiles: Sequence[torch.Tensor], dim: int,
              dev: Optional[torch.device]) -> torch.Tensor:
    """The tiles concatenated along ``dim`` (no communication)."""
    with _scope("assemble"):
        return torch.cat([_on(t, dev) for t in tiles], dim=dim)


def _sharded_call(nests: Sequence[LoopNest], tile_fn: Callable,
                  operands: Dict[str, torch.Tensor], *, cores: int,
                  mode: str, mesh, dev: torch.device) -> torch.Tensor:
    """Shared scaffolding of the two clustered entry points.

    ``tile_fn(ops, device)`` runs one core's tile from its per-shard
    operand dict (views of ``operands``) on that core's device; reduces
    finish with the one combine, maps concatenate tiles along the split
    level.
    """
    names, prepared, dims = _prepare_operands(
        nests, {k: to_device(v, dev) for k, v in operands.items()})
    devs = _core_devices(cores, mesh, dev)
    outs = []
    for c, dev_c in enumerate(devs):
        ops = {}
        for name, arr, dim in zip(names, prepared, dims):
            if dim is not None:
                t = arr.shape[dim] // cores
                arr = arr.narrow(dim, c * t, t)
            ops[name] = _on(arr, dev_c)
        with _scope("core", c):
            outs.append(tile_fn(ops, dev_c))
    if mode == "reduce":
        return _combine(outs, dev)
    return _assemble(outs, 0, dev)


def cluster_call(nest: LoopNest, body: Callable[..., torch.Tensor],
                 operands: Dict[str, torch.Tensor], *,
                 cores: int,
                 mode: str = "reduce",
                 out_dtype: torch.dtype = torch.float32,
                 policy: BlockPolicy = DEFAULT_POLICY,
                 schedule: Optional[Schedule] = None,
                 num_lanes: Optional[int] = None,
                 device: DeviceLike = None,
                 mesh: Optional[Sequence[DeviceLike]] = None
                 ) -> torch.Tensor:
    """Execute a :class:`LoopNest` sharded across C cores.

    Same contract as :func:`~repro_torch.core.lowering.ssr_call` plus
    ``cores``: the outermost loop level is split C ways, each core runs the
    single-core streamed kernel on its tile (on the card, the Hopper kernel
    of the body's op), and

    * ``mode="reduce"`` — per-core partials combine in one fixed-order sum
      (the shared-TCDM reduction);
    * ``mode="map"`` — per-core output tiles concatenate along the split
      level; no combine at all.

    ``cores=1`` is ``ssr_call`` itself, bit-identical.  Reduce bodies must
    be padding-neutral *and* tolerate the level-0 split (sum-like
    reductions are; order-sensitive folds are not).

    ``schedule=None`` resolves the **per-core tile's** schedule from the
    autotuner's cache on the call's device: the tile is a single-core
    problem of the *sharded* bounds.
    """
    _validate(cores, mode)
    dev = resolve_device(device)
    if cores == 1:
        if schedule is None and policy is DEFAULT_POLICY:
            # the resolution ssr_call/NestKernel perform (under the same
            # guard: an explicit non-default policy pins the geometry), so
            # `cores=1` stays bit-identical to the single-core registry
            # path even after a tuner commit
            schedule = _safe_lookup(nest, operands, mode=mode,
                                    out_dtype=out_dtype, site="cluster_call",
                                    device=dev)
        _record_dispatch(schedule, 1, nest.bounds, policy)
        return ssr_call(nest, body, operands, mode=mode, out_dtype=out_dtype,
                        policy=policy, schedule=schedule,
                        num_lanes=num_lanes, device=dev)
    sub = _split_level0(nest, cores)
    if schedule is None and policy is DEFAULT_POLICY:
        schedule = _core_schedule([sub], operands, mode=mode,
                                  out_dtype=out_dtype, device=dev)
    _record_dispatch(schedule, cores, sub.bounds, policy)
    return _sharded_call(
        [nest],
        lambda ops, d: ssr_call(sub, body, ops, mode=mode,
                                out_dtype=out_dtype, policy=policy,
                                schedule=schedule, num_lanes=num_lanes,
                                device=d),
        operands, cores=cores, mode=mode, mesh=mesh, dev=dev)


def cluster_chain_call(nests: Sequence[LoopNest],
                       bodies: Sequence[Callable[..., torch.Tensor]],
                       operands: Dict[str, torch.Tensor], *,
                       cores: int,
                       mode: str = "reduce",
                       out_dtype: torch.dtype = torch.float32,
                       policy: BlockPolicy = DEFAULT_POLICY,
                       schedule: Optional[Schedule] = None,
                       num_lanes: Optional[int] = None,
                       device: DeviceLike = None,
                       mesh: Optional[Sequence[DeviceLike]] = None
                       ) -> torch.Tensor:
    """Execute a producer→consumer chain sharded across C cores.

    Each core runs the whole fused chain (ONE kernel — see
    :func:`~repro_torch.core.lowering.ssr_chain_call`; on the card K5) on
    its tile of the shared iteration space, so the chained intermediates
    stay on that core's chip memory: chaining composes with clustering
    because the link walk is dense row-major, hence splits cleanly on the
    outer level.  Only the final reduce (if any) crosses cores, in the one
    combine.
    """
    nests = tuple(nests)
    _validate(cores, mode)
    dev = resolve_device(device)
    if cores == 1:
        if schedule is None and policy is DEFAULT_POLICY:
            # mirror ssr_chain_call's resolution (stage-0 nest + full
            # operand signature, same default-policy guard) so the
            # recorded provenance is the schedule the delegated call runs
            schedule = _safe_lookup(nests[0], operands, mode=mode,
                                    out_dtype=out_dtype,
                                    site="cluster_chain_call", device=dev)
        _record_dispatch(schedule, 1, nests[0].bounds, policy)
        return ssr_chain_call(nests, bodies, operands, mode=mode,
                              out_dtype=out_dtype, policy=policy,
                              schedule=schedule, num_lanes=num_lanes,
                              device=dev)
    subs = tuple(_split_level0(n, cores) for n in nests)
    if schedule is None and policy is DEFAULT_POLICY:
        schedule = _core_schedule(subs, operands, mode=mode,
                                  out_dtype=out_dtype, device=dev)
    _record_dispatch(schedule, cores, subs[0].bounds, policy)
    return _sharded_call(
        nests,
        lambda ops, d: ssr_chain_call(subs, bodies, ops, mode=mode,
                                      out_dtype=out_dtype, policy=policy,
                                      schedule=schedule, num_lanes=num_lanes,
                                      device=d),
        operands, cores=cores, mode=mode, mesh=mesh, dev=dev)


def factor_cores(cores: int) -> Tuple[int, int]:
    """Closest-to-square (rows, cols) factorisation of a core count.

    The 2-D work split of :func:`cluster_kernel2d`: 8 → (4, 2), 4 → (2, 2),
    6 → (3, 2); a prime count degenerates to a 1-D row split (p, 1).
    """
    if cores < 1:
        raise ClusterError(f"cores must be >= 1, got {cores}")
    c = int(cores ** 0.5)
    while cores % c:
        c -= 1
    return cores // c, c


def _check_args(args: tuple, in_dims: Sequence, cores: int) -> None:
    if cores < 1:
        raise ClusterError(f"cores must be >= 1, got {cores}")
    if len(in_dims) != len(args):
        raise ClusterError(
            f"in_dims has {len(in_dims)} entries for {len(args)} args")


def _split_extent(a: torch.Tensor, dim: int, extent: int,
                  axis: Optional[str] = None) -> int:
    if a.shape[dim] % extent:
        raise ClusterError(
            f"arg dim {dim} extent {a.shape[dim]} not divisible by "
            f"{extent}{f' ({axis})' if axis else ''} cores")
    return a.shape[dim] // extent


def cluster_kernel2d(fn: Callable, args: Sequence[torch.Tensor], *,
                     cores: int,
                     in_dims: Sequence[Tuple[Optional[int], Optional[int]]],
                     out_dims: Tuple[int, int] = (0, 1),
                     mesh: Optional[Sequence[DeviceLike]] = None):
    """Shard a registry kernel across a 2-D (rows × cols) core grid.

    The §5.3 cluster with *two* partitioned levels — GEMM's row×col split:
    ``cores`` factors into a (Cr, Cc) grid (:func:`factor_cores`),
    ``in_dims[i] = (row_dim, col_dim)`` names which dim of ``args[i]``
    shards along each axis (``None`` = replicated on that axis), and every
    core, ``r·Cc + c`` in row-major order, runs the unchanged kernel on
    its views.  The output tiles concatenate along ``out_dims``: each row
    of the grid along ``out_dims[1]`` (where Cc > 1), then the rows along
    ``out_dims[0]`` — no combine, because each core owns a disjoint output
    tile (the contraction, if any, stays core-local).
    """
    args = tuple(args)
    _check_args(args, in_dims, cores)
    if cores == 1:
        return fn(*args)
    cr, cc = factor_cores(cores)
    devs = _core_devices(cores, mesh, None)
    for a, dims in zip(args, in_dims):
        for dim, axis, n in zip(dims, ("rows", "cols"), (cr, cc)):
            if dim is not None:
                _split_extent(a, dim, n, axis)
    grid = []
    for r in range(cr):
        row = []
        for c in range(cc):
            core = r * cc + c
            shard = []
            for a, dims in zip(args, in_dims):
                for dim, i, n in zip(dims, (r, c), (cr, cc)):
                    if dim is not None:
                        t = a.shape[dim] // n
                        a = a.narrow(dim, i * t, t)
                shard.append(_on(a, devs[core]))
            with _scope("core", core):
                row.append(fn(*shard))
        grid.append(row)
    dev = devs[0]
    with _scope("assemble"):
        rows = [row[0] if cc == 1 else
                torch.cat([_on(t, dev) for t in row], dim=out_dims[1])
                for row in grid]
        return torch.cat([_on(t, dev) for t in rows], dim=out_dims[0])


def cluster_kernel(fn: Callable, args: Sequence[torch.Tensor], *,
                   cores: int,
                   in_dims: Sequence[Optional[int]],
                   out_dim: Optional[int] = None,
                   reduce: bool = False,
                   mesh: Optional[Sequence[DeviceLike]] = None):
    """Shard an existing registry kernel (not a nest) across C cores.

    For kernels whose iteration structure is neither a pure map nor a full
    reduction (e.g. GEMV: a reduction *per row*), the nest-level
    :func:`cluster_call` does not apply, but the work still splits on an
    output dimension.  ``in_dims[i]`` names the dim of ``args[i]`` to shard
    (``None`` = replicate, the repeat-stream operands); core c runs the
    unchanged kernel on its view of it.  ``reduce=True`` combines the
    outputs (leaf by leaf for a tuple); otherwise ``out_dim`` is the
    concatenation dim.
    """
    args = tuple(args)
    _check_args(args, in_dims, cores)
    if not reduce and out_dim is None:
        raise ClusterError("need out_dim (concat) or reduce=True (psum)")
    if cores == 1:
        return fn(*args)
    tiles = [None if dim is None else _split_extent(a, dim, cores)
             for a, dim in zip(args, in_dims)]
    devs = _core_devices(cores, mesh, None)
    outs = []
    for c, dev_c in enumerate(devs):
        shard = [_on(a if dim is None else a.narrow(dim, c * t, t), dev_c)
                 for a, dim, t in zip(args, in_dims, tiles)]
        with _scope("core", c):
            outs.append(fn(*shard))
    if reduce:
        return _combine(outs, devs[0])
    return _assemble(outs, out_dim, devs[0])
