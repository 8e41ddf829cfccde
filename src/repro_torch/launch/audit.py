"""Audits of what a program leaves in device memory.

The counterpart of the audit half of ``repro.launch.hlo_analysis``.  The
reference compiles a program and reads its HLO; here the program runs once
and the census comes from what ran.

Cluster locality (``LocalityCheck``, ``check_cluster_locality``): do
per-core intermediates stay core-local?  The call runs under
``torch.profiler`` and the counts come from its trace:

* ``"all-reduce"`` counts the combine's ranges
  (:data:`repro_torch.parallel.cluster.COMBINE_RANGE`), the one place a
  reduction's per-core partials meet;
* every other op that reads a core's output anywhere but inside that core,
  the combine or a map's assembly — a second sum of the partials, a copy of
  one, a core reading another core's tile — leaks it off core.  While the
  call runs, a dispatch mode follows each storage back to the core that
  wrote it and wraps such an op in a ``cluster.leak::<op>`` range; the
  leak is counted under the op's name.  View ops read nothing and are not
  counted.

Fusion (``FusionCheck``, ``check_fusion``, ``DagFusionCheck``,
``check_dag_fusion``): is a fused chain's or DAG's intermediate buffer
gone?  Each program runs once (after a warm-up call) under a dispatch mode
that takes the reference's census of its outputs: the op outputs whose
dtype and shape are the intermediate's (the reference's
``count_materialized``: materialisations of the exact padded type), and
the bytes of all op outputs (its ``bytes_out`` proxy).  An op counts where
it writes what it returns; a view writes nothing.  On a CUDA device the
device activities (kernels, copies, fills) of the same run are counted
too, from ``torch.profiler``.  On the CPU the fused programs run as the
plain block walk, so their intermediates are block-sized there.

The HLO text parser (``parse_computations``, ``analyze_hlo``,
``collective_counts``) is ``launch/hlo_analysis.py``, which also gives
these audits under the reference's module.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..parallel import cluster

#: The prefix of the range around a leaking op; the op's name follows it.
LEAK_RANGE = "cluster.leak::"


@dataclasses.dataclass(frozen=True)
class LocalityCheck:
    """Trace evidence that a clustered call communicates only through its
    final combine (paper §5.3: cores share results via the TCDM *once*,
    everything else is core-local).

    A ``reduce``-mode cluster call may hold exactly one ``all-reduce``
    (the combine); a ``map``-mode call none at all — any other count means
    a per-core intermediate leaked off core.
    """

    mode: str
    counts: Dict[str, int]

    @property
    def ok(self) -> bool:
        extras = {k: v for k, v in self.counts.items() if k != "all-reduce"}
        n_ar = self.counts.get("all-reduce", 0)
        if extras:
            return False
        return n_ar == (1 if self.mode == "reduce" else 0)


def _makes_data(func) -> bool:
    """Whether ``func`` writes what it returns (a new tensor, or an input
    it updates in place); a view returns an input's storage unwritten."""
    return not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)


class _CoreOutputs(TorchDispatchMode):
    """Remembers which core wrote each storage, and puts every op that reads
    a core's output off core in a ``LEAK_RANGE`` range."""

    def __init__(self):
        super().__init__()
        # keyed on the storage itself: an entry goes with its storage, so
        # memory used again later is never taken for the old writer's
        self.writer: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind, core = cluster.SCOPES[-1] if cluster.SCOPES else (None, None)
        here = core if kind == "core" else None
        makes = _makes_data(func)
        leak = False
        if makes and kind not in ("combine", "assemble"):
            read = {self.writer.get(t.untyped_storage())
                    for t in tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor)}
            leak = bool(read - {None, here})
        if leak:
            with record_function(LEAK_RANGE + func.name()):
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        if makes:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.writer[t.untyped_storage()] = here
        return out


def check_cluster_locality(fn: Callable, args: Sequence, kwargs=None, *,
                           mode: str, world: int = 1) -> LocalityCheck:
    """Run a clustered call once under the profiler and audit its trace.

    ``fn(*args, **kwargs)`` must be the full cluster call.  ``world`` is
    the reference's participant count, which scales its HLO counts; a
    trace of one process counts each range once, so it is not read.
    Returns the verdict; callers assert ``.ok``.
    """
    kwargs = kwargs or {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with _CoreOutputs():
            fn(*args, **kwargs)
    counts: Dict[str, int] = collections.Counter()
    for e in prof.events():
        if e.name == cluster.COMBINE_RANGE:
            counts["all-reduce"] += 1
        elif e.name.startswith(LEAK_RANGE):
            counts[e.name[len(LEAK_RANGE):]] += 1
    return LocalityCheck(mode=mode, counts=dict(counts))


# --------------------------------------------------------------------------
# Fusion audit: is the chained intermediate's device buffer actually gone?
# --------------------------------------------------------------------------

#: the reference's HLO spelling of a dtype → torch's
HLO_DTYPES = {"pred": torch.bool, "s8": torch.int8, "u8": torch.uint8,
              "s16": torch.int16, "s32": torch.int32, "s64": torch.int64,
              "f16": torch.float16, "bf16": torch.bfloat16,
              "f32": torch.float32, "f64": torch.float64}


@dataclasses.dataclass
class _Census:
    """What one run of a program wrote: outputs per watched (dtype, shape),
    the bytes of all outputs, and (on CUDA) its device activities."""

    per_shape: Dict[Tuple[torch.dtype, Tuple[int, ...]], int]
    bytes_out: float
    device_ops: Optional[int]


class _OutputCensus(TorchDispatchMode):
    def __init__(self, watch: Iterable[Tuple[torch.dtype, Tuple[int, ...]]]):
        super().__init__()
        self.per_shape = {key: 0 for key in watch}
        self.bytes_out = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _makes_data(func):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.bytes_out += t.numel() * t.element_size()
                    key = (t.dtype, tuple(t.shape))
                    if key in self.per_shape:
                        self.per_shape[key] += 1
        return out


def _census(fn: Callable, args: Sequence, kwargs,
            watch: Sequence[Tuple[torch.dtype, Tuple[int, ...]]]) -> _Census:
    """Run ``fn(*args, **kwargs)`` once to warm it (builds, layouts, plan
    caches), then once under the census."""
    fn(*args, **kwargs)
    cuda = any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in tree_leaves((args, kwargs)))
    device_ops = None
    if cuda:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with _OutputCensus(watch) as census:
                fn(*args, **kwargs)
            torch.cuda.synchronize()
        device_ops = sum(1 for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
    else:
        with _OutputCensus(watch) as census:
            fn(*args, **kwargs)
    return _Census(per_shape=dict(census.per_shape),
                   bytes_out=float(census.bytes_out), device_ops=device_ops)


def _watch_key(dtype: str, dims: Sequence[int]):
    if dtype not in HLO_DTYPES:
        raise ValueError(f"unknown HLO dtype {dtype!r}; known: "
                         f"{sorted(HLO_DTYPES)}")
    return (HLO_DTYPES[dtype], tuple(int(d) for d in dims))


@dataclasses.dataclass(frozen=True)
class FusionCheck:
    """Run-time evidence for (or against) intermediate elimination.

    ``*_buffers`` counts materialisations of the intermediate's exact
    padded type in each program; ``*_bytes_out`` is the total bytes of all
    op outputs, the traffic proxy.  The fused program must not materialise
    *more* intermediate-typed buffers and must write strictly fewer bytes —
    otherwise the "fusion" just hid the copy somewhere else.  (The census
    is ``<=``, not ``<``, as the reference's is: the strict byte reduction
    is what pins the eliminated store and load.)  ``*_device_ops`` are the
    device activities of each run on a CUDA device, ``None`` elsewhere.
    """

    dtype: str
    dims: Tuple[int, ...]
    fused_buffers: int
    unfused_buffers: int
    fused_bytes_out: float
    unfused_bytes_out: float
    fused_device_ops: Optional[int] = None
    unfused_device_ops: Optional[int] = None

    @property
    def intermediate_eliminated(self) -> bool:
        return (self.fused_buffers <= self.unfused_buffers
                and self.fused_bytes_out < self.unfused_bytes_out)

    @property
    def bytes_saved(self) -> float:
        return self.unfused_bytes_out - self.fused_bytes_out


def check_fusion(fused_fn: Callable, unfused_fn: Callable, args: Sequence,
                 kwargs, dtype: str, dims: Tuple[int, ...],
                 world: int = 1) -> FusionCheck:
    """Run both variants and audit the intermediate buffer.

    ``dtype``/``dims`` describe the padded 2-D buffer the unfused
    composition materialises between its kernels, in the reference's HLO
    spelling (e.g. ``("f32", (32, 128))``).  ``world`` scales the
    reference's HLO counts; one process counts each output once, so it is
    not read.
    """
    kwargs = kwargs or {}
    key = _watch_key(dtype, dims)
    fused = _census(fused_fn, args, kwargs, [key])
    unfused = _census(unfused_fn, args, kwargs, [key])
    return FusionCheck(
        dtype=dtype, dims=tuple(dims),
        fused_buffers=fused.per_shape[key],
        unfused_buffers=unfused.per_shape[key],
        fused_bytes_out=fused.bytes_out, unfused_bytes_out=unfused.bytes_out,
        fused_device_ops=fused.device_ops,
        unfused_device_ops=unfused.device_ops)


# --------------------------------------------------------------------------
# DAG fusion audit: every intermediate at once, multi-consumer included.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DagFusionCheck:
    """Run-time evidence that a fused DAG's intermediates are gone.

    A DAG has several intermediates (a diamond's multi-consumer value plus
    the ordinary links); ``inters`` lists each one's padded (dtype, dims)
    as the *unfused* composition materialises it.  The census counts every
    distinct intermediate shape once per side (two buffers of one dtype
    and shape are not told apart, so their counts are summed under one
    entry) and applies the :class:`FusionCheck` criterion in aggregate: no
    more intermediate-shaped buffers, strictly fewer bytes written.
    """

    inters: Tuple[Tuple[str, Tuple[int, ...]], ...]
    fused_buffers: int
    unfused_buffers: int
    fused_bytes_out: float
    unfused_bytes_out: float
    per_shape: Tuple[Tuple[str, Tuple[int, ...], int, int], ...] = ()
    fused_device_ops: Optional[int] = None
    unfused_device_ops: Optional[int] = None

    @property
    def intermediates_eliminated(self) -> bool:
        return (self.fused_buffers <= self.unfused_buffers
                and self.fused_bytes_out < self.unfused_bytes_out)

    @property
    def bytes_saved(self) -> float:
        return self.unfused_bytes_out - self.fused_bytes_out


def check_dag_fusion(fused_fn: Callable, unfused_fn: Callable,
                     args: Sequence, kwargs, inters,
                     world: int = 1) -> DagFusionCheck:
    """Run both variants and audit EVERY DAG intermediate's buffer.

    ``inters`` is an iterable of ``(dtype, dims)`` pairs — one per
    intermediate the unfused composition materialises (see
    ``repro_torch.kernels.dag.DagCase.inters``).  Both programs must run
    the same pinned schedule so fusion is the only structural difference.
    """
    kwargs = kwargs or {}
    inters = tuple((d, tuple(s)) for d, s in inters)
    shapes = list(dict.fromkeys(inters))      # distinct, first-seen order
    keys = [_watch_key(d, s) for d, s in shapes]
    fused = _census(fused_fn, args, kwargs, keys)
    unfused = _census(unfused_fn, args, kwargs, keys)
    per_shape = tuple((d, s, fused.per_shape[k], unfused.per_shape[k])
                      for (d, s), k in zip(shapes, keys))
    return DagFusionCheck(
        inters=inters,
        fused_buffers=sum(f for _, _, f, _ in per_shape),
        unfused_buffers=sum(u for _, _, _, u in per_shape),
        fused_bytes_out=fused.bytes_out, unfused_bytes_out=unfused.bytes_out,
        per_shape=per_shape, fused_device_ops=fused.device_ops,
        unfused_device_ops=unfused.device_ops)
