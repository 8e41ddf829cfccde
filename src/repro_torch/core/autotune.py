"""Schedule autotuner: cost-model-guided block-policy search + dispatch cache.

The PyTorch counterpart of ``repro.core.autotune``: the single-nest search
and, for fused DAGs, the graph-cut search (:func:`autotune_dag`).  The
schedule is a searched artifact:

1. **candidate generation** — :func:`candidate_schedules` enumerates the
   same :class:`~repro_torch.core.lowering.Schedule` variants as the
   reference (block geometries, per-level tile targets, grid-axis orders,
   FIFO depths), filtered by :func:`schedule_is_legal`: the lowering's own
   verdict plus the lane, row, factor and depth checks.  The reference's
   TPU VMEM budget is not carried over.  On a CUDA device, given the body,
   legality adds the Hopper kernel's own acceptance
   (:func:`~repro_torch.core.hopper.accepts`: the block shapes compose,
   blocks stay under 2**31 elements, the CTA's shared memory fits the card);
2. **model prune** — :func:`model_cost` (Eq. (1)–(3) on the padded
   iteration space plus a per-grid-step charge) and :func:`rank_candidates`
   keep a deterministic top-K, collapsing candidates that lower to the same
   geometry (:func:`schedule_fingerprint`);
3. **measure** — :func:`autotune` times the survivors round-robin, the
   default schedule always among them, with a synchronize of the card
   before each clock read, and commits the winner; on the card only one
   candidate per distinct kernel races, and a winner within the race's
   own spread of the default gives way to it;
4. **persist** — a :class:`ScheduleCache` of one JSON file per key under
   ``REPRO_SCHEDULE_CACHE`` (else ``~/.cache/repro-ssr``), in the
   reference's document format, so a cache crosses between the packages.

Keys (:func:`cache_key`) hash the nest signature, the operands' shapes and
dtypes, the mode, the output dtype, the backend and the core count.  Dtypes
are written by their numpy names (``float32``, not ``torch.float32``), so
for the same nest, shapes and backend the key is the reference's hex
digest.  The backend is the device the call runs on: ``"cpu"``, or
``"cuda:<device name>"``, so a winner tuned on one card is never served to
another card or to the CPU.

Dispatch: ``lowering.ssr_call``/``prepare_call``/``ssr_chain_call`` and
``kernels.frontend.NestKernel`` consult :func:`lookup` (``ssr_dag_call``
:func:`lookup_dag`) when no schedule is given, once per problem and
:func:`epoch`: a commit, quarantine or cache switch in this process bumps
the epoch, and :func:`refresh` adopts another process's commits.

The DAG search (:func:`enumerate_cuts` → :func:`dag_cut_is_legal` →
:func:`dag_model_cost` → measure → commit a ``Schedule.cut_edges``) keeps
the reference's keys (:func:`dag_cache_key`) and model; its legality drops
the TPU budget and, on the card, asks each component's kernel.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import json
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import DeviceLike, default_device, resolve_device
from . import hopper, nest_analysis, resilience
from .compiler import ChainDAG, LoopNest, ssrify
from .lowering import (DEFAULT_SCHEDULE, LoweredNest, LoweringError,
                       Schedule, _lowered_for, _plan_for, build_kernel)
from .nest_analysis import auto_lanes
from .ssr import DEFAULT_BUFFER_DEPTH, MAX_BUFFER_DEPTH
from .stream import Direction

#: Bump when the on-disk entry format (or the meaning of a schedule's
#: fields) changes: old entries are ignored, never mis-parsed.  The same
#: number as the reference's, whose documents this cache reads.
SCHEDULE_CACHE_VERSION = 1

_ENV_CACHE_DIR = "REPRO_SCHEDULE_CACHE"

#: Eq. (1)-style charge per grid step: loop bookkeeping + block fetch
#: issue.  What makes the model prefer fewer, bigger blocks until padding
#: waste outweighs it.
STEP_COST = 32

#: The generic generator's search space (the reference's).
_ROWS_CHOICES = (4, 8, 16, 32)
_LANES_CHOICES = (128, 256, 512)
_LANES_FACTORS = (1, 2, 4)
_ROWS_FACTORS = (8, 32)
_QUICK_ROWS = (8, 16)
_QUICK_LANES = (128, 256)
#: FIFO depths explored.  Where a kernel's family stages (the rings R1–R4
#: and R6–R15: ``hopper.RING_KERNELS`` for K1–K13's families, R15 for a
#: StreamKernel's scan), a depth above 2 runs its ring kernel, and a
#: depth-only candidate races on the card.
_DEPTH_CHOICES = (2, 3, 4)
_QUICK_DEPTHS = (2, 3)


def default_cache_dir() -> str:
    env = os.environ.get(_ENV_CACHE_DIR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-ssr")


# --------------------------------------------------------------------------
# Cache keys: nest signature + shapes + backend + cores
# --------------------------------------------------------------------------


def dtype_name(dtype: Any) -> str:
    """A dtype by its numpy name: ``torch.float32`` → ``"float32"``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return str(dtype)


def torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype or its numpy name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"{dtype!r} names no torch dtype")
    return dt


def nest_signature(nest: LoopNest) -> str:
    """Canonical text form of a nest — the schedule cache's identity.

    The reference's text, character for character, so the two packages
    key the same nest alike.
    """
    def _ref_sig(r) -> str:
        sig = f"{r.name}:{r.kind.name}:{r.coeffs}:{r.offset}"
        if r.is_indirect():
            sig += f":ix={r.index_of}*{r.index_scale}"
        if r.window is not None:
            sig += f":win={r.window}"
        if r.acc_kind != "sum":
            sig += f":acc={r.acc_kind}"
        return sig

    refs = ";".join(_ref_sig(r) for r in nest.refs)
    return f"b={nest.bounds}|refs={refs}|c={nest.compute_per_level}"


def operand_signature(operands: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    """Sorted (name, shape×dtype) pairs; accepts tensors, arrays or
    (shape, dtype) pairs.  Dtypes by their numpy names."""
    sig = []
    for name in sorted(operands):
        v = operands[name]
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            shape, dtype = v.shape, v.dtype
        else:
            shape, dtype = v
        sig.append((name, f"{tuple(shape)}:{dtype_name(dtype)}"))
    return tuple(sig)


_DEVICE_NAMES: Dict[int, str] = {}


def call_device(operands: Dict[str, Any],
                device: DeviceLike = None) -> torch.device:
    """The device a call runs on: ``device`` when given, else that of its
    first tensor operand, else the default device."""
    if device is not None:
        return torch.device(device)
    for v in operands.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return default_device()


def _backend(device: DeviceLike = None) -> str:
    """``"cpu"``, or ``"cuda:<device name>"`` for the card the call runs on."""
    dev = torch.device(device) if device is not None else default_device()
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if index not in _DEVICE_NAMES:
        _DEVICE_NAMES[index] = torch.cuda.get_device_name(index)
    return f"cuda:{_DEVICE_NAMES[index]}"


def cache_key(nest: LoopNest, operands: Dict[str, Any], *,
              mode: str = "reduce", out_dtype: Any = "float32",
              backend: Optional[str] = None, cores: int = 1,
              device: DeviceLike = None) -> str:
    """Stable hex digest identifying one tuning problem."""
    backend = backend or _backend(call_device(operands, device))
    blob = json.dumps({
        "v": SCHEDULE_CACHE_VERSION,
        "nest": nest_signature(nest),
        "operands": operand_signature(operands),
        "mode": mode,
        "out_dtype": dtype_name(out_dtype),
        "backend": backend,
        "cores": int(cores),
    }, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


# --------------------------------------------------------------------------
# Persistent schedule cache: JSON-per-key + in-memory LRU + invalidation
# --------------------------------------------------------------------------


#: Sentinel for "generation never observed" — the first probe adopts the
#: on-disk token silently instead of spuriously invalidating local state.
_GEN_UNSET = object()

#: Bounded retry budget for transient I/O on the commit path.
_PUT_ATTEMPTS = 3


class ScheduleCache:
    """On-disk schedule store with an in-memory LRU in front.

    One JSON file per key under ``path`` (atomic tmp + rename writes), in
    the reference's document format (``version``, ``schedule``,
    ``committed_unix``, optional ``meta``).  Misses are negative-cached per
    epoch, so a probe costs one ``os.stat`` of the ``GENERATION`` file plus
    a dict probe; dispatch probes once per problem and epoch.  Every writer
    replaces ``GENERATION``; when its (inode, mtime_ns) token moves, the
    in-memory caches drop and the epoch bumps, so another process's commit
    is seen at the next probe (or :func:`refresh`).

    Torn, garbage, version-skewed or non-dict documents read as misses and
    are quarantined (renamed to ``<key>.json.corrupt``); a later
    :meth:`put` recovers the key.  Commits retry transient ``OSError`` with
    jittered backoff.  The ``cache.read``/``cache.write`` fault seams fire
    here.
    """

    def __init__(self, path: Optional[str] = None, max_entries: int = 256):
        self.path = path or default_cache_dir()
        self.max_entries = max_entries
        self._mem: "collections.OrderedDict[str, Schedule]" = \
            collections.OrderedDict()
        self._miss: Dict[str, int] = {}   # key -> epoch of the probed miss
        self._last_gen: Any = _GEN_UNSET  # last observed GENERATION token
        self.stats: Dict[str, int] = {"hits": 0, "misses": 0,
                                      "quarantined": 0, "retries": 0,
                                      "generation_busts": 0}

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.json")

    def _gen_file(self) -> str:
        return os.path.join(self.path, "GENERATION")

    def _disk_generation(self) -> Optional[Tuple[int, int]]:
        """(inode, mtime_ns) of the GENERATION file; ``None`` while no
        writer has touched it."""
        try:
            st = os.stat(self._gen_file())
        except OSError:
            return None
        return (st.st_ino, st.st_mtime_ns)

    def _atomic_write(self, target: str, write: Callable) -> None:
        os.makedirs(self.path, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                write(f)
            os.replace(tmp, target)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _touch_generation(self) -> None:
        """Advance the cross-process change token (atomic, retried)."""
        try:
            resilience.retry(
                lambda: self._atomic_write(
                    self._gen_file(),
                    lambda f: f.write(f"{os.getpid()}:{time.time_ns()}\n")),
                attempts=_PUT_ATTEMPTS, on_retry=self._count_retry)
        except OSError:
            # the token serves OTHER processes' negative caches; local state
            # is already right, so a sick filesystem must not fail a commit
            pass
        self._last_gen = self._disk_generation()
        self._miss.clear()

    def _count_retry(self, attempt: int, error: BaseException) -> None:
        self.stats["retries"] += 1

    def _sync_generation(self) -> None:
        """Adopt the on-disk token; on change drop the local caches."""
        gen = self._disk_generation()
        if self._last_gen is _GEN_UNSET:
            self._last_gen = gen
            return
        if gen != self._last_gen:
            self._last_gen = gen
            self._miss.clear()
            self._mem.clear()
            self.stats["generation_busts"] += 1
            _bump_epoch()

    def _note_miss(self, key: str) -> None:
        if len(self._miss) >= 4096:
            self._miss.clear()
        self._miss[key] = _EPOCH

    def quarantine(self, key: str) -> bool:
        """Sideline one entry as poisoned: rename to ``.json.corrupt``,
        negative-cache it, advance the generation token.  True if a disk
        file was sidelined."""
        self._mem.pop(key, None)
        sidelined = False
        try:
            os.replace(self._file(key), self._file(key) + ".corrupt")
            sidelined = True
        except OSError:
            try:
                os.unlink(self._file(key))
                sidelined = True
            except OSError:
                pass
        if sidelined:
            self.stats["quarantined"] += 1
            self._touch_generation()
        _bump_epoch()
        self._note_miss(key)
        return sidelined

    def _load(self, key: str) -> Optional[Dict[str, Any]]:
        """The stored document, ``None`` when absent; raises ValueError on
        one that is torn, not JSON, or not a JSON object."""
        with open(self._file(key)) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError(f"schedule document {key} is not an object")
        return doc

    def _miss_and_quarantine(self, key: str) -> None:
        self.quarantine(key)
        self.stats["misses"] += 1

    def get(self, key: str) -> Optional[Schedule]:
        resilience.inject("cache.read")
        self._sync_generation()
        hit = self._mem.get(key)
        if hit is not None:
            self._mem.move_to_end(key)
            self.stats["hits"] += 1
            return hit
        if self._miss.get(key) == _EPOCH:
            self.stats["misses"] += 1
            return None
        try:
            doc = self._load(key)
        except OSError:                  # absent file: a plain miss
            self._note_miss(key)
            self.stats["misses"] += 1
            return None
        except ValueError:               # torn, garbage or not an object
            self._miss_and_quarantine(key)
            return None
        if doc.get("version") != SCHEDULE_CACHE_VERSION:
            self._miss_and_quarantine(key)   # version skew: never mis-parse
            return None
        try:
            sched = Schedule.from_json(doc["schedule"])
        except (KeyError, TypeError, ValueError):
            self._miss_and_quarantine(key)
            return None
        self._remember(key, sched)
        self.stats["hits"] += 1
        return sched

    def meta(self, key: str) -> Optional[Dict[str, Any]]:
        """The full stored document (schedule + provenance), or ``None``."""
        resilience.inject("cache.read")
        try:
            doc = self._load(key)
        except OSError:
            return None
        except ValueError:
            self.quarantine(key)
            return None
        return doc if doc.get("version") == SCHEDULE_CACHE_VERSION else None

    def put(self, key: str, schedule: Schedule,
            meta: Optional[Dict[str, Any]] = None) -> None:
        doc = {"version": SCHEDULE_CACHE_VERSION,
               "schedule": schedule.to_json(),
               "committed_unix": time.time()}
        if meta:
            doc["meta"] = meta

        def _write() -> None:
            resilience.inject("cache.write")
            self._atomic_write(
                self._file(key),
                lambda f: json.dump(doc, f, indent=1, sort_keys=True))

        # transient OSError is retried with jittered backoff; an
        # InjectedFault or a persistent failure propagates to the caller
        resilience.retry(_write, attempts=_PUT_ATTEMPTS,
                         on_retry=self._count_retry)
        self._remember(key, schedule)
        self._touch_generation()
        _bump_epoch()

    def invalidate(self, key: str) -> bool:
        """Drop one entry (memory + disk); True if anything was removed."""
        self._miss.pop(key, None)
        dropped = self._mem.pop(key, None) is not None
        try:
            os.unlink(self._file(key))
            dropped = True
        except OSError:
            pass
        if dropped:
            self._touch_generation()
            _bump_epoch()
        return dropped

    def clear(self) -> int:
        """Drop every entry; returns the number of disk entries removed."""
        self._mem.clear()
        self._miss.clear()
        n = 0
        try:
            names = os.listdir(self.path)
        except OSError:
            names = []
        for name in names:
            if name.endswith(".json"):
                try:
                    os.unlink(os.path.join(self.path, name))
                    n += 1
                except OSError:
                    pass
        self._touch_generation()
        _bump_epoch()
        return n

    def keys(self) -> List[str]:
        try:
            return sorted(n[:-5] for n in os.listdir(self.path)
                          if n.endswith(".json"))
        except OSError:
            return []

    def _remember(self, key: str, sched: Schedule) -> None:
        self._mem[key] = sched
        self._mem.move_to_end(key)
        while len(self._mem) > self.max_entries:
            self._mem.popitem(last=False)


_GLOBAL_CACHE: Optional[ScheduleCache] = None
_EPOCH = 0


def global_cache() -> ScheduleCache:
    """The process-wide cache (respects ``REPRO_SCHEDULE_CACHE``); a new
    cache directory starts a new epoch."""
    global _GLOBAL_CACHE
    if _GLOBAL_CACHE is None or \
            _GLOBAL_CACHE.path != default_cache_dir():
        _GLOBAL_CACHE = ScheduleCache()
        _bump_epoch()
    return _GLOBAL_CACHE


def epoch() -> int:
    """Monotonic commit counter — resolved-schedule caches key on it so a
    schedule committed or quarantined in this process, or a switch of
    ``REPRO_SCHEDULE_CACHE``, takes effect on the next call."""
    global_cache()
    return _EPOCH


def refresh() -> bool:
    """Adopt schedules other processes committed since this one last
    looked: re-read the cache's ``GENERATION`` token and, if it moved, drop
    the in-memory caches and start a new epoch.  True if it moved."""
    before = _EPOCH
    global_cache()._sync_generation()
    return _EPOCH != before


def _bump_epoch() -> None:
    global _EPOCH
    _EPOCH += 1


def lookup(nest: LoopNest, operands: Dict[str, Any], *,
           mode: str = "reduce", out_dtype: Any = "float32",
           cores: int = 1, cache: Optional[ScheduleCache] = None,
           device: DeviceLike = None) -> Schedule:
    """Cache-only schedule resolution: tuned winner or the default.  Never
    measures: one dict/file probe per call."""
    cache = cache or global_cache()
    key = cache_key(nest, operands, mode=mode, out_dtype=out_dtype,
                    cores=cores, device=device)
    return cache.get(key) or DEFAULT_SCHEDULE


# --------------------------------------------------------------------------
# Candidate generation + legality
# --------------------------------------------------------------------------


def _nest_has_output(nest: LoopNest) -> bool:
    return any(r.kind == Direction.WRITE for r in nest.refs)


def _lower_candidate(nest: LoopNest, sched: Schedule):
    """The lowering's own verdict on a candidate (raises LoweringError),
    through the lowering layer's cache."""
    plan = _plan_for(nest, auto_lanes(nest))
    return _lowered_for(plan, sched, _nest_has_output(nest))


def _max_depth(sched: Schedule) -> int:
    if sched.stream_depths:
        return max(sched.stream_depths)
    return sched.buffer_depth


def _operand_dtype(operands: Optional[Dict[str, Any]]) -> torch.dtype:
    for v in (operands or {}).values():
        dtype = v.dtype if hasattr(v, "dtype") else v[1]
        return torch_dtype(dtype_name(dtype))
    return torch.float32


def _table_views(lowered, operands: Optional[Dict[str, Any]]) -> tuple:
    """Each gather table's (≥2-D) view from ``operands`` (tensors, arrays
    or ``(shape, dtype)`` pairs).  A table not given stands in as one row
    of the gather's index scale: its geometry without its size."""
    from .lowering import _table_view_shape

    views = []
    for g in getattr(lowered, "gathers", ()):
        v = (operands or {}).get(g.name)
        shape = tuple(v.shape) if hasattr(v, "shape") else \
            tuple(v[0]) if v is not None else (1, g.scale)
        views.append(_table_view_shape(shape))
    return tuple(views)


def _candidate_kernel(nest: LoopNest, sched: Schedule, body: Callable,
                      mode: str, out_dtype: Any,
                      operands: Optional[Dict[str, Any]] = None):
    """The :class:`SsrKernel` a candidate builds (operands give only the
    gather tables' shapes)."""
    lowered = _lower_candidate(nest, sched)
    return build_kernel(lowered, body, mode, torch_dtype(out_dtype),
                        tables=_table_views(lowered, operands))


def _refusal_of(kernel, body: Callable, operands: Optional[Dict[str, Any]],
                device: DeviceLike) -> Optional[str]:
    takes, why = hopper.accepts(kernel.device_key, kernel.geometry,
                                _operand_dtype(operands),
                                torch.device(device), **kernel.device_args())
    return None if takes else why


def kernel_refusal(nest: LoopNest, sched: Schedule, body: Callable, *,
                   mode: str = "reduce", out_dtype: Any = torch.float32,
                   operands: Optional[Dict[str, Any]] = None,
                   device: DeviceLike = "cuda") -> Optional[str]:
    """Why the Hopper kernel for ``body`` would refuse ``sched``, or None.

    Builds the lowered kernel's geometry (no operands needed) and asks
    :func:`hopper.accepts`, the check its wrapper runs before a launch.
    """
    return _refusal_of(_candidate_kernel(nest, sched, body, mode, out_dtype,
                                         operands),
                       body, operands, device)


def _card_candidates(nest: LoopNest, cands: Sequence[Schedule],
                     body: Callable, *, mode: str, out_dtype: Any,
                     operands: Dict[str, Any],
                     dev: torch.device) -> List[Schedule]:
    """The candidates worth racing on the card: the default, then each one
    the Hopper kernel takes whose kernel differs from every one kept before
    it.  The depths are part of a kernel's identity where it is pipelined
    (its ring kernel stages by them); elsewhere a depth-only variant builds
    its depth-2 twin's kernel and would only race noise against it."""
    kept: List[Schedule] = []
    seen = set()
    for sched in [DEFAULT_SCHEDULE] + [s for s in cands
                                       if s != DEFAULT_SCHEDULE]:
        kernel = _candidate_kernel(nest, sched, body, mode, out_dtype,
                                   operands)
        ident = (kernel.mode, kernel.geometry, kernel.acc_dtype,
                 kernel.depths if kernel.pipelined else None)
        if ident in seen or (sched != DEFAULT_SCHEDULE and _refusal_of(
                kernel, body, operands, dev) is not None):
            continue
        seen.add(ident)
        kept.append(sched)
    return kept


def schedule_is_legal(nest: LoopNest, sched: Schedule, *,
                      operands: Optional[Dict[str, Any]] = None,
                      body: Optional[Callable] = None, mode: str = "reduce",
                      out_dtype: Any = torch.float32,
                      device: DeviceLike = None) -> Tuple[bool, str]:
    """(legal, reason).  Lowering + lane/row/factor/depth checks; on a CUDA
    ``device`` with a ``body``, also the Hopper kernel's own acceptance.

    The reference also holds the working set to a 64 MiB TPU VMEM budget;
    the port does not: a block here is a walk over device memory, and each
    kernel checks its own CTA's shared memory against the card.
    """
    if sched.lanes % 128 != 0 or sched.lanes < 128:
        return False, f"lanes {sched.lanes} not a multiple of the 128-wide " \
                      "hardware lane"
    if sched.rows < 1:
        return False, f"rows {sched.rows} < 1"
    if sched.lanes_tile_factor < 1 or sched.rows_tile_factor < 1:
        return False, "tile factors must be >= 1"
    if not DEFAULT_BUFFER_DEPTH <= sched.buffer_depth <= MAX_BUFFER_DEPTH:
        return False, (f"buffer_depth {sched.buffer_depth} outside "
                       f"[{DEFAULT_BUFFER_DEPTH}, {MAX_BUFFER_DEPTH}]")
    if sched.stream_depths is not None:
        for d in sched.stream_depths:
            if not DEFAULT_BUFFER_DEPTH <= d <= MAX_BUFFER_DEPTH:
                return False, (f"stream depth {d} outside "
                               f"[{DEFAULT_BUFFER_DEPTH}, "
                               f"{MAX_BUFFER_DEPTH}]")
    try:
        lowered = _lower_candidate(nest, sched)
    except LoweringError as e:
        return False, f"lowering rejected: {e}"
    except ValueError as e:              # MAX_DIMS / malformed nest
        return False, f"nest rejected: {e}"
    if sched.stream_depths is not None \
            and len(sched.stream_depths) != len(lowered.in_streams):
        return False, (f"stream_depths has {len(sched.stream_depths)} "
                       f"entries for {len(lowered.in_streams)} read "
                       "streams")
    if body is not None and device is not None \
            and torch.device(device).type == "cuda":
        why = kernel_refusal(nest, sched, body, mode=mode,
                             out_dtype=out_dtype, operands=operands,
                             device=device)
        if why is not None:
            return False, f"kernel refuses: {why}"
    return True, "ok"


def _axis_orders(nest: LoopNest) -> List[Tuple[int, ...]]:
    """Legal grid-axis permutations: parallel axes shuffle, contractions
    stay trailing.  Bounded to 3-deep nests (≤ 2 extra orders)."""
    if not _nest_has_output(nest):
        return []
    try:
        out = nest_analysis.output_ref(nest)
    except ValueError:
        return []
    if out is None or out.coeffs is None:
        return []
    zaxes = nest_analysis.contraction_axes(out, nest)
    par = [l for l in range(len(nest.bounds)) if l not in zaxes]
    if len(par) < 2:
        return []
    orders = []
    for perm in itertools.permutations(par):
        order = tuple(perm) + tuple(z for z in range(len(nest.bounds))
                                    if z in zaxes)
        if order != tuple(range(len(nest.bounds))):
            orders.append(order)
    return orders[:2]


def candidate_schedules(nest: LoopNest, *, quick: bool = False,
                        max_candidates: Optional[int] = None,
                        operands: Optional[Dict[str, Any]] = None,
                        body: Optional[Callable] = None,
                        mode: str = "reduce", out_dtype: Any = torch.float32,
                        device: DeviceLike = None) -> List[Schedule]:
    """Legal candidates for a nest, default schedule always first.

    The reference's enumeration, in its deterministic order, filtered by
    :func:`schedule_is_legal` (with ``body`` and a CUDA ``device``, by the
    Hopper kernel's acceptance too).
    """
    rowses = _QUICK_ROWS if quick else _ROWS_CHOICES
    laneses = _QUICK_LANES if quick else _LANES_CHOICES
    depths = _QUICK_DEPTHS if quick else _DEPTH_CHOICES
    raw: List[Schedule] = [DEFAULT_SCHEDULE]
    for rows, lanes in itertools.product(rowses, laneses):
        raw.append(Schedule(rows=rows, lanes=lanes))
    if _nest_has_output(nest):
        factors = _LANES_FACTORS if not quick else _LANES_FACTORS[:2]
        for lf in factors:
            for rf in _ROWS_FACTORS:
                raw.append(Schedule(lanes_tile_factor=lf,
                                    rows_tile_factor=rf))
        for order in _axis_orders(nest):
            raw.append(Schedule(axis_order=order))
    # every geometry candidate at every FIFO depth
    for s in list(raw):
        for d in depths:
            if d != s.buffer_depth:
                raw.append(dataclasses.replace(s, buffer_depth=d))
    if not quick:
        # asymmetric per-stream depths (full runs, 2-read-stream nests)
        n_reads = sum(1 for r in nest.refs if r.kind == Direction.READ)
        if n_reads == 2:
            for sd in ((4, 2), (2, 4), (3, 2), (2, 3)):
                raw.append(Schedule(stream_depths=sd))

    seen, out = set(), []
    for s in raw:
        if s in seen:
            continue
        seen.add(s)
        if schedule_is_legal(nest, s, operands=operands, body=body,
                             mode=mode, out_dtype=out_dtype,
                             device=device)[0]:
            out.append(s)
    if max_candidates is not None:
        out = out[:max_candidates]
    return out


# --------------------------------------------------------------------------
# Model prune: Eq. (1)–(3) on the padded iteration space + step charge
# --------------------------------------------------------------------------


def _padded_bounds(nest: LoopNest, sched: Schedule) -> Tuple[Tuple[int, ...],
                                                             int]:
    """(padded bounds, grid steps) of the schedule — lowering-accurate
    where the lowering accepts the nest, closed-form otherwise."""
    try:
        lowered = _lower_candidate(nest, sched)
    except (LoweringError, ValueError):
        E = sched.block_elems
        inner = -(-nest.bounds[-1] // E) * E
        padded = tuple(nest.bounds[:-1]) + (inner,)
        return padded, math.prod(nest.bounds[:-1]) * (inner // E)
    if isinstance(lowered, LoweredNest):
        return lowered.padded_bounds, lowered.steps
    padded = tuple(lowered.plan.nest.bounds[:-1]) + (
        lowered.grid[-1] * sched.block_elems,)
    return padded, lowered.steps


def model_cost(nest: LoopNest, sched: Schedule, *,
               step_cost: int = STEP_COST) -> float:
    """Eq. (1) instruction count on the *padded* iteration space, plus a
    per-grid-step charge whose latency half shrinks as ``depth − 1``
    in-flight fetches cover it (exactly ``step_cost`` at depth 2)."""
    padded, steps = _padded_bounds(nest, sched)
    padded_nest = dataclasses.replace(nest, bounds=padded)
    plan = ssrify(padded_nest, num_lanes=auto_lanes(padded_nest), force=True)
    half = step_cost / 2.0
    per_step = half + half / (_max_depth(sched) - 1)
    return float(plan.n_ssr + per_step * steps)


def schedule_fingerprint(nest: LoopNest, sched: Schedule) -> Any:
    """What the schedule *lowers to*: grid, tiles, block shapes (and the
    depth knobs).  Two schedules with the same fingerprint build the same
    kernel, so they are measured once."""
    try:
        lowered = _lower_candidate(nest, sched)
    except (LoweringError, ValueError):
        return ("sched", sched)
    if isinstance(lowered, LoweredNest):
        # axis order matters only across axes that iterate
        eff_order = tuple(l for k, l in enumerate(lowered.axis_order)
                          if lowered.grid[k] > 1)
        return ("nest", lowered.grid, lowered.tiles, eff_order,
                tuple(s.stream.block_shape for s in lowered.in_streams),
                lowered.out_stream.stream.block_shape, sched.acc_dtype,
                sched.buffer_depth, sched.stream_depths)
    return ("flat", lowered.grid,
            tuple(s.stream.block_shape for s in lowered.in_streams),
            sched.acc_dtype, sched.buffer_depth, sched.stream_depths)


def rank_candidates(nest: LoopNest, candidates: Sequence[Schedule], *,
                    top_k: int = 8,
                    step_cost: int = STEP_COST) -> List[Schedule]:
    """Deterministic model ranking; the default schedule always survives.

    Sort key (model cost, schedule identity); candidates with one
    fingerprint collapse to one survivor (the default claims its own), and
    the default is re-inserted if the prune would drop it.
    """
    def ident(s: Schedule):
        return (s.rows, s.lanes, s.lanes_tile_factor, s.rows_tile_factor,
                s.axis_order or (), s.acc_dtype, s.buffer_depth,
                s.stream_depths or ())

    ranked = sorted(candidates,
                    key=lambda s: (model_cost(nest, s,
                                              step_cost=step_cost),
                                   ident(s)))
    default_fp = schedule_fingerprint(nest, DEFAULT_SCHEDULE) \
        if DEFAULT_SCHEDULE in candidates else None
    kept: List[Schedule] = []
    seen = set()
    for s in ranked:
        fp = schedule_fingerprint(nest, s)
        if fp in seen:
            continue
        seen.add(fp)
        kept.append(DEFAULT_SCHEDULE if fp == default_fp else s)
    kept = kept[:max(1, top_k)]
    if DEFAULT_SCHEDULE in candidates and DEFAULT_SCHEDULE not in kept:
        kept[-1] = DEFAULT_SCHEDULE
    return kept


# --------------------------------------------------------------------------
# Measure + commit
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one autotune run (or cache hit).

    ``degraded`` marks a run whose measurement hit a typed infrastructure
    failure and fell back to the default without committing;
    ``committed`` is False when the commit itself failed; ``stragglers``
    counts samples the :class:`~repro_torch.runtime.fault.StragglerMonitor`
    flagged and re-raced.  ``held_back`` marks a race on the card whose
    fastest candidate beat the default by no more than the samples' spread,
    so the default was committed.  ``timings`` holds each measured
    survivor's best time in µs, in ranking order (empty on a cache hit).
    """

    key: str
    schedule: Schedule
    tuned_us: float
    default_us: float
    candidates: int
    measured: int
    from_cache: bool = False
    degraded: bool = False
    committed: bool = True
    stragglers: int = 0
    held_back: bool = False
    timings: Tuple[Tuple[Schedule, float], ...] = ()

    @property
    def speedup(self) -> float:
        return self.default_us / self.tuned_us if self.tuned_us else 1.0

    @property
    def is_default(self) -> bool:
        return self.schedule == DEFAULT_SCHEDULE


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pick(candidates: Sequence[Schedule],
          samples: Sequence[Sequence[float]], i_default: int, *,
          on_card: bool) -> Tuple[Schedule, float, float, bool]:
    """(winner, its µs, the default's µs, held back) of one race: the
    candidate with the fastest sample, ties to the earlier one.  On the
    card a winner that beats the default (``candidates[i_default]``) by no
    more than the race's own spread (max − min over the samples of either)
    is held back for the default."""
    best = [(min(xs) * 1e6, i) for i, xs in enumerate(samples)]
    default_us = best[i_default][0]
    tuned_us, i_win = min(best)
    if not on_card or i_win == i_default:
        return candidates[i_win], tuned_us, default_us, False
    spread_us = max(max(samples[i]) - min(samples[i])
                    for i in (i_default, i_win)) * 1e6
    if default_us - tuned_us <= spread_us:
        return candidates[i_default], default_us, default_us, True
    return candidates[i_win], tuned_us, default_us, False


def _pick_winner(survivors: Sequence[Schedule],
                 samples: Sequence[Sequence[float]], *,
                 on_card: bool) -> Tuple[Schedule, float, float, bool]:
    """:func:`_pick` with the default schedule as the one to beat."""
    return _pick(survivors, samples, list(survivors).index(DEFAULT_SCHEDULE),
                 on_card=on_card)


def autotune(nest: LoopNest, body: Callable, operands: Dict[str, Any], *,
             mode: str = "reduce", out_dtype: Any = "float32",
             num_lanes: Optional[int] = None,
             call: Optional[Callable[[Schedule], Any]] = None,
             candidates: Optional[Sequence[Schedule]] = None,
             top_k: int = 8, warmup: int = 1, iters: int = 3,
             cores: int = 1,
             cache: Optional[ScheduleCache] = None,
             use_cache: bool = True, force: bool = False,
             clock: Optional[Callable[[], float]] = None,
             straggler: Optional[Any] = None,
             device: DeviceLike = None) -> TuneResult:
    """Search → prune → measure → commit the winning schedule.

    ``call(schedule)`` runs the kernel under one candidate; by default the
    whole entry point, ``ssr_call`` with ``nest``/``body``/``operands`` on
    the call's device.  On a CUDA device the card is synchronized before
    each clock read; candidates the Hopper kernel would refuse, or that
    build a kernel already racing, are dropped before the race (the default
    always races); and a winner that beats the default by no more than the
    samples' spread is held back for the default.  Every timed sample
    passes a :class:`~repro_torch.runtime.fault.StragglerMonitor`; a
    flagged sample is re-raced once.  A typed failure while measuring (the
    ``measure`` seam) degrades to the default without committing; a failed
    commit is recorded and tolerated.  A cache hit short-circuits unless
    ``force=True``.
    """
    from ..runtime.fault import StragglerMonitor
    from .lowering import ssr_call

    dev = resolve_device(call_device(operands, device))
    cache = cache or (global_cache() if use_cache else None)
    key = cache_key(nest, operands, mode=mode, out_dtype=out_dtype,
                    cores=cores, device=dev)
    if cache is not None and not force:
        hit = cache.get(key)
        if hit is not None:
            meta = cache.meta(key) or {}
            m = meta.get("meta", {})
            return TuneResult(key=key, schedule=hit,
                              tuned_us=float(m.get("tuned_us", 0.0)),
                              default_us=float(m.get("default_us", 0.0)),
                              candidates=int(m.get("candidates", 0)),
                              measured=0, from_cache=True)

    if call is None:
        def call(sched: Schedule):
            return ssr_call(nest, body, operands, mode=mode,
                            out_dtype=torch_dtype(out_dtype), schedule=sched,
                            num_lanes=num_lanes, device=dev)

    cands = list(candidates) if candidates is not None \
        else candidate_schedules(nest, operands=operands, body=body,
                                 mode=mode, out_dtype=out_dtype, device=dev)
    if DEFAULT_SCHEDULE not in cands:
        cands.insert(0, DEFAULT_SCHEDULE)
    raced = cands if dev.type != "cuda" else _card_candidates(
        nest, cands, body, mode=mode, out_dtype=out_dtype,
        operands=operands, dev=dev)
    survivors = rank_candidates(nest, raced, top_k=top_k)

    # round-robin: one timed call per survivor per round, so drift hits
    # every candidate alike
    clock = clock or time.perf_counter
    monitor = straggler if straggler is not None else \
        StragglerMonitor(warmup_steps=len(survivors))
    sample = 0
    stragglers = 0

    def _run(sched: Schedule) -> float:
        resilience.inject("measure")
        t0 = clock()
        call(sched)
        _synchronize(dev)
        return clock() - t0

    def _timed(sched: Schedule) -> float:
        nonlocal sample, stragglers
        dt = _run(sched)
        if monitor.observe(sample, dt):
            # poisoned sample: re-race once rather than let a stall decide
            stragglers += 1
            sample += 1
            dt = _run(sched)
        sample += 1
        return dt

    samples: List[List[float]] = [[] for _ in survivors]
    try:
        for _ in range(max(0, warmup)):
            for sched in survivors:
                call(sched)
                _synchronize(dev)
        for _ in range(max(1, iters)):
            for i, sched in enumerate(survivors):
                samples[i].append(_timed(sched))
    except resilience.fallback_error_types() as e:
        resilience.record_fallback(
            seam=resilience.classify(e), site="autotune", error=e,
            from_schedule="measure", to_schedule="default", key=key)
        return TuneResult(key=key, schedule=DEFAULT_SCHEDULE, tuned_us=0.0,
                          default_us=0.0, candidates=len(cands), measured=0,
                          degraded=True, committed=False,
                          stragglers=stragglers)
    winner, tuned_us, default_us, held_back = _pick_winner(
        survivors, samples, on_card=dev.type == "cuda")

    committed = False
    if cache is not None:
        try:
            cache.put(key, winner, meta={
                "tuned_us": tuned_us, "default_us": default_us,
                "candidates": len(cands), "measured": len(survivors),
                "stragglers": stragglers, "held_back": held_back,
                "nest": nest_signature(nest), "mode": mode,
                "out_dtype": dtype_name(out_dtype), "cores": cores,
                "backend": _backend(dev),
            })
            committed = True
        except resilience.fallback_error_types() as e:
            # the winner still serves this process; only persistence failed
            resilience.record_fallback(
                seam=resilience.classify(e), site="autotune", error=e,
                from_schedule="winner", to_schedule="uncommitted", key=key)
    return TuneResult(key=key, schedule=winner, tuned_us=tuned_us,
                      default_us=default_us, candidates=len(cands),
                      measured=len(survivors), committed=committed,
                      stragglers=stragglers, held_back=held_back,
                      timings=tuple((sched, min(xs) * 1e6) for sched, xs
                                    in zip(survivors, samples)))


def invalidate(nest: LoopNest, operands: Dict[str, Any], *,
               mode: str = "reduce", out_dtype: Any = "float32",
               cores: int = 1, cache: Optional[ScheduleCache] = None,
               device: DeviceLike = None) -> bool:
    """Explicitly drop the cached schedule for one tuning problem."""
    cache = cache or global_cache()
    return cache.invalidate(
        cache_key(nest, operands, mode=mode, out_dtype=out_dtype,
                  cores=cores, device=device))


def quarantine(nest: LoopNest, operands: Dict[str, Any], *,
               mode: str = "reduce", out_dtype: Any = "float32",
               cores: int = 1, cache: Optional[ScheduleCache] = None,
               device: DeviceLike = None) -> str:
    """Sideline the committed schedule for one tuning problem (dispatch
    calls this when a tuned schedule fails to lower or build); returns the
    quarantined key."""
    cache = cache or global_cache()
    key = cache_key(nest, operands, mode=mode, out_dtype=out_dtype,
                    cores=cores, device=device)
    cache.quarantine(key)
    return key


def stream_block_bytes(lowered: Any, itemsize: int = 4) -> int:
    """Depth-buffered stream blocks plus kernel-resident scratch, in bytes.

    The reference's working-set accounting (``_stream_block_bytes``), byte
    for byte, for a :class:`LoweredPlan`, :class:`LoweredNest` or
    :class:`LoweredChain`: every stream block at the schedule's (possibly
    per-stream) FIFO depth, the synthesised or explicit output, the
    contraction or reduce accumulator, and for a chain or DAG one block per
    live intermediate slot (refcounted: a diamond's peak is 2).  The port
    reports it and holds it to no budget.
    """
    from .lowering import LoweredChain, LoweredPlan, _dag_slots
    from .ssr import stream_vmem_bytes

    sched = lowered.schedule
    total = 0
    n_in = len(lowered.in_streams)
    for i, s in enumerate(lowered.in_streams):
        total += stream_vmem_bytes(
            math.prod(s.stream.block_shape) * itemsize,
            _depth_of(sched, i, n_in))
    if isinstance(lowered, LoweredNest):
        out_block = math.prod(lowered.out_stream.stream.block_shape)
        total += stream_vmem_bytes(out_block * itemsize, _max_depth(sched))
        if lowered.contraction_axes:     # the accumulator scratch
            total += out_block * itemsize
        return total
    block = lowered.policy.rows * lowered.policy.lanes
    total += stream_vmem_bytes(block * itemsize, _max_depth(sched))
    if isinstance(lowered, LoweredChain):
        if isinstance(lowered.chained, ChainDAG):
            _, n_slots = _dag_slots(lowered.chained)
        else:
            n_slots = len(lowered.chained.links)
        total += n_slots * block * itemsize  # intermediate scratch slots
    else:
        assert isinstance(lowered, LoweredPlan)
    return total + block * itemsize          # reduce accumulator scratch


def _depth_of(sched: Schedule, i: int, n_in: int) -> int:
    """FIFO depth of read stream ``i`` of ``n_in`` under ``sched``."""
    if sched.stream_depths is not None and len(sched.stream_depths) == n_in:
        return sched.stream_depths[i]
    return sched.buffer_depth


# --------------------------------------------------------------------------
# DAG fusion search: enumerate legal graph cuts, prune by the Eq. (1)–(3)
# model, measure the survivors, commit the winning partition.
#
# A "cut" is a set of edge indices into ``ChainDAG.edges``.  Every cut edge
# materialises its intermediate in device memory (one kernel stops, another
# reloads); every fused edge keeps it on chip.  The committed winner lands
# in the same :class:`ScheduleCache` under a DAG-specific key, so
# ``ssr_dag_call`` resolves the best partitioning on its next dispatch.
# --------------------------------------------------------------------------


def dag_cache_key(nests: Sequence[LoopNest], operands: Dict[str, Any], *,
                  mode: str = "map", out_dtype: Any = "float32",
                  backend: Optional[str] = None, cores: int = 1,
                  uniforms: Optional[Dict[str, Any]] = None,
                  device: DeviceLike = None) -> str:
    """Stable hex digest identifying one DAG fusion problem (the
    reference's for backend ``"cpu"``)."""
    backend = backend or _backend(call_device(operands, device))
    blob = json.dumps({
        "v": SCHEDULE_CACHE_VERSION,
        "dag": [nest_signature(n) for n in nests],
        "operands": operand_signature(operands),
        "uniforms": operand_signature(uniforms or {}),
        "mode": mode,
        "out_dtype": dtype_name(out_dtype),
        "backend": backend,
        "cores": int(cores),
    }, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def lookup_dag(nests: Sequence[LoopNest], operands: Dict[str, Any], *,
               mode: str = "map", out_dtype: Any = "float32",
               cores: int = 1, cache: Optional[ScheduleCache] = None,
               uniforms: Optional[Dict[str, Any]] = None,
               device: DeviceLike = None) -> Schedule:
    """Cache-only partition resolution for ``ssr_dag_call`` dispatch."""
    cache = cache or global_cache()
    key = dag_cache_key(nests, operands, mode=mode, out_dtype=out_dtype,
                        cores=cores, uniforms=uniforms, device=device)
    return cache.get(key) or DEFAULT_SCHEDULE


def quarantine_dag(nests: Sequence[LoopNest], operands: Dict[str, Any], *,
                   mode: str = "map", out_dtype: Any = "float32",
                   cores: int = 1, cache: Optional[ScheduleCache] = None,
                   uniforms: Optional[Dict[str, Any]] = None,
                   device: DeviceLike = None) -> str:
    """DAG-keyed twin of :func:`quarantine` for ``ssr_dag_call`` dispatch."""
    cache = cache or global_cache()
    key = dag_cache_key(nests, operands, mode=mode, out_dtype=out_dtype,
                        cores=cores, uniforms=uniforms, device=device)
    cache.quarantine(key)
    return key


def enumerate_cuts(dag: ChainDAG) -> List[Tuple[int, ...]]:
    """Every subset of edge indices, smallest cuts first: ``()`` (all
    fused) first, the full cut (all unfused) last."""
    idx = range(len(dag.edges))
    cuts: List[Tuple[int, ...]] = []
    for r in range(len(dag.edges) + 1):
        cuts.extend(itertools.combinations(idx, r))
    return cuts


def dag_cut_is_legal(dag: ChainDAG, cut: Sequence[int], *,
                     sched: Schedule = DEFAULT_SCHEDULE,
                     itemsize: int = 4,
                     nests: Optional[Sequence[LoopNest]] = None,
                     bodies: Optional[Sequence[Callable]] = None,
                     mode: str = "map", out_dtype: Any = torch.float32,
                     uniforms: Optional[Dict[str, Any]] = None,
                     num_lanes: Optional[int] = None,
                     device: DeviceLike = None) -> Tuple[bool, str]:
    """(legal, reason) for one cut: every component has a single exit.

    The reference also holds each component's working set to the TPU's
    VMEM budget; the port does not (a block here is a walk over device
    memory).  On a CUDA ``device``, given the ``nests`` and ``bodies``, each
    component's kernel must also be one the card runs
    (:func:`hopper.accepts`).
    """
    from .lowering import (_component_exit, _dag_components,
                           component_kernel, dag_components)

    cutset = frozenset(int(i) for i in cut)
    for i in cutset:
        if not 0 <= i < len(dag.edges):
            return False, (f"edge index {i} out of range for "
                           f"{len(dag.edges)} edges")
    for comp in _dag_components(dag, cutset):
        try:
            _component_exit(dag, comp, cutset)
        except LoweringError as e:
            return False, str(e)
    if nests is None or bodies is None or device is None \
            or torch.device(device).type != "cuda":
        return True, "ok"
    shapes = tuple(tuple(u.shape) if u.dim() > 1 else (1, u.shape[0])
                   for u in (torch.as_tensor(v) for v in
                             (uniforms or {}).values()))
    try:
        comps = dag_components(dag, tuple(nests), tuple(bodies), cutset,
                               mode=mode, num_lanes=num_lanes,
                               schedule=sched)
        for comp in comps:
            kernel = component_kernel(comp, out_dtype=torch_dtype(out_dtype),
                                      num_lanes=num_lanes, schedule=sched,
                                      uniforms=shapes)
            takes, why = hopper.accepts(kernel.device_key, kernel.geometry,
                                        torch.float32, device,
                                        program=kernel.program)
            if not takes:
                return False, f"component {comp.stages}: {why}"
    except LoweringError as e:
        return False, str(e)
    return True, "ok"


def dag_model_cost(dag: ChainDAG, cut: Sequence[int], *,
                   sched: Schedule = DEFAULT_SCHEDULE,
                   step_cost: int = STEP_COST) -> float:
    """Eq. (1)–(3) cost of executing the DAG under one cut.

    Each fused component is ONE stream region (single setup, bodies summed,
    union of lanes); each cut edge charges the store its producer pays and
    the load its consumer re-issues; every component pays the per-grid-step
    charge of its own kernel.
    """
    from .compiler import _fused_region_count
    from .lowering import _dag_components

    cutset = frozenset(int(i) for i in cut)
    comps = _dag_components(dag, cutset)
    elems = math.prod(dag.bounds)
    steps = -(-dag.bounds[-1] // sched.block_elems) * \
        math.prod(dag.bounds[:-1])
    half = step_cost / 2.0
    per_step = half + half / (_max_depth(sched) - 1)
    total = 0.0
    for comp in comps:
        total += _fused_region_count([dag.stages[s] for s in comp],
                                     dag.bounds)
        total += per_step * steps
    cut_names = {dag.edges[i].name for i in cutset}
    total += elems * (len(cutset) + len(cut_names))  # loads + stores
    return float(total)


def autotune_dag(nests: Sequence[LoopNest], bodies: Sequence[Callable],
                 operands: Dict[str, Any], *,
                 mode: str = "map", out_dtype: Any = "float32",
                 num_lanes: Optional[int] = None,
                 top_k: int = 4, warmup: int = 1, iters: int = 3,
                 cores: int = 1,
                 cache: Optional[ScheduleCache] = None,
                 use_cache: bool = True, force: bool = False,
                 uniforms: Optional[Dict[str, Any]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 device: DeviceLike = None) -> TuneResult:
    """Search the DAG's legal cuts → prune by model → measure → commit.

    The all-fused cut ``()`` and the full cut (the unfused composition)
    always race.  The winner is committed as a :class:`Schedule` whose
    ``cut_edges`` records the partition, under :func:`dag_cache_key`, so a
    later plain ``ssr_dag_call`` resolves it.  On a CUDA device the card is
    synchronized before each clock read, legality adds each component
    kernel's acceptance, and a cut that beats all-fused by no more than the
    race's spread is held back for all-fused (``held_back``).  ``timings``
    holds each survivor as its schedule and best µs.
    """
    from .lowering import _dag_for, _uniform_items, ssr_dag_call

    dev = resolve_device(call_device(operands, device))
    nests = tuple(nests)
    bodies = tuple(bodies)
    dag = _dag_for(nests, num_lanes)
    cache = cache or (global_cache() if use_cache else None)
    # normalised exactly like ssr_dag_call, so the committed key is the one
    # its dispatch looks up
    uniforms = dict(_uniform_items(uniforms, dev))
    key = dag_cache_key(nests, operands, mode=mode, out_dtype=out_dtype,
                        cores=cores, uniforms=uniforms, device=dev)
    if cache is not None and not force:
        hit = cache.get(key)
        if hit is not None:
            meta = cache.meta(key) or {}
            m = meta.get("meta", {})
            return TuneResult(key=key, schedule=hit,
                              tuned_us=float(m.get("tuned_us", 0.0)),
                              default_us=float(m.get("default_us", 0.0)),
                              candidates=int(m.get("candidates", 0)),
                              measured=0, from_cache=True)

    legal = [c for c in enumerate_cuts(dag)
             if dag_cut_is_legal(dag, c, nests=nests, bodies=bodies,
                                 mode=mode, out_dtype=out_dtype,
                                 uniforms=uniforms, num_lanes=num_lanes,
                                 device=dev)[0]]
    full = tuple(range(len(dag.edges)))
    ranked = sorted(legal, key=lambda c: (dag_model_cost(dag, c), c))
    survivors = ranked[:max(1, top_k)]
    for anchor in ((), full):            # both endpoints always race
        if anchor in legal and anchor not in survivors:
            survivors.append(anchor)
    scheds = [dataclasses.replace(DEFAULT_SCHEDULE, cut_edges=c)
              for c in survivors]

    def call(sched: Schedule):
        return ssr_dag_call(nests, bodies, operands, mode=mode,
                            out_dtype=torch_dtype(out_dtype), schedule=sched,
                            num_lanes=num_lanes, device=dev,
                            uniforms=uniforms)

    clock = clock or time.perf_counter
    samples: List[List[float]] = [[] for _ in scheds]
    try:
        for _ in range(max(0, warmup)):
            for sched in scheds:
                call(sched)
                _synchronize(dev)
        for _ in range(max(1, iters)):
            for i, sched in enumerate(scheds):
                resilience.inject("measure")
                t0 = clock()
                call(sched)
                _synchronize(dev)
                samples[i].append(clock() - t0)
    except resilience.fallback_error_types() as e:
        resilience.record_fallback(
            seam=resilience.classify(e), site="autotune_dag", error=e,
            from_schedule="measure", to_schedule="default", key=key)
        return TuneResult(key=key, schedule=DEFAULT_SCHEDULE, tuned_us=0.0,
                          default_us=0.0, candidates=len(legal), measured=0,
                          degraded=True, committed=False)
    i_fused = survivors.index(()) if () in survivors else None
    if i_fused is None:      # all-fused illegal: the fastest legal cut
        tuned_us, i_win = min((min(xs) * 1e6, i)
                              for i, xs in enumerate(samples))
        winner, fused_us, held_back = scheds[i_win], float("inf"), False
    else:
        winner, tuned_us, fused_us, held_back = _pick(
            scheds, samples, i_fused, on_card=dev.type == "cuda")

    committed = False
    if cache is not None:
        try:
            cache.put(key, winner, meta={
                "tuned_us": tuned_us, "default_us": fused_us,
                "candidates": len(legal), "measured": len(survivors),
                "held_back": held_back,
                "dag": [nest_signature(n) for n in nests],
                "edges": len(dag.edges),
                "cut_edges": list(winner.cut_edges),
                "mode": mode, "out_dtype": dtype_name(out_dtype),
                "cores": cores, "backend": _backend(dev),
            })
            committed = True
        except resilience.fallback_error_types() as e:
            resilience.record_fallback(
                seam=resilience.classify(e), site="autotune_dag", error=e,
                from_schedule="winner", to_schedule="uncommitted", key=key)
    return TuneResult(key=key, schedule=winner, tuned_us=tuned_us,
                      default_us=fused_us, candidates=len(legal),
                      measured=len(survivors), committed=committed,
                      held_back=held_back,
                      timings=tuple((s, min(xs) * 1e6)
                                    for s, xs in zip(scheds, samples)))
