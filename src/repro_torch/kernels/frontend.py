"""Shared kernel frontend: operands in, streamed kernel, result out.

The loop prologue/epilogue of the paper's Fig. 4 (steps ① and ④), as in
``repro.kernels.frontend``.  :class:`NestKernel` is the declarative shell:
a kernel module states a :class:`~repro_torch.core.LoopNest` plus a block
body, and the whole schedule — grid, index maps, repeat streams,
contraction accumulators, padding — comes out of
``ssrify``/``lower_plan``/``lower_nest`` via
:func:`repro_torch.core.lowering.ssr_call`.

Dtype policy: bodies compute in :data:`COMPUTE_DTYPE` (f32) whatever the
storage dtype; :func:`promote` is the one place that states it.

:class:`MonolithicKernel` is the same contract for the *baseline*
variants: the kernel walks the padded operands block by block with an
explicit load per block, on the card through the Hopper baseline kernel of
the body's ``op`` (:data:`~repro_torch.core.hopper.BASELINE_KERNELS`), on
the CPU through the body's plain version — so "baseline" and "ssr" differ
only in how operands are delivered.

:class:`StreamKernel` is the waivered escape hatch: a module hands it a raw
:class:`Launch` (grid, read and write :class:`BlockStream`\\ s, scratch,
dimension semantics) with a mandatory ``lowering_waiver`` stating why the
pattern is outside the block-granular AGU model (a carried scan total, an
FFT's per-stage strides, a sort network's compare-exchanges).  On the CPU
the Launch runs as an in-order block walk
(:func:`~repro_torch.core.hopper.plain_stream`); on the card the Hopper
kernel of the body's ``op`` (:data:`~repro_torch.core.hopper.STREAM_KERNELS`)
runs it, or at a depth above 2 its ring kernel (:data:`~repro_torch.core.
hopper.STREAM_RING_KERNELS`: R15 for the scan).

:class:`ChainedKernel` is the waivered producer→consumer fusion: a Launch
with one output stream, a producer body over each step's read blocks and a
unary consumer body over the producer's block, in the same step, the
intermediate never in device memory.  On the CPU the Launch runs as a block
walk of the two bodies (:func:`~repro_torch.core.hopper.plain_chained`); on
the card the Hopper kernel of the pair of body ops runs it: K17
``chained_map``, or R5 ``ring_chained_map`` at a uniform ``buffer_depth``
above 2, its read streams through the stage ring (the reference's
``_pipelined_call``).

:class:`NestKernel` resolves its schedule from the autotuner's cache when
none is given, and owns the tuned → default degradation ladder.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import DeviceLike, resolve_device, to_device
from ..core import autotune, hopper, resilience
from ..core.lowering import DEFAULT_SCHEDULE, Schedule, _body_key, ssr_call
from ..core.agu import RingProgram
from ..core.ssr import BlockStream, LoweringError, _depths, pipeline_supported

ROWS = 8
LANES = 128
BLOCK_ELEMS = ROWS * LANES
COMPUTE_DTYPE = torch.float32

#: ``builds`` counts per-signature entries built (nest, body and schedule
#: resolved, or a baseline's kernel chosen), ``calls`` counts calls of a
#: kernel shell.  A repeated call with the same signature moves ``calls``
#: only.  ``fallbacks``/``degraded`` mirror the lowering counters: lookups
#: abandoned for the default schedule, and tuned entries quarantined and
#: rebuilt on the default — zero when healthy.
DISPATCH_STATS: Dict[str, int] = {"builds": 0, "calls": 0, "fallbacks": 0,
                                  "degraded": 0}

#: Built-entry cap per kernel instance: stops pathological shape churn.
_PIPELINE_CACHE_MAX = 512


def reset_dispatch_stats() -> None:
    for k in DISPATCH_STATS:
        DISPATCH_STATS[k] = 0


def _is_arraylike(x: Any) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _static_key(v: Any) -> Any:
    """Hashable identity for a non-array call ingredient (param or arg)."""
    if callable(v):
        return _body_key(v)
    try:
        hash(v)
        return v
    except TypeError:
        return repr(v)


def _call_key(args: tuple, params: Dict[str, Any]) -> Any:
    """Cache key over raw call inputs: array shapes/dtypes + static values."""
    arg_key = tuple(
        (tuple(a.shape), str(a.dtype)) if _is_arraylike(a) else
        ("static", _static_key(a))
        for a in args)
    param_key = tuple(sorted((k, _static_key(v)) for k, v in params.items()))
    return arg_key, param_key


def on_device(args: tuple, device: torch.device) -> tuple:
    """Array-like arguments as tensors on ``device``; the rest unchanged."""
    return tuple(to_device(a, device) if _is_arraylike(a) else a
                 for a in args)


def promote(x: torch.Tensor) -> torch.Tensor:
    """Cast a block to the compute dtype (f32 accumulation everywhere)."""
    return x.to(COMPUTE_DTYPE)


# -- operand canonicalisation helpers ---------------------------------------


def pad_vector(x: torch.Tensor, *, block: int = BLOCK_ELEMS,
               lanes: int = LANES) -> torch.Tensor:
    """Zero-pad a 1-D tensor to whole blocks; reshape to (rows, lanes)."""
    pad = (-x.shape[0]) % block
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(-1, lanes)


def trim_vector(out: torch.Tensor, n: int) -> torch.Tensor:
    """Undo :func:`pad_vector`: flatten and drop the padding tail."""
    return out.reshape(-1)[:n]


def pad_leading(a: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad the leading (row) dim of a matrix to a multiple of ``mult``."""
    pad = (-a.shape[0]) % mult
    if pad:
        a = F.pad(a, (0, 0, 0, pad))
    return a


def require_power_of_two(n: int, what: str) -> None:
    # n & (n - 1) alone accepts n == 0 (0 & -1 == 0): an empty operand would
    # reach the stage loops and fail far from the cause
    if n <= 0 or n & (n - 1):
        raise ValueError(f"{what} needs a power-of-two length, got {n}")


# -- declarative kernel shells ----------------------------------------------


class ShapeDtype(NamedTuple):
    """An output's or a scratch buffer's shape and dtype (the counterpart of
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel's stream geometry, as declared by its module."""

    grid: Tuple[int, ...]
    in_streams: Tuple[BlockStream, ...]
    out_streams: Tuple[BlockStream, ...]
    out_shapes: Tuple[ShapeDtype, ...]
    scratch_shapes: Tuple[ShapeDtype, ...] = ()
    dimension_semantics: Optional[Tuple[str, ...]] = None


def _require_waiver(name: str, waiver: Optional[str]) -> str:
    """Hand-scheduled geometry must state why the compiler cannot emit it."""
    if not waiver or not waiver.strip():
        raise ValueError(
            f"kernel {name!r} constructs a Launch without a lowering_waiver; "
            "declare why the pattern is outside the block-granular AGU "
            "model, or migrate to NestKernel")
    return waiver


def _tagged_kernel(body: Callable, kernels: Dict[str, Callable],
                   what: str) -> Callable:
    op = getattr(body, "op", None)
    kernel = kernels.get(op)
    if kernel is None:
        raise LoweringError(
            f"no Hopper {what} kernel for a body with op {op!r} ({body!r}); "
            f"the {what} kernels are {sorted(kernels)} — wrap the body in "
            "KernelBody(fn, op) or run on the CPU")
    return kernel


def stream_kernel(body: Callable) -> Callable[..., tuple]:
    """The Hopper stream kernel for a tagged body, or a LoweringError naming
    the missing kernel."""
    return _tagged_kernel(body, hopper.STREAM_KERNELS, "stream")


def stream_ring_kernel(body: Callable) -> Callable[..., tuple]:
    """The Hopper stream ring kernel for a tagged body, called as
    ``kernel(launch, *arrays, ring=...)``, or a LoweringError naming the
    missing kernel."""
    return _tagged_kernel(body, hopper.STREAM_RING_KERNELS, "stream ring")


def chained_kernel(producer: Callable, consumer: Callable
                   ) -> Callable[..., tuple]:
    """The Hopper kernel for a ChainedKernel's pair of tagged bodies,
    called as ``kernel(launch, *arrays, ring=...)``, or a LoweringError
    naming the missing kernel."""
    pair = (getattr(producer, "op", None), getattr(consumer, "op", None))
    if pair not in hopper.CHAINED_PROGRAMS:
        raise LoweringError(
            f"no Hopper chained kernel for producer op {pair[0]!r} "
            f"({producer!r}) → consumer op {pair[1]!r} ({consumer!r}); K17 "
            f"runs {sorted(hopper.CHAINED_PROGRAMS)} — wrap the bodies in "
            "KernelBody(fn, op) or run on the CPU")
    return functools.partial(hopper.chained_map, producer, consumer)


def baseline_kernel(body: Callable) -> Callable[..., torch.Tensor]:
    """The Hopper baseline kernel for a tagged body, or a LoweringError
    naming the missing kernel."""
    return _tagged_kernel(body, hopper.BASELINE_KERNELS, "baseline")


class MonolithicKernel:
    """A baseline kernel: the body walks the padded layouts with explicit
    per-block loads (the paper's serialised load → compute issue).

    ``prepare(*args, **params) -> (layouts, static, final)`` pads the
    operands; ``body(static)`` gives the baseline's plain version over the
    padded layouts, ``fn(*layouts, out_dtype=...)``, tagged with its device
    kernel's ``op`` (a :class:`~repro_torch.core.ssr.KernelBody`);
    ``out_dtype(static, *layouts)`` its output dtype; ``finish(out,
    final)`` trims.  On a CUDA tensor the call launches the baseline kernel
    of ``op`` or raises; on the CPU it runs the plain version.  The chosen
    callable is cached on the raw call inputs (shapes, dtypes, static
    values); padding and trimming run on every call.  The baseline has no
    streams, so it takes no schedule.
    """

    def __init__(self, name: str, *, prepare: Callable, body: Callable,
                 out_dtype: Callable, finish: Optional[Callable] = None):
        self.name = name
        self._prepare = prepare
        self._body = body
        self._out_dtype = out_dtype
        self._finish = finish
        self._cache: Dict[Any, Callable] = {}

    def _build(self, static, arrays: tuple) -> Callable:
        body = self._body(static)
        out_dtype = self._out_dtype(static, *arrays)

        def run(*layouts: torch.Tensor) -> torch.Tensor:
            if layouts[0].device.type == "cpu":
                return body(*layouts, out_dtype=out_dtype)
            return baseline_kernel(body)(*layouts, out_dtype=out_dtype)

        return run

    def __call__(self, *args, device: DeviceLike = None, **params):
        DISPATCH_STATS["calls"] += 1
        dev = resolve_device(device)
        args = on_device(args, dev)
        arrays, static, final = self._prepare(*args, **params)
        key = _call_key(args, params)
        fn = self._cache.get(key)
        if fn is None:
            fn = self._build(static, tuple(arrays))
            DISPATCH_STATS["builds"] += 1
            if len(self._cache) >= _PIPELINE_CACHE_MAX:
                self._cache.clear()
            self._cache[key] = fn
        out = fn(*arrays)
        return self._finish(out, final) if self._finish else out


class StreamKernel:
    """A streamed kernel whose geometry the module states as a
    :class:`Launch` (``launch(static, *arrays) -> Launch``), with a
    mandatory ``lowering_waiver`` — prefer :class:`NestKernel`.

    ``prepare(*args, **params) -> (arrays, static, final)`` pads and
    reshapes the operands; ``body(static)`` gives the block body, called
    as ``fn(step, *in_blocks, *scratch) -> (out_blocks, scratch)`` where
    ``step`` counts the steps of the walk along the Launch's sequential
    (``arbitrary``) axes from 0 — the counterpart of ``pl.program_id`` —
    and the scratch is carried from one step to the next (the counterpart
    of VMEM scratch); ``finish(out, final)`` trims (``out`` is the one
    output, or the tuple of them).  On the CPU the Launch runs as an
    in-order block walk (:func:`~repro_torch.core.hopper.plain_stream`:
    ``parallel`` axes batched, as ``vmap`` batches a kernel); on a CUDA
    tensor the body must be a :class:`~repro_torch.core.ssr.KernelBody`
    whose ``op`` names a Hopper stream kernel, which runs it or raises.

    ``schedule=``'s ``buffer_depth`` is validated as the reference's
    ``ssr_pallas`` validates it, and decides "pipelined" as ``ssr_pallas``
    does: above 2, on a grid of more than one step, where
    :func:`~repro_torch.core.ssr.pipeline_supported` and the body's ``op``
    has a ring kernel (:data:`~repro_torch.core.hopper.
    STREAM_RING_KERNELS`), the read streams arrive through the stage ring —
    on the CPU the block walk over :func:`~repro_torch.core.hopper.
    ring_delivery`'s blocks, on the card R15 ``ring_stream_scan`` for the
    scan.  Everything else runs its sync kernel at any depth (the FFT and
    the sort have a one-step grid).  The built entry (Launch, body, ring,
    the device kernel) is cached on the raw call inputs and the schedule;
    prepare and finish run on every call.
    """

    def __init__(self, name: str, *, prepare: Callable, launch: Callable,
                 body: Callable, finish: Optional[Callable] = None,
                 lowering_waiver: Optional[str] = None):
        self.name = name
        self.lowering_waiver = _require_waiver(name, lowering_waiver)
        self._prepare = prepare
        self._launch = launch
        self._body = body
        self._finish = finish
        self._cache: Dict[Any, Callable] = {}

    def _build(self, static, arrays: tuple,
               schedule: Optional[Schedule]) -> Callable:
        lc: Launch = self._launch(static, *arrays)
        if len(lc.out_streams) != len(lc.out_shapes):
            raise ValueError("one out_shape per output stream")
        depths = _depths((schedule or DEFAULT_SCHEDULE).buffer_depth,
                         len(lc.in_streams), beyond="would eat the VMEM budget")
        ins, _ = hopper.launch_walks(lc)   # every stream's walk is affine
        body = self._body(static)
        ring = None
        if (max(depths, default=2) > 2 and math.prod(lc.grid) > 1
                and pipeline_supported()
                and getattr(body, "op", None) in hopper.STREAM_RING_KERNELS):
            ring = RingProgram(depths, tuple(not any(any(c) for c in a.coeffs)
                                             for a in ins))

        def run(*arrays: torch.Tensor) -> tuple:
            if arrays[0].device.type == "cpu":
                return hopper.plain_stream(body, lc, arrays, ring=ring)
            if ring is None:
                return stream_kernel(body)(lc, *arrays)
            return stream_ring_kernel(body)(lc, *arrays, ring=ring)

        run.ring = ring                # the built entry's ring (None: sync)
        return run

    def __call__(self, *args, schedule: Optional[Schedule] = None,
                 device: DeviceLike = None, **params):
        DISPATCH_STATS["calls"] += 1
        dev = resolve_device(device)
        args = on_device(args, dev)
        arrays, static, final = self._prepare(*args, **params)
        key = (_call_key(args, params), schedule)
        fn = self._cache.get(key)
        if fn is None:
            fn = self._build(static, tuple(arrays), schedule)
            DISPATCH_STATS["builds"] += 1
            if len(self._cache) >= _PIPELINE_CACHE_MAX:
                self._cache.clear()
            self._cache[key] = fn
        outs = fn(*arrays)
        out = outs[0] if len(outs) == 1 else outs
        return self._finish(out, final) if self._finish else out


class NestKernel:
    """A kernel whose schedule IS its :class:`~repro_torch.core.LoopNest`.

    The module supplies

    * ``prepare(*args, **params) -> (operands, static, final)`` — operand
      canonicalisation; ``operands`` maps the nest's MemRef names to
      tensors (the lowering owns padding and layout);
    * ``nest(static) -> LoopNest`` — the §3.2 compiler input;
    * ``body(static) -> fn(*blocks)`` — the compute region; a
      :class:`~repro_torch.core.ssr.KernelBody` to run on the card;
    * ``finish(out, final)`` — result post-processing (trim, cast);
    * ``out_dtype(static)`` — the output dtype (None: f32 accumulation).

    With ``schedule=None`` the schedule comes from the autotuner's cache
    (:func:`repro_torch.core.autotune.lookup`), resolved when an entry is
    built; the entry cache keys on :func:`autotune.epoch`, so a newly
    committed winner rebuilds on the next call.
    """

    def __init__(self, name: str, *, prepare: Callable, nest: Callable,
                 body: Callable, mode: str = "reduce",
                 finish: Optional[Callable] = None,
                 out_dtype: Optional[Callable] = None):
        self.name = name
        self._prepare = prepare
        self._nest = nest
        self._body = body
        self._mode = mode
        self._finish = finish
        self._out_dtype = out_dtype
        self._cache: Dict[Any, tuple] = {}

    def loop_nest(self, static):
        """The nest this kernel executes — exposed for cost-model oracles."""
        return self._nest(static)

    def _out_dtype_of(self, static) -> torch.dtype:
        return torch.float32 if self._out_dtype is None else \
            self._out_dtype(static)

    def _lookup(self, operands, static, dev: torch.device) -> Schedule:
        return autotune.lookup(self._nest(static), dict(operands),
                               mode=self._mode,
                               out_dtype=self._out_dtype_of(static),
                               device=dev)

    def schedule_for(self, *args, device: DeviceLike = None,
                     **params) -> Schedule:
        """The schedule this call would run: tuned (cache hit) or default."""
        dev = resolve_device(device)
        operands, static, _final = self._prepare(*on_device(args, dev),
                                                 **params)
        return self._lookup(operands, static, dev)

    def __call__(self, *args, schedule: Optional[Schedule] = None,
                 device: DeviceLike = None, **params):
        """Run prepare → ssr_call → finish on ``device``.

        **Degradation**: the entry hands ``ssr_call`` an explicit schedule,
        so this level owns the ladder.  A typed failure
        (:func:`resilience.fallback_error_types`: an injected fault, cache
        I/O, a ``LoweringError``) under a *tuned* schedule quarantines the
        cache entry and runs the call again on the default schedule.  An
        explicit ``schedule=`` always propagates the error, and so does a
        kernel that fails to build or launch.
        """
        DISPATCH_STATS["calls"] += 1
        dev = resolve_device(device)
        args = on_device(args, dev)
        try:
            return self._dispatch(args, params, schedule, dev)
        except resilience.fallback_error_types() as e:
            if schedule is not None:
                raise
            key = self._quarantine_tuned(args, params, dev)
            if key is None:
                raise
            DISPATCH_STATS["degraded"] += 1
            resilience.record_fallback(
                seam=resilience.classify(e), site=f"nest_kernel:{self.name}",
                error=e, from_schedule="tuned", to_schedule="default",
                key=key)
            return self._dispatch(args, params, DEFAULT_SCHEDULE, dev)

    def _quarantine_tuned(self, args, params,
                          dev: torch.device) -> Optional[str]:
        """Sideline the committed tuned entry for this call, if any.

        Returns the quarantined key, or ``None`` when the call was already
        on the default schedule (the failure is genuine and propagates).
        """
        try:
            operands, static, _final = self._prepare(*args, **params)
            if self._lookup(operands, static, dev) == DEFAULT_SCHEDULE:
                return None
            return autotune.quarantine(
                self._nest(static), dict(operands), mode=self._mode,
                out_dtype=self._out_dtype_of(static), device=dev)
        except Exception:  # re-probe failed: keep the original error
            return None

    def _dispatch(self, args, params, schedule: Optional[Schedule],
                  dev: torch.device):
        operands, static, final = self._prepare(*args, **params)
        key = (_call_key(args, params), schedule, dev,
               autotune.epoch() if schedule is None else -1)
        entry = self._cache.get(key)
        if entry is None:
            sched = schedule
            if sched is None:
                try:
                    sched = self._lookup(operands, static, dev)
                except resilience.fallback_error_types() as e:
                    DISPATCH_STATS["fallbacks"] += 1
                    resilience.record_fallback(
                        seam=resilience.classify(e),
                        site=f"nest_kernel:{self.name}", error=e,
                        from_schedule="tuned-lookup", to_schedule="default")
                    sched = DEFAULT_SCHEDULE
            kw = {} if self._out_dtype is None else \
                {"out_dtype": self._out_dtype(static)}
            resilience.inject("compile")
            entry = (self._nest(static), self._body(static), kw, sched)
            DISPATCH_STATS["builds"] += 1
            if len(self._cache) >= _PIPELINE_CACHE_MAX:
                self._cache.clear()
            self._cache[key] = entry
        nest, body, kw, sched = entry
        out = ssr_call(nest, body, dict(operands), mode=self._mode,
                       schedule=sched, device=dev, **kw)
        return self._finish(out, final) if self._finish else out


class ChainedParts(NamedTuple):
    """What one ChainedKernel call runs: the Launch, the prepared arrays,
    the two bodies, the ring where the call is pipelined (else None), and
    the ``final`` that ``finish`` takes."""

    launch: Launch
    arrays: Tuple[torch.Tensor, ...]
    producer: Callable
    consumer: Callable
    ring: Optional[RingProgram]
    final: Any

    def run(self) -> tuple:
        """The call's kernel on the arrays' device: the plain version on
        the CPU, K17 or R5 on the card."""
        if self.arrays[0].device.type == "cpu":
            return hopper.plain_chained(self.producer, self.consumer,
                                        self.launch, self.arrays,
                                        ring=self.ring)
        return chained_kernel(self.producer, self.consumer)(
            self.launch, *self.arrays, ring=self.ring)

    def plain(self) -> tuple:
        """The plain version on the arrays' device."""
        return hopper.plain_chained(self.producer, self.consumer,
                                    self.launch, self.arrays, ring=self.ring)


class ChainedKernel:
    """A fused producer→consumer kernel (stream chaining) over a module's
    :class:`Launch`, with a mandatory ``lowering_waiver``.

    ``prepare(*args, **params) -> (arrays, static, final)`` pads and
    reshapes the operands; ``launch(static, *arrays) -> Launch`` states the
    geometry, with exactly one output stream: its block and dtype are the
    intermediate's.  Per step ``producer(static)``'s body runs on the read
    blocks (in their storage dtype), its value is cast to the output dtype
    and shaped as the output block — the reference's VMEM scratch block —
    and ``consumer(static)``'s body, a unary block→block post-op, runs on
    it; its value, cast and shaped likewise, is the step's output block.
    The Launch's own scratch is accepted and never handed to the bodies.
    ``finish(out, final)`` trims.

    ``schedule=``'s uniform ``buffer_depth`` is validated as the reference's
    ``ssr_pallas`` validates it (2..8; ``stream_depths`` is not read, as in
    the reference); above 2, on a grid of more than one step, the read
    streams arrive through the stage ring (:func:`~repro_torch.core.hopper.
    ring_delivery` on the CPU, R5 on the card) where the pair of bodies has
    a Hopper kernel.  On a CUDA tensor the bodies must be
    :class:`~repro_torch.core.ssr.KernelBody`\\ s of a pair of
    :data:`~repro_torch.core.hopper.CHAINED_PROGRAMS` (K17, or R5), which
    runs them or raises.  The built entry is cached on the raw call inputs
    and the schedule; prepare and finish run on every call.
    """

    def __init__(self, name: str, *, prepare: Callable, launch: Callable,
                 producer: Callable, consumer: Callable,
                 finish: Optional[Callable] = None,
                 lowering_waiver: Optional[str] = None):
        self.name = name
        self.lowering_waiver = _require_waiver(name, lowering_waiver)
        self._prepare = prepare
        self._launch = launch
        self._producer = producer
        self._consumer = consumer
        self._finish = finish
        self._cache: Dict[Any, tuple] = {}

    def _build(self, static, arrays: tuple,
               schedule: Optional[Schedule]) -> tuple:
        lc: Launch = self._launch(static, *arrays)
        if len(lc.out_streams) != 1:
            raise ValueError(
                f"{self.name}: ChainedKernel needs exactly one output "
                "stream to size the intermediate scratch")
        depth = (schedule or DEFAULT_SCHEDULE).buffer_depth
        depths = _depths(depth, len(lc.in_streams),
                         beyond="would eat the VMEM budget")
        geo = hopper.chained_geometry(lc)     # every stream's walk is affine
        producer, consumer = self._producer(static), self._consumer(static)
        pair = (getattr(producer, "op", None), getattr(consumer, "op", None))
        ring = None
        if (max(depths, default=2) > 2 and geo.steps > 1
                and pipeline_supported()
                and ("chained", pair) in hopper.RING_KERNELS):
            ring = RingProgram(depths, tuple(not any(any(c) for c in a.coeffs)
                                             for a in geo.ins))
        return lc, producer, consumer, ring

    def parts(self, *args, schedule: Optional[Schedule] = None,
              device: DeviceLike = None, **params) -> ChainedParts:
        """What this call runs (:class:`ChainedParts`), built or from the
        cache."""
        args = on_device(args, resolve_device(device))
        arrays, static, final = self._prepare(*args, **params)
        key = (_call_key(args, params), schedule)
        entry = self._cache.get(key)
        if entry is None:
            entry = self._build(static, tuple(arrays), schedule)
            DISPATCH_STATS["builds"] += 1
            if len(self._cache) >= _PIPELINE_CACHE_MAX:
                self._cache.clear()
            self._cache[key] = entry
        lc, producer, consumer, ring = entry
        return ChainedParts(lc, tuple(arrays), producer, consumer, ring,
                            final)

    def __call__(self, *args, schedule: Optional[Schedule] = None,
                 device: DeviceLike = None, **params):
        DISPATCH_STATS["calls"] += 1
        parts = self.parts(*args, schedule=schedule, device=device, **params)
        (out,) = parts.run()
        return self._finish(out, parts.final) if self._finish else out
