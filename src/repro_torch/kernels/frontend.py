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

The monolithic baselines (``MonolithicKernel``) and the waivered
``StreamKernel``/``ChainedKernel`` shells come with later slices of the
port; this one carries the streamed path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .. import DeviceLike, resolve_device, to_device
from ..core.lowering import DEFAULT_SCHEDULE, Schedule, _body_key, ssr_call

ROWS = 8
LANES = 128
BLOCK_ELEMS = ROWS * LANES
COMPUTE_DTYPE = torch.float32

#: ``builds`` counts per-signature entries built (nest + body resolved),
#: ``calls`` counts ``NestKernel.__call__``.  A repeated call with the same
#: signature moves ``calls`` only.
DISPATCH_STATS: Dict[str, int] = {"builds": 0, "calls": 0}

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

    The schedule is :data:`DEFAULT_SCHEDULE` or the caller's
    ``schedule=``; this slice of the port reads no tuned schedule cache.
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

    def __call__(self, *args, schedule: Optional[Schedule] = None,
                 device: DeviceLike = None, **params):
        """Run prepare → ssr_call → finish on ``device``."""
        DISPATCH_STATS["calls"] += 1
        dev = resolve_device(device)
        args = on_device(args, dev)
        operands, static, final = self._prepare(*args, **params)
        key = (_call_key(args, params), schedule)
        entry = self._cache.get(key)
        if entry is None:
            kw = {} if self._out_dtype is None else \
                {"out_dtype": self._out_dtype(static)}
            entry = (self._nest(static), self._body(static), kw)
            DISPATCH_STATS["builds"] += 1
            if len(self._cache) >= _PIPELINE_CACHE_MAX:
                self._cache.clear()
            self._cache[key] = entry
        nest, body, kw = entry
        out = ssr_call(nest, body, dict(operands), mode=self._mode,
                       schedule=schedule or DEFAULT_SCHEDULE, device=dev,
                       **kw)
        return self._finish(out, final) if self._finish else out
