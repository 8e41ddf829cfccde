"""Carry state across from the JAX reference package, without importing it.

This system has no weights; its state is its geometry objects, its
operands and the schedule cache.  Each helper rebuilds the port's object
from a reference object's fields (duck typing: nothing here imports
``repro`` or JAX):

* :func:`schedule_from_reference` — a ``Schedule`` through its JSON form;
* :func:`loop_nest_from_reference` / :func:`memref_from_reference` — the
  compiler's input IR, field by field;
* :func:`to_tensor` / :func:`operands_to_tensors` — numpy operands as
  tensors on a chosen device;
* :func:`rekey_schedule` — a schedule committed for one backend (a single
  nest's, or a fused DAG's with its ``cut_edges``), served under another
  backend's key.

The schedule cache needs no conversion: both packages write the same
document (``version``, ``schedule`` JSON, ``meta``) under the same key for
the same nest, shapes and backend, so one cache directory serves both.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import DeviceLike, resolve_device
from .core import autotune
from .core.lowering import Schedule
from .core.nest_analysis import LoopNest, MemRef
from .core.stream import Direction


def schedule_from_reference(schedule: Any) -> Schedule:
    """The port's :class:`Schedule` equal to a reference schedule."""
    return Schedule.from_json(schedule.to_json())


def memref_from_reference(ref: Any) -> MemRef:
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(MemRef)}
    fields["kind"] = Direction(ref.kind.value)
    return MemRef(**fields)


def loop_nest_from_reference(nest: Any) -> LoopNest:
    """The port's :class:`LoopNest` with the reference nest's fields."""
    return LoopNest(bounds=tuple(nest.bounds),
                    refs=tuple(memref_from_reference(r) for r in nest.refs),
                    compute_per_level=tuple(nest.compute_per_level))


def to_tensor(array: Any, device: DeviceLike = None) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor."""
    return torch.as_tensor(np.asarray(array), device=resolve_device(device))


def operands_to_tensors(operands: Dict[str, Any],
                        device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    return {name: to_tensor(a, device) for name, a in operands.items()}


def _schedule_key(nest: Any, operands: Dict[str, Any], backend: str,
                  mode: Optional[str], out_dtype: Any, cores: int,
                  uniforms: Optional[Dict[str, Any]]) -> str:
    """The cache key of a single-nest problem, or of a DAG's when ``nest``
    is a sequence of nests."""
    if isinstance(nest, (tuple, list)):
        return autotune.dag_cache_key(nest, operands, mode=mode or "map",
                                      out_dtype=out_dtype, backend=backend,
                                      cores=cores, uniforms=uniforms)
    return autotune.cache_key(nest, operands, mode=mode or "reduce",
                              out_dtype=out_dtype, backend=backend,
                              cores=cores)


def rekey_schedule(nest: Any, operands: Dict[str, Any], *,
                   from_backend: str, to_backend: str,
                   mode: Optional[str] = None, out_dtype: Any = "float32",
                   cores: int = 1,
                   cache: Optional[autotune.ScheduleCache] = None,
                   uniforms: Optional[Dict[str, Any]] = None
                   ) -> Optional[str]:
    """Serve the schedule committed for ``from_backend`` (a reference run's
    ``"cpu"`` or ``"tpu"``, say) under ``to_backend``'s key as well.

    ``nest`` is one nest (the key of ``cache_key``, mode ``"reduce"`` by
    default) or the sequence of a DAG's nests (the key of
    ``dag_cache_key``, mode ``"map"`` by default, with its ``uniforms``);
    either package's nests will do (the signature reads the same fields).
    The schedule — a DAG's ``cut_edges`` included — is copied unchanged,
    its ``meta`` kept and marked with where it came from.  Returns the new
    key, or ``None`` when nothing is committed under ``from_backend``.
    """
    cache = cache or autotune.global_cache()
    kw = dict(mode=mode, out_dtype=out_dtype, cores=cores,
              uniforms=uniforms)
    src = _schedule_key(nest, operands, from_backend, **kw)
    doc = cache.meta(src)
    if doc is None:
        return None
    dst = _schedule_key(nest, operands, to_backend, **kw)
    cache.put(dst, Schedule.from_json(doc["schedule"]),
              meta={**doc.get("meta", {}),
                    "rekeyed_from": {"key": src, "backend": from_backend}})
    return dst
