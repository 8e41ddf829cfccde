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
  backend's key;
* :func:`params_from_reference` — a model's parameter tree, from the
  reference's ``init_params`` (as numpy arrays), stacked axes included, so
  both packages compute one function on one set of weights;
* :func:`train_state_from_reference` — a whole train state (params, the
  optimiser's moments and count), so both packages take one step from
  one state;
* :func:`shards_from_reference` — a rank's shards of the reference's
  params on a mesh (``parallel.sharding``), so a sharded run starts from
  the reference's numbers.

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
    """A numpy array (or anything ``np.asarray`` takes) as a tensor; numpy's
    ``bfloat16`` (``ml_dtypes``) arrives as ``torch.bfloat16``, bit for
    bit."""
    a = np.array(array)        # a writable copy: jax hands out read-only
    dev = resolve_device(device)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.as_tensor(a, device=dev)


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


def params_from_reference(params: Any, cfg: Any,
                          device: DeviceLike = None, *,
                          dtype: Optional[torch.dtype] = None
                          ) -> Dict[str, Any]:
    """The port's parameter tree holding a reference ``init_params`` tree's
    values (numpy arrays, or anything ``np.asarray`` takes).

    Both trees have one layout: ``embed``, ``frontend_proj``, ``groups``
    (per scan group, per pattern element, the block's dict stacked on the
    repeats axis), ``final_norm``, ``lm_head``; ``None`` stays ``None``.
    Every leaf is checked against the port's own tree for ``cfg`` (built on
    the meta device): the same key paths, shapes and dtypes (``dtype``,
    where given, for every leaf: a moment tree's), or ``ValueError``.
    """
    from torch.utils import _pytree as pytree

    from .models import model as mdl

    given = {pytree.keystr(path): leaf for path, leaf
             in pytree.tree_flatten_with_path(params)[0]}
    want, spec = pytree.tree_flatten_with_path(
        mdl.init_params(0, cfg, device="meta"))
    paths = [pytree.keystr(path) for path, _ in want]
    if set(given) != set(paths):
        raise ValueError(f"the reference tree's leaves are not the port's "
                         f"for {cfg.name}: {sorted(set(given) ^ set(paths))}")
    out = []
    for path, (_, w) in zip(paths, want):
        if w is None:
            if given[path] is not None:
                raise ValueError(f"{path}: the port wants None")
            out.append(None)
            continue
        t = to_tensor(given[path], device)
        want_dt = w.dtype if dtype is None else dtype
        if tuple(t.shape) != tuple(w.shape) or t.dtype != want_dt:
            raise ValueError(
                f"{path}: the reference gives {tuple(t.shape)} {t.dtype}, "
                f"the port wants {tuple(w.shape)} {want_dt}")
        out.append(t)
    return pytree.tree_unflatten(out, spec)


def train_state_from_reference(state: Any, cfg: Any, opt_cfg: Any,
                               device: DeviceLike = None) -> Dict[str, Any]:
    """The port's train state (``steps.init_train_state``'s layout) holding
    a reference train state's values: ``params`` through
    :func:`params_from_reference`, the moments ``m`` and ``v`` checked to
    the same paths and shapes in ``opt_cfg.moment_dtype``, and ``count``
    as an int32 scalar."""
    from .models.layers import dtype_of

    opt = state["opt"]
    mdt = dtype_of(opt_cfg.moment_dtype)
    count = to_tensor(opt["count"], device)
    if count.shape != () or count.dtype != torch.int32:
        raise ValueError(f"count: {tuple(count.shape)} {count.dtype}, the "
                         f"port wants an int32 scalar")
    return {"params": params_from_reference(state["params"], cfg, device),
            "opt": {"m": params_from_reference(opt["m"], cfg, device,
                                               dtype=mdt),
                    "v": params_from_reference(opt["v"], cfg, device,
                                               dtype=mdt),
                    "count": count}}


def shards_from_reference(params: Any, cfg: Any, mesh: Any,
                          device: DeviceLike = None, *,
                          inference: bool = False) -> Dict[str, Any]:
    """This rank of ``mesh``'s shards of a reference ``init_params`` tree:
    :func:`params_from_reference`, then ``parallel.sharding.shard_tree``
    by ``param_spec_tree(..., inference=inference)``."""
    from .parallel import sharding

    full = params_from_reference(params, cfg, device)
    specs = sharding.param_spec_tree(full, cfg, mesh, inference=inference)
    return sharding.shard_tree(full, specs, mesh)
