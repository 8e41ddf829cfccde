"""Carry state across from the JAX reference package, without importing it.

This system has no weights; its state is its geometry objects and its
operands.  Each helper rebuilds the port's object from a reference object's
fields (duck typing: nothing here imports ``repro`` or JAX):

* :func:`schedule_from_reference` — a ``Schedule`` through its JSON form;
* :func:`loop_nest_from_reference` / :func:`memref_from_reference` — the
  compiler's input IR, field by field;
* :func:`to_tensor` / :func:`operands_to_tensors` — numpy operands as
  tensors on a chosen device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from . import DeviceLike, resolve_device
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
