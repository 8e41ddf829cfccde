"""Activation sharding constraints, and the ambient mesh.

The reference pins its activations and scan carries to the ambient device
mesh with :func:`constrain`, which resolves symbolic axis groups against
that mesh::

    constrain(h, BATCH, None, MODEL)   # (B over dp axes, S, D over model)

so that XLA's partitioner keeps them sharded.  The port runs explicit SPMD
(``parallel/collectives.py``): each rank computes on its own tensors and
the code places every one of them, so no layout is left for a constraint
to pin, and :func:`constrain` returns its input unchanged, under a mesh
too.  The ambient mesh itself is live: :func:`activation_mesh` sets it,
and ``models/moe.py`` reads it to pick the expert-parallel dispatch, as
the reference's does.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from torch.utils import _pytree as pytree

BATCH = "__batch__"    # data-parallel axes ('pod','data')
MODEL = "__model__"    # tensor-parallel axis
BOTH = "__both__"      # all axes (sequence sharding for B=1 cells)

_state = threading.local()


def set_activation_mesh(mesh: Optional[Any]) -> None:
    _state.mesh = mesh


def get_activation_mesh() -> Optional[Any]:
    return getattr(_state, "mesh", None)


class activation_mesh:
    """Context manager setting the ambient mesh (a
    :class:`~repro_torch.launch.mesh.Mesh`, or ``None``)."""

    def __init__(self, mesh: Optional[Any]):
        self.mesh = mesh

    def __enter__(self):
        self.prev = get_activation_mesh()
        set_activation_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_activation_mesh(self.prev)


def _axes_for(symbol, mesh):
    if symbol == BATCH:
        return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    if symbol == MODEL:
        return ("model",) if "model" in mesh.axis_names else ()
    if symbol == BOTH:
        return tuple(mesh.axis_names)
    if symbol is None:
        return ()
    return (symbol,) if symbol in mesh.axis_names else ()


def resolve_spec(shape, pattern, mesh):
    """The spec a symbolic pattern resolves to on ``mesh``, each axis kept
    only where the dim divides (the reference's)."""
    from .sharding import PartitionSpec

    out = []
    for size, symbol in zip(shape, pattern):
        keep = []
        prod = 1
        for a in _axes_for(symbol, mesh):
            n = mesh.shape[a]
            if size % (prod * n) == 0:
                keep.append(a)
                prod *= n
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return PartitionSpec(*out)


def constrain(x, *pattern):
    """The identity, with or without a mesh: in explicit SPMD every
    tensor is already where the code put it (see the module docstring)."""
    return x


def constrain_tree(tree, *pattern):
    return pytree.tree_map(lambda x: constrain(x, *pattern), tree)
