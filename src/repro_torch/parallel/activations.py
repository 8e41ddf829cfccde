"""Activation sharding constraints (ambient, divisibility-guarded).

The reference pins its activations and scan carries to the ambient device
mesh with :func:`constrain`, which resolves symbolic axis groups against
that mesh::

    constrain(h, BATCH, None, MODEL)   # (B over dp axes, S, D over model)

Outside a mesh (one device) it returns its input unchanged, and so does
the port's: the port runs on one device until the multi-device layer
(port slice 9d: ``launch/mesh.py``, ``parallel/{sharding,collectives}.py``)
lands, so setting a mesh raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from torch.utils import _pytree as pytree

BATCH = "__batch__"    # data-parallel axes ('pod','data')
MODEL = "__model__"    # tensor-parallel axis
BOTH = "__both__"      # all axes (sequence sharding for B=1 cells)

#: the slice that gives the port a device mesh
MESH_SLICE = ("port slice 9d (launch/mesh.py, parallel/sharding.py and "
              "parallel/collectives.py)")

_state = threading.local()


def set_activation_mesh(mesh: Optional[Any]) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"an activation mesh: the port runs on one device until "
            f"{MESH_SLICE}")
    _state.mesh = None


def get_activation_mesh() -> Optional[Any]:
    return getattr(_state, "mesh", None)


class activation_mesh:
    """Context manager pinning the ambient mesh for constraints (only
    ``None`` until the port has meshes)."""

    def __init__(self, mesh: Optional[Any]):
        self.mesh = mesh

    def __enter__(self):
        self.prev = get_activation_mesh()
        set_activation_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_activation_mesh(self.prev)


def constrain(x, *pattern):
    """Apply a symbolic sharding constraint; the identity without a mesh,
    which is always the case in the port so far."""
    return x


def constrain_tree(tree, *pattern):
    return pytree.tree_map(lambda x: constrain(x, *pattern), tree)
