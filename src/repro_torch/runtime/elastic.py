"""Elastic scaling: restore a checkpoint onto a different mesh.

Checkpoints store full host arrays (checkpoint/manager.py), so elastic
restart is: start the new mesh's ranks → derive the sharding-policy specs
for the *same* config on the *new* mesh → ``restore(..., shardings=...)``,
each rank keeping its shards.  Batch size / microbatching are re-derived
so the global batch is preserved when the data-parallel size changes
(gradient-equivalent rescale).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .. import keypaths
from ..checkpoint.manager import CheckpointManager
from ..launch.mesh import Mesh
from ..models.config import ModelConfig
from ..parallel import sharding as shd


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_devices: int
    new_devices: int
    microbatches: int          # re-derived grad-accumulation factor
    note: str


def plan_rescale(cfg: ModelConfig, global_batch: int, old_mesh: Mesh,
                 new_mesh: Mesh) -> ElasticPlan:
    old_dp = shd.dp_size(old_mesh)
    new_dp = shd.dp_size(new_mesh)
    # keep global batch: if dp shrank k×, accumulate k× more microbatches
    micro = max(1, cfg.microbatches * max(1, old_dp // max(new_dp, 1)))
    while global_batch % micro or (global_batch // micro) % max(new_dp, 1):
        micro -= 1
        if micro == 0:
            micro = 1
            break
    return ElasticPlan(
        old_devices=old_mesh.size, new_devices=new_mesh.size,
        microbatches=micro,
        note=(f"dp {old_dp}→{new_dp}; grad-accum ×{micro} preserves "
              f"global batch {global_batch}"))


def restore_on_mesh(ckpt: CheckpointManager, step: int, template: Any,
                    cfg: ModelConfig, mesh: Mesh,
                    params_key: str = "params", *, device=None) -> Any:
    """Restore ``{params, opt, ...}`` state as this rank's shards on
    ``mesh`` (``template`` holds the full shapes: tensors or ``meta``),
    on ``device`` (as ``CheckpointManager.restore``)."""
    pspecs = shd.param_spec_tree(template[params_key], cfg, mesh)
    replicated = shd.NamedSharding(mesh, shd.P())
    shardings = {
        params_key: shd.named(mesh, pspecs),
        "opt": {
            "m": shd.named(mesh, pspecs),
            "v": shd.named(mesh, pspecs),
            "count": replicated,
        },
    }
    # leave any extra top-level entries replicated
    for k in template:
        if k not in shardings:
            shardings[k] = keypaths.map_with_path(lambda *_: replicated,
                                                  template[k])
    return ckpt.restore(step, template, device=device, shardings=shardings)
