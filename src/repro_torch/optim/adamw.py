"""AdamW with global-norm clipping, decoupled weight decay, and a
configurable moment dtype (bf16 moments halve the optimiser's state).

``init`` gives a state tree mirroring the parameters (``m``, ``v``) and a
step ``count``; ``update`` applies one step.  The arithmetic is the
reference's, in f32 tensors on the parameters' device: ``count`` int32,
``b1 ** count`` and ``b2 ** count`` and the schedule's cosine in f32, every
divisor a tensor (the card's ``div`` by a host scalar multiplies by its
reciprocal, another rounding), and the leaves' squared sums added in the
reference's order, by sorted key path (``keypaths``).

Unlike the reference, which is pure and donates its buffers to ``jax.jit``,
``update`` writes the new parameters and moments into the tensors it is
given and returns those trees: a step then holds one copy of the train
state, not two.  The moments may live on another device than the
parameters (the host, where the card's memory is short): each piece is
computed on the parameters' device and written back.  Each leaf is
updated in pieces along its leading axis, so the f32 temporaries stay a
piece's size; the update is elementwise, so the pieces do not change a
bit.

Decay follows the reference's rule, ``p.ndim >= 2``.  A block's norm
weights are stacked on the repeats axis, so they are 2-D and are decayed;
only ``final_norm`` and unstacked vectors are not (reference fault C11,
kept so that updates stay comparable).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from .. import keypaths
from ..models.layers import dtype_of

#: a piece of a leaf that ``update`` computes at once, in elements
PIECE = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: Union[Callable[[torch.Tensor], torch.Tensor],
                         float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"


def _device(tree: Any) -> torch.device:
    return keypaths.leaves(tree)[0].device


def init(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments in ``cfg.moment_dtype`` and a zero int32 count, on the
    parameters' device (``meta`` parameters give ``meta`` state)."""
    dt = dtype_of(cfg.moment_dtype)

    def zeros(_, p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": keypaths.map_with_path(zeros, params),
            "v": keypaths.map_with_path(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=_device(params))}


def global_norm(tree: Any) -> torch.Tensor:
    """√Σ of the leaves' squared f32 sums, added in sorted-key-path order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in keypaths.leaves(tree)))


def _f32(x: float, device: torch.device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=device)


def _pieces(x: torch.Tensor):
    """Views of ``x`` along its leading axis, each about ``PIECE`` elements
    (a whole leaf where it has no axis or fits)."""
    if x.ndim == 0 or x.numel() <= PIECE:
        return (x,)
    rows = max(1, PIECE // max(1, x[0].numel()))
    return x.split(rows)


@torch.no_grad()
def update(grads: Any, state: Dict[str, Any], params: Any,
           cfg: AdamWConfig, *, grad_norm: Optional[torch.Tensor] = None
           ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One step → (params, state, {"grad_norm", "lr"}); ``params`` and
    ``state`` are updated in place and returned.  ``grad_norm`` is the
    gradients' global norm where the trees hold shards of the leaves (the
    sharded train step computes it over every rank); by default
    :func:`global_norm` of ``grads``."""
    dev = _device(params)
    count = state["count"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.minimum(_f32(1.0, dev), _f32(cfg.clip_norm, dev)
                              / torch.maximum(gnorm, _f32(1e-12, dev)))

    lr = cfg.learning_rate(count) if callable(cfg.learning_rate) \
        else cfg.learning_rate
    cf = count.float()
    b1c = 1.0 - torch.pow(_f32(cfg.b1, dev), cf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, dev), cf)

    def one(p, g, m, v, decay):
        # a clipped gradient is f32, as the reference's bf16 g · f32 scale
        gf = g.float() if scale is None else g.float() * scale
        # moments kept on another device (the host) are computed on the
        # parameters' and written back where they live
        m_new = cfg.b1 * m.to(p.device).float() + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v.to(p.device).float() + (1 - cfg.b2) * gf * gf
        upd = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        if decay:
            upd = upd + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
        m.copy_(m_new)
        v.copy_(v_new)

    flat_p = keypaths.leaves_with_path(params)
    flat_g, flat_m, flat_v = (keypaths.leaves(t) for t in
                              (grads, state["m"], state["v"]))
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("grads, moments and params are not one tree")
    for (_, p), g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        decay = bool(cfg.weight_decay) and p.ndim >= 2
        for piece in zip(_pieces(p), _pieces(g), _pieces(m), _pieces(v)):
            one(*piece, decay)
    state["count"].copy_(count)
    lr_out = lr.float() if isinstance(lr, torch.Tensor) else _f32(lr, dev)
    return params, state, {"grad_norm": gnorm, "lr": lr_out}


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine to
    ``floor · peak`` at ``total``; f32, as the reference's."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        dev = step.device
        s = step.float()
        warm = peak * s / _f32(max(warmup, 1), dev)
        t = torch.clamp((s - warmup) / _f32(max(total - warmup, 1), dev),
                        0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)
    return schedule
