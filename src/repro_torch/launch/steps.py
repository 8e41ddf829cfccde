"""Step functions: train (gradient-accumulated), prefill, decode.

The reference's steps are its jit roots; the port's are plain functions.
``train_step(params, opt_state, batch) → (params, opt_state, metrics)``
takes the gradient of ``model.loss_fn`` by autograd, microbatch by
microbatch (contiguous chunks of the batch, the gradients accumulated in
``cfg.grad_accum_dtype``, then divided by their count, as the reference's
``lax.scan``), and applies ``optim.adamw.update``, which writes the new
parameters and moments into the tensors given (the reference donates
them to its jitted step).  Prefill and decode run without autograd; the
decode step updates the caches it is given in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from .. import keypaths
from ..models import config as mcfg
from ..models import model as mdl
from ..models.layers import META, dtype_of
from ..optim import adamw


def _value_and_grad(params, cfg: mcfg.ModelConfig, batch):
    """(loss, the gradient tree) of ``loss_fn`` at ``params``; the
    parameters themselves are not marked for autograd (detached aliases of
    them are)."""
    leaves = keypaths.leaves(params)
    alias = [p.detach().requires_grad_() for p in leaves]
    of = {id(p): a for p, a in zip(leaves, alias)}
    with torch.enable_grad():
        loss, _ = mdl.loss_fn(
            keypaths.map_with_path(lambda _, p: of[id(p)], params), cfg,
            batch)
        grads = torch.autograd.grad(loss, alias, allow_unused=True)
    of = {id(p): torch.zeros_like(p) if g is None else g
          for p, g in zip(leaves, grads)}
    return loss.detach(), keypaths.map_with_path(lambda _, p: of[id(p)],
                                                 params)


def make_train_step(cfg: mcfg.ModelConfig, opt_cfg: adamw.AdamWConfig,
                    *, microbatches: Optional[int] = None) -> Callable:
    """(params, opt_state, batch) → (params, opt_state, {"loss",
    "grad_norm", "lr"}); ``params`` and ``opt_state`` are updated in place
    and returned."""
    m = microbatches or cfg.microbatches
    acc_dt = dtype_of(cfg.grad_accum_dtype)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if m > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % m:
                raise ValueError(f"a batch of {rows} does not split into "
                                 f"{m} microbatches")
            split = {k: v.chunk(m) for k, v in batch.items()}
            acc = keypaths.map_with_path(
                lambda _, p: torch.zeros(p.shape, dtype=acc_dt,
                                         device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=keypaths.leaves(params)[0].device)
            for i in range(m):
                lv, grads = _value_and_grad(
                    params, cfg, {k: v[i] for k, v in split.items()})
                for a, g in zip(keypaths.leaves(acc),
                                keypaths.leaves(grads)):
                    a.add_(g.to(acc_dt))
                del grads
                lsum = lsum + lv
            # divisors as tensors: the card divides by a host scalar
            # through its reciprocal, another rounding
            for a in keypaths.leaves(acc):
                a.div_(torch.full((), m, dtype=acc_dt, device=a.device))
            grads = acc
            lv = lsum / torch.full((), m, dtype=torch.float32,
                                   device=lsum.device)
        else:
            lv, grads = _value_and_grad(params, cfg, batch)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, {"loss": lv, **om}

    return train_step


def make_prefill_step(cfg: mcfg.ModelConfig, *, cache_len: int,
                      batch_chunks: int = 1) -> Callable:
    """(params, batch) → (last-position logits, caches).

    ``batch_chunks > 1`` processes the request batch in sequential chunks,
    which bounds prefill's activations to one chunk's; the chunks' logits
    and caches are joined on the batch axis.
    """

    def one_chunk(params, batch):
        if not cfg.has_decode:  # encoder: plain forward, no cache
            logits, _, _ = mdl.forward(
                params, cfg, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"))
            return logits, ()
        logits, caches, _ = mdl.forward(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), want_cache=True, cache_len=cache_len)
        return logits[:, -1:], caches

    @torch.no_grad()
    def prefill_step(params, batch):
        if batch_chunks <= 1:
            return one_chunk(params, batch)
        rows = next(iter(batch.values())).shape[0]
        if rows % batch_chunks:
            raise ValueError(f"a batch of {rows} does not split into "
                             f"{batch_chunks} chunks")
        split = {k: v.chunk(batch_chunks) for k, v in batch.items()}
        parts = [one_chunk(params, {k: v[i] for k, v in split.items()})
                 for i in range(batch_chunks)]
        logits = torch.cat([lg for lg, _ in parts], dim=0)
        if not cfg.has_decode:
            return logits, ()
        # stacked caches are (repeats, batch, ...): join on axis 1
        caches = [[{name: torch.cat([c[g][e][name] for _, c in parts],
                                    dim=1)
                    for name in parts[0][1][g][e]}
                   for e in range(len(parts[0][1][g]))]
                  for g in range(len(parts[0][1]))]
        return logits, caches

    return prefill_step


def make_decode_step(cfg: mcfg.ModelConfig) -> Callable:
    """(params, caches, tokens (B,1), positions (B,)) → (logits, caches);
    the caches are updated in place."""

    @torch.no_grad()
    def serve_step(params, caches, tokens, positions):
        return mdl.decode_step(params, cfg, tokens, caches, positions)

    return serve_step


def init_train_state(key, cfg: mcfg.ModelConfig,
                     opt_cfg: adamw.AdamWConfig, *,
                     device=None) -> Dict[str, Any]:
    """{"params": drawn from ``key`` (an int seed or a ``torch.Generator``)
    on ``device``, "opt": zero moments and count}."""
    params = mdl.init_params(key, cfg, device=device)
    return {"params": params, "opt": adamw.init(params, opt_cfg)}


def abstract_train_state(cfg: mcfg.ModelConfig,
                         opt_cfg: adamw.AdamWConfig) -> Dict[str, Any]:
    """The train state as ``meta`` tensors (no allocation)."""
    return init_train_state(0, cfg, opt_cfg, device=META)


def abstract_caches(cfg: mcfg.ModelConfig, batch: int, max_len: int, dtype):
    """The decode caches as ``meta`` tensors (no allocation)."""
    return mdl.init_caches(cfg, batch, max_len, dtype, device=META)
