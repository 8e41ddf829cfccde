"""Step functions of the serving path: prefill and decode.

The reference's steps are its jit roots; the port's are plain functions
that run without autograd.  The decode step updates the caches it is
given in place (the reference donates them to its jitted step).  The train
step and its state (``make_train_step``, ``init_train_state``,
``abstract_train_state``) are the training slice's (port slice 9c).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import config as mcfg
from ..models import model as mdl
from ..models.layers import META


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


def abstract_caches(cfg: mcfg.ModelConfig, batch: int, max_len: int, dtype):
    """The decode caches as ``meta`` tensors (no allocation)."""
    return mdl.init_caches(cfg, batch, max_len, dtype, device=META)
