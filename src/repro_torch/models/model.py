"""Full model: embeddings → scan groups → head; prefill and decode."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import resolve_device
from . import blocks
from .config import ModelConfig
from .layers import (META, Init, dot, dot_f32, dtype_of, init_dense,
                     init_embed, rms_norm, softmax_xent)


def init_params(key, cfg: ModelConfig, *, device=None) -> Dict[str, Any]:
    """Random parameters, drawn from ``key`` (an int seed or a
    ``torch.Generator``) on ``device``; ``device="meta"`` gives their shapes
    and dtypes without storage.

    The tree is the reference's: ``embed``, ``frontend_proj``, ``groups``
    (per scan group, per pattern element, a dict stacked on the repeats
    axis), ``final_norm``, ``lm_head``.  Its values are not the
    reference's (``jax.random``'s bits); ``interop.params_from_reference``
    carries a reference tree across.
    """
    init = Init.of(key, device)
    dt = dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {}
    if cfg.frontend != "audio":
        params["embed"] = init_embed(init, cfg.vocab_size, cfg.d_model, dt)
    if cfg.frontend is not None:
        # stub frontend: precomputed frame/patch embeddings → linear adapter
        params["frontend_proj"] = init_dense(init, cfg.d_model, cfg.d_model,
                                             dt)
    params["groups"] = [blocks.init_group(init, g, cfg) for g in cfg.groups]
    params["final_norm"] = init.ones((cfg.d_model,), dt)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(init, cfg.d_model, cfg.vocab_size, dt)
    return params


def _embed_inputs(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
                  embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token and/or frontend-stub embeddings → (B, S_total, D)."""
    parts = []
    if embeds is not None:
        parts.append(dot(embeds, params["frontend_proj"]))
    if tokens is not None:
        parts.append(params["embed"][tokens])
    # each part cast to the compute dtype, then joined: the reference's
    # promoted concatenation then cast, element for element
    cd = dtype_of(cfg.compute_dtype)
    return torch.cat([p.to(cd) for p in parts], dim=1)


def _head(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return dot_f32(h, w)


def forward(params, cfg: ModelConfig, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None, want_cache: bool = False,
            cache_len: int = 0, positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[list], torch.Tensor]:
    """Full-sequence pass → (logits f32, caches | None, aux_loss).

    ``aux_loss`` is the sum of every MoE block's router loss (0 without
    experts).
    """
    h = _embed_inputs(params, cfg, tokens, embeds)
    b, s, _ = h.shape
    if positions is None:
        positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    caches = [] if want_cache else None
    aux = 0.0
    for gp, g in zip(params["groups"], cfg.groups):
        h, cache, a = blocks.group_full(
            gp, h, cfg, g, positions=positions, want_cache=want_cache,
            cache_len=cache_len)
        aux = aux + a
        if want_cache:
            caches.append(cache)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
    return _head(params, cfg, h), caches, aux


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
                device=None) -> list:
    """Zeroed decode caches (``device="meta"``: shapes and dtypes only)."""
    dev = META if device is not None and torch.device(device) == META \
        else resolve_device(device)
    dt = dtype_of(dtype) if isinstance(dtype, str) else dtype
    return [blocks.init_group_cache(g, cfg, batch, max_len, dt, device=dev)
            for g in cfg.groups]


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, caches,
                positions: torch.Tensor) -> Tuple[torch.Tensor, list]:
    """One-token step: tokens (B, 1), positions (B,) → (logits, caches).

    Every layer's state (attention k/v, MLA latents, recurrent state) is
    updated in its slot of the stacked buffers; the list returned is
    ``caches``.
    """
    h = params["embed"][tokens].to(dtype_of(cfg.compute_dtype))
    for gp, g, gc in zip(params["groups"], cfg.groups, caches):
        h, _ = blocks.group_decode(gp, h, cfg, g, caches=gc,
                                   positions=positions)
    return _head(params, cfg, h), caches


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss (LM) or frame-classification loss (encoder)."""
    logits, _, aux = forward(
        params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"))
    labels = batch["labels"]
    if labels.shape[1] != logits.shape[1]:  # vlm: labels only on text tail
        logits = logits[:, -labels.shape[1]:]
    ce = softmax_xent(logits, labels, batch.get("mask"))
    total = ce + (cfg.moe.router_aux_weight * aux if cfg.moe else 0.0)
    return total, {"ce": ce, "aux": aux}
