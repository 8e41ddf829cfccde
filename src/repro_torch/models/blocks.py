"""Block assembly: (mixer, ffn) pairs, pre-norm residuals, scan groups.

A :class:`~repro_torch.models.config.ScanGroup`'s parameters and caches are
stacked on a leading ``repeats`` axis, as the reference's are; where the
reference scans that axis (``lax.scan``), the port walks it in a Python
loop, one layer's views at a time.  A full-sequence pass takes the layers'
views by one ``unbind`` a stacked leaf, so backward assembles each stacked
gradient once (indexing a layer at a time would add a zero-filled
stack-sized gradient a layer).

With ``cfg.remat``, as the reference's ``jax.checkpoint``s: each layer's
body is recomputed in backward, which keeps only its input; a group of 8
or more layers is also walked as ~√R outer chunks (``_layer_chunk``), each
recomputed whole, so backward keeps the chunks' boundaries and one chunk's
layer inputs at a time.  Without autograd recording (serving), nothing is
recomputed and the walk is the plain loop.

Decode keeps every layer's state in its slot of the stacked buffers: the
attention mixers write their token in place (``attn_decode``,
``mla_decode``), the recurrent ones return new state tensors, which
:func:`group_decode` copies into the slot.  The stacked buffers given are
the buffers returned.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils import _pytree as pytree

from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig, ScanGroup
from .layers import (META, Init, dtype_of, gelu_mlp, init_dense, remat,
                     rms_norm, swiglu)

_MIXER_INIT = {
    "attn": attn_mod.init_attn,
    "mla": attn_mod.init_mla,
    "mamba": ssm_mod.init_mamba,
    "mlstm": ssm_mod.init_mlstm,
    "slstm": ssm_mod.init_slstm,
}

_MIXER_DECODE = {
    "attn": attn_mod.attn_decode,
    "mla": attn_mod.mla_decode,
    "mamba": ssm_mod.mamba_decode,
    "mlstm": ssm_mod.mlstm_decode,
    "slstm": ssm_mod.slstm_decode,
}


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a parameter or cache tree (``None`` leaves left out)."""
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def init_ffn(init: Init, kind: str, cfg: ModelConfig) -> Dict[str, Any]:
    dt = dtype_of(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    if kind == "none":
        return {}
    if kind == "moe":
        return moe_mod.init_moe(init, cfg)
    if kind == "gelu_mlp":
        return {"w_up": init_dense(init, d, f, dt),
                "w_down": init_dense(init, f, d, dt)}
    return {"w_gate": init_dense(init, d, f, dt),
            "w_up": init_dense(init, d, f, dt),
            "w_down": init_dense(init, f, d, dt)}


def init_block(init: Init, mixer: str, ffn: str,
               cfg: ModelConfig) -> Dict[str, Any]:
    dt = dtype_of(cfg.param_dtype)
    p: Dict[str, Any] = {
        "norm1": init.ones((cfg.d_model,), dt),
        "mixer": _MIXER_INIT[mixer](init, cfg),
        "ffn": init_ffn(init, ffn, cfg),
    }
    if ffn != "none":
        p["norm2"] = init.ones((cfg.d_model,), dt)
    return p


def _apply_ffn(params, kind: str, h: torch.Tensor, cfg: ModelConfig):
    """The block's ffn → (out, the router's aux loss; 0.0 for a dense ffn)."""
    if kind == "moe":
        return moe_mod.moe_apply(params, h, cfg)
    if kind == "gelu_mlp":
        return gelu_mlp(h, params["w_up"], params["w_down"]), 0.0
    return swiglu(h, params["w_gate"], params["w_up"], params["w_down"]), 0.0


def block_full(params, h: torch.Tensor, cfg: ModelConfig, mixer: str,
               ffn: str, *, positions: torch.Tensor, want_cache: bool,
               cache_len: int):
    """One block, full-sequence mode. Returns (h, cache, aux)."""
    x = rms_norm(h, params["norm1"], cfg.norm_eps)
    if mixer in ("attn", "mla"):
        full = attn_mod.attn_full if mixer == "attn" else attn_mod.mla_full
        y, cache = full(params["mixer"], x, cfg, positions=positions,
                        want_cache=want_cache, cache_len=cache_len)
    else:
        full = {"mamba": ssm_mod.mamba_full, "mlstm": ssm_mod.mlstm_full,
                "slstm": ssm_mod.slstm_full}[mixer]
        y, cache = full(params["mixer"], x, cfg, want_cache=want_cache)
    h = h + y
    aux = 0.0
    if ffn != "none":
        z = rms_norm(h, params["norm2"], cfg.norm_eps)
        out, aux = _apply_ffn(params["ffn"], ffn, z, cfg)
        h = h + out
    return h, cache, aux


def block_decode(params, h: torch.Tensor, cfg: ModelConfig, mixer: str,
                 ffn: str, *, cache, positions: torch.Tensor):
    x = rms_norm(h, params["norm1"], cfg.norm_eps)
    y, cache = _MIXER_DECODE[mixer](params["mixer"], x, cfg, cache,
                                    positions=positions)
    h = h + y
    if ffn != "none":
        z = rms_norm(h, params["norm2"], cfg.norm_eps)
        out, _ = _apply_ffn(params["ffn"], ffn, z, cfg)
        h = h + out
    return h, cache


def init_cache_for(mixer: str, cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype, *, device=None):
    if mixer == "attn":
        return attn_mod.init_attn_cache(cfg, batch, max_len, dtype,
                                        device=device)
    if mixer == "mla":
        return attn_mod.init_mla_cache(cfg, batch, max_len, dtype,
                                       device=device)
    init = {"mamba": ssm_mod.init_mamba_cache,
            "mlstm": ssm_mod.init_mlstm_cache,
            "slstm": ssm_mod.init_slstm_cache}[mixer]
    return init(cfg, batch, dtype, device=device)


# ---------------------------------------------------------------------------
# Scan groups
# ---------------------------------------------------------------------------


def init_group(init: Init, group: ScanGroup, cfg: ModelConfig) -> list:
    """Stacked params: one entry per pattern element, leading axis repeats.

    Each layer is drawn and copied into its slot of the stack in turn, so
    at most one layer's f32 draw is live beside the stack; a group of one
    repeat takes the drawn layer as its stack (a view), so its peak is the
    weights and one leaf's f32 draw.
    """
    out = []
    for mixer, ffn in group.pattern:
        if group.repeats == 1:
            out.append(pytree.tree_map_only(
                torch.Tensor, lambda x: x.unsqueeze(0),
                init_block(init, mixer, ffn, cfg)))
            continue
        stack = None
        for r in range(group.repeats):
            one = init_block(init, mixer, ffn, cfg)
            if stack is None:
                stack = pytree.tree_map_only(
                    torch.Tensor, lambda x: torch.empty(
                        (group.repeats,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device), one)
            for dst, src in zip(tree_leaves(stack), tree_leaves(one)):
                dst[r].copy_(src)
        out.append(stack)
    return out


def init_group_cache(group: ScanGroup, cfg: ModelConfig, batch: int,
                     max_len: int, dtype: torch.dtype, *, device=None) -> list:
    out = []
    for mixer, _ in group.pattern:
        one = init_cache_for(mixer, cfg, batch, max_len, dtype, device=META)
        out.append(pytree.tree_map_only(
            torch.Tensor, lambda x: torch.zeros(
                (group.repeats,) + tuple(x.shape), dtype=x.dtype,
                device=device), one))
    return out


def _layers(tree, repeats: int) -> list:
    """Every layer's views of a stacked tree, one ``unbind`` a leaf (its
    slots, for a cache)."""
    flat, spec = pytree.tree_flatten(tree)
    cols = [x.unbind(0) if isinstance(x, torch.Tensor) else [x] * repeats
            for x in flat]
    return [pytree.tree_unflatten([c[r] for c in cols], spec)
            for r in range(repeats)]


def _layer_chunk(repeats: int) -> int:
    """√R-ish divisor for nested layer-group remat."""
    g = max(1, int(repeats ** 0.5))
    while repeats % g:
        g -= 1
    return g


def group_full(group_params, h: torch.Tensor, cfg: ModelConfig,
               group: ScanGroup, *, positions: torch.Tensor,
               want_cache: bool, cache_len: int):
    """Apply a scan group in full-sequence mode → (h, caches, aux_sum).

    With ``want_cache`` each layer's cache lands in its slot of one stacked
    buffer per pattern element, as the reference's scan stacks its ys.
    With ``cfg.remat`` (and no caches wanted) each layer's body is
    recomputed in backward, and a group of 8 or more layers in ~√R outer
    chunks too, as the reference's nested checkpointed scans.
    """
    layers = _layers(group_params, group.repeats)
    if not want_cache:
        def body(hh, aux, lp):
            for j, (mixer, ffn) in enumerate(group.pattern):
                hh, _, a = block_full(lp[j], hh, cfg, mixer, ffn,
                                      positions=positions, want_cache=False,
                                      cache_len=cache_len)
                aux = aux + a
            return hh, aux

        def chunk(hh, aux, lps):
            for lp in lps:
                hh, aux = remat(body, hh, aux, lp, enabled=cfg.remat)
            return hh, aux

        r = group.repeats
        g = _layer_chunk(r) if cfg.remat and r >= 8 else r
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, r, g):
            h, aux = remat(chunk, h, aux, layers[i:i + g], enabled=g < r)
        return h, None, aux

    caches = [None] * len(group.pattern)
    aux = 0.0
    for r in range(group.repeats):
        for j, (mixer, ffn) in enumerate(group.pattern):
            h, cache, a = block_full(
                layers[r][j], h, cfg, mixer, ffn, positions=positions,
                want_cache=True, cache_len=cache_len)
            aux = aux + a
            if caches[j] is None:
                caches[j] = pytree.tree_map_only(
                    torch.Tensor, lambda x: x.new_empty(
                        (group.repeats,) + tuple(x.shape)), cache)
            for dst, src in zip(tree_leaves(caches[j]), tree_leaves(cache)):
                dst[r].copy_(src)
    return h, caches, aux


def group_decode(group_params, h: torch.Tensor, cfg: ModelConfig,
                 group: ScanGroup, *, caches, positions: torch.Tensor):
    """Decode through a scan group, each layer's state kept in its slot of
    the stacked buffers (returned as given).

    An attention mixer writes its slot in place and returns it; a recurrent
    one returns new state, which is copied into the slot (cast to the
    buffer's dtype, as the reference's ``dynamic_update_index_in_dim``).
    """
    layers = _layers(group_params, group.repeats)
    slots = [_layers(c, group.repeats) for c in caches]
    for r in range(group.repeats):
        for e, (mixer, ffn) in enumerate(group.pattern):
            slot = slots[e][r]
            h, new = block_decode(layers[r][e], h, cfg, mixer, ffn,
                                  cache=slot, positions=positions)
            for dst, src in zip(tree_leaves(slot), tree_leaves(new)):
                if src is not dst:
                    dst.copy_(src)
    return h, caches
