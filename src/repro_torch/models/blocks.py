"""Block assembly: (mixer, ffn) pairs, pre-norm residuals, scan groups.

A :class:`~repro_torch.models.config.ScanGroup`'s parameters and caches are
stacked on a leading ``repeats`` axis, as the reference's are; where the
reference scans that axis (``lax.scan``), the port walks it in a Python
loop, one layer's views at a time.  The reference's ``remat`` and its
nested layer-group scan (``_layer_chunk``) shape backward memory only; a
forward-only path has no counterpart, and the training slice decides.

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
from .layers import (META, Init, dtype_of, gelu_mlp, init_dense, rms_norm,
                     swiglu)

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


def _layer(tree, r: int):
    """Layer ``r``'s views of a stacked tree."""
    return pytree.tree_map_only(torch.Tensor, lambda x: x[r], tree)


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


def group_full(group_params, h: torch.Tensor, cfg: ModelConfig,
               group: ScanGroup, *, positions: torch.Tensor,
               want_cache: bool, cache_len: int):
    """Apply a scan group in full-sequence mode → (h, caches, aux_sum).

    With ``want_cache`` each layer's cache lands in its slot of one stacked
    buffer per pattern element, as the reference's scan stacks its ys.
    """
    caches = [None] * len(group.pattern) if want_cache else None
    aux = 0.0
    for r in range(group.repeats):
        layer_params = _layer(group_params, r)
        for j, (mixer, ffn) in enumerate(group.pattern):
            h, cache, a = block_full(
                layer_params[j], h, cfg, mixer, ffn, positions=positions,
                want_cache=want_cache, cache_len=cache_len)
            aux = aux + a
            if want_cache:
                if caches[j] is None:
                    caches[j] = pytree.tree_map_only(
                        torch.Tensor, lambda x: x.new_empty(
                            (group.repeats,) + tuple(x.shape)), cache)
                for dst, src in zip(tree_leaves(caches[j]),
                                    tree_leaves(cache)):
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
    for r in range(group.repeats):
        layer_params = _layer(group_params, r)
        for e, (mixer, ffn) in enumerate(group.pattern):
            slot = _layer(caches[e], r)
            h, new = block_decode(layer_params[e], h, cfg, mixer, ffn,
                                  cache=slot, positions=positions)
            for dst, src in zip(tree_leaves(slot), tree_leaves(new)):
                if src is not dst:
                    dst.copy_(src)
    return h, caches
