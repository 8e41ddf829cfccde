"""Mixture-of-Experts FFN with sort-based scatter dispatch.

Top-k routing with static per-expert capacity (tokens over capacity are
dropped — GShard semantics).  The dispatch avoids the (N·K, E) one-hot
blow-up: positions-within-expert come from a stable argsort and an offset
subtraction, so the intermediates are O(N·K) plus the (E, C, D) expert
buffers.

Supports DeepSeek-style shared experts (always-on dense experts added to
the routed output) and fine-grained experts (d_expert ≪ d_ff).  The
router's Switch-style load-balance loss is returned beside the output.

The per-expert grouped SwiGLU is three batched products over the expert
axis (``layers.bmm_f32``: bf16 operands summed and returned in f32, as
the reference's ``preferred_element_type=f32`` einsums); every expert's
buffer is multiplied, routed or not, as the reference's dense-capacity
dispatch does.  The expert-parallel variants (``_moe_apply_ep``,
``_moe_apply_ep2d``, ``_moe_apply_ep_dstat``, ``ep2d_axes``) need a device
mesh: port slice 9d.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig
from .layers import Init, bmm_f32, dot_f32, dtype_of, init_dense


def init_moe(init: Init, cfg: ModelConfig) -> Dict[str, object]:
    m: MoEConfig = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.num_experts
    dt = dtype_of(cfg.param_dtype)
    std = 1.0 / math.sqrt(d)
    params = {
        # the router is f32 whatever the parameters' dtype
        "router": init_dense(init, d, e, torch.float32),
        "experts": {
            "w_gate": init.normal((e, d, f), std, dt),
            "w_up": init.normal((e, d, f), std, dt),
            "w_down": init.normal((e, f, d), 1.0 / math.sqrt(f), dt),
        },
    }
    if m.num_shared:
        fs = f * m.num_shared
        params["shared"] = {
            "w_gate": init_dense(init, d, fs, dt),
            "w_up": init_dense(init, d, fs, dt),
            "w_down": init_dense(init, fs, d, dt),
        }
    return params


def capacity(n_tokens: int, m: MoEConfig) -> int:
    c = math.ceil(n_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _route(xf: torch.Tensor, router: torch.Tensor, m: MoEConfig):
    """Shared routing math: (gate_vals, expert_ids, occupancy, mean_probs).

    ``jax.lax.top_k`` breaks a tie between equal probabilities by the lower
    expert index; ``torch.topk`` promises no order among ties.  Ties need
    two f32 softmax outputs equal to the bit, which random routers do not
    give; the tests hold the ids equal and print the smallest margin.
    """
    n = xf.shape[0]
    e, k = m.num_experts, m.top_k
    logits = torch.matmul(xf.float(), router)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)      # (N, K)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    flat = expert_ids.reshape(-1)
    occupancy = torch.zeros((e,), dtype=torch.float32,
                            device=xf.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / (n * k), dtype=torch.float32,
                            device=xf.device))
    mean_probs = torch.mean(probs, dim=0)
    return gate_vals, expert_ids, occupancy, mean_probs


def _positions_in_expert(ids: torch.Tensor, e: int) -> torch.Tensor:
    """Sort-based rank of each dispatch slot within its expert.

    The sort is stable, as the reference's: slots of one expert keep their
    token order, so which slots fall past the capacity is the reference's.
    """
    nk = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    counts = torch.bincount(ids, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    ranks_sorted = torch.arange(nk, device=ids.device) - starts[ids[order]]
    pos = torch.empty((nk,), dtype=torch.int64, device=ids.device)
    pos[order] = ranks_sorted
    return pos


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (out (B, S, D), aux_loss scalar).

    The plain path, which the reference takes without a device mesh; the
    expert-parallel paths that a mesh selects are port slice 9d, and
    ``parallel.activations.activation_mesh`` refuses a mesh until then.
    """
    return _moe_apply_xla(params, x, cfg)


def _moe_apply_xla(params, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single-device dispatch: route, scatter, grouped SwiGLU, gather."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    n = b * s
    e, k = m.num_experts, m.top_k
    xf = x.reshape(n, d)

    gate_vals, expert_ids, occupancy, mean_probs = _route(
        xf, params["router"], m)
    # Switch-style load-balance loss: E · Σ_e f_e · p_e
    aux = e * torch.sum(occupancy * mean_probs)

    # --- dispatch: position-within-expert via sort ------------------------
    nk = n * k
    c = capacity(n, m)
    ids = expert_ids.reshape(nk)
    pos = _positions_in_expert(ids, e)
    keep = pos < c
    dst = torch.where(keep, ids * c + pos, e * c)            # drop → spare
    token_idx = torch.arange(nk, device=x.device) // k
    # one spare row past the experts' e·c takes every dropped slot, so no
    # dropped slot reaches an expert's row (the reference's mode="drop")
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    buf[dst] = xf[token_idx]

    # --- per-expert grouped SwiGLU ------------------------------------------
    bufe = buf[:e * c].view(e, c, d)
    ew = params["experts"]
    g = bmm_f32(bufe, ew["w_gate"])
    u = bmm_f32(bufe, ew["w_up"])
    h = (F.silu(g) * u).to(x.dtype)
    y_e = bmm_f32(h, ew["w_down"])                           # (E, C, D) f32

    # --- combine ------------------------------------------------------------
    y_slots = y_e.reshape(e * c, d)[torch.clamp(dst, max=e * c - 1)]
    y_slots = torch.where(keep[:, None], y_slots, 0.0)
    y = torch.sum((y_slots * gate_vals.reshape(nk, 1)).reshape(n, k, d),
                  dim=1)

    if m.num_shared:
        sh = params["shared"]
        gs = dot_f32(xf, sh["w_gate"])
        us = dot_f32(xf, sh["w_up"])
        hs = (F.silu(gs) * us).to(x.dtype)
        y = y + dot_f32(hs, sh["w_down"])

    return y.reshape(b, s, d).to(x.dtype), aux

