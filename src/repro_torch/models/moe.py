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
dispatch does.

Under an ambient mesh (``parallel.activations.activation_mesh``) the
dispatch is expert-parallel, as the reference's ``shard_map`` bodies, in
explicit SPMD (``parallel/collectives.py``): ``x`` is this rank's rows, its
batch split over every data-parallel axis; each rank routes, scatters into
its own experts' buffer only, runs only its experts, and one all-reduce
combines (``_moe_apply_ep``, ``_moe_apply_ep2d``, ``_moe_apply_ep_dstat``;
:func:`moe_apply` picks one by the reference's rule).  A rank's expert
weights may come as the full leaf, as its ``model`` shard (the train
step's layout) or as the weights-stationary shard of
``param_spec_tree(..., inference=True)``; each variant takes the experts
it runs out of what it is given, recognised by the leading dims.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..parallel import collectives as col
from ..parallel.activations import get_activation_mesh
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
    counts = torch.zeros((e,), dtype=torch.int64,
                         device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))
    starts = torch.cumsum(counts, 0) - counts
    ranks_sorted = torch.arange(nk, device=ids.device) - starts[ids[order]]
    pos = torch.empty((nk,), dtype=torch.int64, device=ids.device)
    pos[order] = ranks_sorted
    return pos


#: the most tokens (the global batch's) that take a weights-stationary
#: variant; more take ``_moe_apply_ep``
STATIONARY_TOKENS = 4096


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def expert_parallel(m: MoEConfig, mesh) -> bool:
    """Does a mesh select an expert-parallel dispatch (the reference's
    condition: ``model`` > 1 divides the experts)?"""
    return (m.impl in ("auto", "ep") and mesh is not None
            and "model" in mesh.axis_names and mesh.shape["model"] > 1
            and m.num_experts % mesh.shape["model"] == 0)


def dispatch_name(m: MoEConfig, mesh, tokens: int) -> str:
    """The dispatch :func:`moe_apply` takes for ``tokens`` tokens in all
    (the global batch's): ``"ep2d"``, ``"ep_dstat"``, ``"ep"`` or
    ``"xla"``, by the reference's rule."""
    if not expert_parallel(m, mesh):
        return "xla"
    if tokens <= STATIONARY_TOKENS:
        axes, world = ep2d_axes(mesh, m.num_experts)
        if len(axes) > 1 and world > mesh.shape["model"]:
            return "ep2d"
        if "data" in mesh.axis_names and mesh.shape["data"] > 1:
            return "ep_dstat"
    return "ep"


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (out (B, S, D), aux_loss scalar).

    Without a mesh, the single-device dispatch.  Under one, ``x`` is this
    rank's rows (the batch split over the dp axes) and the dispatch is
    :func:`dispatch_name`'s; without expert parallelism the rows are
    gathered over the dp axes and routed together, as the reference's
    global batch is."""
    m: MoEConfig = cfg.moe
    mesh = get_activation_mesh()
    if mesh is None:
        return _moe_apply_xla(params, x, cfg)
    dp = _dp_axes(mesh)
    tokens = x.shape[0] * x.shape[1] * mesh.axes_size(dp)
    name = dispatch_name(m, mesh, tokens)
    if name == "ep2d":
        return _moe_apply_ep2d(params, x, cfg, mesh)
    if name == "ep_dstat":
        return _moe_apply_ep_dstat(params, x, cfg, mesh)
    if name == "ep":
        return _moe_apply_ep(params, x, cfg, mesh)
    if mesh.axes_size(dp) == 1:
        return _moe_apply_xla(params, x, cfg)
    b, s, d = x.shape
    xg = col.gather_rows(x.reshape(b * s, d), mesh, dp)
    y, aux = _moe_apply_xla(params, xg.reshape(-1, s, d), cfg)
    i = mesh.index(dp)
    return y[i * b:(i + 1) * b], aux


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



# ---------------------------------------------------------------------------
# Expert-parallel dispatch: the SSR idea at the cluster level.
#
#   * routing is computed redundantly on every model rank (tokens are
#     replicated over 'model'; the router matmul is negligible),
#   * each rank runs ONLY its local experts on the locally-built capacity
#     buffer — no token exchange at all on dispatch,
#   * the combine is one all-reduce of the (n_local, D) output over
#     'model' — the only collective in the layer.
#
# The gradients follow parallel/collectives.py: the routed values enter
# the experts' region through ``enter_model`` (their cotangent summed over
# the model ranks, each of which holds other experts' parts) and leave it
# through ``psum_replicated``; the aux term stays outside, counted once.
# ---------------------------------------------------------------------------


def _experts(w: torch.Tensor, mesh, axes: tuple, e: int) -> torch.Tensor:
    """The experts that this rank's flat index over ``axes`` owns (e /
    |axes| of them), out of ``w`` as the rank holds it: the full leaf, its
    ``model`` shard, or its ('model', 'data') shard."""
    world = mesh.axes_size(axes)
    e_loc = e // world
    tp = mesh.shape["model"]
    lead = w.shape[0]
    if lead == e:
        first = mesh.index(axes) * e_loc
    elif lead == e // tp:
        first = mesh.index(axes) * e_loc - mesh.coords["model"] * lead
    elif axes == ("model",) and "data" in mesh.axis_names and \
            lead * mesh.shape["data"] == e // tp:
        return col.all_gather(w, mesh, ("data",), dim=0)
    elif lead == e_loc:
        return w
    else:
        raise ValueError(f"expert weights of {lead} experts fit neither "
                         f"{e}, {e // tp} nor {e_loc} on {mesh!r}")
    return w[first:first + e_loc]


def _hidden_block(w: torch.Tensor, dim_size: int, mesh) -> torch.Tensor:
    """This rank's ``data`` block of dim 1 of a (e_loc, dim, ·) expert
    leaf, unless it already is one."""
    dd = mesh.shape["data"]
    if w.shape[1] * dd == dim_size and dd > 1:
        return w
    blk = dim_size // dd
    return w[:, mesh.coords["data"] * blk:(mesh.coords["data"] + 1) * blk]


def _dispatch_slots(xf, gate_vals, expert_ids, m: MoEConfig, mesh,
                    first_expert: int, e_loc: int):
    """(this rank's (e_loc, C, D) buffer, its slots' rows in it, which
    slots it owns): the reference's sort-based positions, then only the
    slots of experts [first_expert, first_expert + e_loc)."""
    n, d = xf.shape
    e, k = m.num_experts, m.top_k
    nk = n * k
    c = capacity(n, m)
    ids = expert_ids.reshape(nk)
    pos = _positions_in_expert(ids, e)
    keep = pos < c
    dst = torch.where(keep, ids * c + pos, e * c)
    local_dst = dst - first_expert * c
    mine = keep & (local_dst >= 0) & (local_dst < e_loc * c)
    token_idx = torch.arange(nk, device=xf.device) // k
    buf = torch.zeros((e_loc * c + 1, d), dtype=xf.dtype, device=xf.device)
    buf[torch.where(mine, local_dst, e_loc * c)] = \
        col.enter_model(xf, mesh)[token_idx]
    return buf[:e_loc * c].view(e_loc, c, d), local_dst, mine


def _combine(y_e, local_dst, mine, gate_vals, mesh, n: int, k: int):
    """Σ over each token's slots that this rank owns of gate · output."""
    e_loc, c, d = y_e.shape
    safe = torch.where(mine, local_dst, 0)
    y_slots = torch.where(mine[:, None], y_e.reshape(e_loc * c, d)[safe],
                          0.0)
    gates = col.enter_model(gate_vals, mesh).reshape(n * k, 1)
    return torch.sum((y_slots * gates).reshape(n, k, d), dim=1)


def _swiglu(bufe, wg, wu, wd, dtype):
    g = bmm_f32(bufe, wg)
    u = bmm_f32(bufe, wu)
    return bmm_f32((F.silu(g) * u).to(dtype), wd)


def _add_shared(y, params, x, m: MoEConfig):
    """The EP variants' shared experts: added in x's dtype, as the
    reference adds them after its ``shard_map``."""
    if not m.num_shared:
        return y
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    sh = params["shared"]
    hs = (F.silu(dot_f32(xf, sh["w_gate"])) * dot_f32(xf, sh["w_up"])
          ).to(x.dtype)
    return y + dot_f32(hs, sh["w_down"]).reshape(b, s, d).to(x.dtype)


def _moe_apply_ep(params, x: torch.Tensor, cfg: ModelConfig, mesh
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Experts over 'model'; this rank's rows routed on their own."""
    m: MoEConfig = cfg.moe
    e, k = m.num_experts, m.top_k
    e_loc = e // mesh.shape["model"]
    dp = _dp_axes(mesh)
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    gate_vals, expert_ids, occ, mp = _route(xf, params["router"], m)
    if mesh.axes_size(dp) > 1:
        occ = col.pmean(occ, mesh, dp)
        mp = col.pmean(mp, mesh, dp)
    aux = e * torch.sum(occ * mp)

    ew = params["experts"]
    wg, wu, wd = (_experts(ew[w], mesh, ("model",), e)
                  for w in ("w_gate", "w_up", "w_down"))
    bufe, local_dst, mine = _dispatch_slots(
        xf, gate_vals, expert_ids, m, mesh,
        mesh.coords["model"] * e_loc, e_loc)
    y_e = _swiglu(bufe, wg, wu, wd, x.dtype)
    y_l = _combine(y_e, local_dst, mine, gate_vals, mesh, n, k)
    y_l = col.psum_replicated(y_l, mesh, ("model",))     # THE collective
    return _add_shared(y_l.reshape(b, s, d).to(x.dtype), params, x, m), aux


# ---------------------------------------------------------------------------
# Weights-stationary 2-D expert parallelism — the decode path: experts over
# ('model' × 'data') jointly, the token rows gathered over 'data', every
# rank running only the experts it owns, one all-reduce over both axes.
# ---------------------------------------------------------------------------


def ep2d_axes(mesh, num_experts: int):
    """Largest ('model', 'data'[, 'pod']) prefix whose size divides E."""
    axes = []
    size = 1
    for a in ("model", "data", "pod"):
        if a in mesh.axis_names and num_experts % (size * mesh.shape[a]) == 0:
            axes.append(a)
            size *= mesh.shape[a]
    return tuple(axes), size


def _moe_apply_ep2d(params, x: torch.Tensor, cfg: ModelConfig, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    m: MoEConfig = cfg.moe
    e, k = m.num_experts, m.top_k
    ep_axes, world = ep2d_axes(mesh, e)
    e_loc = e // world
    b, s, d = x.shape
    dp = _dp_axes(mesh)
    gather_axes = tuple(a for a in ep_axes if a != "model")
    dp_rest = tuple(a for a in dp if a not in ep_axes)

    xf = col.gather_rows(x.reshape(b * s, d), mesh, gather_axes)
    nl = xf.shape[0]
    gate_vals, expert_ids, occ, mp = _route(xf, params["router"], m)
    if mesh.axes_size(dp_rest) > 1:
        occ = col.pmean(occ, mesh, dp_rest)
        mp = col.pmean(mp, mesh, dp_rest)
    aux = e * torch.sum(occ * mp)

    ew = params["experts"]
    wg, wu, wd = (_experts(ew[w], mesh, ep_axes, e)
                  for w in ("w_gate", "w_up", "w_down"))
    # the flat rank along ep_axes, model-major (the stored shard's order)
    bufe, local_dst, mine = _dispatch_slots(
        xf, gate_vals, expert_ids, m, mesh, mesh.index(ep_axes) * e_loc,
        e_loc)
    y_e = _swiglu(bufe, wg, wu, wd, x.dtype)
    y_all = _combine(y_e, local_dst, mine, gate_vals, mesh, nl, k)
    y_all = col.psum_replicated(y_all, mesh, ep_axes)  # everyone: all rows
    if gather_axes:
        i = mesh.index(gather_axes)
        y_all = y_all[i * (b * s):(i + 1) * (b * s)]  # this rank's rows
    return _add_shared(y_all.reshape(b, s, d).to(x.dtype), params, x,
                       m), aux


def _moe_apply_ep_dstat(params, x: torch.Tensor, cfg: ModelConfig, mesh
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weights-stationary decode MoE for small expert counts (E ∤ world).

    Experts over 'model' (EP) and the hidden dims over 'data': each rank
    holds (E/tp, D/dd, F) of w_gate/w_up and (E/tp, F/dd, D) of w_down.
    The rows are gathered over the dp axes; the two contractions are
    partial over the data-sharded dim and pay one small all-reduce each.
    """
    m: MoEConfig = cfg.moe
    e, k = m.num_experts, m.top_k
    tp, dd = mesh.shape["model"], mesh.shape["data"]
    e_loc = e // tp
    d_model, f = cfg.d_model, m.d_expert
    if d_model % dd or f % dd:
        return _moe_apply_ep(params, x, cfg, mesh)
    b, s, _ = x.shape
    dp = _dp_axes(mesh)

    xf = col.gather_rows(x.reshape(b * s, d_model), mesh, dp)
    nl = xf.shape[0]
    gate_vals, expert_ids, occ, mp = _route(xf, params["router"], m)
    aux = e * torch.sum(occ * mp)

    ew = params["experts"]
    wg, wu, wd = (_experts(ew[w], mesh, ("model",), e)
                  for w in ("w_gate", "w_up", "w_down"))
    wg, wu = (_hidden_block(w, d_model, mesh) for w in (wg, wu))
    wd = _hidden_block(wd, f, mesh)
    bufe, local_dst, mine = _dispatch_slots(
        xf, gate_vals, expert_ids, m, mesh, mesh.coords["model"] * e_loc,
        e_loc)
    my_d = mesh.coords["data"]
    # contraction partial over the data-sharded D block → all-reduce
    d_blk = d_model // dd
    buf_d = bufe[:, :, my_d * d_blk:(my_d + 1) * d_blk]
    g = col.psum_replicated(bmm_f32(buf_d, wg), mesh, ("data",))
    u = col.psum_replicated(bmm_f32(buf_d, wu), mesh, ("data",))
    hh = (F.silu(g) * u).to(x.dtype)
    f_blk = f // dd
    h_f = hh[:, :, my_d * f_blk:(my_d + 1) * f_blk]
    y_e = col.psum_replicated(bmm_f32(h_f, wd), mesh, ("data",))

    y_all = _combine(y_e, local_dst, mine, gate_vals, mesh, nl, k)
    y_all = col.psum_replicated(y_all, mesh, ("model",))
    i = mesh.index(dp)
    y_l = y_all[i * (b * s):(i + 1) * (b * s)]
    return _add_shared(y_l.reshape(b, s, d_model).to(x.dtype), params, x,
                       m), aux
