"""Attention mixers: GQA (qk-norm / sliding-window options) and MLA.

Two execution modes share the mixer:

* ``full``  — prefill over a whole sequence (causal or bidirectional).
  Optionally emits the KV cache for subsequent decoding.
* ``decode`` — one new token against a cache (per-sequence positions), the
  serve step.  Sliding-window caches are ring buffers bounded by the
  window (why h2o-danube's 500k-context decode is feasible).

The decode step writes its token into the cache in place and returns the
same buffers: the reference gets that effect by donating the caches to its
jitted step (``launch/serve.py``), so neither copies a cache a step.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .config import MLAConfig, ModelConfig
from .flash import flash_sdpa
from .layers import (Init, apply_rope, bmm_f32, dot, dtype_of, init_dense,
                     rms_norm, rope_angles)

_NEG = -1e30

# above this many kv positions the full-sequence path switches from naive
# SDPA (exact, simple — fine for smoke tests) to the chunked flash schedule
# (same math, O(tile) memory — required at prefill_32k scale)
FLASH_THRESHOLD = 1024

def init_attn(init: Init,
              cfg: ModelConfig) -> Dict[str, Optional[torch.Tensor]]:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    dt = dtype_of(cfg.param_dtype)
    return {
        "wq": init_dense(init, d, h * hd, dt),
        "wk": init_dense(init, d, kv * hd, dt),
        "wv": init_dense(init, d, kv * hd, dt),
        "wo": init_dense(init, h * hd, d, dt),
        "q_norm": init.ones((hd,), dt) if cfg.qk_norm else None,
        "k_norm": init.ones((hd,), dt) if cfg.qk_norm else None,
    }


def _mask(sq: int, sk: int, q_pos: torch.Tensor, k_pos: torch.Tensor,
          causal: bool, window: Optional[int],
          valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(…, sq, sk) boolean mask from absolute positions."""
    shape = tuple(q_pos.shape[:-1]) + (sq, sk) if q_pos.ndim > 1 \
        else (sq, sk)
    m = torch.ones(shape, dtype=torch.bool, device=q_pos.device)
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (kp > qp - window)
    if valid_len is not None:
        m = m & (kp < valid_len[..., None, None])
    return m


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,Sq,H,dh), k (B,Sk,KV,dh), v (B,Sk,KV,dv); f32 softmax.

    K and V stay in their storage dtype; both products sum in f32
    (``bmm_f32``), and p is rounded to v's dtype before the second, as the
    reference's ``preferred_element_type`` einsums do.
    """
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dh).permute(0, 2, 3, 1, 4) \
        .reshape(b * kvh, g * sq, dh)
    kt = k.permute(0, 2, 3, 1).reshape(b * kvh, dh, sk)
    logits = bmm_f32(qg, kt).reshape(b, kvh, g, sq, sk) * scale
    logits = torch.where(mask[:, None, None] if mask.ndim == 3 else mask,
                         logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    vv = v.permute(0, 2, 1, 3).reshape(b * kvh, sk, dv)
    out = bmm_f32(p.to(v.dtype).reshape(b * kvh, g * sq, sk), vv)
    out = out.reshape(b, kvh, g, sq, dv).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _qkv(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """q, k, v of x (B, S, D), qk-normed and rotated."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = dot(x, params["wq"]).reshape(b, s, h, hd)
    k = dot(x, params["wk"]).reshape(b, s, kv, hd)
    v = dot(x, params["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_full(params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, want_cache: bool, cache_len: int = 0):
    """Full-sequence attention.  positions (B, S) absolute indices."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(params, x, cfg, positions)
    if s > FLASH_THRESHOLD:
        out = flash_sdpa(q, k, v, q_pos=positions, k_pos=positions,
                         causal=cfg.causal, window=cfg.window,
                         scale=1.0 / math.sqrt(hd), remat=cfg.remat)
    else:
        mask = _mask(s, s, positions, positions, cfg.causal, cfg.window)
        out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(hd))
    out = dot(out.reshape(b, s, h * hd), params["wo"])
    cache = None
    if want_cache:
        cache = init_attn_cache(cfg, b, cache_len, x.dtype, device=x.device)
        cache = _cache_write_bulk(cache, k, v, positions, cfg)
    return out.to(x.dtype), cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype, *, device=None):
    size = min(max_len, cfg.window) if cfg.window else max_len
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, size, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, kv, hd), dtype=dtype, device=device),
    }


def _cache_write_bulk(cache, k: torch.Tensor, v: torch.Tensor,
                      positions: torch.Tensor, cfg: ModelConfig):
    """Prefill write: place the last ``size`` tokens (ring for SWA)."""
    size = cache["k"].shape[1]
    s = k.shape[1]
    if s >= size:
        ksel, vsel = k[:, -size:], v[:, -size:]
        if cfg.window:  # ring layout: slot = pos % size
            psel = positions[:, -size:] % size
            order = torch.argsort(psel, dim=1, stable=True)[..., None, None]
            ksel = torch.take_along_dim(ksel, order, dim=1)
            vsel = torch.take_along_dim(vsel, order, dim=1)
        return {"k": ksel.contiguous(), "v": vsel.contiguous()}
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    return cache


def attn_decode(params, x: torch.Tensor, cfg: ModelConfig, cache, *,
                positions: torch.Tensor):
    """One-token step.  x (B, 1, D); positions (B,) next absolute index.

    Writes the token's k and v into ``cache`` in place (slot ``position``,
    or ``position % size`` in a ring) and returns it with the output.
    """
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"attn_decode takes one token a row, got {s}")
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(params, x, cfg, positions[:, None])

    size = cache["k"].shape[1]
    slot = positions % size if cfg.window else positions
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, slot] = k[:, 0]
    cache["v"][rows, slot] = v[:, 0]

    idx = torch.arange(size, device=x.device)[None, :]
    cur = positions[:, None]
    if cfg.window:
        # ring buffer: slot s holds absolute position  s + size*floor(...)
        # valid iff abs_pos > pos - window; reconstruct abs positions.
        base = cur - cur % size
        abs_pos = torch.where(idx <= cur % size, base + idx,
                              base + idx - size)
        valid = (abs_pos >= 0) & (abs_pos > cur - cfg.window) & \
            (abs_pos <= cur)
    else:
        valid = idx <= cur
    mask = valid[:, None, :]  # (B, 1, S)
    out = _sdpa(q, cache["k"], cache["v"], mask, 1.0 / math.sqrt(hd))
    out = dot(out.reshape(b, 1, h * hd), params["wo"])
    return out.to(x.dtype), cache


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V3 multi-head latent attention.
# ---------------------------------------------------------------------------


def init_mla(init: Init, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dt = dtype_of(cfg.param_dtype)
    return {
        "wdq": init_dense(init, d, m.q_lora_rank, dt),
        "q_norm": init.ones((m.q_lora_rank,), dt),
        "wuq": init_dense(init, m.q_lora_rank, h * m.qk_head_dim, dt),
        "wdkv": init_dense(init, d, m.kv_lora_rank, dt),
        "kv_norm": init.ones((m.kv_lora_rank,), dt),
        "wkr": init_dense(init, d, m.qk_rope_head_dim, dt),
        "wuk": init_dense(init, m.kv_lora_rank, h * m.qk_nope_head_dim, dt),
        "wuv": init_dense(init, m.kv_lora_rank, h * m.v_head_dim, dt),
        "wo": init_dense(init, h * m.v_head_dim, d, dt),
    }


def _mla_qkr(params, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor):
    """Shared q / latent / rope-key computation."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    cq = rms_norm(dot(x, params["wdq"]), params["q_norm"], cfg.norm_eps)
    q = dot(cq, params["wuq"]).reshape(b, s, h, m.qk_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    ckv = rms_norm(dot(x, params["wdkv"]), params["kv_norm"], cfg.norm_eps)
    kr = dot(x, params["wkr"]).reshape(b, s, 1, m.qk_rope_head_dim)
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    kr = apply_rope(kr, cos, sin)[:, :, 0]  # shared across heads
    return q_nope, q_rope, ckv, kr


def mla_full(params, x: torch.Tensor, cfg: ModelConfig, *,
             positions: torch.Tensor, want_cache: bool, cache_len: int = 0):
    """Full-sequence MLA: the latent expanded to per-head k and v, the
    shared rope key folded into every head (q·k over 192 dims, v 128 at
    the published widths)."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope, ckv, kr = _mla_qkr(params, x, cfg, positions)
    k_nope = dot(ckv, params["wuk"]).reshape(b, s, h, m.qk_nope_head_dim)
    v = dot(ckv, params["wuv"]).reshape(b, s, h, m.v_head_dim)
    scale = 1.0 / math.sqrt(m.qk_head_dim)
    # fold the shared rope key in: q' = [q_nope, q_rope], k' = [k_nope, kr]
    qq = torch.cat([q_nope, q_rope], dim=-1)
    kk = torch.cat([k_nope, kr[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    if s > FLASH_THRESHOLD:
        out = flash_sdpa(qq, kk, v, q_pos=positions, k_pos=positions,
                         causal=cfg.causal, window=cfg.window, scale=scale,
                         remat=cfg.remat)
    else:
        mask = _mask(s, s, positions, positions, cfg.causal, cfg.window)
        out = _sdpa(qq, kk, v, mask, scale)
    out = dot(out.reshape(b, s, h * m.v_head_dim).to(x.dtype), params["wo"])
    cache = None
    if want_cache:
        cache = init_mla_cache(cfg, b, cache_len, x.dtype, device=x.device)
        size = cache["lat"].shape[1]
        lat = torch.cat([ckv, kr], dim=-1)[:, :size]
        cache["lat"][:, :lat.shape[1]] = lat
    return out.to(x.dtype), cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype, *, device=None):
    return {"lat": torch.zeros((batch, max_len, cfg.mla.cache_dim),
                               dtype=dtype, device=device)}


def _per_head_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bhx,xhy->bhy", a, w)`` summed and returned in f32: one
    batched product a head."""
    return bmm_f32(a.transpose(0, 1), w.transpose(0, 1)).transpose(0, 1)


def mla_decode(params, x: torch.Tensor, cfg: ModelConfig, cache, *,
               positions: torch.Tensor):
    """Absorbed-formulation decode: scores & values via the latent only.

    Writes the token's latent into ``cache`` in place (slot ``position``)
    and returns it with the output.  The five products sum in f32, as the
    reference's ``preferred_element_type=f32`` einsums.
    """
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"mla_decode takes one token a row, got {s}")
    h, r = cfg.num_heads, m.kv_lora_rank
    q_nope, q_rope, ckv, kr = _mla_qkr(params, x, cfg, positions[:, None])
    lat = cache["lat"]
    rows = torch.arange(b, device=x.device)
    lat[rows, positions] = torch.cat([ckv, kr], dim=-1)[:, 0]
    ckv_all, kr_all = lat[..., :r], lat[..., r:]
    # absorb W_uk into q: q_lat (B, H, r)
    wuk = params["wuk"].reshape(r, h, m.qk_nope_head_dim)
    q_lat = _per_head_f32(q_nope[:, 0], wuk.permute(2, 1, 0))
    scale = 1.0 / math.sqrt(m.qk_head_dim)
    logits = (bmm_f32(q_lat.to(lat.dtype), ckv_all.transpose(1, 2))
              + bmm_f32(q_rope[:, 0], kr_all.transpose(1, 2))) * scale
    valid = torch.arange(lat.shape[1], device=x.device)[None, :] \
        <= positions[:, None]
    logits = torch.where(valid[:, None], logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    o_lat = bmm_f32(p.to(lat.dtype), ckv_all)                # (B, H, r)
    wuv = params["wuv"].reshape(r, h, m.v_head_dim)
    out = _per_head_f32(o_lat.to(wuv.dtype), wuv)
    out = dot(out.reshape(b, 1, h * m.v_head_dim).to(x.dtype), params["wo"])
    return out.to(x.dtype), cache
