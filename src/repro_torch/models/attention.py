"""Attention mixers: GQA (qk-norm / sliding-window options); MLA is port
slice 9b.

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

from .config import ModelConfig
from .flash import flash_sdpa
from .layers import (Init, apply_rope, bmm_f32, dot, dtype_of, init_dense,
                     rms_norm, rope_angles)

_NEG = -1e30

# above this many kv positions the full-sequence path switches from naive
# SDPA (exact, simple — fine for smoke tests) to the chunked flash schedule
# (same math, O(tile) memory — required at prefill_32k scale)
FLASH_THRESHOLD = 1024

#: the slice that ports the latent attention (with the experts and mixers)
MLA_SLICE = "port slice 9b (the MLA half of models/attention.py)"


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
                         scale=1.0 / math.sqrt(hd))
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
# MLA — DeepSeek-V3 multi-head latent attention: port slice 9b.
# ---------------------------------------------------------------------------


def init_mla(init: Init, cfg: ModelConfig):
    raise NotImplementedError(f"init_mla: the 'mla' mixer is {MLA_SLICE}")


def mla_full(params, x, cfg: ModelConfig, *, positions, want_cache: bool,
             cache_len: int = 0):
    raise NotImplementedError(f"mla_full: the 'mla' mixer is {MLA_SLICE}")


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
                   device=None):
    raise NotImplementedError(
        f"init_mla_cache: the 'mla' mixer is {MLA_SLICE}")


def mla_decode(params, x, cfg: ModelConfig, cache, *, positions):
    raise NotImplementedError(f"mla_decode: the 'mla' mixer is {MLA_SLICE}")

