"""Flash-style chunked attention (the path above ``FLASH_THRESHOLD``).

The naive SDPA materialises (B, H, S, S) logits; at prefill_32k scale that
alone overflows device memory.  This is the reference's tile walk: an outer
loop over query tiles and an inner one over KV tiles carrying the
online-softmax accumulator, in f32 inside, every KV tile visited (none is
skipped for its mask, so the roundings are the reference's).  With
``remat``, as the reference's two ``jax.checkpoint``s: each query tile
and, within it, each KV tile step is recomputed in backward, so backward
never holds more than one (bq × bk) tile of logits and one query tile's
accumulators a KV tile.

Semantics identical to ``attention._sdpa`` (tested) — only the schedule
differs.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from . import layers

_NEG = -1e30


def _pick(block: int, size: int) -> int:
    b = min(block, size)
    while size % b:
        b //= 2
    return max(b, 1)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int], scale: float,
               bq: int = 512, bk: int = 1024,
               remat: bool = False) -> torch.Tensor:
    """q (B,Sq,H,dh); k/v (B,Sk,KV,dh); positions (B,S·) → (B,Sq,H,dh)."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kv
    bq = _pick(bq, sq)
    bk = _pick(bk, sk)
    masked = causal or (window is not None)

    def kv_step(m, l, acc, qg, qp, j: int):
        # the tile's K^T and V in f32, (B, KV, 1, ·, ·): one a group
        kt = k[:, j:j + bk].float().permute(0, 2, 3, 1)[:, :, None]
        vt = v[:, j:j + bk].float().permute(0, 2, 1, 3)[:, :, None]
        logits = torch.matmul(qg, kt) * scale             # (B, KV, G, bq, bk)
        if masked:
            kp = k_pos[:, None, j:j + bk]
            mask = torch.ones((b, bq, bk), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = mask & (kp <= qp)
            if window is not None:
                mask = mask & (kp > qp - window)
            logits = torch.where(mask[:, None, None], logits, _NEG)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vt)
        return m_new, l, acc

    def per_q(i: int):
        qg = q[:, i:i + bq].reshape(b, bq, kv, g, dh).float() \
            .permute(0, 2, 3, 1, 4)                       # (B, KV, G, bq, dh)
        qp = q_pos[:, i:i + bq, None]
        m = torch.full((b, kv, g, bq), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kv, g, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kv, g, bq, dv), dtype=torch.float32,
                          device=q.device)
        for j in range(0, sk, bk):
            m, l, acc = layers.remat(kv_step, m, l, acc, qg, qp, j,
                                     enabled=remat)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.permute(0, 3, 1, 2, 4).reshape(b, bq, h, dv)

    outs = [layers.remat(per_q, i, enabled=remat) for i in range(0, sq, bq)]
    return torch.cat(outs, dim=1).to(q.dtype)


def chunked_scan(step_fn: Callable, init, xs, *, chunk: int, length: int,
                 remat: bool = False):
    """A scan over ``length`` steps, walked in chunks of ``chunk``.

    ``step_fn(carry, x) -> (carry, y)``; ``xs`` leaves have leading dim
    ``length`` and the ``y`` leaves come back stacked on a leading
    ``length`` axis, as ``lax.scan``'s do.  With ``remat``, as the
    reference's remat boundary a chunk (``chunk`` halved until it divides
    ``length``): each chunk of steps is recomputed in backward, which keeps
    only the chunk-boundary carries.  The steps run in order whatever the
    chunk, so the results do not change with it.
    """
    c = _pick(chunk, length) if remat else max(length, 1)

    def run(carry, t0: int):
        ys = []
        for t in range(t0, min(t0 + c, length)):
            carry, y = step_fn(carry, pytree.tree_map_only(
                torch.Tensor, lambda x: x[t], xs))
            ys.append(y)
        return carry, ys

    carry, ys = init, []
    for t0 in range(0, length, c):
        carry, part = layers.remat(run, carry, t0, enabled=remat)
        ys += part
    if not ys or all(y is None for y in ys):
        return carry, None
    flat = [pytree.tree_flatten(y)[0] for y in ys]
    spec = pytree.tree_flatten(ys[0])[1]
    stacked = [torch.stack(col) if isinstance(col[0], torch.Tensor) else None
               for col in zip(*flat)]
    return carry, pytree.tree_unflatten(stacked, spec)
