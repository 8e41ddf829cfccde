"""Streaming flash attention — the SSR technique applied to the LM hot spot.

Attention is the paper's reduction (§4.1/Fig. 4) writ large, and it is
nest-lowered, as in ``repro.kernels.attention``: the module declares only
:func:`repro_torch.core.compiler.attention_nest` — K/V read streams over
the kv contraction level, Q a repeat stream, and an output WRITE ref with
``acc_kind="online_softmax"`` — plus the score body.  The lowering owns the
flash recurrence: the m/l/acc state is carried across the kv walk and
rescaled by ``exp(m − m')`` every step; the causal, sliding-window and
padded-column masks are index arithmetic in the body (against the step's
global offsets), filled with −1e30.

On the card the recurrence runs as K11 ``rescale_attention``
(``csrc/rescale_attention.cu``), the kv walk a loop inside each CTA; a
schedule deeper than 2 runs R12 ``ring_rescale_attention``, K11's
arithmetic with K and V arriving through N-deep rings.  The
mask parameters and the head dim are the body's
:class:`~repro_torch.core.ssr.KernelBody` ``params``, so each keys the
kernel caches.

Heads: the reference runs heads with ``jax.vmap``; here q (…, Sq, D) and
k, v (…, Sk, D) with the same leading dims run as ONE K11 launch whose CTA
grid has a head axis, over the single-head plan.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import compiler, lowering
from ..core.lowering import Schedule
from ..core.ssr import KernelBody
from .frontend import NestKernel, on_device, promote
from .registry import KernelEntry, register_kernel

_NEG_INF = -1e30


def _prepare(q, k, v, causal=False, window=None, scale=None, bq=128,
             bk=128):
    # bq/bk are kept for call-site compatibility with the reference; the
    # tiles come from the lowering's schedule
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    static = (sq, sk, d, bool(causal), window, float(scale), q.dtype)
    return {"Q": q, "K": k, "V": v}, static, None


def _nest(static):
    return compiler.attention_nest(*static[:3])


def attention_scores(k_blk, v_blk, q_blk, offs, causal, window, scale,
                     off_rc, sk, d):
    """Raw scores of one (q-tile, kv-tile) step, scaled and masked; the
    lowering's online-softmax kernel owns the m/l/acc recurrence.  ``offs``
    are the per-level global offsets (q, d, kv); query rows align to the
    keys' end (``off_rc = sk − sq``).  ``d`` is the head dim: the blocks'
    lanes past it are the layout's zero padding, which add 0 here and which
    the card's kernel neither stages nor sums."""
    s = torch.matmul(promote(q_blk), promote(k_blk).mT) * scale
    rows = offs[0] + torch.arange(s.shape[0], device=s.device)[:, None] \
        + off_rc
    cols = offs[2] + torch.arange(s.shape[1], device=s.device)[None, :]
    mask = cols < sk                     # padded kv columns
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    return torch.where(mask, s, _NEG_INF), v_blk


def _body(static) -> KernelBody:
    sq, sk, d, causal, window, scale, _dt = static
    return KernelBody(attention_scores, "attn_scores",
                      params=(causal, window, scale, sk - sq, sk, d))


_ssr = NestKernel("attention", prepare=_prepare, nest=_nest, body=_body,
                  out_dtype=lambda static: static[6])


def ssr_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, bq: int = 128,
                        bk: int = 128, schedule: Optional[Schedule] = None,
                        device=None) -> torch.Tensor:
    """Streaming attention; q (…, Sq, D), k/v (…, Sk, D), out in q's dtype.

    Leading dims are a head batch, run as one kernel over every head with
    the single-head plan and schedule (``schedule=None`` resolves the
    tuned schedule of one head).  ``bq``/``bk`` are accepted for call-site
    compatibility (tiles come from the schedule).  With one key (``sk ==
    1``) the softmax of its one score is 1, so the result is ``v[0]`` for
    every query, as ``attention_ref`` gives; the reference raises there
    (its lowering keeps no kv level of bound 1).
    """
    dev = resolve_device(device)
    q, k, v = on_device((q, k, v), dev)
    lead = tuple(q.shape[:-2])
    if tuple(k.shape[:-2]) != lead or tuple(v.shape[:-2]) != lead \
            or k.shape[-2] != v.shape[-2]:
        raise ValueError(f"attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} need the "
                         "same leading (head) dims and one kv length")
    sq, d = q.shape[-2:]
    if k.shape[-2] == 1:
        return v[..., :1, :].to(q.dtype).expand(*lead, sq,
                                                v.shape[-1]).contiguous()
    if not lead:
        return _ssr(q, k, v, causal=causal, window=window, scale=scale,
                    bq=bq, bk=bk, schedule=schedule, device=dev)
    heads = math.prod(lead)
    qh, kh, vh = (t.reshape(heads, *t.shape[-2:]) for t in (q, k, v))
    operands, static, _ = _prepare(qh[0], kh[0], vh[0], causal, window,
                                   scale)
    # schedule=None: one head's tuned schedule, resolved once per problem
    # and autotune epoch, with the tuned → default ladder of ssr_call
    call = lowering.prepare_call(_nest(static), _body(static), operands,
                                 out_dtype=q.dtype, schedule=schedule,
                                 device=dev)
    batch = {"Q": qh, "K": kh, "V": vh}
    layouts = lowering.stream_layouts(
        call.lowered, [batch[s.name] for s in call.lowered.in_streams],
        lead=(heads,))
    return call.finish(call.kernel(*layouts)).reshape(*lead, sq, d)


@register_kernel("attention")
def _entry() -> KernelEntry:
    from . import ref

    def _ref(q, k, v, **kw):
        return ref.attention_ref(q, k, v, **kw).to(q.dtype)

    def example(rng: np.random.Generator, odd: bool = False):
        sq, sk = (128, 256) if odd else (256, 256)
        d = 64
        return tuple(torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)) for s in ((sq, d), (sk, d), (sk, d))), \
            {"causal": True}

    return KernelEntry(name="attention", ssr=ssr_flash_attention, ref=_ref,
                       example=example, tol={"rtol": 2e-4, "atol": 2e-4},
                       problem="flash attention, S=256 D=64")
