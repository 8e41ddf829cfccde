"""Recurrent mixers: Mamba selective SSM and xLSTM (mLSTM / sLSTM) cells.

A sequential recurrence whose operands stream past a small resident
state.  The full-sequence paths walk time in Python loops (the
reference's ``lax.scan``s); decode is a single-step state update, O(1) a
token.  With ``cfg.remat``, as the reference's ``jax.checkpoint``s, each
chunk body (Mamba's and mLSTM's, sLSTM's steps through
``flash.chunked_scan``) is recomputed in backward, which keeps only the
chunk-boundary state: one chunk's transition tensors at a time, not the
sequence's.

As in the reference: the selective scan is a straight sequential scan
(chunked only to bound the (B, chunk, di, d_state) transition tensors),
and the xLSTM blocks omit the small causal-conv pre-layers.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .config import MambaConfig, ModelConfig, XLSTMConfig
from .flash import chunked_scan
from .layers import Init, dot, dtype_of, init_dense, remat, rms_norm

# sequence-chunk length of the chunked schedules below
SCAN_CHUNK = 256


def _chunk(s: int) -> int:
    """SCAN_CHUNK halved until it divides ``s`` (1 for an odd length)."""
    c = SCAN_CHUNK
    while s % c:
        c //= 2
    return c


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def _dt_rank(cfg: ModelConfig) -> int:
    m = cfg.mamba
    return m.dt_rank or max(1, math.ceil(cfg.d_model / 16))


def init_mamba(init: Init, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    m: MambaConfig = cfg.mamba
    d = cfg.d_model
    di = m.expand * d
    dtr = _dt_rank(cfg)
    dt = dtype_of(cfg.param_dtype)
    a = torch.arange(1, m.d_state + 1, dtype=torch.float32,
                     device=init.device).repeat(di, 1)
    return {
        "w_in": init_dense(init, d, 2 * di, dt),
        "conv_w": init.normal((m.d_conv, di), 0.1, dt),
        "conv_b": init.zeros((di,), dt),
        "w_xproj": init_dense(init, di, dtr + 2 * m.d_state, dt),
        "w_dt": init_dense(init, dtr, di, dt),
        "dt_bias": init.zeros((di,), dt),
        "a_log": torch.log(a).to(dt),
        "d_skip": init.ones((di,), dt),
        "w_out": init_dense(init, di, d, dt),
    }


def _mamba_inner(params, xc: torch.Tensor, cfg: ModelConfig):
    """Per-step SSM tensors from the conv output xc (..., di)."""
    m = cfg.mamba
    dtr = _dt_rank(cfg)
    proj = dot(xc, params["w_xproj"])
    dt_in = proj[..., :dtr]
    b_ssm = proj[..., dtr:dtr + m.d_state]
    c_ssm = proj[..., dtr + m.d_state:]
    delta = F.softplus(dot(dt_in, params["w_dt"]).float()
                       + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    return delta, a, b_ssm.float(), c_ssm.float()


def mamba_full(params, x: torch.Tensor, cfg: ModelConfig, *,
               want_cache: bool = False):
    """x (B, S, D) → (B, S, D); optionally the terminal recurrent state.

    The selective scan runs chunk by chunk (``SCAN_CHUNK`` halved until it
    divides S): a chunk's (Δ, A, B, C) projections and its (B, chunk, di,
    d_state) transition tensors, then its steps in order.
    """
    m: MambaConfig = cfg.mamba
    b, s, d = x.shape
    di = m.expand * d
    xz = dot(x, params["w_in"])
    xi, z = xz[..., :di], xz[..., di:]
    # depthwise causal conv along S: one product and one add a tap, each
    # rounded in the storage dtype, in the reference's order
    pad = F.pad(xi, (0, 0, m.d_conv - 1, 0))
    xc = sum(pad[:, j:j + s, :] * params["conv_w"][j]
             for j in range(m.d_conv))
    xc = F.silu(xc + params["conv_b"])

    def chunk_body(h, xck):
        delta, a, b_ssm, c_ssm = _mamba_inner(params, xck, cfg)
        da = torch.exp(delta[..., None] * a)                 # (B,c,di,ds)
        dbx = (delta * xck.float())[..., None] * b_ssm[:, :, None, :]
        ys = []
        for t in range(xck.shape[1]):
            h = da[:, t] * h + dbx[:, t]
            ys.append(torch.bmm(h, c_ssm[:, t, :, None])[..., 0])
        return h, torch.stack(ys, dim=1)

    c = _chunk(s)
    h = torch.zeros((b, di, m.d_state), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(0, s, c):
        h, yc = remat(chunk_body, h, xc[:, i:i + c], enabled=cfg.remat)
        ys.append(yc)
    y = torch.cat(ys, dim=1)                                 # (B, S, di)
    y = y + xc.float() * params["d_skip"].float()
    out = dot((y * F.silu(z.float())).to(x.dtype), params["w_out"])
    cache = None
    if want_cache:
        cache = {"conv": xi[:, -(m.d_conv - 1):, :], "ssm": h}
    return out.to(x.dtype), cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype, *,
                     device=None):
    m = cfg.mamba
    di = m.expand * cfg.d_model
    return {"conv": torch.zeros((batch, m.d_conv - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, m.d_state), dtype=torch.float32,
                               device=device)}


def mamba_decode(params, x: torch.Tensor, cfg: ModelConfig, cache, *,
                 positions=None):
    """One-token step → (out, the new state); ``cache`` is not written."""
    m: MambaConfig = cfg.mamba
    di = m.expand * cfg.d_model
    xz = dot(x[:, 0], params["w_in"])
    xi, z = xz[..., :di], xz[..., di:]
    window = torch.cat([cache["conv"], xi[:, None, :]], dim=1)
    # one contraction over the taps, as the reference's einsum
    xc = torch.einsum("bkd,kd->bd", window, params["conv_w"])
    xc = F.silu(xc + params["conv_b"])
    delta, a, b_ssm, c_ssm = _mamba_inner(params, xc, cfg)
    da = torch.exp(delta[..., None] * a)
    h = da * cache["ssm"] + (delta * xc.float())[..., None] \
        * b_ssm[:, None, :]
    y = torch.bmm(h, c_ssm[..., None])[..., 0]
    y = y + xc.float() * params["d_skip"].float()
    out = dot((y * F.silu(z.float())).to(x.dtype), params["w_out"])
    return out[:, None, :].to(x.dtype), {"conv": window[:, 1:], "ssm": h}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory) blocks.
# d_ff = 0 in the xlstm-125m config: the blocks own their projections
# (mLSTM pre-up-projection ×2, sLSTM post gated FFN ×4/3).
# ---------------------------------------------------------------------------


def init_mlstm(init: Init, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    xc: XLSTMConfig = cfg.xlstm
    d = cfg.d_model
    dp = int(xc.mlstm_proj_factor * d)
    h = cfg.num_heads
    dt = dtype_of(cfg.param_dtype)
    return {
        "w_up": init_dense(init, d, dp, dt),
        "w_gate": init_dense(init, d, dp, dt),
        "wq": init_dense(init, dp, dp, dt),
        "wk": init_dense(init, dp, dp, dt),
        "wv": init_dense(init, dp, dp, dt),
        "w_ifo": init_dense(init, dp, 3 * h, dt),  # input/forget gates a head
        "skip_norm": init.ones((dp,), dt),
        "w_down": init_dense(init, dp, d, dt),
    }


def _mlstm_gates(params, u: torch.Tensor, h: int):
    g = dot(u, params["w_ifo"]).float()
    # three equal parts, as jnp.split(g, 3): not pieces of size 3
    i_pre, f_pre, _ = torch.chunk(g, 3, dim=-1)
    return i_pre, f_pre


def mlstm_full(params, x: torch.Tensor, cfg: ModelConfig, *,
               want_cache: bool = False):
    """Chunkwise-parallel mLSTM (the xLSTM paper's training form).

    Within a chunk the decayed outer-product memory is a masked (c × c)
    attention-like contraction; across chunks the (C, n, m) state carries
    recurrently, in stabilised (÷ exp(m)) units identical to the decode
    path.  The chunk is ``SCAN_CHUNK`` halved until it divides S, and the
    sums change with it, as the reference's do.
    """
    xcfg = cfg.xlstm
    b, s, d = x.shape
    h = cfg.num_heads
    dp = int(xcfg.mlstm_proj_factor * d)
    dh = dp // h
    u = dot(x, params["w_up"])
    gate = dot(x, params["w_gate"])
    q = dot(u, params["wq"]).reshape(b, s, h, dh).float()
    k = (dot(u, params["wk"]).reshape(b, s, h, dh) / math.sqrt(dh)).float()
    v = dot(u, params["wv"]).reshape(b, s, h, dh).float()
    i_pre, f_pre = _mlstm_gates(params, u, h)                # (B, S, H)

    c = _chunk(s)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]

    def chunk_body(C, n, m, qc, kc, vc, ic, fc):
        Lf = torch.cumsum(F.logsigmoid(fc), dim=1)           # inclusive
        a_inter = m[:, None] + Lf                            # (B, c, H)
        # intra-chunk decay: D[t,s] = Lf_t − Lf_s + i_s  (s ≤ t)
        D = Lf[:, :, None] - Lf[:, None, :] + ic[:, None, :]  # (B,c,c,H)
        D = torch.where(causal, D, -math.inf)
        m_t = torch.maximum(a_inter, torch.amax(D, dim=2))   # (B, c, H)
        # inter-chunk path
        scale_in = torch.exp(a_inter - m_t)
        num_in = torch.einsum("bhvk,bthk->bthv", C, qc) * scale_in[..., None]
        den_in = torch.einsum("bhk,bthk->bth", n, qc) * scale_in
        # intra-chunk path
        w = torch.exp(D - m_t[:, :, None, :])                # (B,c,c,H)
        qk = torch.einsum("bthd,bshd->btsh", qc, kc)
        wqk = w * qk
        num = num_in + torch.einsum("btsh,bshd->bthd", wqk, vc)
        den = den_in + torch.sum(wqk, dim=2)
        y = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
        # end-of-chunk state update (stabilised against m_new)
        LfT = Lf[:, -1]                                      # (B, H)
        m_new = torch.maximum(m + LfT, torch.amax(
            LfT[:, None] - Lf + ic, dim=1))
        wS = torch.exp(LfT[:, None] - Lf + ic - m_new[:, None])  # (B,c,H)
        decay = torch.exp(m + LfT - m_new)
        C = decay[:, :, None, None] * C \
            + torch.einsum("bsh,bshv,bshk->bhvk", wS, vc, kc)
        n = decay[..., None] * n + torch.einsum("bsh,bshk->bhk", wS, kc)
        return C, n, m_new, y

    C = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
    m = torch.zeros((b, h), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(0, s, c):
        C, n, m, y = remat(chunk_body, C, n, m, q[:, i:i + c], k[:, i:i + c],
                           v[:, i:i + c], i_pre[:, i:i + c],
                           f_pre[:, i:i + c], enabled=cfg.remat)
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(b, s, dp)
    # the norm runs over the whole dp width, not a head at a time
    y = rms_norm(y.to(x.dtype), params["skip_norm"], cfg.norm_eps)
    out = dot((y.float() * F.silu(gate.float())).to(x.dtype),
              params["w_down"])
    cache = {"C": C, "n": n, "m": m} if want_cache else None
    return out.to(x.dtype), cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype, *,
                     device=None):
    h = cfg.num_heads
    dp = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    dh = dp // h
    f32 = torch.float32
    return {"C": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
            "m": torch.zeros((batch, h), dtype=f32, device=device)}


def mlstm_decode(params, x: torch.Tensor, cfg: ModelConfig, cache, *,
                 positions=None):
    """One-token step → (out, the new state); ``cache`` is not written."""
    b = x.shape[0]
    h = cfg.num_heads
    dp = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    dh = dp // h
    u = dot(x[:, 0], params["w_up"])
    gate = dot(x[:, 0], params["w_gate"])
    q = dot(u, params["wq"]).reshape(b, h, dh).float()
    k = (dot(u, params["wk"]).reshape(b, h, dh) / math.sqrt(dh)).float()
    v = dot(u, params["wv"]).reshape(b, h, dh).float()
    i_pre, f_pre = _mlstm_gates(params, u, h)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + cache["m"], i_pre)
    i_sc = torch.exp(i_pre - m_new)
    f_sc = torch.exp(logf + cache["m"] - m_new)
    C = f_sc[..., None, None] * cache["C"] + i_sc[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f_sc[..., None] * cache["n"] + i_sc[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", C, q)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, q)),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(b, dp)
    y = rms_norm(y.to(x.dtype), params["skip_norm"], cfg.norm_eps)
    out = dot((y.float() * F.silu(gate.float())).to(x.dtype),
              params["w_down"])
    return out[:, None].to(x.dtype), {"C": C, "n": n, "m": m_new}


def init_slstm(init: Init, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    df = int(cfg.xlstm.slstm_proj_factor * d)
    dt = dtype_of(cfg.param_dtype)
    return {
        "w_zifo": init_dense(init, d, 4 * d, dt),
        "r_zifo": init_dense(init, d, 4 * d, dt, scale=0.5),
        "b_zifo": init.zeros((4 * d,), dt),
        "ffn_up": init_dense(init, d, 2 * df, dt),
        "ffn_down": init_dense(init, df, d, dt),
    }


def _slstm_step(params, x_t: torch.Tensor, carry):
    """x_t (B, D) f32; carry (c, n, h, m) each (B, D) f32."""
    c, n, h, m = carry
    pre = (torch.matmul(x_t, params["w_zifo"].float())
           + torch.matmul(h, params["r_zifo"].float())
           + params["b_zifo"].float())
    # four equal parts, as jnp.split(pre, 4)
    z_p, i_p, f_p, o_p = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z_p)
    o = torch.sigmoid(o_p)
    logf = F.logsigmoid(f_p)
    m_new = torch.maximum(logf + m, i_p)
    i_sc = torch.exp(i_p - m_new)
    f_sc = torch.exp(logf + m - m_new)
    c_new = f_sc * c + i_sc * z
    n_new = f_sc * n + i_sc
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_ffn(params, y: torch.Tensor) -> torch.Tensor:
    """The post gated FFN (×4/3)."""
    df2 = params["ffn_up"].shape[1]
    up = dot(y, params["ffn_up"]).float()
    g, u = up[..., :df2 // 2], up[..., df2 // 2:]
    return dot((F.silu(g) * u).to(y.dtype), params["ffn_down"])


def slstm_full(params, x: torch.Tensor, cfg: ModelConfig, *,
               want_cache: bool = False):
    """sLSTM has a true hidden-to-hidden recurrence (no parallel form, per
    the xLSTM paper): one step a token, through ``chunked_scan``."""
    b, s, d = x.shape
    # the recurrence's weights in f32 once, not once a step
    w32 = {name: params[name].float()
           for name in ("w_zifo", "r_zifo", "b_zifo")}
    init = tuple(torch.zeros((b, d), dtype=torch.float32, device=x.device)
                 for _ in range(4))
    carry, ys = chunked_scan(
        lambda cr, xt: _slstm_step(w32, xt, cr),
        init, x.float().transpose(0, 1), chunk=SCAN_CHUNK, length=s,
        remat=cfg.remat)
    y = ys.transpose(0, 1).to(x.dtype)
    out = _slstm_ffn(params, y)
    cache = None
    if want_cache:
        cache = dict(zip("cnhm", carry))
    return out.to(x.dtype), cache


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype, *,
                     device=None):
    d = cfg.d_model
    return {k: torch.zeros((batch, d), dtype=torch.float32, device=device)
            for k in "cnhm"}


def slstm_decode(params, x: torch.Tensor, cfg: ModelConfig, cache, *,
                 positions=None):
    """One-token step → (out, the new state); ``cache`` is not written."""
    carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    carry, y = _slstm_step(params, x[:, 0].float(), carry)
    out = _slstm_ffn(params, y[:, None].to(x.dtype))
    return out.to(x.dtype), dict(zip("cnhm", carry))
