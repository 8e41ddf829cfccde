"""The port's model stack against the JAX package, on the CPU.

Layers, the flash tile walk, GQA attention (full below and above
``FLASH_THRESHOLD``, decode with the sliding-window ring), the model's
``forward`` and ``decode_step`` on one set of weights
(``interop.params_from_reference``) for all ten smoke configs and the
reference's tiny families (dense, swa, moe, mla, hybrid, xlstm), the
aux loss, the configs and the synthetic data.  The experts, MLA and the
recurrent mixers alone: ``tests/test_torch_{moe,mla,ssm}.py``.
Inputs are made with numpy from a seed and handed to both packages.

Limits, each relative to the reference's max |value| unless said:

* f32 layers, ``F32_LAYER`` = 1e-6: one f32 sum in another order reads
  about 1e-7;
* bf16 layers, ``BF16_LAYER`` = 2**-8: both round their result to bf16
  (8 bits), so a sum that lands on the other side of a rounding boundary
  moves one ulp, 2**-8 of the value at most;
* f32 logits, ``F32_LOGITS`` = 1e-5 (of the row's max |logit| over the
  batch): reads 1e-6 on the smoke configs; times the mLSTM layers where
  a config has them (``logits_limit``);
* bf16 logits, ``BF16_LOGITS`` = 2**-5: every bf16 activation may round
  one ulp (2**-8) the other way, and a few layers of residual sums carry
  a few such ulps into the logits.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

import jax
import jax.numpy as jnp
from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.data import pipeline as jpipeline
from repro.models import attention as jattention
from repro.models import config as jconfig
from repro.models import flash as jflash
from repro.models import layers as jlayers
from repro.models import model as jmodel

from repro_torch import configs, interop
from repro_torch.configs import shapes
from repro_torch.data import pipeline
from repro_torch.models import attention, blocks, flash, layers, model
from repro_torch.models.config import ModelConfig, ScanGroup
from repro_torch.parallel import activations

F32_LAYER = 1e-6
BF16_LAYER = 2.0 ** -8
F32_LOGITS = 1e-5
BF16_LOGITS = 2.0 ** -5

DENSE = ["yi_6b", "llama3_405b", "h2o_danube_18b", "qwen3_14b",
         "hubert_xlarge", "internvl2_26b"]
#: the archs of the experts, the latent attention and the recurrent mixers
FAMILIES = ["xlstm_125m", "jamba_v01_52b", "deepseek_v3_671b", "dbrx_132b"]


def tiny(cls, name, **kw):
    """``tests/test_models.py``'s tiny configs, in either package."""
    base = dict(
        name=name, family="dense", d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=97,
        groups=(cls.ScanGroup((("attn", "mlp"),), 2),),
        head_dim=16, remat=False)
    base.update(kw)
    return cls.ModelConfig(**base)


#: ``tests/test_models.py``'s tiny families: each kind's settings, given
#: the package's config module
TINY = {
    "dense": lambda c: dict(qk_norm=True),
    "swa": lambda c: dict(window=24),
    "moe": lambda c: dict(
        groups=(c.ScanGroup((("attn", "moe"),), 2),),
        moe=c.MoEConfig(num_experts=4, top_k=2, d_expert=32, num_shared=1,
                        capacity_factor=2.0)),
    "mla": lambda c: dict(
        num_kv_heads=4, groups=(c.ScanGroup((("mla", "mlp"),), 2),),
        mla=c.MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                        qk_nope_head_dim=16, qk_rope_head_dim=8,
                        v_head_dim=16)),
    "hybrid": lambda c: dict(
        groups=(c.ScanGroup((("mamba", "mlp"), ("attn", "mlp")), 1),),
        mamba=c.MambaConfig(d_state=4)),
    "xlstm": lambda c: dict(
        num_kv_heads=4, d_ff=0,
        groups=(c.ScanGroup((("mlstm", "none"), ("slstm", "none")), 1),),
        xlstm=c.XLSTMConfig()),
}


def both(kind):
    """(reference config, port config) of a tiny kind or a smoke arch."""
    if kind in TINY:
        from repro_torch.models import config as pconfig
        return (tiny(jconfig, kind, **TINY[kind](jconfig)),
                tiny(pconfig, kind, **TINY[kind](pconfig)))
    return jconfigs.get_smoke(kind), configs.get_smoke(kind)


def logits_limit(cfg) -> float:
    """``F32_LOGITS``, times the config's mLSTM layers where it has them.

    An mLSTM layer divides by max(|den|, exp(−m)), which amplifies a
    difference in its input several times (xlstm-125m's smoke variant: 1e-6
    of f32 noise a layer, 1.1e-6 after the first of its five mLSTM layers,
    1.4e-5 after the fifth, 1.6e-5 at the logits); so each mLSTM layer
    adds ``F32_LOGITS`` to the limit.
    """
    n = sum(g.repeats * sum(m == "mlstm" for m, _ in g.pattern)
            for g in cfg.groups)
    return F32_LOGITS * max(1, n)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def rel_err(want, got) -> float:
    want, got = as_np(want), as_np(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    return float(np.abs(want - got).max() / np.abs(want).max())


def pt(a) -> torch.Tensor:
    return interop.to_tensor(np.asarray(a), "cpu")


def weights(jcfg, pcfg, seed=1):
    """A reference ``init_params`` tree (its shapes and dtypes, numpy
    values: norms and skips near 1, biases N(0, 0.01), embeddings
    N(0, 0.02²), matrices N(0, 1/d_in))
    and the port's tree of the same values, through
    ``params_from_reference``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name or "d_skip" in name:
            x = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif len(leaf.shape) == 1:      # biases
            x = 0.1 * rng.standard_normal(leaf.shape)
        elif "embed" in name:
            x = 0.02 * rng.standard_normal(leaf.shape)
        else:
            x = rng.standard_normal(leaf.shape) / math.sqrt(leaf.shape[-2])
        return np.asarray(jnp.asarray(x.astype(np.float32), leaf.dtype))

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return (jax.tree.map(jnp.asarray, tree),
            interop.params_from_reference(tree, pcfg, device="cpu"))


def inputs(jcfg, rng, b, s):
    """numpy tokens and stub embeddings for both packages' forward."""
    kw = {}
    if jcfg.frontend != "audio":
        kw["tokens"] = rng.integers(0, jcfg.vocab_size, (b, s)).astype(
            np.int32)
    if jcfg.frontend is not None:
        n = s if jcfg.frontend == "audio" else jcfg.frontend_len
        kw["embeds"] = (rng.standard_normal((b, n, jcfg.d_model)) * 0.1
                        ).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in kw.items()},
            {k: torch.from_numpy(v) for k, v in kw.items()})


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    wg, wu = ((rng.standard_normal((64, 96)) * 0.2).astype(np.float32)
              for _ in range(2))
    wd = (rng.standard_normal((96, 64)) * 0.2).astype(np.float32)
    return x, w, wg, wu, wd


@pytest.mark.parametrize("dtype, limit", [("float32", F32_LAYER),
                                          ("bfloat16", BF16_LAYER)])
@pytest.mark.parametrize("fn", ["rms_norm", "swiglu", "gelu_mlp"])
def test_layer_matches_reference(fn, dtype, limit):
    x, w, wg, wu, wd = _layer_inputs()
    args = {"rms_norm": (x, w), "swiglu": (x, wg, wu, wd),
            "gelu_mlp": (x, wu, wd)}[fn]
    jargs = [jnp.asarray(a, dtype) for a in args]
    want = getattr(jlayers, fn)(*jargs)
    got = getattr(layers, fn)(*(pt(a) for a in jargs))
    assert got.dtype == getattr(torch, dtype)
    assert rel_err(want, got) <= limit


def test_gelu_mlp_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh form; torch's default (erf) differs
    from it here by far more than the f32 limit, and the port does not."""
    x, _, _, wu, wd = _layer_inputs(1)
    x = x * 2.0
    want = jlayers.gelu_mlp(jnp.asarray(x), jnp.asarray(wu), jnp.asarray(wd))
    got = layers.gelu_mlp(pt(x), pt(wu), pt(wd))
    erf = layers.dot_f32(F.gelu(layers.dot_f32(pt(x), pt(wu))), pt(wd))
    assert rel_err(want, got) <= F32_LAYER
    assert rel_err(want, erf) > 10 * F32_LAYER


@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6, 5e6])
def test_rope_matches_reference(theta):
    pos = np.broadcast_to(np.arange(64)[None], (2, 64)).astype(np.int32)
    x = np.random.default_rng(2).standard_normal((2, 64, 4, 32)).astype(
        np.float32)
    jc, js = jlayers.rope_angles(jnp.asarray(pos), 32, theta)
    pc, ps = layers.rope_angles(torch.from_numpy(pos), 32, theta)
    # XLA's and torch's f32 pow differ by an ulp for some thetas: the
    # angles at position 63 then differ by ~63 ulp of the frequency
    assert np.abs(as_np(jc) - as_np(pc)).max() <= 1e-5
    assert np.abs(as_np(js) - as_np(ps)).max() <= 1e-5
    want = jlayers.apply_rope(jnp.asarray(x), jc, js)
    got = layers.apply_rope(pt(x), pt(jc), pt(js))
    assert rel_err(want, got) <= F32_LAYER


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None
    want = jlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
    got = layers.softmax_xent(pt(logits), pt(labels),
                              None if mask is None else pt(mask))
    assert abs(float(want) - float(got)) <= F32_LAYER * abs(float(want))


def test_init_draws_in_f32_then_casts():
    init = layers.Init.of(5, "cpu")
    w = layers.init_dense(init, 256, 512, torch.bfloat16, scale=2.0)
    e = layers.init_embed(init, 1000, 64, torch.float32)
    assert w.dtype == torch.bfloat16 and w.shape == (256, 512)
    # N(0, (2/16)²) and N(0, 0.02²): the sample std within 2 %
    assert abs(float(w.float().std()) - 2.0 / 16) < 0.02 * 2.0 / 16
    assert abs(float(e.std()) - 0.02) < 0.02 * 0.02
    again = layers.init_dense(layers.Init.of(5, "cpu"), 256, 512,
                              torch.bfloat16, scale=2.0)
    assert torch.equal(w, again)
    meta = layers.init_dense(layers.Init.of(5, "meta"), 256, 512,
                             torch.bfloat16)
    assert meta.is_meta and meta.shape == (256, 512)


def test_products_sum_in_f32_on_the_cpu():
    """dot_f32 and bmm_f32 give f32 results of bf16 operands, unrounded:
    the upcast product of exact bf16 values."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((3, 8, 32)).astype(
        np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((3, 32, 5)).astype(
        np.float32)).bfloat16()
    got = layers.bmm_f32(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.bmm(a.float(), b.float()))
    got2 = layers.dot_f32(a, b[0])
    assert got2.dtype == torch.float32
    assert torch.equal(got2, torch.matmul(a.float(), b[0].float()))
    assert not torch.equal(torch.matmul(a, b[0]).float(), got2)


# ---------------------------------------------------------------------------
# flash_sdpa and chunked_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("window", [None, 24])
def test_flash_matches_reference(causal, window):
    rng = np.random.default_rng(5)
    b, s, h, kv, dh = 2, 256, 4, 2, 16
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    kw = dict(causal=causal, window=window, scale=0.25, bq=64, bk=64)
    want = jflash.flash_sdpa(*map(jnp.asarray, (q, k, v)),
                             q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                             **kw)
    got = flash.flash_sdpa(*map(pt, (q, k, v)), q_pos=pt(pos),
                           k_pos=pt(pos), **kw)
    assert rel_err(want, got) <= F32_LAYER


def test_chunked_scan_matches_reference():
    def jstep(c, x):
        c = 0.9 * c + x["a"] * x["b"]
        return c, {"c": c, "twice": 2 * c}

    def pstep(c, x):
        c = 0.9 * c + x["a"] * x["b"]
        return c, {"c": c, "twice": 2 * c}

    rng = np.random.default_rng(6)
    xs = {"a": rng.standard_normal((64, 8)).astype(np.float32),
          "b": rng.standard_normal((64, 8)).astype(np.float32)}
    c0 = np.zeros(8, np.float32)
    jc, jys = jflash.chunked_scan(jstep, jnp.asarray(c0),
                                  jax.tree.map(jnp.asarray, xs), chunk=16,
                                  length=64)
    pc, pys = flash.chunked_scan(pstep, pt(c0), {k: pt(v) for k, v in
                                                 xs.items()},
                                 chunk=16, length=64)
    assert rel_err(jc, pc) <= F32_LAYER
    for key in ("c", "twice"):
        assert rel_err(jys[key], pys[key]) <= F32_LAYER


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_params(jcfg, seed=7):
    rng = np.random.default_rng(seed)
    d, hd = jcfg.d_model, jcfg.resolved_head_dim
    out = {name: rng.standard_normal((d, n * hd)).astype(np.float32)
           / math.sqrt(d) for name, n in (("wq", jcfg.num_heads),
                                          ("wk", jcfg.num_kv_heads),
                                          ("wv", jcfg.num_kv_heads))}
    out["wo"] = rng.standard_normal((jcfg.num_heads * hd, d)).astype(
        np.float32) / math.sqrt(jcfg.num_heads * hd)
    for name in ("q_norm", "k_norm"):
        out[name] = (1 + 0.1 * rng.standard_normal(hd)).astype(np.float32) \
            if jcfg.qk_norm else None
    return ({k: None if v is None else jnp.asarray(v) for k, v in out.items()},
            {k: None if v is None else pt(v) for k, v in out.items()})


@pytest.mark.parametrize("kind", ["dense", "swa"])
@pytest.mark.parametrize("s", [64, 2048])
def test_attn_full_below_and_above_the_flash_threshold(kind, s):
    jcfg, pcfg = both(kind)
    jp, pp = _attn_params(jcfg)
    x = (np.random.default_rng(8).standard_normal((1, s, 64)) * 0.5).astype(
        np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    full = jax.jit(lambda p, x, pos: jattention.attn_full(
        p, x, jcfg, positions=pos, want_cache=True, cache_len=s + 8))
    want, jcache = full(jp, jnp.asarray(x), jnp.asarray(pos))
    got, pcache = attention.attn_full(pp, pt(x), pcfg, positions=pt(pos),
                                      want_cache=True, cache_len=s + 8)
    assert (s > attention.FLASH_THRESHOLD) == (s > 1024)
    # rotations of positions up to 2048: XLA's and torch's f32 sin/cos of
    # angles up to 2048 rad differ by a few ulp of the angle (k reads 7e-6)
    limit = F32_LAYER if s <= 1024 else 10 * F32_LAYER
    assert rel_err(want, got) <= limit
    for name in ("k", "v"):
        assert rel_err(jcache[name], pcache[name]) <= limit


@pytest.mark.parametrize("kind", ["dense", "swa"])
def test_attn_decode_across_the_ring(kind):
    """Prefill 16 positions, then decode 20 one at a time: the SWA cache
    (24 slots) wraps at position 24, and its ring must read as the
    reference's; the port's cache is updated in place."""
    jcfg, pcfg = both(kind)
    jp, pp = _attn_params(jcfg)
    rng = np.random.default_rng(9)
    s0, steps = 16, 20
    x = (rng.standard_normal((2, s0 + steps, 64)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(s0)[None], (2, s0)).astype(np.int32)
    cache_len = s0 + steps + 1
    _, jc = jax.jit(lambda p, x, pos: jattention.attn_full(
        p, x, jcfg, positions=pos, want_cache=True, cache_len=cache_len))(
        jp, jnp.asarray(x[:, :s0]), jnp.asarray(pos))
    decode = jax.jit(lambda p, x, c, pos: jattention.attn_decode(
        p, x, jcfg, c, positions=pos))
    _, pc = attention.attn_full(pp, pt(x[:, :s0]), pcfg, positions=pt(pos),
                                want_cache=True, cache_len=cache_len)
    buf = pc["k"]
    for t in range(steps):
        p = np.full((2,), s0 + t, np.int32)
        want, jc = decode(jp, jnp.asarray(x[:, s0 + t:][:, :1]), jc,
                          jnp.asarray(p))
        got, pc = attention.attn_decode(pp, pt(x[:, s0 + t:][:, :1]), pcfg,
                                        pc, positions=pt(p))
        assert pc["k"] is buf
        assert rel_err(want, got) <= F32_LAYER, t
        assert rel_err(jc["v"], pc["v"]) <= F32_LAYER, t
    if kind == "swa":
        assert pc["k"].shape[1] == 24


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def reference_block_aux(jp, jcfg, jkw) -> float:
    """The sum of every reference block's aux loss, walked block by block
    (``repro.models.blocks.block_full``)."""
    from repro.models import blocks as jblocks

    def walk(p, kw):
        h = jmodel._embed_inputs(p, jcfg, kw.get("tokens"), kw.get("embeds"))
        pos = jnp.broadcast_to(jnp.arange(h.shape[1])[None], h.shape[:2])
        aux = jnp.float32(0.0)
        for gp, g in zip(p["groups"], jcfg.groups):
            for r in range(g.repeats):
                for j, (mixer, ffn) in enumerate(g.pattern):
                    lp = jax.tree.map(lambda x: x[r], gp[j])
                    h, _, a = jblocks.block_full(
                        lp, h, jcfg, mixer, ffn, positions=pos,
                        want_cache=False, cache_len=0)
                    aux = aux + a
        return aux

    return float(jax.jit(walk)(jp, jkw))


@pytest.mark.parametrize("kind", ["dense", "swa", *DENSE, "moe", "mla",
                                  "hybrid", "xlstm", *FAMILIES])
def test_forward_matches_reference(kind):
    """Logits against the reference's; the aux loss is the sum of the MoE
    blocks' router losses, the reference's blocks' summed (0 without
    experts: see ``test_aux_sums_every_moe_block``)."""
    jcfg, pcfg = both(kind)
    jp, pp = weights(jcfg, pcfg)
    jkw, pkw = inputs(jcfg, np.random.default_rng(10), 2, 16)
    want, _, jaux = jax.jit(lambda p, kw: jmodel.forward(p, jcfg, **kw))(
        jp, jkw)
    got, _, paux = model.forward(pp, pcfg, **pkw)
    assert got.dtype == torch.float32
    assert rel_err(want, got) <= logits_limit(pcfg)
    want_aux = 0.0
    if jcfg.moe is None:
        assert float(paux) == float(jaux) == 0.0
    else:
        want_aux = reference_block_aux(jp, jcfg, jkw)
        assert abs(float(paux) - want_aux) <= F32_LOGITS * want_aux
    if "tokens" in jkw:   # the loss on the tokens shifted by one
        labels = np.random.default_rng(11).integers(
            0, jcfg.vocab_size, jkw["tokens"].shape).astype(np.int32)
        jl, _ = jax.jit(lambda p, b: jmodel.loss_fn(p, jcfg, b))(
            jp, {**jkw, "labels": jnp.asarray(labels)})
        pl, _ = model.loss_fn(pp, pcfg, {**pkw, "labels": torch.from_numpy(
            labels)})
        # the reference's loss adds its forward's aux (C9): the port's adds
        # every block's
        if jcfg.moe is not None:
            jl = float(jl) + jcfg.moe.router_aux_weight * (
                want_aux - float(jaux))
        assert abs(float(jl) - float(pl)) <= F32_LOGITS * abs(float(jl))


def test_aux_sums_every_moe_block():
    """The reference's ``group_full`` carries only the pattern's last
    block's aux a repeat (``aux + a`` after the loop): on jamba's pattern
    of four MoE blocks it reports the last one's alone.  The port sums
    every block's, as the reference's blocks give them (ROADMAP Queue C,
    C9)."""
    jcfg, pcfg = both("jamba_v01_52b")
    jp, pp = weights(jcfg, pcfg)
    jkw, pkw = inputs(jcfg, np.random.default_rng(10), 2, 16)
    _, _, jaux = jax.jit(lambda p, kw: jmodel.forward(p, jcfg, **kw))(
        jp, jkw)
    _, _, paux = model.forward(pp, pcfg, **pkw)
    every = reference_block_aux(jp, jcfg, jkw)
    assert sum(f == "moe" for _, f in jcfg.groups[0].pattern) == 4
    assert abs(float(paux) - every) <= F32_LOGITS * every
    assert float(jaux) < 0.5 * every        # one block's of four


@pytest.mark.parametrize("kind", ["dense", "swa", *DENSE[:4], "internvl2_26b",
                                  "moe", "mla", "hybrid", "xlstm",
                                  *FAMILIES])
def test_decode_step_matches_reference(kind):
    """Prefill 12 positions with the cache, then 4 decode steps of given
    tokens: each step's logits against the reference's."""
    jcfg, pcfg = both(kind)
    jp, pp = weights(jcfg, pcfg)
    rng = np.random.default_rng(12)
    jkw, pkw = inputs(jcfg, rng, 2, 12)
    start = 12 + (jcfg.frontend_len if jcfg.frontend == "vision" else 0)
    cache_len = start + 5
    _, jc, _ = jax.jit(lambda p, kw: jmodel.forward(
        p, jcfg, want_cache=True, cache_len=cache_len, **kw))(jp, jkw)
    decode = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, jcfg, t, c,
                                                             pos))
    _, pc, _ = model.forward(pp, pcfg, want_cache=True, cache_len=cache_len,
                             **pkw)
    toks = rng.integers(0, jcfg.vocab_size, (4, 2, 1)).astype(np.int32)
    for t in range(4):
        p = np.full((2,), start + t, np.int32)
        want, jc = decode(jp, jnp.asarray(toks[t]), jc, jnp.asarray(p))
        got, pc2 = model.decode_step(pp, pcfg, torch.from_numpy(toks[t]), pc,
                                     torch.from_numpy(p))
        assert pc2 is pc
        assert rel_err(want, got) <= logits_limit(pcfg), t


@pytest.mark.parametrize("arch", ["qwen3_14b", "dbrx_132b"])
def test_forward_in_bf16_matches_reference(arch):
    """bf16 logits within ``BF16_LOGITS``.  The Mamba, MLA and mLSTM smoke
    configs read 0.09–0.10 of max |logit| here: XLA on the CPU keeps a
    fused chain of bf16 operations in f32 (e.g. Mamba's conv sum) where
    the port rounds each operation, 2–6 bf16 ulps a block (ROADMAP Queue
    C, framework differences); they are held in f32."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    pcfg = dataclasses.replace(configs.get_smoke(arch),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    jp, pp = weights(jcfg, pcfg)
    assert pp["embed"].dtype == torch.bfloat16
    jkw, pkw = inputs(jcfg, np.random.default_rng(13), 2, 16)
    want, _, _ = jax.jit(lambda p, kw: jmodel.forward(p, jcfg, **kw))(
        jp, jkw)
    got, _, _ = model.forward(pp, pcfg, **pkw)
    assert got.dtype == torch.float32
    assert rel_err(want, got) <= BF16_LOGITS


def test_params_from_reference_checks_the_tree():
    jcfg, pcfg = both("dense")
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda k: jmodel.init_params(k, jcfg))(jax.random.PRNGKey(0)))
    pp = interop.params_from_reference(jp, pcfg, device="cpu")
    assert pp["groups"][0][0]["mixer"]["wq"].shape == (2, 64, 64)
    np.testing.assert_array_equal(pp["groups"][0][0]["ffn"]["w_up"].numpy(),
                                  jp["groups"][0][0]["ffn"]["w_up"])
    bad = dict(jp, final_norm=np.ones(32, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        interop.params_from_reference(bad, pcfg, device="cpu")
    with pytest.raises(ValueError, match="lm_head"):
        interop.params_from_reference(
            {k: v for k, v in jp.items() if k != "lm_head"}, pcfg,
            device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_reference_takes_every_family(arch):
    """The reference's own bf16 tree of each new family's smoke variant
    carries across leaf for leaf, the f32 router inside it included."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               param_dtype="bfloat16")
    pcfg = dataclasses.replace(configs.get_smoke(arch),
                               param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda k: jmodel.init_params(k, jcfg))(jax.random.PRNGKey(0)))
    pp = interop.params_from_reference(jp, pcfg, device="cpu")
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {pytree.keystr(p): v for p, v in
           pytree.tree_flatten_with_path(pp)[0] if v is not None}
    assert set(want) == set(got)
    for name, v in want.items():
        np.testing.assert_array_equal(as_np(got[name]), as_np(v))
    if jcfg.moe is not None:
        routers = [v for name, v in got.items() if "router" in name]
        assert routers and all(r.dtype == torch.float32 for r in routers)
        assert all(v.dtype == torch.bfloat16 for name, v in got.items()
                   if "experts" in name)


def test_init_params_is_seeded_and_stacked():
    cfg = configs.get_smoke("qwen3_14b")
    a = model.init_params(3, cfg, device="cpu")
    b = model.init_params(torch.Generator().manual_seed(3), cfg,
                          device="cpu")
    c = model.init_params(4, cfg, device="cpu")
    wq = a["groups"][0][0]["mixer"]["wq"]
    assert wq.shape == (1, cfg.d_model, cfg.num_heads * 16)
    assert torch.equal(wq, b["groups"][0][0]["mixer"]["wq"])
    assert not torch.equal(wq, c["groups"][0][0]["mixer"]["wq"])
    if not torch.cuda.is_available():   # no silent CPU path: cuda raises
        with pytest.raises(RuntimeError, match="cuda"):
            model.init_params(3, cfg)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs._ALIASES == jconfigs._ALIASES
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt5")


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_matches_reference_field_for_field(arch):
    for get in ("get", "get_smoke"):
        want = dataclasses.asdict(getattr(jconfigs, get)(arch))
        got = dataclasses.asdict(getattr(configs, get)(arch))
        assert got == want
        alias = arch.replace("_", "-")
        assert dataclasses.asdict(getattr(configs, get)(alias)) == want
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for prop in ("num_layers", "resolved_head_dim", "sub_quadratic",
                 "has_decode"):
        assert getattr(cfg, prop) == getattr(jcfg, prop)
    assert [(c.name, r) for c, r in shapes.cells_for(cfg)] == \
        [(c.name, r) for c, r in jshapes.cells_for(jcfg)]
    assert [dataclasses.asdict(c) for c in shapes.SHAPES] == \
        [dataclasses.asdict(c) for c in jshapes.SHAPES]
    assert set(configs.all_configs()) == set(jconfigs.ARCH_IDS)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_count_matches_reference_without_allocating(arch):
    for get in ("get", "get_smoke"):
        cfg, jcfg = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
    meta = model.init_params(0, configs.get(arch), device="meta")
    assert all(t.is_meta for t in blocks.tree_leaves(meta))


def test_qwen3_14b_is_the_published_size():
    cfg = configs.get("qwen3_14b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.param_dtype) == (
        40, 5120, 40, 8, 17408, 151936, "bfloat16")
    assert 14.7e9 < cfg.param_count() < 14.9e9


def test_smoke_variant_and_uniform_groups_match_reference():
    from repro_torch.models import config as pconfig
    jbase = tiny(jconfig, "x", window=64, num_heads=8, num_kv_heads=2)
    pbase = tiny(pconfig, "x", window=64, num_heads=8, num_kv_heads=2)
    assert dataclasses.asdict(pconfig.smoke_variant(pbase, vocab_size=50)) \
        == dataclasses.asdict(jconfig.smoke_variant(jbase, vocab_size=50))
    assert [dataclasses.asdict(g) for g in
            pconfig.uniform_dense_groups(3, ffn="gelu_mlp")] == \
        [dataclasses.asdict(g) for g in
         jconfig.uniform_dense_groups(3, ffn="gelu_mlp")]
    with pytest.raises(ValueError, match="divisible"):
        ModelConfig(name="x", family="dense", d_model=8, num_heads=3,
                    num_kv_heads=2, d_ff=8, vocab_size=8,
                    groups=(ScanGroup((("attn", "mlp"),), 1),))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_14b", "hubert_xlarge",
                                  "internvl2_26b"])
def test_batches_have_the_reference_shapes_dtypes_and_range(arch):
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    dcfg = pipeline.DataConfig(4, 32, seed=3)
    got = pipeline.make_batch(cfg, dcfg, 5, device="cpu")
    want = jpipeline.make_batch(jcfg, jpipeline.DataConfig(4, 32, seed=3), 5)
    assert set(got) == set(want)
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        assert str(got[name].dtype).split(".")[-1] == \
            str(want[name].dtype), name
    for name in ("tokens", "labels"):
        if name in got:
            assert int(got[name].min()) >= 0
            assert int(got[name].max()) < cfg.vocab_size
    if "tokens" in got:   # labels are the tokens shifted by one
        assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])
    specs = pipeline.input_specs(cfg, dcfg)
    jspecs = jpipeline.input_specs(jcfg, jpipeline.DataConfig(4, 32))
    assert set(specs) == set(jspecs)
    for name, spec in specs.items():
        assert spec.is_meta
        assert tuple(spec.shape) == tuple(jspecs[name].shape)
        assert str(spec.dtype).split(".")[-1] == str(jspecs[name].dtype)


def test_batches_are_a_function_of_seed_and_step():
    cfg = configs.get_smoke("qwen3_14b")
    dcfg = pipeline.DataConfig(4, 32, seed=3)
    a = pipeline.make_batch(cfg, dcfg, 5, device="cpu")
    b = pipeline.make_batch(cfg, dcfg, 5, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], pipeline.make_batch(
        cfg, dcfg, 6, device="cpu")["tokens"])
    assert not torch.equal(a["tokens"], pipeline.make_batch(
        cfg, pipeline.DataConfig(4, 32, seed=4), 5, device="cpu")["tokens"])
    it = pipeline.iterate(cfg, dcfg, start_step=5, device="cpu")
    assert torch.equal(next(it)["tokens"], a["tokens"])
    assert torch.equal(next(it)["tokens"], pipeline.make_batch(
        cfg, dcfg, 6, device="cpu")["tokens"])


def test_tokens_keep_the_markov_structure():
    """Each next token is the last plus a small increment mod V: the
    increments are base // (V // 64) + noise, so below 64 + 5."""
    cfg = configs.get("qwen3_14b")
    toks = pipeline.make_batch(cfg, pipeline.DataConfig(8, 512), 0,
                               device="cpu")["tokens"].long()
    inc = (toks[:, 1:] - toks[:, :-1]) % cfg.vocab_size
    assert int(inc.max()) < 64 + 5
    # Zipf-biased: small increments dominate
    assert float((inc < 5).float().mean()) > 0.5


def test_tokens_diverge_from_the_references_by_design():
    """The reference draws from jax.random, whose bits the port does not
    reproduce: same law, other tokens (ROADMAP Queue C)."""
    cfg, jcfg = configs.get_smoke("qwen3_14b"), jconfigs.get_smoke(
        "qwen3_14b")
    got = pipeline.make_batch(cfg, pipeline.DataConfig(4, 32), 0,
                              device="cpu")["tokens"].numpy()
    want = np.asarray(jpipeline.make_batch(
        jcfg, jpipeline.DataConfig(4, 32), 0)["tokens"])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert not np.array_equal(got, want)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def test_constrain_is_the_identity_and_meshes_raise():
    """``constrain`` is the identity with or without a mesh (explicit
    SPMD places every tensor itself); ``activation_mesh`` sets the ambient
    mesh that ``models/moe.py`` reads, and restores the one before."""
    from repro_torch.launch.mesh import Mesh

    x = torch.ones(4, 8)
    assert activations.constrain(x, activations.BATCH, None) is x
    tree = {"a": x, "b": [x]}
    out = activations.constrain_tree(tree, activations.MODEL, None)
    assert out["a"] is x and out["b"][0] is x
    with activations.activation_mesh(None) as mesh:
        assert mesh is None and activations.get_activation_mesh() is None
    m = Mesh((2, 4), ("data", "model"))
    with activations.activation_mesh(m):
        assert activations.get_activation_mesh() is m
        assert activations.constrain(x, activations.BATCH, None) is x
    assert activations.get_activation_mesh() is None
    from repro.parallel import activations as jactivations
    assert (activations.BATCH, activations.MODEL, activations.BOTH) == (
        jactivations.BATCH, jactivations.MODEL, jactivations.BOTH)
