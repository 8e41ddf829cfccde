"""The port's latent attention (MLA, ``models/attention.py``) against the
JAX package, on the CPU.

``mla_full`` below ``FLASH_THRESHOLD`` (``_sdpa``) and above it
(``flash_sdpa``, at the published head dims: q·k over 192, v 128), the
latent cache it writes, and four absorbed ``mla_decode`` steps after a
prefill, each against the reference's, the cache written in place.
Inputs are made with numpy from a seed; the reference runs under
``jax.jit``.  Limits are ``tests/test_torch_models.py``'s (relative to the
reference's max |value|).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import attention as jattention
from repro.models import config as jconfig

from repro_torch.models import attention, layers
from repro_torch.models import config as pconfig

from test_torch_models import BF16_LAYER, F32_LAYER, pt, rel_err

#: the reference's tiny ``mla`` family's dims, and the published head dims
MLA_DIMS = {"tiny": dict(q_lora_rank=32, kv_lora_rank=16,
                         qk_nope_head_dim=16, qk_rope_head_dim=8,
                         v_head_dim=16),
            "published": dict(q_lora_rank=64, kv_lora_rank=32,
                              qk_nope_head_dim=128, qk_rope_head_dim=64,
                              v_head_dim=128)}


def _cfgs(dims="tiny", dtype="float32", heads=4):
    def one(cls):
        return cls.ModelConfig(
            name="mla", family="moe", d_model=64, num_heads=heads,
            num_kv_heads=heads, d_ff=128, vocab_size=97, head_dim=16,
            groups=(cls.ScanGroup((("mla", "mlp"),), 2),),
            mla=cls.MLAConfig(**MLA_DIMS[dims]), param_dtype=dtype,
            compute_dtype=dtype, remat=False)
    return one(jconfig), one(pconfig)


def _params(jcfg, seed=5):
    """numpy MLA weights of the reference's shapes (norms near 1,
    matrices N(0, 1/d_in)), for both packages."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jattention.init_mla(
        jax.random.PRNGKey(0), jcfg))
    out = {}
    for name, leaf in shapes.items():
        if "norm" in name:
            x = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            x = rng.standard_normal(leaf.shape) / math.sqrt(leaf.shape[0])
        out[name] = jnp.asarray(x.astype(np.float32), leaf.dtype)
    return out, {k: pt(np.asarray(v)) for k, v in out.items()}


def _x(shape, seed=6, dtype=jnp.float32):
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(
        np.float32)
    jx = jnp.asarray(x, dtype)
    return jx, pt(np.asarray(jx))


def test_init_mla_is_the_references_tree():
    jcfg, pcfg = _cfgs("published", "bfloat16")
    want = jax.eval_shape(lambda: jattention.init_mla(
        jax.random.PRNGKey(0), jcfg))
    got = attention.init_mla(layers.Init.of(0, "meta"), pcfg)
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == tuple(leaf.shape), name
        assert got[name].dtype == torch.bfloat16


@pytest.mark.parametrize("dims, s, cache_len", [
    ("tiny", 64, 72), ("tiny", 64, 40), ("published", 1536, 1540)])
def test_mla_full_below_and_above_the_flash_threshold(dims, s, cache_len):
    """Below the threshold ``_sdpa``, above it ``flash_sdpa`` with q·k over
    192 dims and v over 128; the latent cache holds the first
    ``cache_len`` positions (truncated where the prompt is longer)."""
    jcfg, pcfg = _cfgs(dims, heads=2 if dims == "published" else 4)
    jp, pp = _params(jcfg)
    jx, px = _x((2 if s < 1024 else 1, s, 64))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None],
                          (px.shape[0], s))
    want, jc = jax.jit(lambda p, x, q: jattention.mla_full(
        p, x, jcfg, positions=q, want_cache=True, cache_len=cache_len))(
        jp, jx, jnp.asarray(pos))
    got, pc = attention.mla_full(pp, px, pcfg, positions=pt(pos),
                                 want_cache=True, cache_len=cache_len)
    assert (s > attention.FLASH_THRESHOLD) == (s > 1024)
    # rotations of positions past 1024: XLA's and torch's f32 sin/cos of
    # large angles differ by a few ulp of the angle (as the GQA test's)
    limit = F32_LAYER if s <= 1024 else 10 * F32_LAYER
    assert rel_err(want, got) <= limit
    assert pc["lat"].shape == (px.shape[0], cache_len, pcfg.mla.cache_dim)
    assert rel_err(jc["lat"], pc["lat"]) <= limit


@pytest.mark.parametrize("dtype, limit", [("float32", F32_LAYER),
                                          ("bfloat16", BF16_LAYER)])
def test_mla_decode_after_a_prefill(dtype, limit):
    """Prefill 12 positions with the cache, then four absorbed decode steps
    of given inputs: each step's output and the cache against the
    reference's; the port writes each latent into the buffer it was
    given."""
    jcfg, pcfg = _cfgs(dtype=dtype)
    jp, pp = _params(jcfg)
    jx, px = _x((2, 16, 64), dtype=jnp.dtype(dtype))
    s0, cache_len = 12, 17
    pos = np.broadcast_to(np.arange(s0, dtype=np.int32)[None], (2, s0))
    _, jc = jax.jit(lambda p, x, q: jattention.mla_full(
        p, x, jcfg, positions=q, want_cache=True, cache_len=cache_len))(
        jp, jx[:, :s0], jnp.asarray(pos))
    _, pc = attention.mla_full(pp, px[:, :s0], pcfg, positions=pt(pos),
                               want_cache=True, cache_len=cache_len)
    decode = jax.jit(lambda p, x, c, q: jattention.mla_decode(
        p, x, jcfg, c, positions=q))
    buf = pc["lat"]
    for t in range(4):
        p = np.array([s0 + t, s0 + t + 1], np.int32)   # rows apart
        want, jc = decode(jp, jx[:, s0 + t:s0 + t + 1], jc, jnp.asarray(p))
        got, pc = attention.mla_decode(pp, px[:, s0 + t:s0 + t + 1], pcfg,
                                       pc, positions=pt(p))
        assert pc["lat"] is buf
        assert got.dtype == px.dtype
        assert rel_err(want, got) <= limit, t
        assert rel_err(jc["lat"], pc["lat"]) <= limit, t


def test_mla_decode_takes_one_token():
    _, pcfg = _cfgs()
    _, pp = _params(_cfgs()[0])
    cache = attention.init_mla_cache(pcfg, 1, 8, torch.float32)
    with pytest.raises(ValueError, match="one token"):
        attention.mla_decode(pp, torch.zeros(1, 2, 64), pcfg, cache,
                             positions=torch.zeros(1, dtype=torch.int32))
