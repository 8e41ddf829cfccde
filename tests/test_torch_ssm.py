"""The port's recurrent mixers (``models/ssm.py``: Mamba, mLSTM, sLSTM)
against the JAX package, on the CPU.

Each mixer's full-sequence path and the state it returns, at S = 512 (two
of mLSTM's 256-position chunks) and at an odd S (its chunk falls to 1),
then four decode steps from that state, each against the reference's;
and, at the model level, decode keeping every recurrent state in its
slot of the stacked buffers (the buffers given are the buffers returned,
and the state advances).  Inputs are made with numpy from a seed; the
reference runs under ``jax.jit``.  Limits are
``tests/test_torch_models.py``'s: ``F32_LAYER`` (1e-6 of the reference's
max |value|), and for mLSTM's chunks a limit derived from the size of
their exponents (``_mlstm_limit``).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jax
import jax.numpy as jnp
from repro.models import config as jconfig
from repro.models import model as jmodel
from repro.models import ssm as jssm

from repro_torch.models import config as pconfig
from repro_torch.models import layers, model, ssm

from test_torch_models import (F32_LAYER, F32_LOGITS, both, pt, rel_err,
                               tiny, weights)


def _cfgs(mixer):
    """A tiny config of one ``mixer`` layer (d_model 64, 4 heads), in
    either package: the reference's ``hybrid`` and ``xlstm`` families'
    settings."""
    def one(cls):
        kw = dict(mamba=cls.MambaConfig(d_state=4)) if mixer == "mamba" \
            else dict(xlstm=cls.XLSTMConfig(), num_kv_heads=4, d_ff=0)
        return tiny(cls, mixer, groups=(cls.ScanGroup(((mixer, "none"),),
                                                      1),), **kw)
    return one(jconfig), one(pconfig)


def _params(mixer, jcfg, seed=14):
    """numpy weights of the reference's shapes, for both packages."""
    rng = np.random.default_rng(seed)
    init = getattr(jssm, f"init_{mixer}")
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))
    out = {}
    for name, leaf in shapes.items():
        if "norm" in name or name == "d_skip":
            x = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name == "a_log":
            x = np.log(np.arange(1, leaf.shape[1] + 1))[None] \
                + 0.1 * rng.standard_normal(leaf.shape)
        elif len(leaf.shape) == 1:
            x = 0.1 * rng.standard_normal(leaf.shape)
        else:
            scale = 0.5 if name == "r_zifo" else 1.0
            x = scale * rng.standard_normal(leaf.shape) \
                / math.sqrt(leaf.shape[0])
        out[name] = jnp.asarray(x.astype(np.float32), leaf.dtype)
    return out, {k: pt(np.asarray(v)) for k, v in out.items()}


def _mlstm_limit(pp, x: torch.Tensor, s: int) -> float:
    """mLSTM's limit at S: its chunk's decays are exponentials of inclusive
    sums Lf of up to 256 log-sigmoids (|Lf| reaches ~200 at a chunk of
    256), and such an exponent summed in another order differs by a few
    ulp of itself, |Lf| · 2**-24, which the exponential keeps as a
    relative error: 2 such ulps of the largest |Lf|, or ``F32_LAYER``."""
    u = layers.dot(x, pp["w_up"])
    _, f_pre = ssm._mlstm_gates(pp, u, 4)
    c = ssm._chunk(s)
    lf = torch.nn.functional.logsigmoid(f_pre).reshape(2, s // c, c, 4)
    return max(F32_LAYER, 2 * 2.0 ** -24 * float(
        torch.cumsum(lf, dim=2).abs().max()))


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
@pytest.mark.parametrize("s", [512, 37])
def test_full_and_decode_match_reference(mixer, s):
    jcfg, pcfg = _cfgs(mixer)
    jp, pp = _params(mixer, jcfg)
    x = (np.random.default_rng(15).standard_normal((2, s + 4, 64)) * 0.5
         ).astype(np.float32)
    jfull = getattr(jssm, f"{mixer}_full")
    want, jc = jax.jit(lambda p, x: jfull(p, x, jcfg, want_cache=True))(
        jp, jnp.asarray(x[:, :s]))
    got, pc = getattr(ssm, f"{mixer}_full")(pp, pt(x[:, :s]), pcfg,
                                            want_cache=True)
    assert ssm._chunk(s) == (256 if s == 512 else 1)
    limit = _mlstm_limit(pp, pt(x[:, :s]), s) if mixer == "mlstm" \
        else F32_LAYER
    print(f"{mixer} S={s}: limit {limit:.3g}")
    assert rel_err(want, got) <= limit
    assert sorted(pc) == sorted(jc)
    for name in jc:
        assert pc[name].dtype == layers.dtype_of(str(jc[name].dtype))
        assert rel_err(jc[name], pc[name]) <= limit, name
    jdec = jax.jit(lambda p, x, c: getattr(jssm, f"{mixer}_decode")(
        p, x, jcfg, c))
    for t in range(4):
        xt = x[:, s + t:s + t + 1]
        want, jc = jdec(jp, jnp.asarray(xt), jc)
        got, pc = getattr(ssm, f"{mixer}_decode")(pp, pt(xt), pcfg, pc)
        assert rel_err(want, got) <= limit, t
        for name in jc:
            assert rel_err(jc[name], pc[name]) <= limit, (t, name)


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_init_and_caches_are_the_references_shapes(mixer):
    jcfg, pcfg = _cfgs(mixer)
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    pcfg = dataclasses.replace(pcfg, param_dtype="bfloat16")
    want = jax.eval_shape(lambda: getattr(jssm, f"init_{mixer}")(
        jax.random.PRNGKey(0), jcfg))
    got = getattr(ssm, f"init_{mixer}")(layers.Init.of(0, "meta"), pcfg)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == {
        k: (tuple(v.shape), str(v.dtype)[len("torch."):])
        for k, v in got.items()}
    jcache = getattr(jssm, f"init_{mixer}_cache")(jcfg, 3, jnp.bfloat16)
    pcache = getattr(ssm, f"init_{mixer}_cache")(pcfg, 3, torch.bfloat16,
                                                 device="meta")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()} \
        == {k: (tuple(v.shape), str(v.dtype)[len("torch."):])
            for k, v in pcache.items()}


def test_splits_are_equal_parts():
    """``jnp.split(g, 3)``/``(pre, 4)`` cut equal parts: the gates of
    4 heads are (B, 4) each, sLSTM's four pre-activations (B, D) each."""
    jcfg, pcfg = _cfgs("mlstm")
    _, pp = _params("mlstm", jcfg)
    i_pre, f_pre = ssm._mlstm_gates(pp, torch.ones(2, 128), 4)
    assert i_pre.shape == f_pre.shape == (2, 4)
    jcfg, pcfg = _cfgs("slstm")
    _, pp = _params("slstm", jcfg)
    carry = tuple(torch.zeros(2, 64) for _ in range(4))
    carry, h = ssm._slstm_step(pp, torch.ones(2, 64), carry)
    assert h.shape == (2, 64) and all(c.shape == (2, 64) for c in carry)


@pytest.mark.parametrize("kind", ["hybrid", "xlstm"])
def test_decode_keeps_the_recurrent_state_in_its_buffers(kind):
    """The tiny ``hybrid`` (Mamba + attention) and ``xlstm`` (mLSTM +
    sLSTM) models: four decode steps against the reference's, every state
    buffer the one given, and every buffer advanced by each step (a step
    that dropped the recurrent state would leave it as it was)."""
    jcfg, pcfg = both(kind)
    jp, pp = weights(jcfg, pcfg)
    toks = np.random.default_rng(16).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    _, jc, _ = jax.jit(lambda p, t: jmodel.forward(
        p, jcfg, tokens=t, want_cache=True, cache_len=21))(
        jp, jnp.asarray(toks[:, :12]))
    _, pc, _ = model.forward(pp, pcfg, tokens=torch.from_numpy(toks[:, :12]),
                             want_cache=True, cache_len=21)
    bufs = layers_of(pc)
    assert len(bufs) == len(jax.tree_util.tree_leaves(jc))
    decode = jax.jit(lambda p, t, c, q: jmodel.decode_step(p, jcfg, t, c, q))
    for t in range(4):
        before = [b.clone() for b in bufs]
        pos = np.full((2,), 12 + t, np.int32)
        tok = toks[:, 12 + t:13 + t]
        want, jc = decode(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
        got, pc2 = model.decode_step(pp, pcfg, torch.from_numpy(tok), pc,
                                     torch.from_numpy(pos))
        assert pc2 is pc
        assert rel_err(want, got) <= F32_LOGITS, t
        for i, leaf in enumerate(layers_of(pc)):
            assert leaf is bufs[i]
            assert not torch.equal(leaf, before[i]), (t, i)
        want_state = {jax.tree_util.keystr(p): v for p, v in
                      jax.tree_util.tree_flatten_with_path(jc)[0]}
        for path, leaf in pytree.tree_flatten_with_path(pc)[0]:
            assert rel_err(want_state[pytree.keystr(path)], leaf) \
                <= F32_LOGITS, (t, pytree.keystr(path))


def layers_of(caches):
    """The stacked state buffers, in tree order."""
    return [leaf for _, leaf in pytree.tree_flatten_with_path(caches)[0]]
