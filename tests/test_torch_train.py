"""The port's train step (``launch/steps.py``) against the JAX package, on
the CPU.

One step from one train state (``interop.train_state_from_reference``:
the weights of ``tests/test_torch_models.py``, moments carried, count 3) on
one batch made with numpy from a seed, in both packages: the loss, the
gradient norm, and every updated parameter and moment.  The moments are
drawn at each leaf's gradient scale (m ~ N(0, s²), v ~ s²·U[½, 3/2], s the
leaf's RMS gradient), so an update is a smooth function of the gradient:
from zero moments Adam's first update is g / (|g| + ε), whose sign flips
for any gradient within its rounding of 0.

Limits, per leaf, relative to the reference's largest |update| (params:
|p_new − p_old|) or largest |value| (m, v), plus two f32 ulps of the
leaf's largest |p| for the params (p − lr·u rounds at p's scale):

* ``F32_STEP`` = 1e-5: the f32 gradients, summed in other orders, read
  1e-7–1e-6 of their leaf's max on the dense, MoE, MLA and Mamba smoke
  configs, and the updates and moments 0.6–2.7e-6 of their scale;
* times the config's mLSTM layers, as ``test_torch_models.logits_limit``:
  the normaliser max(|den|, exp(−m)) amplifies a difference several times
  a layer, in backward as in forward.  xlstm-125m's smoke variant (5 mLSTM
  layers) reads up to 4.4e-4 on its first layers' gradients, but 4.4e-6
  on the updates and moments (its limit 5e-5);
* bf16 parameters and gradients (qwen3, danube), f32 moments:
  ``BF16_STEP`` = 2**-8 of the largest |update| beyond one bf16 ulp of
  each element's new value (a parameter near a rounding boundary rounds
  the other way), and of the moments' largest |value| (a bf16 gradient
  rounded the other way is 2**-8 of itself); they read 4e-4–9e-4.

Beside each check its control: the port's step from the same state on
another batch's gradients, which must read above the limit on every leaf
(in bf16: every first moment, and the parameters and second moments as a
whole: a norm's update is about one bf16 ulp of it, and a second moment
moves by 0.05·Δ(g²), so another batch need not move such a leaf by more).

The configs that accumulate microbatch gradients in bf16 (llama3-405b,
deepseek-v3) are compared at f32 accumulation: a bf16 rounding of a
gradient that lands the other way moves an element by 2**-8 of itself, a
limit that another batch does not clear on every leaf.  Their bf16
accumulator is held to the reference's formula on the port's own
gradients (``test_torch_train_families.py``).  The experts, the latent
attention and the recurrent mixers: ``test_torch_train_families.py``;
jamba and its aux loss (C9): ``test_torch_train_jamba.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.launch import steps as jsteps
from repro.optim import adamw as jadamw

from repro_torch import configs, interop, keypaths
from repro_torch.launch import steps
from repro_torch.models.config import ModelConfig, ScanGroup
from repro_torch.optim import adamw

from test_torch_models import BF16_LOGITS, DENSE, F32_LOGITS, both, inputs, weights

F32_STEP = 1e-5
BF16_STEP = 2.0 ** -8
LR = 1e-2


def mlstm_layers(cfg) -> int:
    return sum(g.repeats * sum(m == "mlstm" for m, _ in g.pattern)
               for g in cfg.groups)


def step_limit(cfg) -> float:
    return F32_STEP * max(1, mlstm_layers(cfg))


def batch(jcfg, seed, b=4, s=16):
    """numpy inputs and labels for both packages."""
    rng = np.random.default_rng(seed)
    jkw, pkw = inputs(jcfg, rng, b, s)
    labels = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    jkw["labels"] = jnp.asarray(labels)
    pkw["labels"] = torch.from_numpy(labels)
    return jkw, pkw


def no_aux(cfg):
    """``cfg`` with the router's aux loss weighted 0 (jamba: C9)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_aux_weight=0.0))


def train_state(jcfg, pcfg, jp, pkw, opt_kw, seed=5):
    """(reference state, port state, the two optimiser configs): the
    weights given, moments drawn at each leaf's gradient scale, count 3."""
    jopt = jadamw.AdamWConfig(**opt_kw)
    popt = adamw.AdamWConfig(**opt_kw)
    pp = interop.params_from_reference(jax.tree.map(np.asarray, jp), pcfg,
                                       device="cpu")
    _, g = steps._value_and_grad(pp, pcfg, pkw)
    rms = {keypaths.key(p): float(x.float().pow(2).mean().sqrt()) + 1e-12
           for p, x in keypaths.leaves_with_path(g)}
    rng = np.random.default_rng(seed)
    mdt = jnp.dtype(jopt.moment_dtype)

    def draw(kind):
        def one(path, leaf):
            s = rms[keypaths.key(tuple(getattr(k, "key", getattr(k, "idx", k))
                                       for k in path))]
            x = rng.standard_normal(leaf.shape) * s if kind == "m" else \
                rng.uniform(0.5, 1.5, leaf.shape) * s * s
            return np.asarray(jnp.asarray(x.astype(np.float32), mdt))
        return jax.tree_util.tree_map_with_path(one, jp)

    m, v = draw("m"), draw("v")
    count = np.asarray(3, np.int32)
    jstate = {"params": jp, "opt": {"m": jax.tree.map(jnp.asarray, m),
                                    "v": jax.tree.map(jnp.asarray, v),
                                    "count": jnp.asarray(count)}}
    pstate = interop.train_state_from_reference(
        {"params": jax.tree.map(np.asarray, jp),
         "opt": {"m": m, "v": v, "count": count}}, pcfg, popt, device="cpu")
    return jstate, pstate, jopt, popt


def leaf_errors(want, got, old, kind_limit, bf16_params=False):
    """{key: (err, limit scale)}: max |got − want| over the reference's
    largest |update| (params) or |value| (moments), and the ulp allowance
    of the params, each leaf."""
    out = {}
    for (path, g), w in zip(keypaths.leaves_with_path(got),
                            jax.tree.leaves(want)):
        k = keypaths.key(path)
        if k == "opt/count":                   # held to the bit apart
            continue
        w = np.asarray(jnp.asarray(w, jnp.float32), np.float64)
        g = g.float().numpy().astype(np.float64)
        if k.startswith("params"):
            o = old[k].float().numpy().astype(np.float64)
            scale = np.abs(w - o).max()
            top = max(float(np.abs(w).max()), 1e-30)
            if bf16_params:
                # one bf16 ulp of each element's new value
                ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w),
                                                          1e-30))) - 7)
                d = np.maximum(np.abs(g - w) - ulp, 0.0)
                allow = 0.0
            else:
                d = np.abs(g - w)
                allow = 2 * 2.0 ** (math.floor(math.log2(top)) - 23)
        else:
            scale = np.abs(w).max()
            d, allow = np.abs(g - w), 0.0
        if scale == 0:
            assert d.max() <= allow, k
            continue
        out[k] = (float(d.max()), scale * kind_limit + allow)
    return out


def run_step(kind, microbatches, dtype="float32"):
    jcfg, pcfg = (dataclasses.replace(no_aux(c), grad_accum_dtype="float32")
                  for c in both(kind))
    if dtype != "float32":
        jcfg, pcfg = (dataclasses.replace(c, param_dtype=dtype,
                                          compute_dtype=dtype)
                      for c in (jcfg, pcfg))
    jp, _ = weights(jcfg, pcfg)
    jkw, pkw = batch(jcfg, 7)
    opt_kw = dict(learning_rate=LR)
    js, ps, jopt, popt = train_state(jcfg, pcfg, jp, pkw, opt_kw)
    old = {keypaths.key(p): x.clone()
           for p, x in keypaths.leaves_with_path(ps)}
    state0 = {k: v.clone() for k, v in old.items()}
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt,
                                           microbatches=microbatches))
    jparams, jo, jm = jstep(js["params"], js["opt"], jkw)
    pstep = steps.make_train_step(pcfg, popt, microbatches=microbatches)
    pparams, po, pm = pstep(ps["params"], ps["opt"], pkw)
    assert pparams is ps["params"] and po is ps["opt"]
    got = {"params": pparams, "opt": po}
    want = {"params": jparams, "opt": jo}
    # the control: the same state, another batch
    cs = keypaths.map_with_path(lambda p, _: state0[keypaths.key(p)], ps)
    _, ckw = batch(jcfg, 8)
    cparams, co, _ = pstep(cs["params"], cs["opt"], ckw)
    return (jcfg, pcfg, jm, pm, want, got, {"params": cparams, "opt": co},
            old)


def check_step(kind, microbatches):
    """One step in both packages, every leaf within its limit and the
    control above it on every leaf."""
    jcfg, pcfg, jm, pm, want, got, ctrl, old = run_step(kind, microbatches)
    limit = step_limit(pcfg)
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= \
        F32_LOGITS * max(1, mlstm_layers(pcfg)) * abs(float(jm["loss"]))
    assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) <= \
        limit * float(jm["grad_norm"])
    assert float(pm["lr"]) == float(jm["lr"]) == float(np.float32(LR))
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 4
    errs = leaf_errors(want, got, old, limit)
    ctrls = leaf_errors(want, ctrl, old, limit)
    print(f"{kind} x{microbatches}: limit {limit:.3g}, worst leaf "
          f"{max(e / lim for e, lim in errs.values()):.3g} of it, the "
          f"control's least {min(e / lim for e, lim in ctrls.values()):.3g}")
    for k, (e, lim) in errs.items():
        assert e <= lim, (k, e, lim)
        assert ctrls[k][0] > lim, (k, ctrls[k], lim)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("kind", DENSE)
def test_train_step_matches_reference(kind, microbatches):
    check_step(kind, microbatches)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("kind", ["qwen3_14b", "h2o_danube_18b"])
def test_train_step_in_bf16_matches_reference(kind, microbatches):
    """bf16 parameters and gradients, f32 moments: ``BF16_STEP`` of the
    largest |update| beyond one bf16 ulp of each element (params), of the
    largest |value| (moments); loss within ``BF16_LOGITS``."""
    jcfg, pcfg, jm, pm, want, got, ctrl, old = run_step(
        kind, microbatches, "bfloat16")
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= \
        BF16_LOGITS * abs(float(jm["loss"]))
    assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) <= \
        BF16_STEP * float(jm["grad_norm"])
    errs = leaf_errors(want, got, old, BF16_STEP, bf16_params=True)
    ctrls = leaf_errors(want, ctrl, old, BF16_STEP, bf16_params=True)
    print(f"{kind} bf16 x{microbatches}: worst leaf "
          f"{max(e / lim for e, lim in errs.values()):.3g} of the limit")
    for k, (e, lim) in errs.items():
        assert e <= lim, (k, e, lim)
        if k.startswith("opt/m"):
            assert ctrls[k][0] > lim, (k, ctrls[k], lim)
    for part in ("params", "opt/v"):
        assert max(e / lim for k, (e, lim) in ctrls.items()
                   if k.startswith(part)) > 1, part


# -- the reference's TestTrainStep (tests/test_steps.py), on the port --------

TINY = ModelConfig(name="s", family="dense", d_model=32, num_heads=2,
                   num_kv_heads=2, d_ff=64, vocab_size=64,
                   groups=(ScanGroup((("attn", "mlp"),), 2),), remat=False)
OPT = adamw.AdamWConfig(learning_rate=1e-3)


def test_grad_accumulation_invariant():
    """microbatches=1 and =4 produce the same update (mean-of-means)."""
    from repro_torch.data import pipeline

    dcfg = pipeline.DataConfig(global_batch=8, seq_len=16)
    batch_ = pipeline.make_batch(TINY, dcfg, 0, device="cpu")
    s1 = steps.init_train_state(3, TINY, OPT, device="cpu")
    s4 = steps.init_train_state(3, TINY, OPT, device="cpu")
    p1, _, m1 = steps.make_train_step(TINY, OPT, microbatches=1)(
        s1["params"], s1["opt"], batch_)
    p4, _, m4 = steps.make_train_step(TINY, OPT, microbatches=4)(
        s4["params"], s4["opt"], batch_)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-5
    for a, b in zip(keypaths.leaves(p1), keypaths.leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=1e-5)


def test_abstract_state_matches_concrete():
    abstract = steps.abstract_train_state(TINY, OPT)
    concrete = steps.init_train_state(3, TINY, OPT, device="cpu")
    fa, fc = keypaths.leaves(abstract), keypaths.leaves(concrete)
    assert len(fa) == len(fc)
    assert all(a.device.type == "meta" for a in fa)
    for a, c in zip(fa, fc):
        assert a.shape == c.shape and a.dtype == c.dtype


@pytest.mark.parametrize("arch", ["h2o_danube_18b", "xlstm_125m",
                                  "deepseek_v3_671b"])
def test_abstract_state_is_the_references_shapes(arch):
    """The full configs' train state, as ``meta`` tensors: the reference's
    ``eval_shape`` leaves, path for path."""
    jcfg, pcfg = configs.get(arch), configs.get(arch)
    from repro import configs as jconfigs
    jcfg = jconfigs.get(arch)
    jopt = jadamw.AdamWConfig(moment_dtype=jcfg.optimizer_dtype)
    popt = adamw.AdamWConfig(moment_dtype=pcfg.optimizer_dtype)
    want = jax.tree_util.tree_flatten_with_path(
        jsteps.abstract_train_state(jcfg, jopt))[0]
    got = keypaths.leaves_with_path(steps.abstract_train_state(pcfg, popt))
    assert len(want) == len(got)
    for (jpath, j), (path, g) in zip(want, got):
        assert keypaths.key(path) == "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in jpath)
        assert tuple(g.shape) == tuple(j.shape)
        assert str(g.dtype) == f"torch.{j.dtype}"


def test_a_batch_that_does_not_split_is_refused():
    s = steps.init_train_state(0, TINY, OPT, device="cpu")
    b = {"tokens": torch.zeros(3, 8, dtype=torch.int32),
         "labels": torch.zeros(3, 8, dtype=torch.int32)}
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_train_step(TINY, OPT, microbatches=2)(
            s["params"], s["opt"], b)


def test_the_parameters_are_not_marked_for_autograd():
    """The step differentiates detached aliases: the caller's tensors
    never require grad and hold no ``.grad``."""
    s = steps.init_train_state(0, TINY, OPT, device="cpu")
    b = {"tokens": torch.zeros(2, 8, dtype=torch.int32),
         "labels": torch.ones(2, 8, dtype=torch.int32)}
    steps.make_train_step(TINY, OPT)(s["params"], s["opt"], b)
    for p in keypaths.leaves(s["params"]):
        assert not p.requires_grad and p.grad is None
