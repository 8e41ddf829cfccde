"""The port's experts (``models/moe.py``) against the JAX package, on the CPU.

Capacity on a grid, the router's expert ids and the slots' positions in
their experts exactly equal, ``moe_apply``'s output and aux loss where
slots drop and where none can, the reference's permutation-equivariance
check, and the mesh refusal.  Inputs are made with numpy from a seed;
the reference runs under ``jax.jit``.  Limits are
``tests/test_torch_models.py``'s: ``F32_LAYER`` (1e-6 of the reference's
max |value|) in f32, ``BF16_LAYER`` (2**-8) in bf16.
"""

import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jax
import jax.numpy as jnp
from repro.models import config as jconfig
from repro.models import moe as jmoe

from repro_torch.models import config as pconfig
from repro_torch.models import layers, moe
from repro_torch.parallel import activations

from test_torch_models import (BF16_LAYER, F32_LAYER, F32_LOGITS, pt,
                               rel_err)


def _cfgs(factor=1.25, shared=1, dtype="float32", e=4, k=2):
    """The reference's tiny ``moe`` family (``tests/test_models.py``) at a
    capacity factor, in either package."""
    def one(cls):
        return cls.ModelConfig(
            name="moe", family="moe", d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=97, head_dim=16,
            groups=(cls.ScanGroup((("attn", "moe"),), 2),),
            moe=cls.MoEConfig(num_experts=e, top_k=k, d_expert=32,
                              num_shared=shared, capacity_factor=factor),
            param_dtype=dtype, compute_dtype=dtype, remat=False)
    return one(jconfig), one(pconfig)


def _params(cfg, seed=3, skew=0.0):
    """numpy MoE weights; ``skew`` is added to the router's first two
    columns, which then take most tokens of inputs shifted off zero mean."""
    rng = np.random.default_rng(seed)
    m, d = cfg.moe, cfg.d_model
    e, f = m.num_experts, m.d_expert
    router = rng.standard_normal((d, e)) / math.sqrt(d)
    router[:, :2] += skew
    p = {"router": router.astype(np.float32),
         "experts": {"w_gate": rng.standard_normal((e, d, f)) / math.sqrt(d),
                     "w_up": rng.standard_normal((e, d, f)) / math.sqrt(d),
                     "w_down": rng.standard_normal((e, f, d)) / math.sqrt(f)}}
    if m.num_shared:
        fs = f * m.num_shared
        p["shared"] = {"w_gate": rng.standard_normal((d, fs)) / math.sqrt(d),
                       "w_up": rng.standard_normal((d, fs)) / math.sqrt(d),
                       "w_down": rng.standard_normal((fs, d)) / math.sqrt(fs)}
    dt = jnp.dtype(cfg.param_dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, dt), p)
    jp["router"] = jnp.asarray(p["router"])          # f32 in any tree
    return jp, jax.tree.map(lambda a: pt(np.asarray(a)), jp)


def _x(shape, seed=4, shift=0.0, dtype=jnp.float32):
    x = np.random.default_rng(seed).standard_normal(shape) + shift
    jx = jnp.asarray(x.astype(np.float32), dtype)
    return jx, pt(np.asarray(jx))


@pytest.mark.parametrize("e, k", [(4, 2), (16, 2), (16, 4), (256, 8)])
def test_capacity_matches_reference_on_a_grid(e, k):
    for n, factor in itertools.product((1, 7, 8, 64, 760, 4096),
                                       (1.0, 1.25, 2.0, e / k)):
        jm = jconfig.MoEConfig(num_experts=e, top_k=k, d_expert=8,
                               capacity_factor=factor)
        pm = pconfig.MoEConfig(num_experts=e, top_k=k, d_expert=8,
                               capacity_factor=factor)
        assert moe.capacity(n, pm) == jmoe.capacity(n, jm), (n, factor)
        if factor == e / k:
            assert moe.capacity(n, pm) >= n     # ample: no slot can drop


@pytest.mark.parametrize("e, k", [(4, 2), (16, 4), (256, 8)])
def test_routing_and_positions_equal_the_references_exactly(e, k):
    jcfg, pcfg = _cfgs(e=e, k=k)
    jp, pp = _params(pcfg, skew=0.5)
    jx, px = _x((96, 64))
    jg, jids, jocc, jmp = jax.jit(lambda x, r: jmoe._route(
        x, r, jcfg.moe))(jx, jp["router"])
    pg, pids, pocc, pmp = moe._route(px, pp["router"], pcfg.moe)
    np.testing.assert_array_equal(np.asarray(jids), pids.numpy())
    # the routing is decided by margins far above f32 rounding: the
    # smallest gap between neighbouring probabilities of the top k + 1,
    # relative to the smaller, is ~80 f32 ulps (1e-5) or more
    probs = torch.softmax(px @ pp["router"], dim=-1)
    top = torch.topk(probs, k + 1, dim=-1).values
    margin = float(((top[:, :-1] - top[:, 1:]) / top[:, 1:]).min())
    print(f"smallest relative top-{k} margin: {margin:.3e}")
    assert margin > 1e-5
    # the gates are a softmax of logits up to |5| here: a logit summed in
    # another order moves by a few ulp of 5 (~5e-7), the gate by that
    # relatively, so F32_LOGITS (1e-5) rather than F32_LAYER
    for want, got in ((jg, pg), (jocc, pocc), (jmp, pmp)):
        assert rel_err(want, got) <= F32_LOGITS
    ids = np.asarray(jids).reshape(-1)
    want_pos = jax.jit(lambda i: jmoe._positions_in_expert(i, e))(
        jnp.asarray(ids))
    got_pos = moe._positions_in_expert(torch.tensor(ids).long(), e)
    np.testing.assert_array_equal(np.asarray(want_pos), got_pos.numpy())


@pytest.mark.parametrize("case", ["drops", "ample", "bf16", "no_shared"])
def test_moe_apply_matches_reference(case):
    """At factor 1.25 on a router skewed to two experts, slots drop (the
    test asserts some do, and that the port drops the reference's slots);
    at factor e / k none can."""
    factor = 2.0 if case == "ample" else 1.25
    dtype = "bfloat16" if case == "bf16" else "float32"
    jcfg, pcfg = _cfgs(factor=factor, dtype=dtype,
                       shared=0 if case == "no_shared" else 1)
    jp, pp = _params(pcfg, skew=0.0 if case == "ample" else 0.1)
    jx, px = _x((2, 16, 64), shift=1.0, dtype=jnp.dtype(dtype))
    want, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg))(jp, jx)
    got, paux = moe.moe_apply(pp, px, pcfg)
    assert got.dtype == px.dtype and got.shape == px.shape
    _, ids, _, _ = moe._route(px.reshape(32, 64), pp["router"], pcfg.moe)
    pos = moe._positions_in_expert(ids.reshape(-1), 4)
    dropped = int((pos >= moe.capacity(32, pcfg.moe)).sum())
    print(f"{case}: {dropped} of {pos.numel()} slots dropped")
    assert (dropped > 0) == (case != "ample")
    limit = BF16_LAYER if dtype == "bfloat16" else F32_LAYER
    assert rel_err(want, got) <= limit
    assert abs(float(jaux) - float(paux)) <= F32_LAYER * float(jaux)


def test_expert_permutation_equivariance():
    """Permuting expert weights (and router columns) leaves the output
    unchanged (``tests/test_models.py``'s check, on the port)."""
    _, pcfg = _cfgs(factor=2.0)
    _, pp = _params(pcfg)
    _, px = _x((1, 8, 64))
    y1, _ = moe.moe_apply(pp, px, pcfg)
    perm = torch.tensor([2, 0, 3, 1])
    p2 = {"router": pp["router"][:, perm],
          "experts": {k: w[perm] for k, w in pp["experts"].items()},
          "shared": pp["shared"]}
    y2, _ = moe.moe_apply(p2, px, pcfg)
    torch.testing.assert_close(y1, y2, rtol=2e-3, atol=2e-3)


def test_init_moe_is_the_references_tree():
    jcfg, pcfg = _cfgs(dtype="bfloat16")
    want = jax.eval_shape(lambda: jmoe.init_moe(jax.random.PRNGKey(0), jcfg))
    got = moe.init_moe(layers.Init.of(0, "meta"), pcfg)
    assert {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(want)[0]} == {
        pytree.keystr(p): (tuple(v.shape), str(v.dtype)[len("torch."):])
        for p, v in pytree.tree_flatten_with_path(got)[0]}
    assert got["router"].dtype == torch.float32


def test_a_mesh_raises_naming_the_multi_device_slice():
    """Under a one-rank mesh ``moe_apply`` is the plain dispatch, to the
    bit; a mesh with ``model`` > 1 dividing the experts selects expert
    parallelism (``tests/test_torch_moe_ep.py`` runs it), ``impl="xla"``
    never does."""
    from repro_torch.launch.mesh import Mesh

    _, pcfg = _cfgs()
    _, pp = _params(pcfg)
    _, px = _x((1, 4, 64))
    want, want_aux = moe.moe_apply(pp, px, pcfg)
    with activations.activation_mesh(Mesh((1, 1), ("data", "model"),
                                          rank=0)):
        y, aux = moe.moe_apply(pp, px, pcfg)
    assert torch.equal(y, want) and torch.equal(aux, want_aux)
    m = Mesh((2, 2), ("data", "model"))
    assert moe.dispatch_name(pcfg.moe, m, 8) == "ep2d"
    assert moe.dispatch_name(pcfg.moe, m, 8192) == "ep"
    cfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe,
                                                            impl="xla"))
    assert moe.dispatch_name(cfg.moe, m, 8) == "xla"
    y, _ = moe.moe_apply(pp, px, cfg)       # no mesh: the plain path
    assert y.shape == px.shape