"""Jamba's train step against the JAX package, on the CPU, and its aux
loss (reference fault C9).

The reference's ``group_full`` counts one MoE block's router loss a repeat
(the pattern's last), the port every block's: jamba's smoke pattern has
four MoE blocks, so the step is compared at ``router_aux_weight = 0``
(``tests/test_torch_train.py``'s state, limits and controls), and the aux
term's gradient is held apart, against the gradient of the reference's
blocks' aux losses summed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import blocks as jblocks
from repro.models import model as jmodel

from repro_torch import keypaths
from repro_torch.models import model

from test_torch_models import both, inputs, weights
from test_torch_train import check_step

#: the aux term's gradient, per leaf, relative to the leaf's largest |value|:
#: through each router it is a difference of softmax terms,
#: e·p_i·(f_i − Σ_j f_j·p_j)/N, which cancels, so its f32 noise reads up to
#: 1.4e-5 of a leaf's max (the loss's gradients: 1e-6)
AUX_GRAD = 1e-4


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    check_step("jamba_v01_52b", microbatches)


def test_jambas_aux_gradient_is_the_references_blocks_summed():
    """C9: the port's aux loss sums every MoE block's router loss.  Its
    gradient against the gradient of the reference's blocks' aux losses
    summed (each leaf within ``AUX_GRAD`` of that leaf's largest |value|);
    the control, the gradient of the aux the reference's ``forward``
    reports (the pattern's last MoE block's alone), reads above."""
    jcfg, pcfg = both("jamba_v01_52b")
    jp, pp = weights(jcfg, pcfg)
    jkw, pkw = inputs(jcfg, np.random.default_rng(10), 2, 16)

    def blocks_aux(p, kw):
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

    want = jax.jit(jax.grad(blocks_aux))(jp, jkw)
    ctrl = jax.jit(jax.grad(
        lambda p, kw: jmodel.forward(p, jcfg, **kw)[2]))(jp, jkw)
    leaves = keypaths.leaves(pp)
    alias = [p.detach().requires_grad_() for p in leaves]
    of = {id(p): a for p, a in zip(leaves, alias)}
    tree = keypaths.map_with_path(lambda _, p: of[id(p)], pp)
    _, _, aux = model.forward(tree, pcfg, **pkw)
    got = torch.autograd.grad(aux, alias, allow_unused=True)
    checked = 0
    for g, w, c in zip(got, jax.tree.leaves(want), jax.tree.leaves(ctrl)):
        w, c = np.asarray(w, np.float64), np.asarray(c, np.float64)
        g = np.zeros_like(w) if g is None else g.numpy().astype(np.float64)
        scale = np.abs(w).max()
        if scale == 0:
            assert not g.any()
            continue
        checked += 1
        assert np.abs(g - w).max() <= AUX_GRAD * scale
    assert checked >= 4                     # the four routers at least
    every = np.concatenate([np.asarray(x).ravel() for x in
                            jax.tree.leaves(want)])
    last = np.concatenate([np.asarray(x).ravel() for x in
                           jax.tree.leaves(ctrl)])
    assert np.abs(every - last).max() > AUX_GRAD * np.abs(every).max()
