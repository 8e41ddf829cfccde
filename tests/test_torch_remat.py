"""Recomputation in backward (``cfg.remat``) and the f32-output products'
gradient, on the CPU.

With ``remat`` the port wraps, as the reference's ``jax.checkpoint``s do,
each layer's body and ~√R outer chunks of a deep group
(``models/blocks.py``), flash's query tiles and KV tile steps
(``models/flash.py``), and the Mamba, mLSTM and sLSTM chunk bodies
(``models/ssm.py``) in ``torch.utils.checkpoint``.  Recomputing changes no
arithmetic and autograd walks the same graph, so the loss and every
gradient equal those without remat to the bit; and backward keeps less:
the bytes autograd saves (counted through
``torch.autograd.graph.saved_tensors_hooks``) plus the tensors the
checkpointed regions keep as their inputs, parameters left out.

``layers.F32Product`` is the card's f32-output product with a gradient;
on the CPU its forward is the upcast product, so its backward is held
against autograd through that product.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch import keypaths
from repro_torch.launch import steps
from repro_torch.models import flash, layers, ssm
from repro_torch.models import config as pconfig
from repro_torch.optim import adamw

from test_torch_models import tiny

OPT = adamw.AdamWConfig()


class SavedBytes:
    """Counts the bytes of the distinct storages that autograd saves, and
    those that the checkpointed regions take as inputs, beside the
    parameters' own."""

    def __init__(self, monkeypatch, exclude=()):
        self.seen = {t.untyped_storage().data_ptr() for t in exclude}
        self.bytes = 0
        self.regions = 0
        inner = layers.checkpoint

        def counted(fn, *args, **kw):
            self.regions += 1
            for a in keypaths.leaves(list(args)):
                if isinstance(a, torch.Tensor):
                    self.add(a)
            return inner(fn, *args, **kw)

        monkeypatch.setattr(layers, "checkpoint", counted)

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st.data_ptr() not in self.seen:
            self.seen.add(st.data_ptr())
            self.bytes += st.nbytes()

    def hooks(self):
        def pack(t):
            self.add(t)
            return t
        return torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)


def grads_and_bytes(cfg, params, batch, monkeypatch):
    """(loss, gradients in key order, saved bytes, checkpointed regions
    entered in forward) of ``loss_fn`` at ``params``."""
    from repro_torch.models import model

    leaves = keypaths.leaves(params)
    alias = [p.detach().requires_grad_() for p in leaves]
    of = {id(p): a for p, a in zip(leaves, alias)}
    count = SavedBytes(monkeypatch, exclude=leaves)
    with count.hooks():
        loss, _ = model.loss_fn(
            keypaths.map_with_path(lambda _, p: of[id(p)], params), cfg,
            batch)
    regions = count.regions
    grads = torch.autograd.grad(loss, alias, allow_unused=True)
    monkeypatch.undo()
    return loss.detach(), grads, count.bytes, regions


def both_ways(cfg, batch, monkeypatch, seed=0):
    params = steps.init_train_state(seed, cfg, OPT, device="cpu")["params"]
    out = {}
    for remat in (False, True):
        out[remat] = grads_and_bytes(dataclasses.replace(cfg, remat=remat),
                                     params, batch, monkeypatch)
    return out


def lm_batch(cfg, b=2, s=16, seed=3):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                        dtype=torch.int32)
    return {"tokens": tok, "labels": (tok * 5 + 1) % cfg.vocab_size}


def assert_same_bits(out):
    (l0, g0, b0, r0), (l1, g1, b1, r1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert r0 == 0 < r1
    assert b1 < b0, (b1, b0)
    return b0, b1, r1


def test_a_nine_layer_group_recomputes_in_three_chunks(monkeypatch):
    """9 layers: ``_layer_chunk`` gives 3, so forward enters 3 outer
    chunks and 9 layer bodies; the gradients are the plain walk's bits."""
    from repro_torch.models import blocks

    assert blocks._layer_chunk(9) == 3
    cfg = tiny(pconfig, "deep", groups=(pconfig.ScanGroup(
        (("attn", "mlp"),), 9),))
    b0, b1, regions = assert_same_bits(both_ways(cfg, lm_batch(cfg),
                                                 monkeypatch))
    assert regions == 3 + 9
    print(f"9 layers: {b0} bytes saved plain, {b1} with remat")


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_recurrent_chunks_recompute_to_the_bit(monkeypatch, mixer):
    """One layer of each recurrent mixer at S = 32 in chunks of 8 (the
    chunk patched from 256, so four chunks hold boundaries): the loss and
    the gradients equal the plain walk's to the bit, and the saved bytes
    are fewer."""
    monkeypatch.setattr(ssm, "SCAN_CHUNK", 8)
    kw = dict(mamba=pconfig.MambaConfig(d_state=4)) if mixer == "mamba" \
        else dict(xlstm=pconfig.XLSTMConfig(), num_kv_heads=4, d_ff=0)
    cfg = tiny(pconfig, mixer, groups=(pconfig.ScanGroup(
        ((mixer, "none"),), 1),), **kw)
    batch = lm_batch(cfg, s=32)
    out = {}
    for remat in (False, True):
        params = steps.init_train_state(0, cfg, OPT, device="cpu")["params"]
        monkeypatch.setattr(ssm, "SCAN_CHUNK", 8)
        out[remat] = grads_and_bytes(dataclasses.replace(cfg, remat=remat),
                                     params, batch, monkeypatch)
    b0, b1, regions = assert_same_bits(out)
    # the layer body, and four chunks in it
    assert regions == 1 + 4
    print(f"{mixer}: {b0} bytes saved plain, {b1} with remat")


def test_flash_recomputes_its_tiles_to_the_bit(monkeypatch):
    """flash_sdpa at 2048 positions: 4 query tiles of 512, each over 2 KV
    tiles of 1024 (causal, window 1536).  q, k, v's gradients equal the
    plain walk's to the bit; forward enters 4 query-tile regions and 8 KV
    steps; the saved bytes are fewer."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 2048, 4, 16, generator=g) for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    pos = torch.arange(2048)[None]
    out = {}
    for remat in (False, True):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        count = SavedBytes(monkeypatch, exclude=leaves)
        with count.hooks():
            o = flash.flash_sdpa(*leaves, q_pos=pos, k_pos=pos, causal=True,
                                 window=1536, scale=0.25, remat=remat)
            loss = torch.sum(o * o)
        regions = count.regions
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves),
                      count.bytes, regions)
        monkeypatch.undo()
    b0, b1, regions = assert_same_bits(out)
    assert regions == 4 + 4 * 2
    print(f"flash: {b0} bytes saved plain, {b1} with remat")


def test_without_autograd_nothing_is_recomputed(monkeypatch):
    """Serving (no autograd recording) walks the plain loop: no region is
    entered, and the logits are those of ``remat=False``."""
    from repro_torch.models import model

    cfg = tiny(pconfig, "deep", groups=(pconfig.ScanGroup(
        (("attn", "mlp"),), 9),), remat=True)
    params = steps.init_train_state(0, cfg, OPT, device="cpu")["params"]
    count = SavedBytes(monkeypatch)
    with torch.no_grad():
        got, _, _ = model.forward(params, cfg, tokens=lm_batch(cfg)["tokens"])
        want, _, _ = model.forward(
            params, dataclasses.replace(cfg, remat=False),
            tokens=lm_batch(cfg)["tokens"])
    assert count.regions == 0
    assert torch.equal(got, want)


# -- the f32-output products' gradient ----------------------------------------

def _operands(shape_a, shape_b, seed=6):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape_a).astype(np.float32)
    b = rng.standard_normal(shape_b).astype(np.float32)
    return (torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16())


@pytest.mark.parametrize("shapes", [((24, 64), (64, 40)),
                                    ((3, 24, 64), (3, 64, 40))])
def test_f32_product_backward_is_the_upcast_products(shapes):
    """``F32Product``'s gradient equals autograd's through the upcast
    product (f32 cotangent times the other operand in f32, cast to bf16),
    to the bit; the forward is that product's."""
    a, b = _operands(*shapes)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        shapes[0][:-1] + shapes[1][-1:]).astype(np.float32))
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = layers.F32Product.apply(a1, b1)
    assert out.dtype == torch.float32
    ga, gb = torch.autograd.grad(out, (a1, b1), g)
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    want = torch.matmul(a2.float(), b2.float())
    wa, wb = torch.autograd.grad(want, (a2, b2), g)
    assert torch.equal(out, want.detach())
    assert ga.dtype == gb.dtype == torch.bfloat16
    assert torch.equal(ga, wa) and torch.equal(gb, wb)


def test_f32_product_backward_is_the_references_gradient():
    """Against ``jax.grad`` of ``jnp.dot(x, w, preferred_element_type=
    f32)`` on bf16 operands (each cotangent product an f32 dot, then cast
    to bf16): within one bf16 ulp of the largest |gradient| (the f32 sums
    in another order may round the cast the other way), and most elements
    equal to the bit."""
    a, b = _operands((24, 64), (64, 40))
    g = np.random.default_rng(8).standard_normal((24, 40)).astype(
        np.float32)
    ja = jnp.asarray(a.float().numpy(), jnp.bfloat16)
    jb = jnp.asarray(b.float().numpy(), jnp.bfloat16)
    _, vjp = jax.vjp(lambda x, w: jnp.dot(
        x, w, preferred_element_type=jnp.float32), ja, jb)
    want = vjp(jnp.asarray(g))
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    got = torch.autograd.grad(layers.F32Product.apply(a1, b1), (a1, b1),
                              torch.from_numpy(g))
    for w, x in zip(want, got):
        w = np.asarray(w.astype(jnp.float32))
        x = x.float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert np.abs(w - x).max() <= ulp
        assert np.mean(w == x) > 0.95
