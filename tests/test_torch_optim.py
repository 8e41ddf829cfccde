"""The port's optimiser (``optim/adamw.py``) and gradient compression
(``optim/compress.py``) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  Where
both compute one rounding of one f32 operation the results are compared to
the bit; where an XLA CPU fusion may contract a product into an FMA or its
``pow`` and ``cos`` round otherwise, within ``ULPS`` units in the last
place of the value (stated at each use).  The reference's own optimiser
tests (``tests/test_substrate.py``: ``TestAdamW``, ``TestCompression``) are
ported as cases below.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress

from repro_torch import interop, keypaths
from repro_torch.models import config as pconfig
from repro_torch.models import model
from repro_torch.optim import adamw, compress

#: a few units in the last place: XLA on the CPU may fuse m·b1 + g·(1−b1)
#: into one FMA (ROADMAP Queue C, C6), rounds pow and cos its own way, and
#: sums a leaf's squares in another order, so the global norm and with it
#: the clip scale differ by an ulp or two, which every clipped g carries
#: (twice in g², over three steps); the largest reading is 6
ULPS = 16


def as64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def ulps(want, got, bits: int) -> float:
    """max |got − want| in units in the last place (at ``bits`` of
    mantissa) of the largest |want|: a sum that cancels (m·b1 + g·(1−b1))
    is off by its operands' ulp, not its result's."""
    w, g = as64(want), as64(got)
    top = max(float(np.max(np.abs(w))), 1e-38) if w.size else 1.0
    ulp = 2.0 ** (math.floor(math.log2(top)) - bits)
    return float(np.max(np.abs(g - w))) / ulp if w.size else 0.0


def bits_of(dtype: str) -> int:
    return {"float32": 23, "bfloat16": 7}[dtype]


def tree(rng, dtype: str, scale: float = 1.0):
    """A tree whose dict keys are not in sorted order: 2-D and 3-D leaves
    (decayed), vectors (not), a nested dict and a list, numpy values."""
    def draw(*shape):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        return np.asarray(jnp.asarray(x, jnp.dtype(dtype)))
    return {"wq": draw(6, 8), "norm1": draw(8), "b": draw(3),
            "stack": {"w_up": draw(2, 4, 5), "norm": draw(1, 5)},
            "groups": [draw(4), draw(3, 3)]}


def to_port(t):
    return keypaths.map_with_path(
        lambda _, x: interop.to_tensor(x, "cpu"), t)


def to_ref(t):
    return jax.tree.map(jnp.asarray, t)


SCHEDULES = {"constant": lambda m: 2e-2,
             "warmup_cosine": lambda m: m.warmup_cosine(3e-2, 2, 6)}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_update_matches_reference_over_three_steps(param_dtype,
                                                   moment_dtype, clip,
                                                   schedule):
    """Three steps with the moments carried: params, m, v within ``ULPS``
    ulps of each leaf's largest value (at the storage dtype's precision),
    grad_norm and lr within ``ULPS`` f32 ulps, count to the bit.  The
    gradients' norm is about 8, so clipping engages where it is on."""
    rng = np.random.default_rng(0)
    kw = dict(clip_norm=clip, moment_dtype=moment_dtype,
              weight_decay=0.1)
    jcfg = jadamw.AdamWConfig(learning_rate=SCHEDULES[schedule](jadamw),
                              **kw)
    pcfg = adamw.AdamWConfig(learning_rate=SCHEDULES[schedule](adamw),
                             **kw)
    params = tree(rng, param_dtype)
    jp, pp = to_ref(params), to_port(params)
    js, ps = jadamw.init(jp, jcfg), adamw.init(pp, pcfg)
    step = jax.jit(lambda g, s, p: jadamw.update(g, s, p, jcfg))
    for k in range(3):
        grads = tree(rng, param_dtype, scale=1.5)
        jp, js, jm = step(to_ref(grads), js, jp)
        pp2, ps2, pm = adamw.update(to_port(grads), ps, pp, pcfg)
        assert pp2 is pp and ps2 is ps
        assert int(ps["count"]) == int(js["count"]) == k + 1
        assert ulps(jm["grad_norm"], pm["grad_norm"], 23) <= ULPS
        assert ulps(jm["lr"], pm["lr"], 23) <= ULPS
        assert pm["lr"].dtype == torch.float32
        for name, want, got, dt in (
                ("params", jp, pp, param_dtype),
                ("m", js["m"], ps["m"], moment_dtype),
                ("v", js["v"], ps["v"], moment_dtype)):
            for w, g in zip(jax.tree.leaves(want), keypaths.leaves(got)):
                assert str(g.dtype) == f"torch.{dt}"
                assert ulps(w, g, bits_of(dt)) <= ULPS, (name, k)


def test_update_is_bit_exact_where_no_fma_can_form():
    """With b1 = 0 and b2 = 0 the moments are g and g² (one rounding each,
    no sum to contract) and no decay: every value equals the reference's
    to the bit, which pins the order of the per-element operations."""
    rng = np.random.default_rng(1)
    kw = dict(b1=0.0, b2=0.0, weight_decay=0.0, clip_norm=None,
              learning_rate=0.5)
    jcfg, pcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    params, grads = tree(rng, "float32"), tree(rng, "float32")
    jp, js, _ = jadamw.update(to_ref(grads), jadamw.init(to_ref(params),
                                                         jcfg),
                              to_ref(params), jcfg)
    pp, ps, _ = adamw.update(to_port(grads), adamw.init(to_port(params),
                                                        pcfg),
                             to_port(params), pcfg)
    for w, g in zip(jax.tree.leaves((jp, js["m"], js["v"])),
                    keypaths.leaves((pp, ps["m"], ps["v"]))):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_global_norm_adds_the_leaves_in_sorted_key_order():
    """``jax.tree.leaves`` visits dict keys sorted; ``torch.utils._pytree``
    in insertion order.  Squares of eight leaves of 2**-24 and one of 1,
    summed in f32: sorted (a … h, then z) they give 1 + 2**-21; z first,
    each 2**-24 is a tie that rounds back to 1.  The port's norm is the
    reference's, √(1 + 2**-21), not the insertion order's 1."""
    t = {"z": np.ones(1, np.float32)}
    t.update({k: np.full(1, 2.0 ** -12, np.float32) for k in "abcdefgh"})
    want = float(np.asarray(jadamw.global_norm(to_ref(t))))
    got = float(adamw.global_norm(to_port(t)))
    assert got == want == float(np.sqrt(np.float32(1 + 2.0 ** -21)))
    from torch.utils import _pytree as pytree
    insertion = torch.sqrt(sum(torch.sum(torch.square(x)) for x in
                               pytree.tree_leaves(to_port(t))))
    assert float(insertion) == 1.0 != got


def test_decay_follows_the_references_ndim_rule_c11():
    """Reference fault C11: ``update`` decays a leaf when ``p.ndim >= 2``
    ("no decay on norms/biases"), but a block's norm weights are stacked
    on the repeats axis, so they are 2-D and decayed; only ``final_norm``
    is not.  The port keeps the rule so that updates stay comparable: with
    zero gradients, lr 0.5 and decay 1, a stacked norm shrinks by half in
    both packages and ``final_norm`` stays."""
    cfg = pconfig.ModelConfig(
        name="c11", family="dense", d_model=8, num_heads=2, num_kv_heads=2,
        d_ff=16, vocab_size=11,
        groups=(pconfig.ScanGroup((("attn", "mlp"),), 2),), remat=False)
    params = model.init_params(0, cfg, device="cpu")
    assert tuple(params["groups"][0][0]["norm1"].shape) == (2, 8)
    kw = dict(learning_rate=0.5, weight_decay=1.0, clip_norm=None)
    pcfg = adamw.AdamWConfig(**kw)
    zeros = keypaths.map_with_path(lambda _, p: torch.zeros_like(p), params)
    adamw.update(zeros, adamw.init(params, pcfg), params, pcfg)
    assert torch.equal(params["groups"][0][0]["norm1"],
                       torch.full((2, 8), 0.5))
    assert torch.equal(params["final_norm"], torch.ones(8))
    jcfg = jadamw.AdamWConfig(**kw)
    jp = {"norm1": jnp.ones((2, 8)), "final_norm": jnp.ones((8,))}
    jp2, _, _ = jadamw.update(jax.tree.map(jnp.zeros_like, jp),
                              jadamw.init(jp, jcfg), jp, jcfg)
    np.testing.assert_array_equal(np.asarray(jp2["norm1"]), 0.5)
    np.testing.assert_array_equal(np.asarray(jp2["final_norm"]), 1.0)


def test_update_writes_in_place_and_returns_the_trees_given():
    """The port's divergence (ROADMAP Queue C): the new params and moments
    are written into the tensors given, and those trees are returned."""
    rng = np.random.default_rng(2)
    pcfg = adamw.AdamWConfig(learning_rate=1e-2)
    pp = to_port(tree(rng, "float32"))
    ps = adamw.init(pp, pcfg)
    ids = [id(x) for x in keypaths.leaves((pp, ps))]
    before = [x.clone() for x in keypaths.leaves(pp)]
    p2, s2, _ = adamw.update(to_port(tree(rng, "float32")), ps, pp, pcfg)
    assert p2 is pp and s2 is ps
    assert [id(x) for x in keypaths.leaves((p2, s2))] == ids
    assert all(not torch.equal(a, b)
               for a, b in zip(before, keypaths.leaves(pp)))


def test_update_in_pieces_keeps_every_bit(monkeypatch):
    """A leaf is updated in pieces along its leading axis; the update is
    elementwise, so a piece of one row gives the whole leaf's bits."""
    rng = np.random.default_rng(3)
    pcfg = adamw.AdamWConfig(learning_rate=1e-2, moment_dtype="bfloat16")
    params, grads = tree(rng, "bfloat16"), tree(rng, "bfloat16")
    whole = to_port(params)
    adamw.update(to_port(grads), adamw.init(whole, pcfg), whole, pcfg)
    monkeypatch.setattr(adamw, "PIECE", 1)
    pieces = to_port(params)
    adamw.update(to_port(grads), adamw.init(pieces, pcfg), pieces, pcfg)
    for a, b in zip(keypaths.leaves(whole), keypaths.leaves(pieces)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 1, 2, 5, 9, 10, 11, 57, 109, 110, 200])
def test_warmup_cosine_matches_reference(step):
    """The schedule in f32: within ``ULPS`` f32 ulps of the reference's
    (its cosine is XLA's), to the bit during the warmup."""
    want = jadamw.warmup_cosine(3e-4, 10, 110)(jnp.asarray(step, jnp.int32))
    got = adamw.warmup_cosine(3e-4, 10, 110)(
        torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    if step < 10:
        assert float(got) == float(want)
    else:
        assert ulps(want, got, 23) <= ULPS


# -- the reference's TestAdamW (tests/test_substrate.py), on the port --------

def test_converges_on_quadratic():
    cfg = adamw.AdamWConfig(learning_rate=0.1, weight_decay=0.0,
                            clip_norm=None)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw.init(params, cfg)
    for _ in range(300):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        params, state, _ = adamw.update({"w": g}, state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_bf16_moments():
    cfg = adamw.AdamWConfig(moment_dtype="bfloat16")
    params = {"w": torch.ones(4, 4)}
    state = adamw.init(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    params, state, _ = adamw.update({"w": torch.ones(4, 4)}, state, params,
                                    cfg)
    assert state["v"]["w"].dtype == torch.bfloat16


def test_clip_norm():
    cfg = adamw.AdamWConfig(clip_norm=1.0, learning_rate=1.0,
                            weight_decay=0.0)
    params = {"w": torch.zeros(2)}
    state = adamw.init(params, cfg)
    p2, _, m = adamw.update({"w": torch.tensor([3e4, 4e4])}, state, params,
                            cfg)
    assert float(m["grad_norm"]) == pytest.approx(5e4, rel=1e-3)
    assert bool(torch.isfinite(p2["w"]).all())


def test_no_decay_on_1d():
    cfg = adamw.AdamWConfig(learning_rate=0.0, weight_decay=1.0)
    # lr = 0: params unchanged whatever the decay
    params = {"norm": torch.ones(4), "w": torch.ones(4, 4)}
    state = adamw.init(params, cfg)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, _, _ = adamw.update(grads, state, params, cfg)
    np.testing.assert_allclose(p2["norm"].numpy(), 1.0)


def test_warmup_cosine():
    sched = adamw.warmup_cosine(peak=1.0, warmup=10, total=110)
    assert float(sched(torch.tensor(0))) == 0.0
    assert float(sched(torch.tensor(10))) == pytest.approx(1.0)
    assert float(sched(torch.tensor(110))) == pytest.approx(0.1, abs=1e-3)


# -- compression --------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-5, 3e-3, 1.0, 7.0, 1e4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_is_the_references_bit_for_bit(scale, dtype):
    """q, scale, dequantize and one error-feedback step, to the bit; the
    inputs hold exact ties (x / scale = k + 0.5), which both round to
    even."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(256) * scale).astype(np.float32)
    x[0] = scale * 4                       # max |x|: scale = 4·scale / 127
    x[1:5] = np.float32(scale * 4 / 127) * np.float32([0.5, 1.5, 2.5, -0.5])
    x = np.asarray(jnp.asarray(x, jnp.dtype(dtype)))
    jq, js = jcompress.quantize(jnp.asarray(x))
    pq, ps = compress.quantize(interop.to_tensor(x, "cpu"))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jq), pq.numpy())
    assert float(js) == float(ps)
    np.testing.assert_array_equal(
        np.asarray(jcompress.dequantize(jq, js)),
        compress.dequantize(pq, ps).numpy())
    r = (rng.standard_normal(256) * scale * 0.01).astype(np.float32)
    want = jcompress.compress_leaf(jnp.asarray(x), jnp.asarray(r))
    got = compress.compress_leaf(interop.to_tensor(x, "cpu"),
                                 torch.from_numpy(r))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_quantize_rounds_half_to_even():
    q, s = compress.quantize(torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5]))
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0]


@pytest.mark.parametrize("scale", [1e-5, 2.2e-3, 0.7, 31.0, 1e4])
def test_quant_roundtrip_error_bounded(scale):
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(256)
                          * scale).astype(np.float32))
    q, s = compress.quantize(x)
    err = (compress.dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-9


def test_error_feedback_accumulates():
    g = torch.full((64,), 0.3e-2)
    residual = torch.zeros(64)
    total = torch.zeros(64)
    for _ in range(50):
        q, s, residual = compress.compress_leaf(g, residual)
        total = total + compress.dequantize(q, s)
    # with error feedback, the long-run mean equals the true gradient
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), rtol=0.05)


def test_init_residuals_are_f32_zeros_of_the_tree():
    t = to_port(tree(np.random.default_rng(5), "bfloat16"))
    r = compress.init_residuals(t)
    for g, z in zip(keypaths.leaves(t), keypaths.leaves(r)):
        assert z.dtype == torch.float32 and z.shape == g.shape
        assert not bool(z.any())


def test_compressed_psum_waits_for_the_multi_device_layer():
    """``compressed_psum`` over an axis of one rank equals the reference's
    over a one-device ``shard_map`` to the bit (the multi-rank cases:
    ``tests/test_torch_collectives.py``); without a mesh it refuses."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh as JMesh
    from jax.sharding import PartitionSpec as JP

    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.activations import activation_mesh

    rng = np.random.default_rng(11)
    grads = tree(rng, "float32", scale=0.3)
    resid = tree(rng, "float32", scale=1e-3)
    jmesh = JMesh(np.array(jax.devices()[:1]), ("pod",))
    want = shard_map(lambda g, r: jcompress.compressed_psum(g, r, "pod"),
                     mesh=jmesh, in_specs=(JP(), JP()),
                     out_specs=(JP(), JP()))(to_ref(grads), to_ref(resid))
    with activation_mesh(Mesh((1,), ("pod",), rank=0)):
        got = compress.compressed_psum(to_port(grads), to_port(resid),
                                       "pod")
    for w, g in zip(jax.tree.leaves(want), keypaths.leaves(got)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="needs a mesh"):
        compress.compressed_psum(to_port(grads), to_port(resid), "pod")
