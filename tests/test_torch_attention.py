"""The online-softmax accumulator: the port's attention against the JAX
package's, on the CPU.

Exact for what is pure Python: the rescale geometry of ``lower_nest``
(grid, tiles, padded bounds, streams, coefficients), the padded layouts,
the ``StreamReport`` bytes (m, l and acc as scratch), the lowering's
errors, and the autotuner's candidates, model costs and fingerprints on
``attention_nest``.  Within the registry ``tol`` for values, on inputs
drawn with numpy from a seed: a sweep of shapes and masks against the
reference's ``ssr_flash_attention`` in Pallas interpret mode, a head batch
against ``jax.vmap`` of it, bf16 inputs, and ``sk == 1`` against
``attention_ref`` (where the reference's lowering raises).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import autotune as jautotune
from repro.core import compiler as jcompiler
from repro.core import lowering as jlowering
from repro.kernels import attention as jattention
from repro.kernels import ref as jref
from repro.kernels import registry as jregistry

import repro_torch
from repro_torch.core import autotune, compiler, lowering, nest_analysis
from repro_torch.core.lowering import LoweringError, Schedule
from repro_torch.kernels import attention, frontend, ops, ref, registry

from test_torch_halo import (assert_same_geometry, assert_same_layouts,
                             assert_same_report)

TOL = registry.get("attention").tol          # rtol = atol = 2e-4

SHAPES = [(256, 256, 64), (100, 333, 80), (128, 256, 32), (1, 7, 4),
          (4096, 4096, 128)]
SCHEDULES = {
    "default": {},
    "rows16": dict(rows=16),
    "lanes_tile2": dict(lanes_tile_factor=2, rows_tile_factor=4),
}


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _lower_both(shape, kw):
    nest, jnest = (compiler.attention_nest(*shape),
                   jcompiler.attention_nest(*shape))
    lanes = nest_analysis.auto_lanes(nest, None)
    plan, jplan = (lowering._plan_for(nest, lanes),
                   jlowering._plan_for(jnest, lanes))
    return (lowering.lower_nest(plan, schedule=Schedule(**kw)),
            jlowering.lower_nest(jplan, schedule=jlowering.Schedule(**kw)))


def _qkv(sq, sk, d, seed, lead=()):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((*lead, s, d)).astype(np.float32)
                 for s in (sq, sk, sk))


# -- the rescale geometry ---------------------------------------------------------


@pytest.mark.parametrize("sched", SCHEDULES, ids=list(SCHEDULES))
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_rescale_geometry_matches_the_reference(shape, sched):
    lw, rw = _lower_both(shape, SCHEDULES[sched])
    assert lw.rescale and not lw.halos
    assert lw.semantics == ("parallel", "parallel", "arbitrary")
    assert_same_geometry(lw, rw)


@pytest.mark.parametrize("sched", SCHEDULES, ids=list(SCHEDULES))
@pytest.mark.parametrize("shape", SHAPES[:4], ids=[str(s) for s in SHAPES[:4]])
def test_rescale_layouts_match_the_reference(shape, sched):
    lw, rw = _lower_both(shape, SCHEDULES[sched])
    assert_same_layouts(lw, rw, seed=sum(shape))


@pytest.mark.parametrize("sched", SCHEDULES, ids=list(SCHEDULES))
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_rescale_report_bytes_match_the_reference(shape, sched):
    """m and l, (rows, 1) f32, and acc, (rows, lanes) f32, are the
    kernel's scratch, as the reference allocates them."""
    lw, rw = _lower_both(shape, SCHEDULES[sched])
    assert_same_report(lw, rw, lambda *b: b[0], lambda *b: b[0])
    kern = lowering._build_nest_kernel(lw, lambda *b: b[0], torch.float32)
    rows, lanes = lw.out_stream.stream.block_shape
    assert kern.scratch_bytes == 4 * (2 * rows + rows * lanes)
    assert kern.rescale and kern.plain_kind == "rescale"


def test_head_batch_layouts_are_each_head_laid_out():
    lw, _ = _lower_both((100, 333, 80), {})
    q, k, v = (torch.from_numpy(a) for a in _qkv(100, 333, 80, 1, lead=(3,)))
    batch = {"Q": q, "K": k, "V": v}
    got = lowering.stream_layouts(lw, [batch[s.name] for s in lw.in_streams],
                                  lead=(3,))
    for g, s in zip(got, lw.in_streams):
        assert tuple(g.shape) == (3, *s.layout_shape)
        for h in range(3):
            torch.testing.assert_close(g[h], s.prepare(batch[s.name][h]),
                                       rtol=0, atol=0)


@pytest.mark.parametrize("shape, kw, match", [
    ((64, 64, 64), dict(acc_dtype="float16"), "pins acc_dtype=float32"),
    ((64, 64, 640), dict(lanes=128, lanes_tile_factor=1),
     "served in one grid step"),
])
def test_rescale_errors_match_the_reference(shape, kw, match):
    with pytest.raises(LoweringError, match=match) as exc:
        _lower_both(shape, kw)
    nest = jcompiler.attention_nest(*shape)
    jplan = jlowering._plan_for(nest, nest_analysis.auto_lanes(
        compiler.attention_nest(*shape), None))
    with pytest.raises(jlowering.LoweringError) as jexc:
        jlowering.lower_nest(jplan, schedule=jlowering.Schedule(**kw))
    assert str(exc.value) == str(jexc.value)


def test_kv_level_of_bound_one_raises_as_the_reference():
    """The lowering keeps the reference's error for sk == 1 (a kv level of
    bound 1 is no contraction axis); ssr_flash_attention answers before
    lowering."""
    with pytest.raises(LoweringError) as exc:
        _lower_both((5, 1, 8), {})
    jplan = jlowering._plan_for(jcompiler.attention_nest(5, 1, 8), 4)
    with pytest.raises(jlowering.LoweringError) as jexc:
        jlowering.lower_nest(jplan)
    assert str(exc.value) == str(jexc.value)
    assert "exactly one contraction axis" in str(exc.value)


# -- values against the reference kernels ---------------------------------------


def _sweep(count, seed):
    """Seeded (sq ≤ sk, d, causal, window) draws, as the reference's
    property test draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        sq = int(rng.integers(1, 201))
        sk = sq + int(rng.integers(0, 201))
        d = int(rng.choice([4, 32, 64]))
        causal = bool(rng.integers(0, 2))
        window = [None, 7, 64][int(rng.integers(0, 3))]
        out.append((sq, sk, d, causal, window))
    return out


@pytest.mark.parametrize("case", _sweep(12, 2024),
                         ids=lambda c: "-".join(map(str, c)))
def test_sweep_matches_the_reference(case):
    sq, sk, d, causal, window = case
    q, k, v = _qkv(sq, sk, d, seed=sq * 1000 + sk)
    got = attention.ssr_flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window)
    want = np.asarray(jattention.ssr_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window,
        schedule=jlowering.DEFAULT_SCHEDULE))
    assert tuple(got.shape) == want.shape == (sq, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    oracle = ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", [(96, 160, 192, True, None),
                                  (64, 100, 192, False, 7),
                                  (96, 160, 256, True, 64),
                                  (130, 130, 256, False, None)],
                         ids=lambda c: "-".join(map(str, c)))
def test_wide_head_dims_match_the_reference(case):
    """D = 192 and 256 lower to a 256-lane tile (192 zero-padded), as K11's
    64-row tiles take them on the card."""
    sq, sk, d, causal, window = case
    q, k, v = _qkv(sq, sk, d, seed=sq + sk + d)
    got = attention.ssr_flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window)
    want = np.asarray(jattention.ssr_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window,
        schedule=jlowering.DEFAULT_SCHEDULE))
    assert tuple(got.shape) == want.shape == (sq, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # f32 sums over the keys in another order: a few ulp of |v| ≈ 4
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    lw, rw = _lower_both((sq, sk, d), {})
    assert_same_geometry(lw, rw)
    assert lw.in_streams[0].stream.block_shape[1] == 256


def test_schedule_invariance():
    """The m/l/acc recurrence does not depend on the kv tiling: any legal
    schedule agrees to float error (the reference's own test)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(192, 256, 64, 3))
    base = attention.ssr_flash_attention(q, k, v, causal=True)
    for sched in (Schedule(buffer_depth=3), Schedule(rows=16),
                  Schedule(lanes_tile_factor=2)):
        got = attention.ssr_flash_attention(q, k, v, causal=True,
                                            schedule=sched)
        assert float((got - base).abs().max()) <= 1e-6


def test_head_batch_matches_vmap_of_the_reference():
    q, k, v = _qkv(128, 128, 32, 4, lead=(4,))
    got = attention.ssr_flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    want = jax.vmap(lambda a, b, c: jattention.ssr_flash_attention(
        a, b, c, causal=True))(*(jnp.asarray(x) for x in (q, k, v)))
    assert tuple(got.shape) == (4, 128, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    heads = [attention.ssr_flash_attention(
        *(torch.from_numpy(a[h]) for a in (q, k, v)), causal=True)
        for h in range(4)]
    np.testing.assert_array_equal(got.numpy(), torch.stack(heads).numpy())


def test_head_batch_with_two_leading_dims_and_a_window():
    q, k, v = (torch.from_numpy(a) for a in _qkv(50, 90, 8, 5, lead=(2, 3)))
    got = ops.flash_attention(q, k, v, causal=True, window=7, ssr=True)
    assert tuple(got.shape) == (2, 3, 50, 8)
    want = ref.attention_ref(q, k, v, causal=True, window=7)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    off = ops.flash_attention(q, k, v, causal=True, window=7, ssr=False)
    np.testing.assert_allclose(got.numpy(), off.numpy(), **TOL)


def test_bf16_inputs_match_the_reference():
    q, k, v = _qkv(100, 160, 32, 6)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    # the same bf16 values on both sides
    np.testing.assert_array_equal(tq.float().numpy(),
                                  np.asarray(jq.astype(jnp.float32)))
    got = attention.ssr_flash_attention(tq, tk, tv, causal=True)
    want = jattention.ssr_flash_attention(jq, jk, jv, causal=True,
                                          schedule=jlowering.DEFAULT_SCHEDULE)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # both compute in f32 and round once to bf16: one bf16 ulp apart at most
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("sq, causal, window", [(1, True, None),
                                                (1, False, 4),
                                                (6, False, None)])
def test_one_key_returns_v0_as_the_oracle(sq, causal, window):
    q, k, v = _qkv(sq, 1, 16, 7)
    got = attention.ssr_flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window)
    want = np.asarray(jref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                         causal=causal, window=window))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(v[0], (sq, 16)))
    heads = attention.ssr_flash_attention(
        *(torch.from_numpy(np.stack([a, a])) for a in (q, k, v)))
    assert tuple(heads.shape) == (2, sq, 16)


def test_mask_parameters_key_the_kernel_cache():
    q, k, v = (torch.from_numpy(a) for a in _qkv(64, 64, 16, 8))
    lowering.clear_caches()
    lowering.reset_dispatch_stats()
    a = attention.ssr_flash_attention(q, k, v, causal=True, window=7)
    b = attention.ssr_flash_attention(q, k, v, causal=True, window=9)
    assert lowering.DISPATCH_STATS["builds"] == 2
    assert float((a - b).abs().max()) > 1e-3
    body = attention._body(attention._prepare(q, k, v, True, 7)[1])
    assert body.op == "attn_scores"
    assert body.params == (True, 7, 0.25, 0, 64, 16)


def test_refs_and_registry_match_the_reference():
    q, k, v = _qkv(40, 70, 16, 9)
    for kw in (dict(causal=True), dict(window=5), dict(causal=True,
                                                       window=9)):
        np.testing.assert_allclose(
            ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                              **kw).numpy(),
            np.asarray(jref.attention_ref(*(jnp.asarray(a)
                                            for a in (q, k, v)), **kw)),
            rtol=1e-5, atol=1e-6)
    e, je = registry.get("attention"), jregistry.get("attention")
    assert (e.tol, e.problem, e.baseline, je.baseline) == \
        (je.tol, je.problem, None, None)
    for odd in (False, True):
        args, kw = e.example(np.random.default_rng(3), odd=odd)
        jargs, jkw = je.example(np.random.default_rng(3), odd=odd)
        for a, ja in zip(args, jargs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        assert kw == jkw


# -- the autotuner on attention_nest --------------------------------------------


def _js(scheds):
    return [s.to_json() for s in scheds]


def _fp(fp):
    if isinstance(fp, tuple):
        return tuple(_fp(x) for x in fp)
    if hasattr(fp, "to_json"):
        return json.dumps(fp.to_json(), sort_keys=True)
    return fp


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("shape", [(256, 256, 64), (100, 333, 80)],
                         ids=["256", "100x333"])
def test_candidates_costs_and_legality_match_the_reference(shape, quick):
    nest, jnest = (compiler.attention_nest(*shape),
                   jcompiler.attention_nest(*shape))
    cands = autotune.candidate_schedules(nest, quick=quick)
    jcands = jautotune.candidate_schedules(jnest, quick=quick)
    assert _js(cands) == _js(jcands)
    jby = {json.dumps(s.to_json(), sort_keys=True): s for s in jcands}
    for s in cands:
        js = jby[json.dumps(s.to_json(), sort_keys=True)]
        assert autotune.model_cost(nest, s) == jautotune.model_cost(jnest, js)
        assert _fp(autotune.schedule_fingerprint(nest, s)) == \
            _fp(jautotune.schedule_fingerprint(jnest, js))
    assert _js(autotune.rank_candidates(nest, cands, top_k=4)) == \
        _js(jautotune.rank_candidates(jnest, jcands, top_k=4))
    for kw in (dict(acc_dtype="float16"), dict(lanes=256),
               dict(axis_order=(1, 0, 2)), dict(axis_order=(2, 0, 1))):
        assert autotune.schedule_is_legal(nest, Schedule(**kw)) == \
            jautotune.schedule_is_legal(jnest, jlowering.Schedule(**kw))


def test_eq_1_3_on_attention_nest():
    for shape in ((256, 256, 64), (4096, 4096, 128), (8192, 8192, 80)):
        plan = compiler.ssrify(compiler.attention_nest(*shape), num_lanes=4,
                               force=True)
        jplan = jcompiler.ssrify(jcompiler.attention_nest(*shape),
                                 num_lanes=4, force=True)
        assert (plan.n_base, plan.n_ssr, plan.speedup, plan.ssrified) == \
            (jplan.n_base, jplan.n_ssr, jplan.speedup, jplan.ssrified)


def test_frontend_counts_one_build_per_head_batch_signature():
    q, k, v = (torch.from_numpy(a) for a in _qkv(32, 32, 8, 10, lead=(2,)))
    frontend.reset_dispatch_stats()
    lowering.clear_caches()
    lowering.reset_dispatch_stats()
    for _ in range(2):
        attention.ssr_flash_attention(q, k, v, causal=True)
    assert lowering.DISPATCH_STATS["builds"] == 1


def test_head_batch_runs_the_committed_schedule():
    """A head batch resolves one head's tuned schedule, as the single-head
    call does, and runs it."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(64, 96, 16, 12, lead=(3,)))
    operands, static, _ = attention._prepare(q[0], k[0], v[0], True, None)
    key = autotune.cache_key(attention._nest(static), operands,
                             mode="reduce", out_dtype=torch.float32,
                             device="cpu")
    autotune.global_cache().put(key, Schedule(rows=16))
    lowering.clear_caches()
    assert attention._ssr.schedule_for(q[0], k[0], v[0], causal=True) == \
        Schedule(rows=16)
    got = attention.ssr_flash_attention(q, k, v, causal=True)
    assert [key_[1] for key_ in lowering._kernel_cache] == [Schedule(rows=16)]
    np.testing.assert_allclose(
        got.numpy(), ref.attention_ref(q, k, v, causal=True).numpy(), **TOL)
