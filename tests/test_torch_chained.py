"""Stream chaining in the port against the JAX package, on the CPU.

Three layers, as ``tests/test_chained.py`` has them: ``chain()`` and its
errors, ``lower_chain()`` / ``ssr_chain_call()`` (geometry exact, values
within tolerance, every error message equal), and the fused registry
variants (``gemv_relu``, ``sum_sq_diff``, ``axpy_dot``) with their unfused
compositions.  The JAX side runs as its own tests run it (Pallas interpret
mode); the same inputs come from a numpy seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import autotune as jautotune
from repro.core import lowering as jlowering
from repro.core.compiler import chain as jchain
from repro.core.nest_analysis import LoopNest as JLoopNest
from repro.core.nest_analysis import MemRef as JMemRef
from repro.core.stream import Direction as JDirection
from repro.kernels import chained as jchained
from repro.kernels import registry as jregistry

import repro_torch
from repro_torch.core import agu, autotune, lowering
from repro_torch.core.compiler import ChainError, chain
from repro_torch.core.nest_analysis import LoopNest, MemRef
from repro_torch.core.ssr import KernelBody, LoweringError
from repro_torch.core.stream import Direction
from repro_torch.kernels import chained, ops, registry

CHAINED = ["gemv_relu", "stencil1d_relu", "sum_sq_diff", "axpy_dot"]


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _pair(ref: bool):
    return (JLoopNest, JMemRef, JDirection) if ref else \
        (LoopNest, MemRef, Direction)


def producer_nest(n, inter="T", ref=False, write=(1,)):
    L, M, D = _pair(ref)
    return L(bounds=(n,), refs=(M("X", D.READ, (1,)), M("Y", D.READ, (1,)),
                               M(inter, D.WRITE, write)),
             compute_per_level=(2,))


def consumer_nest(n, inter="T", ref=False, read=(1,), **kw):
    L, M, D = _pair(ref)
    return L(bounds=(n,), refs=(M(inter, D.READ, read, **kw),),
             compute_per_level=(1,))


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


# -- 1. chain(): the compiler, its accounting and its errors -------------------


def test_chain_accounting_matches_the_reference():
    for n in (3, 1024, 5000):
        for force in (False, True):
            got = chain((producer_nest(n), consumer_nest(n)), force=force)
            want = jchain((producer_nest(n, ref=True),
                           consumer_nest(n, ref=True)), force=force)
            assert (got.n_chain, got.n_unfused, got.eliminated_loads,
                    got.eliminated_stores, got.chain_speedup) == \
                (want.n_chain, want.n_unfused, want.eliminated_loads,
                 want.eliminated_stores, want.chain_speedup)
            assert [(l.name, l.producer_stage, l.coeffs, l.offset, l.elems)
                    for l in got.links] == \
                [(l.name, l.producer_stage, l.coeffs, l.offset, l.elems)
                 for l in want.links]


def _chain_error_cases(ref):
    L, M, D = _pair(ref)
    n = 1024
    two_writes = L(bounds=(n,), refs=(M("X", D.READ, (1,)),
                                      M("T", D.WRITE, (1,)),
                                      M("U", D.WRITE, (1,))),
                   compute_per_level=(1,))
    two_reads = L(bounds=(n,), refs=(M("T", D.READ, (1,)),
                                     M("U", D.READ, (1,))),
                  compute_per_level=(1,))
    gather = L(bounds=(n,), refs=(M("T", D.READ, None),),
               compute_per_level=(1,))
    return {
        "too_few": (producer_nest(8, ref=ref),),
        "spaces": (producer_nest(n, ref=ref), consumer_nest(2048, ref=ref)),
        "no_common": (producer_nest(n, "T", ref=ref),
                      consumer_nest(n, "U", ref=ref)),
        "two_common": (two_writes, two_reads),
        "non_affine": (producer_nest(n, ref=ref), gather),
        "walks": (producer_nest(n, ref=ref),
                  consumer_nest(n, ref=ref, offset=128)),
    }


@pytest.mark.parametrize("case", list(_chain_error_cases(False)))
def test_chain_errors_match_the_reference(case):
    with pytest.raises(Exception) as want:
        jchain(_chain_error_cases(True)[case])
    with pytest.raises(ChainError) as got:
        chain(_chain_error_cases(False)[case])
    assert type(want.value).__name__ == "ChainError"
    assert str(got.value) == str(want.value)


# -- 2. lower_chain(): geometry, exactly ---------------------------------------


def _three_stage(n, ref=False):
    L, M, D = _pair(ref)
    mid = L(bounds=(n,), refs=(M("T", D.READ, (1,)), M("U", D.WRITE, (1,))),
            compute_per_level=(1,))
    return (producer_nest(n, ref=ref), mid, consumer_nest(n, "U", ref=ref))


def _geometry(lowered, ref: bool):
    coeffs = (jlowering.agu if ref else agu).affine_coefficients
    out = {"grid": tuple(lowered.grid), "steps": lowered.steps,
           "policy": (lowered.policy.rows, lowered.policy.lanes),
           "stages": []}
    for stage in lowered.stage_in_streams:
        rows = []
        for s in stage:
            off, cs = coeffs(s.stream.index_map, lowered.grid)
            rows.append((s.name, tuple(s.stream.block_shape),
                         s.logical_shape, s.padded_last, s.offset,
                         np.asarray(off).tolist(),
                         [np.asarray(c).tolist() for c in cs]))
        out["stages"].append(rows)
    return out


@pytest.mark.parametrize("sched", [{}, {"rows": 16, "lanes": 256},
                                   {"buffer_depth": 3}],
                         ids=["default", "rows16_lanes256", "deep"])
@pytest.mark.parametrize("n", [1024, 5000, 8192])
def test_lower_chain_geometry_matches(n, sched):
    for build in (lambda r: (producer_nest(n, ref=r), consumer_nest(n, ref=r)),
                  lambda r: _three_stage(n, r)):
        got = lowering.lower_chain(
            chain(build(False), force=True),
            schedule=lowering.Schedule(**sched))
        want = jlowering.lower_chain(
            jchain(build(True), force=True),
            schedule=jlowering.Schedule(**sched))
        assert _geometry(got, False) == _geometry(want, True)
        assert autotune.stream_block_bytes(got) == \
            jautotune._stream_block_bytes(want)


def test_grid_matches_single_plan_grid():
    n = 8192
    lc = lowering.lower_chain(chain((producer_nest(n), consumer_nest(n)),
                                    force=True))
    single = lowering.lower_plan(lowering._plan_for(
        LoopNest(bounds=(n,), refs=(MemRef("X", Direction.READ, (1,)),),
                 compute_per_level=(1,)), 2))
    assert lc.grid == single.grid and lc.steps == single.steps


def _lowering_error_cases(ref):
    L, M, D = _pair(ref)
    n = 1024
    strided = (producer_nest(n, ref=ref, write=(2,)),
               consumer_nest(n, ref=ref, read=(2,)))
    extra = L(bounds=(n,), refs=(M("X", D.READ, (1,)), M("S", D.WRITE, (1,)),
                                 M("T", D.WRITE, (1,))),
              compute_per_level=(1,))
    cc = jchain if ref else chain
    return {
        "non_dense_link": lambda: cc(strided, force=True),
        "extra_write": lambda: cc((extra, consumer_nest(n, ref=ref)),
                                  force=True),
        "unallocated": lambda: cc((producer_nest(3, ref=ref),
                                   consumer_nest(3, ref=ref))),
    }


@pytest.mark.parametrize("case", list(_lowering_error_cases(False)))
def test_lower_chain_errors_match_the_reference(case):
    with pytest.raises(Exception) as want:
        jlowering.lower_chain(_lowering_error_cases(True)[case]())
    with pytest.raises(LoweringError) as got:
        lowering.lower_chain(_lowering_error_cases(False)[case]())
    assert str(got.value) == str(want.value)


# -- 3. ssr_chain_call: values and errors --------------------------------------


def _call_error_cases(ref):
    n = 2048
    x, y = _vec(n, 1), _vec(n, 2)
    if ref:
        xs, ys, lib = jnp.asarray(x), jnp.asarray(y), jnp
        call = jlowering.ssr_chain_call
    else:
        xs, ys, lib = torch.from_numpy(x), torch.from_numpy(y), torch
        call = lowering.ssr_chain_call
    nests = (producer_nest(n, ref=ref), consumer_nest(n, ref=ref))
    return {
        "bad_stage_shape": lambda: call(
            nests, (lambda a, b: lib.sum(a * b), lambda t: t),
            {"X": xs, "Y": ys}, mode="reduce"),
        "bad_final_map_shape": lambda: call(
            nests, (lambda a, b: a - b, lambda t: lib.sum(t)),
            {"X": xs, "Y": ys}, mode="map"),
        "body_count": lambda: call(nests, (lambda a, b: a - b,),
                                   {"X": xs, "Y": ys}),
        "missing_operand": lambda: call(nests, (lambda a, b: a - b,
                                                lambda t: t), {"X": xs}),
    }


@pytest.mark.parametrize("case", list(_call_error_cases(False)))
def test_ssr_chain_call_errors_match_the_reference(case):
    with pytest.raises(ValueError) as want:
        _call_error_cases(True)[case]()
    with pytest.raises(ValueError) as got:
        _call_error_cases(False)[case]()
    assert type(got.value).__name__ == type(want.value).__name__
    # the reference's shape is a tuple of ints in both packages' message
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [1024, 5000])
def test_fused_reduce_matches_the_reference(n):
    x, y = _vec(n, n), _vec(n, n + 1)
    got = lowering.ssr_chain_call(
        (producer_nest(n), consumer_nest(n)),
        (lambda a, b: (a - b) * (a - b), lambda t: t),
        {"X": torch.from_numpy(x), "Y": torch.from_numpy(y)}, mode="reduce")
    want = jlowering.ssr_chain_call(
        (producer_nest(n, ref=True), consumer_nest(n, ref=True)),
        (lambda a, b: (a - b) * (a - b), lambda t: t),
        {"X": jnp.asarray(x), "Y": jnp.asarray(y)}, mode="reduce")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n", [1024, 3000])
def test_fused_map_matches_the_reference(n):
    x, y = _vec(n, n), _vec(n, n + 1)
    got = lowering.ssr_chain_call(
        (producer_nest(n), consumer_nest(n)),
        (lambda a, b: a - b, lambda t: torch.clamp(t, min=0)),
        {"X": torch.from_numpy(x), "Y": torch.from_numpy(y)}, mode="map")
    want = jlowering.ssr_chain_call(
        (producer_nest(n, ref=True), consumer_nest(n, ref=True)),
        (lambda a, b: a - b, lambda t: jnp.maximum(t, 0)),
        {"X": jnp.asarray(x), "Y": jnp.asarray(y)}, mode="map")
    np.testing.assert_array_equal(_np(got), _np(want))


def test_vector_accumulator_matches_scalar_path():
    n = 5000
    x, y = torch.from_numpy(_vec(n, 1)), torch.from_numpy(_vec(n, 2))
    nest = LoopNest(bounds=(n,), refs=(MemRef("A", Direction.READ, (1,)),
                                       MemRef("B", Direction.READ, (1,))),
                    compute_per_level=(1,))
    vec = lowering.ssr_call(nest, lambda a, b: a * b, {"A": x, "B": y})
    scal = lowering.ssr_call(nest, lambda a, b: torch.sum(a * b),
                             {"A": x, "B": y})
    np.testing.assert_allclose(float(vec), float(scal), rtol=1e-4, atol=1e-3)


# -- 4. the fused registry variants ----------------------------------------------


def _jargs(args, kwargs):
    return [jnp.asarray(a.numpy()) for a in args], dict(kwargs)


@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("name", CHAINED)
def test_fused_and_unfused_match_the_reference(name, odd):
    entry = registry.get(name)
    jentry = jregistry.get(name)
    args, kwargs = entry.example(np.random.default_rng(7), odd=odd)
    jargs, jkw = _jargs(args, kwargs)
    want_fused = _np(jentry.ssr(*jargs, **jkw))
    want_unfused = _np(jentry.baseline(*jargs, **jkw))
    fused = _np(entry.ssr(*args, **kwargs))
    unfused = _np(entry.baseline(*args, **kwargs))
    assert fused.shape == want_fused.shape
    for got in (fused, unfused):
        np.testing.assert_allclose(got, want_fused, **entry.tol)
        np.testing.assert_allclose(got, want_unfused, **entry.tol)
        np.testing.assert_allclose(got, _np(jentry.ref(*jargs, **jkw)),
                                   **entry.tol)
    # tighter than the registry tol: the same f32 arithmetic in both
    np.testing.assert_allclose(fused, want_fused, rtol=1e-5, atol=1e-4)


def test_registry_lists_the_chains_like_the_reference():
    for name in CHAINED:
        e, je = registry.get(name), jregistry.get(name)
        assert (e.tol, e.problem) == (je.tol, je.problem)
        assert sorted(e.variants()) == sorted(je.variants())
        assert sorted(e.cluster_variants()) == sorted(je.cluster_variants())
        assert e.baseline is not None


def test_fused_case_table_matches_the_reference():
    ours = {c.name: c for c in chained.fused_cases()}
    theirs = {c.name: c for c in jchained.fused_cases()}
    assert set(ours) == set(theirs)
    for name, case in ours.items():
        args, kw = case.example(np.random.default_rng(1), odd=True)
        jargs, jkw = _jargs(args, kw)
        assert case.tol == theirs[name].tol
        assert (case.cluster is None) == (theirs[name].cluster is None)
        assert case.inter_type(*args, **kw) == \
            theirs[name].inter_type(*jargs, **jkw)


@pytest.mark.parametrize("name", CHAINED)
def test_ops_ssrcfg_switch_keeps_semantics(name):
    entry = registry.get(name)
    fn = getattr(ops, name)
    args, kwargs = entry.example(np.random.default_rng(3), odd=True)
    off = fn(*args, **kwargs)
    on = fn(*args, ssr=True, **kwargs)
    np.testing.assert_allclose(_np(on), _np(off), **entry.tol)
    np.testing.assert_allclose(_np(off), _np(entry.ref(*args, **kwargs)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name, fused_builds, unfused_builds",
                         [("gemv_relu", 1, 2), ("sum_sq_diff", 1, 2),
                          ("axpy_dot", 1, 2)])
def test_fused_builds_one_kernel_unfused_one_per_stage(name, fused_builds,
                                                      unfused_builds):
    entry = registry.get(name)
    args, kwargs = entry.example(np.random.default_rng(4))
    lowering.clear_caches()
    lowering.reset_dispatch_stats()
    entry.ssr(*args, **kwargs)
    assert lowering.DISPATCH_STATS["builds"] == fused_builds
    lowering.reset_dispatch_stats()
    entry.baseline(*args, **kwargs)
    assert lowering.DISPATCH_STATS["builds"] == unfused_builds


def test_fused_calls_name_their_device_kernels():
    """The chains' bodies are tagged: on the card the fused call is K5 and
    the unfused stages K5/K1, gemv_relu K4 with its relu drain."""
    n = 4096
    for nests, bodies, mode, ops_ in (
            (chained._chain_nests(n, False),
             (chained.SQ_DIFF, chained.IDENTITY), "reduce", ("X", "Y")),
            (chained._chain_nests(n, True),
             (chained.axpy_block(0.5), chained.DOT), "reduce",
             ("X", "Y", "W"))):
        call = lowering.prepare_chain_call(
            nests, bodies, {k: torch.ones(n) for k in ops_}, mode=mode)
        assert call.kernel.device_key == (mode, tuple(b.op for b in bodies))
        assert call.kernel.device_kernel().__name__ == "chain_elem"
        assert call.kernel.program.params == tuple(b.params for b in bodies)
    assert chained.MATVEC_RELU.op == "matvec_relu"
    call = lowering.prepare_call(
        chained._gemv_relu._nest((60, 64)), chained.MATVEC_RELU,
        {"A": torch.ones(60, 64), "x": torch.ones(64)})
    assert call.kernel.device_kernel().__name__ == "contract_gemv_relu"


def test_axpy_alpha_keys_the_kernel_cache():
    x = torch.from_numpy(_vec(3000, 5))
    lowering.clear_caches()
    lowering.reset_dispatch_stats()
    a = chained.fused_axpy_dot(x, x, x, alpha=0.5)
    chained.fused_axpy_dot(x, x, x, alpha=0.5)
    assert lowering.DISPATCH_STATS["builds"] == 1
    b = chained.fused_axpy_dot(x, x, x, alpha=2.0)
    assert lowering.DISPATCH_STATS["builds"] == 2
    assert float(a) != float(b)
    assert chained.axpy_block(0.5) == chained.axpy_block(0.5)
    assert chained.axpy_block(0.5) != chained.axpy_block(2.0)


def test_kernel_body_params_follow_the_blocks():
    body = KernelBody(lambda a, b, alpha: alpha * a + b, "axpy",
                      params=(3.0,))
    a, b = torch.ones(2), torch.full((2,), 2.0)
    assert torch.equal(body(a, b), torch.full((2,), 5.0))
    swapped = body.reordered((1, 0))
    assert (swapped.op, swapped.params, swapped.perm) == ("axpy", (3.0,),
                                                          (1, 0))
    assert torch.equal(swapped(b, a), torch.full((2,), 5.0))


def test_gemv_relu_drain_never_touches_a_partial():
    """relu applies to the drained sum, not to each k-tile's partial: a
    row whose partials change sign gives the relu of their sum."""
    m, n = 8, 1024            # two k tiles at the default 512-wide tile
    a = torch.zeros(m, n)
    a[:, :512] = 1.0
    a[:, 512:] = -1.0
    x = torch.ones(n)
    x[512:] = 0.5
    got = chained.fused_gemv_relu(a, x)
    assert torch.equal(got, torch.full((m,), 256.0))
    assert torch.equal(chained.fused_gemv_relu(-a, x), torch.zeros(m))


def test_chain_schedule_resolves_once_per_epoch(monkeypatch):
    """ssr_chain_call looks its schedule up under the stage-0 nest's key,
    once per problem and autotune.epoch() (the reference probes on every
    call); a commit starts a new epoch and is served on the next call."""
    n = 2048
    nests = chained._chain_nests(n, False)
    ops_ = {"X": torch.ones(n), "Y": torch.zeros(n)}
    bodies = (chained.SQ_DIFF, chained.IDENTITY)
    probes = []
    real = autotune.lookup

    def spy(*a, **kw):
        probes.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(autotune, "lookup", spy)
    for _ in range(3):
        assert float(lowering.ssr_chain_call(nests, bodies, ops_,
                                             mode="reduce")) == n
    assert probes == [nests[0]]
    tuned = lowering.Schedule(rows=16)
    autotune.global_cache().put(
        autotune.cache_key(nests[0], ops_, mode="reduce"), tuned)
    lowering.reset_dispatch_stats()
    assert float(lowering.ssr_chain_call(nests, bodies, ops_,
                                         mode="reduce")) == n
    assert len(probes) == 2 and lowering.DISPATCH_STATS["builds"] == 1
    assert lowering.prepare_chain_call(
        nests, bodies, ops_, mode="reduce",
        schedule=tuned).lowered.grid == (1,)
