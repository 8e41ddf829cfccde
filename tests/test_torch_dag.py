"""Chain DAGs in the port against the JAX package, on the CPU.

As ``tests/test_dag.py`` layers them: ``chain_dag()`` and its errors, the
refcounted slots (``_dag_slots``), ``ssr_dag_call`` (the hand-written
diamonds and every legal cut), uniforms, the cut search (``enumerate_cuts``,
``dag_cut_is_legal``, ``dag_model_cost``, ``dag_cache_key``, schedule JSON,
``autotune_dag`` → ``lookup_dag``), and the registry DAGs (``layernorm``,
``softmax_xent``, ``mlp_block``) fused, unfused and under every legal cut.
Pure-Python artifacts must be equal; values agree within the registry
``tol``.  The JAX side runs in Pallas interpret mode.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import autotune as jautotune
from repro.core import lowering as jlowering
from repro.core.compiler import chain_dag as jchain_dag
from repro.core.nest_analysis import LoopNest as JLoopNest
from repro.core.nest_analysis import MemRef as JMemRef
from repro.core.stream import Direction as JDirection
from repro.kernels import dag as jdag
from repro.kernels import registry as jregistry

import repro_torch
from repro_torch import interop
from repro_torch.core import autotune, hopper, lowering, resilience
from repro_torch.core.autotune import ScheduleCache
from repro_torch.core.compiler import ChainError, chain_dag
from repro_torch.core.lowering import DEFAULT_SCHEDULE, Schedule
from repro_torch.core.nest_analysis import LoopNest, MemRef
from repro_torch.core.ssr import KernelBody, LoweringError
from repro_torch.core.stream import Direction
from repro_torch.kernels import dag, registry

DAGS = ["layernorm", "softmax_xent", "mlp_block"]


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    resilience.reset()
    yield
    resilience.reset()
    repro_torch.set_default_device(prev)


def _nest(n, reads, writes, compute=1, ref=False):
    L, M, D = (JLoopNest, JMemRef, JDirection) if ref else \
        (LoopNest, MemRef, Direction)
    refs = tuple([M(r, D.READ, (1,)) for r in reads]
                 + [M(w, D.WRITE, (1,)) for w in writes])
    return L(bounds=(n,), refs=refs, compute_per_level=(compute,))


def diamond_nests(n, ref=False):
    """X → T; T → U; (T, U) → out — the canonical multi-consumer shape."""
    return (_nest(n, ("X",), ("T",), ref=ref),
            _nest(n, ("T",), ("U",), ref=ref),
            _nest(n, ("T", "U"), (), compute=2, ref=ref))


DIAMOND_BODIES = (lambda xb: 2.0 * xb, lambda tb: tb + 1.0,
                  lambda tb, ub: tb * ub)


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


def _exact(msg: str) -> str:
    return "^" + re.escape(msg) + "$"


# -- 1. chain_dag(): structure, accounting, errors -----------------------------


def _dag_tuple(d):
    return ([(e.name, e.producer_stage, e.consumer_stage, e.coeffs, e.offset,
              e.elems) for e in d.edges], d.intermediates, d.n_dag,
            d.n_unfused, d.eliminated_loads, d.eliminated_stores)


@pytest.mark.parametrize("shape", ["diamond", "line", "registry"])
def test_chain_dag_matches_the_reference(shape):
    n = 4096
    if shape == "diamond":
        ours, theirs = diamond_nests(n), diamond_nests(n, ref=True)
    elif shape == "line":
        ours = (_nest(n, ("X", "Y"), ("T",), 2), _nest(n, ("T",), ()))
        theirs = (_nest(n, ("X", "Y"), ("T",), 2, ref=True),
                  _nest(n, ("T",), (), ref=True))
    else:
        ours = dag._dag_nests(n, dag._MLP_STAGES)
        theirs = jdag._dag_nests(n, jdag._MLP_STAGES)
    for force in (False, True):
        assert _dag_tuple(chain_dag(ours, force=force)) == \
            _dag_tuple(jchain_dag(theirs, force=force))


def _error_cases(ref):
    n = 1024
    N = lambda *a, **k: _nest(*a, ref=ref, **k)  # noqa: E731
    return {
        "too_few": (N(64, ("X",), ("T",)),),
        "spaces": (N(1024, ("X",), ("T",)), N(2048, ("T",), ())),
        "duplicate_writer": (N(n, ("X",), ("T",)), N(n, ("Y",), ("T",)),
                             N(n, ("T",), ())),
        "read_before_write": (N(n, ("T",), ()), N(n, ("X",), ("T",))),
        "disconnected": (N(n, ("X",), ("T",)), N(n, ("Y",), ()),
                         N(n, ("T",), ())),
        "two_terminals": (N(n, ("X",), ("T",)), N(n, ("T",), ()),
                          N(n, ("T",), ())),
        "dead": (N(n, ("X",), ("T", "D")), N(n, ("T",), ())),
    }


@pytest.mark.parametrize("case", list(_error_cases(False)))
def test_chain_dag_errors_match_the_reference(case):
    with pytest.raises(Exception) as want:
        jchain_dag(_error_cases(True)[case])
    with pytest.raises(ChainError, match=_exact(str(want.value))):
        chain_dag(_error_cases(False)[case])


# -- 2. refcounted slots --------------------------------------------------------


@pytest.mark.parametrize("shape", ["diamond", "line4", "mlp"])
def test_dag_slots_match_the_reference(shape):
    n = 2048
    if shape == "diamond":
        ours, theirs = diamond_nests(n), diamond_nests(n, ref=True)
    elif shape == "line4":
        names = ("X", "T", "U", "V")
        ours = tuple(_nest(n, (a,), (b,) if b else ())
                     for a, b in zip(names, names[1:] + (None,)))
        theirs = tuple(_nest(n, (a,), (b,) if b else (), ref=True)
                       for a, b in zip(names, names[1:] + (None,)))
    else:
        ours = dag._dag_nests(n, dag._MLP_STAGES)
        theirs = jdag._dag_nests(n, jdag._MLP_STAGES)
    got = lowering._dag_slots(chain_dag(ours, force=True))
    want = jlowering._dag_slots(jchain_dag(theirs, force=True))
    assert got == want
    assert got[1] == {"diamond": 2, "line4": 1, "mlp": 2}[shape]


def test_two_intermediates_from_one_stage_rejected_like_the_reference():
    with pytest.raises(Exception) as want:
        jlowering._dag_slots(jchain_dag(
            (_nest(1024, ("X",), ("T", "U"), ref=True),
             _nest(1024, ("T", "U"), (), ref=True)), force=True))
    with pytest.raises(LoweringError, match=_exact(str(want.value))):
        lowering._dag_slots(chain_dag((_nest(1024, ("X",), ("T", "U")),
                                       _nest(1024, ("T", "U"), ())),
                                      force=True))


def test_stage_program_carries_sources_and_slots():
    n = 4096
    call = lowering.prepare_dag_call(diamond_nests(n), DIAMOND_BODIES,
                                     {"X": torch.ones(n)})
    prog = call.kernel.program
    assert prog.sources == ((("stream", 0),), (("stage", 0),),
                            (("stage", 0), ("stage", 1)))
    assert (prog.slots, prog.n_slots) == ((0, 1, None), 2)
    assert prog.block == (8, 128) and prog.mode == "map"


# -- 3. ssr_dag_call: values, cuts, uniforms ------------------------------------


def _ref_diamond_bodies():
    return (lambda xb: 2.0 * xb, lambda tb: tb + 1.0, lambda tb, ub: tb * ub)


@pytest.mark.parametrize("mode", ["map", "reduce"])
@pytest.mark.parametrize("n", [1024, 5000])
def test_diamond_matches_the_reference(n, mode):
    x = _vec(n, n)
    got = lowering.ssr_dag_call(diamond_nests(n), DIAMOND_BODIES,
                                {"X": torch.from_numpy(x)}, mode=mode)
    want = jlowering.ssr_dag_call(diamond_nests(n, ref=True),
                                  _ref_diamond_bodies(),
                                  {"X": jnp.asarray(x)}, mode=mode)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-3)


def test_every_legal_diamond_cut_matches_the_reference():
    n = 4096
    x = _vec(n, 1)
    nests, jnests = diamond_nests(n), diamond_nests(n, ref=True)
    d = lowering._dag_for(nests, None)
    ran = 0
    for cut in autotune.enumerate_cuts(d):
        if not autotune.dag_cut_is_legal(d, cut)[0]:
            continue
        got = lowering.ssr_dag_call(
            nests, DIAMOND_BODIES, {"X": torch.from_numpy(x)},
            schedule=dataclasses.replace(DEFAULT_SCHEDULE, cut_edges=cut))
        want = jlowering.ssr_dag_call(
            jnests, _ref_diamond_bodies(), {"X": jnp.asarray(x)},
            schedule=dataclasses.replace(jlowering.DEFAULT_SCHEDULE,
                                         cut_edges=cut))
        np.testing.assert_array_equal(_np(got), _np(want))
        ran += 1
    assert ran == 3


def test_linear_chain_via_dag_is_bit_identical_to_chain_call():
    n = 3000
    x, y = torch.from_numpy(_vec(n, 2)), torch.from_numpy(_vec(n, 3))
    nests = (_nest(n, ("X", "Y"), ("T",), 2), _nest(n, ("T",), ()))
    bodies = (lambda a, b: a - b, lambda t: torch.clamp(t, min=0.0))
    via_chain = lowering.ssr_chain_call(nests, bodies, {"X": x, "Y": y})
    via_dag = lowering.ssr_dag_call(nests, bodies, {"X": x, "Y": y})
    assert torch.equal(via_dag, via_chain)


def test_uniforms_are_whole_arrays_and_1d_gains_a_row():
    n = 2048
    x, w = _vec(n, 4), _vec(16, 5)
    seen = []

    def body(xb, wb):
        seen.append(tuple(wb.shape))
        return xb * wb.sum()

    got = lowering.ssr_call(_nest(n, ("X",), ()), body,
                            {"X": torch.from_numpy(x)}, mode="map",
                            uniforms={"W": torch.from_numpy(w)})
    assert seen and all(s == (1, 16) for s in seen)
    want = jlowering.ssr_call(_nest(n, ("X",), (), ref=True),
                              lambda xb, wb: xb * jnp.sum(wb),
                              {"X": jnp.asarray(x)}, mode="map",
                              uniforms={"W": jnp.asarray(w)})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    call = lowering.prepare_call(_nest(n, ("X",), ()), body,
                                 {"X": torch.from_numpy(x)}, mode="map",
                                 uniforms={"W": torch.from_numpy(w)})
    uni = call.kernel.geometry.ins[-1]
    assert uni.block == (1, 16) and all(c == (0, 0) for c in uni.coeffs)
    assert call.kernel.program.n_uniform == 1
    assert call.kernel.program.n_streams == 1


def _uniform_error_cases(ref):
    call, lib = (jlowering.ssr_call, jnp) if ref else \
        (lowering.ssr_call, torch)
    dcall = jlowering.ssr_dag_call if ref else lowering.ssr_dag_call
    arr = (lambda a: jnp.asarray(a)) if ref else torch.from_numpy
    x = arr(_vec(1024, 6))
    return {
        "scalar": (ValueError, lambda: call(
            _nest(1024, ("X",), (), ref=ref), lambda xb, s: xb * s,
            {"X": x}, mode="map",
            uniforms={"s": lib.tensor(2.0) if not ref else jnp.float32(2.0)})),
        "level_mapped": (LoweringError, lambda: call(
            _nest(1024, ("X", "Y"), ("T",), 2, ref=ref),
            lambda a, b, w: a - b, {"X": x, "Y": x},
            uniforms={"W": arr(_vec(128, 7)).reshape(1, -1)})),
        "clash": (ValueError, lambda: dcall(
            diamond_nests(1024, ref=ref),
            _ref_diamond_bodies() if ref else DIAMOND_BODIES, {"X": x},
            mode="map", uniforms={"X": arr(_vec(16, 8))})),
    }


@pytest.mark.parametrize("case", list(_uniform_error_cases(False)))
def test_uniform_errors_match_the_reference(case):
    with pytest.raises(Exception) as want:
        _uniform_error_cases(True)[case][1]()
    kind, run = _uniform_error_cases(False)[case]
    with pytest.raises(kind, match=_exact(str(want.value))):
        run()


@pytest.mark.parametrize("shape", ["stage", "final_map"])
def test_dag_stage_shape_errors_match_the_reference(shape):
    n = 2048
    x = _vec(n, 9)
    if shape == "stage":
        ours = (lambda xb: torch.sum(xb), lambda tb: tb + 1.0,
                lambda tb, ub: tb * ub)
        theirs = (lambda xb: jnp.sum(xb), lambda tb: tb + 1.0,
                  lambda tb, ub: tb * ub)
    else:
        ours = DIAMOND_BODIES[:2] + (lambda tb, ub: torch.sum(tb * ub),)
        theirs = _ref_diamond_bodies()[:2] + (lambda tb, ub: jnp.sum(tb * ub),)
    with pytest.raises(Exception) as want:
        jlowering.ssr_dag_call(diamond_nests(n, ref=True), theirs,
                               {"X": jnp.asarray(x)}, mode="map")
    with pytest.raises(LoweringError, match=_exact(str(want.value))):
        lowering.ssr_dag_call(diamond_nests(n), ours,
                              {"X": torch.from_numpy(x)}, mode="map")


def test_out_of_range_cut_rejected_like_the_reference():
    n = 1024
    x = _vec(n, 10)
    sched = dataclasses.replace(DEFAULT_SCHEDULE, cut_edges=(7,))
    with pytest.raises(Exception) as want:
        jlowering.ssr_dag_call(
            diamond_nests(n, ref=True), _ref_diamond_bodies(),
            {"X": jnp.asarray(x)},
            schedule=dataclasses.replace(jlowering.DEFAULT_SCHEDULE,
                                         cut_edges=(7,)))
    with pytest.raises(LoweringError, match=_exact(str(want.value))):
        lowering.ssr_dag_call(diamond_nests(n), DIAMOND_BODIES,
                              {"X": torch.from_numpy(x)}, schedule=sched)


# -- 4. schedules and the cut search --------------------------------------------


@pytest.mark.parametrize("kw", [dict(stream_depths=(4, 2), cut_edges=()),
                                dict(cut_edges=(0, 2)),
                                dict(buffer_depth=3), {}],
                         ids=["depths_empty_cut", "cut02", "deep", "default"])
def test_schedule_json_with_cut_edges_matches(kw):
    ours, theirs = Schedule(**kw), jlowering.Schedule(**kw)
    assert ours.to_json() == theirs.to_json()
    assert Schedule.from_json(theirs.to_json()) == ours
    assert jlowering.Schedule.from_json(ours.to_json()) == theirs
    assert Schedule.from_json(Schedule(cut_edges=()).to_json()).cut_edges == ()


def _case_dags(name, rows=37):
    ours = {c.name: c for c in dag.dag_cases()}[name]
    theirs = {c.name: c for c in jdag.dag_cases()}[name]
    args, kw = ours.example(np.random.default_rng(3), odd=True)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    spec, jspec = ours.spec(*args), theirs.spec(*jargs)
    return ours, theirs, args, jargs, spec, jspec


@pytest.mark.parametrize("name", DAGS + ["diamond"])
def test_cut_search_artifacts_equal_the_reference(name):
    if name == "diamond":
        nests, jnests = diamond_nests(1024), diamond_nests(1024, ref=True)
        operands = {"X": np.zeros(1024, np.float32)}
        juniforms = uniforms = {}
        mode = "map"
    else:
        _, _, _, _, spec, jspec = _case_dags(name)
        nests, _, operands, mode, uniforms = spec
        jnests, _, joperands, _, juniforms = jspec
    d, jd = lowering._dag_for(nests, None), jlowering._dag_for(jnests, None)
    cuts = autotune.enumerate_cuts(d)
    assert cuts == jautotune.enumerate_cuts(jd)
    assert cuts[0] == () and cuts[-1] == tuple(range(len(d.edges)))
    for cut in cuts + [(7,)]:
        assert autotune.dag_cut_is_legal(d, cut) == \
            jautotune.dag_cut_is_legal(jd, cut)
    for cut in cuts:
        assert autotune.dag_model_cost(d, cut) == \
            jautotune.dag_model_cost(jd, cut)
    legal = [c for c in cuts if autotune.dag_cut_is_legal(d, c)[0]]
    assert legal == [(), (0, 1), (0, 1, 2)]
    costs = [autotune.dag_model_cost(d, c) for c in legal]
    assert costs == sorted(costs)       # fused < split < full
    jops = {k: jnp.asarray(np.asarray(v)) for k, v in operands.items()}
    juni = {k: jnp.asarray(np.asarray(v)).reshape(1, -1)
            if np.asarray(v).ndim == 1 else jnp.asarray(np.asarray(v))
            for k, v in (juniforms or {}).items()}
    uni = {k: torch.as_tensor(np.asarray(v)).reshape(1, -1)
           if np.asarray(v).ndim == 1 else torch.as_tensor(np.asarray(v))
           for k, v in (uniforms or {}).items()}
    for m in (mode, "reduce"):
        assert autotune.dag_cache_key(nests, operands, mode=m,
                                      uniforms=uni, backend="cpu") == \
            jautotune.dag_cache_key(jnests, jops, mode=m, uniforms=juni,
                                    backend="cpu")
    assert autotune.dag_cache_key(nests, operands, mode=mode, uniforms=uni) \
        == autotune.dag_cache_key(nests, operands, mode=mode, uniforms=uni,
                                  backend="cpu")


def test_cache_key_separates_uniforms():
    nests = diamond_nests(1024)
    x, w = torch.ones(1024), torch.ones(1, 16)
    assert autotune.dag_cache_key(nests, {"X": x}) != \
        autotune.dag_cache_key(nests, {"X": x}, uniforms={"W": w})


@pytest.mark.parametrize("name", DAGS)
def test_every_component_of_every_legal_cut_has_a_kernel(name):
    """A CPU check of what the card needs: each component a legal cut can
    produce is an instantiation in ``hopper.DEVICE_KERNELS`` whose checks
    (everything but the card's shared memory) take its geometry."""
    _, _, _, _, spec, _ = _case_dags(name)
    nests, bodies, operands, mode, uniforms = spec
    d = lowering._dag_for(nests, None)
    shapes = tuple(tuple(u.shape) if u.dim() > 1 else (1, u.shape[0])
                   for u in uniforms.values())
    seen = set()
    for cut in autotune.enumerate_cuts(d):
        if not autotune.dag_cut_is_legal(d, cut)[0]:
            continue
        for comp in lowering.dag_components(d, nests, bodies, cut,
                                            mode=mode):
            kernel = lowering.component_kernel(
                comp, out_dtype=torch.float32, uniforms=shapes)
            assert kernel.device_key in hopper.DEVICE_KERNELS, comp.stages
            assert hopper.accepts(kernel.device_key, kernel.geometry,
                                  torch.float32, "cpu",
                                  program=kernel.program) == (True, "ok")
            seen.add(comp.stages)
    assert seen == {(0, 1, 2), (0,), (1, 2), (1,), (2,)}


def test_kernels_refuse_other_lane_widths_and_dtypes():
    _, _, _, _, spec, _ = _case_dags("layernorm")
    nests, bodies, operands, mode, _ = spec
    call = lowering.prepare_dag_call(nests, bodies, operands, mode=mode,
                                     schedule=Schedule(lanes=256))
    k = call.kernel
    ok, why = hopper.accepts(k.device_key, k.geometry, torch.float32, "cpu",
                             program=k.program)
    assert not ok and "rows of 128" in why
    call = lowering.prepare_dag_call(nests, bodies, operands, mode=mode)
    k = call.kernel
    ok, why = hopper.accepts(k.device_key, k.geometry, torch.bfloat16,
                             "cpu", program=k.program)
    assert not ok and "float32" in why
    # a body of another family, or a subset that is no instantiation
    swapped = (bodies[0], KernelBody(bodies[1].fn, "sx_exp"), bodies[2])
    bad = lowering.prepare_dag_call(nests, swapped, operands, mode=mode)
    ok, why = hopper.accepts(bad.kernel.device_key, bad.kernel.geometry,
                             torch.float32, "cpu",
                             program=bad.kernel.program)
    assert not ok and "no Hopper kernel" in why


def test_reordered_body_keeps_its_tag_and_permutation():
    _, _, _, _, spec, _ = _case_dags("layernorm")
    nests, bodies, _, mode, _ = spec
    d = lowering._dag_for(nests, None)
    comps = lowering.dag_components(d, nests, bodies, (0, 1), mode=mode)
    assert [c.stages for c in comps] == [(0,), (1, 2)]
    normalise = comps[1].bodies[1]
    assert isinstance(normalise, KernelBody)
    assert (normalise.op, normalise.perm) == ("ln_normalise", (1, 0))
    assert normalise.fn is bodies[2].fn
    assert comps[1].bodies[0] is bodies[1]         # order unchanged
    call = lowering.prepare_dag_call(comps[1].nests, comps[1].bodies,
                                     {"C": torch.ones(37 * 128)}, mode="map")
    assert call.kernel.program.canonical(1) == (("stream", 1), ("stage", 0))
    # an untagged body is adapted by a plain function: CPU only
    plain = lowering._reorder_body(lambda c, v: c * v, ["V", "C"],
                                   ["C", "V"], "stage")
    assert not isinstance(plain, KernelBody)


def test_autotune_dag_commits_and_lookup_resolves(tmp_path):
    n = 2048
    x = torch.from_numpy(_vec(n, 11))
    nests = diamond_nests(n)
    cache = ScheduleCache(path=str(tmp_path / "sched"))
    res = autotune.autotune_dag(nests, DIAMOND_BODIES, {"X": x}, mode="map",
                                cache=cache, warmup=0, iters=1, force=True)
    assert res.candidates == 3 and res.measured == 3
    assert [s.cut_edges for s, _ in res.timings] == [(), (0, 1), (0, 1, 2)]
    committed = cache.get(res.key)
    assert committed is not None and committed == res.schedule
    assert autotune.lookup_dag(nests, {"X": x}, mode="map",
                               cache=cache) == committed
    other = (_nest(n, ("X",), ("T",)), _nest(n, ("T",), ()))
    assert autotune.lookup_dag(other, {"X": x}, mode="map",
                               cache=cache) == DEFAULT_SCHEDULE
    hit = autotune.autotune_dag(nests, DIAMOND_BODIES, {"X": x}, mode="map",
                                cache=cache)
    assert hit.from_cache and hit.schedule == committed


def test_autotune_dag_holds_back_a_cut_within_the_spread():
    from repro_torch.core.autotune import _pick
    s = [Schedule(cut_edges=c) for c in ((), (0, 1), (0, 1, 2))]
    fast_noisy = [[1.0e-3, 1.3e-3], [0.9e-3, 1.0e-3], [2e-3, 2e-3]]
    assert _pick(s, fast_noisy, 0, on_card=True) == (s[0], 1000.0, 1000.0,
                                                     True)
    assert _pick(s, fast_noisy, 0, on_card=False)[0] == s[1]
    clear = [[1.0e-3, 1.01e-3], [0.5e-3, 0.51e-3], [2e-3, 2e-3]]
    assert _pick(s, clear, 0, on_card=True)[0] == s[1]


# -- 5. dispatch: the committed cut, freshness, the ladder -------------------------


def test_a_committed_cut_runs_one_kernel_per_component():
    case = {c.name: c for c in dag.dag_cases()}["layernorm"]
    (x,), _ = case.example(np.random.default_rng(5), odd=True)
    nests, bodies, operands, mode, _ = case.spec(x)
    autotune.global_cache().put(
        autotune.dag_cache_key(nests, operands, mode=mode),
        Schedule(cut_edges=(0, 1, 2)))
    lowering.clear_caches()
    lowering.reset_dispatch_stats()
    got = case.fused(x)
    assert lowering.DISPATCH_STATS["builds"] == 3
    np.testing.assert_allclose(_np(got), _np(case.ref(x)), **case.tol)
    lowering.reset_dispatch_stats()
    case.fused(x, schedule=Schedule(cut_edges=()))
    case.fused(x, schedule=DEFAULT_SCHEDULE)
    assert lowering.DISPATCH_STATS["builds"] == 1   # () is the same kernel


def test_dag_schedule_resolves_once_per_epoch(monkeypatch):
    n = 2048
    x = torch.ones(n)
    nests = diamond_nests(n)
    probes = []
    real = autotune.lookup_dag

    def spy(*a, **kw):
        probes.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(autotune, "lookup_dag", spy)
    for _ in range(3):
        lowering.ssr_dag_call(nests, DIAMOND_BODIES, {"X": x})
    assert len(probes) == 1
    autotune.global_cache().put(autotune.dag_cache_key(nests, {"X": x}),
                                Schedule(cut_edges=(0, 1)))
    lowering.ssr_dag_call(nests, DIAMOND_BODIES, {"X": x})
    assert len(probes) == 2


def test_a_failing_committed_cut_degrades_to_all_fused():
    case = {c.name: c for c in dag.dag_cases()}["softmax_xent"]
    args, _ = case.example(np.random.default_rng(6), odd=True)
    nests, bodies, operands, mode, _ = case.spec(*args)
    cache = autotune.global_cache()
    key = autotune.dag_cache_key(nests, operands, mode=mode)
    cache.put(key, Schedule(cut_edges=(0, 1, 2)))
    lowering.clear_caches()
    lowering.reset_dispatch_stats()
    resilience.reset_fallback_log()
    with resilience.inject_faults("compile") as specs:
        got = case.fused(*args)
    assert specs[0].fired == 1
    assert lowering.DISPATCH_STATS["degraded"] == 1
    assert [(e.site, e.from_schedule, e.to_schedule)
            for e in resilience.fallback_events()] == \
        [("ssr_dag_call", "tuned", "default")]
    assert cache.get(key) is None
    import os
    assert os.path.exists(os.path.join(cache.path, f"{key}.json.corrupt"))
    np.testing.assert_allclose(_np(got), _np(case.ref(*args)), **case.tol)
    assert autotune.quarantine_dag(nests, operands, mode=mode) == key


# -- 6. the registry DAGs against the reference ----------------------------------


@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("name", DAGS)
def test_fused_and_unfused_match_the_reference(name, odd):
    entry, jentry = registry.get(name), jregistry.get(name)
    args, kwargs = entry.example(np.random.default_rng(7), odd=odd)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    want = _np(jentry.ssr(*jargs, schedule=jlowering.DEFAULT_SCHEDULE))
    want_unfused = _np(jentry.baseline(*jargs))
    fused = _np(entry.ssr(*args))
    unfused = _np(entry.baseline(*args))
    assert fused.shape == want.shape
    for got in (fused, unfused):
        np.testing.assert_allclose(got, want, **entry.tol)
        np.testing.assert_allclose(got, want_unfused, **entry.tol)
        np.testing.assert_allclose(got, _np(jentry.ref(*jargs)), **entry.tol)
    np.testing.assert_allclose(fused, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cut", [(), (0, 1), (0, 1, 2)],
                         ids=["fused", "split", "full"])
@pytest.mark.parametrize("name", DAGS)
def test_every_legal_cut_matches_the_reference(name, cut):
    ours, theirs, args, jargs, _, _ = _case_dags(name)
    got = ours.fused(*args, schedule=Schedule(cut_edges=cut))
    want = theirs.fused(*jargs, schedule=jlowering.Schedule(cut_edges=cut))
    np.testing.assert_allclose(_np(got), _np(want), **ours.tol)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_registry_lists_the_dags_like_the_reference():
    for name in DAGS:
        e, je = registry.get(name), jregistry.get(name)
        assert (e.tol, e.problem) == (je.tol, je.problem)
        assert sorted(e.variants()) == sorted(je.variants())
    ours = {c.name: c for c in dag.dag_cases()}
    for case in jdag.dag_cases():
        args, _ = ours[case.name].example(np.random.default_rng(2))
        jargs = [jnp.asarray(a.numpy()) for a in args]
        assert ours[case.name].tol == case.tol
        assert ours[case.name].inters(*args) == case.inters(*jargs)


@pytest.mark.parametrize("name, stages", [("layernorm", 3),
                                          ("softmax_xent", 3),
                                          ("mlp_block", 3)])
def test_fused_builds_one_kernel_unfused_one_per_stage(name, stages):
    entry = registry.get(name)
    args, _ = entry.example(np.random.default_rng(8))
    lowering.clear_caches()
    lowering.reset_dispatch_stats()
    entry.ssr(*args, schedule=DEFAULT_SCHEDULE)
    assert lowering.DISPATCH_STATS["builds"] == 1
    lowering.reset_dispatch_stats()
    entry.baseline(*args)
    assert lowering.DISPATCH_STATS["builds"] == stages


def test_zero_padding_rows_stay_neutral_on_both_paths():
    """37 rows pad to 40: layernorm's zero rows give 0, softmax's mask
    zeroes them and the clamp keeps the unfused log finite."""
    cases = {c.name: c for c in dag.dag_cases()}
    z, p = cases["softmax_xent"].example(np.random.default_rng(9),
                                         odd=True)[0]
    assert z.shape[0] == 37
    for fn in (cases["softmax_xent"].fused, cases["softmax_xent"].unfused):
        got = fn(z, p)
        assert bool(torch.isfinite(got))
        np.testing.assert_allclose(float(got), float(
            cases["softmax_xent"].ref(z, p)), rtol=1e-5)
    nests, bodies, operands, mode, _ = cases["layernorm"].spec(z)
    call = lowering.prepare_dag_call(nests, bodies, operands, mode=mode)
    out = call.kernel(*call.layouts)
    assert out.shape[0] == 40 and torch.equal(out[37:], torch.zeros(3, 128))


# -- 7. state across the packages: DAG cache entries -------------------------------


def test_reference_dag_entries_read_by_the_port_and_back(tmp_path):
    _, _, _, _, spec, jspec = _case_dags("mlp_block")
    nests, _, operands, mode, uniforms = spec
    jnests, _, joperands, _, juniforms = jspec
    path = str(tmp_path / "shared")
    juni = {k: jnp.asarray(v).reshape(1, -1) if v.ndim == 1 else v
            for k, v in juniforms.items()}
    uni = {k: v.reshape(1, -1) if v.dim() == 1 else v
           for k, v in uniforms.items()}
    jkey = jautotune.dag_cache_key(jnests, joperands, mode=mode,
                                   uniforms=juni, backend="cpu")
    jautotune.ScheduleCache(path=path).put(
        jkey, jlowering.Schedule(cut_edges=(0, 1)), meta={"tuned_us": 2.0})
    cache = ScheduleCache(path=path)
    key = autotune.dag_cache_key(nests, operands, mode=mode, uniforms=uni,
                                 backend="cpu")
    assert key == jkey
    assert autotune.lookup_dag(nests, operands, mode=mode, uniforms=uni,
                               cache=cache) == Schedule(cut_edges=(0, 1))
    cache.put(key, Schedule(cut_edges=(0, 1, 2)), meta={"tuned_us": 1.0})
    jcache = jautotune.ScheduleCache(path=path)
    assert jautotune.lookup_dag(jnests, joperands, mode=mode,
                                uniforms=juni, cache=jcache) == \
        jlowering.Schedule(cut_edges=(0, 1, 2))
    card = "cuda:NVIDIA H100 80GB HBM3"
    dst = interop.rekey_schedule(jnests, joperands, from_backend="cpu",
                                 to_backend=card, mode=mode, uniforms=juni,
                                 cache=cache)
    assert dst == autotune.dag_cache_key(nests, operands, mode=mode,
                                         uniforms=uni, backend=card)
    assert cache.get(dst) == Schedule(cut_edges=(0, 1, 2))
    assert cache.meta(dst)["meta"]["rekeyed_from"]["backend"] == "cpu"
    assert interop.rekey_schedule(jnests, joperands, from_backend="tpu",
                                  to_backend=card, mode=mode, uniforms=juni,
                                  cache=cache) is None


def test_stream_block_bytes_of_every_lowering_match():
    _, _, _, _, spec, jspec = _case_dags("softmax_xent")
    nests, jnests = spec[0], jspec[0]
    for sched in ({}, dict(buffer_depth=3), dict(rows=16)):
        got = lowering.lower_chain(lowering._dag_for(nests, None),
                                   schedule=Schedule(**sched))
        want = jlowering.lower_chain(jlowering._dag_for(jnests, None),
                                     schedule=jlowering.Schedule(**sched))
        assert autotune.stream_block_bytes(got) == \
            jautotune._stream_block_bytes(want)
    from repro.core import compiler as jcompiler
    from repro_torch.core import compiler
    for fn, args in (("gemm_nest", (100, 130, 70)),
                     ("dot_product_nest", (5000,))):
        nest, jnest = getattr(compiler, fn)(*args), \
            getattr(jcompiler, fn)(*args)
        nested = fn == "gemm_nest"
        lanes = 3 if nested else 2
        got = lowering._lowered_for(lowering._plan_for(nest, lanes),
                                    DEFAULT_SCHEDULE, nested)
        want = jlowering._lowered_for(jlowering._plan_for(jnest, lanes),
                                      jlowering.DEFAULT_SCHEDULE, nested)
        assert autotune.stream_block_bytes(got) == \
            jautotune._stream_block_bytes(want)
