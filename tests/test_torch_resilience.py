"""The port's resilience layer against the JAX package's, on the CPU.

The injector, the retry helper and the straggler watch mirror the
reference's cases (and one ``REPRO_FAULTS`` string arms both packages).
Then the degradation ladder: every seam × kind through a tuned
``ssr_call``; a ``compile`` fault under a tuned schedule degrades
``NestKernel`` and ``ssr_call`` to the default and quarantines the entry;
an explicit ``schedule=`` re-raises; ``dispatch(baseline_fallback=True)``
falls to ``ref`` on a typed error, while a kernel that fails to build
(``RuntimeError``) propagates through every rung.
"""

import itertools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import resilience as jresilience
from repro.runtime.fault import StragglerMonitor as JStragglerMonitor

import repro_torch
from repro_torch.core import (autotune, compiler, hopper, lowering,
                              resilience)
from repro_torch.core.autotune import ScheduleCache
from repro_torch.core.lowering import DEFAULT_SCHEDULE, Schedule, ssr_call
from repro_torch.core.resilience import (KINDS, SEAMS, FaultSpec,
                                         InjectedFault, inject_faults,
                                         parse_faults, retry)
from repro_torch.core.ssr import LoweringError, SsrKernel
from repro_torch.kernels import frontend, reduction, registry
from repro_torch.runtime.fault import StragglerMonitor

RNG = np.random.default_rng(29)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")
TUNED = Schedule(rows=16)          # a legal non-default geometry


def arr(n):
    return torch.from_numpy(RNG.standard_normal(n).astype(np.float32))


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    # a schedule cache of the test's own, no ambient faults, the CPU path
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "sch"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    resilience.reset()
    lowering.reset_dispatch_stats()
    frontend.reset_dispatch_stats()
    lowering.clear_caches()        # seams must fire, not hit stale kernels
    yield
    resilience.reset()
    repro_torch.set_default_device(prev)


@pytest.fixture
def tuned_env():
    return autotune.global_cache()


# -- the injector ---------------------------------------------------------------


def test_seams_and_kinds_are_the_reference_ones():
    assert SEAMS == jresilience.SEAMS and KINDS == jresilience.KINDS
    text = "cache.read, cache.write:oserror:2,compile"
    assert [(s.seam, s.kind, s.times) for s in parse_faults(text)] == \
        [(s.seam, s.kind, s.times) for s in jresilience.parse_faults(text)]
    assert resilience._ENV_FAULTS == jresilience._ENV_FAULTS == \
        "REPRO_FAULTS"


def test_parse_faults():
    specs = parse_faults("cache.read, cache.write:oserror:2,compile")
    assert [(s.seam, s.kind, s.times) for s in specs] == [
        ("cache.read", "fault", 1), ("cache.write", "oserror", 2),
        ("compile", "fault", 1)]


def test_parse_rejects_unknown_seam_and_kind():
    with pytest.raises(ValueError, match="unknown fault seam"):
        parse_faults("cache.reed")
    with pytest.raises(ValueError, match="unknown fault kind"):
        parse_faults("compile:tornado")
    with pytest.raises(ValueError, match="unknown fault seam"):
        resilience.arm("nope")


def test_context_manager_fires_then_exhausts():
    with inject_faults("compile") as specs:
        with pytest.raises(InjectedFault) as ei:
            resilience.inject("compile")
        assert ei.value.seam == "compile"
        resilience.inject("compile")      # times=1: now exhausted
        resilience.inject("cache.read")   # other seams untouched
    assert specs[0].fired == 1
    assert resilience.FAULT_STATS["injected"] == 1
    resilience.inject("compile")          # disarmed on exit


def test_oserror_kind_is_an_oserror():
    with inject_faults("cache.write", kind="oserror"):
        with pytest.raises(OSError):
            resilience.inject("cache.write")


def test_env_arming_and_consumption(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "lowering")
    resilience.reset_faults(reload_env=True)
    with pytest.raises(InjectedFault):
        resilience.inject("lowering")
    resilience.reset_faults()             # the variable is consumed
    resilience.inject("lowering")


def test_unlimited_times():
    spec = FaultSpec(seam="compile", times=-1)
    assert not spec.exhausted()
    spec.fired = 100
    assert not spec.exhausted()


def test_fallback_types_hold_no_kernel_error():
    types = resilience.fallback_error_types()
    assert set(types) == {InjectedFault, OSError, LoweringError}
    assert not issubclass(RuntimeError, types)
    assert issubclass(LoweringError, types)
    for e in (InjectedFault("compile", "fault"), LoweringError("x"),
              OSError("x")):
        assert resilience.classify(e) == jresilience.classify(e)
    assert resilience.classify(LoweringError("x")) == "lowering"


# -- retry ------------------------------------------------------------------------


def test_retry_absorbs_transient_then_succeeds():
    calls, slept, retried = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    got = retry(flaky, attempts=3, sleep=slept.append,
                on_retry=lambda a, e: retried.append(a))
    assert got == "ok" and len(calls) == 3
    assert retried == [1, 2] and len(slept) == 2


def test_retry_budget_exhausted_propagates_last_error():
    def always():
        raise OSError("persistent")

    with pytest.raises(OSError, match="persistent"):
        retry(always, attempts=3, sleep=lambda _: None)


def test_retry_non_retriable_propagates_immediately():
    calls = []

    def boom():
        calls.append(1)
        raise ValueError("user error")

    with pytest.raises(ValueError):
        retry(boom, attempts=5, sleep=lambda _: None)
    assert len(calls) == 1


def test_retry_backoff_is_bounded():
    slept = []

    def always():
        raise OSError("x")

    with pytest.raises(OSError):
        retry(always, attempts=4, base_delay=0.004, max_delay=0.01,
              sleep=slept.append)
    assert len(slept) == 3 and all(0 <= d <= 0.01 for d in slept)


# -- the ladder -----------------------------------------------------------------


def _setup_problem(cache):
    n = 2048
    x, y = arr(n), arr(n)
    nest = compiler.dot_product_nest(n)
    operands = {"A": x, "B": y}
    body = lambda a, b: a * b  # noqa: E731
    healthy = ssr_call(nest, body, operands)      # default-schedule result
    key = autotune.cache_key(nest, operands, mode="reduce",
                             out_dtype="float32")
    cache.put(key, TUNED)
    return nest, body, operands, key, healthy


@pytest.mark.parametrize("seam,kind", list(itertools.product(SEAMS, KINDS)))
def test_chaos_sweep_through_ssr_call(seam, kind, tuned_env):
    nest, body, operands, key, healthy = _setup_problem(tuned_env)
    resilience.reset_fallback_log()
    lowering.reset_dispatch_stats()
    with inject_faults(seam, kind=kind) as specs:
        got = ssr_call(nest, body, operands)
    np.testing.assert_allclose(float(got), float(healthy), rtol=1e-5)
    stats = lowering.DISPATCH_STATS
    events = resilience.fallback_events()
    if seam == "cache.read":
        # the lookup failed before any tuned kernel existed: default, and
        # the innocent entry stays
        assert specs[0].fired == 1
        assert stats["fallbacks"] == 1 and stats["degraded"] == 0
        assert [e.to_schedule for e in events] == ["default"]
        assert tuned_env.get(key) == TUNED
    elif seam in ("lowering", "compile"):
        assert specs[0].fired == 1
        assert stats["degraded"] == 1
        assert [(e.seam, e.site, e.key) for e in events] == \
            [(seam, "ssr_call", key)]
        assert tuned_env.get(key) is None
        assert os.path.exists(
            os.path.join(tuned_env.path, f"{key}.json.corrupt"))
        again = ssr_call(nest, body, operands)     # sticky: the default
        np.testing.assert_allclose(float(again), float(healthy), rtol=1e-5)
    else:   # cache.write / measure: no such seam on the dispatch path
        assert specs[0].fired == 0
        assert stats["fallbacks"] == 0 and stats["degraded"] == 0


def test_prepare_call_degrades_like_ssr_call(tuned_env):
    nest, body, operands, key, _ = _setup_problem(tuned_env)
    with inject_faults("compile") as specs:
        call = lowering.prepare_call(nest, body, operands)
    assert specs[0].fired == 1
    assert call.lowered.schedule == DEFAULT_SCHEDULE
    assert lowering.DISPATCH_STATS["degraded"] == 1
    assert tuned_env.get(key) is None


def test_explicit_schedule_error_propagates(tuned_env):
    n = 2048
    nest = compiler.dot_product_nest(n)
    operands = {"A": arr(n), "B": arr(n)}
    with inject_faults("lowering"):
        with pytest.raises(InjectedFault):
            ssr_call(nest, lambda a, b: a * b, operands, schedule=TUNED)
    assert lowering.DISPATCH_STATS["degraded"] == 0


def test_user_error_never_masked(tuned_env):
    n = 2048
    x, y = arr(n), arr(n)
    nest = compiler.dot_product_nest(n)
    key = autotune.cache_key(nest, {"A": x, "B": y}, mode="reduce",
                             out_dtype="float32")
    tuned_env.put(key, TUNED)
    with pytest.raises(ValueError, match="missing operands"):
        ssr_call(nest, lambda a, b: a * b, {"A": x})  # B missing
    assert tuned_env.get(key) == TUNED
    assert lowering.DISPATCH_STATS["degraded"] == 0


def _tune_reduction(cache, x, y):
    key = autotune.cache_key(compiler.dot_product_nest(x.shape[0]),
                             {"A": x, "B": y}, mode="reduce",
                             out_dtype="float32")
    cache.put(key, TUNED)
    return key


def test_nest_kernel_degrades_and_quarantines(tuned_env):
    n = 2048
    x, y = arr(n), arr(n)
    healthy = reduction.ssr_dot(x, y)
    key = _tune_reduction(tuned_env, x, y)
    frontend.reset_dispatch_stats()
    resilience.reset_fallback_log()
    with inject_faults("compile") as specs:
        got = reduction.ssr_dot(x, y)
    assert specs[0].fired == 1
    assert frontend.DISPATCH_STATS["degraded"] == 1
    assert tuned_env.get(key) is None
    events = resilience.fallback_events()
    assert [(e.site, e.from_schedule, e.to_schedule, e.key)
            for e in events] == [("nest_kernel:reduction", "tuned",
                                  "default", key)]
    np.testing.assert_allclose(float(got), float(healthy), rtol=1e-5)


def test_nest_kernel_explicit_schedule_reraises(tuned_env):
    n = 2048
    x, y = arr(n), arr(n)
    _tune_reduction(tuned_env, x, y)
    with inject_faults("compile"):
        with pytest.raises(InjectedFault):
            reduction.ssr_dot(x, y, schedule=TUNED)
    assert frontend.DISPATCH_STATS["degraded"] == 0


def test_nest_kernel_lookup_fault_falls_back(tuned_env):
    n = 1024
    x, y = arr(n), arr(n)
    key = _tune_reduction(tuned_env, x, y)
    with inject_faults("cache.read") as specs:
        reduction.ssr_dot(x, y)
    assert specs[0].fired == 1
    assert frontend.DISPATCH_STATS["fallbacks"] == 1
    assert tuned_env.get(key) == TUNED      # not quarantined


def test_default_schedule_failure_is_genuine(tuned_env):
    """With nothing tuned there is no rung below: the error propagates."""
    with inject_faults("compile"):
        with pytest.raises(InjectedFault):
            reduction.ssr_dot(arr(512), arr(512))
    assert frontend.DISPATCH_STATS["degraded"] == 0


def test_registry_baseline_fallback_opt_in(tuned_env):
    n = 2048
    x, y = arr(n), arr(n)
    want = registry.get("reduction").ref(x, y)
    resilience.reset_fallback_log()
    # unlimited compile faults: the streamed engine is down for good
    with inject_faults("compile", times=-1):
        with pytest.raises(InjectedFault):
            registry.dispatch("reduction", x, y, ssr=True)
        got = registry.dispatch("reduction", x, y, ssr=True,
                                baseline_fallback=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert [(e.site, e.to_schedule) for e in resilience.fallback_events()] \
        == [("registry:reduction", "baseline")]


def test_registry_baseline_fallback_env(tuned_env, monkeypatch):
    n = 1024
    x, y = arr(n), arr(n)
    monkeypatch.setenv("REPRO_BASELINE_FALLBACK", "1")
    with inject_faults("compile", times=-1):
        got = registry.dispatch("reduction", x, y, ssr=True)
    np.testing.assert_allclose(
        float(got), float(registry.get("reduction").ref(x, y)), rtol=1e-5)


def test_registry_fallback_rung_per_device():
    """The last rung is ``ref`` on the CPU; on the card it is the entry's
    baseline kernel, and an entry without a baseline has no rung there."""
    entry = registry.get("gemm")
    cuda = torch.device("cuda")
    assert registry.fallback_variant(entry, torch.device("cpu")) is entry.ref
    rung = registry.fallback_variant(entry, cuda)
    assert rung.func is entry.baseline and rung.keywords == {"device": cuda}
    bare = registry.KernelEntry(name="bare", ssr=entry.ssr, ref=entry.ref)
    assert registry.fallback_variant(bare, cuda) is None
    assert registry.fallback_variant(bare, torch.device("cpu")) is entry.ref


def test_a_kernel_build_failure_propagates_through_every_rung(
        tuned_env, monkeypatch):
    """A kernel that fails to build is a RuntimeError: no rung takes it —
    not the tuned → default ladder, not the opt-in baseline fallback."""
    n = 2048
    x, y = arr(n), arr(n)
    key = _tune_reduction(tuned_env, x, y)

    def broken(self, *layouts):
        raise RuntimeError("nvcc failed for reduce_mul")

    monkeypatch.setattr(SsrKernel, "__call__", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        registry.dispatch("reduction", x, y, ssr=True,
                          baseline_fallback=True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ssr_call(compiler.dot_product_nest(n), reduction.MUL,
                 {"A": x, "B": y})
    assert tuned_env.get(key) == TUNED
    assert frontend.DISPATCH_STATS["degraded"] == 0
    assert lowering.DISPATCH_STATS["degraded"] == 0
    assert resilience.fallback_events() == []


def test_a_kernel_build_oserror_is_not_cache_io(monkeypatch):
    """An OSError while building or loading a kernel (a read-only build
    directory, a truncated library) must not pass for cache I/O."""
    def denied(names):
        raise PermissionError("build/repro_torch: permission denied")

    monkeypatch.setattr(hopper, "build", denied)
    monkeypatch.setattr(hopper, "_LIBS", {})
    with pytest.raises(RuntimeError, match="cannot build or load") as ei:
        hopper._lib("reduce_mul")
    assert not isinstance(ei.value, resilience.fallback_error_types())


# -- the cache under faults --------------------------------------------------------


def test_write_retry_absorbs_transient_oserror(tmp_path):
    cache = ScheduleCache(path=str(tmp_path / "c"))
    with inject_faults("cache.write", kind="oserror", times=2) as specs:
        cache.put("k", TUNED)
    assert specs[0].fired == 2
    assert cache.stats["retries"] >= 2
    assert cache.get("k") == TUNED
    assert not [f for f in os.listdir(cache.path) if f.endswith(".tmp")]


def test_write_retry_budget_exhausted_raises(tmp_path):
    cache = ScheduleCache(path=str(tmp_path / "c"))
    with inject_faults("cache.write", kind="oserror", times=3):
        with pytest.raises(OSError):
            cache.put("k", TUNED)
    assert cache.get("k") is None


def test_write_hard_fault_not_retried(tmp_path):
    cache = ScheduleCache(path=str(tmp_path / "c"))
    with inject_faults("cache.write") as specs:
        with pytest.raises(InjectedFault):
            cache.put("k", TUNED)
    assert specs[0].fired == 1


def test_measure_fault_degrades_autotune_without_commit(tmp_path):
    n = 2048
    nest = compiler.dot_product_nest(n)
    operands = {"A": arr(n), "B": arr(n)}
    cache = ScheduleCache(path=str(tmp_path / "c"))
    with inject_faults("measure"):
        res = autotune.autotune(nest, lambda a, b: a * b, operands,
                                cache=cache, iters=1, warmup=0)
    assert res.degraded and not res.committed
    assert res.schedule == DEFAULT_SCHEDULE
    assert cache.keys() == []
    assert [e.site for e in resilience.fallback_events()] == ["autotune"]


def test_commit_fault_is_tolerated(tmp_path):
    n = 1024
    nest = compiler.dot_product_nest(n)
    cache = ScheduleCache(path=str(tmp_path / "c"))
    with inject_faults("cache.write"):
        res = autotune.autotune(nest, lambda a, b: a * b,
                                {"A": arr(n), "B": arr(n)}, cache=cache,
                                candidates=[DEFAULT_SCHEDULE], iters=1,
                                warmup=0)
    assert not res.committed and not res.degraded
    assert cache.keys() == []


def test_negative_cache_busted_by_another_process(tmp_path):
    path = str(tmp_path / "shared")
    local = ScheduleCache(path=path)
    key = "deadbeef01"
    assert local.get(key) is None
    assert local.get(key) is None          # from the miss cache
    e0 = autotune.epoch()
    code = textwrap.dedent("""
        import sys
        from repro_torch.core.autotune import ScheduleCache
        from repro_torch.core.lowering import Schedule
        ScheduleCache(path=sys.argv[1]).put(sys.argv[2], Schedule(rows=16))
    """)
    env = dict(os.environ, REPRO_SCHEDULE_CACHE=path,
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("REPRO_FAULTS", None)
    subprocess.run([sys.executable, "-c", code, path, key], check=True,
                   env=env, timeout=240)
    assert local.get(key) == Schedule(rows=16)
    assert local.stats["generation_busts"] >= 1
    assert autotune.epoch() > e0


# -- the straggler watch -----------------------------------------------------------


def test_straggler_monitor_flags_like_the_reference():
    rng = np.random.default_rng(3)
    times = list(0.002 + 1e-5 * rng.standard_normal(40))
    times[7] = times[23] = 0.05
    ours, theirs = StragglerMonitor(), JStragglerMonitor()
    got = [ours.observe(i, t) for i, t in enumerate(times)]
    want = [theirs.observe(i, t) for i, t in enumerate(times)]
    assert got == want and sum(got) >= 2
    assert ours.events == theirs.events
    assert ours.mean == pytest.approx(theirs.mean)


class _FakeClock:
    """perf_counter whose timed intervals pop planned durations."""

    def __init__(self, dts):
        self.dts, self.t, self.phase = list(dts), 0.0, 0

    def __call__(self):
        if self.phase == 0:
            self.phase = 1
            return self.t
        self.phase = 0
        self.t += self.dts.pop(0) if self.dts else 1e-3
        return self.t


def _race(monitor, tmp_path):
    n = 2048
    nest = compiler.dot_product_nest(n)
    operands = {"A": arr(n), "B": arr(n)}
    cands = [DEFAULT_SCHEDULE, TUNED]
    survivors = autotune.rank_candidates(nest, cands, top_k=2)
    # the default's sample is poisoned by a 1 s stall; the slower tuned
    # candidate times a clean 2 ms; a re-race of the stall reads 1 ms
    seq = []
    for s in survivors:
        seq.append(1.0 if s == DEFAULT_SCHEDULE else 0.002)
        if s == DEFAULT_SCHEDULE:
            seq.append(0.001)
    cache = ScheduleCache(path=str(tmp_path / "c"))
    res = autotune.autotune(
        nest, lambda a, b: a * b, operands, cache=cache, candidates=cands,
        top_k=2, warmup=0, iters=1, call=lambda sched: torch.zeros(()),
        clock=_FakeClock(seq), straggler=monitor)
    return res, cache, nest, operands


def test_straggler_flagged_and_reraced_not_committed(tmp_path):
    monitor = StragglerMonitor(warmup_steps=0, mean=0.002, var=1e-8, n=5)
    res, cache, nest, operands = _race(monitor, tmp_path)
    assert res.stragglers == 1
    assert res.schedule == DEFAULT_SCHEDULE
    assert autotune.lookup(nest, operands, cache=cache) == DEFAULT_SCHEDULE


def test_without_monitor_the_poisoned_race_lies(tmp_path):
    blind = StragglerMonitor(warmup_steps=0, mean=0.002, var=1e-8, n=5,
                             threshold_sigma=1e9)
    res, *_ = _race(blind, tmp_path)
    assert res.stragglers == 0
    assert res.schedule == TUNED
