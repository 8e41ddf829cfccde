"""The port's schedule autotuner against the JAX package's, on the CPU.

The pure-Python half must match exactly for the four nests of this slice:
nest and operand signatures, cache keys for backend ``"cpu"``, the
candidate lists (quick and full), model costs, fingerprints and rankings.
Then the cache itself (put/get/invalidate/quarantine, the cross-instance
generation bust, corrupt, version-skewed and non-dict documents), the
measured race with an injected clock, and transparent dispatch: a
committed winner reaches ``NestKernel`` and a direct ``ssr_call``, and a
new commit rebuilds.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import autotune as jautotune
from repro.core import compiler as jcompiler
from repro.core.lowering import Schedule as JSchedule

import repro_torch
from repro_torch import interop
from repro_torch.core import autotune, compiler, hopper, lowering
from repro_torch.core.autotune import ScheduleCache
from repro_torch.core.lowering import DEFAULT_SCHEDULE, Schedule
from repro_torch.kernels import frontend, gemm, reduction

RNG = np.random.default_rng(31)

#: (port nest, reference nest, operands as numpy, mode, out dtype name)
NESTS = {
    "dot": (lambda: compiler.dot_product_nest(5000),
            lambda: jcompiler.dot_product_nest(5000),
            {"A": (5000,), "B": (5000,)}, "reduce"),
    "relu": (lambda: compiler.elementwise_nest(1025),
             lambda: jcompiler.elementwise_nest(1025), {"X": (1025,)},
             "map"),
    "gemm": (lambda: compiler.gemm_nest(100, 130, 70),
             lambda: jcompiler.gemm_nest(100, 130, 70),
             {"A": (100, 70), "B": (70, 130)}, "nest"),
    "gemm_large": (lambda: compiler.gemm_nest(512, 1024, 768),
                   lambda: jcompiler.gemm_nest(512, 1024, 768),
                   {"A": (512, 768), "B": (768, 1024)}, "nest"),
    "gemv": (lambda: compiler.gemv_nest(60, 64),
             lambda: jcompiler.gemv_nest(60, 64),
             {"A": (60, 64), "x": (64,)}, "nest"),
}


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


@pytest.fixture
def cache(tmp_path):
    return ScheduleCache(path=str(tmp_path / "sched"))


def _both(name):
    port, ref, shapes, mode = NESTS[name]
    arrays = {k: RNG.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    return (port(), ref(), {k: torch.from_numpy(v) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()}, mode)


def _js(scheds):
    return [s.to_json() for s in scheds]


def _fp(fp):
    """A fingerprint with any Schedule in it by its JSON form."""
    if isinstance(fp, tuple):
        return tuple(_fp(x) for x in fp)
    if hasattr(fp, "to_json"):
        return json.dumps(fp.to_json(), sort_keys=True)
    return fp


# -- exact parity -------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(NESTS))
def test_signatures_and_cache_key_match_the_reference(name):
    nest, jnest, ops, jops, mode = _both(name)
    assert autotune.nest_signature(nest) == jautotune.nest_signature(jnest)
    assert autotune.operand_signature(ops) == \
        jautotune.operand_signature(jops)
    for out_dtype in ("float32", torch.float32):
        assert autotune.cache_key(nest, ops, mode=mode, out_dtype=out_dtype,
                                  backend="cpu") == \
            jautotune.cache_key(jnest, jops, mode=mode, out_dtype="float32",
                                backend="cpu")
    bf = {k: v.to(torch.bfloat16) for k, v in ops.items()}
    jbf = {k: v.astype(jnp.bfloat16) for k, v in jops.items()}
    assert autotune.cache_key(nest, bf, mode=mode, out_dtype=torch.bfloat16,
                              backend="cpu") == \
        jautotune.cache_key(jnest, jbf, mode=mode, out_dtype="bfloat16",
                            backend="cpu")


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("name", sorted(NESTS))
def test_candidates_costs_and_ranking_match_the_reference(name, quick):
    nest, jnest, *_ = _both(name)
    cands = autotune.candidate_schedules(nest, quick=quick)
    jcands = jautotune.candidate_schedules(jnest, quick=quick)
    assert _js(cands) == _js(jcands)
    jby = {json.dumps(s.to_json(), sort_keys=True): s for s in jcands}
    for s in cands:
        js = jby[json.dumps(s.to_json(), sort_keys=True)]
        assert autotune.model_cost(nest, s) == jautotune.model_cost(jnest, js)
        assert _fp(autotune.schedule_fingerprint(nest, s)) == \
            _fp(jautotune.schedule_fingerprint(jnest, js))
    for top_k in (2, 8):
        assert _js(autotune.rank_candidates(nest, cands, top_k=top_k)) == \
            _js(jautotune.rank_candidates(jnest, jcands, top_k=top_k))


def test_backend_is_the_device_of_the_call():
    nest = compiler.dot_product_nest(2048)
    ops = {"A": torch.ones(2048), "B": torch.ones(2048)}
    assert autotune._backend("cpu") == "cpu"
    cpu = autotune.cache_key(nest, ops, backend="cpu")
    assert autotune.cache_key(nest, ops) == cpu       # tensors on the CPU
    assert autotune.cache_key(nest, ops, device="cpu") == cpu
    card = autotune.cache_key(nest, ops, backend="cuda:NVIDIA H100 80GB HBM3")
    assert card != cpu
    assert card != autotune.cache_key(nest, ops,
                                      backend="cuda:NVIDIA H200")


def test_dtype_names_are_numpy_names():
    assert autotune.dtype_name(torch.float32) == "float32"
    assert autotune.dtype_name(torch.bfloat16) == "bfloat16"
    assert autotune.dtype_name(np.dtype("int32")) == "int32"
    assert autotune.torch_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(TypeError, match="names no torch dtype"):
        autotune.torch_dtype("float128x")


# -- legality -----------------------------------------------------------------


def test_legality_keeps_the_reference_checks():
    nest = compiler.dot_product_nest(2048)
    assert autotune.schedule_is_legal(nest, DEFAULT_SCHEDULE) == (True, "ok")
    ok, why = autotune.schedule_is_legal(nest, Schedule(lanes=100))
    assert not ok and "lane" in why
    ok, why = autotune.schedule_is_legal(nest, Schedule(axis_order=(0,)))
    assert not ok and "lowering rejected" in why
    ok, why = autotune.schedule_is_legal(nest, Schedule(buffer_depth=9))
    assert not ok and "buffer_depth" in why
    ok, why = autotune.schedule_is_legal(compiler.gemm_nest(64, 64, 64),
                                         Schedule(axis_order=(2, 0, 1)))
    assert not ok and "lowering rejected" in why


def test_no_tpu_vmem_budget():
    """A deliberate divergence: the reference refuses this schedule for its
    64 MiB VMEM budget; on the card a block is a walk over device memory."""
    big = Schedule(rows=32768, lanes=1024)
    assert autotune.schedule_is_legal(compiler.dot_product_nest(1 << 26),
                                      big)[0]
    ok, why = jautotune.schedule_is_legal(jcompiler.dot_product_nest(1 << 26),
                                          JSchedule(rows=32768, lanes=1024))
    assert not ok and "VMEM" in why


def test_kernel_acceptance_filters_on_the_card(monkeypatch):
    """On a CUDA device legality asks the Hopper kernel (hopper.accepts);
    here the card's shared-memory probe is stubbed, the rest is real."""
    monkeypatch.setattr(hopper, "_smem_refusal",
                        lambda name, dev, *args: None)
    nest = compiler.gemm_nest(256, 256, 256)
    f32 = {"A": ((256, 256), "float32"), "B": ((256, 256), "float32")}
    f64 = {"A": ((256, 256), "float64"), "B": ((256, 256), "float64")}
    assert autotune.schedule_is_legal(nest, DEFAULT_SCHEDULE, body=gemm.DOT,
                                      operands=f32, device="cuda")[0]
    ok, why = autotune.schedule_is_legal(nest, DEFAULT_SCHEDULE,
                                         body=gemm.DOT, operands=f64,
                                         device="cuda")
    assert not ok and "kernel refuses" in why and "float64" in why
    ok, why = autotune.schedule_is_legal(nest, DEFAULT_SCHEDULE,
                                         body=lambda a, b: a @ b,
                                         operands=f32, device="cuda")
    assert not ok and "no Hopper kernel" in why
    # without a card, or without a body, nothing is asked of a kernel
    assert autotune.schedule_is_legal(nest, DEFAULT_SCHEDULE, body=gemm.DOT,
                                      operands=f64, device="cpu")[0]
    assert autotune.candidate_schedules(nest, quick=True, body=gemm.DOT,
                                        operands=f64, device="cuda") == []
    assert autotune.candidate_schedules(nest, quick=True, body=gemm.DOT,
                                        operands=f32, device="cuda") == \
        autotune.candidate_schedules(nest, quick=True)


def test_hopper_accepts_shares_the_wrapper_checks():
    call = lowering.prepare_call(compiler.gemm_nest(64, 64, 64), gemm.DOT,
                                 {"A": torch.ones(64, 64),
                                  "B": torch.ones(64, 64)}, device="cpu")
    geo = call.kernel.geometry
    assert hopper.accepts(("nest", "dot"), geo, torch.float32, "cpu") == \
        (True, "ok")
    ok, why = hopper.accepts(("nest", "dot"), geo, torch.float64, "cpu")
    assert not ok and "float64" in why
    ok, why = hopper.accepts(("nest", "matvec"), geo, torch.float32, "cpu")
    assert not ok and "compose" in why
    ok, why = hopper.accepts(("map", "sigmoid"), geo, torch.float32, "cpu")
    assert not ok and "no Hopper kernel" in why


# -- the cache ------------------------------------------------------------------


def test_put_get_roundtrip_and_meta(tmp_path):
    path = str(tmp_path / "sched")
    sched = Schedule(rows=16, lanes=256, axis_order=(1, 0, 2),
                     buffer_depth=3)
    ScheduleCache(path=path).put("k1", sched, meta={"tuned_us": 1.0})
    fresh = ScheduleCache(path=path)
    assert fresh.get("k1") == sched
    assert fresh.meta("k1")["meta"]["tuned_us"] == 1.0
    assert fresh.get("nope") is None
    assert fresh.stats["hits"] == 1 and fresh.stats["misses"] == 1


def test_invalidate_clear_and_keys(cache):
    cache.put("a", DEFAULT_SCHEDULE)
    cache.put("b", Schedule(rows=16))
    assert cache.keys() == ["a", "b"]
    assert cache.invalidate("a") and cache.get("a") is None
    assert not cache.invalidate("a")
    assert cache.clear() == 1 and cache.keys() == []


def test_quarantine_sidelines_the_entry(cache):
    cache.put("k", Schedule(rows=16))
    e0 = autotune.epoch()
    assert cache.quarantine("k")
    assert cache.get("k") is None
    assert os.path.exists(os.path.join(cache.path, "k.json.corrupt"))
    assert cache.stats["quarantined"] == 1 and autotune.epoch() > e0
    cache.put("k", Schedule(rows=32))
    assert cache.get("k") == Schedule(rows=32)


def test_generation_bust_across_instances(tmp_path):
    path = str(tmp_path / "shared")
    local, other = ScheduleCache(path=path), ScheduleCache(path=path)
    assert local.get("k") is None and local.get("k") is None   # negative
    e0 = autotune.epoch()
    other.put("k", Schedule(rows=16))
    assert local.get("k") == Schedule(rows=16)
    assert local.stats["generation_busts"] >= 1
    assert autotune.epoch() > e0


@pytest.mark.parametrize("payload", [
    "{not json", '{"version": 1, "sched', "", "6789", "[1, 2]", '"text"',
    json.dumps({"version": -1, "schedule": Schedule().to_json()}),
    json.dumps({"version": 1, "schedule": {"lanes": 128}}),
], ids=["garbage", "truncated", "empty", "int", "list", "string",
        "version-skew", "bad-schedule"])
def test_corrupt_documents_are_quarantined_misses(cache, payload):
    cache.put("good", Schedule(rows=16))
    with open(os.path.join(cache.path, "bad.json"), "w") as f:
        f.write(payload)
    assert cache.get("bad") is None                 # a miss, not a crash
    assert cache.stats["quarantined"] == 1
    assert os.path.exists(os.path.join(cache.path, "bad.json.corrupt"))
    assert cache.get("good") == Schedule(rows=16)   # neighbour untouched
    cache.put("bad", Schedule(rows=32))
    assert cache.get("bad") == Schedule(rows=32)


def test_meta_quarantines_a_non_dict_document(cache):
    os.makedirs(cache.path, exist_ok=True)
    with open(os.path.join(cache.path, "k.json"), "w") as f:
        f.write("6789")
    assert cache.meta("k") is None
    assert cache.stats["quarantined"] == 1


# -- the state crosses between the packages -----------------------------------


def test_reference_documents_read_by_the_port(tmp_path):
    nest, jnest, ops, jops, mode = _both("gemm")
    path = str(tmp_path / "shared")
    key = jautotune.cache_key(jnest, jops, mode=mode, backend="cpu")
    jautotune.ScheduleCache(path=path).put(
        key, JSchedule(rows=16, lanes=256, axis_order=(1, 0, 2)),
        meta={"tuned_us": 2.5})
    cache = ScheduleCache(path=path)
    assert autotune.cache_key(nest, ops, mode=mode, backend="cpu") == key
    assert autotune.lookup(nest, ops, mode=mode, cache=cache,
                           device="cpu") == \
        Schedule(rows=16, lanes=256, axis_order=(1, 0, 2))
    assert cache.meta(key)["meta"]["tuned_us"] == 2.5


def test_port_documents_read_by_the_reference(tmp_path):
    nest, jnest, ops, jops, mode = _both("dot")
    path = str(tmp_path / "shared")
    key = autotune.cache_key(nest, ops, mode=mode, backend="cpu")
    ScheduleCache(path=path).put(key, Schedule(rows=16, buffer_depth=3),
                                 meta={"tuned_us": 1.0})
    jcache = jautotune.ScheduleCache(path=path)
    assert jautotune.lookup(jnest, jops, mode=mode, cache=jcache) == \
        JSchedule(rows=16, buffer_depth=3)
    assert jcache.meta(key)["meta"]["tuned_us"] == 1.0


def test_rekey_serves_a_reference_entry_on_another_backend(tmp_path):
    nest, jnest, ops, jops, mode = _both("gemv")
    path = str(tmp_path / "shared")
    tuned = JSchedule(rows=16, lanes_tile_factor=1)
    jautotune.ScheduleCache(path=path).put(
        jautotune.cache_key(jnest, jops, mode=mode, backend="cpu"), tuned,
        meta={"tuned_us": 3.0})
    cache = ScheduleCache(path=path)
    card = "cuda:NVIDIA H100 80GB HBM3"
    key = interop.rekey_schedule(jnest, jops, from_backend="cpu",
                                 to_backend=card, mode=mode, cache=cache)
    assert key == autotune.cache_key(nest, ops, mode=mode, backend=card)
    assert cache.get(key) == interop.schedule_from_reference(tuned)
    meta = cache.meta(key)["meta"]
    assert meta["tuned_us"] == 3.0 and meta["rekeyed_from"]["backend"] == "cpu"
    assert interop.rekey_schedule(nest, ops, from_backend="tpu",
                                  to_backend=card, mode=mode,
                                  cache=cache) is None


# -- the measured race and transparent dispatch --------------------------------


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


TUNED = Schedule(rows=16)


def _tune_dot(cache, n=2048, default_s=0.002, tuned_s=0.001, **kw):
    nest = compiler.dot_product_nest(n)
    x = torch.from_numpy(RNG.standard_normal(n).astype(np.float32))
    y = torch.from_numpy(RNG.standard_normal(n).astype(np.float32))
    cands = [DEFAULT_SCHEDULE, TUNED]
    survivors = autotune.rank_candidates(nest, cands, top_k=2)
    dts = [default_s if s == DEFAULT_SCHEDULE else tuned_s
           for s in survivors]
    res = autotune.autotune(nest, reduction.MUL, {"A": x, "B": y},
                            candidates=cands, top_k=2, warmup=1, iters=1,
                            cache=cache, clock=_FakeClock(dts), **kw)
    return res, nest, x, y


def test_autotune_commits_the_faster_candidate(cache):
    res, nest, x, y = _tune_dot(cache)
    assert res.schedule == TUNED and res.committed and res.measured == 2
    assert res.tuned_us == pytest.approx(1000.0)
    assert res.default_us == pytest.approx(2000.0)
    assert dict((s, us) for s, us in res.timings)[TUNED] == res.tuned_us
    assert cache.get(res.key) == TUNED
    assert cache.meta(res.key)["meta"]["backend"] == "cpu"
    again, *_ = _tune_dot(cache)
    assert again.from_cache and again.schedule == TUNED


def test_autotune_keeps_the_default_when_it_is_faster(cache):
    res, *_ = _tune_dot(cache, default_s=0.001, tuned_s=0.002)
    assert res.is_default and cache.get(res.key) == DEFAULT_SCHEDULE


def test_committed_winner_runs_in_nest_kernel_and_ssr_call(monkeypatch):
    seen = []
    real = frontend.ssr_call

    def spy(*args, **kw):
        seen.append(kw["schedule"])
        return real(*args, **kw)

    monkeypatch.setattr(frontend, "ssr_call", spy)
    res, nest, x, y = _tune_dot(None)
    assert res.schedule == TUNED
    assert reduction._ssr.schedule_for(x, y) == TUNED
    healthy = float(reduction.ssr_dot(x, y, schedule=DEFAULT_SCHEDULE))
    got = float(reduction.ssr_dot(x, y))
    assert seen[-1] == TUNED
    assert got == pytest.approx(healthy, rel=1e-5)
    call = lowering.prepare_call(nest, reduction.MUL, {"A": x, "B": y})
    assert call.lowered.schedule == TUNED
    assert float(lowering.ssr_call(nest, reduction.MUL,
                                   {"A": x, "B": y})) == \
        pytest.approx(healthy, rel=1e-5)


def test_a_new_commit_rebuilds_the_nest_kernel_entry():
    x = torch.ones(3000)
    frontend.reset_dispatch_stats()
    reduction.ssr_dot(x, x)
    reduction.ssr_dot(x, x)
    assert frontend.DISPATCH_STATS["builds"] == 1
    nest = compiler.dot_product_nest(3000)
    autotune.global_cache().put(
        autotune.cache_key(nest, {"A": x, "B": x}), TUNED)
    assert float(reduction.ssr_dot(x, x)) == 3000.0
    assert frontend.DISPATCH_STATS["builds"] == 2
    assert reduction._ssr.schedule_for(x, x) == TUNED
    reduction.ssr_dot(x, x)
    assert frontend.DISPATCH_STATS["builds"] == 2


def test_lookup_then_invalidate(cache):
    res, nest, x, y = _tune_dot(cache)
    ops = {"A": x, "B": y}
    assert autotune.lookup(nest, ops, cache=cache) == TUNED
    assert autotune.invalidate(nest, ops, cache=cache)
    assert autotune.lookup(nest, ops, cache=cache) == DEFAULT_SCHEDULE


def test_an_explicit_policy_is_never_overridden():
    x = torch.ones(2048)
    nest = compiler.dot_product_nest(2048)
    autotune.global_cache().put(
        autotune.cache_key(nest, {"A": x, "B": x}), TUNED)
    call = lowering.prepare_call(nest, reduction.MUL, {"A": x, "B": x},
                                 policy=lowering.BlockPolicy(rows=32))
    assert call.lowered.schedule == Schedule(rows=32)
    pinned = lowering.prepare_call(nest, reduction.MUL, {"A": x, "B": x},
                                   schedule=DEFAULT_SCHEDULE)
    assert pinned.lowered.schedule == DEFAULT_SCHEDULE


# -- the race on the card, and resolution per epoch ----------------------------


@pytest.mark.parametrize("on_card, default_ms, tuned_ms, want", [
    (False, (2.0, 2.1, 2.2), (1.9, 2.3, 2.3), (TUNED, False)),
    (True, (2.0, 2.1, 2.2), (1.9, 2.3, 2.3), (DEFAULT_SCHEDULE, True)),
    (True, (2.0, 2.05, 2.02), (1.0, 1.02, 1.01), (TUNED, False)),
    (True, (1.0, 1.1, 1.2), (2.0, 2.0, 2.0), (DEFAULT_SCHEDULE, False)),
], ids=["cpu-commits-the-fastest", "card-holds-back-noise",
        "card-commits-a-clear-gain", "card-default-fastest"])
def test_the_card_commits_only_a_gain_above_the_spread(on_card, default_ms,
                                                       tuned_ms, want):
    survivors = [TUNED, DEFAULT_SCHEDULE]
    samples = [[t / 1e3 for t in tuned_ms], [t / 1e3 for t in default_ms]]
    winner, tuned_us, default_us, held = autotune._pick_winner(
        survivors, samples, on_card=on_card)
    assert (winner, held) == want
    assert default_us == pytest.approx(min(default_ms) * 1e3)
    assert tuned_us == pytest.approx(
        min(tuned_ms if winner == TUNED else default_ms) * 1e3)


def test_the_card_races_one_candidate_per_kernel():
    """A kernel is its geometry, accumulator and — where it is pipelined
    (gemm's ring kernel stages by them) — its depths: on the card each
    distinct kernel races once, the default's its own, so a depth-only
    variant of a pipelined geometry races beside its depth-2 twin."""
    nest = compiler.gemm_nest(256, 256, 1024)
    ops = {"A": torch.ones(256, 1024), "B": torch.ones(1024, 256)}
    cands = autotune.candidate_schedules(nest, quick=True)
    kept = autotune._card_candidates(nest, cands, gemm.DOT, mode="nest",
                                     out_dtype="float32", operands=ops,
                                     dev=torch.device("cpu"))

    def ident(s):
        k = autotune._candidate_kernel(nest, s, gemm.DOT, "nest", "float32")
        return (k.mode, k.geometry, k.acc_dtype,
                k.depths if k.pipelined else None)

    assert kept[0] == DEFAULT_SCHEDULE
    assert len({ident(s) for s in kept}) == len(kept)
    assert {ident(s) for s in kept} == {ident(s) for s in cands}
    assert any(s.buffer_depth != 2 for s in kept)
    assert all(ident(s)[3] is not None for s in kept if s.buffer_depth != 2)


def test_ssr_call_resolves_once_per_epoch(monkeypatch):
    n = 2100
    nest, x = compiler.dot_product_nest(n), torch.ones(n)
    ops = {"A": x, "B": x}
    probes = []
    real = autotune.lookup

    def spy(*a, **kw):
        probes.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(autotune, "lookup", spy)
    for _ in range(3):
        assert float(lowering.ssr_call(nest, reduction.MUL, ops)) == n
    assert len(probes) == 1
    autotune.global_cache().put(autotune.cache_key(nest, ops), TUNED)
    assert lowering.prepare_call(nest, reduction.MUL, ops).lowered.schedule \
        == TUNED
    assert float(lowering.ssr_call(nest, reduction.MUL, ops)) == n
    assert len(probes) == 2


def test_refresh_adopts_another_process_commit():
    """A commit written by another process reaches ``ssr_call`` once this
    process calls :func:`autotune.refresh`."""
    n = 2200
    nest, x = compiler.dot_product_nest(n), torch.ones(n)
    ops = {"A": x, "B": x}
    assert lowering.prepare_call(nest, reduction.MUL, ops).lowered.schedule \
        == DEFAULT_SCHEDULE
    path = autotune.global_cache().path
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, f"{autotune.cache_key(nest, ops)}.json"),
              "w") as f:
        json.dump({"version": autotune.SCHEDULE_CACHE_VERSION,
                   "schedule": TUNED.to_json(), "committed_unix": 0.0}, f)
    gen = os.path.join(path, "GENERATION")
    with open(gen + ".tmp", "w") as f:
        f.write("another process\n")
    os.replace(gen + ".tmp", gen)
    assert lowering.prepare_call(nest, reduction.MUL, ops).lowered.schedule \
        == DEFAULT_SCHEDULE                    # memoised until refreshed
    assert autotune.refresh()
    assert not autotune.refresh()
    assert lowering.prepare_call(nest, reduction.MUL, ops).lowered.schedule \
        == TUNED


def test_a_new_cache_directory_starts_a_new_epoch(tmp_path, monkeypatch):
    x = torch.ones(2300)
    nest = compiler.dot_product_nest(2300)
    autotune.global_cache().put(
        autotune.cache_key(nest, {"A": x, "B": x}), TUNED)
    assert reduction._ssr.schedule_for(x, x) == TUNED
    assert lowering.prepare_call(nest, reduction.MUL, {"A": x, "B": x}) \
        .lowered.schedule == TUNED
    e0 = autotune.epoch()
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "other"))
    assert autotune.epoch() > e0
    assert lowering.prepare_call(nest, reduction.MUL, {"A": x, "B": x}) \
        .lowered.schedule == DEFAULT_SCHEDULE
    assert reduction._ssr.schedule_for(x, x) == DEFAULT_SCHEDULE
