"""Halo reads: the port's stencils against the JAX package's, on the CPU.

Exact for what is pure Python: the halo geometry of ``lower_nest`` (grid,
tiles, padded bounds, the ``2**k`` shifted streams and their index-map
coefficients, ``HaloRead``), the padded layouts ``prepare`` lays out, the
``StreamReport`` bytes, the loud window-too-wide error, the autotuner's
candidates, legality, model costs and fingerprints.  Within the registry
``tol`` for values: ``ssr_stencil1d``, ``baseline_stencil1d``,
``ssr_stencil2d`` and the fused and unfused ``stencil1d_relu`` on inputs
drawn with numpy from a seed, the reference in Pallas interpret mode (the
port through its plain versions).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import agu as ref_agu
from repro.core import autotune as jautotune
from repro.core import compiler as jcompiler
from repro.core import lowering as jlowering
from repro.kernels import chained as jchained
from repro.kernels import ref as jref
from repro.kernels import stencil as jstencil

import repro_torch
from repro_torch.core import agu, autotune, compiler, lowering, nest_analysis
from repro_torch.core.lowering import LoweringError, Schedule
from repro_torch.kernels import chained, ops, ref, registry, stencil

TAPS = 11

#: (name, port nest, reference nest) — the halo nests at small sizes
NESTS = {
    "stencil1d_1024": (lambda: compiler.stencil_nest(1024, TAPS),
                       lambda: jcompiler.stencil_nest(1024, TAPS)),
    "stencil1d_500": (lambda: compiler.stencil_nest(500, TAPS),
                      lambda: jcompiler.stencil_nest(500, TAPS)),
    "stencil1d_5": (lambda: compiler.stencil_nest(1000, 5),
                    lambda: jcompiler.stencil_nest(1000, 5)),
    "stencil2d_64": (lambda: compiler.stencil2d_nest(64, 64, TAPS),
                     lambda: jcompiler.stencil2d_nest(64, 64, TAPS)),
    "stencil2d_32x300": (lambda: compiler.stencil2d_nest(32, 300, TAPS),
                         lambda: jcompiler.stencil2d_nest(32, 300, TAPS)),
}
SCHEDULES = {
    "default": {},
    "rows16_lanes256": dict(rows=16, lanes=256),
    "small_tiles": dict(lanes_tile_factor=1, rows_tile_factor=2),
}


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


# -- exact parity of a lowered nest (shared with test_torch_attention.py) --


def _coeffs(stream, grid):
    off, cs = agu.affine_coefficients(stream.index_map, grid)
    return off.tolist(), [c.tolist() for c in cs]


def _ref_coeffs(stream, grid):
    off, cs = ref_agu.affine_coefficients(stream.index_map, grid)
    return np.asarray(off).tolist(), [np.asarray(c).tolist() for c in cs]


def assert_same_geometry(lw, rw):
    """Grid, tiles, semantics, streams, coefficients, halos: equal."""
    assert (lw.grid, lw.tiles, lw.semantics, lw.contraction_axes,
            lw.axis_order, lw.padded_bounds, lw.rescale) == \
        (rw.grid, rw.tiles, rw.semantics, rw.contraction_axes,
         rw.axis_order, rw.padded_bounds, rw.rescale)
    assert [(h.name, h.slots, h.axes, h.tiles, h.windows)
            for h in lw.halos] == \
        [(h.name, h.slots, h.axes, h.tiles, h.windows) for h in rw.halos]
    assert len(lw.in_streams) == len(rw.in_streams)
    for a, b in [*zip(lw.in_streams, rw.in_streams),
                 (lw.out_stream, rw.out_stream)]:
        assert (a.name, a.stream.block_shape, a.levels, a.logical_shape,
                a.padded_shape, a.layout_shape) == \
            (b.name, b.stream.block_shape, b.levels, b.logical_shape,
             b.padded_shape, b.layout_shape)
        assert _coeffs(a.stream, lw.grid) == _ref_coeffs(b.stream, rw.grid)


def assert_same_layouts(lw, rw, seed):
    rng = np.random.default_rng(seed)
    data = {}
    for s in lw.in_streams:
        shape = s.logical_shape or (7,)
        data.setdefault(s.name, rng.standard_normal(
            int(np.prod(shape))).astype(np.float32))
    got = lowering.stream_layouts(lw, [torch.from_numpy(data[s.name])
                                       for s in lw.in_streams])
    for g, b in zip(got, rw.in_streams):
        want = np.asarray(b.prepare(jnp.asarray(data[b.name])))
        assert tuple(g.shape) == want.shape
        np.testing.assert_array_equal(g.numpy(), want)


def assert_same_report(lw, rw, body, jbody):
    kern = lowering._build_nest_kernel(lw, body, torch.float32)
    jkern = jlowering._build_nest_kernel(rw, jbody, jnp.float32, True)
    n = len(lw.in_streams) + 1
    for dts in ([torch.float32] * n,
                [torch.bfloat16] * (n - 1) + [torch.float32]):
        jdts = [jnp.bfloat16 if d == torch.bfloat16 else jnp.float32
                for d in dts]
        got, want = kern.report(dts), jkern.report(jdts)
        assert (got.grid, got.vmem_bytes, got.hbm_bytes_streamed,
                got.hbm_bytes_unique, got.scratch_bytes) == \
            (want.grid, want.vmem_bytes, want.hbm_bytes_streamed,
             want.hbm_bytes_unique, want.scratch_bytes)


def _plans(name):
    port, ref_ = NESTS[name]
    nest, jnest = port(), ref_()
    lanes = nest_analysis.auto_lanes(nest, None)
    return (lowering._plan_for(nest, lanes),
            jlowering._plan_for(jnest, lanes))


def _lower_both(name, sched):
    plan, jplan = _plans(name)
    kw = SCHEDULES[sched]
    return (lowering.lower_nest(plan, schedule=Schedule(**kw)),
            jlowering.lower_nest(jplan, schedule=jlowering.Schedule(**kw)))


# -- the halo geometry ----------------------------------------------------------


@pytest.mark.parametrize("sched", SCHEDULES, ids=list(SCHEDULES))
@pytest.mark.parametrize("name", sorted(NESTS))
def test_halo_geometry_matches_the_reference(name, sched):
    lw, rw = _lower_both(name, sched)
    assert lw.halos and not lw.rescale
    assert_same_geometry(lw, rw)


@pytest.mark.parametrize("sched", SCHEDULES, ids=list(SCHEDULES))
@pytest.mark.parametrize("name", sorted(NESTS))
def test_halo_layouts_match_the_reference(name, sched):
    lw, rw = _lower_both(name, sched)
    assert_same_layouts(lw, rw, seed=len(name))


@pytest.mark.parametrize("sched", SCHEDULES, ids=list(SCHEDULES))
@pytest.mark.parametrize("name", sorted(NESTS))
def test_halo_report_bytes_match_the_reference(name, sched):
    """The twin streams stay in the plan and the report, as the reference
    accounts them (the Hopper kernels read only the first slot)."""
    lw, rw = _lower_both(name, sched)
    assert_same_report(lw, rw, lambda *b: b[0], lambda *b: b[0])


def test_shifted_twins_share_one_layout():
    lw, _ = _lower_both("stencil2d_64", "default")
    x = torch.zeros(74, 74)
    w = torch.zeros(11)
    layouts = lowering.stream_layouts(
        lw, [{"x": x, "wx": w, "wy": w}[s.name] for s in lw.in_streams])
    assert lw.halos[0].slots == (0, 1, 2, 3)
    assert all(layouts[s] is layouts[0] for s in (1, 2, 3))


def test_default_2d_tile_is_raised_by_the_halo():
    """10 overlap rows need a 16-row tile where the default target would
    give 8 (a one-tile rows factor): the halo raises it, as the reference
    does."""
    plan, jplan = _plans("stencil2d_32x300")
    kw = dict(rows_tile_factor=1)
    lw = lowering.lower_nest(plan, schedule=Schedule(**kw))
    rw = jlowering.lower_nest(jplan, schedule=jlowering.Schedule(**kw))
    assert lw.tiles[0] == rw.tiles[0] == 16


class TestHaloWindowTooWide:
    """The halo legality error is loud and pinned verbatim (the reference's
    ``tests/test_halo_rescale.py::TestHaloWindowTooWide``)."""

    PINNED = ("stream 'x': halo window (11, 11) needs 10 overlap columns "
              "on level 0, but the block tile is only 8 wide; widen the "
              "tile so one block plus its +1-shifted neighbour covers the "
              "window")

    def test_window_exceeding_tile_is_loud_and_verbatim(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((8 + 10, 64 + 10)).astype(np.float32)
        w = (rng.standard_normal(TAPS) * 0.3).astype(np.float32)
        with pytest.raises(LoweringError) as exc:
            stencil.ssr_stencil2d(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(w))
        assert str(exc.value) == self.PINNED
        with pytest.raises(jlowering.LoweringError) as jexc:
            jstencil.ssr_stencil2d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(w))
        assert str(jexc.value) == str(exc.value)

    def test_boundary_height_lowers(self):
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.standard_normal((19, 74)).astype(np.float32))
        w = torch.from_numpy((rng.standard_normal(TAPS) * 0.3).astype(
            np.float32))
        got = stencil.ssr_stencil2d(x, w, w)
        np.testing.assert_allclose(got.numpy(),
                                   ref.stencil2d_ref(x, w, w).numpy(),
                                   rtol=0, atol=1e-5)


def test_base_offset_on_a_windowed_ref_is_refused():
    nest = compiler.LoopNest(
        bounds=(64,),
        refs=(compiler.MemRef("x", compiler.Direction.READ, (1,), offset=3,
                              window=(5,)),
              compiler.MemRef("y", compiler.Direction.WRITE, (1,))),
        compute_per_level=(5,))
    plan = lowering._plan_for(nest, nest_analysis.auto_lanes(nest, None))
    with pytest.raises(LoweringError, match="base offset 3"):
        lowering.lower_nest(plan)


# -- values against the reference kernels ---------------------------------------


def _x_w(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n + TAPS - 1).astype(np.float32),
            (rng.standard_normal(TAPS) * 0.3).astype(np.float32))


@pytest.mark.parametrize("n", [1, 500, 1024, 5000])
def test_stencil1d_matches_the_reference(n):
    x, w = _x_w(n, n)
    tol = registry.get("stencil1d").tol
    want = np.asarray(jstencil.ssr_stencil1d(
        jnp.asarray(x), jnp.asarray(w), schedule=jlowering.DEFAULT_SCHEDULE))
    got = stencil.ssr_stencil1d(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == want.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    base = stencil.baseline_stencil1d(torch.from_numpy(x),
                                      torch.from_numpy(w))
    jbase = np.asarray(jstencil.baseline_stencil1d(jnp.asarray(x),
                                                   jnp.asarray(w)))
    np.testing.assert_allclose(base.numpy(), jbase, **tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.stencil1d_ref(
        jnp.asarray(x), jnp.asarray(w))), **tol)


@pytest.mark.parametrize("hw", [(42, 74), (74, 74)])
def test_stencil2d_matches_the_reference(hw):
    rng = np.random.default_rng(hw[0])
    x = rng.standard_normal(hw).astype(np.float32)
    wx, wy = ((rng.standard_normal(TAPS) * 0.3).astype(np.float32)
              for _ in range(2))
    want = np.asarray(jstencil.ssr_stencil2d(
        jnp.asarray(x), jnp.asarray(wx), jnp.asarray(wy),
        schedule=jlowering.DEFAULT_SCHEDULE))
    got = stencil.ssr_stencil2d(*(torch.from_numpy(a) for a in (x, wx, wy)))
    assert tuple(got.shape) == want.shape == (hw[0] - 10, hw[1] - 10)
    np.testing.assert_allclose(got.numpy(), want,
                               **registry.get("stencil2d").tol)


@pytest.mark.parametrize("n", [500, 1024])
def test_stencil1d_relu_fused_and_unfused_match_the_reference(n):
    x, w = _x_w(n, n + 1)
    tol = registry.get("stencil1d_relu").tol
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    want = np.asarray(jchained.fused_stencil1d_relu(jx, jw))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    fused = chained.fused_stencil1d_relu(tx, tw)
    unfused = chained.unfused_stencil1d_relu(tx, tw)
    np.testing.assert_allclose(fused.numpy(), want, **tol)
    np.testing.assert_allclose(unfused.numpy(),
                               np.asarray(jchained.unfused_stencil1d_relu(
                                   jx, jw)), **tol)
    # one stencil arithmetic on both sides: the relu selects, to the bit
    np.testing.assert_array_equal(fused.numpy(), unfused.numpy())
    assert float(fused.min()) >= 0.0


@pytest.mark.parametrize("sched", [Schedule(lanes_tile_factor=1),
                                   Schedule(rows=16, lanes=256),
                                   Schedule(buffer_depth=3)],
                         ids=["lanes1", "r16l256", "depth3"])
def test_stencil_values_do_not_depend_on_the_schedule(sched):
    x, w = _x_w(1000, 3)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    base = stencil.ssr_stencil1d(tx, tw)
    got = stencil.ssr_stencil1d(tx, tw, schedule=sched)
    np.testing.assert_array_equal(got.numpy(), base.numpy())


def test_ops_ssrcfg_switch_keeps_semantics():
    x, w = _x_w(700, 5)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for fn in (ops.stencil1d, ops.stencil1d_relu):
        np.testing.assert_allclose(fn(tx, tw, ssr=True).numpy(),
                                   fn(tx, tw, ssr=False).numpy(),
                                   rtol=1e-5, atol=1e-5)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (40, 50)).astype(np.float32))
    np.testing.assert_allclose(ops.stencil2d(g, tw, tw, ssr=True).numpy(),
                               ops.stencil2d(g, tw, tw, ssr=False).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_refs_match_the_reference_refs():
    x, w = _x_w(300, 8)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        ref.stencil1d_ref(t(x), t(w)).numpy(),
        np.asarray(jref.stencil1d_ref(jnp.asarray(x), jnp.asarray(w))))
    np.testing.assert_array_equal(
        ref.stencil1d_relu_ref(t(x), t(w)).numpy(),
        np.asarray(jref.stencil1d_relu_ref(jnp.asarray(x), jnp.asarray(w))))
    g = np.random.default_rng(9).standard_normal((30, 41)).astype(np.float32)
    np.testing.assert_array_equal(
        ref.stencil2d_ref(t(g), t(w), t(w)).numpy(),
        np.asarray(jref.stencil2d_ref(jnp.asarray(g), jnp.asarray(w),
                                      jnp.asarray(w))))


def test_registry_entries_match_the_reference():
    from repro.kernels import registry as jregistry
    for name in ("stencil1d", "stencil2d", "stencil1d_relu"):
        e, je = registry.get(name), jregistry.get(name)
        assert (e.tol, e.problem) == (je.tol, je.problem)
        assert sorted(e.variants()) == sorted(je.variants())
        assert sorted(e.cluster_variants()) == sorted(je.cluster_variants())
        for odd in (False, True):
            args, kw = e.example(np.random.default_rng(2), odd=odd)
            jargs, jkw = je.example(np.random.default_rng(2), odd=odd)
            for a, ja in zip(args, jargs):
                np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
            assert kw == jkw


# -- the autotuner on the halo nests --------------------------------------------


def _js(scheds):
    return [s.to_json() for s in scheds]


def _fp(fp):
    if isinstance(fp, tuple):
        return tuple(_fp(x) for x in fp)
    if hasattr(fp, "to_json"):
        return json.dumps(fp.to_json(), sort_keys=True)
    return fp


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("name", ["stencil1d_1024", "stencil1d_500",
                                  "stencil2d_64", "stencil2d_32x300"])
def test_candidates_costs_and_legality_match_the_reference(name, quick):
    port, ref_ = NESTS[name]
    nest, jnest = port(), ref_()
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


@pytest.mark.parametrize("kw", [dict(rows_tile_factor=1),
                                dict(rows=8, rows_tile_factor=1,
                                     lanes_tile_factor=1),
                                dict(rows=16), dict(lanes=256)],
                         ids=["rows1", "small", "rows16", "lanes256"])
def test_narrow_tiles_are_filtered_not_raised(kw):
    """A tile narrower than the overlap is illegal for both packages, with
    the lowering's own message; it is never raised out of the tuner."""
    for h in (8, 20, 64):
        nest, jnest = (compiler.stencil2d_nest(h, 64, TAPS),
                       jcompiler.stencil2d_nest(h, 64, TAPS))
        got = autotune.schedule_is_legal(nest, Schedule(**kw))
        want = jautotune.schedule_is_legal(jnest, jlowering.Schedule(**kw))
        assert got == want


def test_eq_1_3_on_the_halo_nests():
    """Eq. (1)–(3) (the compiler's plan numbers) on the halo nests."""
    for fn, args in (("stencil_nest", (1024, TAPS)),
                     ("stencil2d_nest", (64, 64, TAPS)),
                     ("stencil_nest", (500, 5))):
        plan = compiler.ssrify(getattr(compiler, fn)(*args), num_lanes=3,
                               force=True)
        jplan = jcompiler.ssrify(getattr(jcompiler, fn)(*args), num_lanes=3,
                                 force=True)
        assert (plan.n_base, plan.n_ssr, plan.speedup, plan.ssrified) == \
            (jplan.n_base, jplan.n_ssr, jplan.speedup, jplan.ssrified)
