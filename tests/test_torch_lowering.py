"""Parity of the port's lowering and ``ssr_call`` with the JAX reference.

Exact for geometry — grid, tiles, semantics, contraction axes, block and
layout shapes, affine coefficients, padded layouts, report bytes, schedule
JSON — and within the registry tolerance for the computed values of
``ssr_call`` in reduce, map and nest modes (run on the CPU through the plain
versions; the reference in Pallas interpret mode).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import agu as ref_agu
from repro.core import compiler as ref_compiler
from repro.core import lowering as ref_lowering
from repro.core.nest_analysis import LoopNest as RefLoopNest
from repro.core.nest_analysis import MemRef as RefMemRef
from repro.core.stream import Direction as RefDirection

import repro_torch
from repro_torch import interop
from repro_torch.core import agu, compiler, lowering, nest_analysis
from repro_torch.core.lowering import LoweringError, Schedule
from repro_torch.core.nest_analysis import LoopNest, MemRef
from repro_torch.core.stream import Direction
from repro_torch.kernels.frontend import promote


@pytest.fixture(autouse=True)
def _cpu():
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _flat2d(ref=False):
    """A 2-level flat nest: a dense operand, a row-repeated one, a constant."""
    L, M, D = ((RefLoopNest, RefMemRef, RefDirection) if ref
               else (LoopNest, MemRef, Direction))
    return L(bounds=(3, 300),
             refs=(M("A", D.READ, (300, 1)), M("w", D.READ, (0, 1)),
                   M("c", D.READ, (0, 0), offset=5)),
             compute_per_level=(0, 2))


def _nest(fn, args, ref=False):
    if fn == "flat2d":
        return _flat2d(ref)
    return getattr(ref_compiler if ref else compiler, fn)(*args)


FLAT = [("dot_product_nest", (5000,)), ("elementwise_nest", (1025,)),
        ("dot_product_nest", (2048,)), ("flat2d", ())]
NESTED = [("gemm_nest", (100, 130, 70)), ("gemm_nest", (32, 32, 32)),
          ("gemm_nest", (4096, 4096, 4096)), ("gemm_nest", (1, 2, 300)),
          ("gemv_nest", (60, 64)), ("gemv_nest", (8192, 8192)),
          ("gemv_nest", (1000, 1536))]
SCHEDULES = {
    "default": {},
    "rows16_lanes256": dict(rows=16, lanes=256),
    "small_tiles": dict(lanes_tile_factor=1, rows_tile_factor=2),
    "deep": dict(buffer_depth=3),
}


def _both_schedules(kw):
    return Schedule(**kw), ref_lowering.Schedule(**kw)


def _coeffs(stream, grid):
    off, cs = agu.affine_coefficients(stream.index_map, grid)
    return off.tolist(), [c.tolist() for c in cs]


def _ref_coeffs(stream, grid):
    off, cs = ref_agu.affine_coefficients(stream.index_map, grid)
    return np.asarray(off).tolist(), [np.asarray(c).tolist() for c in cs]


def _plan_pair(fn, args):
    nest, ref_nest = _nest(fn, args), _nest(fn, args, ref=True)
    lanes = nest_analysis.auto_lanes(nest, None)
    return (lowering._plan_for(nest, lanes),
            ref_lowering._plan_for(ref_nest, lanes))


@pytest.mark.parametrize("sched", SCHEDULES, ids=list(SCHEDULES))
@pytest.mark.parametrize("fn,args", FLAT, ids=[f"{f}{a}" for f, a in FLAT])
def test_lower_plan_geometry(fn, args, sched):
    plan, ref_plan = _plan_pair(fn, args)
    s, rs = _both_schedules(SCHEDULES[sched])
    lw = lowering.lower_plan(plan, schedule=s)
    rw = ref_lowering.lower_plan(ref_plan, schedule=rs)
    assert lw.grid == rw.grid
    assert lw.policy.block_shape == rw.policy.block_shape
    assert len(lw.in_streams) == len(rw.in_streams)
    for a, b in zip(lw.in_streams, rw.in_streams):
        assert (a.name, a.stream.block_shape, a.logical_shape, a.padded_last,
                a.offset) == (b.name, b.stream.block_shape, b.logical_shape,
                              b.padded_last, b.offset)
        assert _coeffs(a.stream, lw.grid) == _ref_coeffs(b.stream, rw.grid)


@pytest.mark.parametrize("sched", SCHEDULES, ids=list(SCHEDULES))
@pytest.mark.parametrize("fn,args", NESTED,
                         ids=[f"{f}{a}" for f, a in NESTED])
def test_lower_nest_geometry(fn, args, sched):
    plan, ref_plan = _plan_pair(fn, args)
    s, rs = _both_schedules(SCHEDULES[sched])
    lw = lowering.lower_nest(plan, schedule=s)
    rw = ref_lowering.lower_nest(ref_plan, schedule=rs)
    assert (lw.grid, lw.tiles, lw.semantics, lw.contraction_axes,
            lw.axis_order, lw.padded_bounds) == \
        (rw.grid, rw.tiles, rw.semantics, rw.contraction_axes,
         rw.axis_order, rw.padded_bounds)
    streams = list(zip(lw.in_streams, rw.in_streams))
    streams.append((lw.out_stream, rw.out_stream))
    assert len(lw.in_streams) == len(rw.in_streams)
    for a, b in streams:
        assert (a.name, a.stream.block_shape, a.levels, a.logical_shape,
                a.padded_shape, a.layout_shape) == \
            (b.name, b.stream.block_shape, b.levels, b.logical_shape,
             b.padded_shape, b.layout_shape)
        assert _coeffs(a.stream, lw.grid) == _ref_coeffs(b.stream, rw.grid)


def test_gemm_axis_order_and_default_geometry():
    plan, ref_plan = _plan_pair("gemm_nest", (4096, 4096, 4096))
    lw = lowering.lower_nest(plan)
    assert (lw.grid, lw.tiles) == ((16, 8, 8), (256, 512, 512))
    assert lw.semantics == ("parallel", "parallel", "arbitrary")
    kw = dict(axis_order=(1, 0, 2))
    s, rs = _both_schedules(kw)
    a = lowering.lower_nest(plan, schedule=s)
    b = ref_lowering.lower_nest(ref_plan, schedule=rs)
    assert (a.grid, a.axis_order) == (b.grid, b.axis_order) == ((8, 16, 8),
                                                                (1, 0, 2))
    for x, y in zip(a.in_streams, b.in_streams):
        assert _coeffs(x.stream, a.grid) == _ref_coeffs(y.stream, b.grid)
    bad = Schedule(axis_order=(2, 0, 1))
    with pytest.raises(LoweringError, match="trailing"):
        lowering.lower_nest(plan, schedule=bad)
    with pytest.raises(LoweringError, match="level-mapped path"):
        lowering.lower_plan(_plan_pair("dot_product_nest", (64,))[0],
                            schedule=Schedule(axis_order=(0,)))


def test_slice_boundaries_name_the_slice():
    for fn, args, what in (("stencil_nest", (64, 5), "halo"),
                           ("attention_nest", (8, 8, 4), "online-softmax"),
                           ("spmv_nest", (8, 4), "gathers")):
        nest = getattr(compiler, fn)(*args)
        plan = compiler.ssrify(nest, num_lanes=nest_analysis.auto_lanes(
            nest, None), force=True)
        with pytest.raises(LoweringError, match=f"{what}.*slice"):
            lowering.lower_nest(plan)


@pytest.mark.parametrize("fn,args", FLAT + NESTED[:2] + NESTED[3:5],
                         ids=[f"{f}{a}" for f, a in FLAT + NESTED[:2]
                              + NESTED[3:5]])
def test_prepare_layouts_match(fn, args):
    plan, ref_plan = _plan_pair(fn, args)
    nested = any(r.kind == Direction.WRITE for r in plan.nest.refs)
    lw = lowering._lowered_for(plan, lowering.DEFAULT_SCHEDULE, nested)
    rw = ref_lowering._lowered_for(ref_plan, ref_lowering.DEFAULT_SCHEDULE,
                                   nested)
    rng = np.random.default_rng(3)
    for a, b in zip(lw.in_streams, rw.in_streams):
        shape = a.logical_shape if a.logical_shape else (7,)
        if not shape:
            shape = (7,)
        data = rng.standard_normal(int(np.prod(shape))).astype(np.float32)
        got = a.prepare(torch.from_numpy(data))
        want = np.asarray(b.prepare(jnp.asarray(data)))
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


REPORT_CASES = [("dot_product_nest", (5000,), "reduce"),
                ("elementwise_nest", (1025,), "map"),
                ("flat2d", (), "reduce"),
                ("gemm_nest", (100, 130, 70), "nest"),
                ("gemm_nest", (4096, 4096, 4096), "nest"),
                ("gemv_nest", (8192, 8192), "nest")]


@pytest.mark.parametrize("sched", ["default", "deep"])
@pytest.mark.parametrize("fn,args,mode", REPORT_CASES,
                         ids=[f"{f}{a}" for f, a, _ in REPORT_CASES])
def test_stream_report_bytes_match(fn, args, mode, sched):
    plan, ref_plan = _plan_pair(fn, args)
    s, rs = _both_schedules(SCHEDULES[sched])
    if mode == "nest":
        lw = lowering.lower_nest(plan, schedule=s)
        rw = ref_lowering.lower_nest(ref_plan, schedule=rs)
        kern = lowering._build_nest_kernel(lw, lambda a, b: a, torch.float32)
        ref_kern = ref_lowering._build_nest_kernel(
            rw, lambda a, b: a, jnp.float32, True)
    else:
        lw = lowering.lower_plan(plan, schedule=s)
        rw = ref_lowering.lower_plan(ref_plan, schedule=rs)
        n_in = len(lw.in_streams)

        def body(*xs):
            return promote(xs[0]) * 2.0

        def ref_body(*xs):
            return xs[0].astype(jnp.float32) * 2.0

        kern = lowering._build_kernel(lw, body, mode, torch.float32)
        ref_kern = ref_lowering._build_kernel(rw, ref_body, mode,
                                              jnp.float32, True)
        assert n_in == len(rw.in_streams)
    n = len(lw.in_streams) + 1
    for dts in ([torch.float32] * n, [torch.bfloat16] * (n - 1)
                + [torch.float32]):
        ref_dts = [jnp.bfloat16 if d == torch.bfloat16 else jnp.float32
                   for d in dts]
        got, want = kern.report(dts), ref_kern.report(ref_dts)
        assert (got.grid, got.vmem_bytes, got.hbm_bytes_streamed,
                got.hbm_bytes_unique, got.scratch_bytes) == \
            (want.grid, want.vmem_bytes, want.hbm_bytes_streamed,
             want.hbm_bytes_unique, want.scratch_bytes)
        assert got.reuse_factor == want.reuse_factor


def test_default_gemm_schedule_is_not_rejected_against_smem():
    """The lowered blocks are delivery units in device memory, not shared
    memory: the 512 KiB C block and 1 MiB B block must not be refused."""
    plan, _ = _plan_pair("gemm_nest", (4096, 4096, 4096))
    lw = lowering.lower_nest(plan)
    kern = lowering._build_nest_kernel(lw, lambda a, b: a, torch.float32)
    rep = kern.report([torch.float32] * 3)
    assert rep.vmem_bytes == 2 * (256 * 512 + 512 * 512 + 256 * 512) * 4
    assert rep.scratch_bytes == 256 * 512 * 4


@pytest.mark.parametrize("bad", [1, 9])
def test_buffer_depth_is_validated(bad):
    plan, _ = _plan_pair("dot_product_nest", (4096,))
    lw = lowering.lower_plan(plan, schedule=Schedule(buffer_depth=bad))
    with pytest.raises(ValueError, match="buffer_depth"):
        lowering._build_kernel(lw, lambda a, b: a * b, "reduce",
                               torch.float32)


# -- ssr_call values, within the registry tolerance -------------------------

def _ref_call(nest, body, operands, **kw):
    return np.asarray(ref_lowering.ssr_call(
        nest, body, {k: jnp.asarray(v) for k, v in operands.items()},
        schedule=kw.pop("schedule", ref_lowering.DEFAULT_SCHEDULE),
        interpret=True, **kw))


def _call(nest, body, operands, **kw):
    return lowering.ssr_call(
        nest, body, {k: torch.from_numpy(v) for k, v in operands.items()},
        **kw).numpy()


@pytest.mark.parametrize("sched", ["default", "rows16_lanes256"])
@pytest.mark.parametrize("n", [5000, 1024, 7])
def test_ssr_call_reduce(n, sched):
    rng = np.random.default_rng(n)
    ops = {"A": rng.standard_normal(n).astype(np.float32),
           "B": rng.standard_normal(n).astype(np.float32)}
    s, rs = _both_schedules(SCHEDULES[sched])
    got = _call(compiler.dot_product_nest(n),
                lambda a, b: promote(a) * promote(b), ops, schedule=s)
    want = _ref_call(ref_compiler.dot_product_nest(n),
                     lambda a, b: a * b, ops, schedule=rs)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    # a scalar partial takes the (1, 1) accumulator
    got = _call(compiler.dot_product_nest(n),
                lambda a, b: torch.sum(promote(a) * promote(b)), ops)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def test_ssr_call_flat2d_reduce_and_map():
    rng = np.random.default_rng(5)
    ops = {"A": rng.standard_normal(900).astype(np.float32),
           "w": rng.standard_normal(300).astype(np.float32),
           "c": rng.standard_normal(40).astype(np.float32)}
    got = _call(_flat2d(), lambda a, w, c: a * w + c[:, :1], ops)
    want = _ref_call(_flat2d(True), lambda a, w, c: a * w + c[:, :1], ops)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    got = _call(_flat2d(), lambda a, w, c: a - w, ops, mode="map")
    want = _ref_call(_flat2d(True), lambda a, w, c: a - w, ops, mode="map")
    assert got.shape == want.shape == (900,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1025, 64, 3000])
def test_ssr_call_map(n):
    rng = np.random.default_rng(n)
    ops = {"X": rng.standard_normal(n).astype(np.float32)}
    got = _call(compiler.elementwise_nest(n),
                lambda x: torch.clamp_min(x, 0.0) * 3.0, ops, mode="map")
    want = _ref_call(ref_compiler.elementwise_nest(n),
                     lambda x: jnp.maximum(x, 0.0) * 3.0, ops, mode="map")
    np.testing.assert_array_equal(got, want)


NEST_CALLS = [((100, 130, 70), "default"), ((100, 130, 300), "small_tiles"),
              ((17, 3, 260), "small_tiles"), ((32, 32, 32), "default")]


@pytest.mark.parametrize("mnk,sched", NEST_CALLS,
                         ids=[f"{m}-{s}" for m, s in NEST_CALLS])
def test_ssr_call_nest_gemm(mnk, sched):
    m, n, k = mnk
    rng = np.random.default_rng(m + n + k)
    ops = {"A": rng.standard_normal((m, k)).astype(np.float32),
           "B": rng.standard_normal((k, n)).astype(np.float32)}
    s, rs = _both_schedules(SCHEDULES[sched])
    got = _call(compiler.gemm_nest(m, n, k),
                lambda a, b: promote(a) @ promote(b), ops, schedule=s)
    want = _ref_call(ref_compiler.gemm_nest(m, n, k),
                     lambda a, b: jnp.dot(a, b), ops, schedule=rs)
    assert got.shape == want.shape == (m, n)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mn,sched", [((60, 64), "default"),
                                      ((300, 700), "small_tiles")])
def test_ssr_call_nest_gemv(mn, sched):
    m, n = mn
    rng = np.random.default_rng(m * n)
    ops = {"A": rng.standard_normal((m, n)).astype(np.float32),
           "x": rng.standard_normal(n).astype(np.float32)}
    s, rs = _both_schedules(SCHEDULES[sched])
    got = _call(compiler.gemv_nest(m, n),
                lambda a, x: promote(a) @ promote(x).mT, ops, schedule=s)
    want = _ref_call(ref_compiler.gemv_nest(m, n),
                     lambda a, x: jnp.dot(a, x.T), ops, schedule=rs)
    assert got.shape == want.shape == (m,)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_ssr_call_missing_operand_and_cache():
    nest = compiler.dot_product_nest(64)
    with pytest.raises(ValueError, match="missing operands"):
        lowering.ssr_call(nest, lambda a, b: a * b, {"A": torch.ones(64)})
    lowering.reset_dispatch_stats()
    x = torch.ones(64)
    for _ in range(2):
        lowering.ssr_call(nest, lambda a, b: a * b, {"A": x, "B": x})
    assert lowering.DISPATCH_STATS == {"builds": 1, "calls": 2}


# -- interop: geometry objects carried across --------------------------------

INTEROP_SCHEDULES = [
    {}, dict(rows=16, lanes=256), dict(axis_order=(1, 0, 2)),
    dict(acc_dtype="float64", buffer_depth=4),
    dict(stream_depths=(2, 5), cut_edges=()),
    dict(cut_edges=(0, 2), lanes_tile_factor=2, rows_tile_factor=8),
]


@pytest.mark.parametrize("kw", INTEROP_SCHEDULES,
                         ids=[str(k) for k in INTEROP_SCHEDULES])
def test_schedule_json_round_trip(kw):
    ref = ref_lowering.Schedule(**kw)
    port = interop.schedule_from_reference(ref)
    assert port == Schedule(**kw)
    assert port.to_json() == ref.to_json()
    assert Schedule.from_json(port.to_json()) == port
    assert ref_lowering.Schedule.from_json(port.to_json()) == ref


@pytest.mark.parametrize("fn,args", NESTED[:2] + FLAT[:2] + [
    ("stencil_nest", (64, 5)), ("attention_nest", (8, 8, 4)),
    ("spmv_nest", (8, 4))])
def test_loop_nest_from_reference(fn, args):
    ref_nest = getattr(ref_compiler, fn)(*args)
    nest = interop.loop_nest_from_reference(ref_nest)
    assert nest == getattr(compiler, fn)(*args)
    assert hash(nest) == hash(getattr(compiler, fn)(*args))


def test_operands_to_tensors():
    arrs = {"A": np.arange(6, dtype=np.float32), "B": np.ones(3, np.int32)}
    out = interop.operands_to_tensors(arrs, device="cpu")
    assert out["A"].dtype == torch.float32 and out["B"].dtype == torch.int32
    assert out["A"].device.type == "cpu"
    np.testing.assert_array_equal(out["A"].numpy(), arrs["A"])
