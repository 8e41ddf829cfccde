"""Pipelined delivery in the port: the N-deep ring against the depth-2 path.

The counterpart of ``tests/test_pipeline.py``.  A schedule deeper than 2
(``buffer_depth`` or per-stream ``stream_depths``) makes a call of K1–K13's
families pipelined: its read streams arrive through an N-deep ring (on the
CPU :func:`hopper.plain_ring`, on the card the ring kernels R1–R4 and R6;
a ChainedKernel's R5 has its own tests, ``tests/test_torch_chained_kernel
.py``, and its fetch log here; the DAGs' R7–R9 theirs,
``tests/test_torch_dag_ring.py``; the halos' and attention's R10–R12
theirs, ``tests/test_torch_halo_attention_ring.py``; the gathers' R13, R14
and the scan's R15 theirs, ``tests/test_torch_gather_scan_ring.py``).  The
contracts, on the CPU:

* **delivery changes, the arithmetic does not** — map, reduce, gemm, gemv,
  gemv_relu and K5's chains (sum_sq_diff fused, its (x − y)² map stage;
  axpy_dot fused, its axpy map and identity reduce stages) at depths 3, 4,
  8 and per-stream depths give the depth-2 result bit for bit, and the
  reference's sync result (Pallas interpret mode) within the registry
  ``tol`` (relu bit for bit);
* **pipelined where a ring runs** — True for those and the halo and
  gather families, False for a one-step grid, an untagged body and under
  ``REPRO_DISABLE_PIPELINE``;
* **the reference's rotation** — the plain ring's fetch log is the
  prime / run-ahead / no-fetch-past-the-run formula of ``_pipelined_call``
  for several run splits (R1's, R5's and R6's), and an invariant stream is
  fetched once;
* **one budget** — ``StreamReport`` and the tuner's working-set count agree
  at every depth; a ring over the shared memory a CTA may opt into is
  refused by ``accepts`` with the kernel's name;
* **the race on the card** keeps depth-only candidates where the kernel
  stages, and drops them where it does not (the pipeline disabled);
* **interop** — a reference schedule with depths resolves, through a shared
  cache entry, to a pipelined port kernel with the same depths.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import compiler as jcompiler
from repro.core import lowering as jlowering
from repro.core.lowering import DEFAULT_SCHEDULE as REF_DEFAULT
from repro.core.lowering import Schedule as JSchedule
from repro.kernels import chained as jchained
from repro.kernels import registry as jregistry

import repro_torch
from repro_torch import interop
from repro_torch.core import agu, autotune, compiler, hopper, lowering, ssr
from repro_torch.core.autotune import ScheduleCache
from repro_torch.core.lowering import DEFAULT_SCHEDULE, Schedule, ssr_call
from repro_torch.core.ssr import MAX_BUFFER_DEPTH, stream_vmem_bytes
from repro_torch.core.ssr import BlockStream
from repro_torch.core.stream import Direction
from repro_torch.kernels import (attention, chained, frontend, gemm, gemv,
                                 reduction, relu, sparse, stencil)

DEPTHS = [3, 4, 8, (2, 4), (4, 2)]
# a causal attention problem of 512 queries and keys, D = 128 (its static)
_ATT = (512, 512, 128, True, None, 128 ** -0.5, torch.float32)
# relu has one read stream: a per-stream depth is a 1-tuple
MAP_DEPTHS = [3, 4, 8, (5,), (8,)]


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    # a schedule cache of the test's own: a tuned entry elsewhere must not
    # change either package's schedule
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    monkeypatch.delenv("REPRO_DISABLE_PIPELINE", raising=False)
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _sched(depth, **kw) -> Schedule:
    if isinstance(depth, tuple):
        return Schedule(stream_depths=depth, **kw)
    return Schedule(buffer_depth=depth, **kw)


def _f32(rng, *shape) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# -- the cases: entry, its reference sync result, its kernel ----------------
#
# Each case: (port call at a schedule, reference call at the default
# schedule, registry entry whose tol holds, the call's prepared kernel).

def _dot_case(rng):
    x, y = _f32(rng, 5000), _f32(rng, 5000)
    nest = compiler.dot_product_nest(5000)
    return (lambda s: reduction.ssr_dot(x, y, schedule=s),
            lambda: jregistry.get("reduction").ssr(
                jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                schedule=REF_DEFAULT),
            "reduction",
            lambda s: lowering.prepare_call(nest, reduction.MUL,
                                            {"A": x, "B": y}, schedule=s))


def _gemm_case(rng):
    a, b = _f32(rng, 300, 1100), _f32(rng, 1100, 260)
    nest = compiler.gemm_nest(300, 260, 1100)
    return (lambda s: gemm.ssr_matmul(a, b, schedule=s),
            lambda: jregistry.get("gemm").ssr(
                jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                schedule=REF_DEFAULT),
            "gemm",
            lambda s: lowering.prepare_call(nest, gemm.DOT,
                                            {"A": a, "B": b}, schedule=s))


def _gemv_case(rng, shape=(1000, 1536)):
    a, x = _f32(rng, *shape), _f32(rng, shape[1])
    nest = compiler.gemv_nest(*shape)
    return (lambda s: gemv.ssr_gemv(a, x, schedule=s),
            lambda: jregistry.get("gemv").ssr(
                jnp.asarray(a.numpy()), jnp.asarray(x.numpy()),
                schedule=REF_DEFAULT),
            "gemv",
            lambda s: lowering.prepare_call(nest, gemv.MATVEC,
                                            {"A": a, "x": x}, schedule=s))


def _gemv_relu_case(rng):
    a, x = _f32(rng, 1000, 1536), _f32(rng, 1536)
    nest = compiler.gemv_nest(1000, 1536)
    return (lambda s: chained.fused_gemv_relu(a, x, schedule=s),
            lambda: jchained.fused_gemv_relu(jnp.asarray(a.numpy()),
                                             jnp.asarray(x.numpy())),
            "gemv_relu",
            lambda s: lowering.prepare_call(nest, chained.MATVEC_RELU,
                                            {"A": a, "x": x}, schedule=s))


def _sum_sq_diff_chain_case(rng):
    x, y = _f32(rng, 5000), _f32(rng, 5000)
    return (lambda s: chained.fused_sum_sq_diff(x, y, schedule=s),
            lambda: jchained.fused_sum_sq_diff(jnp.asarray(x.numpy()),
                                               jnp.asarray(y.numpy())),
            "sum_sq_diff",
            lambda s: lowering.prepare_chain_call(
                chained._chain_nests(5000, False),
                (chained.SQ_DIFF, chained.IDENTITY), {"X": x, "Y": y},
                mode="reduce", schedule=s))


def _sq_diff_map_case(rng):
    x, y = _f32(rng, 5000), _f32(rng, 5000)
    nest = compiler.elementwise_nest(5000, ("X", "Y"), 2)
    jnest = jcompiler.elementwise_nest(5000, ("X", "Y"), 2)
    return (lambda s: ssr_call(nest, chained.SQ_DIFF, {"X": x, "Y": y},
                               mode="map", schedule=s),
            lambda: jlowering.ssr_call(
                jnest, jchained._sq_diff_block,
                {"X": jnp.asarray(x.numpy()), "Y": jnp.asarray(y.numpy())},
                mode="map", schedule=REF_DEFAULT),
            "sum_sq_diff",
            lambda s: lowering.prepare_call(nest, chained.SQ_DIFF,
                                            {"X": x, "Y": y}, mode="map",
                                            schedule=s))


CASES = {"dot": _dot_case, "gemm": _gemm_case, "gemv": _gemv_case,
         "gemv_x_invariant": lambda rng: _gemv_case(rng, (2048, 512)),
         "gemv_relu": _gemv_relu_case,
         "sum_sq_diff_chain": _sum_sq_diff_chain_case,
         "sq_diff_map": _sq_diff_map_case}


@pytest.mark.parametrize("depth", DEPTHS, ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_depth_is_bit_identical_to_depth_2(case, depth):
    run, ref, entry, prepare = CASES[case](np.random.default_rng(7))
    call = prepare(_sched(depth))
    assert call.kernel.pipelined and call.kernel.geometry.steps > 1
    want = run(DEFAULT_SCHEDULE)
    got = run(_sched(depth))
    assert torch.equal(got, want)
    assert torch.equal(call.run().reshape(got.shape), got)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref()),
                               **jregistry.get(entry).tol)


@pytest.mark.parametrize("depth", MAP_DEPTHS, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_map_relu_is_bit_identical(depth, dtype):
    rng = np.random.default_rng(3)
    if dtype == "int32":
        xn = rng.integers(-(1 << 30), 1 << 30, 5000, dtype=np.int32)
    else:
        xn = rng.standard_normal(5000).astype(np.float32)
        xn[:3] = [-0.0, np.nan, -np.inf]
    x = torch.from_numpy(xn)
    jx = jnp.asarray(xn)
    if dtype == "bfloat16":
        x, jx = x.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    call = lowering.prepare_call(compiler.elementwise_nest(5000), relu.RELU,
                                 {"X": x}, mode="map", out_dtype=x.dtype,
                                 schedule=_sched(depth))
    assert call.kernel.pipelined
    got = relu.ssr_relu(x, schedule=_sched(depth))
    want = relu.ssr_relu(x, schedule=DEFAULT_SCHEDULE)
    ref = jregistry.get("relu").ssr(jx, schedule=REF_DEFAULT)
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    ref_bits = np.asarray(ref.astype(jnp.float32)).astype(np.float32) \
        if dtype == "bfloat16" else np.asarray(ref)
    np.testing.assert_array_equal(got.to(torch.float32).numpy()
                                  if dtype == "bfloat16" else got.numpy(),
                                  ref_bits)


AXPY_DEPTHS = [3, 4, 8, (2, 4, 3), (4, 2, 2)]


@pytest.mark.parametrize("depth", AXPY_DEPTHS, ids=str)
def test_axpy_dot_chain_and_stages_are_bit_identical(depth):
    """K5's three-stream chain and its two unfused stages (R6 on the card):
    the depth-2 bits at every depth, the reference within the tol."""
    rng = np.random.default_rng(13)
    x, y, w = _f32(rng, 5000), _f32(rng, 5000), _f32(rng, 5000)
    jx, jy, jw = (jnp.asarray(t.numpy()) for t in (x, y, w))
    tol = jregistry.get("axpy_dot").tol
    call = lowering.prepare_chain_call(
        chained._chain_nests(5000, True), (chained.axpy_block(0.5),
                                           chained.DOT),
        {"X": x, "Y": y, "W": w}, mode="reduce", schedule=_sched(depth))
    assert call.kernel.pipelined and len(call.kernel.depths) == 3
    got = chained.fused_axpy_dot(x, y, w, alpha=0.5, schedule=_sched(depth))
    assert torch.equal(got, chained.fused_axpy_dot(x, y, w, alpha=0.5))
    assert torch.equal(call.run().reshape(got.shape), got)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jchained.fused_axpy_dot(jx, jy, jw, alpha=0.5)), **tol)
    # the unfused stages: the axpy map (two streams), the identity reduce
    pair = compiler.elementwise_nest(5000, ("X", "Y"), 2)
    stage = depth[:2] if isinstance(depth, tuple) else depth
    t = ssr_call(pair, chained.axpy_block(0.5), {"X": x, "Y": y},
                 mode="map", schedule=_sched(stage))
    assert torch.equal(t, ssr_call(pair, chained.axpy_block(0.5),
                                   {"X": x, "Y": y}, mode="map"))
    jt = jlowering.ssr_call(jcompiler.elementwise_nest(5000, ("X", "Y"), 2),
                            jchained._axpy_block(0.5), {"X": jx, "Y": jy},
                            mode="map", schedule=REF_DEFAULT)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), **tol)
    single = compiler.elementwise_nest(5000, ("T",), 1)
    red = (stage[0],) if isinstance(stage, tuple) else stage
    got_sum = ssr_call(single, chained.IDENTITY, {"T": t},
                       schedule=_sched(red))
    assert lowering.prepare_call(single, chained.IDENTITY, {"T": t},
                                 schedule=_sched(red)).kernel.pipelined \
        is (max(red if isinstance(red, tuple) else (red,)) > 2)
    assert torch.equal(got_sum, ssr_call(single, chained.IDENTITY, {"T": t}))
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(jlowering.ssr_call(
        jcompiler.elementwise_nest(5000, ("T",), 1),
        jchained._identity_block, {"T": jt}, schedule=REF_DEFAULT)), **tol)


# -- where the ring runs -------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_only_above_depth_2(case):
    prepare = CASES[case](np.random.default_rng(1))[3]
    assert not prepare(DEFAULT_SCHEDULE).kernel.pipelined
    assert prepare(Schedule(stream_depths=(2, 2))).kernel.pipelined is False
    assert prepare(Schedule(buffer_depth=3)).kernel.pipelined


def test_single_step_grid_is_not_pipelined():
    x = torch.ones(1000)
    call = lowering.prepare_call(compiler.dot_product_nest(1000),
                                 reduction.MUL, {"A": x, "B": x},
                                 schedule=Schedule(buffer_depth=4))
    assert call.kernel.geometry.steps == 1
    assert not call.kernel.pipelined
    assert float(call.run()) == 1000.0


def _unstaged(n=4096):
    """Prepared calls at depth 3: the halo and gather families (which
    stage, R10, R11 and R13) and a body without a ring kernel."""
    x, w = torch.ones(n + stencil.TAPS - 1), torch.ones(stencil.TAPS)
    s = Schedule(buffer_depth=3)
    csr = sparse.hpcg_operator(16, 16, 16, device="cpu")
    vals, cidx, m, k = sparse.pack_ell(*csr, 4096)
    side = 1024 + stencil.TAPS - 1
    return {
        "stencil1d": lowering.prepare_call(
            compiler.stencil_nest(n, stencil.TAPS), stencil.STENCIL1D,
            {"x": x, "w": w}, schedule=s),
        "stencil2d": lowering.prepare_call(
            compiler.stencil2d_nest(1024, 1024, stencil.TAPS),
            stencil.STENCIL2D,
            {"x": torch.ones(side, side), "wx": w, "wy": w}, schedule=s),
        "spmv": lowering.prepare_call(
            compiler.spmv_nest(m, k), sparse.SPMV,
            {"vals": vals, "cidx": cidx, "x": torch.ones(4096)}, schedule=s),
        "untagged": lowering.prepare_call(
            compiler.dot_product_nest(n), lambda a, b: a * b,
            {"A": torch.ones(n), "B": torch.ones(n)}, schedule=s),
    }


@pytest.mark.parametrize("name", ["untagged"])
def test_unstaged_families_stay_sync(name):
    call = _unstaged()[name]
    assert max(call.kernel.depths) == 3 and call.kernel.geometry.steps > 1
    assert not call.kernel.pipelined


@pytest.mark.parametrize("name, ring", [("stencil1d", "ring_halo_stencil1d"),
                                        ("stencil2d", "ring_halo_stencil2d")])
def test_halo_families_now_pipeline(name, ring):
    call = _unstaged()[name]
    assert max(call.kernel.depths) == 3 and call.kernel.geometry.steps > 1
    assert call.kernel.pipelined
    assert hopper.RING_KERNELS[call.kernel.device_key] == ring


@pytest.mark.parametrize("case", sorted(CASES))
def test_disable_pipeline_forces_sync(case, monkeypatch):
    run, _, _, prepare = CASES[case](np.random.default_rng(5))
    deep = run(Schedule(buffer_depth=4))
    monkeypatch.setenv("REPRO_DISABLE_PIPELINE", "1")
    assert not ssr.pipeline_supported()
    assert not prepare(Schedule(buffer_depth=4)).kernel.pipelined
    assert torch.equal(run(Schedule(buffer_depth=4)), deep)


# -- the reference's rotation: the fetch log ----------------------------------


def _formula(depths, invariant, steps, run):
    """``_pipelined_call``'s fetches over runs of ``run`` steps: each run
    primes min(d − 1, n) fetches (an invariant stream one, into slot 0);
    its step s fetches step s + d − 1 into slot (s + d − 1) % d while the
    run has that step."""
    log = []
    for s0 in range(0, steps, run):
        n = min(run, steps - s0)
        for i, d in enumerate(depths):
            if invariant[i]:
                log.append((i, s0, 0))
            else:
                log.extend((i, s0 + j, j) for j in range(min(d - 1, n)))
        for s in range(n):
            for i, d in enumerate(depths):
                if not invariant[i] and s + d - 1 < n:
                    log.append((i, s0 + s + d - 1, (s + d - 1) % d))
    return log


@pytest.mark.parametrize("run", [None, 1, 2, 3, 5, 12], ids=str)
@pytest.mark.parametrize("depth", DEPTHS, ids=str)
def test_plain_ring_fetch_log_is_the_reference_rotation(depth, run):
    x, y = _f32(np.random.default_rng(9), 13 * 1024), \
        _f32(np.random.default_rng(10), 13 * 1024)
    call = lowering.prepare_call(compiler.dot_product_nest(13 * 1024),
                                 reduction.MUL, {"A": x, "B": y},
                                 schedule=_sched(depth))
    kern = call.kernel
    assert kern.geometry.steps == 13
    out, log = hopper.plain_ring(kern.body, kern.geometry, call.layouts,
                                 kern.out_dtype, mode="reduce",
                                 ring=kern.ring, steps_per_cta=run)
    assert log == _formula(kern.depths, (False, False), 13, run or 13)
    assert torch.equal(out, kern.plain(call.layouts))
    # every step's block arrives exactly once per stream
    for i in range(2):
        assert sorted(s for j, s, _ in log if j == i) == list(range(13))


@pytest.mark.parametrize("run", [None, 1, 2, 5], ids=str)
@pytest.mark.parametrize("depth", [3, 8, (2, 4, 3), (4, 2, 2)], ids=str)
def test_r6_chain_fetch_log_is_the_reference_rotation(depth, run):
    """axpy_dot's three streams through R6's ring, in the plain version."""
    x, y, w = (_f32(np.random.default_rng(k), 13 * 1024) for k in (1, 2, 3))
    call = lowering.prepare_chain_call(
        chained._chain_nests(13 * 1024, True),
        (chained.axpy_block(0.5), chained.DOT), {"X": x, "Y": y, "W": w},
        mode="reduce", schedule=_sched(depth))
    kern = call.kernel
    assert kern.pipelined and kern.geometry.steps == 13
    inputs, log = hopper.ring_delivery(kern.geometry, call.layouts, kern.ring,
                                       run)
    assert log == _formula(kern.depths, (False,) * 3, 13, run or 13)
    assert torch.equal(hopper.plain_stages(
        kern.bodies, kern.program, kern.mode, kern.geometry, call.layouts,
        kern.out_dtype, inputs=inputs), kern.plain(call.layouts))


def _r5_axpy_relu(n_rows):
    """A ChainedKernel relu(0.5·x + y) on a flat Launch of (8, 128) blocks,
    and its inputs: ``n_rows`` / 8 steps."""
    def launch(static, x, y):
        return frontend.Launch(
            grid=(x.shape[0] // 8,),
            in_streams=(BlockStream((8, 128), lambda i: (i, 0)),) * 2,
            out_streams=(BlockStream((8, 128), lambda i: (i, 0),
                                     Direction.WRITE),),
            out_shapes=(frontend.ShapeDtype(tuple(x.shape), x.dtype),))

    kern = frontend.ChainedKernel(
        "axpy_relu", prepare=lambda x, y: ((x, y), None, None), launch=launch,
        producer=lambda s: chained.axpy_block(0.5),
        consumer=lambda s: relu.RELU, lowering_waiver="a test instance")
    rng = np.random.default_rng(n_rows)
    return kern, (_f32(rng, n_rows, 128), _f32(rng, n_rows, 128))


@pytest.mark.parametrize("run", [None, 1, 2, 5], ids=str)
@pytest.mark.parametrize("depth", [3, 4, 8])
def test_r5_fetch_log_is_the_reference_rotation(depth, run):
    kern, xs = _r5_axpy_relu(13 * 8)
    parts = kern.parts(*xs, schedule=Schedule(buffer_depth=depth))
    geo = hopper.chained_geometry(parts.launch)
    assert geo.steps == 13 and parts.ring.depths == (depth, depth)
    inputs, log = hopper.ring_delivery(geo, parts.arrays, parts.ring, run)
    assert log == _formula((depth, depth), (False, False), 13, run or 13)
    assert torch.equal(parts.plain()[0], kern(*xs))
    assert torch.equal(parts.plain()[0], torch.relu(0.5 * xs[0] + xs[1]))


@pytest.mark.parametrize("run", [None, 1, 3], ids=str)
def test_invariant_stream_is_fetched_once_a_run(run):
    a, x = _f32(np.random.default_rng(2), 2048, 512), \
        _f32(np.random.default_rng(4), 512)
    call = lowering.prepare_call(compiler.gemv_nest(2048, 512), gemv.MATVEC,
                                 {"A": a, "x": x},
                                 schedule=Schedule(buffer_depth=4))
    kern = call.kernel
    assert kern.ring.invariant == (False, True) and kern.geometry.steps == 4
    out, log = hopper.plain_ring(kern.body, kern.geometry, call.layouts,
                                 kern.out_dtype, mode="nest", ring=kern.ring,
                                 steps_per_cta=run)
    runs = list(range(0, 4, run or 4))
    assert [e for e in log if e[0] == 1] == [(1, s0, 0) for s0 in runs]
    assert log == _formula(kern.depths, (False, True), 4, run or 4)
    assert torch.equal(out, hopper.plain_contract(
        kern.body, kern.geometry, call.layouts, kern.out_dtype))


# -- one budget ---------------------------------------------------------------


@pytest.mark.parametrize("depth", [2, 3, 4, 8, (2, 4), (4, 2)], ids=str)
@pytest.mark.parametrize("nest", ["gemm", "gemv"])
def test_report_agrees_with_the_tuner_count(nest, depth):
    built = {"gemm": (compiler.gemm_nest(300, 260, 1100), gemm.DOT),
             "gemv": (compiler.gemv_nest(1000, 1536), gemv.MATVEC)}[nest]
    sched = _sched(depth)
    lowered = autotune._lower_candidate(built[0], sched)
    kern = autotune._candidate_kernel(built[0], sched, built[1], "nest",
                                      "float32")
    rep = kern.report([torch.float32] * 3)
    assert rep.vmem_bytes + rep.scratch_bytes == \
        autotune.stream_block_bytes(lowered)
    depths = kern.depths
    ins = [s.block_bytes(torch.float32) for s in kern.in_streams]
    ring = agu.RingProgram(depths, kern.ring.invariant, tuple(ins))
    assert ring.ring_bytes == sum(stream_vmem_bytes(b, d)
                                  for b, d in zip(ins, depths))
    out = kern.out_stream.block_bytes(torch.float32)
    assert rep.vmem_bytes == ring.ring_bytes + stream_vmem_bytes(
        out, max(depths))


@pytest.mark.parametrize("depth", [2, 3, 4, 8])
def test_stream_report_scales_with_depth(depth):
    call = lowering.prepare_call(compiler.elementwise_nest(4096), relu.RELU,
                                 {"X": torch.ones(4096)}, mode="map",
                                 out_dtype=torch.float32,
                                 schedule=Schedule(buffer_depth=depth))
    rep = call.kernel.report([torch.float32, torch.float32])
    assert rep.vmem_bytes == 2 * stream_vmem_bytes(8 * 128 * 4, depth)


def _over_budget():
    """(op, kernel, ring kernel name) whose ring at depth 8 exceeds a CTA's
    opt-in shared memory while its depth-3 ring fits."""
    x = torch.ones(1 << 16)
    dot = lambda s: lowering.prepare_call(  # noqa: E731
        compiler.dot_product_nest(1 << 16), reduction.MUL, {"A": x, "B": x},
        schedule=s)
    a, v = torch.ones(64, 8192), torch.ones(8192)
    mv = lambda s: lowering.prepare_call(  # noqa: E731
        compiler.gemv_nest(64, 8192), gemv.MATVEC, {"A": a, "x": v},
        schedule=s)
    ssd = lambda s: lowering.prepare_chain_call(  # noqa: E731
        chained._chain_nests(1 << 16, False),
        (chained.SQ_DIFF, chained.IDENTITY), {"X": x, "Y": x},
        mode="reduce", schedule=s)
    return {"ring_reduce_mul": (dot, dict(rows=16, lanes=512)),
            "ring_contract_gemv": (mv, dict(lanes=512, lanes_tile_factor=4)),
            "ring_chain_elem": (ssd, dict(rows=16, lanes=512))}


@pytest.mark.parametrize("name", ["ring_reduce_mul", "ring_contract_gemv",
                                  "ring_chain_elem"])
def test_accepts_refuses_a_ring_over_the_budget(name):
    prepare, geometry = _over_budget()[name]
    for depth, fits in ((3, True), (MAX_BUFFER_DEPTH, False)):
        kern = prepare(Schedule(buffer_depth=depth, **geometry)).kernel
        assert kern.pipelined
        takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                    torch.float32, "cpu",
                                    **kern.device_args())
        assert takes is fits, why
        if not fits:
            assert why.startswith(f"{name}:") and str(kern.depths) in why
            assert str(hopper.SMEM_OPTIN_BYTES) in why


def test_tuner_legality_uses_the_ring_refusal():
    nest = compiler.dot_product_nest(1 << 16)
    x = torch.ones(1 << 16)
    deep = Schedule(rows=16, lanes=512, buffer_depth=MAX_BUFFER_DEPTH)
    why = autotune.kernel_refusal(nest, deep, reduction.MUL,
                                  operands={"A": x, "B": x}, device="cpu")
    assert why is not None and why.startswith("ring_reduce_mul:")
    assert autotune.kernel_refusal(
        nest, Schedule(rows=16, lanes=512, buffer_depth=3), reduction.MUL,
        operands={"A": x, "B": x}, device="cpu") is None


# -- the race on the card ------------------------------------------------------


def _candidates(nest, body, mode, ops):
    cands = autotune.candidate_schedules(nest, quick=True)
    kept = autotune._card_candidates(nest, cands, body, mode=mode,
                                     out_dtype="float32", operands=ops,
                                     dev=torch.device("cpu"))
    return cands, kept


@pytest.mark.parametrize("family", ["gemm", "dot", "relu", "gemv",
                                    "sq_diff_map", "identity_reduce",
                                    "stencil1d", "attention", "spmv",
                                    "spmm"])
def test_card_race_keeps_depth_only_candidates_where_the_kernel_stages(
        family):
    n = 1 << 14
    nest, body, mode, ops = {
        "sq_diff_map": (compiler.elementwise_nest(n, ("X", "Y"), 2),
                        chained.SQ_DIFF, "map",
                        {"X": torch.ones(n), "Y": torch.ones(n)}),
        "identity_reduce": (compiler.elementwise_nest(n, ("T",), 1),
                            chained.IDENTITY, "reduce", {"T": torch.ones(n)}),
        "gemm": (compiler.gemm_nest(256, 256, 1024), gemm.DOT, "nest",
                 {"A": torch.ones(256, 1024), "B": torch.ones(1024, 256)}),
        "dot": (compiler.dot_product_nest(n), reduction.MUL, "reduce",
                {"A": torch.ones(n), "B": torch.ones(n)}),
        "relu": (compiler.elementwise_nest(n), relu.RELU, "map",
                 {"X": torch.ones(n)}),
        "gemv": (compiler.gemv_nest(1024, 2048), gemv.MATVEC, "nest",
                 {"A": torch.ones(1024, 2048), "x": torch.ones(2048)}),
        "stencil1d": (compiler.stencil_nest(n, stencil.TAPS),
                      stencil.STENCIL1D, "nest",
                      {"x": torch.ones(n + stencil.TAPS - 1),
                       "w": torch.ones(stencil.TAPS)}),
        "attention": (attention._nest(_ATT), attention._body(_ATT), "nest",
                      {"Q": torch.ones(512, 128), "K": torch.ones(512, 128),
                       "V": torch.ones(512, 128)}),
        **_gather_families(),
    }[family]
    cands, kept = _candidates(nest, body, mode, ops)
    assert kept[0] == DEFAULT_SCHEDULE
    deep = [s for s in kept if s.buffer_depth == 3]
    assert deep, kept
    shallow = {autotune._candidate_kernel(nest, s, body, mode, "float32",
                                          ops).geometry
               for s in kept if s.buffer_depth == 2}
    for s in deep:      # a ring beside the sync kernel of its geometry
        k = autotune._candidate_kernel(nest, s, body, mode, "float32", ops)
        # a gather's table trails at depth 2, whole (the reference's)
        n = len(k.depths) - len(k.geometry.gathers)
        assert k.pipelined and k.depths == (3,) * n + (2,) * (len(k.depths)
                                                              - n)
        assert k.geometry in shallow


def _gather_families():
    """spmv and spmm on HPCG's operator at 16**3 (k = 27): their race
    entries (nest, body, mode, operands)."""
    csr = sparse.hpcg_operator(16, 16, 16, device="cpu")
    vals, cidx, m, k = sparse.pack_ell(*csr, 4096)
    return {"spmv": (compiler.spmv_nest(m, k), sparse.SPMV, "nest",
                     {"vals": vals, "cidx": cidx, "x": torch.ones(4096)}),
            "spmm": (compiler.spmm_nest(m, 128, k, 128), sparse.SPMM, "nest",
                     {"vals": vals, "cidx": cidx,
                      "X": torch.ones(4096, 128)})}


def test_card_race_drops_depth_only_candidates_where_it_does_not_stage(
        monkeypatch):
    # every streamed family stages now: with the pipeline disabled none does
    monkeypatch.setenv("REPRO_DISABLE_PIPELINE", "1")
    csr = sparse.hpcg_operator(16, 16, 16, device="cpu")
    vals, cidx, m, k = sparse.pack_ell(*csr, 4096)
    nest = compiler.spmv_nest(m, k)
    ops = {"vals": vals, "cidx": cidx, "x": torch.ones(4096)}
    cands, kept = _candidates(nest, sparse.SPMV, "nest", ops)
    assert any(s.buffer_depth != 2 for s in cands)
    assert all(s.buffer_depth == 2 for s in kept)


# -- interop -------------------------------------------------------------------


@pytest.mark.parametrize("depths", [dict(buffer_depth=4),
                                    dict(stream_depths=(2, 4))],
                         ids=["buffer_depth4", "stream_depths24"])
def test_reference_schedule_with_depths_resolves_to_a_pipelined_kernel(
        tmp_path, depths):
    ref = JSchedule(**depths)
    assert interop.schedule_from_reference(ref) == Schedule(**depths)
    rng = np.random.default_rng(11)
    a, b = _f32(rng, 300, 1100), _f32(rng, 1100, 260)
    jnest = jcompiler.gemm_nest(300, 260, 1100)
    jops = {"A": jnp.asarray(a.numpy()), "B": jnp.asarray(b.numpy())}
    from repro.core import autotune as jautotune
    path = str(tmp_path / "shared")
    jautotune.ScheduleCache(path=path).put(
        jautotune.cache_key(jnest, jops, mode="nest", backend="tpu"), ref,
        meta={"tuned_us": 1.0})
    cache = ScheduleCache(path=path)
    nest, ops = compiler.gemm_nest(300, 260, 1100), {"A": a, "B": b}
    key = interop.rekey_schedule(jnest, jops, from_backend="tpu",
                                 to_backend="cpu", mode="nest", cache=cache)
    assert key == autotune.cache_key(nest, ops, mode="nest", backend="cpu")
    sched = autotune.lookup(nest, ops, mode="nest", cache=cache,
                            device="cpu")
    assert sched == Schedule(**depths)
    kern = lowering.prepare_call(nest, gemm.DOT, ops, schedule=sched).kernel
    assert kern.pipelined
    want = (4, 4) if "buffer_depth" in depths else (2, 4)
    assert kern.depths == want and kern.ring.depths == want
    assert torch.equal(ssr_call(nest, gemm.DOT, ops, schedule=sched),
                       ssr_call(nest, gemm.DOT, ops))
