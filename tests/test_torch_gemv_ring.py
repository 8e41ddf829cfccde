"""R4, the gemv ring, in the port: a filling warp on mbarriers, persistent
CTAs, K4's bits.

R4 ``ring_contract_gemv`` is 8 computing warps (one row each) and a
filling warp that brings each step's 8 rows of A and the x block into
rings of the schedule's depths, on a full and an empty mbarrier a slot;
its CTAs are persistent, each walking a run of whole output blocks of its
row group (``csrc/ring_contract_gemv.cu``).  On the CPU, at small sizes and
on inputs from a numpy seed:

* **the split** — :func:`hopper.ring_run_steps` for R4 is a pure function
  of the geometry, the ring, the dtype and the SM count; each row group's
  runs cover its output blocks once, in order; at 132 SMs every CTA of the
  8192 x 8192 gemv cell is resident in one wave at depths 3, 4 and 8 and
  the per-stream pairs, in f32 and bf16;
* **the plain ring under R4's runs** gives the depth-2 result to the bit,
  the relu drain included, and the JAX package's sync output (Pallas
  interpret mode) within the registry ``tol``;
* **one budget** — R4 keeps its slots' mbarriers beside the ring; every
  depth from 2 to 8 (and the pairs) is taken on the cell, and a ring over
  a CTA's shared memory is refused, naming those bytes.

The card's checks (R4 = K4 to the bit) are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.lowering import DEFAULT_SCHEDULE as REF_DEFAULT
from repro.kernels import chained as jchained
from repro.kernels import gemv as jgemv
from repro.kernels import registry as jregistry

import repro_torch
from repro_torch.core import autotune, compiler, hopper, lowering
from repro_torch.core.lowering import DEFAULT_SCHEDULE, Schedule
from repro_torch.kernels import chained, gemv

CELL = 8192         # chip_smoke.py's gemv cell: A 8192 x 8192
SMS = 132           # an H100's SMs
DEPTHS = [3, 4, 8, (2, 4), (4, 2)]
R4 = "ring_contract_gemv"
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _sched(depth, **kw) -> Schedule:
    if isinstance(depth, tuple):
        return Schedule(stream_depths=depth, **kw)
    return Schedule(buffer_depth=depth, **kw)


def _kernel(m, n, depth, dtype=torch.float32, body=gemv.MATVEC, **kw):
    """The pipelined kernel a schedule of ``depth`` builds (no operands)."""
    return autotune._candidate_kernel(compiler.gemv_nest(m, n),
                                      _sched(depth, **kw), body, "nest",
                                      dtype)


def _run(kern, dtype, sms):
    return hopper.ring_run_steps(R4, kern.geometry, kern.ring, dtype, sms)


def _groups(geo):
    return -(-geo.ins[0].block[0] // hopper.GEMV_RING_ROWS)


# -- the split -----------------------------------------------------------------


@pytest.mark.parametrize("sms", [1, 2, 7, SMS])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("depth", DEPTHS, ids=str)
def test_r4_split_is_a_pure_function_of_geometry_ring_dtype_and_sms(
        depth, dtype, sms):
    kern = _kernel(CELL, CELL, depth, dtype)
    run = _run(kern, dtype, sms)
    _run(_kernel(300, 1100, 3, lanes_tile_factor=1), torch.bfloat16, 1)
    again = _kernel(CELL, CELL, depth, dtype)
    assert _run(again, dtype, sms) == _run(kern, dtype, sms) == run
    assert 1 <= run <= kern.geometry.steps


@pytest.mark.parametrize("sms", [1, 2, 7, SMS])
@pytest.mark.parametrize("shape", [(CELL, CELL, {}),
                                   (300, 1100, {"lanes_tile_factor": 1}),
                                   (2048, 512, {})], ids=str)
@pytest.mark.parametrize("depth", [3, 4, 8], ids=str)
def test_r4_runs_cover_every_output_block_once_in_order(depth, shape, sms):
    """A run is whole output blocks (``contraction_steps`` consecutive
    steps each); each row group's runs tile its blocks in grid order, so
    every output block is drained once, by one CTA."""
    m, n, kw = shape
    kern = _kernel(m, n, depth, **kw)
    geo = kern.geometry
    z = geo.contraction_steps
    run = _run(kern, torch.float32, sms)
    assert run % z == 0
    spans = [(s, min(s + run, geo.steps)) for s in range(0, geo.steps, run)]
    blocks = [(b * z, (b + 1) * z) for b in range(geo.steps // z)]
    walked = [b for a, e in spans for b in blocks if a <= b[0] and b[1] <= e]
    assert walked == blocks
    assert spans[-1][1] == geo.steps


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("depth", DEPTHS, ids=str)
def test_r4_is_one_wave_of_persistent_ctas_on_the_gemv_cell(depth, dtype):
    """At 132 SMs R4 launches no more CTAs than fit the SMs beside their
    rings and barriers (at most its build's CTAs an SM), each on a run of
    whole output blocks of its row group."""
    kern = _kernel(CELL, CELL, depth, dtype)
    geo = kern.geometry
    dr = hopper.device_ring(R4, geo, kern.ring, dtype)
    smem = dr.ring_bytes + hopper._staged_bytes(R4, (), geo)
    per_sm = hopper._ctas_per_sm(smem, hopper.GEMV_RING_PER_SM[dtype])
    z = geo.contraction_steps
    per = _run(kern, dtype, SMS) // z
    ctas = _groups(geo) * -(-(geo.steps // z) // per)
    assert geo.grid == (16, 16) and z == 16
    assert per >= 1 and ctas <= per_sm * SMS


def test_r4_split_weighs_the_busiest_sm_against_a_ctas_steps():
    """Of the one-wave runs, R4 takes the one whose busiest SM takes the
    least time: 4 blocks a CTA (two CTAs an SM) in f32 at depth 4, where 3
    would load an SM with 9 blocks; 3 in bf16 at depth 8, where 4 would
    make a CTA's 64 steps the longer time."""
    f32 = _kernel(CELL, CELL, 4)
    assert _run(f32, torch.float32, SMS) == 4 * 16
    bf16 = _kernel(CELL, CELL, 8, torch.bfloat16)
    assert _run(bf16, torch.bfloat16, SMS) == 3 * 16
    assert _run(_kernel(CELL, CELL, 8), torch.float32, SMS) == 8 * 16


# -- the plain ring under R4's runs --------------------------------------------


def _gemv_inputs(m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("sms", [1, 2, SMS])
@pytest.mark.parametrize("depth", DEPTHS, ids=str)
@pytest.mark.parametrize("relu", [False, True], ids=["gemv", "gemv_relu"])
def test_plain_ring_under_r4_runs_is_the_depth_2_result(relu, depth, sms):
    """A (300, 1100) in 128 x 128 blocks — grid (3, 9), a ragged last row
    block — through the ring under R4's runs gives the depth-2 plain
    version's bits, the relu drain included, and the reference's sync
    output within the registry tol."""
    an, xn = _gemv_inputs(300, 1100, 7)
    a, x = torch.from_numpy(an), torch.from_numpy(xn)
    body = chained.MATVEC_RELU if relu else gemv.MATVEC
    nest = compiler.gemv_nest(300, 1100)
    kw = {"lanes_tile_factor": 1}
    call = lowering.prepare_call(nest, body, {"A": a, "x": x},
                                 schedule=_sched(depth, **kw))
    kern = call.kernel
    assert kern.pipelined and kern.geometry.grid == (3, 9)
    run = _run(kern, torch.float32, sms)
    got, log = hopper.plain_ring(kern.body, kern.geometry, call.layouts,
                                 kern.out_dtype, kern.acc_dtype, mode="nest",
                                 ring=kern.ring, steps_per_cta=run)
    got = call.finish(got)
    want = lowering.prepare_call(nest, body, {"A": a, "x": x},
                                 schedule=Schedule(**kw)).run()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for i in range(2):      # every block of a moving stream delivered once
        assert sorted(s for j, s, _ in log if j == i) == list(range(27))
    ref = (jchained.fused_gemv_relu(jnp.asarray(an), jnp.asarray(xn))
           if relu else jgemv.ssr_gemv(jnp.asarray(an), jnp.asarray(xn),
                                       schedule=REF_DEFAULT))
    tol = jregistry.get("gemv_relu" if relu else "gemv").tol
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("depth", [3, 4, 8], ids=str)
def test_plain_ring_with_an_x_that_never_moves_is_the_depth_2_result(depth):
    """gemv (2048, 512): one contraction step, so x is invariant (one
    slot, fetched once) and each CTA runs several output blocks."""
    an, xn = _gemv_inputs(2048, 512, 3)
    a, x = torch.from_numpy(an), torch.from_numpy(xn)
    nest = compiler.gemv_nest(2048, 512)
    call = lowering.prepare_call(nest, gemv.MATVEC, {"A": a, "x": x},
                                 schedule=_sched(depth))
    kern = call.kernel
    assert kern.invariant == (False, True) and kern.pipelined
    run = _run(kern, torch.float32, SMS)
    got, log = hopper.plain_ring(kern.body, kern.geometry, call.layouts,
                                 kern.out_dtype, kern.acc_dtype, mode="nest",
                                 ring=kern.ring, steps_per_cta=run)
    want = lowering.prepare_call(nest, gemv.MATVEC, {"A": a, "x": x},
                                 schedule=DEFAULT_SCHEDULE).run()
    assert torch.equal(call.finish(got).view(torch.int32),
                       want.view(torch.int32))
    runs = -(-kern.geometry.steps // run)
    assert sum(1 for j, _, _ in log if j == 1) == runs   # x once a CTA


# -- one budget ----------------------------------------------------------------


def test_r4_keeps_its_barriers_beside_the_ring():
    geo = _kernel(CELL, CELL, 4).geometry
    assert hopper._staged_bytes(R4, ("matvec",), geo) == \
        hopper.RING_BARRIER_BYTES == 256
    dr = hopper.device_ring(R4, geo, _kernel(CELL, CELL, 4).ring,
                            torch.float32)
    assert dr.ring_bytes == 4 * (8 * 512 + 512) * 4


@pytest.mark.parametrize("depth", [*range(2, 9), (2, 4), (4, 2)], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("body", [gemv.MATVEC, chained.MATVEC_RELU],
                         ids=["gemv", "gemv_relu"])
def test_every_depth_from_2_to_8_is_taken_on_the_cell(body, dtype, depth):
    kern = _kernel(CELL, CELL, depth, dtype, body)
    takes, why = hopper.accepts(kern.device_key, kern.geometry, dtype, "cpu",
                                **kern.device_args())
    assert takes, why
    assert kern.pipelined is (depth != 2)


def test_a_ring_over_the_budget_is_refused_naming_its_barriers():
    """2048-wide f32 blocks: 8 rows and x a slot, 73,728 bytes; depth 3 and
    its barriers fit, depth 4 does not, and the refusal counts and names
    the barriers."""
    kw = {"lanes_tile_factor": 16}
    fits = _kernel(CELL, CELL, 3, **kw)
    assert fits.geometry.ins[0].block[1] == 2048
    assert hopper.accepts(fits.device_key, fits.geometry, torch.float32,
                          "cpu", **fits.device_args())[0]
    kern = _kernel(CELL, CELL, 4, **kw)
    takes, why = hopper.accepts(kern.device_key, kern.geometry, torch.float32,
                                "cpu", **kern.device_args())
    need = hopper.device_ring(R4, kern.geometry, kern.ring,
                              torch.float32).ring_bytes + 256
    assert not takes
    assert why == (f"{R4}: its ring at depths {kern.depths} needs {need} "
                   "bytes of shared memory a CTA (256 of them its slots' "
                   f"barriers), the card allows {hopper.SMEM_OPTIN_BYTES}")
