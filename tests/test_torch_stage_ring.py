"""R1 and R2, the stage rings of the main path's dot and relu, in the port.

R1 ``ring_reduce_mul`` runs on persistent CTAs that walk K1's runs one after
another, its ring running on across each run's end, one partial a run; R2
``ring_map_relu`` runs on K2's split of the steps (``csrc/ring_map_relu.cu``
says why).  Both fill their rings from a filling warp on mbarriers, whose
256 bytes (R1: and its warp sums' 64) sit beside the ring.  On the CPU, at
small sizes and on inputs from a numpy seed:

* **the split** — :func:`hopper.ring_run_steps` for R1 is a pure function
  of the geometry, the ring, the dtype and the SM count; it walks whole
  K1 runs, in order, each in one CTA; at 132 SMs it is one wave on the dot
  cell (2**26 elements) at depths 3, 4 and 8 in f32 and bf16;
* **the plain ring under the kernels' runs** — R1's (a ring across K1's
  run boundaries) and R2's (K2's runs) — gives the depth-2 result, to the
  bit, and the reference's sync output (Pallas interpret mode) within the
  registry ``tol`` (relu to the bit);
* **one budget** — R1 keeps its barriers and warp sums, R2 its barriers,
  beside the ring; every depth from 2 to 8 is taken on the cells, and a
  ring over a CTA's shared memory is refused naming those bytes.

The card's checks (R1 = K1 and R2 = K2 to the bit) are in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.lowering import DEFAULT_SCHEDULE as REF_DEFAULT
from repro.kernels import registry as jregistry

import repro_torch
from repro_torch.core import autotune, compiler, hopper, lowering
from repro_torch.core.lowering import DEFAULT_SCHEDULE, Schedule
from repro_torch.kernels import reduction, relu

CELL = 1 << 26      # chip_smoke.py's dot and relu cells
SMS = 132           # an H100's SMs
DEPTHS = [3, 4, 8, (2, 4), (4, 2)]


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


def _kernel(nest, body, mode, depth, dtype=torch.float32, **kw):
    """The pipelined kernel a schedule of ``depth`` builds (no operands)."""
    return autotune._candidate_kernel(nest, _sched(depth, **kw), body, mode,
                                      dtype)


def _dot_kernel(n, depth, dtype=torch.float32, **kw):
    return _kernel(compiler.dot_product_nest(n), reduction.MUL, "reduce",
                   depth, **kw)


def _relu_kernel(n, depth, dtype=torch.float32, **kw):
    return _kernel(compiler.elementwise_nest(n), relu.RELU, "map", depth,
                   dtype, **kw)


def _r1_run(kern, dtype, sms):
    return hopper.ring_run_steps("ring_reduce_mul", kern.geometry, kern.ring,
                                 dtype, sms)


# -- the split -----------------------------------------------------------------


@pytest.mark.parametrize("sms", [1, 2, 7, SMS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("depth", DEPTHS, ids=str)
def test_r1_split_is_a_pure_function_of_geometry_ring_dtype_and_sms(
        depth, dtype, sms):
    """The same inputs give the same split, built anew or not, whatever was
    asked before; only the geometry, the ring, the dtype and the SM count
    enter."""
    kern = _dot_kernel(CELL, depth)
    run = _r1_run(kern, dtype, sms)
    _r1_run(_dot_kernel(5000, 3), torch.bfloat16, 1)
    again = _dot_kernel(CELL, depth)
    assert _r1_run(again, dtype, sms) == _r1_run(kern, dtype, sms) == run
    assert 1 <= run <= kern.geometry.steps


@pytest.mark.parametrize("sms", [1, 2, 7, SMS])
@pytest.mark.parametrize("n", [13 * 1024, 5000, (1 << 20) + 3, CELL])
@pytest.mark.parametrize("depth", [3, 4, 8], ids=str)
def test_r1_walks_k1_runs_in_order_one_partial_each(depth, n, sms):
    """R1's CTAs walk K1's split (``_ctas``' runs, ``REDUCE_PER_SM`` CTAs an
    SM), whole runs in order: each K1 run lies in one CTA's steps, the
    CTAs' steps tile the grid, and there is one partial a K1 run."""
    kern = _dot_kernel(n, depth)
    steps = kern.geometry.steps
    runs, per = hopper._k_split(steps, hopper.REDUCE_PER_SM * sms)
    run = _r1_run(kern, torch.float32, sms)
    assert run % per == 0
    spans = [(s, min(s + run, steps)) for s in range(0, steps, run)]
    k1 = [(r * per, min((r + 1) * per, steps)) for r in range(runs)]
    walked = [k for a, b in spans for k in k1 if a <= k[0] and k[1] <= b]
    assert walked == k1                       # in order, each in one CTA
    assert spans[-1][1] == steps and len(walked) == runs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("depth", [3, 4, 8], ids=str)
def test_r1_is_one_wave_of_persistent_ctas_on_the_dot_cell(depth, dtype):
    """At 132 SMs R1 launches no more CTAs than fit the SMs beside their
    rings, barriers and warp sums (at most its build's 5 an SM), and its
    CTAs walk several of K1's runs, so a ring crosses run boundaries; no
    split of fewer runs a CTA would leave the busiest SM fewer runs."""
    kern = _dot_kernel(CELL, depth)
    geo = kern.geometry
    dr = hopper.device_ring("ring_reduce_mul", geo, kern.ring, dtype)
    smem = dr.ring_bytes + hopper._staged_bytes("ring_reduce_mul", (), geo)
    per_sm = hopper._ctas_per_sm(smem, hopper._RING_PER_SM["ring_reduce_mul"])
    runs, per = hopper._k_split(geo.steps, hopper.REDUCE_PER_SM * SMS)
    k = _r1_run(kern, dtype, SMS) // per
    ctas = -(-runs // k)
    assert ctas <= per_sm * SMS and k > 1

    def busiest(k_):
        return -(-(-(-runs // k_)) // SMS) * k_
    assert all(busiest(k) <= busiest(j) for j in range(1, k)
               if -(-runs // j) <= per_sm * SMS)


# -- the plain ring under the kernels' runs -------------------------------------


def _f32(rng, n):
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("sms", [1, 2, SMS])
@pytest.mark.parametrize("depth", DEPTHS, ids=str)
def test_plain_ring_under_r1_runs_is_the_depth_2_result(depth, sms):
    """On 13 (8, 128) blocks the plain ring under R1's runs — one CTA of
    several K1 runs on one SM, runs of one step on two — sums to the
    depth-2 plain version's bits and to the reference's sync dot within
    the registry tol."""
    rng = np.random.default_rng(11)
    n = 13 * 1024
    x, y = _f32(rng, n), _f32(rng, n)
    call = lowering.prepare_call(compiler.dot_product_nest(n), reduction.MUL,
                                 {"A": x, "B": y}, schedule=_sched(depth))
    kern = call.kernel
    assert kern.pipelined and kern.geometry.steps == 13
    run = _r1_run(kern, torch.float32, sms)
    got, log = hopper.plain_ring(kern.body, kern.geometry, call.layouts,
                                 kern.out_dtype, kern.acc_dtype, mode="reduce",
                                 ring=kern.ring, steps_per_cta=run)
    want = lowering.prepare_call(compiler.dot_product_nest(n), reduction.MUL,
                                 {"A": x, "B": y},
                                 schedule=DEFAULT_SCHEDULE).run()
    assert torch.equal(got.reshape(want.shape), want)
    for i in range(2):      # every block delivered once a stream
        assert sorted(s for j, s, _ in log if j == i) == list(range(13))
    ref = jregistry.get("reduction").ssr(
        jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), schedule=REF_DEFAULT)
    np.testing.assert_allclose(got.reshape(()).numpy(), np.asarray(ref),
                               **jregistry.get("reduction").tol)


@pytest.mark.parametrize("sms", [1, 2, SMS])
@pytest.mark.parametrize("depth", [3, 4, 8, (5,)], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_plain_ring_under_r2_runs_is_k2_bit_for_bit(dtype, depth, sms):
    """relu on 41 (8, 128) blocks through the ring under K2's runs gives
    the depth-2 bits and the reference's: ±0, NaN, ±inf and int32 above
    2**24 included."""
    rng = np.random.default_rng(5)
    n = 41 * 1024
    if dtype == "int32":
        xn = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int64
                          ).astype(np.int32)
        xn[:4] = [(1 << 24) + 1, -(1 << 24) - 1, (1 << 31) - 1, -(1 << 31)]
    else:
        xn = rng.standard_normal(n).astype(np.float32)
        xn[:6] = [-0.0, 0.0, np.nan, -np.inf, np.inf, -np.nan]
    x, jx = torch.from_numpy(xn), jnp.asarray(xn)
    if dtype == "bfloat16":
        x, jx = x.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    call = lowering.prepare_call(compiler.elementwise_nest(n), relu.RELU,
                                 {"X": x}, mode="map", out_dtype=x.dtype,
                                 schedule=_sched(depth))
    kern = call.kernel
    assert kern.pipelined and kern.geometry.steps == 41
    _, per = hopper._k_split(41, 64 * sms)
    got, _ = hopper.plain_ring(kern.body, kern.geometry, call.layouts,
                               kern.out_dtype, mode="map", ring=kern.ring,
                               steps_per_cta=per)
    got = call.finish(got)
    want = relu.ssr_relu(x, schedule=DEFAULT_SCHEDULE)
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    ref = jregistry.get("relu").ssr(jx, schedule=REF_DEFAULT)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(
            got.to(torch.float32).numpy(),
            np.asarray(ref.astype(jnp.float32)).astype(np.float32))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- one budget ------------------------------------------------------------------


def test_r1_and_r2_keep_their_barriers_beside_the_ring():
    geo = _dot_kernel(5000, 4).geometry
    assert hopper._staged_bytes("ring_reduce_mul", ("mul",), geo) == \
        hopper.RING_BARRIER_BYTES + hopper.STAGE_SUM_BYTES == 256 + 64
    geo = _relu_kernel(5000, 4).geometry
    assert hopper._staged_bytes("ring_map_relu", ("relu",), geo) == \
        hopper.RING_BARRIER_BYTES == 256


@pytest.mark.parametrize("depth", range(2, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["dot", "relu"])
def test_every_depth_from_2_to_8_is_taken_on_the_cells(kind, dtype, depth):
    kern = (_dot_kernel if kind == "dot" else _relu_kernel)(CELL, depth,
                                                            dtype)
    takes, why = hopper.accepts(kern.device_key, kern.geometry, dtype, "cpu",
                                **kern.device_args())
    assert takes, why
    assert kern.pipelined is (depth > 2)


@pytest.mark.parametrize("kind", ["dot", "relu"])
def test_a_ring_over_the_budget_is_refused_naming_its_barriers(kind):
    """(16, 512) blocks of f32 at depth 8 are over a CTA's shared memory; the
    refusal counts the ring and the bytes beside it, and names them."""
    rname, what, staged = {
        "dot": ("ring_reduce_mul", "its slots' barriers and warp sums", 320),
        "relu": ("ring_map_relu", "its slots' barriers", 256)}[kind]
    make = _dot_kernel if kind == "dot" else _relu_kernel
    fits = make(1 << 16, 3, rows=16, lanes=512)
    assert hopper.accepts(fits.device_key, fits.geometry, torch.float32,
                          "cpu", **fits.device_args())[0]
    kern = make(1 << 16, 8, rows=16, lanes=512)
    takes, why = hopper.accepts(kern.device_key, kern.geometry, torch.float32,
                                "cpu", **kern.device_args())
    need = hopper.device_ring(rname, kern.geometry, kern.ring,
                              torch.float32).ring_bytes + staged
    assert not takes
    assert why == (f"{rname}: its ring at depths {kern.depths} needs {need} "
                   f"bytes of shared memory a CTA ({staged} of them {what}), "
                   f"the card allows {hopper.SMEM_OPTIN_BYTES}")
