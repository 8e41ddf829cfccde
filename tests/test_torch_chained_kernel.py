"""The port's ChainedKernel against the JAX package's.

``repro.kernels.frontend.ChainedKernel`` and its port run the same Launch
(the same grid, block streams and output shape) with the reference's bodies
on one side and the port's tagged bodies on the other: ``axpy_relu``
(relu(α·x + y) on a flat (rows, 128) Launch, n = 4096 and an odd 5000),
``scale_relu`` (relu(x·w) on a 2-D grid whose w stream is one invariant
block) and ``sq_diff_identity``.  Inputs come from a numpy seed; the
reference runs in Pallas interpret mode.  Each instance runs at the default
schedule and at ``buffer_depth`` 3, 4 and 8 (the port's plain version then
takes its blocks through the stage ring), in f32 and bf16, and must agree to
the bit.

bf16 with α = 0.3: the reference hands the producer the stored bf16 blocks,
and jnp rounds the weakly typed α to bf16 (0.30078125) and each operation to
bf16; the port does the same.  f32 with α = 0.3: XLA on the CPU contracts
α·x + y into one FMA, while the port rounds the product and the sum as
PyTorch does (K17 likewise, ``__fmul_rn``/``__fadd_rn``): the two differ by
the product's rounding, which a test pins (ROADMAP Queue C); the f32 parity
runs at α = 0.5, where the product is exact.

The contract's errors raise as the reference's do: two output streams, a
missing waiver, a depth of 1 or 9; an untagged producer has no Hopper
kernel (a LoweringError from the lookup); a ring over the shared memory a
CTA may opt into is refused by ``accepts`` with R5's name.  The waivered
kernels of both packages are the same set.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core.lowering import Schedule as JSchedule
from repro.core.ssr import BlockStream as JBlockStream
from repro.core.stream import Direction as JDirection
from repro.kernels import chained as jchained
from repro.kernels import frontend as jfrontend
from repro.kernels import relu as jrelu
from repro.kernels.registry import _KERNEL_MODULES as J_KERNEL_MODULES

import repro_torch
from repro_torch.core import agu, hopper
from repro_torch.core.lowering import Schedule
from repro_torch.core.ssr import BlockStream, KernelBody, LoweringError
from repro_torch.core.stream import Direction
from repro_torch.kernels import chained, frontend, relu
from repro_torch.kernels.registry import _KERNEL_MODULES

DEPTHS = [2, 3, 4, 8]
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.delenv("REPRO_DISABLE_PIPELINE", raising=False)
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


# -- the instances, the same Launch in both packages -------------------------
#
# ``launch(static, *arrays)`` is written once against a package's own
# BlockStream, Direction and out-shape type; each instance names its bodies
# in both packages.


def _flat_launch(stream, direction, shape_dtype):
    """(rows, 128) layouts walked in (8, 128) blocks, one a step."""
    def launch(static, *arrays):
        rows = arrays[0].shape[0]
        return dict(
            grid=(rows // 8,),
            in_streams=tuple(stream((8, 128), lambda i: (i, 0))
                             for _ in arrays),
            out_streams=(stream((8, 128), lambda i: (i, 0),
                                direction.WRITE),),
            out_shapes=(shape_dtype(tuple(arrays[0].shape),
                                    arrays[0].dtype),),
            dimension_semantics=("arbitrary",))
    return launch


def _scale_launch(stream, direction, shape_dtype):
    """x (r, c) in (8, 512) blocks on an (r/8, c/512) grid, w one (8, 512)
    block at every step (the repeat register)."""
    def launch(static, x, w):
        r, c = x.shape
        return dict(
            grid=(r // 8, c // 512),
            in_streams=(stream((8, 512), lambda i, j: (i, j)),
                        stream((8, 512), lambda i, j: (0, 0))),
            out_streams=(stream((8, 512), lambda i, j: (i, j),
                                direction.WRITE),),
            out_shapes=(shape_dtype(tuple(x.shape), x.dtype),),
            dimension_semantics=("parallel", "parallel"))
    return launch


def _ref_kernel(name, launch, producer, consumer, flat):
    lc = launch(JBlockStream, JDirection, jax.ShapeDtypeStruct)

    def prepare(*xs):
        if flat:
            return tuple(jfrontend.pad_vector(x) for x in xs), None, \
                xs[0].shape[0]
        return xs, None, None

    return jfrontend.ChainedKernel(
        name, prepare=prepare,
        launch=lambda static, *a: jfrontend.Launch(**lc(static, *a)),
        producer=lambda static: producer, consumer=lambda static: consumer,
        finish=(lambda out, n: jfrontend.trim_vector(out, n)) if flat
        else None, lowering_waiver="a test instance")


def _port_kernel(name, launch, producer, consumer, flat):
    lc = launch(BlockStream, Direction, frontend.ShapeDtype)

    def prepare(*xs):
        if flat:
            return tuple(frontend.pad_vector(x) for x in xs), None, \
                xs[0].shape[0]
        return xs, None, None

    return frontend.ChainedKernel(
        name, prepare=prepare,
        launch=lambda static, *a: frontend.Launch(**lc(static, *a)),
        producer=lambda static: producer, consumer=lambda static: consumer,
        finish=(lambda out, n: frontend.trim_vector(out, n)) if flat
        else None, lowering_waiver="a test instance")


def _instance(name, alpha=0.5):
    """(reference kernel, port kernel) of a named instance."""
    if name == "axpy_relu":
        bodies = ((jchained._axpy_block(alpha), jrelu.relu_block),
                  (chained.axpy_block(alpha), relu.RELU), _flat_launch, True)
    elif name == "scale_relu":
        bodies = ((jchained._dot_block, jrelu.relu_block),
                  (chained.DOT, relu.RELU), _scale_launch, False)
    else:
        bodies = ((jchained._sq_diff_block, jchained._identity_block),
                  (chained.SQ_DIFF, chained.IDENTITY), _flat_launch, True)
    (jp, jc), (p, c), launch, flat = bodies
    return (_ref_kernel(name, launch, jp, jc, flat),
            _port_kernel(name, launch, p, c, flat))


def _inputs(name, n, dtype, seed=0):
    """The instance's inputs, drawn in f32 with numpy and cast to ``dtype``:
    (port tensors, reference arrays), holding the same bits."""
    rng = np.random.default_rng(seed)
    shapes = [(64, 2048), (8, 512)] if name == "scale_relu" else [(n,), (n,)]
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ts = [torch.from_numpy(x).to(dtype) for x in xs]
    js = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32) for t in ts]
    return ts, js


def _ref_out(kernel, js, depth):
    out = kernel(*js) if depth == 2 else \
        kernel(*js, schedule=JSchedule(buffer_depth=depth))
    return torch.from_numpy(np.asarray(out.astype(jnp.float32)))


CASES = [("axpy_relu", 4096), ("axpy_relu", 5000), ("scale_relu", None),
         ("sq_diff_identity", 4096)]


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name, n", CASES,
                         ids=[f"{c}_{n}" if n else c for c, n in CASES])
def test_port_equals_the_reference_to_the_bit(name, n, dtype, depth):
    alpha = 0.3 if dtype == torch.bfloat16 else 0.5
    ref, port = _instance(name, alpha)
    ts, js = _inputs(name, n, dtype)
    sched = None if depth == 2 else Schedule(buffer_depth=depth)
    got = port(*ts, schedule=sched)
    parts = port.parts(*ts, schedule=sched)
    assert (parts.ring is not None) == (depth > 2)
    want = _ref_out(ref, js, depth)
    assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
    assert torch.equal(got.float(), want)
    # the ring delivers the depth-2 blocks: the same bits
    assert torch.equal(got.view(BITS[dtype]),
                       port(*ts).view(BITS[dtype]))


def test_bf16_rounds_alpha_and_every_operation_as_the_reference():
    """α = 0.3 becomes 0.30078125 in bf16; each operation rounds to bf16.
    A Python-scalar α (PyTorch keeps it in f32) would differ."""
    ts, js = _inputs("axpy_relu", 4096, torch.bfloat16, seed=3)
    ref, port = _instance("axpy_relu", 0.3)
    got = port(*ts)
    x, y = ts
    want = torch.relu(torch.tensor(0.3, dtype=torch.bfloat16) * x + y)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(got.float(), _ref_out(ref, js, 2))
    scalar = torch.relu(0.3 * x + y)
    assert not torch.equal(got.view(torch.int16), scalar.view(torch.int16))


@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("n", [4096, 5000])
def test_f32_axpy_differs_from_xla_fma_by_the_products_rounding(n, depth):
    """XLA on the CPU contracts α·x + y into an FMA; the port rounds the
    product and the sum as PyTorch does (ROADMAP Queue C): the two differ
    by at most an ulp of the product and an ulp of the sum."""
    ts, js = _inputs("axpy_relu", n, torch.float32, seed=1)
    ref, port = _instance("axpy_relu", 0.3)
    sched = None if depth == 2 else Schedule(buffer_depth=depth)
    got = port(*ts, schedule=sched)
    x, y = ts
    rounded = torch.tensor(0.3) * x + y          # PyTorch's two roundings
    assert torch.equal(got, torch.relu(rounded))
    want = _ref_out(ref, js, depth)
    fused = (float(np.float32(0.3)) * x.double() + y.double()).float()
    assert torch.equal(want, torch.relu(fused))
    def ulp(t):
        return torch.nextafter(t.abs(), torch.tensor(np.inf)) - t.abs()

    product = torch.tensor(0.3) * x
    assert bool(((rounded - fused).abs() <= ulp(product) + ulp(fused)).all())
    assert not torch.equal(got, want)


# -- the ring's delivery, and the CPU path -----------------------------------


def test_invariant_stream_rides_the_ring_once():
    ref, port = _instance("scale_relu")
    ts, _ = _inputs("scale_relu", None, torch.float32)
    parts = port.parts(*ts, schedule=Schedule(buffer_depth=4))
    assert parts.ring == agu.RingProgram((4, 4), (False, True))
    geo = hopper.chained_geometry(parts.launch)
    _, log = hopper.ring_delivery(geo, parts.arrays, parts.ring)
    assert [e for e in log if e[0] == 1] == [(1, 0, 0)]
    assert sorted(s for i, s, _ in log if i == 0) == list(range(geo.steps))
    # the kernel gives the invariant stream one slot
    dr = hopper.device_ring("ring_chained_map", geo, parts.ring,
                            torch.float32)
    assert dr.depths == (4, 1) and dr.ring_bytes == 5 * 8 * 512 * 4


def test_stream_depths_are_not_read_and_one_step_never_stages():
    ref, port = _instance("axpy_relu")
    ts, _ = _inputs("axpy_relu", 1024, torch.float32)
    parts = port.parts(*ts, schedule=Schedule(stream_depths=(4, 4)))
    assert parts.ring is None
    one = port.parts(*ts, schedule=Schedule(buffer_depth=8))
    assert hopper.chained_geometry(one.launch).steps == 1
    assert one.ring is None


def test_disable_pipeline_keeps_it_sync(monkeypatch):
    ref, port = _instance("axpy_relu")
    ts, _ = _inputs("axpy_relu", 4096, torch.float32)
    deep = port(*ts, schedule=Schedule(buffer_depth=4))
    monkeypatch.setenv("REPRO_DISABLE_PIPELINE", "1")
    port2 = _instance("axpy_relu")[1]
    assert port2.parts(*ts, schedule=Schedule(buffer_depth=4)).ring is None
    assert torch.equal(port2(*ts, schedule=Schedule(buffer_depth=4)), deep)


def test_scratch_is_accepted_and_never_handed_to_the_bodies():
    seen = []

    def producer(a, b):
        seen.append(2)
        return a * b

    lc = _flat_launch(BlockStream, Direction, frontend.ShapeDtype)
    port = frontend.ChainedKernel(
        "k", prepare=lambda x, y: ((frontend.pad_vector(x),
                                    frontend.pad_vector(y)), None, x.shape[0]),
        launch=lambda s, *a: frontend.Launch(
            **lc(s, *a), scratch_shapes=(frontend.ShapeDtype(
                (8, 128), torch.float32),)),
        producer=lambda s: producer, consumer=lambda s: relu.relu_block,
        finish=lambda out, n: frontend.trim_vector(out, n),
        lowering_waiver="a test instance")
    x, y = torch.randn(3000), torch.randn(3000)
    assert torch.equal(port(x, y), torch.relu(x * y))
    assert seen


def test_intermediate_is_cast_to_the_output_dtype_before_the_consumer():
    """An f32 producer value into a bf16 output: rounded to bf16 before the
    consumer sees it, as the reference's scratch block is."""
    lc = _flat_launch(BlockStream, Direction, frontend.ShapeDtype)
    jlc = _flat_launch(JBlockStream, JDirection, jax.ShapeDtypeStruct)
    consumed = []

    def consumer(t):
        consumed.append(t.dtype)
        return t * 3

    def launch(static, *a):
        d = lc(static, *a)
        d["out_shapes"] = (frontend.ShapeDtype(tuple(a[0].shape),
                                               torch.bfloat16),)
        return frontend.Launch(**d)

    def jlaunch(static, *a):
        d = jlc(static, *a)
        d["out_shapes"] = (jax.ShapeDtypeStruct(a[0].shape, jnp.bfloat16),)
        return jfrontend.Launch(**d)

    x = np.random.default_rng(4).standard_normal(2048).astype(np.float32)
    port = frontend.ChainedKernel(
        "k", prepare=lambda v: ((frontend.pad_vector(v),), None, None),
        launch=launch, producer=lambda s: chained.IDENTITY,
        consumer=lambda s: consumer, lowering_waiver="a test instance")
    ref = jfrontend.ChainedKernel(
        "k", prepare=lambda v: ((jfrontend.pad_vector(v),), None, None),
        launch=jlaunch, producer=lambda s: jchained._identity_block,
        consumer=lambda s: lambda t: t * 3, lowering_waiver="a test instance")
    got = port(torch.from_numpy(x))
    want = np.asarray(ref(jnp.asarray(x)).astype(jnp.float32))
    assert consumed and set(consumed) == {torch.bfloat16}
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy().reshape(want.shape),
                                  want)


# -- the errors, as the reference raises them --------------------------------


def _raise_message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_two_output_streams_raise_the_reference_message():
    def launch(stream, direction, shape_dtype, wrap):
        def lc(static, x):
            out = stream((8, 128), lambda i: (i, 0), direction.WRITE)
            return wrap(grid=(x.shape[0] // 8,),
                        in_streams=(stream((8, 128), lambda i: (i, 0)),),
                        out_streams=(out, out),
                        out_shapes=(shape_dtype(tuple(x.shape), x.dtype),) * 2)
        return lc

    port = frontend.ChainedKernel(
        "two", prepare=lambda x: ((x,), None, None),
        launch=launch(BlockStream, Direction, frontend.ShapeDtype,
                      frontend.Launch),
        producer=lambda s: chained.IDENTITY, consumer=lambda s: relu.RELU,
        lowering_waiver="w")
    ref = jfrontend.ChainedKernel(
        "two", prepare=lambda x: ((x,), None, None),
        launch=launch(JBlockStream, JDirection, jax.ShapeDtypeStruct,
                      jfrontend.Launch),
        producer=lambda s: jchained._identity_block,
        consumer=lambda s: jrelu.relu_block, lowering_waiver="w")
    got = _raise_message(lambda: port(torch.zeros(16, 128)))
    want = _raise_message(lambda: ref(jnp.zeros((16, 128))))
    assert got == want and "exactly one output stream" in got


@pytest.mark.parametrize("waiver", [None, "", "   "])
def test_missing_waiver_raises_the_reference_message(waiver):
    kw = dict(prepare=None, launch=None, producer=None, consumer=None,
              lowering_waiver=waiver)
    got = _raise_message(lambda: frontend.ChainedKernel("k", **kw))
    want = _raise_message(lambda: jfrontend.ChainedKernel("k", **kw))
    assert got == want


@pytest.mark.parametrize("depth", [1, 9])
def test_depth_out_of_bounds_raises_the_reference_message(depth):
    ref, port = _instance("axpy_relu")
    ts, js = _inputs("axpy_relu", 4096, torch.float32)
    got = _raise_message(lambda: port(*ts,
                                      schedule=Schedule(buffer_depth=depth)))
    want = _raise_message(lambda: ref(
        *js, schedule=JSchedule(buffer_depth=depth)))
    assert got == want


@pytest.mark.parametrize("producer, consumer", [
    (KernelBody(lambda a, b: a + b, "add"), relu.RELU),
    (lambda a, b: a * b, relu.RELU),
    (chained.DOT, lambda t: t),
    (chained.DOT, chained.SQ_DIFF),
])
def test_a_pair_without_a_kernel_raises_on_the_lookup(producer, consumer):
    with pytest.raises(LoweringError, match="no Hopper chained kernel"):
        frontend.chained_kernel(producer, consumer)


def test_untagged_producer_runs_on_the_cpu_only():
    lc = _flat_launch(BlockStream, Direction, frontend.ShapeDtype)
    port = frontend.ChainedKernel(
        "k", prepare=lambda x, y: ((frontend.pad_vector(x),
                                    frontend.pad_vector(y)), None, None),
        launch=lambda s, *a: frontend.Launch(**lc(s, *a)),
        producer=lambda s: (lambda a, b: a - b),
        consumer=lambda s: relu.RELU, lowering_waiver="w")
    x, y = torch.randn(1024), torch.randn(1024)
    assert torch.equal(port(x, y).reshape(-1), torch.relu(x - y))
    parts = port.parts(x, y)
    with pytest.raises(LoweringError, match="no Hopper chained kernel"):
        frontend.chained_kernel(parts.producer, parts.consumer)


def test_accepts_refuses_a_ring_over_the_budget_with_r5s_name():
    """(64, 512) f32 blocks: 128 KiB a slot, so a depth-3 ring of two
    streams needs 768 KiB; (8, 128) blocks fit at depth 8."""
    def launch(rows, lanes, n_rows):
        return frontend.Launch(
            grid=(n_rows // rows,),
            in_streams=tuple(BlockStream((rows, lanes), lambda i: (i, 0))
                             for _ in range(2)),
            out_streams=(BlockStream((rows, lanes), lambda i: (i, 0),
                                     Direction.WRITE),),
            out_shapes=(frontend.ShapeDtype((n_rows, lanes),
                                            torch.float32),))

    key = ("chained", ("axpy", "relu"))
    for (rows, lanes), depth, fits in (((64, 512), 3, False),
                                       ((8, 128), 8, True)):
        geo = hopper.chained_geometry(launch(rows, lanes, 4 * rows))
        ring = agu.RingProgram((depth, depth), (False, False))
        takes, why = hopper.accepts(key, geo, torch.float32, "cpu", ring=ring)
        assert takes is fits, why
        if not fits:
            assert why.startswith("ring_chained_map:")
            assert str(hopper.SMEM_OPTIN_BYTES) in why
        assert hopper.accepts(key, geo, torch.float32, "cpu")[0]
    # the sync kernel's own refusals name K17
    geo = hopper.chained_geometry(launch(8, 128, 32))
    takes, why = hopper.accepts(key, geo, torch.int32, "cpu")
    assert not takes and why.startswith("chained_map:")
    takes, why = hopper.accepts(("chained", ("relu", "relu")), geo,
                                torch.float32, "cpu")
    assert not takes and "takes 1 streams" in why


def test_every_tagged_pair_is_a_program_with_a_ring():
    assert set(hopper.CHAINED_PROGRAMS) == {
        (p, c) for p in ("identity", "relu", "sq_diff", "axpy", "mul")
        for c in ("identity", "relu")}
    assert sorted(hopper.CHAINED_PROGRAMS.values()) == list(range(10))
    for pair in hopper.CHAINED_PROGRAMS:
        assert hopper.RING_KERNELS[("chained", pair)] == "ring_chained_map"
    # the port's tagged bodies are the producers and consumers
    for body in (chained.SQ_DIFF, chained.IDENTITY, chained.axpy_block(0.3),
                 chained.DOT, relu.RELU):
        assert body.op in hopper.CHAINED_PRODUCERS
    assert {relu.RELU.op, chained.IDENTITY.op} == set(
        hopper.CHAINED_CONSUMERS)


# -- the one-path-to-silicon contract ----------------------------------------


def _holdouts(package, modules, frontend_mod):
    found = {}
    for modname in modules:
        mod = importlib.import_module(f"{package}.kernels.{modname}")
        for attr in vars(mod).values():
            if isinstance(attr, (frontend_mod.StreamKernel,
                                 frontend_mod.ChainedKernel)):
                found[attr.name] = attr.lowering_waiver
    return found


def test_waivered_kernels_are_the_references():
    """Every StreamKernel or ChainedKernel of a kernel module states its
    waiver, and the port's waivered kernels are the reference's."""
    port = _holdouts("repro_torch", _KERNEL_MODULES, frontend)
    ref = _holdouts("repro", J_KERNEL_MODULES, jfrontend)
    assert set(port) == set(ref) == {"scan", "fft", "bitonic"}
    for name, waiver in port.items():
        assert waiver.strip() and waiver == ref[name]
