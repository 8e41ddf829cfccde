"""The Hopper kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device.  This file
imports neither JAX nor ``repro``, so it runs on a GPU machine without
them; ``--noconftest`` skips the repo's JAX test settings::

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import compiler, hopper, lowering, resilience
from repro_torch.core.ssr import LoweringError
from repro_torch.kernels import (frontend, gemm, gemv, ops, reduction,
                                 registry, relu)

pytestmark = pytest.mark.cuda

# max |kernel - plain| over the scale below: sound f32 kernels read under
# 5e-7, a kernel that rounds its inputs to TF32 about 1e-5 and more
# (chip_smoke.py's CONTRACT_LIMIT and DOT_LIMIT)
CONTRACT_LIMIT = 5e-6
DOT_LIMIT = 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_and_plain(call):
    kern = call.kernel
    before = dict(hopper.LAUNCHES)
    got = call.run()
    torch.cuda.synchronize()
    launched = {k for k, v in hopper.LAUNCHES.items() if v != before[k]}
    want = call.finish(hopper.PLAIN[kern.mode](
        kern.body, kern.geometry, call.layouts, kern.out_dtype,
        kern.acc_dtype))
    return got, want, launched


@pytest.mark.parametrize("n", [1, 1000, 5000, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_mul(dev, n, dtype):
    g = torch.Generator(device=dev).manual_seed(n)
    # non-negative inputs: Σ|x·y| is the dot itself, so the limit sees a
    # dropped or doubled grid step
    x = torch.rand(n, generator=g, device=dev).to(dtype)
    y = torch.rand(n, generator=g, device=dev).to(dtype)
    call = lowering.prepare_call(compiler.dot_product_nest(n), reduction.MUL,
                                 {"A": x, "B": y}, device=dev)
    got, want, launched = _kernel_and_plain(call)
    assert launched == {"reduce_mul"}
    scale = float((x.float() * y.float()).abs().sum())
    assert abs(float(got) - float(want)) <= DOT_LIMIT * scale


@pytest.mark.parametrize("n", [7, 1025, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_map_relu_bit_exact(dev, n, dtype):
    g = torch.Generator(device=dev).manual_seed(n)
    if dtype == torch.int32:
        x = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g,
                          device=dev, dtype=dtype)
    else:
        x = torch.randn(n, generator=g, device=dev).to(dtype)
        x[:3] = torch.tensor([-0.0, float("nan"), float("-inf")])
    got = ops.relu(x, ssr=True, device=dev)
    call = lowering.prepare_call(compiler.elementwise_nest(n), relu.RELU,
                                 {"X": x}, mode="map", out_dtype=dtype,
                                 device=dev)
    _, want, launched = _kernel_and_plain(call)
    assert launched == {"map_relu"}
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int8) if dtype != torch.int32 else got,
                       want.view(torch.int8) if dtype != torch.int32
                       else want)


@pytest.mark.parametrize("mnk", [(100, 130, 70), (300, 260, 1100),
                                 (1, 2, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contract_gemm(dev, mnk, dtype):
    m, n, k = mnk
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    a = torch.randn(m, k, generator=g, device=dev).to(dtype)
    b = torch.randn(k, n, generator=g, device=dev).to(dtype)
    for sched in (lowering.DEFAULT_SCHEDULE,
                  lowering.Schedule(lanes_tile_factor=1, rows_tile_factor=2),
                  lowering.Schedule(axis_order=(1, 0, 2))):
        call = lowering.prepare_call(compiler.gemm_nest(m, n, k), gemm.DOT,
                                     {"A": a, "B": b}, schedule=sched,
                                     device=dev)
        got, want, launched = _kernel_and_plain(call)
        assert launched == {"contract_gemm"}
        scale = a.float().abs() @ b.float().abs()
        rel = (got - want).abs() / (scale + 1e-30)
        assert float(rel.max()) <= CONTRACT_LIMIT


@pytest.mark.parametrize("mn", [(60, 64), (1000, 1536), (3, 5000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contract_gemv(dev, mn, dtype):
    m, n = mn
    g = torch.Generator(device=dev).manual_seed(m * n)
    a = torch.randn(m, n, generator=g, device=dev).to(dtype)
    x = torch.randn(n, generator=g, device=dev).to(dtype)
    call = lowering.prepare_call(compiler.gemv_nest(m, n), gemv.MATVEC,
                                 {"A": a, "x": x}, device=dev)
    got, want, launched = _kernel_and_plain(call)
    assert launched == {"contract_gemv"}
    scale = a.float().abs() @ x.float().abs()
    rel = (got - want).abs() / (scale + 1e-30)
    assert float(rel.max()) <= CONTRACT_LIMIT


def test_untagged_body_raises_on_the_card(dev):
    x = torch.ones(64, device=dev)
    with pytest.raises(LoweringError, match="no Hopper kernel"):
        lowering.ssr_call(compiler.dot_product_nest(64), lambda a, b: a * b,
                          {"A": x, "B": x}, device=dev)


def test_unsupported_dtype_raises_on_the_card(dev):
    x = torch.ones(64, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        ops.dot(x, x, ssr=True, device=dev)


# -- the four baseline kernels (B1–B4) ---------------------------------------


def _launched(before):
    torch.cuda.synchronize()
    return {k for k, v in hopper.LAUNCHES.items() if v != before[k]}


@pytest.mark.parametrize("n", [1, 1000, 5000, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_base_reduce(dev, n, dtype):
    g = torch.Generator(device=dev).manual_seed(n + 1)
    x = torch.rand(n, generator=g, device=dev).to(dtype)
    y = torch.rand(n, generator=g, device=dev).to(dtype)
    before = dict(hopper.LAUNCHES)
    got = reduction.baseline_dot(x, y, device=dev)
    assert _launched(before) == {"base_reduce"}
    want = hopper.plain_base_reduce(frontend.pad_vector(x),
                                    frontend.pad_vector(y))[0, 0]
    scale = float((x.float() * y.float()).abs().sum())
    assert abs(float(got) - float(want)) <= DOT_LIMIT * scale
    streamed = ops.dot(x, y, ssr=True, device=dev)
    assert abs(float(got) - float(streamed)) <= DOT_LIMIT * scale


@pytest.mark.parametrize("n", [7, 1025, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_base_relu_bit_exact(dev, n, dtype):
    g = torch.Generator(device=dev).manual_seed(n + 2)
    if dtype == torch.int32:
        x = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g,
                          device=dev, dtype=dtype)
    else:
        x = torch.randn(n, generator=g, device=dev).to(dtype)
        x[:3] = torch.tensor([-0.0, float("nan"), float("-inf")])
    before = dict(hopper.LAUNCHES)
    got = relu.baseline_relu(x, device=dev)
    assert _launched(before) == {"base_relu"}
    want = frontend.trim_vector(
        hopper.plain_base_map(relu.relu_block, frontend.pad_vector(x)), n)
    streamed = ops.relu(x, ssr=True, device=dev)
    view = (lambda t: t) if dtype == torch.int32 else \
        (lambda t: t.view(torch.int8))
    assert got.dtype == dtype
    assert torch.equal(view(got), view(want))
    assert torch.equal(view(got), view(streamed))


@pytest.mark.parametrize("mnk", [(100, 130, 70), (300, 260, 1100),
                                 (1, 2, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_base_gemm(dev, mnk, dtype):
    m, n, k = mnk
    g = torch.Generator(device=dev).manual_seed(m + n + k + 3)
    a = torch.randn(m, k, generator=g, device=dev).to(dtype)
    b = torch.randn(k, n, generator=g, device=dev).to(dtype)
    before = dict(hopper.LAUNCHES)
    got = gemm.baseline_matmul(a, b, out_dtype=torch.float32, device=dev)
    assert _launched(before) == {"base_gemm"}
    (pa, pb), _, _ = gemm._prepare_base(a, b)
    want = hopper.plain_base_gemm(pa, pb)
    scale = a.float().abs() @ b.float().abs() + 1e-30
    assert float(((got - want).abs() / scale).max()) <= CONTRACT_LIMIT
    streamed = ops.matmul(a, b, ssr=True, out_dtype=torch.float32,
                          device=dev)
    assert float(((got - streamed).abs() / scale).max()) <= CONTRACT_LIMIT


def test_base_gemm_drains_to_bf16(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn(130, 256, generator=g, device=dev)
    b = torch.randn(256, 70, generator=g, device=dev)
    got = gemm.baseline_matmul(a, b, out_dtype=torch.bfloat16, device=dev)
    assert got.dtype == torch.bfloat16
    want = hopper.plain_base_gemm(a, b, out_dtype=torch.bfloat16)
    # the two f32 sums may round to neighbouring bf16 values: one bf16 ulp
    # of the output is at most 2**-8 of |a|·|b|
    scale = a.abs() @ b.abs()
    err = (got.float() - want.float()).abs()
    assert float((err / scale).max()) <= 2 ** -7


@pytest.mark.parametrize("mn", [(60, 64), (1000, 1536), (3, 5000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_base_gemv(dev, mn, dtype):
    m, n = mn
    g = torch.Generator(device=dev).manual_seed(m * n + 4)
    a = torch.randn(m, n, generator=g, device=dev).to(dtype)
    x = torch.randn(n, generator=g, device=dev).to(dtype)
    before = dict(hopper.LAUNCHES)
    got = gemv.baseline_gemv(a, x, device=dev)
    assert _launched(before) == {"base_gemv"}
    (pa, px), _, _ = gemv._prepare_base(a, x)
    want = hopper.plain_base_gemv(pa, px).reshape(-1)[:m]
    scale = a.float().abs() @ x.float().abs() + 1e-30
    assert float(((got - want).abs() / scale).max()) <= CONTRACT_LIMIT
    streamed = ops.gemv(a, x, ssr=True, device=dev).float()
    assert float(((got - streamed).abs() / scale).max()) <= CONTRACT_LIMIT


def test_custom_baseline_body_raises_on_the_card(dev):
    x = torch.ones(64, device=dev)
    with pytest.raises(LoweringError, match="no Hopper baseline kernel"):
        relu._base(x, lambda b: b * 2, device=dev)


@pytest.mark.parametrize("name, base", [
    ("reduction", "base_reduce"), ("relu", "base_relu"),
    ("gemm", "base_gemm"), ("gemv", "base_gemv")])
def test_baseline_fallback_runs_the_baseline_kernel(dev, name, base,
                                                    tmp_path, monkeypatch):
    """Under ``baseline_fallback=True`` an armed ``lowering`` fault falls to
    the entry's baseline kernel on the card; PyTorch's ``ref`` never runs on
    tensors that are there."""
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path))
    entry = registry.get(name)
    args, kw = entry.example(np.random.default_rng(5), odd=True)
    want = entry.ref(*args, **kw)

    def no_ref(*a, **k):
        raise AssertionError("ref ran on tensors on the card")

    monkeypatch.setitem(registry._RESOLVED, name,
                        dataclasses.replace(entry, ref=no_ref))
    lowering.clear_caches()          # the lowering seam must fire
    resilience.reset()
    before = dict(hopper.LAUNCHES)
    with resilience.inject_faults("lowering") as specs:
        got = registry.dispatch(name, *args, ssr=True, baseline_fallback=True,
                                device=dev, **kw)
    assert specs[0].fired == 1
    assert _launched(before) == {base}
    assert [e.site for e in resilience.fallback_events()] == \
        [f"registry:{name}"]
    resilience.reset()
    assert torch.allclose(got.cpu(), want, **entry.tol)


# -- the fused chains and DAGs (K5–K8) and K4's relu drain ---------------------

# map outputs of the DAG kernels: max |kernel − plain| over max(1, |plain|)
# (rsqrtf, expf and the row sums' order differ from PyTorch's by a few ulp;
# an input rounded to bf16 reads about 1e-3 and more)
MAP_LIMIT = 1e-5


def _chain_inputs(dev, n, k, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    # uniform in [0, 1): every term of the sums is non-negative, so the
    # limit relative to the sum sees a dropped or doubled grid step
    return [torch.rand(n, generator=g, device=dev) for _ in range(k)]


def _run_and_plain(call):
    before = dict(hopper.LAUNCHES)
    got = call.run()
    launched = _launched(before)
    want = call.finish(call.kernel.plain(call.layouts))
    return got, want, launched


@pytest.mark.parametrize("n", [1, 1000, 5000, 1 << 20])
def test_chain_elem_fused(dev, n):
    from repro_torch.kernels import chained
    x, y, w = _chain_inputs(dev, n, 3, n)
    for nests, bodies, ops_, scale in (
            (chained._chain_nests(n, False),
             (chained.SQ_DIFF, chained.IDENTITY), {"X": x, "Y": y},
             float(((x - y) ** 2).sum())),
            (chained._chain_nests(n, True),
             (chained.axpy_block(0.5), chained.DOT),
             {"X": x, "Y": y, "W": w},
             float(((0.5 * x + y) * w).sum()))):
        call = lowering.prepare_chain_call(nests, bodies, ops_,
                                           mode="reduce", device=dev)
        got, want, launched = _run_and_plain(call)
        assert launched == {"chain_elem"}
        assert abs(float(got) - float(want)) <= DOT_LIMIT * max(scale, 1e-30)


@pytest.mark.parametrize("n", [7, 1025, 1 << 20])
def test_chain_elem_stages(dev, n):
    from repro_torch.kernels import chained
    x, y = _chain_inputs(dev, n, 2, n + 1)
    nest2 = compiler.elementwise_nest(n, ("X", "Y"), 2)
    for body in (chained.SQ_DIFF, chained.axpy_block(-1.5)):
        call = lowering.prepare_call(nest2, body, {"X": x, "Y": y},
                                     mode="map", device=dev)
        got, want, launched = _run_and_plain(call)
        assert launched == {"chain_elem"}
        assert torch.equal(got, want)          # rounded as PyTorch rounds
    call = lowering.prepare_call(compiler.elementwise_nest(n, ("T",), 1),
                                 chained.IDENTITY, {"T": x}, device=dev)
    got, want, launched = _run_and_plain(call)
    assert launched == {"chain_elem"}
    assert abs(float(got) - float(want)) <= DOT_LIMIT * float(x.sum())


def test_axpy_alpha_is_a_kernel_argument(dev):
    from repro_torch.kernels import chained
    x, y, w = _chain_inputs(dev, 3000, 3, 9)
    a = chained.fused_axpy_dot(x, y, w, alpha=0.5, device=dev)
    b = chained.fused_axpy_dot(x, y, w, alpha=2.0, device=dev)
    for alpha, got in ((0.5, a), (2.0, b)):
        want = ((alpha * x + y) * w).sum()
        assert abs(float(got) - float(want)) <= DOT_LIMIT * float(want)


def _dag_case(name, rows, seed):
    from repro_torch.kernels import dag
    case = {c.name: c for c in dag.dag_cases()}[name]
    rng = np.random.default_rng(seed)
    if name == "layernorm":
        args = (torch.from_numpy(rng.standard_normal((rows, 128))
                                 .astype(np.float32)),)
    elif name == "softmax_xent":
        z = torch.from_numpy(rng.standard_normal((rows, 128))
                             .astype(np.float32))
        p = torch.from_numpy(np.eye(128, dtype=np.float32)[
            rng.integers(0, 128, rows)])
        args = (z, p)
    else:
        args, _ = case.example(rng)
        args = (torch.from_numpy(rng.standard_normal((rows, 128))
                                 .astype(np.float32)),) + tuple(args[1:])
    return case, args


def _abs_call(call):
    """The plain version of the same call with every input and uniform
    replaced by its absolute value: for the MLP's monotone stages the
    |a|·|b| scale of each output."""
    layouts = tuple(t.abs() for t in call.layouts)
    return call.finish(call.kernel.plain(layouts))


@pytest.mark.parametrize("rows", [37, 1000])
@pytest.mark.parametrize("name", ["layernorm", "softmax_xent", "mlp_block"])
def test_dag_every_component_of_every_legal_cut(dev, name, rows):
    """Each instantiation a legal cut can launch, on its own inputs,
    against its plain version; and each cut's result against all-fused."""
    from repro_torch.core import autotune
    case, args = _dag_case(name, rows, rows)
    args = tuple(a.to(dev) for a in args)
    nests, bodies, operands, mode, uniforms = case.spec(*args)
    dag = lowering._dag_for(nests, None)
    kernel = {"layernorm": "dag_layernorm",
              "softmax_xent": "dag_softmax_xent", "mlp_block": "dag_mlp"}[name]
    fused = None
    for cut in autotune.enumerate_cuts(dag):
        if not autotune.dag_cut_is_legal(dag, cut, nests=nests,
                                         bodies=bodies, mode=mode,
                                         uniforms=uniforms, device=dev)[0]:
            continue
        env = dict(operands)
        for comp in lowering.dag_components(dag, nests, bodies, cut,
                                            mode=mode):
            if len(comp.stages) == 1:
                call = lowering.prepare_call(
                    comp.nests[0], comp.bodies[0], env, mode=comp.mode,
                    schedule=lowering.DEFAULT_SCHEDULE, device=dev,
                    uniforms=uniforms)
            else:
                call = lowering.prepare_dag_call(
                    comp.nests, comp.bodies, env, mode=comp.mode, device=dev,
                    uniforms=uniforms)
            got, want, launched = _run_and_plain(call)
            assert launched == {kernel}, (cut, comp.stages)
            if name == "mlp_block":
                scale = _abs_call(call)
                assert float(((got - want).abs() / (scale + 1e-30)).max()) \
                    <= CONTRACT_LIMIT, (cut, comp.stages)
            elif comp.mode == "reduce":
                assert abs(float(got) - float(want)) <= \
                    DOT_LIMIT * abs(float(want)), (cut, comp.stages)
            else:
                err = (got - want).abs() / want.abs().clamp(min=1.0)
                assert float(err.max()) <= MAP_LIMIT, (cut, comp.stages)
            if comp.exported is not None:
                env[comp.exported] = got
        if fused is None:
            fused = got
        else:
            err = (got - fused).abs() / fused.abs().clamp(min=1.0)
            assert float(err.max()) <= 1e-4, cut


@pytest.mark.parametrize("name", ["layernorm", "softmax_xent", "mlp_block"])
def test_fused_is_one_launch_unfused_one_per_stage(dev, name):
    case, args = _dag_case(name, 37, 4)
    args = tuple(a.to(dev) for a in args)
    kernel = {"layernorm": "dag_layernorm",
              "softmax_xent": "dag_softmax_xent", "mlp_block": "dag_mlp"}[name]
    hopper.reset_launches()
    fused = case.fused(*args, schedule=lowering.DEFAULT_SCHEDULE, device=dev)
    assert hopper.LAUNCHES[kernel] == 1
    unfused = case.unfused(*args, device=dev)
    assert hopper.LAUNCHES[kernel] == 4
    want = case.ref(*(a.cpu() for a in args))
    for got in (fused, unfused):
        assert torch.allclose(got.cpu(), want, **case.tol)


def test_gemv_relu_drain_is_the_selection(dev):
    """K4's relu drain equals K4's plain drain put through the selection,
    bit for bit: negative, zero and NaN outputs included."""
    from repro_torch.kernels import chained
    g = torch.Generator(device=dev).manual_seed(8)
    a = torch.randn(300, 700, generator=g, device=dev)
    x = torch.randn(700, generator=g, device=dev)
    a[0] = 0.0
    a[1] = -0.0
    a[2, 5] = float("nan")
    a[3, :] = -1.0
    x[:] = x.abs()
    before = dict(hopper.LAUNCHES)
    fused = chained.fused_gemv_relu(a, x, device=dev)
    assert _launched(before) == {"contract_gemv"}
    plain = gemv.ssr_gemv(a, x, device=dev)
    want = relu.relu_block(plain)
    assert torch.equal(fused.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isnan(fused[2])) and float(fused[3]) == 0.0


def test_reordered_body_permutes_its_streams(dev):
    """A reordered KernelBody runs the same kernel with its streams
    permuted: normalise(C, V) fed as (V, C)."""
    from repro_torch.kernels import dag
    g = torch.Generator(device=dev).manual_seed(3)
    c = torch.randn(37 * 128, generator=g, device=dev)
    v = torch.rand(37 * 128, generator=g, device=dev)
    body = dag._LN_BODIES[2]
    n = c.numel()
    straight = lowering.ssr_call(compiler.elementwise_nest(n, ("C", "V"), 3),
                                 body, {"C": c, "V": v}, mode="map",
                                 device=dev)
    swapped = body.reordered((1, 0))
    assert swapped.op == body.op and swapped.perm == (1, 0)
    call = lowering.prepare_call(compiler.elementwise_nest(n, ("V", "C"), 3),
                                 swapped, {"C": c, "V": v}, mode="map",
                                 device=dev)
    got, want, launched = _run_and_plain(call)
    assert launched == {"dag_layernorm"}
    assert torch.equal(got, straight)
    assert float((got - want).abs().max()) <= MAP_LIMIT * 10


def test_dag_mlp_refuses_a_card_without_the_shared_memory(dev, monkeypatch):
    case, args = _dag_case("mlp_block", 37, 5)
    args = tuple(a.to(dev) for a in args)
    nests, bodies, operands, mode, uniforms = case.spec(*args)
    call = lowering.prepare_dag_call(nests, bodies, operands, mode=mode,
                                     device=dev, uniforms=uniforms)
    kern = call.kernel
    assert hopper.accepts(kern.device_key, kern.geometry, torch.float32, dev,
                          program=kern.program)[0]
    props = hopper._card(dev)

    class Small:
        multi_processor_count = props.multi_processor_count
        shared_memory_per_block_optin = 48 * 1024

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    monkeypatch.setitem(hopper._CARDS, index, Small())
    takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                torch.float32, dev, program=kern.program)
    assert not takes and "shared memory" in why
    before = dict(hopper.LAUNCHES)
    with pytest.raises(LoweringError, match="shared memory"):
        call.run()
    assert hopper.LAUNCHES == before
