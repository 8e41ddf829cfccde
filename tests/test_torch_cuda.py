"""The Hopper kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device.  This file
imports neither JAX nor ``repro``, so it runs on a GPU machine without
them; ``--noconftest`` skips the repo's JAX test settings::

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.core import agu, compiler, hopper, lowering, resilience
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


# lanes → K3's route (f32, bf16) on the 300 x 260 x 1100 problem, three or
# more contraction steps each, tm = 152 off the 128-row tile: 128 tk = 384;
# 8 tk = 24, under the 32-wide chunk; 130 tk = 390 off the chunk on a
# 1170-element pitch, tn = 260 off the tile; 131 tk = 393 on an odd pitch
# (1179), tn = 262
K3_LANES = {128: ("packs", "packs"), 8: ("packs", "packs"),
            130: ("words", "elements"), 131: ("words", "elements")}


@pytest.mark.parametrize("lanes", sorted(K3_LANES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_contract_gemm_routes(dev, lanes, dtype, out_dtype):
    """K3 against its plain version on every route its copies take, in f32
    and bf16 in and out, with tm, tn and tk off its tile and chunk and
    more than one contraction step."""
    g = torch.Generator(device=dev).manual_seed(lanes)
    a = torch.randn(300, 1100, generator=g, device=dev).to(dtype)
    b = torch.randn(1100, 260, generator=g, device=dev).to(dtype)
    call = lowering.prepare_call(compiler.gemm_nest(300, 260, 1100),
                                 gemm.DOT, {"A": a, "B": b},
                                 out_dtype=out_dtype,
                                 schedule=lowering.Schedule(lanes=lanes),
                                 device=dev)
    geo = call.kernel.geometry
    assert geo.contraction_steps > 1 and geo.out.block[0] % 128
    assert hopper.contract_gemm_route(geo, call.layouts) == \
        K3_LANES[lanes][dtype == torch.bfloat16]
    got, want, launched = _kernel_and_plain(call)
    assert launched == {"contract_gemm"} and got.dtype == out_dtype
    # each drains its f32 sum to the output dtype once: in bf16 the two
    # sums, within CONTRACT_LIMIT of each other, may round one bf16 ulp
    # (2**-7 of the value) apart
    scale = a.float().abs() @ b.float().abs()
    ulp = 2 ** -7 * want.float().abs() if out_dtype == torch.bfloat16 else 0
    assert bool(((got.float() - want.float()).abs()
                 <= CONTRACT_LIMIT * scale + ulp).all())


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
                                 (1, 2, 300), (300, 260, 128),
                                 (130, 1000, 128)])
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


# -- the halo and rescale kernels (K9–K11) and B5 --------------------------------

# stencils: max |kernel − plain| over the stencil of |w| and |x| (nvcc
# contracts the taps into FMA, PyTorch rounds each product: a few ulp of
# the sum of the terms' sizes)
STENCIL_LIMIT = 1e-6
# attention: max |kernel − plain| over max |v| (sums over the keys in
# another order and other kv sub-tiles; TF32 inputs read about 1e-4)
ATTENTION_LIMIT = 1e-5


def _stencil_scale(call):
    """The plain version on |inputs|: Σ_j |w_j|·|x_{i+j}| per output."""
    return call.finish(call.kernel.plain(tuple(t.abs() for t in call.layouts)))


@pytest.mark.parametrize("n", [1, 7, 1025, 5000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_halo_stencil1d(dev, n, dtype):
    from repro_torch.kernels import stencil
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n + 10, generator=g, device=dev).to(dtype)
    w = (torch.randn(11, generator=g, device=dev) * 0.3).to(dtype)
    for sched in (lowering.DEFAULT_SCHEDULE,
                  lowering.Schedule(lanes_tile_factor=1),
                  lowering.Schedule(lanes=256, lanes_tile_factor=8)):
        call = lowering.prepare_call(compiler.stencil_nest(n, 11),
                                     stencil.STENCIL1D, {"x": x, "w": w},
                                     schedule=sched, device=dev)
        got, want, launched = _run_and_plain(call)
        assert launched == {"halo_stencil1d"}
        assert got.shape == (n,)
        err = (got - want).abs() / (_stencil_scale(call) + 1e-30)
        assert float(err.max()) <= STENCIL_LIMIT


@pytest.mark.parametrize("n", [1, 7, 1025])
def test_stencil1d_relu_drain_is_the_selection(dev, n):
    from repro_torch.kernels import chained, stencil
    g = torch.Generator(device=dev).manual_seed(n + 1)
    x = torch.randn(n + 10, generator=g, device=dev)
    w = torch.randn(11, generator=g, device=dev) * 0.3
    before = dict(hopper.LAUNCHES)
    fused = chained.fused_stencil1d_relu(x, w, device=dev)
    assert _launched(before) == {"halo_stencil1d"}
    want = relu.relu_block(stencil.ssr_stencil1d(x, w, device=dev))
    assert torch.equal(fused.view(torch.int32), want.view(torch.int32))
    before = dict(hopper.LAUNCHES)
    unfused = chained.unfused_stencil1d_relu(x, w, device=dev)
    assert _launched(before) == {"halo_stencil1d", "map_relu"}
    assert torch.equal(unfused.view(torch.int32), fused.view(torch.int32))


@pytest.mark.parametrize("hw", [(37, 53), (9, 1), (300, 260)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_halo_stencil2d(dev, hw, dtype):
    from repro_torch.kernels import stencil
    h, wd = hw
    g = torch.Generator(device=dev).manual_seed(h * wd)
    x = torch.randn(h + 10, wd + 10, generator=g, device=dev).to(dtype)
    wx = (torch.randn(11, generator=g, device=dev) * 0.3).to(dtype)
    wy = (torch.randn(11, generator=g, device=dev) * 0.3).to(dtype)
    for sched in (lowering.DEFAULT_SCHEDULE,
                  lowering.Schedule(rows=16, lanes_tile_factor=1),
                  lowering.Schedule(axis_order=(1, 0))):
        call = lowering.prepare_call(compiler.stencil2d_nest(h, wd, 11),
                                     stencil.STENCIL2D,
                                     {"x": x, "wx": wx, "wy": wy},
                                     schedule=sched, device=dev)
        got, want, launched = _run_and_plain(call)
        assert launched == {"halo_stencil2d"}
        assert got.shape == (h, wd)
        err = (got - want).abs() / (_stencil_scale(call) + 1e-30)
        assert float(err.max()) <= STENCIL_LIMIT


@pytest.mark.parametrize("n", [1, 7, 1025, 5000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_base_stencil1d(dev, n, dtype):
    from repro_torch.kernels import stencil
    g = torch.Generator(device=dev).manual_seed(n + 2)
    x = torch.randn(n + 10, generator=g, device=dev).to(dtype)
    w = torch.randn(11, generator=g, device=dev) * 0.3
    before = dict(hopper.LAUNCHES)
    got = stencil.baseline_stencil1d(x, w, device=dev)
    assert _launched(before) == {"base_stencil1d"}
    xl, wl = x.reshape(1, -1), w.reshape(1, -1)
    want = hopper.plain_base_stencil1d(xl, wl).reshape(-1)
    scale = hopper.plain_base_stencil1d(xl.abs(), wl.abs()).reshape(-1)
    assert float(((got - want).abs() / (scale + 1e-30)).max()) \
        <= STENCIL_LIMIT


def _qkv(dev, sq, sk, d, seed, lead=(), dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(*lead, s, d, generator=g, device=dev).to(dtype)
                 for s in (sq, sk, sk))


@pytest.mark.parametrize("shape", [(100, 333, 80, True, 64),
                                   (100, 333, 80, False, None),
                                   (256, 256, 64, True, None),
                                   (1, 7, 4, False, 3),
                                   (129, 130, 128, True, 7)])
def test_rescale_attention(dev, shape):
    from repro_torch.kernels import attention
    sq, sk, d, causal, window = shape
    q, k, v = _qkv(dev, sq, sk, d, sq * sk)
    _, static, _ = attention._prepare(q, k, v, causal, window)
    for sched in (lowering.DEFAULT_SCHEDULE, lowering.Schedule(rows=16),
                  lowering.Schedule(axis_order=(1, 0, 2))):
        call = lowering.prepare_call(attention._nest(static),
                                     attention._body(static),
                                     {"Q": q, "K": k, "V": v},
                                     schedule=sched, device=dev)
        got, want, launched = _run_and_plain(call)
        assert launched == {"rescale_attention"}
        assert got.shape == (sq, d)
        assert float((got - want).abs().max()) <= \
            ATTENTION_LIMIT * float(v.abs().max())


def test_rescale_attention_head_batch_is_one_launch(dev):
    from repro_torch.kernels import attention, ref
    q, k, v = _qkv(dev, 100, 333, 80, 9, lead=(2, 3))
    before = dict(hopper.LAUNCHES)
    got = attention.ssr_flash_attention(q, k, v, causal=True, window=64,
                                        device=dev)
    assert hopper.LAUNCHES["rescale_attention"] - \
        before["rescale_attention"] == 1
    assert got.shape == (2, 3, 100, 80)
    for h in ((0, 0), (1, 2)):
        one = attention.ssr_flash_attention(q[h], k[h], v[h], causal=True,
                                            window=64, device=dev)
        assert float((got[h] - one).abs().max()) <= \
            ATTENTION_LIMIT * float(v[h].abs().max())
    want = ref.attention_ref(q, k, v, causal=True, window=64)
    assert float((got - want).abs().max()) <= 2e-4


@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_rescale_attention_bf16_inputs(dev, out):
    from repro_torch.kernels import attention
    q, k, v = _qkv(dev, 100, 333, 80, 4, dtype=torch.bfloat16)
    _, static, _ = attention._prepare(q, k, v, True, 64)
    out_dtype = torch.bfloat16 if out == "bf16" else torch.float32
    call = lowering.prepare_call(attention._nest(static),
                                 attention._body(static),
                                 {"Q": q, "K": k, "V": v},
                                 out_dtype=out_dtype, device=dev)
    got, want, launched = _run_and_plain(call)
    assert launched == {"rescale_attention"} and got.dtype == out_dtype
    # one bf16 rounding of the output apart at most (plus f32 order)
    tol = 2 ** -8 if out == "bf16" else ATTENTION_LIMIT
    assert float((got.float() - want.float()).abs().max()) <= \
        tol * float(v.float().abs().max())


def test_rescale_attention_refuses_a_card_without_the_shared_memory(
        dev, monkeypatch):
    from repro_torch.kernels import attention
    q, k, v = _qkv(dev, 100, 333, 80, 2)
    _, static, _ = attention._prepare(q, k, v, True, 64)
    call = lowering.prepare_call(attention._nest(static),
                                 attention._body(static),
                                 {"Q": q, "K": k, "V": v}, device=dev)
    kern = call.kernel
    assert hopper.accepts(kern.device_key, kern.geometry, torch.float32, dev,
                          program=kern.program)[0]
    props = hopper._card(dev)

    class Small:
        multi_processor_count = props.multi_processor_count
        shared_memory_per_block_optin = 100 * 1024

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    monkeypatch.setitem(hopper._CARDS, index, Small())
    takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                torch.float32, dev, program=kern.program)
    assert not takes and "shared memory" in why
    before = dict(hopper.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        call.run()
    assert hopper.LAUNCHES == before


def test_new_wrappers_launch_or_raise_never_plain(dev, monkeypatch):
    """On CUDA tensors the halo and rescale wrappers launch their kernel or
    raise; the plain versions never run."""
    from repro_torch.kernels import attention, stencil

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for key in ("nest", "rescale"):
        monkeypatch.setitem(hopper.PLAIN, key, no_plain)
    monkeypatch.setattr(hopper, "plain_base_stencil1d", no_plain)
    x = torch.randn(1010, device=dev)
    w = torch.randn(11, device=dev)
    q, k, v = _qkv(dev, 64, 64, 32, 1)
    for fn, want in ((lambda: stencil.ssr_stencil1d(x, w, device=dev),
                      "halo_stencil1d"),
                     (lambda: stencil.ssr_stencil2d(
                         x[:900].reshape(30, 30), w, w, device=dev),
                      "halo_stencil2d"),
                     (lambda: stencil.baseline_stencil1d(x, w, device=dev),
                      "base_stencil1d"),
                     (lambda: attention.ssr_flash_attention(
                         q, k, v, causal=True, device=dev),
                      "rescale_attention")):
        before = dict(hopper.LAUNCHES)
        fn()
        assert _launched(before) == {want}
    # a tagged body on a geometry its kernel does not take raises
    call = lowering.prepare_call(compiler.stencil_nest(100, 5),
                                 stencil.STENCIL1D,
                                 {"x": torch.randn(104, device=dev),
                                  "w": torch.randn(5, device=dev)},
                                 device=dev)
    before = dict(hopper.LAUNCHES)
    with pytest.raises(ValueError, match="halo_stencil1d"):
        call.run()
    assert hopper.LAUNCHES == before


def test_rescale_attention_takes_a_misaligned_view(dev):
    """A view starting off a 16-byte boundary is copied before K11's packed
    loads; the result is the aligned copy's."""
    from repro_torch.kernels import attention
    g = torch.Generator(device=dev).manual_seed(11)
    flat = torch.randn(3 * 256 * 128 + 1, generator=g, device=dev)
    q, k, v = (flat[1 + i * 256 * 128:1 + (i + 1) * 256 * 128].view(256, 128)
               for i in range(3))
    assert q.data_ptr() % 16 != 0
    got = attention.ssr_flash_attention(q, k, v, causal=True, device=dev)
    want = attention.ssr_flash_attention(q.clone(), k.clone(), v.clone(),
                                         causal=True, device=dev)
    assert torch.equal(got, want)


# -- the gather kernels (K12, K13) and their baselines (B6, B7) ---------------

# spmv/spmm: max |kernel − plain| over Σ_j |v_ij|·|x_cidx| per output (short
# signed sums: nvcc contracts into FMA, PyTorch rounds each product), the
# stencils' rule
SPARSE_LIMIT = 1e-6


def _csr_case(name, seed):
    """(data, indices, indptr, n): the odd inputs of the card checks."""
    from repro_torch.kernels import sparse
    rng = np.random.default_rng(seed)
    if name == "example":
        return (*sparse.random_csr(rng, 37, 53, 0.1), 53)
    if name == "zero":
        return (np.zeros(0, np.float32), np.zeros(0, np.int64),
                np.zeros(6, np.int64), 7)
    if name == "empty_rows":
        return (np.asarray([1.0, 2.0, 3.0, 4.0], np.float32),
                np.asarray([0, 1, 2, 3]), np.asarray([0, 0, 4, 4, 4]), 5)
    if name == "one":
        return (np.asarray([3.0], np.float32), np.asarray([0]),
                np.asarray([0, 1]), 1)
    if name in ("row300", "row600"):        # one long row: k > 128
        k = int(name[3:])
        cols = np.sort(rng.choice(1000, k, replace=False))
        data = rng.standard_normal(k + 2).astype(np.float32)
        return (data, np.concatenate([cols, [5, 9]]),
                np.asarray([0, k, k + 1, k + 2]), 1000)
    if name == "hpcg":
        data, indices, indptr = sparse.hpcg_operator(8, 8, 8)
        return data.numpy(), indices.numpy(), indptr.numpy(), 512
    raise KeyError(name)


SPARSE_CASES = ["example", "zero", "empty_rows", "one", "row300", "row600",
                "hpcg"]
SPARSE_SCHEDULES = [lowering.DEFAULT_SCHEDULE,
                    lowering.Schedule(lanes_tile_factor=1, rows_tile_factor=2)]


def _ell_on(dev, data, indices, indptr, n):
    from repro_torch.kernels import sparse
    vals, cidx, m, k = sparse.csr_to_ell(data, indices, indptr, n)
    return (torch.from_numpy(vals).to(dev), torch.from_numpy(cidx).to(dev),
            m, k)


def _sparse_check(call, launched, want_kernel):
    got = call.run()
    assert _launched(launched) == {want_kernel}
    want = call.finish(call.kernel.plain(call.layouts))
    scale = call.finish(call.kernel.plain(tuple(t.abs()
                                                for t in call.layouts)))
    assert got.shape == want.shape
    assert float(((got - want).abs() / (scale + 1e-30)).max()) \
        <= SPARSE_LIMIT
    return got


def _oracle_check(ssr, baseline, ref, kernels, data, indices, indptr, x,
                  dev):
    """The entry point and its baseline, one launch each, against the
    densified oracle within the registry tol (1e-5) of the terms' sizes,
    Σ_j |v_ij|·|x_cidx|: a row of 600 terms sums them in another order."""
    want = ref(data, indices, indptr, x)
    scale = ref(np.abs(data), indices, indptr, x.abs())
    for variant, kname in zip((ssr, baseline), kernels):
        before = dict(hopper.LAUNCHES)
        got = variant(data, indices, indptr, x, device=dev)
        assert _launched(before) == {kname}
        assert got.shape == want.shape
        assert bool(((got - want).abs() <= 1e-5 + 1e-5 * scale).all())


@pytest.mark.parametrize("case", SPARSE_CASES)
def test_gather_spmv(dev, case):
    from repro_torch.kernels import sparse
    data, indices, indptr, n = _csr_case(case, 3)
    vals, cidx, m, k = _ell_on(dev, data, indices, indptr, n)
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, generator=g, device=dev)
    for sched in SPARSE_SCHEDULES:
        call = lowering.prepare_call(compiler.spmv_nest(m, k), sparse.SPMV,
                                     {"vals": vals, "cidx": cidx, "x": x},
                                     schedule=sched, device=dev)
        _sparse_check(call, dict(hopper.LAUNCHES), "gather_spmv")
    _oracle_check(sparse.ssr_spmv, sparse.baseline_spmv, sparse.ref_spmv,
                  ("gather_spmv", "base_spmv"), data, indices, indptr, x, dev)


@pytest.mark.parametrize("case", SPARSE_CASES)
def test_gather_spmv_reads_pack_ell_planes_with_no_copy(dev, case):
    """On the card K12 takes the (m, k) planes pack_ell made as they are
    (the same storage, no padded layout copied), at pitch k, and gives its
    plain version's result on them within SPARSE_LIMIT, beside its run on
    the values doubled, which must read above it where the product is not
    all zero; R13 at depth 4 on the padded layouts gives K12's bits."""
    from repro_torch.kernels import sparse
    data, indices, indptr, n = _csr_case(case, 8)
    vals, cidx, m, k = sparse.pack_ell(*(torch.as_tensor(np.asarray(a),
                                                         device=dev)
                                         for a in (data, indices, indptr)), n)
    g = torch.Generator(device=dev).manual_seed(n + 2)
    x = torch.randn(n, generator=g, device=dev)
    ops_ = {"vals": vals, "cidx": cidx, "x": x}
    copies = lowering.LAYOUT_COPIES["padded"]
    call = lowering.prepare_call(compiler.spmv_nest(m, k), sparse.SPMV, ops_,
                                 device=dev)
    assert lowering.LAYOUT_COPIES["padded"] == copies
    assert call.layouts[0].data_ptr() == vals.data_ptr()
    assert call.layouts[1].data_ptr() == cidx.data_ptr()
    assert tuple(call.layouts[0].shape) == (m, k)
    got = _sparse_check(call, dict(hopper.LAUNCHES), "gather_spmv")
    want = call.finish(call.kernel.plain(call.layouts))
    scale = call.finish(call.kernel.plain(tuple(t.abs()
                                                for t in call.layouts)))
    doubled = call.finish(call.kernel(2 * vals, cidx, call.layouts[2]))
    ctrl = float(((doubled - want).abs() / (scale + 1e-30)).max())
    assert (ctrl > SPARSE_LIMIT) == bool(want.any())
    ring, launched = _forced_ring(call, 4, "ring_gather_spmv",
                                  call.padded_layouts())
    if ring is not None:
        assert launched == {"ring_gather_spmv"}
        assert torch.equal(ring.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("c", [1, 17, 128, 200])
@pytest.mark.parametrize("case", SPARSE_CASES)
def test_gather_spmm(dev, case, c):
    from repro_torch.kernels import sparse
    data, indices, indptr, n = _csr_case(case, 4)
    vals, cidx, m, k = _ell_on(dev, data, indices, indptr, n)
    g = torch.Generator(device=dev).manual_seed(n * c)
    x = torch.randn(n, c, generator=g, device=dev)
    pitch = -(-c // 128) * 128
    xp = torch.nn.functional.pad(x, (0, pitch - c))
    for sched in SPARSE_SCHEDULES:
        call = lowering.prepare_call(compiler.spmm_nest(m, c, k, pitch),
                                     sparse.SPMM,
                                     {"vals": vals, "cidx": cidx, "X": xp},
                                     schedule=sched, device=dev)
        _sparse_check(call, dict(hopper.LAUNCHES), "gather_spmm")
    _oracle_check(sparse.ssr_spmm, sparse.baseline_spmm, sparse.ref_spmm,
                  ("gather_spmm", "base_spmm"), data, indices, indptr, x, dev)


@pytest.mark.parametrize("case", SPARSE_CASES)
def test_base_spmv_and_spmm(dev, case):
    data, indices, indptr, n = _csr_case(case, 5)
    vals, cidx, m, k = _ell_on(dev, data, indices, indptr, n)
    g = torch.Generator(device=dev).manual_seed(n + 1)
    x = torch.randn(1, n, generator=g, device=dev)
    X = torch.randn(n, 200, generator=g, device=dev)
    for wrapper, plain, table in (
            (hopper.base_spmv, hopper.plain_base_spmv, x),
            (hopper.base_spmm, hopper.plain_base_spmm, X)):
        before = dict(hopper.LAUNCHES)
        got = wrapper(vals, cidx, table)
        assert _launched(before) == {wrapper.__name__}
        want = plain(vals, cidx, table)
        scale = plain(vals.abs(), cidx, table.abs())
        assert float(((got - want).abs() / (scale + 1e-30)).max()) \
            <= SPARSE_LIMIT


def test_gather_addresses_are_64_bit(dev):
    """cidx · 128 past 2**31: a table of 2**31 + 2048 elements (8 GiB) read
    at rows beyond 2**24 gives the rows' values, not a wrapped address."""
    from repro_torch.kernels import sparse
    n, c = (1 << 24) + 16, 128
    X = torch.zeros(n, c, device=dev)
    rows = torch.arange(n - 8, n, device=dev)
    X[rows] = torch.arange(8 * c, dtype=torch.float32,
                           device=dev).reshape(8, c) + 1
    X[rows - (1 << 24)] = -7.0         # where a 32-bit wrap would land
    indices = np.arange(n - 8, n, dtype=np.int64)
    data = np.ones(8, np.float32)
    indptr = np.arange(9, dtype=np.int64)
    before = dict(hopper.LAUNCHES)
    got = sparse.ssr_spmm(data, indices, indptr, X, device=dev)
    assert _launched(before) == {"gather_spmm"}
    assert torch.equal(got, X[rows])
    got_b = sparse.baseline_spmm(data, indices, indptr, X, device=dev)
    assert torch.equal(got_b, X[rows])
    del X


def test_pack_ell_on_the_card_matches_csr_to_ell(dev):
    from repro_torch.kernels import sparse
    data, indices, indptr = sparse.hpcg_operator(6, 5, 4, device=dev)
    n = 6 * 5 * 4
    got = sparse.pack_ell(data, indices, indptr, n)
    want = sparse.csr_to_ell(data.cpu().numpy(), indices.cpu().numpy(),
                             indptr.cpu().numpy(), n)
    assert got[2:] == want[2:]
    assert torch.equal(got[0].cpu(), torch.from_numpy(want[0]))
    assert torch.equal(got[1].cpu(), torch.from_numpy(want[1]))
    bad = indptr.clone()
    bad[3] = bad[2] - 1
    with pytest.raises(ValueError, match="indptr must be non-decreasing"):
        sparse.pack_ell(data, indices, bad, n)
    with pytest.raises(ValueError, match="column index out of range"):
        sparse.pack_ell(data, indices, indptr, n - 1)


def test_sparse_entry_points_launch_or_raise_never_plain(dev, monkeypatch):
    """On the card spmv, sparse_gemv and spmm launch K12/K13 (one launch a
    call) and the baselines B6/B7; no plain version runs."""
    from repro_torch.kernels import sparse

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setitem(hopper.PLAIN, "nest", no_plain)
    monkeypatch.setattr(hopper, "plain_base_spmv", no_plain)
    monkeypatch.setattr(hopper, "plain_base_spmm", no_plain)
    data, indices, indptr = sparse.hpcg_operator(8, 8, 8, device=dev)
    x = torch.rand(512, device=dev)
    X = torch.randn(512, 40, device=dev)
    for fn, want in (
            (lambda: ops.spmv(data, indices, indptr, x, ssr=True),
             {"gather_spmv": 1}),
            (lambda: ops.sparse_gemv(data, indices, indptr, x, ssr=True),
             {"gather_spmv": 1}),
            (lambda: ops.spmm(data, indices, indptr, X, ssr=True),
             {"gather_spmm": 1}),
            (lambda: registry.get("spmv").baseline(data, indices, indptr, x),
             {"base_spmv": 1}),
            (lambda: registry.get("spmm").baseline(data, indices, indptr, X),
             {"base_spmm": 1})):
        before = dict(hopper.LAUNCHES)
        fn()
        assert {k: v - before[k] for k, v in hopper.LAUNCHES.items()
                if v != before[k]} == want


def test_gather_skips_the_lowering_pad_lanes(dev):
    """x[0] = inf: K12 reads only the lanes holding data, as its plain
    version does, so a full row stays finite; a row with an ELL pad (its
    (0.0, 0) entry) is NaN on both, and on B6 every row that reads x[0]."""
    from repro_torch.kernels import sparse
    data = np.asarray([1.0, 2.0, 3.0], np.float32)
    indices, indptr = np.asarray([1, 2, 3]), np.asarray([0, 2, 3])
    x = torch.tensor([float("inf"), 1.0, 2.0, 3.0], device=dev)
    got = sparse.ssr_spmv(data, indices, indptr, x, device=dev)
    assert float(got[0]) == 5.0 and bool(torch.isnan(got[1]))
    base = sparse.baseline_spmv(data, indices, indptr, x, device=dev)
    assert float(base[0]) == 5.0 and bool(torch.isnan(base[1]))


# -- K11 at head dims above 128 --------------------------------------------------


@pytest.mark.parametrize("shape", [(100, 333, 192, True, 64),
                                   (100, 333, 192, False, None),
                                   (256, 256, 256, True, None),
                                   (129, 130, 256, False, 7)])
def test_rescale_attention_wide_heads(dev, shape):
    """D = 192 arrives zero-padded to a 256-lane tile, D = 256 as one: K11's
    64-row tiles, against the plain version."""
    from repro_torch.kernels import attention
    sq, sk, d, causal, window = shape
    q, k, v = _qkv(dev, sq, sk, d, sq * sk + d)
    _, static, _ = attention._prepare(q, k, v, causal, window)
    for sched in (lowering.DEFAULT_SCHEDULE, lowering.Schedule(rows=16)):
        call = lowering.prepare_call(attention._nest(static),
                                     attention._body(static),
                                     {"Q": q, "K": k, "V": v},
                                     schedule=sched, device=dev)
        assert call.kernel.geometry.ins[0].block[1] == 256
        got, want, launched = _run_and_plain(call)
        assert launched == {"rescale_attention"}
        assert got.shape == (sq, d)
        assert float((got - want).abs().max()) <= \
            ATTENTION_LIMIT * float(v.abs().max())


@pytest.mark.parametrize("d", [192, 256])
def test_rescale_attention_wide_head_batch_is_one_launch(dev, d):
    from repro_torch.kernels import attention, ref
    q, k, v = _qkv(dev, 100, 333, d, d, lead=(2, 3))
    before = dict(hopper.LAUNCHES)
    got = attention.ssr_flash_attention(q, k, v, causal=True, window=64,
                                        device=dev)
    assert hopper.LAUNCHES["rescale_attention"] - \
        before["rescale_attention"] == 1
    assert got.shape == (2, 3, 100, d)
    for h in ((0, 0), (1, 2)):
        one = attention.ssr_flash_attention(q[h], k[h], v[h], causal=True,
                                            window=64, device=dev)
        assert float((got[h] - one).abs().max()) <= \
            ATTENTION_LIMIT * float(v[h].abs().max())
    want = ref.attention_ref(q, k, v, causal=True, window=64)
    assert float((got - want).abs().max()) <= 2e-4


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("d", [192, 256])
def test_rescale_attention_wide_heads_bf16_inputs(dev, d, out):
    from repro_torch.kernels import attention
    q, k, v = _qkv(dev, 100, 333, d, 4, dtype=torch.bfloat16)
    _, static, _ = attention._prepare(q, k, v, True, 64)
    out_dtype = torch.bfloat16 if out == "bf16" else torch.float32
    call = lowering.prepare_call(attention._nest(static),
                                 attention._body(static),
                                 {"Q": q, "K": k, "V": v},
                                 out_dtype=out_dtype, device=dev)
    got, want, launched = _run_and_plain(call)
    assert launched == {"rescale_attention"} and got.dtype == out_dtype
    tol = 2 ** -8 if out == "bf16" else ATTENTION_LIMIT
    assert float((got.float() - want.float()).abs().max()) <= \
        tol * float(v.float().abs().max())


def test_rescale_attention_refuses_an_unheld_lanes_tile(dev):
    """A 384-lane tile is neither of K11's: refused with the kernel's name,
    nothing launched."""
    from repro_torch.kernels import attention
    q, k, v = _qkv(dev, 64, 64, 384, 3)
    _, static, _ = attention._prepare(q, k, v, True, None)
    call = lowering.prepare_call(attention._nest(static),
                                 attention._body(static),
                                 {"Q": q, "K": k, "V": v}, device=dev)
    kern = call.kernel
    takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                torch.float32, dev, program=kern.program)
    assert not takes and "rescale_attention" in why
    before = dict(hopper.LAUNCHES)
    with pytest.raises(ValueError, match="rescale_attention"):
        call.run()
    assert hopper.LAUNCHES == before


# -- the stream kernels (K14–K16) and B8 -----------------------------------------

# scan: max |got − f64 prefix sum| over the f64 prefix sum of |x| (f32 sums
# in any fixed order read about 1e-7; one tile's carry dropped reads 1e-2
# and more, chip_smoke.py's control)
SCAN_LIMIT = 1e-6
# fft: max |kernel − plain| over Σ|x| of the row (the kernel rounds each
# product and sum as the plain version does: 0 expected; twiddles rounded
# to bf16 read about 1e-4)
FFT_LIMIT = 1e-6


def _stream(module, *args):
    """(Launch, prepared arrays, body) of a StreamKernel module's call."""
    arrays, static, _ = module._prepare(*args)
    return (module._launch(static, *arrays), tuple(arrays),
            module._ssr._body(static))


@pytest.mark.parametrize("n", [1, 1000, 4096, 5000, 1 << 20, (1 << 22) + 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_stream_scan_and_base_scan(dev, n, dtype):
    from repro_torch.kernels import scan
    g = torch.Generator(device=dev).manual_seed(n)
    if dtype == torch.int32:
        x = torch.randint(-1000, 1000, (n,), generator=g, device=dev,
                          dtype=dtype)
    else:
        x = torch.randn(n, generator=g, device=dev).to(dtype)
    exact = torch.cumsum(x.double(), 0)
    scale = torch.cumsum(x.double().abs(), 0) + 1e-30
    outs = {}
    for kname, fn in (("stream_scan", scan.ssr_scan),
                      ("base_scan", scan.baseline_scan)):
        before = dict(hopper.LAUNCHES)
        got = fn(x, device=dev)
        assert _launched(before) == {kname}
        assert got.dtype == torch.float32 and got.shape == (n,)
        assert float(((got.double() - exact).abs() / scale).max()) \
            <= SCAN_LIMIT
        outs[kname] = got
    # the same result every run: no order depends on timing
    assert torch.equal(scan.ssr_scan(x, device=dev), outs["stream_scan"])
    assert torch.equal(scan.baseline_scan(x, device=dev), outs["base_scan"])
    if n <= 5000:      # the plain walk, one step a block
        lc, arrays, body = _stream(scan, x)
        want = hopper.plain_stream(body, lc, arrays)[0].reshape(-1)[:n]
        assert float(((want.double() - exact).abs() / scale).max()) \
            <= SCAN_LIMIT
        base = hopper.plain_base_scan(arrays[0]).reshape(-1)[:n]
        assert float(((base.double() - exact).abs() / scale).max()) \
            <= SCAN_LIMIT


@pytest.mark.parametrize("shape", [(1,), (2,), (256,), (3, 2048), (5, 8192),
                                   (1 << 14,), (2, 1 << 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_fft(dev, shape, dtype):
    from repro_torch.kernels import fft
    g = torch.Generator(device=dev).manual_seed(shape[-1])
    re, im = (torch.randn(*shape, generator=g, device=dev).to(dtype)
              for _ in range(2))
    lc, arrays, body = _stream(fft, re, im)
    before = dict(hopper.LAUNCHES)
    got = fft.ssr_fft(re, im, device=dev)
    assert _launched(before) == {"stream_fft"}
    want = [t.reshape(shape) for t in hopper.plain_stream(body, lc, arrays)]
    scale = (re.float().abs() + im.float().abs()).sum(-1, keepdim=True)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == shape
        assert float(((a - b).abs() / scale).max()) <= FFT_LIMIT
    z = torch.fft.fft(torch.complex(re.float(), im.float()))
    assert float(((got[0] - z.real).abs() / scale).max()) <= 1e-5
    assert float(((got[1] - z.imag).abs() / scale).max()) <= 1e-5


@pytest.mark.parametrize("shape", [(1,), (2,), (4,), (8,), (32,), (256,),
                                   (3, 2048), (5, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_fft_bit_exact_in_a_cta(dev, shape, dtype):
    """A row of up to FFT_SMEM_POINTS points runs in one CTA, its stages in
    register groups, every operation rounded as the plain version rounds
    it: the same bits, in one device launch."""
    from repro_torch.kernels import fft
    g = torch.Generator(device=dev).manual_seed(shape[-1] + 7)
    re, im = (torch.randn(*shape, generator=g, device=dev).to(dtype)
              for _ in range(2))
    lc, arrays, body = _stream(fft, re, im)
    got = fft.ssr_fft(re, im, device=dev)
    want = [t.reshape(shape) for t in hopper.plain_stream(body, lc, arrays)]
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert _device_kernels(lambda: fft.ssr_fft(re, im, device=dev)) == 1


def _device_kernels(fn) -> int:
    """Device kernels one call of ``fn`` launches (profiler, CUDA
    activity)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.parametrize("n", [1 << 13, 1 << 14, 1 << 18])
def test_stream_bitonic_device_launches_follow_the_schedule(dev, n):
    from repro_torch.kernels import bitonic
    x = torch.randn(n, device=dev)
    assert _device_kernels(lambda: bitonic.ssr_sort(x, device=dev)) == \
        len(bitonic.sort_passes(n))


def _bits(t):
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16,
                   torch.int32: torch.int32}[t.dtype])


@pytest.mark.parametrize("shape", [(1,), (2,), (64,), (3, 1024), (8192,),
                                   (5, 8), (7, 16), (1 << 14,), (2, 1 << 17),
                                   (1 << 21,), (1 << 24,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_stream_bitonic_bit_exact(dev, shape, dtype):
    from repro_torch.kernels import bitonic
    g = torch.Generator(device=dev).manual_seed(shape[-1] + 1)
    if dtype == torch.int32:
        x = torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=g,
                          device=dev, dtype=dtype)
    else:
        x = torch.randn(*shape, generator=g, device=dev).to(dtype)
        flat = x.view(-1)
        flat[: min(4, flat.numel())] = torch.tensor(
            [0.0, -0.0, float("inf"), float("-inf")][: min(4, flat.numel())])
    lc, arrays, body = _stream(bitonic, x)
    before = dict(hopper.LAUNCHES)
    got = bitonic.ssr_sort(x, device=dev)
    assert _launched(before) == {"stream_bitonic"}
    want = hopper.plain_stream(body, lc, arrays)[0].reshape(shape)
    assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))
    assert torch.equal(got, torch.sort(x).values)


@pytest.mark.parametrize("n", [8, 1 << 15])
def test_stream_bitonic_nan_and_signed_zeros(dev, n):
    """One NaN turns every output to NaN, as the reference's ssr_sort; −0
    sorts below +0 — both as the plain version, to the bit."""
    from repro_torch.kernels import bitonic
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, generator=g, device=dev)
    x[: n // 2] = 0.0
    x[: n // 4] = -0.0
    x = x[torch.randperm(n, generator=g, device=dev)]
    got = bitonic.ssr_sort(x, device=dev)
    lc, arrays, body = _stream(bitonic, x)
    want = hopper.plain_stream(body, lc, arrays)[0].reshape(-1)
    assert torch.equal(_bits(got), _bits(want))
    zeros = got[got == 0]
    assert bool(torch.signbit(zeros[: n // 4]).all())
    assert not bool(torch.signbit(zeros[n // 4:]).any())
    x[n // 3] = float("nan")
    got = bitonic.ssr_sort(x, device=dev)
    lc, arrays, body = _stream(bitonic, x)
    want = hopper.plain_stream(body, lc, arrays)[0].reshape(-1)
    assert bool(torch.isnan(got).all())
    assert torch.equal(_bits(got), _bits(want))


def test_stream_kernels_launch_or_raise_never_plain(dev, monkeypatch):
    """On CUDA tensors the stream entry points and B8 launch their kernel or
    raise; the plain walk never runs.  A body without a stream kernel
    raises a LoweringError and launches nothing."""
    from repro_torch.kernels import frontend, scan

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(hopper, "plain_stream", no_plain)
    monkeypatch.setattr(hopper, "plain_base_scan", no_plain)
    x = torch.randn(4096, device=dev)
    for fn, want in ((lambda: ops.prefix_sum(x, ssr=True, device=dev),
                      "stream_scan"),
                     (lambda: scan.baseline_scan(x, device=dev), "base_scan"),
                     (lambda: ops.fft(x, x, ssr=True, device=dev),
                      "stream_fft"),
                     (lambda: ops.sort(x, ssr=True, device=dev),
                      "stream_bitonic")):
        before = dict(hopper.LAUNCHES)
        fn()
        assert _launched(before) == {want}
    plain_body = frontend.StreamKernel(
        "untagged", prepare=scan._prepare, launch=scan._launch,
        body=lambda static: scan._scan_block,
        lowering_waiver="a body without a device kernel")
    before = dict(hopper.LAUNCHES)
    with pytest.raises(LoweringError, match="no Hopper stream kernel"):
        plain_body(x, device=dev)
    assert hopper.LAUNCHES == before
    # a tagged body on a Launch its kernel does not compute raises
    wrong = frontend.StreamKernel(
        "wrong", prepare=scan._prepare,
        launch=lambda static, x2d: dataclasses.replace(
            scan._launch(static, x2d), dimension_semantics=("parallel",)),
        body=lambda static: scan.SCAN, lowering_waiver="a wrong Launch")
    with pytest.raises(ValueError, match="stream_scan"):
        wrong(x, device=dev)
    assert hopper.LAUNCHES == before


# -- the stage rings (R1–R4): a schedule deeper than 2 ------------------------

RING_DEPTHS = [3, 4, 8, (2, 4), (4, 2)]


def _depth(depth):
    return lowering.Schedule(stream_depths=depth) if isinstance(depth, tuple) \
        else lowering.Schedule(buffer_depth=depth)


def _ring_against_sync(nest, body, ops_, depth, bits=torch.int32, lanes=128,
                       **kw):
    """The call at ``depth`` and at depth 2 (blocks ``lanes`` wide): the
    ring kernel's output, the sync kernel's, and what each launched."""
    out = []
    for sched in (dataclasses.replace(_depth(depth), lanes=lanes),
                  lowering.Schedule(lanes=lanes)):
        call = lowering.prepare_call(nest, body, ops_, schedule=sched, **kw)
        before = dict(hopper.LAUNCHES)
        got = call.run()
        out.append((got.contiguous().view(bits), _launched(before),
                    call.kernel))
    return out


# lanes → R1's and R2's fill route: 128 the bulk copies (16-byte packs),
# 130 a 130-element pitch, no 16-byte packs: the filling warp's element
# copies
FILL_LANES = {128: "bulk", 130: "elements"}


def _fill_route(kern, layouts):
    return "bulk" if hopper._vector_width(
        layouts, kern.geometry.ins) > 1 else "elements"


@pytest.mark.parametrize("depth", RING_DEPTHS, ids=str)
@pytest.mark.parametrize("lanes", sorted(FILL_LANES))
@pytest.mark.parametrize("n", [5000, (1 << 20) + 3, 1 << 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_reduce_mul_is_k1_to_the_bit(dev, n, dtype, lanes, depth):
    """R1 against K1 on both fill routes; at 2**24 each persistent CTA
    walks several of K1's runs, so its ring crosses run boundaries."""
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.rand(n, generator=g, device=dev).to(dtype)
    y = torch.rand(n, generator=g, device=dev).to(dtype)
    nest = compiler.dot_product_nest(n)
    (got, ring, kr), (want, sync, _) = _ring_against_sync(
        nest, reduction.MUL, {"A": x, "B": y}, depth, lanes=lanes)
    assert kr.pipelined and ring == {"ring_reduce_mul"} \
        and sync == {"reduce_mul"}
    call = lowering.prepare_call(nest, reduction.MUL, {"A": x, "B": y},
                                 schedule=dataclasses.replace(
                                     _depth(depth), lanes=lanes))
    assert _fill_route(call.kernel, call.layouts) == FILL_LANES[lanes]
    if n == 1 << 24:
        geo = call.kernel.geometry
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _, per = hopper._k_split(geo.steps, hopper.REDUCE_PER_SM * sms)
        run = hopper.ring_run_steps("ring_reduce_mul", geo, call.kernel.ring,
                                    dtype, sms)
        assert run % per == 0 and run // per > 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("depth", [3, 4, 8, (5,)], ids=str)
@pytest.mark.parametrize("lanes", sorted(FILL_LANES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_ring_map_relu_is_k2_to_the_bit(dev, dtype, lanes, depth):
    """R2 against K2 on both fill routes, ±0, NaN, ±inf and int32 beyond
    2**24 (selected, never rounded) included."""
    n = (1 << 20) + 7
    g = torch.Generator(device=dev).manual_seed(3)
    if dtype == torch.int32:
        x = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g,
                          device=dev, dtype=dtype)
        x[:4] = torch.tensor([(1 << 24) + 1, -(1 << 24) - 1, (1 << 31) - 1,
                              -(1 << 31)], dtype=dtype)
    else:
        x = torch.randn(n, generator=g, device=dev).to(dtype)
        x[:5] = torch.tensor([-0.0, 0.0, float("nan"), float("-inf"),
                              float("inf")])
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    nest = compiler.elementwise_nest(n)
    (got, ring, kr), (want, sync, _) = _ring_against_sync(
        nest, relu.RELU, {"X": x}, depth, bits, mode="map", out_dtype=dtype,
        lanes=lanes)
    assert kr.pipelined and ring == {"ring_map_relu"} \
        and sync == {"map_relu"}
    call = lowering.prepare_call(nest, relu.RELU, {"X": x}, mode="map",
                                 out_dtype=dtype, schedule=dataclasses.replace(
                                     _depth(depth), lanes=lanes))
    assert _fill_route(call.kernel, call.layouts) == FILL_LANES[lanes]
    assert torch.equal(got, want)   # the bits, ``bits`` wide
    if dtype == torch.int32:
        assert got[:4].tolist() == [(1 << 24) + 1, 0, (1 << 31) - 1, 0]
    elif dtype == torch.float32:
        v = got[:5].view(torch.float32)
        assert got[:2].tolist() == [0, 0]      # -0 and +0 give +0
        assert v[2].isnan() and v[3] == 0 and v[4] == float("inf")


# lanes → R3's route in f32 on the 300 x 260 x 1100 problem: 128 the
# default (TMA: tk 384), 8 a block width tk = 24 off the 16-wide chunk
# (cp.async packs), 130 a 1170-element pitch (no 16-byte packs: element
# copies); bf16 takes the cp.async routes
GEMM_LANES = {128: "tma", 8: "cp.async", 130: "cp.async elements"}


@pytest.mark.parametrize("depth", RING_DEPTHS, ids=str)
@pytest.mark.parametrize("mnk", [(300, 260, 1100), (1024, 1024, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lanes", sorted(GEMM_LANES))
def test_ring_contract_gemm_is_k3_to_the_bit(dev, mnk, dtype, depth, lanes):
    m, n, k = mnk
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    a = torch.randn(m, k, generator=g, device=dev).to(dtype)
    b = torch.randn(k, n, generator=g, device=dev).to(dtype)
    nest, ops_ = compiler.gemm_nest(m, n, k), {"A": a, "B": b}
    call = lowering.prepare_call(nest, gemm.DOT, ops_, schedule=(
        dataclasses.replace(_depth(depth), lanes=lanes)))
    route = hopper.gemm_ring_route(call.kernel.geometry, call.layouts)
    if mnk == (300, 260, 1100):
        want_route = GEMM_LANES[lanes]
        assert route == (want_route if dtype == torch.float32 or
                         want_route != "tma" else "cp.async")
    before = dict(hopper.LAUNCHES)
    got = call.run()
    assert _launched(before) == {"ring_contract_gemm"} \
        and call.kernel.pipelined
    before = dict(hopper.LAUNCHES)
    want = lowering.prepare_call(nest, gemm.DOT, ops_, schedule=(
        lowering.Schedule(lanes=lanes))).run()
    assert _launched(before) == {"contract_gemm"}
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("depth", RING_DEPTHS, ids=str)
@pytest.mark.parametrize("mn", [(1000, 1536), (2048, 512), (300, 5000)])
@pytest.mark.parametrize("body", ["matvec", "matvec_relu"])
def test_ring_contract_gemv_is_k4_to_the_bit(dev, mn, body, depth):
    from repro_torch.kernels import chained
    m, n = mn
    g = torch.Generator(device=dev).manual_seed(m * n)
    a = torch.randn(m, n, generator=g, device=dev)
    x = torch.randn(n, generator=g, device=dev)
    fn = gemv.MATVEC if body == "matvec" else chained.MATVEC_RELU
    (got, ring, kr), (want, sync, _) = _ring_against_sync(
        compiler.gemv_nest(m, n), fn, {"A": a, "x": x}, depth)
    assert kr.pipelined and ring == {"ring_contract_gemv"} \
        and sync == {"contract_gemv"}
    assert torch.equal(got, want)


@pytest.mark.parametrize("depth", RING_DEPTHS, ids=str)
@pytest.mark.parametrize("mn", [(1024, 1536), (2048, 512), (8192, 8192)])
@pytest.mark.parametrize("body", ["matvec", "matvec_relu"])
@pytest.mark.parametrize("route", ["bulk", "elements"])
def test_ring_contract_gemv_bf16_and_its_routes_are_k4_to_the_bit(
        dev, route, body, mn, depth):
    """R4 against K4 in bf16 (out f32) on both fill routes (a view one
    element into its storage has no 16-byte rows: A's and x's element
    copies), x that never moves at (2048, 512), persistent runs of several
    output blocks on the 8192² cell; beside R4 on A's first block zeroed,
    which must differ."""
    from repro_torch.kernels import chained
    m, n = mn
    g = torch.Generator(device=dev).manual_seed(m + n)
    a = torch.randn(m * n + 1, generator=g, device=dev).bfloat16()
    x = torch.randn(n + 1, generator=g, device=dev).bfloat16()
    off = 1 if route == "elements" else 0
    a, x = a[off:off + m * n].view(m, n), x[off:off + n]
    fn = gemv.MATVEC if body == "matvec" else chained.MATVEC_RELU
    nest = compiler.gemv_nest(m, n)
    deep = lowering.prepare_call(nest, fn, {"A": a, "x": x},
                                 schedule=_depth(depth))
    kern = deep.kernel
    assert kern.pipelined
    vec = hopper._vector_width(deep.layouts[:1], kern.geometry.ins[:1])
    assert (vec > 1) == (route == "bulk")
    before = dict(hopper.LAUNCHES)
    got = deep.run()
    assert _launched(before) == {"ring_contract_gemv"}
    before = dict(hopper.LAUNCHES)
    want = lowering.prepare_call(nest, fn, {"A": a, "x": x}).run()
    assert _launched(before) == {"contract_gemv"}
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    zeroed = deep.layouts[0].clone()
    rows, cols = kern.geometry.ins[0].block
    zeroed[:rows, :cols] = 0
    control = deep.finish(kern(zeroed, *deep.layouts[1:]))
    assert not torch.equal(control.view(torch.int32), want.view(torch.int32))
    if mn == (8192, 8192):      # each CTA runs on across output blocks
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        run = hopper.ring_run_steps("ring_contract_gemv", kern.geometry,
                                    kern.ring, torch.bfloat16, sms)
        assert run > kern.geometry.contraction_steps


def test_ring_contract_gemv_spills_nothing(dev):
    """R4's every instantiation (f32 and bf16 in and out, both routes of
    A) has no local bytes; its CTAs an SM at the gemv cell's depth-4 ring
    are at least two."""
    smem = 4 * (hopper.GEMV_RING_ROWS + 1) * 512 * 4 + hopper.RING_BARRIER_BYTES
    got = hopper.kernel_attributes("ring_contract_gemv", smem)
    assert got["localSizeBytes"] == 0 and got["ctasPerSm"] >= 2


@pytest.mark.parametrize("depth", [3, 8, (2, 4)], ids=str)
def test_plain_ring_matches_the_ring_kernel(dev, depth):
    g = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(300, 1100, generator=g, device=dev)
    b = torch.randn(1100, 260, generator=g, device=dev)
    call = lowering.prepare_call(compiler.gemm_nest(300, 260, 1100),
                                 gemm.DOT, {"A": a, "B": b},
                                 schedule=_depth(depth))
    got = call.run()
    want, log = hopper.plain_ring(call.kernel.body, call.kernel.geometry,
                                  call.layouts, call.kernel.out_dtype,
                                  mode="nest", ring=call.kernel.ring)
    assert len({(i, s) for i, s, _ in log}) == len(log)
    scale = a.abs() @ b.abs()
    assert float(((got - call.finish(want)).abs() / scale).max()) \
        <= CONTRACT_LIMIT


def test_ring_over_the_budget_raises_on_the_card(dev):
    x = torch.ones(1 << 16, device=dev)
    call = lowering.prepare_call(
        compiler.dot_product_nest(1 << 16), reduction.MUL, {"A": x, "B": x},
        schedule=lowering.Schedule(rows=16, lanes=512, buffer_depth=8))
    before = dict(hopper.LAUNCHES)
    with pytest.raises(ValueError, match="ring_reduce_mul: its ring"):
        call.run()
    assert hopper.LAUNCHES == before


# -- K17 and R5: the ChainedKernel; R6: K5's chains through the ring ----------


def _chained(producer, consumer, rows=8, lanes=128):
    """A ChainedKernel over (n_rows, lanes) layouts in (rows, lanes) blocks,
    one a step; its operands as the caller gives them."""
    from repro_torch.core.ssr import BlockStream
    from repro_torch.core.stream import Direction

    def launch(static, *arrays):
        return frontend.Launch(
            grid=(arrays[0].shape[0] // rows,),
            in_streams=tuple(BlockStream((rows, lanes), lambda i: (i, 0))
                             for _ in arrays),
            out_streams=(BlockStream((rows, lanes), lambda i: (i, 0),
                                     Direction.WRITE),),
            out_shapes=(frontend.ShapeDtype(tuple(arrays[0].shape),
                                            arrays[0].dtype),))

    return frontend.ChainedKernel(
        "chained", prepare=lambda *xs: (xs, None, None), launch=launch,
        producer=lambda s: producer, consumer=lambda s: consumer,
        lowering_waiver="a test instance")


def _pairs():
    from repro_torch.kernels import chained
    producers = {"identity": chained.IDENTITY, "relu": relu.RELU,
                 "sq_diff": chained.SQ_DIFF, "axpy": chained.axpy_block(0.3),
                 "mul": chained.DOT}
    consumers = {"identity": chained.IDENTITY, "relu": relu.RELU}
    return [(producers[p], consumers[c]) for p, c in hopper.CHAINED_PROGRAMS]


@pytest.mark.parametrize("depth", [2, 3, 4, 8])
@pytest.mark.parametrize("lanes", [128, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pair", range(10))
def test_chained_map_every_program_to_the_bit(dev, pair, dtype, lanes, depth):
    """Every producer and consumer pair, 16-byte packs (128 lanes) and
    element accesses (130), each depth: K17 against its plain version to
    the bit, and R5 against K17."""
    producer, consumer = _pairs()[pair]
    n_in = hopper.CHAINED_PRODUCERS[producer.op][0]
    g = torch.Generator(device=dev).manual_seed(pair)
    xs = [torch.randn(40, lanes, generator=g, device=dev).to(dtype)
          for _ in range(n_in)]
    if producer.op in ("identity", "relu"):     # selections: ±0, NaN
        xs[0][0, :3] = torch.tensor([-0.0, float("nan"), 0.0])
    kern = _chained(producer, consumer, lanes=lanes)
    parts = kern.parts(*xs, schedule=_depth(depth), device=dev)
    before = dict(hopper.LAUNCHES)
    got = parts.run()[0]
    torch.cuda.synchronize()
    assert _launched(before) == ({"ring_chained_map"} if depth > 2
                                 else {"chained_map"})
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), parts.plain()[0].view(bits))
    k17 = kern.parts(*xs, device=dev).run()[0]
    assert torch.equal(got.view(bits), k17.view(bits))


@pytest.mark.parametrize("depth", [2, 3, 8])
@pytest.mark.parametrize("shape", [(8, 512), (24, 1536), (1032, 4096)])
def test_chained_map_invariant_stream(dev, shape, depth):
    """relu(x·w) on a 2-D grid, w one invariant (8, 512) block."""
    from repro_torch.core.ssr import BlockStream
    from repro_torch.core.stream import Direction
    from repro_torch.kernels import chained

    def launch(static, x, w):
        r, c = x.shape
        return frontend.Launch(
            grid=(r // 8, c // 512),
            in_streams=(BlockStream((8, 512), lambda i, j: (i, j)),
                        BlockStream((8, 512), lambda i, j: (0, 0))),
            out_streams=(BlockStream((8, 512), lambda i, j: (i, j),
                                     Direction.WRITE),),
            out_shapes=(frontend.ShapeDtype(tuple(x.shape), x.dtype),))

    kern = frontend.ChainedKernel(
        "scale_relu", prepare=lambda x, w: ((x, w), None, None),
        launch=launch, producer=lambda s: chained.DOT,
        consumer=lambda s: relu.RELU, lowering_waiver="a test instance")
    g = torch.Generator(device=dev).manual_seed(shape[0])
    x = torch.randn(*shape, generator=g, device=dev)
    w = torch.randn(8, 512, generator=g, device=dev)
    got = kern(x, w, schedule=_depth(depth))
    assert torch.equal(got.view(torch.int32),
                       torch.relu(x * w.repeat(shape[0] // 8, shape[1] // 512)
                                  ).view(torch.int32))


def test_untagged_chained_body_raises_on_the_card(dev):
    kern = _chained(lambda a, b: a + b, relu.RELU)
    x = torch.ones(16, 128, device=dev)
    with pytest.raises(LoweringError, match="no Hopper chained kernel"):
        kern(x, x)


def _chain_call(kind, n, sched, dev):
    from repro_torch.kernels import chained
    g = torch.Generator(device=dev).manual_seed(n)
    x, y, w = (torch.rand(n, generator=g, device=dev) for _ in range(3))
    pair = compiler.elementwise_nest(n, ("X", "Y"), 2)
    if kind == "sum_sq_diff":
        return lowering.prepare_chain_call(
            chained._chain_nests(n, False),
            (chained.SQ_DIFF, chained.IDENTITY), {"X": x, "Y": y},
            mode="reduce", schedule=sched)
    if kind == "axpy_dot":
        return lowering.prepare_chain_call(
            chained._chain_nests(n, True),
            (chained.axpy_block(0.3), chained.DOT),
            {"X": x, "Y": y, "W": w}, mode="reduce", schedule=sched)
    if kind == "sq_diff":
        return lowering.prepare_call(pair, chained.SQ_DIFF,
                                     {"X": x, "Y": y}, mode="map",
                                     schedule=sched)
    if kind == "axpy":
        return lowering.prepare_call(pair, chained.axpy_block(0.3),
                                     {"X": x, "Y": y}, mode="map",
                                     schedule=sched)
    return lowering.prepare_call(compiler.elementwise_nest(n, ("T",), 1),
                                 chained.IDENTITY, {"T": x}, schedule=sched)


R6_DEPTHS = {"sum_sq_diff": [3, 4, 8, (2, 4), (4, 2)],
             "axpy_dot": [3, 4, 8, (2, 4, 3), (4, 2, 2)],
             "sq_diff": [3, 4, 8, (2, 4), (4, 2)],
             "axpy": [3, 4, 8, (2, 4), (4, 2)],
             "identity": [3, 4, 8]}


@pytest.mark.parametrize("case", [(k, d) for k, ds in R6_DEPTHS.items()
                                  for d in ds], ids=str)
@pytest.mark.parametrize("n", [5001, (1 << 20) + 3])
def test_ring_chain_elem_is_k5_to_the_bit(dev, n, case):
    kind, depth = case
    ring = _chain_call(kind, n, _depth(depth), dev)
    sync = _chain_call(kind, n, lowering.DEFAULT_SCHEDULE, dev)
    assert ring.kernel.pipelined and not sync.kernel.pipelined
    before = dict(hopper.LAUNCHES)
    got = ring.run()
    torch.cuda.synchronize()
    assert _launched(before) == {"ring_chain_elem"}
    before = dict(hopper.LAUNCHES)
    want = sync.run()
    assert _launched(before) == {"chain_elem"}
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# -- R7–R9: the DAGs of K6–K8 through the ring ------------------------------

_DAG_KERNEL = {"layernorm": "dag_layernorm",
               "softmax_xent": "dag_softmax_xent", "mlp_block": "dag_mlp"}


def _dag_instances(name, rows, dev):
    """Every instantiation a legal cut of the family's DAG runs, as
    ``stages -> (nests, bodies, operands, mode, uniforms)``, each on the
    values the sync kernels before it produced."""
    from repro_torch.core import autotune
    case, args = _dag_case(name, rows, rows)
    args = tuple(a.to(dev) for a in args)
    nests, bodies, operands, mode, uniforms = case.spec(*args)
    graph = lowering._dag_for(nests, None)
    out = {}
    for cut in autotune.enumerate_cuts(graph):
        if not autotune.dag_cut_is_legal(graph, cut, nests=nests,
                                         bodies=bodies, mode=mode,
                                         uniforms=uniforms, device=dev)[0]:
            continue
        env = dict(operands)
        for comp in lowering.dag_components(graph, nests, bodies, cut,
                                            mode=mode):
            inst = (comp.nests, comp.bodies, dict(env), comp.mode, uniforms)
            out.setdefault(comp.stages, inst)
            if comp.exported is not None:
                env[comp.exported] = _dag_instance_call(
                    inst, lowering.DEFAULT_SCHEDULE).run()
    return out


def _dag_instance_call(inst, sched):
    nests, bodies, env, mode, uniforms = inst
    if len(nests) == 1:
        return lowering.prepare_call(nests[0], bodies[0], env, mode=mode,
                                     schedule=sched, uniforms=uniforms)
    return lowering.prepare_dag_call(nests, bodies, env, mode=mode,
                                     schedule=sched, uniforms=uniforms)


# one per-stream case a family, on the instantiation that reads the most
# streams: layernorm's normalise (C, V), softmax_xent's loss (C, E, P),
# the MLP's residual (H, Y)
DAG_RING_PAIRS = {"layernorm": ((2,), (2, 4)),
                  "softmax_xent": ((2,), (2, 4, 3)),
                  "mlp_block": ((2,), (4, 2))}


@pytest.mark.parametrize("depth", [3, 8, "pair"], ids=str)
@pytest.mark.parametrize("rows", [37, 1001, 20011])
@pytest.mark.parametrize("name", ["layernorm", "softmax_xent", "mlp_block"])
def test_ring_dag_is_its_k_kernel_to_the_bit(dev, name, rows, depth):
    """R7–R9 on every instantiation of K6–K8 give the K kernel's bits, and
    launch their ring kernel alone; the depth-2 call its K kernel alone."""
    kname = _DAG_KERNEL[name]
    insts = _dag_instances(name, rows, dev)
    assert set(insts) == {(0, 1, 2), (0,), (1,), (2,), (1, 2)}
    if depth == "pair":
        stages, pair = DAG_RING_PAIRS[name]
        todo = {stages: lowering.Schedule(stream_depths=pair)}
    else:
        todo = {s: lowering.Schedule(buffer_depth=depth) for s in insts}
    for stages, sched in todo.items():
        ring = _dag_instance_call(insts[stages], sched)
        sync = _dag_instance_call(insts[stages], lowering.DEFAULT_SCHEDULE)
        assert ring.kernel.pipelined and not sync.kernel.pipelined, stages
        before = dict(hopper.LAUNCHES)
        got = ring.run()
        assert _launched(before) == {f"ring_{kname}"}, stages
        before = dict(hopper.LAUNCHES)
        want = sync.run()
        assert _launched(before) == {kname}, stages
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            (stages, float((got - want).abs().max()))


@pytest.mark.parametrize("name", ["layernorm", "softmax_xent", "mlp_block"])
def test_ring_dag_entry_point_launches_the_ring(dev, name):
    case, args = _dag_case(name, 1001, 3)
    args = tuple(a.to(dev) for a in args)
    kname = _DAG_KERNEL[name]
    before = dict(hopper.LAUNCHES)
    got = case.fused(*args, schedule=lowering.Schedule(buffer_depth=4),
                     device=dev)
    assert _launched(before) == {f"ring_{kname}"}
    want = case.fused(*args, schedule=lowering.DEFAULT_SCHEDULE, device=dev)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_ring_dag_mlp_over_the_budget_raises_on_the_card(dev):
    case, args = _dag_case("mlp_block", 1001, 5)
    args = tuple(a.to(dev) for a in args)
    nests, bodies, operands, mode, uniforms = case.spec(*args)
    call = lowering.prepare_dag_call(
        nests, bodies, operands, mode=mode, uniforms=uniforms,
        schedule=lowering.Schedule(rows=16, buffer_depth=8))
    before = dict(hopper.LAUNCHES)
    with pytest.raises(LoweringError, match="ring_dag_mlp: its ring at "
                       r"depths \(8, 8, 8, 8, 8\)") as err:
        call.run()
    assert str(hopper.SMEM_OPTIN_BYTES) in str(err.value)
    assert hopper.LAUNCHES == before


# -- the halo and attention rings (R10–R12) -----------------------------------


def _zeroed_end_blocks(call):
    """The call's layouts with every moving stream's first and last blocks
    zeroed (a head batch: every head's): what a ring that delivered another
    block in a slot would have read.  The last block too, since a mask can
    hide the first from every query (a sliding window)."""
    out = []
    for t, agu in zip(call.layouts, call.kernel.geometry.ins):
        if any(any(c) for c in agu.coeffs):
            t = t.clone()
            rows, cols = agu.block
            t[..., :rows, :cols] = 0
            t[..., -rows:, -cols:] = 0
        out.append(t)
    return tuple(out)


def _ring_is_sync(make, depth, sync, ring):
    """``make(schedule)``'s call at ``depth`` (pipelined, launching only
    ``ring``) against its depth-2 twin (launching only ``sync``), to the
    bit, beside the ring on the end blocks zeroed, which must differ."""
    deep, flat = make(_depth(depth)), make(lowering.DEFAULT_SCHEDULE)
    assert deep.kernel.pipelined and not flat.kernel.pipelined
    assert hopper.RING_KERNELS[deep.kernel.device_key] == ring
    before = dict(hopper.LAUNCHES)
    got = deep.run()
    assert _launched(before) == {ring}
    before = dict(hopper.LAUNCHES)
    want = flat.run()
    assert _launched(before) == {sync}
    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    assert torch.equal(got.contiguous().view(bits), want.contiguous().view(bits)), \
        float((got.float() - want.float()).abs().max())
    zeroed = deep.finish(deep.kernel(*_zeroed_end_blocks(deep)))
    assert not torch.equal(zeroed.contiguous().view(bits),
                           want.contiguous().view(bits))


@pytest.mark.parametrize("depth", [3, 4, 8, (4, 2, 2), (2, 4, 2)], ids=str)
@pytest.mark.parametrize("n", [1025, 5000, (1 << 20) + 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drain", ["stencil1d", "stencil1d_relu"])
def test_ring_halo_stencil1d_is_k9_to_the_bit(dev, drain, dtype, n, depth):
    from repro_torch.kernels import chained, stencil
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n + 10, generator=g, device=dev).to(dtype)
    w = (torch.randn(11, generator=g, device=dev) * 0.3).to(dtype)
    body = chained.STENCIL1D_RELU if drain == "stencil1d_relu" \
        else stencil.STENCIL1D
    for extra in ({}, {"lanes": 256, "lanes_tile_factor": 8}):
        def make(sched):
            sched = dataclasses.replace(sched, **extra)
            return lowering.prepare_call(compiler.stencil_nest(n, 11), body,
                                         {"x": x, "w": w}, schedule=sched,
                                         device=dev)
        if make(lowering.DEFAULT_SCHEDULE).kernel.geometry.steps == 1:
            continue      # a one-step grid never stages
        _ring_is_sync(make, depth, "halo_stencil1d", "ring_halo_stencil1d")


@pytest.mark.parametrize("depth", [3, 4, 8, (4, 2, 2, 2, 2, 2)], ids=str)
@pytest.mark.parametrize("hw", [(37, 53), (300, 260), (1000, 700)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_halo_stencil2d_is_k10_to_the_bit(dev, dtype, hw, depth):
    from repro_torch.kernels import stencil
    h, wd = hw
    g = torch.Generator(device=dev).manual_seed(h * wd)
    x = torch.randn(h + 10, wd + 10, generator=g, device=dev).to(dtype)
    wx = (torch.randn(11, generator=g, device=dev) * 0.3).to(dtype)
    wy = (torch.randn(11, generator=g, device=dev) * 0.3).to(dtype)
    for extra in ({}, {"rows": 16, "lanes_tile_factor": 1}):
        def make(sched):
            sched = dataclasses.replace(sched, **extra)
            return lowering.prepare_call(compiler.stencil2d_nest(h, wd, 11),
                                         stencil.STENCIL2D,
                                         {"x": x, "wx": wx, "wy": wy},
                                         schedule=sched, device=dev)
        if make(lowering.DEFAULT_SCHEDULE).kernel.geometry.steps == 1:
            continue      # a one-step grid never stages
        _ring_is_sync(make, depth, "halo_stencil2d", "ring_halo_stencil2d")


ATTENTION_RING_SHAPES = [(100, 333, 80, True, 64), (129, 130, 128, True, 7),
                         (256, 600, 64, False, None), (300, 500, 192, True, None),
                         (130, 700, 256, False, None), (96, 400, 256, True, 64)]


@pytest.mark.parametrize("depth", [3, 4, (4, 4, 2), (2, 4, 2), (4, 2, 2)],
                         ids=str)
@pytest.mark.parametrize("shape", ATTENTION_RING_SHAPES, ids=str)
def test_ring_rescale_attention_is_k11_to_the_bit(dev, shape, depth):
    from repro_torch.kernels import attention
    sq, sk, d, causal, window = shape
    q, k, v = _qkv(dev, sq, sk, d, sq + sk + d)
    _, static, _ = attention._prepare(q, k, v, causal, window)
    for extra in ({}, {"rows": 16}):
        def make(sched):
            sched = dataclasses.replace(sched, **extra)
            return lowering.prepare_call(attention._nest(static),
                                         attention._body(static),
                                         {"Q": q, "K": k, "V": v},
                                         schedule=sched, device=dev)
        if make(lowering.DEFAULT_SCHEDULE).kernel.geometry.steps == 1:
            continue
        _ring_is_sync(make, depth, "rescale_attention",
                      "ring_rescale_attention")


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("d", [80, 256])
def test_ring_rescale_attention_bf16_and_head_batch(dev, d, out):
    from repro_torch.kernels import attention
    q, k, v = _qkv(dev, 100, 333, d, 4, lead=(2, 3), dtype=torch.bfloat16)
    out_dtype = torch.bfloat16 if out == "bf16" else torch.float32
    _, static, _ = attention._prepare(q[0, 0], k[0, 0], v[0, 0], True, 64)

    def make(sched):
        one = lowering.prepare_call(
            attention._nest(static), attention._body(static),
            {"Q": q[0, 0], "K": k[0, 0], "V": v[0, 0]}, out_dtype=out_dtype,
            schedule=sched, device=dev)
        batch = {"Q": q.reshape(6, 100, d), "K": k.reshape(6, 333, d),
                 "V": v.reshape(6, 333, d)}
        layouts = lowering.stream_layouts(
            one.lowered, [batch[s.name] for s in one.lowered.in_streams],
            lead=(6,))
        return lowering.PreparedCall(kernel=one.kernel, layouts=layouts,
                                     lowered=one.lowered, bounds=one.bounds)
    _ring_is_sync(make, 4, "rescale_attention", "ring_rescale_attention")


def test_ring_entry_points_launch_the_rings(dev):
    """The entry points at depth 4 launch R10–R12, at depth 2 K9–K11."""
    from repro_torch.kernels import attention, chained, stencil
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(70000 + 10, generator=g, device=dev)
    w = torch.randn(11, generator=g, device=dev) * 0.3
    x2 = torch.randn(1010, 1010, generator=g, device=dev)
    q, k, v = _qkv(dev, 512, 512, 128, 5, lead=(4,))
    deep, flat = lowering.Schedule(buffer_depth=4), lowering.DEFAULT_SCHEDULE
    for fn, ring, sync in (
            (lambda s: stencil.ssr_stencil1d(x, w, schedule=s, device=dev),
             "ring_halo_stencil1d", "halo_stencil1d"),
            (lambda s: chained.fused_stencil1d_relu(x, w, schedule=s,
                                                    device=dev),
             "ring_halo_stencil1d", "halo_stencil1d"),
            (lambda s: stencil.ssr_stencil2d(x2, w, w, schedule=s,
                                             device=dev),
             "ring_halo_stencil2d", "halo_stencil2d"),
            (lambda s: attention.ssr_flash_attention(
                q, k, v, causal=True, schedule=s, device=dev),
             "ring_rescale_attention", "rescale_attention")):
        before = dict(hopper.LAUNCHES)
        got = fn(deep)
        assert _launched(before) == {ring}
        before = dict(hopper.LAUNCHES)
        want = fn(flat)
        assert _launched(before) == {sync}
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("d", [128, 256])
def test_ring_rescale_attention_refuses_depth_8(dev, d):
    from repro_torch.kernels import attention
    q, k, v = _qkv(dev, 300, 600, d, 8)
    _, static, _ = attention._prepare(q, k, v, True, None)
    call = lowering.prepare_call(attention._nest(static),
                                 attention._body(static),
                                 {"Q": q, "K": k, "V": v},
                                 schedule=lowering.Schedule(buffer_depth=8),
                                 device=dev)
    kern = call.kernel
    takes, why = hopper.accepts(kern.device_key, kern.geometry, q.dtype, dev,
                                **kern.device_args())
    assert not takes and why.startswith("ring_rescale_attention: its ring")
    before = dict(hopper.LAUNCHES)
    with pytest.raises(ValueError, match=r"ring_rescale_attention: its ring "
                       r"at depths \(8, 8, 8\)") as err:
        call.run()
    assert str(hopper.SMEM_OPTIN_BYTES) in str(err.value)
    assert hopper.LAUNCHES == before


# -- the gather and scan rings (R13–R15) ----------------------------------------


GATHER_RING = {"spmv": ("gather_spmv", "ring_gather_spmv"),
               "spmm": ("gather_spmm", "ring_gather_spmm")}


def _gather_make(kind, case, c, dev, extra):
    """``make(schedule)`` of a sparse case (``hpcg16``: HPCG's operator on
    16**3, 4096 rows): its prepared call at the schedule with ``extra``
    replaced."""
    from repro_torch.kernels import sparse
    if case == "hpcg16":
        data, indices, indptr = (t.numpy() for t in
                                 sparse.hpcg_operator(16, 16, 16))
        n = 4096
    else:
        data, indices, indptr, n = _csr_case(case, 6)
    vals, cidx, m, k = _ell_on(dev, data, indices, indptr, n)
    g = torch.Generator(device=dev).manual_seed(n + c)
    if kind == "spmv":
        ops_ = {"vals": vals, "cidx": cidx,
                "x": torch.randn(n, generator=g, device=dev)}
        nest, body = compiler.spmv_nest(m, k), sparse.SPMV
    else:
        pitch = -(-c // 128) * 128
        ops_ = {"vals": vals, "cidx": cidx, "X": torch.nn.functional.pad(
            torch.randn(n, c, generator=g, device=dev), (0, pitch - c))}
        nest, body = compiler.spmm_nest(m, c, k, pitch), sparse.SPMM

    def make(sched):
        return lowering.prepare_call(nest, body, ops_,
                                     schedule=dataclasses.replace(sched,
                                                                  **extra),
                                     device=dev)
    return make


def _forced_ring(call, depth, rname, layouts=None):
    """R13/R14 on the call's geometry at ``depth`` whatever its grid (a
    one-step grid, which the entry points never stage), on the call's
    layouts or on ``layouts``: its output and what it launched, or None and
    nothing launched where ``accepts`` refuses the ring (by the kernel's
    name, with the same message the wrapper raises)."""
    kern = call.kernel
    layouts = call.layouts if layouts is None else layouts
    ring = agu.RingProgram((depth,) * (len(kern.depths) - 1) + (2,),
                           kern.invariant)
    takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                torch.float32, call.layouts[0].device,
                                program=kern.program, ring=ring)
    before = dict(hopper.LAUNCHES)
    if not takes:
        assert why.startswith(f"{rname}: its ring at depths")
        with pytest.raises(ValueError) as err:
            kern.device_kernel()(kern.geometry, layouts, kern.out_dtype,
                                 kern.acc_dtype, program=kern.program,
                                 ring=ring)
        assert str(err.value) == why and hopper.LAUNCHES == before
        return None, set()
    out = kern.device_kernel()(kern.geometry, layouts, kern.out_dtype,
                               kern.acc_dtype, program=kern.program,
                               ring=ring)
    return call.finish(out), _launched(before)


@pytest.mark.parametrize("depth", RING_DEPTHS, ids=str)
@pytest.mark.parametrize("case", ["row300", "row600", "hpcg16"])
@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_ring_gather_is_its_k_kernel_to_the_bit(dev, kind, case, depth):
    """R13/R14 against K12/K13 at every depth their budget admits (a depth
    it does not admit is refused by name, launching nothing), beside the
    ring on the end blocks zeroed, which must differ."""
    sync, ring = GATHER_RING[kind]
    for extra in ({}, {"lanes_tile_factor": 1, "rows_tile_factor": 2}):
        make = _gather_make(kind, case, 200, dev, extra)
        if make(lowering.DEFAULT_SCHEDULE).kernel.geometry.steps == 1:
            continue      # a one-step grid never stages
        deep = make(_depth(depth))
        kern = deep.kernel
        takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                    torch.float32, dev, **kern.device_args())
        if not takes:
            assert why.startswith(f"{ring}: its ring at depths")
            before = dict(hopper.LAUNCHES)
            with pytest.raises(ValueError, match=f"{ring}: its ring"):
                deep.run()
            assert hopper.LAUNCHES == before
            continue
        _ring_is_sync(make, depth, sync, ring)


@pytest.mark.parametrize("kind, c", [("spmv", 1), ("spmm", 1), ("spmm", 200)])
@pytest.mark.parametrize("case", SPARSE_CASES)
def test_ring_gather_on_the_odd_inputs_is_its_k_kernel(dev, case, kind, c):
    """R13/R14 at depth 4 on the odd inputs (the all-zero matrix, empty
    rows, 1 × 1, rows of 300 and 600 entries, c = 200), launched on their
    geometry directly (most are one-step grids), to K12's/K13's bits,
    beside the ring on vals' first block zeroed, which must differ
    wherever the product is not all zero; R13 refuses the rows of 300 and
    600 by name where their slots (64 rows of the block's valid width, and
    its barriers) are over the budget."""
    sync, ring = GATHER_RING[kind]
    for extra in ({}, {"lanes_tile_factor": 1, "rows_tile_factor": 2}):
        make = _gather_make(kind, case, c, dev, extra)
        call = make(lowering.DEFAULT_SCHEDULE)
        before = dict(hopper.LAUNCHES)
        want = call.run()
        assert _launched(before) == {sync}
        # the ring reads the padded layouts (K12 ran on pack_ell's planes)
        padded = call.padded_layouts()
        got, launched = _forced_ring(call, 4, ring, padded)
        if got is None:
            assert kind == "spmv" and case in ("row300", "row600")
            continue
        assert launched == {ring}
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        # vals' first block zeroed (a one-step grid moves no block, so
        # _zeroed_end_blocks would zero none)
        vals = padded[0].clone()
        rows, cols = call.kernel.geometry.ins[0].block
        vals[:rows, :cols] = 0
        control, _ = _forced_ring(call, 4, ring, (vals, *padded[1:]))
        assert torch.equal(control.view(torch.int32),
                           want.view(torch.int32)) == (case == "zero")


@pytest.mark.parametrize("depth", [3, 4, 8], ids=str)
@pytest.mark.parametrize("n", [5000, 1 << 20, (1 << 22) + 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_ring_stream_scan_is_k14_to_the_bit(dev, dtype, n, depth):
    """R15 against K14 to the bit, one wrapper launch (its one pass),
    beside R15 on the first block zeroed, which must differ."""
    from repro_torch.kernels import scan
    g = torch.Generator(device=dev).manual_seed(n + depth)
    if dtype == torch.int32:
        x = torch.randint(-1000, 1000, (n,), generator=g, device=dev,
                          dtype=dtype)
    else:
        x = torch.randn(n, generator=g, device=dev).to(dtype)
    sched = lowering.Schedule(buffer_depth=depth)
    before = dict(hopper.LAUNCHES)
    got = scan._ssr(x, schedule=sched, device=dev)
    assert _launched(before) == {"ring_stream_scan"}
    before = dict(hopper.LAUNCHES)
    want = scan.ssr_scan(x, device=dev)
    assert _launched(before) == {"stream_scan"}
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    zeroed = x.clone()
    zeroed[:1024] = 0
    ctrl = scan._ssr(zeroed, schedule=sched, device=dev)
    assert not torch.equal(ctrl.view(torch.int32), want.view(torch.int32))
    # the plain ring (one run) against R15, within the scan limit
    lc, arrays, body = _stream(scan, x)
    entry = scan._ssr._build(None, arrays, sched)
    if n <= 5000:
        plain = hopper.plain_stream(body, lc, arrays, ring=entry.ring)[0]
        exact = torch.cumsum(x.double(), 0)
        scale = torch.cumsum(x.double().abs(), 0) + 1e-30
        assert float(((plain.reshape(-1)[:n].double() - exact).abs()
                      / scale).max()) <= SCAN_LIMIT


def test_ring_stream_scan_one_block_stays_k14(dev):
    from repro_torch.kernels import scan
    x = torch.randn(1000, device=dev)
    before = dict(hopper.LAUNCHES)
    got = scan._ssr(x, schedule=lowering.Schedule(buffer_depth=4), device=dev)
    assert _launched(before) == {"stream_scan"}
    assert torch.equal(got, scan.ssr_scan(x, device=dev))


def _r15_and_k14(x, depth):
    """R15 and K14 launched on the scan's Launch over ``x``, at ``depth``
    whatever its grid (one block, which the entry never stages, too)."""
    from repro_torch.kernels import scan
    arrays, static, _ = scan._prepare(x)
    lc = scan._launch(static, *arrays)
    ring = agu.RingProgram((depth,), (False,))
    before = dict(hopper.LAUNCHES)
    got = hopper.ring_stream_scan(lc, arrays[0], ring)[0]
    assert _launched(before) == {"ring_stream_scan"}
    return got, hopper.stream_scan(lc, arrays[0])[0]


@pytest.mark.parametrize("depth", [3, 4, 8], ids=str)
@pytest.mark.parametrize("n", [1024, 4096, (1 << 26) - 1024, (1 << 26) + 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_ring_stream_scan_one_pass_is_k14_at_the_edges(dev, dtype, n, depth):
    """R15's one pass against K14 to the bit at one block, one tile, and
    2**26 ± 1024 (a partial last tile, a fifth chunk of totals): int32 to
    ±2**30, so its rounding to f32 shows; beside R15 on the first block
    zeroed, which must differ."""
    g = torch.Generator(device=dev).manual_seed(n + depth)
    if dtype == torch.int32:
        x = torch.randint(-(1 << 30), 1 << 30, (n,), generator=g, device=dev,
                          dtype=dtype)
    else:
        x = torch.randn(n, generator=g, device=dev).to(dtype)
    got, want = _r15_and_k14(x, depth)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    x[:1024] = 0
    ctrl, _ = _r15_and_k14(x, depth)
    assert not torch.equal(ctrl.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("depth", [3, 4, 8], ids=str)
def test_ring_stream_scan_signed_zeros_and_nan_as_k14(dev, depth):
    """A vector of ±0 scans to +0 everywhere, as K14's (the offsets' chain
    starts from 0.f); a NaN turns its own output and every later one to NaN
    and no earlier one."""
    g = torch.Generator(device=dev).manual_seed(depth)
    n = 1 << 20
    z = torch.zeros(n, device=dev)
    z[torch.rand(n, generator=g, device=dev) < 0.5] = -0.0
    for x in (z, z.bfloat16()):
        got, want = _r15_and_k14(x, depth)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert not bool(torch.signbit(got).any())
    x = torch.randn(n, generator=g, device=dev)
    x[300_000] = float("nan")
    got, want = _r15_and_k14(x, depth)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    flat = got.reshape(-1)               # the padded (rows, 128) layout
    assert bool(torch.isnan(flat[300_000:]).all())
    assert not bool(torch.isnan(flat[:300_000]).any())


def test_ring_stream_scan_gives_the_same_bits_every_run(dev):
    """Tiles finish in any order; the offsets do not depend on it."""
    from repro_torch.kernels import scan
    g = torch.Generator(device=dev).manual_seed(26)
    x = torch.randn(1 << 26, generator=g, device=dev)
    sched = lowering.Schedule(buffer_depth=4)
    first = scan._ssr(x, schedule=sched, device=dev)
    for _ in range(5):
        again = scan._ssr(x, schedule=sched, device=dev)
        assert torch.equal(again.view(torch.int32), first.view(torch.int32))


def test_ring_stream_scan_is_one_kernel_that_spills_nothing(dev):
    """One device kernel a call (its state zeroed by a memset, no kernel),
    by the profiler; no local bytes; at least one CTA an SM at depth 4 in
    f32."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import scan
    x = torch.randn(1 << 22, device=dev)
    sched = lowering.Schedule(buffer_depth=4)
    scan._ssr(x, schedule=sched, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scan._ssr(x, schedule=sched, device=dev)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if "ring_scan_tiles" in e.key]
    calls = sum(e.count for e in prof.key_averages()
                if "ring_scan_tiles" in e.key)
    assert names and calls == 1
    attrs = hopper.kernel_attributes(
        "ring_stream_scan", 4 * hopper.SCAN_TILE * 4
        + hopper.SCAN_RING_STAGED_BYTES)
    assert attrs["localSizeBytes"] == 0 and attrs["ctasPerSm"] >= 1


def test_stream_scan_is_one_kernel_after_a_memset_that_spills_nothing(dev):
    """K14 reads x once: one device kernel a call (its state zeroed by a
    memset, no kernel), by the profiler, none of the three-launch design's;
    no local bytes; at least one CTA an SM."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import scan
    x = torch.randn(1 << 22, device=dev)
    scan.ssr_scan(x, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scan.ssr_scan(x, device=dev)
        torch.cuda.synchronize()
    keys = [e.key for e in prof.key_averages()]
    calls = sum(e.count for e in prof.key_averages()
                if "::scan_tiles<" in e.key)
    assert calls == 1
    assert not any("tile_totals" in k or "exclusive_offsets" in k
                   or "ring_scan_tiles" in k for k in keys)
    attrs = hopper.kernel_attributes("stream_scan")
    assert attrs["localSizeBytes"] == 0 and attrs["ctasPerSm"] >= 1


@pytest.mark.parametrize("n", [1024, 4096, 5000, (1 << 22) + 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_stream_scan_keeps_the_three_launch_designs_bits(dev, dtype, n):
    """K14 in one pass gives the bits of the three-launch scan it replaced
    (``hopper.scan_model``: that design's association in numpy float32),
    and R15 at depth 4 gives K14's."""
    from repro_torch.kernels import scan
    g = torch.Generator(device=dev).manual_seed(n)
    if dtype == torch.int32:
        x = torch.randint(-(1 << 30), 1 << 30, (n,), generator=g, device=dev,
                          dtype=dtype)
    else:
        x = torch.randn(n, generator=g, device=dev).to(dtype)
    got, want = _r15_and_k14(x, 4)
    padded = scan._prepare(x)[0][0].reshape(-1).cpu()
    model = hopper.scan_model(padded.numpy().astype(np.float32)
                              if dtype == torch.int32
                              else padded.float().numpy())
    assert torch.equal(want.reshape(-1).cpu().view(torch.int32),
                       torch.from_numpy(model).view(torch.int32))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_base_scan_is_one_kernel_after_a_memset_that_spills_nothing(dev):
    """B8 reads x once: one device kernel a call (its state zeroed by a
    memset, no kernel), by the profiler, none of the three-launch design's;
    no local bytes in any dtype; at least one CTA an SM."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import scan
    x = torch.randn(1 << 22, device=dev)
    scan.baseline_scan(x, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scan.baseline_scan(x, device=dev)
        torch.cuda.synchronize()
    keys = [e.key for e in prof.key_averages()]
    calls = sum(e.count for e in prof.key_averages()
                if "base_scan_tiles<" in e.key)
    assert calls == 1
    assert not any("walk_tile" in k or "exclusive_offsets" in k
                   for k in keys)
    attrs = hopper.kernel_attributes("base_scan")
    assert attrs["localSizeBytes"] == 0 and attrs["ctasPerSm"] >= 1


@pytest.mark.parametrize("n", [1024, 4096, 5000, (1 << 22) + 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_base_scan_keeps_the_three_launch_designs_bits(dev, dtype, n):
    """B8 in one pass gives the bits of the three-launch B8 it replaced
    (``hopper.base_scan_model``: that design's association in numpy
    float32), the same every run."""
    from repro_torch.kernels import scan
    g = torch.Generator(device=dev).manual_seed(n)
    if dtype == torch.int32:
        x = torch.randint(-(1 << 30), 1 << 30, (n,), generator=g, device=dev,
                          dtype=dtype)
    else:
        x = torch.randn(n, generator=g, device=dev).to(dtype)
    padded = scan._prepare(x)[0][0]
    got = hopper.base_scan(padded)
    flat = padded.reshape(-1).cpu()
    model = hopper.base_scan_model(flat.numpy().astype(np.float32)
                                   if dtype == torch.int32
                                   else flat.float().numpy())
    assert torch.equal(got.reshape(-1).cpu().view(torch.int32),
                       torch.from_numpy(model).view(torch.int32))
    assert torch.equal(hopper.base_scan(padded).view(torch.int32),
                       got.view(torch.int32))


def test_reduce_mul_is_one_kernel_and_k1_k2_spill_nothing(dev):
    """K1 folds its partials in its own launch: one device kernel a call,
    by the profiler, and none of the two-launch design's fold; K1 and K2
    have no local bytes in any build and reach the CTAs an SM K1's split
    counts on (``hopper.REDUCE_CTAS_PER_SM``)."""
    from torch.profiler import ProfilerActivity, profile
    n = 1 << 22
    x = torch.rand(n, device=dev)
    call = lowering.prepare_call(compiler.dot_product_nest(n), reduction.MUL,
                                 {"A": x, "B": x}, device=dev)
    call.run()
    torch.cuda._sleep(1000)            # the marks' kernel loaded
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):      # a trace can lose a kernel's record, not add one
        # the call between two marks, with the host paused on each side,
        # inside the profiler's window (chip_smoke.py's traced_kernels)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.05)
            torch.cuda._sleep(100_000)
            call.run()
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            time.sleep(0.05)
        events = prof.key_averages()
        assert not any("fold_partials" in e.key for e in events)
        counts.append(sum(e.count for e in events
                          if "reduce_mul_kernel<" in e.key))
        if counts[-1] == 1:
            break
    assert max(counts) == 1, counts
    for name in ("reduce_mul", "map_relu"):
        attrs = hopper.kernel_attributes(name)
        assert attrs["localSizeBytes"] == 0, name
        assert attrs["ctasPerSm"] >= hopper.REDUCE_CTAS_PER_SM, name


@pytest.mark.parametrize("n", [1000, (1 << 20) - 1024, (1 << 20) + 1024,
                               (1 << 24) + 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off", [0, 1])
def test_reduce_mul_keeps_the_two_launch_designs_bits(dev, dtype, n, off):
    """K1 in one launch, reading ahead, gives the bits of the two-launch K1
    it replaced (``hopper.reduce_mul_model``), in 16-byte packs and on
    views one element off a 16-byte boundary (one element an access), the
    same every run, and R1 at depth 4 gives them too."""
    g = torch.Generator(device=dev).manual_seed(n + off)
    x = torch.rand(n + 1, generator=g, device=dev).to(dtype)[off:off + n]
    y = torch.rand(n + 1, generator=g, device=dev).to(dtype)[off:off + n]
    nest = compiler.dot_product_nest(n)
    call = lowering.prepare_call(nest, reduction.MUL, {"A": x, "B": y},
                                 device=dev)
    got = call.run()
    geo = call.kernel.geometry
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    runs, per, _, _ = hopper.reduce_split(geo.steps, sms)
    vec = hopper._vector_width(call.layouts, geo.ins)
    assert (vec > 1) == (off == 0 or call.layouts[0].data_ptr() % 16 == 0)
    a, b = (t.float().cpu().numpy() for t in call.layouts)
    model = hopper.reduce_mul_model(a, b, per, runs, vec=vec)
    assert np.float32(float(got)).view(np.int32) == model.view(np.int32)
    assert torch.equal(call.run(), got)
    ring = lowering.prepare_call(nest, reduction.MUL, {"A": x, "B": y},
                                 schedule=lowering.Schedule(buffer_depth=4),
                                 device=dev)
    # a one-step grid never stages
    assert ring.kernel.pipelined == (geo.steps > 1)
    assert torch.equal(ring.run(), got)


@pytest.mark.parametrize("build", hopper.GEMV_BUILDS)
def test_contract_gemv_builds_spill_nothing(dev, build):
    """Each of K4's eight builds has no local bytes and reaches the CTAs
    an SM its split counts on (``hopper.GEMV_PER_SM``)."""
    attrs = hopper.kernel_attributes("contract_gemv", build=build)
    assert attrs["localSizeBytes"] == 0
    assert attrs["ctasPerSm"] >= hopper.GEMV_PER_SM


@pytest.mark.parametrize("mn", [(33, 4100), (8192, 8192), (100, 20000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off", [0, 1])
def test_contract_gemv_is_r4_to_the_bit_on_odd_layouts(dev, mn, dtype, off):
    """K4 against R4 at depth 3 to the bit (R4 keeps K4's first design's
    bits): rows not a multiple of a CTA's 32, a block wider than the staged
    x (20000 columns: pieces of one step), and A and x as views one element
    off a 16-byte boundary (A's elements route; x copied or staged by
    elements); the second call of a key runs the memo and the same bits."""
    m, n = mn
    g = torch.Generator(device=dev).manual_seed(m + n + off)
    a = torch.randn(m * n + 1, generator=g, device=dev).to(dtype)
    x = torch.randn(n + 1, generator=g, device=dev).to(dtype)
    a, x = a[off:off + m * n].view(m, n), x[off:off + n]
    nest = compiler.gemv_nest(m, n)
    call = lowering.prepare_call(nest, gemv.MATVEC, {"A": a, "x": x})
    before = dict(hopper.LAUNCHES)
    want = call.run()
    assert _launched(before) == {"contract_gemv"}
    again = call.run()
    deep = lowering.prepare_call(nest, gemv.MATVEC, {"A": a, "x": x},
                                 schedule=_depth(3))
    got = deep.run()
    bits = torch.int32 if want.dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))
    assert torch.equal(again.view(bits), want.view(bits))


@pytest.mark.parametrize("d", [192, 256])
def test_rescale_attention_wide_tile_spills_nothing(dev, d):
    """K11's wide tile on 192 or 256 live lanes: no local bytes, one CTA an
    SM, its shared memory as the wrapper's mirror counts it."""
    attrs = hopper.kernel_attributes("rescale_attention", tile=(256, d))
    assert attrs["localSizeBytes"] == 0 and attrs["ctasPerSm"] >= 1
    assert hopper.kernel_smem_bytes("rescale_attention", 256, d) == \
        hopper.rescale_attention_tiles(d, 256)["smem"]


@pytest.mark.parametrize("shape", [(8, 512, 192, True, None),
                                   (3, 333, 192, True, 70),
                                   (2, 300, 160, False, None)])
def test_rescale_attention_live_lanes_keep_r12_at_k11s_bits(dev, shape):
    """K11 on the live lanes of a head dim up to 192 against its plain
    version, zeros past the head dim in its output layout, and R12 on the
    padded lanes to its bits at depth 4."""
    from repro_torch.kernels import attention
    heads, s_, d, causal, window = shape
    q, k, v = _qkv(dev, s_, s_, d, heads + s_, lead=(heads,))
    _, static, _ = attention._prepare(q[0], k[0], v[0], causal, window)
    call = lowering.prepare_call(attention._nest(static),
                                 attention._body(static),
                                 {"Q": q[0], "K": k[0], "V": v[0]},
                                 device=dev)
    got, want, launched = _run_and_plain(call)
    assert launched == {"rescale_attention"}
    assert float((got - want).abs().max()) <= \
        ATTENTION_LIMIT * float(v[0].abs().max())
    padded = call.kernel(*call.layouts)
    assert not padded[:, d:].any()
    k11 = attention.ssr_flash_attention(q, k, v, causal=causal,
                                        window=window, device=dev)
    r12 = attention.ssr_flash_attention(
        q, k, v, causal=causal, window=window, device=dev,
        schedule=lowering.Schedule(buffer_depth=4))
    assert torch.equal(k11.view(torch.int32), r12.view(torch.int32))


@pytest.mark.parametrize("c", [1, 200])
@pytest.mark.parametrize("case", SPARSE_CASES)
def test_gather_spmm_reads_pack_ell_planes_with_no_copy(dev, case, c):
    """On the card K13 takes the (m, k) planes pack_ell made as they are,
    at pitch k, and gives its plain version's result on them within
    SPARSE_LIMIT, beside its run on the values doubled, which must read
    above it where the product is not all zero; R14 at depth 4 on the
    padded layouts gives K13's bits."""
    from repro_torch.kernels import sparse
    data, indices, indptr, n = _csr_case(case, 9)
    vals, cidx, m, k = sparse.pack_ell(*(torch.as_tensor(np.asarray(a),
                                                         device=dev)
                                         for a in (data, indices, indptr)), n)
    g = torch.Generator(device=dev).manual_seed(n + c)
    pitch = -(-c // 128) * 128
    X = torch.nn.functional.pad(torch.randn(n, c, generator=g, device=dev),
                                (0, pitch - c))
    copies = lowering.LAYOUT_COPIES["padded"]
    call = lowering.prepare_call(compiler.spmm_nest(m, c, k, pitch),
                                 sparse.SPMM, {"vals": vals, "cidx": cidx,
                                               "X": X}, device=dev)
    assert lowering.LAYOUT_COPIES["padded"] == copies
    assert call.planes
    assert call.layouts[0].data_ptr() == vals.data_ptr()
    assert call.layouts[1].data_ptr() == cidx.data_ptr()
    assert tuple(call.layouts[0].shape) == (m, k)
    got = _sparse_check(call, dict(hopper.LAUNCHES), "gather_spmm")
    want = call.finish(call.kernel.plain(call.layouts))
    scale = call.finish(call.kernel.plain(tuple(t.abs()
                                                for t in call.layouts)))
    doubled = call.finish(call.kernel(2 * vals, cidx, call.layouts[2]))
    ctrl = float(((doubled - want).abs() / (scale + 1e-30)).max())
    assert (ctrl > SPARSE_LIMIT) == bool(want.any())
    ring, launched = _forced_ring(call, 4, "ring_gather_spmm",
                                  call.padded_layouts())
    assert launched == {"ring_gather_spmm"}
    assert torch.equal(ring.view(torch.int32), got.view(torch.int32))


def test_gather_spmm_spills_nothing_on_the_planes_of_hpcg(dev):
    """K13 spills no byte, and on HPCG's 64**3 operator times 128 columns
    it reads the planes, to R14's bits at depth 4."""
    from repro_torch.kernels import sparse
    assert hopper.kernel_attributes("gather_spmm")["localSizeBytes"] == 0
    csr = sparse.hpcg_operator(64, 64, 64, device=dev)
    g = torch.Generator(device=dev).manual_seed(64)
    X = torch.randn(64 ** 3, 128, generator=g, device=dev)
    flat = sparse.ssr_spmm(*csr, X, device=dev)
    deep = sparse.ssr_spmm(*csr, X, schedule=lowering.Schedule(
        buffer_depth=4), device=dev)
    assert torch.equal(flat.view(torch.int32), deep.view(torch.int32))


def test_ring_gather_and_scan_entry_points_launch_the_rings(dev):
    """The entry points at depth 4 launch R13–R15, at depth 2 K12–K14."""
    from repro_torch.kernels import scan, sparse
    csr = sparse.hpcg_operator(32, 32, 32, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x, X = (torch.rand(32 ** 3, generator=g, device=dev),
            torch.randn(32 ** 3, 128, generator=g, device=dev))
    xs = torch.randn(1 << 20, generator=g, device=dev)
    deep, flat = lowering.Schedule(buffer_depth=4), lowering.DEFAULT_SCHEDULE
    for fn, ring, sync in (
            (lambda s: sparse.ssr_spmv(*csr, x, schedule=s, device=dev),
             "ring_gather_spmv", "gather_spmv"),
            (lambda s: sparse.ssr_spmm(*csr, X, schedule=s, device=dev),
             "ring_gather_spmm", "gather_spmm"),
            (lambda s: scan._ssr(xs, schedule=s, device=dev),
             "ring_stream_scan", "stream_scan")):
        before = dict(hopper.LAUNCHES)
        got = fn(deep)
        assert _launched(before) == {ring}
        before = dict(hopper.LAUNCHES)
        want = fn(flat)
        assert _launched(before) == {sync}
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_ring_gather_spmv_over_the_budget_raises_on_the_card(dev):
    """k = 300 under 128-lane k steps: a slot is 64 x 128 x 4 bytes a
    stream, so depth 4 needs 262,144 bytes and R13's 256 bytes of slot
    barriers beside them, and is refused by name."""
    make = _gather_make("spmv", "row300", 1, dev,
                        {"lanes_tile_factor": 1, "rows_tile_factor": 2})
    call = make(lowering.Schedule(buffer_depth=4))
    before = dict(hopper.LAUNCHES)
    with pytest.raises(ValueError, match=r"ring_gather_spmv: its ring at "
                       r"depths \(4, 4, 2\) needs 262400 bytes of shared "
                       r"memory a CTA \(256 of them its slots' barriers\)"):
        call.run()
    assert hopper.LAUNCHES == before


@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_ring_gather_copies_4_bytes_where_a_layout_is_off_16(dev, kind):
    """vals and cidx layouts that start 4 bytes past a 16-byte boundary (a
    view into a larger tensor): R13/R14, which copy rows in 16-byte packs,
    take aligned copies of them, to the bits of the aligned call."""
    sync, ring = GATHER_RING[kind]
    call = _gather_make(kind, "hpcg16", 200, dev, {})(
        lowering.Schedule(buffer_depth=4))
    assert call.kernel.pipelined

    def shifted(t):
        big = torch.zeros(t.numel() + 1, dtype=t.dtype, device=dev)
        view = big[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        return view
    layouts = [shifted(t) if k < 2 else t
               for k, t in enumerate(call.layouts)]
    before = dict(hopper.LAUNCHES)
    got = call.finish(call.kernel(*layouts))
    assert _launched(before) == {ring}
    want = call.run()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
