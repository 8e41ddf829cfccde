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
