"""The Hopper kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device.  This file
imports neither JAX nor ``repro``, so it runs on a GPU machine without
them; ``--noconftest`` skips the repo's JAX test settings::

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.core import compiler, hopper, lowering
from repro_torch.core.ssr import LoweringError
from repro_torch.kernels import gemm, gemv, ops, reduction, relu

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
