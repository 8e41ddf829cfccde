"""The port's monolithic baselines against the JAX package's, on the CPU.

Each registry entry's ``baseline`` runs the plain version of its Hopper
baseline kernel (the block walk over the reference's padded layouts); the
reference's ``baseline_*`` runs its ``MonolithicKernel`` in Pallas
interpret mode.  Inputs come from numpy seeds and go to both packages.
They agree within the registry entry's ``tol``; relu bit for bit, in f32,
bf16 and int32 above 2**24.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import registry as jregistry
from repro.kernels import relu as jrelu

import repro_torch
from repro_torch.core import hopper
from repro_torch.core.ssr import KernelBody, LoweringError
from repro_torch.kernels import (frontend, gemm, gemv, reduction, registry,
                                 relu, scan, sparse, stencil)

KERNELS = ["reduction", "relu", "gemm", "gemv"]
RELU_SPECIALS = np.array([-0.0, 0.0, np.nan, -np.inf, np.inf, -1e-30, 1e-30,
                          3.5, -2.0], np.float32)


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    # a schedule cache of the test's own: a tuned entry elsewhere must not
    # change either package's result
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _jax(args, kwargs):
    jargs = [jnp.asarray(a.numpy()) for a in args]
    jkw = {k: (jnp.float32 if v is torch.float32 else v)
           for k, v in kwargs.items()}
    return jargs, jkw


@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("name", KERNELS)
def test_baseline_matches_reference_baseline(name, odd):
    entry = registry.get(name)
    args, kwargs = entry.example(np.random.default_rng(17), odd=odd)
    got = entry.baseline(*args, **kwargs)
    jargs, jkw = _jax(args, kwargs)
    want = np.asarray(jregistry.get(name).baseline(*jargs, **jkw))
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).rsplit(".", 1)[-1] == str(want.dtype)
    np.testing.assert_allclose(got.numpy(), want, **entry.tol)
    if entry.tol["atol"] == 0.0:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("name", KERNELS)
def test_baseline_matches_streamed_and_oracle(name, odd):
    """ssr == baseline == ref on the port's side, as the reference's
    registry test holds its own three variants."""
    entry = registry.get(name)
    args, kwargs = entry.example(np.random.default_rng(23), odd=odd)
    outs = {k: fn(*args, **kwargs) for k, fn in entry.variants().items()}
    assert sorted(outs) == ["baseline", "ref", "ssr"]
    for k in ("ssr", "baseline"):
        np.testing.assert_allclose(outs[k].numpy(), outs["ref"].numpy(),
                                   **entry.tol)


@pytest.mark.parametrize("name", KERNELS)
def test_variants_have_the_reference_keys(name):
    assert sorted(registry.get(name).variants()) == \
        sorted(jregistry.get(name).variants())


def test_relu_baseline_bit_exact_f32():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(3001).astype(np.float32)
    x[:len(RELU_SPECIALS)] = RELU_SPECIALS
    got = relu.baseline_relu(torch.from_numpy(x)).numpy()
    want = np.asarray(jrelu.baseline_relu(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_relu_baseline_bit_exact_bf16():
    rng = np.random.default_rng(6)
    x = rng.standard_normal(1500).astype(np.float32)
    x[:len(RELU_SPECIALS)] = RELU_SPECIALS
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    # the same input bits on both sides (the two f32→bf16 casts differ on
    # NaN payloads)
    bits = np.asarray(jx).view(np.int16).copy()
    got = relu.baseline_relu(torch.from_numpy(bits).view(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jrelu.baseline_relu(jx))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_relu_baseline_int32_above_2_24_exact():
    rng = np.random.default_rng(7)
    x = rng.integers(-(1 << 31), (1 << 31) - 1, size=2049, dtype=np.int64)
    x[:6] = [(1 << 24) + 1, (1 << 30) + 3, (1 << 31) - 1, -(1 << 31), 0, -1]
    x = x.astype(np.int32)
    got = relu.baseline_relu(torch.from_numpy(x))
    assert got.dtype == torch.int32
    want = np.asarray(jrelu.baseline_relu(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.maximum(x, 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_inputs_promote_like_the_reference_baselines(dtype):
    rng = np.random.default_rng(8)
    a = rng.standard_normal((70, 300)).astype(np.float32)
    b = rng.standard_normal((300, 40)).astype(np.float32)
    v = rng.standard_normal(300).astype(np.float32)
    ta, tb, tv = (torch.from_numpy(t).to(getattr(torch, dtype))
                  for t in (a, b, v))
    ja, jb, jv = (jnp.asarray(t).astype(getattr(jnp, dtype))
                  for t in (a, b, v))
    jr = jregistry
    got = gemm.baseline_matmul(ta, tb, out_dtype=torch.float32)
    want = jr.get("gemm").baseline(ja, jb, out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(
        gemv.baseline_gemv(ta, tv).numpy(),
        np.asarray(jr.get("gemv").baseline(ja, jv)), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        float(reduction.baseline_dot(ta.reshape(-1)[:300], tv)),
        float(jr.get("reduction").baseline(ja.reshape(-1)[:300], jv)),
        rtol=1e-4)


def test_gemm_baseline_drains_to_bf16_like_the_reference():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((33, 200)).astype(np.float32)
    b = rng.standard_normal((200, 17)).astype(np.float32)
    got = gemm.baseline_matmul(torch.from_numpy(a), torch.from_numpy(b),
                               out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (33, 17)
    want = np.asarray(jregistry.get("gemm").baseline(
        jnp.asarray(a), jnp.asarray(b), out_dtype=jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               want.astype(np.float32), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("k", [1, 128, 129, 300])
def test_gemm_baseline_pads_k_to_whole_chunks(k):
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((9, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 11)).astype(np.float32))
    (pa, pb), _, _ = gemm._prepare_base(a, b)
    assert pa.shape[1] % 128 == 0 and pa.shape[1] == pb.shape[0] >= k
    np.testing.assert_allclose(gemm.baseline_matmul(a, b).numpy(),
                               (a.double() @ b.double()).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_plain_baselines_walk_the_reference_blocks():
    """The plain versions take the padded layouts the wrappers take."""
    x = torch.arange(2048, dtype=torch.float32).reshape(16, 128)
    assert float(hopper.plain_base_reduce(x, torch.ones_like(x))) == \
        float(x.sum())
    blocks = hopper.plain_base_map(lambda b: b * 0 + b[0, 0], x)
    assert torch.equal(blocks[:8], torch.zeros(8, 128))
    assert torch.equal(blocks[8:], torch.full((8, 128), 1024.0))
    a = torch.ones(16, 256)
    y = hopper.plain_base_gemv(a, torch.ones(1, 256))
    assert tuple(y.shape) == (16, 1) and y.dtype == torch.float32
    assert torch.equal(y, torch.full((16, 1), 256.0))


def test_baseline_bodies_name_their_kernels():
    assert frontend.baseline_kernel(reduction.BASE_MUL) is hopper.base_reduce
    assert frontend.baseline_kernel(relu._baseline_body(relu.RELU)) is \
        hopper.base_relu
    assert frontend.baseline_kernel(gemm.BASE_DOT) is hopper.base_gemm
    assert frontend.baseline_kernel(gemv.BASE_MATVEC) is hopper.base_gemv
    assert frontend.baseline_kernel(stencil.BASE_STENCIL1D) is \
        hopper.base_stencil1d
    assert frontend.baseline_kernel(sparse.BASE_SPMV) is hopper.base_spmv
    assert frontend.baseline_kernel(sparse.BASE_SPMM) is hopper.base_spmm
    assert frontend.baseline_kernel(scan.BASE_SCAN) is hopper.base_scan
    assert sorted(hopper.BASELINE_KERNELS) == ["dot", "matvec", "mul",
                                               "relu", "scan", "spmm", "spmv",
                                               "stencil1d"]


def test_custom_fn_baseline_runs_on_cpu_and_has_no_card_kernel():
    x = torch.linspace(-3, 3, 1500)
    got = relu._base(x, lambda b: torch.tanh(b) * 2)
    torch.testing.assert_close(got, torch.tanh(x) * 2)
    body = relu._baseline_body(lambda b: torch.tanh(b))
    with pytest.raises(LoweringError, match="no Hopper baseline kernel"):
        frontend.baseline_kernel(body)
    with pytest.raises(LoweringError, match="KernelBody"):
        frontend.baseline_kernel(KernelBody(lambda b: b, "sigmoid"))


def test_monolithic_kernel_builds_once_per_signature():
    frontend.reset_dispatch_stats()
    x = torch.ones(3000)
    for _ in range(3):
        reduction.baseline_dot(x, x)
    assert frontend.DISPATCH_STATS["builds"] == 1
    assert frontend.DISPATCH_STATS["calls"] == 3
    reduction.baseline_dot(torch.ones(100), torch.ones(100))
    assert frontend.DISPATCH_STATS["builds"] == 2
    assert float(reduction.baseline_dot(x, x)) == 3000.0


def test_baseline_asks_for_cuda_without_it_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks a machine "
                    "without one")
    with pytest.raises(RuntimeError, match="cuda"):
        reduction.baseline_dot(torch.ones(8), torch.ones(8), device="cuda")
