"""The port's streamed kernels against the JAX package's, through the public API.

Each registry entry's ``example`` inputs (drawn with numpy from a seed, the
odd sizes included) go through ``repro_torch.kernels.ops`` with
``ssr=True`` on the CPU — the plain versions of the lowered computation —
and through the reference's ``ssr_*`` kernels in Pallas interpret mode,
pinned to the default schedule.  They must agree within the entry's
``tol``; relu bit for bit, int32 above 2**24 and bf16 included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.lowering import DEFAULT_SCHEDULE as REF_DEFAULT
from repro.kernels import ref as jref
from repro.kernels import registry as jregistry

import repro_torch
from repro_torch.core.region import ssr_region
from repro_torch.kernels import frontend, ops, ref, registry
from repro_torch.kernels.gemm import ssr_matmul
from repro_torch.kernels.relu import ssr_elementwise, ssr_relu

KERNELS = ["reduction", "relu", "gemm", "gemv", "gemv_relu", "sum_sq_diff",
           "axpy_dot", "layernorm", "softmax_xent", "mlp_block"]
# the single-nest kernels; the chains and DAGs have their own parity tests
# (tests/test_torch_chained.py, tests/test_torch_dag.py)
STREAMED = KERNELS[:4]
OPS = {"reduction": ops.dot, "relu": ops.relu, "gemm": ops.matmul,
       "gemv": ops.gemv}


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    # a schedule cache of the test's own: a tuned entry elsewhere must not
    # change either package's schedule
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _jax_args(args, kwargs):
    jargs = [jnp.asarray(a.numpy()) for a in args]
    jkw = {k: (jnp.float32 if v is torch.float32 else v)
           for k, v in kwargs.items()}
    return jargs, jkw


def test_registry_lists_the_slice():
    assert registry.names() == sorted(KERNELS)
    for name in KERNELS:
        e, je = registry.get(name), jregistry.get(name)
        assert e.tol == je.tol and e.problem == je.problem
        assert e.baseline is not None
        # the cluster variants arrive with port slice 7
        assert sorted(e.variants()) == sorted(v for v in je.variants()
                                              if v != "cluster")
    with pytest.raises(KeyError, match="registered"):
        registry.get("typo")


@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("name", STREAMED)
def test_ops_ssr_matches_reference_kernel(name, odd):
    entry = registry.get(name)
    args, kwargs = entry.example(np.random.default_rng(7), odd=odd)
    got = OPS[name](*args, ssr=True, **kwargs)
    jargs, jkw = _jax_args(args, kwargs)
    want = np.asarray(jregistry.get(name).ssr(*jargs, schedule=REF_DEFAULT,
                                               **jkw))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **entry.tol)
    if entry.tol["atol"] == 0.0:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("name", STREAMED)
def test_ssrcfg_off_matches_reference_oracle(name, odd):
    entry = registry.get(name)
    args, kwargs = entry.example(np.random.default_rng(11), odd=odd)
    got = OPS[name](*args, **kwargs)          # ssrcfg off: the oracle
    with ssr_region(True):
        streamed = OPS[name](*args, **kwargs)
    jargs, jkw = _jax_args(args, kwargs)
    want = np.asarray(jregistry.get(name).ref(*jargs, **jkw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(streamed.numpy(), got.numpy(), **entry.tol)


RELU_SPECIALS = np.array([-0.0, 0.0, np.nan, -np.inf, np.inf, -1e-30, 1e-30,
                          3.5, -2.0], np.float32)


@pytest.mark.parametrize("n", [1024, 1025, 3000])
def test_relu_f32_bit_exact(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    x[:len(RELU_SPECIALS)] = RELU_SPECIALS
    got = ssr_relu(torch.from_numpy(x)).numpy()
    want = np.asarray(jregistry.get("relu").ssr(jnp.asarray(x),
                                                schedule=REF_DEFAULT))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_relu_int32_above_2_24_exact():
    rng = np.random.default_rng(3)
    x = rng.integers(-(1 << 31), (1 << 31) - 1, size=2049, dtype=np.int64)
    x[:6] = [(1 << 24) + 1, (1 << 30) + 3, (1 << 31) - 1, -(1 << 31), 0, -1]
    x = x.astype(np.int32)
    got = ops.relu(torch.from_numpy(x), ssr=True)
    assert got.dtype == torch.int32
    want = np.asarray(jregistry.get("relu").ssr(jnp.asarray(x),
                                                schedule=REF_DEFAULT))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.maximum(x, 0))


def test_relu_bf16_bit_exact():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(1500).astype(np.float32)
    x[:len(RELU_SPECIALS)] = RELU_SPECIALS
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    # the same input bits on both sides (the two f32→bf16 casts differ on
    # NaN payloads)
    bits = np.asarray(jx).view(np.int16).copy()
    got = ssr_relu(torch.from_numpy(bits).view(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jregistry.get("relu").ssr(jx, schedule=REF_DEFAULT))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_ssr_elementwise_any_body_on_cpu():
    x = torch.linspace(-3, 3, 2000)
    got = ssr_elementwise(x, lambda b: torch.tanh(b) * 2)
    torch.testing.assert_close(got, torch.tanh(x) * 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_inputs_promote_like_the_reference(dtype):
    rng = np.random.default_rng(9)
    a = rng.standard_normal((70, 90)).astype(np.float32)
    b = rng.standard_normal((90, 40)).astype(np.float32)
    v = rng.standard_normal(90).astype(np.float32)
    ta, tb, tv = (torch.from_numpy(t).to(getattr(torch, dtype))
                  for t in (a, b, v))
    ja, jb, jv = (jnp.asarray(t).astype(getattr(jnp, dtype))
                  for t in (a, b, v))
    jr = jregistry
    np.testing.assert_allclose(
        ops.matmul(ta, tb, ssr=True, out_dtype=torch.float32).numpy(),
        np.asarray(jr.get("gemm").ssr(ja, jb, out_dtype=jnp.float32,
                                      schedule=REF_DEFAULT)),
        rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        ops.gemv(ta, tv[:90], ssr=True).numpy(),
        np.asarray(jr.get("gemv").ssr(ja, jv, schedule=REF_DEFAULT)),
        rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        ops.dot(ta.reshape(-1)[:90], tv, ssr=True).numpy(),
        np.asarray(jr.get("reduction").ssr(ja.reshape(-1)[:90], jv,
                                           schedule=REF_DEFAULT)),
        rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("m,k,n", [(5, 1, 7), (6, 9, 1), (1, 300, 2)])
def test_gemm_degenerate_dims(m, k, n):
    rng = np.random.default_rng(m * k * n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = ssr_matmul(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jregistry.get("gemm").ssr(
        jnp.asarray(a), jnp.asarray(b), schedule=REF_DEFAULT))
    assert tuple(got.shape) == want.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_gemm_out_dtype_bf16():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((40, 50)).astype(np.float32)
    b = rng.standard_normal((50, 30)).astype(np.float32)
    got = ssr_matmul(torch.from_numpy(a), torch.from_numpy(b),
                     out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jregistry.get("gemm").ssr(
        jnp.asarray(a), jnp.asarray(b), out_dtype=jnp.bfloat16,
        schedule=REF_DEFAULT)).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)


def test_refs_match_reference_refs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(300).astype(np.float32)
    m = rng.standard_normal((20, 300)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(ref.dot_ref(t(x), t(x)).numpy(),
                               np.asarray(jref.dot_ref(x, x)), rtol=1e-5)
    np.testing.assert_array_equal(ref.relu_ref(t(x)).numpy(),
                                  np.asarray(jref.relu_ref(x)))
    np.testing.assert_allclose(ref.gemv_ref(t(m), t(x)).numpy(),
                               np.asarray(jref.gemv_ref(m, x)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ref.matmul_ref(t(m), t(m.T.copy())).numpy(),
                               np.asarray(jref.matmul_ref(m, m.T)),
                               rtol=1e-4, atol=1e-4)


def test_nest_kernel_dispatch_cache():
    frontend.reset_dispatch_stats()
    x = torch.ones(3000)
    for _ in range(3):
        ops.dot(x, x, ssr=True)
    assert frontend.DISPATCH_STATS == {"builds": 1, "calls": 3,
                                       "fallbacks": 0, "degraded": 0}
    ops.dot(torch.ones(2000), torch.ones(2000), ssr=True)
    assert frontend.DISPATCH_STATS == {"builds": 2, "calls": 4,
                                       "fallbacks": 0, "degraded": 0}


def test_numpy_operands_become_tensors():
    x = np.arange(10, dtype=np.float32)
    got = ops.dot(x, x, ssr=True)
    assert isinstance(got, torch.Tensor)
    assert float(got) == pytest.approx(float(np.dot(x, x)))


def test_frontend_helpers():
    x = torch.arange(5.0)
    padded = frontend.pad_vector(x, block=8, lanes=4)
    assert padded.shape == (2, 4)
    assert torch.equal(frontend.trim_vector(padded, 5), x)
    assert frontend.pad_leading(torch.ones(3, 2), 8).shape == (8, 2)
    assert frontend.promote(torch.ones(2, dtype=torch.bfloat16)).dtype == \
        torch.float32
