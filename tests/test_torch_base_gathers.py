"""B7's and B5's bits in numpy, their wrappers' memo and refusals, on the
CPU.

B7 ``base_spmm`` (``csrc/base_spmm.cu``) carries several rows a warp, each
row's chain in element order (the index loaded, the address computed and
clipped, the X segment and the value loaded and used before the next
index), on CTAs of consecutive rows, with 16-byte loads where X allows
them; each output is the fmaf chain over the row's elements from 0
(``hopper.base_spmm_model``).  B5 ``base_stencil1d``
(``csrc/base_stencil1d.cu``) stages each step's 512 + 10 inputs in shared
memory and reads each output's 11 taps from the tile in tap order: tap 1's
product rounded, tap 0's fused onto it, then taps 2 .. 10 by one FMA each
(``hopper.base_stencil1d_model``).  From numpy seeds:

* **the models** — each equals its kernel's association written out
  element by element (Python scalars, each FMA rounded from its exact
  value) to the bit, and holds against the JAX package's
  ``baseline_spmm`` / ``baseline_stencil1d`` (Pallas interpret mode, as its
  own tests run it) within the registry entry's ``tol`` and against
  ``hopper.plain_base_spmm`` / ``plain_base_stencil1d`` within
  SPARSE_LIMIT / STENCIL_LIMIT: B7 at c = 128, 200 and 3 and k = 1 and 27,
  B5 at n = 1, 7, 1,025 and 5,000 in f32 and bf16;
* **the memo** — ``base_spmm`` and ``base_stencil1d`` check and build a
  launch once a key; a view of X or x off a 16-byte boundary is a key of
  its own whose launch reads one element a load (``vec = 1``), and B5's
  split is ``_k_split(steps, BASE_STENCIL_PER_SM · sms)``;
* **the refusals** — each wrapper names itself for what its kernel does
  not take, and builds nothing.

The card's checks (both kernels to their models' bits, five runs to one
set of bits, no local bytes, one device kernel a call) are in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; the baselines' rule in
their sources in ``tests/test_torch_base_runs.py``.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jregistry
from repro.kernels import sparse as jsparse
from repro.kernels import stencil as jstencil

import repro_torch
from repro_torch.core import hopper
from repro_torch.kernels import sparse

from test_torch_reduce_runahead import _fma

#: max |port − reference| over Σ_j |v_j|·|x_j| (chip_smoke.py's limits)
SPARSE_LIMIT = 1e-6
STENCIL_LIMIT = 1e-6
TAPS = hopper.STENCIL_TAPS
SMS = 132


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_the_models_fast_fma_rounds_as_the_exact_one():
    """``_fma32_fast`` gives ``_fma32``'s bits: on random values, on sums
    whose float64 rounding lands on a float32 midpoint the exact value
    lies off (a = b = 1 + 2**-12, c = ±2**-60: p + c rounds up or down, not
    to even), and under float32's normal range."""
    rng = np.random.default_rng(3)
    a, b, c = (rng.standard_normal(4096).astype(np.float32)
               for _ in range(3))
    a[:3] = b[:3] = np.float32(1 + 2 ** -12)
    c[:3] = np.float32(2 ** -60), np.float32(-2 ** -60), np.float32(0)
    a[3:6], b[3:6] = np.float32(1e-30), np.float32(1e-10)
    c[3:6] = np.float32(1e-39), np.float32(-1e-39), np.float32(0)
    fast = hopper._fma32_fast(a, b, c)
    assert np.array_equal(_bits(fast), _bits(hopper._fma32(a, b, c)))
    # the float64 sum, rounded to float32, would tie to even at the first
    assert fast[0] != np.float32(np.float64(a[0]) * b[0] + c[0])
    assert fast[0] == np.float32(1 + 2 ** -11 + 2 ** -23)
    assert fast[1] == np.float32(1 + 2 ** -11)


# -- B7 -----------------------------------------------------------------------


def _csr(m: int, k: int, n: int, seed: int):
    """A CSR triple of m rows over n columns, the longest row k entries."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, k + 1, m)
    counts[m // 2] = k
    indices = np.concatenate([np.sort(rng.choice(n, c, replace=False))
                              for c in counts]).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    data = rng.standard_normal(int(indptr[-1])).astype(np.float32)
    return data, indices, indptr


@pytest.mark.parametrize("k", [1, 27])
@pytest.mark.parametrize("c", [128, 200, 3])
def test_b7s_model_holds_against_the_jax_baseline_and_the_plain_b7(c, k):
    m, n = 150, 97
    data, indices, indptr = _csr(m, k, n, seed=c * 100 + k)
    x = np.random.default_rng(c + k).standard_normal((n, c)).astype(
        np.float32)
    vals, cidx, m_, k_ = sparse.csr_to_ell(data, indices, indptr, n)
    assert (m_, k_) == (m, k)
    got = hopper.base_spmm_model(vals, cidx, x)
    assert got.dtype == np.float32 and got.shape == (m, c)
    want = np.asarray(jsparse.baseline_spmm(data, indices, indptr,
                                            jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **jregistry.get("spmm").tol)
    tv, tc, tx = (torch.from_numpy(a) for a in (vals, cidx, x))
    plain = hopper.plain_base_spmm(tv, tc, tx).numpy()
    scale = hopper.plain_base_spmm(tv.abs(), tc, tx.abs()).numpy()
    assert np.max(np.abs(got - plain) / (scale + 1e-30)) <= SPARSE_LIMIT
    # the baseline's entry on the CPU runs the plain B7
    assert np.array_equal(sparse.baseline_spmm(data, indices, indptr,
                                               torch.from_numpy(x)).numpy(),
                          plain)


def _b7_written_out(vals, cidx, x):
    """B7 output by output: the row's elements in order, the index clipped
    into X, one FMA each from 0."""
    m, k = vals.shape
    n, c = x.shape
    out = np.zeros((m, c), np.float32)
    for i in range(m):
        for col in range(c):
            acc = np.float32(0)
            for j in range(k):
                row = min(max(int(cidx[i, j]), 0), n - 1)
                acc = _fma(vals[i, j], x[row, col], acc)
            out[i, col] = acc
    return out


@pytest.mark.parametrize("m, k, n, c", [(5, 4, 6, 3), (9, 27, 30, 5),
                                        (3, 1, 2, 8)])
def test_b7s_model_is_its_association_written_out(m, k, n, c):
    """Indices below 0 and past n included: the take's clip."""
    rng = np.random.default_rng(m * k + c)
    vals = rng.standard_normal((m, k)).astype(np.float32)
    cidx = rng.integers(-3, n + 3, (m, k)).astype(np.int32)
    x = rng.standard_normal((n, c)).astype(np.float32)
    got = hopper.base_spmm_model(vals, cidx, x)
    assert np.array_equal(_bits(got), _bits(_b7_written_out(vals, cidx, x)))


def test_b7s_model_walks_its_chunks_as_one(monkeypatch):
    """Rows computed a chunk at a time, in threads, give the whole's
    bits."""
    rng = np.random.default_rng(7)
    vals = rng.standard_normal((300, 27)).astype(np.float32)
    cidx = rng.integers(0, 200, (300, 27)).astype(np.int32)
    x = rng.standard_normal((200, 130)).astype(np.float32)
    whole = hopper.base_spmm_model(vals, cidx, x)
    monkeypatch.setattr(hopper, "_MODEL_CHUNK", 7 * 130)
    assert np.array_equal(_bits(hopper.base_spmm_model(vals, cidx, x)),
                          _bits(whole))


# -- B5 -----------------------------------------------------------------------


def _x_w(n: int, dtype: str, seed: int):
    """(x as the port's tensor, x as the JAX array, w) of x ~ N(0, 1) with
    n + 10 elements (rounded to bf16) and taps ~ N(0, 0.3²)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n + TAPS - 1).astype(np.float32)
    w = (rng.standard_normal(TAPS) * 0.3).astype(np.float32)
    jx = jnp.asarray(x)
    if dtype == "bfloat16":
        jx = jx.astype(jnp.bfloat16)
        tx = torch.from_numpy(np.asarray(jx).view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        tx = torch.from_numpy(x)
    return tx, jx, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 7, 1025, 5000])
def test_b5s_model_holds_against_the_jax_baseline_and_the_plain_b5(n, dtype):
    tx, jx, w = _x_w(n, dtype, seed=n + (dtype == "bfloat16"))
    xf = tx.float().numpy()
    got = hopper.base_stencil1d_model(xf, w)
    assert got.dtype == np.float32 and got.shape == (n,)
    want = np.asarray(jstencil.baseline_stencil1d(jx, jnp.asarray(w)))
    np.testing.assert_allclose(got, want, **jregistry.get("stencil1d").tol)
    xl, wl = tx.reshape(1, -1), torch.from_numpy(w).reshape(1, -1)
    plain = hopper.plain_base_stencil1d(xl, wl).reshape(-1).numpy()
    scale = hopper.plain_base_stencil1d(xl.abs(), wl.abs()).reshape(-1).numpy()
    assert np.max(np.abs(got - plain) / (scale + 1e-30)) <= STENCIL_LIMIT
    # either contraction of the first two taps is within the limit: the
    # card settles which one the parent's build made
    other = hopper.base_stencil1d_model(xf, w, rounded_tap=0)
    assert np.max(np.abs(other - plain) / (scale + 1e-30)) <= STENCIL_LIMIT


def _b5_written_out(x, w, rounded_tap):
    """B5 output by output: the rounded tap's product, the other first tap
    fused onto it, then taps 2 .. 10 in order, one FMA each."""
    n = x.size - (TAPS - 1)
    fused = 1 - rounded_tap
    out = np.zeros(n, np.float32)
    for i in range(n):
        acc = np.float32(w[rounded_tap] * x[i + rounded_tap])
        acc = _fma(w[fused], x[i + fused], acc)
        for j in range(2, TAPS):
            acc = _fma(w[j], x[i + j], acc)
        out[i] = acc
    return out


@pytest.mark.parametrize("rounded_tap", [1, 0])
@pytest.mark.parametrize("n", [1, 40])
def test_b5s_model_is_its_association_written_out(n, rounded_tap):
    rng = np.random.default_rng(n + 10 * rounded_tap)
    x = rng.standard_normal(n + TAPS - 1).astype(np.float32)
    w = (rng.standard_normal(TAPS) * 0.3).astype(np.float32)
    got = hopper.base_stencil1d_model(x, w, rounded_tap)
    assert np.array_equal(_bits(got), _bits(_b5_written_out(x, w,
                                                             rounded_tap)))


def test_the_two_contractions_differ_and_the_model_walks_its_chunks(
        monkeypatch):
    """The card can tell the first two taps' contractions apart; chunks
    give the whole's bits."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(5000 + TAPS - 1).astype(np.float32)
    w = (rng.standard_normal(TAPS) * 0.3).astype(np.float32)
    one, zero = (hopper.base_stencil1d_model(x, w, r) for r in (1, 0))
    assert not np.array_equal(_bits(one), _bits(zero))
    monkeypatch.setattr(hopper, "_MODEL_CHUNK", 777)
    assert np.array_equal(_bits(hopper.base_stencil1d_model(x, w)),
                          _bits(one))


def test_the_models_refuse_what_their_kernels_do_not_compute():
    with pytest.raises(ValueError, match="base_stencil1d_model"):
        hopper.base_stencil1d_model(np.zeros(10, np.float32),
                                    np.zeros(TAPS, np.float32))
    with pytest.raises(ValueError, match="base_stencil1d_model"):
        hopper.base_stencil1d_model(np.zeros(30, np.float32),
                                    np.zeros(TAPS, np.float32), 2)
    with pytest.raises(ValueError, match="base_spmm_model"):
        hopper.base_spmm_model(np.zeros((3, 2), np.float32),
                               np.zeros((3, 3), np.int32),
                               np.zeros((4, 5), np.float32))


# -- the wrappers, their launches recorded ------------------------------------


def _recorded(monkeypatch, sms: int = SMS):
    """(checks run, launches) of the wrappers with an empty memo, each
    launch recorded instead of made, a card of ``sms`` SMs: the checks run
    as on the card, but for the CPU tensors' device."""
    checked, launched = [], []
    real = hopper._checked_base

    def base(name, tensors, dtypes):
        checked.append(name)
        return real(name, tensors, dtypes)
    # the CPU is no CUDA device: every other check runs
    monkeypatch.setattr(hopper, "_cuda_device", lambda name, t: t.device)
    monkeypatch.setattr(hopper, "_checked_base", base)
    monkeypatch.setattr(hopper, "_smem_refusal", lambda name, dev: None)
    monkeypatch.setattr(hopper, "_card",
                        lambda dev: SimpleNamespace(multi_processor_count=sms))
    monkeypatch.setattr(hopper, "_launch",
                        lambda name, dev, *a: launched.append((name, a)))
    monkeypatch.setattr(hopper, "_PREPARED", {})
    return checked, launched


def _table(rows: int, c: int, off: int = 0, dtype=torch.float32):
    flat = torch.zeros(rows * c + 8, dtype=dtype)
    return flat[off:off + rows * c].view(rows, c)


def _planes(m: int, k: int):
    return torch.zeros(m, k), torch.zeros(m, k, dtype=torch.int32)


def test_b7_is_built_once_a_key_and_a_misaligned_x_is_its_own(monkeypatch):
    """B7's entry takes vals, cidx, X and out, then m, k, n, c and vec: 4
    where c % 4 == 0 and X starts on a 16-byte boundary, else 1."""
    checked, launched = _recorded(monkeypatch)
    vals, cidx = _planes(37, 27)
    X = _table(50, 128)
    for _ in range(2):
        out = hopper.base_spmm(vals, cidx, X)
    assert checked == ["base_spmm"]
    assert out.shape == (37, 128) and out.dtype == torch.float32
    (k1, a1), (k2, a2) = launched
    assert k1 == k2 == "base_spmm" and a1[4:] == a2[4:] == (37, 27, 50, 128,
                                                           4)
    hopper.base_spmm(vals, cidx, _table(50, 128, off=1))
    assert checked == ["base_spmm"] * 2 and launched[2][1][4:] == (
        37, 27, 50, 128, 1)
    # c = 3 and c = 200 on a view off 16 bytes: four 4-byte loads a lane
    hopper.base_spmm(vals, cidx, _table(50, 3))
    hopper.base_spmm(vals, cidx, _table(50, 200, off=1))
    assert [a[-1] for _, a in launched[3:]] == [1, 1]
    hopper.base_spmm(vals, cidx, _table(50, 200))
    assert launched[5][1][-1] == 4
    assert checked == ["base_spmm"] * 5 and len(hopper._PREPARED) == 5


def test_b5_is_built_once_a_key_and_a_misaligned_x_is_its_own(monkeypatch):
    """B5's entry takes x, w and y, then the dtype, vec, n and its split:
    vec 4 (f32) or 8 (bf16) where x starts on a 16-byte boundary, else 1,
    whatever n."""
    checked, launched = _recorded(monkeypatch)
    w = torch.zeros(1, TAPS)
    n = 1025
    x = _table(1, n + TAPS - 1)
    for _ in range(2):
        out = hopper.base_stencil1d(x, w)
    assert checked == ["base_stencil1d"]
    assert out.shape == (1, n) and out.dtype == torch.float32
    (k1, a1), (k2, a2) = launched
    assert k1 == k2 == "base_stencil1d" and a1[3:] == a2[3:]
    assert a1[3:6] == (0, 4, n)
    hopper.base_stencil1d(_table(1, n + TAPS - 1, off=1), w)
    assert checked == ["base_stencil1d"] * 2
    assert launched[2][1][3:6] == (0, 1, n)
    hopper.base_stencil1d(_table(1, n + TAPS - 1, dtype=torch.bfloat16), w)
    hopper.base_stencil1d(_table(1, n + TAPS - 1, off=1,
                                 dtype=torch.bfloat16), w)
    assert [a[3:5] for _, a in launched[3:]] == [(1, 8), (1, 1)]
    assert len(hopper._PREPARED) == 4


@pytest.mark.parametrize("sms", [1, SMS])
@pytest.mark.parametrize("n", [1, 512, 513, 1 << 20, (1 << 26) + 5])
def test_b5_launches_its_split_over_every_step(monkeypatch, n, sms):
    _, launched = _recorded(monkeypatch, sms)
    hopper.base_stencil1d(torch.empty(1, n + TAPS - 1), torch.zeros(1, TAPS))
    ctas, per = launched[0][1][-2:]
    steps = -(-n // hopper.STENCIL_TILE)
    assert (ctas, per) == hopper._k_split(
        steps, hopper.BASE_STENCIL_PER_SM * sms)
    assert (ctas - 1) * per < steps <= ctas * per


@pytest.mark.parametrize("case", ["out_dtype", "cidx_dtype", "x_dtype",
                                  "shapes", "view", "grid"])
def test_b7_refuses_what_its_kernel_does_not_take(monkeypatch, case):
    _recorded(monkeypatch)
    vals, cidx = _planes(8, 4)
    X = _table(16, 8)
    args, err = {
        "out_dtype": ((vals, cidx, X, torch.bfloat16), TypeError),
        "cidx_dtype": ((vals, cidx.long(), X), TypeError),
        "x_dtype": ((vals, cidx, X.bfloat16()), TypeError),
        "shapes": ((vals, cidx[:, :3].contiguous(), X), ValueError),
        "view": ((vals, cidx, torch.zeros(8, 16)[:, ::2]), ValueError),
        "grid": ((vals, cidx, torch.empty(1, 65536 * hopper.SPMM_COLS)),
                 ValueError),
    }[case]
    with pytest.raises(err, match="base_spmm"):
        hopper.base_spmm(*args)
    assert hopper._PREPARED == {}


@pytest.mark.parametrize("case", ["out_dtype", "x_dtype", "w_dtype",
                                  "x_rows", "x_short", "taps"])
def test_b5_refuses_what_its_kernel_does_not_take(monkeypatch, case):
    _recorded(monkeypatch)
    x, w = torch.zeros(1, 100), torch.zeros(1, TAPS)
    args, err = {
        "out_dtype": ((x, w, torch.bfloat16), TypeError),
        "x_dtype": ((x.int(), w), TypeError),
        "w_dtype": ((x, w.bfloat16()), TypeError),
        "x_rows": ((torch.zeros(2, 100), w), ValueError),
        "x_short": ((torch.zeros(1, TAPS - 1), w), ValueError),
        "taps": ((x, torch.zeros(1, TAPS - 1)), ValueError),
    }[case]
    with pytest.raises(err, match="base_stencil1d"):
        hopper.base_stencil1d(*args)
    assert hopper._PREPARED == {}
