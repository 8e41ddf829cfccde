"""B1's bits in numpy, B1's and B2's splits, their wrappers' memo and the
baselines' rule, on the CPU.

B1 ``base_reduce`` (``csrc/base_reduce.cu``) runs on K1's runs, one CTA a
run: each thread loads its pack of each stream a block (16 bytes where both
layouts allow it, else one element an access) and adds its products at
once, block after block; the last CTA folds the runs' partials in the same
launch.  Its bits are ``hopper.reduce_mul_model`` at B1's packs: K1's
association.  B2 ``base_relu`` (``csrc/base_relu.cu``) runs on K2's split
and CTAs.  From numpy seeds:

* **the model** — at B1's packs and runs it equals B1's association
  written out thread by thread (Python scalars, each FMA rounded from its
  exact value) to the bit, and holds against the JAX package's
  ``baseline_dot`` (Pallas interpret mode, as its own tests run it) within
  the registry entry's ``tol`` and against ``hopper.plain_base_reduce``
  within DOT_LIMIT, at n = 1, 1,000, 5,000 and 2**20 in f32 and in bf16
  inputs; on a vector's aligned layouts it is K1's model;
* **the splits** — B1 launches ``reduce_split``'s runs, one CTA each, in one
  wave; B2 launches ``_k_split(blocks, MAP_PER_SM · sms)``; at 1 and 132
  SMs;
* **the memo** — ``base_reduce`` and ``base_relu`` check and build a launch
  once a key, and a view off a 16-byte boundary is a key of its own whose
  launch reads one element an access (``vec = 1``);
* **the rule** — no baseline's source reads ahead (B1, B2, and B5 and B7,
  whose bits and wrappers ``tests/test_torch_base_gathers.py`` holds): no
  ``ssr_for`` batch, no run walk, no ring, no bulk copy, no prefetch, one
  kernel each, and the block, element or step loop is rolled (``#pragma
  unroll 1``).

The card's checks (B1 to the model's bits, five runs to one set of bits,
one device kernel a call, no local bytes, B2 to the bit) are in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import reduction as jreduction
from repro.kernels import registry as jregistry

import repro_torch
from repro_torch.core import compiler, hopper, lowering
from repro_torch.kernels import frontend, reduction

from test_torch_reduce_runahead import _cta_sum, _fma, _inputs

#: max |port − reference| over Σ|x·y| (chip_smoke.py's DOT_LIMIT)
DOT_LIMIT = 1e-6
SMS = 132
BLOCK = hopper.ROWS * hopper.LANES


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _b1_model(xp: torch.Tensor, yp: torch.Tensor, sms: int = SMS):
    """B1's bits by the model on its padded layouts: K1's runs, B1's
    packs."""
    runs, per = hopper.reduce_split(xp.shape[0] // hopper.ROWS, sms)[:2]
    vec = hopper._vector_width((xp, yp), ())
    a, b = (t.float().numpy() for t in (xp, yp))
    return hopper.reduce_mul_model(a, b, per, runs, vec=vec)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 1000, 5000, 1 << 20])
def test_b1s_model_holds_against_the_jax_baseline_and_the_plain_b1(n, dtype):
    (x, y), (jx, jy) = _inputs(n, dtype, seed=n + 34)
    xp, yp = frontend.pad_vector(x), frontend.pad_vector(y)
    got = _b1_model(xp, yp)
    assert isinstance(got, np.float32)
    want = float(jreduction.baseline_dot(jx, jy))
    np.testing.assert_allclose(float(got), want,
                               **jregistry.get("reduction").tol)
    plain = float(hopper.plain_base_reduce(xp, yp))
    scale = float(np.sum(np.abs(xp.double().numpy() * yp.double().numpy())))
    assert abs(float(got) - plain) <= DOT_LIMIT * scale
    # the baseline's entry on the CPU runs the plain B1
    assert float(reduction.baseline_dot(x, y)) == plain


# -- the model against B1's association written out --------------------------


def _b1_written_out(a: np.ndarray, b: np.ndarray, per: int, vec: int,
                    threads: int = 256):
    """B1 thread by thread: each run's CTA, its threads' packs of each
    block in block order (pack t, t + threads, ... of a block), the CTA
    sum, then the fold's 1,024 lanes."""
    steps = a.size // BLOCK
    packs = BLOCK // vec
    partials = []
    for b0 in range(0, steps, per):
        acc = [np.float32(0)] * threads
        for t in range(threads):
            for i in range(b0, min(steps, b0 + per)):
                for k in range(t, packs, threads):
                    for j in range(vec):
                        e = i * BLOCK + k * vec + j
                        acc[t] = _fma(a[e], b[e], acc[t])
        partials.append(_cta_sum(acc))
    lanes = [np.float32(0)] * 1024
    for r, p in enumerate(partials):
        lanes[r % 1024] = np.float32(lanes[r % 1024] + p)
    return _cta_sum(lanes)


@pytest.mark.parametrize("steps, per, vec", [(1, 1, 4), (3, 2, 4),
                                             (4, 3, 8), (2, 2, 1)])
def test_the_model_is_b1s_association_written_out(steps, per, vec):
    rng = np.random.default_rng(steps * 100 + vec)
    a, b = (rng.standard_normal(steps * BLOCK).astype(np.float32)
            for _ in range(2))
    if vec == 8:                   # bf16 inputs, promoted
        a, b = (torch.from_numpy(v).bfloat16().float().numpy() for v in (a, b))
    got = hopper.reduce_mul_model(a, b, per, -(-steps // per), vec=vec)
    want = _b1_written_out(a, b, per, vec)
    assert got.view(np.int32) == np.float32(want).view(np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1000, 5000, 1 << 20])
def test_on_aligned_layouts_b1s_model_is_k1s(n, dtype):
    """B1 reads K1's layouts of a vector's dot on K1's runs at K1's packs,
    so the model gives both the same bits."""
    rng = np.random.default_rng(n)
    x, y = (torch.from_numpy(rng.random(n).astype(np.float32)).to(dtype)
            for _ in range(2))
    call = lowering.prepare_call(compiler.dot_product_nest(n), reduction.MUL,
                                 {"A": x, "B": y}, device="cpu")
    geo = call.kernel.geometry
    xp, yp = frontend.pad_vector(x), frontend.pad_vector(y)
    assert all(torch.equal(k, p) for k, p in zip(call.layouts, (xp, yp)))
    assert geo.steps == xp.shape[0] // hopper.ROWS
    assert hopper._vector_width(call.layouts, geo.ins) == \
        hopper._vector_width((xp, yp), ()) == 16 // x.element_size()
    runs, per = hopper.reduce_split(geo.steps, SMS)[:2]
    a, b = (t.float().numpy() for t in call.layouts)
    k1 = hopper.reduce_mul_model(a, b, per, runs,
                                 vec=16 // x.element_size())
    assert _b1_model(xp, yp).view(np.int32) == k1.view(np.int32)


# -- the wrappers, their launches recorded ------------------------------------


def _recorded(monkeypatch, sms: int = SMS):
    """(checks run, launches) of the baseline wrappers with an empty memo,
    each launch recorded instead of made, a card of ``sms`` SMs, a CPU
    tensor for the scratch."""
    checked, launched = [], []
    real = hopper._checked_base

    def spy(name, tensors, dtypes):
        checked.append(name)
        try:
            return real(name, tensors, dtypes)
        except ValueError:           # the CPU is no CUDA device: go on
            return tensors[0].device
    monkeypatch.setattr(hopper, "_checked_base", spy)
    monkeypatch.setattr(hopper, "_card",
                        lambda dev: SimpleNamespace(multi_processor_count=sms))
    monkeypatch.setattr(hopper, "_launch",
                        lambda name, dev, *a: launched.append((name, a)))
    monkeypatch.setattr(hopper, "_work",
                        lambda dev, words: torch.zeros(words, dtype=torch.int32))
    monkeypatch.setattr(hopper, "_PREPARED", {})
    return checked, launched


#: the pointers each baseline's entry takes before its other arguments:
#: B1's x, y, output and scratch; B2's x and output
POINTERS = {"base_reduce": 4, "base_relu": 2}


def _layouts(blocks: int, off: int = 0, dtype=torch.float32):
    flat = torch.empty(blocks * BLOCK + 8, dtype=dtype)
    return flat[off:off + blocks * BLOCK].view(-1, hopper.LANES)


def _call(name, t):
    return hopper.base_reduce(t, t) if name == "base_reduce" \
        else hopper.base_relu(t)


@pytest.mark.parametrize("sms", [1, SMS])
@pytest.mark.parametrize("blocks", [1, 7, 9, 1000, 1057, 16897])
def test_b1_launches_k1s_runs_and_b2_k2s_split(monkeypatch, blocks, sms):
    _, launched = _recorded(monkeypatch, sms)
    t = _layouts(blocks)
    for name in POINTERS:
        _call(name, t)
    (n1, a1), (n2, a2) = launched
    assert (n1, n2) == ("base_reduce", "base_relu")
    # B1: dtype, vec, blocks, then K1's runs, one CTA each, all in one
    # wave at REDUCE_PER_SM CTAs an SM
    runs, per = a1[POINTERS[n1] + 3:]
    assert (runs, per) == hopper.reduce_split(blocks, sms)[:2]
    assert runs <= hopper.REDUCE_PER_SM * sms
    # B2: dtype, vec, blocks, then K2's split
    ctas, per_cta = a2[POINTERS[n2] + 3:]
    assert (ctas, per_cta) == hopper._k_split(blocks,
                                              hopper.MAP_PER_SM * sms)
    for (c, p), name in (((runs, per), n1), ((ctas, per_cta), n2)):
        # CTA c walks blocks [c·p, (c + 1)·p), each block once
        covered = [i for k in range(c)
                   for i in range(k * p, min(blocks, (k + 1) * p))]
        assert covered == list(range(blocks)), name
        assert a1[POINTERS[n1] + 2] == a2[POINTERS[n2] + 2] == blocks


@pytest.mark.parametrize("name", sorted(POINTERS))
def test_a_launch_is_built_once_a_key_and_a_misaligned_view_is_its_own(
        monkeypatch, name):
    """The first call of a key runs the checks and builds the arguments,
    the second reuses them; a view one element off a 16-byte boundary is a
    new key, checked again, whose launch takes one element an access."""
    checked, launched = _recorded(monkeypatch)
    aligned = _layouts(9)
    for _ in range(2):
        out = _call(name, aligned)
    assert checked == [name]
    assert out.shape == ((1, 1) if name == "base_reduce" else aligned.shape)
    (k1, a1), (k2, a2) = launched
    ptrs = POINTERS[name]
    assert k1 == k2 == name and a1[ptrs:] == a2[ptrs:]
    # the dtype code and the vector width
    assert a1[ptrs:ptrs + 2] == (0, 4)
    _call(name, _layouts(9, off=1))
    assert checked == [name] * 2
    assert launched[2][1][ptrs:ptrs + 2] == (0, 1)
    assert len(hopper._PREPARED) == 2
    # a bf16 layout is a key of its own: 16-byte packs of eight elements
    _call(name, _layouts(9, dtype=torch.bfloat16))
    assert checked == [name] * 3
    assert launched[3][1][ptrs:ptrs + 2] == (1, 8)


def test_b1s_scratch_holds_its_ticket_and_its_runs_partials(monkeypatch):
    """B1 asks the stream's scratch for its ticket word and one partial a
    run, as K1 does."""
    _, launched = _recorded(monkeypatch)
    words = []
    monkeypatch.setattr(hopper, "_work", lambda dev, n: words.append(n)
                        or torch.zeros(n, dtype=torch.int32))
    hopper.base_reduce(_layouts(1057), _layouts(1057))
    runs = hopper.reduce_split(1057, SMS)[0]
    assert words == [1 + runs]


@pytest.mark.parametrize("name", sorted(POINTERS))
def test_the_wrappers_refuse_what_their_kernels_do_not_take(monkeypatch,
                                                             name):
    _recorded(monkeypatch)
    with pytest.raises(ValueError, match="rows"):
        _call(name, torch.zeros(12, hopper.LANES))
    with pytest.raises(TypeError):
        if name == "base_reduce":
            hopper.base_reduce(_layouts(1), _layouts(1),
                               out_dtype=torch.bfloat16)
        else:
            hopper.base_relu(_layouts(1), out_dtype=torch.bfloat16)
    assert hopper._PREPARED == {}


# -- the baselines' rule, in their sources ------------------------------------


#: each baseline's rolled loop: B1's and B2's block loop, B7's loop over a
#: row's elements, B5's step loop (an output's taps are read from the
#: step's tile)
ROLLED = {
    "base_reduce": r"for \(int64_t i = b0; i < b1; \+\+i\)",
    "base_relu": r"for \(int64_t i = b0; i < b1; \+\+i\)",
    "base_spmm": r"for \(int64_t j = 0; j < k; \+\+j\)",
    "base_stencil1d": r"for \(int64_t step = first; step < last; \+\+step\)",
}


@pytest.mark.parametrize("name", sorted(ROLLED))
def test_the_baselines_keep_an_explicit_load_before_every_use(name):
    """The header states the rule, and the code keeps it: one kernel with a
    rolled block, element or step loop, no read-ahead batch, run walk,
    ring, bulk copy or prefetch."""
    text = (hopper.CSRC / f"{name}.cu").read_text()
    header = " ".join(line.lstrip("/").strip() for line in text.splitlines()
                      if line.startswith("//"))
    assert "an explicit load before every use" in header
    code = re.sub(r"//[^\n]*", "", text)
    for banned in ("ssr_for", "SsrRunWalk", "SsrFlatCell", "SsrRing",
                   "cp.async", "cp_async", "bulk", "prefetch", "mbarrier",
                   "__pipeline", "fold_partials"):
        assert banned not in code, banned
    assert code.count("__global__") == 1
    assert re.search(r"#pragma unroll 1\s+" + ROLLED[name], code)
