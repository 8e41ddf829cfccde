"""K1's bits in numpy, its split, and the wrappers' memo, on the CPU.

K1 ``reduce_mul`` (``csrc/reduce_mul.cu``) reads its packs ahead of their
use and folds its partials in its own launch, keeping the bits of the
two-launch K1 it replaced, which R1 is held to.  ``hopper.reduce_mul_model``
computes those bits in numpy float32: each of a 256-thread CTA's threads
sums its packs of each step's block in step order, element by element, one
FMA rounding each; ``ssr_cta_sum<256>`` gives a run's partial; the fold
gives lane L of 1,024 the partials L, L + 1,024, ... in order, then
``ssr_cta_sum<1024>``.  From numpy seeds:

* **the model** — equals that association written out thread by thread
  (Python scalars, each FMA rounded from its exact value) to the bit, and
  holds against the JAX package's ``ssr_dot`` (Pallas interpret mode, as
  its own tests run it) within the registry entry's ``tol`` and against the
  port's plain K1 within DOT_LIMIT, at n = 1, 1,000, 5,000 and 2**20 in f32
  and in bf16 inputs;
* **the split** — ``hopper.reduce_split`` cuts the steps into
  ``_k_split(steps, REDUCE_PER_SM · sms)``'s runs and gives every run to
  one CTA, in one wave at ``REDUCE_CTAS_PER_SM`` CTAs an SM, at 1 and 132
  SMs;
* **the memo** — ``hopper._launch_key`` differs when any one of its parts
  differs; ``reduce_mul`` and ``map_relu`` check and build a launch once a
  key, and a view off a 16-byte boundary is a key of its own whose launch
  reads one element an access (``vec = 1``).

The card's checks (K1 to the model's bits, one device kernel a call, K1
and K2 without local bytes) are in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

from fractions import Fraction
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import reduction as jreduction
from repro.kernels import registry as jregistry

import repro_torch
from repro_torch.core import agu, compiler, hopper, lowering
from repro_torch.kernels import reduction, relu

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


def _inputs(n: int, dtype: str, seed: int):
    """(the port's two tensors, the JAX arrays) of U[0, 1) inputs."""
    rng = np.random.default_rng(seed)
    pair = [rng.random(n).astype(np.float32) for _ in range(2)]
    jx = [jnp.asarray(v) for v in pair]
    if dtype == "bfloat16":
        jx = [v.astype(jnp.bfloat16) for v in jx]
        tx = [torch.from_numpy(np.asarray(v).view(np.int16).copy())
              .view(torch.bfloat16) for v in jx]
    else:
        tx = [torch.from_numpy(v.copy()) for v in pair]
    return tx, jx


def _model(x: torch.Tensor, y: torch.Tensor, sms: int = SMS):
    """(K1's bits by the model, the plain K1, Σ|x·y|) on the port's
    layouts."""
    call = lowering.prepare_call(compiler.dot_product_nest(x.numel()),
                                 reduction.MUL, {"A": x, "B": y},
                                 device="cpu")
    geo = call.kernel.geometry
    runs, per, _, _ = hopper.reduce_split(geo.steps, sms)
    vec = hopper._vector_width(call.layouts, geo.ins)
    a, b = (t.float().numpy() for t in call.layouts)
    scale = float(np.sum(np.abs(a.astype(np.float64) * b)))
    return hopper.reduce_mul_model(a, b, per, runs, vec=vec), \
        float(call.run()), scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 1000, 5000, 1 << 20])
def test_the_model_holds_against_the_jax_dot_and_the_plain_k1(n, dtype):
    (x, y), (jx, jy) = _inputs(n, dtype, seed=n)
    got, plain, scale = _model(x, y)
    assert isinstance(got, np.float32)
    want = float(jreduction.ssr_dot(jx, jy))
    tol = jregistry.get("reduction").tol
    np.testing.assert_allclose(float(got), want, **tol)
    assert abs(float(got) - plain) <= DOT_LIMIT * scale
    exact = float(np.dot(x.double().numpy(), y.double().numpy()))
    assert abs(float(got) - exact) <= DOT_LIMIT * scale


# -- the model against K1's association written out --------------------------


def _fma(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """fmaf: a·b + c rounded once to nearest, ties to even, from its exact
    value."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    cands = (np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.int32)) & 1))


def _cta_sum(v: list) -> np.float32:
    """ssr_cta_sum over len(v) threads, lane by lane."""
    def butterfly(lanes):
        for o in (16, 8, 4, 2, 1):
            lanes = [np.float32(lanes[i] + lanes[i ^ o]) for i in range(32)]
        return lanes[0]
    warps = [butterfly(v[w * 32:(w + 1) * 32]) for w in range(len(v) // 32)]
    return butterfly(warps + [np.float32(0)] * (32 - len(warps)))


def _written_out(a: np.ndarray, b: np.ndarray, per: int, vec: int):
    """K1 thread by thread: each run's threads, their packs in step
    order, the CTA sum, then the fold's 1,024 lanes."""
    steps = a.size // BLOCK
    packs = BLOCK // vec
    partials = []
    for s0 in range(0, steps, per):
        acc = [np.float32(0)] * 256
        for s in range(s0, min(steps, s0 + per)):
            for t in range(256):
                for k in range(t, packs, 256):
                    for j in range(vec):
                        e = s * BLOCK + k * vec + j
                        acc[t] = _fma(a[e], b[e], acc[t])
        partials.append(_cta_sum(acc))
    lanes = [np.float32(0)] * 1024
    for i, p in enumerate(partials):
        lanes[i % 1024] = np.float32(lanes[i % 1024] + p)
    return _cta_sum(lanes)


@pytest.mark.parametrize("steps, per, vec", [(1, 1, 4), (3, 2, 4),
                                             (5, 1, 8), (2, 2, 1)])
def test_the_model_is_k1s_association_written_out(steps, per, vec):
    rng = np.random.default_rng(steps * 10 + vec)
    a, b = (rng.standard_normal(steps * BLOCK).astype(np.float32)
            for _ in range(2))
    if vec == 8:                   # bf16 inputs, promoted
        a, b = (torch.from_numpy(v).bfloat16().float().numpy() for v in (a, b))
    got = hopper.reduce_mul_model(a, b, per, -(-steps // per), vec=vec)
    want = _written_out(a, b, per, vec)
    assert got.view(np.int32) == np.float32(want).view(np.int32)


@pytest.mark.parametrize("case", ["blocks", "runs", "pack"])
def test_the_model_refuses_what_k1_does_not_walk(case):
    x = np.zeros(BLOCK * 2, np.float32)
    with pytest.raises(ValueError):
        if case == "blocks":
            hopper.reduce_mul_model(x[:1000], x[:1000], 1, 1)
        elif case == "runs":
            hopper.reduce_mul_model(x, x, 1, 1)
        else:
            hopper.reduce_mul_model(x, x, 1, 2, vec=3)


# -- the split -------------------------------------------------------------------


@pytest.mark.parametrize("sms", [1, SMS])
@pytest.mark.parametrize("steps", [1, 7, 8, 9, 1000, 1024, 65536,
                                   65536 + 1, 1 << 20])
def test_the_split_is_k1s_runs_in_one_wave(steps, sms):
    runs, per, k, ctas = hopper.reduce_split(steps, sms)
    assert (runs, per) == hopper._k_split(steps,
                                          hopper.REDUCE_PER_SM * sms)
    assert ctas == -(-runs // k) <= hopper.REDUCE_CTAS_PER_SM * sms
    # CTA c walks runs [c·k, (c + 1)·k), each run's steps once
    covered = [s for c in range(ctas)
               for r in range(c * k, min(runs, (c + 1) * k))
               for s in range(r * per, min(steps, (r + 1) * per))]
    assert covered == list(range(steps))


# -- the memo --------------------------------------------------------------------


def _layouts(n=4096, dtype=torch.float32, off=0):
    flat = torch.rand(n + 8).to(dtype)
    return flat[off:off + n].view(-1, hopper.LANES)


def _geometry(mode):
    n = 4096
    if mode == "map":
        return lowering.prepare_call(
            compiler.elementwise_nest(n), relu.RELU, {"X": torch.ones(n)},
            mode="map", out_dtype=torch.float32, device="cpu").kernel.geometry
    return lowering.prepare_call(
        compiler.dot_product_nest(n), reduction.MUL,
        {"A": torch.ones(n), "B": torch.ones(n)}, device="cpu").kernel.geometry


def _key(**change):
    fields = dict(name="reduce_mul", op=("reduce", "mul"),
                  geo=_geometry("reduce"), ring=None, program=None,
                  out_dtype=torch.float32, acc_dtype=torch.float32,
                  layouts=(_layouts(), _layouts()))
    fields.update(change)
    return hopper._launch_key(**fields)


def _changed(part):
    a = _layouts()
    return {
        "name": {"name": "map_relu"}, "op": {"op": ("map", "relu")},
        "geo": {"geo": _geometry("map")},
        "ring": {"ring": agu.RingProgram((3, 3), (False, False))},
        "program": {"program": "a program"},
        "out_dtype": {"out_dtype": torch.bfloat16},
        "acc_dtype": {"acc_dtype": torch.bfloat16},
        "count": {"layouts": (a,)},
        "shape": {"layouts": (a, a.reshape(-1, 64))},
        "strides": {"layouts": (a, torch.rand(32, 256)[:, :128])},
        "dtype": {"layouts": (a, a.to(torch.bfloat16))},
        "device": {"layouts": (a, a.to("meta"))},
        "alignment": {"layouts": (a, _layouts(off=1))},
    }[part]


@pytest.mark.parametrize("part", ["name", "op", "geo", "ring", "program",
                                  "out_dtype", "acc_dtype", "count", "shape",
                                  "strides", "dtype", "device", "alignment"])
def test_every_part_of_the_key_changes_it(part):
    a = _layouts()
    base = _key(layouts=(a, a))
    assert _key(layouts=(a, a)) == base
    change = _changed(part)
    if "layouts" not in change:
        change["layouts"] = (a, a)
    assert _key(**change) != base


def _recorded(monkeypatch):
    """(checks run, launches) of the wrappers with an empty memo, each
    launch recorded instead of made, a CPU tensor for the scratch."""
    checked, launched = [], []
    real = hopper._checked

    def spy(*args, **kw):
        checked.append(args[0])
        try:
            return real(*args, **kw)
        except ValueError:           # the CPU is no CUDA device: go on
            return args[2][0].device
    monkeypatch.setattr(hopper, "_checked", spy)
    monkeypatch.setattr(hopper, "_card",
                        lambda dev: SimpleNamespace(multi_processor_count=SMS))
    monkeypatch.setattr(hopper, "_launch",
                        lambda name, dev, *a: launched.append((name, a)))
    monkeypatch.setattr(hopper, "_work",
                        lambda dev, words: torch.zeros(words, dtype=torch.int32))
    monkeypatch.setattr(hopper, "_PREPARED", {})
    return checked, launched


@pytest.mark.parametrize("name", ["reduce_mul", "map_relu"])
def test_a_launch_is_built_once_a_key_and_a_misaligned_view_is_its_own(
        monkeypatch, name):
    """The first call of a key runs the checks and builds the arguments,
    the second reuses them; a view one element off a 16-byte boundary is a
    new key, checked again, whose launch takes one element an access."""
    mode = "map" if name == "map_relu" else "reduce"
    geo = _geometry(mode)
    n_in = 1 if name == "map_relu" else 2
    wrapper = getattr(hopper, name)
    checked, launched = _recorded(monkeypatch)
    aligned = (_layouts(),) * n_in
    for _ in range(2):
        wrapper(geo, aligned, torch.float32)
    assert checked == [name]
    (k1, a1), (k2, a2) = launched
    # the pointers (the layouts', the output's, K1's scratch), then the
    # dtype code and the vector width
    ptrs = n_in + 1 + (name == "reduce_mul")
    assert k1 == k2 == name and a1[ptrs:] == a2[ptrs:]
    assert a1[ptrs:ptrs + 2] == (0, 4)
    if name == "reduce_mul":
        runs, per, k, _ = hopper.reduce_split(geo.steps, SMS)
        assert a1[-3:] == (runs, per, k)
    wrapper(geo, (_layouts(off=1),) * n_in, torch.float32)
    assert checked == [name] * 2
    assert launched[2][1][ptrs:ptrs + 2] == (0, 1)
    assert len(hopper._PREPARED) == 2
