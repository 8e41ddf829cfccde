"""The waivered stream kernels: the port's scan, FFT and sort against the
JAX package's.

The same numpy inputs go to ``repro.kernels.{scan,fft,bitonic}`` (Pallas
interpret mode) and to ``repro_torch.kernels.{scan,fft,bitonic}`` on the
CPU, where ``StreamKernel`` runs each Launch as the in-order block walk
(``hopper.plain_stream``).  Exact for what is pure Python or numpy: the
twiddle tables, the Launch geometry, the waiver, power-of-two and
``buffer_depth`` messages, the loop nests ``NestKernel.loop_nest`` exposes.
The sort is exact to the bit (its registry ``tol`` is 0/0): f32, bf16 and
int32, signed zeros, and the reference's NaN behaviour — one NaN turns
every output to NaN, while its oracle ``sort_ref`` sorts NaN last.  The
scan and FFT agree within the registry ``tol`` and within the tighter
bounds stated below.  Leading batch dims of ``ssr_fft``/``ssr_sort`` are
held against ``jax.vmap`` of the reference.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import lowering as jlowering
from repro.kernels import bitonic as jbitonic
from repro.kernels import fft as jfft
from repro.kernels import frontend as jfrontend
from repro.kernels import gemv as jgemv
from repro.kernels import ref as jref
from repro.kernels import reduction as jreduction
from repro.kernels import registry as jregistry
from repro.kernels import scan as jscan

import repro_torch
from repro_torch import interop
from repro_torch.core import agu, hopper
from repro_torch.core.lowering import Schedule
from repro_torch.core.ssr import BlockStream, LoweringError
from repro_torch.kernels import (bitonic, fft, frontend, gemv, ops, reduction,
                                 ref, registry, scan)

#: scan: max |port − f64 prefix sum| over the f64 prefix sum of |x| (an f32
#: prefix sum in any fixed order reads about 1e-7)
SCAN_BOUND = 1e-6
#: fft: max |port − reference| over Σ|x| of the transform (the two round the
#: same butterflies in f32; twiddles rounded to bf16 read about 1e-4)
FFT_BOUND = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- scan ---------------------------------------------------------------------


@pytest.mark.parametrize("n", [4096, 3000, 5000, 1])
@pytest.mark.parametrize("variant", ["ssr", "baseline"])
def test_scan_matches_the_reference(n, variant):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = getattr(registry.get("scan"), variant)(_t(x)).numpy()
    want = np.asarray(getattr(jregistry.get("scan"), variant)(jnp.asarray(x)))
    assert got.shape == want.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **registry.get("scan").tol)
    exact, scale = np.cumsum(x.astype(np.float64)), \
        np.cumsum(np.abs(x.astype(np.float64)))
    assert np.max(np.abs(got - exact) / scale) <= SCAN_BOUND
    assert np.max(np.abs(want - exact) / scale) <= SCAN_BOUND


@pytest.mark.parametrize("dtype", ["bfloat16", "int32"])
def test_scan_promotes_like_the_reference(dtype):
    rng = np.random.default_rng(3)
    if dtype == "int32":
        x = rng.integers(-1000, 1000, 2500).astype(np.int32)
        tx, jx = _t(x), jnp.asarray(x)
    else:
        jx = jnp.asarray(rng.standard_normal(2500).astype(np.float32)
                         ).astype(jnp.bfloat16)
        tx = _t(np.asarray(jx).view(np.int16).copy()).view(torch.bfloat16)
    for port, jax_fn in ((scan.ssr_scan, jscan.ssr_scan),
                         (scan.baseline_scan, jscan.baseline_scan)):
        got = port(tx)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_fn(jx)),
                                   rtol=1e-5, atol=1e-3)


def test_scan_launch_matches_the_reference():
    x = np.arange(3000, dtype=np.float32)
    arrays, static, final = scan._prepare(_t(x))
    jarrays, jstatic, jfinal = jscan._prepare(jnp.asarray(x))
    assert final == jfinal == 3000
    assert tuple(arrays[0].shape) == jarrays[0].shape == (24, 128)
    lc, jlc = scan._launch(static, *arrays), jscan._launch(jstatic, *jarrays)
    assert lc.grid == jlc.grid == (3,)
    assert lc.dimension_semantics == jlc.dimension_semantics
    for s, js in zip((*lc.in_streams, *lc.out_streams),
                     (*jlc.in_streams, *jlc.out_streams)):
        assert (s.block_shape, s.name, s.direction.value) == \
            (js.block_shape, js.name, js.direction.value)
        assert [s.index_map(i) for i in range(3)] == \
            [tuple(int(v) for v in js.index_map(i)) for i in range(3)]
    assert [(tuple(o.shape), str(o.dtype).split(".")[-1])
            for o in lc.out_shapes] == \
        [(o.shape, str(o.dtype)) for o in jlc.out_shapes]
    assert lc.scratch_shapes[0].shape == (1, 1)
    assert scan._ssr.lowering_waiver == jscan._ssr.lowering_waiver


# -- fft ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 8, 256, 2048])
def test_twiddle_tables_equal_the_reference_bit_for_bit(n):
    for a, b in zip(fft.twiddle_tables(n), jfft.twiddle_tables(n)):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _fft_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _fft_err(got, want, re, im):
    scale = np.sum(np.abs(re) + np.abs(im), axis=-1, keepdims=True)
    return max(float(np.max(np.abs(g - w) / scale))
               for g, w in zip(got, want))


@pytest.mark.parametrize("n", [256, 2048, 2])
def test_fft_matches_the_reference(n):
    re, im = _fft_inputs(n, n)
    got = [t.numpy() for t in ops.fft(_t(re), _t(im), ssr=True)]
    want = [np.asarray(t) for t in jfft.ssr_fft(jnp.asarray(re),
                                                jnp.asarray(im))]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (n,) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **registry.get("fft").tol)
    assert _fft_err(got, want, re, im) <= FFT_BOUND


def test_fft_batch_matches_vmap_of_the_reference():
    re, im = _fft_inputs((3, 256), 7)
    got = [t.numpy() for t in fft.ssr_fft(_t(re), _t(im))]
    want = [np.asarray(t) for t in jax.vmap(jfft.ssr_fft)(jnp.asarray(re),
                                                          jnp.asarray(im))]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 256)
    assert _fft_err(got, want, re, im) <= FFT_BOUND
    # each row is its own transform
    one = [t.numpy() for t in fft.ssr_fft(_t(re[1]), _t(im[1]))]
    np.testing.assert_array_equal(got[0][1], one[0])


def test_fft_bf16_input_promotes():
    re, im = _fft_inputs(256, 5)
    jre, jim = (jnp.asarray(t).astype(jnp.bfloat16) for t in (re, im))
    tre, tim = (_t(np.asarray(t).view(np.int16).copy()).view(torch.bfloat16)
                for t in (jre, jim))
    got = [t.numpy() for t in fft.ssr_fft(tre, tim)]
    want = [np.asarray(t) for t in jfft.ssr_fft(jre, jim)]
    assert _fft_err(got, want, re, im) <= FFT_BOUND


# -- bitonic ------------------------------------------------------------------


def _sort_both(x):
    """The port's and the reference's ssr_sort of the same bits."""
    if x.dtype == jnp.bfloat16:
        tx = _t(np.asarray(x).view(np.int16).copy()).view(torch.bfloat16)
    else:
        tx = _t(np.asarray(x))
    got = bitonic.ssr_sort(tx)
    want = np.asarray(jax.vmap(jbitonic.ssr_sort)(x) if x.ndim == 2
                      else jbitonic.ssr_sort(x))
    return got, want


def _same_bits(got, want):
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    g = got.view(torch.int16 if got.dtype == torch.bfloat16 else torch.int32)
    w = want.view(np.int16 if got.dtype == torch.bfloat16 else np.int32)
    np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n", [64, 1024, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_sort_matches_the_reference_bit_for_bit(n, dtype):
    rng = np.random.default_rng(n)
    if dtype == "int32":
        x = jnp.asarray(rng.integers(-(1 << 31), (1 << 31) - 1, n,
                                     dtype=np.int64).astype(np.int32))
    else:
        x = jnp.asarray(rng.standard_normal(n).astype(np.float32)
                        ).astype(getattr(jnp, dtype))
    got, want = _sort_both(x)
    _same_bits(got, want)
    if dtype == "float32":
        np.testing.assert_array_equal(
            ops.sort(_t(np.asarray(x)), ssr=True).numpy(), want)


def test_sort_batch_matches_vmap_of_the_reference():
    x = jnp.asarray(np.random.default_rng(2).standard_normal((3, 64))
                    .astype(np.float32))
    got, want = _sort_both(x)
    assert got.shape == want.shape == (3, 64)
    _same_bits(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sort_orders_signed_zeros_as_the_reference(dtype):
    """jnp orders −0 below +0; torch.minimum/maximum do not, so the port's
    min and max are selects."""
    v = np.array([0, -0.0, -0.0, 1, -1, 0, -0.0, 0], np.float32)
    got, want = _sort_both(jnp.asarray(v).astype(getattr(jnp, dtype)))
    _same_bits(got, want)
    assert torch.signbit(got).tolist() == [True] * 4 + [False] * 4
    rng = np.random.default_rng(8)
    v = rng.choice(np.array([0.0, -0.0, 1.5, -2.0], np.float32), 256)
    got, want = _sort_both(jnp.asarray(v).astype(getattr(jnp, dtype)))
    _same_bits(got, want)


def test_one_nan_turns_every_output_to_nan_as_the_reference():
    """The reference's ssr_sort propagates NaN through every compare-
    exchange; its oracle sort_ref (jnp.sort) sorts it last.  The port
    follows ssr_sort, NaN positions compared equal."""
    v = np.array([0, -0.0, np.nan, 1, -1, 0, -0.0, 2], np.float32)
    got, want = _sort_both(jnp.asarray(v))
    assert np.isnan(want).all() and bool(torch.isnan(got).all())
    v = np.random.default_rng(4).standard_normal(1024).astype(np.float32)
    v[100] = np.nan
    got, want = _sort_both(jnp.asarray(v))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(want).all()
    assert np.isnan(np.asarray(jref.sort_ref(jnp.asarray(v)))[-1])
    assert bool(torch.isnan(ref.sort_ref(_t(v))[-1]))


def test_min_max_is_jnp_minimum_and_maximum():
    vals = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan],
                    np.float32)
    a, b = (np.repeat(vals, len(vals)), np.tile(vals, len(vals)))
    lo, hi = bitonic.min_max(_t(a), _t(b))
    jlo, jhi = (np.asarray(f(jnp.asarray(a), jnp.asarray(b)))
                for f in (jnp.minimum, jnp.maximum))
    for got, want in ((lo.numpy(), jlo), (hi.numpy(), jhi)):
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(got[~nan].view(np.int32),
                                      want[~nan].view(np.int32))


# -- the frontend -------------------------------------------------------------


@pytest.mark.parametrize("waiver", [None, "", "   "])
def test_waiver_message_equals_the_reference(waiver):
    with pytest.raises(ValueError) as port:
        frontend.StreamKernel("k", prepare=None, launch=None, body=None,
                              lowering_waiver=waiver)
    with pytest.raises(ValueError) as want:
        jfrontend.StreamKernel("k", prepare=None, launch=None, body=None,
                               lowering_waiver=waiver)
    assert str(port.value) == str(want.value)


@pytest.mark.parametrize("n", [0, 100, 3])
@pytest.mark.parametrize("which", ["fft", "bitonic", "helper"])
def test_power_of_two_message_equals_the_reference(n, which):
    def run(pkg_fft, pkg_sort, helper, arr):
        if which == "fft":
            return pkg_fft(arr(n), arr(n))
        if which == "bitonic":
            return pkg_sort(arr(n))
        return helper(n, "a network")

    with pytest.raises(ValueError) as port:
        run(fft.ssr_fft, bitonic.ssr_sort, frontend.require_power_of_two,
            lambda k: torch.ones(k))
    with pytest.raises(ValueError) as want:
        run(jfft.ssr_fft, jbitonic.ssr_sort, jfrontend.require_power_of_two,
            lambda k: jnp.ones(k))
    assert str(port.value) == str(want.value)


@pytest.mark.parametrize("depth", [1, 9, (2, 3)])
def test_buffer_depth_message_equals_the_reference(depth):
    x = np.ones(4096, np.float32)
    kw = {"buffer_depth": depth} if isinstance(depth, int) else \
        {"buffer_depth": depth}
    with pytest.raises(ValueError) as port:
        scan._ssr(_t(x), schedule=Schedule(**kw))
    with pytest.raises(ValueError) as want:
        jscan._ssr(jnp.asarray(x), schedule=jlowering.Schedule(**kw))
    assert str(port.value) == str(want.value)


def test_a_legal_buffer_depth_changes_nothing():
    x = _t(np.random.default_rng(1).standard_normal(3000).astype(np.float32))
    assert torch.equal(scan._ssr(x, schedule=Schedule(buffer_depth=4)),
                       scan.ssr_scan(x))


def test_stream_kernel_caches_per_signature():
    frontend.reset_dispatch_stats()
    x = torch.ones(3333)      # a signature no other test builds
    for _ in range(3):
        ops.prefix_sum(x, ssr=True)
    assert frontend.DISPATCH_STATS["builds"] == 1
    assert frontend.DISPATCH_STATS["calls"] == 3
    ops.prefix_sum(torch.ones(2222), ssr=True)
    assert frontend.DISPATCH_STATS["builds"] == 2


def test_a_body_without_a_stream_kernel_is_refused_for_the_card():
    before = dict(hopper.LAUNCHES)
    with pytest.raises(LoweringError, match="no Hopper stream kernel"):
        frontend.stream_kernel(scan._scan_block)
    assert frontend.stream_kernel(scan.SCAN) is hopper.stream_scan
    assert frontend.stream_kernel(fft.FFT) is hopper.stream_fft
    assert frontend.stream_kernel(bitonic.BITONIC) is hopper.stream_bitonic
    assert frontend.baseline_kernel(scan.BASE_SCAN) is hopper.base_scan
    assert hopper.LAUNCHES == before


def test_stream_kernels_refuse_a_launch_they_do_not_compute():
    """K14–K16 check the Launch as well as the operands: the grid, every
    stream's walk, the outputs, the scratch and the axes' semantics."""
    arrays, static, _ = scan._prepare(torch.ones(4096))
    lc = scan._launch(static, *arrays)
    walk = agu.BlockAGU((8, 128), (0, 0), ((1, 0),))
    expect = ((4,), (walk,), (walk,), (((32, 128), torch.float32),),
              (((1, 1), torch.float32),), ("arbitrary",))
    assert hopper._launch_refusal("stream_scan", lc, *expect) is None
    shifted = BlockStream((8, 128), lambda i: (i + 1, 0), name="x")
    for wrong, match in (
            (dataclasses.replace(lc, dimension_semantics=("parallel",)),
             "runs axes"),
            (dataclasses.replace(lc, grid=(2,)), "runs grid"),
            (dataclasses.replace(lc, in_streams=(shifted,)), "walks"),
            (dataclasses.replace(lc, scratch_shapes=()), "scratch"),
            (dataclasses.replace(lc, out_shapes=(frontend.ShapeDtype(
                (32, 128), torch.bfloat16),)), "writes")):
        assert match in hopper._launch_refusal("stream_scan", wrong,
                                               *expect)


def test_stream_entry_points_never_run_plain_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks a machine "
                    "without one")
    x = torch.ones(64)
    for fn, args in ((ops.prefix_sum, (x,)), (ops.fft, (x, x)),
                     (ops.sort, (x,))):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(*args, ssr=True, device="cuda")


@pytest.mark.parametrize("name", ["reduction", "gemv"])
def test_loop_nest_is_the_references(name):
    x = np.ones((6, 40), np.float32)
    port_mod, jmod = {"reduction": (reduction, jreduction),
                      "gemv": (gemv, jgemv)}[name]
    args = (x[0], x[0]) if name == "reduction" else (x, x[0])
    _, static, _ = port_mod._ssr._prepare(*[_t(a) for a in args])
    _, jstatic, _ = jmod._ssr._prepare(*[jnp.asarray(a) for a in args])
    nest = port_mod._ssr.loop_nest(static)
    assert nest == interop.loop_nest_from_reference(
        jmod._ssr.loop_nest(jstatic))


# -- the registry and the oracles ---------------------------------------------


@pytest.mark.parametrize("name", ["scan", "fft", "bitonic"])
def test_registry_entries_match_the_reference(name):
    e, je = registry.get(name), jregistry.get(name)
    assert e.tol == je.tol and e.problem == je.problem
    assert sorted(e.variants()) == sorted(je.variants())
    for odd in (False, True):
        args, _ = e.example(np.random.default_rng(0), odd=odd)
        jargs, _ = je.example(np.random.default_rng(0), odd=odd)
        for a, ja in zip(args, jargs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


def test_refs_match_the_reference_refs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(2048).astype(np.float32)
    y = rng.standard_normal(2048).astype(np.float32)
    np.testing.assert_allclose(ref.scan_ref(_t(x)).numpy(),
                               np.asarray(jref.scan_ref(x)), rtol=1e-5,
                               atol=1e-4)
    scale = np.sum(np.abs(x) + np.abs(y))
    for got, want in zip(ref.fft_ref(_t(x), _t(y)), jref.fft_ref(x, y)):
        assert got.dtype == torch.float32
        assert np.max(np.abs(got.numpy() - np.asarray(want))) / scale <= 1e-6
    np.testing.assert_array_equal(ref.sort_ref(_t(x)).numpy(),
                                  np.asarray(jref.sort_ref(x)))


@pytest.mark.parametrize("name, op", [("scan", "prefix_sum"), ("fft", "fft"),
                                      ("bitonic", "sort")])
def test_ssrcfg_switch_keeps_semantics(name, op):
    args, _ = registry.get(name).example(np.random.default_rng(9), odd=True)
    plain = getattr(ops, op)(*args)
    streamed = getattr(ops, op)(*args, ssr=True)
    for p, s in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (plain, streamed))):
        torch.testing.assert_close(s, p, **{"rtol": 1e-3, "atol": 1e-3}
                                   if name != "bitonic" else
                                   {"rtol": 0, "atol": 0})
