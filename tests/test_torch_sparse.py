"""Indirection streams: the port's CSR kernels against the JAX package's.

The same numpy CSR triples and dense operands go to ``repro.kernels.sparse``
(Pallas interpret mode, pinned to ``DEFAULT_SCHEDULE``) and to
``repro_torch.kernels.sparse`` on the CPU (the plain versions).  Exact for
what is pure Python or numpy: validation and its messages, ELL packing (on
the host and on the tensors' device), the Eq. (1)–(3) numbers of the static
plan, the lowered geometry with its ``IndirectGather`` records, the padded
layouts and table views, the ``StreamReport`` bytes (the table stream
included), cache keys, candidates and ``LoweringError`` messages.  Within
the registry ``tol`` (1e-5) for values: spmv, sparse_gemv, spmm and both
baselines, on the reference's hypothesis CSR patterns and the named edge
cases.  Two deliberate divergences are pinned: gather tables charge no TPU
VMEM budget, and a non-finite table entry at the pad address reaches only
the rows whose ELL pads read it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hypothesis import given, settings
import hypothesis.strategies as st
from repro.core import autotune as jautotune
from repro.core import compiler as jcompiler
from repro.core import lowering as jlowering
from repro.core.nest_analysis import LoopNest as JLoopNest
from repro.core.nest_analysis import MemRef as JMemRef
from repro.core.stream import Direction as JDirection
from repro.kernels import sparse as jsp

import repro_torch
from repro_torch.core import autotune, compiler, hopper, lowering
from repro_torch.core import nest_analysis
from repro_torch.core.lowering import DEFAULT_SCHEDULE, LoweringError, Schedule
from repro_torch.core.nest_analysis import LoopNest, MemRef
from repro_torch.core.stream import Direction
from repro_torch.kernels import frontend, ops, registry
from repro_torch.kernels import sparse as sp

from test_torch_halo import assert_same_geometry

#: The differential-agreement bound (the registry tol of both entries).
TOL = 1e-5
DENSITIES = (0.01, 0.1, 0.5)
JDEFAULT = jlowering.DEFAULT_SCHEDULE


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    # a schedule cache of the test's own: a tuned entry elsewhere must not
    # change either package's schedule
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _close(got, want, tol=TOL, terms=None):
    """max |got − want| ≤ tol, or with ``terms`` (Σ_j |v_ij|·|x_cidx| per
    output) ≤ tol·(1 + terms): a row of 600 terms sums to ~20 and differs
    by more than 1e-5 between two summation orders."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.size:
        bound = tol if terms is None else tol * (1 + np.asarray(terms))
        assert np.all(np.abs(got - want) <= bound)


def _terms(data, indices, indptr, operand):
    """Σ_j |v_ij|·|x_cidx| per output: the oracle on absolute values."""
    return sp.ref_spmv(np.abs(data), indices, indptr, np.abs(operand)) \
        if np.ndim(operand) == 1 else \
        sp.ref_spmm(np.abs(data), indices, indptr, np.abs(operand))


# -- CSR inputs ----------------------------------------------------------------


@st.composite
def csr_patterns(draw, max_m=9, max_n=12):
    """A random valid CSR triple + its column count (the reference's
    strategy, ``tests/test_sparse.py``): ragged rows, empty rows, all-zero
    matrices at density 0.01, non-square shapes."""
    m = draw(st.integers(min_value=1, max_value=max_m))
    n = draw(st.integers(min_value=1, max_value=max_n))
    density = draw(st.sampled_from(list(DENSITIES)))
    data, indices, indptr = [], [], [0]
    for _ in range(m):
        cap = max(0, round(n * density))
        if cap and draw(st.booleans()):
            cap = max(1, cap - 1)  # jitter the row budget: ragged rows
        cols = sorted(draw(st.lists(
            st.integers(min_value=0, max_value=n - 1),
            min_size=0, max_size=cap, unique=True)))
        for c in cols:
            indices.append(c)
            data.append(draw(st.floats(min_value=-2.0, max_value=2.0)))
        indptr.append(len(indices))
    return (np.asarray(data, np.float32), np.asarray(indices, np.int64),
            np.asarray(indptr, np.int64), n)


def _long_row(k, seed=0):
    """Row 0 holds k entries (k > 128: the lowering pads k past one lane
    tile), row 1 one entry, row 2 none."""
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.choice(1000, k, replace=False))
    return (rng.standard_normal(k + 1).astype(np.float32),
            np.concatenate([cols, [7]]).astype(np.int64),
            np.asarray([0, k, k + 1, k + 1], np.int64), 1000)


def _edge(name):
    """The named edge shapes of the reference's deterministic tests, and
    rows longer than one lane tile."""
    if name == "all_zero":
        return (np.zeros(0, np.float32), np.zeros(0, np.int64),
                np.zeros(5, np.int64), 7)
    if name == "single_element_rows":
        return (np.asarray([1.5, -2.0, 0.25], np.float32),
                np.asarray([4, 0, 2], np.int64),
                np.asarray([0, 1, 2, 3], np.int64), 6)
    if name == "mixed_empty_and_full":
        return (np.asarray([1.0, 2.0, 3.0, 4.0], np.float32),
                np.asarray([0, 1, 2, 3], np.int64),
                np.asarray([0, 0, 4, 4], np.int64), 4)
    if name == "one_by_one":
        return (np.asarray([3.0], np.float32), np.asarray([0], np.int64),
                np.asarray([0, 1], np.int64), 1)
    if name in ("tall", "wide"):
        m, n = (17, 3) if name == "tall" else (3, 17)
        return (*sp.random_csr(np.random.default_rng(11), m, n, 0.3), n)
    if name.startswith("row"):
        return _long_row(int(name[3:]))
    raise KeyError(name)


EDGES = ["all_zero", "single_element_rows", "mixed_empty_and_full",
         "one_by_one", "tall", "wide", "row300", "row600"]


def _operands(n, c, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((n, c)).astype(np.float32))


# -- values: the port on the CPU against the reference -------------------------


@settings(max_examples=30, deadline=None)
@given(csr=csr_patterns())
def test_spmv_matches_reference(csr):
    data, indices, indptr, n = csr
    x = np.random.default_rng(n * 1000 + data.size).standard_normal(n) \
        .astype(np.float32)
    want = jsp.ssr_spmv(data, indices, indptr, x, schedule=JDEFAULT)
    _close(sp.ssr_spmv(data, indices, indptr, x), want)
    _close(ops.spmv(data, indices, indptr, x, ssr=True), want)


@settings(max_examples=15, deadline=None)
@given(csr=csr_patterns())
def test_spmv_baseline_matches_reference(csr):
    data, indices, indptr, n = csr
    x = np.random.default_rng(n * 77 + data.size).standard_normal(n) \
        .astype(np.float32)
    _close(sp.baseline_spmv(data, indices, indptr, x),
           jsp.baseline_spmv(data, indices, indptr, x))


@settings(max_examples=30, deadline=None)
@given(csr=csr_patterns(), c=st.integers(min_value=1, max_value=5))
def test_spmm_matches_reference(csr, c):
    data, indices, indptr, n = csr
    x = np.random.default_rng(n * 1000 + c).standard_normal((n, c)) \
        .astype(np.float32)
    _close(sp.ssr_spmm(data, indices, indptr, x),
           jsp.ssr_spmm(data, indices, indptr, x, schedule=JDEFAULT))


@settings(max_examples=15, deadline=None)
@given(csr=csr_patterns(), c=st.integers(min_value=1, max_value=5))
def test_spmm_baseline_matches_reference(csr, c):
    data, indices, indptr, n = csr
    x = np.random.default_rng(n * 77 + c).standard_normal((n, c)) \
        .astype(np.float32)
    _close(sp.baseline_spmm(data, indices, indptr, x),
           jsp.baseline_spmm(data, indices, indptr, x))


@pytest.mark.parametrize("name", EDGES)
def test_edge_cases_match_reference(name):
    data, indices, indptr, n = _edge(name)
    x, X = _operands(n, 3, len(name))
    tv, tm = (_terms(data, indices, indptr, a) for a in (x, X))
    _close(sp.ssr_spmv(data, indices, indptr, x),
           jsp.ssr_spmv(data, indices, indptr, x, schedule=JDEFAULT),
           terms=tv)
    _close(sp.baseline_spmv(data, indices, indptr, x),
           jsp.baseline_spmv(data, indices, indptr, x), terms=tv)
    _close(sp.ssr_spmm(data, indices, indptr, X),
           jsp.ssr_spmm(data, indices, indptr, X, schedule=JDEFAULT),
           terms=tm)
    _close(sp.baseline_spmm(data, indices, indptr, X),
           jsp.baseline_spmm(data, indices, indptr, X), terms=tm)
    _close(sp.ref_spmv(data, indices, indptr, x),
           jsp.ref_spmv(data, indices, indptr, x), terms=tv)


@pytest.mark.parametrize("c", [129, 200])
@pytest.mark.parametrize("name", ["tall", "row300"])
def test_wide_dense_operand_matches_reference(name, c):
    """c > 128: the table pitch is 256 and the c tile spans two of K13's
    128-column chunks (or two tiles under the small-tile schedule)."""
    data, indices, indptr, n = _edge(name)
    _, X = _operands(n, c, c)
    terms = _terms(data, indices, indptr, X)
    for kw in ({}, dict(lanes_tile_factor=1, rows_tile_factor=2)):
        _close(sp.ssr_spmm(data, indices, indptr, X, schedule=Schedule(**kw)),
               jsp.ssr_spmm(data, indices, indptr, X,
                            schedule=jlowering.Schedule(**kw)), terms=terms)
    _close(sp.baseline_spmm(data, indices, indptr, X),
           jsp.baseline_spmm(data, indices, indptr, X), terms=terms)


@pytest.mark.parametrize("kw", [dict(lanes_tile_factor=1, rows_tile_factor=2),
                                dict(rows=16, lanes=256)],
                         ids=["small_tiles", "rows16_lanes256"])
@pytest.mark.parametrize("name", ["row300", "row600", "tall"])
def test_schedules_match_reference(name, kw):
    """Under a non-default schedule (k = 300 in three 128-lane steps, the
    accumulator carried between them) the values follow the reference."""
    data, indices, indptr, n = _edge(name)
    x, X = _operands(n, 5, 3)
    _close(sp.ssr_spmv(data, indices, indptr, x, schedule=Schedule(**kw)),
           jsp.ssr_spmv(data, indices, indptr, x,
                        schedule=jlowering.Schedule(**kw)),
           terms=_terms(data, indices, indptr, x))
    _close(sp.ssr_spmm(data, indices, indptr, X, schedule=Schedule(**kw)),
           jsp.ssr_spmm(data, indices, indptr, X,
                        schedule=jlowering.Schedule(**kw)),
           terms=_terms(data, indices, indptr, X))


@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("name", ["spmv", "spmm"])
def test_registry_examples_match_reference(name, odd):
    """The entries' examples draw the reference's numbers from the same
    numpy Generator; ssr and baseline agree with the reference's."""
    args, kw = registry.get(name).example(np.random.default_rng(3), odd=odd)
    jargs, jkw = jsp_entry(name).example(np.random.default_rng(3), odd=odd)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    entry = registry.get(name)
    for variant in ("ssr", "baseline", "ref"):
        got = getattr(entry, variant)(*args, **kw)
        jfn = getattr(jsp_entry(name), variant)
        want = jfn(*jargs, schedule=JDEFAULT) if variant == "ssr" \
            else jfn(*jargs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **entry.tol)


def jsp_entry(name):
    from repro.kernels import registry as jregistry
    return jregistry.get(name)


def test_sparse_gemv_alias():
    data, indices, indptr = sp.random_csr(np.random.default_rng(5), 8, 10, 0.2)
    x = np.random.default_rng(6).standard_normal(10).astype(np.float32)
    assert sp.ssr_sparse_gemv is sp.ssr_spmv
    assert torch.equal(ops.sparse_gemv(data, indices, indptr, x, ssr=True),
                       ops.spmv(data, indices, indptr, x, ssr=True))


def test_ops_facades_agree_across_ssrcfg():
    rng = np.random.default_rng(6)
    data, indices, indptr = sp.random_csr(rng, 9, 11, 0.2)
    x = rng.standard_normal(11).astype(np.float32)
    X = rng.standard_normal((11, 4)).astype(np.float32)
    _close(ops.spmv(data, indices, indptr, x, ssr=True),
           ops.spmv(data, indices, indptr, x, ssr=False))
    _close(ops.spmm(data, indices, indptr, X, ssr=True),
           ops.spmm(data, indices, indptr, X, ssr=False))


# -- exact: validation, packing and their messages ---------------------------


CASES = EDGES[:6] + ["example"]


def _case(name):
    if name == "example":
        return (*sp.random_csr(np.random.default_rng(2), 37, 53, 0.1), 53)
    if name == "rows300":        # several row blocks and k steps
        return (*sp.random_csr(np.random.default_rng(4), 300, 700, 0.3), 700)
    return _edge(name)


@pytest.mark.parametrize("name", CASES)
def test_host_packing_matches_reference(name):
    data, indices, indptr, n = _case(name)
    for got, want in zip(sp.validate_csr(data, indices, indptr, n),
                         jsp.validate_csr(data, indices, indptr, n)):
        np.testing.assert_array_equal(got, want)
    for fn in ("csr_to_ell", "csr_to_dense"):
        got = getattr(sp, fn)(data, indices, indptr, n)
        want = getattr(jsp, fn)(data, indices, indptr, n)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == np.asarray(w).dtype


def _pack_both(data, indices, indptr, n):
    got = sp.pack_ell(torch.from_numpy(np.asarray(data)),
                      torch.from_numpy(np.asarray(indices)),
                      torch.from_numpy(np.asarray(indptr)), n)
    want = jsp.csr_to_ell(data, indices, indptr, n)
    assert got[2:] == want[2:]
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("name", CASES)
def test_device_packing_matches_csr_to_ell(name):
    _pack_both(*_case(name))


@settings(max_examples=30, deadline=None)
@given(csr=csr_patterns())
def test_device_packing_matches_csr_to_ell_on_patterns(csr):
    _pack_both(*csr)


_GOOD = (np.asarray([1.0, 2.0, 3.0], np.float32),
         np.asarray([0, 2, 1], np.int64),
         np.asarray([0, 2, 3], np.int64), 4)

BAD = {
    "short_indptr": (_GOOD[0], _GOOD[1], np.asarray([0]), 4),
    "two_dimensional_indptr": (_GOOD[0], _GOOD[1],
                               np.zeros((2, 2), np.int64), 4),
    "length_mismatch": (_GOOD[0][:2], _GOOD[1], _GOOD[2], 4),
    "non_monotone": (_GOOD[0], _GOOD[1], np.asarray([0, 3, 2]), 4),
    "non_monotone_right_ends": (_GOOD[0], _GOOD[1],
                                np.asarray([0, 3, 1, 3]), 4),
    "bad_start": (_GOOD[0], _GOOD[1], np.asarray([1, 2, 3]), 4),
    "bad_end": (_GOOD[0], _GOOD[1], np.asarray([0, 2, 5]), 4),
    "column_too_big": (_GOOD[0], np.asarray([0, 9, 1]), _GOOD[2], 4),
    "column_negative": (_GOOD[0], np.asarray([0, -1, 1]), _GOOD[2], 4),
    "unsorted_in_row": (np.asarray([1.0, 2.0, 3.0]), np.asarray([2, 0, 1]),
                        np.asarray([0, 3, 3]), 4),
    "duplicate_in_row": (np.asarray([1.0, 2.0]), np.asarray([1, 1]),
                         np.asarray([0, 2]), 4),
}


def _message(fn, *args):
    with pytest.raises(ValueError) as info:
        fn(*args)
    return str(info.value)


@pytest.mark.parametrize("name", sorted(BAD))
def test_invalid_csr_messages_match_reference(name):
    """Every malformed triple raises the reference's message, verbatim,
    from validation, host packing, device packing and every entry point."""
    data, indices, indptr, n = BAD[name]
    want = _message(jsp.validate_csr, data, indices, indptr, n)
    assert _message(sp.validate_csr, data, indices, indptr, n) == want
    assert _message(sp.csr_to_ell, data, indices, indptr, n) == want
    assert _message(sp.pack_ell, *(torch.from_numpy(np.asarray(a))
                                   for a in (data, indices, indptr)),
                    n) == want
    x, X = np.ones(n, np.float32), np.ones((n, 2), np.float32)
    for fn, operand in ((sp.ssr_spmv, x), (sp.baseline_spmv, x),
                        (sp.ref_spmv, x), (sp.ssr_spmm, X),
                        (sp.baseline_spmm, X), (sp.ref_spmm, X)):
        assert _message(fn, data, indices, indptr, operand) == want


def test_descending_across_a_row_boundary_is_valid():
    args = (np.asarray([1.0, 2.0]), np.asarray([3, 0]), np.asarray([0, 1, 2]),
            4)
    sp.validate_csr(*args)
    _pack_both(*args)


def test_spmm_rejects_a_vector_operand_as_the_reference():
    x = np.ones(_GOOD[3], np.float32)
    assert _message(sp.ssr_spmm, *_GOOD[:3], x) == \
        _message(jsp.ssr_spmm, *_GOOD[:3], x)


# -- exact: the cost model, the lowering, layouts, reports, keys ---------------


STATS_NESTS = {
    "spmv_16x6": ("spmv_nest", (16, 6)),
    "spmm_8x4x5": ("spmm_nest", (8, 4, 5, 128)),
    "gemm_8": ("gemm_nest", (8, 8, 8)),
    "spmv_hpcg": ("spmv_nest", (2097152, 27)),
    "spmm_hpcg": ("spmm_nest", (262144, 128, 27, 128)),
}


@pytest.mark.parametrize("name", sorted(STATS_NESTS))
def test_plan_stats_match_reference(name):
    fn, args = STATS_NESTS[name]
    nest, jnest = getattr(compiler, fn)(*args), getattr(jcompiler, fn)(*args)
    lanes = nest_analysis.auto_lanes(nest)
    got = lowering.plan_stats(nest, num_lanes=lanes)
    want = jlowering.plan_stats(jnest, num_lanes=lanes)
    assert (got.ssrified, got.eliminated_idx_instrs, got.n_base,
            got.n_ssr) == (want.ssrified, want.eliminated_idx_instrs,
                           want.n_base, want.n_ssr)
    if fn == "spmv_nest":        # one index load + one address op per slot
        assert got.eliminated_idx_instrs == 2 * args[0] * args[1]
    if fn == "spmm_nest":        # re-paid for every dense column
        assert got.eliminated_idx_instrs == 2 * args[0] * args[1] * args[2]
    if fn == "gemm_nest":
        assert got.eliminated_idx_instrs == 0
    assert got.ssrified and got.n_base > got.n_ssr


LOWER_NESTS = {
    "spmv_37x13": ("spmv_nest", (37, 13)),
    "spmv_37x300": ("spmv_nest", (37, 300)),
    "spmv_hpcg": ("spmv_nest", (2097152, 27)),
    "spmm_29x17": ("spmm_nest", (29, 17, 13, 128)),
    "spmm_1000x200x300": ("spmm_nest", (1000, 200, 300, 256)),
    "spmm_hpcg": ("spmm_nest", (262144, 128, 27, 128)),
}
LOWER_SCHEDULES = {
    "default": {},
    "rows16_lanes256": dict(rows=16, lanes=256),
    "small_tiles": dict(lanes_tile_factor=1, rows_tile_factor=2),
    "c_axis_first": dict(axis_order=(1, 0, 2)),
}


def _plans(name):
    fn, args = LOWER_NESTS[name]
    nest, jnest = getattr(compiler, fn)(*args), getattr(jcompiler, fn)(*args)
    lanes = nest_analysis.auto_lanes(nest, None)
    return lowering._plan_for(nest, lanes), jlowering._plan_for(jnest, lanes)


def _lower_both(name, sched):
    plan, jplan = _plans(name)
    kw = LOWER_SCHEDULES[sched]
    return (lowering.lower_nest(plan, schedule=Schedule(**kw)),
            jlowering.lower_nest(jplan, schedule=jlowering.Schedule(**kw)))


LOWER_IDS = [(n, s) for n in sorted(LOWER_NESTS) for s in LOWER_SCHEDULES
             if not (n.startswith("spmv") and s == "c_axis_first")]


@pytest.mark.parametrize("name,sched", LOWER_IDS,
                         ids=[f"{n}-{s}" for n, s in LOWER_IDS])
def test_lowered_gathers_match_reference(name, sched):
    lw, rw = _lower_both(name, sched)
    assert_same_geometry(lw, rw)
    assert [dataclasses.astuple(g) for g in lw.gathers] == \
        [dataclasses.astuple(g) for g in rw.gathers]
    assert len(lw.gathers) == 1 and lw.gathers[0].index_of == "cidx"


def _arrays(lw, seed):
    """Operands for every read stream and gather table of ``lw``: int32
    column indices for cidx, f32 values for the rest."""
    rng = np.random.default_rng(seed)
    plan = lw.plan
    nest = plan.nest
    out = {}
    for s in lw.in_streams:
        shape = s.logical_shape
        if s.name == "cidx":
            out[s.name] = rng.integers(0, 50, shape).astype(np.int32)
        else:
            out[s.name] = rng.standard_normal(shape).astype(np.float32)
    for g in lw.gathers:
        ref = next(r for r in nest.refs if r.name == g.name)
        rows = 50
        shape = (rows,) if ref.index_scale == 1 else (rows, ref.index_scale)
        out[g.name] = rng.standard_normal(shape).astype(np.float32)
    return out


SMALL = [n for n in sorted(LOWER_NESTS) if "hpcg" not in n]


@pytest.mark.parametrize("sched", ["default", "small_tiles"])
@pytest.mark.parametrize("name", SMALL)
def test_stream_layouts_match_reference(name, sched):
    """The padded layouts of the read streams, then each table whole as
    its ≥2-D view: what the reference's ``ssr_call`` hands its kernel."""
    lw, rw = _lower_both(name, sched)
    data = _arrays(lw, 5)
    names = [s.name for s in lw.in_streams] + [g.name for g in lw.gathers]
    got = lowering.stream_layouts(lw, [torch.from_numpy(data[k])
                                       for k in names])
    want = [np.asarray(s.prepare(jnp.asarray(data[s.name])))
            for s in rw.in_streams]
    want += [np.asarray(jnp.reshape(jnp.asarray(data[g.name]),
                                    jlowering._table_view_shape(
                                        data[g.name].shape)))
             for g in rw.gathers]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="gather tables"):
        lowering.stream_layouts(lw, [torch.from_numpy(data[k])
                                     for k in names[:-1]])


@pytest.mark.parametrize("sched", ["default", "small_tiles",
                                   "rows16_lanes256"])
@pytest.mark.parametrize("name", SMALL)
def test_stream_report_counts_the_table_as_the_reference(name, sched):
    """The table stream is a revisited invariant block at depth 2: its
    bytes enter the in-flight set twice, the streamed bytes every step and
    the unique bytes once — the reference's ``StreamReport``, byte for
    byte (bf16 values included)."""
    lw, rw = _lower_both(name, sched)
    table = _arrays(lw, 1)[lw.gathers[0].name]
    view = jlowering._table_view_shape(table.shape)
    kern = lowering._build_nest_kernel(lw, lambda *b: b[0], torch.float32,
                                       (view,))
    jkern = jlowering._build_nest_kernel(
        rw, lambda *b: b[0], jnp.float32, True,
        tables=(jax.ShapeDtypeStruct(view, jnp.float32),))
    for dts, jdts in (
            ([torch.float32, torch.int32, torch.float32, torch.float32],
             [jnp.float32, jnp.int32, jnp.float32, jnp.float32]),
            ([torch.bfloat16, torch.int32, torch.bfloat16, torch.float32],
             [jnp.bfloat16, jnp.int32, jnp.bfloat16, jnp.float32])):
        got, want = kern.report(dts), jkern.report(jdts)
        assert (got.grid, got.vmem_bytes, got.hbm_bytes_streamed,
                got.hbm_bytes_unique, got.scratch_bytes) == \
            (want.grid, want.vmem_bytes, want.hbm_bytes_streamed,
             want.hbm_bytes_unique, want.scratch_bytes)
    # the table is the trailing read stream, one block, at FIFO depth 2
    assert kern.in_streams[-1].block_shape == view
    assert kern.depths[-1] == 2 and len(kern.depths) == 3


def _unlowerable(order, lanes=3, ref=False):
    """spmv-like nests whose allocation leaves a gather unservable: refs in
    ``order`` allocate first (cidx varies with the row level only)."""
    L, M, D = ((JLoopNest, JMemRef, JDirection) if ref
               else (LoopNest, MemRef, Direction))
    refs = {"vals": M("vals", D.READ, (4, 1)),
            "cidx": M("cidx", D.READ, (1, 0)),
            "x": M("x", D.READ, (0, 0), index_of="cidx"),
            "y": M("y", D.WRITE, (1, 0))}
    nest = L(bounds=(8, 4), refs=tuple(refs[k] for k in order),
             compute_per_level=(0, 1))
    return (jcompiler if ref else compiler).ssrify(nest, num_lanes=lanes,
                                                   force=True)


def _overlapping(ref=False):
    L, M, D = ((JLoopNest, JMemRef, JDirection) if ref
               else (LoopNest, MemRef, Direction))
    nest = L(bounds=(8, 3, 4),
             refs=(M("vals", D.READ, (4, 0, 1)), M("cidx", D.READ, (4, 0, 1)),
                   M("X", D.READ, (0, 1, 1), index_of="cidx",
                     index_scale=128),
                   M("Y", D.WRITE, (3, 1, 0))),
             compute_per_level=(0, 0, 1))
    return (jcompiler if ref else compiler).ssrify(nest, num_lanes=4,
                                                   force=True)


@pytest.mark.parametrize("case,phrase", [
    (("vals", "y", "cidx", "x"), "was not allocated a lane; a gather"),
    (("vals", "y", "x", "cidx"), "must itself be an allocated read stream"),
    ("overlap", "coincide with the index stream's varying levels"),
], ids=["residual_gather", "index_not_allocated", "affine_overlap"])
def test_lowering_errors_match_reference(case, phrase):
    if case == "overlap":
        plan, jplan = _overlapping(), _overlapping(ref=True)
    else:
        plan, jplan = _unlowerable(case), _unlowerable(case, ref=True)
    with pytest.raises(jlowering.LoweringError) as want:
        jlowering.lower_nest(jplan)
    with pytest.raises(LoweringError) as got:
        lowering.lower_nest(plan)
    assert str(got.value) == str(want.value)
    assert phrase in str(got.value)


def test_flat_path_refuses_gathers_as_the_reference():
    nest, jnest = compiler.spmv_nest(8, 4), jcompiler.spmv_nest(8, 4)
    lanes = nest_analysis.auto_lanes(nest)
    with pytest.raises(jlowering.LoweringError) as want:
        jlowering.lower_plan(jlowering._plan_for(jnest, lanes))
    with pytest.raises(LoweringError) as got:
        lowering.lower_plan(lowering._plan_for(nest, lanes))
    assert str(got.value) == str(want.value)


def test_missing_table_operand_is_named_as_the_reference():
    nest, jnest = compiler.spmv_nest(8, 4), jcompiler.spmv_nest(8, 4)
    vals = np.ones((8, 4), np.float32)
    cidx = np.zeros((8, 4), np.int32)
    with pytest.raises(ValueError) as want:
        jlowering.ssr_call(jnest, lambda *b: b[0],
                           {"vals": jnp.asarray(vals), "cidx": jnp.asarray(cidx)},
                           schedule=JDEFAULT)
    with pytest.raises(ValueError) as got:
        lowering.ssr_call(nest, sp.SPMV, {"vals": vals, "cidx": cidx},
                          schedule=DEFAULT_SCHEDULE)
    assert str(got.value) == str(want.value) == \
        "missing operands for streams ['x']"


@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_cache_keys_and_candidates_match_reference(kind):
    if kind == "spmv":
        nest, jnest = compiler.spmv_nest(37, 13), jcompiler.spmv_nest(37, 13)
        arrays = {"vals": np.ones((37, 13), np.float32),
                  "cidx": np.zeros((37, 13), np.int32),
                  "x": np.ones(53, np.float32)}
    else:
        nest = compiler.spmm_nest(29, 17, 13, 128)
        jnest = jcompiler.spmm_nest(29, 17, 13, 128)
        arrays = {"vals": np.ones((29, 13), np.float32),
                  "cidx": np.zeros((29, 13), np.int32),
                  "X": np.ones((41, 128), np.float32)}
        assert ":ix=cidx*128" in autotune.nest_signature(nest)
    ops_ = {k: torch.from_numpy(v) for k, v in arrays.items()}
    jops = {k: jnp.asarray(v) for k, v in arrays.items()}
    assert autotune.nest_signature(nest) == jautotune.nest_signature(jnest)
    assert autotune.cache_key(nest, ops_, mode="reduce", backend="cpu") == \
        jautotune.cache_key(jnest, jops, mode="reduce", backend="cpu")
    for quick in (True, False):
        got = autotune.candidate_schedules(nest, quick=quick, operands=ops_)
        want = jautotune.candidate_schedules(jnest, quick=quick,
                                             operands=jops)
        assert [s.to_json() for s in got] == [s.to_json() for s in want]


# -- the kernels' acceptance, the plain version's chunks -------------------------


def _call(kind, schedule=DEFAULT_SCHEDULE, c=17, case="example"):
    data, indices, indptr, n = _case(case)
    vals, cidx, m, k = sp.csr_to_ell(data, indices, indptr, n)
    x, X = _operands(n, c, 9)
    if kind == "spmv":
        return lowering.prepare_call(
            compiler.spmv_nest(m, k), sp.SPMV,
            {"vals": vals, "cidx": cidx, "x": x}, schedule=schedule)
    pitch = -(-c // 128) * 128
    return lowering.prepare_call(
        compiler.spmm_nest(m, c, k, pitch), sp.SPMM,
        {"vals": vals, "cidx": cidx, "X": np.pad(X, ((0, 0), (0, pitch - c)))},
        schedule=schedule)


@pytest.mark.parametrize("kind,kernel", [("spmv", "gather_spmv"),
                                         ("spmm", "gather_spmm")])
def test_gather_kernels_accept_the_lowered_geometry(kind, kernel):
    for sched in (DEFAULT_SCHEDULE, Schedule(lanes_tile_factor=1,
                                             rows_tile_factor=2),
                  Schedule(rows=16, lanes=256)):
        kern = _call(kind, sched).kernel
        assert kern.device_kernel() is getattr(hopper, kernel)
        assert hopper.accepts(kern.device_key, kern.geometry, torch.float32,
                              "cpu", program=kern.program) == (True, "ok")
        takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                    torch.bfloat16, "cpu",
                                    program=kern.program)
        assert not takes and "float32" in why
        g = kern.geometry.gathers[0]
        assert (g.index, g.table) == (1, 2)
    # a gather whose affine level steps by 2 is no K13 geometry
    geo = _call("spmm").kernel.geometry
    bent = dataclasses.replace(geo, gathers=(dataclasses.replace(
        geo.gathers[0], coeffs=(2,)),))
    assert not hopper.accepts(("nest", "spmm"), bent, torch.float32, "cpu")[0]


@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_plain_gather_runs_in_chunks_with_the_same_result(kind, monkeypatch):
    """The plain version holds at most PLAIN_GATHER_ELEMS gathered values:
    at one element it runs one output block at a time, to the same bits."""
    sched = Schedule(lanes_tile_factor=1, rows_tile_factor=2)
    call = _call(kind, sched, c=200, case="rows300")
    geo = call.kernel.geometry
    assert geo.contraction_steps > 1 and geo.steps > geo.contraction_steps
    whole = call.run()
    monkeypatch.setattr(hopper, "PLAIN_GATHER_ELEMS", 1)
    assert torch.equal(call.run(), whole)


def test_plain_base_versions_run_in_chunks_with_the_same_result(monkeypatch):
    data, indices, indptr, n = _case("example")
    vals, cidx, _, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                        else a for a in sp.csr_to_ell(data, indices, indptr,
                                                      n))
    x, X = (torch.from_numpy(a) for a in _operands(n, 7, 2))
    whole = (hopper.plain_base_spmv(vals, cidx, x.reshape(1, -1)),
             hopper.plain_base_spmm(vals, cidx, X))
    monkeypatch.setattr(hopper, "PLAIN_GATHER_ELEMS", 1)
    assert torch.equal(hopper.plain_base_spmv(vals, cidx, x.reshape(1, -1)),
                       whole[0])
    assert torch.equal(hopper.plain_base_spmm(vals, cidx, X), whole[1])


# -- the pinned divergences --------------------------------------------------------


def test_gather_tables_charge_no_vmem_budget():
    """The port's counterpart of the reference's
    ``TestDispatch::test_gather_tables_charge_the_vmem_budget``: the
    reference holds a 2**26-element table to its 64 MiB TPU VMEM budget;
    on the card the table lives in device memory, so the port holds no
    budget and the schedule stays legal (ROADMAP, Queue C)."""
    nest, jnest = compiler.spmv_nest(8, 4), jcompiler.spmv_nest(8, 4)
    table = {"x": ((1 << 26,), "float32")}
    assert autotune.schedule_is_legal(nest, DEFAULT_SCHEDULE) == (True, "ok")
    assert autotune.schedule_is_legal(nest, DEFAULT_SCHEDULE,
                                      operands=table) == (True, "ok")
    ok, why = jautotune.schedule_is_legal(jnest, JDEFAULT, operands=table)
    assert not ok and "VMEM" in why
    # on the card legality asks the kernel, which takes the table whole
    assert autotune.kernel_refusal(nest, DEFAULT_SCHEDULE, sp.SPMV,
                                   operands=table, device="cpu") is None


def test_non_finite_pad_address_reaches_only_ell_pads():
    """x[0] = inf.  The reference gathers x[0] for the lowering's pad lanes
    (k = 2 padded to 128) and turns every row NaN through 0·inf, as its
    densified oracle does; the port (K12 and its plain version) reads only
    the lanes holding data, so a full row that does not touch column 0
    stays finite, and a row with an ELL pad (0.0, 0) is NaN in both
    (ROADMAP, Queue C)."""
    data = np.asarray([1.0, 2.0, 3.0], np.float32)
    indices, indptr = np.asarray([1, 2, 3]), np.asarray([0, 2, 3])
    x = np.asarray([np.inf, 1.0, 2.0, 3.0], np.float32)
    want = np.asarray(jsp.ssr_spmv(data, indices, indptr, x,
                                   schedule=JDEFAULT))
    got = sp.ssr_spmv(data, indices, indptr, x).numpy()
    assert np.isnan(want).all()
    assert got[0] == 5.0 and np.isnan(got[1])
    # the baselines read every ELL column, as the reference's do
    base = sp.baseline_spmv(data, indices, indptr, x).numpy()
    jbase = np.asarray(jsp.baseline_spmv(data, indices, indptr, x))
    np.testing.assert_array_equal(base, jbase)
    # with a finite table the two agree
    x[0] = 4.0
    _close(sp.ssr_spmv(data, indices, indptr, x),
           jsp.ssr_spmv(data, indices, indptr, x, schedule=JDEFAULT))


# -- dispatch ------------------------------------------------------------------------


def test_repeated_call_is_a_pure_cache_hit():
    rng = np.random.default_rng(3)
    data, indices, indptr = sp.random_csr(rng, 10, 12, 0.2)
    x = rng.standard_normal(12).astype(np.float32)
    X = rng.standard_normal((12, 3)).astype(np.float32)
    for fn, operand in ((sp.ssr_spmv, x), (sp.ssr_spmm, X)):
        first = fn(data, indices, indptr, operand)
        snap = dict(frontend.DISPATCH_STATS)
        builds = lowering.DISPATCH_STATS["builds"]
        again = fn(data, indices, indptr, operand)
        assert frontend.DISPATCH_STATS["builds"] == snap["builds"]
        assert frontend.DISPATCH_STATS["calls"] == snap["calls"] + 1
        assert lowering.DISPATCH_STATS["builds"] == builds
        assert torch.equal(again, first)


def test_ell_width_is_a_cache_key_fact():
    """Two same-shape CSRs with different max row population run different
    entries: k is a static parameter."""
    x = np.ones(6, np.float32)
    a = (np.asarray([1.0, 2.0], np.float32), np.asarray([0, 1]),
         np.asarray([0, 2, 2]))     # k = 2
    b = (np.asarray([1.0, 2.0], np.float32), np.asarray([0, 0]),
         np.asarray([0, 1, 2]))     # k = 1
    _close(sp.ssr_spmv(*a, x), jsp.ref_spmv(*a, x))
    _close(sp.ssr_spmv(*b, x), jsp.ref_spmv(*b, x))


def test_tuned_schedule_resolved_transparently():
    """A winner committed under the kernel's own lookup key is what the
    next call runs, with no call-site change, and the numbers match."""
    rng = np.random.default_rng(9)
    data, indices, indptr = sp.random_csr(rng, 12, 14, 0.3)
    x = rng.standard_normal(14).astype(np.float32)
    vals, cidx, m, k = sp.csr_to_ell(data, indices, indptr, 14)
    args = (torch.from_numpy(vals), torch.from_numpy(cidx),
            torch.from_numpy(x))
    params = {"m": m, "k": k}
    assert sp._ssr_spmv.schedule_for(*args, **params) == DEFAULT_SCHEDULE
    operands, static, _final = sp._ssr_spmv._prepare(*args, **params)
    nest = sp._ssr_spmv._nest(static)
    variant = dataclasses.replace(DEFAULT_SCHEDULE, rows=4)
    ok, why = autotune.schedule_is_legal(nest, variant,
                                         operands=dict(operands))
    assert ok, why
    key = autotune.cache_key(nest, dict(operands), mode=sp._ssr_spmv._mode,
                             out_dtype="float32")
    autotune.global_cache().put(key, variant, meta={"test": True})
    assert sp._ssr_spmv.schedule_for(*args, **params) == variant
    _close(sp.ssr_spmv(data, indices, indptr, x),
           jsp.ref_spmv(data, indices, indptr, x))


def test_hpcg_operator_is_its_definition():
    """26 on the diagonal, −1 per neighbour, columns increasing: the loop
    of HPCG's GenerateProblem_ref, at a small grid; nnz = Π (3·n − 2)."""
    nx, ny, nz = 4, 3, 5
    data, indices, indptr = sp.hpcg_operator(nx, ny, nz)
    rows, cols, vals = [0], [], []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                for sz in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            jz, jy, jx = iz + sz, iy + sy, ix + sx
                            if 0 <= jz < nz and 0 <= jy < ny and 0 <= jx < nx:
                                cols.append((jz * ny + jy) * nx + jx)
                                vals.append(26.0 if sz == sy == sx == 0
                                            else -1.0)
                rows.append(len(cols))
    np.testing.assert_array_equal(indptr.numpy(), rows)
    np.testing.assert_array_equal(indices.numpy(), cols)
    np.testing.assert_array_equal(data.numpy(), np.asarray(vals, np.float32))
    assert indices.dtype == torch.int32 and data.dtype == torch.float32
    assert int(indptr[-1]) == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    sp.validate_csr(data, indices, indptr, nx * ny * nz)
