"""Parity of the port's framework-free core with the JAX reference.

The copied modules (``stream``, ``isa``, ``nest_analysis``, ``compiler``,
``region``) and the ported address-generation model (``agu``) must give
exactly the reference's answers: the ISA tables, the ``ssrify`` plans and
their Eq. (1)–(3) numbers, and the address sequences.
"""

import dataclasses
import enum
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import agu as ref_agu
from repro.core import compiler as ref_compiler
from repro.core import isa as ref_isa
from repro.core import nest_analysis as ref_na
from repro.core.stream import StreamSpec as RefStreamSpec

from repro_torch.core import agu, compiler, isa, nest_analysis, region
from repro_torch.core.stream import Direction, StreamSpec


def plain(obj):
    """A dataclass tree as nested builtins (enums by value), for equality."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [plain(x) for x in obj]
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    return obj


# -- isa: every closed-form number of §4.1 (mirrors test_isa_model.py) ------


class TestIsaParity:
    def test_fig4_and_table2(self):
        assert isa.fig4_dot_product(1000) == ref_isa.fig4_dot_product(1000) \
            == (3001, 1012)
        assert plain(isa.table2()) == plain(ref_isa.table2())
        for r, rr in zip(isa.table2(), ref_isa.table2()):
            assert (r.speedup, r.base.eta, r.ssr.eta) == \
                (rr.speedup, rr.base.eta, rr.ssr.eta)

    def test_breakeven_and_counts(self):
        assert [isa.min_side_length(d) for d in (1, 2, 3, 4)] == \
            [ref_isa.min_side_length(d) for d in (1, 2, 3, 4)] == [6, 3, 2, 2]
        for L in ([7], [3, 5], [2, 2, 9], [1, 4, 2, 3], [50, 50]):
            for s in (1, 2, 4):
                Iv = list(range(len(L)))
                assert isa.n_ssr(L, Iv, s) == ref_isa.n_ssr(L, Iv, s)
                assert isa.n_base(L, Iv, s) == ref_isa.n_base(L, Iv, s)
            assert isa.ssr_profitable(L) == ref_isa.ssr_profitable(L)

    def test_utilization_limits(self):
        for n in (10, 100, 1000, 10**9):
            for ssr in (False, True):
                assert isa.utilization_limit_dot(n, ssr) == \
                    ref_isa.utilization_limit_dot(n, ssr)
        for l, d in itertools.product((2, 8, 64, 1024), (1, 2, 3, 4)):
            assert isa.utilization_reduction(l, d) == \
                ref_isa.utilization_reduction(l, d)
        for w, s in itertools.product((1, 2), (False, True)):
            assert isa.utilization_class(w, s) == \
                ref_isa.utilization_class(w, s)

    def test_kernel_suite_and_cluster(self):
        assert plain(isa.kernel_suite()) == plain(ref_isa.kernel_suite())
        assert [k.speedup for k in isa.kernel_suite()] == \
            [k.speedup for k in ref_isa.kernel_suite()]
        assert isa.equivalent_cores(6) == ref_isa.equivalent_cores(6) == 2
        for c, s in itertools.product((1, 2, 6, 8), (False, True)):
            assert isa.cluster_time(c, s) == ref_isa.cluster_time(c, s)


# -- compiler: ssrify plans and Eq. (1)–(3) for the slice's four nests -----


NESTS = [
    ("dot_product_nest", (1000,)), ("dot_product_nest", (5,)),
    ("dot_product_nest", (5000,)), ("elementwise_nest", (1025,)),
    ("gemm_nest", (32, 32, 32)), ("gemm_nest", (100, 130, 70)),
    ("gemv_nest", (64, 64)), ("gemv_nest", (60, 64)),
]


@pytest.mark.parametrize("fn,args", NESTS,
                         ids=[f"{f}{a}" for f, a in NESTS])
@pytest.mark.parametrize("num_lanes,force", [(2, False), (None, True),
                                             (1, True)])
def test_ssrify_plan_parity(fn, args, num_lanes, force):
    nest = getattr(compiler, fn)(*args)
    ref_nest = getattr(ref_compiler, fn)(*args)
    assert plain(nest) == plain(ref_nest)
    lanes = nest_analysis.auto_lanes(nest, num_lanes)
    assert lanes == ref_na.auto_lanes(ref_nest, num_lanes)
    plan = compiler.ssrify(nest, num_lanes=lanes, force=force)
    ref_plan = ref_compiler.ssrify(ref_nest, num_lanes=lanes, force=force)
    assert plain(plan) == plain(ref_plan)
    assert (plan.n_ssr, plan.n_base, plan.ssrified, plan.speedup) == \
        (ref_plan.n_ssr, ref_plan.n_base, ref_plan.ssrified, ref_plan.speedup)


def test_fig4_plan_numbers():
    plan = compiler.ssrify(compiler.dot_product_nest(1000))
    assert (plan.n_ssr, plan.n_base) == (1012, 3001)


@pytest.mark.parametrize("fn,args", NESTS[3:],
                         ids=[f"{f}{a}" for f, a in NESTS[3:]])
def test_nest_analysis_parity(fn, args):
    nest = getattr(compiler, fn)(*args)
    ref_nest = getattr(ref_compiler, fn)(*args)
    for r, rr in zip(nest.refs, ref_nest.refs):
        assert nest_analysis.storage_order(r, nest) == \
            ref_na.storage_order(rr, ref_nest)
        assert nest_analysis.contraction_axes(r, nest) == \
            ref_na.contraction_axes(rr, ref_nest)
        assert nest_analysis.varying_levels(r) == ref_na.varying_levels(rr)


def test_region_is_the_ssrcfg_csr():
    assert not region.ssr_enabled()
    with region.ssr_region():
        assert region.ssr_enabled()
        with region.ssr_region(False):
            assert not region.ssr_enabled()
        assert region.ssr_enabled()
    assert not region.ssr_enabled()


# -- agu: address sequences, block grids, affine coefficients --------------


SPECS = [
    dict(bounds=(7,), strides=(1,)),
    dict(bounds=(4, 8), strides=(8, 1), base=3),
    dict(bounds=(3, 5), strides=(1, 3), repeat=2),
    dict(bounds=(2, 3, 4), strides=(12, 0, 1), base=5),
    dict(bounds=(2, 2, 2, 3), strides=(1, 2, 4, 8)),
]


@pytest.mark.parametrize("kw", SPECS, ids=[str(s["bounds"]) for s in SPECS])
def test_address_sequence_parity(kw):
    got = agu.address_sequence(StreamSpec(**kw))
    want = np.asarray(ref_agu.address_sequence(RefStreamSpec(**kw)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == list(StreamSpec(**kw).addresses())


@pytest.mark.parametrize("kw", SPECS[:3], ids=[str(s["bounds"]) for s in SPECS[:3]])
def test_gather_scatter_parity(kw):
    rng = np.random.default_rng(1)
    data = rng.standard_normal(64).astype(np.float32)
    spec, ref_spec = StreamSpec(**kw), RefStreamSpec(**kw)
    np.testing.assert_array_equal(
        agu.gather_stream(torch.from_numpy(data), spec).numpy(),
        np.asarray(ref_agu.gather_stream(jnp.asarray(data), ref_spec)))
    vals = rng.standard_normal(len(agu.address_sequence(spec))).astype(
        np.float32)
    np.testing.assert_array_equal(
        agu.scatter_stream(40, torch.from_numpy(vals), spec).numpy(),
        np.asarray(ref_agu.scatter_stream(40, jnp.asarray(vals), ref_spec)))


@pytest.mark.parametrize("bounds,block", [((64,), (8,)), ((4, 256), (128,)),
                                          ((8, 16, 32), (4, 8)),
                                          ((6, 10), (4,))])
def test_block_grid_parity(bounds, block):
    strides = compiler._dense_strides(bounds)
    spec, ref_spec = StreamSpec(bounds, strides), RefStreamSpec(bounds, strides)
    try:
        want = ref_agu.block_grid(ref_spec, block)
    except ValueError:
        with pytest.raises(ValueError):
            agu.block_grid(spec, block)
    else:
        assert agu.block_grid(spec, block) == want


MAPS = [
    (lambda i, j: (i, 0), (5, 3)),
    (lambda i, j, k: (i * 2 + k, j), (3, 4, 2)),
    (lambda i, j: (i * j, 0), (4, 4)),            # not affine
    (lambda i: (0, 0), (9,)),
]


@pytest.mark.parametrize("index_map,grid", MAPS, ids=range(len(MAPS)))
def test_affine_coefficients_parity(index_map, grid):
    got = agu.affine_coefficients(index_map, grid)
    want = ref_agu.affine_coefficients(index_map, grid)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)


def test_block_agu_gathers_the_index_map_blocks():
    """BlockAGU's gather is the index map at block granularity."""
    grid, block = (3, 4), (2, 5)
    layout = torch.arange(6 * 20, dtype=torch.float32).reshape(6, 20)
    index_map = lambda i, j: (i, j)  # noqa: E731
    blocks = agu.BlockAGU.of(index_map, block, grid).gather(layout, grid)
    for s, (i, j) in enumerate(itertools.product(range(3), range(4))):
        want = layout[i * 2:(i + 1) * 2, j * 5:(j + 1) * 5]
        assert torch.equal(blocks[s], want)


def test_block_agu_rejects_walks_outside_the_layout():
    walk = agu.BlockAGU.of(lambda i: (i + 1, 0), (8, 128), (4,))
    walk.check_within((4,), (40, 128))
    with pytest.raises(ValueError, match="outside the layout"):
        walk.check_within((4,), (32, 128))
    with pytest.raises(ValueError, match="not affine"):
        agu.BlockAGU.of(lambda i: (i * i, 0), (8, 128), (4,))


def test_direction_values_match():
    from repro.core.stream import Direction as RefDirection
    assert [d.value for d in Direction] == [d.value for d in RefDirection]


#: the reference's TPU-only names: the port checks each kernel's CTA
#: against the card (``hopper.accepts``) instead
TPU_ONLY = {"ssr_pallas", "VMEM_BUDGET_BYTES", "check_mxu_alignment"}


@pytest.mark.parametrize("package", ["core", "kernels"])
def test_the_port_re_exports_the_references_public_names(package):
    """Every public non-module name of ``repro.core`` and ``repro.kernels``
    (but the TPU-only three) is one of the port's package namespace too,
    so code written against the reference's packages switches over."""
    import importlib
    import types

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), types.ModuleType)}

    ref_pkg = importlib.import_module(f"repro.{package}")
    port_pkg = importlib.import_module(f"repro_torch.{package}")
    want = public(ref_pkg) - TPU_ONLY
    assert want - public(port_pkg) == set()
    assert not TPU_ONLY & public(port_pkg)
    for name in want:   # the same kind of object: class, function, value
        assert callable(getattr(ref_pkg, name)) is \
            callable(getattr(port_pkg, name)), name
