"""K12's planes: on the card the spmv gather reads ``pack_ell``'s (m, k)
ELL planes as they are, at pitch k, with no layout copy.

The lowering pads k to a 128-lane tile (and m to whole row blocks); the CPU
executor, R13 and the report keep those padded layouts.  On the CPU, from
numpy seeds:

* **the picker** — :func:`lowering.device_layouts` is pure: on a CUDA
  device it hands K12 (a sync spmv nest) the planes themselves (the same
  ``data_ptr``, no copy counted in ``lowering.LAYOUT_COPIES``), and R13 (a
  pipelined one), any other kernel and the CPU the padded layouts; the
  choice has one owner (``SsrKernel.takes_planes``, from
  ``hopper.PLANE_KERNELS``), and a call on the planes hands out R13's
  padded layouts (``PreparedCall.padded_layouts``);
* **the plain gather at pitch k** — ``hopper._plain_gather_contract`` on
  the planes gives the bits it gives on the padded layouts, and the JAX
  package's ``ssr_spmv`` (Pallas interpret mode) within the registry
  ``tol``, on the registry's examples and on the odd CSR inputs: an
  all-zero matrix, empty rows, 1 x 1, rows of 300 and 600 entries (k above
  128: several column steps);
* **the walk check** — :func:`hopper.check_gather_walks` takes the
  unpadded planes for K12, refuses planes that the gather's extent leaves,
  and holds R13 to the padded walk.

The card's checks (K12 on the planes against its plain version, R13 against
K12 to the bit) are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import lowering as jlowering
from repro.kernels import sparse as jsp

import repro_torch
from repro_torch.core import compiler, hopper, lowering
from repro_torch.core.lowering import DEFAULT_SCHEDULE, Schedule
from repro_torch.kernels import gemv, registry
from repro_torch.kernels import sparse as sp

from test_torch_sparse import _close, _edge, _terms

CUDA = torch.device("cuda")
ODD = ["all_zero", "mixed_empty_and_full", "one_by_one", "row300", "row600"]
#: 128-lane k steps and 16-row blocks, so that small inputs take several
#: grid steps (R13's schedule at depth 4)
CARRIED = dict(lanes_tile_factor=1, rows_tile_factor=2)
RING = Schedule(buffer_depth=4, **CARRIED)


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _csr(name, seed=3):
    """(data, indices, indptr, n, x): a named odd input or a registry
    example, x from the same seed."""
    if name.startswith("example"):
        (d, i, p, x), _ = registry.get("spmv").example(
            np.random.default_rng(seed), odd=name.endswith("odd"))
        d, i, p, x = (np.asarray(a) for a in (d, i, p, x))
        return d, i, p, x.shape[0], x
    if name == "hpcg":      # HPCG's 27-point operator on 8 x 8 x 4: 256 rows
        d, i, p = (t.numpy() for t in sp.hpcg_operator(8, 8, 4))
        n = 256
    else:
        d, i, p, n = _edge(name)
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return d, i, p, n, x


def _call(name, schedule=DEFAULT_SCHEDULE):
    """The spmv call of a CSR input on the CPU, and its planes and x."""
    d, i, p, n, x = _csr(name)
    vals, cidx, m, k = sp.pack_ell(torch.from_numpy(d), torch.from_numpy(i),
                                   torch.from_numpy(p), n)
    xt = torch.from_numpy(x)
    call = lowering.prepare_call(compiler.spmv_nest(m, k), sp.SPMV,
                                 {"vals": vals, "cidx": cidx, "x": xt},
                                 schedule=schedule)
    return call, (vals, cidx, xt)


# -- the picker ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["example_odd", "row300", "one_by_one"])
def test_k12_on_the_card_takes_pack_ell_planes_with_no_copy(name):
    call, (vals, cidx, x) = _call(name)
    kern = call.kernel
    assert kern.device_key == ("nest", "spmv") and not kern.pipelined
    before = dict(lowering.LAYOUT_COPIES)
    got = lowering.device_layouts(kern, call.lowered, [vals, cidx, x], CUDA)
    assert lowering.LAYOUT_COPIES == before
    assert got[0].data_ptr() == vals.data_ptr()
    assert got[1].data_ptr() == cidx.data_ptr()
    assert got[0].shape == vals.shape and got[1].shape == cidx.shape
    assert got[2].data_ptr() == x.data_ptr()


@pytest.mark.parametrize("name", ["hpcg", "row300"])
def test_r13_and_the_cpu_take_the_padded_layouts(name):
    call, arrays = _call(name, Schedule(**CARRIED))
    ring_call, _ = _call(name, RING)
    assert ring_call.kernel.pipelined
    before = lowering.LAYOUT_COPIES["padded"]
    on_cpu = lowering.device_layouts(call.kernel, call.lowered, arrays,
                                     torch.device("cpu"))
    r13 = lowering.device_layouts(ring_call.kernel, ring_call.lowered,
                                  arrays, CUDA)
    padded = lowering.stream_layouts(call.lowered, arrays)
    for got in (on_cpu, r13, call.layouts):
        assert [t.shape for t in got] == [t.shape for t in padded]
        for a, b in zip(got, padded):
            assert torch.equal(a, b)
    # two streams padded for each of the three layouts made here
    assert lowering.LAYOUT_COPIES["padded"] - before == 3 * 2


def test_the_planes_are_the_operands_not_a_reshaped_copy_of_the_layout():
    """The planes' rows sit k apart, where the padded layout's sit 128
    apart; the positions the extent holds are the same values."""
    call, (vals, cidx, x) = _call("example")
    planes = lowering.device_layouts(call.kernel, call.lowered,
                                     [vals, cidx, x], CUDA)
    m, k = vals.shape
    assert planes[0].stride() == (k, 1)
    assert call.layouts[0].shape[1] == 128 != k
    assert torch.equal(call.layouts[0][:m, :k], planes[0])
    assert torch.equal(call.layouts[1][:m, :k], planes[1])
    assert call.kernel.geometry.gathers[0].extent == (m, k)


# -- the plain gather at pitch k ------------------------------------------------


@pytest.mark.parametrize("name", ["example", "example_odd", "hpcg", *ODD])
def test_plain_gather_at_pitch_k_is_pitch_128_bit_for_bit(name):
    call, arrays = _call(name)
    planes = lowering.device_layouts(call.kernel, call.lowered, arrays, CUDA)
    padded = call.kernel.plain(call.layouts)
    unpadded = call.kernel.plain(planes)
    assert torch.equal(padded.view(torch.int32), unpadded.view(torch.int32))


@pytest.mark.parametrize("name", ["example", "example_odd", "hpcg", *ODD])
def test_plain_gather_at_pitch_k_matches_the_reference(name):
    d, i, p, n, x = _csr(name)
    call, arrays = _call(name)
    planes = lowering.device_layouts(call.kernel, call.lowered, arrays, CUDA)
    got = call.finish(call.kernel.plain(planes))
    want = np.asarray(jsp.ssr_spmv(d, i, p, x,
                                   schedule=jlowering.DEFAULT_SCHEDULE))
    tol = registry.get("spmv").tol
    assert tol == {"rtol": 1e-5, "atol": 1e-5}
    _close(got, want, tol["atol"], _terms(d, i, p, x))


@pytest.mark.parametrize("name", ["row300", "row600"])
def test_a_row_past_one_lane_tile_walks_several_column_steps(name):
    """k above 128: the walk has ceil(k / 128) column steps, each starting
    at z·128 within a row of pitch k, and the plain gather reads them."""
    call, arrays = _call(name, Schedule(**CARRIED))
    geo = call.kernel.geometry
    k = arrays[0].shape[1]
    assert k > 128 and geo.contraction_steps == -(-k // 128)
    assert geo.ins[1].block[1] == 128
    planes = lowering.device_layouts(call.kernel, call.lowered, arrays, CUDA)
    assert planes[1].shape[1] == k
    got = call.finish(call.kernel.plain(planes))
    assert torch.equal(got, call.run())


# -- the walk check ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["hpcg", "row300"])
def test_only_k12_takes_the_planes(name):
    """One owner: K12 takes planes (and K13, as it does since the planes
    reached it too), R13 (its ring) and the gemv do not, whatever asks
    (the kernel, the walk check, the lowering)."""
    call, _ = _call(name)
    ring_call, _ = _call(name, RING)
    assert call.kernel.takes_planes and not ring_call.kernel.takes_planes
    assert hopper.takes_planes(("nest", "spmv"))
    assert not hopper.takes_planes(("nest", "spmv"), ring_call.kernel.ring)
    assert hopper.PLANE_KERNELS == {("nest", "spmv"), ("nest", "spmm")}
    gemv_call = lowering.prepare_call(
        compiler.gemv_nest(64, 64), gemv.MATVEC,
        {"A": torch.ones(64, 64), "x": torch.ones(64)})
    assert not gemv_call.kernel.takes_planes
    # on the CPU no call holds planes
    assert not call.planes and not ring_call.planes


@pytest.mark.parametrize("name", ["example_odd", "hpcg", "row300"])
def test_padded_layouts_of_a_call_on_the_planes(name):
    """A call whose K12 reads the planes hands out the padded layouts that
    R13 reads, equal to the CPU's; a call on padded layouts hands out its
    own."""
    call, arrays = _call(name)
    planes = lowering.device_layouts(call.kernel, call.lowered, arrays, CUDA)
    on_planes = lowering.PreparedCall(kernel=call.kernel, layouts=planes,
                                      lowered=call.lowered,
                                      bounds=call.bounds, planes=True)
    got = on_planes.padded_layouts()
    assert [t.shape for t in got] == [t.shape for t in call.layouts]
    for a, b in zip(got, call.layouts):
        assert torch.equal(a, b)
    assert got[2].data_ptr() == planes[2].data_ptr()
    assert call.padded_layouts() is call.layouts


def _shapes(layouts):
    return [tuple(t.shape) for t in layouts]


@pytest.mark.parametrize("name", ["example_odd", "row300", "one_by_one"])
def test_k12_walk_check_takes_the_unpadded_planes(name):
    call, arrays = _call(name)
    geo = call.kernel.geometry
    planes = lowering.device_layouts(call.kernel, call.lowered, arrays, CUDA)
    hopper.check_gather_walks("gather_spmv", geo, _shapes(planes))
    hopper.check_gather_walks("gather_spmv", geo, _shapes(call.layouts))


@pytest.mark.parametrize("cut", ["rows", "cols"])
@pytest.mark.parametrize("name", ["example_odd", "row300"])
def test_k12_walk_check_refuses_planes_the_extent_leaves(name, cut):
    call, arrays = _call(name)
    geo = call.kernel.geometry
    m, k = arrays[0].shape
    short = (m - 1, k) if cut == "rows" else (m, k - 1)
    shapes = [short, short, tuple(call.layouts[2].shape)]
    with pytest.raises(ValueError, match=r"gather_spmv\[0\].*extent "
                       rf"\({m}, {k}\) leaves the layout"):
        hopper.check_gather_walks("gather_spmv", geo, shapes)


def test_r13_walk_check_holds_the_padded_walk():
    call, arrays = _call("hpcg", RING)
    assert call.kernel.pipelined
    geo, ring = call.kernel.geometry, call.kernel.ring
    hopper.check_gather_walks("gather_spmv", geo, _shapes(call.layouts), ring)
    planes = lowering.stream_layouts(call.lowered, arrays, planes=True)
    with pytest.raises(ValueError, match="outside the layout"):
        hopper.check_gather_walks("gather_spmv", geo, _shapes(planes), ring)


def test_a_walk_starting_before_the_planes_is_refused():
    call, arrays = _call("example_odd")
    geo = call.kernel.geometry
    agu = geo.ins[1]
    back = agu.__class__(**{**agu.__dict__,
                            "offset": (-1, *agu.offset[1:])})
    m, k = arrays[0].shape
    with pytest.raises(ValueError, match="leaves the layout"):
        back.check_extent_within(geo.grid, (m, k), geo.gathers[0].extent)
