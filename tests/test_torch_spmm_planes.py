"""K13's planes: on the card the spmm gather reads ``pack_ell``'s (m, k)
ELL planes as they are, at pitch k, with no layout copy, as K12 does.

On the CPU, from numpy seeds:

* **the picker** — ``hopper.PLANE_KERNELS`` holds K13's key, so
  :func:`lowering.device_layouts` on a CUDA device hands K13 (a sync spmm
  nest) the planes themselves (the same ``data_ptr``, no copy counted in
  ``lowering.LAYOUT_COPIES``), and R14 (a pipelined one) and the CPU the
  padded layouts;
* **the walk check** — :func:`hopper.check_gather_walks` takes the planes
  for K13 and refuses, by the stream's name, a plane narrower than the
  gather's extent;
* **the plain gather at pitch k** — K13's plain version on the planes
  gives the bits of its run on the padded layouts, and the JAX package's
  ``ssr_spmm`` (Pallas interpret mode) within the registry ``tol``;
* **X as it is** — the spmm entry lays out X by a copy only where its
  width is not a whole lane tile already (``sparse._prepare_spmm``), and
  the result is the one the copied X gave.

The card's checks (K13 on the planes against R14 to the bit and its plain
version) are in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import lowering as jlowering
from repro.kernels import sparse as jsp

import repro_torch
from repro_torch.core import compiler, hopper, lowering
from repro_torch.core.lowering import DEFAULT_SCHEDULE, Schedule
from repro_torch.kernels import registry
from repro_torch.kernels import sparse as sp

from test_torch_sparse import _close, _terms
from test_torch_spmv_planes import CARRIED, ODD, _csr

CUDA = torch.device("cuda")
RING = Schedule(buffer_depth=4, **CARRIED)


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _call(name, schedule=DEFAULT_SCHEDULE, c=17):
    """The spmm call of a CSR input on the CPU (X of ``c`` columns, padded
    to whole lane tiles), its planes and X."""
    d, i, p, n, _ = _csr(name)
    vals, cidx, m, k = sp.pack_ell(torch.from_numpy(d), torch.from_numpy(i),
                                   torch.from_numpy(p), n)
    X = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n, c)).astype(np.float32))
    pitch = -(-c // 128) * 128
    Xp = F.pad(X, (0, pitch - c))
    call = lowering.prepare_call(compiler.spmm_nest(m, c, k, pitch), sp.SPMM,
                                 {"vals": vals, "cidx": cidx, "X": Xp},
                                 schedule=schedule)
    return call, (vals, cidx, Xp), X


# -- the picker ------------------------------------------------------------------


def test_k13_takes_planes_and_r14_does_not():
    call, _, _ = _call("hpcg")
    ring_call, _, _ = _call("hpcg", RING)
    assert call.kernel.device_key == ("nest", "spmm")
    assert hopper.takes_planes(("nest", "spmm"))
    assert call.kernel.takes_planes and not call.kernel.pipelined
    assert ring_call.kernel.pipelined
    assert not ring_call.kernel.takes_planes
    assert not hopper.takes_planes(("nest", "spmm"), ring_call.kernel.ring)
    assert hopper.RING_KERNELS[("nest", "spmm")] == "ring_gather_spmm"


@pytest.mark.parametrize("name", ["example_odd", "hpcg", "row300",
                                  "one_by_one"])
def test_k13_on_the_card_takes_pack_ell_planes_with_no_copy(name):
    call, (vals, cidx, X), _ = _call(name)
    before = dict(lowering.LAYOUT_COPIES)
    got = lowering.device_layouts(call.kernel, call.lowered, [vals, cidx, X],
                                  CUDA)
    assert lowering.LAYOUT_COPIES == before
    assert got[0].data_ptr() == vals.data_ptr()
    assert got[1].data_ptr() == cidx.data_ptr()
    assert got[0].shape == vals.shape and got[1].shape == cidx.shape
    assert got[0].stride() == (vals.shape[1], 1)
    assert got[2].data_ptr() == X.data_ptr()
    assert call.kernel.geometry.gathers[0].extent == tuple(vals.shape)


@pytest.mark.parametrize("name", ["hpcg", "row300"])
def test_r14_and_the_cpu_take_the_padded_layouts(name):
    call, arrays, _ = _call(name, Schedule(**CARRIED))
    ring_call, _, _ = _call(name, RING)
    on_cpu = lowering.device_layouts(call.kernel, call.lowered, arrays,
                                     torch.device("cpu"))
    r14 = lowering.device_layouts(ring_call.kernel, ring_call.lowered,
                                  arrays, CUDA)
    padded = lowering.stream_layouts(call.lowered, arrays)
    for got in (on_cpu, r14, call.layouts):
        assert [t.shape for t in got] == [t.shape for t in padded]
        for a, b in zip(got, padded):
            assert torch.equal(a, b)
    assert padded[0].shape[1] == 128 != arrays[0].shape[1] or name == "row300"


# -- the walk check ----------------------------------------------------------------


def _shapes(layouts):
    return [tuple(t.shape) for t in layouts]


@pytest.mark.parametrize("name", ["example_odd", "hpcg", "row300"])
def test_k13_walk_check_takes_the_planes(name):
    call, arrays, _ = _call(name)
    geo = call.kernel.geometry
    planes = lowering.device_layouts(call.kernel, call.lowered, arrays, CUDA)
    hopper.check_gather_walks("gather_spmm", geo, _shapes(planes))
    hopper.check_gather_walks("gather_spmm", geo, _shapes(call.layouts))


@pytest.mark.parametrize("cut", ["rows", "cols"])
@pytest.mark.parametrize("name", ["example_odd", "hpcg"])
def test_k13_walk_check_refuses_a_plane_narrower_than_the_extent(name, cut):
    call, arrays, _ = _call(name)
    geo = call.kernel.geometry
    m, k = arrays[0].shape
    short = (m - 1, k) if cut == "rows" else (m, k - 1)
    for which in (0, 1):
        shapes = [tuple(arrays[0].shape), tuple(arrays[1].shape),
                  tuple(call.layouts[2].shape)]
        shapes[which] = short
        with pytest.raises(ValueError, match=rf"gather_spmm\[{which}\].*"
                           rf"extent \({m}, {k}\) leaves the layout"):
            hopper.check_gather_walks("gather_spmm", geo, shapes)


def test_r14_walk_check_holds_the_padded_walk():
    call, arrays, _ = _call("hpcg", RING)
    geo, ring = call.kernel.geometry, call.kernel.ring
    hopper.check_gather_walks("gather_spmm", geo, _shapes(call.layouts), ring)
    planes = lowering.stream_layouts(call.lowered, arrays, planes=True)
    with pytest.raises(ValueError, match="outside the layout"):
        hopper.check_gather_walks("gather_spmm", geo, _shapes(planes), ring)


# -- the plain gather at pitch k ------------------------------------------------


@pytest.mark.parametrize("c", [17, 128, 200])
@pytest.mark.parametrize("name", ["example", "example_odd", "hpcg", *ODD])
def test_plain_gather_on_the_planes_is_the_padded_run_bit_for_bit(name, c):
    call, arrays, _ = _call(name, c=c)
    planes = lowering.device_layouts(call.kernel, call.lowered, arrays, CUDA)
    padded = call.kernel.plain(call.layouts)
    unpadded = call.kernel.plain(planes)
    assert torch.equal(padded.view(torch.int32), unpadded.view(torch.int32))


@pytest.mark.parametrize("name", ["example_odd", "hpcg", *ODD])
def test_plain_gather_on_the_planes_matches_the_reference(name):
    d, i, p, n, _ = _csr(name)
    call, arrays, X = _call(name)
    planes = lowering.device_layouts(call.kernel, call.lowered, arrays, CUDA)
    got = call.finish(call.kernel.plain(planes))[:, :X.shape[1]]
    want = np.asarray(jsp.ssr_spmm(d, i, p, X.numpy(),
                                   schedule=jlowering.DEFAULT_SCHEDULE))
    tol = registry.get("spmm").tol
    _close(got, want, tol["atol"], _terms(d, i, p, X.numpy()))


# -- X as it is ----------------------------------------------------------------


@pytest.mark.parametrize("c", [128, 256])
def test_prepare_spmm_takes_x_as_it_is_at_a_whole_lane_tile(c):
    d, i, p, n, _ = _csr("hpcg")
    vals, cidx, m, k = sp.pack_ell(torch.from_numpy(d), torch.from_numpy(i),
                                   torch.from_numpy(p), n)
    X = torch.from_numpy(np.random.default_rng(c).standard_normal(
        (n, c)).astype(np.float32))
    ops_, static, _ = sp._prepare_spmm(vals, cidx, X, m=m, k=k, pitch=c)
    assert ops_["X"] is X and static == (m, c, k, c)
    got = sp.ssr_spmm(d, i, p, X)
    copied = sp._ssr_spmm(vals, cidx, X, m=m, k=k, pitch=c + 128)[:, :c]
    assert torch.equal(got.view(torch.int32), copied.view(torch.int32))
    _close(got, sp.ref_spmm(d, i, p, X.numpy()),
           registry.get("spmm").tol["atol"], _terms(d, i, p, X.numpy()))


def test_prepare_spmm_pads_x_off_a_lane_tile():
    X = torch.ones(5, 17)
    ops_, _, _ = sp._prepare_spmm(torch.ones(5, 1), torch.zeros(5, 1,
                                  dtype=torch.int32), X, m=5, k=1, pitch=128)
    assert ops_["X"].shape == (5, 128)
    assert torch.equal(ops_["X"][:, :17], X) and not ops_["X"][:, 17:].any()
