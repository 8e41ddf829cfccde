"""The gather and scan rings in the port: K12–K14 under the N-deep rotation.

A schedule deeper than 2 makes a sparse call (``ssr_spmv``, ``ssr_spmm``)
or a StreamKernel's scan (``scan._ssr``) pipelined: its read streams arrive
through the ring (on the CPU :func:`hopper.plain_ring` over
:func:`hopper.ring_taken` and :func:`hopper.ring_blocks`, or
:func:`hopper.plain_stream` with ``ring=``; on the card R13
``ring_gather_spmv``, R14 ``ring_gather_spmm`` and R15
``ring_stream_scan``).  On the CPU, at small sizes and on inputs from a
numpy seed:

* **delivery changes, the arithmetic does not** — at depths 3, 4, 8 and
  per-stream (2, 4), (4, 2), spmv and spmm on rows of 300 and 600 entries
  and a tall matrix, with the contraction carried over k steps, give the
  port's depth-2 bits and agree with the JAX package's sync output (Pallas
  interpret mode) within the sparse tests' ``_close`` bound; the scan at 3,
  4 and 8 gives its depth-2 bits (f32, bf16, int32) and agrees with the
  reference within the stream tests' bounds;
* **pipelined where a ring runs** — depth 2 routes to K12/K13/K14, deeper
  to R13/R14/R15; a one-step grid (a scan of n ≤ 1024, an FFT, a sort)
  stays sync at depth 4;
* **one budget** — ``device_ring`` gives the table 0 bytes, a gather slot a
  row group × the valid width rounded up to 16 bytes × 4 bytes a stream
  (R13 keeps its slots' mbarriers besides, ``_staged_bytes``) and a scan
  slot one of K14's tiles, unpadded; ``accepts`` refuses, by name, a depth
  over ``SMEM_OPTIN_BYTES``;
* **one wave** — ``ring_run_steps`` gives every row group of R13 and R14
  the same runs, as many as fit the card's CTAs, so no CTA waits for a
  second wave, and the plain ring under those runs gives the sync plain
  version's bits;
* **the reference's rotation** — the fetch log of a gather walk and of the
  scan walk, under the runs the wrappers launch, is ``_pipelined_call``'s
  formula;
* **the addresses come from the ring** — a gather ring that delivers
  another step's cidx block changes that step's result and no other (R13
  gathers a step's table values ahead of it, from that step's cidx).

The card's own checks (R13–R15 against K12–K14 to the bit) are in
``tests/test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import lowering as jlowering
from repro.kernels import scan as jscan
from repro.kernels import sparse as jsp

import repro_torch
from repro_torch.core import agu, compiler, hopper, lowering
from repro_torch.core.lowering import DEFAULT_SCHEDULE, Schedule
from repro_torch.kernels import bitonic, fft, registry, scan
from repro_torch.kernels import sparse as sp

from test_torch_pipeline import _formula
from test_torch_sparse import _case, _close, _edge, _operands, _terms
from test_torch_stream import SCAN_BOUND

DEPTHS = [3, 4, 8, (2, 4), (4, 2)]
CASES = ["row300", "row600", "tall"]
# k = 300 and 600 in 128-lane steps, the accumulator carried between them
CARRIED = dict(lanes_tile_factor=1, rows_tile_factor=2)
RING = {"spmv": "ring_gather_spmv", "spmm": "ring_gather_spmm"}
SYNC = {"spmv": "gather_spmv", "spmm": "gather_spmm"}
SMS = 132                         # the H100's SMs, for the run lengths


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    monkeypatch.delenv("REPRO_DISABLE_PIPELINE", raising=False)
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _sched(depth, **kw) -> Schedule:
    if isinstance(depth, tuple):
        return Schedule(stream_depths=depth, **kw)
    return Schedule(buffer_depth=depth, **kw)


def _inputs(kind, case):
    data, indices, indptr, n = _edge(case)
    x, X = _operands(n, 5, 3)
    return data, indices, indptr, (x if kind == "spmv" else X)


@functools.lru_cache(maxsize=None)
def _reference(kind: str, case: str) -> np.ndarray:
    """The JAX package's sync output (Pallas interpret mode), once a case."""
    data, indices, indptr, operand = _inputs(kind, case)
    fn = jsp.ssr_spmv if kind == "spmv" else jsp.ssr_spmm
    return np.asarray(fn(data, indices, indptr, operand,
                         schedule=jlowering.Schedule(**CARRIED)))


def _port(kind, case, sched):
    data, indices, indptr, operand = _inputs(kind, case)
    fn = sp.ssr_spmv if kind == "spmv" else sp.ssr_spmm
    return fn(data, indices, indptr, operand, schedule=sched)


def _call(kind, case, sched, c=5):
    """The prepared call (kernel and layouts) of a sparse case."""
    data, indices, indptr, n = _edge(case) if case in CASES else case
    vals, cidx, m, k = sp.csr_to_ell(data, indices, indptr, n)
    x, X = _operands(n, c, 3)
    if kind == "spmv":
        return lowering.prepare_call(
            compiler.spmv_nest(m, k), sp.SPMV,
            {"vals": vals, "cidx": cidx, "x": x}, schedule=sched)
    pitch = -(-c // 128) * 128
    return lowering.prepare_call(
        compiler.spmm_nest(m, c, k, pitch), sp.SPMM,
        {"vals": vals, "cidx": cidx, "X": np.pad(X, ((0, 0), (0, pitch - c)))},
        schedule=sched)


def _hpcg(side=16):
    """HPCG's 27-point operator on a side**3 grid as CSR, its ELL width 27."""
    data, indices, indptr = sp.hpcg_operator(side, side, side)
    return data.numpy(), indices.numpy(), indptr.numpy(), side ** 3


def _scan_input(n, dtype, seed=7):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return x.to(torch.bfloat16) if dtype == "bfloat16" else x


def _scan_entry(x, sched):
    """The scan's built entry (its ``.ring``), Launch and prepared arrays."""
    arrays, static, _ = scan._prepare(x)
    return (scan._ssr._build(static, tuple(arrays), sched),
            scan._launch(static, *arrays), tuple(arrays))


# -- delivery changes, the arithmetic does not --------------------------------


@pytest.mark.parametrize("depth", DEPTHS, ids=str)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_pipelined_gather_matches_the_reference_sync_output(kind, case,
                                                            depth):
    sched = _sched(depth, **CARRIED)
    kern = _call(kind, case, sched).kernel
    if case != "tall":              # k = 300, 600: three or five k steps
        assert kern.geometry.contraction_steps > 1
    # spmv's 17 tall rows are one lanes-wide row block of one k step: a
    # one-step grid, which never stages (ssr_pallas does not rotate it)
    assert kern.pipelined == (kern.geometry.steps > 1) == (
        (kind, case) != ("spmv", "tall"))
    assert hopper.RING_KERNELS[kern.device_key] == RING[kind]
    got = _port(kind, case, sched)
    flat = _port(kind, case, Schedule(**CARRIED))
    # only delivery changed: the depth-2 bits
    assert torch.equal(got, flat), float((got - flat).abs().max())
    data, indices, indptr, operand = _inputs(kind, case)
    _close(got, _reference(kind, case),
           terms=_terms(data, indices, indptr, operand))


@pytest.mark.parametrize("sms", [1, 2, SMS])
@pytest.mark.parametrize("depth", [3, 4, 8], ids=str)
@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_plain_ring_equals_the_sync_plain_version_to_the_bit(kind, depth,
                                                              sms):
    """At the default schedule on HPCG's operator, the plain ring under the
    runs R13/R14 launch on a card of ``sms`` SMs (runs of one output block
    on the H100's 132, of several on fewer) equals the sync plain version
    to the bit."""
    call = _call(kind, _hpcg(), _sched(depth), c=200)
    kern = call.kernel
    assert kern.pipelined
    run = hopper.ring_run_steps(RING[kind], kern.geometry, kern.ring,
                                torch.float32, sms)
    got, _ = hopper.plain_ring(kern.body, kern.geometry, call.layouts,
                               kern.out_dtype, kern.acc_dtype, mode="nest",
                               ring=kern.ring, steps_per_cta=run)
    want = hopper.plain_contract(kern.body, kern.geometry, call.layouts,
                                 kern.out_dtype, kern.acc_dtype)
    assert torch.equal(got, want)
    assert torch.equal(kern.plain(call.layouts), want)


@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_plain_gather_ring_runs_in_chunks_with_the_same_result(kind,
                                                               monkeypatch):
    """The plain ring takes the delivered blocks a chunk of steps at a
    time: at one element a chunk, one output block at a time, to the same
    bits."""
    call = _call(kind, _case("rows300"), _sched(4, **CARRIED), c=200)
    kern = call.kernel
    assert kern.geometry.steps > kern.geometry.contraction_steps > 1
    whole = kern.plain(call.layouts)
    monkeypatch.setattr(hopper, "PLAIN_GATHER_ELEMS", 1)
    assert torch.equal(kern.plain(call.layouts), whole)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("depth", [3, 4, 8], ids=str)
def test_pipelined_scan_matches_sync_and_the_reference(depth, dtype):
    x = _scan_input(10000, dtype)
    entry, _, _ = _scan_entry(x, Schedule(buffer_depth=depth))
    assert entry.ring is not None and entry.ring.depths == (depth,)
    got = scan._ssr(x, schedule=Schedule(buffer_depth=depth))
    flat = scan.ssr_scan(x)
    assert torch.equal(got, flat), float((got - flat).abs().max())
    xf = x.float().numpy()
    jx = jnp.asarray(xf) if dtype == "float32" else jnp.asarray(
        xf).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.int32)
    want = np.asarray(jscan._ssr(jx))
    assert got.shape == want.shape == (10000,)
    np.testing.assert_allclose(got.numpy(), want, **registry.get("scan").tol)
    exact = np.cumsum(xf.astype(np.float64))
    scale = np.cumsum(np.abs(xf.astype(np.float64)))
    assert np.max(np.abs(got.numpy() - exact) / scale) <= SCAN_BOUND


# -- pipelined where a ring runs ---------------------------------------------


@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_depth_2_routes_to_the_sync_kernel_and_deeper_to_the_ring(
        kind, monkeypatch):
    kern = _call(kind, "row300", Schedule(**CARRIED)).kernel
    assert not kern.pipelined and "ring" not in kern.device_args()
    assert kern.device_kernel() is getattr(hopper, SYNC[kind])
    deep = _call(kind, "row300", _sched(3, **CARRIED)).kernel
    assert deep.pipelined and deep.device_args()["ring"] == deep.ring
    assert hopper.RING_KERNELS[deep.device_key] == RING[kind]
    monkeypatch.setenv("REPRO_DISABLE_PIPELINE", "1")
    assert not _call(kind, "row300", _sched(3, **CARRIED)).kernel.pipelined


def test_scan_routes_to_k14_at_depth_2_and_to_r15_deeper(monkeypatch):
    x = _scan_input(5000, "float32")
    assert _scan_entry(x, None)[0].ring is None
    assert _scan_entry(x, Schedule(buffer_depth=2))[0].ring is None
    assert _scan_entry(x, Schedule(buffer_depth=3))[0].ring.depths == (3,)
    assert hopper.STREAM_RING_KERNELS["scan"] is hopper.ring_stream_scan
    assert hopper.STREAM_KERNELS["scan"] is hopper.stream_scan
    monkeypatch.setenv("REPRO_DISABLE_PIPELINE", "1")
    assert _scan_entry(x, Schedule(buffer_depth=3))[0].ring is None


@pytest.mark.parametrize("what", ["scan_1000", "fft", "sort"])
def test_a_one_step_grid_stays_sync_at_depth_4(what):
    """A scan of n ≤ 1024 walks one block; the FFT and the sort run one
    step a batch row: none stages, as ssr_pallas never rotates them."""
    sched = Schedule(buffer_depth=4)
    rng = np.random.default_rng(2)
    if what == "scan_1000":
        x = _scan_input(1000, "float32")
        entry, lc, _ = _scan_entry(x, sched)
        assert lc.grid == (1,) and entry.ring is None
        assert torch.equal(scan._ssr(x, schedule=sched), scan.ssr_scan(x))
        return
    module = fft if what == "fft" else bitonic
    args = (torch.from_numpy(rng.standard_normal((1, 256)).astype(
        np.float32)),) * (2 if what == "fft" else 1)
    if what == "sort":
        args = (args[0][0],)
    arrays, static, _ = module._prepare(*args)
    entry = module._ssr._build(static, tuple(arrays), sched)
    assert entry.ring is None
    assert getattr(module._ssr._body(static), "op", None) not in \
        hopper.STREAM_RING_KERNELS


def test_the_rings_are_registered_kernels():
    for rname in ("ring_gather_spmv", "ring_gather_spmm",
                  "ring_stream_scan"):
        assert hopper.KERNELS[rname]["source"].endswith(f"csrc/{rname}.cu")
        assert hopper.KERNELS[rname]["replaces"] == \
            "src/repro/core/ssr.py:215"
        assert rname in hopper._SIGNATURES and hopper.LAUNCHES[rname] == 0
        assert (hopper.CSRC / f"{rname}.cu").is_file()


# -- one budget ----------------------------------------------------------------


@pytest.mark.parametrize("kind, rows, staged", [("spmv", 64, 256),
                                                ("spmm", 8, 0)])
def test_gather_ring_bytes_give_the_table_none(kind, rows, staged):
    kern = _call(kind, _hpcg(), _sched((4, 3))).kernel
    geo = kern.geometry
    assert geo.gathers[0].extent[1] == 27 and geo.ins[1].block[1] == 128
    assert hopper.gather_slot_width(geo) == 28
    dr = hopper.device_ring(RING[kind], geo, kern.ring, torch.float32)
    assert kern.ring.depths == (4, 3, 2) and dr.depths == (4, 3, 2)
    # vals and cidx: a row group × 28 lanes × 4 bytes; the table none
    assert dr.slot_bytes == (rows * 28 * 4, rows * 28 * 4, 0)
    assert dr.ring_bytes == 7 * rows * 28 * 4
    # R13's full and empty mbarriers, 8 slots of each stream, whatever the
    # depths; R14's warps keep nothing besides their rings
    assert hopper._staged_bytes(RING[kind], (), geo) == staged
    if kind == "spmv":              # R13's slot at depth 1: 14,336 bytes
        assert sum(dr.slot_bytes) == 14336


def test_gather_slot_width_is_the_block_past_one_lane_tile():
    kern = _call("spmv", "row300", _sched(3, **CARRIED)).kernel
    assert kern.geometry.gathers[0].extent[1] == 300
    assert hopper.gather_slot_width(kern.geometry) == 128


@pytest.mark.parametrize("dtype, words", [(torch.float32, 4096),
                                          (torch.int32, 4096),
                                          (torch.bfloat16, 2048)])
def test_scan_ring_bytes_are_k14_tiles(dtype, words):
    """A slot is one of K14's tiles, unpadded (one bulk copy lands it, and
    the tile's sums are staged back in it); besides the ring R15 keeps 512
    bytes: its slots' barriers, their tile numbers, a group's totals, the
    carry and the offset."""
    x = torch.zeros(3 * hopper.SCAN_TILE, dtype=dtype)
    entry, lc, _ = _scan_entry(x, Schedule(buffer_depth=8))
    geo = hopper.launch_geometry(lc)
    dr = hopper.device_ring("ring_stream_scan", geo, entry.ring, dtype)
    assert hopper.scan_slot_words(x.element_size()) == words
    assert dr.slot_bytes == (4 * words,) and dr.ring_bytes == 32 * words
    staged = hopper._staged_bytes("ring_stream_scan", (), geo)
    assert staged == hopper.SCAN_RING_STAGED_BYTES == 512
    # every depth fits the budget, those bytes included
    assert hopper._ring_budget_refusal("ring_stream_scan", geo, dtype,
                                       entry.ring, staged) is None


@pytest.mark.parametrize("kind, depth, fits", [
    ("spmv", 3, True), ("spmv", (2, 4), True), ("spmv", 4, False),
    ("spmv", 8, False), ("spmm", 8, True)], ids=str)
def test_accepts_refuses_r13_over_the_budget_by_name(kind, depth, fits):
    """k = 300: R13's slot is 64 rows × 128 lanes × 4 bytes a stream, so
    with its 256 bytes of barriers depth 3 (196,864 bytes) fits and depth 4
    (262,400 bytes) does not; R14's slots are 8 rows: every depth fits."""
    rname = RING[kind]
    kern = _call(kind, "row300", _sched(depth, **CARRIED)).kernel
    takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                torch.float32, "cpu", **kern.device_args())
    dr = hopper.device_ring(rname, kern.geometry, kern.ring, torch.float32)
    staged = hopper._staged_bytes(rname, (), kern.geometry)
    need = dr.ring_bytes + staged
    assert takes == fits, why
    assert (need <= hopper.SMEM_OPTIN_BYTES) == fits
    assert dr.slot_bytes[0] == (64 if kind == "spmv" else 8) * 128 * 4
    if kind == "spmv":
        assert need == {3: 196864, (2, 4): 196864, 4: 262400,
                        8: 524544}[depth]
    if not fits:
        assert why == (f"ring_gather_spmv: its ring at depths "
                       f"{kern.depths} needs {need} bytes of shared memory "
                       f"a CTA ({staged} of them its slots' barriers), the "
                       f"card allows {hopper.SMEM_OPTIN_BYTES}")
    else:
        assert why == "ok"


def test_accepts_refuses_what_the_sync_gather_refuses_under_the_ring_name():
    kern = _call("spmv", _hpcg(), _sched(4)).kernel
    takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                torch.bfloat16, "cpu", **kern.device_args())
    assert not takes and why.startswith("ring_gather_spmv: takes")


# -- the reference's rotation: the fetch log -----------------------------------


@pytest.mark.parametrize("depth", [3, 8, (2, 4), (4, 2)], ids=str)
@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_gather_walk_fetch_log_is_the_reference_rotation(kind, depth):
    call = _call(kind, "row300", _sched(depth, **CARRIED), c=200)
    kern = call.kernel
    geo = kern.geometry
    z = geo.contraction_steps
    run = hopper.ring_run_steps(RING[kind], geo, kern.ring, torch.float32,
                                SMS)
    assert run % z == 0             # whole output blocks a run
    for r in (None, z, run):
        taken, log = hopper.ring_taken(geo, kern.ring, r)
        assert log == _formula(kern.depths, kern.invariant, geo.steps,
                               r or geo.steps)
        # the table is fetched once a run, into slot 0, and never again
        assert kern.invariant[2] and all(s == 0 for i, _, s in log if i == 2)
        for i in (0, 1):           # each step's block arrives once
            assert sorted(s for j, s, _ in log if j == i) == \
                list(range(geo.steps))
            assert taken[i] == list(range(geo.steps))


@pytest.mark.parametrize("sms", [1, 2, 5, SMS])
@pytest.mark.parametrize("depth", [3, 4, 8], ids=str)
@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_gather_ring_runs_fill_one_wave(kind, depth, sms):
    """R13's and R14's persistent grid on a card of ``sms`` SMs: every row
    group (and R14's column chunk) walks the same runs of whole output
    blocks, as many runs as fit the CTAs an SM beside the rings (R13: four
    by registers, fewer by shared memory; R14: three by registers), so the
    grid is one wave; and no shorter runs would fit it."""
    rname = RING[kind]
    call = _call(kind, _hpcg(), _sched(depth), c=200)
    geo = call.kernel.geometry
    z = geo.contraction_steps
    blocks = geo.steps // z
    rows = hopper.SPMV_RING_ROWS if kind == "spmv" else hopper.SPMM_RING_ROWS
    groups = -(-geo.ins[1].block[0] // rows) * (
        geo.gathers[0].tiles[0] // hopper.SPMM_COLS if kind == "spmm" else 1)
    dr = hopper.device_ring(rname, geo, call.kernel.ring, torch.float32)
    smem = dr.ring_bytes + hopper._staged_bytes(rname, (), geo)
    per_sm = hopper._ctas_per_sm(smem, {"spmv": 4, "spmm": 3}[kind])
    # R13: four, three and two CTAs an SM by shared memory (its ring and
    # barriers); R14: three by registers at every depth
    assert per_sm == {"spmv": {3: 4, 4: 3, 8: 2},
                      "spmm": {3: 3, 4: 3, 8: 3}}[kind][depth]
    run = hopper.ring_run_steps(rname, geo, call.kernel.ring,
                                torch.float32, sms)
    assert run % z == 0
    per = run // z
    ctas = -(-blocks // per) * groups
    assert ctas <= max(per_sm * sms, groups)
    if per > 1:                     # a block less a run: over one wave
        assert -(-blocks // (per - 1)) * groups > per_sm * sms


@pytest.mark.parametrize("depth", [3, 4, 8], ids=str)
def test_scan_walk_fetch_log_is_the_reference_rotation(depth):
    x = _scan_input(40 * 1024, "float32")
    entry, lc, arrays = _scan_entry(x, Schedule(buffer_depth=depth))
    geo = hopper.launch_geometry(lc)
    run = hopper.ring_run_steps("ring_stream_scan", geo, entry.ring,
                                torch.float32, 4)
    per = hopper.SCAN_TILE // 1024
    # R15's CTAs take a tile at a time by ticket: each tile a run of its own
    assert run == per and run < geo.steps
    want = hopper.plain_stream(scan.SCAN, lc, arrays)
    for r in (None, per, run):
        _, log = hopper.ring_taken(geo, entry.ring, r)
        assert log == _formula((depth,), (False,), geo.steps, r or geo.steps)
        got = hopper.plain_stream(scan.SCAN, lc, arrays, ring=entry.ring,
                                  steps_per_cta=r)
        assert torch.equal(got[0], want[0])


# -- the addresses come from the ring ------------------------------------------


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("depth", [3, 4, 8], ids=str)
@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_plain_gather_ring_reads_its_addresses_from_the_delivered_block(
        kind, depth, step, monkeypatch):
    """A ring that hands ``step`` the cidx block of the last step (its slot
    filled with another step's block) changes that step's result and no
    other: the plain ring gathers through the cidx block it delivered for
    the step, not through the layout, whatever the depth (R13 gathers a
    step's table values ``depth − 2`` steps ahead of its arithmetic, from
    that step's cidx slot).  (HPCG's first two row blocks, the z = 0 and z
    = 1 layers, begin with the same columns; the last one does not.)"""
    call = _call(kind, _hpcg(), _sched(depth), c=200)
    kern = call.kernel
    geo = kern.geometry
    assert step < geo.steps - 1
    want = kern.plain(call.layouts)
    real = hopper.ring_taken

    def early(geo, ring, steps_per_cta=None):
        taken, log = real(geo, ring, steps_per_cta)
        taken[1][step] = geo.steps - 1   # cidx only: vals still its own
        return taken, log

    monkeypatch.setattr(hopper, "ring_taken", early)
    got = kern.plain(call.layouts)
    # the step's output block moved (its rows gathered at the last step's
    # columns); every other block did not
    first = geo.out.element_index(geo.grid, geo.out_shape, None,
                                  agu.grid_steps(geo.grid)[step:step + 1]
                                  ).reshape(-1)
    mask = torch.zeros(got.numel(), dtype=torch.bool)
    mask[first] = True
    assert not torch.equal(got.reshape(-1)[mask], want.reshape(-1)[mask])
    assert torch.equal(got.reshape(-1)[~mask], want.reshape(-1)[~mask])
