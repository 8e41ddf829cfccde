"""The halo and attention rings in the port: K9–K11's families under the
N-deep rotation.

A schedule deeper than 2 makes a stencil (``ssr_stencil1d``, the fused
``stencil1d_relu``, ``ssr_stencil2d``) or an attention call
(``ssr_flash_attention``) pipelined: its read streams arrive through the
ring (on the CPU :func:`hopper.plain_ring` over
:func:`hopper.ring_delivery`, on the card R10 ``ring_halo_stencil1d``, R11
``ring_halo_stencil2d`` and R12 ``ring_rescale_attention``).  On the CPU,
at small sizes and on inputs from a numpy seed:

* **delivery changes, the arithmetic does not** — at depths 3, 4, 8 and a
  per-stream tuple, each call gives its depth-2 bits and agrees with the
  JAX package's sync output (its Pallas kernel in interpret mode: the
  reference's own rotation does not run on this jax) within the registry
  ``tol``: causal, windowed, D = 80 padded to 128 and D = 192 padded to
  256 attention, a head batch;
* **pipelined where a ring runs**, routed to R10–R12;
* **one budget** — ``device_ring`` gives the shifted twins no bytes, the
  invariant taps one slot and Q the one tile R12 stages (Q^T in f32 on
  128 lanes, Q's rows on 256), R12's K slots its units of 32 keys (128
  lanes) or of 64 keys on a quarter of the lanes (256); ``accepts``
  counts R12's p tile beside its ring, takes depth 4 on a 128-lane
  geometry in f32 and bf16, refuses every depth over the budget (and
  depth 8) naming the kernel and its bytes, and admits R11 at every depth;
* **the plain ring of attention is the online softmax** — ``plain_ring``
  runs ``plain_rescale`` (the kernel's ``plain_kind``) on the delivered
  blocks;
* **the reference's rotation** — the fetch log of a halo's twin pair and
  of the kv walk is ``_pipelined_call``'s formula.

The card's own checks (R10–R12 against K9–K11 to the bit) are in
``tests/test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.lowering import DEFAULT_SCHEDULE as REF_DEFAULT
from repro.kernels import attention as jattention
from repro.kernels import chained as jchained
from repro.kernels import stencil as jstencil

import repro_torch
from repro_torch.core import agu, compiler, hopper, lowering
from repro_torch.core.lowering import DEFAULT_SCHEDULE, Schedule
from repro_torch.kernels import attention, chained, registry, stencil

from test_torch_pipeline import _formula

TAPS = stencil.TAPS
DEPTHS = [3, 4, 8, "pair"]
# the per-stream tuple of each family: the ring's stream deepest, a twin
# or the V stream shallower
PAIRS = {"stencil1d": (4, 2, 2), "stencil2d": (4, 2, 2, 2, 2, 2),
         "attention": (4, 4, 2)}
RING = {"stencil1d": "ring_halo_stencil1d",
        "stencil1d_relu": "ring_halo_stencil1d",
        "stencil2d": "ring_halo_stencil2d",
        "attention": "ring_rescale_attention"}
N1D = 3000                       # 6 grid steps of 512
HW = (300, 600)                  # a (2, 5) grid of (152, 128) blocks
ATTENTION = {                    # (sq, sk, d, causal, window)
    "causal_d80": (100, 333, 80, True, None),
    "window_d80": (100, 333, 80, True, 64),
    "d192": (96, 300, 192, True, None),
    "d256_window": (64, 260, 256, False, 64),
}


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    monkeypatch.delenv("REPRO_DISABLE_PIPELINE", raising=False)
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _sched(depth, family) -> Schedule:
    if depth == "pair":
        return Schedule(stream_depths=PAIRS[family])
    return Schedule(buffer_depth=depth)


def _f32(seed, *shape, scale=1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _stencil1d_inputs():
    return _f32(1, N1D + TAPS - 1), _f32(2, TAPS, scale=0.3)


def _stencil2d_inputs():
    h, w = HW
    return (_f32(3, h + TAPS - 1, w + TAPS - 1), _f32(4, TAPS, scale=0.3),
            _f32(5, TAPS, scale=0.3))


def _qkv(name, lead=()):
    sq, sk, d, _, _ = ATTENTION[name]
    return tuple(_f32(10 + k, *lead, s, d) for k, s in enumerate((sq, sk,
                                                                  sk)))


@functools.lru_cache(maxsize=None)
def _reference(name: str) -> np.ndarray:
    """The JAX package's sync output (Pallas interpret mode), once a case."""
    if name == "stencil1d":
        x, w = _stencil1d_inputs()
        return np.asarray(jstencil.ssr_stencil1d(
            jnp.asarray(x), jnp.asarray(w), schedule=REF_DEFAULT))
    if name == "stencil1d_relu":
        x, w = _stencil1d_inputs()
        return np.asarray(jchained.fused_stencil1d_relu(jnp.asarray(x),
                                                        jnp.asarray(w)))
    if name == "stencil2d":
        return np.asarray(jstencil.ssr_stencil2d(
            *(jnp.asarray(a) for a in _stencil2d_inputs()),
            schedule=REF_DEFAULT))
    _, _, _, causal, window = ATTENTION[name]
    return np.asarray(jattention.ssr_flash_attention(
        *(jnp.asarray(a) for a in _qkv(name)), causal=causal, window=window,
        schedule=REF_DEFAULT))


def _port(name, sched):
    """The port's entry point for the case under ``sched``."""
    if name == "stencil1d":
        return stencil.ssr_stencil1d(
            *(torch.from_numpy(a) for a in _stencil1d_inputs()),
            schedule=sched)
    if name == "stencil1d_relu":
        return chained.fused_stencil1d_relu(
            *(torch.from_numpy(a) for a in _stencil1d_inputs()),
            schedule=sched)
    if name == "stencil2d":
        return stencil.ssr_stencil2d(
            *(torch.from_numpy(a) for a in _stencil2d_inputs()),
            schedule=sched)
    _, _, _, causal, window = ATTENTION[name]
    return attention.ssr_flash_attention(
        *(torch.from_numpy(a) for a in _qkv(name)), causal=causal,
        window=window, schedule=sched)


def _call(name, sched, lead=()):
    """The prepared call (kernel and layouts) of the case under ``sched``;
    with ``lead``, the single-head kernel over a head batch's layouts."""
    if name in ("stencil1d", "stencil1d_relu"):
        x, w = (torch.from_numpy(a) for a in _stencil1d_inputs())
        body = stencil.STENCIL1D if name == "stencil1d" \
            else chained.STENCIL1D_RELU
        return lowering.prepare_call(_nest(name), body,
                                     {"x": x, "w": w}, schedule=sched)
    if name == "stencil2d":
        x, wx, wy = (torch.from_numpy(a) for a in _stencil2d_inputs())
        return lowering.prepare_call(_nest(name), stencil.STENCIL2D,
                                     {"x": x, "wx": wx, "wy": wy},
                                     schedule=sched)
    sq, sk, d, causal, window = ATTENTION[name]
    q, k, v = (torch.from_numpy(a) for a in _qkv(name, lead))
    _, static, _ = attention._prepare(q[(0,) * len(lead)],
                                      k[(0,) * len(lead)],
                                      v[(0,) * len(lead)], causal, window)
    one = lowering.prepare_call(
        attention._nest(static), attention._body(static),
        {"Q": q[(0,) * len(lead)], "K": k[(0,) * len(lead)],
         "V": v[(0,) * len(lead)]}, schedule=sched)
    if not lead:
        return one
    batch = {"Q": q, "K": k, "V": v}
    layouts = lowering.stream_layouts(
        one.lowered, [batch[s.name] for s in one.lowered.in_streams],
        lead=lead)
    return lowering.PreparedCall(kernel=one.kernel, layouts=layouts,
                                 lowered=one.lowered, bounds=one.bounds)


def _nest(name):
    if name == "stencil2d":
        return compiler.stencil2d_nest(*HW, TAPS)
    return compiler.stencil_nest(N1D, TAPS)


def _tol(name):
    key = {"stencil1d_relu": "stencil1d"}.get(name, name)
    return registry.get("attention" if key in ATTENTION else key).tol


# -- delivery changes, the arithmetic does not --------------------------------


_CASES = [(name, depth) for name in ("stencil1d", "stencil1d_relu",
                                     "stencil2d", *ATTENTION)
          for depth in DEPTHS]


@pytest.mark.parametrize("name, depth", _CASES, ids=str)
def test_pipelined_call_matches_the_reference_sync_output(name, depth):
    family = "attention" if name in ATTENTION else name.replace("_relu", "")
    sched = _sched(depth, family)
    call = _call(name, sched)
    kern = call.kernel
    assert kern.pipelined and kern.geometry.steps > 1
    assert hopper.RING_KERNELS[kern.device_key] == RING[
        "attention" if name in ATTENTION else name]
    got = _port(name, sched)
    flat = _port(name, DEFAULT_SCHEDULE)
    # only delivery changed: the depth-2 bits
    assert torch.equal(got, flat), float((got - flat).abs().max())
    want = _reference(name)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **_tol(name))


def test_head_batch_through_the_ring_is_each_head():
    lead = (2, 3)
    call = _call("window_d80", Schedule(buffer_depth=4), lead=(6,))
    assert call.kernel.pipelined
    got = call.finish(call.kernel(*call.layouts))
    q, k, v = (torch.from_numpy(a.reshape(6, *a.shape[2:]))
               for a in _qkv("window_d80", lead))
    for h in (0, 4):
        one = attention.ssr_flash_attention(q[h], k[h], v[h], causal=True,
                                            window=64)
        assert torch.equal(got[h], one)


# -- pipelined where a ring runs ---------------------------------------------


@pytest.mark.parametrize("name", ["stencil1d", "stencil1d_relu", "stencil2d",
                                  "causal_d80"])
def test_depth_2_stays_sync_and_deeper_routes_to_the_ring(name, monkeypatch):
    kern = _call(name, DEFAULT_SCHEDULE).kernel
    assert not kern.pipelined and "ring" not in kern.device_args()
    deep = _call(name, Schedule(buffer_depth=3)).kernel
    assert deep.pipelined and deep.device_args()["ring"] == deep.ring
    assert hopper.RING_KERNELS[deep.device_key] == RING[
        "attention" if name in ATTENTION else name]
    monkeypatch.setenv("REPRO_DISABLE_PIPELINE", "1")
    assert not _call(name, Schedule(buffer_depth=3)).kernel.pipelined


def test_the_rings_are_registered_kernels():
    for rname in ("ring_halo_stencil1d", "ring_halo_stencil2d",
                  "ring_rescale_attention"):
        assert hopper.KERNELS[rname]["source"].endswith(f"csrc/{rname}.cu")
        assert hopper.KERNELS[rname]["replaces"] == \
            "src/repro/core/ssr.py:215"
        assert rname in hopper._SIGNATURES and hopper.LAUNCHES[rname] == 0
        assert (hopper.CSRC / f"{rname}.cu").is_file()


# -- one budget ----------------------------------------------------------------


@pytest.mark.parametrize("dtype, slot", [(torch.float32, 2112),
                                         (torch.bfloat16, 1056)])
def test_r10_ring_bytes(dtype, slot):
    kern = _call("stencil1d", Schedule(stream_depths=(4, 3, 2))).kernel
    dr = hopper.device_ring("ring_halo_stencil1d", kern.geometry, kern.ring,
                            dtype)
    # x's items at its depth, the twin never read, the taps one slot
    assert kern.invariant == (False, False, True)
    assert dr.depths == (4, 3, 1)
    assert dr.slot_bytes == (slot, 0, 4 * TAPS)
    assert dr.ring_bytes == 4 * slot + 4 * TAPS


@pytest.mark.parametrize("dtype, slot", [(torch.float32, 42 * 140 * 4),
                                         (torch.bfloat16, 42 * 144 * 2)])
def test_r11_ring_bytes_and_every_depth_fits(dtype, slot):
    kern = _call("stencil2d", Schedule(buffer_depth=8)).kernel
    dr = hopper.device_ring("ring_halo_stencil2d", kern.geometry, kern.ring,
                            dtype)
    assert dr.slot_bytes == (slot, 0, 0, 0, 4 * TAPS, 4 * TAPS)
    assert dr.depths == (8, 8, 8, 8, 1, 1)
    assert dr.ring_bytes == 8 * slot + 8 * TAPS
    for depth in (3, 4, 8):
        k = _call("stencil2d", Schedule(buffer_depth=depth)).kernel
        assert hopper.accepts(k.device_key, k.geometry, dtype, "cpu",
                              **k.device_args()) == (True, "ok")


@pytest.mark.parametrize("name, d, kunit, vkeys, rows", [
    ("causal_d80", 128, (32, 128), 32, 128), ("d192", 256, (64, 64), 16, 64)])
def test_r12_ring_bytes_count_q_once(name, d, kunit, vkeys, rows):
    kern = _call(name, Schedule(stream_depths=(4, 3, 2))).kernel
    assert kern.geometry.ins[0].block[1] == d
    assert hopper.ATTENTION_RING_TILES[d] == (rows, kunit, vkeys)
    dr = hopper.device_ring("ring_rescale_attention", kern.geometry,
                            kern.ring, torch.float32)
    # K and V units at their depths, Q the one tile R12 stages: Q^T in f32
    # on 128 lanes, Q's rows on a pitch of d + 16 bytes on 256
    keys, lanes = kunit
    q32 = d * rows * 4 if d == 128 else rows * (d + 4) * 4
    assert dr.depths == (4, 3, 1)
    assert dr.slot_bytes == (keys * (lanes + 4) * 4, vkeys * d * 4, q32)
    staged = hopper._staged_bytes("ring_rescale_attention", (),
                                  kern.geometry)
    assert staged == 4 * 64 * (rows + 4)
    bf = hopper.device_ring("ring_rescale_attention", kern.geometry,
                            kern.ring, torch.bfloat16)
    q16 = d * rows * 4 if d == 128 else rows * (d + 8) * 2
    assert bf.slot_bytes == (keys * (lanes + 8) * 2, vkeys * d * 2, q16)


@pytest.mark.parametrize("name, fits, over", [("causal_d80", 4, 5),
                                              ("d192", 4, 5)])
def test_accepts_counts_the_p_tile_and_refuses_r12_beyond(name, fits, over):
    kern = _call(name, Schedule(buffer_depth=fits)).kernel
    assert hopper.accepts(kern.device_key, kern.geometry, torch.float32,
                          "cpu", **kern.device_args()) == (True, "ok")
    dr = hopper.device_ring("ring_rescale_attention", kern.geometry,
                            kern.ring, torch.float32)
    need = dr.ring_bytes + hopper._staged_bytes("ring_rescale_attention",
                                                (), kern.geometry)
    assert need <= hopper.SMEM_OPTIN_BYTES
    if name == "causal_d80":        # depth 4 at D = 128 fills the budget
        assert need == hopper.SMEM_OPTIN_BYTES
    for depth in (over, 8):
        k = _call(name, Schedule(buffer_depth=depth)).kernel
        takes, why = hopper.accepts(k.device_key, k.geometry, torch.float32,
                                    "cpu", **k.device_args())
        dr = hopper.device_ring("ring_rescale_attention", k.geometry, k.ring,
                                torch.float32)
        need = dr.ring_bytes + hopper._staged_bytes(
            "ring_rescale_attention", (), k.geometry)
        assert not takes
        assert why.startswith("ring_rescale_attention: its ring at depths "
                              f"{(depth,) * 3} needs {need} bytes")
        assert "its p tile" in why and str(hopper.SMEM_OPTIN_BYTES) in why


def _qwen3_shaped(depth, d=128):
    """A causal attention call shaped as the qwen3 cell's heads (D = 128,
    a 128-lane tile; or D on a 256-lane one), at ``depth``."""
    q = torch.from_numpy(_f32(20, 512, d))
    _, static, _ = attention._prepare(q, q, q, True, None)
    return lowering.prepare_call(attention._nest(static),
                                 attention._body(static),
                                 {"Q": q, "K": q, "V": q},
                                 schedule=Schedule(buffer_depth=depth)).kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_r12_takes_depth_4_on_the_qwen3_geometry(dtype):
    """The main path's depth: R12 at depth 4 on D = 128 in f32 (every byte
    a CTA may opt into: Q^T 65,536, p 33,792, K 4 × 16,896, V 4 × 16,384)
    and in bf16 (the ring's bytes halved)."""
    kern = _qwen3_shaped(4)
    assert kern.geometry.ins[0].block[1] == 128
    assert hopper.accepts(kern.device_key, kern.geometry, dtype, "cpu",
                          **kern.device_args()) == (True, "ok")
    dr = hopper.device_ring("ring_rescale_attention", kern.geometry,
                            kern.ring, dtype)
    need = dr.ring_bytes + hopper._staged_bytes("ring_rescale_attention",
                                                (), kern.geometry)
    size = dtype.itemsize
    ring = 4 * (32 * (128 + 16 // size) * size + 32 * 128 * size)
    assert need == 65_536 + 33_792 + ring
    if dtype == torch.float32:
        assert need == hopper.SMEM_OPTIN_BYTES


@pytest.mark.parametrize("d, dtype, deepest", [(128, torch.float32, 4),
                                               (128, torch.bfloat16, 7),
                                               (256, torch.float32, 4),
                                               (256, torch.bfloat16, 8)])
def test_r12_refuses_by_name_each_depth_over_its_budget(d, dtype, deepest):
    """Every depth from 3 to 8 that R12's ring fits is taken; every one
    over the budget is refused naming the kernel, the depths and the
    bytes, as depth 8 is in f32."""
    for depth in range(3, 9):
        kern = _qwen3_shaped(depth, d)
        takes, why = hopper.accepts(kern.device_key, kern.geometry, dtype,
                                    "cpu", **kern.device_args())
        dr = hopper.device_ring("ring_rescale_attention", kern.geometry,
                                kern.ring, dtype)
        need = dr.ring_bytes + hopper._staged_bytes(
            "ring_rescale_attention", (), kern.geometry)
        assert takes == (depth <= deepest) == (need <=
                                               hopper.SMEM_OPTIN_BYTES)
        if not takes:
            assert why.startswith("ring_rescale_attention: its ring at "
                                  f"depths {(depth,) * 3} needs {need} "
                                  "bytes")


def test_bf16_admits_the_same_depths():
    kern = _call("causal_d80", Schedule(buffer_depth=4)).kernel
    assert hopper.accepts(kern.device_key, kern.geometry, torch.bfloat16,
                          "cpu", **kern.device_args())[0]


# -- the plain ring of attention is the online softmax -------------------------


def test_plain_ring_of_attention_runs_plain_rescale():
    call = _call("window_d80", Schedule(buffer_depth=3))
    kern = call.kernel
    assert kern.plain_kind == "rescale"
    got, log = hopper.plain_ring(kern.body, kern.geometry, call.layouts,
                                 kern.out_dtype, kern.acc_dtype,
                                 mode=kern.plain_kind, ring=kern.ring)
    want = hopper.plain_rescale(kern.body, kern.geometry, call.layouts,
                                kern.out_dtype, kern.acc_dtype)
    assert torch.equal(got, want) and log
    # the kernel's own plain version goes through the ring: the same bits
    assert torch.equal(kern.plain(call.layouts), want)


def test_plain_ring_of_a_head_batch_stacks_the_heads():
    call = _call("causal_d80", Schedule(buffer_depth=4), lead=(3,))
    kern = call.kernel
    got, log = hopper.plain_ring(kern.body, kern.geometry, call.layouts,
                                 kern.out_dtype, mode=kern.plain_kind,
                                 ring=kern.ring)
    want = hopper.plain_rescale(kern.body, kern.geometry, call.layouts,
                                kern.out_dtype)
    assert got.shape[0] == 3 and torch.equal(got, want)
    assert log == _formula(kern.depths, kern.invariant, kern.geometry.steps,
                           kern.geometry.steps)


# -- the reference's rotation: the fetch log -----------------------------------


@pytest.mark.parametrize("run", [None, 1, 2, 4], ids=str)
@pytest.mark.parametrize("depths", [(3, 3, 3), (4, 2, 2), (2, 5, 8)],
                         ids=str)
def test_halo_twin_pair_fetch_log_is_the_reference_rotation(depths, run):
    call = _call("stencil1d", Schedule(stream_depths=depths))
    kern = call.kernel
    steps = kern.geometry.steps
    (inputs, log) = hopper.ring_delivery(kern.geometry, call.layouts,
                                         kern.ring, run)
    assert log == _formula(depths, (False, False, True), steps, run or steps)
    # each of the twin pair is delivered from its own ring, every step once
    for i in (0, 1):
        assert sorted(s for j, s, _ in log if j == i) == list(range(steps))
    # and the widened block is stitched from both, as the sync path does
    got = hopper.plain_contract(kern.body, kern.geometry, call.layouts,
                                kern.out_dtype, inputs=inputs)
    assert torch.equal(got, hopper.plain_contract(
        kern.body, kern.geometry, call.layouts, kern.out_dtype))


@pytest.mark.parametrize("run", [None, 3], ids=str)
@pytest.mark.parametrize("name", ["causal_d80", "d256_window"])
def test_kv_walk_fetch_log_is_the_reference_rotation(name, run):
    call = _call(name, Schedule(stream_depths=(4, 3, 2)))
    kern = call.kernel
    geo = kern.geometry
    assert geo.contraction_steps > 1 and kern.invariant[:2] == (False, False)
    inputs, log = hopper.ring_delivery(geo, call.layouts, kern.ring, run)
    assert log == _formula((4, 3, 2), kern.invariant, geo.steps,
                           run or geo.steps)
    got = hopper.plain_rescale(kern.body, geo, call.layouts, kern.out_dtype,
                               inputs=inputs)
    assert torch.equal(got, hopper.plain_rescale(kern.body, geo, call.layouts,
                                                 kern.out_dtype))
    # the kv steps of one query block in grid order: K's fetches walk them
    z = geo.contraction_steps
    k_steps = [s for i, s, _ in log if i == 0]
    assert k_steps[:z] == list(range(z))
    assert isinstance(kern.ring, agu.RingProgram)
