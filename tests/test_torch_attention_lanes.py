"""K11's tiles by head dim: the live lanes of a wide head.

On the card K11 ``rescale_attention`` runs the 128-lane tile up to D = 128
(80 zero-padded to 128) on its live lanes, 96 of them for D ≤ 96, else
128, and, above, the wide kernel on the live lanes of the 256-lane layout:
192 of them for D ≤ 192, else 256 — Q, K and V staged and the score and
p·v products summed over those lanes alone, the drain writing 0 past them.
The wrapper reads D from the attention body's parameters.  Here, on the
CPU:

* the tile ``hopper.rescale_attention_tiles`` picks for D = 64, 80, 96,
  97, 128, 160, 192, 193 and 256, and the shared memory it counts for it
  (the mirror of ``ssr_rescale_attention_smem_bytes``, which
  ``chip_smoke.py`` holds equal to the C count on the card), within the
  227 KiB a CTA may opt into;
* the body's parameters carry D, and the kernel's refusal counts the
  widest tile of the lanes;
* the port's attention at D = 80, 96, 97 and 192 against the JAX package,
  the same seeded numpy inputs through both, at the registry ``tol``.

The card's checks (K11 against its plain version, R12 to K11's bits) are in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lowering as jlowering
from repro.kernels import attention as jattention

import repro_torch
from repro_torch.core import hopper, lowering
from repro_torch.kernels import attention, registry

OPTIN = 227 * 1024         # shared memory a CTA may opt into on an H100
TOL = registry.get("attention").tol


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


@pytest.mark.parametrize("dim, lanes, rows, live, acc, smem", [
    (64, 128, 128, 96, 6, 183_296),
    (80, 128, 128, 96, 6, 183_296),
    (96, 128, 128, 96, 6, 183_296),
    (97, 128, 128, 128, 8, 232_448),
    (128, 128, 128, 128, 8, 232_448),
    (160, 256, 64, 192, 6, 166_912),
    (192, 256, 64, 192, 6, 166_912),
    (193, 256, 64, 256, 8, 216_064),
    (256, 256, 64, 256, 8, 216_064)])
def test_the_tile_of_each_head_dim(dim, lanes, rows, live, acc, smem):
    tile = hopper.rescale_attention_tiles(dim, lanes)
    assert tile == {"rows": rows, "live": live, "acc_lanes": acc,
                    "smem": smem}
    assert tile["smem"] <= OPTIN
    # a thread's accumulator lanes cover the live lanes over 32 column
    # groups on the wide tile (16 on the 128-lane one)
    assert tile["acc_lanes"] * (16 if lanes == 128 else 32) == live


@pytest.mark.parametrize("dim, lanes", [(0, 128), (129, 128), (257, 256),
                                        (64, 192)])
def test_a_head_dim_the_lanes_cannot_hold_is_refused(dim, lanes):
    with pytest.raises(ValueError, match="rescale_attention"):
        hopper.rescale_attention_tiles(dim, lanes)


def test_the_layouts_pad_each_head_dim_to_its_lanes_tile():
    """What the tile choice sees: D = 80 and 128 on 128 lanes, 192 and 256
    on 256, the layout's lanes past D zero."""
    for d, lanes in ((80, 128), (128, 128), (192, 256), (256, 256)):
        q = torch.randn(70, d)
        _, static, _ = attention._prepare(q, q, q, True, None)
        call = lowering.prepare_call(attention._nest(static),
                                     attention._body(static),
                                     {"Q": q, "K": q, "V": q})
        geo = call.kernel.geometry
        assert {s.block[1] for s in geo.ins} == {lanes}
        assert call.kernel.program.params[0][5] == d
        for t in call.layouts:
            assert not t[:, d:].any()


def test_the_128_lane_tile_stages_q_transposed_and_k_on_a_16_byte_pitch():
    """The 128-lane tile's shared memory, term by term: Q^T (live × 128
    rows), the p tile (64 × 132) and two buffers each of K (64 keys on a
    pitch of live + 4 floats) and V (64 × live), in f32; the widest (D =
    128) is the most, all a CTA may opt into on an H100."""
    for dim, live in ((80, 96), (128, 128)):
        want = 4 * (live * 128 + 64 * 132 + 2 * (64 * (live + 4) + 64 * live))
        assert hopper.rescale_attention_tiles(dim, 128)["smem"] == want
    assert hopper.rescale_attention_tiles(128, 128)["smem"] == max(
        hopper.rescale_attention_tiles(d, 128)["smem"] for d in range(1, 129))
    assert hopper.rescale_attention_tiles(128, 128)["smem"] == \
        hopper.SMEM_OPTIN_BYTES


def test_the_body_carries_the_head_dim_and_the_refusal_the_widest_tile():
    q = torch.randn(40, 192)
    _, static, _ = attention._prepare(q, q, q, True, 9)
    body = attention._body(static)
    assert body.params[-1] == 192 and len(body.params) == \
        hopper._PARAMS["rescale_attention"]
    call = lowering.prepare_call(attention._nest(static), body,
                                 {"Q": q, "K": q, "V": q})
    # the shared memory the wrapper checks before a launch: the lanes
    # tile's widest head dim, the most any head dim there takes
    assert hopper._SMEM_ARGS["rescale_attention"](
        call.kernel.geometry, torch.float32) == (256, 256)
    assert hopper.rescale_attention_tiles(256, 256)["smem"] == max(
        hopper.rescale_attention_tiles(d, 256)["smem"]
        for d in range(129, 257))


@pytest.mark.parametrize("case", [(2, 80, 120, True, None),
                                  (3, 64, 64, False, 9),
                                  (1, 130, 70, True, 40)],
                         ids=lambda c: "-".join(map(str, c)))
def test_d192_heads_match_the_jax_package(case):
    """The port's attention at D = 192 over a head batch against the JAX
    package (its Pallas kernel in interpret mode, one head at a time), the
    same seeded numpy inputs through both, at the registry tol."""
    heads, sq, sk, causal, window = case
    rng = np.random.default_rng(heads * 1000 + sq + sk)
    q, k, v = (rng.standard_normal((heads, s, 192)).astype(np.float32)
               for s in (sq, sk, sk))
    got = attention.ssr_flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window)
    assert tuple(got.shape) == (heads, sq, 192)
    for h in range(heads):
        want = np.asarray(jattention.ssr_flash_attention(
            *(jnp.asarray(a[h]) for a in (q, k, v)), causal=causal,
            window=window, schedule=jlowering.DEFAULT_SCHEDULE))
        np.testing.assert_allclose(got[h].numpy(), want, **TOL)


@pytest.mark.parametrize("case", [(2, 80, 120, True, None),
                                  (2, 80, 150, True, 33),
                                  (1, 96, 70, True, None),
                                  (3, 96, 96, True, 17),
                                  (2, 97, 130, True, None),
                                  (1, 97, 100, True, 40)],
                         ids=lambda c: "-".join(map(str, c)))
def test_128_lane_live_widths_match_the_jax_package(case):
    """The port's attention at D = 80 and 96 (96 live lanes of the 128-lane
    tile on the card) and 97 (all 128), causal and windowed, over a head
    batch against the JAX package (its Pallas kernel in interpret mode,
    one head at a time), the same seeded numpy inputs through both, at the
    registry tol."""
    heads, d, s_, causal, window = case
    rng = np.random.default_rng(heads * 1000 + d + s_)
    q, k, v = (rng.standard_normal((heads, s_, d)).astype(np.float32)
               for _ in range(3))
    got = attention.ssr_flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window)
    assert tuple(got.shape) == (heads, s_, d)
    for h in range(heads):
        want = np.asarray(jattention.ssr_flash_attention(
            *(jnp.asarray(a[h]) for a in (q, k, v)), causal=causal,
            window=window, schedule=jlowering.DEFAULT_SCHEDULE))
        np.testing.assert_allclose(got[h].numpy(), want, **TOL)
