"""B8, scan's monolithic baseline, in one pass: its association and its
schedule, on the CPU.

B8 ``base_scan`` (``csrc/base_scan.cu``) reads x once: persistent CTAs
take K14's 4096-element tiles by ticket, one at a time; each walks its
tile's four (8, 128) blocks with one explicit load a thread a block, holds
the blocks' sums in registers, publishes the tile's total and waits for the
tile's offset from K14's look-back (``csrc/ssr_scan.cuh``).  Its bits are
those of the three-launch B8 it replaced (the tiles' totals, the fixed
second pass over them, the tiles' scans from their offsets).  In numpy
float32, from numpy seeds:

* **the model** — ``hopper.base_scan_model`` equals that three-launch
  walk, written out tile by tile, to the bit, and stays within
  SCAN_LIMIT of the JAX package's baseline (Pallas interpret mode, as its
  own tests run it) at n = 1, 1000, 4096, 5000 and 2**20 + 12 in f32, bf16
  and int32;
* **the schedule** — ``hopper.base_scan_schedule_model`` at 1 to 8 CTAs
  an SM on 132 SMs finishes every tile, holds one tile a CTA, and gives
  the second pass's offsets to the bit, on random totals and on totals
  holding ±0 and a NaN; a ticket held by a CTA that never runs deadlocks.

The card's checks (B8 to the model's bits, one kernel after a memset, no
spills) are in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import scan as jscan

from repro_torch.core import hopper
from repro_torch.kernels import scan

#: max |port − reference| over the prefix sum of |x| (chip_smoke.py's
#: SCAN_LIMIT): two f32 scans of one vector in other associations
SCAN_LIMIT = 1e-6
SMS = 132
BLOCK = hopper.ROWS * hopper.LANES


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _input(n: int, dtype: str, seed: int):
    """(numpy values as the port's f32 model sees them, the port's tensor,
    the JAX array) of one input."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        x = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
        return x.astype(np.float32), torch.from_numpy(x), jnp.asarray(x)
    jx = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    if dtype == "bfloat16":
        jx = jx.astype(jnp.bfloat16)
        bits = np.asarray(jx).view(np.int16).copy()
        tx = torch.from_numpy(bits).view(torch.bfloat16)
        return tx.float().numpy(), tx, jx
    return np.asarray(jx), torch.from_numpy(np.asarray(jx).copy()), jx


def _three_launches(x: np.ndarray) -> np.ndarray:
    """The three-launch B8, tile by tile: each tile's total from its block
    walk, the second pass over the totals, each tile's walk again from its
    offset."""
    blocks = len(x) // BLOCK
    tiles = -(-blocks // 4)

    def walk(t, carry, out=None):
        for b in range(t * 4, min(blocks, t * 4 + 4)):
            v = x[b * BLOCK:(b + 1) * BLOCK].reshape(256, 4)
            s = v.copy()
            for i in range(1, 4):
                s[:, i] = s[:, i - 1] + v[:, i]
            excl, total = hopper.cta_exclusive_scan_model(s[:, 3])
            if out is not None:
                out[b * BLOCK:(b + 1) * BLOCK] = (
                    carry + (excl[:, None] + s)).reshape(-1)
            carry = np.float32(carry + total)
        return carry

    totals = np.array([walk(t, np.float32(0)) for t in range(tiles)],
                      np.float32)
    offsets = hopper.scan_offsets_model(totals)
    out = np.empty(len(x), np.float32)
    for t in range(tiles):
        walk(t, offsets[t], out)
    return out


@pytest.mark.parametrize("blocks", [1, 3, 4, 5, 4 * 17 + 2, 4 * 4096 + 6])
def test_the_model_is_the_three_launch_walk_bit_for_bit(blocks):
    x = np.random.default_rng(blocks).standard_normal(
        blocks * BLOCK).astype(np.float32)
    np.testing.assert_array_equal(_bits(hopper.base_scan_model(x)),
                                  _bits(_three_launches(x)))


def test_the_model_takes_whole_blocks():
    with pytest.raises(ValueError, match="whole blocks"):
        hopper.base_scan_model(np.zeros(1000, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n", [1, 1000, 4096, 5000, (1 << 20) + 12])
def test_the_model_is_within_the_jax_baseline(n, dtype):
    values, tx, jx = _input(n, dtype, seed=n)
    padded = scan._prepare(tx)[0][0]
    flat = padded.reshape(-1)
    got = hopper.base_scan_model(flat.numpy().astype(np.float32)
                                 if dtype == "int32"
                                 else flat.float().numpy())[:n]
    want = np.asarray(jscan.baseline_scan(jx))
    assert got.dtype == want.dtype == np.float32 and want.shape == (n,)
    scale = np.cumsum(np.abs(values.astype(np.float64))) + 1e-30
    assert float(np.max(np.abs(got - want) / scale)) <= SCAN_LIMIT
    exact = np.cumsum(values.astype(np.float64))
    assert float(np.max(np.abs(got - exact) / scale)) <= SCAN_LIMIT


@pytest.mark.parametrize("n", [1000, 5000, 3 * 4096 + 1024])
def test_the_model_is_within_the_plain_walk(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    padded = scan._prepare(torch.from_numpy(x))[0][0]
    plain = hopper.plain_base_scan(padded).reshape(-1).numpy()
    got = hopper.base_scan_model(padded.reshape(-1).numpy())
    scale = np.cumsum(np.abs(padded.reshape(-1).numpy().astype(
        np.float64))) + 1e-30
    assert float(np.max(np.abs(got - plain) / scale)) <= SCAN_LIMIT


# -- the schedule: persistent CTAs, one tile each at a time ---------------------

SCHEDULE_TILES = [1, 2, 15, 16, 17, 4095, 4096, 4097, 20000]


@pytest.mark.parametrize("per_sm", range(1, 9))
@pytest.mark.parametrize("tiles", SCHEDULE_TILES)
def test_b8_schedule_finishes_every_tile(tiles, per_sm):
    totals = np.zeros(tiles, np.float32)
    _, stats = hopper.base_scan_schedule_model(totals, per_sm, SMS,
                                               seed=tiles + per_sm,
                                               values=False)
    assert sorted(stats["order"]) == list(range(tiles))
    assert stats["held"] == 1


def _totals(kind: str, tiles: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + tiles)
    if kind == "random":
        return rng.standard_normal(tiles).astype(np.float32)
    totals = np.where(rng.random(tiles) < 0.5, -0.0, 0.0).astype(np.float32)
    if kind == "signed_zeros_and_nan":
        totals[tiles // 2] = np.nan
    return totals


@pytest.mark.parametrize("kind", ["random", "signed_zeros",
                                  "signed_zeros_and_nan"])
@pytest.mark.parametrize("per_sm", [1, 4, 8])
def test_b8_schedule_offsets_are_the_second_pass_bit_for_bit(per_sm, kind):
    totals = _totals(kind, 4096 + 300, seed=per_sm)
    got, stats = hopper.base_scan_schedule_model(totals, per_sm, SMS,
                                                 seed=per_sm)
    want = hopper.scan_offsets_model(totals)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert stats["held"] == 1 and len(stats["order"]) == len(totals)
    if kind == "signed_zeros_and_nan":      # only the tiles after the NaN
        assert not np.isnan(got[:len(totals) // 2 + 1]).any()
        assert np.isnan(got[len(totals) // 2 + 1:]).all()


def test_b8_ticket_held_by_a_cta_that_never_runs_deadlocks():
    """Why B8's CTAs are all resident at once, as K14's: a CTA that took
    a ticket and never ran would leave the tiles after its own waiting for
    its total."""
    totals = np.zeros(40, np.float32)
    with pytest.raises(hopper.ScanDeadlock, match="none can move"):
        hopper.scan_schedule_model(totals, 3, values=False, stalled=(0,),
                                   ahead=False)
    _, stats = hopper.scan_schedule_model(totals, 3, values=False,
                                          ahead=False)
    assert sorted(stats["order"]) == list(range(40))
