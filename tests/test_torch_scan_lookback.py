"""R15's one pass keeps K14's association: each tile's offset from its
predecessors alone, operation for operation as K14's second pass.

K14 ``stream_scan`` fixes its tiles' offsets in one CTA
(a second pass: chunks of 4096 totals with a running carry,
each thread's 16 totals summed in order from 0, a Kogge–Stone CTA scan of
those sums).  R15 ``ring_stream_scan`` reads x once: each tile publishes
its total, the tile that closes a group of 16 its group's sum, the tile
that closes a chunk the next carry, and each tile computes its own offset
from what its predecessors published.  On the CPU, in numpy float32 (the
models in ``repro_torch.core.hopper``), from numpy seeds:

* **bit for bit** — R15's per-tile offsets equal K14's at 1, 15, 16, 17,
  4095, 4096, 4097 and 16384 tiles, on random totals, on totals of ±0 and
  on totals spanning 1e-30 to 1e30;
* **predecessors only** — every total at or after tile i turned to NaN
  leaves tile i's offset unchanged, and a tile that would read a group sum
  or carry before its tile published it raises;
* **the whole scan** — the model's scan of a padded vector is within the
  registry's scan tolerance of ``ref.scan_ref`` and of the JAX package's
  ``scan_ref``.

K14 ``stream_scan`` itself is one pass now: persistent CTAs take tiles by
ticket, hold at most two (one summed, one being summed), publish a tile's
total before any wait, and find each offset by the same look-back
(``csrc/ssr_scan.cuh``).  Its schedule, in ``hopper.scan_schedule_model``:

* **every tile finishes** — no interleaving of 1 to 4 CTAs an SM on 132
  SMs over 1 to 20,000 tiles leaves every unfinished CTA waiting, no CTA
  holds more than two tiles, and every tile's total is published once;
* **the same offsets** — over more than one chunk (> 4096 tiles) the
  offsets the schedule computes from what it published equal the second
  pass's to the bit, whatever the interleaving;
* **its state** — the words a call's memset zeroes.

The card's checks (R15 against K14 to the bit at depths 3, 4 and 8, K14
against ``hopper.scan_model``'s bits, K14 one kernel after a memset) are
in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.core import hopper
from repro_torch.kernels import ref, registry, scan

TILES = [1, 15, 16, 17, 4095, 4096, 4097, 16384]


def _totals(kind: str, tiles: int, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed + tiles)
    if kind == "random":
        return rng.standard_normal(tiles).astype(np.float32)
    if kind == "signed_zeros":
        return np.where(rng.random(tiles) < 0.5, -0.0, 0.0).astype(np.float32)
    mag = 10.0 ** rng.uniform(-30, 30, tiles)
    return (np.where(rng.random(tiles) < 0.5, -1, 1) * mag).astype(np.float32)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("kind", ["random", "signed_zeros", "wide"])
@pytest.mark.parametrize("tiles", TILES)
def test_r15_offsets_are_k14s_bit_for_bit(tiles, kind):
    totals = _totals(kind, tiles)
    want = hopper.scan_offsets_model(totals)
    got = hopper.scan_tile_offsets_model(totals)
    assert got.shape == want.shape == (tiles,)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if kind == "signed_zeros":       # the chain starts from 0.f: +0 offsets
        assert not np.signbit(got).any()


@pytest.mark.parametrize("i", [0, 1, 15, 16, 17, 255, 4095, 4096, 4097,
                               6000])
def test_an_offset_ignores_the_totals_from_its_own_tile_on(i):
    totals = _totals("random", 8192)
    poisoned = totals.copy()
    poisoned[i:] = np.nan
    for model in (hopper.scan_offsets_model, hopper.scan_tile_offsets_model):
        before, after = model(totals), model(poisoned)
        assert _bits(after[i]) == _bits(before[i])
        assert not np.isnan(after[i])
    # R15's step for tile i takes the totals before it and nothing later
    groups, carries = {}, {}
    got = [hopper.scan_tile_offset_model(poisoned[:t], poisoned[t], groups,
                                         carries) for t in range(i + 1)]
    assert _bits(got[i]) == _bits(hopper.scan_offsets_model(totals)[i])


@pytest.mark.parametrize("i", [32, 300, 4096, 4096 + 16])
def test_a_tile_reads_only_what_its_predecessors_published(i):
    """Tile i reads its chunk's earlier group sums and its carry from what
    the tiles closing them published: before they did, the read fails."""
    totals = _totals("random", i + 1)
    with pytest.raises(KeyError):
        hopper.scan_tile_offset_model(totals[:i], totals[i], {}, {})


def test_the_cta_scan_model_is_an_exclusive_scan():
    v = np.random.default_rng(1).standard_normal(256).astype(np.float32)
    excl, total = hopper.cta_exclusive_scan_model(v)
    want = np.concatenate([[0.0], np.cumsum(v.astype(np.float64))[:-1]])
    np.testing.assert_allclose(excl, want, rtol=0, atol=1e-4)
    assert abs(total - v.astype(np.float64).sum()) < 1e-4
    assert excl[0] == 0 and excl.dtype == np.float32


@pytest.mark.parametrize("n", [1000, 4096, 3 * 4096 + 1024, 70 * 4096 + 5])
def test_the_models_scan_is_within_the_references(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    arrays, _, _ = scan._prepare(torch.from_numpy(x))
    padded = arrays[0].numpy()
    assert padded.shape[1] == 128 and padded.size >= n
    got = hopper.scan_model(padded.reshape(-1))[:n]
    tol = registry.get("scan").tol
    np.testing.assert_allclose(got, ref.scan_ref(torch.from_numpy(x)).numpy(),
                               **tol)
    np.testing.assert_allclose(got, np.asarray(jref.scan_ref(jnp.asarray(x))),
                               **tol)


# -- K14's schedule: persistent CTAs, two tiles each -----------------------------

SMS = 132
SCHEDULE_TILES = [1, 2, 15, 16, 17, 4095, 4096, 4097, 20000]


@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
@pytest.mark.parametrize("tiles", SCHEDULE_TILES)
def test_k14_schedule_finishes_every_tile(tiles, per_sm):
    totals = np.zeros(tiles, np.float32)
    _, stats = hopper.scan_schedule_model(totals, per_sm * SMS,
                                          seed=tiles + per_sm, values=False)
    assert sorted(stats["order"]) == list(range(tiles))
    assert stats["held"] == (1 if tiles == 1 else 2)


@pytest.mark.parametrize("ctas", [1, 5, SMS, 4 * SMS])
@pytest.mark.parametrize("tiles", [4097, 9000])
def test_k14_schedule_offsets_are_the_second_pass_bit_for_bit(tiles, ctas):
    totals = _totals("random", tiles, seed=ctas)
    got, stats = hopper.scan_schedule_model(totals, ctas, seed=ctas)
    want = hopper.scan_offsets_model(totals)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # tiles started in ticket order, so their totals were published in an
    # order no tile waits out of: the model finished with both checks
    assert stats["held"] == 2 and len(stats["order"]) == tiles


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k14_schedule_offsets_on_signed_zeros_and_wide_totals(seed):
    for kind in ("signed_zeros", "wide"):
        totals = _totals(kind, 4096 + 300, seed=seed)
        got, _ = hopper.scan_schedule_model(totals, 2 * SMS, seed=seed)
        np.testing.assert_array_equal(_bits(got),
                                      _bits(hopper.scan_offsets_model(totals)))


def test_a_ticket_held_by_a_cta_that_never_runs_deadlocks():
    """Why K14's CTAs are all resident at once: a CTA that took a ticket
    and never ran would leave the tiles after its own waiting for its
    total, and the model reports that."""
    totals = np.zeros(40, np.float32)
    with pytest.raises(hopper.ScanDeadlock, match="none can move"):
        hopper.scan_schedule_model(totals, 3, values=False, stalled=(0,))
    # the same schedule with every CTA running finishes
    _, stats = hopper.scan_schedule_model(totals, 3, values=False)
    assert sorted(stats["order"]) == list(range(40))


@pytest.mark.parametrize("tiles", [1, 15, 16, 17, 4095, 4096, 4097, 16384,
                                   16385])
def test_k14_state_words(tiles):
    groups, chunks = -(-tiles // 16), -(-tiles // 4096)
    # each tile's total, each group's sum, one carry more than the chunks,
    # the ticket counter
    assert hopper.scan_state_words(tiles) == tiles + groups + chunks + 1 + 1


def test_the_batched_cta_scan_model_is_the_one_cta_model():
    v = np.random.default_rng(2).standard_normal((5, 256)).astype(np.float32)
    excl, total = hopper.cta_exclusive_scan_model(v)
    for i in range(5):
        e, t = hopper.cta_exclusive_scan_model(v[i])
        np.testing.assert_array_equal(_bits(excl[i]), _bits(e))
        assert _bits(total[i]) == _bits(t)


@pytest.mark.parametrize("n", [1024, 4096, 5 * 4096 + 1024, 4097 * 4096])
def test_scan_model_is_the_per_tile_look_back(n):
    """The model's scan, its tiles at once over the second pass's offsets,
    gives the bits of each tile scanned from the offset its look-back
    finds."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    tiles = -(-n // hopper.SCAN_TILE)
    v = np.zeros(tiles * hopper.SCAN_TILE, np.float32)
    v[:n] = x
    v = v.reshape(tiles, 256, 16)
    sums = v[:, :, 0].copy()
    for j in range(1, 16):
        sums = sums + v[:, :, j]
    runs, totals = [], np.empty(tiles, np.float32)
    for i in range(tiles):
        r, totals[i] = hopper.cta_exclusive_scan_model(sums[i])
        runs.append(r)
    offs = hopper.scan_tile_offsets_model(totals)
    want = np.empty_like(v)
    for i in range(tiles):
        run = runs[i]
        for j in range(16):
            run = run + v[i, :, j]
            want[i, :, j] = offs[i] + run
    np.testing.assert_array_equal(_bits(hopper.scan_model(x)),
                                  _bits(want.reshape(-1)[:n]))
