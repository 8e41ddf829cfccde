"""K16's and K15's schedules, held on the CPU through their Python mirrors.

``kernels/bitonic.py`` lists K16's passes over a row (tile sort, group
passes, tile merges, each with its stages and every CTA's index set) and
the register runs inside a pass; ``kernels/fft.py`` lists K15's stage
groups and each thread's points.  Their plain executors run the network
and the transform pass by pass and group by group through those sets, and
must equal the plain versions ``bitonic._network`` and ``fft._stockham`` to
the bit, and the JAX package's ``ssr_sort``/``ssr_fft`` as the plain
versions do.  The constants the mirrors use are read from the CUDA sources.
All sizes here are small: the bit-for-bit executors run at n ≤ 2**12.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import bitonic as jbitonic
from repro.kernels import fft as jfft

from repro_torch.core import hopper
from repro_torch.kernels import bitonic, fft

CSRC = pathlib.Path(hopper.__file__).resolve().parents[1] / "csrc"
TILE_LOG2 = hopper.SORT_TILE.bit_length() - 1


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    m = re.search(rf"constexpr\s+(?:int|int64_t)\s+{name}\s*=\s*(\d+)\s*;",
                  text)
    assert m, f"{name} not in {source}"
    return int(m.group(1))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16,
                   torch.int32: torch.int32}[t.dtype])


def _network_rows(x2d: torch.Tensor) -> torch.Tensor:
    return torch.cat([bitonic._network(0, x2d[i:i + 1])[0][0]
                      for i in range(x2d.shape[0])])


# -- the constants ------------------------------------------------------------


def test_cu_constants_equal_hoppers():
    assert 1 << _constant("stream_bitonic.cu", "kTileLog2") == \
        hopper.SORT_TILE
    assert _constant("stream_bitonic.cu", "kGroup") == hopper.SORT_GROUP
    assert _constant("stream_bitonic.cu", "kRegLog2") == hopper.SORT_REG_LOG2
    assert _constant("stream_fft.cu", "kRadixLog2") == hopper.FFT_RADIX_LOG2
    assert _constant("stream_fft.cu", "kSmemPoints") == \
        hopper.FFT_SMEM_POINTS


# -- K16: the passes ----------------------------------------------------------


@pytest.mark.parametrize("log2n", range(1, 27))
def test_sort_passes_concatenate_to_the_network(log2n):
    """Pure Python up to 2**26: the passes' stages, in order, are the
    network's; every group pass runs 1 … SORT_GROUP adjacent stages of one
    k, all at distances of at least the tile."""
    n = 1 << log2n
    passes = bitonic.sort_passes(n)
    assert [st for p in passes for st in p.stages] == \
        bitonic.network_stages(n)
    assert passes[0].kind == "tile_sort"
    for p in passes:
        assert p.len_log2 == min(log2n, TILE_LOG2)
        if p.kind == "group":
            ks = {k for k, _ in p.stages}
            js = [j for _, j in p.stages]
            assert len(ks) == 1 and 1 <= len(js) <= hopper.SORT_GROUP
            assert min(js) >= hopper.SORT_TILE
            assert js == [js[0] >> i for i in range(len(js))]
    if n <= hopper.SORT_TILE:
        assert len(passes) == 1


def test_pass_count_at_2p26_is_the_launches_docstring():
    text = pathlib.Path(hopper.__file__).read_text()
    m = re.search(r"sort_passes``: (\d+) at n = 2\*\*26", text)
    assert m, "hopper's LAUNCHES comment states no K16 launch count"
    passes = bitonic.sort_passes(1 << 26)
    assert len(passes) == int(m.group(1)) == 28 <= 32
    kinds = [p.kind for p in passes]
    assert (kinds.count("tile_sort"), kinds.count("group"),
            kinds.count("tile_merge")) == (1, 15, 12)
    # the 8,192-element tile with groups of 8 (tools/sort_tile_sweep.py)
    assert len(bitonic.sort_passes(1 << 26, tile=8192, group=8)) == 32


@pytest.mark.parametrize("n, rows", [(1 << 12, 1), (1 << 12, 3), (256, 2)])
def test_index_sets_partition_the_rows_and_hold_every_pair(n, rows):
    """n = 2**12, tile 2**6, G = 3: each pass's CTA index sets partition
    the rows, and each of its stages pairs elements of one CTA."""
    for p in bitonic.sort_passes(n, rows, tile=64, group=3):
        idx = p.index_sets()
        assert idx.shape == (p.ctas, 1 << p.len_log2)
        assert torch.equal(idx.reshape(-1).sort().values,
                           torch.arange(rows * n))
        for _k, j in p.stages:
            lo = idx[(idx & j) == 0].reshape(p.ctas, -1)
            hi = idx[(idx & j) != 0].reshape(p.ctas, -1)
            assert torch.equal(lo + j, hi)
        if p.kind == "group":   # runs of 2**lo contiguous elements
            assert p.lo == 6 - len(p.stages)
            assert torch.equal(idx[:, 1:1 << p.lo] - idx[:, :(1 << p.lo) - 1],
                               torch.ones(p.ctas, (1 << p.lo) - 1,
                                          dtype=torch.int64))


def test_tile_holds_several_short_rows():
    """Rows shorter than the tile share one: a batch of 2**16 rows of 1024
    is one launch of SORT_TILE-element tiles, 3 rows of 1024 one of
    1024."""
    p, = bitonic.sort_passes(1024, rows=1 << 16)
    assert (p.len_log2, p.ctas) == (TILE_LOG2, 1 << (26 - TILE_LOG2))
    p, = bitonic.sort_passes(1024, rows=3)
    assert (p.len_log2, p.ctas) == (10, 3)


@pytest.mark.parametrize("n, tile, group", [(1 << 12, 64, 3),
                                            (1 << 12, 1 << 13, 8),
                                            (1 << 10, 32, 1),
                                            (1 << 16, 1 << 13, 8),
                                            (1 << 26, 1 << 13, 8),
                                            (1 << 26, 1 << 14, 9)])
def test_register_runs_cover_each_pass(n, tile, group):
    """The runs split each pass's stages in order; each holds SORT_REG_LOG2
    tile bits, every stage's bit among them; the slot bits and the thread
    bits together number the tile."""
    r = hopper.SORT_REG_LOG2
    for p in bitonic.sort_passes(n, tile=tile, group=group):
        runs = bitonic.register_runs(p)
        assert [st for _m, sts in runs for st in sts] == list(p.stages)
        for mask, sts in runs:
            assert bin(mask).count("1") == r and mask < 1 << p.len_log2
            assert sts
            for _k, j in sts:
                assert mask >> p.tile_bit(j.bit_length() - 1) & 1
        # a run ends only where the next stage's bit would be its r + 1st
        for mask, sts in runs[:-1]:
            assert len({p.tile_bit(j.bit_length() - 1) for _k, j in sts}) == r


def test_register_runs_at_the_tile():
    """At K16's tile (t bits) a tile merge is three runs (5 + 5 + t − 10
    stages), a group pass of SORT_GROUP stages two (5 + the rest), of 3
    stages one, each on five contiguous tile bits (its warps'
    shared-memory words on 32 banks)."""
    t, g = TILE_LOG2, hopper.SORT_GROUP
    top5 = 0b11111 << (t - 5)
    passes = bitonic.sort_passes(1 << 26)
    merge = next(p for p in passes if p.kind == "tile_merge")
    assert [(m, len(s)) for m, s in bitonic.register_runs(merge)] == \
        [(top5, 5), (0b11111 << (t - 10), 5), (0b11111, t - 10)]
    group = next(p for p in passes if p.kind == "group"
                 and len(p.stages) == g)
    assert [(m, len(s)) for m, s in bitonic.register_runs(group)] == \
        [(top5, 5), (0b11111 << (t - g), g - 5)]
    group = next(p for p in passes if p.kind == "group"
                 and len(p.stages) == 3)
    assert [(m, len(s)) for m, s in bitonic.register_runs(group)] == \
        [(top5, 3)]
    assert bitonic.register_runs(bitonic.sort_passes(16, rows=1)[0]) == []


def _sort_input(dtype, rows, n, seed, nan):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        x = torch.from_numpy(rng.integers(-(1 << 31), (1 << 31) - 1,
                                          (rows, n), dtype=np.int64)
                             .astype(np.int32))
        return x
    x = rng.standard_normal(rows * n).astype(np.float32)
    x[: rows * n // 4] = 0.0
    x[: rows * n // 8] = -0.0
    x = torch.from_numpy(x[rng.permutation(rows * n)].reshape(rows, n))
    x = x.to(dtype)
    if nan:
        x[0, n // 3] = float("nan")
    return x


@pytest.mark.parametrize("dtype, nan", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, False),
    (torch.bfloat16, True), (torch.int32, False)])
@pytest.mark.parametrize("n, rows, tile, group", [
    (1 << 12, 1, 64, 3), (1 << 12, 1, 256, 8), (1 << 10, 3, 32, 2),
    (1 << 12, 2, 512, 4), (64, 4, 1 << 14, 9), (8, 5, 64, 3),
    (2, 1, 64, 3)])
def test_run_passes_equals_the_network_to_the_bit(dtype, nan, n, rows, tile,
                                                  group):
    x = _sort_input(dtype, rows, n, n + rows + tile, nan)
    got = bitonic.run_passes(x, bitonic.sort_passes(n, rows, tile, group))
    want = _network_rows(x)
    assert got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    if nan:
        assert bool(torch.isnan(got[0]).all())
    elif dtype != torch.int32:   # −0 below +0, each zero kept
        zeros = got[got == 0]
        assert int(torch.signbit(zeros).sum()) == \
            int(torch.signbit(x[x == 0]).sum())


def test_run_passes_equals_the_reference_sort():
    """The pass-by-pass executor against the JAX package's ssr_sort."""
    x = _sort_input(torch.float32, 1, 256, 7, False)
    got = bitonic.run_passes(x, bitonic.sort_passes(256, 1, 32, 2))
    want = np.asarray(jbitonic.ssr_sort(jnp.asarray(x.numpy()[0])))
    np.testing.assert_array_equal(got.numpy()[0].view(np.int32),
                                  want.view(np.int32))


# -- K15: the stage groups ----------------------------------------------------


def test_fft_groups():
    assert fft.fft_groups(11) == ((0, 3), (3, 3), (6, 3), (9, 2))
    assert fft.fft_groups(11, 2) == ((0, 2), (2, 2), (4, 2), (6, 2),
                                     (8, 2), (10, 1))
    assert fft.fft_groups(13) == ((0, 3), (3, 3), (6, 3), (9, 3), (12, 1))
    assert fft.fft_groups(2) == ((0, 2),) and fft.fft_groups(0) == ()


@pytest.mark.parametrize("log2n", range(0, 12))
@pytest.mark.parametrize("r", [2, 3])
def test_thread_points_stay_closed_for_a_group(log2n, r):
    """A thread's points at a group's start partition the row; within the
    group every stage pairs two of them (the stage's top bit), and they
    land on a partition of the row."""
    n = 1 << log2n
    pts = fft.fft_thread_points(n, r)
    assert torch.equal(pts.reshape(-1).sort().values, torch.arange(n))
    for s0, g in fft.fft_groups(log2n, r):
        cur = pts
        for s in range(s0, s0 + g):
            top = cur >> (log2n - 1) & 1
            assert int(top.sum()) * 2 == cur.numel()
            for row, bit in zip(cur.tolist(), top.tolist()):
                lows = {p for p, b in zip(row, bit) if not b}
                assert {p + n // 2 for p in lows} == \
                    {p for p, b in zip(row, bit) if b}
            cur = fft.fft_group_outputs(cur, n, s, 1)
        assert torch.equal(cur, fft.fft_group_outputs(pts, n, s0, g))
        assert torch.equal(cur.reshape(-1).sort().values, torch.arange(n))


def test_exchange_words_are_conflict_free_at_2048():
    """fft_exchange_word is a permutation of the row, and a warp's reads at
    a group's start and its writes after every group hit 32 banks."""
    n = 2048
    pts = fft.fft_thread_points(n)
    words = fft.fft_exchange_word(torch.arange(n))
    assert torch.equal(words.sort().values, torch.arange(n))
    groups = fft.fft_groups(11)
    for s0, g in groups[:-1]:     # the last group writes y itself
        for pattern in (pts, fft.fft_group_outputs(pts, n, s0, g)):
            banks = fft.fft_exchange_word(pattern) & 31
            for w in range(0, pts.shape[0], 32):
                for c in range(pts.shape[1]):
                    assert len(set(banks[w:w + 32, c].tolist())) == 32


def _fft_input(n, rows, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    re, im = (torch.from_numpy(rng.standard_normal((rows, n))
                               .astype(np.float32)).to(dtype)
              for _ in range(2))
    wr, wi = (torch.from_numpy(t) for t in fft.twiddle_tables(n))
    return re, im, wr, wi


def _stockham_rows(re, im, wr, wi):
    outs = [fft._stockham(0, re[i:i + 1], im[i:i + 1], wr, wi)[0]
            for i in range(re.shape[0])]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


@pytest.mark.parametrize("log2n", range(0, 12))
@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stockham_grouped_equals_stockham_to_the_bit(log2n, r, dtype):
    n = 1 << log2n
    re, im, wr, wi = _fft_input(n, 2, log2n * 7 + r, dtype)
    got = fft.stockham_grouped(re, im, wr, wi, r)
    want = _stockham_rows(re, im, wr, wi)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (2, n)
        assert torch.equal(_bits(g), _bits(w))


def test_stockham_grouped_equals_the_reference_fft():
    """The group-by-group executor against the JAX package's ssr_fft,
    within the bound the stream tests hold the plain version to."""
    re, im, wr, wi = _fft_input(256, 1, 3)
    got = fft.stockham_grouped(re, im, wr, wi)
    want = jfft.ssr_fft(jnp.asarray(re.numpy()[0]), jnp.asarray(im.numpy()[0]))
    scale = float((re.abs() + im.abs()).sum())
    for g, w in zip(got, want):
        assert float(np.abs(g.numpy()[0] - np.asarray(w)).max()) / scale \
            <= 1e-6
    assert jax.devices()[0].platform == "cpu"
