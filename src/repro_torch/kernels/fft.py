"""Radix-2 Stockham FFT — paper §4.2 (2048 points).

As in ``repro.kernels.fft``: every stage reads the working vector at a
different power-of-two stride; the Stockham formulation makes each
stage's access a pure reshape, so all ``log2(n)`` stages unroll in the body
with the per-stage twiddle tables riding constant streams.  Complex data
travels as separate re/im planes.  A waivered
:class:`~repro_torch.kernels.frontend.StreamKernel`: on the CPU the Launch
runs as the block walk, on the card as K15 ``stream_fft``
(``csrc/stream_fft.cu``), the same stages and twiddles.

Leading dims of ``re``/``im`` are a batch of independent transforms (the
counterpart of ``jax.vmap(ssr_fft)``): the Launch's one grid axis walks
the rows, ``parallel``.

K15 runs a row's stages in groups of ``hopper.FFT_RADIX_LOG2`` in
registers: :func:`fft_groups` lists the groups, :func:`fft_thread_points`
each thread's points at a group's start, :func:`fft_group_outputs` where
they land after it, :func:`fft_exchange_word` the shared-memory word of a
point between groups, and :func:`stockham_grouped` runs the transform
group by group through those point sets — the plain mirror of the kernel's
schedule, equal to :func:`_stockham` to the bit.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.hopper import FFT_RADIX_LOG2
from ..core.ssr import BlockStream, KernelBody
from ..core.stream import Direction
from .frontend import (Launch, ShapeDtype, StreamKernel, promote,
                       require_power_of_two)
from .registry import KernelEntry, register_kernel


def twiddle_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-stage twiddles, padded to (stages, n//2).

    Stage s operates on sub-transforms of length nc = n >> s and needs
    m = nc/2 factors  w_p = exp(-2πi p / nc).
    """
    stages = int(math.log2(n))
    wr = np.zeros((stages, n // 2), np.float32)
    wi = np.zeros((stages, n // 2), np.float32)
    for s in range(stages):
        nc = n >> s
        m = nc // 2
        p = np.arange(m)
        wr[s, :m] = np.cos(-2 * np.pi * p / nc)
        wi[s, :m] = np.sin(-2 * np.pi * p / nc)
    return wr, wi


@functools.lru_cache(maxsize=64)
def _twiddles_on(n: int, device: torch.device) -> tuple:
    """The twiddle tables as tensors on ``device``, made once per (n,
    device): a call does not copy them from the host again."""
    return tuple(torch.from_numpy(t).to(device) for t in twiddle_tables(n))


def _prepare(re, im):
    n = re.shape[-1]
    require_power_of_two(n, "radix-2 FFT")
    if im.shape != re.shape:
        raise ValueError(f"radix-2 FFT: re {tuple(re.shape)} and im "
                         f"{tuple(im.shape)} differ")
    wr, wi = _twiddles_on(n, re.device)
    return (re.reshape(-1, n), im.reshape(-1, n), wr, wi), None, \
        tuple(re.shape)


def _stockham(i, xr_blk, xi_blk, wr, wi):
    """Every stage of one transform: per stage the (nc, s_stride) reshape,
    even outputs a + b, odd outputs (a − b)·w, written interleaved."""
    n = xr_blk.shape[1]
    xr = promote(xr_blk).reshape(n)
    xi = promote(xi_blk).reshape(n)
    s_stride, nc = 1, n
    for s in range(int(math.log2(n))):
        m = nc // 2
        Xr, Xi = xr.reshape(nc, s_stride), xi.reshape(nc, s_stride)
        ar, ai, br, bi = Xr[:m], Xi[:m], Xr[m:], Xi[m:]
        w_r, w_i = wr[s, :m].reshape(m, 1), wi[s, :m].reshape(m, 1)
        er, ei = ar + br, ai + bi
        dr, di = ar - br, ai - bi
        orr = dr * w_r - di * w_i
        oii = dr * w_i + di * w_r
        xr = torch.stack([er, orr], dim=1).reshape(nc * s_stride)
        xi = torch.stack([ei, oii], dim=1).reshape(nc * s_stride)
        nc //= 2
        s_stride *= 2
    return (xr.reshape(1, n), xi.reshape(1, n)), ()


FFT = KernelBody(_stockham, "fft")


# -- K15's schedule, mirrored ------------------------------------------------


def fft_groups(stages: int, r: int = FFT_RADIX_LOG2
               ) -> tuple[tuple[int, int], ...]:
    """K15's stage groups of a row of ``2**stages`` points: (first stage,
    stages) a group, ``r`` stages each but the last."""
    r = min(r, stages)
    return tuple((s0, min(r, stages - s0))
                 for s0 in range(0, stages, r)) if r else ()


def fft_thread_points(n: int, r: int = FFT_RADIX_LOG2) -> torch.Tensor:
    """(n >> r', 2**r') int64, r' = min(r, log2 n): the points thread t
    holds at every group's start, register c holding t + c·n/2**r' (the
    points that differ in the index's top r' bits)."""
    stages = n.bit_length() - 1
    r = min(r, stages)
    t = torch.arange(n >> r, dtype=torch.int64)[:, None]
    c = torch.arange(1 << r, dtype=torch.int64)[None, :]
    return t | (c << (stages - r))


def fft_group_outputs(points: torch.Tensor, n: int, s0: int, g: int
                      ) -> torch.Tensor:
    """Where the value at each of ``points`` lands after the ``g`` stages
    from ``s0``: stage s sends the index's top bit to bit s and moves the
    bits from s up by one, so the bits below s0 stay, the top g bits land
    reversed in s0 … s0 + g − 1 and the bits s0 … log2 n − g − 1 move up
    by g."""
    stages = n.bit_length() - 1
    out = (points & ((1 << s0) - 1)) | (
        ((points >> s0) & ((1 << (stages - g - s0)) - 1)) << (s0 + g))
    for i in range(g):
        out = out | (((points >> (stages - 1 - i)) & 1) << (s0 + i))
    return out


def fft_exchange_word(points: torch.Tensor) -> torch.Tensor:
    """K15's shared-memory word of each point between groups: bits 5–7
    XORed into the bank bits (bit 5 into bit 0, bit 6 into bits 1 and 3,
    bit 7 into bits 2 and 4), so that a warp's writes after a group from
    stage 0 or 3 and its reads at a group's start each hit 32 banks."""
    return points ^ ((points >> 5) & 7) ^ ((points >> 3) & 24)


def stockham_grouped(xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor,
                     wi: torch.Tensor, r: int = FFT_RADIX_LOG2
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The transform of every row of (xr, xi) (rows, n), f32 out, group by
    group as K15 runs it: each thread's points gathered, the group's
    stages run on them (at step j the registers differing in bit r' − 1 − j
    pair up, the twiddle ``w[s, p]`` of the lower one's butterfly, each
    operation as :func:`_stockham` rounds it), the values scattered to
    :func:`fft_group_outputs`."""
    rows, n = xr.shape
    stages = n.bit_length() - 1
    re, im = promote(xr).clone(), promote(xi).clone()
    pts = fft_thread_points(n, r)
    rr = pts.shape[1].bit_length() - 1
    for s0, g in fft_groups(stages, r):
        vr, vi = re[:, pts], im[:, pts]
        for j in range(g):
            s, hb = s0 + j, 1 << (rr - 1 - j)
            a = [c for c in range(1 << rr) if not c & hb]
            b = [c | hb for c in a]
            p = (pts[:, a] >> s0) & ((1 << (stages - 1 - s)) - 1)
            w_r, w_i = wr[s][p], wi[s][p]
            ar, ai, br, bi = vr[..., a], vi[..., a], vr[..., b], vi[..., b]
            dr, di = ar - br, ai - bi
            vr[..., a], vi[..., a] = ar + br, ai + bi
            vr[..., b] = dr * w_r - di * w_i
            vi[..., b] = dr * w_i + di * w_r
        out = fft_group_outputs(pts, n, s0, g)
        re, im = torch.empty_like(re), torch.empty_like(im)
        re[:, out], im[:, out] = vr, vi
    return re, im


def _launch(static, xr, xi, wr, wi):
    rows, n = xr.shape
    return Launch(
        grid=(rows,),
        in_streams=(
            BlockStream((1, n), lambda i: (i, 0), name="xr"),
            BlockStream((1, n), lambda i: (i, 0), name="xi"),
            BlockStream(tuple(wr.shape), lambda i: (0, 0), name="wr"),
            BlockStream(tuple(wi.shape), lambda i: (0, 0), name="wi"),
        ),
        out_streams=(
            BlockStream((1, n), lambda i: (i, 0), Direction.WRITE, name="yr"),
            BlockStream((1, n), lambda i: (i, 0), Direction.WRITE, name="yi"),
        ),
        out_shapes=(ShapeDtype((rows, n), torch.float32),
                    ShapeDtype((rows, n), torch.float32)),
        dimension_semantics=("parallel",),
    )


_ssr = StreamKernel(
    "fft", prepare=_prepare, launch=_launch, body=lambda static: FFT,
    finish=lambda out, shape: (out[0].reshape(shape), out[1].reshape(shape)),
    lowering_waiver=(
        "per-stage power-of-two strided butterflies: every stage re-walks "
        "the working vector at a different stride — word-granular AGU "
        "territory, no whole-block dense layout across stages"))


def ssr_fft(re: torch.Tensor, im: torch.Tensor, *, schedule=None,
            device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward DFT of a power-of-two length vector, split re/im; leading
    dims are a batch of transforms."""
    return _ssr(re, im, schedule=schedule, device=device)


@register_kernel("fft")
def _entry() -> KernelEntry:
    from . import ref

    def example(rng: np.random.Generator, odd: bool = False):
        n = 256 if odd else 2048   # no odd sizes: radix-2 requires 2^k
        return ((torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
                 torch.from_numpy(rng.standard_normal(n).astype(np.float32))),
                {})

    return KernelEntry(name="fft", ssr=ssr_fft, ref=ref.fft_ref,
                       example=example, tol={"rtol": 1e-3, "atol": 5e-2},
                       problem="radix-2, n=2048")
