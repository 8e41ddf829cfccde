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
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

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
