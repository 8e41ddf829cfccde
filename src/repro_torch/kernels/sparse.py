"""CSR sparse kernels (SpMV / SpMM) on the indirection-stream path.

The port of ``repro.kernels.sparse``.  The SSR paper streams *affine* walks;
its follow-ups — Indirection-SSR (arXiv 2011.08070) and Sparse SSR (arXiv
2305.05559) — extend the AGU with an index stream feeding the address
stage, which is what CSR sparse-dense products need: the column-index stream
drives gathers from the dense operand.  As in the reference:

* the host side validates CSR (a ``ValueError`` per malformed invariant,
  the reference's messages) and packs it to ELL — ``(m, k)`` value and
  column-index planes, ``k`` the max row population — with pads ``(0.0,
  0)``; :func:`validate_csr`, :func:`csr_to_ell`, :func:`csr_to_dense` and
  :func:`random_csr` are the reference's numpy, and :func:`pack_ell` is the
  same packing on the tensors' device, with one host sync (for ``k`` and the
  checks);
* :func:`~repro_torch.core.compiler.spmv_nest` /
  :func:`~repro_torch.core.compiler.spmm_nest` declare the nests with an
  **indirect** ``MemRef`` (``index_of="cidx"``), and ``ssrify`` /
  ``lower_nest`` / ``ssr_call`` do the rest: the table rides whole after
  the streamed operands, the body sees gathered blocks, the contraction
  accumulates;
* the baselines are monolithic kernels with the explicit index handling (a
  clipped take per element) the indirection papers charge against scalar
  cores; the refs densify and multiply.

On the card the streamed kernels are K12 ``gather_spmv``
(``csrc/gather_spmv.cu``) and K13 ``gather_spmm`` (``csrc/gather_spmm.cu``),
the baselines B6 ``base_spmv`` and B7 ``base_spmm``; a schedule deeper than
2 runs their rings R13 ``ring_gather_spmv`` and R14 ``ring_gather_spmm``
(vals' and cidx's rows through shared-memory slots, the table gathered as
K12 and K13 gather it), to the sync kernels' bits.  The entry points pack
on the call's device: a CSR triple on the card is validated and packed
there.  ``k`` is a data fact, so the entry points take concrete CSR arrays
and derive it before the shape-static ``NestKernel``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device, to_device
from ..core import compiler, hopper
from ..core.ssr import KernelBody
from .frontend import MonolithicKernel, NestKernel, promote
from .registry import KernelEntry, register_kernel

# Padded row pitch of the SpMM gather table: the indirect ref's
# ``index_scale`` must be a static layout fact, so the dense operand is
# padded to a lane-aligned pitch independent of the (searched) schedule.
_TABLE_PITCH = 128


# --------------------------------------------------------------------------
# Host-side CSR validation + ELL packing (the reference's numpy)
# --------------------------------------------------------------------------


def validate_csr(data, indices, indptr, num_cols: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Check the CSR invariants; return host arrays + row count.

    Every violation raises a ``ValueError`` whose message is pinned by
    ``tests/test_sparse.py`` — these are API surface, not prose.
    """
    data = np.asarray(data)
    indices = np.asarray(indices)
    indptr = np.asarray(indptr)
    if indptr.ndim != 1 or indptr.size < 2:
        raise ValueError(
            "CSR indptr must be 1-D with at least two entries (m+1)")
    if data.ndim != 1 or indices.ndim != 1 or data.shape != indices.shape:
        raise ValueError("CSR data and indices must be 1-D of equal length")
    if np.any(np.diff(indptr) < 0):
        raise ValueError("CSR indptr must be non-decreasing")
    if indptr[0] != 0 or indptr[-1] != data.size:
        raise ValueError("CSR indptr must start at 0 and end at nnz")
    if indices.size and (indices.min() < 0 or indices.max() >= num_cols):
        raise ValueError(
            f"CSR column index out of range [0, {num_cols})")
    if indices.size > 1:
        jumps = np.diff(indices)
        same_row = np.ones(indices.size - 1, dtype=bool)
        starts = indptr[1:-1]
        starts = starts[(starts > 0) & (starts < indices.size)]
        same_row[starts - 1] = False
        if np.any(jumps[same_row] <= 0):
            raise ValueError(
                "CSR column indices must be strictly increasing within "
                "each row")
    return data, indices, indptr, indptr.size - 1


def csr_to_ell(data, indices, indptr, num_cols: int
               ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Validate + pack CSR to ELL ``(vals, cidx, m, k)`` host arrays.

    ``k`` is the max row population (≥ 1 so the nest never degenerates);
    pad slots hold ``(0.0, 0)`` — a zero-weighted gather of element 0.
    """
    data, indices, indptr, m = validate_csr(data, indices, indptr, num_cols)
    counts = np.diff(indptr)
    k = int(max(1, counts.max(initial=0)))
    vals = np.zeros((m, k), np.float32)
    cidx = np.zeros((m, k), np.int32)
    if data.size:
        rows = np.repeat(np.arange(m), counts)
        pos = np.arange(data.size) - np.repeat(indptr[:-1], counts)
        vals[rows, pos] = data
        cidx[rows, pos] = indices
    return vals, cidx, m, k


def csr_to_dense(data, indices, indptr, num_cols: int) -> np.ndarray:
    """Densify (validating) — the differential-testing oracle's input."""
    data, indices, indptr, m = validate_csr(data, indices, indptr, num_cols)
    dense = np.zeros((m, num_cols), np.float32)
    if data.size:
        counts = np.diff(indptr)
        rows = np.repeat(np.arange(m), counts)
        dense[rows, indices] = data
    return dense


def random_csr(rng, m: int, n: int, density: float
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A random CSR ``(data, indices, indptr)`` triple at ``density``."""
    mask = rng.random((m, n)) < density
    dense = np.where(mask, rng.standard_normal((m, n)), 0.0)
    indptr = np.zeros(m + 1, np.int64)
    cols, vals = [], []
    for i in range(m):
        nz = np.nonzero(dense[i])[0]
        cols.append(nz)
        vals.append(dense[i, nz])
        indptr[i + 1] = indptr[i] + nz.size
    indices = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    data = np.concatenate(vals) if vals else np.zeros(0, np.float64)
    return (data.astype(np.float32), indices.astype(np.int64), indptr)


# --------------------------------------------------------------------------
# The same validation and packing on the tensors' device
# --------------------------------------------------------------------------


def pack_ell(data: torch.Tensor, indices: torch.Tensor, indptr: torch.Tensor,
             num_cols: int) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """:func:`csr_to_ell` on the tensors' device: the same checks in the
    same order with the same messages, the same ``(vals, cidx, m, k)``.

    Every check is computed at once and read back with ``k`` in one host
    sync; the first failing one (in :func:`validate_csr`'s order) raises.
    """
    if indptr.dim() != 1 or indptr.numel() < 2:
        raise ValueError(
            "CSR indptr must be 1-D with at least two entries (m+1)")
    if data.dim() != 1 or indices.dim() != 1 or data.shape != indices.shape:
        raise ValueError("CSR data and indices must be 1-D of equal length")
    dev, nnz, m = indptr.device, data.numel(), indptr.numel() - 1
    ip, ix = indptr.to(torch.int64), indices.to(torch.int64)
    counts = ip[1:] - ip[:-1]
    false = torch.zeros((), dtype=torch.bool, device=dev)
    bad_cols = bad_order = false
    if nnz:
        bad_cols = (ix.min() < 0) | (ix.max() >= num_cols)
    if nnz > 1:
        # a pair (i, i + 1) of entries straddles a row start s = i + 1;
        # starts outside (0, nnz) are dropped, as the reference drops them
        starts = ip[1:-1]
        ok = (starts > 0) & (starts < nnz)
        straddle = torch.zeros(nnz, dtype=torch.bool, device=dev)
        straddle.scatter_(0, torch.where(ok, starts - 1, nnz - 1), ok)
        bad_order = ((ix[1:] - ix[:-1] <= 0) & ~straddle[:-1]).any()
    flags = torch.stack([(counts < 0).any(), (ip[0] != 0) | (ip[-1] != nnz),
                         bad_cols, bad_order]).to(torch.int64)
    *bad, kmax = torch.cat([flags, counts.max().reshape(1)]).tolist()
    for failed, msg in zip(bad, (
            "CSR indptr must be non-decreasing",
            "CSR indptr must start at 0 and end at nnz",
            f"CSR column index out of range [0, {num_cols})",
            "CSR column indices must be strictly increasing within each "
            "row")):
        if failed:
            raise ValueError(msg)
    k = int(max(1, kmax))
    vals = torch.zeros((m, k), dtype=torch.float32, device=dev)
    cidx = torch.zeros((m, k), dtype=torch.int32, device=dev)
    if nnz:
        rows = torch.repeat_interleave(torch.arange(m, device=dev), counts,
                                       output_size=nnz)
        pos = torch.arange(nnz, device=dev) - ip[rows]
        vals[rows, pos] = data.to(torch.float32)
        cidx[rows, pos] = indices.to(torch.int32)
    return vals, cidx, m, k


def hpcg_operator(nx: int, ny: int, nz: int, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """HPCG's 27-point operator on an nx × ny × nz grid as CSR ``(data,
    indices, indptr)``: 26.0 on the diagonal, −1.0 for each of the up to 26
    neighbours, columns increasing within a row (hpcg-benchmark.org,
    ``src/GenerateProblem_ref.cpp``).  f32 data, int32 indices, int64
    indptr, built on ``device`` (default: the CPU) without a per-row loop.
    """
    dev = torch.device(device) if device is not None else torch.device("cpu")
    rows = torch.arange(nx * ny * nz, device=dev)
    ix, iy, iz = rows % nx, (rows // nx) % ny, rows // (nx * ny)
    d = torch.arange(-1, 2, device=dev)
    # the 27 offsets in (z, y, x) order: the column order within a row
    dz, dy, dx = (t.reshape(-1) for t in torch.meshgrid(d, d, d,
                                                        indexing="ij"))
    inside = ((ix[:, None] + dx >= 0) & (ix[:, None] + dx < nx)
              & (iy[:, None] + dy >= 0) & (iy[:, None] + dy < ny)
              & (iz[:, None] + dz >= 0) & (iz[:, None] + dz < nz))
    cols = rows[:, None] + dz * nx * ny + dy * nx + dx
    diag = (dz == 0) & (dy == 0) & (dx == 0)
    data = torch.where(diag, 26.0, -1.0).to(torch.float32).expand_as(cols)
    indptr = torch.zeros(rows.numel() + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(inside.sum(1), 0)
    return (data[inside].contiguous(), cols[inside].to(torch.int32),
            indptr)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _ell(data, indices, indptr, num_cols: int, dev: torch.device
         ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """ELL planes on ``dev``: packed by :func:`csr_to_ell` for the CPU, by
    :func:`pack_ell` on the card."""
    if dev.type == "cpu":
        vals, cidx, m, k = csr_to_ell(_host(data), _host(indices),
                                      _host(indptr), num_cols)
        return torch.from_numpy(vals), torch.from_numpy(cidx), m, k
    return pack_ell(to_device(data, dev), to_device(indices, dev),
                    to_device(indptr, dev), num_cols)


def _dense_f32(x, dev: torch.device) -> torch.Tensor:
    return to_device(x, dev).to(torch.float32)


# --------------------------------------------------------------------------
# SpMV: y[m] = A_csr[m, n] · x[n]
# --------------------------------------------------------------------------


def spmv_block(vals_blk: torch.Tensor, cidx_blk: torch.Tensor,
               x_gathered: torch.Tensor) -> torch.Tensor:
    """One step's row partials: Σ_j vals·x[cidx] over the block's columns.

    cidx's block rides to the kernel anyway (it feeds the gather's
    addresses); the body consumes only vals × gathered x.
    """
    del cidx_blk
    return torch.sum(promote(vals_blk) * promote(x_gathered), dim=1)


SPMV = KernelBody(spmv_block, "spmv")


def _prepare_spmv(vals, cidx, x, m=None, k=None):
    return {"vals": vals, "cidx": cidx, "x": x}, (m, k), None


_ssr_spmv = NestKernel("spmv", prepare=_prepare_spmv,
                       nest=lambda static: compiler.spmv_nest(*static),
                       body=lambda static: SPMV)


def ssr_spmv(data, indices, indptr, x, *, schedule=None,
             device=None) -> torch.Tensor:
    """y = A·x for CSR ``A`` through the compiled indirection-stream path."""
    dev = resolve_device(device)
    x = _dense_f32(x, dev)
    vals, cidx, m, k = _ell(data, indices, indptr, int(x.shape[0]), dev)
    return _ssr_spmv(vals, cidx, x, m=m, k=k, schedule=schedule, device=dev)


# The sparse-row generalisation of gemv: identical entry point, named for
# call sites that think in dense-kernel terms (cidx = iota recovers gemv).
ssr_sparse_gemv = ssr_spmv


def _prepare_spmv_base(vals, cidx, x):
    return (vals.contiguous(), cidx.contiguous(),
            x.reshape(1, -1).contiguous()), None, None


#: The baseline body: a clipped take of x per element, then the row sums,
#: whose device kernel is ``base_spmv``.
BASE_SPMV = KernelBody(hopper.plain_base_spmv, "spmv")

_base_spmv = MonolithicKernel(
    "spmv", prepare=_prepare_spmv_base, body=lambda static: BASE_SPMV,
    out_dtype=lambda static, *arrays: torch.float32,
    finish=lambda out, _final: out[:, 0])


def baseline_spmv(data, indices, indptr, x, *, device=None) -> torch.Tensor:
    dev = resolve_device(device)
    x = _dense_f32(x, dev)
    vals, cidx, _m, _k = _ell(data, indices, indptr, int(x.shape[0]), dev)
    return _base_spmv(vals, cidx, x, device=dev)


def ref_spmv(data, indices, indptr, x) -> torch.Tensor:
    """Densified product oracle (also the ``ssrcfg``-off path)."""
    x = torch.as_tensor(x).to(torch.float32)
    dense = csr_to_dense(_host(data), _host(indices), _host(indptr),
                         int(x.shape[0]))
    return torch.matmul(torch.from_numpy(dense).to(x.device), x)


# --------------------------------------------------------------------------
# SpMM: Y[m, c] = A_csr[m, n] · X[n, c]
# --------------------------------------------------------------------------


def spmm_block(vals_blk: torch.Tensor, cidx_blk: torch.Tensor,
               x_gathered: torch.Tensor) -> torch.Tensor:
    """One step's (tile_m, tile_c) partial: the gathered block is (tile_c,
    tile_m, tile_k) — the affine column level prepends one dimension to the
    index block's (m, k) walk."""
    del cidx_blk
    return (promote(vals_blk)[None] * promote(x_gathered)).sum(-1).mT


SPMM = KernelBody(spmm_block, "spmm")


def _prepare_spmm(vals, cidx, x, m=None, k=None, pitch=None):
    c = int(x.shape[1])
    # X is the gather's table at the pitch of whole 128-lane tiles: padded
    # only where c is not one already (F.pad copies even a pad of 0)
    xp = x if pitch == c else F.pad(x, (0, pitch - c))
    return {"vals": vals, "cidx": cidx, "X": xp}, (m, c, k, pitch), None


_ssr_spmm = NestKernel("spmm", prepare=_prepare_spmm,
                       nest=lambda static: compiler.spmm_nest(*static),
                       body=lambda static: SPMM)


def ssr_spmm(data, indices, indptr, x, *, schedule=None,
             device=None) -> torch.Tensor:
    """Y = A·X for CSR ``A``, dense ``X[n, c]`` — the compiled gather path."""
    dev = resolve_device(device)
    x = _dense_f32(x, dev)
    if x.dim() != 2:
        raise ValueError(
            f"spmm needs a dense (n, c) operand, got {tuple(x.shape)}")
    vals, cidx, m, k = _ell(data, indices, indptr, int(x.shape[0]), dev)
    pitch = -(-int(x.shape[1]) // _TABLE_PITCH) * _TABLE_PITCH
    return _ssr_spmm(vals, cidx, x, m=m, k=k, pitch=pitch, schedule=schedule,
                     device=dev)


def _prepare_spmm_base(vals, cidx, x):
    return (vals.contiguous(), cidx.contiguous(), x.contiguous()), None, None


#: The baseline body: a clipped take of X's rows per element, then the
#: sums, whose device kernel is ``base_spmm``.
BASE_SPMM = KernelBody(hopper.plain_base_spmm, "spmm")

_base_spmm = MonolithicKernel(
    "spmm", prepare=_prepare_spmm_base, body=lambda static: BASE_SPMM,
    out_dtype=lambda static, *arrays: torch.float32)


def baseline_spmm(data, indices, indptr, x, *, device=None) -> torch.Tensor:
    dev = resolve_device(device)
    x = _dense_f32(x, dev)
    vals, cidx, _m, _k = _ell(data, indices, indptr, int(x.shape[0]), dev)
    return _base_spmm(vals, cidx, x, device=dev)


def ref_spmm(data, indices, indptr, x) -> torch.Tensor:
    x = torch.as_tensor(x).to(torch.float32)
    dense = csr_to_dense(_host(data), _host(indices), _host(indptr),
                         int(x.shape[0]))
    return torch.matmul(torch.from_numpy(dense).to(x.device), x)


# --------------------------------------------------------------------------
# Registry entries
# --------------------------------------------------------------------------


def _tensors(*arrays) -> tuple:
    return tuple(torch.from_numpy(a) for a in arrays)


@register_kernel("spmv")
def _entry_spmv() -> KernelEntry:
    def example(rng: np.random.Generator, odd: bool = False):
        m, n, density = (37, 53, 0.1) if odd else (32, 32, 0.25)
        data, indices, indptr = random_csr(rng, m, n, density)
        x = rng.standard_normal(n).astype(np.float32)
        return _tensors(data, indices, indptr, x), {}

    return KernelEntry(name="spmv", ssr=ssr_spmv, baseline=baseline_spmv,
                       ref=ref_spmv, example=example,
                       tol={"rtol": 1e-5, "atol": 1e-5},
                       problem="CSR 32×32 @ 25% density")


@register_kernel("spmm")
def _entry_spmm() -> KernelEntry:
    def example(rng: np.random.Generator, odd: bool = False):
        m, n, c, density = (29, 41, 17, 0.1) if odd else (32, 32, 16, 0.25)
        data, indices, indptr = random_csr(rng, m, n, density)
        x = rng.standard_normal((n, c)).astype(np.float32)
        return _tensors(data, indices, indptr, x), {}

    return KernelEntry(name="spmm", ssr=ssr_spmm, baseline=baseline_spmm,
                       ref=ref_spmm, example=example,
                       tol={"rtol": 1e-5, "atol": 1e-5},
                       problem="CSR 32×32 · 32×16 @ 25% density")
