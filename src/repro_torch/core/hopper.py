"""The Hopper kernels of the port, and their plain PyTorch versions.

The streamed kernels each run one lowered SSR schedule — a grid plus the
streams' affine block walks (:class:`~repro_torch.core.agu.StreamGeometry`):

================  ===========  =============================================
kernel            call mode    body op (stage ops of a fused chain or DAG)
================  ===========  =============================================
reduce_mul        reduce       ``mul``    (reduction: Fig. 4's dot product)
map_relu          map          ``relu``   (relu)
contract_gemm     nest         ``dot``    (gemm's C += A·B)
contract_gemv     nest         ``matvec`` (gemv's y += A·x); ``matvec_relu``
                               with its relu drain (the fused gemv_relu)
chain_elem        reduce, map  K5: ``(sq_diff, identity)``, ``(axpy, mul)``
                               fused; ``sq_diff``, ``axpy`` (map) and
                               ``identity`` (reduce) alone
dag_layernorm     map          K6: ``ln_centre``, ``ln_square``,
                               ``ln_normalise`` — all three, each alone,
                               and the last two
dag_softmax_xent  reduce, map  K7: ``sx_shift``, ``sx_exp``, ``sx_loss`` —
                               the same subsets (with ``sx_loss``: reduce)
dag_mlp           map          K8: ``mlp_hidden``, ``mlp_out``,
                               ``mlp_residual`` — the same subsets
halo_stencil1d    nest         K9: ``stencil1d`` (an 11-tap window on x);
                               ``stencil1d_relu`` with its relu drain
halo_stencil2d    nest         K10: ``stencil2d`` (the 11-point star)
rescale_attention nest         K11: ``attn_scores`` (the online-softmax
                               accumulator over a head batch)
gather_spmv       nest         K12: ``spmv`` (y += vals·x[cidx], a gather;
                               on the card it reads ``pack_ell``'s (m, k)
                               planes at pitch k, no layout copy)
gather_spmm       nest         K13: ``spmm`` (Y += vals·X[cidx, c]; on the
                               card it reads ``pack_ell``'s (m, k) planes,
                               as K12)
================  ===========  =============================================

A schedule deeper than 2 makes a call of K1–K13's families pipelined
(:attr:`~repro_torch.core.ssr.SsrKernel.pipelined`): it runs the ring kernel
of :data:`RING_KERNELS` instead — R1 ``ring_reduce_mul``, R2
``ring_map_relu``, R3 ``ring_contract_gemm`` (its rings of 16-wide k
chunks filled by a producer warp on a full and an empty mbarrier a slot,
with TMA where :func:`gemm_ring_route` finds the layout allows it), R4
``ring_contract_gemv`` (with the relu drain; 8 rows of A and the x block a
step, filled by a ninth warp on mbarriers, persistent CTAs on runs of whole
output blocks, :func:`ring_run_steps`), R6
``ring_chain_elem`` (every program of K5), R7 ``ring_dag_layernorm``, R8
``ring_dag_softmax_xent`` and R9 ``ring_dag_mlp`` (every instantiation of
K6–K8; R9's ring lands its step blocks in K8's 64-row tiles), R10
``ring_halo_stencil1d`` (K9's items, with the relu drain), R11
``ring_halo_stencil2d`` (K10's windows) and R12 ``ring_rescale_attention``
(K11's K/V walk in units of 32 or 16 keys), R13 ``ring_gather_spmv`` and
R14 ``ring_gather_spmm`` (K12's and K13's rows of vals and cidx with no
CTA barrier in the step loop: R13's filled by a ninth warp of each CTA on
a full and an empty mbarrier a slot, R14's a ring a warp, each warp
filling and reading its own row; the table is never ringed, but gathered
as K12 and K13 gather it) — whose read streams arrive through an N-deep
ring of shared-memory slots filled by ``cp.async``, each stream ``depth −
1`` fetches ahead (the reference's ``_pipelined_call``), with the same
arithmetic, so the same bits, as the sync kernel.  Its plain version is
:func:`plain_ring` (:func:`ring_taken` schedules the fetches,
:func:`ring_blocks` delivers the blocks).  A
StreamKernel's scan at a depth above 2 runs R15 ``ring_stream_scan``
(:data:`STREAM_RING_KERNELS`: K14's tiles through a ring, in one pass
that reads x once, each tile's offset found from its predecessors'
published totals as K14's second pass finds it); the FFT and the sort
have a one-step grid, so they stay synchronous at any depth.

A ``ChainedKernel`` (a producer body, then a unary consumer body, on each
step of a module's Launch, one output stream) runs as K17 ``chained_map``
(:data:`CHAINED_PROGRAMS`, by the pair of body ops), or, at a uniform depth
above 2, as R5 ``ring_chained_map``; its plain version is
:func:`plain_chained`.

The waivered stream kernels run a module's :class:`~repro_torch.kernels.
frontend.Launch` instead of a lowered schedule (:data:`STREAM_KERNELS`, by
body op): K14 ``stream_scan`` (``scan``: the inclusive prefix sum in one
pass that reads x once, each tile's offset found from its predecessors'
published totals in a fixed order), K15 ``stream_fft``
(``fft``: the radix-2 Stockham stages, a row a CTA up to
:data:`FFT_SMEM_POINTS` points with :data:`FFT_RADIX_LOG2` stages at a time
in registers, as global passes above) and K16 ``stream_bitonic``
(``bitonic``: the ascending sort network in passes over
:data:`SORT_TILE`-element tiles, up to :data:`SORT_GROUP` stages a group
pass).  A leading
``parallel`` grid axis is a batch of rows (the counterpart of ``vmap``).
:func:`plain_stream` takes the ring too (``ring=``), and walks the blocks
it delivers.

A halo'd read arrives as ``2**k`` shifted streams (the lowering's
``HaloRead``); K9 and K10 (and R10, R11) read the widened block from the
first slot's walk alone.  K11 (and R12) runs the kv axis as a loop inside
each CTA.  A gather's table
arrives whole as the trailing read stream, with its address program
(:class:`~repro_torch.core.agu.GatherAGU`); K12 and K13 read only the index
block's positions that hold data, and compute addresses in 64 bits.

A fused kernel (K5–K8) is one template per family of stages, instantiated
for every subset a legal cut of its DAG can produce (:data:`_FAMILIES`): a
value whose producer runs in the subset stays on chip, any other comes
from its stream, and the subset's last stage writes its value.  Its wrapper
reads the stage program (:class:`~repro_torch.core.ssr.StageProgram`) to
find which stream carries which value.

The monolithic baselines (``MonolithicKernel``) take the padded layouts of
the reference's baseline bodies instead, and walk them with an explicit,
serialised load per block (:data:`BASELINE_KERNELS`, by body op):
``base_reduce`` (``mul``), ``base_relu`` (``relu``), ``base_gemm``
(``dot``), ``base_gemv`` (``matvec``), ``base_stencil1d``
(``stencil1d``), ``base_spmv`` (``spmv``), ``base_spmm`` (``spmm``) and
``base_scan`` (``scan``).
Each runs on the same number of
CTAs, with the same CTA tile, as its streamed counterpart, so the time of
the pair is the card's SSR-against-baseline comparison: B1 on K1's runs
(:func:`reduce_split`), B2 on K2's split (:data:`MAP_PER_SM`).

The kernels are CUDA C++ for ``sm_90a`` under ``repro_torch/csrc``, each
built by ``nvcc`` into a shared library with a plain C interface at first
use (into ``build/repro_torch/`` of the checkout, keyed on a hash of the
sources and flags) and bound with ``ctypes``.  A wrapper takes the prepared
layouts, checks what its kernel accepts and raises on anything else,
launches on PyTorch's current stream and counts the launch in
:data:`LAUNCHES`.  It never falls back to anything.

The plain versions of the streamed kernels (:func:`plain_reduce`,
:func:`plain_map`, :func:`plain_contract`, :func:`plain_rescale`,
:func:`plain_stages`) run the same lowered computation with any PyTorch
bodies: they gather every step's blocks through the same AGU programming
(widening a halo'd read's shifted blocks as the reference does), apply the
body (or the stages in order) to all steps at once (``torch.vmap``) and
apply the reference's epilogue — the vector accumulator fold, the dense map
write, the f32 contraction accumulator with its drain, the online-softmax
recurrence over the kv steps.  :func:`plain_stream` runs a stream
kernel's Launch as an in-order block walk of its body.  Those of the
baselines (``plain_base_*``) run the baseline bodies' block walks on the
same padded layouts.  The CPU runs them; the tests and ``chip_smoke.py``
hold each kernel against them.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch
import torch.nn.functional as F

from .agu import (SSR_MAX_AXES, BlockAGU, RingProgram, StreamGeometry,
                  grid_steps)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: What each kernel replaces in the JAX package (file:line), and its source.
KERNELS: Dict[str, Dict[str, str]] = {
    "reduce_mul": {"replaces": "src/repro/core/lowering.py:1259",
                   "source": "src/repro_torch/csrc/reduce_mul.cu"},
    "map_relu": {"replaces": "src/repro/core/lowering.py:1289",
                 "source": "src/repro_torch/csrc/map_relu.cu"},
    "contract_gemm": {"replaces": "src/repro/core/lowering.py:1510",
                      "source": "src/repro_torch/csrc/contract_gemm.cu"},
    "contract_gemv": {"replaces": "src/repro/kernels/gemv.py:29",
                      "source": "src/repro_torch/csrc/contract_gemv.cu"},
    "base_reduce": {"replaces": "src/repro/kernels/reduction.py:53",
                    "source": "src/repro_torch/csrc/base_reduce.cu"},
    "base_relu": {"replaces": "src/repro/kernels/relu.py:48",
                  "source": "src/repro_torch/csrc/base_relu.cu"},
    "base_gemm": {"replaces": "src/repro/kernels/gemm.py:112",
                  "source": "src/repro_torch/csrc/base_gemm.cu"},
    "base_gemv": {"replaces": "src/repro/kernels/gemv.py:62",
                  "source": "src/repro_torch/csrc/base_gemv.cu"},
    "chain_elem": {"replaces": "src/repro/core/lowering.py:1615",
                   "source": "src/repro_torch/csrc/chain_elem.cu"},
    "dag_layernorm": {"replaces": "src/repro/kernels/dag.py:88",
                      "source": "src/repro_torch/csrc/dag_layernorm.cu"},
    "dag_softmax_xent": {"replaces": "src/repro/kernels/dag.py:145",
                         "source": "src/repro_torch/csrc/dag_softmax_xent.cu"},
    "dag_mlp": {"replaces": "src/repro/kernels/dag.py:215",
                "source": "src/repro_torch/csrc/dag_mlp.cu"},
    "halo_stencil1d": {"replaces": "src/repro/kernels/stencil.py:39",
                       "source": "src/repro_torch/csrc/halo_stencil1d.cu"},
    "halo_stencil2d": {"replaces": "src/repro/kernels/stencil.py:167",
                       "source": "src/repro_torch/csrc/halo_stencil2d.cu"},
    "rescale_attention": {"replaces": "src/repro/core/lowering.py:1457",
                          "source":
                              "src/repro_torch/csrc/rescale_attention.cu"},
    "base_stencil1d": {"replaces": "src/repro/kernels/stencil.py:95",
                       "source": "src/repro_torch/csrc/base_stencil1d.cu"},
    "gather_spmv": {"replaces": "src/repro/kernels/sparse.py:134",
                    "source": "src/repro_torch/csrc/gather_spmv.cu"},
    "gather_spmm": {"replaces": "src/repro/kernels/sparse.py:215",
                    "source": "src/repro_torch/csrc/gather_spmm.cu"},
    "base_spmv": {"replaces": "src/repro/kernels/sparse.py:166",
                  "source": "src/repro_torch/csrc/base_spmv.cu"},
    "base_spmm": {"replaces": "src/repro/kernels/sparse.py:248",
                  "source": "src/repro_torch/csrc/base_spmm.cu"},
    "stream_scan": {"replaces": "src/repro/kernels/scan.py:28",
                    "source": "src/repro_torch/csrc/stream_scan.cu"},
    "stream_fft": {"replaces": "src/repro/kernels/fft.py:52",
                   "source": "src/repro_torch/csrc/stream_fft.cu"},
    "stream_bitonic": {"replaces": "src/repro/kernels/bitonic.py:29",
                       "source": "src/repro_torch/csrc/stream_bitonic.cu"},
    "base_scan": {"replaces": "src/repro/kernels/scan.py:64",
                  "source": "src/repro_torch/csrc/base_scan.cu"},
    "ring_reduce_mul": {"replaces": "src/repro/core/ssr.py:215",
                        "source": "src/repro_torch/csrc/ring_reduce_mul.cu"},
    "ring_map_relu": {"replaces": "src/repro/core/ssr.py:215",
                      "source": "src/repro_torch/csrc/ring_map_relu.cu"},
    "ring_contract_gemm": {"replaces": "src/repro/core/ssr.py:215",
                           "source":
                               "src/repro_torch/csrc/ring_contract_gemm.cu"},
    "ring_contract_gemv": {"replaces": "src/repro/core/ssr.py:215",
                           "source":
                               "src/repro_torch/csrc/ring_contract_gemv.cu"},
    "chained_map": {"replaces": "src/repro/kernels/frontend.py:465",
                    "source": "src/repro_torch/csrc/chained_map.cu"},
    "ring_chained_map": {"replaces": "src/repro/core/ssr.py:215",
                         "source": "src/repro_torch/csrc/ring_chained_map.cu"},
    "ring_chain_elem": {"replaces": "src/repro/core/ssr.py:215",
                        "source": "src/repro_torch/csrc/ring_chain_elem.cu"},
    "ring_dag_layernorm": {"replaces": "src/repro/core/ssr.py:215",
                           "source":
                               "src/repro_torch/csrc/ring_dag_layernorm.cu"},
    "ring_dag_softmax_xent": {
        "replaces": "src/repro/core/ssr.py:215",
        "source": "src/repro_torch/csrc/ring_dag_softmax_xent.cu"},
    "ring_dag_mlp": {"replaces": "src/repro/core/ssr.py:215",
                     "source": "src/repro_torch/csrc/ring_dag_mlp.cu"},
    "ring_halo_stencil1d": {"replaces": "src/repro/core/ssr.py:215",
                            "source":
                                "src/repro_torch/csrc/ring_halo_stencil1d.cu"},
    "ring_halo_stencil2d": {"replaces": "src/repro/core/ssr.py:215",
                            "source":
                                "src/repro_torch/csrc/ring_halo_stencil2d.cu"},
    "ring_rescale_attention": {
        "replaces": "src/repro/core/ssr.py:215",
        "source": "src/repro_torch/csrc/ring_rescale_attention.cu"},
    "ring_gather_spmv": {"replaces": "src/repro/core/ssr.py:215",
                         "source": "src/repro_torch/csrc/ring_gather_spmv.cu"},
    "ring_gather_spmm": {"replaces": "src/repro/core/ssr.py:215",
                         "source": "src/repro_torch/csrc/ring_gather_spmm.cu"},
    "ring_stream_scan": {"replaces": "src/repro/core/ssr.py:215",
                         "source": "src/repro_torch/csrc/ring_stream_scan.cu"},
}

#: Wrapper calls per kernel since the last :func:`reset_launches`: one per
#: call that launched its kernel.  A reduce of ``chain_elem`` or
#: ``dag_softmax_xent`` is two device launches (the per-CTA partials, then
#: the one-CTA fold); a ``reduce_mul`` or ``base_reduce`` call is one, its
#: last CTA folding the partials (:func:`reduce_split`); every other
#: kernel's call is one — except the stream kernels: a ``stream_scan`` or
#: ``base_scan`` call is one kernel, its one pass, after one memset of its
#: state; a ``stream_fft`` call one for n up to
#: FFT_SMEM_POINTS, else log2 n (one global pass a stage); a
#: ``stream_bitonic`` call one for n up to SORT_TILE, else one tile sort
#: plus, for each k = 2 SORT_TILE … n, a group pass for each SORT_GROUP
#: stages (or fewer) with j ≥ SORT_TILE and one tile merge
#: (``kernels/bitonic.py::sort_passes``: 28 at n = 2**26).  K4's relu
#: drain counts as ``contract_gemv``, K9's as ``halo_stencil1d``; a K11
#: call over a head batch is one launch, and so is a K15 or K16 call over a
#: batch of rows.
#: A pipelined call counts its ring kernel (R4's drain as
#: ``ring_contract_gemv``, R10's as ``ring_halo_stencil1d``; an R1 call, or
#: a reduce of R6 or R8, is two device launches, as K5's and K7's; an
#: R12 call over a head batch is one; a ``ring_stream_scan`` call is one
#: kernel, its one pass, after one memset of its state).  A ``chained_map``
#: or ``ring_chained_map`` call is one.
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- build and bind ---------------------------------------------------------


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "Hopper kernels are built from source at first use")


def _headers(source: Path) -> list:
    """The repo headers ``source`` includes, directly or through another."""
    seen: list = []
    todo = [source]
    while todo:
        for line in todo.pop().read_text().splitlines():
            if line.startswith('#include "'):
                h = CSRC / line.split('"')[1]
                if h not in seen:
                    seen.append(h)
                    todo.append(h)
    return sorted(seen)


def library_path(name: str) -> Path:
    """Where the built library of ``name`` lives, keyed on its inputs: its
    source, the headers it includes and the flags."""
    h = hashlib.sha256()
    source = CSRC / f"{name}.cu"
    for f in (*_headers(source), source):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel not built yet, one ``nvcc`` each,
    together.

    Returns the compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) for each kernel it compiled; raises if any compile failed.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(n))
        else:
            failed.append(n)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


class _Grid(ctypes.Structure):
    _fields_ = [("ndim", ctypes.c_int64),
                ("dims", ctypes.c_int64 * SSR_MAX_AXES)]


class _Stream(ctypes.Structure):
    _fields_ = [("offset", ctypes.c_int64 * 2),
                ("coeff", (ctypes.c_int64 * 2) * SSR_MAX_AXES),
                ("block", ctypes.c_int64 * 2),
                ("pitch", ctypes.c_int64)]


class _Ring(ctypes.Structure):
    _fields_ = [("depth", ctypes.c_int64 * 3),
                ("invariant", ctypes.c_int64 * 3)]


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_GP, _SP = ctypes.POINTER(_Grid), ctypes.POINTER(_Stream)
_RP = ctypes.POINTER(_Ring)
_SIGNATURES = {
    "reduce_mul": [_P, _P, _P, _P, _I, _I, _GP, _SP, _SP, _I64, _I64, _I64,
                   _P],
    "map_relu": [_P, _P, _I, _I, _GP, _SP, _SP, _I64, _I64, _P],
    "contract_gemm": [_P, _P, _P, _I, _I, _I, _GP, _SP, _SP, _SP, _I64, _P],
    "contract_gemv": [_P, _P, _P, _I, _I, _I, _I, _GP, _SP, _SP, _SP, _I64,
                      _I64, _I, _P],
    "base_reduce": [_P, _P, _P, _P, _I, _I, _I64, _I64, _I64, _P],
    "base_relu": [_P, _P, _I, _I, _I64, _I64, _I64, _P],
    "base_gemm": [_P, _P, _P, _I, _I, _I, _I64, _I64, _I64, _P],
    "base_gemv": [_P, _P, _P, _I, _I, _I64, _I64, _P],
    "chain_elem": [_I, _P, _P, _P, _P, ctypes.c_float, _I, _GP, _SP, _SP,
                   _SP, _SP, _P, _I64, _I64, _P],
    "dag_layernorm": [_I, _P, _P, _P, _P, _I, _GP, _SP, _SP, _SP, _SP, _I64,
                      _I64, _P],
    "dag_softmax_xent": [_I, _P, _P, _P, _P, _P, _P, _I, _GP, _SP, _SP, _SP,
                         _SP, _SP, _I64, _I64, _P],
    "dag_mlp": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _GP, _SP, _SP, _SP,
                _SP, _I64, _P],
    "halo_stencil1d": [_P, _P, _P, _I, _I, _GP, _SP, _SP, _SP, _I64, _I64,
                       _I, _P],
    "halo_stencil2d": [_P, _P, _P, _P, _I, _I, _GP, _SP, _SP, _SP, _SP, _I64,
                       _P],
    "rescale_attention": [_P, _P, _P, _P, _I, _I, _GP, _SP, _SP, _SP, _SP,
                          _I64, _I64, _P, ctypes.c_float, _I, _I64, _I64,
                          _I64, _I64, _P],
    "base_stencil1d": [_P, _P, _P, _I, _I, _I64, _I64, _I64, _P],
    "gather_spmv": [_P, _P, _P, _P, _GP, _SP, _SP, _SP] + [_I64] * 6 + [_P],
    "gather_spmm": [_P, _P, _P, _P, _GP, _SP, _SP, _SP] + [_I64] * 8 + [_P],
    "base_spmv": [_P, _P, _P, _P, _I64, _I64, _I64, _P],
    "base_spmm": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _P],
    "stream_scan": [_P, _I, _P, _P, _I64, _I64, _I64, _P],
    "base_scan": [_P, _I, _P, _P, _I64, _I64, _I64, _P],
    "stream_fft": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _P],
    "stream_bitonic": [_P, _P, _I, _I64, _I64, _P],
    "ring_reduce_mul": [_P, _P, _P, _P, _I, _I, _GP, _SP, _SP, _RP, _I64,
                        _I64, _I64, _I64, _P],
    "ring_map_relu": [_P, _P, _I, _I, _GP, _SP, _SP, _RP, _I64, _I64, _I64,
                      _P],
    "ring_contract_gemm": [_P, _P, _P, _I, _I, _I, _GP, _SP, _SP, _SP, _I64,
                           _RP, _I64, _P],
    "ring_contract_gemv": [_P, _P, _P, _I, _I, _I, _I, _GP, _SP, _SP, _SP,
                           _I64, _I64, _I, _RP, _I64, _P],
    "chained_map": [_I, _P, _P, _P, _I, _I, ctypes.c_float, _GP, _SP, _SP,
                    _SP, _I64, _I64, _P],
    "ring_chained_map": [_I, _P, _P, _P, _I, _I, ctypes.c_float, _GP, _SP,
                         _SP, _SP, _RP, _I64, _I64, _I64, _P],
    "ring_chain_elem": [_I, _P, _P, _P, _P, ctypes.c_float, _I, _GP, _SP, _SP,
                        _SP, _SP, _RP, _I64, _P, _I64, _I64, _P],
    "ring_dag_layernorm": [_I, _P, _P, _P, _P, _I, _GP, _SP, _SP, _SP, _SP,
                           _RP, _I64, _I64, _I64, _P],
    "ring_dag_softmax_xent": [_I, _P, _P, _P, _P, _P, _P, _I, _GP, _SP, _SP,
                              _SP, _SP, _SP, _RP, _I64, _I64, _I64, _P],
    "ring_dag_mlp": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _GP, _SP, _SP,
                     _SP, _SP, _RP, _I64, _I64, _I64, _P],
    "ring_halo_stencil1d": [_P, _P, _P, _I, _I, _GP, _SP, _SP, _SP, _I64,
                            _I64, _I, _RP, _I64, _P],
    "ring_halo_stencil2d": [_P, _P, _P, _P, _I, _I, _GP, _SP, _SP, _SP, _SP,
                            _RP, _I64, _P],
    "ring_rescale_attention": [_P, _P, _P, _P, _I, _I, _GP, _SP, _SP, _SP,
                               _SP, _I64, _I64, _P, ctypes.c_float, _I, _I64,
                               _I64, _I64, _RP, _I64, _I64, _P],
    "ring_gather_spmv": [_P, _P, _P, _P, _GP, _SP, _SP, _SP] + [_I64] * 8
    + [_RP, _I64, _P],
    "ring_gather_spmm": [_P, _P, _P, _P, _GP, _SP, _SP, _SP] + [_I64] * 10
    + [_RP, _I64, _P],
    "ring_stream_scan": [_P, _I, _P, _P, _I64, _I64, _I64, _RP, _I64, _P],
}
#: Arguments of a kernel's ``ssr_<name>_smem_bytes`` (none for the rest).
_SMEM_SIGNATURES = {"contract_gemm": [_I],
                    "halo_stencil1d": [_I64], "halo_stencil2d": [_I64],
                    "rescale_attention": [_I64, _I64], "stream_fft": [_I64],
                    "ring_dag_mlp": [_I64] * 4}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        try:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
        except OSError as e:
            # a kernel that cannot be built or loaded is broken, not cache
            # I/O: no fallback rung may take it for a transient OSError
            raise RuntimeError(f"{name}: cannot build or load the kernel: "
                               f"{e}") from e
        entry = getattr(lib, f"ssr_{name}")
        entry.argtypes = _SIGNATURES[name]
        entry.restype = ctypes.c_int
        smem = getattr(lib, f"ssr_{name}_smem_bytes")
        smem.argtypes = _SMEM_SIGNATURES.get(name, [])
        smem.restype = ctypes.c_int64
        lib.ssr_error_string.argtypes = [ctypes.c_int]
        lib.ssr_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


#: The kernels whose attributes entry also reads their CTAs an SM
#: (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, at the dynamic
#: shared memory it is given).
_OCCUPANCY_ATTRIBUTES = ("contract_gemm", "ring_contract_gemm", "base_gemm",
                         "ring_reduce_mul", "ring_map_relu",
                         "ring_contract_gemv", "ring_stream_scan",
                         "ring_dag_mlp")
#: The kernels whose attributes entry reads their CTAs an SM at the shared
#: memory they take themselves: K14 and B8 (static), K4 (static, one build
#: at a time), K11 (its widest tiles), K1, K2, B1 and B2 (static; their f32
#: builds in 16-byte packs), K8 (its fused f32 build in 16-byte packs), B5
#: (its static tile; f32 in 16-byte loads) and B7 (16-byte loads).
_OWN_OCCUPANCY_ATTRIBUTES = ("stream_scan", "base_scan", "contract_gemv",
                             "rescale_attention", "reduce_mul", "map_relu",
                             "base_reduce", "base_relu", "dag_mlp",
                             "base_stencil1d", "base_spmm")
#: K4's eight builds, in the order of its attributes entry: input and
#: output dtype, and A's 16-byte packs (``v4``/``v8``) or elements (``v1``).
GEMV_BUILDS = ("f32_f32_v4", "f32_f32_v1", "f32_bf16_v4", "f32_bf16_v1",
               "bf16_f32_v8", "bf16_f32_v1", "bf16_bf16_v8", "bf16_bf16_v1")


def kernel_attributes(name: str, smem: int = 0,
                      tile: Sequence[int] = (),
                      build: Optional[str] = None) -> Dict[str, int]:
    """Registers a thread (``numRegs``) and local, spilled bytes a thread
    (``localSizeBytes``) of kernel ``name`` as ``cudaFuncGetAttributes``
    reads them on the current card (the most over its instantiations): K12,
    K13, R13, R14 and R12 report them; K3, R3, B3, R1, R2, R4, R15 and R9
    also their CTAs an SM (``ctasPerSm``) at ``smem`` bytes of dynamic
    shared memory (the ring and its barriers of R3, R1, R2, R4 and R15, R9's
    weights and tiles, at their main path's instantiation; K3 and B3 take
    their own); K14, B8, K4, K11, K1, K2, B1, B2, K8, B5 and B7 at the
    shared memory they take themselves (the CTAs an SM of K1, K2, B1, B2
    and B5 are their f32 builds' in 16-byte packs, K8's its fused f32
    build's, B7's its 16-byte loads'), K11 for
    the tile of ``tile`` = (lanes, head dim)
    (:func:`rescale_attention_tiles`), K4 for one ``build`` of
    :data:`GEMV_BUILDS` (not the most over them)."""
    if (name == "contract_gemv") != (build is not None):
        raise ValueError(f"{name}: a build of GEMV_BUILDS is K4's argument "
                         f"and only K4's, got build={build!r}")
    fn = getattr(_lib(name), f"ssr_{name}_attributes")
    occupancy = name in _OCCUPANCY_ATTRIBUTES
    own = name in _OWN_OCCUPANCY_ATTRIBUTES
    args = [smem] if occupancy else [GEMV_BUILDS.index(build)] \
        if build is not None else list(tile)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int64),
                   *([ctypes.c_int64] * len(args))]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int64 * 3)()
    rc = fn(out, *args)
    if rc != 0:
        raise RuntimeError(f"{name}: cudaFuncGetAttributes failed with CUDA "
                           f"error {rc}")
    got = {"numRegs": int(out[0]), "localSizeBytes": int(out[1])}
    if occupancy or own:
        got["ctasPerSm"] = int(out[2])
    return got


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _grid_arg(grid: Sequence[int]) -> _Grid:
    if len(grid) > SSR_MAX_AXES:
        raise ValueError(f"grid {grid} has more than {SSR_MAX_AXES} axes")
    g = _Grid(len(grid))
    for k, d in enumerate(grid):
        g.dims[k] = d
    return g


def _stream_arg(agu: BlockAGU, layout: torch.Tensor) -> _Stream:
    return _stream_pitch_arg(agu, layout.shape[1])


def _stream_pitch_arg(agu: BlockAGU, pitch: int) -> _Stream:
    s = _Stream()
    s.offset[0], s.offset[1] = agu.offset
    for k, (c0, c1) in enumerate(agu.coeffs):
        s.coeff[k][0], s.coeff[k][1] = c0, c1
    s.block[0], s.block[1] = agu.block
    s.pitch = pitch
    return s


_FLOATS = (torch.float32, torch.bfloat16)


def _gemm_composes(geo: StreamGeometry) -> bool:
    (tm, tk), (tk2, tn) = geo.ins[0].block, geo.ins[1].block
    return (tk2, geo.out.block) == (tk, (tm, tn))


def _gemv_composes(geo: StreamGeometry) -> bool:
    tm, tn = geo.ins[0].block
    return (geo.ins[1].block, geo.out.block) == ((1, tn), (1, tm))


#: The window of the stencil kernels (K9, K10, B5): the 11 taps of the
#: reference's stencils (``kernels/stencil.py``'s ``TAPS``).
STENCIL_TAPS = 11
#: CTAs per SM of K9 (and of B5, on K9's split): one wave at K9's
#: occupancy.
STENCIL_PER_SM = 8
#: The lanes tiles K11 holds (the head dim padded to a multiple of 128):
#: 128 with 128-row query tiles, 256 with 64-row ones.
ATTENTION_LANES = (128, 256)


def _invariant(agu: BlockAGU, width: int) -> bool:
    """A one-row block at least ``width`` wide, the same at every step."""
    return (agu.block[0] == 1 and agu.block[1] >= width
            and not any(any(c) for c in agu.coeffs))


def _shifted_twins(geo: StreamGeometry) -> bool:
    """Every halo's slots are its first slot's walk, shifted one block on
    the levels of their bits — what the kernels take as read."""
    for h in geo.halos:
        first = geo.ins[h.slots[0]]
        for m, slot in enumerate(h.slots):
            want = list(first.offset)
            for j, ax in enumerate(h.axes):
                want[ax] += (m >> j) & 1
            a = geo.ins[slot]
            if (a.block, a.coeffs, list(a.offset)) != \
                    (first.block, first.coeffs, want):
                return False
    return True


def _halo_composes(geo: StreamGeometry, slots: Tuple[int, ...],
                   axes: Tuple[int, ...]) -> bool:
    """One windowed read on ``slots`` over block ``axes`` with the stencil
    window, its tile at least the overlap, the output block its tile, and
    the coefficient streams invariant blocks of the taps."""
    if len(geo.halos) != 1:
        return False
    h = geo.halos[0]
    x = geo.ins[h.slots[0]]
    return (h.slots == slots and h.axes == axes
            and h.windows == (STENCIL_TAPS,) * len(axes)
            and x.block == geo.out.block
            and all(x.block[a] >= STENCIL_TAPS - 1 for a in axes)
            and all(_invariant(a, STENCIL_TAPS) for a in geo.ins[len(slots):])
            and _shifted_twins(geo))


def _stencil1d_composes(geo: StreamGeometry) -> bool:
    return geo.ins[0].block[0] == 1 and _halo_composes(geo, (0, 1), (1,))


def _stencil2d_composes(geo: StreamGeometry) -> bool:
    return _halo_composes(geo, (0, 1, 2, 3), (0, 1))


def _attention_composes(geo: StreamGeometry) -> bool:
    """K, V (tk, D), Q and O (tq, D) with D a held lanes tile, one
    contraction axis (the kv walk) along which Q and O stay put."""
    if len(geo.contraction_axes) != 1 or not geo.level_tiles or geo.halos:
        return False
    (kb, vb, qb), z = (a.block for a in geo.ins), geo.contraction_axes[0]
    return (kb == vb and qb == geo.out.block
            and kb[1] == qb[1] and qb[1] in ATTENTION_LANES
            and not any(geo.ins[2].coeffs[z]) and not any(geo.out.coeffs[z]))


#: K13's columns a CTA: each lane of a warp holds four consecutive columns
#: of a SPMM_COLS-wide chunk of the c tile (grid y walks the chunks).
SPMM_COLS = 128


def _gather_composes(geo: StreamGeometry, levels: int) -> bool:
    """One gather whose index stream (slot 1) walks as the values (slot 0)
    do, its table (slot 2) one invariant block, with ``levels`` affine
    levels.  No levels (K12): the output block is (1, rows of the index
    block).  One (K13): coefficient 1 on a parallel axis, a tile of whole
    SPMM_COLS chunks, the output block (rows, tile), every address of a
    chunk 16-byte aligned (scale, offset and the table's size multiples of
    4) and a table of at least one chunk (a warp's 128 columns are tested
    against the table's ends together)."""
    if len(geo.gathers) != 1 or geo.halos or geo.level_tiles:
        return False
    g = geo.gathers[0]
    v, c, t = geo.ins
    if (g.index, g.table, len(g.grid_pos)) != (1, 2, levels) or \
            (v.block, v.coeffs, v.offset) != (c.block, c.coeffs, c.offset) \
            or any(any(x) for x in t.coeffs) or any(t.offset):
        return False
    if levels == 0:
        return geo.out.block == (1, c.block[0])
    (pos,), (tile,), (coeff,) = g.grid_pos, g.tiles, g.coeffs
    return (coeff == 1 and pos not in geo.contraction_axes
            and tile % SPMM_COLS == 0 and g.scale % 4 == 0
            and g.offset % 4 == 0 and math.prod(t.block) % 4 == 0
            and math.prod(t.block) >= SPMM_COLS
            and geo.out.block == (c.block[0], tile))


#: What each streamed kernel takes: read streams, input dtypes, and the
#: block composition it computes (as text, and as a test of the geometry).
_TAKES: Dict[str, tuple] = {
    "reduce_mul": (2, _FLOATS, "one block shape for every read stream",
                   lambda geo: len({a.block for a in geo.ins}) == 1),
    "map_relu": (1, _FLOATS + (torch.int32,), "read block = write block",
                 lambda geo: geo.ins[0].block == geo.out.block),
    "contract_gemm": (2, _FLOATS, "C += A·B", _gemm_composes),
    "contract_gemv": (2, _FLOATS, "y += A·xᵀ", _gemv_composes),
    "contract_gemv_relu": (2, _FLOATS, "y = relu(Σ A·xᵀ)", _gemv_composes),
    "halo_stencil1d": (3, _FLOATS, "y = Σ_j w[j]·x[i+j] over 11 taps, x "
                       "widened by its +1-shifted twin", _stencil1d_composes),
    "halo_stencil1d_relu": (3, _FLOATS, "y = relu(Σ_j w[j]·x[i+j])",
                            _stencil1d_composes),
    "halo_stencil2d": (6, _FLOATS, "the 11-point star over x widened by "
                       "its three shifted twins", _stencil2d_composes),
    "rescale_attention": (3, _FLOATS, "O = softmax(Q·Kᵀ)·V over the kv "
                          "walk, lanes tile 128 or 256", _attention_composes),
    "gather_spmv": (3, (torch.float32,), "y = Σ_j vals·x[scale·cidx + "
                    "offset], no affine level",
                    lambda geo: _gather_composes(geo, 0)),
    "gather_spmm": (3, (torch.float32,), "Y = Σ_j vals·X[scale·cidx + c + "
                    "offset], one affine level over whole 128-column chunks",
                    lambda geo: _gather_composes(geo, 1)),
}
#: The arguments of each kernel's shared-memory count, from its geometry
#: and input dtype.
_SMEM_ARGS: Dict[str, Callable[[StreamGeometry, torch.dtype], tuple]] = {
    "contract_gemm": lambda geo, dtype: (_DTYPE_CODE[dtype],),
    "halo_stencil1d": lambda geo, dtype: (geo.halos[0].windows[0],),
    "halo_stencil1d_relu": lambda geo, dtype: (geo.halos[0].windows[0],),
    "halo_stencil2d": lambda geo, dtype: (geo.halos[0].windows[0],),
    # the widest head dim the lanes tile holds: the most shared memory
    "rescale_attention": lambda geo, dtype: (geo.ins[0].block[1],) * 2,
}
#: The scalar parameters a kernel takes from its body (K11's mask and the
#: head dim).
_PARAMS = {"rescale_attention": 6}


def rescale_attention_tiles(dim: int, lanes: int) -> Dict[str, int]:
    """K11's tile for a head dim ``dim`` on a lanes tile of ``lanes`` (128
    or 256, the head dim padded), as ``csrc/rescale_attention.cu`` picks
    it: ``rows`` (query rows a CTA), ``live`` (the lanes it stages and
    sums: 96 for ``dim`` ≤ 96, else 128, on 128 lanes; 192 for ``dim`` ≤
    192, else 256, on 256), ``acc_lanes`` (accumulator lanes a thread:
    ``live`` over 16 column groups on 128 lanes, 32 on 256) and ``smem``
    (bytes of shared memory a CTA, counted in f32 as
    ``ssr_rescale_attention_smem_bytes`` counts them: on 128 lanes Q^T,
    the p tile and two buffers each of K, on a pitch of ``live`` + 4, and
    of V; on 256 Q and K on that pitch, V and the p tile)."""
    if not 1 <= dim <= lanes or lanes not in (128, 256):
        raise ValueError(f"rescale_attention: takes a head dim of 1 to the "
                         f"lanes tile, on 128 or 256 lanes; got {dim} on "
                         f"{lanes}")
    sub = ATTENTION_SUBTILE
    if lanes == 128:
        rows, live = 128, 96 if dim <= 96 else 128
        smem = 4 * (live * rows + sub * (rows + 4)
                    + 2 * (sub * (live + 4) + sub * live))
        return {"rows": rows, "live": live, "acc_lanes": live // 16,
                "smem": smem}
    rows, live = 64, 192 if dim <= 192 else 256
    # Q and K on a pitch of live + 4 floats, V of live, the p tile
    smem = 4 * ((rows + sub) * (live + 4) + sub * live + sub * (rows + 4))
    return {"rows": rows, "live": live, "acc_lanes": live // 32,
            "smem": smem}


def kernel_smem_bytes(name: str, *args: Union[int, torch.dtype]) -> int:
    """The shared memory a CTA of kernel ``name`` takes, as its own entry
    ``ssr_<name>_smem_bytes`` counts it from ``args`` (a dtype passed as
    its code); builds the kernel."""
    codes = [_DTYPE_CODE[a] if isinstance(a, torch.dtype) else a
             for a in args]
    return int(getattr(_lib(name), f"ssr_{name}_smem_bytes")(*codes))


def _smem_refusal(name: str, dev: torch.device, *args: int) -> Optional[str]:
    need = kernel_smem_bytes(name, *args)
    limit = _card(dev).shared_memory_per_block_optin
    if need > limit:
        return (f"{name}: a CTA needs {need} bytes of shared memory, the "
                f"card allows {limit}")
    return None


def _refusal(name: str, geo: StreamGeometry, dtype: torch.dtype,
             dev: torch.device) -> Optional[str]:
    """Why kernel ``name`` refuses this geometry at ``dtype``, or None."""
    reason = _geometry_refusal(name, geo, dtype)
    if reason is not None or dev.type != "cuda":
        return reason
    args = _SMEM_ARGS[name](geo, dtype) if name in _SMEM_ARGS else ()
    return _smem_refusal(_LIB_OF.get(name, name), dev, *args)


def _geometry_refusal(name: str, geo: StreamGeometry,
                      dtype: torch.dtype) -> Optional[str]:
    """What kernel ``name`` (or its ring kernel) refuses of the geometry at
    ``dtype``, on any device: streams, dtypes, axes, block sizes and the
    block composition."""
    n_in, dtypes, formula, composes = _TAKES[name]
    if len(geo.ins) != n_in:
        return f"{name}: takes {n_in} streams, the schedule has {len(geo.ins)}"
    if dtype not in dtypes:
        return (f"{name}: takes {[str(d) for d in dtypes]}, not {dtype}")
    if len(geo.grid) > SSR_MAX_AXES:
        return f"{name}: grid {geo.grid} has more than {SSR_MAX_AXES} axes"
    tables = {g.table for g in geo.gathers}     # addressed in 64 bits
    for k, agu in enumerate((*geo.ins, geo.out)):
        if k not in tables and math.prod(agu.block) >= 2 ** 31:
            return (f"{name}: block {agu.block} has 2**31 or more elements; "
                    "the kernels index blocks in 32 bits")
    if len(geo.out_shape) != 2:
        return f"{name}: output layout {geo.out_shape} is not 2-D"
    if not composes(geo):
        return (f"{name}: blocks {[a.block for a in geo.ins]} → "
                f"{geo.out.block} do not compose as {formula}")
    return None


# -- the rings of the pipelined kernels --------------------------------------

#: K17's producers: body op → (read streams, parameters); its consumers.
#: A program is ``producer index · 2 + consumer index`` (the order here),
#: numbered as ``csrc/ssr_chained_map.cuh`` numbers them.
CHAINED_PRODUCERS: Dict[str, Tuple[int, int]] = {
    "identity": (1, 0), "relu": (1, 0), "sq_diff": (2, 0), "axpy": (2, 1),
    "mul": (2, 0)}
CHAINED_CONSUMERS: Tuple[str, ...] = ("identity", "relu")
#: (producer op, consumer op) → K17's program number.
CHAINED_PROGRAMS: Dict[Tuple[str, str], int] = {
    (p, c): 2 * i + j for i, p in enumerate(CHAINED_PRODUCERS)
    for j, c in enumerate(CHAINED_CONSUMERS)}

#: (call mode, body op — or the tuple of stage ops of a fused chain or DAG)
#: → the ring kernel a pipelined call of that family runs on the card
#: (R1–R4; R6 for every key of K5, R7–R9 for every key of K6–K8, added
#: beside :data:`DEVICE_KERNELS`; R10–R12 for K9–K11's, R13 and R14 for
#: K12's and K13's); ``("chained", (producer op, consumer op))`` → R5 for a
#: ChainedKernel.  A StreamKernel's ring is :data:`STREAM_RING_KERNELS`'s.
RING_KERNELS: Dict[tuple, str] = {
    ("reduce", "mul"): "ring_reduce_mul",
    ("map", "relu"): "ring_map_relu",
    ("nest", "dot"): "ring_contract_gemm",
    ("nest", "matvec"): "ring_contract_gemv",
    ("nest", "matvec_relu"): "ring_contract_gemv",
    ("reduce", ("sq_diff", "identity")): "ring_chain_elem",
    ("reduce", ("axpy", "mul")): "ring_chain_elem",
    ("map", "sq_diff"): "ring_chain_elem",
    ("map", "axpy"): "ring_chain_elem",
    ("reduce", "identity"): "ring_chain_elem",
    **{("chained", pair): "ring_chained_map" for pair in CHAINED_PROGRAMS},
    ("nest", "stencil1d"): "ring_halo_stencil1d",
    ("nest", "stencil1d_relu"): "ring_halo_stencil1d",
    ("nest", "stencil2d"): "ring_halo_stencil2d",
    ("nest", "attn_scores"): "ring_rescale_attention",
    ("nest", "spmv"): "ring_gather_spmv",
    ("nest", "spmm"): "ring_gather_spmm",
}
#: R3's CTA tile (K3's): 128 x 128 outputs over 16-wide k chunks, the unit
#: of its ring; an A slot is 128 rows of 16 k and a B slot 16 rows of 128,
#: unpadded (what a TMA box lands as).
GEMM_TILE_M, GEMM_TILE_N, GEMM_CHUNK_K = 128, 128, 16
#: R4's rows a CTA (one a warp).
GEMV_RING_ROWS = 8
#: Shared memory one CTA may opt into on an H100 or H200 (what the card
#: reports as ``shared_memory_per_block_optin``): the budget of a ring, the
#: same wherever the schedule is checked.
SMEM_OPTIN_BYTES = 232448
#: K8's tile (``csrc/ssr_dag.cuh``): 64 rows on a 132-float pitch.  K8
#: stages W1 and W2 once a CTA and two tiles, multiplying one while the
#: next lands.  R9 stages the weights and the tiles its ring lands in
#: (:func:`mlp_ring_tiles`); the residual alone stages nothing, its ring's
#: slots being step blocks on the tile's pitch.
MLP_ROWS_TILE, MLP_PITCH = 64, 132
MLP_WEIGHT_BYTES = 4 * 2 * 128 * 128
MLP_TILE_BYTES = 4 * MLP_ROWS_TILE * MLP_PITCH
MLP_STAGED_BYTES = MLP_WEIGHT_BYTES + 2 * MLP_TILE_BYTES
#: K8's residual alone (an elementwise add): its CTAs an SM, 32 rows a warp
#: at a time.
MLP_RESIDUAL_PER_SM = 8
#: R10's slot: one of K9's work items, 512 outputs and their halo on a
#: 528-element stretch (``csrc/ssr_stencil1d.cuh``'s kStaged).
STENCIL1D_STAGED = 528
#: R11's slot: one of K10's windows, 42 staged rows on a 16-byte pitch: 140
#: f32 or 144 bf16 elements (``csrc/ssr_stencil2d.cuh``).
STENCIL2D_WIDE_ROWS = 42
STENCIL2D_PITCH = {torch.float32: 140, torch.bfloat16: 144}
#: R12's tiles by lanes tile D: (query rows a CTA, a K unit's (keys,
#: lanes), a V unit's keys).  A K slot is its keys on a pitch of its lanes
#: and 16 bytes — on 128 lanes 32 keys of every lane, on 256 the sub-tile's
#: 64 keys on a quarter of the lanes — and a V slot its keys of D.  Q is
#: staged once a CTA, on 128 lanes as Q^T in f32 (D × rows), on 256 as its
#: rows on a pitch of D elements and 16 bytes; the p tile (64 keys × rows +
#: 4, f32) besides the ring (``csrc/ring_rescale_attention.cu``).
ATTENTION_RING_TILES = {128: (128, (32, 128), 32), 256: (64, (64, 64), 16)}
#: Keys a rescale of m, l and acc covers (K11's and R12's sub-tile).
ATTENTION_SUBTILE = 64
#: R13's and R14's rows a CTA (K12's and K13's): a slot holds one step's
#: rows of vals (or cidx) on a pitch of :func:`gather_slot_width` elements.
SPMV_RING_ROWS, SPMM_RING_ROWS = 64, 8
#: What R1, R2, R3 and R13 keep besides their rings: a full and an empty
#: mbarrier for each of up to 8 slots of each of two streams, 8 bytes each,
#: whatever the depths (``csrc/ssr_mbarrier.cuh``).
RING_BARRIER_BYTES = 4 * 8 * 8
#: R1's warp sums besides its barriers: two sets of its 8 computing warps'
#: floats, one K1 run's and the next one's (``csrc/ssr_stage_ring.cuh``).
STAGE_SUM_BYTES = 2 * 8 * 4
#: The CTAs an SM K2's split asks for (``map_relu``, :func:`_ctas`): runs
#: of 4 steps on the relu cells, one batch of loads a thread; B2 runs on
#: it too; R2 asks for RING_MAP_PER_SM, runs of 8.
MAP_PER_SM, RING_MAP_PER_SM = 128, 64
#: The runs an SM of K1's split (``reduce_mul``), one partial each: R1
#: walks K1's runs.
REDUCE_PER_SM = 8
#: The CTAs an SM K1 is built for (``csrc/reduce_mul.cu``'s kMinCtas), each
#: walking several of its runs one after another (:func:`reduce_split`).
REDUCE_CTAS_PER_SM = 4
#: Shared memory an SM of an H100 or H200 holds for its CTAs (228 KiB), and
#: what the card keeps of it for each CTA (1 KiB): a persistent ring
#: kernel launches as many CTAs as fit an SM beside their rings, at most
#: its sync kernel's.
SMEM_SM_BYTES, SMEM_CTA_RESERVED = 233472, 1024


def mlp_ring_tiles(depth: int, rows: int) -> int:
    """The tiles R9's ring lands in at ``depth`` with step blocks of
    ``rows`` rows, ``64 // rows`` steps a tile (``ssr_dag.cuh``'s
    ``mlp_ring_tiles``): the tile being multiplied and every tile a fetch
    issued during its product reaches, its steps fetched ``depth − 1``
    ahead of the next tile's.  A block of more than 64 rows takes a tile of
    its own (and R9 refuses it: such tiles never fit)."""
    per = MLP_ROWS_TILE // rows if rows <= MLP_ROWS_TILE else 1
    return 3 + (depth - 2) // per


def mlp_split(steps: int, rows: int, sms: int,
              ring: bool = False) -> Tuple[int, int]:
    """(CTAs, steps a tile) of K8's tiled instantiations — 64-row tiles of
    the flat rows, whatever the step — or, with ``ring``, of R9 — ``64 //
    rows`` whole steps a tile (one for a block of more rows, which only the
    residual alone takes): persistent CTAs, at most one an SM, CTA b taking
    tiles b, b + CTAs, ... (:func:`mlp_tile_walk`).  K8's residual alone
    takes :data:`MLP_RESIDUAL_PER_SM` CTAs an SM instead."""
    if not ring:
        return min(-(-steps * rows // MLP_ROWS_TILE), sms), 0
    per = max(1, MLP_ROWS_TILE // rows)
    return min(-(-steps // per), sms), per


def mlp_tile_walk(steps: int, rows: int, sms: int,
                  ring: bool = False) -> List[List[Tuple[int, int]]]:
    """The rows each CTA of K8 (or R9) writes, tile by tile, as ``[start,
    stop)`` ranges of the flat rows, on :func:`mlp_split`'s split."""
    ctas, per = mlp_split(steps, rows, sms, ring)
    total = steps * rows
    span = per * rows if ring else MLP_ROWS_TILE
    tiles = -(-total // span)
    return [[(t * span, min(total, (t + 1) * span))
             for t in range(b, tiles, ctas)] for b in range(ctas)]


def mlp_ring_schedule(steps: int, rows: int, depth: int, ctas: int,
                      hook_steps: int) -> List[List[tuple]]:
    """R9's run on one of K8's tiled instantiations, CTA by CTA, as
    ``csrc/ring_dag_mlp.cu`` issues it: ``("fetch", step, tile, first
    row)`` (one commit group of every thread), ``("wait", pending)`` (the
    groups each thread lets stay in flight), ``("tile", i, tile, steps)``
    (the barrier, then the product of the CTA's i-th tile) and ``("done",
    i)``.  The first tile's steps and ``depth − 1`` beyond them are fetched
    first; a tile's product, in ``hook_steps`` steps, issues
    the fetches that the next tile's steps would, each ``depth − 1`` steps
    ahead (``hook_steps`` is ``ssr_dag.cuh``'s ``mlp_hook_steps``: one a
    product).  The tiles are :func:`mlp_ring_tiles` buffers in turn."""
    per = MLP_ROWS_TILE // rows
    nb = mlp_ring_tiles(depth, rows)
    tiles = -(-steps // per)
    out = []
    for cta in range(min(ctas, tiles)):
        mine = (tiles - 1 - cta) // ctas + 1
        n_of = [min(per, steps - (cta + i * ctas) * per) for i in range(mine)]
        run = sum(n_of)
        ev: list = []
        cur = [0, 0, 0, 0]           # issued, tile, step in it, buffer

        def fetch():
            issued, fi, fp, fb = cur
            ev.append(("fetch", (cta + fi * ctas) * per + fp, fb, fp * rows))
            cur[0] = issued + 1
            if fp + 1 == per:
                cur[1:] = [fi + 1, 0, (fb + 1) % nb]
            else:
                cur[2] = fp + 1
        end = n_of[0]
        while cur[0] < min(run, end + depth - 1):
            fetch()
        tb = 0
        for i in range(mine):
            ev.append(("wait", cur[0] - end))
            ev.append(("tile", i, tb, n_of[i]))
            base, ahead = cur[0], n_of[i + 1] if i + 1 < mine else 0
            for q in range(hook_steps):
                want = min(run, base + -(-(q + 1) * ahead // hook_steps))
                while cur[0] < want:
                    fetch()
            ev.append(("done", i))
            end += ahead
            tb = (tb + 1) % nb
        out.append(ev)
    return out


def device_ring(name: str, geo: StreamGeometry, ring: RingProgram,
                dtype: torch.dtype,
                reads: Optional[frozenset] = None) -> RingProgram:
    """``ring`` as ring kernel ``name`` allocates it: one slot per stream
    and depth, each the kernel's tile of that stream — of the streams in
    ``reads`` where given (a stage kernel fetches a value once, however
    many of its stages take it; the others get no slot).  R3's unit is the k
    chunk, which moves at every step, so no stream of it is invariant.  R5
    and R6–R8 give an invariant stream the one slot it is fetched into.
    R9's slots are step blocks on the tile's pitch; its uniforms, staged
    whole (:func:`_staged_bytes`), are never among the streams it
    ``reads``; an instantiation that reads one value (all but the residual
    alone) lands its steps in the tiles :func:`_staged_bytes` counts, so
    its slots take no bytes of their own.  R10 and R11 ring the halo's
    first slot at its depth: the
    shifted twins get no bytes, the invariant taps one slot of 11 floats;
    R12 rings K and V in the units of :data:`ATTENTION_RING_TILES`, and
    counts Q as the one tile it stages, at depth 1.  R13 and R14 ring vals
    and cidx at their depths, a slot a row group's step on the pitch of
    :func:`gather_slot_width`, and give the table 0 bytes: it is gathered
    from device memory, never copied into a slot (R13's slot barriers are
    in :func:`_staged_bytes`).  R15's slot is one of K14's tiles, the
    input's words unpadded, as one bulk copy lands them."""
    dr = _device_ring(name, geo, ring, dtype)
    if reads is None:
        return dr
    if name == "ring_dag_mlp" and len(reads) == 1:
        return RingProgram(dr.depths, dr.invariant, (0,) * len(dr.slot_bytes))
    return RingProgram(dr.depths, dr.invariant, tuple(
        b if k in reads else 0 for k, b in enumerate(dr.slot_bytes)))


def _device_ring(name: str, geo: StreamGeometry, ring: RingProgram,
                 dtype: torch.dtype) -> RingProgram:
    size = _itemsize(dtype)
    if name == "ring_dag_mlp":
        return RingProgram(ring.depths, ring.invariant,
                           tuple(a.block[0] * MLP_PITCH * size
                                 for a in geo.ins))
    if name in ("ring_chained_map", "ring_chain_elem", "ring_dag_layernorm",
                "ring_dag_softmax_xent"):
        return RingProgram(
            tuple(1 if inv else d
                  for d, inv in zip(ring.depths, ring.invariant)),
            ring.invariant, tuple(math.prod(a.block) * size for a in geo.ins))
    if name == "ring_contract_gemm":
        return RingProgram(
            ring.depths, (False, False),
            (GEMM_TILE_M * GEMM_CHUNK_K * size,
             GEMM_CHUNK_K * GEMM_TILE_N * size))
    if name == "ring_contract_gemv":
        tn = geo.ins[0].block[1]
        return RingProgram(ring.depths, ring.invariant,
                           (GEMV_RING_ROWS * tn * size, tn * size))
    if name in ("ring_halo_stencil1d", "ring_halo_stencil2d"):
        slot = STENCIL1D_STAGED * size if name == "ring_halo_stencil1d" \
            else STENCIL2D_WIDE_ROWS * STENCIL2D_PITCH[dtype] * size
        twins = set(geo.halos[0].slots[1:])
        return RingProgram(
            tuple(1 if inv else d
                  for d, inv in zip(ring.depths, ring.invariant)),
            ring.invariant,
            tuple(slot if k == 0 else 0 if k in twins
                  else STENCIL_TAPS * 4 for k in range(len(geo.ins))))
    if name == "ring_rescale_attention":
        d = geo.ins[0].block[1]
        rows, (kkeys, klanes), vkeys = ATTENTION_RING_TILES[d]
        q = d * rows * 4 if d == 128 else rows * (d + 16 // size) * size
        return RingProgram(
            (*ring.depths[:2], 1), ring.invariant,
            (kkeys * (klanes + 16 // size) * size, vkeys * d * size, q))
    if name in ("ring_gather_spmv", "ring_gather_spmm"):
        rows = SPMV_RING_ROWS if name == "ring_gather_spmv" \
            else SPMM_RING_ROWS
        slot = rows * gather_slot_width(geo) * 4     # f32 vals, int32 cidx
        return RingProgram(ring.depths, ring.invariant, (slot, slot, 0))
    if name == "ring_stream_scan":
        return RingProgram(ring.depths, ring.invariant,
                           (scan_slot_words(size) * 4,))
    return RingProgram(ring.depths, ring.invariant,
                       tuple(math.prod(a.block) * size for a in geo.ins))


def _itemsize(dtype: torch.dtype) -> int:
    return dtype.itemsize


def gather_slot_width(geo: StreamGeometry) -> int:
    """R13's and R14's slot pitch in elements: the index block's valid
    width (the gather's ``extent``, at most the block's) rounded up to 16
    bytes — 28 of 128 lanes for an ELL width of 27."""
    return min(geo.ins[1].block[1], -(-geo.gathers[0].extent[1] // 4) * 4)


def scan_slot_words(itemsize: int) -> int:
    """4-byte words of one of R15's slots: a SCAN_TILE tile of the input's
    words (one element a word in f32 or int32, two in bf16), unpadded: one
    bulk copy lands it, and the kernel reads a thread's 16 elements as
    16-byte words in a rotated order that spreads a quarter warp over the
    banks (``csrc/ring_stream_scan.cu``)."""
    return SCAN_TILE * itemsize // 4


#: What R15 keeps before its slots (``csrc/ring_stream_scan.cu``'s
#: kStagedBytes): its full and empty mbarriers (8 slots), each slot's tile
#: number, a group's totals, the carry and the offset.  Its sums are staged
#: in the tile's own slot.
SCAN_RING_STAGED_BYTES = 512
#: R15's groups (a group's totals summed in order) and chunks (the totals
#: one carry spans): the second pass's 16 totals a thread and 4096 a pass
#: of its 256 threads (:func:`scan_offsets_model`).
SCAN_GROUP, SCAN_CHUNK = 16, 4096


def scan_state_words(tiles: int) -> int:
    """The 64-bit words of one K14 or R15 call's state, zeroed by its
    entry: each tile's total, each group's sum, each chunk's carry (one
    more than the chunks) and the ticket counter
    (``ssr_stream_scan_state_words``, ``ssr_ring_stream_scan_state_words``:
    ``csrc/ssr_scan.cuh``'s ``state_words``)."""
    return tiles + -(-tiles // SCAN_GROUP) + -(-tiles // SCAN_CHUNK) + 2


# -- the scans' association, in float32 on the host ----------------------------
#
# K14 and R15 give the same bits because R15 computes each tile's offset by
# the operations of the second pass (:func:`scan_offsets_model`), from its
# predecessors alone.  These models run both in numpy float32 (IEEE single
# adds, in the kernels' order), so the CPU tests can hold them equal.

#: The threads of K14's and R15's CTA scans, and a warp's lanes.
_SCAN_THREADS, _WARP = 256, 32


def cta_exclusive_scan_model(v: np.ndarray) -> Tuple[np.ndarray, Any]:
    """``ssr_cta_exclusive_scan<256>`` in float32 on one value a thread
    (the last axis of ``v``; leading axes are independent CTAs): each
    warp's Kogge–Stone scan by shuffles (lane l adds lane l − o's value
    for o = 1, 2, … 16), its exclusive value the lane below's inclusive one
    (0 in lane 0), then the same scan over the 8 warps' totals (lanes past
    8 hold 0); each thread's exclusive value (its warp's predecessors'
    inclusive total plus its own, in warps past the first) and the CTA's
    total."""
    v = np.asarray(v, np.float32)
    lead = v.shape[:-1]
    incl = v.reshape(*lead, -1, _WARP).copy()
    warps = incl.shape[-2]
    o = 1
    while o < _WARP:
        incl[..., o:] = incl[..., o:] + incl[..., :-o]
        o *= 2
    excl = np.zeros_like(incl)
    excl[..., 1:] = incl[..., :-1]
    w = np.zeros((*lead, _WARP), np.float32)
    w[..., :warps] = incl[..., -1]
    o = 1
    while o < warps:
        w[..., o:] = w[..., o:] + w[..., :-o]
        o *= 2
    excl[..., 1:, :] = w[..., :warps - 1, None] + excl[..., 1:, :]
    total = w[..., warps - 1]
    return excl.reshape(v.shape), (np.float32(total) if not lead else total)


def _group_sums_model(v: np.ndarray) -> np.ndarray:
    """Each thread's sum of its SCAN_GROUP totals (rows of ``v``), in
    order, from 0."""
    s = np.zeros(v.shape[0], np.float32)
    for j in range(v.shape[1]):
        s = s + v[:, j]
    return s


def scan_offsets_model(totals: np.ndarray) -> np.ndarray:
    """The fixed-order second pass over the tiles' totals that K14 and B8
    ran in one CTA before each read x once, in float32: the tiles'
    ``totals`` in chunks of SCAN_CHUNK with a running carry from 0; in a
    chunk each of 256 threads sums its 16 totals in order from 0 (0 past
    the end), a CTA scan of the sums, and tile 16 t + j's offset is carry +
    (the thread's exclusive value + its first j totals, in order).  Each
    tile's exclusive offset."""
    totals = np.asarray(totals, np.float32)
    out = np.empty(len(totals), np.float32)
    carry = np.float32(0)
    for base in range(0, len(totals), SCAN_CHUNK):
        seg = totals[base:base + SCAN_CHUNK]
        v = np.zeros(SCAN_CHUNK, np.float32)
        v[:len(seg)] = seg
        v = v.reshape(_SCAN_THREADS, SCAN_GROUP)
        run, chunk = cta_exclusive_scan_model(_group_sums_model(v))
        offs = np.empty_like(v)
        for j in range(SCAN_GROUP):
            offs[:, j] = carry + run
            run = run + v[:, j]
        out[base:base + len(seg)] = offs.reshape(-1)[:len(seg)]
        carry = carry + chunk
    return out


def _group_sum_model(mates: np.ndarray, total: float) -> np.float32:
    """The sum a tile closing its group publishes: its 15 mates' totals
    and its own, in order from 0 (``Words::close``)."""
    s = np.float32(0)
    for t in (*np.asarray(mates, np.float32), np.float32(total)):
        s = np.float32(s + t)
    return s


def _chunk_group_sums(tile: int, groups: Dict[int, np.float32],
                      own: Optional[np.float32] = None) -> np.ndarray:
    """The CTA scan's input for tile ``tile``'s chunk: the chunk's group
    sums before the tile's own group (a KeyError for one not yet
    published), then ``own`` (its group's sum where it closes it) or 0."""
    chunk, pos = divmod(tile, SCAN_CHUNK)
    q = pos // SCAN_GROUP
    g = np.zeros(_SCAN_THREADS, np.float32)
    for t in range(q):
        g[t] = groups[chunk * _SCAN_THREADS + t]
    if own is not None:
        g[q] = own
    return g


def _next_carry_model(tile: int, own: np.float32,
                      groups: Dict[int, np.float32],
                      carries: Dict[int, np.float32]) -> np.float32:
    """The carry a tile closing its chunk publishes: the CTA scan's total
    over the chunk's 256 group sums (its own group's last), added to the
    chunk's carry."""
    chunk = tile // SCAN_CHUNK
    _, total = cta_exclusive_scan_model(_chunk_group_sums(tile, groups, own))
    carry = carries[chunk] if chunk else np.float32(0)
    return np.float32(carry + total)


def _offset_model(tile: int, mates: np.ndarray,
                  groups: Dict[int, np.float32],
                  carries: Dict[int, np.float32]) -> np.float32:
    """Tile ``tile``'s offset from its group ``mates``' totals, the chunk's
    earlier group sums and its carry (``Words::offset``): the group's
    exclusive value from the CTA scan, the mates added in order, then the
    carry."""
    chunk, pos = divmod(tile, SCAN_CHUNK)
    excl, _ = cta_exclusive_scan_model(_chunk_group_sums(tile, groups))
    carry = carries[chunk] if chunk else np.float32(0)
    run = excl[pos // SCAN_GROUP]
    for t in np.asarray(mates, np.float32):
        run = np.float32(run + t)
    return np.float32(carry + run)


def scan_tile_offset_model(prior: np.ndarray, total: float,
                           groups: Dict[int, np.float32],
                           carries: Dict[int, np.float32]) -> np.float32:
    """K14's and R15's offset of tile i = ``len(prior)``
    (``csrc/ssr_scan.cuh``'s ``Words``), from what tiles before i published
    and nothing else: ``prior`` their totals, ``groups`` the group sums and
    ``carries`` the chunks' carries published so far (a KeyError if one is
    read before it is).  With ``total``, the tile's own, it publishes its
    group's sum (in order from 0) where it closes the group, and the next
    chunk's carry where it closes the chunk (its scan's total over the
    chunk's 256 group sums, added to the chunk's carry) -- the kernels do
    both in the tile's sum step.  The chunk's earlier group sums go
    through the CTA scan with 0 from the tile's own group on: the exclusive
    value of its group depends on the groups before it alone."""
    i = len(prior)
    pos = i % SCAN_CHUNK
    j = pos % SCAN_GROUP
    mates = np.asarray(prior[i - j:i], np.float32)
    if j == SCAN_GROUP - 1:
        own = groups[i // SCAN_GROUP] = _group_sum_model(mates, total)
        if pos == SCAN_CHUNK - 1:
            carries[i // SCAN_CHUNK + 1] = _next_carry_model(i, own, groups,
                                                             carries)
    return _offset_model(i, mates, groups, carries)


def scan_tile_offsets_model(totals: np.ndarray) -> np.ndarray:
    """Every tile's offset as K14 and R15 find it
    (:func:`scan_tile_offset_model`, tile by tile in ticket order, each
    from its predecessors' totals)."""
    totals = np.asarray(totals, np.float32)
    groups: Dict[int, np.float32] = {}
    carries: Dict[int, np.float32] = {}
    return np.array([scan_tile_offset_model(totals[:i], totals[i], groups,
                                            carries)
                     for i in range(len(totals))], np.float32)


class ScanDeadlock(RuntimeError):
    """K14's schedule model reached a state where no CTA could move."""


def scan_schedule_model(totals: np.ndarray, ctas: int, seed: int = 0,
                        values: bool = True, stalled: Sequence[int] = (),
                        ahead: bool = True) -> Tuple[np.ndarray, dict]:
    """K14's schedule (``csrc/stream_scan.cu``) on ``ctas`` persistent CTAs,
    interleaved at random (from ``seed``), over tiles whose totals are
    ``totals``.  Each CTA takes tickets from one counter, so tiles start in
    increasing order, and holds at most two tiles: it sums its first tile
    (publishing its total, then closing its group or chunk where it closes
    one), then, per ticket B, sums B the same way, then waits for its held
    tile A's offset and writes A, and keeps B.  Without ``ahead``, B8's
    (``csrc/base_scan.cu``): a CTA holds one tile, sums it, waits for its
    offset and writes it before it takes the next ticket.  A CTA moves only
    when what it waits on is published: a closing tile waits for its group
    mates' totals (and, closing a chunk, the chunk's group sums and carry),
    an offset for its mates' totals, the chunk's earlier group sums and
    its carry.  The CTAs in ``stalled`` take one ticket and never move again,
    as a CTA that was not resident with the rest would.  Raises
    :class:`ScanDeadlock` if every unfinished CTA waits.
    Returns each tile's offset (float32, from the published values in the
    kernel's operations; NaN without ``values``) and the schedule's stats:
    ``held`` (the most tiles a CTA held), ``rounds`` (of the interleaving)
    and ``order`` (the tiles in the order their totals were published)."""
    totals = np.asarray(totals, np.float32)
    tiles = len(totals)
    pub = np.zeros(tiles, bool)
    groups: Dict[int, np.float32] = {}
    carries: Dict[int, np.float32] = {}
    offsets = np.full(tiles, np.nan, np.float32)
    counter = [0]
    stats: Dict[str, Any] = {"held": 0, "rounds": 0, "order": []}

    def take() -> Optional[int]:
        if counter[0] >= tiles:
            return None
        counter[0] += 1
        return counter[0] - 1

    def ready_totals(lo: int, hi: int) -> Callable[[], bool]:
        return lambda: bool(pub[lo:hi].all())

    def ready_chunk(tile: int) -> Callable[[], bool]:
        chunk, pos = divmod(tile, SCAN_CHUNK)
        keys = [chunk * _SCAN_THREADS + t for t in range(pos // SCAN_GROUP)]
        return lambda: all(k in groups for k in keys) and (
            chunk == 0 or chunk in carries)

    def sum_step(b: int):
        pub[b] = True                  # the total, before any wait
        stats["order"].append(b)
        pos = b % SCAN_CHUNK
        if pos % SCAN_GROUP != SCAN_GROUP - 1:
            return
        yield ready_totals(b - SCAN_GROUP + 1, b)
        own = _group_sum_model(totals[b - SCAN_GROUP + 1:b], totals[b]) \
            if values else np.float32(0)
        groups[b // SCAN_GROUP] = own
        if pos == SCAN_CHUNK - 1:
            yield ready_chunk(b)
            carries[b // SCAN_CHUNK + 1] = _next_carry_model(
                b, own, groups, carries) if values else np.float32(0)

    def offset_step(a: int):
        j = a % SCAN_GROUP
        yield ready_totals(a - j, a)
        yield ready_chunk(a)
        if values:
            offsets[a] = _offset_model(a, totals[a - j:a], groups, carries)

    def one_ahead(a: int):
        yield from sum_step(a)
        while True:
            b = take()
            if b is not None:        # A and B held
                stats["held"] = max(stats["held"], 2)
                yield from sum_step(b)
            yield from offset_step(a)
            if b is None:            # A written
                return
            a = b

    def one_at_a_time(a: Optional[int]):
        while a is not None:
            yield from sum_step(a)
            yield from offset_step(a)    # A written
            a = take()

    def cta(c: int):
        a = take()
        if a is None:
            return
        stats["held"] = max(stats["held"], 1)
        if c in stalled:
            yield lambda: False
        yield from one_ahead(a) if ahead else one_at_a_time(a)

    rng = np.random.default_rng(seed)
    gens = [cta(c) for c in range(ctas)]
    waits: List[Optional[Callable[[], bool]]] = [None] * ctas
    live = list(range(ctas))
    while live:
        stats["rounds"] += 1
        moved, still = False, []
        for c in rng.permutation(live):
            if waits[c] is not None and not waits[c]():
                still.append(c)
                continue
            moved = True
            try:
                waits[c] = next(gens[c])
                still.append(c)
            except StopIteration:
                pass
        if not moved:
            raise ScanDeadlock(f"{len(live)} CTAs wait and none can move "
                               f"({int(pub.sum())} of {tiles} totals out)")
        live = still
    return offsets, stats


def scan_model(x: np.ndarray) -> np.ndarray:
    """K14's (and R15's) inclusive prefix sum of the padded vector ``x``
    in float32 (``csrc/ssr_scan.cuh``): per SCAN_TILE tile (0 past the
    end), each of 256 threads sums its 16 elements in order from the first,
    a CTA scan of the sums gives the tile's total and each thread's
    exclusive value, and each element is the tile's offset (the fixed
    second pass over the totals, :func:`scan_offsets_model`, which the
    tiles' look-back reproduces: :func:`scan_tile_offsets_model`) + its
    running sum from that value.  The tiles run at once."""
    x = np.asarray(x, np.float32).reshape(-1)
    n = len(x)
    tiles = -(-n // SCAN_TILE)
    v = np.zeros(tiles * SCAN_TILE, np.float32)
    v[:n] = x
    v = v.reshape(tiles, _SCAN_THREADS, SCAN_GROUP)
    s = v[:, :, 0].copy()
    for j in range(1, SCAN_GROUP):
        s = s + v[:, :, j]
    run, totals = cta_exclusive_scan_model(s)
    offs = scan_offsets_model(totals)[:, None]
    out = np.empty_like(v)
    for j in range(SCAN_GROUP):
        run = run + v[:, :, j]
        out[:, :, j] = offs + run
    return out.reshape(-1)[:n]


def base_scan_schedule_model(totals: np.ndarray, per_sm: int,
                             sms: int = 132, seed: int = 0,
                             values: bool = True) -> Tuple[np.ndarray, dict]:
    """B8's schedule at ``per_sm`` CTAs an SM on ``sms`` SMs: as many
    persistent CTAs as fit (at most one a tile), each holding one tile at
    a time (:func:`scan_schedule_model` without ``ahead``)."""
    ctas = max(1, min(len(totals), per_sm * sms))
    return scan_schedule_model(totals, ctas, seed=seed, values=values,
                               ahead=False)


def base_scan_model(x: np.ndarray) -> np.ndarray:
    """B8's inclusive prefix sum of the padded vector ``x`` (a multiple of
    ROWS·LANES = 1024 elements) in float32 (``csrc/base_scan.cu``): in each
    (8, 128) block each of 256 threads sums its 4 consecutive elements in
    order from the first, and a CTA scan of the thread sums gives the
    block's total and each thread's exclusive value; a SCAN_TILE tile's
    total is 0 plus its blocks' totals in order (the blocks it has), its
    offset the fixed second pass's over the tiles' totals
    (:func:`scan_offsets_model`), and each element is the carry (the
    offset, plus the tile's earlier blocks' totals in order) + (the
    thread's exclusive value + its running sum).  The tiles run at
    once."""
    x = np.asarray(x, np.float32).reshape(-1)
    per_block, per_tile = ROWS * LANES, SCAN_TILE // (ROWS * LANES)
    blocks = len(x) // per_block
    if blocks * per_block != len(x) or not blocks:
        raise ValueError(f"base_scan_model: {len(x)} elements are not whole "
                         f"blocks of {per_block}")
    v = x.reshape(blocks, _SCAN_THREADS, per_block // _SCAN_THREADS)
    run = v.copy()
    for i in range(1, run.shape[2]):
        run[:, :, i] = run[:, :, i - 1] + v[:, :, i]
    excl, block_totals = cta_exclusive_scan_model(run[:, :, -1])
    sums = excl[:, :, None] + run
    tiles = -(-blocks // per_tile)
    first = np.arange(tiles) * per_tile          # each tile's first block
    total = np.zeros(tiles, np.float32)
    for k in range(per_tile):
        has = first + k < blocks
        total[has] = total[has] + block_totals[first[has] + k]
    carry = scan_offsets_model(total)
    out = np.empty_like(sums)
    for k in range(per_tile):
        has = first + k < blocks
        b = first[has] + k
        out[b] = carry[has][:, None, None] + sums[b]
        carry[has] = carry[has] + block_totals[b]
    return out.reshape(-1)


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """fmaf(a, b, c) of float32 arrays, rounded once as the card rounds
    it: a·b is exact in float64, the sum's error is carried by TwoSum, and
    a float64 sum that lands on a float32 tie is settled by that error's
    sign."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    r = s.astype(np.float32)
    back = r.astype(np.float64)
    with np.errstate(invalid="ignore"):
        other = np.nextafter(r, np.where(s > back, np.inf, -np.inf)
                             .astype(np.float32))
        tie = (s != back) & (2 * s == back + other.astype(np.float64)) \
            & (err != 0)
        up = tie & ((err > 0) == (other.astype(np.float64) > back))
    return np.where(up, other, r).astype(np.float32)


def _fma32_fast(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """:func:`_fma32`'s bits, its TwoSum taken only where it can matter:
    the float64 sum's float32 rounding is the exact value's unless that sum
    lies on a float32 midpoint (of the 29 significand bits float32 drops,
    the first set and the rest clear) or under float32's normal range."""
    a, b, c = np.broadcast_arrays(a, b, c)
    s = a.astype(np.float64) * b + c
    r = s.astype(np.float32)
    low = s.view(np.uint64) & np.uint64(0x1FFFFFFF)
    slow = (low == np.uint64(0x10000000)) | (np.abs(s) < 2.0 ** -125)
    if slow.any():
        at = np.nonzero(slow)
        r[at] = _fma32(a[at], b[at], c[at])
    return r


def _warp_butterfly(v: np.ndarray) -> np.ndarray:
    """Each lane of the warps in the last axis (32 lanes) after the
    butterfly ``v += shfl_xor(v, o)`` for o = 16, 8, 4, 2, 1, float32."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lane ^ o]).astype(np.float32)
    return v


def cta_sum_model(v: np.ndarray) -> np.ndarray:
    """``ssr_cta_sum<THREADS>`` over the last axis of ``v`` (THREADS
    float32 values, a multiple of 32, at most 1,024), as thread 0 gets it:
    each warp's butterfly, then warp 0's over the warp sums (its other
    lanes 0)."""
    v = np.asarray(v, np.float32)
    threads = v.shape[-1]
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"a CTA of {threads} threads: a multiple of 32, "
                         "at most 1,024")
    warps = _warp_butterfly(v.reshape(*v.shape[:-1], threads // 32, 32))
    lanes = np.zeros((*v.shape[:-1], 32), np.float32)
    lanes[..., :threads // 32] = warps[..., 0]
    return _warp_butterfly(lanes)[..., 0]


#: Threads of a K1 CTA, and the lanes of the fold over its partials
#: (``csrc/reduce_mul.cu``, ``csrc/ssr_run.cuh``'s kFoldLanes).
REDUCE_THREADS, FOLD_LANES = 256, 1024


def reduce_mul_model(a: np.ndarray, b: np.ndarray, steps_per_run: int,
                     runs: int, vec: int = 4,
                     block: Tuple[int, int] = (8, 128)) -> np.float32:
    """K1's Σ a·b with K1's bits, in numpy float32 (B1's too, at the packs
    B1 reads, on K1's runs: ``csrc/base_reduce.cu``).  ``a`` and ``b`` hold
    the streams' blocks in grid-step order, each block's elements row-major
    (the flat (rows, 128) layouts of a vector's dot), promoted to float32;
    ``vec`` elements a pack (4 for f32 and 8 for bf16 in 16-byte packs, else
    1).  The association: thread t of a 256-thread CTA takes the packs t, t
    + 256, ... of each step's block (SsrBlockWalk's order) and accumulates
    each pack's products element by element with one rounding each (an
    FMA), step by step through its run of ``steps_per_run`` steps; the run's
    partial is ``ssr_cta_sum<256>`` of its threads; the fold gives lane L
    of 1,024 the partials L, L + 1,024, ... in order and sums the lanes by
    ``ssr_cta_sum<1024>``.  ``runs`` must be K1's (the steps over
    ``steps_per_run``)."""
    size = block[0] * block[1]
    a = np.asarray(a, np.float32).reshape(-1)
    b = np.asarray(b, np.float32).reshape(-1)
    if a.size != b.size or a.size % size or size % vec:
        raise ValueError(f"reduce_mul_model: two streams of whole {block} "
                         f"blocks of {vec}-element packs, got {a.size} and "
                         f"{b.size} elements")
    steps, packs = a.size // size, size // vec
    if runs != -(-steps // steps_per_run):
        raise ValueError(f"reduce_mul_model: {steps} steps in runs of "
                         f"{steps_per_run} are not {runs} runs")
    cells = -(-packs // REDUCE_THREADS)
    per = steps_per_run

    def walk(x: np.ndarray) -> np.ndarray:
        """(runs, step of the run, cell of a thread, thread, element)."""
        out = np.zeros((runs * per, cells * REDUCE_THREADS, vec), np.float32)
        out[:steps, :packs] = x.reshape(steps, packs, vec)
        return out.reshape(runs, per, cells, REDUCE_THREADS, vec)

    wa, wb = walk(a), walk(b)
    valid = np.zeros((runs * per, cells * REDUCE_THREADS), bool)
    valid[:steps, :packs] = True
    valid = valid.reshape(runs, per, cells, REDUCE_THREADS)
    acc = np.zeros((runs, REDUCE_THREADS), np.float32)
    for s in range(per):
        for c in range(cells):
            live = valid[:, s, c]
            for j in range(vec):
                acc = np.where(live, _fma32(wa[:, s, c, :, j],
                                            wb[:, s, c, :, j], acc), acc)
    partials = cta_sum_model(acc)
    lanes = np.zeros(FOLD_LANES, np.float32)
    for i in range(0, runs, FOLD_LANES):
        row = partials[i:i + FOLD_LANES]
        lanes[:row.size] = (lanes[:row.size] + row).astype(np.float32)
    return np.float32(cta_sum_model(lanes))


#: Elements of the output the baselines' models compute a chunk, the
#: chunks on the host's cores at once (numpy's loops release the GIL).
_MODEL_CHUNK = 1 << 20


def _in_chunks(total: int, chunk: int, fn: Callable[[int, int], None]
               ) -> None:
    """``fn(lo, hi)`` over [0, total) in chunks of ``chunk``, in threads."""
    bounds = [(lo, min(total, lo + chunk)) for lo in range(0, total, chunk)]
    workers = min(len(bounds), os.cpu_count() or 1)
    if workers <= 1:
        for lo, hi in bounds:
            fn(lo, hi)
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(lambda b: fn(*b), bounds))


def base_stencil1d_model(x: np.ndarray, w: np.ndarray,
                         rounded_tap: int = 1) -> np.ndarray:
    """B5's y (n,) with B5's bits, in numpy float32: x holds n + 10
    elements (bf16 promoted to float32), w the 11 f32 taps.  Each output:
    tap ``rounded_tap``'s product (0 or 1) rounded alone, the other of the
    first two taps fused onto it by one FMA, then taps 2 .. 10 each by one
    FMA in tap order.  B5 computes ``rounded_tap = 1``: fmaf(w0, x0,
    w1·x1), as nvcc contracted the parent's acc = w0·x0; acc + w1·x1."""
    x = np.asarray(x, np.float32).reshape(-1)
    w = np.asarray(w, np.float32).reshape(-1)
    taps = w.size
    n = x.size - (taps - 1)
    if taps != STENCIL_TAPS or n < 1 or rounded_tap not in (0, 1):
        raise ValueError(f"base_stencil1d_model: x of n + {STENCIL_TAPS - 1}"
                         f" elements, {STENCIL_TAPS} taps and rounded_tap 0 "
                         f"or 1, got {x.size}, {taps} and {rounded_tap}")
    fused = 1 - rounded_tap
    y = np.empty(n, np.float32)

    def chunk(i0: int, i1: int) -> None:
        def tap(j):
            return x[i0 + j:i1 + j]
        acc = (w[rounded_tap] * tap(rounded_tap)).astype(np.float32)
        acc = _fma32_fast(w[fused], tap(fused), acc)
        for j in range(2, taps):
            acc = _fma32_fast(w[j], tap(j), acc)
        y[i0:i1] = acc
    _in_chunks(n, _MODEL_CHUNK, chunk)
    return y


def base_spmm_model(vals: np.ndarray, cidx: np.ndarray,
                    x: np.ndarray) -> np.ndarray:
    """B7's out (m, c) with B7's bits, in numpy float32: each output is the
    chain acc = fmaf(vals[i, j], X[clip(cidx[i, j]), col], acc) over j = 0
    .. k − 1 from 0, pads included, each FMA rounded once, the columns
    independent (so the same at either load width)."""
    vals = np.asarray(vals, np.float32)
    cidx = np.asarray(cidx)
    x = np.asarray(x, np.float32)
    if vals.ndim != 2 or vals.shape != cidx.shape or x.ndim != 2 \
            or x.shape[0] < 1:
        raise ValueError(f"base_spmm_model: vals and cidx (m, k) and X "
                         f"(n, c), got {vals.shape}, {cidx.shape} and "
                         f"{x.shape}")
    m, k = vals.shape
    c = x.shape[1]
    rows = np.clip(cidx.astype(np.int64), 0, x.shape[0] - 1)
    out = np.empty((m, c), np.float32)

    def chunk(r0: int, r1: int) -> None:
        acc = np.zeros((r1 - r0, c), np.float32)
        for j in range(k):
            acc = _fma32_fast(vals[r0:r1, j:j + 1], x[rows[r0:r1, j]], acc)
        out[r0:r1] = acc
    _in_chunks(m, max(1, _MODEL_CHUNK // max(1, c)), chunk)
    return out


def _ctas_per_sm(smem: int, most: int) -> int:
    """CTAs of a kernel taking ``smem`` bytes of shared memory that fit an
    SM, at most ``most``."""
    return max(1, min(most, SMEM_SM_BYTES // (smem + SMEM_CTA_RESERVED)))


#: The most CTAs an SM of R13 (288 threads: 56 registers a thread where
#: four fit beside their rings, else 75 and eight gathers a thread in
#: flight), R14 (256 threads, 80 registers) and R1 (288 threads, built for
#: five CTAs an SM at 40 registers a thread).
_RING_PER_SM = {"ring_gather_spmv": 4, "ring_gather_spmm": 3,
                "ring_reduce_mul": 5}
#: The most CTAs an SM of R4 (288 threads), by input dtype: its bf16 bulk
#: route is built for 4 (at most 56 registers a thread), whose steps are
#: half f32's and need the CTAs; f32 and the element routes for 3 (72).
GEMV_RING_PER_SM = {torch.float32: 3, torch.bfloat16: 4}
#: R4's split (:func:`_gemv_runs`), fitted to the splits measured on an
#: H100 (``tools/gemv_spmv_ablation.py``, the 8192² gemv cell): a
#: persistent CTA's step of 8 rows takes about GEMV_STEP_US whatever its
#: ring's depth (0.83–0.88 µs at one CTA an SM, up to 1.3 at two in bf16;
#: 1.2 picks the fastest one-wave split at every depth there), and the
#: card streams at most GEMV_CARD_BYTES_PER_US of A (2.8 TB/s, K4's and
#: R4's best).  Only one-wave splits are weighed: K4's split (one output
#: block a CTA, in waves) led them by 1.7 % on the mean at f32 depth 4
#: over thirteen runs (tied in some) but lost by 1–5 % at (2, 4) and
#: (4, 2), at the same split and CTAs an SM, by 11–14 % at depth 8 and by
#: 1–7 % in bf16.
GEMV_STEP_US = 1.2
GEMV_CARD_BYTES_PER_US = 2.8e6


def _k_split(steps: int, ctas: int) -> Tuple[int, int]:
    """(runs, steps a run): ``steps`` in runs of consecutive steps over at
    most ``ctas`` CTAs, as the sync kernels split them."""
    per = -(-steps // min(steps, ctas))
    return -(-steps // per), per


def _fewest_on_an_sm(units: int, per_sm: int, sms: int) -> int:
    """The units of work a persistent CTA walks when ``units`` are spread
    over at most ``per_sm`` CTAs on each of ``sms`` SMs, the CTAs dealt out
    evenly: of the splits into ``c`` CTAs an SM, the one whose busiest SM
    walks the fewest units (the smaller run, so the more CTAs, where two
    tie)."""
    def busiest(per: int) -> Tuple[int, int]:
        ctas = -(-units // per)
        return -(-ctas // sms) * per, per
    return min((-(-units // (c * sms)) for c in range(1, per_sm + 1)),
               key=busiest)


def reduce_split(steps: int, sms: int) -> Tuple[int, int, int, int]:
    """(runs, steps a run, runs a CTA, CTAs) of K1 on a card of ``sms``
    SMs.  The runs are K1's partials, ``_k_split(steps, REDUCE_PER_SM ·
    sms)`` (R1 walks the same runs, so their sums are K1's bits); a CTA
    walks a run of them one after another at :data:`REDUCE_CTAS_PER_SM`
    CTAs an SM, all in one wave: of those splits, the one whose busiest SM
    walks the fewest runs (:func:`_fewest_on_an_sm`)."""
    runs, per = _k_split(steps, REDUCE_PER_SM * sms)
    k = _fewest_on_an_sm(runs, REDUCE_CTAS_PER_SM, sms)
    return runs, per, k, -(-runs // k)


def _gemv_runs(groups: int, blocks: int, z: int, step_bytes: int,
               per_sm: int, sms: int) -> int:
    """The output blocks (of ``z`` steps of ``step_bytes``) a persistent
    CTA of R4 walks when each of ``groups`` row groups cuts its ``blocks``
    into runs of one length, one run a CTA: of the lengths that keep every
    CTA in one wave at ``per_sm`` CTAs on each of ``sms`` SMs, the one
    whose busiest SM, the CTAs dealt out evenly, takes the least time --
    the longer of its bytes at the card's rate shared out by SM and its
    busiest CTA's steps at :data:`GEMV_STEP_US` each (the shorter run, so
    the more CTAs, where two tie); all of a group's blocks where no length
    fits one wave."""
    sm_rate = GEMV_CARD_BYTES_PER_US / sms

    def cost(per: int) -> Tuple[float, int]:
        ctas = groups * -(-blocks // per)
        steps = -(-ctas // sms) * per * z       # the busiest SM's
        return max(steps * step_bytes / sm_rate, per * z * GEMV_STEP_US), per
    runs = range(1, min(blocks, per_sm * sms // groups) + 1)
    return min((-(-blocks // r) for r in runs), key=cost, default=blocks)


#: K4's rows a CTA (its row group: 8 warps of four rows) and the CTAs an
#: SM every build of it is built for (``csrc/contract_gemv.cu``'s
#: kRowsPerCta and kMinCtas).
GEMV_ROWS = 32
GEMV_PER_SM = 2


def gemv_split(geo: StreamGeometry, sms: int) -> Tuple[int, int]:
    """(units a CTA, CTAs) of K4 on a card of ``sms`` SMs.  A unit is a
    GEMV_ROWS-row group of one output block; the units run in grid order,
    output block by output block and row group by row group within one,
    and CTA c walks units [c·per, (c + 1)·per).  Of the runs that keep
    every CTA in one wave at ``GEMV_PER_SM`` CTAs an SM, the one
    whose busiest SM, the CTAs dealt out evenly, walks the fewest units
    (the shorter run where two tie; :func:`_fewest_on_an_sm`)."""
    groups = -(-geo.ins[0].block[0] // GEMV_ROWS)
    units = geo.steps // geo.contraction_steps * groups
    per = _fewest_on_an_sm(units, GEMV_PER_SM, sms)
    return per, -(-units // per)


def gemv_walk(geo: StreamGeometry, per: int
              ) -> List[List[Tuple[int, int, int, Tuple[int, ...]]]]:
    """K4's walk on ``per`` units a CTA, as its CTAs run it: for each CTA
    its units in order, each as (output block, first row, end row, the
    grid steps it reads, in order)."""
    z, tm = geo.contraction_steps, geo.ins[0].block[0]
    groups = -(-tm // GEMV_ROWS)
    units = geo.steps // z * groups
    walk = []
    for c in range(-(-units // per)):
        run = []
        for u in range(c * per, min(units, (c + 1) * per)):
            p, g = divmod(u, groups)
            run.append((p, g * GEMV_ROWS, min(tm, (g + 1) * GEMV_ROWS),
                        tuple(range(p * z, (p + 1) * z))))
        walk.append(run)
    return walk


@functools.lru_cache(maxsize=256)
def ring_run_steps(rname: str, geo: StreamGeometry, ring: RingProgram,
                   dtype: torch.dtype, sms: int) -> int:
    """The grid steps a CTA of the persistent ring kernel ``rname`` (R1,
    R4, R13, R14 or R15) walks, consecutive, on a card of ``sms`` SMs:
    whole runs of K1's split (R1: its partials are K1's) or the output
    blocks (R4, R13, R14: whole ones, of ``contraction_steps`` steps each)
    spread over as many CTAs as fit the SMs beside their rings; R15 walks
    one SCAN_TILE tile (four of the Launch's (8, 128) blocks) at a time:
    each CTA takes its next tile by a ticket, the tiles handed out in
    increasing order, so a tile is a run of its own.  R1's runs
    are coarse (K1's 8 CTAs an SM), so it takes, of the splits into 1 to
    that many CTAs an SM, the one whose busiest SM walks the fewest runs;
    R4 takes, for each of its 8-row groups, the run of output blocks whose
    busiest SM takes the least time (:func:`_gemv_runs`); R13 and R14
    give each row group (and R14's column chunk) the same number of runs,
    as many as fit that count.  So no CTA waits for a second wave.  The
    wrapper launches that split; the plain ring takes it as
    ``steps_per_cta``.  Memoized: a wrapper asks at every call."""
    if rname == "ring_stream_scan":
        return SCAN_TILE // (ROWS * LANES)
    dr = device_ring(rname, geo, ring, dtype)
    smem = dr.ring_bytes + _staged_bytes(rname, (), geo)
    most = GEMV_RING_PER_SM[dtype] if rname == "ring_contract_gemv" \
        else _RING_PER_SM[rname]
    per_sm = _ctas_per_sm(smem, most)
    ctas = per_sm * sms
    if rname == "ring_reduce_mul":
        runs, per = _k_split(geo.steps, REDUCE_PER_SM * sms)
        return _fewest_on_an_sm(runs, per_sm, sms) * per
    if rname == "ring_contract_gemv":
        z = geo.contraction_steps
        groups = -(-geo.ins[0].block[0] // GEMV_RING_ROWS)
        step = (GEMV_RING_ROWS + 1) * geo.ins[0].block[1] * _itemsize(dtype)
        return _gemv_runs(groups, geo.steps // z, z, step, per_sm, sms) * z
    z = geo.contraction_steps
    blocks = geo.steps // z
    rows = SPMV_RING_ROWS if rname == "ring_gather_spmv" else SPMM_RING_ROWS
    groups = -(-geo.ins[1].block[0] // rows)
    if rname == "ring_gather_spmm":
        groups *= geo.gathers[0].tiles[0] // SPMM_COLS
    runs = min(blocks, max(1, ctas // groups))
    return -(-blocks // runs) * z


def _ring_refusal(op: tuple, name: str, geo: StreamGeometry,
                  dtype: torch.dtype, ring: RingProgram,
                  reason: Optional[str] = None,
                  reads: Optional[frozenset] = None) -> Optional[str]:
    """Why the ring kernel of ``op`` refuses this pipelined call: what the
    sync kernel ``name`` refuses of the geometry (for a stage kernel, its
    ``reason`` and the streams it ``reads``), then what
    :func:`_ring_budget_refusal` refuses of the ring: its streams, its
    bytes over the shared memory a CTA may opt into
    (:data:`SMEM_OPTIN_BYTES`), a depth outside 2 to 8."""
    rname = RING_KERNELS[op]
    if name in _TAKES:
        reason = _geometry_refusal(name, geo, dtype)
    if reason is not None:
        return reason.replace(f"{name}:", f"{rname}:", 1)
    ops = op[1] if isinstance(op[1], tuple) else (op[1],)
    return _ring_budget_refusal(rname, geo, dtype, ring,
                                _staged_bytes(rname, ops, geo, ring), reads)


def _staged_bytes(rname: str, ops: Sequence[str], geo: StreamGeometry,
                  ring: Optional[RingProgram] = None) -> int:
    """The shared memory ring kernel ``rname`` takes besides its ring,
    running the stage ``ops``: R9 stages K8's weights and, at the depth of
    ``ring``'s first stream (x or H), the :func:`mlp_ring_tiles` tiles its
    ring lands in, but for the residual alone; R12 its p tile (Q is in its
    ring, one tile); R3 and R13 their slots' barriers; R2 and R4 their
    slots' barriers and R1 those and its warp sums; R15 its barriers, slot
    numbers and group sums (:data:`SCAN_RING_STAGED_BYTES`); the others
    nothing."""
    if rname == "ring_dag_mlp" and tuple(ops) != ("mlp_residual",):
        rows = geo.out.block[0]
        return MLP_WEIGHT_BYTES + mlp_ring_tiles(ring.depths[0], rows) * \
            max(MLP_ROWS_TILE, rows) * MLP_PITCH * 4
    if rname in ("ring_contract_gemm", "ring_gather_spmv", "ring_map_relu",
                 "ring_contract_gemv"):
        return RING_BARRIER_BYTES
    if rname == "ring_reduce_mul":
        return RING_BARRIER_BYTES + STAGE_SUM_BYTES
    if rname == "ring_rescale_attention":
        rows = ATTENTION_RING_TILES[geo.ins[0].block[1]][0]
        return 4 * ATTENTION_SUBTILE * (rows + 4)
    if rname == "ring_stream_scan":
        return SCAN_RING_STAGED_BYTES
    return 0


#: What a ring kernel's staged bytes hold, for its refusal.
_STAGED_WHAT = {"ring_dag_mlp": "its staged weights and the tiles its ring "
                                "lands in",
                "ring_rescale_attention": "its p tile",
                "ring_contract_gemm": "its slots' barriers",
                "ring_gather_spmv": "its slots' barriers",
                "ring_map_relu": "its slots' barriers",
                "ring_contract_gemv": "its slots' barriers",
                "ring_reduce_mul": "its slots' barriers and warp sums",
                "ring_stream_scan": "its barriers and sums"}


def _ring_budget_refusal(rname: str, geo: StreamGeometry, dtype: torch.dtype,
                         ring: RingProgram, staged: int = 0,
                         reads: Optional[frozenset] = None) -> Optional[str]:
    """A ring of another stream count than the read streams; one that,
    with the ``staged`` bytes the kernel takes besides it, is over the
    shared memory a CTA may opt into, as ring kernel ``rname`` sizes it
    (:func:`device_ring`, over the streams it ``reads``); or one with a
    stream's depth outside the 2 to ``MAX_BUFFER_DEPTH`` slots every ring
    kernel takes (R1's, R2's, R3's and R13's barriers are for 8 slots a
    stream).
    Every ring kernel's refusal ends here, through :func:`accepts` and in
    its wrapper."""
    from .ssr import DEFAULT_BUFFER_DEPTH, MAX_BUFFER_DEPTH
    if len(ring.depths) != len(geo.ins):
        return (f"{rname}: a ring of {len(ring.depths)} streams for "
                f"{len(geo.ins)} read streams")
    need = device_ring(rname, geo, ring, dtype, reads).ring_bytes + staged
    if need > SMEM_OPTIN_BYTES:
        also = f" ({staged} of them {_STAGED_WHAT[rname]})" if staged else ""
        return (f"{rname}: its ring at depths {ring.depths} needs {need} "
                f"bytes of shared memory a CTA{also}, the card allows "
                f"{SMEM_OPTIN_BYTES}")
    if not all(DEFAULT_BUFFER_DEPTH <= d <= MAX_BUFFER_DEPTH
               for d in ring.depths):
        return (f"{rname}: its ring at depths {ring.depths} has a stream "
                f"outside the {DEFAULT_BUFFER_DEPTH} to {MAX_BUFFER_DEPTH} "
                "slots it takes")
    return None


#: Wrappers that launch another wrapper's library.
_LIB_OF = {"contract_gemv_relu": "contract_gemv",
           "halo_stencil1d_relu": "halo_stencil1d"}


def accepts(op: tuple, geo: StreamGeometry, dtype: torch.dtype,
            device: Union[str, torch.device],
            program: Optional[Any] = None,
            ring: Optional[RingProgram] = None) -> Tuple[bool, str]:
    """(takes, reason): whether the streamed kernel of ``op`` — a (call
    mode, body op or tuple of stage ops) pair of :data:`DEVICE_KERNELS`, or
    ``("chained", (producer op, consumer op))`` for K17 on a Launch's
    geometry (:func:`chained_geometry`) — takes this geometry at this input
    dtype on ``device``, running
    ``program`` (a :class:`~repro_torch.core.ssr.StageProgram`; the stage
    kernels need it).  With ``ring`` (a pipelined call) it is the ring
    kernel of :data:`RING_KERNELS` that must take it, its ring within the
    shared memory a CTA may opt into.  The wrappers refuse exactly what
    this refuses; the autotuners filter their candidates with it.  On a
    CUDA device the sync kernels' shared-memory check builds the kernel."""
    if op and op[0] == "chained":
        reason = _chained_refusal(op[1], geo, dtype, dtype, ring)
        return reason is None, reason or "ok"
    kernel = DEVICE_KERNELS.get(op)
    if kernel is None:
        return False, f"no Hopper kernel for {op}"
    name, dev = kernel.__name__, torch.device(device)
    if ring is not None:
        if op not in RING_KERNELS:
            return False, f"no Hopper ring kernel for {op}"
        if name in _TAKES:
            reason = _program_refusal(name, program) or \
                _ring_refusal(op, name, geo, dtype, ring)
        else:
            reason = _stage_refusal(name, program, geo, dtype, dev)
            reason = _ring_refusal(op, name, geo, dtype, ring, reason, None
                                   if reason else _stage_reads(name, program))
    elif name in _TAKES:
        reason = _program_refusal(name, program) or \
            _refusal(name, geo, dtype, dev)
    else:
        reason = _stage_refusal(name, program, geo, dtype, dev)
    return reason is None, reason or "ok"


def _program_refusal(name: str, program: Optional[Any]) -> Optional[str]:
    """A single-op kernel runs one body over its streams in order, with no
    permutation or uniforms, and with the parameters it takes (none but
    K11's mask)."""
    if program is None:
        return None
    want = _PARAMS.get(name, 0)
    if want and len(program.ops) == 1 and not program.n_uniform \
            and len(program.params[0]) == want and program.perms[0] is None:
        return None
    if not want and program.plain:
        return None
    return (f"{name}: runs one body over its streams in order with "
            f"{want} parameters; the program has uniforms, other "
            "parameters or a permutation")


def _cuda_device(name: str, t: torch.Tensor) -> torch.device:
    """``t``'s device, which must be a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: launches on CUDA tensors, got {t.device}")
    return t.device


def _checked_operands(name: str, tensors: Sequence[torch.Tensor],
                      dtypes: Sequence[torch.dtype]) -> torch.device:
    """What every wrapper's kernel takes of its operands — one CUDA device,
    one dtype of ``dtypes``, contiguous 2-D layouts; return the device."""
    dev = _cuda_device(name, tensors[0])
    for k, t in enumerate(tensors):
        if t.device != dev:
            raise ValueError(f"{name}: operand {k} on {t.device}, not {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: operand {k} has dtype {t.dtype}; the "
                            f"kernel takes {[str(d) for d in dtypes]}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: operand {k} needs a contiguous 2-D "
                             f"layout, got shape {tuple(t.shape)}")
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"{name}: operands of mixed dtypes "
                        f"{[str(t.dtype) for t in tensors]}")
    return dev


def _checked(name: str, geo: StreamGeometry,
             layouts: Sequence[torch.Tensor],
             program: Optional[Any] = None,
             ring: Optional[RingProgram] = None,
             op: Optional[tuple] = None) -> torch.device:
    """Validate what every streamed wrapper's kernel takes (with ``ring``,
    what the ring kernel of ``op`` takes); return the device."""
    reason = _program_refusal(name, program)
    if reason is not None:
        raise ValueError(reason)
    n_in, dtypes = _TAKES[name][:2]
    dev = _checked_operands(name, layouts, dtypes)
    if len(layouts) != n_in:
        raise ValueError(f"{name}: takes {n_in} streams, got {len(layouts)}")
    for k, (t, agu) in enumerate(zip(layouts, geo.ins)):
        agu.check_within(geo.grid, tuple(t.shape), f"{name}[{k}]")
    reason = _refusal(name, geo, layouts[0].dtype, dev) if ring is None \
        else _ring_refusal(op, name, geo, layouts[0].dtype, ring)
    if reason is not None:
        raise ValueError(reason)
    geo.out.check_within(geo.grid, geo.out_shape, f"{name}[out]")
    return dev


_CARDS: Dict[int, Any] = {}


def _card(dev: torch.device):
    """The card's properties (SM count, shared-memory limit), read once."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _CARDS:
        _CARDS[index] = torch.cuda.get_device_properties(index)
    return _CARDS[index]


def _launch(name: str, dev: torch.device, *args) -> None:
    lib = _lib(name)
    entry = getattr(lib, f"ssr_{name}")
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    # the entry launches on the current device, on its current stream
    with (contextlib.nullcontext() if index == current
          else torch.cuda.device(index)):
        rc = entry(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc} "
                           f"({lib.ssr_error_string(rc).decode()})")
    LAUNCHES[name] += 1


def _ctas(dev: torch.device, steps: int, per_sm: int) -> tuple:
    """(CTAs, steps per CTA) that spread ``steps`` over the card's SMs."""
    return _k_split(steps, per_sm * _card(dev).multi_processor_count)


def _vector_width(tensors: Sequence[torch.Tensor],
                  agus: Sequence[BlockAGU]) -> int:
    """Elements per 16-byte access where every base pointer, row pitch and
    block width allows one (then every block row starts aligned), else 1."""
    v = 16 // tensors[0].element_size()
    if all(t.data_ptr() % 16 == 0 and t.shape[1] % v == 0 for t in tensors) \
            and all(a.block[1] % v == 0 for a in agus):
        return v
    return 1


# -- the four wrappers ------------------------------------------------------


def _ring_arg(ring: RingProgram) -> _Ring:
    r = _Ring()
    for i, (d, inv) in enumerate(zip(ring.depths, ring.invariant)):
        r.depth[i], r.invariant[i] = d, int(inv)
    return r


class _Prepared(NamedTuple):
    """A launch as far as it depends on its key alone: the kernel, the
    device, the output's shape and dtype, which layouts are copied to a
    16-byte boundary a call, the 4-byte words of the stream's scratch a
    call takes (:func:`_work`; 0 for none), and the entry's arguments after
    its pointers (the layouts', the output's, the scratch's): dtypes,
    vector widths, the AGU structs, the CTA split.  ``order`` names the
    layout each of the entry's leading pointers takes (empty: each layout
    in turn)."""
    kernel: str
    dev: torch.device
    out_shape: Tuple[int, ...]
    out_dtype: torch.dtype
    align: Tuple[bool, ...]
    work: int
    args: tuple
    order: Tuple[int, ...] = ()


#: The wrappers' prepared launches by key (:func:`_launch_key`); emptied
#: when full.
_PREPARED: Dict[tuple, _Prepared] = {}
_PREPARED_MOST = 256


def _launch_key(name: str, op: tuple, geo: StreamGeometry,
                ring: Optional[RingProgram], program: Optional[Any],
                out_dtype: torch.dtype, acc_dtype: torch.dtype,
                layouts: Sequence[torch.Tensor]) -> tuple:
    """What a wrapper's checks and launch arguments depend on: the
    wrapper, op, geometry, ring, program, dtypes and the layouts
    (:func:`_layouts_key`)."""
    return (name, op, geo, ring, program, out_dtype, acc_dtype,
            _layouts_key(layouts))


def _layouts_key(layouts: Sequence[torch.Tensor]) -> tuple:
    """What a launch depends on of its layouts: each one's shape, strides,
    dtype, device and base pointer's 16-byte alignment."""
    return tuple((t.shape, t.stride(), t.dtype, t.device, t.data_ptr() % 16)
                 for t in layouts)


def _prepared(key: tuple, prepare: Callable[[], _Prepared]) -> _Prepared:
    """The launch of ``key``, checked and built by ``prepare()`` once."""
    prep = _PREPARED.get(key)
    if prep is None:
        prep = prepare()
        if len(_PREPARED) >= _PREPARED_MOST:
            _PREPARED.clear()
        _PREPARED[key] = prep
    return prep


#: Each stream's scratch by (device index, stream handle): K1's ticket and
#: partials, R1's partials (:func:`_work`).
_WORK: Dict[Tuple[int, int], torch.Tensor] = {}


def _work(dev: torch.device, words: int) -> torch.Tensor:
    """At least ``words`` 4-byte words of scratch for launches on the
    device's current stream, zero when first made: K1's first word is its
    ticket, which each launch leaves at zero, and the partials follow it.
    Launches on one stream run one after another, so they share it."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    work = _WORK.get(key)
    if work is None or work.numel() < words:
        work = torch.zeros(words, dtype=torch.int32,
                           device=torch.device("cuda", index))
        _WORK[key] = work
    return work


def _run(prep: _Prepared, layouts: Sequence[torch.Tensor]) -> torch.Tensor:
    """A call of a prepared launch: the output allocated, the layouts (in
    ``prep.order``) copied where ``prep.align`` asks, the scratch, then the
    launch."""
    if prep.order:
        layouts = [layouts[j] for j in prep.order]
    ins = [_aligned16(t) if al else t for t, al in zip(layouts, prep.align)]
    out = torch.empty(prep.out_shape, dtype=prep.out_dtype, device=prep.dev)
    work = (_work(prep.dev, prep.work).data_ptr(),) if prep.work else ()
    _launch(prep.kernel, prep.dev, *(t.data_ptr() for t in ins),
            out.data_ptr(), *work, *prep.args)
    return out


def _prepare_reduce_mul(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                        out_dtype: torch.dtype, program: Optional[Any],
                        ring: Optional[RingProgram]) -> _Prepared:
    """Every check of K1 (or R1), then its launch's arguments."""
    dev = _checked("reduce_mul", geo, layouts, program, ring,
                   ("reduce", "mul"))
    if out_dtype != torch.float32:
        raise TypeError(f"reduce_mul: accumulates in float32, asked for "
                        f"{out_dtype}")
    a, b = layouts
    sms = _card(dev).multi_processor_count
    runs, per, k, _ = reduce_split(geo.steps, sms)
    head = (_DTYPE_CODE[a.dtype], _vector_width(layouts, geo.ins),
            ctypes.byref(_grid_arg(geo.grid)),
            ctypes.byref(_stream_arg(geo.ins[0], a)),
            ctypes.byref(_stream_arg(geo.ins[1], b)))
    if ring is None:
        return _Prepared("reduce_mul", dev, (1, 1), torch.float32,
                         (False, False), 1 + runs, (*head, runs, per, k))
    dr = device_ring("ring_reduce_mul", geo, ring, a.dtype)
    run = ring_run_steps("ring_reduce_mul", geo, ring, a.dtype, sms)
    return _Prepared("ring_reduce_mul", dev, (1, 1), torch.float32,
                     (False, False), 1 + runs, (
                         *head, ctypes.byref(_ring_arg(dr)),
                         dr.ring_bytes + _staged_bytes("ring_reduce_mul", (),
                                                       geo),
                         runs, per, run // per))


def reduce_mul(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
               out_dtype: torch.dtype,
               acc_dtype: torch.dtype = torch.float32,
               program: Optional[Any] = None,
               ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K1: Σ promote(a)·promote(b) over every step → (1, 1) f32, in one
    launch on :func:`reduce_split`'s runs, its last CTA folding the runs'
    partials; with ``ring`` (a pipelined call) R1, whose persistent CTAs
    walk K1's runs (:func:`ring_run_steps`), one partial a run, then a
    second launch folds them.  Checked and built once per key
    (:func:`_launch_key`)."""
    key = _launch_key("reduce_mul", ("reduce", "mul"), geo, ring, program,
                      out_dtype, acc_dtype, layouts)
    return _run(_prepared(key, lambda: _prepare_reduce_mul(
        geo, layouts, out_dtype, program, ring)), layouts)


def _prepare_map_relu(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                      out_dtype: torch.dtype, program: Optional[Any],
                      ring: Optional[RingProgram]) -> _Prepared:
    """Every check of K2 (or R2), then its launch's arguments.  The output
    is a new tensor each call, so 16-byte aligned: its pitch and block
    width decide its packs."""
    dev = _checked("map_relu", geo, layouts, program, ring, ("map", "relu"))
    (x,) = layouts
    if out_dtype != x.dtype:
        raise TypeError(f"map_relu: keeps the dtype ({x.dtype}), asked for "
                        f"{out_dtype}")
    vec = _vector_width(layouts, geo.ins)
    if geo.out_shape[1] % vec or geo.out.block[1] % vec:
        vec = 1
    ctas, per_cta = _ctas(dev, geo.steps, per_sm=MAP_PER_SM if ring is None
                          else RING_MAP_PER_SM)
    head = (_DTYPE_CODE[x.dtype], vec, ctypes.byref(_grid_arg(geo.grid)),
            ctypes.byref(_stream_arg(geo.ins[0], x)),
            ctypes.byref(_stream_pitch_arg(geo.out, geo.out_shape[1])))
    if ring is None:
        return _Prepared("map_relu", dev, tuple(geo.out_shape), x.dtype,
                         (False,), 0, (*head, ctas, per_cta))
    dr = device_ring("ring_map_relu", geo, ring, x.dtype)
    return _Prepared("ring_map_relu", dev, tuple(geo.out_shape), x.dtype,
                     (False,), 0, (
                         *head, ctypes.byref(_ring_arg(dr)),
                         dr.ring_bytes + _staged_bytes("ring_map_relu", (),
                                                       geo),
                         ctas, per_cta))


def map_relu(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
             out_dtype: torch.dtype,
             acc_dtype: torch.dtype = torch.float32,
             program: Optional[Any] = None,
             ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K2: each step's block → max(0, block) through the dense out map, on
    runs of steps at MAP_PER_SM CTAs an SM; with ``ring`` (a pipelined call)
    R2, at RING_MAP_PER_SM.  Checked and built once per key
    (:func:`_launch_key`)."""
    key = _launch_key("map_relu", ("map", "relu"), geo, ring, program,
                      out_dtype, acc_dtype, layouts)
    return _run(_prepared(key, lambda: _prepare_map_relu(
        geo, layouts, out_dtype, program, ring)), layouts)


def _prepare_contract(name: str, geo: StreamGeometry,
                      layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
                      acc_dtype: torch.dtype, program: Optional[Any],
                      ring: Optional[RingProgram], op: tuple,
                      args: Callable[[torch.device], tuple]) -> _Prepared:
    """Every check of a contraction, then its launch's arguments."""
    dev = _checked(name, geo, layouts, program, ring, op)
    if acc_dtype != torch.float32:
        raise TypeError(f"{name}: accumulates in float32, the schedule asks "
                        f"for {acc_dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: drains to float32 or bfloat16, asked for "
                        f"{out_dtype}")
    kernel, widths, rest, align_b = args(dev)
    g = _grid_arg(geo.grid)
    s0, s1 = (_stream_arg(a, t) for a, t in zip(geo.ins, layouts))
    so = _stream_pitch_arg(geo.out, geo.out_shape[1])
    return _Prepared(kernel, dev, tuple(geo.out_shape), out_dtype,
                     (False, align_b), 0, (
                         _DTYPE_CODE[layouts[0].dtype], _DTYPE_CODE[out_dtype],
                         *widths, ctypes.byref(g), ctypes.byref(s0),
                         ctypes.byref(s1), ctypes.byref(so),
                         geo.contraction_steps, *rest))


def _contract(name: str, geo: StreamGeometry,
              layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
              acc_dtype: torch.dtype, program: Optional[Any],
              ring: Optional[RingProgram], op: tuple,
              args: Callable[[torch.device], tuple]) -> torch.Tensor:
    """Check and launch a contraction: ``args(dev)`` gives the kernel's
    name, its vector widths, its arguments after the contraction steps
    and whether the second operand is copied to a 16-byte boundary, or,
    with ``ring``, the ring kernel's.  What depends only on the call's key
    (:func:`_launch_key`) is checked and built once per key
    (:data:`_PREPARED`); a call then allocates the output and launches."""
    key = _launch_key(name, op, geo, ring, program, out_dtype, acc_dtype,
                      layouts)
    return _run(_prepared(key, lambda: _prepare_contract(
        name, geo, layouts, out_dtype, acc_dtype, program, ring, op, args)),
        layouts)


#: R3's routes (:func:`gemm_ring_route`) → the ``cvec`` its entry takes.
_GEMM_ROUTES = {"tma": 2, "cp.async": 1, "cp.async elements": 0}


def gemm_ring_route(geo: StreamGeometry,
                    layouts: Sequence[torch.Tensor]) -> str:
    """How R3's producer warp fills its slots on these layouts: ``"tma"``
    (2-D tensor copies) where A and B are f32 with base pointers, pitches
    and block widths in 16-byte packs and A's block width ``tk`` is a
    multiple of :data:`GEMM_CHUNK_K` (no chunk crosses the block's k edge,
    which TMA would not zero); else ``"cp.async"`` (16-byte packs, in either
    dtype, where the same alignment holds) or ``"cp.async elements"``."""
    aligned = _vector_width(layouts, geo.ins) > 1
    if aligned and layouts[0].dtype == torch.float32 \
            and geo.ins[0].block[1] % GEMM_CHUNK_K == 0:
        return "tma"
    return "cp.async" if aligned else "cp.async elements"


#: K3's routes (:func:`contract_gemm_route`) → the ``route`` its entry
#: takes.
_CONTRACT_GEMM_ROUTES = {"packs": 2, "words": 1, "elements": 0}
#: K3's k chunk: each of its two buffers holds 32 k of A (k-major, f32, on
#: a pitch of 132 floats) and of B (128 columns of the input dtype).
CONTRACT_GEMM_CHUNK_K = 32


def contract_gemm_smem_bytes(dtype: torch.dtype) -> int:
    """The dynamic shared memory a K3 CTA takes at input ``dtype``, as its
    entry's ``ssr_contract_gemm_smem_bytes`` counts it: two buffers of
    :data:`CONTRACT_GEMM_CHUNK_K` k (66,560 bytes in f32, 50,176 in
    bf16)."""
    k = CONTRACT_GEMM_CHUNK_K
    return 2 * k * (4 * (GEMM_TILE_M + 4) + GEMM_TILE_N * _itemsize(dtype))


def contract_gemm_route(geo: StreamGeometry,
                        layouts: Sequence[torch.Tensor]) -> str:
    """How K3's threads move a chunk of A and B on these layouts: in
    16-byte packs (``"packs"``) where both have base pointers, pitches and
    block widths in 16-byte packs, else one element a copy: 4-byte words in
    f32 (``"words"``), elements in bf16 (``"elements"``)."""
    if _vector_width(layouts, geo.ins) > 1:
        return "packs"
    return "words" if layouts[0].dtype == torch.float32 else "elements"


def contract_gemm(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                  out_dtype: torch.dtype,
                  acc_dtype: torch.dtype = torch.float32,
                  program: Optional[Any] = None,
                  ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K3: C block (tm, tn) += A block (tm, tk) · B block (tk, tn), by
    :func:`contract_gemm_route`'s route; with ``ring`` (a pipelined call)
    R3, by :func:`gemm_ring_route`'s."""
    def args(dev):
        if ring is None:
            return "contract_gemm", (
                _CONTRACT_GEMM_ROUTES[contract_gemm_route(geo, layouts)],), \
                (), False
        dr = device_ring("ring_contract_gemm", geo, ring, layouts[0].dtype)
        return "ring_contract_gemm", (
            _GEMM_ROUTES[gemm_ring_route(geo, layouts)],), (
            ctypes.byref(_ring_arg(dr)),
            dr.ring_bytes + _staged_bytes("ring_contract_gemm", (), geo)), \
            False

    return _contract("contract_gemm", geo, layouts, out_dtype, acc_dtype,
                     program, ring, ("nest", "dot"), args)


def contract_gemv(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                  out_dtype: torch.dtype,
                  acc_dtype: torch.dtype = torch.float32,
                  program: Optional[Any] = None,
                  ring: Optional[RingProgram] = None, *,
                  relu: bool = False) -> torch.Tensor:
    """K4: y block (1, tm) += A block (tm, tn) · x block (1, tn)ᵀ; with
    ``relu`` the drain writes max(0, y) (selected, as K2 does), once per
    output block, never to a partial.  K4's CTAs are one wave, each on a
    run of units (a GEMV_ROWS-row group of one output block,
    :func:`gemv_split`), x staged many steps at a time.  With ``ring`` (a
    pipelined call) R4, a filling warp on mbarriers, its persistent CTAs
    each on a run of whole output blocks of its 8 rows
    (:func:`ring_run_steps`), all in one wave."""
    def args(dev):
        # A is read in 16-byte packs where it can be; then K4 stages and
        # R4's bulk route copies x's blocks in 16-byte packs too, and a
        # view of x off a 16-byte boundary is copied once a call
        a, x = layouts
        vec = _vector_width(layouts[:1], geo.ins[:1])
        align_x = vec > 1
        xvec = int(_vector_width((_aligned16(x) if align_x else x,),
                                 geo.ins[1:]) > 1)
        sms = _card(dev).multi_processor_count
        if ring is None:
            per, _ = gemv_split(geo, sms)
            return "contract_gemv", (vec, xvec), (per, int(relu)), align_x
        dr = device_ring("ring_contract_gemv", geo, ring, a.dtype)
        run = ring_run_steps("ring_contract_gemv", geo, ring, a.dtype, sms)
        return "ring_contract_gemv", (vec, xvec), (
            run // geo.contraction_steps, int(relu),
            ctypes.byref(_ring_arg(dr)),
            dr.ring_bytes + _staged_bytes("ring_contract_gemv", (), geo)), \
            align_x

    return _contract("contract_gemv", geo, layouts, out_dtype, acc_dtype,
                     program, ring,
                     ("nest", "matvec_relu" if relu else "matvec"), args)


def contract_gemv_relu(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                       out_dtype: torch.dtype,
                       acc_dtype: torch.dtype = torch.float32,
                       program: Optional[Any] = None,
                       ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K4 with its relu drain: y = max(0, A·x) (``matvec_relu``); R4 with
    ``ring``."""
    return contract_gemv(geo, layouts, out_dtype, acc_dtype, program, ring,
                         relu=True)


# -- the halo and rescale kernels -------------------------------------------


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or its copy where it starts off a 16-byte boundary (a view
    into a larger tensor): the kernels load 16-byte packs."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _first_slot_ring(rname: str, geo: StreamGeometry, ring: RingProgram,
                     dtype: torch.dtype) -> RingProgram:
    """The one stream R10 and R11 ring: the halo's first slot, as
    :func:`device_ring` sizes it (the twins and taps are not ringed)."""
    dr = device_ring(rname, geo, ring, dtype)
    return RingProgram(dr.depths[:1], (False,), dr.slot_bytes[:1])


def _copies16(t: torch.Tensor, agu: BlockAGU) -> bool:
    """Whether every block row of ``t`` along ``agu``'s walk starts 16-byte
    aligned (base pointer, row pitch and block width)."""
    return _vector_width((t,), (agu,)) == 16 // t.element_size()


def _halo_stencil1d(name: str, geo: StreamGeometry,
                    layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
                    program: Optional[Any], ring: Optional[RingProgram],
                    relu: bool) -> torch.Tensor:
    op = ("nest", "stencil1d_relu" if relu else "stencil1d")
    dev = _checked(name, geo, layouts, program, ring, op)
    _f32_out(name, out_dtype)
    x, _twin, w = layouts
    ctas, per_cta = _ctas(dev, geo.steps, per_sm=STENCIL_PER_SM)
    out = torch.empty(geo.out_shape, dtype=torch.float32, device=dev)
    g = _grid_arg(geo.grid)
    sx, sw, so = (_stream_arg(geo.ins[0], x), _stream_arg(geo.ins[2], w),
                  _stream_arg(geo.out, out))
    head = (x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype])
    streams = (ctypes.byref(g), ctypes.byref(sx), ctypes.byref(sw),
               ctypes.byref(so), ctas, per_cta, int(relu))
    if ring is None:
        vec = 4 if x.dtype == torch.float32 and _vector_width(
            (x, out), (geo.ins[0], geo.out)) == 4 else 1
        _launch("halo_stencil1d", dev, *head, vec, *streams)
        return out
    # R10 copies x in 16-byte packs and stores y in them where both allow
    vec = 4 if _copies16(x, geo.ins[0]) and _vector_width(
        (out,), (geo.out,)) == 4 else 1
    xr = _first_slot_ring("ring_halo_stencil1d", geo, ring, x.dtype)
    _launch("ring_halo_stencil1d", dev, *head, vec, *streams,
            ctypes.byref(_ring_arg(xr)), xr.ring_bytes)
    return out


def halo_stencil1d(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                   out_dtype: torch.dtype,
                   acc_dtype: torch.dtype = torch.float32,
                   program: Optional[Any] = None,
                   ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K9: y block (1, t) = Σ_j w[j]·x[i+j] over the widened block (1, t +
    10) read from x's first slot; the twin's walk is not read.  With
    ``ring`` (a pipelined call) R10, x's items through a ring of the first
    slot's depth, on K9's split of the steps, to K9's bits."""
    return _halo_stencil1d("halo_stencil1d", geo, layouts, out_dtype,
                           program, ring, relu=False)


def halo_stencil1d_relu(geo: StreamGeometry,
                        layouts: Sequence[torch.Tensor],
                        out_dtype: torch.dtype,
                        acc_dtype: torch.dtype = torch.float32,
                        program: Optional[Any] = None,
                        ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K9 with its relu drain: y = max(0, Σ_j w[j]·x[i+j]), selected as K2
    selects it (``stencil1d_relu``); R10 with its drain with ``ring``."""
    return _halo_stencil1d("halo_stencil1d_relu", geo, layouts, out_dtype,
                           program, ring, relu=True)


def halo_stencil2d(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                   out_dtype: torch.dtype,
                   acc_dtype: torch.dtype = torch.float32,
                   program: Optional[Any] = None,
                   ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K10: the 11-point star over each block, widened by 10 rows and 10
    columns, read from x's first slot; the three twins are not read.  With
    ``ring`` (a pipelined call) R11, K10's windows through a ring of the
    first slot's depth, on as many persistent CTAs as fit the card, to
    K10's bits."""
    dev = _checked("halo_stencil2d", geo, layouts, program, ring,
                   ("nest", "stencil2d"))
    _f32_out("halo_stencil2d", out_dtype)
    x, wx, wy = layouts[0], layouts[4], layouts[5]
    out = torch.empty(geo.out_shape, dtype=torch.float32, device=dev)
    g = _grid_arg(geo.grid)
    sx, swx, swy, so = (_stream_arg(geo.ins[0], x),
                        _stream_arg(geo.ins[4], wx),
                        _stream_arg(geo.ins[5], wy),
                        _stream_arg(geo.out, out))
    head = (x.data_ptr(), wx.data_ptr(), wy.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[x.dtype])
    streams = (ctypes.byref(g), ctypes.byref(sx), ctypes.byref(swx),
               ctypes.byref(swy), ctypes.byref(so))
    if ring is None:
        vec = 4 if x.dtype == torch.float32 and _vector_width(
            (x,), (geo.ins[0],)) == 4 else 1
        ctas = 4 * _card(dev).multi_processor_count      # persistent (f32)
        _launch("halo_stencil2d", dev, *head, vec, *streams, ctas)
        return out
    xr = _first_slot_ring("ring_halo_stencil2d", geo, ring, x.dtype)
    _launch("ring_halo_stencil2d", dev, *head,
            4 if _copies16(x, geo.ins[0]) else 1, *streams,
            ctypes.byref(_ring_arg(xr)), xr.ring_bytes)
    return out


def _heads(name: str, layouts: Sequence[torch.Tensor]
           ) -> Tuple[int, list]:
    """(heads, one head's layouts): every layout 2-D, or every layout 3-D,
    contiguous, over the same leading head dim."""
    dims = {t.dim() for t in layouts}
    if dims == {2}:
        return 1, list(layouts)
    if dims == {3} and len({t.shape[0] for t in layouts}) == 1 \
            and layouts[0].shape[0] > 0 \
            and all(t.is_contiguous() for t in layouts):
        return layouts[0].shape[0], [t[0] for t in layouts]
    raise ValueError(f"{name}: needs 2-D layouts or contiguous 3-D layouts "
                     f"over one head dim, got "
                     f"{[tuple(t.shape) for t in layouts]}")


def _prepare_rescale_attention(geo: StreamGeometry,
                               layouts: Sequence[torch.Tensor],
                               out_dtype: torch.dtype, acc_dtype: torch.dtype,
                               program: Optional[Any],
                               ring: Optional[RingProgram]) -> _Prepared:
    """Every check of K11 (or R12), then its launch's arguments.  K11
    loads rows in 16-byte packs: a layout that is a view starting off a
    16-byte boundary (a slice of a larger tensor) is copied once a call."""
    name = "rescale_attention"
    layouts = [_aligned16(t) for t in layouts]
    heads, head0 = _heads(name, layouts)
    dev = _checked(name, geo, head0, program, ring, ("nest", "attn_scores"))
    if acc_dtype != torch.float32:
        raise TypeError(f"{name}: carries m, l and acc in float32, the "
                        f"schedule asks for {acc_dtype}")
    if out_dtype not in _FLOATS:
        raise TypeError(f"{name}: drains to float32 or bfloat16, asked for "
                        f"{out_dtype}")
    causal, window, scale, off_rc, sk, dim = program.params[0]
    k = layouts[0]
    shape = geo.out_shape if k.dim() == 2 else (heads, *geo.out_shape)
    per_head = [t[0].numel() if t.dim() == 3 else 0 for t in layouts] + \
        [math.prod(geo.out_shape) if k.dim() == 3 else 0]
    args = (_DTYPE_CODE[k.dtype], _DTYPE_CODE[out_dtype],
            ctypes.byref(_grid_arg(geo.grid)),
            *(ctypes.byref(_stream_arg(a, t)) for a, t in zip(geo.ins, head0)),
            ctypes.byref(_stream_pitch_arg(geo.out, geo.out_shape[1])),
            geo.contraction_steps, heads, (ctypes.c_int64 * 4)(*per_head),
            float(scale), int(bool(causal)),
            -1 if window is None else int(window), int(off_rc), int(sk))
    align = (True,) * len(layouts)
    if ring is None:
        # K11 stages and sums only the lanes that hold the head dim
        return _Prepared(name, dev, tuple(shape), out_dtype, align, 0,
                         (*args, int(dim)))
    dr = device_ring("ring_rescale_attention", geo, ring, k.dtype)
    return _Prepared("ring_rescale_attention", dev, tuple(shape), out_dtype,
                     align, 0, (*args, ctypes.byref(_ring_arg(dr)),
                                dr.ring_bytes + _staged_bytes(
                                    "ring_rescale_attention", (), geo),
                                int(dim)))


def rescale_attention(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                      out_dtype: torch.dtype,
                      acc_dtype: torch.dtype = torch.float32,
                      program: Optional[Any] = None,
                      ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K11: O = softmax(Q·Kᵀ·scale + mask)·V for every head of the batch in
    one launch, the kv walk a loop inside each CTA carrying m, l and acc.
    The mask and the head dim are the body's parameters: (causal, window,
    scale, sk − sq, sk, d); K11 stages and sums the live lanes that hold d
    (:func:`rescale_attention_tiles`: 96 or 128 of a 128-lane tile, 192 or
    256 of a 256-lane one) and writes 0 to the lanes past them in O.  With
    ``ring`` (a pipelined call) R12: K and V through rings of their
    streams' depths in the units of :data:`ATTENTION_RING_TILES`, Q staged
    once a CTA, on K11's live lanes, to K11's bits.  Checked and built once
    per key (:func:`_launch_key` and the card's shared memory a CTA)."""
    dev = layouts[0].device
    key = (_launch_key("rescale_attention", ("nest", "attn_scores"), geo,
                       ring, program, out_dtype, acc_dtype, layouts),
           _card(dev).shared_memory_per_block_optin
           if dev.type == "cuda" else None)
    return _run(_prepared(key, lambda: _prepare_rescale_attention(
        geo, layouts, out_dtype, acc_dtype, program, ring)), layouts)


# -- the gather kernels --------------------------------------------------------


def _checked_gather(name: str, geo: StreamGeometry,
                    layouts: Sequence[torch.Tensor], program: Optional[Any],
                    ring: Optional[RingProgram] = None) -> torch.device:
    """What K12 and K13 take: f32 values and table, an int32 index stream,
    contiguous 2-D layouts on one CUDA device, inside their walks (their
    vals and cidx inside the gather's extent: the unpadded (m, k) planes);
    with ``ring``, what their ring kernel R13 or R14 takes (its ring within
    the shared memory a CTA may opt into)."""
    for t in layouts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: launches on CUDA tensors, got "
                             f"{t.device}")
    reason = _program_refusal(name, program)
    if reason is not None:
        raise ValueError(reason)
    if len(layouts) != 3:
        raise ValueError(f"{name}: takes 3 streams, got {len(layouts)}")
    vals, cidx, table = layouts
    dev = _checked_operands(name, (vals, table), (torch.float32,))
    _checked_operands(name, (cidx,), (torch.int32,))
    if cidx.device != dev:
        raise ValueError(f"{name}: operand 1 on {cidx.device}, not {dev}")
    check_gather_walks(name, geo, [tuple(t.shape) for t in layouts], ring)
    reason = _refusal(name, geo, vals.dtype, dev) if ring is None else \
        _ring_refusal(_gather_key(name),
                      name, geo, vals.dtype, ring)
    if reason is not None:
        raise ValueError(reason)
    geo.out.check_within(geo.grid, geo.out_shape, f"{name}[out]")
    return dev


#: The device kernels, by their :data:`DEVICE_KERNELS` key, that read a
#: gather nest's read streams as their operands' unpadded (rows, cols)
#: planes, at the planes' own pitch and bounded by the gather's extent,
#: when they run unpipelined on the card: K12 and K13 (``pack_ell``'s
#: (m, k) planes, no layout copy).  Their ring kernels (R13, R14) and
#: every other kernel read the lowering's padded layouts.
PLANE_KERNELS = frozenset({("nest", "spmv"), ("nest", "spmm")})


def takes_planes(key: tuple, ring: Optional[RingProgram] = None) -> bool:
    """Whether the device kernel of ``key`` (its ring kernel, with
    ``ring``) reads unpadded planes (:data:`PLANE_KERNELS`)."""
    return key in PLANE_KERNELS and ring is None


def _gather_key(name: str) -> tuple:
    """The :data:`DEVICE_KERNELS` key of gather kernel ``name`` (K12, K13)."""
    return ("nest", name.removeprefix("gather_"))


def check_gather_walks(name: str, geo: StreamGeometry,
                       shapes: Sequence[Tuple[int, ...]],
                       ring: Optional[RingProgram] = None) -> None:
    """Raise unless each of gather kernel ``name``'s layouts (their
    ``shapes``) holds what it reads: every block of its walk, but where the
    kernel :func:`takes_planes` (K12, K13), whose vals and cidx need hold
    only the gather's extent -- the unpadded (m, k) planes it reads at
    pitch k (:meth:`BlockAGU.check_extent_within`).  R13 and R14 read
    whole slots or rows of the padded layouts."""
    planes = takes_planes(_gather_key(name), ring)
    for k, (shape, agu) in enumerate(zip(shapes, geo.ins)):
        if planes and k < 2:
            agu.check_extent_within(geo.grid, tuple(shape),
                                    geo.gathers[0].extent, f"{name}[{k}]")
        else:
            agu.check_within(geo.grid, tuple(shape), f"{name}[{k}]")


def _gather_args(name: str, geo: StreamGeometry,
                 layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
                 acc_dtype: torch.dtype, program: Optional[Any],
                 ring: Optional[RingProgram] = None
                 ) -> Tuple[torch.device, torch.Tensor, tuple]:
    """The output, and the arguments K12 and K13 (R13 and R14 with
    ``ring``) share: the three layouts and the output, the grid and the
    walks, the contraction steps and the gather's program (scale, offset,
    table size, the extent that holds data)."""
    dev = _checked_gather(name, geo, layouts, program, ring)
    _f32_out(name, out_dtype)
    if acc_dtype != torch.float32:
        raise TypeError(f"{name}: accumulates in float32, the schedule asks "
                        f"for {acc_dtype}")
    vals, cidx, table = layouts
    g = geo.gathers[0]
    out = torch.empty(geo.out_shape, dtype=torch.float32, device=dev)
    return dev, out, (
        vals.data_ptr(), cidx.data_ptr(), table.data_ptr(), out.data_ptr(),
        ctypes.byref(_grid_arg(geo.grid)),
        ctypes.byref(_stream_arg(geo.ins[0], vals)),
        ctypes.byref(_stream_arg(geo.ins[1], cidx)),
        ctypes.byref(_stream_arg(geo.out, out)),
        geo.contraction_steps, g.scale, g.offset, table.numel(),
        g.extent[0], g.extent[1])


def _gather_ring_args(rname: str, geo: StreamGeometry, ring: RingProgram,
                      dev: torch.device) -> tuple:
    """What R13 and R14 take besides their sync kernel's arguments: the
    output blocks a CTA's run walks (:func:`ring_run_steps`), the slot
    pitch, the ring as :func:`device_ring` sizes it and the shared memory a
    CTA takes (the ring and :func:`_staged_bytes`)."""
    dr = device_ring(rname, geo, ring, torch.float32)
    steps = ring_run_steps(rname, geo, ring, torch.float32,
                           _card(dev).multi_processor_count)
    return (steps // geo.contraction_steps, gather_slot_width(geo),
            ctypes.byref(_ring_arg(dr)),
            dr.ring_bytes + _staged_bytes(rname, (), geo))



def gather_spmv(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                out_dtype: torch.dtype, acc_dtype: torch.dtype = torch.float32,
                program: Optional[Any] = None,
                ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K12: y block (1, tm) = Σ over the contraction steps and the index
    block's columns of vals·x[clip(scale·cidx + offset)], f32; a group of
    four threads per row reads only the positions holding data, at the
    planes' pitch: ``pack_ell``'s (m, k) planes on the card
    (:data:`PLANE_KERNELS`), or padded layouts (:func:`check_gather_walks`).  With ``ring`` (a pipelined call)
    R13 (:func:`ring_gather_spmv`), on the padded layouts."""
    if ring is not None:
        return ring_gather_spmv(geo, layouts, out_dtype, acc_dtype, program,
                                ring)
    dev, out, args = _gather_args("gather_spmv", geo, layouts, out_dtype,
                                  acc_dtype, program)
    _launch("gather_spmv", dev, *args)
    return out


def ring_gather_spmv(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                     out_dtype: torch.dtype, acc_dtype: torch.dtype,
                     program: Optional[Any], ring: RingProgram
                     ) -> torch.Tensor:
    """R13: K12 with vals' and cidx's rows through rings of their streams'
    depths, filled by a ninth warp of each CTA on a full and an empty
    mbarrier a slot, on persistent CTAs that each walk a run of whole
    output blocks for their 64 rows (:func:`ring_run_steps`); the table
    gathered as K12 gathers it; K12's bits."""
    # 16-byte copies of the rows: a view off a 16-byte boundary is copied
    layouts = [_aligned16(t) if k < 2 else t for k, t in enumerate(layouts)]
    dev, out, args = _gather_args("gather_spmv", geo, layouts, out_dtype,
                                  acc_dtype, program, ring)
    _launch("ring_gather_spmv", dev, *args, *_gather_ring_args(
        "ring_gather_spmv", geo, ring, dev))
    return out


def gather_spmm(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                out_dtype: torch.dtype, acc_dtype: torch.dtype = torch.float32,
                program: Optional[Any] = None,
                ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K13: Y block (tm, tc) = Σ vals·X[clip(scale·cidx + c + offset)], a
    warp per row, each lane four consecutive columns gathered as one
    16-byte load, eight entries in flight; the c tile in SPMM_COLS-wide
    chunks (grid y); vals and cidx at the planes' pitch: ``pack_ell``'s
    (m, k) planes on the card (:data:`PLANE_KERNELS`), or padded layouts.
    With ``ring`` (a pipelined call) R14 (:func:`ring_gather_spmm`), on the
    padded layouts."""
    if ring is not None:
        return ring_gather_spmm(geo, layouts, out_dtype, acc_dtype, program,
                                ring)
    name = "gather_spmm"
    # 16-byte gathers: a table view off a 16-byte boundary is copied once
    layouts = [_aligned16(t) if k == 2 else t for k, t in enumerate(layouts)]
    dev, out, args = _gather_args(name, geo, layouts, out_dtype, acc_dtype,
                                  program)
    g = geo.gathers[0]
    _launch(name, dev, *args, g.grid_pos[0], g.tiles[0])
    return out


def ring_gather_spmm(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                     out_dtype: torch.dtype, acc_dtype: torch.dtype,
                     program: Optional[Any], ring: RingProgram
                     ) -> torch.Tensor:
    """R14: K13 with vals' and cidx's rows through rings of their streams'
    depths, each warp's row a ring of its own, on persistent CTAs that each
    walk a run of whole output blocks for their 8 rows and 128-column
    chunk; X gathered as K13 gathers it; K13's bits."""
    layouts = [_aligned16(t) for t in layouts]
    dev, out, args = _gather_args("gather_spmm", geo, layouts, out_dtype,
                                  acc_dtype, program, ring)
    g = geo.gathers[0]
    _launch("ring_gather_spmm", dev, *args, g.grid_pos[0], g.tiles[0],
            *_gather_ring_args("ring_gather_spmm", geo, ring, dev))
    return out


# -- the stream kernels (StreamKernel) -----------------------------------------
#
# They run a module's Launch, not a lowered schedule: each wrapper checks that
# the Launch is the one its kernel computes (grid, every stream's walk, the
# output shapes, scratch and dimension semantics) besides the operands.

#: K14's and B8's CTA tile: 4096 elements, 16 consecutive ones a thread.
SCAN_TILE = 4096
#: K15 runs a transform of up to this many points in one CTA (re and im in
#: one shared-memory buffer: 8 bytes a point); longer ones as global passes.
FFT_SMEM_POINTS = 8192
#: K15 runs the stages of a CTA's row in groups of this many (log2 of the
#: points a thread holds in registers), the row crossing shared memory once
#: a group (``kernels/fft.py::fft_groups``).
FFT_RADIX_LOG2 = 3
#: K16's shared-memory tile: a row of up to SORT_TILE elements is one
#: launch; a longer one is walked in passes of SORT_TILE-element tiles
#: (``kernels/bitonic.py::sort_passes``).
SORT_TILE = 16384
#: The most stages (adjacent j ≥ SORT_TILE of one k) one K16 group pass runs.
SORT_GROUP = 9
#: log2 of the elements a K16 thread holds in registers (one run of stages
#: a pass of the tile through shared memory: ``bitonic.register_runs``).
SORT_REG_LOG2 = 5


#: launch_walks' results by the Launch's id (with the Launch, so that the id
#: is not reused while the entry stands): a Launch is frozen, and an entry
#: point reuses its Launch from call to call, so its index maps are probed
#: once, not at every call.
_WALKS: Dict[int, Tuple[Any, tuple]] = {}
_WALKS_MAX = 256


def launch_walks(launch: Any) -> Tuple[Tuple[BlockAGU, ...],
                                       Tuple[BlockAGU, ...]]:
    """The AGU programming of a Launch's read and write streams; raises
    when an index map is not affine."""
    hit = _WALKS.get(id(launch))
    if hit is not None and hit[0] is launch:
        return hit[1]
    grid = tuple(launch.grid)
    walks = (tuple(s.agu(grid) for s in launch.in_streams),
             tuple(s.agu(grid) for s in launch.out_streams))
    if len(_WALKS) >= _WALKS_MAX:
        _WALKS.clear()
    _WALKS[id(launch)] = (launch, walks)
    return walks


def _same_walk(a: BlockAGU, b: BlockAGU, grid: Tuple[int, ...]) -> bool:
    """The same blocks at every step: block, offset, and the coefficient of
    every axis that takes more than one step."""
    return (a.block == b.block and a.offset == b.offset
            and all(ca == cb for ca, cb, g in zip(a.coeffs, b.coeffs, grid)
                    if g > 1))


def _launch_refusal(name: str, launch: Any, grid: Tuple[int, ...],
                    ins: Sequence[BlockAGU], outs: Sequence[BlockAGU],
                    out_shapes: Sequence[tuple], scratch: Sequence[tuple],
                    semantics: Tuple[str, ...]) -> Optional[str]:
    """Why kernel ``name`` does not compute this Launch, or None: the
    kernel's grid, walks, output (shape, dtype)s, scratch and semantics."""
    if tuple(launch.grid) != grid:
        return f"{name}: runs grid {grid}, the Launch has {tuple(launch.grid)}"
    got_in, got_out = launch_walks(launch)
    got, want = (*got_in, *got_out), (*ins, *outs)
    if (len(got_in), len(got_out)) != (len(ins), len(outs)) or \
            not all(_same_walk(a, b, grid) for a, b in zip(got, want)):
        return (f"{name}: walks {[(a.block, a.offset, a.coeffs) for a in got]}"
                f" are not the kernel's "
                f"{[(a.block, a.offset, a.coeffs) for a in want]}")
    got = [(tuple(o.shape), o.dtype) for o in launch.out_shapes]
    if got != list(out_shapes):
        return f"{name}: writes {list(out_shapes)}, the Launch asks for {got}"
    got = [(tuple(o.shape), o.dtype) for o in launch.scratch_shapes]
    if got != list(scratch):
        return f"{name}: carries scratch {list(scratch)}, the Launch has {got}"
    if tuple(launch.dimension_semantics or ()) != semantics:
        return (f"{name}: runs axes {semantics}, the Launch declares "
                f"{launch.dimension_semantics}")
    return None


def _power_of_two_rows(name: str, t: torch.Tensor) -> Tuple[int, int]:
    """(rows, n) of a (rows, n) layout of power-of-two rows."""
    rows, n = t.shape
    if rows == 0 or n <= 0 or n & (n - 1):
        raise ValueError(f"{name}: needs (rows, n) with rows > 0 and n a "
                         f"power of two, got {tuple(t.shape)}")
    return rows, n


def _checked_launch(name: str, launch: Any, *expect) -> None:
    reason = _launch_refusal(name, launch, *expect)
    if reason is not None:
        raise ValueError(reason)


def _checked_scan(name: str, launch: Any, x: torch.Tensor) -> torch.device:
    """What K14 and R15 take: the padded vector x (rows, 128) in f32, bf16
    or int32 on a CUDA device, and the scan's Launch over it."""
    dev = _checked_operands(name, (x,), _FLOATS + (torch.int32,))
    nblk = _row_blocks(name, x)
    walk = BlockAGU((ROWS, LANES), (0, 0), ((1, 0),))
    _checked_launch(name, launch, (nblk,), (walk,), (walk,),
                    ((tuple(x.shape), torch.float32),),
                    (((1, 1), torch.float32),), ("arbitrary",))
    return dev


def stream_scan(launch: Any, x: torch.Tensor) -> Tuple[torch.Tensor]:
    """K14: the inclusive prefix sum of the padded vector x (rows, 128) in
    f32, the Launch's (8, 128) blocks walked in order with an f32 carry,
    in one pass that reads x once: persistent CTAs take SCAN_TILE tiles by
    ticket, in increasing order, two slots a CTA, and each tile finds its
    offset from its predecessors' published totals as a fixed-order second
    pass over the totals would (:func:`scan_model`) — the same bits every
    run.  One memset of the call's state (:func:`scan_state_words`), then
    one launch."""
    name = "stream_scan"
    dev = _checked_scan(name, launch, x)
    x = _aligned16(x)
    tiles = -(-x.numel() // SCAN_TILE)
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    nwords = scan_state_words(tiles)
    words = torch.empty(nwords, dtype=torch.int64, device=dev)
    _launch(name, dev, x.data_ptr(), _DTYPE_CODE[x.dtype], out.data_ptr(),
            words.data_ptr(), x.numel(), tiles, nwords)
    return (out,)


def launch_geometry(launch: Any) -> StreamGeometry:
    """A Launch's walks as a geometry (its first output stream as ``out``):
    what a stream kernel's ring is sized and scheduled over."""
    ins, outs = launch_walks(launch)
    return StreamGeometry(grid=tuple(launch.grid), ins=ins, out=outs[0],
                          out_shape=tuple(launch.out_shapes[0].shape))


def ring_stream_scan(launch: Any, x: torch.Tensor, ring: RingProgram
                     ) -> Tuple[torch.Tensor]:
    """R15: K14's scan in one pass that reads x once: CTAs take SCAN_TILE
    tiles by ticket, in increasing order, through a ring of
    ``ring.depths[0]`` tile slots (the ring's unit is K14's tile, four of
    the Launch's blocks), and each tile finds its offset from its
    predecessors' published totals as K14's second pass finds it; K14's
    bits.  One memset of the call's state (:func:`scan_state_words`), then
    one launch."""
    name = "ring_stream_scan"
    dev = _checked_scan(name, launch, x)
    geo = launch_geometry(launch)
    reason = _ring_budget_refusal(name, geo, x.dtype, ring,
                                  _staged_bytes(name, (), geo))
    if reason is not None:
        raise ValueError(reason)
    x = _aligned16(x)
    tiles = -(-x.numel() // SCAN_TILE)
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    nwords = scan_state_words(tiles)
    words = torch.empty(nwords, dtype=torch.int64, device=dev)
    dr = device_ring(name, geo, ring, x.dtype)
    _launch(name, dev, x.data_ptr(), _DTYPE_CODE[x.dtype], out.data_ptr(),
            words.data_ptr(), x.numel(), tiles, nwords,
            ctypes.byref(_ring_arg(dr)),
            dr.ring_bytes + _staged_bytes(name, (), geo))
    return (out,)


def stream_fft(launch: Any, xr: torch.Tensor, xi: torch.Tensor,
               wr: torch.Tensor, wi: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K15: the forward DFT of every row of (xr, xi) (rows, n), n a power
    of two, by the reference's Stockham stages and twiddle tables (wr, wi)
    (log2 n, n/2), f32 out: one CTA a row up to FFT_SMEM_POINTS points
    (FFT_RADIX_LOG2 stages at a time in registers), else one global pass a
    stage."""
    name = "stream_fft"
    dev = _checked_operands(name, (xr, xi), _FLOATS)
    _checked_operands(name, (wr, wi), (torch.float32,))
    if wr.device != dev:
        raise ValueError(f"{name}: twiddles on {wr.device}, not {dev}")
    rows, n = _power_of_two_rows(name, xr)
    stages = n.bit_length() - 1
    if xi.shape != xr.shape or tuple(wr.shape) != (stages, n // 2) \
            or wi.shape != wr.shape:
        raise ValueError(f"{name}: needs re and im (rows, n) and twiddles "
                         f"({stages}, {n // 2}), got {tuple(xr.shape)}, "
                         f"{tuple(xi.shape)}, {tuple(wr.shape)} and "
                         f"{tuple(wi.shape)}")
    row = BlockAGU((1, n), (0, 0), ((1, 0),))
    tw = BlockAGU((stages, n // 2), (0, 0), ((0, 0),))
    _checked_launch(name, launch, (rows,), (row, row, tw, tw), (row, row),
                    (((rows, n), torch.float32),) * 2, (), ("parallel",))
    reason = _smem_refusal(name, dev, n)
    if reason is not None:
        raise ValueError(reason)
    yr, yi = (torch.empty((rows, n), dtype=torch.float32, device=dev)
              for _ in range(2))
    # the global passes ping-pong between the output and a scratch pair
    tmp = [torch.empty((rows, n), dtype=torch.float32, device=dev)
           for _ in range(2)] if n > FFT_SMEM_POINTS else []
    ptrs = [t.data_ptr() for t in tmp] or [None, None]
    _launch(name, dev, xr.data_ptr(), xi.data_ptr(), _DTYPE_CODE[xr.dtype],
            wr.data_ptr(), wi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            *ptrs, rows, n, stages)
    return yr, yi


def stream_bitonic(launch: Any, x: torch.Tensor) -> Tuple[torch.Tensor]:
    """K16: every row of x (rows, n), n a power of two, through the
    ascending bitonic network, dtype kept; min and max are selects on the
    bits with jnp's order: NaN propagates, −0 < +0."""
    name = "stream_bitonic"
    dev = _checked_operands(name, (x,), _FLOATS + (torch.int32,))
    rows, n = _power_of_two_rows(name, x)
    row = BlockAGU((1, n), (0, 0), ((1, 0),))
    _checked_launch(name, launch, (rows,), (row,), (row,),
                    (((rows, n), x.dtype),), (), ("parallel",))
    reason = _smem_refusal(name, dev)
    if reason is not None:
        raise ValueError(reason)
    x = _aligned16(x)
    out = torch.empty_like(x)
    _launch(name, dev, x.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
            rows, n)
    return (out,)


#: Body op → the stream kernel that runs a StreamKernel's Launch on the
#: card, called as ``kernel(launch, *arrays) -> tuple of outputs``.
STREAM_KERNELS: Dict[str, Callable[..., tuple]] = {
    "scan": stream_scan,
    "fft": stream_fft,
    "bitonic": stream_bitonic,
}
#: Body op → the ring kernel that runs a StreamKernel's Launch at a depth
#: above 2 on a grid of more than one step, called as ``kernel(launch,
#: *arrays, ring=...)``.  The FFT and the sort run a one-step grid, which
#: never stages.
STREAM_RING_KERNELS: Dict[str, Callable[..., tuple]] = {
    "scan": ring_stream_scan,
}


# -- the chained kernel (ChainedKernel) ------------------------------------------
#
# K17 runs a ChainedKernel's Launch: the producer body on each step's blocks,
# the value rounded to the output dtype, the consumer body on it, the block
# written through the one output stream.  The bodies are named by their ops
# (CHAINED_PROGRAMS); every block is the output block.


def chained_geometry(launch: Any) -> StreamGeometry:
    """A ChainedKernel's Launch as the geometry K17 walks: the read streams'
    walks and the one output stream's; raises when an index map is not
    affine or the Launch writes another number of streams than one."""
    outs = launch_walks(launch)[1]
    if len(outs) != 1 or len(launch.out_shapes) != 1:
        raise ValueError(f"a chained kernel writes one output stream; the "
                         f"Launch has {len(outs)} streams and "
                         f"{len(launch.out_shapes)} out_shapes")
    return launch_geometry(launch)


def _chained_refusal(pair: Tuple[Optional[str], Optional[str]],
                     geo: StreamGeometry, dtype: torch.dtype,
                     out_dtype: torch.dtype,
                     ring: Optional[RingProgram] = None) -> Optional[str]:
    """Why K17 (with ``ring``: R5) refuses the pair of body ops on this
    geometry at these dtypes, or None: a program it has, its producer's
    streams, one float dtype throughout, every block the 2-D output block,
    an output walk that writes each block once, and R5's ring within the
    shared memory a CTA may opt into."""
    name = "chained_map" if ring is None else "ring_chained_map"
    if pair not in CHAINED_PROGRAMS:
        return (f"{name}: no program for producer op {pair[0]!r} → consumer "
                f"op {pair[1]!r}; it runs {sorted(CHAINED_PROGRAMS)}")
    n_in = CHAINED_PRODUCERS[pair[0]][0]
    if len(geo.ins) != n_in:
        return (f"{name}: producer {pair[0]!r} takes {n_in} streams, the "
                f"Launch has {len(geo.ins)}")
    if dtype not in _FLOATS or out_dtype != dtype:
        return (f"{name}: takes one dtype of {[str(d) for d in _FLOATS]} for "
                f"every stream and the output, got {dtype} → {out_dtype}")
    if len(geo.grid) > SSR_MAX_AXES:
        return f"{name}: grid {geo.grid} has more than {SSR_MAX_AXES} axes"
    blocks = {a.block for a in (*geo.ins, geo.out)}
    if len(blocks) != 1 or len(geo.out.block) != 2 or \
            len(geo.out_shape) != 2:
        return (f"{name}: every stream needs the 2-D output block "
                f"{geo.out.block} of a 2-D output, got "
                f"{[a.block for a in geo.ins]} → {geo.out_shape}")
    if math.prod(geo.out.block) >= 2 ** 31:
        return (f"{name}: block {geo.out.block} has 2**31 or more elements; "
                "the kernels index blocks in 32 bits")
    if any(g > 1 and not any(c) for c, g in zip(geo.out.coeffs, geo.grid)):
        return (f"{name}: the output walk {geo.out.coeffs} stays put along a "
                f"grid axis of {geo.grid}: steps run concurrently, so each "
                "must write its own block")
    if ring is None:
        return None
    return _ring_budget_refusal(name, geo, dtype, ring)


def chained_map(producer: Callable, consumer: Callable, launch: Any,
                *arrays: torch.Tensor,
                ring: Optional[RingProgram] = None) -> Tuple[torch.Tensor]:
    """K17: every step's out block = consumer(producer(*in blocks)) through
    the Launch's walks, the producer in the storage dtype (α rounded to it),
    its value rounded to the output dtype before the consumer, the
    intermediate in registers; with ``ring`` (a pipelined call) R5, on K17's
    split of the steps, to K17's bits.  ``producer`` and ``consumer`` are
    :class:`~repro_torch.core.ssr.KernelBody`\\ s of a pair of
    :data:`CHAINED_PROGRAMS`; the Launch's scratch is never handed to
    them."""
    pair = (getattr(producer, "op", None), getattr(consumer, "op", None))
    name = "chained_map" if ring is None else "ring_chained_map"
    geo = chained_geometry(launch)
    if not arrays:
        raise ValueError(f"{name}: no operands")
    dev = _checked_operands(name, arrays, _FLOATS)
    if len(arrays) != len(geo.ins):
        raise ValueError(f"{name}: the Launch has {len(geo.ins)} read "
                         f"streams, got {len(arrays)} operands")
    for k, (t, agu) in enumerate(zip(arrays, geo.ins)):
        agu.check_within(geo.grid, tuple(t.shape), f"{name}[{k}]")
    geo.out.check_within(geo.grid, geo.out_shape, f"{name}[out]")
    reason = _chained_refusal(pair, geo, arrays[0].dtype,
                              launch.out_shapes[0].dtype, ring)
    if reason is not None:
        raise ValueError(reason)
    want = CHAINED_PRODUCERS[pair[0]][1]
    for body, n in ((producer, want), (consumer, 0)):
        if getattr(body, "perm", None) is not None or \
                len(getattr(body, "params", ())) != n or \
                getattr(body, "drain", None) is not None:
            raise ValueError(f"{name}: body {body.op!r} takes {n} parameters "
                             "and no permutation or drain")
    alpha = float(producer.params[0]) if want else 0.0
    x = arrays[0]
    ctas, per_cta = _ctas(dev, geo.steps, per_sm=64)
    out = torch.empty(geo.out_shape, dtype=x.dtype, device=dev)
    b = arrays[-1]
    head = (CHAINED_PROGRAMS[pair], x.data_ptr(),
            b.data_ptr() if len(arrays) == 2 else None, out.data_ptr(),
            _DTYPE_CODE[x.dtype],
            _vector_width((*arrays, out), (*geo.ins, geo.out)), alpha,
            ctypes.byref(_grid_arg(geo.grid)),
            ctypes.byref(_stream_arg(geo.ins[0], x)),
            ctypes.byref(_stream_arg(geo.ins[-1], b)),
            ctypes.byref(_stream_arg(geo.out, out)))
    if ring is None:
        _launch("chained_map", dev, *head, ctas, per_cta)
    else:
        dr = device_ring("ring_chained_map", geo, ring, x.dtype)
        _launch("ring_chained_map", dev, *head, ctypes.byref(_ring_arg(dr)),
                dr.ring_bytes, ctas, per_cta)
    return (out,)


# -- the stage kernels: fused chains and DAGs ----------------------------------
#
# A CUDA kernel cannot take the stage bodies, so each family of stages is one
# kernel source, a template over the subset of the family's stages it runs.
# A family names its stages (body ops), the values each stage reads (the
# family's inputs, or another stage's product) and its uniforms.  Within a
# subset a value whose producer runs there stays on chip; any other value
# comes from a stream; the subset's last stage writes its value through the
# map epilogue (a dense intermediate in device memory) or, for the family's
# final stage, through the family's epilogue.


@dataclasses.dataclass(frozen=True)
class _Family:
    """The stages one fused kernel runs: their body ops, the values each
    reads (the family's inputs or another stage's product), what each
    produces, the final stage's call mode, the subsets instantiated, the
    uniforms' shapes, each stage's number of parameters, and the lane
    width its bodies assume (``None``: any).  ``code`` tells apart two
    families of one kernel."""

    kernel: str
    stages: Tuple[str, ...]
    args: Tuple[Tuple[str, ...], ...]
    products: Tuple[str, ...]
    final_mode: str
    subsets: Tuple[Tuple[int, ...], ...]
    code: int = 0
    uniforms: Tuple[Tuple[int, int], ...] = ()
    params: Tuple[int, ...] = (0, 0, 0)
    lanes: Optional[int] = None

    def mode_of(self, subset: Tuple[int, ...]) -> str:
        return self.final_mode if subset[-1] == len(self.stages) - 1 \
            else "map"


_CHAIN_ELEM = (
    _Family("chain_elem", ("sq_diff", "identity"), (("X", "Y"), ("T",)),
            ("T", "S"), "reduce", ((0, 1), (0,), (1,)), code=0,
            params=(0, 0)),
    _Family("chain_elem", ("axpy", "mul"), (("X", "Y"), ("T", "W")),
            ("T", "S"), "reduce", ((0, 1), (0,)), code=1, params=(1, 0)),
)
_DAG_SUBSETS = ((0, 1, 2), (0,), (1,), (2,), (1, 2))
_LAYERNORM = _Family(
    "dag_layernorm", ("ln_centre", "ln_square", "ln_normalise"),
    (("X",), ("C",), ("C", "V")), ("C", "V", "Y"), "map", _DAG_SUBSETS,
    lanes=128)
_SOFTMAX_XENT = _Family(
    "dag_softmax_xent", ("sx_shift", "sx_exp", "sx_loss"),
    (("Z",), ("C",), ("C", "E", "P")), ("C", "E", "L"), "reduce",
    _DAG_SUBSETS, lanes=128)
_MLP = _Family(
    "dag_mlp", ("mlp_hidden", "mlp_out", "mlp_residual"),
    (("X",), ("H",), ("H", "Y")), ("H", "Y", "O"), "map", _DAG_SUBSETS,
    uniforms=((128, 128), (1, 128), (128, 128), (1, 128)), lanes=128)
_FAMILIES: Tuple[_Family, ...] = (*_CHAIN_ELEM, _LAYERNORM, _SOFTMAX_XENT,
                                  _MLP)


class _Resolved(NamedTuple):
    """A program matched against its family: the stage bit mask, the
    stream each value read from device memory comes from, and the
    parameters."""

    family: _Family
    mask: int
    streams: Dict[str, int]
    params: Tuple[float, ...]


def _resolve(name: str, program: Optional[Any]) -> _Resolved:
    """Match ``program`` to a family of kernel ``name``; ValueError with
    the reason when it is none of the kernel's instantiations."""
    if program is None:
        raise ValueError(f"{name}: runs a stage program; none was given")
    for fam in _FAMILIES:
        if fam.kernel != name or not all(op in fam.stages
                                         for op in program.ops):
            continue
        idx = tuple(fam.stages.index(op) for op in program.ops)
        if idx not in fam.subsets:
            have = [tuple(fam.stages[i] for i in sub) for sub in fam.subsets]
            raise ValueError(f"{name}: stages {program.ops} are no "
                             f"instantiation of {fam.stages}; it has {have}")
        if program.mode != fam.mode_of(idx):
            raise ValueError(f"{name}: stages {program.ops} run in "
                             f"{fam.mode_of(idx)} mode, not {program.mode}")
        if program.n_uniform != len(fam.uniforms):
            raise ValueError(f"{name}: takes {len(fam.uniforms)} uniforms, "
                             f"the program has {program.n_uniform}")
        streams: Dict[str, int] = {}
        params: Tuple[float, ...] = ()
        for k, s in enumerate(idx):
            want = fam.args[s]
            got = program.canonical(k)[:len(program.sources[k])]
            if len(got) != len(want):
                raise ValueError(f"{name}: stage {fam.stages[s]} takes "
                                 f"{len(want)} blocks, the program passes "
                                 f"{len(got)}")
            for value, (kind, j) in zip(want, got):
                producer = fam.products.index(value) \
                    if value in fam.products else None
                if kind == "stage":
                    if producer is None or idx[j] != producer:
                        raise ValueError(
                            f"{name}: stage {fam.stages[s]} reads {value} "
                            f"from stage {program.ops[j]}, which does not "
                            "produce it")
                elif producer is not None and producer in idx:
                    raise ValueError(
                        f"{name}: stage {fam.stages[s]} reads {value} from "
                        f"a stream while its producer "
                        f"{fam.stages[producer]} runs in the kernel")
                else:
                    streams.setdefault(value, j)
            p = program.params[k] if program.params else ()
            if len(p) != fam.params[s]:
                raise ValueError(f"{name}: stage {fam.stages[s]} takes "
                                 f"{fam.params[s]} parameters, got {p}")
            params += tuple(float(v) for v in p)
        return _Resolved(fam, sum(1 << s for s in idx), streams, params)
    raise ValueError(f"{name}: no family of this kernel runs stages "
                     f"{program.ops}")


def _stage_refusal(name: str, program: Optional[Any], geo: StreamGeometry,
                   dtype: torch.dtype, dev: torch.device) -> Optional[str]:
    """Why stage kernel ``name`` refuses this program and geometry at
    ``dtype``, or None.  Every stream's block is the policy block (the
    stages' values are elementwise on it); a family that works on rows
    takes 128-wide blocks, one data row per block row; uniforms are whole
    arrays of the family's shapes."""
    try:
        res = _resolve(name, program)
    except ValueError as e:
        return str(e)
    if dtype != torch.float32:
        return f"{name}: takes float32, not {dtype}"
    if len(geo.grid) > SSR_MAX_AXES:
        return f"{name}: grid {geo.grid} has more than {SSR_MAX_AXES} axes"
    n_s = program.n_streams
    if len(geo.ins) != n_s + program.n_uniform:
        return (f"{name}: the program has {n_s} streams and "
                f"{program.n_uniform} uniforms, the schedule "
                f"{len(geo.ins)} read streams")
    blocks = {a.block for a in geo.ins[:n_s]}
    if program.mode == "map":
        blocks.add(geo.out.block)
    elif geo.out.block != (1, 1):
        return f"{name}: a reduce writes one (1, 1) block, not {geo.out.block}"
    if len(blocks) != 1 or len(next(iter(blocks))) != 2:
        return (f"{name}: every stream needs one 2-D block shape, got "
                f"{sorted(blocks)}")
    (block,) = blocks
    if math.prod(block) >= 2 ** 31:
        return (f"{name}: block {block} has 2**31 or more elements; the "
                "kernels index blocks in 32 bits")
    lanes = res.family.lanes
    if lanes is not None and block[1] != lanes:
        return (f"{name}: the {res.family.stages} bodies work on rows of "
                f"{lanes} (one data row per block row); the schedule's "
                f"blocks are {block}")
    for a, want in zip(geo.ins[n_s:], res.family.uniforms):
        if a.block != want or any(any(c) for c in a.coeffs):
            return (f"{name}: uniform block {a.block} is not the whole "
                    f"{want} array at every step")
    if len(geo.out_shape) != 2:
        return f"{name}: output layout {geo.out_shape} is not 2-D"
    return _smem_refusal(name, dev) if dev.type == "cuda" else None


def _stage_reads(name: str, program: Any) -> frozenset:
    """The read streams stage kernel ``name`` fetches running ``program``:
    each value's first stream (a value two stages take is read once)."""
    return frozenset(_resolve(name, program).streams.values())


def _checked_stages(name: str, geo: StreamGeometry,
                    layouts: Sequence[torch.Tensor],
                    program: Optional[Any]) -> Tuple[torch.device,
                                                     _Resolved]:
    """Validate what a stage kernel takes; return the device and the
    program matched to its family."""
    from .ssr import LoweringError

    dev = _checked_operands(name, layouts, (torch.float32,))
    reason = _stage_refusal(name, program, geo, layouts[0].dtype, dev)
    if reason is not None:      # a schedule the kernel does not take
        raise LoweringError(reason)
    for k, (t, agu) in enumerate(zip(layouts, geo.ins)):
        agu.check_within(geo.grid, tuple(t.shape), f"{name}[{k}]")
    geo.out.check_within(geo.grid, geo.out_shape, f"{name}[out]")
    return dev, _resolve(name, program)


def _value_streams(res: _Resolved, names: Sequence[str], geo: StreamGeometry,
                   layouts: Sequence[torch.Tensor]) -> list:
    """(pointer, stream argument) of each named value, in ``names`` order;
    a value kept on chip (or not read) gets a null pointer and the first
    stream's walk."""
    out = []
    for v in names:
        j = res.streams.get(v)
        if j is None:
            out.append((None, _stream_arg(geo.ins[0], layouts[0])))
        else:
            out.append((layouts[j].data_ptr(),
                        _stream_arg(geo.ins[j], layouts[j])))
    return out


def _stage_vec(res: _Resolved, geo: StreamGeometry,
               layouts: Sequence[torch.Tensor], out: torch.Tensor,
               mode: str, n_streams: int) -> int:
    """4 when every stream the kernel reads, every uniform and a map's
    output allow 16-byte accesses, else 1 (f32 only)."""
    used = sorted(set(res.streams.values()))
    tensors = [layouts[j] for j in used] + list(layouts[n_streams:])
    agus = [geo.ins[j] for j in used] + list(geo.ins[n_streams:])
    if mode == "map":
        tensors.append(out)
    return _vector_width(tensors, agus)


def _stage_out(geo: StreamGeometry, dev: torch.device, mode: str,
               ctas: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The output (and per-CTA partials of a reduce) of a stage kernel."""
    out = torch.empty(geo.out_shape, dtype=torch.float32, device=dev)
    if mode == "reduce":
        return out, torch.empty(ctas, dtype=torch.float32, device=dev)
    return out, None


def _f32_out(name: str, out_dtype: torch.dtype) -> None:
    if out_dtype != torch.float32:
        raise TypeError(f"{name}: writes float32, asked for {out_dtype}")


def _read_ring(rname: str, res: _Resolved, names: Sequence[str],
               geo: StreamGeometry, ring: RingProgram,
               staged: int = 0) -> RingProgram:
    """The ring of the values a stage kernel reads from device memory, in
    the order of ``names`` (R6–R9 number their streams so; a value kept on
    chip has none), each as :func:`device_ring` sizes it.  A LoweringError
    naming ``rname`` where the ring, with the ``staged`` bytes, is over the
    budget: the refusal of :func:`accepts`."""
    reads = frozenset(res.streams.values())
    reason = _ring_budget_refusal(rname, geo, torch.float32, ring, staged,
                                  reads)
    if reason is not None:      # a schedule the ring kernel does not take
        from .ssr import LoweringError
        raise LoweringError(reason)
    dr = device_ring(rname, geo, ring, torch.float32, reads)
    at = [res.streams[v] for v in names if v in res.streams]
    return RingProgram(tuple(dr.depths[j] for j in at),
                       tuple(dr.invariant[j] for j in at),
                       tuple(dr.slot_bytes[j] for j in at))


def chain_elem(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
               out_dtype: torch.dtype, acc_dtype: torch.dtype = torch.float32,
               program: Optional[Any] = None,
               ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K5: the elementwise chains: Σ (x − y)², Σ (αx + y)·w fused (the
    intermediate in registers), their map producers (x − y)² and αx + y,
    and Σ t, over the streams' AGU walks.  With ``ring`` (a pipelined call)
    R6, on K5's split of the steps, to K5's bits."""
    dev, res = _checked_stages("chain_elem", geo, layouts, program)
    _f32_out("chain_elem", out_dtype)
    prog = {(0, 3): 0, (1, 3): 1, (0, 1): 2, (1, 1): 3, (0, 2): 4}[
        (res.family.code, res.mask)]
    ctas, per_cta = _ctas(dev, geo.steps, per_sm=8 if program.mode ==
                          "reduce" else 64)
    out, partials = _stage_out(geo, dev, program.mode, ctas)
    names = ("X", "Y", "W") if prog != 4 else ("T", "Y", "W")
    (pa, sa), (pb, sb), (pc, sc) = _value_streams(res, names, geo, layouts)
    so = _stream_arg(geo.out, out)
    vec = _stage_vec(res, geo, layouts, out, program.mode,
                     program.n_streams)
    g = _grid_arg(geo.grid)
    head = (prog, pa, pb, pc, out.data_ptr(),
            res.params[0] if res.params else 0.0, vec, ctypes.byref(g),
            ctypes.byref(sa), ctypes.byref(sb), ctypes.byref(sc),
            ctypes.byref(so))
    tail = (partials.data_ptr() if partials is not None else None, ctas,
            per_cta)
    if ring is None:
        _launch("chain_elem", dev, *head, *tail)
        return out
    dr = _read_ring("ring_chain_elem", res, names, geo, ring)
    _launch("ring_chain_elem", dev, *head, ctypes.byref(_ring_arg(dr)),
            dr.ring_bytes, *tail)
    return out


def dag_layernorm(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                  out_dtype: torch.dtype,
                  acc_dtype: torch.dtype = torch.float32,
                  program: Optional[Any] = None,
                  ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K6: layernorm's diamond x → {C = x − μ, V = C²} → C·rsqrt(mean V + ε)
    on 128-wide rows, any subset of its stages, one warp per row.  With
    ``ring`` (a pipelined call) R7, on K6's split of the steps, to K6's
    bits."""
    dev, res = _checked_stages("dag_layernorm", geo, layouts, program)
    _f32_out("dag_layernorm", out_dtype)
    ctas, per_cta = _ctas(dev, geo.steps, per_sm=8)
    out, _ = _stage_out(geo, dev, "map", ctas)
    names = ("X", "C", "V")
    (px, sx), (pc, sc), (pv, sv) = _value_streams(res, names, geo, layouts)
    g, so = _grid_arg(geo.grid), _stream_arg(geo.out, out)
    head = (res.mask, px, pc, pv, out.data_ptr(),
            _stage_vec(res, geo, layouts, out, "map", program.n_streams),
            ctypes.byref(g), ctypes.byref(sx), ctypes.byref(sc),
            ctypes.byref(sv), ctypes.byref(so))
    if ring is None:
        _launch("dag_layernorm", dev, *head, ctas, per_cta)
        return out
    dr = _read_ring("ring_dag_layernorm", res, names, geo, ring)
    _launch("ring_dag_layernorm", dev, *head, ctypes.byref(_ring_arg(dr)),
            dr.ring_bytes, ctas, per_cta)
    return out


def dag_softmax_xent(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                     out_dtype: torch.dtype,
                     acc_dtype: torch.dtype = torch.float32,
                     program: Optional[Any] = None,
                     ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K7: softmax cross-entropy's diamond z → {C = z − max, E = eᶜ} →
    Σ mask·(lse − p·C) on 128-wide rows, any subset of its stages; the
    loss is folded from per-CTA partials in a fixed order.  With ``ring``
    (a pipelined call) R8, on K7's split and fold, to K7's bits."""
    dev, res = _checked_stages("dag_softmax_xent", geo, layouts, program)
    _f32_out("dag_softmax_xent", out_dtype)
    ctas, per_cta = _ctas(dev, geo.steps, per_sm=8)
    out, partials = _stage_out(geo, dev, program.mode, ctas)
    names = ("Z", "C", "E", "P")
    (pz, sz), (pc, sc), (pe, se), (pp, sp) = _value_streams(res, names, geo,
                                                            layouts)
    g, so = _grid_arg(geo.grid), _stream_arg(geo.out, out)
    head = (res.mask, pz, pc, pe, pp, out.data_ptr(),
            partials.data_ptr() if partials is not None else None,
            _stage_vec(res, geo, layouts, out, program.mode,
                       program.n_streams),
            ctypes.byref(g), ctypes.byref(sz), ctypes.byref(sc),
            ctypes.byref(se), ctypes.byref(sp), ctypes.byref(so))
    if ring is None:
        _launch("dag_softmax_xent", dev, *head, ctas, per_cta)
        return out
    dr = _read_ring("ring_dag_softmax_xent", res, names, geo, ring)
    _launch("ring_dag_softmax_xent", dev, *head,
            ctypes.byref(_ring_arg(dr)), dr.ring_bytes, ctas, per_cta)
    return out


def _prepare_dag_mlp(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                     out_dtype: torch.dtype, program: Optional[Any],
                     ring: Optional[RingProgram]) -> _Prepared:
    """Every check of K8 (or R9), then its launch's arguments.  The entry
    takes x, H and Y (a value it does not read gets the first layout, which
    it never touches), then the uniforms.  The output is a new tensor each
    call, so 16-byte aligned."""
    dev, res = _checked_stages("dag_mlp", geo, layouts, program)
    _f32_out("dag_mlp", out_dtype)
    names = ("X", "H", "Y")
    n = program.n_streams
    order = (*(res.streams.get(v, 0) for v in names), *range(n, n + 4))
    (_, sx), (_, sh), (_, sy) = _value_streams(res, names, geo, layouts)
    used = sorted(set(res.streams.values()))
    vec = _vector_width([layouts[j] for j in used] + list(layouts[n:]),
                        [geo.ins[j] for j in used] + list(geo.ins[n:]))
    if geo.out_shape[1] % vec:
        vec = 1
    head = (res.mask, vec, ctypes.byref(_grid_arg(geo.grid)),
            ctypes.byref(sx), ctypes.byref(sh), ctypes.byref(sy),
            ctypes.byref(_stream_pitch_arg(geo.out, geo.out_shape[1])))
    sms = _card(dev).multi_processor_count
    ctas, per_tile = mlp_split(geo.steps, geo.out.block[0], sms,
                               ring is not None)
    align = (False,) * len(order)
    if ring is None:
        if res.mask == 4:         # the residual alone: 256 rows a CTA turn
            ctas = min(-(-geo.steps * geo.out.block[0] // 256),
                       MLP_RESIDUAL_PER_SM * sms)
        return _Prepared("dag_mlp", dev, tuple(geo.out_shape), torch.float32,
                         align, 0, (*head, ctas), order)
    staged = _staged_bytes("ring_dag_mlp", program.ops, geo, ring)
    dr = _read_ring("ring_dag_mlp", res, names, geo, ring, staged)
    return _Prepared("ring_dag_mlp", dev, tuple(geo.out_shape), torch.float32,
                     align, 0, (*head, ctypes.byref(_ring_arg(dr)),
                                dr.ring_bytes + staged, per_tile, ctas),
                     order)


def dag_mlp(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
            out_dtype: torch.dtype, acc_dtype: torch.dtype = torch.float32,
            program: Optional[Any] = None,
            ring: Optional[RingProgram] = None) -> torch.Tensor:
    """K8: the MLP block's diamond x → H = relu(xW₁ + b₁) → {Y = HW₂ + b₂,
    Y + H} on 128-wide rows, any subset of its stages, in FP32 FMA; W₁ and
    W₂ (uniforms) staged in shared memory once per CTA, 64-row tiles, the
    next one copied in while the CTA multiplies the last.  With ``ring`` (a
    pipelined call) R9: a ring of step blocks landing in K8's tiles
    (:func:`mlp_ring_tiles`), to K8's bits.  Checked and built once per key
    (:func:`_launch_key` and the card's shared memory a CTA)."""
    dev = layouts[0].device
    key = (_launch_key("dag_mlp", ("map", "mlp"), geo, ring, program,
                       out_dtype, acc_dtype, layouts),
           _card(dev).shared_memory_per_block_optin
           if dev.type == "cuda" else None)
    return _run(_prepared(key, lambda: _prepare_dag_mlp(
        geo, layouts, out_dtype, program, ring)), layouts)


def _stage_keys(fam: _Family, value: Any) -> Dict[tuple, Any]:
    """The DEVICE_KERNELS (or RING_KERNELS) entries of one family: one per
    instantiated subset, a single stage under its op, several under their
    tuple, each mapped to ``value``."""
    keys = {}
    for sub in fam.subsets:
        ops = tuple(fam.stages[i] for i in sub)
        keys[(fam.mode_of(sub), ops[0] if len(ops) == 1 else ops)] = value
    return keys


#: (call mode, body op — or the tuple of stage ops of a fused chain or DAG)
#: → the kernel that runs it on the card.
DEVICE_KERNELS: Dict[tuple, Callable[..., torch.Tensor]] = {
    ("reduce", "mul"): reduce_mul,
    ("map", "relu"): map_relu,
    ("nest", "dot"): contract_gemm,
    ("nest", "matvec"): contract_gemv,
    ("nest", "matvec_relu"): contract_gemv_relu,
    **_stage_keys(_CHAIN_ELEM[0], chain_elem),
    **_stage_keys(_CHAIN_ELEM[1], chain_elem),
    **_stage_keys(_LAYERNORM, dag_layernorm),
    **_stage_keys(_SOFTMAX_XENT, dag_softmax_xent),
    **_stage_keys(_MLP, dag_mlp),
    ("nest", "stencil1d"): halo_stencil1d,
    ("nest", "stencil1d_relu"): halo_stencil1d_relu,
    ("nest", "stencil2d"): halo_stencil2d,
    ("nest", "attn_scores"): rescale_attention,
    ("nest", "spmv"): gather_spmv,
    ("nest", "spmm"): gather_spmm,
}
RING_KERNELS.update({**_stage_keys(_LAYERNORM, "ring_dag_layernorm"),
                     **_stage_keys(_SOFTMAX_XENT, "ring_dag_softmax_xent"),
                     **_stage_keys(_MLP, "ring_dag_mlp")})


# -- the four baseline wrappers ---------------------------------------------
#
# They take the padded layouts of the reference's baseline bodies: x and y
# as (rows, 128) with rows a multiple of 8 (``frontend.pad_vector``); A as
# (m, k) with k a multiple of 128 and B as (k, n); A as (m8, n) with m8 a
# multiple of 8 and x as (1, n).

ROWS, LANES = 8, 128


def _checked_base(name: str, tensors: Sequence[torch.Tensor],
                  dtypes: Sequence[torch.dtype]) -> torch.device:
    """Validate what every baseline wrapper's kernel takes; return the
    device."""
    dev = _checked_operands(name, tensors, dtypes)
    reason = _smem_refusal(name, dev)
    if reason is not None:
        raise ValueError(reason)
    return dev


def _row_blocks(name: str, t: torch.Tensor) -> int:
    """(8, 128) blocks of a padded vector layout; at least one."""
    rows, lanes = t.shape
    if lanes != LANES or rows % ROWS or rows == 0:
        raise ValueError(f"{name}: needs a (rows, {LANES}) layout with rows "
                         f"a positive multiple of {ROWS}, got {tuple(t.shape)}")
    return rows // ROWS


def _base_key(name: str, layouts: Sequence[torch.Tensor],
              out_dtype: Optional[torch.dtype]) -> tuple:
    """What B1's, B2's, B5's and B7's checks and launch arguments depend on: the
    wrapper, ``out_dtype`` and the layouts (:func:`_layouts_key`)."""
    return (name, out_dtype, _layouts_key(layouts))


def _prepare_base_reduce(x: torch.Tensor, y: torch.Tensor,
                         out_dtype: torch.dtype) -> _Prepared:
    """Every check of B1, then its launch's arguments: K1's runs."""
    name = "base_reduce"
    dev = _checked_base(name, (x, y), _FLOATS)
    if out_dtype != torch.float32:
        raise TypeError(f"{name}: accumulates in float32, asked for "
                        f"{out_dtype}")
    if x.shape != y.shape:
        raise ValueError(f"{name}: layouts {tuple(x.shape)} and "
                         f"{tuple(y.shape)} differ")
    nblk = _row_blocks(name, x)
    runs, per = reduce_split(nblk, _card(dev).multi_processor_count)[:2]
    return _Prepared(name, dev, (1, 1), torch.float32, (False, False),
                     1 + runs, (_DTYPE_CODE[x.dtype],
                                _vector_width((x, y), ()), nblk, runs, per))


def base_reduce(x: torch.Tensor, y: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B1: Σ promote(x)·promote(y) over the (8, 128) blocks → (1, 1) f32,
    in one launch on K1's runs (:func:`reduce_split`), one CTA a run: each
    thread loads its pack of each stream a block (16 bytes where both
    layouts allow it, else one element an access) and uses it before the
    next block's; the last CTA folds the runs' partials
    (:func:`reduce_mul_model`'s bits at B1's packs).  Checked and built
    once per key (:func:`_base_key`)."""
    key = _base_key("base_reduce", (x, y), out_dtype)
    return _run(_prepared(key, lambda: _prepare_base_reduce(x, y, out_dtype)),
                (x, y))


def _prepare_base_relu(x: torch.Tensor,
                       out_dtype: Optional[torch.dtype]) -> _Prepared:
    """Every check of B2, then its launch's arguments: K2's split."""
    name = "base_relu"
    dev = _checked_base(name, (x,), _FLOATS + (torch.int32,))
    if out_dtype not in (None, x.dtype):
        raise TypeError(f"{name}: keeps the dtype ({x.dtype}), asked for "
                        f"{out_dtype}")
    nblk = _row_blocks(name, x)
    ctas, per_cta = _ctas(dev, nblk, per_sm=MAP_PER_SM)
    return _Prepared(name, dev, tuple(x.shape), x.dtype, (False,), 0,
                     (_DTYPE_CODE[x.dtype], _vector_width((x,), ()), nblk,
                      ctas, per_cta))


def base_relu(x: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """B2: each (8, 128) block → max(0, block), dtype kept, on K2's split
    and CTAs: each thread loads its pack a block (16 bytes where x allows
    it, else one element an access) and stores its relu before the next
    block's load.  Checked and built once per key (:func:`_base_key`)."""
    key = _base_key("base_relu", (x,), out_dtype)
    return _run(_prepared(key, lambda: _prepare_base_relu(x, out_dtype)),
                (x,))


def base_gemm(a: torch.Tensor, b: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B3: C (m, n) = A (m, k) · B (k, n) over 32-wide k chunks, f32
    accumulator (K3's fmaf chain over k), cast to ``out_dtype`` once."""
    dev = _checked_base("base_gemm", (a, b), _FLOATS)
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2 or k % LANES or k == 0:
        raise ValueError(f"base_gemm: needs A (m, k) · B (k, n) with k a "
                         f"positive multiple of {LANES}, got {tuple(a.shape)}"
                         f" · {tuple(b.shape)}")
    if out_dtype not in _FLOATS:
        raise TypeError(f"base_gemm: drains to float32 or bfloat16, asked "
                        f"for {out_dtype}")
    if m == 0 or n == 0:
        raise ValueError(f"base_gemm: empty output ({m}, {n})")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    # 16-byte loads where A and B are f32 and every row starts aligned
    vec = 4 if (a.dtype == torch.float32
                and _vector_width((a, b), ()) == 4) else 1
    _launch("base_gemm", dev, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype], vec, m, n, k)
    return out


def base_gemv(a: torch.Tensor, x: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B4: y (m8, 1) f32, each 8-row panel of A times x (1, n), with x
    re-read from device memory for every panel."""
    dev = _checked_base("base_gemv", (a, x), _FLOATS)
    (m8, n) = a.shape
    if m8 % ROWS or m8 == 0 or n == 0 or tuple(x.shape) != (1, n):
        raise ValueError(f"base_gemv: needs A (m8, n) with m8 a positive "
                         f"multiple of {ROWS} and x (1, n), got "
                         f"{tuple(a.shape)} and {tuple(x.shape)}")
    if out_dtype != torch.float32:
        raise TypeError(f"base_gemv: writes float32, asked for {out_dtype}")
    out = torch.empty((m8, 1), dtype=torch.float32, device=dev)
    _launch("base_gemv", dev, a.data_ptr(), x.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[a.dtype], _vector_width((a, x), ()), m8 // ROWS, n)
    return out


#: B5's grid step: K9's default tile (128 lanes × lanes_tile_factor 4).
STENCIL_TILE = 512
#: B5's split: runs of consecutive steps over BASE_STENCIL_PER_SM CTAs an SM
#: (``csrc/base_stencil1d.cu``'s kMinCtas), all resident at once.
BASE_STENCIL_PER_SM = 16


def _prepare_base_stencil1d(x: torch.Tensor, w: torch.Tensor,
                            out_dtype: torch.dtype) -> _Prepared:
    """Every check of B5, then its launch's arguments: the dtype, the
    tile's loads (16-byte packs where x's base allows them, else one
    element a load) and the split."""
    name = "base_stencil1d"
    dev = _checked_base(name, (x,), _FLOATS)
    _checked_operands(name, (w,), (torch.float32,))
    n = x.shape[1] - (STENCIL_TAPS - 1)
    if x.shape[0] != 1 or n < 1 or tuple(w.shape) != (1, STENCIL_TAPS) \
            or w.device != dev:
        raise ValueError(f"{name}: needs x (1, n + {STENCIL_TAPS - 1})"
                         f" and w (1, {STENCIL_TAPS}) on one device, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    _f32_out(name, out_dtype)
    # every step's tile starts 512 elements on: 16-byte packs where x's
    # base does, whatever n
    vec = 16 // x.element_size() if x.data_ptr() % 16 == 0 else 1
    ctas, per_cta = _ctas(dev, -(-n // STENCIL_TILE),
                          per_sm=BASE_STENCIL_PER_SM)
    return _Prepared(name, dev, (1, n), torch.float32, (False, False), 0,
                     (_DTYPE_CODE[x.dtype], vec, n, ctas, per_cta))


def base_stencil1d(x: torch.Tensor, w: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B5: y (1, n) f32 = Σ_j w[j]·x[i+j] over x (1, n + 10) and the f32
    taps w (1, 11): each step's 512 + 10 inputs staged in shared memory by
    plain loads, then each output's 11 taps read from the tile in tap
    order (:func:`base_stencil1d_model`'s bits).  Checked and built once
    per key (:func:`_base_key`)."""
    key = _base_key("base_stencil1d", (x, w), out_dtype)
    return _run(_prepared(key, lambda: _prepare_base_stencil1d(
        x, w, out_dtype)), (x, w))


def _checked_ell(name: str, vals: torch.Tensor, cidx: torch.Tensor,
                 table: torch.Tensor) -> Tuple[torch.device, int, int]:
    """The baselines' ELL planes: f32 vals and int32 cidx (m, k) and an f32
    table, contiguous 2-D on one CUDA device; returns (device, m, k)."""
    dev = _checked_base(name, (vals, table), (torch.float32,))
    _checked_operands(name, (cidx,), (torch.int32,))
    if cidx.device != dev or cidx.shape != vals.shape or vals.numel() == 0 \
            or table.numel() == 0:
        raise ValueError(f"{name}: needs vals and cidx (m, k) and a table "
                         f"on one device, got {tuple(vals.shape)}, "
                         f"{tuple(cidx.shape)} and {tuple(table.shape)}")
    return dev, vals.shape[0], vals.shape[1]


def base_spmv(vals: torch.Tensor, cidx: torch.Tensor, x: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B6: out (m, 1) f32 = Σ_j vals[i, j]·x[0, clip(cidx[i, j])] over the
    unpadded ELL planes and x (1, n): per element the index is loaded, the
    address computed from it, and the table load and the FMA waited on at
    once; on K12's CTAs (64 rows of four threads)."""
    dev, m, k = _checked_ell("base_spmv", vals, cidx, x)
    if x.shape[0] != 1:
        raise ValueError(f"base_spmv: needs x as (1, n), got "
                         f"{tuple(x.shape)}")
    _f32_out("base_spmv", out_dtype)
    out = torch.empty((m, 1), dtype=torch.float32, device=dev)
    _launch("base_spmv", dev, vals.data_ptr(), cidx.data_ptr(), x.data_ptr(),
            out.data_ptr(), m, k, x.shape[1])
    return out


#: B7's CTA: BASE_SPMM_ROWS consecutive rows a warp at once, four warps,
#: so BASE_SPMM_BAND consecutive rows a CTA (``csrc/base_spmm.cu``), and
#: SPMM_COLS columns a CTA (grid y).
BASE_SPMM_ROWS = 4
BASE_SPMM_BAND = 4 * BASE_SPMM_ROWS
#: The most CUDA allows in grid x and grid y.
_GRID_X_MOST, _GRID_Y_MOST = 2 ** 31 - 1, 65535


def _prepare_base_spmm(vals: torch.Tensor, cidx: torch.Tensor,
                       x: torch.Tensor, out_dtype: torch.dtype) -> _Prepared:
    """Every check of B7, then its launch's arguments: the sizes and the
    segments' loads (16-byte where c % 4 == 0 and X's base allows them,
    else four 4-byte loads a lane)."""
    name = "base_spmm"
    dev, m, k = _checked_ell(name, vals, cidx, x)
    _f32_out(name, out_dtype)
    n, c = x.shape
    if -(-m // BASE_SPMM_BAND) > _GRID_X_MOST \
            or -(-c // SPMM_COLS) > _GRID_Y_MOST:
        raise ValueError(f"{name}: {m} rows in bands of {BASE_SPMM_BAND} and "
                         f"{c} columns in chunks of {SPMM_COLS} exceed the "
                         f"grid ({_GRID_X_MOST} × {_GRID_Y_MOST} CTAs)")
    return _Prepared(name, dev, (m, c), torch.float32, (False,) * 3, 0,
                     (m, k, n, c, _vector_width((x,), ())))


def base_spmm(vals: torch.Tensor, cidx: torch.Tensor, x: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B7: out (m, c) f32 = Σ_j vals[i, j]·X[clip(cidx[i, j]), :] over the
    unpadded ELL planes and X (n, c): each row's index loaded, its address
    computed and clipped, its X segment and value loaded and used before
    its next index; BASE_SPMM_ROWS rows a warp at once, CTAs on bands of
    BASE_SPMM_BAND consecutive rows, 16-byte loads where X allows them
    (:func:`base_spmm_model`'s bits).  Checked and built once per key
    (:func:`_base_key`)."""
    key = _base_key("base_spmm", (vals, cidx, x), out_dtype)
    return _run(_prepared(key, lambda: _prepare_base_spmm(
        vals, cidx, x, out_dtype)), (vals, cidx, x))


def base_scan(x: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B8: the inclusive prefix sum of the padded vector x (rows, 128) in
    f32 on K14's tiles: each CTA walks its tile's (8, 128) blocks in order,
    one explicit load a thread a block, used before the next block's, and
    holds the tile's sums in registers until its offset comes from the
    look-back K14 runs (:func:`base_scan_model`: the bits).  One memset of
    the call's state (:func:`scan_state_words`), then one launch that reads
    x once."""
    name = "base_scan"
    dev = _checked_base(name, (x,), _FLOATS + (torch.int32,))
    _row_blocks(name, x)
    _f32_out(name, out_dtype)
    reason = _smem_refusal(name, dev)
    if reason is not None:
        raise ValueError(reason)
    x = _aligned16(x)
    tiles = -(-x.numel() // SCAN_TILE)
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    nwords = scan_state_words(tiles)
    words = torch.empty(nwords, dtype=torch.int64, device=dev)
    _launch(name, dev, x.data_ptr(), _DTYPE_CODE[x.dtype], out.data_ptr(),
            words.data_ptr(), x.numel(), tiles, nwords)
    return out


#: Body op → the baseline kernel that runs it on the card.  Every wrapper
#: is called as ``kernel(*layouts, out_dtype=...)``, like the plain versions.
BASELINE_KERNELS: Dict[str, Callable[..., torch.Tensor]] = {
    "mul": base_reduce,
    "relu": base_relu,
    "dot": base_gemm,
    "matvec": base_gemv,
    "stencil1d": base_stencil1d,
    "spmv": base_spmv,
    "spmm": base_spmm,
    "scan": base_scan,
}


# -- plain versions ---------------------------------------------------------


def _invariant_block(agu: BlockAGU, t: torch.Tensor) -> torch.Tensor:
    """The one block a walk with no varying coefficient delivers."""
    return t[tuple(slice(o * b, (o + 1) * b)
                   for o, b in zip(agu.offset, agu.block))]


def _step_inputs(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                 steps: Optional[torch.Tensor] = None) -> Tuple[list, tuple]:
    """Every step's blocks of each stream (or those of the given rows of
    :func:`grid_steps`), and their ``vmap`` dims.

    A stream whose walk has no varying coefficient (a loop-invariant block,
    a uniform, a gather table) delivers the same block at every step: it is
    passed once, unbatched (dim ``None``), not gathered ``steps`` times.
    """
    if len(layouts) != len(geo.ins):
        raise ValueError(f"{len(geo.ins)} streams, got {len(layouts)} "
                         "operands")
    for k, (agu, t) in enumerate(zip(geo.ins, layouts)):
        agu.check_within(geo.grid, tuple(t.shape), f"in[{k}]")
    fixed = [not any(any(c) for c in agu.coeffs) for agu in geo.ins]
    if all(fixed):        # vmap needs one batched input
        fixed[0] = False
    blocks = [_invariant_block(agu, t) if f else agu.gather(t, geo.grid,
                                                            steps)
              for agu, t, f in zip(geo.ins, layouts, fixed)]
    return blocks, tuple(None if f else 0 for f in fixed)


def _step_blocks(geo: StreamGeometry,
                 layouts: Sequence[torch.Tensor]) -> list:
    """Every step's blocks of each stream, gathered ``(steps, *block)``."""
    blocks, dims = _step_inputs(geo, layouts)
    return [b.expand(geo.steps, *b.shape) if d is None else b
            for b, d in zip(blocks, dims)]


def _halo_widen(parts: Sequence[torch.Tensor], halo: Any) -> torch.Tensor:
    """Stitch a halo's ``2**k`` shifted blocks into one widened block.

    Pass ``j`` pairs the blocks differing only in halo bit ``j`` (adjacent
    after earlier passes), concatenates each pair along that level's block
    axis and keeps the first ``tile + w - 1`` columns, as the reference's
    ``_halo_widen`` does.
    """
    for ax, t, w in zip(halo.axes, halo.tiles, halo.windows):
        parts = [torch.cat([parts[m], parts[m + 1]], dim=ax).narrow(
            ax, 0, t + w - 1) for m in range(0, len(parts), 2)]
    return parts[0]


def _widened(geo: StreamGeometry, blocks: Sequence[torch.Tensor]) -> list:
    """One step's blocks as the body takes them: each halo's shifted blocks
    widened into one, in the first slot's place."""
    if not geo.halos:
        return list(blocks)
    first = {h.slots[0]: h for h in geo.halos}
    twins = {s for h in geo.halos for s in h.slots[1:]}
    return [_halo_widen([blocks[s] for s in first[k].slots], first[k])
            if k in first else b
            for k, b in enumerate(blocks) if k not in twins]


def _each_step(fn: Callable, geo: StreamGeometry,
               layouts: Sequence[torch.Tensor],
               inputs: Optional[Tuple[list, tuple]] = None) -> torch.Tensor:
    """``fn`` applied to every step's blocks at once: (steps, *partial).
    ``inputs`` are the blocks and their ``vmap`` dims as delivered (by the
    ring), else :func:`_step_inputs` gathers them."""
    blocks, dims = inputs or _step_inputs(geo, layouts)
    return torch.vmap(lambda *b: fn(*_widened(geo, b)), in_dims=dims)(*blocks)


def _write_blocks(geo: StreamGeometry, blocks: torch.Tensor,
                  out_dtype: torch.dtype, every: int = 1) -> torch.Tensor:
    """Scatter one block per ``every`` steps through the output stream."""
    out = torch.zeros(geo.out_shape, dtype=out_dtype, device=blocks.device)
    idx = geo.out.element_index(geo.grid, geo.out_shape, blocks.device)
    out.view(-1)[idx[::every]] = blocks.to(out_dtype)
    return out


def _reduce_epilogue(parts: torch.Tensor, geo: StreamGeometry,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Accumulate every step's partial, fold once → (1, 1).

    A block-shaped partial sums into a (rows, lanes) vector accumulator
    folded to the scalar at the end; a scalar partial into a (1, 1) one.
    """
    parts = parts.to(out_dtype)
    shape = tuple(parts.shape[1:])
    vector = len(shape) == 2 and math.prod(shape) > 1
    acc = parts.reshape(geo.steps, *(shape if vector else (1, 1))).sum(0)
    return acc.sum().reshape(1, 1) if vector else acc


def _map_epilogue(parts: torch.Tensor, geo: StreamGeometry,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Each step's block → the dense write stream."""
    parts = parts.to(out_dtype).reshape(geo.steps, *geo.out.block)
    return _write_blocks(geo, parts, out_dtype)


def plain_reduce(body: Callable, geo: StreamGeometry,
                 layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
                 acc_dtype: torch.dtype = torch.float32,
                 inputs: Optional[Tuple[list, tuple]] = None) -> torch.Tensor:
    """Reduce epilogue: accumulate every step's partial, fold once → (1, 1)
    (see :func:`_reduce_epilogue`)."""
    return _reduce_epilogue(_each_step(body, geo, layouts, inputs), geo,
                            out_dtype)


def plain_map(body: Callable, geo: StreamGeometry,
              layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
              acc_dtype: torch.dtype = torch.float32,
              inputs: Optional[Tuple[list, tuple]] = None) -> torch.Tensor:
    """Map epilogue: each step's body block → the dense write stream."""
    return _map_epilogue(_each_step(body, geo, layouts, inputs), geo,
                         out_dtype)


#: Gathered elements the plain version of a gather holds at once: it runs
#: over chunks of whole output blocks' steps, so the peak stays near 1 GiB
#: (the gathered values with their int64 addresses) whatever the grid.
PLAIN_GATHER_ELEMS = 1 << 25


def _plain_gather_contract(body: Callable, geo: StreamGeometry,
                           layouts: Sequence[torch.Tensor],
                           out_dtype: torch.dtype, acc_dtype: torch.dtype,
                           ring: Optional[RingProgram] = None,
                           taken: Optional[Sequence[Sequence[int]]] = None
                           ) -> torch.Tensor:
    """:func:`plain_contract` with gathers, over chunks of grid steps.

    Per step the body receives the streamed blocks (halos widened), then
    each gather's block of the table (:meth:`GatherAGU.gather`); the
    tables are the trailing read streams.  A chunk is a whole number of
    output blocks' contraction steps, so each output block is summed and
    drained as in :func:`plain_contract`.  With ``ring`` and its ``taken``
    steps (:func:`ring_taken`) the streamed blocks are the ones the ring
    delivers (:func:`ring_blocks`), a chunk at a time, and each gather's
    addresses come from the index block delivered
    (:meth:`GatherAGU.gather_delivered`), its extent mask and affine levels
    from the step that computes.
    """
    n_s = len(geo.ins) - len(geo.gathers)     # the tables trail
    layouts = _walk_layouts(geo, layouts)
    dev = layouts[0].device
    z = geo.contraction_steps
    per_step = sum(math.prod(g.tiles) * math.prod(geo.ins[g.index].block)
                   for g in geo.gathers)
    chunk = z * max(1, PLAIN_GATHER_ELEMS // max(1, per_step * z))
    drain = getattr(body, "drain", None) or (lambda t: t)
    steps = grid_steps(geo.grid, dev)
    out = torch.zeros(geo.out_shape, dtype=out_dtype, device=dev)
    for s0 in range(0, geo.steps, chunk):
        at = steps[s0:s0 + chunk]
        if taken is None:
            blocks, dims = _step_inputs(geo, layouts, at)
            gathered = [g.gather(geo.ins[g.index], geo.grid,
                                 layouts[g.index], layouts[g.table], at)
                        for g in geo.gathers]
        else:
            blocks, dims = ring_blocks(geo, layouts, ring, taken, s0,
                                       s0 + chunk)
            gathered = [g.gather_delivered(
                _batched(blocks[g.index], dims[g.index], len(at)),
                geo.ins[g.index], geo.grid, tuple(layouts[g.index].shape),
                layouts[g.table], at) for g in geo.gathers]
        parts = torch.vmap(
            lambda *b: body(*_widened(geo, b[:n_s]), *b[n_s:]),
            in_dims=(*dims[:n_s], *(0,) * len(gathered)))(
                *blocks[:n_s], *gathered)
        parts = parts.to(acc_dtype).reshape(-1, z, *geo.out.block).sum(1)
        idx = geo.out.element_index(geo.grid, geo.out_shape, dev, at[::z])
        out.view(-1)[idx] = drain(parts).to(out_dtype)
    return out


def _walk_layouts(geo: StreamGeometry,
                  layouts: Sequence[torch.Tensor]) -> list:
    """The layouts, each narrower than its stream's walk (K12's unpadded
    planes) zero-padded to it, as the lowering pads them: the plain
    version reads whole blocks, and the positions past the planes hold
    (0.0, 0), outside the gather's extent, whatever their pitch."""
    out = []
    for t, agu in zip(layouts, geo.ins):
        if t.dim() == 2:
            (_, rows), (_, cols) = agu.span(geo.grid)
            if rows > t.shape[0] or cols > t.shape[1]:
                t = F.pad(t, (0, max(0, cols - t.shape[1]),
                              0, max(0, rows - t.shape[0])))
        out.append(t)
    return out + list(layouts[len(geo.ins):])


def _batched(block: torch.Tensor, dim: Optional[int],
             steps: int) -> torch.Tensor:
    """A delivered block per step: an unbatched (invariant) one repeated."""
    return block.expand(steps, *block.shape) if dim is None else block


def plain_contract(body: Callable, geo: StreamGeometry,
                   layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
                   acc_dtype: torch.dtype = torch.float32,
                   inputs: Optional[Tuple[list, tuple]] = None
                   ) -> torch.Tensor:
    """Level-mapped epilogue: accumulate over the contraction steps, drain.

    The contraction axes trail the grid, so the visits of one output block
    are ``contraction_steps`` consecutive steps; their partials sum in
    ``acc_dtype``, the body's ``drain`` (if any) applies to each sum once,
    and the result is cast to ``out_dtype``.  Without contraction axes every
    step writes its own block.  A call with gathers runs
    :func:`_plain_gather_contract`.
    """
    if geo.gathers:
        return _plain_gather_contract(body, geo, layouts, out_dtype,
                                      acc_dtype)
    parts = _each_step(body, geo, layouts, inputs)
    drain = getattr(body, "drain", None) or (lambda t: t)
    if not geo.contraction_axes:
        parts = drain(parts).to(out_dtype).reshape(geo.steps, *geo.out.block)
        return _write_blocks(geo, parts, out_dtype)
    z = geo.contraction_steps
    acc = parts.to(acc_dtype).reshape(-1, z, *geo.out.block).sum(1)
    return _write_blocks(geo, drain(acc), out_dtype, every=z)


def plain_stages(bodies: Sequence[Callable], program: StageProgram,
                 mode: str, geo: StreamGeometry,
                 layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
                 acc_dtype: torch.dtype = torch.float32,
                 inputs: Optional[Tuple[list, tuple]] = None) -> torch.Tensor:
    """A stage program's plain version: on every step's blocks at once (as
    delivered, by the ring: ``inputs``), run the stages in order — each
    carried value cast to ``out_dtype`` and shaped as the policy block, as
    the reference writes it to its scratch slot — and apply the final
    stage's map or reduce epilogue."""
    n_s = program.n_streams

    def step(*xs):
        uni = xs[n_s:]
        vals: list = []
        for k, body in enumerate(bodies):
            args = [vals[j] if kind == "stage" else xs[j]
                    for kind, j in program.sources[k]]
            cur = body(*args, *uni)
            if k < len(bodies) - 1:
                cur = torch.as_tensor(cur).to(out_dtype).reshape(
                    program.block)
            vals.append(cur)
        return vals[-1]

    parts = _each_step(step, geo, layouts, inputs)
    if mode == "reduce":
        return _reduce_epilogue(parts, geo, out_dtype)
    if mode == "map":
        return _map_epilogue(parts, geo, out_dtype)
    raise ValueError(f"stage programs run in map or reduce mode, not {mode!r}")


RESCALE_FILL = -1e30   # the initial running max (and the masks' fill)


def plain_rescale(body: Callable, geo: StreamGeometry,
                  layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
                  acc_dtype: torch.dtype = torch.float32,
                  inputs: Optional[Tuple[list, tuple]] = None
                  ) -> torch.Tensor:
    """Online-softmax epilogue: per output block, the m/l/acc recurrence
    over its kv steps in grid order, drained as ``acc / max(l, 1e-30)``.

    ``body(*blocks, offs)`` returns the masked score block ``s`` and the
    value block ``v`` of one step (``offs``: the step's global offset of
    every loop level); ``m`` starts at ``RESCALE_FILL``.  The parallel steps
    run at once (``torch.vmap``).  3-D layouts are a head batch: each head
    runs alike and the heads stack.  ``inputs`` are one head's blocks as
    delivered (by the ring: :func:`plain_ring`).
    """
    if layouts and layouts[0].dim() == 3:
        return torch.stack([plain_rescale(body, geo, [t[h] for t in layouts],
                                          out_dtype, acc_dtype)
                            for h in range(layouts[0].shape[0])])
    blocks, dims = inputs or _step_inputs(geo, layouts)
    z = geo.contraction_steps
    par = geo.steps // z
    steps = grid_steps(geo.grid, layouts[0].device)
    offs = torch.stack([steps[:, a] * t for a, t in geo.level_tiles], dim=1)
    blocks = [b.reshape(par, z, *b.shape[1:]) if d == 0 else b
              for b, d in zip(blocks, dims)]

    def one(*args):
        *blks, off = args
        for j in range(z):
            step = [b[j] if d == 0 else b for b, d in zip(blks, dims)]
            s, v = body(*_widened(geo, step),
                        tuple(off[j][i] for i in range(off.shape[-1])))
            s = s.to(acc_dtype)
            if j == 0:
                m = torch.full((s.shape[0], 1), RESCALE_FILL,
                               dtype=acc_dtype, device=s.device)
                l = torch.zeros_like(m)
                acc = torch.zeros((s.shape[0], v.shape[-1]), dtype=acc_dtype,
                                  device=s.device)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ v.to(acc_dtype)
            m = m_new
        return acc / torch.clamp(l, min=1e-30)

    out = torch.vmap(one, in_dims=(*dims, 0))(*blocks,
                                              offs.reshape(par, z, -1))
    return _write_blocks(geo, out.to(out_dtype), out_dtype, every=z)


def plain_stream(body: Callable, launch: Any,
                 arrays: Sequence[torch.Tensor],
                 ring: Optional[RingProgram] = None,
                 steps_per_cta: Optional[int] = None) -> tuple:
    """A stream kernel's Launch as an in-order block walk: the counterpart
    of the reference's sequential Pallas grid.

    Leading ``parallel`` axes are independent instances, batched as
    ``vmap`` batches a kernel; the remaining axes (``arbitrary``, or all of
    them when the Launch declares no semantics) are walked in row-major
    order, calling ``body(step, *in_blocks, *scratch) -> (out_blocks,
    scratch)`` with ``step`` counting from 0 and the scratch (zeros at
    first) carried from step to step.  A stream whose walk never moves is
    handed its one block unbatched.  With ``ring`` (a pipelined call) the
    moving streams' blocks are the ones it delivers over the flat grid
    (:func:`ring_delivery`, in runs of ``steps_per_cta`` steps; one run by
    default), the carry threaded as without it.  Returns the outputs,
    blocks a step leaves unwritten zero."""
    grid = tuple(launch.grid)
    sem = tuple(launch.dimension_semantics or ("arbitrary",) * len(grid))
    par = 0
    while par < len(grid) and sem[par] == "parallel":
        par += 1
    if "parallel" in sem[par:]:
        raise ValueError(f"parallel axes must lead the grid, got {sem}")
    n_par, n_seq = math.prod(grid[:par]), math.prod(grid[par:])
    ins, outs = launch_walks(launch)
    dev = arrays[0].device
    blocks, dims = [], []
    for k, (agu, t) in enumerate(zip(ins, arrays)):
        agu.check_within(grid, tuple(t.shape), f"in[{k}]")
    if ring is not None:
        delivered = ring_delivery(launch_geometry(launch), arrays, ring,
                                  steps_per_cta)[0][0]
    for k, (agu, t) in enumerate(zip(ins, arrays)):
        if not any(any(c) for c in agu.coeffs):
            blocks.append(_invariant_block(agu, t))
            dims.append(None)
        else:
            got = agu.gather(t, grid) if ring is None else delivered[k]
            blocks.append(got.reshape(n_par, n_seq, *agu.block))
            dims.append(0)
    batched = n_par > 1
    lead = (n_par,) if batched else ()
    scratch = tuple(torch.zeros((*lead, *sh.shape), dtype=sh.dtype,
                                device=dev) for sh in launch.scratch_shapes)
    results = []
    for step in range(n_seq):
        at = [b if d is None else (b[:, step] if batched else b[0, step])
              for b, d in zip(blocks, dims)]
        if batched:
            fn = torch.vmap(functools.partial(body, step),
                            in_dims=(*dims, *([0] * len(scratch))))
            got, scratch = fn(*at, *scratch)
        else:
            got, scratch = body(step, *at, *scratch)
        results.append(tuple(got))
    out = []
    for k, (agu, sh) in enumerate(zip(outs, launch.out_shapes)):
        o = torch.zeros(tuple(sh.shape), dtype=sh.dtype, device=dev)
        agu.check_within(grid, tuple(sh.shape), f"out[{k}]")
        if results:
            blk = torch.stack([r[k] for r in results],
                              dim=1 if batched else 0)
            idx = agu.element_index(grid, tuple(sh.shape), dev)
            o.view(-1)[idx.reshape(-1)] = blk.reshape(-1).to(sh.dtype)
        out.append(o)
    return tuple(out)


PLAIN: Dict[str, Callable[..., torch.Tensor]] = {
    "reduce": plain_reduce, "map": plain_map, "nest": plain_contract,
    "rescale": plain_rescale}


def ring_taken(geo: StreamGeometry, ring: RingProgram,
               steps_per_cta: Optional[int] = None
               ) -> Tuple[list, list]:
    """The ring's schedule over the whole grid: per stream the grid step
    whose block each step takes, and the fetch log.

    The grid runs as runs of ``steps_per_cta`` consecutive steps (one run
    by default: the reference's single core).  Each run starts with an
    empty ring of ``ring.depths[i]`` slots a stream, primes
    :meth:`RingProgram.prime` fetches, and at each of its steps ``s``
    first starts the fetch of step ``s + d − 1`` (if the run has it) into
    slot ``(s + d − 1) % d``, then takes the block of slot ``s % d``; an
    invariant stream is fetched once into slot 0 and taken from there.  The
    slots hold the grid step of the block they were last filled with, so a
    slot read too early or refilled too soon hands its step another step's
    block.  The log is ``(stream, step, slot)`` in issue order, ``step``
    counted over the whole grid.
    """
    steps = geo.steps
    run = steps_per_cta or steps
    held = [[-1] * (1 if inv else d)
            for d, inv in zip(ring.depths, ring.invariant)]
    taken = [[-1] * steps for _ in geo.ins]
    log = []

    def fetch(i: int, step: int, slot: int) -> None:
        held[i][slot] = step
        log.append((i, step, slot))

    streams = range(len(geo.ins))
    for s0 in range(0, steps, run):
        n = min(run, steps - s0)
        for i in streams:
            for j in range(ring.prime(i, n)):
                fetch(i, s0 + j, j)
        for s in range(n):
            for i in streams:
                t = s + ring.depths[i] - 1
                if not ring.invariant[i] and t < n:
                    fetch(i, s0 + t, t % ring.depths[i])
            for i in streams:
                taken[i][s0 + s] = held[i][0 if ring.invariant[i]
                                           else s % ring.depths[i]]
    return taken, log


def ring_blocks(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                ring: RingProgram, taken: Sequence[Sequence[int]],
                start: int = 0, stop: Optional[int] = None
                ) -> Tuple[list, tuple]:
    """The blocks of steps ``start`` … ``stop`` as the ring delivers them
    (``taken``: :func:`ring_taken`'s), in the form the plain versions take
    them: the blocks and their ``vmap`` dims.  An invariant stream is
    handed its one block unbatched, as the gathering plain versions hand it
    (vmap needs one batched input, so the first stream is batched when
    every stream is invariant)."""
    stop = geo.steps if stop is None else stop
    fixed = list(ring.invariant) if not all(ring.invariant) else \
        [False] + list(ring.invariant[1:])
    blocks = []
    for agu, t, at, f in zip(geo.ins, layouts, taken, fixed):
        if f:
            blocks.append(_invariant_block(agu, t))
            continue
        at = torch.tensor(at[start:stop], dtype=torch.int64, device=t.device)
        blocks.append(agu.gather(t, geo.grid,
                                 grid_steps(geo.grid, t.device)[at]))
    return blocks, tuple(None if f else 0 for f in fixed)


def ring_delivery(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                  ring: RingProgram, steps_per_cta: Optional[int] = None
                  ) -> Tuple[Tuple[list, tuple], list]:
    """Every step's blocks of each stream as ``ring`` delivers them
    (:func:`ring_blocks` over the whole grid), and the fetch log
    (:func:`ring_taken`)."""
    taken, log = ring_taken(geo, ring, steps_per_cta)
    return ring_blocks(geo, layouts, ring, taken), log


def plain_ring(body: Callable, geo: StreamGeometry,
               layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
               acc_dtype: torch.dtype = torch.float32, *, mode: str,
               ring: RingProgram, steps_per_cta: Optional[int] = None
               ) -> Tuple[torch.Tensor, list]:
    """A pipelined kernel's plain version: the blocks of
    :func:`plain_reduce`, :func:`plain_map`, :func:`plain_contract` or
    :func:`plain_rescale` (``mode``, a key of :data:`PLAIN`: the kernel's
    ``plain_kind``) delivered through ``ring`` (:func:`ring_delivery`), then
    the same computation; a contraction with gathers takes the delivered
    blocks a chunk of steps at a time (:func:`_plain_gather_contract`).  3-D
    layouts are a head batch: each head through the ring alike, the results
    stacked.  Returns the result and the fetch log (one head's)."""
    if layouts and layouts[0].dim() == 3:
        runs = [plain_ring(body, geo, [t[h] for t in layouts], out_dtype,
                           acc_dtype, mode=mode, ring=ring,
                           steps_per_cta=steps_per_cta)
                for h in range(layouts[0].shape[0])]
        return torch.stack([r[0] for r in runs]), runs[0][1]
    taken, log = ring_taken(geo, ring, steps_per_cta)
    if mode == "nest" and geo.gathers:
        return _plain_gather_contract(body, geo, layouts, out_dtype,
                                      acc_dtype, ring, taken), log
    out = PLAIN[mode](body, geo, layouts, out_dtype, acc_dtype,
                      inputs=ring_blocks(geo, layouts, ring, taken))
    return out, log


def _chained_step(producer: Callable, consumer: Callable,
                  block: Tuple[int, ...], out_dtype: torch.dtype) -> Callable:
    """One step of a ChainedKernel: the producer's value cast to the output
    dtype and shaped as the output block (the reference's scratch block),
    the consumer's value likewise."""
    def step(*blocks: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(producer(*blocks)).to(out_dtype).reshape(block)
        return torch.as_tensor(consumer(t)).to(out_dtype).reshape(block)
    return step


def plain_chained(producer: Callable, consumer: Callable, launch: Any,
                  arrays: Sequence[torch.Tensor],
                  ring: Optional[RingProgram] = None) -> Tuple[torch.Tensor]:
    """K17's plain version (and, with ``ring``, R5's): a ChainedKernel's
    Launch as a block walk of :func:`_chained_step` — every step at once,
    the grid's steps being independent (no scratch is carried: the Launch's
    own is never handed to the bodies); with ``ring`` the blocks arrive
    through it (:func:`ring_delivery`).  Blocks no step writes stay zero."""
    geo = chained_geometry(launch)
    out_dtype = launch.out_shapes[0].dtype
    step = _chained_step(producer, consumer, geo.out.block, out_dtype)
    inputs = None if ring is None else ring_delivery(geo, arrays, ring)[0]
    return (plain_map(step, geo, arrays, out_dtype, inputs=inputs),)


# -- plain versions of the baselines ------------------------------------------
#
# The reference's baseline bodies on the same padded layouts: the same
# (8, 128) blocks, 128-wide k chunks and 8-row panels, promoted to f32.


def _promote(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def plain_base_reduce(x: torch.Tensor, y: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Each (8, 128) block's Σ promote(x)·promote(y), summed → (1, 1)."""
    blocks = x.reshape(-1, ROWS * LANES), y.reshape(-1, ROWS * LANES)
    parts = (_promote(blocks[0]) * _promote(blocks[1])).sum(1)
    return parts.sum().reshape(1, 1).to(out_dtype)


def plain_base_map(fn: Callable, x: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``fn`` on each (8, 128) block, written in place of the block."""
    blocks = x.reshape(-1, ROWS, LANES)
    out = torch.vmap(fn)(blocks).reshape(x.shape)
    return out.to(out_dtype or x.dtype)


def plain_base_gemm(a: torch.Tensor, b: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """acc (m, n) += A[:, kc] · B[kc, :] over 128-wide k chunks, in f32."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    bk = min(a.shape[1], LANES)
    for k0 in range(0, a.shape[1], bk):
        acc += _promote(a[:, k0:k0 + bk]) @ _promote(b[k0:k0 + bk, :])
    return acc.to(out_dtype)


def plain_base_stencil1d(x: torch.Tensor, w: torch.Tensor,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """acc (1, n) += w[0, j]·x[:, j:j + n] over the taps, from zero, in f32
    (the baseline body's dynamic slices)."""
    taps = w.shape[1]
    n = x.shape[1] - (taps - 1)
    xf, wf = _promote(x), _promote(w)
    acc = torch.zeros((1, n), dtype=torch.float32, device=x.device)
    for j in range(taps):
        acc = acc + wf[0, j] * xf[:, j:j + n]
    return acc.to(out_dtype)


def plain_base_gemv(a: torch.Tensor, x: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Each 8-row panel of A times x (1, n)ᵀ → (m8, 1) f32."""
    panels = _promote(a).reshape(-1, ROWS, a.shape[1])
    return (panels @ _promote(x).mT).reshape(-1, 1).to(out_dtype)


def _ell_rows(vals: torch.Tensor, cidx: torch.Tensor, table: torch.Tensor,
              row_width: int, row_fn: Callable) -> torch.Tensor:
    """``row_fn(vals rows, the table's rows at clip(cidx))`` over chunks of
    ELL rows, so the gathered rows held at once stay under
    PLAIN_GATHER_ELEMS elements; the chunks' results stacked."""
    m, k = vals.shape
    step = max(1, PLAIN_GATHER_ELEMS // max(1, k * row_width))
    rows = table.shape[0]
    parts = []
    for r0 in range(0, m, step):
        idx = cidx[r0:r0 + step].to(torch.int64).clamp(0, rows - 1)
        parts.append(row_fn(_promote(vals[r0:r0 + step]),
                            _promote(table[idx])))
    return torch.cat(parts)


def plain_base_spmv(vals: torch.Tensor, cidx: torch.Tensor, x: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """out (m, 1) = Σ_j vals[i, j]·x[0, clip(cidx[i, j])] over every column
    of the ELL planes: the baseline body's clipped ``take``."""
    return _ell_rows(vals, cidx, x.reshape(-1, 1), 1,
                     lambda v, g: (v * g[..., 0]).sum(1, keepdim=True)
                     ).to(out_dtype)


def plain_base_spmm(vals: torch.Tensor, cidx: torch.Tensor, x: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """out (m, c) = Σ_j vals[i, j]·X[clip(cidx[i, j]), :]: the baseline
    body's clipped row ``take``, summed over j in f32."""
    return _ell_rows(vals, cidx, x, x.shape[1],
                     lambda v, g: (v[..., None] * g).sum(1)).to(out_dtype)


def plain_base_scan(x: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The baseline body's block walk: each (8, 128) block's f32 cumsum
    plus the carry, the carry then plus the block's last sum — the carries
    accumulated in f32 in block order."""
    csum = torch.cumsum(_promote(x).reshape(-1, ROWS * LANES), 1)
    last = csum[:, -1].cpu().numpy().astype(np.float32)
    carry = np.add.accumulate(np.concatenate([[0.0], last[:-1]]).astype(
        np.float32), dtype=np.float32)
    out = csum + torch.from_numpy(carry).to(x.device)[:, None]
    return out.reshape(x.shape).to(out_dtype)
