#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py [--seed N]     # about a minute, the build included

The main path is the paper's compile-and-run loop (``ssrify`` →
``lower_plan``/``lower_nest`` → ``ssr_call``) behind ``repro_torch.kernels
.ops`` with ``ssr=True``, and each registry entry's monolithic
``baseline`` beside it; then the fused chains (``ssr_chain_call``) and DAGs
(``ssr_dag_call``) through their registry entries, each beside its
``baseline``, the unfused composition.  The schedule cache is a fresh directory under
``build/`` (``REPRO_SCHEDULE_CACHE``), so no run reads or writes the
user's cache and phases 2–4 run the default schedules.  Phases, each
printing JSON lines:

1. build every Hopper kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all at once), print the ``kernel_attributes`` line (K12,
   K13, R13, R14, K3, R3, B3, R1, R2, R4, R15, K14, B8, K1, K2, K4's eight
   builds and K11's tiles at D = 80, 128, 192 and 256: registers and local
   bytes a thread as ``cudaFuncGetAttributes`` reads them; K3, R3, B3, R1,
   R2, R4, R15, K14, B8, K1, K2, K4 and K11 also their CTAs an SM from the
   occupancy API (K4's held to ``hopper.GEMV_PER_SM``), the rings at
   their main path's rings; K11 its shared memory as its entry and the
   wrapper's mirror count it) and the card's name and power limit;
2. drive the main path once, with every launch counter at 0 before it:
   dot and relu (f32, int32 above 2**24, bf16) at n = 2**26, gemm at
   4096**3 and gemv at 8192**2 in f32, plus one direct ``ssr_call``, and
   each kernel's baseline at the same inputs; the fused cells fused and
   unfused: ``gemv_relu`` 8192**2, ``sum_sq_diff`` and ``axpy_dot`` at
   n = 2**26, ``layernorm``, ``softmax_xent`` and ``mlp_block`` at 2**19
   rows of 128; the halo and rescale cells: ``stencil1d`` (and its
   baseline) and ``stencil1d_relu`` (fused and unfused) at n = 2**26,
   ``stencil2d`` at 8192**2, ``attention_qwen3`` (40 heads, 4096**2,
   D = 128, causal) and ``attention_danube`` (32 heads, 8192**2, D = 80,
   causal, window 4096); the indirection cells: ``spmv_hpcg`` (HPCG's
   27-point operator on a 128**3 grid: ``ops.spmv`` and ``ops.sparse_gemv``
   on the CSR triple, and the baseline) and ``spmm_hpcg`` (the operator on
   64**3 times 128 right-hand sides: ``ops.spmm`` and the baseline); the
   waivered stream cells: ``scan_2p26`` (``ops.prefix_sum`` and the
   baseline at n = 2**26), ``fft_2048_b32768`` (``ops.fft`` on 32,768
   transforms of 2048 points) and ``sort_2p26`` (``ops.sort`` on one row of
   2**26); K11's wide heads: ``attention_d192`` and ``attention_d256`` (8
   heads, 2048**2, causal); the ChainedKernel cells: ``chained_axpy_relu``
   (relu(0.3·x + y) on 2**26 elements, f32 and bf16, a flat (rows, 128)
   Launch of (8, 128) blocks) and ``chained_scale_relu`` (relu(x·w), x
   8192**2 f32 in (8, 512) blocks, w one invariant block), and the unfused
   composition of the first; check that every kernel launched, that a fused
   call is one launch and an unfused one one per stage, that a sparse or
   stream call is one wrapper call of its kernel, that one sort_2p26 call
   runs the 28 device kernels of K16's schedule (at most 32), one
   fft_2048_b32768 call K15's one and one scan_2p26 call K14's one after a
   memset, and its baseline B8's one, and one K1 call on the dot cell its
   one kernel, its last CTA folding the partials (``torch.profiler``
   counts: the ``device_launches`` line), that a ChainedKernel call is one K17 launch, and that no
   fallback fired, and that ``ops.spmv`` and ``ops.sparse_gemv`` lay out
   no stream by a copy (K12 takes ``pack_ell``'s (m, k) planes as they
   are: ``lowering.LAYOUT_COPIES``, the ``layout_copies`` of the
   ``sparse_launches`` line);
3. hold each kernel's output against its plain PyTorch version on the
   card, on the same inputs, and each baseline's against the streamed
   kernel's; each instantiation of K5–K8 (every component of every legal
   cut, on the values the kernels before it produced) and K4's relu drain
   likewise, and each fused result against its unfused one; K12, K13, B6
   and B7 on every row, and on odd CSR inputs against the oracle (K12
   there also against its plain version on pack_ell's planes, beside its
   run on the values doubled); K14 and
   B8 (and their plain versions) against an f64 prefix sum, K14 twice to
   the bit, B8 to ``hopper.base_scan_model``'s bits in f32, bf16 and int32
   at n = 1024, 4096 and 2**26 ± 1024 and five B8 runs of scan_2p26 to one
   set of bits, B8's and every K4 build's local bytes none; K1 to
   ``hopper.reduce_mul_model``'s bits (the two-launch K1's association) on
   the dot cell in f32 and bf16 and at n = 1000 and 2**20 ± 1024, five K1
   runs of the dot cell to the main path's bits beside its run on the first
   block zeroed, which must differ, and K1's and K2's local bytes none; K15 to the bit on the batch cell and bf16 inputs, within the
   limit on one transform of 2**22 points (the global passes); K16 to the
   bit on the cell, a batch of
   2**16 rows of 1024, bf16 and int32, and inputs holding ±0 and a NaN;
   the ring kernels R1–R4 (a schedule deeper than 2) against K1–K4 to the
   bit on the dot (f32, bf16), relu (f32, int32, bf16), gemm, gemv and
   gemv_relu (f32 and bf16) cells at depths 3, 4 and 8 (and per-stream
   (2, 4), (4, 2) on dot, gemm and the gemv cells) and on a gemv whose x
   never moves (2048 x 512, one contraction step), each beside the ring on
   its first block zeroed, which must differ; R1–R4 at each cell's main-path depth (and the main
   path's own ring outputs) against the plain ring at the cell's size,
   beside the ring on its first block zeroed, which must read above the
   limit; the plain ring against R1–R4 at small sizes; K17 against its
   plain version to the bit (f32, bf16, the invariant stream), R5 against
   K17 at depths 3, 4 and 8, R6 against K5 on sum_sq_diff, axpy_dot and
   their unfused stages at 2**26 at depths 3, 4, 8 and per-stream depths,
   each beside its run with the first block zeroed, which must differ; R5
   and R6 at the main path's depth against the plain ring at full size;
   R7–R9 against K6–K8 to the bit on every instantiation of each DAG cell
   (on the values the kernels before it produced) at depths 3, 4 and 8,
   and at per-stream depths (softmax_xent fused (2, 4), (4, 2), its loss
   alone (2, 4, 3), the MLP's residual alone (4, 2)), each beside its run
   with the first block zeroed, which must differ; R7–R9 at depth 4 (and
   the main path's DAG ring outputs) against the plain ring at full size
   within the DAG limits; each limit beside a control that must read above
   it; R10–R12 against K9–K11 to the bit on the stencil1d, stencil1d_relu
   and stencil2d cells at depths 3, 4 and 8 and a per-stream tuple, and on
   every attention cell at depths 3, 4 and (4, 4, 2) (R12 refusing depth 8
   by name, its ring over the shared memory a CTA may opt into), each
   beside its run with every moving stream's first block zeroed, which must
   differ; R10–R12 at depth 4 (and the main path's ring outputs) against
   the plain ring at full size within STENCIL_LIMIT or ATTENTION_LIMIT,
   beside the zeroed-block control above it; R13–R15 against K12–K14 to
   the bit on spmv_hpcg and spmm_hpcg at depths 3, 4, 8, (2, 4) and
   (4, 2) (a depth over the shared memory refused by name) and on
   scan_2p26 at 3, 4 and 8, each beside its run on the moving streams'
   first blocks zeroed, which must differ; R13/R14 at depth 4 on the odd
   CSR inputs (R13 on the padded layouts, K12 on the planes); R14's local
   bytes a thread at most R14_LOCAL_BYTES, R3's, K3's, R1's, R2's and
   R4's none, and K3's shared memory as its entry and the wrapper
   count it; the gemm check names K3's route (``packs``, ``words`` or
   ``elements``, ``hopper.contract_gemm_route``); every R3 check names the
   route its producer warp took (``tma``, ``cp.async`` or ``cp.async
   elements``, ``hopper.gemm_ring_route``), and
   two more hold R3 at depth 3 on the cp.async routes to K3's bits on the
   gemm cell's inputs (bf16, and f32 on a 4158-element pitch), beside
   their zeroed-block controls; R13–R15 at depth 4 (and the main
   path's ring outputs) against the plain ring at full size under the ring
   kernel's runs, within SPARSE_LIMIT or SCAN_LIMIT, beside the
   zeroed-block control above it;
4. time each kernel, its plain version and one PyTorch library call with
   CUDA events, beside the least time the card could take (K1's, K2's and
   K4's rows also through the C entry, ``c_entry_ms``, and the host's time
   to issue one wrapper call, ``host_ms``), each baseline
   against its streamed kernel (``ssr_over_baseline``), each fused cell
   against its unfused stages (``fused_over_unfused``), each entry
   point of the main path by the host's clock once warm, and the sparse
   entries' wall time split into packing, copies, the layouts the kernel
   takes (``layout_ms``; the padded layouts' copy beside it) and kernel; the
   ``gemm_roofline`` line (K3, B3 and R3 at 3, 4, 8 on the gemm cell:
   ms, bound_ms / ms and ms / torch.matmul's, beside their registers and
   CTAs an SM); a ``depth_sweep`` line per ring cell: ms at depths 2 (the K-kernel), 3, 4
   and 8, the best per-stream pair, ``ring_over_sync`` = K ms / R ms (the
   gemv cells also through K4's and R4's C entries, ``c_entry_ms``, with
   no wrapper's host time); a
   ``chained_time`` line per ChainedKernel cell (K17 and R5 at depths 2–8,
   the composed library calls, and for axpy_relu the unfused stages and
   ``fused_over_unfused`` beside the byte prediction 20 / 12), a
   ``chain_depth_sweep`` line per R6 cell and a ``depth_sweep`` line per
   DAG cell (K6–K8 and R7–R9 at depths 2, 3, 4, 8 and softmax_xent's
   pairs) and per halo and attention cell (K9–K11 and R10–R12 at depth 2
   and at their ring depths) and per gather and scan cell (K12–K14 and
   R13–R15 at depth 2, 3, 4, 8 and the pairs);
5. tune gemm 4096**3 over the quick candidates into the cache (one
   candidate per distinct kernel, depth-only variants racing as R3; a
   winner within the race's spread of the default is held back), and
   check that the next ``ops.matmul`` runs the committed schedule,
   correctly; then commit the race's fastest depth-3 survivor and check
   that ``ssr_call`` with no schedule runs it on R3, to K3's bits; then
   commit depth 4 for the stencil1d cell and check that ``ops.stencil1d``
   (``ssr=True``) runs R10, to the bits of the main path's ring;
6. arm one ``compile`` fault and check that ``ops.matmul`` under the tuned
   schedule degrades to the default, quarantines the entry and stays
   right;
5b. search layernorm's graph cuts at full size into the cache (the race
   holds back a cut within its spread of all-fused), then commit the cut
   that fuses nothing and check that the next ``fused_layernorm`` runs the
   three singleton instantiations, correctly;
6b. arm one ``compile`` fault under that cut and check that the call
   degrades to all-fused (one K6 launch), quarantines the entry and stays
   right;
7. print the ``{"kernels": [...]}`` line (K1–K17, B1–B8 and R1–R15, 40
   rows; K11's and R12's rows are the attention_qwen3 cell, K11's row
   carries the other attention cells under ``cells``, which also have time
   and depth_sweep lines of their own; an R row times its main-path
   depth), then the device line last.

Phase 2 also drives the rings: ``ssr_dot``, ``ssr_relu`` (three dtypes),
``ssr_gemv`` and ``fused_gemv_relu`` at depth 4, ``ssr_matmul`` at depth
3 and ``ssr_call`` at per-stream depths (2, 4), the ChainedKernel cells,
``fused_sum_sq_diff``/``fused_axpy_dot`` and ``fused_layernorm``/
``fused_softmax_xent``/``fused_mlp_block``, ``ssr_stencil1d``,
``fused_stencil1d_relu``, ``ssr_stencil2d`` and ``ssr_flash_attention`` on
attention_qwen3 and attention_d256 at depth 4, ``ops.spmv``,
``ops.sparse_gemv`` and ``ops.spmm`` under a committed depth-4 schedule and
``scan.ssr_scan`` at depth 4 (R15's one device kernel, counted by the
profiler); each must launch its ring kernel (R1–R15) and no sync kernel,
and each depth-2 call its sync kernel and no ring.

Any failure exits non-zero; without a CUDA device, without the repo's
``src/repro_torch`` beside this file, or with ``REPRO_DISABLE_PIPELINE``
set (the rings would not run), it exits non-zero before any result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPS = 10   # timed samples per kernel; the median is reported

# Published peaks of the H100 SXM (80 GB HBM3), dense, at the full 700 W
# power limit (NVIDIA data sheet): memory bytes/s, FP32 FLOP/s outside the
# tensor cores.  Only this card has been run; another needs its own entry.
CARD_PEAKS = {"H100 80GB HBM3": (3.35e12, 67e12)}

# gemm/gemv limit on max |kernel - plain| / (|a|·|b|) per output.  Sound
# f32 kernels read below 5e-7 at k = 4096; a kernel that rounds its inputs
# to TF32 reads about 1e-5 and more, and the run fails unless its TF32
# control lands above the limit.
CONTRACT_LIMIT = 5e-6
# dot limit relative to Σ|x·y| (= x·y: the inputs are uniform in [0, 1)).
DOT_LIMIT = 1e-6

# The stencils (K9, K10, B5): max |kernel − plain| relative to the stencil
# of the absolute values, Σ_j |w_j|·|x_{i+j}|.  nvcc contracts the taps
# into FMA and PyTorch rounds each product, a few ulp of that sum (≈ 1e-7);
# the plain version on inputs rounded to bf16 reads about 1e-3, and the run
# fails unless it lands above.
STENCIL_LIMIT = 1e-6
# Attention (K11): max |kernel − plain| / max |v|.  The kernel sums the
# keys in sub-tiles of 64 (the plain version in the lowered kv tiles) and
# its products in another order: about 1e-7 of max |v|; the plain version
# on q, k, v rounded to TF32 reads about 1e-4, and must land above.
ATTENTION_LIMIT = 1e-5
#: K11's tiles in phase 1: (lanes, head dim) of danube, qwen3, d192, d256
K11_TILES = ((128, 80), (128, 128), (256, 192), (256, 256))
# the attention cells: (heads, sequence, head dim, causal, window); D = 192
# and 256 run on K11's 256-lane tiles (192 zero-padded)
ATTENTION_CELLS = {"attention_qwen3": (40, 4096, 128, True, None),
                   "attention_danube": (32, 8192, 80, True, 4096),
                   "attention_d192": (8, 2048, 192, True, None),
                   "attention_d256": (8, 2048, 256, True, None)}
STENCIL2D_SIZE = 8192   # the 2-D cell's output is 8192 x 8192

# The gathers (K12, K13, B6, B7): max |kernel − plain| relative to the sum
# of the terms' sizes, Σ_j |v_ij|·|x_cidx|, per output, the stencils' rule
# (short signed sums); the plain version on bf16-rounded values must read
# above it.
SPARSE_LIMIT = 1e-6
# the sparse cells: HPCG's 27-point operator on a grid of this side
SPMV_GRID, SPMM_GRID, SPMM_RHS = 128, 64, 128

# The stream kernels.  Scan (K14, B8): max |got − f64 prefix sum| over the
# f64 prefix sum of |x|; f32 prefix sums in any fixed order read about 1e-7,
# and the run fails unless the control, the carry out of the first tile
# dropped, reads above.  FFT (K15): max |kernel − plain| over Σ|x| of each
# transform; the kernel rounds each product and sum as the plain version
# does, so a row that fits a CTA (the fft and fft_bf16 checks) must equal
# it to the bit, and the plain version with its twiddles rounded to bf16
# must read above the limit.  Sort (K16): to the bit.
SCAN_LIMIT = 1e-6
FFT_LIMIT = 1e-6
SCAN_N, SORT_N = 1 << 26, 1 << 26      # the scan_2p26 and sort_2p26 cells
SORT_MOST_LAUNCHES = 32                # K16's device kernels on sort_2p26, most
FFT_N, FFT_BATCH = 2048, 32768         # fft_2048_b32768

# The DAG kernels' map outputs: max |kernel − plain| / max(1, |plain|).
# rsqrtf, expf and the order of a row's sums differ from PyTorch's by a few
# ulp (≈ 1e-7 of values of order 1); the same plain version on inputs
# rounded to bf16 reads about 1e-3, and the run fails unless it lands above.
MAP_LIMIT = 1e-5

FUSED_ROWS = 1 << 19   # the DAG cells: 2**19 rows of 128 (256 MiB each)

# fused cell → the launches of one fused and one unfused (baseline) call
FUSED_LAUNCHES = {
    "gemv_relu": ({"contract_gemv": 1}, {"contract_gemv": 1, "map_relu": 1}),
    "sum_sq_diff": ({"chain_elem": 1}, {"chain_elem": 2}),
    "axpy_dot": ({"chain_elem": 1}, {"chain_elem": 1, "reduce_mul": 1}),
    "layernorm": ({"dag_layernorm": 1}, {"dag_layernorm": 3}),
    "softmax_xent": ({"dag_softmax_xent": 1}, {"dag_softmax_xent": 3}),
    "mlp_block": ({"dag_mlp": 1}, {"dag_mlp": 3}),
    "stencil1d_relu": ({"halo_stencil1d": 1},
                       {"halo_stencil1d": 1, "map_relu": 1}),
}
# the fused instantiation each K5–K8 row of the kernels line times
FUSED_ROW = {"chain_elem": "sum_sq_diff", "dag_layernorm": "layernorm",
             "dag_softmax_xent": "softmax_xent", "dag_mlp": "mlp_block"}

# main-path entry at a depth above 2 → (the ring kernel it must launch, the
# depth-2 entry whose K-kernel it must not)
RING_PATH = {"dot_ring": ("ring_reduce_mul", "dot"),
             "dot_ssr_call_ring": ("ring_reduce_mul", "dot_ssr_call"),
             "relu_ring": ("ring_map_relu", "relu"),
             "relu_int32_ring": ("ring_map_relu", "relu_int32"),
             "relu_bf16_ring": ("ring_map_relu", "relu_bf16"),
             "gemm_ring": ("ring_contract_gemm", "gemm"),
             "gemv_ring": ("ring_contract_gemv", "gemv"),
             "gemv_relu_ring": ("ring_contract_gemv", "gemv_relu"),
             "sum_sq_diff_ring": ("ring_chain_elem", "sum_sq_diff"),
             "axpy_dot_ring": ("ring_chain_elem", "axpy_dot"),
             "chained_axpy_relu_ring": ("ring_chained_map",
                                        "chained_axpy_relu"),
             "chained_axpy_relu_bf16_ring": ("ring_chained_map",
                                             "chained_axpy_relu_bf16"),
             "chained_scale_relu_ring": ("ring_chained_map",
                                         "chained_scale_relu"),
             "layernorm_ring": ("ring_dag_layernorm", "layernorm"),
             "softmax_xent_ring": ("ring_dag_softmax_xent", "softmax_xent"),
             "mlp_block_ring": ("ring_dag_mlp", "mlp_block"),
             "stencil1d_ring": ("ring_halo_stencil1d", "stencil1d"),
             "stencil1d_relu_ring": ("ring_halo_stencil1d", "stencil1d_relu"),
             "stencil2d_ring": ("ring_halo_stencil2d", "stencil2d"),
             "attention_qwen3_ring": ("ring_rescale_attention",
                                      "attention_qwen3"),
             "attention_d256_ring": ("ring_rescale_attention",
                                     "attention_d256"),
             "spmv_ring": ("ring_gather_spmv", "spmv"),
             "sparse_gemv_ring": ("ring_gather_spmv", "sparse_gemv"),
             "spmm_ring": ("ring_gather_spmm", "spmm"),
             "prefix_sum_ring": ("ring_stream_scan", "prefix_sum")}
SYNC = ("reduce_mul", "map_relu", "contract_gemm", "contract_gemv",
        "chain_elem", "chained_map", "dag_layernorm", "dag_softmax_xent",
        "dag_mlp", "halo_stencil1d", "halo_stencil2d", "rescale_attention",
        "gather_spmv", "gather_spmm", "stream_scan")
RING_DEPTHS = (3, 4, 8)
RING_PAIRS = ((2, 4), (4, 2))
# main-path entry at a depth above 2 → (its ring cell of phase 3e, depth)
RING_ENTRY = {"dot_ring": ("dot", 4), "dot_ssr_call_ring": ("dot", (2, 4)),
              "relu_ring": ("relu", 4), "relu_int32_ring": ("relu_int32", 4),
              "relu_bf16_ring": ("relu_bf16", 4), "gemm_ring": ("gemm", 3),
              "gemv_ring": ("gemv", 4), "gemv_relu_ring": ("gemv_relu", 4)}
# ring cell → the depth the main path runs it at (dot_bf16 as dot)
RING_MAIN_DEPTH = {cell: depth for cell, depth in RING_ENTRY.values()
                   if not isinstance(depth, tuple)}
RING_MAIN_DEPTH["dot_bf16"] = 4
# the ring kernel → its sync kernel and the main-path entry its row times
RING_ROW = {"ring_reduce_mul": ("reduce_mul", "dot"),
            "ring_map_relu": ("map_relu", "relu"),
            "ring_contract_gemm": ("contract_gemm", "gemm"),
            "ring_contract_gemv": ("contract_gemv", "gemv")}

# The ChainedKernel cells (K17, R5): relu(0.3·x + y) on 2**26 elements of
# a flat (rows, 128) Launch in (8, 128) blocks, f32 and bf16 (the bias-add-
# then-activation pattern); relu(x·w) on an 8192 x 8192 f32 x in (8, 512)
# blocks on a (1024, 16) grid, w one invariant (8, 512) block read at every
# step (the repeat register).  The main path runs them at depth 2 (K17) and
# at CHAINED_MAIN_DEPTH (R5); the chains of K5 at that depth run R6.
CHAINED_ALPHA = 0.3
SCALE_BLOCK = (8, 512)
CHAINED_MAIN_DEPTH = 4
# main-path entry → the launches of one call: K17 once, the unfused
# composition (K5's axpy map, then K2) one launch a stage
CHAINED_LAUNCHES = {"chained_axpy_relu": {"chained_map": 1},
                    "chained_axpy_relu_bf16": {"chained_map": 1},
                    "chained_scale_relu": {"chained_map": 1},
                    "chained_axpy_relu_unfused": {"chain_elem": 1,
                                                  "map_relu": 1}}
# R6's cells: (K5 program, stream count) → the depths checked and swept
R6_DEPTHS = {"sum_sq_diff": (3, 4, 8, (2, 4), (4, 2)),
             "axpy_dot": (3, 4, 8, (2, 4, 3), (4, 2, 2)),
             "sq_diff_map": (3, 4, 8, (2, 4), (4, 2)),
             "axpy_map": (3, 4, 8, (2, 4), (4, 2)),
             "identity_reduce": (3, 4, 8)}

# The DAG rings (R7–R9): each DAG cell's entry at DAG_MAIN_DEPTH on the
# main path; every instantiation of K6–K8 against its ring at
# RING_DEPTHS, and at per-stream depths where it reads two or more
# streams (softmax_xent fused reads Z, P; its loss alone C, E, P; the MLP's
# residual alone H, Y)
DAG_MAIN_DEPTH = 4
DAG_RING_PAIRS = {("softmax_xent", (0, 1, 2)): ((2, 4), (4, 2)),
                  ("softmax_xent", (2,)): ((2, 4, 3),),
                  ("mlp_block", (2,)): ((4, 2),)}
# the ring kernel → its sync kernel and the DAG cell its row times
DAG_RING_ROW = {"ring_dag_layernorm": ("dag_layernorm", "layernorm"),
                "ring_dag_softmax_xent": ("dag_softmax_xent", "softmax_xent"),
                "ring_dag_mlp": ("dag_mlp", "mlp_block")}

# The halo and attention rings (R10–R12): the stencil cells and every
# attention cell against K9–K11 at these depths (R12 where its budget
# admits them: depth 8 must be refused by name) and at one per-stream tuple
# each; the main path runs stencil1d, stencil1d_relu, stencil2d,
# attention_qwen3 and attention_d256 at HALO_MAIN_DEPTH
HALO_MAIN_DEPTH = 4
HALO_RING_CELLS = {"stencil1d": (3, 4, 8, (4, 2, 2)),
                   "stencil1d_relu": (3, 4, 8, (4, 2, 2)),
                   "stencil2d": (3, 4, 8, (4, 2, 2, 2, 2, 2)),
                   **{cell: (3, 4, (4, 4, 2)) for cell in ATTENTION_CELLS}}
# R12's depth beyond its shared memory, checked as a refusal naming it
ATTENTION_REFUSED_DEPTH = 8
# the ring kernel → its sync kernel and the cell its row times
HALO_RING_ROW = {"ring_halo_stencil1d": ("halo_stencil1d", "stencil1d"),
                 "ring_halo_stencil2d": ("halo_stencil2d", "stencil2d"),
                 "ring_rescale_attention": ("rescale_attention",
                                            "attention_qwen3")}

# The gather and scan rings (R13–R15): spmv_hpcg and spmm_hpcg against
# K12/K13 at these depths and per-stream pairs (a depth over R13's or R14's
# shared memory is checked as a refusal naming it), scan_2p26 against K14;
# the main path runs ops.spmv, ops.sparse_gemv and ops.spmm under a
# committed GATHER_MAIN_DEPTH schedule and scan.ssr_scan at that depth
GATHER_MAIN_DEPTH = 4
GATHER_RING_CELLS = {"spmv_hpcg": (3, 4, 8, (2, 4), (4, 2)),
                     "spmm_hpcg": (3, 4, 8, (2, 4), (4, 2)),
                     "scan_2p26": (3, 4, 8)}
# the main-path entries that commit a schedule around their call (their
# host wall time is not the entry's)
COMMITTED_ENTRIES = ("spmv_ring", "sparse_gemv_ring", "spmm_ring")
# R14's ceiling of local (spilled) bytes a thread: the 668 bytes of spill
# stores of the CTA-barrier ring its warp rings replaced
R14_LOCAL_BYTES = 668
# the ring kernel → its sync kernel and the cell its row times
GATHER_RING_ROW = {"ring_gather_spmv": ("gather_spmv", "spmv_hpcg"),
                   "ring_gather_spmm": ("gather_spmm", "spmm_hpcg"),
                   "ring_stream_scan": ("stream_scan", "scan_2p26")}

# streamed kernel → its monolithic baseline
PAIRS = {"reduce_mul": "base_reduce", "map_relu": "base_relu",
         "contract_gemm": "base_gemm", "contract_gemv": "base_gemv",
         "halo_stencil1d": "base_stencil1d", "gather_spmv": "base_spmv",
         "gather_spmm": "base_spmm", "stream_scan": "base_scan"}


#: the kernels whose device launches a call are counted: their cell
STREAM_CELL = {"stream_bitonic": "sort", "stream_fft": "fft",
               "stream_scan": "prefix_sum", "reduce_mul": "dot_k1"}
#: the kernels whose rows of the kernels line also time their C entry
#: (``c_entry_ms``) and the host's time to issue a wrapper call
#: (``host_ms``)
ENTRY_ROWS = ("contract_gemv", "reduce_mul", "map_relu")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


#: the bracketing kernel of a profiled call (``torch.cuda._sleep``'s) and
#: its length in cycles; the host's pause before and after it, in seconds
TRACE_MARK, TRACE_MARK_CYCLES, TRACE_PAD_S = "spin_kernel", 100_000, 0.05
#: profiles of one call at most, while its trace lacks a bracketing kernel
TRACE_ATTEMPTS = 3


def traced_kernels(fn, key: str, attempt: int):
    """The device kernels of one ``fn()`` in launch order, from a
    ``torch.profiler`` trace (CUDA activity), or None when the trace is not
    whole.  The call sits between two ``spin_kernel`` marks, with a host
    pause on each side: the profiler drops the kernels whose device times
    fall outside its window, so a trace counts only when both marks are in
    it, first and last, and nothing else is a mark."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
        torch.cuda._sleep(TRACE_MARK_CYCLES)
        fn()
        torch.cuda._sleep(TRACE_MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    trace = os.path.join(os.environ["REPRO_SCHEDULE_CACHE"],
                         f"trace_{key}_{attempt}.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) \
        if isinstance(events, dict) else events
    kernels = [e["name"] for e in sorted(
        (e for e in events if e.get("cat") == "kernel"),
        key=lambda e: float(e.get("ts", 0)))]
    marks = [i for i, k in enumerate(kernels) if TRACE_MARK in k]
    if marks != [0, len(kernels) - 1] or len(kernels) < 2:
        return None
    return kernels[1:-1]


def count_device_launches(calls) -> dict:
    """Device kernels of one call each, from a ``torch.profiler`` trace
    (``traced_kernels``): ``calls`` maps a cell to (call, the schedule's
    count, the most allowed, substrings of its kernels' names).  Exits
    unless each call launched exactly its schedule's kernels, all of them
    its own, or if no trace of a call was whole."""
    counts = {}
    torch.cuda._sleep(TRACE_MARK_CYCLES)   # the mark's kernel loaded
    for key, (fn, want, most, names) in calls.items():
        fn()                       # built, loaded and warm
        torch.cuda.synchronize()
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            kernels = traced_kernels(fn, key, attempt)
            if kernels is not None:
                break
        if kernels is None:
            raise SystemExit(f"chip_smoke: no whole profiler trace of the "
                             f"{key} call in {TRACE_ATTEMPTS} tries: a "
                             f"bracketing {TRACE_MARK} was missing")
        counts[key] = {"device_kernels": len(kernels), "schedule": want,
                       "most": most, "traces": attempt,
                       "names": sorted(set(kernels)),
                       "ok": len(kernels) == want <= most and all(
                           any(n_ in k for n_ in names) for k in kernels)}
    emit({"phase": "device_launches", "calls": counts})
    wrong = [key for key, c in counts.items() if not c["ok"]]
    if wrong:
        raise SystemExit(f"chip_smoke: device kernels per call differ from "
                         f"the schedule: {wrong}: {counts}")
    return {key: c["device_kernels"] for key, c in counts.items()}


def card_peaks(name: str):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    raise SystemExit(f"chip_smoke: no published peaks for card {name!r}")


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to TF32's 10-bit mantissa, to nearest even."""
    bits = t.view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def time_ms(fn, warmup: int = 3) -> float:
    """Median CUDA-event time of one ``fn`` call, over ``REPS`` samples.

    Each sample times enough back-to-back calls to last about 2 ms and
    divides by their count, so the host's launch work overlaps the
    device's and a fast kernel is not timed as its launch gap.  A call
    that takes more than 100 ms (a plain version walking its blocks one
    step at a time) is timed over one warm-up and three samples.
    """
    def sample(calls: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    fn()
    first = sample(1)
    if first > 100.0:
        return statistics.median([first, sample(1), sample(1)])
    for _ in range(warmup - 1):
        fn()
    calls = max(1, min(100, int(2.0 / max(sample(1), 1e-3))))
    return statistics.median(sample(calls) for _ in range(REPS))


def busy_ms(fn, calls: int = 5) -> float:
    """Median CUDA-event time of one ``fn`` call with the device kept busy:
    each sample enqueues a call before its start event, so the timed calls
    are enqueued while the device runs it.  ``time_ms`` times single calls
    once a call lasts over 2 ms, and then counts the host's launch work in
    each sample."""
    def sample() -> float:
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    sample()
    return statistics.median(sample() for _ in range(REPS))


def host_ms(fn, calls: int = 200) -> float:
    """Host time to issue one ``fn`` call, back to back (the mean of
    ``calls``), once warm: a wrapper's own work, with its launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return t


def wall_ms(fn) -> float:
    """Median host wall time of one call that ends in a synchronize: what a
    caller of the entry point waits, host work included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rel_to_abs_prod(got, want, scale) -> float:
    return float(((got.float() - want.float()).abs() / scale).max())


def map_err(got, want) -> float:
    """max |got − want| / max(1, |want|): MAP_LIMIT's measure."""
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def unmasked_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the attention mask leaves visible, query rows
    aligned to the keys' end: the work the kernel must do."""
    rows = torch.arange(sq, dtype=torch.int64) + (sk - sq)
    hi = torch.clamp(rows + 1, max=sk) if causal else torch.full_like(rows, sk)
    lo = torch.clamp(rows - window + 1, min=0) if window is not None \
        else torch.zeros_like(rows)
    return int(torch.clamp(hi - lo, min=0).sum())


def depth_schedule(depth, lowering):
    """The default schedule at a uniform depth, or at per-stream depths."""
    if isinstance(depth, tuple):
        return lowering.Schedule(stream_depths=depth)
    return lowering.Schedule(buffer_depth=depth)


def first_block_zeroed(call):
    """The call's layouts with every stream's first block zeroed (uniforms
    kept): what a kernel that dropped one grid step would have read."""
    n = call.kernel.program.n_streams
    out = []
    for k, t in enumerate(call.layouts):
        if k < n:
            t = t.clone()
            rows, cols = call.kernel.geometry.ins[k].block
            t[:rows, :cols] = 0
        out.append(t)
    return tuple(out)


def chained_kernels(frontend, chained, relu, block_stream, direction):
    """The ChainedKernel cells as a user states them: (axpy_relu, a flat
    (rows, 128) Launch of (8, 128) blocks; scale_relu, x in SCALE_BLOCK
    blocks on a 2-D grid with w one invariant block)."""
    def flat(static, x, y):
        walk = block_stream((8, 128), lambda i: (i, 0))
        return frontend.Launch(
            grid=(x.shape[0] // 8,), in_streams=(walk, walk),
            out_streams=(block_stream((8, 128), lambda i: (i, 0),
                                      direction.WRITE),),
            out_shapes=(frontend.ShapeDtype(tuple(x.shape), x.dtype),),
            dimension_semantics=("parallel",))

    def scaled(static, x, w):
        (r, c), (br, bc) = x.shape, SCALE_BLOCK
        return frontend.Launch(
            grid=(r // br, c // bc),
            in_streams=(block_stream(SCALE_BLOCK, lambda i, j: (i, j)),
                        block_stream(SCALE_BLOCK, lambda i, j: (0, 0))),
            out_streams=(block_stream(SCALE_BLOCK, lambda i, j: (i, j),
                                      direction.WRITE),),
            out_shapes=(frontend.ShapeDtype(tuple(x.shape), x.dtype),),
            dimension_semantics=("parallel", "parallel"))

    waiver = ("a producer block handed to an elementwise consumer in the "
              "same step, over a hand-stated Launch")
    axpy_relu = frontend.ChainedKernel(
        "chained_axpy_relu",
        prepare=lambda x, y: ((frontend.pad_vector(x), frontend.pad_vector(y)),
                              None, x.shape[0]),
        launch=flat, producer=lambda s: chained.axpy_block(CHAINED_ALPHA),
        consumer=lambda s: relu.RELU,
        finish=lambda out, n: frontend.trim_vector(out, n),
        lowering_waiver=waiver)
    scale_relu = frontend.ChainedKernel(
        "chained_scale_relu", prepare=lambda x, w: ((x, w), None, None),
        launch=scaled, producer=lambda s: chained.DOT,
        consumer=lambda s: relu.RELU, lowering_waiver=waiver)
    return axpy_relu, scale_relu


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the inputs, made on the card")
    args = ap.parse_args()

    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if os.environ.get("REPRO_DISABLE_PIPELINE"):
        print("chip_smoke: REPRO_DISABLE_PIPELINE is set, so no ring kernel "
              "would run; unset it", file=sys.stderr)
        return 2
    (root / "build").mkdir(exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_schedules_",
                                 dir=root / "build")
    os.environ["REPRO_SCHEDULE_CACHE"] = cache_dir
    # the main path must run its kernels: no opt-in rung may stand in
    os.environ.pop("REPRO_BASELINE_FALLBACK", None)
    try:
        return run(root, args.seed, cache_dir)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def run(root: Path, seed: int, cache_dir: str) -> int:
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch.core import (autotune, compiler, hopper, lowering,
                                  resilience)
    from repro_torch.core.ssr import BlockStream
    from repro_torch.core.stream import Direction
    from repro_torch.kernels import (attention, bitonic, chained, dag, fft,
                                     frontend, gemm, gemv, ops, reduction,
                                     registry, relu, scan, sparse, stencil)

    dev = torch.device("cuda")
    repro_torch.set_default_device(dev)
    resilience.reset()               # no fault armed from the environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "setup", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "schedule_cache": cache_dir,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = hopper.build()
    build_s = time.perf_counter() - t0
    out_dir = root / "chiprun_out"
    if logs and out_dir.is_dir():
        (out_dir / "chip_smoke_nvcc.log").write_text(
            "\n".join(f"== {n}\n{log}" for n, log in logs.items()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit({"phase": "build", "seconds": build_s, "compiled": sorted(logs),
          "kernels": sorted(hopper.KERNELS)})
    # the gathers', the gemms' and R1's, R2's and R4's registers a thread
    # and spilled bytes, as the runtime reads them (R14 held to
    # R14_LOCAL_BYTES in phase 3i, R3, K3, R1, R2 and R4 to none in 3e),
    # and the gemms' and R1's, R2's and R4's CTAs an SM from the occupancy
    # API, each ring at its main path's ring in f32 and its barriers: R3
    # depth 3 on A and B; R1 and R2 at depth 4, (8, 128) blocks, R1 with
    # its warp sums; R4 at depth 4
    r3_smem = RING_MAIN_DEPTH["gemm"] * 4 * hopper.GEMM_CHUNK_K * (
        hopper.GEMM_TILE_M + hopper.GEMM_TILE_N) + hopper.RING_BARRIER_BYTES
    block = 4 * 8 * 128
    r1_smem = 2 * RING_MAIN_DEPTH["dot"] * block + \
        hopper.RING_BARRIER_BYTES + hopper.STAGE_SUM_BYTES
    r2_smem = RING_MAIN_DEPTH["relu"] * block + hopper.RING_BARRIER_BYTES
    # R4 at depth 4 on the gemv cell's 512-wide f32 blocks: 8 rows and x
    r4_smem = RING_MAIN_DEPTH["gemv"] * (hopper.GEMV_RING_ROWS + 1) * 512 * 4 \
        + hopper.RING_BARRIER_BYTES
    # R15 at the scan's main-path depth: f32 tiles and its 512-byte header
    r15_smem = GATHER_MAIN_DEPTH * hopper.SCAN_TILE * 4 + \
        hopper.SCAN_RING_STAGED_BYTES
    attributes = {n: hopper.kernel_attributes(n) for n in (
        "gather_spmv", "gather_spmm", "ring_gather_spmv", "ring_gather_spmm",
        "contract_gemm", "base_gemm")}
    for n, smem_ in (("ring_contract_gemm", r3_smem),
                     ("ring_reduce_mul", r1_smem), ("ring_map_relu", r2_smem),
                     ("ring_contract_gemv", r4_smem),
                     ("ring_stream_scan", r15_smem)):
        attributes[n] = hopper.kernel_attributes(n, smem_)
    # K14's (its two slots, static) and K11's tiles: the 128-lane tile,
    # the wide tile on 192 and 256 live lanes; K11's shared memory as its
    # entry counts it beside the wrapper's mirror (held equal in phase 3)
    attributes["stream_scan"] = hopper.kernel_attributes("stream_scan")
    # B8 (static, its three dtypes), K1 and K2 (static, every build; CTAs
    # an SM of their f32 builds in 16-byte packs) and each of K4's eight
    # builds
    attributes["base_scan"] = hopper.kernel_attributes("base_scan")
    for name in ("reduce_mul", "map_relu"):
        attributes[name] = hopper.kernel_attributes(name)
    for build in hopper.GEMV_BUILDS:
        attributes[f"contract_gemv_{build}"] = hopper.kernel_attributes(
            "contract_gemv", build=build)
    for lanes, dim in K11_TILES:
        key = f"rescale_attention_{lanes}_d{dim}"
        attributes[key] = hopper.kernel_attributes("rescale_attention",
                                                   tile=(lanes, dim))
        attributes[key]["smemBytes"] = hopper.kernel_smem_bytes(
            "rescale_attention", lanes, dim)
        attributes[key]["smemMirror"] = hopper.rescale_attention_tiles(
            dim, lanes)["smem"]
    # K3's two buffers as its entry counts them, beside the wrapper's count
    k3_smem = {str(dt): (hopper.kernel_smem_bytes("contract_gemm", dt),
                         hopper.contract_gemm_smem_bytes(dt))
               for dt in (torch.float32, torch.bfloat16)}
    attributes["contract_gemm"]["smemBytes"] = k3_smem[str(torch.float32)][0]
    emit({"phase": "kernel_attributes", "kernels": attributes})
    print(smi, flush=True)
    card = torch.cuda.get_device_name(0)
    bw, fp32 = card_peaks(card)

    # -- inputs, made on the card from the seed ---------------------------
    n_vec, (m, n, k), (gm, gn) = 1 << 26, (4096, 4096, 4096), (8192, 8192)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # dot's inputs are non-negative, so Σ|x·y| is the dot itself and a
    # limit relative to it sees a dropped or doubled grid step
    x = torch.rand(n_vec, generator=gen, device=dev)
    y = torch.rand(n_vec, generator=gen, device=dev)
    xi = torch.randint(-(1 << 30), 1 << 30, (n_vec,), generator=gen,
                       device=dev, dtype=torch.int32)
    xr = randn(n_vec)          # relu's input: signed zeros, NaN and infinities
    xr[:5] = torch.tensor([-0.0, 0.0, float("nan"), float("-inf"),
                           float("inf")])
    xb = xr.to(torch.bfloat16)
    a, b = randn(m, k), randn(k, n)
    ga, gx = randn(gm, gn), randn(gn)
    # the fused cells: axpy_dot's w uniform in [0, 1) like x and y (every
    # term non-negative); the DAGs' rows of 128; one-hot targets; weights
    # and biases ~ N(0, 0.1²)
    w = torch.rand(n_vec, generator=gen, device=dev)
    lx, lz, mx = (randn(FUSED_ROWS, 128) for _ in range(3))
    lp = torch.nn.functional.one_hot(
        torch.randint(0, 128, (FUSED_ROWS,), generator=gen, device=dev),
        128).float()
    w1, w2 = randn(128, 128) * 0.1, randn(128, 128) * 0.1
    b1, b2 = randn(128) * 0.1, randn(128) * 0.1
    # the halo cells: a padded vector and grid, taps ~ N(0, 0.3²); the
    # attention cells' heads
    xs = randn(n_vec + stencil.TAPS - 1)
    ws = randn(stencil.TAPS) * 0.3
    hw = STENCIL2D_SIZE
    x2 = randn(hw + stencil.TAPS - 1, hw + stencil.TAPS - 1)
    wx2, wy2 = randn(stencil.TAPS) * 0.3, randn(stencil.TAPS) * 0.3
    qkv = {cell: tuple(randn(h, s_, d) for _ in range(3))
           for cell, (h, s_, d, _c, _w) in ATTENTION_CELLS.items()}
    # the sparse cells: HPCG's operator as CSR on the card; x ~ U[0, 1),
    # X ~ N(0, 1)
    n_v1, n_m2 = SPMV_GRID ** 3, SPMM_GRID ** 3
    hcsr = sparse.hpcg_operator(SPMV_GRID, SPMV_GRID, SPMV_GRID, device=dev)
    scsr = sparse.hpcg_operator(SPMM_GRID, SPMM_GRID, SPMM_GRID, device=dev)
    hx = torch.rand(n_v1, generator=gen, device=dev)
    sX = randn(n_m2, SPMM_RHS)
    # the stream cells: x ~ N(0, 1) for the scan and the sort; the FFT's re
    # and im planes ~ N(0, 1)
    xsc, xso = randn(SCAN_N), randn(SORT_N)
    fre, fim = randn(FFT_BATCH, FFT_N), randn(FFT_BATCH, FFT_N)
    fused_args = {"gemv_relu": ((ga, gx), {}), "sum_sq_diff": ((x, y), {}),
                  "axpy_dot": ((x, y, w), {"alpha": 0.5}),
                  "layernorm": ((lx,), {}), "softmax_xent": ((lz, lp), {}),
                  "mlp_block": ((mx, w1, b1, w2, b2), {}),
                  "stencil1d_relu": ((xs, ws), {})}
    # the ChainedKernel cells: signed x and y ~ N(0, 1) and their bf16
    # roundings; the scale cell's x is gemv's A, its w ~ N(0, 1)
    cx, cy = randn(n_vec), randn(n_vec)
    cxb, cyb = cx.to(torch.bfloat16), cy.to(torch.bfloat16)
    cw = randn(*SCALE_BLOCK)
    axpy_relu, scale_relu = chained_kernels(frontend, chained, relu,
                                            BlockStream, Direction)
    pair_c = compiler.elementwise_nest(n_vec, ("X", "Y"), 2)
    # the ELL planes the sparse entry points pack on the card, and the
    # schedule-cache keys of their NestKernels (a depth committed under a
    # key is what the entry point runs with no schedule)
    hv, hc, hm, hk = sparse.pack_ell(*hcsr, n_v1)
    sv, sc, sm, sk = sparse.pack_ell(*scsr, n_m2)

    def entry_key(nk, *args_, **params):
        ops_, static_, _ = nk._prepare(*args_, **params)
        return autotune.cache_key(nk._nest(static_), dict(ops_), mode=nk._mode,
                                  out_dtype=nk._out_dtype_of(static_),
                                  device=dev)

    spmv_key = entry_key(sparse._ssr_spmv, hv, hc, hx, m=hm, k=hk)
    spmm_key = entry_key(sparse._ssr_spmm, sv, sc, sX, m=sm, k=sk,
                         pitch=SPMM_RHS)

    def committed(key, fn):
        """``fn()`` with GATHER_MAIN_DEPTH committed under ``key``, the
        default committed again after it."""
        cache = autotune.global_cache()
        cache.put(key, deep[GATHER_MAIN_DEPTH],
                  meta={"note": "a sparse cell's ring depth"})
        try:
            return fn()
        finally:
            cache.put(key, lowering.DEFAULT_SCHEDULE)

    torch.cuda.synchronize()

    # -- 2. the main path, counters at 0 just before it --------------------
    deep = {d: depth_schedule(d, lowering)
            for d in (*RING_DEPTHS, *RING_PAIRS)}
    base = {name: registry.get(name).baseline
            for name in ("reduction", "relu", "gemm", "gemv")}
    path = {
        "dot": lambda: ops.dot(x, y, ssr=True),
        "dot_ssr_call": lambda: lowering.ssr_call(
            compiler.dot_product_nest(n_vec), reduction.MUL,
            {"A": x, "B": y}),
        "relu": lambda: ops.relu(xr, ssr=True),
        "relu_int32": lambda: ops.relu(xi, ssr=True),
        "relu_bf16": lambda: ops.relu(xb, ssr=True),
        "gemm": lambda: ops.matmul(a, b, ssr=True),
        "gemv": lambda: ops.gemv(ga, gx, ssr=True),
        "dot_baseline": lambda: base["reduction"](x, y),
        "relu_baseline": lambda: base["relu"](xr),
        "relu_int32_baseline": lambda: base["relu"](xi),
        "relu_bf16_baseline": lambda: base["relu"](xb),
        "gemm_baseline": lambda: base["gemm"](a, b),
        "gemv_baseline": lambda: base["gemv"](ga, gx),
        # the fused chains and DAGs through their entry points, and each
        # registry entry's baseline: the unfused composition
        "gemv_relu": lambda: ops.gemv_relu(ga, gx, ssr=True),
        "sum_sq_diff": lambda: ops.sum_sq_diff(x, y, ssr=True),
        "axpy_dot": lambda: ops.axpy_dot(x, y, w, alpha=0.5, ssr=True),
        "layernorm": lambda: registry.dispatch("layernorm", lx, ssr=True),
        "softmax_xent": lambda: registry.dispatch("softmax_xent", lz, lp,
                                                  ssr=True),
        "mlp_block": lambda: registry.dispatch("mlp_block", mx, w1, b1, w2,
                                               b2, ssr=True),
        # the halo reads and the online-softmax accumulator
        "stencil1d": lambda: ops.stencil1d(xs, ws, ssr=True),
        "stencil1d_baseline": lambda: registry.get("stencil1d").baseline(
            xs, ws),
        "stencil2d": lambda: ops.stencil2d(x2, wx2, wy2, ssr=True),
        "stencil1d_relu": lambda: ops.stencil1d_relu(xs, ws, ssr=True),
        **{cell: (lambda c=cell: ops.flash_attention(
            *qkv[c], causal=ATTENTION_CELLS[c][3],
            window=ATTENTION_CELLS[c][4], ssr=True))
           for cell in ATTENTION_CELLS},
        **{f"{cell}_unfused": (lambda c=cell: registry.get(c).baseline(
            *fused_args[c][0], **fused_args[c][1]))
           for cell in FUSED_LAUNCHES},
        # the indirection streams, on the CSR triple
        "spmv": lambda: ops.spmv(*hcsr, hx, ssr=True),
        "sparse_gemv": lambda: ops.sparse_gemv(*hcsr, hx, ssr=True),
        "spmv_baseline": lambda: registry.get("spmv").baseline(*hcsr, hx),
        "spmm": lambda: ops.spmm(*scsr, sX, ssr=True),
        "spmm_baseline": lambda: registry.get("spmm").baseline(*scsr, sX),
        # the waivered stream kernels (StreamKernel), through their entries
        "prefix_sum": lambda: ops.prefix_sum(xsc, ssr=True),
        "prefix_sum_baseline": lambda: registry.get("scan").baseline(xsc),
        "fft": lambda: ops.fft(fre, fim, ssr=True),
        "sort": lambda: ops.sort(xso, ssr=True),
        # the stage rings: the entry points at a schedule deeper than 2
        "dot_ring": lambda: reduction.ssr_dot(x, y, schedule=deep[4]),
        "dot_ssr_call_ring": lambda: lowering.ssr_call(
            compiler.dot_product_nest(n_vec), reduction.MUL,
            {"A": x, "B": y}, schedule=deep[(2, 4)]),
        "relu_ring": lambda: relu.ssr_relu(xr, schedule=deep[4]),
        "relu_int32_ring": lambda: relu.ssr_relu(xi, schedule=deep[4]),
        "relu_bf16_ring": lambda: relu.ssr_relu(xb, schedule=deep[4]),
        "gemm_ring": lambda: gemm.ssr_matmul(a, b, schedule=deep[3]),
        "gemv_ring": lambda: gemv.ssr_gemv(ga, gx, schedule=deep[4]),
        "gemv_relu_ring": lambda: chained.fused_gemv_relu(
            ga, gx, schedule=deep[4]),
        # the ChainedKernel (K17; at a depth above 2, R5) beside its unfused
        # composition (K5's axpy map, then K2), and K5's chains at a depth
        # above 2 (R6)
        "chained_axpy_relu": lambda: axpy_relu(cx, cy),
        "chained_axpy_relu_bf16": lambda: axpy_relu(cxb, cyb),
        "chained_scale_relu": lambda: scale_relu(ga, cw),
        "chained_axpy_relu_unfused": lambda: relu.ssr_relu(
            lowering.ssr_call(pair_c, chained.axpy_block(CHAINED_ALPHA),
                              {"X": cx, "Y": cy}, mode="map",
                              schedule=lowering.DEFAULT_SCHEDULE),
            schedule=lowering.DEFAULT_SCHEDULE),
        "chained_axpy_relu_ring": lambda: axpy_relu(
            cx, cy, schedule=deep[CHAINED_MAIN_DEPTH]),
        "chained_axpy_relu_bf16_ring": lambda: axpy_relu(
            cxb, cyb, schedule=deep[CHAINED_MAIN_DEPTH]),
        "chained_scale_relu_ring": lambda: scale_relu(
            ga, cw, schedule=deep[CHAINED_MAIN_DEPTH]),
        "sum_sq_diff_ring": lambda: chained.fused_sum_sq_diff(
            x, y, schedule=deep[CHAINED_MAIN_DEPTH]),
        "axpy_dot_ring": lambda: chained.fused_axpy_dot(
            x, y, w, alpha=0.5, schedule=deep[CHAINED_MAIN_DEPTH]),
        # the DAGs at a depth above 2 (R7–R9)
        "layernorm_ring": lambda: dag.fused_layernorm(
            lx, schedule=deep[DAG_MAIN_DEPTH]),
        "softmax_xent_ring": lambda: dag.fused_softmax_xent(
            lz, lp, schedule=deep[DAG_MAIN_DEPTH]),
        "mlp_block_ring": lambda: dag.fused_mlp_block(
            mx, w1, b1, w2, b2, schedule=deep[DAG_MAIN_DEPTH]),
        # the halos and attention at a depth above 2 (R10–R12)
        "stencil1d_ring": lambda: stencil.ssr_stencil1d(
            xs, ws, schedule=deep[HALO_MAIN_DEPTH]),
        "stencil1d_relu_ring": lambda: chained.fused_stencil1d_relu(
            xs, ws, schedule=deep[HALO_MAIN_DEPTH]),
        "stencil2d_ring": lambda: stencil.ssr_stencil2d(
            x2, wx2, wy2, schedule=deep[HALO_MAIN_DEPTH]),
        **{f"{cell}_ring": (lambda c=cell: attention.ssr_flash_attention(
            *qkv[c], causal=ATTENTION_CELLS[c][3],
            window=ATTENTION_CELLS[c][4], schedule=deep[HALO_MAIN_DEPTH]))
           for cell in ("attention_qwen3", "attention_d256")},
        # the gathers under a committed depth above 2 and the scan at one
        # (R13–R15)
        "spmv_ring": lambda: committed(
            spmv_key, lambda: ops.spmv(*hcsr, hx, ssr=True)),
        "sparse_gemv_ring": lambda: committed(
            spmv_key, lambda: ops.sparse_gemv(*hcsr, hx, ssr=True)),
        "spmm_ring": lambda: committed(
            spmm_key, lambda: ops.spmm(*scsr, sX, ssr=True)),
        "prefix_sum_ring": lambda: scan.ssr_scan(
            xsc, schedule=deep[GATHER_MAIN_DEPTH]),
    }
    lowering.reset_dispatch_stats()
    frontend.reset_dispatch_stats()
    resilience.reset_fallback_log()
    hopper.reset_launches()
    main, wall, per_call, copies = {}, {}, {}, {}
    for key, fn in path.items():   # first calls: plans, lowering, loading
        before = dict(hopper.LAUNCHES)
        padded = lowering.LAYOUT_COPIES["padded"]
        t0 = time.perf_counter()
        main[key] = fn()
        torch.cuda.synchronize()
        wall[key] = time.perf_counter() - t0
        per_call[key] = {k_: v - before[k_] for k_, v in hopper.LAUNCHES.items()
                         if v != before[k_]}
        copies[key] = lowering.LAYOUT_COPIES["padded"] - padded
    launches = dict(hopper.LAUNCHES)
    ladder = {"fallback_events": len(resilience.fallback_events()),
              "lowering": {c: lowering.DISPATCH_STATS[c]
                           for c in ("fallbacks", "degraded")},
              "frontend": {c: frontend.DISPATCH_STATS[c]
                           for c in ("fallbacks", "degraded")}}
    emit({"phase": "main_path", "seconds": sum(wall.values()),
          "first_call_seconds": wall, "launches": launches, "ladder": ladder,
          "shapes": {k_: [list(t.shape) for t in v] if isinstance(v, tuple)
                     else list(v.shape) for k_, v in main.items()}})
    idle = [name for name, cnt in launches.items() if cnt == 0]
    if idle:
        raise SystemExit(f"chip_smoke: kernels never launched on the main "
                         f"path: {idle}")
    # a fused call is one launch of its kernel, an unfused one one per stage
    # (the counterpart of the reference's HLO fusion audit)
    counts = {key: per_call[key] for cell in FUSED_LAUNCHES
              for key in (cell, f"{cell}_unfused")}
    emit({"phase": "fusion_launches", "launches": counts})
    wrong = [cell for cell, (f, u) in FUSED_LAUNCHES.items()
             if counts[cell] != f or counts[f"{cell}_unfused"] != u]
    if wrong:
        raise SystemExit(f"chip_smoke: fused or unfused calls launched "
                         f"other kernels than expected: {wrong}: {counts}")
    # a sparse call is one launch of its kernel
    sparse_launches = {"spmv": {"gather_spmv": 1},
                       "sparse_gemv": {"gather_spmv": 1},
                       "spmv_baseline": {"base_spmv": 1},
                       "spmm": {"gather_spmm": 1},
                       "spmm_baseline": {"base_spmm": 1}}
    # and K12 and K13 take pack_ell's planes as they are: the spmv and spmm
    # entries at the default schedule lay out no stream by a copy
    emit({"phase": "sparse_launches",
          "launches": {key: per_call[key] for key in sparse_launches},
          "layout_copies": {key: copies[key] for key in sparse_launches}})
    if any(per_call[key] != want for key, want in sparse_launches.items()):
        raise SystemExit(f"chip_smoke: a sparse call launched other kernels "
                         f"than one K12/K13/B6/B7: "
                         f"{ {key: per_call[key] for key in sparse_launches} }")
    if copies["spmv"] or copies["sparse_gemv"] or copies["spmm"]:
        raise SystemExit(f"chip_smoke: a sparse entry copied its planes into "
                         f"padded layouts: {copies}")
    # a stream call is one wrapper call of its kernel (K14's and B8's scan
    # one device kernel after a memset of its state, one for the FFT cell,
    # 28 for the sort cell: LAUNCHES and the device_launches line below)
    stream_launches = {"prefix_sum": {"stream_scan": 1},
                       "prefix_sum_baseline": {"base_scan": 1},
                       "fft": {"stream_fft": 1},
                       "sort": {"stream_bitonic": 1}}
    emit({"phase": "stream_launches",
          "launches": {key: per_call[key] for key in stream_launches}})
    if any(per_call[key] != want for key, want in stream_launches.items()):
        raise SystemExit(f"chip_smoke: a stream call launched other kernels "
                         f"than its K14/B8/K15/K16: "
                         f"{ {key: per_call[key] for key in stream_launches} }")
    # the device kernels of one sort_2p26 and one fft_2048_b32768 call,
    # counted by the profiler, against K16's and K15's Python schedules;
    # one K1 call on the dot cell its one kernel;
    # one scan_2p26 call runs K14's one pass, one at GATHER_MAIN_DEPTH
    # R15's and one baseline call B8's (each after a memset of its state,
    # which is no kernel)
    k1_call = lowering.prepare_call(compiler.dot_product_nest(n_vec),
                                    reduction.MUL, {"A": x, "B": y})
    device_launches = count_device_launches({
        "sort": (lambda: ops.sort(xso, ssr=True),
                 len(bitonic.sort_passes(SORT_N)), SORT_MOST_LAUNCHES,
                 ("sort_pass",)),
        "fft": (lambda: ops.fft(fre, fim, ssr=True), 1, 1, ("fft_rows",)),
        "prefix_sum": (path["prefix_sum"], 1, 1, ("::scan_tiles<",)),
        "prefix_sum_baseline": (path["prefix_sum_baseline"], 1, 1,
                                ("base_scan_tiles<",)),
        "prefix_sum_ring": (path["prefix_sum_ring"], 1, 1,
                            ("ring_scan_tiles",)),
        # K1 on the dot cell: one kernel, its last CTA folding the partials
        "dot_k1": (k1_call.run, 1, 1, ("reduce_mul_kernel<",))})
    # a call deeper than 2 launches its ring kernel and no K kernel; its
    # depth-2 twin launches its K kernel and no ring
    ring_launches = {key: per_call[key] for pair in RING_PATH.items()
                     for key in pair[1][1:] + (pair[0],)}
    emit({"phase": "ring_launches", "launches": ring_launches})
    wrong = [key for key, (ring, sync) in RING_PATH.items()
             if per_call[key] != {ring: 1}
             or any(k_.startswith("ring_") for k_ in per_call[sync])
             or not set(per_call[sync]) <= set(SYNC)]
    if wrong:
        raise SystemExit(f"chip_smoke: a depth call launched other kernels "
                         f"than its ring, or a depth-2 call a ring: {wrong}: "
                         f"{ring_launches}")
    # a ChainedKernel call is one K17 launch, its unfused composition one
    # launch a stage
    chained_launches = {key: per_call[key] for key in CHAINED_LAUNCHES}
    emit({"phase": "chained_launches", "launches": chained_launches})
    if chained_launches != CHAINED_LAUNCHES:
        raise SystemExit(f"chip_smoke: a chained call launched other kernels "
                         f"than expected: {chained_launches}")
    if resilience.fallback_events() or any(
            v for stats in (ladder["lowering"], ladder["frontend"])
            for v in stats.values()):
        raise SystemExit(f"chip_smoke: a fallback fired on the healthy main "
                         f"path: {ladder}, {resilience.fallback_events()}")

    # -- 3. each kernel against its plain version, on the card ------------
    calls = {
        "reduce_mul": lowering.prepare_call(
            compiler.dot_product_nest(n_vec), reduction.MUL,
            {"A": x, "B": y}),
        "map_relu": lowering.prepare_call(
            compiler.elementwise_nest(n_vec), relu.RELU, {"X": xr},
            mode="map", out_dtype=xr.dtype),
        "contract_gemm": lowering.prepare_call(
            compiler.gemm_nest(m, n, k), gemm.DOT, {"A": a, "B": b}),
        "contract_gemv": lowering.prepare_call(
            compiler.gemv_nest(gm, gn), gemv.MATVEC, {"A": ga, "x": gx}),
        "halo_stencil1d": lowering.prepare_call(
            compiler.stencil_nest(n_vec, stencil.TAPS), stencil.STENCIL1D,
            {"x": xs, "w": ws}),
        "halo_stencil2d": lowering.prepare_call(
            compiler.stencil2d_nest(hw, hw, stencil.TAPS), stencil.STENCIL2D,
            {"x": x2, "wx": wx2, "wy": wy2}),
    }
    # K11 over each attention cell's head batch: the single-head plan and
    # kernel, every head's layouts (what ssr_flash_attention launches); at a
    # schedule deeper than 2, R12
    def attention_call(cell, schedule=lowering.DEFAULT_SCHEDULE):
        heads, _s, _d, causal, window = ATTENTION_CELLS[cell]
        q_, k_, v_ = qkv[cell]
        _, static, _ = attention._prepare(q_[0], k_[0], v_[0], causal, window)
        one = lowering.prepare_call(
            attention._nest(static), attention._body(static),
            {"Q": q_[0], "K": k_[0], "V": v_[0]}, out_dtype=q_.dtype,
            schedule=schedule)
        batch = {"Q": q_, "K": k_, "V": v_}
        layouts = lowering.stream_layouts(
            one.lowered, [batch[s_.name] for s_ in one.lowered.in_streams],
            lead=(heads,))
        return lowering.PreparedCall(kernel=one.kernel, layouts=layouts,
                                     lowered=one.lowered, bounds=one.bounds)

    att_calls = {cell: attention_call(cell) for cell in ATTENTION_CELLS}
    calls["rescale_attention"] = att_calls["attention_qwen3"]
    # K12/K13 on the ELL planes the entry points pack on the card
    sparse_ops = {"spmv": {"vals": hv, "cidx": hc, "x": hx},
                  "spmm": {"vals": sv, "cidx": sc, "X": sX}}
    calls["gather_spmv"] = lowering.prepare_call(
        compiler.spmv_nest(hm, hk), sparse.SPMV, sparse_ops["spmv"])
    calls["gather_spmm"] = lowering.prepare_call(
        compiler.spmm_nest(sm, SPMM_RHS, sk, SPMM_RHS), sparse.SPMM,
        sparse_ops["spmm"])
    # the baselines' padded layouts, as their MonolithicKernels prepare them
    xp, yp = frontend.pad_vector(x), frontend.pad_vector(y)
    gxp = gx.reshape(1, gn)
    base_layouts = {"base_reduce": (xp, yp),
                    "base_relu": (frontend.pad_vector(xr),),
                    "base_gemm": (a, b), "base_gemv": (ga, gxp),
                    "base_stencil1d": (xs.reshape(1, -1), ws.reshape(1, -1)),
                    "base_spmv": (hv, hc, hx.reshape(1, -1)),
                    "base_spmm": (sv, sc, sX)}
    base_plain = {
        "base_reduce": hopper.plain_base_reduce,
        "base_relu": lambda t: hopper.plain_base_map(relu.relu_block, t),
        "base_gemm": hopper.plain_base_gemm,
        "base_gemv": hopper.plain_base_gemv,
        "base_stencil1d": hopper.plain_base_stencil1d,
        "base_spmv": hopper.plain_base_spmv,
        "base_spmm": hopper.plain_base_spmm,
    }

    def plain(call):
        return call.finish(call.kernel.plain(call.layouts))

    checks, errors, failed = {}, {}, []
    # dot: f32 sums of 2**26 products in two orders.  The control is what a
    # kernel that dropped one grid step (one (8, 128) block) would be off
    # by; the limit must lie below it, or the check could not see such a
    # kernel.
    ref = plain(calls["reduce_mul"])
    ref_b = base_plain["base_reduce"](xp, yp)[0, 0]
    scale = float(torch.sum(torch.abs(x * y)))
    step = math.prod(calls["reduce_mul"].kernel.geometry.ins[0].block)
    dropped = float(torch.dot(x[:step], y[:step]))
    if dropped <= DOT_LIMIT * scale:
        failed.append("dot: limit above the dropped-step control")
    for key, kname, want in (("dot", "reduce_mul", ref),
                             ("dot_ssr_call", "reduce_mul", ref),
                             ("dot_baseline", "base_reduce", ref_b)):
        err = abs(float(main[key]) - float(want))
        checks[key] = {"abs_err": err, "rel_err": err / scale,
                       "limit": DOT_LIMIT, "dropped_step_rel": dropped / scale}
        errors[kname] = max(errors.get(kname, 0.0), err)
    err = abs(float(main["dot_baseline"]) - float(main["dot"]))
    checks["dot_baseline_vs_ssr"] = {"abs_err": err, "rel_err": err / scale,
                                     "limit": DOT_LIMIT}
    # K1 to the bits of the two-launch K1 it replaced, as
    # hopper.reduce_mul_model computes them (numpy float32: each thread's
    # packs in step order, one FMA rounding each, ssr_cta_sum<256> a run,
    # the fold's 1,024 lanes), on the dot cell in f32 and rounded to bf16
    # and at n = 1,000 and 2**20 ± 1,024; five K1 runs of the dot cell give
    # the main path's bits, and its run on the first block zeroed differs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def k1_model(key, x_, y_):
        call_ = lowering.prepare_call(compiler.dot_product_nest(x_.numel()),
                                      reduction.MUL, {"A": x_, "B": y_})
        got_ = np.float32(float(call_.run()))
        geo_ = call_.kernel.geometry
        runs_, per_, _, _ = hopper.reduce_split(geo_.steps, sms)
        a_, b_ = (t.float().cpu().numpy() for t in call_.layouts)
        model = hopper.reduce_mul_model(
            a_, b_, per_, runs_,
            vec=hopper._vector_width(call_.layouts, geo_.ins))
        checks[f"k1_model_{key}"] = {
            "exact": bool(got_.view(np.int32) == model.view(np.int32)),
            "abs_err": abs(float(got_) - float(model)), "limit": 0.0,
            "kernel": "reduce_mul", "against": "hopper.reduce_mul_model"}

    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).removeprefix("torch.")
        k1_model(f"dot_{tag}", x.to(dt), y.to(dt))
        for n_ in (1000, (1 << 20) - 1024, (1 << 20) + 1024):
            k1_model(f"{tag}_{n_}",
                     torch.rand(n_, generator=gen, device=dev).to(dt),
                     torch.rand(n_, generator=gen, device=dev).to(dt))
    runs = [calls["reduce_mul"].run() for _ in range(5)]
    xz = x.clone()
    xz[:step] = 0
    ctrl = lowering.prepare_call(compiler.dot_product_nest(n_vec),
                                 reduction.MUL, {"A": xz, "B": y}).run()
    checks["k1_dot_five_runs"] = {
        "exact": all(torch.equal(r_.reshape(-1), main["dot"].reshape(-1))
                     for r_ in runs)
        and not torch.equal(ctrl.reshape(-1), main["dot"].reshape(-1)),
        "abs_err": max(abs(float(r_) - float(main["dot"])) for r_ in runs),
        "limit": 0.0, "kernel": "reduce_mul",
        "zeroed_block_control": float(ctrl)}
    del xz, runs, ctrl
    # relu: the value is selected, never computed — exact to the bit in
    # every dtype, NaN payloads and signed zeros included.
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int32: torch.int32}

    def exact(key, got, want):
        same = bool(torch.equal(got.view(bits[got.dtype]),
                                want.view(bits[want.dtype])))
        diff = (got.float() - want.float()).abs()
        err = float(diff[~diff.isnan()].max())
        checks[key] = {"exact": same, "abs_err": err, "limit": 0.0}
        return err

    for key, inp in (("relu", xr), ("relu_int32", xi), ("relu_bf16", xb)):
        want = plain(lowering.prepare_call(
            compiler.elementwise_nest(n_vec), relu.RELU, {"X": inp},
            mode="map", out_dtype=inp.dtype))
        errors["map_relu"] = max(errors.get("map_relu", 0.0),
                                 exact(key, main[key], want))
        want_b = frontend.trim_vector(
            base_plain["base_relu"](frontend.pad_vector(inp)), n_vec)
        errors["base_relu"] = max(
            errors.get("base_relu", 0.0),
            exact(f"{key}_baseline", main[f"{key}_baseline"], want_b))
        exact(f"{key}_baseline_vs_ssr", main[f"{key}_baseline"], main[key])
    # gemm/gemv: k-long f32 dot products summed in two orders, held to
    # CONTRACT_LIMIT·(|a|·|b|) per output.  The control is the same product
    # from TF32 inputs (cuBLAS with TF32 on for gemm; inputs rounded to TF32
    # for gemv, since cuBLAS's gemv has no TF32 path); it must read above
    # the limit, or the check could not see a TF32 shortcut.
    def tf32_matmul():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.matmul(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    for key, kname, bname, absmat, control in (
            ("gemm", "contract_gemm", "base_gemm",
             lambda: torch.abs(a) @ torch.abs(b), tf32_matmul),
            ("gemv", "contract_gemv", "base_gemv",
             lambda: torch.abs(ga) @ torch.abs(gx),
             lambda: torch.mv(tf32_round(ga), tf32_round(gx)))):
        scale_t = absmat()
        ctrl = control()
        for ckey, cname, got, want in (
                (key, kname, main[key], plain(calls[kname])),
                (f"{key}_baseline", bname, main[f"{key}_baseline"],
                 base_plain[bname](*base_layouts[bname]).reshape(
                     main[f"{key}_baseline"].shape))):
            c = {"abs_err": float((got - want).abs().max()),
                 "rel_to_abs_prod": rel_to_abs_prod(got, want, scale_t),
                 "limit": CONTRACT_LIMIT,
                 "tf32_control": rel_to_abs_prod(ctrl, want, scale_t)}
            if cname == "contract_gemm":     # how K3's copies ran
                c["route"] = hopper.contract_gemm_route(
                    calls[kname].kernel.geometry, calls[kname].layouts)
            checks[ckey] = c
            errors[cname] = c["abs_err"]
            if c["tf32_control"] <= CONTRACT_LIMIT:
                failed.append(f"{ckey}: limit above the TF32 control")
        checks[f"{key}_baseline_vs_ssr"] = {
            "rel_to_abs_prod": rel_to_abs_prod(main[f"{key}_baseline"],
                                               main[key], scale_t),
            "abs_err": float((main[f"{key}_baseline"] - main[key])
                             .abs().max()),
            "limit": CONTRACT_LIMIT}
    # -- 3a. the halo and rescale kernels against their plain versions -----
    def rel_max(got, want, scale_t) -> float:
        return float(((got - want).abs() / scale_t).max())

    def stencil_check(key, kname, got, want, scale_t, ctrl):
        """``got`` against ``want`` relative to the stencil of the absolute
        values, beside the control: the plain version on bf16 inputs."""
        c = {"abs_err": float((got - want).abs().max()),
             "rel_err": rel_max(got, want, scale_t), "limit": STENCIL_LIMIT,
             "bf16_control": rel_max(ctrl, want, scale_t), "kernel": kname}
        checks[key] = c
        errors[kname] = max(errors.get(kname, 0.0), c["abs_err"])
        if c["bf16_control"] <= STENCIL_LIMIT:
            failed.append(f"{key}: limit above the bf16 control")

    def bf16(t):
        return t.to(torch.bfloat16).float()

    halo_plain = {}
    for key, kname in (("stencil1d", "halo_stencil1d"),
                       ("stencil2d", "halo_stencil2d")):
        call = calls[kname]
        want = plain(call)
        scale_t = call.finish(call.kernel.plain(tuple(
            t.abs() for t in call.layouts))) + 1e-30
        ctrl = call.finish(call.kernel.plain(tuple(
            bf16(t) for t in call.layouts)))
        stencil_check(key, kname, main[key], want, scale_t, ctrl)
        halo_plain[key] = (want, scale_t)
    # B5 against its plain version (the baseline body on its layouts), and
    # against K9
    bx, bwt = base_layouts["base_stencil1d"]
    want = hopper.plain_base_stencil1d(bx, bwt).reshape(-1)
    scale_t = hopper.plain_base_stencil1d(bx.abs(), bwt.abs()).reshape(-1) \
        + 1e-30
    stencil_check("stencil1d_baseline", "base_stencil1d",
                  main["stencil1d_baseline"], want, scale_t,
                  hopper.plain_base_stencil1d(bf16(bx), bf16(bwt)).reshape(-1))
    checks["stencil1d_baseline_vs_ssr"] = {
        "abs_err": float((main["stencil1d_baseline"]
                          - main["stencil1d"]).abs().max()),
        "rel_err": rel_max(main["stencil1d_baseline"], main["stencil1d"],
                           halo_plain["stencil1d"][1]),
        "limit": STENCIL_LIMIT}
    # K9's relu drain: bit for bit the selection of K9's own output
    checks["stencil1d_relu_vs_selection"] = {
        "exact": bool(torch.equal(
            main["stencil1d_relu"].view(torch.int32),
            relu.relu_block(main["stencil1d"]).view(torch.int32))),
        "abs_err": 0.0, "limit": 0.0}
    # K11 over every head of each cell against its plain version, relative
    # to max |v|, beside the plain version on TF32 inputs
    for cell, call in att_calls.items():
        vmax = float(qkv[cell][2].abs().max())
        want = plain(call)
        ctrl = plain(lowering.PreparedCall(
            kernel=call.kernel, layouts=tuple(tf32_round(t)
                                              for t in call.layouts),
            lowered=call.lowered, bounds=call.bounds))
        c = {"abs_err": float((main[cell] - want).abs().max()),
             "limit": ATTENTION_LIMIT, "heads": ATTENTION_CELLS[cell][0],
             "kernel": "rescale_attention"}
        c["rel_err"] = c["abs_err"] / vmax
        c["tf32_control"] = float((ctrl - want).abs().max()) / vmax
        checks[cell] = c
        errors["rescale_attention"] = max(
            errors.get("rescale_attention", 0.0), c["abs_err"])
        if c["tf32_control"] <= ATTENTION_LIMIT:
            failed.append(f"{cell}: limit above the TF32 control")
        if tuple(main[cell].shape) != tuple(qkv[cell][0].shape):
            failed.append(f"{cell}: output shape {tuple(main[cell].shape)}")
        del want, ctrl

    # -- 3b. the fused kernels' instantiations against their plain versions
    def inst_check(label, kname, call, kind):
        """One instantiation, run on the card and plain on the same inputs,
        held to the limit of its kind beside a control above it."""
        kern = call.kernel
        got = call.run()
        want = call.finish(kern.plain(call.layouts))
        n_s = kern.program.n_streams
        if kind == "reduce":
            ref_ = abs(float(want))
            ctrl = call.finish(kern.plain(first_block_zeroed(call)))
            err = abs(float(got) - float(want))
            c = {"abs_err": err, "rel_err": err / ref_, "limit": DOT_LIMIT,
                 "dropped_step_rel": abs(float(ctrl) - float(want)) / ref_}
            control = c["dropped_step_rel"]
        elif kind == "map":
            ctrl = call.finish(kern.plain(tuple(
                t.to(torch.bfloat16).float() if k_ < n_s else t
                for k_, t in enumerate(call.layouts))))
            c = {"abs_err": float((got - want).abs().max()),
                 "rel_err": map_err(got, want), "limit": MAP_LIMIT,
                 "bit_exact": bool(torch.equal(got, want)),
                 "bf16_control": map_err(ctrl, want)}
            control = c["bf16_control"]
        else:   # products: error relative to |a|·|b|, TF32 control
            scale_t = call.finish(kern.plain(tuple(
                t.abs() for t in call.layouts))) + 1e-30
            ctrl = call.finish(kern.plain(tuple(
                tf32_round(t) for t in call.layouts)))
            c = {"abs_err": float((got - want).abs().max()),
                 "rel_to_abs_prod": rel_to_abs_prod(got, want, scale_t),
                 "limit": CONTRACT_LIMIT,
                 "tf32_control": rel_to_abs_prod(ctrl, want, scale_t)}
            control = c["tf32_control"]
        c["kernel"] = kname
        checks[label] = c
        errors[kname] = max(errors.get(kname, 0.0), c["abs_err"])
        if control <= c["limit"]:
            failed.append(f"{label}: limit above the control")
        return got

    n_v = n_vec
    ssd_ops, axd_ops = {"X": x, "Y": y}, {"X": x, "Y": y, "W": w}
    fused_calls = {
        "sum_sq_diff": lowering.prepare_chain_call(
            chained._chain_nests(n_v, False),
            (chained.SQ_DIFF, chained.IDENTITY), ssd_ops, mode="reduce"),
        "axpy_dot": lowering.prepare_chain_call(
            chained._chain_nests(n_v, True),
            (chained.axpy_block(0.5), chained.DOT), axd_ops, mode="reduce"),
        "gemv_relu": lowering.prepare_call(
            compiler.gemv_nest(gm, gn), chained.MATVEC_RELU,
            {"A": ga, "x": gx}),
        "stencil1d_relu": lowering.prepare_call(
            compiler.stencil_nest(n_vec, stencil.TAPS),
            chained.STENCIL1D_RELU, {"x": xs, "w": ws}),
    }
    # K9's relu drain against its plain version (the stencil limit; the
    # relu of the stencil of |x| and |w| is that stencil itself)
    sr_call = fused_calls["stencil1d_relu"]
    stencil_check("stencil1d_relu", "halo_stencil1d", main["stencil1d_relu"],
                  plain(sr_call), halo_plain["stencil1d"][1],
                  sr_call.finish(sr_call.kernel.plain(tuple(
                      bf16(t) for t in sr_call.layouts))))
    for cell in ("sum_sq_diff", "axpy_dot"):
        inst_check(f"{cell}_fused", "chain_elem", fused_calls[cell],
                   "reduce")
    pair2 = compiler.elementwise_nest(n_v, ("X", "Y"), 2)
    sq_call = lowering.prepare_call(pair2, chained.SQ_DIFF, ssd_ops,
                                    mode="map")
    ax_call = lowering.prepare_call(pair2, chained.axpy_block(0.5), ssd_ops,
                                    mode="map")
    t_sq = inst_check("sq_diff_map", "chain_elem", sq_call, "map")
    t_ax = inst_check("axpy_map", "chain_elem", ax_call, "map")
    id_call = lowering.prepare_call(
        compiler.elementwise_nest(n_v, ("T",), 1), chained.IDENTITY,
        {"T": t_sq})
    inst_check("identity_reduce", "chain_elem", id_call, "reduce")
    dot_call = lowering.prepare_call(
        compiler.elementwise_nest(n_v, ("T", "W"), 1), chained.DOT,
        {"T": t_ax, "W": w})
    relu_call = lowering.prepare_call(
        compiler.elementwise_nest(gm), relu.RELU, {"X": main["gemv"]},
        mode="map", out_dtype=torch.float32)
    stencil_relu_call = lowering.prepare_call(
        compiler.elementwise_nest(n_vec), relu.RELU, {"X": main["stencil1d"]},
        mode="map", out_dtype=torch.float32)
    unfused_calls = {"sum_sq_diff": [sq_call, id_call],
                     "axpy_dot": [ax_call, dot_call],
                     "gemv_relu": [calls["contract_gemv"], relu_call],
                     "stencil1d_relu": [calls["halo_stencil1d"],
                                        stencil_relu_call]}
    # K4's relu drain: the gemv limit and TF32 control, and bit for bit the
    # selection of K4's own drain
    gscale = torch.abs(ga) @ torch.abs(gx)
    gr_call = fused_calls["gemv_relu"]
    want = gr_call.finish(gr_call.kernel.plain(gr_call.layouts))
    c = {"abs_err": float((main["gemv_relu"] - want).abs().max()),
         "rel_to_abs_prod": rel_to_abs_prod(main["gemv_relu"], want, gscale),
         "limit": CONTRACT_LIMIT, "kernel": "contract_gemv",
         "tf32_control": rel_to_abs_prod(relu.relu_block(torch.mv(
             tf32_round(ga), tf32_round(gx))), want, gscale)}
    checks["gemv_relu"] = c
    if c["tf32_control"] <= CONTRACT_LIMIT:
        failed.append("gemv_relu: limit above the TF32 control")
    checks["gemv_relu_vs_selection"] = {
        "exact": bool(torch.equal(
            main["gemv_relu"].view(torch.int32),
            relu.relu_block(main["gemv"]).view(torch.int32))),
        "abs_err": 0.0, "limit": 0.0}
    # the DAGs: every component of every legal cut, each on the values the
    # kernels before it produced
    cases = {cs.name: cs for cs in dag.dag_cases()}
    dag_kernel = {"layernorm": "dag_layernorm",
                  "softmax_xent": "dag_softmax_xent", "mlp_block": "dag_mlp"}
    stage_calls, dag_insts = {}, {}
    for cell, kname in dag_kernel.items():
        nests, bodies, operands, mode, uniforms = cases[cell].spec(
            *fused_args[cell][0])
        graph = lowering._dag_for(nests, None)
        stage_calls[cell], dag_insts[cell], finals = {}, {}, {}
        for cut in autotune.enumerate_cuts(graph):
            if not autotune.dag_cut_is_legal(
                    graph, cut, nests=nests, bodies=bodies, mode=mode,
                    uniforms=uniforms, device=dev)[0]:
                continue
            env = dict(operands)
            for comp in lowering.dag_components(graph, nests, bodies, cut,
                                                mode=mode):
                if len(comp.stages) == 1:
                    call = lowering.prepare_call(
                        comp.nests[0], comp.bodies[0], env, mode=comp.mode,
                        schedule=lowering.DEFAULT_SCHEDULE,
                        uniforms=uniforms)
                else:
                    call = lowering.prepare_dag_call(
                        comp.nests, comp.bodies, env, mode=comp.mode,
                        uniforms=uniforms)
                how = "products" if cell == "mlp_block" else comp.mode
                if comp.stages in stage_calls[cell]:
                    out = call.run()
                else:
                    stage_calls[cell][comp.stages] = call
                    out = inst_check(
                        f"{cell}_{''.join(map(str, comp.stages))}", kname,
                        call, how)
                    dag_insts[cell][comp.stages] = (
                        comp.nests, comp.bodies, dict(env), comp.mode,
                        uniforms, out)
                if comp.exported is not None:
                    env[comp.exported] = out
            finals[cut] = out
        checks[f"{cell}_cuts"] = {
            "cuts": [list(cut) for cut in finals], "abs_err": 0.0,
            "limit": 0.0, "exact": set(stage_calls[cell]) ==
            {(0, 1, 2), (0,), (1,), (2,), (1, 2)}}
        fused_calls[cell] = stage_calls[cell][(0, 1, 2)]
        for cut, out in finals.items():     # each cut against all-fused
            base_out = finals[()]
            c = {"abs_err": float((out - base_out).abs().max())}
            if cell == "softmax_xent":
                c.update(rel_err=c["abs_err"] / abs(float(base_out)),
                         limit=DOT_LIMIT)
            elif cell == "layernorm":
                c.update(rel_err=map_err(out, base_out), limit=MAP_LIMIT)
            else:
                fc = fused_calls[cell]
                c.update(rel_to_abs_prod=rel_to_abs_prod(
                    out, base_out, fc.finish(fc.kernel.plain(tuple(
                        t.abs() for t in fc.layouts))) + 1e-30),
                    limit=CONTRACT_LIMIT)
            checks[f"{cell}_cut_{''.join(map(str, cut)) or 'none'}"] = c
        unfused_calls[cell] = [stage_calls[cell][(k_,)] for k_ in range(3)]
    # fused against unfused, within the same limits
    for cell in FUSED_LAUNCHES:
        f_, u_ = main[cell], main[f"{cell}_unfused"]
        if cell in ("sum_sq_diff", "axpy_dot", "softmax_xent"):
            err = abs(float(f_) - float(u_))
            c = {"abs_err": err, "rel_err": err / abs(float(f_)),
                 "limit": DOT_LIMIT}
        elif cell == "layernorm":
            c = {"abs_err": float((f_ - u_).abs().max()),
                 "rel_err": map_err(u_, f_), "limit": MAP_LIMIT}
        elif cell == "stencil1d_relu":   # one K9 arithmetic: to the bit
            c = {"exact": bool(torch.equal(f_.view(torch.int32),
                                           u_.view(torch.int32))),
                 "abs_err": float((f_ - u_).abs().max()), "limit": 0.0}
        else:
            fc = fused_calls[cell]
            sc_ = gscale if cell == "gemv_relu" else fc.finish(
                fc.kernel.plain(tuple(t.abs() for t in fc.layouts))
            ).reshape(f_.shape) + 1e-30
            c = {"abs_err": float((f_ - u_).abs().max()),
                 "rel_to_abs_prod": rel_to_abs_prod(u_, f_, sc_),
                 "limit": CONTRACT_LIMIT}
        checks[f"{cell}_fused_vs_unfused"] = c
        for key in (cell, f"{cell}_unfused"):
            if not bool(torch.isfinite(main[key]).all()):
                failed.append(f"{key}: non-finite")
    # -- 3c. the gathers on every row, and odd CSR inputs against the oracle
    def floats_bf16(ts):
        return tuple(bf16(t) if t.is_floating_point() else t for t in ts)

    def sparse_check(key, kname, got, want, scale_t, ctrl):
        """``got`` against ``want`` relative to Σ_j |v_ij|·|x_cidx|, beside
        the control: the plain version on bf16-rounded values."""
        c = {"abs_err": float((got - want).abs().max()),
             "rel_err": rel_max(got, want, scale_t), "limit": SPARSE_LIMIT,
             "bf16_control": rel_max(ctrl, want, scale_t), "kernel": kname}
        checks[key] = c
        errors[kname] = max(errors.get(kname, 0.0), c["abs_err"])
        if c["bf16_control"] <= SPARSE_LIMIT:
            failed.append(f"{key}: limit above the bf16 control")

    sparse_scale = {}
    for kname, keys in (("gather_spmv", ("spmv", "sparse_gemv")),
                        ("gather_spmm", ("spmm",))):
        call = calls[kname]
        want = plain(call)
        scale_t = call.finish(call.kernel.plain(tuple(
            t.abs() for t in call.layouts))) + 1e-30
        ctrl = call.finish(call.kernel.plain(floats_bf16(call.layouts)))
        for key in keys:
            sparse_check(key, kname, main[key], want, scale_t, ctrl)
        sparse_scale[keys[0]] = scale_t
        del want, ctrl
    for key, bname, kkey in (("spmv_baseline", "base_spmv", "spmv"),
                             ("spmm_baseline", "base_spmm", "spmm")):
        lay, pf, shape = base_layouts[bname], base_plain[bname], main[key].shape
        sparse_check(key, bname, main[key], pf(*lay).reshape(shape),
                     pf(*(t.abs() for t in lay)).reshape(shape) + 1e-30,
                     pf(*floats_bf16(lay)).reshape(shape))
        checks[f"{key}_vs_ssr"] = {
            "abs_err": float((main[key] - main[kkey]).abs().max()),
            "rel_err": rel_max(main[key], main[kkey], sparse_scale[kkey]),
            "limit": SPARSE_LIMIT}
    # odd CSR inputs through the entry points and the baselines, against
    # the densified oracle within the registry tol of the terms' sizes:
    # |got − oracle| ≤ tol·(1 + Σ_j |v_ij|·|x_cidx|)
    srng = np.random.default_rng(seed)
    long_cols = {k_: np.sort(srng.choice(1000, k_, replace=False))
                 for k_ in (300, 600)}
    odd_csr = {
        "all_zero": (np.zeros(0, np.float32), np.zeros(0, np.int64),
                     np.zeros(6, np.int64), 7),
        "empty_rows": (np.asarray([1.0, 2.0, 3.0, 4.0], np.float32),
                       np.asarray([0, 1, 2, 3]), np.asarray([0, 0, 4, 4, 4]),
                       5),
        "one_by_one": (np.asarray([3.0], np.float32), np.asarray([0]),
                       np.asarray([0, 1]), 1),
        **{f"row_{k_}": (srng.standard_normal(k_ + 1).astype(np.float32),
                         np.concatenate([cols, [7]]),
                         np.asarray([0, k_, k_ + 1]), 1000)
           for k_, cols in long_cols.items()},
    }
    for name, (d_, i_, p_, n_) in odd_csr.items():
        for prod, c_ in (("spmv", None), ("spmm", 200)):
            operand = randn(n_) if c_ is None else randn(n_, c_)
            ref_fn = getattr(sparse, f"ref_{prod}")
            want = ref_fn(d_, i_, p_, operand)
            scale_t = ref_fn(np.abs(d_), i_, p_, operand.abs())
            for variant in ("ssr", "baseline"):
                got = getattr(sparse, f"{variant}_{prod}")(d_, i_, p_, operand,
                                                           device=dev)
                checks[f"odd_{prod}_{name}_{variant}"] = {
                    "abs_err": float((got - want).abs().max()),
                    "rel_err": float(((got - want).abs() / (1 + scale_t))
                                     .max()), "limit": 1e-5}
    # -- 3d. the stream kernels against their plain versions ----------------
    def stream_parts(module, *args_):
        """(Launch, prepared arrays, body) of a StreamKernel entry's call."""
        arrays_, static_, _ = module._prepare(*args_)
        return (module._launch(static_, *arrays_), tuple(arrays_),
                module._ssr._body(static_))

    # K14 and B8, and their plain versions, against an f64 prefix sum,
    # relative to the prefix sum of |x|; the control drops the carry out of
    # the first tile, as a kernel that lost one tile's offset would
    exact64 = torch.cumsum(xsc.double(), 0)
    pscale = torch.cumsum(xsc.double().abs(), 0)

    def scan_rel(t) -> float:
        return float(((t.double() - exact64).abs() / pscale).max())

    sc_lc, sc_arrays, _ = stream_parts(scan, xsc)
    sc_plain = hopper.plain_stream(scan.SCAN, sc_lc, sc_arrays)[0]
    sc_plain = sc_plain.reshape(-1)[:SCAN_N]
    sc_base_plain = hopper.plain_base_scan(sc_arrays[0]).reshape(-1)[:SCAN_N]
    dropped = sc_plain.clone()
    dropped[hopper.SCAN_TILE:] -= sc_plain[hopper.SCAN_TILE - 1]
    scan_ctrl = scan_rel(dropped)
    if scan_ctrl <= SCAN_LIMIT:
        failed.append("prefix_sum: limit above the dropped-carry control")
    for key, kname, want in (("prefix_sum", "stream_scan", sc_plain),
                             ("prefix_sum_baseline", "base_scan",
                              sc_base_plain)):
        got = main[key]
        c = {"abs_err": float((got - want).abs().max()),
             "rel_err": scan_rel(got), "plain_rel_err": scan_rel(want),
             "limit": SCAN_LIMIT, "dropped_carry_control": scan_ctrl,
             "kernel": kname}
        checks[key] = c
        errors[kname] = c["abs_err"]
        if c["plain_rel_err"] > SCAN_LIMIT:
            failed.append(f"{key}: the plain version above the limit")
    # two runs of K14 agree to the bit: no order depends on timing
    checks["prefix_sum"]["exact"] = bool(torch.equal(
        ops.prefix_sum(xsc, ssr=True), main["prefix_sum"]))
    del exact64, pscale, dropped

    # K15 against its plain version relative to Σ|x| of each transform,
    # beside the plain version on twiddles rounded to bf16
    def fft_check(key, re_, im_):
        lc_, arrays_, body_ = stream_parts(fft, re_, im_)
        got = main["fft"] if key == "fft" else ops.fft(re_, im_, ssr=True)
        shape_ = tuple(re_.shape)
        want = [t.reshape(shape_)
                for t in hopper.plain_stream(body_, lc_, arrays_)]
        ctrl_ = [t.reshape(shape_) for t in hopper.plain_stream(
            body_, lc_, (*arrays_[:2], *(bf16(t) for t in arrays_[2:])))]
        sc_ = (re_.float().abs() + im_.float().abs()).sum(-1, keepdim=True)

        def rel(outs) -> float:
            return max(float(((g - w).abs() / sc_).max())
                       for g, w in zip(outs, want))

        c = {"abs_err": max(float((g - w).abs().max())
                            for g, w in zip(got, want)),
             "rel_err": rel(got), "limit": FFT_LIMIT,
             "bit_exact": all(bool(torch.equal(g, w))
                              for g, w in zip(got, want)),
             "bf16_twiddle_control": rel(ctrl_), "kernel": "stream_fft",
             "shape": list(shape_), "dtype": str(re_.dtype)}
        if key != "fft_2p22":      # the row fits a CTA: the same bits
            c["exact"] = c["bit_exact"]
        checks[key] = c
        errors["stream_fft"] = max(errors.get("stream_fft", 0.0),
                                   c["abs_err"])
        if c["bf16_twiddle_control"] <= FFT_LIMIT:
            failed.append(f"{key}: limit above the bf16-twiddle control")
        if any(tuple(g.shape) != shape_ or not bool(torch.isfinite(g).all())
               for g in got):
            failed.append(f"{key}: output shape or non-finite values")

    fft_check("fft", fre, fim)
    fft_check("fft_2p22", randn(1 << 22), randn(1 << 22))
    fft_check("fft_bf16", fre[:256].to(torch.bfloat16),
              fim[:256].to(torch.bfloat16))

    # K16 to the bit against its plain version
    sort_bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                 torch.int32: torch.int32}

    def sort_check(key, x_):
        lc_, arrays_, body_ = stream_parts(bitonic, x_)
        got = main["sort"] if key == "sort" else ops.sort(x_, ssr=True)
        want = hopper.plain_stream(body_, lc_, arrays_)[0].reshape(x_.shape)
        diff = (got.float() - want.float()).abs()
        diff = diff[~diff.isnan()]
        checks[key] = {
            "exact": bool(torch.equal(got.view(sort_bits[got.dtype]),
                                      want.view(sort_bits[want.dtype]))),
            "abs_err": float(diff.max()) if diff.numel() else 0.0,
            "limit": 0.0, "kernel": "stream_bitonic",
            "shape": list(x_.shape), "dtype": str(x_.dtype)}
        errors["stream_bitonic"] = max(errors.get("stream_bitonic", 0.0),
                                       checks[key]["abs_err"])
        return got

    sort_check("sort", xso)
    checks["sort_vs_torch_sort"] = {
        "exact": bool(torch.equal(main["sort"], torch.sort(xso).values)),
        "abs_err": 0.0, "limit": 0.0}
    sort_check("sort_batch", randn(1 << 16, 1024))
    sort_check("sort_bf16", randn(1 << 20).to(torch.bfloat16))
    sort_check("sort_int32", torch.randint(
        -(1 << 31), (1 << 31) - 1, (256, 4096), generator=gen, device=dev,
        dtype=torch.int32))
    # a quarter −0, a quarter +0, shuffled: −0 sorts below +0; then one NaN
    # turns every output to NaN, as the reference's ssr_sort does
    nz = 1 << 20
    xz = randn(nz)
    xz[: nz // 2] = 0.0
    xz[: nz // 4] = -0.0
    xz = xz[torch.randperm(nz, generator=gen, device=dev)]
    got = sort_check("sort_signed_zeros", xz)
    zeros = got[got == 0]
    checks["sort_signed_zeros"]["exact"] &= bool(
        torch.signbit(zeros[: nz // 4]).all()) and not bool(
        torch.signbit(zeros[nz // 4:]).any())
    xz[nz // 3] = float("nan")
    got = sort_check("sort_nan", xz)
    checks["sort_nan"]["exact"] &= bool(torch.isnan(got).all())

    # -- 3e. the rings against K1–K4 to the bit, at the cells' sizes -------
    # (call mode, nest, body, operands, out dtype, bit view, depths) a cell;
    # R4 also in bf16 and with an x that never moves
    gab, gxb = ga.bfloat16(), gx.bfloat16()
    gai = ga[:2048, :512].contiguous()
    ring_cells = {
        "dot": ("reduce", compiler.dot_product_nest(n_vec), reduction.MUL,
                {"A": x, "B": y}, None, torch.int32,
                (*RING_DEPTHS, *RING_PAIRS)),
        "dot_bf16": ("reduce", compiler.dot_product_nest(n_vec),
                     reduction.MUL, {"A": x.bfloat16(), "B": y.bfloat16()},
                     None, torch.int32, RING_DEPTHS),
        "relu": ("map", compiler.elementwise_nest(n_vec), relu.RELU,
                 {"X": xr}, xr.dtype, torch.int32, RING_DEPTHS),
        "relu_int32": ("map", compiler.elementwise_nest(n_vec), relu.RELU,
                       {"X": xi}, xi.dtype, torch.int32, RING_DEPTHS),
        "relu_bf16": ("map", compiler.elementwise_nest(n_vec), relu.RELU,
                      {"X": xb}, xb.dtype, torch.int16, RING_DEPTHS),
        "gemm": ("nest", compiler.gemm_nest(m, n, k), gemm.DOT,
                 {"A": a, "B": b}, None, torch.int32,
                 (*RING_DEPTHS, *RING_PAIRS)),
        "gemv": ("nest", compiler.gemv_nest(gm, gn), gemv.MATVEC,
                 {"A": ga, "x": gx}, None, torch.int32,
                 (*RING_DEPTHS, *RING_PAIRS)),
        "gemv_relu": ("nest", compiler.gemv_nest(gm, gn),
                      chained.MATVEC_RELU, {"A": ga, "x": gx}, None,
                      torch.int32, (*RING_DEPTHS, *RING_PAIRS)),
        "gemv_bf16": ("nest", compiler.gemv_nest(gm, gn), gemv.MATVEC,
                      {"A": gab, "x": gxb}, None, torch.int32,
                      (*RING_DEPTHS, *RING_PAIRS)),
        "gemv_relu_bf16": ("nest", compiler.gemv_nest(gm, gn),
                           chained.MATVEC_RELU, {"A": gab, "x": gxb}, None,
                           torch.int32, (*RING_DEPTHS, *RING_PAIRS)),
        # one contraction step: x never moves (one slot, fetched once)
        "gemv_x_invariant": ("nest", compiler.gemv_nest(2048, 512),
                             gemv.MATVEC, {"A": gai, "x": gx[:512]}, None,
                             torch.int32, (*RING_DEPTHS, *RING_PAIRS)),
    }

    def cell_call(cell, depth):
        mode_, nest_, body_, ops_, out_dt, _, _ = ring_cells[cell]
        kw = {} if out_dt is None else {"out_dtype": out_dt}
        return lowering.prepare_call(nest_, body_, ops_, mode=mode_,
                                     schedule=deep[depth] if depth != 2
                                     else lowering.DEFAULT_SCHEDULE, **kw)

    def same_bits(t1, t2, view) -> bool:
        return bool(torch.equal(t1.contiguous().view(view),
                                t2.contiguous().view(view)))

    def ring_measure(cell):
        """(err(got, want), limit) of a ring cell against the plain ring:
        relu's bits (the max |difference| besides NaNs, held to 0), a dot's
        |difference| over Σ|a·b| (DOT_LIMIT), a contraction's over |A|·|B|
        per output (CONTRACT_LIMIT)."""
        if cell.startswith("relu"):
            def err(got, want):
                d = (got.float() - want.float()).abs()
                return float(d[~d.isnan()].max())
            return err, 0.0
        a_, b_ = (t.float() for t in ring_cells[cell][3].values())
        if cell.startswith("dot"):
            sc = float(torch.sum(torch.abs(a_ * b_)))
            return (lambda got, want: float(
                (got.float() - want.float()).abs().max()) / sc), DOT_LIMIT
        sc = torch.abs(a_) @ torch.abs(b_)
        return (lambda got, want: rel_to_abs_prod(
            got.reshape(sc.shape), want.reshape(sc.shape), sc)), \
            CONTRACT_LIMIT

    def plain_ring_check(key, cell, depth, got, want, ctrl):
        """``got`` (a ring's output at the cell's size) against ``want``,
        the plain ring's, beside ``ctrl``, the ring on its first block
        zeroed: its err must read above the limit (relu: its bits must
        differ)."""
        err, limit = ring_measure(cell)
        view = ring_cells[cell][5]
        relu_cell = cell.startswith("relu")
        c = {"exact": same_bits(got, want, view) if relu_cell else True,
             "rel_err": err(got, want), "abs_err": float(
                 (got.float() - want.float()).abs().nan_to_num().max()),
             "limit": limit, "depths": list(ring_calls[cell, depth]
                                            .kernel.depths)}
        if cell == "gemm":
            c["route"] = hopper.gemm_ring_route(
                ring_calls[cell, depth].kernel.geometry,
                ring_calls[cell, depth].layouts)
        if relu_cell:
            c["control_differs"] = not same_bits(ctrl, want, view)
            bad = not c["control_differs"]
        else:
            c["zeroed_block_control"] = err(ctrl, want)
            bad = c["zeroed_block_control"] <= limit
        checks[key] = c
        if bad:
            failed.append(f"{key}: limit above the zeroed-block control")

    ring_calls = {}
    for cell, (_, _, _, _, _, view, depths) in ring_cells.items():
        want = cell_call(cell, 2).run()
        for depth in depths:
            call = ring_calls[cell, depth] = cell_call(cell, depth)
            rname = hopper.RING_KERNELS[call.kernel.device_key]
            got = call.run()
            ctrl = call.finish(call.kernel(*first_block_zeroed(call)))
            err = float((got.float() - want.float()).abs().nan_to_num()
                        .max())
            c = {"exact": same_bits(got, want, view)
                 and call.kernel.pipelined,
                 "control_differs": not same_bits(ctrl, want, view),
                 "abs_err": err, "limit": 0.0, "kernel": rname,
                 "depths": list(call.kernel.depths)}
            if rname == "ring_contract_gemm":
                c["route"] = hopper.gemm_ring_route(call.kernel.geometry,
                                                    call.layouts)
            checks[f"ring_{cell}_{depth}"] = c
            errors[rname] = max(errors.get(rname, 0.0), err)
            if not c["control_differs"]:
                failed.append(f"ring_{cell}_{depth}: the zeroed first block "
                              "left the result unchanged")
            # at the main path's depths: the ring kernel and the main
            # path's own ring outputs against the plain ring at full size
            entries = [e for e, cd in RING_ENTRY.items() if cd == (cell, depth)]
            if entries or RING_MAIN_DEPTH.get(cell) == depth:
                want_p = plain(call)
                plain_ring_check(f"plain_ring_full_{cell}_{depth}", cell,
                                 depth, got, want_p, ctrl)
                for e in entries:
                    plain_ring_check(f"{e}_vs_plain_ring", cell, depth,
                                     main[e], want_p, ctrl)
                del want_p
            del got, ctrl
        del want
    # R3's cp.async route at the main path's depth, against K3 to the bit
    # on the gemm cell's inputs: in bf16, and in f32 on a layout whose
    # pitch is no multiple of 16 bytes (lanes 126: blocks 378 wide on a
    # 4158-element pitch, copied element by element), each beside its run
    # on the first blocks zeroed
    for key, ops_, lanes in (
            ("ring_gemm_bf16_3", {"A": a.bfloat16(), "B": b.bfloat16()},
             128),
            ("ring_gemm_pitch_4158_3", {"A": a, "B": b}, 126)):
        depth = RING_MAIN_DEPTH["gemm"]
        nest_ = compiler.gemm_nest(m, n, k)
        want = lowering.prepare_call(
            nest_, gemm.DOT, ops_, schedule=lowering.Schedule(
                lanes=lanes)).run()
        call = lowering.prepare_call(
            nest_, gemm.DOT, ops_, schedule=lowering.Schedule(
                lanes=lanes, buffer_depth=depth))
        route = hopper.gemm_ring_route(call.kernel.geometry, call.layouts)
        got = call.run()
        ctrl = call.finish(call.kernel(*first_block_zeroed(call)))
        c = {"exact": same_bits(got, want, torch.int32)
             and call.kernel.pipelined and route != "tma",
             "control_differs": not same_bits(ctrl, want, torch.int32),
             "abs_err": float((got - want).abs().max()), "limit": 0.0,
             "kernel": "ring_contract_gemm", "route": route,
             "pitch": int(call.layouts[0].shape[1]), "depths": [depth]}
        checks[key] = c
        errors["ring_contract_gemm"] = max(
            errors.get("ring_contract_gemm", 0.0), c["abs_err"])
        if not c["control_differs"]:
            failed.append(f"{key}: the zeroed first block left the result "
                          "unchanged")
        del got, ctrl, want
    # K3's entry and wrapper count the same shared memory
    checks["contract_gemm_smem_bytes"] = {
        "exact": all(e == w for e, w in k3_smem.values()),
        "entry_and_wrapper": k3_smem, "abs_err": 0.0, "limit": 0.0}
    # R3, K3, R1, R2 and R4 spill nothing, in any instantiation
    for name in ("ring_contract_gemm", "contract_gemm", "ring_reduce_mul",
                 "ring_map_relu", "ring_contract_gemv"):
        local = attributes[name]["localSizeBytes"]
        checks[f"{name}_local_bytes"] = {
            "exact": local == 0, "local_bytes": local, "local_limit": 0,
            "abs_err": 0.0, "limit": 0.0}
    # the plain ring (its fetch log the reference's rotation) against R1–R4
    # at small sizes, one CTA's run over the whole grid
    sa_, sb_ = randn(300, 1100), randn(1100, 260)
    sv_ = torch.rand(1 << 20, generator=gen, device=dev)
    small = {
        "dot": (lowering.prepare_call(
            compiler.dot_product_nest((1 << 20) - 3), reduction.MUL,
            {"A": sv_[3:], "B": sv_[:-3]}, schedule=deep[(2, 4)]),
            DOT_LIMIT),
        "relu": (lowering.prepare_call(
            compiler.elementwise_nest(1 << 20), relu.RELU, {"X": xr[:1 << 20]},
            mode="map", out_dtype=xr.dtype, schedule=deep[8]), 0.0),
        "gemm": (lowering.prepare_call(
            compiler.gemm_nest(300, 260, 1100), gemm.DOT,
            {"A": sa_, "B": sb_}, schedule=deep[4]), CONTRACT_LIMIT),
        "gemv_x_invariant": (lowering.prepare_call(
            compiler.gemv_nest(2048, 512), gemv.MATVEC,
            {"A": ga[:2048, :512].contiguous(), "x": gx[:512]},
            schedule=deep[4]),
            CONTRACT_LIMIT),
    }
    for cell, (call, limit) in small.items():
        kern = call.kernel
        got = call.run()
        want = plain(call)
        zeroed = call.finish(kern.plain(first_block_zeroed(call)))
        scale_t = call.finish(kern.plain(tuple(t.abs() for t in call.layouts)
                                         )) + 1e-30
        rel = float(((got.float() - want.float()).abs() / scale_t.float())
                    .nan_to_num().max())
        ctrl = float(((zeroed.float() - want.float()).abs()
                      / scale_t.float()).nan_to_num().max())
        checks[f"plain_ring_{cell}"] = {
            "rel_err": rel, "abs_err": float((got.float() - want.float())
                                             .abs().nan_to_num().max()),
            "limit": limit, "zeroed_block_control": ctrl,
            "kernel": hopper.RING_KERNELS[kern.device_key],
            "pipelined": kern.pipelined, "invariant": list(kern.invariant),
            "exact": kern.pipelined}
        if cell == "gemm":
            checks["plain_ring_gemm"]["route"] = hopper.gemm_ring_route(
                kern.geometry, call.layouts)
        if ctrl <= limit:
            failed.append(f"plain_ring_{cell}: limit above the control")

    # -- 3f. K17 and R5 (the ChainedKernel), R6 (K5's chains), to the bit ---
    # K17 against its plain version, R5 against K17 at every depth, R6
    # against K5 at every depth and per-stream depths, each beside its run
    # on the inputs with every moving stream's first block zeroed, which
    # must differ; R5 and R6 at the main path's depth against the plain
    # ring at full size (R6's sums within DOT_LIMIT)
    chained_cells = {"axpy_relu": (axpy_relu, (cx, cy), torch.int32),
                     "axpy_relu_bf16": (axpy_relu, (cxb, cyb), torch.int16),
                     "scale_relu": (scale_relu, (ga, cw), torch.int32)}

    def zeroed(parts):
        geo_ = hopper.chained_geometry(parts.launch)
        arrays_ = []
        for a_, t in zip(geo_.ins, parts.arrays):
            if any(any(c_) for c_ in a_.coeffs):
                t = t.clone()
                t[:a_.block[0], :a_.block[1]] = 0
            arrays_.append(t)
        return parts._replace(arrays=tuple(arrays_))

    def bits_check(key, kname, got, want, ctrl, view, **extra):
        c = {"exact": same_bits(got, want, view),
             "control_differs": not same_bits(ctrl, want, view),
             "abs_err": float((got.float() - want.float()).abs()
                              .nan_to_num().max()),
             "limit": 0.0, "kernel": kname, **extra}
        checks[key] = c
        errors[kname] = max(errors.get(kname, 0.0), c["abs_err"])
        if not c["control_differs"]:
            failed.append(f"{key}: the zeroed first block left the result "
                          "unchanged")

    chained_parts, k17_out = {}, {}
    for cell, (kern_, args_, view) in chained_cells.items():
        entry = f"chained_{cell}"
        p2 = chained_parts[cell, 2] = kern_.parts(*args_)
        k17 = k17_out[cell] = p2.run()[0]
        bits_check(f"{entry}_vs_plain", "chained_map", k17, p2.plain()[0],
                   zeroed(p2).plain()[0], view)
        checks[f"{entry}_vs_plain"]["exact"] &= same_bits(
            main[entry].reshape(k17.shape), k17, view) and p2.ring is None
        for depth in RING_DEPTHS:
            pr = chained_parts[cell, depth] = kern_.parts(
                *args_, schedule=deep[depth])
            got = pr.run()[0]
            bits_check(f"ring_chained_{cell}_{depth}", "ring_chained_map",
                       got, k17, zeroed(pr).run()[0], view, depth=depth)
            checks[f"ring_chained_{cell}_{depth}"]["exact"] &= \
                pr.ring is not None
            if depth == CHAINED_MAIN_DEPTH:
                want_p = pr.plain()[0]
                bits_check(f"{entry}_ring_vs_plain_ring", "ring_chained_map",
                           main[f"{entry}_ring"].reshape(want_p.shape),
                           want_p, zeroed(pr).plain()[0], view, depth=depth)
                checks[f"{entry}_ring_vs_plain_ring"]["exact"] &= \
                    same_bits(got, want_p, view)
                del want_p
            del got
    # the unfused composition (K5's axpy map, then K2) rounds as K17 does
    checks["chained_axpy_relu_fused_vs_unfused"] = {
        "exact": same_bits(main["chained_axpy_relu"],
                           main["chained_axpy_relu_unfused"], torch.int32),
        "abs_err": 0.0, "limit": 0.0}
    r6_calls = {
        "sum_sq_diff": lambda s_: lowering.prepare_chain_call(
            chained._chain_nests(n_v, False),
            (chained.SQ_DIFF, chained.IDENTITY), ssd_ops, mode="reduce",
            schedule=s_),
        "axpy_dot": lambda s_: lowering.prepare_chain_call(
            chained._chain_nests(n_v, True),
            (chained.axpy_block(0.5), chained.DOT), axd_ops, mode="reduce",
            schedule=s_),
        "sq_diff_map": lambda s_: lowering.prepare_call(
            pair2, chained.SQ_DIFF, ssd_ops, mode="map", schedule=s_),
        "axpy_map": lambda s_: lowering.prepare_call(
            pair2, chained.axpy_block(0.5), ssd_ops, mode="map",
            schedule=s_),
        "identity_reduce": lambda s_: lowering.prepare_call(
            compiler.elementwise_nest(n_v, ("T",), 1), chained.IDENTITY,
            {"T": t_sq}, schedule=s_),
    }

    def r6_call(cell, depth):
        return r6_calls[cell](lowering.DEFAULT_SCHEDULE if depth == 2
                              else depth_schedule(depth, lowering))

    for cell, depths in R6_DEPTHS.items():
        want = r6_call(cell, 2).run()
        for depth in depths:
            call = r6_call(cell, depth)
            got = call.run()
            bits_check(f"ring_chain_{cell}_{depth}", "ring_chain_elem", got,
                       want, call.finish(call.kernel(*first_block_zeroed(
                           call))), torch.int32,
                       depths=list(call.kernel.depths))
            checks[f"ring_chain_{cell}_{depth}"]["exact"] &= \
                call.kernel.pipelined
            del got
        del want
    for cell in ("sum_sq_diff", "axpy_dot"):
        call = r6_call(cell, CHAINED_MAIN_DEPTH)
        want = float(call.finish(call.kernel.plain(call.layouts)))
        ctrl = float(call.finish(call.kernel.plain(first_block_zeroed(call))))
        got = float(main[f"{cell}_ring"])
        checks[f"{cell}_ring_vs_plain_ring"] = {
            "abs_err": abs(got - want), "rel_err": abs(got - want) / want,
            "limit": DOT_LIMIT, "zeroed_block_control": abs(ctrl - want) / want,
            "exact": call.kernel.pipelined and float(call.run()) == got}
        if abs(ctrl - want) / want <= DOT_LIMIT:
            failed.append(f"{cell}_ring_vs_plain_ring: limit above the "
                          "control")

    # -- 3g. R7–R9 (K6–K8's DAGs through the ring), to the bit ------------
    # every instantiation of each DAG cell, on the values the kernels before
    # it produced, against its K kernel at RING_DEPTHS and DAG_RING_PAIRS,
    # each beside its run with the first block zeroed, which must differ;
    # each fused cell at DAG_MAIN_DEPTH, and the main path's own ring
    # output, against the plain ring at full size within the DAG limits
    def dag_call(inst, depth):
        nests_, bodies_, env_, mode_, uni_, _ = inst
        sched_ = depth_schedule(depth, lowering)
        if len(nests_) == 1:
            return lowering.prepare_call(nests_[0], bodies_[0], env_,
                                         mode=mode_, schedule=sched_,
                                         uniforms=uni_)
        return lowering.prepare_dag_call(nests_, bodies_, env_, mode=mode_,
                                         schedule=sched_, uniforms=uni_)

    dag_ring_calls = {}
    for cell, insts in dag_insts.items():
        rname = f"ring_{dag_kernel[cell]}"
        for stages, inst in insts.items():
            for depth in (*RING_DEPTHS, *DAG_RING_PAIRS.get((cell, stages),
                                                            ())):
                call = dag_call(inst, depth)
                key = f"ring_dag_{cell}_{''.join(map(str, stages))}_{depth}"
                bits_check(key, rname, call.run(), inst[5], call.finish(
                    call.kernel(*first_block_zeroed(call))), torch.int32,
                    depths=list(call.kernel.depths))
                checks[key]["exact"] &= call.kernel.pipelined
                if stages == (0, 1, 2):
                    dag_ring_calls[cell, depth] = call

    def dag_err(cell, call):
        """(err(got, want), limit) of a fused DAG cell: layernorm's
        MAP_LIMIT measure, the loss relative to itself, the MLP's relative
        to |a|·|b| (the plain ring on the absolute values)."""
        if cell == "layernorm":
            return (lambda g_, w_: map_err(g_.reshape(w_.shape), w_)), \
                MAP_LIMIT
        if cell == "softmax_xent":
            return (lambda g_, w_: abs(float(g_) - float(w_))
                    / abs(float(w_))), DOT_LIMIT
        scale_t = call.finish(call.kernel.plain(tuple(
            t.abs() for t in call.layouts))) + 1e-30
        return (lambda g_, w_: rel_to_abs_prod(g_.reshape(w_.shape), w_,
                                               scale_t)), CONTRACT_LIMIT

    for cell, kname in dag_kernel.items():
        call = dag_ring_calls[cell, DAG_MAIN_DEPTH]
        err, limit = dag_err(cell, call)
        want_p = plain(call)
        control = err(call.finish(call.kernel(*first_block_zeroed(call))),
                      want_p)
        for key, got in ((f"plain_ring_full_dag_{cell}_{DAG_MAIN_DEPTH}",
                          call.run()),
                         (f"{cell}_ring_vs_plain_ring", main[f"{cell}_ring"])):
            checks[key] = {
                "rel_err": err(got, want_p), "abs_err": float(
                    (got.reshape(want_p.shape) - want_p).abs().max()),
                "limit": limit, "zeroed_block_control": control,
                "kernel": f"ring_{kname}", "exact": call.kernel.pipelined}
        if control <= limit:
            failed.append(f"plain_ring_full_dag_{cell}: limit above the "
                          "zeroed-block control")
        del want_p

    # -- 3h. R10–R12 (K9–K11 through the ring), to the bit ------------------
    # each halo and attention cell against its K kernel at HALO_RING_CELLS'
    # depths, each beside its run with every moving stream's first block
    # zeroed, which must differ; R12 refusing ATTENTION_REFUSED_DEPTH by
    # name; at HALO_MAIN_DEPTH the ring, and the main path's own ring
    # output, against the plain ring at full size within STENCIL_LIMIT or
    # ATTENTION_LIMIT, beside the zeroed-block control above it
    def halo_call(cell, depth):
        sched_ = lowering.DEFAULT_SCHEDULE if depth == 2 \
            else depth_schedule(depth, lowering)
        if cell in ATTENTION_CELLS:
            return attention_call(cell, sched_)
        if cell == "stencil2d":
            return lowering.prepare_call(
                compiler.stencil2d_nest(hw, hw, stencil.TAPS),
                stencil.STENCIL2D, {"x": x2, "wx": wx2, "wy": wy2},
                schedule=sched_)
        body_ = chained.STENCIL1D_RELU if cell == "stencil1d_relu" \
            else stencil.STENCIL1D
        return lowering.prepare_call(
            compiler.stencil_nest(n_vec, stencil.TAPS), body_,
            {"x": xs, "w": ws}, schedule=sched_)

    def moving_blocks_zeroed(call):
        """The call's layouts with every moving stream's first and last
        blocks zeroed (a head batch: every head's; the last too, since a
        sliding window can hide the first from every query); invariant
        streams kept."""
        out = []
        for t, agu_ in zip(call.layouts, call.kernel.geometry.ins):
            if any(any(c_) for c_ in agu_.coeffs):
                t = t.clone()
                rows, cols = agu_.block
                t[..., :rows, :cols] = 0
                t[..., -rows:, -cols:] = 0
            out.append(t)
        return tuple(out)

    halo_ring_calls = {}
    for cell, depths in HALO_RING_CELLS.items():
        sync_call = halo_call(cell, 2)
        want = sync_call.run()
        kname = sync_call.kernel.device_kernel().__name__.replace("_relu", "")
        for depth in depths:
            call = halo_ring_calls[cell, depth] = halo_call(cell, depth)
            rname = hopper.RING_KERNELS[call.kernel.device_key]
            got = call.run()
            ctrl = call.finish(call.kernel(*moving_blocks_zeroed(call)))
            c = {"exact": same_bits(got, want, torch.int32)
                 and call.kernel.pipelined,
                 "control_differs": not same_bits(ctrl, want, torch.int32),
                 "abs_err": float((got - want).abs().max()), "limit": 0.0,
                 "kernel": rname, "against": kname,
                 "depths": list(call.kernel.depths)}
            checks[f"ring_{cell}_{depth}"] = c
            errors[rname] = max(errors.get(rname, 0.0), c["abs_err"])
            if not c["control_differs"]:
                failed.append(f"ring_{cell}_{depth}: the zeroed first blocks "
                              "left the result unchanged")
            del got, ctrl
        if cell in ATTENTION_CELLS:   # R12's budget: refused by name
            call = halo_call(cell, ATTENTION_REFUSED_DEPTH)
            kern = call.kernel
            takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                        qkv[cell][0].dtype, dev,
                                        **kern.device_args())
            before = dict(hopper.LAUNCHES)
            try:
                call.run()
                raised = ""
            except ValueError as e:
                raised = str(e)
            named = raised.startswith("ring_rescale_attention: its ring")
            checks[f"ring_{cell}_{ATTENTION_REFUSED_DEPTH}_refused"] = {
                "exact": named and not takes and raised == why
                and hopper.LAUNCHES == before,
                "message": raised, "abs_err": 0.0, "limit": 0.0}
        del want
    for cell, entry in (("stencil1d", "stencil1d_ring"),
                        ("stencil1d_relu", "stencil1d_relu_ring"),
                        ("stencil2d", "stencil2d_ring"),
                        ("attention_qwen3", "attention_qwen3_ring"),
                        ("attention_d256", "attention_d256_ring")):
        call = halo_ring_calls[cell, HALO_MAIN_DEPTH]
        rname = hopper.RING_KERNELS[call.kernel.device_key]
        want_p = plain(call)
        if cell in ATTENTION_CELLS:
            vmax = float(qkv[cell][2].abs().max())
            limit = ATTENTION_LIMIT

            def err(got_, vm=vmax):
                return float((got_ - want_p).abs().max()) / vm
        else:
            scale_t = halo_plain["stencil2d" if cell == "stencil2d"
                                 else "stencil1d"][1]
            limit = STENCIL_LIMIT

            def err(got_, sc=scale_t):
                return rel_max(got_, want_p, sc)
        control = err(call.finish(call.kernel(*moving_blocks_zeroed(call))))
        for key, got in ((f"plain_ring_full_{cell}_{HALO_MAIN_DEPTH}",
                          call.run()),
                         (f"{entry}_vs_plain_ring", main[entry])):
            checks[key] = {"rel_err": err(got), "abs_err": float(
                (got - want_p).abs().max()), "limit": limit,
                "zeroed_block_control": control, "kernel": rname,
                "exact": call.kernel.pipelined}
            errors[rname] = max(errors.get(rname, 0.0),
                                checks[key]["abs_err"])
        if control <= limit:
            failed.append(f"plain_ring_full_{cell}: limit above the "
                          "zeroed-block control")
        del want_p

    # -- 3i. R13–R15 (K12–K14 through the ring), to the bit -----------------
    # spmv_hpcg and spmm_hpcg against K12/K13 at GATHER_RING_CELLS' depths
    # (a depth over the budget refused by name), scan_2p26 against K14, each
    # beside its run on every moving stream's first and last blocks zeroed
    # (the scan: its first block), which must differ; R13/R14 at depth 4 on
    # the odd CSR inputs of 3c, launched on their geometry (one-step grids,
    # which the entry points never stage); at GATHER_MAIN_DEPTH the ring,
    # and the main path's own ring output, against the plain ring at full
    # size under the runs the ring kernel launches, within SPARSE_LIMIT or
    # SCAN_LIMIT, beside the zeroed-block control above it
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def gather_call(cell, depth):
        sched_ = lowering.DEFAULT_SCHEDULE if depth == 2 \
            else depth_schedule(depth, lowering)
        if cell == "spmv_hpcg":
            return lowering.prepare_call(compiler.spmv_nest(hm, hk),
                                         sparse.SPMV, sparse_ops["spmv"],
                                         schedule=sched_)
        return lowering.prepare_call(
            compiler.spmm_nest(sm, SPMM_RHS, sk, SPMM_RHS), sparse.SPMM,
            sparse_ops["spmm"], schedule=sched_)

    def forced_ring(call, depth, layouts):
        """R13/R14 on the call's geometry at ``depth``, whatever its grid,
        on the padded ``layouts`` it reads: (its output, None), or (None,
        the message) where it is refused."""
        kern = call.kernel
        ring = hopper.RingProgram((depth,) * (len(kern.depths) - 1) + (2,),
                                  kern.invariant)
        try:
            return call.finish(kern.device_kernel()(
                kern.geometry, layouts, kern.out_dtype, kern.acc_dtype,
                program=kern.program, ring=ring)), None
        except ValueError as e:
            return None, str(e)

    scan_ring_out = {}
    gather_ring_calls = {}
    for cell, depths in GATHER_RING_CELLS.items():
        if cell == "scan_2p26":
            want = main["prefix_sum"]
            kname, rname = "stream_scan", "ring_stream_scan"
            k_planes = True
        else:
            k_call = gather_call(cell, 2)
            want = k_call.run()
            # K12 and K13 on pack_ell's planes, their rings on the padded
            # layouts
            k_planes = k_call.planes
            del k_call
            kname = "gather_spmv" if cell == "spmv_hpcg" else "gather_spmm"
            rname = "ring_" + kname
        for depth in depths:
            key = f"ring_{cell}_{depth}"
            if cell == "scan_2p26":
                sched_ = depth_schedule(depth, lowering)
                got = scan.ssr_scan(xsc, schedule=sched_)
                zx = xsc.clone()
                zx[:1024] = 0
                ctrl = scan.ssr_scan(zx, schedule=sched_)
                scan_ring_out[depth] = got
                piped = True
                del zx
            else:
                call = gather_ring_calls[cell, depth] = gather_call(cell,
                                                                    depth)
                kern = call.kernel
                takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                            torch.float32, dev,
                                            **kern.device_args())
                if not takes:       # refused by name, launching nothing
                    before = dict(hopper.LAUNCHES)
                    try:
                        call.run()
                        raised = ""
                    except ValueError as e:
                        raised = str(e)
                    checks[f"{key}_refused"] = {
                        "exact": raised == why and hopper.LAUNCHES == before
                        and raised.startswith(f"{rname}: its ring"),
                        "message": raised, "abs_err": 0.0, "limit": 0.0}
                    continue
                got = call.run()
                ctrl = call.finish(call.kernel(*moving_blocks_zeroed(call)))
                piped = kern.pipelined
            c = {"exact": same_bits(got, want, torch.int32) and piped
                 and k_planes,
                 "control_differs": not same_bits(ctrl, want, torch.int32),
                 "abs_err": float((got - want).abs().max()), "limit": 0.0,
                 "kernel": rname, "against": kname, "k_planes": k_planes,
                 "depths": list(depth) if isinstance(depth, tuple)
                 else [depth]}
            checks[key] = c
            errors[rname] = max(errors.get(rname, 0.0), c["abs_err"])
            if not c["control_differs"]:
                failed.append(f"{key}: the zeroed first blocks left the "
                              "result unchanged")
            del got, ctrl
        del want
    # R14's spilled bytes held to R14_LOCAL_BYTES; R15 and K13 spill none
    local = attributes["ring_gather_spmm"]["localSizeBytes"]
    checks["ring_gather_spmm_local_bytes"] = {
        "exact": local <= R14_LOCAL_BYTES, "local_bytes": local,
        "local_limit": R14_LOCAL_BYTES, "abs_err": 0.0, "limit": 0.0}
    for name in ("ring_stream_scan", "gather_spmm", "stream_scan",
                 "rescale_attention_256_d192", "rescale_attention_256_d256",
                 "base_scan", "reduce_mul", "map_relu",
                 *(f"contract_gemv_{b}" for b in hopper.GEMV_BUILDS)):
        local = attributes[name]["localSizeBytes"]
        checks[f"{name}_local_bytes"] = {
            "exact": local == 0, "local_bytes": local, "local_limit": 0,
            "abs_err": 0.0, "limit": 0.0}
    # every K4 build reaches the CTAs an SM its one-wave split counts on
    k4_ctas = {b: attributes[f"contract_gemv_{b}"]["ctasPerSm"]
               for b in hopper.GEMV_BUILDS}
    checks["contract_gemv_ctas_per_sm"] = {
        "exact": all(c_ >= hopper.GEMV_PER_SM for c_ in k4_ctas.values()),
        "ctas_per_sm": k4_ctas, "abs_err": 0.0, "limit": 0.0}
    # K11's shared memory: the wrapper's mirror is the entry's count, and
    # each tile fits what a CTA may opt into
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    k11_smem = {f"{lanes}_d{dim}": attributes[
        f"rescale_attention_{lanes}_d{dim}"] for lanes, dim in K11_TILES}
    checks["rescale_attention_smem_mirror"] = {
        "exact": all(a_["smemBytes"] == a_["smemMirror"] <= optin
                     for a_ in k11_smem.values()),
        "smem": {k: a_["smemBytes"] for k, a_ in k11_smem.items()},
        "optin": optin, "abs_err": 0.0, "limit": 0.0}

    # R15 against K14 to the bit, both launched on the scan's Launch at
    # each depth, whatever its grid (n = 1024 is one block, which the entry
    # never stages): f32, bf16 and int32 (to ±2**30: int32's rounding) at n
    # = 1024, 4096, 2**26 ± 1024 and depths 3, 4, 8, each n beside R15 on
    # the input with its first block zeroed, which must differ; a vector of
    # ±0 (every output +0, as K14's) and one holding a NaN; R15 on
    # scan_2p26 five times, the same bits
    def r15_and_k14(x_, depth):
        arrays_, static_, _ = scan._prepare(x_)
        lc_ = scan._launch(static_, *arrays_)
        ring_ = hopper.RingProgram((depth,), (False,))
        return (hopper.ring_stream_scan(lc_, arrays_[0], ring_)[0],
                hopper.stream_scan(lc_, arrays_[0])[0])

    def bits_diff(a_, b_) -> float:
        d_ = (a_ - b_).abs()
        return float(torch.nan_to_num(d_, nan=0.0).max())

    # K14 against the bits of the three-launch design it replaced, as
    # hopper.scan_model computes them (numpy float32: per tile 16 elements
    # a thread in order, the CTA scan, the fixed second pass over the
    # totals), on the padded vector
    def k14_model(x_, k14_):
        padded = scan._prepare(x_)[0][0].reshape(-1).cpu()
        model = hopper.scan_model(padded.numpy().astype(np.float32)
                                  if x_.dtype == torch.int32
                                  else padded.float().numpy())
        got_ = k14_.reshape(-1).cpu()
        return {"exact": bool(torch.equal(got_.view(torch.int32),
                                          torch.from_numpy(model)
                                          .view(torch.int32))),
                "abs_err": float(torch.nan_to_num(
                    (got_ - torch.from_numpy(model)).abs(), nan=0.0).max()),
                "limit": 0.0, "kernel": "stream_scan",
                "against": "hopper.scan_model"}

    # B8 against the bits of the three-launch B8 it replaced, as
    # hopper.base_scan_model computes them (numpy float32: per block 4
    # elements a thread in order, the CTA scan, each tile's blocks' totals
    # in order, the fixed second pass over the tiles' totals)
    def b8_model(x_):
        padded_t = scan._prepare(x_)[0][0]
        got_ = hopper.base_scan(padded_t).reshape(-1).cpu()
        flat = padded_t.reshape(-1).cpu()
        model = torch.from_numpy(hopper.base_scan_model(
            flat.numpy().astype(np.float32) if x_.dtype == torch.int32
            else flat.float().numpy()))
        return {"exact": bool(torch.equal(got_.view(torch.int32),
                                          model.view(torch.int32))),
                "abs_err": float(torch.nan_to_num(
                    (got_ - model).abs(), nan=0.0).max()),
                "limit": 0.0, "kernel": "base_scan",
                "against": "hopper.base_scan_model"}

    for dt in (torch.float32, torch.bfloat16, torch.int32):
        tag = str(dt).removeprefix("torch.")
        for n_ in (1024, 4096, SCAN_N - 1024, SCAN_N + 1024):
            if dt == torch.int32:
                x_ = torch.randint(-(1 << 30), 1 << 30, (n_,), generator=gen,
                                   device=dev, dtype=torch.int32)
            else:
                x_ = randn(n_).to(dt)
            for depth in (3, 4, 8):
                got, want = r15_and_k14(x_, depth)
                checks[f"r15_{tag}_{n_}_{depth}"] = {
                    "exact": same_bits(got, want, torch.int32),
                    "abs_err": bits_diff(got, want), "limit": 0.0,
                    "kernel": "ring_stream_scan", "against": "stream_scan"}
            checks[f"k14_model_{tag}_{n_}"] = k14_model(x_, want)
            checks[f"b8_model_{tag}_{n_}"] = b8_model(x_)
            x_[:1024] = 0
            ctrl = r15_and_k14(x_, GATHER_MAIN_DEPTH)[0]
            if same_bits(ctrl, want, torch.int32):
                failed.append(f"r15_{tag}_{n_}: the zeroed first block left "
                              "the result unchanged")
            del x_, got, want, ctrl
    xz = torch.zeros(1 << 20, device=dev)
    xz[torch.rand(1 << 20, generator=gen, device=dev) < 0.5] = -0.0
    xnan = randn(1 << 20)
    xnan[300_000] = float("nan")
    for key, x_ in (("r15_signed_zeros", xz), ("r15_nan", xnan),
                    ("r15_signed_zeros_bf16", xz.bfloat16())):
        for depth in (3, 4, 8):
            got, want = r15_and_k14(x_, depth)
            c = {"exact": same_bits(got, want, torch.int32),
                 "abs_err": bits_diff(got, want), "limit": 0.0,
                 "kernel": "ring_stream_scan", "against": "stream_scan"}
            flat = got.reshape(-1)       # the padded (rows, 128) layout
            if key.startswith("r15_signed_zeros"):
                c["exact"] &= not bool(torch.signbit(flat).any())
            else:
                c["exact"] &= bool(torch.isnan(flat[300_000:]).all()) and \
                    not bool(torch.isnan(flat[:300_000]).any())
            checks[f"{key}_{depth}"] = c
    del xz, xnan
    runs = [scan.ssr_scan(xsc, schedule=deep[GATHER_MAIN_DEPTH])
            for _ in range(5)]
    checks["r15_scan_2p26_five_runs"] = {
        "exact": all(same_bits(r_, main["prefix_sum_ring"], torch.int32)
                     for r_ in runs), "abs_err": max(
            bits_diff(r_, main["prefix_sum_ring"]) for r_ in runs),
        "limit": 0.0, "kernel": "ring_stream_scan"}
    runs = [registry.get("scan").baseline(xsc) for _ in range(5)]
    checks["b8_scan_2p26_five_runs"] = {
        "exact": all(same_bits(r_, main["prefix_sum_baseline"], torch.int32)
                     for r_ in runs), "abs_err": max(
            bits_diff(r_, main["prefix_sum_baseline"]) for r_ in runs),
        "limit": 0.0, "kernel": "base_scan"}
    del runs
    # R13/R14 at depth 4 on the odd CSR inputs, against K12/K13 to the bit
    # (R13 on the padded layouts, K12 on pack_ell's planes); K12 against
    # its plain version within SPARSE_LIMIT, beside its run on the values
    # doubled, which must read above it where the product is not all zero
    for name, (d_, i_, p_, n_) in odd_csr.items():
        ell = sparse.pack_ell(*(torch.as_tensor(np.asarray(a_), device=dev)
                                for a_ in (d_, i_, p_)), n_)
        for prod, c_ in (("spmv", None), ("spmm", 200)):
            operand = randn(n_) if c_ is None else randn(n_, c_)
            if prod == "spmv":
                ops_ = {"vals": ell[0], "cidx": ell[1], "x": operand}
                call = lowering.prepare_call(
                    compiler.spmv_nest(ell[2], ell[3]), sparse.SPMV, ops_)
            else:
                pitch_ = -(-c_ // 128) * 128
                ops_ = {"vals": ell[0], "cidx": ell[1],
                        "X": F.pad(operand, (0, pitch_ - c_))}
                call = lowering.prepare_call(
                    compiler.spmm_nest(ell[2], c_, ell[3], pitch_),
                    sparse.SPMM, ops_)
            want = call.run()
            # K12 and K13 on pack_ell's planes against their plain
            # versions, beside their runs on the values doubled
            kern = call.kernel
            kname = f"gather_{prod}"
            scale_t = call.finish(kern.plain(tuple(
                t.abs() for t in call.layouts))) + 1e-30
            plain_ = call.finish(kern.plain(call.layouts))
            doubled = call.finish(kern(2 * call.layouts[0],
                                       *call.layouts[1:]))
            ctrl = rel_max(doubled, plain_, scale_t)
            key = f"odd_{'k12' if prod == 'spmv' else 'k13'}_planes_{name}"
            checks[key] = {
                "abs_err": float((want - plain_).abs().max()),
                "rel_err": rel_max(want, plain_, scale_t),
                "limit": SPARSE_LIMIT, "doubled_control": ctrl,
                "pitch": int(call.layouts[0].shape[1]),
                "exact": int(call.layouts[0].shape[1]) == ell[3],
                "kernel": kname}
            errors[kname] = max(errors.get(kname, 0.0),
                                checks[key]["abs_err"])
            if bool(plain_.any()) and ctrl <= SPARSE_LIMIT:
                failed.append(f"{key}: limit above the doubled control")
            before = dict(hopper.LAUNCHES)
            got, raised = forced_ring(call, GATHER_MAIN_DEPTH,
                                      call.padded_layouts())
            torch.cuda.synchronize()
            launched = {k_ for k_, v in hopper.LAUNCHES.items()
                        if v != before[k_]}
            rname = f"ring_gather_{prod}"
            key = f"ring_odd_{prod}_{name}_{GATHER_MAIN_DEPTH}"
            if got is None:     # a slot of the block's width over budget
                checks[f"{key}_refused"] = {
                    "exact": raised.startswith(f"{rname}: its ring")
                    and not launched, "message": raised, "abs_err": 0.0,
                    "limit": 0.0}
                continue
            checks[key] = {
                "exact": same_bits(got, want, torch.int32)
                and launched == {rname},
                "abs_err": float((got - want).abs().max()), "limit": 0.0,
                "kernel": rname}
    # the plain ring at full size against the ring and the main path's ring
    # outputs, under the runs the ring kernel launches
    for cell, op, entries in (("spmv_hpcg", "spmv",
                               ("spmv_ring", "sparse_gemv_ring")),
                              ("spmm_hpcg", "spmm", ("spmm_ring",))):
        call = gather_ring_calls[cell, GATHER_MAIN_DEPTH]
        kern = call.kernel
        rname = hopper.RING_KERNELS[kern.device_key]
        run_ = hopper.ring_run_steps(rname, kern.geometry, kern.ring,
                                     torch.float32, sms)
        want_p = call.finish(hopper.plain_ring(
            kern.body, kern.geometry, call.layouts, kern.out_dtype,
            kern.acc_dtype, mode="nest", ring=kern.ring,
            steps_per_cta=run_)[0])
        scale_t = sparse_scale[op]
        control = rel_max(call.finish(call.kernel(
            *moving_blocks_zeroed(call))), want_p, scale_t)
        for key, got in ((f"plain_ring_full_{cell}_{GATHER_MAIN_DEPTH}",
                          call.run()),
                         *((f"{e}_vs_plain_ring", main[e]) for e in entries)):
            checks[key] = {"rel_err": rel_max(got, want_p, scale_t),
                           "abs_err": float((got - want_p).abs().max()),
                           "limit": SPARSE_LIMIT, "steps_per_cta": run_,
                           "zeroed_block_control": control, "kernel": rname,
                           "exact": kern.pipelined}
        if control <= SPARSE_LIMIT:
            failed.append(f"plain_ring_full_{cell}: limit above the "
                          "zeroed-block control")
        del want_p
    exact64 = torch.cumsum(xsc.double(), 0)
    pscale = torch.cumsum(xsc.double().abs(), 0)
    sc_entry = scan._ssr._build(None, sc_arrays,
                                deep[GATHER_MAIN_DEPTH])
    sc_run = hopper.ring_run_steps("ring_stream_scan",
                                   hopper.launch_geometry(sc_lc),
                                   sc_entry.ring, xsc.dtype, sms)
    sc_plain_ring = hopper.plain_stream(
        scan.SCAN, sc_lc, sc_arrays, ring=sc_entry.ring,
        steps_per_cta=sc_run)[0].reshape(-1)[:SCAN_N]
    zx = xsc.clone()
    zx[:1024] = 0
    scan_zero_ctrl = scan_rel(scan.ssr_scan(zx, schedule=deep[
        GATHER_MAIN_DEPTH]))
    del zx
    for key, got in ((f"plain_ring_full_scan_2p26_{GATHER_MAIN_DEPTH}",
                      scan_ring_out[GATHER_MAIN_DEPTH]),
                     ("prefix_sum_ring_vs_plain_ring",
                      main["prefix_sum_ring"])):
        checks[key] = {"rel_err": scan_rel(got),
                       "plain_rel_err": scan_rel(sc_plain_ring),
                       "abs_err": float((got - sc_plain_ring).abs().max()),
                       "limit": SCAN_LIMIT, "steps_per_cta": sc_run,
                       "zeroed_block_control": scan_zero_ctrl,
                       "kernel": "ring_stream_scan"}
        if checks[key]["plain_rel_err"] > SCAN_LIMIT:
            failed.append(f"{key}: the plain ring above the limit")
    if scan_zero_ctrl <= SCAN_LIMIT:
        failed.append("plain_ring_full_scan_2p26: limit above the "
                      "zeroed-block control")
    del exact64, pscale, sc_plain_ring

    for key, c in checks.items():
        ok = (c.get("exact", True) and
              c.get("rel_to_abs_prod", c.get("rel_err", c["abs_err"]))
              <= c["limit"])
        c["ok"] = ok
        if not ok:
            failed.append(key)
    for key in ("dot", "dot_ssr_call", "gemm", "gemv", "dot_baseline",
                "gemm_baseline", "gemv_baseline", "stencil1d",
                "stencil1d_baseline", "stencil2d", *ATTENTION_CELLS,
                "spmv", "sparse_gemv", "spmv_baseline", "spmm",
                "spmm_baseline", "prefix_sum", "prefix_sum_baseline",
                "sort", "spmv_ring", "sparse_gemv_ring", "spmm_ring",
                "prefix_sum_ring", "dot_ring", "dot_ssr_call_ring",
                "gemm_ring", "gemv_ring", "gemv_relu_ring", *CHAINED_LAUNCHES,
                "chained_axpy_relu_ring", "chained_axpy_relu_bf16_ring",
                "chained_scale_relu_ring", "sum_sq_diff_ring",
                "axpy_dot_ring", "layernorm_ring", "softmax_xent_ring",
                "mlp_block_ring", "stencil1d_ring", "stencil1d_relu_ring",
                "stencil2d_ring", "attention_qwen3_ring",
                "attention_d256_ring"):
        if not bool(torch.isfinite(main[key]).all()):
            failed.append(f"{key}: non-finite")
    # the repo's own oracle on small odd inputs, within the registry tol
    rng = np.random.default_rng(seed)
    for entry in registry.entries():
        ex_args, ex_kw = entry.example(rng, odd=True)
        want = entry.ref(*[t.to(dev) for t in ex_args], **ex_kw)
        for variant in ("ssr", "baseline"):
            if getattr(entry, variant) is None:     # stencil2d, attention
                continue
            got = getattr(entry, variant)(*ex_args, device=dev, **ex_kw)
            ok = all(bool(torch.allclose(g, w, **entry.tol)) for g, w in (
                zip(got, want) if isinstance(got, tuple) else ((got, want),)))
            checks[f"registry_{entry.name}_{variant}"] = {"ok": ok}
            if not ok:
                failed.append(f"registry_{entry.name}_{variant}")
    torch.cuda.synchronize()
    emit({"phase": "check", "checks": checks})
    if failed:
        raise SystemExit(f"chip_smoke: checks failed: {failed}")

    # -- 4. timing ----------------------------------------------------------
    def kernel_fn(call):
        kern = call.kernel
        dk, kw = kern.device_kernel(), kern.device_args()
        return lambda: dk(kern.geometry, call.layouts, kern.out_dtype,
                          kern.acc_dtype, **kw)

    def entry_fn(call):
        """The kernel's C entry with the arguments its wrapper passes for
        ``call`` (and the output it allocated, kept alive): its device time
        without the wrapper's host work."""
        kern, got = call.kernel, {}
        real = hopper._launch
        hopper._launch = lambda name, dev_, *a: got.update(name=name, args=a)
        try:
            out = kern.device_kernel()(kern.geometry, call.layouts,
                                       kern.out_dtype, kern.acc_dtype,
                                       **kern.device_args())
        finally:
            hopper._launch = real
        fn = getattr(hopper._lib(got["name"]), f"ssr_{got['name']}")
        stream = torch.cuda.current_stream().cuda_stream

        def run(args=got["args"], keep=out):
            if fn(*args, stream) != 0:
                raise SystemExit(f"chip_smoke: {got['name']} failed")
        return run

    taps, wide = stencil.TAPS, hw + stencil.TAPS - 1

    def attention_work(cell):
        """(bytes of q, k, v read once and out written once, the FP32
        operations of the unmasked pairs: 2·D FMAs each)."""
        heads, seq, d, causal, window = ATTENTION_CELLS[cell]
        pairs = unmasked_pairs(seq, seq, causal, window)
        return 4 * heads * seq * d * 4, 4 * d * pairs * heads

    # the 2-D stencil as one 11 x 11 convolution: the cross of the two arms
    cross = torch.zeros(taps, taps, device=dev)
    cross[taps // 2, :] += wx2
    cross[:, taps // 2] += wy2

    def sdpa(cell):
        """One PyTorch call computing the attention of the cell: causal,
        and for a window a boolean mask of the visible pairs."""
        heads, seq, d, causal, window = ATTENTION_CELLS[cell]
        if window is None:
            return lambda: F.scaled_dot_product_attention(*qkv[cell],
                                                          is_causal=causal)
        i = torch.arange(seq, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        return lambda: F.scaled_dot_product_attention(*qkv[cell],
                                                      attn_mask=mask)

    work = {   # (bytes each input read once + output written once, FLOPs)
        "reduce_mul": (2 * n_vec * 4 + 4, 2 * n_vec),
        "map_relu": (2 * n_vec * 4, n_vec),
        "contract_gemm": ((m * k + k * n + m * n) * 4, 2 * m * n * k),
        "contract_gemv": ((gm * gn + gn + gm) * 4, 2 * gm * gn),
        "halo_stencil1d": ((2 * n_vec + 2 * taps - 1) * 4, 2 * taps * n_vec),
        "halo_stencil2d": ((wide * wide + hw * hw + 2 * taps) * 4,
                           4 * taps * hw * hw),
        "rescale_attention": attention_work("attention_qwen3"),
        # the ELL planes at their logical width k, each vector or matrix
        # once; two operations per stored entry (and right-hand side)
        "gather_spmv": (hm * hk * 8 + (n_v1 + hm) * 4,
                        2 * int(hcsr[0].numel())),
        "gather_spmm": (sm * sk * 8 + (n_m2 + sm) * SPMM_RHS * 4,
                        2 * int(scsr[0].numel()) * SPMM_RHS),
    }
    # cuSPARSE through PyTorch: the library call beside K12/K13
    csr_lib = {name: torch.sparse_csr_tensor(
        csr[2].to(torch.int32), csr[1], csr[0], size=(n_, n_))
        for name, csr, n_ in (("spmv", hcsr, n_v1), ("spmm", scsr, n_m2))}
    library = {
        "reduce_mul": lambda: torch.dot(x, y),
        "map_relu": lambda: torch.relu(xr),
        "contract_gemm": lambda: torch.matmul(a, b),
        "contract_gemv": lambda: torch.mv(ga, gx),
        "halo_stencil1d": lambda: F.conv1d(xs.view(1, 1, -1),
                                           ws.view(1, 1, -1)),
        "halo_stencil2d": lambda: F.conv2d(x2.view(1, 1, wide, wide),
                                           cross.view(1, 1, taps, taps)),
        "rescale_attention": sdpa("attention_qwen3"),
        "gather_spmv": lambda: csr_lib["spmv"] @ hx,
        "gather_spmm": lambda: csr_lib["spmm"] @ sX,
    }
    timed = {name: (kernel_fn(call), lambda c=call: plain(c))
             for name, call in calls.items()}
    # the stream kernels: each wrapper on the Launch and arrays its entry
    # point prepares, beside the plain walk; B8 on K14's padded layout
    ff_lc, ff_arrays, _ = stream_parts(fft, fre, fim)
    so_lc, so_arrays, _ = stream_parts(bitonic, xso)
    for kname, body_, lc_, arrays_ in (
            ("stream_scan", scan.SCAN, sc_lc, sc_arrays),
            ("stream_fft", fft.FFT, ff_lc, ff_arrays),
            ("stream_bitonic", bitonic.BITONIC, so_lc, so_arrays)):
        timed[kname] = (
            lambda w=getattr(hopper, kname), l_=lc_, a_=arrays_: w(l_, *a_),
            lambda b_=body_, l_=lc_, a_=arrays_: hopper.plain_stream(b_, l_,
                                                                     a_))
    base_layouts["base_scan"] = (sc_arrays[0],)
    base_plain["base_scan"] = hopper.plain_base_scan
    sort_stages = SORT_N.bit_length() * (SORT_N.bit_length() - 1) // 2
    work.update({
        # x read once, y written once; one add an element
        "stream_scan": (2 * SCAN_N * 4, SCAN_N),
        # re and im in, both out, the twiddle tables once; 5 n log2 n FP32
        # operations a transform
        "stream_fft": (4 * FFT_BATCH * FFT_N * 4 + 2 * ff_arrays[2].numel()
                       * 4, 5 * FFT_N * (FFT_N.bit_length() - 1) * FFT_BATCH),
        # the row in and out; n/2 compare-exchanges at each of the 351
        # stages, a min and a max each (two FP32 operations)
        "stream_bitonic": (2 * SORT_N * 4, 2 * (SORT_N // 2) * sort_stages),
    })
    zc = torch.complex(fre, fim)       # prebuilt: the FFT call timed alone
    library.update({"stream_scan": lambda: torch.cumsum(xsc, 0),
                    "stream_fft": lambda: torch.fft.fft(zc),
                    "stream_bitonic": lambda: torch.sort(xso)})
    for kname, bname in PAIRS.items():   # a baseline does the K row's work
        work[bname], library[bname] = work[kname], library[kname]
        wrapper, layouts = getattr(hopper, bname), base_layouts[bname]
        timed[bname] = (lambda w=wrapper, t=layouts: w(*t),
                        lambda p=base_plain[bname], t=layouts: p(*t))
    rows = []
    for name, (kernel, plain_fn) in timed.items():
        nbytes, flops = work[name]
        t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32 * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": hopper.KERNELS[name]["source"],
            "replaces": hopper.KERNELS[name]["replaces"],
            "launches": launches[name],
            "max_abs_err": errors[name],
            "ms": time_ms(kernel),
            "plain_ms": time_ms(plain_fn),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(library[name]),
        })
        if name in ENTRY_ROWS:   # on the line, its C entry, its host
            rows[-1].update(c_entry_ms=time_ms(entry_fn(calls[name])),
                            host_ms=host_ms(kernel))
        emit({"phase": "time", **rows[-1], **(
            {"device_launches": device_launches[STREAM_CELL[name]]}
            if name in STREAM_CELL else {})})
    # the other attention cells: K11 over their heads, as the row above,
    # each also in the kernels line under K11's row (``cells``)
    k11_row = next(r_ for r_ in rows if r_["name"] == "rescale_attention")
    k11_row["cell"], k11_row["cells"] = "attention_qwen3", {}
    for cell in ATTENTION_CELLS:
        if cell == "attention_qwen3":
            continue
        call = att_calls[cell]
        nbytes, flops = attention_work(cell)
        t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32 * 1e3
        line = {"ms": time_ms(kernel_fn(call)),
                "plain_ms": time_ms(lambda c=call: plain(c)),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": time_ms(sdpa(cell))}
        k11_row["cells"][cell] = line
        emit({"phase": "time", "cell": cell, "name": "rescale_attention",
              **line})
    # the fused cells: the fused instantiation against the unfused stages'
    # kernels run one after another, each timed alone; bytes each input
    # read once and each output written once (unfused: every intermediate
    # written and read back), FP32 operations for the MLP's products
    nf = FUSED_ROWS * 128
    mlp_ops = 4 * FUSED_ROWS * 128 * 128 + 3 * nf
    weights = 2 * (128 * 128 + 128) * 4
    cell_work = {   # cell: (fused bytes, unfused bytes, operations)
        "gemv_relu": ((gm * gn + gn + gm) * 4, (gm * gn + gn + 3 * gm) * 4,
                      2 * gm * gn),
        "sum_sq_diff": (2 * n_vec * 4 + 4, 4 * n_vec * 4 + 4, 3 * n_vec),
        "axpy_dot": (3 * n_vec * 4 + 4, 5 * n_vec * 4 + 4, 4 * n_vec),
        "layernorm": (2 * nf * 4, 7 * nf * 4, 6 * nf),
        "softmax_xent": (2 * nf * 4 + 4, 7 * nf * 4 + 4, 7 * nf),
        "mlp_block": (2 * nf * 4 + weights, 7 * nf * 4 + 3 * weights,
                      mlp_ops),
        "stencil1d_relu": ((2 * n_vec + 2 * taps - 1) * 4,
                           (4 * n_vec + 2 * taps - 1) * 4,
                           (2 * taps + 1) * n_vec),
    }
    # one PyTorch call computing the same function, where there is one;
    # else the composition of library calls, labelled as such
    library_one = {
        "sum_sq_diff": lambda: F.mse_loss(x, y, reduction="sum"),
        "layernorm": lambda: F.layer_norm(lx, (128,)),
        "softmax_xent": lambda: F.cross_entropy(lz, lp, reduction="sum"),
    }
    library_composed = {
        "gemv_relu": lambda: torch.relu(torch.mv(ga, gx)),
        "axpy_dot": lambda: torch.dot(torch.add(y, x, alpha=0.5), w),
        "mlp_block": lambda: (lambda h: torch.addmm(b2, h, w2) + h)(
            torch.relu(torch.addmm(b1, mx, w1))),
        "stencil1d_relu": lambda: torch.relu(F.conv1d(xs.view(1, 1, -1),
                                                      ws.view(1, 1, -1))),
    }
    cells = {}
    for cell, (fb, ub, flops) in cell_work.items():
        fused_t = time_ms(kernel_fn(fused_calls[cell]))
        stages_t = [time_ms(kernel_fn(c_)) for c_ in unfused_calls[cell]]
        unfused_t = sum(stages_t)
        t_ops = flops / fp32 * 1e3
        cells[cell] = {
            "fused_ms": fused_t, "unfused_ms": unfused_t,
            "unfused_stage_ms": stages_t,
            "fused_over_unfused": unfused_t / fused_t,
            "fused_bound_ms": max(fb / bw * 1e3, t_ops),
            "unfused_bound_ms": max(ub / bw * 1e3, t_ops),
            "bound_by": "bytes" if fb / bw * 1e3 >= t_ops else "operations",
            "entry_fused_ms": time_ms(path[cell]),
            "entry_unfused_ms": time_ms(path[f"{cell}_unfused"]),
            "library_ms": (time_ms(library_one[cell])
                           if cell in library_one else None),
            "library_composed_ms": (time_ms(library_composed[cell])
                                    if cell in library_composed else None),
        }
        emit({"phase": "fused_time", "cell": cell, **cells[cell]})
    for kname, cell in FUSED_ROW.items():
        fb, _, flops = cell_work[cell]
        t_bytes, t_ops = fb / bw * 1e3, flops / fp32 * 1e3
        call = fused_calls[cell]
        rows.append({
            "name": kname, "route": "cuda",
            "source": hopper.KERNELS[kname]["source"],
            "replaces": hopper.KERNELS[kname]["replaces"],
            "launches": launches[kname],
            "max_abs_err": errors[kname],
            "ms": cells[cell]["fused_ms"],
            "plain_ms": time_ms(lambda c_=call: c_.kernel.plain(c_.layouts)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cells[cell]["library_ms"],
        })
        emit({"phase": "time", "cell": cell, **rows[-1]})
    # the rings: each cell at depths 2 (the K-kernel), 3, 4 and 8 and the
    # per-stream pairs, beside K's bound and library call; a ring row times
    # its main-path depth
    nb = 2 * n_vec * 2
    sweep_work = {   # cell: (bytes, FLOPs, library call or None)
        "dot": (*work["reduce_mul"], library["reduce_mul"]),
        "dot_bf16": (nb + 4, 2 * n_vec, lambda: torch.dot(
            ring_cells["dot_bf16"][3]["A"], ring_cells["dot_bf16"][3]["B"])),
        "relu": (*work["map_relu"], library["map_relu"]),
        "relu_int32": (*work["map_relu"], lambda: torch.relu(xi)),
        "relu_bf16": (nb, n_vec, lambda: torch.relu(xb)),
        "gemm": (*work["contract_gemm"], library["contract_gemm"]),
        "gemv": (*work["contract_gemv"], library["contract_gemv"]),
        "gemv_relu": (*work["contract_gemv"], None),
        "gemv_bf16": ((gm * gn + gn) * 2 + gm * 4, 2 * gm * gn,
                      lambda: torch.mv(gab, gxb)),
        "gemv_relu_bf16": ((gm * gn + gn) * 2 + gm * 4, 2 * gm * gn, None),
        "gemv_x_invariant": ((2048 * 512 + 512 + 2048) * 4, 2 * 2048 * 512,
                             lambda: torch.mv(gai, gx[:512])),
    }
    sweeps = {}
    for cell, (_, _, _, _, _, _, depths) in ring_cells.items():
        nbytes, flops, lib = sweep_work[cell]
        t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32 * 1e3
        at = {2: time_ms(kernel_fn(cell_call(cell, 2)))}
        for depth in depths:
            at[depth] = time_ms(kernel_fn(ring_calls[cell, depth]))
        pairs = {d: t for d, t in at.items() if isinstance(d, tuple)}
        best = min(pairs, key=pairs.get) if pairs else None
        sweeps[cell] = {
            "ms": {str(d): t for d, t in at.items()},
            "best_pair": list(best) if best else None,
            "best_pair_ms": pairs[best] if best else None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lib) if lib is not None else None,
            "ring_over_sync": {str(d): at[2] / t for d, t in at.items()
                               if d != 2}}
        if cell.startswith("gemv"):     # K4 and R4 with no wrapper's host
            c_at = {2: time_ms(entry_fn(cell_call(cell, 2)))}
            for depth in depths:
                c_at[depth] = time_ms(entry_fn(ring_calls[cell, depth]))
            sweeps[cell]["c_entry_ms"] = {str(d): t for d, t in c_at.items()}
            sweeps[cell]["c_entry_ring_over_sync"] = {
                str(d): c_at[2] / t for d, t in c_at.items() if d != 2}
        emit({"phase": "depth_sweep", "cell": cell, **sweeps[cell]})
    for rname, (kname, cell) in RING_ROW.items():
        krow = next(r for r in rows if r["name"] == kname)
        call = ring_calls[cell, RING_MAIN_DEPTH[cell]]
        rows.append({
            "name": rname, "route": "cuda",
            "source": hopper.KERNELS[rname]["source"],
            "replaces": hopper.KERNELS[rname]["replaces"],
            "launches": launches[rname],
            "max_abs_err": errors[rname],
            "ms": sweeps[cell]["ms"][str(RING_MAIN_DEPTH[cell])],
            "plain_ms": time_ms(lambda c=call: plain(c)),
            "bound_ms": krow["bound_ms"], "bound_by": krow["bound_by"],
            "library_ms": krow["library_ms"],
            "depth": RING_MAIN_DEPTH[cell],
        })
        if "c_entry_ms" in sweeps[cell]:    # R4: through its C entry too
            rows[-1]["c_entry_ms"] = \
                sweeps[cell]["c_entry_ms"][str(RING_MAIN_DEPTH[cell])]
        emit({"phase": "time", "cell": cell, **rows[-1]})
    # the ChainedKernel cells: K17 (depth 2) and R5 at depths 3, 4 and 8,
    # beside the unfused composition's stage kernels (K5's axpy map, then
    # K2; the axpy_relu cell) and the composed library calls; bytes each
    # input read once and the output written once, two FP32 operations an
    # element for the axpy (a product and a sum), one for the scale
    rep_w = cw.view(1, SCALE_BLOCK[0], 1, SCALE_BLOCK[1])
    chained_work = {   # cell: (bytes, FLOPs, composed library call)
        "axpy_relu": (3 * n_vec * 4, 2 * n_vec,
                      lambda: torch.relu(torch.add(cy, cx,
                                                   alpha=CHAINED_ALPHA))),
        "axpy_relu_bf16": (3 * n_vec * 2, 2 * n_vec,
                           lambda: torch.relu(torch.add(
                               cyb, cxb, alpha=CHAINED_ALPHA))),
        "scale_relu": (2 * gm * gn * 4 + math.prod(SCALE_BLOCK) * 4, gm * gn,
                       lambda: torch.relu(ga.view(
                           gm // SCALE_BLOCK[0], SCALE_BLOCK[0],
                           gn // SCALE_BLOCK[1], SCALE_BLOCK[1]) * rep_w)),
    }
    ax_stage = lowering.prepare_call(pair_c, chained.axpy_block(CHAINED_ALPHA),
                                     {"X": cx, "Y": cy}, mode="map")
    relu_stage = lowering.prepare_call(
        compiler.elementwise_nest(n_vec), relu.RELU, {"X": ax_stage.run()},
        mode="map", out_dtype=torch.float32)
    chained_sweeps = {}
    for cell, (nbytes, flops, lib) in chained_work.items():
        t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32 * 1e3
        at = {d: time_ms(lambda p_=chained_parts[cell, d]: p_.run())
              for d in (2, *RING_DEPTHS)}
        line = {"ms": {str(d): t for d, t in at.items()},
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_composed_ms": time_ms(lib),
                "ring_over_sync": {str(d): at[2] / t for d, t in at.items()
                                   if d != 2}}
        if cell == "axpy_relu":
            stages_t = [time_ms(kernel_fn(c_))
                        for c_ in (ax_stage, relu_stage)]
            line.update(unfused_stage_ms=stages_t,
                        fused_over_unfused=sum(stages_t) / at[2],
                        predicted_fused_over_unfused=20 / 12)
        chained_sweeps[cell] = line
        emit({"phase": "chained_time", "cell": cell, **line})
    # R6: each chain cell at depth 2 (K5) and at R6's depths
    chain_sweeps = {}
    for cell, depths in R6_DEPTHS.items():
        at = {d: time_ms(kernel_fn(r6_call(cell, d))) for d in (2, *depths)}
        chain_sweeps[cell] = {
            "ms": {str(d): t for d, t in at.items()},
            "ring_over_sync": {str(d): at[2] / t for d, t in at.items()
                               if d != 2}}
        emit({"phase": "chain_depth_sweep", "cell": cell,
              **chain_sweeps[cell]})
    k5row = next(r_ for r_ in rows if r_["name"] == "chain_elem")
    for name, cell, plain_fn, bound, lib_ms, comp_ms in (
            ("chained_map", "axpy_relu",
             lambda: chained_parts["axpy_relu", 2].plain(),
             chained_sweeps["axpy_relu"], None,
             chained_sweeps["axpy_relu"]["library_composed_ms"]),
            ("ring_chained_map", "axpy_relu",
             lambda: chained_parts["axpy_relu", CHAINED_MAIN_DEPTH].plain(),
             chained_sweeps["axpy_relu"], None,
             chained_sweeps["axpy_relu"]["library_composed_ms"]),
            ("ring_chain_elem", "sum_sq_diff",
             lambda c_=r6_call("sum_sq_diff", CHAINED_MAIN_DEPTH):
             c_.kernel.plain(c_.layouts), k5row, k5row["library_ms"], None)):
        depth = 2 if name == "chained_map" else CHAINED_MAIN_DEPTH
        sweep = chained_sweeps.get(cell) or chain_sweeps[cell]
        rows.append({
            "name": name, "route": "cuda",
            "source": hopper.KERNELS[name]["source"],
            "replaces": hopper.KERNELS[name]["replaces"],
            "launches": launches[name],
            "max_abs_err": errors[name],
            "ms": sweep["ms"][str(depth)],
            "plain_ms": time_ms(plain_fn),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": lib_ms, "library_composed_ms": comp_ms,
            "depth": depth,
        })
        emit({"phase": "time", "cell": cell, **rows[-1]})
    # R7–R9: each DAG cell fused at depth 2 (K6–K8) and at the ring depths
    # and per-stream pairs, beside K's bound and library call; a ring row
    # times DAG_MAIN_DEPTH
    dag_sweeps = {}
    for cell in dag_kernel:
        fb, _, flops = cell_work[cell]
        t_bytes, t_ops = fb / bw * 1e3, flops / fp32 * 1e3
        at = {2: time_ms(kernel_fn(fused_calls[cell]))}
        for depth in (*RING_DEPTHS, *DAG_RING_PAIRS.get((cell, (0, 1, 2)),
                                                        ())):
            at[depth] = time_ms(kernel_fn(dag_ring_calls[cell, depth]))
        pairs = {d: t for d, t in at.items() if isinstance(d, tuple)}
        best = min(pairs, key=pairs.get) if pairs else None
        dag_sweeps[cell] = {
            "ms": {str(d): t for d, t in at.items()},
            "best_pair": list(best) if best else None,
            "best_pair_ms": pairs[best] if best else None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cells[cell]["library_ms"],
            "library_composed_ms": cells[cell]["library_composed_ms"],
            "ring_over_sync": {str(d): at[2] / t for d, t in at.items()
                               if d != 2}}
        emit({"phase": "depth_sweep", "cell": cell, **dag_sweeps[cell]})
    for rname, (kname, cell) in DAG_RING_ROW.items():
        krow = next(r_ for r_ in rows if r_["name"] == kname)
        call = dag_ring_calls[cell, DAG_MAIN_DEPTH]
        rows.append({
            "name": rname, "route": "cuda",
            "source": hopper.KERNELS[rname]["source"],
            "replaces": hopper.KERNELS[rname]["replaces"],
            "launches": launches[rname],
            "max_abs_err": errors[rname],
            "ms": dag_sweeps[cell]["ms"][str(DAG_MAIN_DEPTH)],
            "plain_ms": time_ms(lambda c_=call: c_.kernel.plain(c_.layouts)),
            "bound_ms": krow["bound_ms"], "bound_by": krow["bound_by"],
            "library_ms": krow["library_ms"],
            "depth": DAG_MAIN_DEPTH,
        })
        emit({"phase": "time", "cell": cell, **rows[-1]})
    # R10–R12: each halo and attention cell at depth 2 (K9–K11) and at its
    # ring depths, beside K's bound and library call; a ring row times
    # HALO_MAIN_DEPTH on its cell
    halo_work = {   # cell: (bytes, FLOPs, library call)
        "stencil1d": (*work["halo_stencil1d"], library["halo_stencil1d"]),
        "stencil1d_relu": (cell_work["stencil1d_relu"][0],
                           cell_work["stencil1d_relu"][2],
                           library_composed["stencil1d_relu"]),
        "stencil2d": (*work["halo_stencil2d"], library["halo_stencil2d"]),
        **{cell: (*attention_work(cell), sdpa(cell))
           for cell in ATTENTION_CELLS},
    }
    halo_sweeps = {}
    for cell, depths in HALO_RING_CELLS.items():
        nbytes, flops, lib = halo_work[cell]
        t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32 * 1e3
        at = {2: time_ms(kernel_fn(halo_call(cell, 2)))}
        for depth in depths:
            at[depth] = time_ms(kernel_fn(halo_ring_calls[cell, depth]))
        halo_sweeps[cell] = {
            "ms": {str(d): t for d, t in at.items()},
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lib),
            "refused": [ATTENTION_REFUSED_DEPTH] if cell in ATTENTION_CELLS
            else [],
            "ring_over_sync": {str(d): at[2] / t for d, t in at.items()
                               if d != 2}}
        emit({"phase": "depth_sweep", "cell": cell, **halo_sweeps[cell]})
    for rname, (kname, cell) in HALO_RING_ROW.items():
        krow = next(r_ for r_ in rows if r_["name"] == kname)
        call = halo_ring_calls[cell, HALO_MAIN_DEPTH]
        rows.append({
            "name": rname, "route": "cuda",
            "source": hopper.KERNELS[rname]["source"],
            "replaces": hopper.KERNELS[rname]["replaces"],
            "launches": launches[rname],
            "max_abs_err": errors[rname],
            "ms": halo_sweeps[cell]["ms"][str(HALO_MAIN_DEPTH)],
            "plain_ms": time_ms(lambda c_=call: plain(c_)),
            "bound_ms": krow["bound_ms"], "bound_by": krow["bound_by"],
            "library_ms": krow["library_ms"],
            "depth": HALO_MAIN_DEPTH,
        })
        emit({"phase": "time", "cell": cell, **rows[-1]})
    # R13–R15: each gather and scan cell at depth 2 (K12–K14) and at its
    # ring depths, beside K's bound and library call; a ring row times
    # GATHER_MAIN_DEPTH on its cell, its plain_ms the plain ring under the
    # ring kernel's runs
    def scan_ring_fn(depth):
        entry = scan._ssr._build(None, sc_arrays, depth_schedule(depth,
                                                                 lowering))
        return lambda: hopper.ring_stream_scan(sc_lc, *sc_arrays,
                                               ring=entry.ring)

    gather_sweeps, ring_plain = {}, {}
    for cell, depths in GATHER_RING_CELLS.items():
        kname = {"spmv_hpcg": "gather_spmv", "spmm_hpcg": "gather_spmm",
                 "scan_2p26": "stream_scan"}[cell]
        krow = next(r_ for r_ in rows if r_["name"] == kname)
        at = {2: krow["ms"]} if cell == "scan_2p26" else \
            {2: time_ms(kernel_fn(gather_call(cell, 2)))}
        refused = []
        for depth in depths:
            if cell == "scan_2p26":
                at[depth] = time_ms(scan_ring_fn(depth))
            elif f"ring_{cell}_{depth}_refused" in checks:
                refused.append(depth)
            else:
                at[depth] = time_ms(kernel_fn(gather_ring_calls[cell, depth]))
        pairs = {d: t for d, t in at.items() if isinstance(d, tuple)}
        best = min(pairs, key=pairs.get) if pairs else None
        gather_sweeps[cell] = {
            "ms": {str(d): t for d, t in at.items()},
            "best_pair": list(best) if best else None,
            "best_pair_ms": pairs[best] if best else None,
            "bound_ms": krow["bound_ms"], "bound_by": krow["bound_by"],
            "library_ms": krow["library_ms"], "refused": refused,
            "ring_over_sync": {str(d): at[2] / t for d, t in at.items()
                               if d != 2}}
        emit({"phase": "depth_sweep", "cell": cell, **gather_sweeps[cell]})
    for rname, (kname, cell) in GATHER_RING_ROW.items():
        krow = next(r_ for r_ in rows if r_["name"] == kname)
        if cell == "scan_2p26":
            plain_fn = (lambda e=sc_entry: hopper.plain_stream(
                scan.SCAN, sc_lc, sc_arrays, ring=e.ring,
                steps_per_cta=sc_run))
        else:
            call = gather_ring_calls[cell, GATHER_MAIN_DEPTH]
            kern = call.kernel
            plain_fn = (lambda c_=call, k_=kern: hopper.plain_ring(
                k_.body, k_.geometry, c_.layouts, k_.out_dtype,
                k_.acc_dtype, mode="nest", ring=k_.ring,
                steps_per_cta=hopper.ring_run_steps(
                    hopper.RING_KERNELS[k_.device_key], k_.geometry,
                    k_.ring, torch.float32, sms)))
        rows.append({
            "name": rname, "route": "cuda",
            "source": hopper.KERNELS[rname]["source"],
            "replaces": hopper.KERNELS[rname]["replaces"],
            "launches": launches[rname],
            "max_abs_err": errors[rname],
            "ms": gather_sweeps[cell]["ms"][str(GATHER_MAIN_DEPTH)],
            "plain_ms": time_ms(plain_fn),
            "bound_ms": krow["bound_ms"], "bound_by": krow["bound_by"],
            "library_ms": krow["library_ms"],
            "depth": GATHER_MAIN_DEPTH,
        })
        emit({"phase": "time", "cell": cell, **rows[-1]})
    ms = {r["name"]: r["ms"] for r in rows}
    emit({"phase": "ssr_vs_baseline", "ssr_over_baseline": {
        kname: ms[bname] / ms[kname] for kname, bname in PAIRS.items()}})
    # the gemm cell's kernels against the card's bound and torch.matmul
    # (TF32 off), with their registers and CTAs an SM: ``ms`` as the
    # kernels line times them, ``busy_ms`` with the device kept busy (no
    # launch gap in a sample)
    gsw = sweeps["gemm"]
    gemm_fns = {"contract_gemm": timed["contract_gemm"][0],
                "base_gemm": timed["base_gemm"][0],
                **{f"ring_contract_gemm_{d}": kernel_fn(ring_calls["gemm", d])
                   for d in RING_DEPTHS}}
    gemm_ms = {"contract_gemm": ms["contract_gemm"],
               "base_gemm": ms["base_gemm"],
               **{f"ring_contract_gemm_{d}": gsw["ms"][str(d)]
                  for d in RING_DEPTHS}}
    lib_busy = busy_ms(library["contract_gemm"])
    busy = {name: busy_ms(fn) for name, fn in gemm_fns.items()}
    emit({"phase": "gemm_roofline", "card": smi,
          "bound_ms": gsw["bound_ms"], "library_ms": gsw["library_ms"],
          "library_busy_ms": lib_busy,
          "kernels": {name: {"ms": t, "bound_over_ms": gsw["bound_ms"] / t,
                             "over_library": t / gsw["library_ms"],
                             "busy_ms": busy[name],
                             "busy_over_library": busy[name] / lib_busy}
                      for name, t in gemm_ms.items()},
          "attributes": {n: attributes[n] for n in (
              "contract_gemm", "ring_contract_gemm", "base_gemm")}})
    emit({"phase": "fused_vs_unfused", "fused_over_unfused": {
        cell: c_["fused_over_unfused"] for cell, c_ in cells.items()}})
    # the main path's entry points once warm, host work included; beside
    # them a direct ssr_call with its schedule pinned, and the schedule
    # cache probe that an unpinned ssr_call makes once per problem and epoch
    dot_nest, dot_ops = compiler.dot_product_nest(n_vec), {"A": x, "B": y}
    probes = {
        "dot_ssr_call_pinned": lambda: lowering.ssr_call(
            dot_nest, reduction.MUL, dot_ops,
            schedule=lowering.DEFAULT_SCHEDULE),
        "dot_ssr_call_unpinned": lambda: lowering.ssr_call(
            dot_nest, reduction.MUL, dot_ops),
        "schedule_lookup": lambda: autotune.lookup(dot_nest, dot_ops,
                                                   device=dev),
    }
    walls = {key: wall_ms(fn) for key, fn in {**path, **probes}.items()
             if key not in COMMITTED_ENTRIES}
    emit({"phase": "entry_points", "wall_ms": walls})
    # the sparse cells: the entry's wall split into CSR validation and ELL
    # packing on the card, the copies of a host CSR triple and x to the
    # card, the layouts the kernel takes (K12: pack_ell's planes, no copy;
    # K13: the lowered (m, 128) layouts) and the kernel; and what the
    # gathers move
    host = {"spmv": [t.cpu() for t in (*hcsr, hx)],
            "spmm": [t.cpu() for t in (*scsr, sX)]}
    cell_of = {"spmv": ("spmv_hpcg", "gather_spmv", n_v1, hcsr),
               "spmm": ("spmm_hpcg", "gather_spmm", n_m2, scsr)}
    for op, (cell, kname, n_, csr) in cell_of.items():
        call, row = calls[kname], next(r for r in rows if r["name"] == kname)
        arrays = [sparse_ops[op][s_.name]
                  for s_ in (*call.lowered.in_streams, *call.lowered.gathers)]
        nnz = int(csr[0].numel())
        info = {
            "m": n_, "nnz": nnz, "k": hk if op == "spmv" else sk,
            "bytes": work[kname][0],
            "layout_bytes": sum(t.numel() * t.element_size()
                                for t in call.layouts),
            "layout_shapes": [list(t.shape) for t in call.layouts],
            "kernel_ms": row["ms"], "bound_ms": row["bound_ms"],
            "share_of_bound": row["bound_ms"] / row["ms"],
            "pack_ms": wall_ms(lambda c_=csr, n=n_: sparse.pack_ell(*c_, n)),
            "h2d_ms": wall_ms(lambda h=host[op]: [t.to(dev) for t in h]),
            # the layouts the kernel takes on the card (K12: the planes as
            # they are), and the padded layouts' copy beside it
            "layout_ms": time_ms(lambda c_=call, a=arrays:
                                 lowering.device_layouts(
                                     c_.kernel, c_.lowered, a, dev)),
            "padded_layout_ms": time_ms(lambda c_=call, a=arrays:
                                        lowering.stream_layouts(c_.lowered,
                                                                a)),
            "entry_wall_ms": walls[op],
            "entry_wall_host_csr_ms": wall_ms(
                lambda h=host[op], k_=op: getattr(ops, k_)(*h, ssr=True)),
        }
        if op == "spmm":
            info["gathered_bytes"] = nnz * SPMM_RHS * 4
            info["gathered_bytes_per_ms"] = info["gathered_bytes"] / row["ms"]
        emit({"phase": "sparse_cell", "cell": cell, **info})

    # -- 5. the tuner on the card --------------------------------------------
    nest, operands = compiler.gemm_nest(m, n, k), {"A": a, "B": b}
    cands = autotune.candidate_schedules(nest, quick=True, operands=operands,
                                         body=gemm.DOT, device=dev)
    # ten samples per survivor, so the spread that a winner must beat is
    # the race's own (the default of three samples sees little of it)
    res = autotune.autotune(nest, gemm.DOT, operands, candidates=cands,
                            iters=10)
    if not res.committed or res.degraded:
        raise SystemExit(f"chip_smoke: the tuner did not commit: {res}")
    emit({"phase": "tune", "candidates": [s.to_json() for s in cands],
          "measured": res.measured, "default_us": res.default_us,
          "tuned_us": res.tuned_us, "winner": res.schedule.to_json(),
          "winner_is_default": res.is_default, "held_back": res.held_back,
          "timings_us": [[s.to_json(), us] for s, us in res.timings]})
    # the winner runs K3, or R3 where it is deeper than 2
    committed = lowering.prepare_call(nest, gemm.DOT, operands,
                                      schedule=res.schedule)
    tuned_kernel = hopper.RING_KERNELS[committed.kernel.device_key] \
        if committed.kernel.pipelined else "contract_gemm"
    before = hopper.LAUNCHES[tuned_kernel]
    tuned_out = ops.matmul(a, b, ssr=True)
    torch.cuda.synchronize()
    resolved = gemm._ssr.schedule_for(a, b)
    want = plain(committed)
    del committed
    scale_t = torch.abs(a) @ torch.abs(b)
    tuned_err = rel_to_abs_prod(tuned_out, want, scale_t)
    emit({"phase": "tuned_dispatch", "resolved": resolved.to_json(),
          "kernel": tuned_kernel,
          "launched": hopper.LAUNCHES[tuned_kernel] - before,
          "rel_to_abs_prod": tuned_err, "limit": CONTRACT_LIMIT})
    if resolved != res.schedule or tuned_err > CONTRACT_LIMIT or \
            hopper.LAUNCHES[tuned_kernel] == before:
        raise SystemExit("chip_smoke: ops.matmul did not run the committed "
                         "winner correctly")

    # a committed depth winner dispatches R3: the race's fastest pipelined
    # survivor (the winner itself where it is one), committed, then
    # ssr_call with no schedule, to the bits of K3 on the same geometry
    deep_runs = sorted((us, i, s_) for i, (s_, us) in enumerate(res.timings)
                       if max(s_.stream_depths or (s_.buffer_depth,)) > 2)
    depth_sched = deep_runs[0][2] if deep_runs else deep[3]
    autotune.global_cache().put(res.key, depth_sched,
                                meta={"note": "the fastest depth survivor"})
    before = dict(hopper.LAUNCHES)
    depth_out = lowering.ssr_call(nest, gemm.DOT, operands)
    torch.cuda.synchronize()
    depth_launched = {k_: v - before[k_] for k_, v in hopper.LAUNCHES.items()
                      if v != before[k_]}
    twin = lowering.prepare_call(nest, gemm.DOT, operands, schedule=(
        lowering.Schedule.from_json({**depth_sched.to_json(),
                                     "buffer_depth": 2,
                                     "stream_depths": None}))).run()
    torch.cuda.synchronize()
    depth_call = lowering.prepare_call(nest, gemm.DOT, operands,
                                       schedule=depth_sched)
    emit({"phase": "depth_dispatch", "committed": depth_sched.to_json(),
          "raced": bool(deep_runs), "launched": depth_launched,
          "route": hopper.gemm_ring_route(depth_call.kernel.geometry,
                                          depth_call.layouts),
          "same_bits_as_k3": bool(torch.equal(depth_out.view(torch.int32),
                                              twin.view(torch.int32)))})
    if depth_launched != {"ring_contract_gemm": 1} or not torch.equal(
            depth_out.view(torch.int32), twin.view(torch.int32)):
        raise SystemExit("chip_smoke: a committed depth winner did not run "
                         "R3, or not to K3's bits")
    autotune.global_cache().put(res.key, res.schedule)

    # a committed depth-4 schedule for the stencil1d cell makes ops.stencil1d
    # (ssr=True, no schedule) run R10, to the bits of the main path's ring
    st_ops, st_static, _ = stencil._ssr_1d._prepare(xs, ws)
    st_key = autotune.cache_key(stencil._ssr_1d._nest(st_static),
                                dict(st_ops), mode=stencil._ssr_1d._mode,
                                out_dtype=stencil._ssr_1d._out_dtype_of(
                                    st_static), device=dev)
    autotune.global_cache().put(st_key, deep[HALO_MAIN_DEPTH],
                                meta={"note": "the stencil1d cell's depth"})
    before = dict(hopper.LAUNCHES)
    ops_out = ops.stencil1d(xs, ws, ssr=True)
    torch.cuda.synchronize()
    ops_launched = {k_: v - before[k_] for k_, v in hopper.LAUNCHES.items()
                    if v != before[k_]}
    ops_same = bool(torch.equal(ops_out.view(torch.int32),
                                main["stencil1d_ring"].view(torch.int32)))
    emit({"phase": "ops_depth_dispatch", "cell": "stencil1d",
          "committed": deep[HALO_MAIN_DEPTH].to_json(),
          "launched": ops_launched, "same_bits_as_ring": ops_same})
    if ops_launched != {"ring_halo_stencil1d": 1} or not ops_same:
        raise SystemExit("chip_smoke: ops.stencil1d under a committed depth "
                         "did not run R10, or not to its bits")
    autotune.global_cache().put(st_key, lowering.DEFAULT_SCHEDULE)

    # -- 6. the degradation ladder on the card --------------------------------
    tuned, note = res.schedule, "the committed winner, committed again"
    if res.is_default:
        others = [(us, i, s) for i, (s, us) in enumerate(res.timings)
                  if s != lowering.DEFAULT_SCHEDULE]
        if not others:
            raise SystemExit("chip_smoke: no non-default survivor to tune")
        tuned = min(others)[2]
        note = "the winner is the default: the fastest non-default survivor"
    cache = autotune.global_cache()
    # a commit bumps the epoch, so the gemm NestKernel builds its entry anew
    # and the armed fault fires there
    cache.put(res.key, tuned, meta={"note": note})
    lowering.reset_dispatch_stats()
    frontend.reset_dispatch_stats()
    resilience.reset_fallback_log()
    with resilience.inject_faults("compile") as specs:
        degraded_out = ops.matmul(a, b, ssr=True)
    torch.cuda.synchronize()
    events = resilience.fallback_events()
    want = plain(calls["contract_gemm"])
    ladder_err = rel_to_abs_prod(degraded_out, want, scale_t)
    corrupt = os.path.exists(os.path.join(cache.path,
                                          f"{res.key}.json.corrupt"))
    emit({"phase": "ladder", "tuned": tuned.to_json(), "note": note,
          "fired": specs[0].fired,
          "degraded": frontend.DISPATCH_STATS["degraded"],
          "events": [[e.seam, e.site, e.from_schedule, e.to_schedule]
                     for e in events],
          "quarantined": corrupt,
          "now_resolves": gemm._ssr.schedule_for(a, b).to_json(),
          "rel_to_abs_prod": ladder_err, "limit": CONTRACT_LIMIT})
    if not (specs[0].fired == 1 and frontend.DISPATCH_STATS["degraded"] == 1
            and [e.site for e in events] == ["nest_kernel:gemm"]
            and corrupt and cache.get(res.key) is None
            and gemm._ssr.schedule_for(a, b) == lowering.DEFAULT_SCHEDULE
            and ladder_err <= CONTRACT_LIMIT):
        raise SystemExit("chip_smoke: the compile fault did not degrade "
                         "to the default schedule correctly")

    # -- 5b. the DAG cut search on the card -----------------------------------
    ln_case = cases["layernorm"]
    nests, bodies, operands, mode, _ = ln_case.spec(lx)
    graph = lowering._dag_for(nests, None)
    legal = [cut for cut in autotune.enumerate_cuts(graph)
             if autotune.dag_cut_is_legal(graph, cut, nests=nests,
                                          bodies=bodies, mode=mode,
                                          device=dev)[0]]
    dres = autotune.autotune_dag(nests, bodies, operands, mode=mode,
                                 iters=10, force=True)
    if not dres.committed or dres.degraded:
        raise SystemExit(f"chip_smoke: the DAG tuner did not commit: {dres}")
    emit({"phase": "tune_dag", "cell": "layernorm",
          "legal_cuts": [list(c_) for c_ in legal],
          "survivors": [[list(s_.cut_edges), us] for s_, us in dres.timings],
          "winner": list(dres.schedule.cut_edges),
          "fused_us": dres.default_us, "winner_us": dres.tuned_us,
          "held_back": dres.held_back})
    # commit the cut that fuses nothing: the next fused_layernorm with no
    # schedule runs the three singleton instantiations
    full_cut = lowering.Schedule(cut_edges=tuple(range(len(graph.edges))))
    cache = autotune.global_cache()
    cache.put(dres.key, full_cut, meta={"note": "every edge cut"})
    fused_ln = fused_calls["layernorm"]
    ln_want = fused_ln.finish(fused_ln.kernel.plain(fused_ln.layouts)
                              ).reshape(lx.shape)
    before = dict(hopper.LAUNCHES)
    cut_out = dag.fused_layernorm(lx)
    torch.cuda.synchronize()
    cut_launches = {k_: v - before[k_] for k_, v in hopper.LAUNCHES.items()
                    if v != before[k_]}
    cut_err = map_err(cut_out, ln_want)
    emit({"phase": "committed_cut", "cut": list(full_cut.cut_edges),
          "launches": cut_launches, "rel_err": cut_err, "limit": MAP_LIMIT})
    if cut_launches != {"dag_layernorm": 3} or cut_err > MAP_LIMIT:
        raise SystemExit("chip_smoke: the committed cut did not run the "
                         "singleton instantiations correctly")

    # -- 6b. a compile fault under the committed cut --------------------------
    lowering.clear_caches()          # the components' kernels build anew
    lowering.reset_dispatch_stats()
    resilience.reset_fallback_log()
    before = dict(hopper.LAUNCHES)
    with resilience.inject_faults("compile") as specs:
        degraded_ln = dag.fused_layernorm(lx)
    torch.cuda.synchronize()
    deg_launches = {k_: v - before[k_] for k_, v in hopper.LAUNCHES.items()
                    if v != before[k_]}
    events = resilience.fallback_events()
    deg_err = map_err(degraded_ln, ln_want)
    corrupt = os.path.exists(os.path.join(cache.path,
                                          f"{dres.key}.json.corrupt"))
    emit({"phase": "dag_ladder", "fired": specs[0].fired,
          "degraded": lowering.DISPATCH_STATS["degraded"],
          "launches": deg_launches,
          "events": [[e.seam, e.site, e.from_schedule, e.to_schedule]
                     for e in events],
          "quarantined": corrupt, "rel_err": deg_err, "limit": MAP_LIMIT})
    if not (specs[0].fired == 1 and lowering.DISPATCH_STATS["degraded"] == 1
            and deg_launches == {"dag_layernorm": 1}
            and [e.site for e in events] == ["ssr_dag_call"]
            and corrupt and cache.get(dres.key) is None
            and deg_err <= MAP_LIMIT):
        raise SystemExit("chip_smoke: the compile fault under the committed "
                         "cut did not degrade to all-fused correctly")

    # -- 7. result ----------------------------------------------------------
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
