#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py [--seed N]    # about ten minutes, the build included

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
   K13, R13, R14, K3, R3, B3, R1, R2, R4, R15, K14, B8, K1, K2, B1, B2,
   B5, B7, K4's eight builds, K11's tiles at D = 80, 96, 128, 192 and 256 (96, 96,
   128, 192 and 256 live lanes) and R12 (the most over its sixteen
   instantiations), K8 and R9 (the most over their ten): registers and
   local bytes a thread as ``cudaFuncGetAttributes`` reads them; K3,
   R3, B3, R1, R2, R4, R15, K14, B8, K1, K2, B1, B2, B5, B7, K4, K11, K8
   and R9 also their CTAs an SM from the
   occupancy API (K4's held to ``hopper.GEMV_PER_SM``), the rings at
   their main path's rings; K11 and K8 their shared memory as their
   entries and the wrapper's mirrors count it, and R9 its at the DAG
   rings' depths) and the card's name and power limit;
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
   memset, and its baseline B8's one, one K1 call and one B1 call on
   the dot cell each its one kernel, its last CTA folding the partials,
   one B5 call on the stencil1d cell and one B7 call on spmm_hpcg's
   planes each its one, and one fused mlp_block call K8's one kernel,
   its unfused one three
   (``torch.profiler``
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
   block zeroed, which must differ, and K1's and K2's local bytes none;
   B1 likewise to ``hopper.reduce_mul_model``'s bits at its own packs (the
   dot cell in f32 and bf16, n = 1000 and 2**20 ± 1024), five B1 runs to
   one set of bits beside its run on the first block zeroed, B1 on the
   dot cell equal to K1 to the bit where both read 16-byte f32 packs, B2
   bit-exact against its plain version and K2 in f32, bf16 and int32 on a
   view one element off a 16-byte boundary (one element an access), B1's
   and B2's local bytes none and B1 at least ``hopper.REDUCE_PER_SM`` CTAs
   an SM; B5 to ``hopper.base_stencil1d_model``'s bits on the stencil1d
   cell in f32 and bf16 and B7 to ``hopper.base_spmm_model``'s bits on
   spmm_hpcg, five more runs of each cell to those bits, B5's and B7's
   local bytes none (their registers and CTAs an SM beside); K15 to the bit on the batch cell and bf16 inputs, within the
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
   bytes a thread at most R14_LOCAL_BYTES, R3's, K3's, R1's, R2's, R4's,
   K8's and R9's none, K3's shared memory as its entry and the wrapper
   count it, K8's likewise and within the opt-in limit, and R9's as its
   entry and the wrapper count it at depths 3, 4, 8 (and the residual's
   (4, 2)) on the DAG cell's blocks; the gemm check names K3's route (``packs``, ``words`` or
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
   CUDA events, beside the least time the card could take (K1's, K2's,
   K4's, B1's, B2's and B4's rows also through the C entry,
   ``c_entry_ms``, and the host's time to issue one wrapper call,
   ``host_ms``), each baseline
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
4b. the cluster (``parallel/cluster.py``): dot, relu, sum_sq_diff and
   axpy_dot at n = 2**26, gemm at 4096**3, gemv at 8192**2 and stencil1d
   at 2**26 through their registry entries' ``cluster`` at 1, 2, 4 and 8
   cores, and each entry's odd example at 8 (tiles off 16-byte
   boundaries), every launch counter at 0 just before: cores = 1 and every
   map to the single-core entry's bits, the reduces within DOT_LIMIT of
   Σ|terms| beside core 0's partial left out, each core's Hopper kernel
   launched once, ``LAST_DISPATCH``'s cores and tile bounds, no fallback,
   ``cluster_over_single`` and the entries' wall times (the
   ``cluster_time`` lines); then the locality audit on dot and relu at 4
   cores.  The device kernels of each clustered call at 1, 2, 4 and 8
   cores are counted in phase 2's ``device_launches`` line, against
   ``cluster_launches``;
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
7. the serving path (``models/``, ``launch/steps.py``,
   ``launch/serve.py``), once phases 1–6's tensors are freed and the peak
   memory counter reset: qwen3-14b at its published size (40 layers,
   d_model 5120, 40/8 heads, d_ff 17408, vocab 151,936, bf16: 14.8 B
   parameters, 27.5 GiB of weights drawn on the card from ``--seed``; the
   phase peaks near 31 GiB) serves 8 prompts of 64 tokens from the data
   pipeline through ``serve.generate`` (a first run, then a timed one: 31
   greedy decode steps); hard checks, each beside a control that must read
   above its limit: every logit finite; each decode step's logits against
   one teacher-forced ``forward`` over the prompts and the generated
   tokens (``SERVE_TF_LIMIT``; control: every cache's first position
   zeroed); one 2048-token prefill through ``flash_sdpa`` (its 40 calls
   counted), and ``flash_sdpa`` against ``_sdpa`` on layer 0's q, k, v
   (``SERVE_FLASH_LIMIT``; control: ``_sdpa`` unmasked); the smoke variant
   on the card against the CPU from one set of weights in f32 with TF32 off
   (``SERVE_CPU_LIMIT``; control: the card on the weights rounded to
   bf16).  The ``serve`` line reports, beside the card's name and power
   limit, prefill ms and tokens/s, decode ms a step and tokens/s (the
   serve CLI's report lines too), peak memory, one decode step's device
   kernels and busy share (Σ kernel time over the step's wall time, from
   ``torch.profiler``), and the bounds: a decode step's weight and cache
   bytes over the HBM peak, prefill's 2·N·tokens over the dense bf16 peak;
7b. the experts, the latent attention and the recurrent mixers
   (``models/moe.py``, MLA, ``models/ssm.py``), once phase 7's tensors
   are freed, one config at a time at its published widths, depth cut by
   setting every group's repeats to 1: deepseek-v3 (2 of 61 layers, one
   dense and one of 256 experts top-8 with a shared one, 13.9 B
   parameters), jamba-v0.1 (one 8-layer period: 7 Mamba, 1 attention, 4
   MoE of 16 experts top-2, 13.3 B) and xlstm-125m (whole); each serves
   the phase-7 batch through ``serve.generate`` (a first run recording
   the MoE calls, then a timed one); hard checks beside their controls:
   every logit finite; decode against teacher forcing at capacity factor
   e / k (no slot drops at either token count) on the positions no
   routing flip reaches (``FAMILY_TF_LIMIT``; flips counted from
   ``_route`` on each MoE layer's input in both runs, at most
   ``FAMILY_FLIP_CAP`` of the tokens, at least ``FAMILY_MIN_CHECKED`` of
   the positions kept; xlstm-125m's on an f32 copy of its weights,
   ``FAMILY_TF_F32``; control: every attention or latent cache's first
   position and every recurrent state zeroed); deepseek's 2048-token
   prefill through ``flash_sdpa`` (q·k over 192, v 128) against
   ``_sdpa`` on layer 0 (``SERVE_FLASH_LIMIT``); the smoke variant on the
   card against the CPU (``SERVE_CPU_LIMIT``, times its mLSTM layers).  The ``serve_families``
   line reports per config prefill and decode times, peak memory, a
   decode step's kernels and busy share, the dropped-slot shares at the
   published capacity (prefill and each decode step) and the bounds (a
   decode step reads every expert's weights: the dense-capacity dispatch
   multiplies all e buffers);
7c. training (``optim/``, ``launch/steps.py``'s train step with remat,
   ``checkpoint/``, ``runtime/fault.py``, ``launch/train.py``), once
   phase 7b's tensors are freed and the peak counter reset, TF32 off:
   h2o-danube-1.8b at its published size (24 layers, d_model 2560, 32/8
   heads of 80, d_ff 6912, vocab 32,000, window 4096, bf16 weights and
   f32 moments: 1.83 B parameters, 17.1 GiB of state drawn on the card
   from ``--seed``) trains 20 steps through ``launch/train.py``'s step at
   the CLI's defaults (batch 8 × 128 from the data pipeline, lr 3e-4,
   warmup 10), then one step of 2 × 4096 tokens in 2 microbatches
   (``flash_sdpa`` and the f32 accumulator under remat); hard checks,
   each beside a control that must read above its limit: every loss and
   gradient norm finite; the loss falls by ``TRAIN_LOSS_DROP`` (control:
   the untrained weights on the last batches); the long step goes through
   ``flash_sdpa`` with remat in every layer; on the trained weights, an
   f32 copy's ⟨g, d⟩ against extrapolated central differences
   (``GRAD_FD_LIMIT``) and the bf16 gradients against the f32 copy's, a
   layer's tensor at a time (``GRAD_BF16_LIMIT``; controls: the last
   layer's gradient zeroed, the opposite sign); the ten smoke variants'
   train step on the card against the CPU from one state, in f32
   (``SERVE_CPU_LIMIT``) and bf16 (``TRAIN_BF16_CPU_LIMIT``; control:
   another batch); xlstm-125m whole trained 10 steps clean and with
   failures at 3 and 7 from checkpoints every 2 steps under ``build/``,
   under deterministic algorithms: the final parameters to the bit
   (control: the checkpoint two steps before the end).  The ``train``
   line reports the losses and gradient norms, a step's ms and tokens/s
   beside its bound (6·N·tokens over the dense bf16 peak), its device
   kernels and busy share (``torch.profiler``), peak memory, the long
   step's ms and peak beside the reckoning of what it holds, and the
   checkpoint's save and restore seconds;
7d. the multi-device layer (``launch/mesh.py``, ``parallel/``, the EP
   MoE, the sharded train step, the elastic restore), once 7c's tensors
   are freed, on ranks that share the card: (a) one NCCL rank takes
   danube's sharded step on a (1, 1) mesh, to the unsharded step's bits
   under deterministic algorithms (control: another batch); (b) four gloo
   ranks on (data 2, model 2) take danube's sharded step against the
   unsharded step from one state, per leaf within ``MESH_STEP_LIMIT``
   (control: another batch's gradient), run ``compressed_psum`` over
   ``data`` within its bounds, and checkpoint danube cut to 2 layers from
   their shards and restore it onto (1, 2) to the bit, then step there;
   (c) deepseek-v3's MoE layer at published widths through ep2d (8
   tokens) and ep (8 × 1,024) on (2, 2), dbrx's through ep_dstat on (3,
   2), each against the plain dispatch within ``EP_LIMIT`` on the tokens
   no routing flip reaches (control: one rank's experts zeroed). The
   ``mesh_world1`` and ``mesh`` lines report a rank's resident state,
   peak, step and collective ms ("ranks share one H100 over gloo") and
   the phase's seconds (at most ``MESH_PHASE_S``);
8. print the ``{"kernels": [...]}`` line (K1–K17, B1–B8 and R1–R15, 40
   rows; K11's and R12's rows are the attention_qwen3 cell, K11's row
   carries the other attention cells under ``cells``, which also have time
   and depth_sweep lines of their own; an R row times its main-path
   depth), then the device line last.  The serving and training paths run
   no Pallas kernel in the reference, so they add no row.

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
import concurrent.futures
import dataclasses
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
#: K11's tiles in phase 1: (lanes, head dim) of danube and the widest head
#: dim on the 128-lane tile's 96 live lanes, qwen3 (128 live lanes), d192
#: and d256 (the wide tile's 192 and 256)
K11_TILES = ((128, 80), (128, 96), (128, 128), (256, 192), (256, 256))
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
               "stream_scan": "prefix_sum", "reduce_mul": "dot_k1",
               "base_reduce": "dot_b1"}
#: the kernels whose rows of the kernels line also time their C entry
#: (``c_entry_ms``) and the host's time to issue a wrapper call
#: (``host_ms``)
ENTRY_ROWS = ("contract_gemv", "reduce_mul", "map_relu", "base_reduce",
              "base_relu", "base_gemv")

# The cluster (parallel/cluster.py): each full-size cell's clustered entry
# at these core counts (and its entry's odd example at the last), beside
# the single-core entry.  Cell → (registry entry, mode, the Hopper kernel
# one core's call launches)
CLUSTER_CORES = (1, 2, 4, 8)
CLUSTER_CELLS = {"dot": ("reduction", "reduce", "reduce_mul"),
                 "relu": ("relu", "map", "map_relu"),
                 "gemm": ("gemm", "map", "contract_gemm"),
                 "gemv": ("gemv", "map", "contract_gemv"),
                 "stencil1d": ("stencil1d", "map", "halo_stencil1d"),
                 "sum_sq_diff": ("sum_sq_diff", "reduce", "chain_elem"),
                 "axpy_dot": ("axpy_dot", "reduce", "chain_elem")}
# device kernels of one single-core call of each cell (the stencil's: x and
# w laid out by F.pad, then K9; the chains': K5 and its fold of the
# partials), as the first run counted them (PERF.md §2)
CLUSTER_SHARD_LAUNCHES = {"dot": 1, "relu": 1, "gemm": 1, "gemv": 1,
                          "stencil1d": 3, "sum_sq_diff": 2, "axpy_dot": 2}


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


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bits (NaN payloads and signed zeros too)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def cluster_launches(cell: str, cores: int) -> int:
    """The device kernels of one clustered call: each core's call (a gemm
    core on a column panel of B, Cc > 1, also lays the strided panel out
    contiguous), then the reduce's combine (C − 1 adds, core 0 first) or
    the map's assembly (one cat; the gemm's 2-D grid a cat a row of it
    where Cc > 1, then one of the rows)."""
    from repro_torch.parallel.cluster import factor_cores

    shard = CLUSTER_SHARD_LAUNCHES[cell]
    if cores == 1:
        return shard
    if CLUSTER_CELLS[cell][1] == "reduce":
        return cores * shard + cores - 1
    if cell != "gemm":
        return cores * shard + 1
    cr, cc = factor_cores(cores)
    return cores * (shard + (cc > 1)) + (1 if cc == 1 else cr + 1)


def cluster_traced_calls(dev: torch.device, inputs: dict) -> dict:
    """``count_device_launches``'s entries for each cell's clustered call at
    CLUSTER_CORES: ``cluster_launches`` device kernels, any names."""
    from repro_torch.kernels import registry

    def call(cell, c):
        args, kw = inputs[cell]
        entry = registry.get(CLUSTER_CELLS[cell][0])
        return lambda: entry.cluster(*args, cores=c, device=dev, **kw)
    return {f"cluster_{cell}_c{c}": (call(cell, c), cluster_launches(cell, c),
                                     cluster_launches(cell, c), ("",))
            for cell in CLUSTER_CELLS for c in CLUSTER_CORES}


def cluster_phase(dev: torch.device, inputs: dict, smi: str) -> None:
    """The cluster on the card: every cell of ``inputs`` (cell → (args,
    kwargs), at full size) through its registry entry's ``cluster`` at
    CLUSTER_CORES and on the entry's odd example at the last.  Hard: cores
    = 1 to the single-core entry's bits; maps to its bits at every count;
    reduces within DOT_LIMIT of Σ|terms| of it, beside a control with core
    0's partial left out that must read above it; each core's Hopper
    kernel launched once a core (``hopper.LAUNCHES``, counters at 0 just
    before the drive; the device kernels a call are phase 2's, from
    ``cluster_traced_calls``); ``LAST_DISPATCH``'s cores and tile bounds;
    no fallback; the locality audit on dot (reduce) and relu (map) at 4
    cores.  Reported: ``cluster_over_single`` (the single-core entry's ms
    over the clustered entry's at each count, ``time_ms``) and both
    entries' wall times once warm (``wall_ms``)."""
    from repro_torch.core import hopper, lowering, resilience
    from repro_torch.kernels import frontend, registry
    from repro_torch.launch.audit import check_cluster_locality
    from repro_torch.parallel import cluster

    entries = {cell: registry.get(name)
               for cell, (name, _m, _k) in CLUSTER_CELLS.items()}
    top = CLUSTER_CORES[-1]
    cases = [(cell, c, inputs[cell]) for cell in CLUSTER_CELLS
             for c in CLUSTER_CORES]
    for cell, e in entries.items():   # the odd examples, on the card
        args, kw = e.example(np.random.default_rng(top), odd=True)
        cases.append((f"{cell}_odd", top, (tuple(a.to(dev) for a in args),
                                           kw)))

    def cell_of(key: str) -> str:
        return key[:-len("_odd")] if key.endswith("_odd") else key

    def terms(cell: str, args, kw) -> float:
        """Σ|terms| of a reduce, in float64."""
        a = [t.double() for t in args]
        if cell == "dot":
            return float((a[0] * a[1]).abs().sum())
        if cell == "sum_sq_diff":
            return float(((a[0] - a[1]) ** 2).sum())
        return float(((kw["alpha"] * a[0] + a[1]) * a[2]).abs().sum())

    # what the clustered calls are held to, computed before the drive (so
    # its counters see the clustered calls alone): the single-core entry,
    # and a reduce's core-0 partial for the control
    singles, partial0, scale = {}, {}, {}
    for key, c, (args, kw) in cases:
        cell = cell_of(key)
        e = entries[cell]
        if (key, 1) not in singles:
            singles[key, 1] = e.ssr(*args, device=dev, **kw)
        if CLUSTER_CELLS[cell][1] == "reduce" and c > 1:
            (padded, n_pad) = cluster.pad_to_cores(args, c)
            partial0[key, c] = e.ssr(*(t[:n_pad // c] for t in padded),
                                     device=dev, **kw)
            scale[key] = terms(cell, args, kw)
    torch.cuda.synchronize()

    # the cluster's main path, every counter at 0 just before it
    lowering.reset_dispatch_stats()
    frontend.reset_dispatch_stats()
    resilience.reset_fallback_log()
    hopper.reset_launches()
    checks, failed, want_launches = {}, [], {}
    for key, c, (args, kw) in cases:
        cell = cell_of(key)
        name, mode, kernel = CLUSTER_CELLS[cell]
        want_launches[kernel] = want_launches.get(kernel, 0) + c
        cluster.LAST_DISPATCH.clear()
        got = entries[cell].cluster(*args, cores=c, device=dev, **kw)
        torch.cuda.synchronize()
        single = singles[key, 1]
        check = {"cores": c}
        if mode == "map" or c == 1:
            check["bits"] = ok = bits_equal(got, single)
        else:
            err = abs(float(got) - float(single)) / scale[key]
            control = abs(float(got - partial0[key, c]) - float(single)) \
                / scale[key]
            check.update(rel_err=err, control=control, limit=DOT_LIMIT)
            ok = err <= DOT_LIMIT < control
        if cell in ("dot", "relu", "sum_sq_diff", "axpy_dot"):
            n_pad = cluster.pad_to_cores(args, c)[1]
            d = dict(cluster.LAST_DISPATCH)
            check["dispatch"] = [d.get("cores"), list(d.get("tile_bounds",
                                                            ()))]
            ok = ok and d.get("cores") == c and \
                d.get("tile_bounds") == (n_pad // c,)
        checks[f"{key}_c{c}"] = check
        if not ok:
            failed.append(f"{key}_c{c}")
    launches = {k_: v for k_, v in hopper.LAUNCHES.items() if v}
    fallbacks = {"events": len(resilience.fallback_events()),
                 **{c_: lowering.DISPATCH_STATS[c_]
                    for c_ in ("fallbacks", "degraded")}}
    emit({"phase": "cluster_main_path", "launches": launches,
          "want": want_launches, "fallbacks": fallbacks, "checks": checks})
    if launches != want_launches:
        failed.append(f"launches {launches} != {want_launches}")
    if any(fallbacks.values()):
        failed.append(f"a fallback fired: {fallbacks}")

    # reported: each cell's clustered entry against its single-core entry
    for cell, (name, _m, _k) in CLUSTER_CELLS.items():
        args, kw = inputs[cell]
        calls = {"single": lambda e=entries[cell]: e.ssr(*args, device=dev,
                                                         **kw),
                 **{c: (lambda c=c, e=entries[cell]: e.cluster(
                     *args, cores=c, device=dev, **kw))
                    for c in CLUSTER_CORES}}
        ms = {c: time_ms(fn) for c, fn in calls.items()}
        walls = {c: wall_ms(fn) for c, fn in calls.items()}
        emit({"phase": "cluster_time", "cell": cell, "card": smi,
              "ms": {str(c): t for c, t in ms.items()},
              "cluster_over_single": {str(c): ms["single"] / ms[c]
                                      for c in CLUSTER_CORES},
              "entry_wall_ms": {str(c): t for c, t in walls.items()}})
    if failed:
        raise SystemExit(f"chip_smoke: the cluster failed its checks: "
                         f"{failed}")

    # the locality audit: dot's one combine, relu's none (a profile of no
    # CUDA activity, after every CUDA trace of the run)
    locality = {}
    for cell, mode in (("dot", "reduce"), ("relu", "map")):
        args, kw = inputs[cell]
        chk = check_cluster_locality(
            lambda *a, e=entries[cell], k=kw: e.cluster(
                *a, cores=4, device=dev, **k), args, mode=mode, world=4)
        locality[cell] = {"ok": chk.ok, "counts": chk.counts}
    emit({"phase": "cluster_locality", "checks": locality})
    if not all(c_["ok"] for c_ in locality.values()):
        raise SystemExit(f"chip_smoke: a clustered call leaked off core: "
                         f"{locality}")


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



# The serving phase (models/, launch/steps.py, launch/serve.py): qwen3-14b
# at its published size (40 layers, d_model 5120, 40/8 heads, d_ff 17408,
# vocab 151,936, bf16: 14.8 B parameters, 29.6 GB), random weights drawn on
# the card from --seed; SERVE_BATCH prompts of SERVE_PROMPT tokens from the
# data pipeline, SERVE_GEN greedy tokens (SERVE_GEN - 1 decode steps).
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "qwen3_14b", 8, 64, 32
# (layers, d_model, heads, kv heads, d_ff, vocab, dtype) as published
SERVE_SHAPE = (40, 5120, 40, 8, 17408, 151936, "bfloat16")
# one prefill of this many tokens (batch 1) goes through flash_sdpa
SERVE_FLASH_LEN = 2048
# Published dense bf16 peak of the H100 SXM at 700 W (NVIDIA data sheet).
BF16_PEAK = {"H100 80GB HBM3": 989e12}
# Decode against teacher forcing: max |Δlogit| over the row's max |logit|.
# Decode multiplies 8 rows where the forward multiplies 760, so the card's
# GEMMs sum in other orders and a bf16 value of the residual stream may
# round the other way (2**-8 of it) in any of the 40 layers: uncorrelated,
# sqrt(40) · 2**-8 ≈ 0.025 of the logits, and 2.5 times that for the
# limit, 2**-4.  The control (the caches' first position zeroed in every
# layer) must read above it.
SERVE_TF_LIMIT = 2.0 ** -4
# flash_sdpa against _sdpa on layer 0's q, k, v at SERVE_FLASH_LEN: max |Δ|
# over max |v|.  _sdpa rounds p to bf16 before p·v (≤ 2**-9 of max |v|),
# and both round their output to bf16 (≤ 2**-9 of it each): 3 · 2**-9, so
# 2**-7.  The control, _sdpa without the causal mask, must read above it.
SERVE_FLASH_LIMIT = 2.0 ** -7
# The smoke variant on the card against the CPU from one set of weights,
# f32 with TF32 off: max |Δlogit| over the row's max |logit|.  The control,
# the card's run on the weights rounded to bf16, must read above it.
SERVE_CPU_LIMIT = 1e-5


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of max |got − want| / max |want| (the last axis)."""
    return float(((got.float() - want.float()).abs().amax(-1)
                  / want.float().abs().amax(-1)).max())


def teacher_forcing(params, cfg, prompts, res, steps, model, blocks):
    """(decode's error against one forward over the prompts and the
    generated tokens, the same with every cache's first position zeroed):
    ``row_err`` of each decode step's logits at its position."""
    seq = torch.cat([prompts["tokens"], res.tokens[:, :-1]], dim=1)
    with torch.no_grad():
        full, _, _ = model.forward(params, cfg, tokens=seq)
    want = full[:, res.start - 1:]
    err = row_err(torch.cat(res.logits, dim=1), want)
    _, caches = steps.make_prefill_step(
        cfg, cache_len=res.start + SERVE_GEN + 1)(params, prompts)
    for buf in blocks.tree_leaves(caches):     # (layers, B, slots, kv, hd)
        buf[:, :, 0].zero_()
    decode = steps.make_decode_step(cfg)
    pos = torch.full((prompts["tokens"].shape[0],), res.start,
                     dtype=torch.int32, device=seq.device)
    ctrl = []
    for t in range(SERVE_GEN - 1):
        logits, caches = decode(params, caches, res.tokens[:, t:t + 1],
                                pos + t)
        ctrl.append(logits)
    return err, row_err(torch.cat(ctrl, dim=1), want[:, 1:])


def flash_against_sdpa(params, cfg, tokens, attention, flash, layers):
    """flash_sdpa against _sdpa on layer 0's q, k, v of ``tokens`` (1, S):
    (error, the control's error against _sdpa unmasked)."""
    from torch.utils import _pytree as pytree

    lp = pytree.tree_map_only(torch.Tensor, lambda t: t[0],
                              params["groups"][0][0])
    s = tokens.shape[1]
    pos = torch.arange(s, device=tokens.device)[None]
    with torch.no_grad():
        x = layers.rms_norm(params["embed"][tokens].to(torch.bfloat16),
                            lp["norm1"], cfg.norm_eps)
        q, k, v = attention._qkv(lp["mixer"], x, cfg, pos)
        scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
        got = flash.flash_sdpa(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                               window=None, scale=scale)
        want = attention._sdpa(q, k, v, attention._mask(
            s, s, pos, pos, True, None), scale)
        unmasked = attention._sdpa(q, k, v, attention._mask(
            s, s, pos, pos, False, None), scale)
    vmax = float(v.float().abs().max())
    return (float((got.float() - want.float()).abs().max()) / vmax,
            float((got.float() - unmasked.float()).abs().max()) / vmax)


def card_against_cpu(seed, dev, configs, pipeline, steps, model,
                     arch=SERVE_ARCH):
    """The smoke variant's prefill and 4 decode steps on the card and on
    the CPU from one set of weights (drawn on the CPU), f32: (error, the
    control's: the card on the weights rounded to bf16)."""
    from torch.utils import _pytree as pytree

    cfg = configs.get_smoke(arch)
    cpu_params = model.init_params(seed, cfg, device="cpu")
    batch = pipeline.make_batch(cfg, pipeline.DataConfig(2, 16), 0,
                                device="cpu")
    batch.pop("labels")

    def run_on(params, where):
        b = {k: v.to(where) for k, v in batch.items()}
        logits, caches = steps.make_prefill_step(cfg, cache_len=21)(params, b)
        out = [logits]
        tok = torch.zeros(2, 1, dtype=torch.int32, device=where)
        for t in range(4):
            pos = torch.full((2,), 16 + t, dtype=torch.int32, device=where)
            logits, caches = steps.make_decode_step(cfg)(params, caches, tok,
                                                         pos)
            out.append(logits)
            tok = (tok * 7 + 3) % cfg.vocab_size
        return torch.cat(out, dim=1).cpu()

    want = run_on(cpu_params, "cpu")
    on_card = pytree.tree_map_only(torch.Tensor, lambda t: t.to(dev),
                                   cpu_params)
    rounded = pytree.tree_map_only(
        torch.Tensor, lambda t: t.to(torch.bfloat16).float(), on_card)
    return (row_err(run_on(on_card, dev), want),
            row_err(run_on(rounded, dev), want))


def decode_trace(fn, key: str):
    """(device kernels, Σ their time in ms) of one ``fn()`` from a
    ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    trace = os.path.join(os.environ["REPRO_SCHEDULE_CACHE"],
                         f"trace_{key}.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) \
        if isinstance(events, dict) else events
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return len(kernels), sum(float(e.get("dur", 0)) for e in kernels) / 1e3


def serve_phase(seed: int, smi: str, card: str, dev: torch.device) -> None:
    """Serve qwen3-14b at its published size through launch/serve.py's
    prefill and decode functions, after the earlier phases' tensors are
    freed; check decode against teacher forcing, flash_sdpa against _sdpa
    at 2048 positions and the smoke variant on the card against the CPU,
    each beside its control; report times, peak memory, a decode step's
    kernels and busy share, and the bounds."""
    import gc

    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.launch import serve, steps
    from repro_torch.models import attention, blocks, flash, layers, model

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    residual = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("chip_smoke: the serving phase needs TF32 off")

    cfg = configs.get(SERVE_ARCH)
    shape = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
             cfg.d_ff, cfg.vocab_size, cfg.param_dtype)
    if shape != SERVE_SHAPE:
        raise SystemExit(f"chip_smoke: {SERVE_ARCH} is not its published "
                         f"size: {shape}")
    n_params = cfg.param_count()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in blocks.tree_leaves(params))
    embed_bytes = params["embed"].numel() * params["embed"].element_size()
    prompts = pipeline.make_batch(
        cfg, pipeline.DataConfig(SERVE_BATCH, SERVE_PROMPT, seed=11), 0,
        device=dev)
    prompts.pop("labels")

    # a first run loads the kernels; the second is timed and checked
    first = serve.generate(params, cfg, prompts, gen=SERVE_GEN)
    res = serve.generate(params, cfg, prompts, gen=SERVE_GEN,
                         keep_logits=True)
    finite = all(bool(torch.isfinite(lg).all()) for lg in res.logits)
    tf_err, tf_ctrl = teacher_forcing(params, cfg, prompts, res, steps,
                                      model, blocks)

    # one more decode step (the slot after the last), timed and traced
    decode = steps.make_decode_step(cfg)
    tok = res.tokens[:, -1:]
    pos = torch.full((SERVE_BATCH,), res.start + SERVE_GEN - 1,
                     dtype=torch.int32, device=dev)
    step = lambda: decode(params, res.caches, tok, pos)  # noqa: E731
    step_ms = wall_ms(step)
    # the host's state, which sets a step's host time: the live Python
    # objects a full collection walks (the earlier phases' leave many), a
    # step timed with the collector off, and the dispatch modes on the stack
    host_state = {"python_objects": len(gc.get_objects()),
                  "dispatch_modes": torch._C._len_torch_dispatch_stack()}
    gc.disable()
    try:
        host_state["decode_step_wall_ms_gc_off"] = wall_ms(step)
    finally:
        gc.enable()
    n_kernels, kernel_ms = decode_trace(step, "serve_decode_step")
    n_kernels_again, _ = decode_trace(step, "serve_decode_step_2")

    # the flash path at full width: one prefill of SERVE_FLASH_LEN tokens
    long_tokens = pipeline.make_batch(
        cfg, pipeline.DataConfig(1, SERVE_FLASH_LEN, seed=12), 0,
        device=dev)["tokens"]
    calls = []
    inner = attention.flash_sdpa

    def counted(*a, **k):
        calls.append(a[0].shape)
        return inner(*a, **k)

    attention.flash_sdpa = counted
    try:
        prefill_long = steps.make_prefill_step(
            cfg, cache_len=SERVE_FLASH_LEN + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        long_logits, long_caches = prefill_long(params,
                                                {"tokens": long_tokens})
        torch.cuda.synchronize()
        long_s = time.perf_counter() - t0
    finally:
        attention.flash_sdpa = inner
    long_finite = bool(torch.isfinite(long_logits).all())
    del long_logits, long_caches
    flash_err, flash_ctrl = flash_against_sdpa(params, cfg, long_tokens,
                                               attention, flash, layers)
    peak = torch.cuda.max_memory_allocated()
    prefill_s, decode_s = res.prefill_s, res.decode_s
    report = serve.report(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, res)
    same_tokens = bool(torch.equal(first.tokens, res.tokens))
    last_pos = int(pos[0])
    del params, first, res, prompts, tok, pos, long_tokens
    gc.collect()
    torch.cuda.empty_cache()

    cpu_err, cpu_ctrl = card_against_cpu(seed, dev, configs, pipeline,
                                         steps, model)

    bw, _ = card_peaks(card)
    bf16 = next(v for k_, v in BF16_PEAK.items() if k_ in card)
    # a decode step reads every weight but the embedding table (its B rows
    # only) and the caches up to its position
    cache_bytes = (2 * cfg.num_layers * SERVE_BATCH * (last_pos + 1)
                   * cfg.num_kv_heads * cfg.resolved_head_dim * 2)
    decode_bytes = weight_bytes - embed_bytes + \
        SERVE_BATCH * cfg.d_model * 2 + cache_bytes
    # prefill multiplies every parameter but the embedding table's, once a
    # token (the head too: the forward takes every position's logits)
    mm_params = n_params - cfg.vocab_size * cfg.d_model
    tokens = SERVE_BATCH * SERVE_PROMPT
    checks = {
        "finite": finite and long_finite,
        "same_tokens_both_runs": same_tokens,
        "decode_vs_teacher_forcing": {"err": tf_err, "limit": SERVE_TF_LIMIT,
                                      "control_first_position_zeroed":
                                          tf_ctrl},
        "flash_vs_sdpa": {"err": flash_err, "limit": SERVE_FLASH_LIMIT,
                          "control_unmasked": flash_ctrl,
                          "flash_calls": len(calls),
                          "layers": cfg.num_layers},
        "card_vs_cpu": {"err": cpu_err, "limit": SERVE_CPU_LIMIT,
                        "control_bf16_weights": cpu_ctrl},
    }
    emit({"phase": "serve", "card": smi, "arch": cfg.name,
          "params": n_params, "weights_gib": weight_bytes / 2**30,
          "residual_gib_before": residual / 2**30, "init_s": init_s,
          "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
          "prefill_ms": prefill_s * 1e3, "prefill_tok_s": tokens / prefill_s,
          "prefill_bound_ms": 2 * mm_params * tokens / bf16 * 1e3,
          "decode_ms_step": decode_s / (SERVE_GEN - 1) * 1e3,
          "decode_tok_s": SERVE_BATCH * SERVE_GEN / decode_s,
          "decode_step_wall_ms": step_ms,
          "decode_step_kernels": n_kernels,
          "decode_step_kernels_second_trace": n_kernels_again,
          "decode_step_kernel_ms": kernel_ms,
          "decode_step_busy_share": kernel_ms / step_ms,
          "decode_step_bound_ms": decode_bytes / bw * 1e3,
          "decode_step_bytes": decode_bytes,
          "prefill_long_tokens": SERVE_FLASH_LEN,
          "prefill_long_ms": long_s * 1e3,
          "prefill_long_tok_s": SERVE_FLASH_LEN / long_s,
          "peak_gib": peak / 2**30, "host_state": host_state,
          "report": report, "checks": checks})
    bad = [name for name, ok in (
        ("finite", checks["finite"]),
        ("decode_vs_teacher_forcing", tf_err <= SERVE_TF_LIMIT < tf_ctrl),
        ("flash_vs_sdpa", flash_err <= SERVE_FLASH_LIMIT < flash_ctrl
         and len(calls) == cfg.num_layers),
        ("card_vs_cpu", cpu_err <= SERVE_CPU_LIMIT < cpu_ctrl)) if not ok]
    if bad:
        raise SystemExit(f"chip_smoke: the serving phase failed {bad}: "
                         f"{checks}")


# Phase 7b: the experts, the latent attention and the recurrent mixers at
# their published widths.  deepseek-v3 and jamba are configs.get(...) with
# every group's repeats set to 1 (smoke_variant's cut of depth): deepseek's
# first dense layer and first MoE layer (2 of 61), jamba's one 8-layer
# period (of 4); xlstm-125m runs whole (12 layers).
FAMILY_ARCHS = ("deepseek_v3_671b", "jamba_v01_52b", "xlstm_125m")
FAMILY_DEPTH_CUT = ("deepseek_v3_671b", "jamba_v01_52b")
FAMILY_CUT = {"deepseek_v3_671b": "2 of 61 layers: one (mla, mlp), one "
                                  "(mla, moe)",
              "jamba_v01_52b": "one 8-layer period of 4: 7 Mamba, 1 "
                               "attention, 4 MoE",
              "xlstm_125m": "none: 12 layers, 10 mLSTM, 2 sLSTM"}
# Decode against teacher forcing, max |Δlogit| over the row's max |logit|
# on the rows no routing flip reaches.  √L · 2**-8 · 2.5 (phase 7's
# derivation) gives 0.014, 0.028 and 0.034 for 2, 8 and 12 layers; the
# absorbed MLA decode rounds q·W_uk to bf16 where the forward rounds
# ckv·W_uk, and an mLSTM layer's normaliser amplifies a difference in its
# input several times (tests/test_torch_models.py::logits_limit), so phase
# 7's 2**-4 holds for all three.  The control (the first position of every
# attention or latent cache zeroed, every recurrent state zeroed) must read
# above it.
FAMILY_TF_LIMIT = 2.0 ** -4
# xlstm-125m's check runs on an f32 copy of its weights: in bf16 the
# reference's own decode reads 0.16-0.31 of max |logit| from its own
# forward (7 steps after a 64-token prefill, on the CPU), its mLSTM
# normalisers amplifying bf16 roundings, where in f32 it reads 2.6e-4.
# The f32 limit is 2**-8, 15 times that reading.
FAMILY_TF_F32 = {"xlstm_125m": 2.0 ** -8}
# At least this share of the compared positions must stay in the check
# once the positions that routing flips reach are left out.
FAMILY_MIN_CHECKED = 1 / 8
# Routing flips.  A token's top-k set can differ between decode and the
# forward from one bf16 rounding of the router's input: the residual
# stream differs by a bf16 ulp in a share of its elements, which moves a
# logit by about 2**-9 · sqrt(0.2 · d) / sqrt(d) ≈ 1e-3 of its N(0, 1)
# scale, against a gap between the k-th and (k+1)-th of e logits of about
# 0.06 (deepseek: 8th of 256) and 0.4 (jamba: 2nd of 16): a flip a token
# with a chance of ~3 % (deepseek) and ~0.5 % a layer (jamba, 4 layers).
# The cap is 10 % of the tokens (prompt and generated), about three times
# the larger.
FAMILY_FLIP_CAP = 0.1
# mla_full's flash path against _sdpa on layer 0's q, k, v at 2048
# positions (q·k over 192 dims, v 128): phase 7's SERVE_FLASH_LIMIT.
FAMILY_FLASH_ARCH, FAMILY_FLASH_LEN = "deepseek_v3_671b", 2048


def family_config(configs, arch: str):
    """``configs.get(arch)``, every group's repeats set to 1 where the
    depth is cut."""
    cfg = configs.get(arch)
    if arch not in FAMILY_DEPTH_CUT:
        return cfg
    return dataclasses.replace(cfg, groups=tuple(
        dataclasses.replace(g, repeats=1) for g in cfg.groups))


def mlstm_layers(cfg) -> int:
    return sum(g.repeats * sum(m == "mlstm" for m, _ in g.pattern)
               for g in cfg.groups)


def moe_layers(cfg):
    """Per MoE block in layer order: whether a mixer follows it (a
    difference at one position then reaches every later position)."""
    seq = [f for g in cfg.groups for _ in range(g.repeats)
           for _, f in g.pattern]
    return [i < len(seq) - 1 for i, f in enumerate(seq) if f == "moe"]


class RecordMoE:
    """Records every ``moe_apply`` call's input and router while active."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        inner = self.inner = self.moe.moe_apply

        def recording(params, x, cfg):
            self.calls.append((x, params["router"]))
            return inner(params, x, cfg)

        self.moe.moe_apply = recording
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply = self.inner


def routed_sets(moe, x, router, m):
    """(B, S, k) sorted expert ids of x (B, S, D) from the port's _route."""
    _, ids, _, _ = moe._route(x.reshape(-1, x.shape[-1]), router, m)
    return torch.sort(ids, dim=-1).values.reshape(*x.shape[:2], -1)


def dropped_shares(moe, calls, m):
    """The share of each call's dispatch slots past its capacity."""
    out = []
    for x, router in calls:
        n = x.shape[0] * x.shape[1]
        _, ids, _, _ = moe._route(x.reshape(n, -1), router, m)
        pos = moe._positions_in_expert(ids.reshape(-1), m.num_experts)
        out.append(float((pos >= moe.capacity(n, m)).float().mean()))
    return out


def zero_state(caches):
    """The control: every attention or latent cache's first position
    zeroed, every recurrent state zeroed, in place."""
    from torch.utils import _pytree as pytree
    for path, leaf in pytree.tree_flatten_with_path(caches)[0]:
        if path[-1].key in ("k", "v", "lat"):
            leaf[:, :, 0].zero_()        # (layers, B, slots, ...)
        else:
            leaf.zero_()


def family_teacher_forcing(params, cfg, prompts, gen, serve, steps, model,
                           moe, limit=FAMILY_TF_LIMIT):
    """Decode at an ample capacity (factor e / k: no slot drops at either
    token count) against one teacher-forced forward over the prompts and
    the generated tokens: the error on the compared positions no routing
    flip reaches, the control's on all, the tokens whose top-k set differs
    in any MoE layer (prompt and generated) and the compared positions
    left out."""
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    with RecordMoE(moe) as run:
        res = serve.generate(params, cfg, prompts, gen=gen,
                             keep_logits=True)
    seq = torch.cat([prompts["tokens"], res.tokens[:, :-1]], dim=1)
    with RecordMoE(moe) as fwd, torch.no_grad():
        full, _, _ = model.forward(params, cfg, tokens=seq)
    b, start = seq.shape[0], res.start
    want = full[:, start - 1:]                       # (B, gen, V)
    got = torch.cat(res.logits, dim=1)
    err = ((got - want).abs().amax(-1) / want.abs().amax(-1))  # (B, gen)
    left_out = torch.zeros((b, gen), dtype=torch.bool, device=seq.device)
    flipped = torch.zeros(seq.shape, dtype=torch.bool, device=seq.device)
    follows = moe_layers(cfg)
    if follows:
        n = len(follows)
        # the run's calls: prefill's n, then n a decode step
        for i, mixes in enumerate(follows):
            ran = torch.cat([x for x, _ in run.calls[i::n]], dim=1)
            want_sets = routed_sets(moe, fwd.calls[i][0], fwd.calls[i][1],
                                    cfg.moe)[:, :ran.shape[1]]
            flip = (routed_sets(moe, ran, run.calls[i][1], cfg.moe)
                    != want_sets).any(-1)            # (B, positions)
            flipped |= flip
            # a flip reaches the logits at its own position, and at every
            # later one where a mixer follows its layer
            hit = flip.cumsum(1) > 0 if mixes else flip
            left_out |= hit[:, start - 1:start - 1 + gen]
    tf_err = float(err[~left_out].max()) if bool((~left_out).any()) \
        else float("inf")
    # every position left out is printed, with the error it reads
    out_rows = {str(r): [start - 1 + int(t) for t in
                         left_out[r].nonzero().flatten()]
                for r in range(b) if bool(left_out[r].any())}
    out_err = float(err[left_out].max()) if bool(left_out.any()) else None
    _, caches = steps.make_prefill_step(cfg, cache_len=start + gen + 1)(
        params, prompts)
    zero_state(caches)
    decode = steps.make_decode_step(cfg)
    pos = torch.full((b,), start, dtype=torch.int32, device=seq.device)
    ctrl = []
    for t in range(gen - 1):
        logits, caches = decode(params, caches, res.tokens[:, t:t + 1],
                                pos + t)
        ctrl.append(logits)
    ctrl_err = row_err(torch.cat(ctrl, dim=1), want[:, 1:])
    return {"err": tf_err, "limit": limit, "dtype": cfg.param_dtype,
            "control_state_zeroed": ctrl_err,
            "flipped_tokens": int(flipped.sum()), "tokens": flipped.numel(),
            "flip_cap": FAMILY_FLIP_CAP, "compared_tokens": b * gen,
            "compared_left_out": int(left_out.sum()),
            "left_out_positions": out_rows, "left_out_err": out_err}


def mla_flash_against_sdpa(params, cfg, tokens, attention, flash, layers):
    """mla_full's flash_sdpa against _sdpa on layer 0's q, k, v (q·k over
    the rope-folded 192 dims, v 128): (error, the control's: _sdpa
    unmasked), over max |v|."""
    from torch.utils import _pytree as pytree

    lp = pytree.tree_map_only(torch.Tensor, lambda t: t[0],
                              params["groups"][0][0])
    m, h = cfg.mla, cfg.num_heads
    s = tokens.shape[1]
    pos = torch.arange(s, device=tokens.device)[None]
    with torch.no_grad():
        x = layers.rms_norm(params["embed"][tokens].to(torch.bfloat16),
                            lp["norm1"], cfg.norm_eps)
        q_nope, q_rope, ckv, kr = attention._mla_qkr(lp["mixer"], x, cfg,
                                                     pos)
        k_nope = layers.dot(ckv, lp["mixer"]["wuk"]).reshape(
            1, s, h, m.qk_nope_head_dim)
        v = layers.dot(ckv, lp["mixer"]["wuv"]).reshape(1, s, h,
                                                        m.v_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, kr[:, :, None].expand(
            1, s, h, m.qk_rope_head_dim)], dim=-1)
        scale = 1.0 / math.sqrt(m.qk_head_dim)
        got = flash.flash_sdpa(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                               window=None, scale=scale)
        want = attention._sdpa(q, k, v, attention._mask(
            s, s, pos, pos, True, None), scale)
        unmasked = attention._sdpa(q, k, v, attention._mask(
            s, s, pos, pos, False, None), scale)
    vmax = float(v.float().abs().max())
    return (float((got.float() - want.float()).abs().max()) / vmax,
            float((got.float() - unmasked.float()).abs().max()) / vmax,
            (q.shape[-1], v.shape[-1]))


def family_bounds(cfg, params, caches, n_params, tokens, card, blocks,
                  moe):
    """(prefill bound ms, decode step bound ms, decode step bytes).

    Prefill: the larger of its products' operations over the dense bf16
    peak (2 · the multiplied non-expert parameters a token, and every
    expert's (capacity, d) buffer through its three products, as the
    dense-capacity dispatch computes them) and its weights read once.  A
    decode step reads every weight but the embedding table's rows (every
    expert's too: the dispatch multiplies all e buffers, routed or not)
    and every cache whole, and writes the recurrent state back."""
    from torch.utils import _pytree as pytree

    bw, _ = card_peaks(card)
    bf16 = next(v for k_, v in BF16_PEAK.items() if k_ in card)
    leaves = pytree.tree_flatten_with_path(params)[0]
    expert = sum(t.numel() for p, t in leaves
                 if t is not None and "experts" in pytree.keystr(p))
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in blocks.tree_leaves(params))
    embed = params["embed"]
    flops = 2 * (n_params - expert - embed.numel()
                 + (embed.numel() if cfg.tie_embeddings else 0)) * tokens
    if cfg.moe is not None:
        m = cfg.moe
        c = moe.capacity(tokens, m)
        n_moe = len(moe_layers(cfg))
        flops += n_moe * 2 * 3 * cfg.d_model * m.d_expert * m.num_experts * c
    prefill_ms = max(flops / bf16, (weight_bytes - embed.numel()
                                    * embed.element_size()) / bw) * 1e3
    state = 0
    cache_bytes = 0
    for p, t in pytree.tree_flatten_with_path(caches)[0]:
        nbytes = t.numel() * t.element_size()
        cache_bytes += nbytes
        if p[-1].key not in ("k", "v", "lat"):
            state += nbytes
    b = next(t for t in blocks.tree_leaves(caches)).shape[1]
    decode_bytes = (weight_bytes - embed.numel() * embed.element_size()
                    + b * cfg.d_model * embed.element_size() + cache_bytes
                    + state)
    return prefill_ms, decode_bytes / bw * 1e3, decode_bytes


def families_phase(seed: int, smi: str, card: str,
                   dev: torch.device) -> None:
    """Phase 7b: serve deepseek-v3 (2 layers), jamba (one period) and
    xlstm-125m (whole) at their published widths through launch/serve.py,
    one config at a time (the previous one's tensors freed); check every
    logit finite, decode against teacher forcing at an ample capacity (the
    tokens a routing flip reaches left out and counted; xlstm in f32),
    mla_full's flash
    path against _sdpa at 2048 positions (deepseek) and each smoke variant
    on the card against the CPU, each beside its control; report the
    ``serve_families`` line."""
    import gc

    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.launch import serve, steps
    from repro_torch.models import (attention, blocks, flash, layers, model,
                                    moe)

    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("chip_smoke: phase 7b needs TF32 off")
    rows, bad = [], []
    for arch in FAMILY_ARCHS:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        residual = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cfg = family_config(configs, arch)
        n_params = cfg.param_count()
        t0 = time.perf_counter()
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in blocks.tree_leaves(params))
        prompts = pipeline.make_batch(
            cfg, pipeline.DataConfig(SERVE_BATCH, SERVE_PROMPT, seed=11), 0,
            device=dev)
        prompts.pop("labels")

        # a first run, recorded: the MoE calls' dropped shares at the
        # published capacity; the second is timed
        with RecordMoE(moe) as rec:
            first = serve.generate(params, cfg, prompts, gen=SERVE_GEN)
        dropped = {}
        if cfg.moe is not None:
            shares = dropped_shares(moe, rec.calls, cfg.moe)
            n = len(moe_layers(cfg))
            dropped = {"capacity_factor": cfg.moe.capacity_factor,
                       "prefill": shares[:n],
                       "decode_steps": [shares[i:i + n] for i in
                                        range(n, len(shares), n)]}
        del rec
        res = serve.generate(params, cfg, prompts, gen=SERVE_GEN,
                             keep_logits=True)
        finite = all(bool(torch.isfinite(lg).all()) for lg in res.logits)
        same_tokens = bool(torch.equal(first.tokens, res.tokens))
        del first

        decode = steps.make_decode_step(cfg)
        tok = res.tokens[:, -1:]
        pos = torch.full((SERVE_BATCH,), res.start + SERVE_GEN - 1,
                         dtype=torch.int32, device=dev)
        step = lambda: decode(params, res.caches, tok, pos)  # noqa: E731
        step_ms = wall_ms(step)
        n_kernels, kernel_ms = decode_trace(step, f"families_{arch}")
        prefill_bound, decode_bound, decode_bytes = family_bounds(
            cfg, params, res.caches, n_params, SERVE_BATCH * SERVE_PROMPT,
            card, blocks, moe)
        report = serve.report(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, res)
        prefill_s, decode_s = res.prefill_s, res.decode_s
        del res, step
        gc.collect()

        if arch in FAMILY_TF_F32:
            from torch.utils import _pytree as pytree
            tf = family_teacher_forcing(
                pytree.tree_map_only(torch.Tensor, lambda t: t.float(),
                                     params),
                dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32"),
                prompts, SERVE_GEN, serve, steps, model, moe,
                limit=FAMILY_TF_F32[arch])
        else:
            tf = family_teacher_forcing(params, cfg, prompts, SERVE_GEN,
                                        serve, steps, model, moe)
        checks = {"finite": finite, "same_tokens_both_runs": same_tokens,
                  "decode_vs_teacher_forcing": tf}
        ok = finite and tf["err"] <= tf["limit"] \
            < tf["control_state_zeroed"] \
            and tf["flipped_tokens"] <= FAMILY_FLIP_CAP * tf["tokens"] \
            and tf["compared_left_out"] <= (1 - FAMILY_MIN_CHECKED) * tf[
                "compared_tokens"]
        extra = {}
        if arch == FAMILY_FLASH_ARCH:
            long_tokens = pipeline.make_batch(
                cfg, pipeline.DataConfig(1, FAMILY_FLASH_LEN, seed=12), 0,
                device=dev)["tokens"]
            calls = []
            inner = attention.flash_sdpa

            def counted(*a, **k):
                calls.append(tuple(a[0].shape))
                return inner(*a, **k)

            attention.flash_sdpa = counted
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                long_logits, long_caches = steps.make_prefill_step(
                    cfg, cache_len=FAMILY_FLASH_LEN + 1)(
                    params, {"tokens": long_tokens})
                torch.cuda.synchronize()
                long_s = time.perf_counter() - t0
            finally:
                attention.flash_sdpa = inner
            long_finite = bool(torch.isfinite(long_logits).all())
            del long_logits, long_caches
            f_err, f_ctrl, dims = mla_flash_against_sdpa(
                params, cfg, long_tokens, attention, flash, layers)
            checks["flash_vs_sdpa"] = {
                "err": f_err, "limit": SERVE_FLASH_LIMIT,
                "control_unmasked": f_ctrl, "flash_calls": len(calls),
                "layers": cfg.num_layers, "qk_dim": dims[0],
                "v_dim": dims[1], "finite": long_finite}
            extra = {"prefill_long_tokens": FAMILY_FLASH_LEN,
                     "prefill_long_ms": long_s * 1e3,
                     "prefill_long_tok_s": FAMILY_FLASH_LEN / long_s}
            ok = ok and long_finite and f_err <= SERVE_FLASH_LIMIT < f_ctrl \
                and len(calls) == cfg.num_layers and dims == (192, 128)
        peak = torch.cuda.max_memory_allocated()
        del params, prompts, tok, pos
        gc.collect()
        torch.cuda.empty_cache()

        cpu_err, cpu_ctrl = card_against_cpu(seed, dev, configs, pipeline,
                                             steps, model, arch=arch)
        # an mLSTM layer amplifies a difference in its input several times
        # (tests/test_torch_models.py::logits_limit): the limit a layer
        cpu_limit = SERVE_CPU_LIMIT * max(1, mlstm_layers(
            configs.get_smoke(arch)))
        checks["card_vs_cpu"] = {"err": cpu_err, "limit": cpu_limit,
                                 "control_bf16_weights": cpu_ctrl}
        ok = ok and cpu_err <= cpu_limit < cpu_ctrl
        tokens = SERVE_BATCH * SERVE_PROMPT
        rows.append({
            "arch": cfg.name, "cut": FAMILY_CUT[arch],
            "layers": cfg.num_layers, "params": n_params,
            "weights_gib": weight_bytes / 2**30, "init_s": init_s,
            "init_peak_gib": init_peak / 2**30,
            "residual_gib_before": residual / 2**30,
            "prefill_ms": prefill_s * 1e3,
            "prefill_tok_s": tokens / prefill_s,
            "prefill_bound_ms": prefill_bound,
            "decode_ms_step": decode_s / (SERVE_GEN - 1) * 1e3,
            "decode_tok_s": SERVE_BATCH * SERVE_GEN / decode_s,
            "decode_step_wall_ms": step_ms,
            "decode_step_kernels": n_kernels,
            "decode_step_kernel_ms": kernel_ms,
            "decode_step_busy_share": kernel_ms / step_ms,
            "decode_step_bound_ms": decode_bound,
            "decode_step_bytes": decode_bytes,
            "decode_bound_reads": "every weight but the embedding rows, "
                                  "every expert's included (the dense-"
                                  "capacity dispatch multiplies all e "
                                  "buffers each step), the caches whole, "
                                  "the recurrent state written back",
            "dropped_share": dropped, "peak_gib": peak / 2**30,
            "report": report, "checks": checks, "ok": ok, **extra})
        if not ok:
            bad.append(arch)
    emit({"phase": "serve_families", "card": smi, "batch": SERVE_BATCH,
          "prompt": SERVE_PROMPT, "gen": SERVE_GEN, "configs": rows})
    if bad:
        raise SystemExit(f"chip_smoke: phase 7b failed on {bad}")


# Phase 7c: training (optim/, launch/steps.py's train step with remat,
# checkpoint/, runtime/fault.py, launch/train.py).  h2o-danube-1.8b at its
# published size trains through launch/train.py's step at the CLI's
# defaults, with weights drawn on the card from --seed.
TRAIN_ARCH = "h2o_danube_18b"
# (layers, d_model, heads, kv heads, head dim, d_ff, vocab, window, dtype)
TRAIN_SHAPE = (24, 2560, 32, 8, 80, 6912, 32000, 4096, "bfloat16")
# launch/train.py's defaults: batch, sequence, peak lr (warmup 10 steps)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 8, 128, 3e-4
# The loss falls: the first step's loss less the mean of the last
# TRAIN_TAIL by at least TRAIN_LOSS_DROP nats (examples/train_e2e.py's
# LEARNED margin).  The control, the untrained weights' loss on those last
# batches, must fall by less: the fall is the training's, not easier data.
TRAIN_TAIL, TRAIN_LOSS_DROP = 5, 0.5
# One step at the long shape: batch, sequence, microbatches (flash_sdpa
# and the f32 accumulator under remat).
TRAIN_LONG = (2, 4096, 2)
# Gradient checks on the trained weights, a batch of GRAD_BATCH ×
# GRAD_SEQ.  On an f32 copy: ⟨g, d⟩ for d ~ N(0, 1) scaled to each leaf's
# RMS against central differences (L(θ + εd) − L(θ − εd)) / 2ε at
# ε = GRAD_EPS and ε/2, extrapolated to cancel their O(ε²) term, relative
# to that derivative: the loss (~8) rounds at ~1e-6 against differences of
# ~5e-4, a few 1e-3 at most, so GRAD_FD_LIMIT = 5e-3 (at ε alone the smoke
# variant reads 1.1e-2 on the CPU, its curvature term; the extrapolation
# reads 5.5e-4 on danube).  The bf16 gradients against the f32 copy's, per
# layer's tensor, as ‖g_bf16 − g_f32‖ / ‖g_f32‖: 0.012 at the median,
# 0.21 at the worst (a last layer's wq: a small gradient through the
# softmax's Jacobian, where the bf16 logits' rounding against their spread
# is largest), so GRAD_BF16_LIMIT = 1/2.  Controls: the last layer's
# gradient zeroed, and the opposite sign.
GRAD_BATCH, GRAD_SEQ, GRAD_EPS = 2, 128, 1e-2
GRAD_FD_LIMIT = 5e-3
GRAD_BF16_LIMIT = 2.0 ** -1
# The smoke variants' train step on the card against the CPU, from one
# state (weights drawn on the CPU, moments carried at each leaf's
# gradient scale, count 3, lr 1e-2): per leaf, |Δ| over the CPU step's
# largest |update| (params) or |value| (moments).  f32, TF32 off:
# SERVE_CPU_LIMIT (times the mLSTM layers) plus two f32 ulps of the
# leaf's largest |p|.  bf16: TRAIN_BF16_CPU_LIMIT beyond one bf16 ulp of
# each element (the card's products sum in other orders, so a bf16 value
# may round the other way; the CPU upcasts, as the reference computes its
# f32-output products and their gradients): xlstm's reads 4.2e-4 (its
# mLSTM layers amplify such a flip), the others 2.0e-4 or less, so
# 2**-10.  Control: the card's step on another batch, above the limit on
# the params, the first and the second moments (each's worst leaf); it
# moves m by a tenth of a gradient's change, ~2**-5 of its largest value.
TRAIN_BF16_CPU_LIMIT = 2.0 ** -10
# Restart exactness on xlstm-125m whole: RESTART_STEPS steps at the CLI's
# batch and sequence, once clean and once with failures at RESTART_FAILS,
# checkpointing every RESTART_EVERY steps (keep RESTART_KEEP) under
# build/, with torch.use_deterministic_algorithms(True).
RESTART_ARCH, RESTART_STEPS, RESTART_FAILS = "xlstm_125m", 10, (3, 7)
RESTART_EVERY, RESTART_KEEP = 2, 2


def state_bytes(tree, keypaths) -> int:
    return sum(t.numel() * t.element_size() for t in keypaths.leaves(tree))


def layer_slices(tree, cfg, keypaths):
    """{name: tensor} of a parameter tree, a stacked leaf split into its
    layers (``groups/0/0/mixer/wq[23]``)."""
    out = {}
    for path, t in keypaths.leaves_with_path(tree):
        key = keypaths.key(path)
        if path[0] == "groups":
            for r in range(t.shape[0]):
                out[f"{key}[{r}]"] = t[r]
        else:
            out[key] = t
    return out


def rel_l2(got, want) -> float:
    w = want.double()
    return float(torch.linalg.vector_norm(got.double() - w)
                 / torch.linalg.vector_norm(w).clamp_min(1e-300))


def gradient_checks(seed, dev, params, cfg, keypaths, pipeline, steps,
                    model):
    """The bf16 gradients against an f32 copy's, and the f32 copy's
    directional derivative against a central difference, each beside its
    controls (``GRAD_*``)."""
    batch = pipeline.make_batch(
        cfg, pipeline.DataConfig(GRAD_BATCH, GRAD_SEQ, seed=13), 0,
        device=dev)
    _, g16 = steps._value_and_grad(params, cfg, batch)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = keypaths.map_with_path(lambda _, p: p.float(), params)
    loss32, g32 = steps._value_and_grad(p32, cfg32, batch)
    last = cfg.groups[-1].repeats - 1
    s16, s32 = layer_slices(g16, cfg, keypaths), layer_slices(g32, cfg,
                                                              keypaths)
    per = {k: rel_l2(s16[k], s32[k]) for k in s32}
    norms = {k: float(torch.linalg.vector_norm(s32[k].double()))
             for k in s32}
    zeroed = {k: (rel_l2(torch.zeros_like(s16[k]), s32[k])
                  if k.endswith(f"[{last}]") else v)
              for k, v in per.items()}
    opposite = {k: rel_l2(-s16[k], s32[k]) for k in s32}
    worst = max(per, key=per.get)
    del g16, s16

    gen_seed = seed + 7
    scales = [float(p.float().pow(2).mean().sqrt()) for p in
              keypaths.leaves(p32)]

    def walk(fn):
        gen = torch.Generator(device=dev).manual_seed(gen_seed)
        for p, s in zip(keypaths.leaves(p32), scales):
            fn(p, torch.randn(p.shape, generator=gen, device=dev) * s)

    gd = [0.0, 0.0]                     # ⟨g, d⟩, the last layer's share
    gl = iter(keypaths.leaves_with_path(g32))

    def dot(p, d):
        path, g = next(gl)
        gd[0] += float(torch.sum(g.double() * d.double()))
        if path[0] == "groups" and len(path) > 1 and \
                path[1] == len(cfg.groups) - 1:
            gd[1] += float(torch.sum(g[last].double() * d[last].double()))

    walk(dot)
    del g32, s32

    def loss_at(sign):
        walk(lambda p, d: p.add_(sign * GRAD_EPS * d))
        with torch.no_grad():
            lv, _ = model.loss_fn(p32, cfg32, batch)
        return float(lv)

    # central differences at ε and ε/2, extrapolated (Richardson):
    # (4·D(ε/2) − D(ε)) / 3 cancels the O(ε²) term
    at = {}
    for eps, signs in ((GRAD_EPS, (1.0, -2.0, 1.0)),
                       (GRAD_EPS / 2, (0.5, -1.0, 0.5))):
        plus, minus = loss_at(signs[0]), loss_at(signs[1])
        walk(lambda p, d: p.add_(signs[2] * GRAD_EPS * d))
        at[eps] = (plus - minus) / (2 * eps)
    fd = (4 * at[GRAD_EPS / 2] - at[GRAD_EPS]) / 3
    err = abs(gd[0] - fd) / abs(fd)
    ctrl_zero = abs(gd[0] - gd[1] - fd) / abs(fd)
    ctrl_sign = abs(-gd[0] - fd) / abs(fd)
    return {
        "batch": [GRAD_BATCH, GRAD_SEQ], "loss_f32": float(loss32),
        "directional": {"g_dot_d": gd[0], "central_difference": fd,
                        "at_eps": at[GRAD_EPS],
                        "at_half_eps": at[GRAD_EPS / 2],
                        "eps": GRAD_EPS, "err": err,
                        "limit": GRAD_FD_LIMIT,
                        "control_last_layer_zeroed": ctrl_zero,
                        "control_opposite_sign": ctrl_sign},
        "bf16_vs_f32": {"tensors": len(per), "err": per[worst],
                        "worst_tensor": worst, "limit": GRAD_BF16_LIMIT,
                        "median": statistics.median(per.values()),
                        "worst5": [[k, per[k], norms[k]] for k in sorted(
                            per, key=per.get)[-5:]],
                        "control_last_layer_zeroed": max(zeroed.values()),
                        "control_opposite_sign": min(opposite.values())},
    }


def carried_state(params, grads, keypaths, seed: int):
    """A train state holding ``params``, moments carried at each leaf's
    gradient scale s (its RMS in ``grads``: m ~ N(0, s²),
    v ~ s² · U[1/2, 3/2]) and count 3, drawn on the CPU: a step is then a
    smooth function of the gradient (from zero moments the first update
    is g / (|g| + ε), whose sign flips for a gradient within its rounding
    of 0)."""
    gen = torch.Generator().manual_seed(seed)
    rms = {keypaths.key(p): float(g.float().pow(2).mean().sqrt()) + 1e-12
           for p, g in keypaths.leaves_with_path(grads)}
    m = keypaths.map_with_path(lambda path, p: torch.randn(
        p.shape, generator=gen) * rms[keypaths.key(path)], params)
    v = keypaths.map_with_path(lambda path, p: (torch.rand(
        p.shape, generator=gen) + 0.5) * rms[keypaths.key(path)] ** 2,
        params)
    return {"params": params, "opt": {
        "m": m, "v": v, "count": torch.tensor(3, dtype=torch.int32)}}


def step_errors(want, got, old, limit: float, bf16: bool, keypaths):
    """{leaf: (err, limit)} of a train state ``got`` against ``want`` (both
    on the CPU): params over ``want``'s largest |update| beyond two f32
    ulps of its largest |p| (bf16: beyond one bf16 ulp of each element),
    moments over their largest |value|."""
    out = {}
    for (path, g), w in zip(keypaths.leaves_with_path(got),
                            keypaths.leaves(want)):
        k = keypaths.key(path)
        if k == "opt/count":
            continue
        w64, g64 = w.double(), g.double()
        d = (g64 - w64).abs()
        if path[0] == "params":
            scale = float((w64 - old[k].double()).abs().max())
            if bf16:
                ulp = torch.exp2(torch.floor(torch.log2(
                    w64.abs().clamp_min(1e-30))) - 7)
                d = (d - ulp).clamp_min(0.0)
                allow = 0.0
            else:
                top = max(float(w64.abs().max()), 1e-30)
                allow = 2 * 2.0 ** (math.floor(math.log2(top)) - 23)
        else:
            scale, allow = float(w64.abs().max()), 0.0
        out[k] = (float(d.max()), scale * limit + allow)
    return out


def train_card_against_cpu(seed, dev, arch, dtype, configs, keypaths,
                           pipeline, steps, model, adamw):
    """One train step of ``arch``'s smoke variant in ``dtype`` on the card
    and on the CPU from one state: {"err": the worst leaf's error over its
    limit, "control": the card's step on another batch, the worst leaf of
    the params, of m and of v, each over its limit} (see
    ``TRAIN_BF16_CPU_LIMIT``)."""
    cfg = dataclasses.replace(configs.get_smoke(arch), param_dtype=dtype,
                              compute_dtype=dtype)
    opt = adamw.AdamWConfig(learning_rate=1e-2)
    params = model.init_params(seed, cfg, device="cpu")
    batches = [pipeline.make_batch(cfg, pipeline.DataConfig(2, 16), s,
                                   device="cpu") for s in (0, 1)]
    base = carried_state(params, steps._value_and_grad(
        params, cfg, batches[0])[1], keypaths, seed + 1)
    old = {keypaths.key(p): t.clone()
           for p, t in keypaths.leaves_with_path(base)}

    def run(where, b):
        st = keypaths.map_with_path(lambda _, t: t.clone().to(where), base)
        batch = {k: v.to(where) for k, v in b.items()}
        steps.make_train_step(cfg, opt)(st["params"], st["opt"], batch)
        return keypaths.map_with_path(lambda _, t: t.cpu(), st)

    mlstm = max(1, mlstm_layers(cfg))
    limit = SERVE_CPU_LIMIT * mlstm if dtype == "float32" \
        else TRAIN_BF16_CPU_LIMIT
    want = run("cpu", batches[0])
    errs = step_errors(want, run(dev, batches[0]), old, limit,
                       dtype != "float32", keypaths)
    ctrls = step_errors(want, run(dev, batches[1]), old, limit,
                        dtype != "float32", keypaths)
    ratio = {k: e / lim for k, (e, lim) in errs.items()}
    cr = {k: e / lim for k, (e, lim) in ctrls.items()}
    worst = max(ratio, key=ratio.get)
    return {"arch": cfg.name, "dtype": dtype, "limit": limit,
            "err": ratio[worst], "worst_leaf": worst,
            "control": {part: max(v for k, v in cr.items()
                                  if k.startswith(part))
                        for part in ("params", "opt/m", "opt/v")}}


def restart_exactness(seed, dev, root, configs, keypaths, pipeline, steps,
                      train):
    """xlstm-125m: RESTART_STEPS steps clean and with failures, under
    deterministic algorithms; the final params to the bit (or, where an
    op has no deterministic CUDA kernel, named, within the f32 rounding of
    its largest |p|), beside the clean run's checkpoint two steps before
    the end, which must differ; save and restore seconds."""
    import warnings

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.runtime.fault import FailureInjector, Supervisor

    cfg = configs.get(RESTART_ARCH)
    opt = train.optimizer(cfg, TRAIN_LR, RESTART_STEPS)
    dcfg = pipeline.DataConfig(TRAIN_BATCH, TRAIN_SEQ)
    base = tempfile.mkdtemp(prefix="chip_smoke_restart_", dir=root / "build")
    step_s = []

    def run(fail_at, name):
        st = steps.init_train_state(
            torch.Generator(device=dev).manual_seed(seed), cfg, opt,
            device=dev)
        sup = Supervisor(ckpt=CheckpointManager(os.path.join(base, name),
                                                keep=RESTART_KEEP),
                         checkpoint_every=RESTART_EVERY,
                         injector=FailureInjector(fail_at_steps=fail_at))
        inner = train.make_step_fn(cfg, opt, dcfg, microbatches=1,
                                   device=dev,
                                   on_metrics=lambda s, m: None)

        def timed(state, step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(state, step)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out

        return sup.run(st, timed, RESTART_STEPS), sup

    # cuBLAS is deterministic on one stream with a fixed workspace; this is
    # the setting torch asks for before it calls it so
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            clean, _ = run((), "clean")
            faulty, sup = run(RESTART_FAILS, "faulty")
        nondet = sorted({str(w.message).split(" does not have")[0][:160]
                         for w in caught
                         if "deterministic" in str(w.message)})
        mgr = CheckpointManager(os.path.join(base, "clean"),
                                keep=RESTART_KEEP)
        t0 = time.perf_counter()
        before = mgr.restore(RESTART_STEPS - RESTART_EVERY, clean)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        CheckpointManager(os.path.join(base, "timed"), keep=1).save(
            RESTART_STEPS, clean)
        save_s = time.perf_counter() - t0
        save_bytes = state_bytes(clean, keypaths)
        pairs = list(zip(keypaths.leaves(clean["params"]),
                         keypaths.leaves(faulty["params"])))
        bits = all(bits_equal(a, b) for a, b in pairs)
        # where an op runs without a deterministic kernel: its f32 sums
        # may round otherwise, one ulp of the leaf's largest |p| a step
        dev_ulps = max(float((a.float() - b.float()).abs().max())
                       / 2.0 ** (math.floor(math.log2(max(float(
                           a.float().abs().max()), 1e-30))) - 23)
                       for a, b in pairs)
        ctrl_equal = all(bits_equal(a, b) for a, b in zip(
            keypaths.leaves(clean["params"]),
            keypaths.leaves(before["params"])))
        ok = (bits if not nondet else dev_ulps <= RESTART_STEPS) \
            and not ctrl_equal and sup.restarts == len(RESTART_FAILS)
        return {"arch": cfg.name, "params": cfg.param_count(),
                "steps": RESTART_STEPS, "fail_at": list(RESTART_FAILS),
                "checkpoint_every": RESTART_EVERY, "keep": RESTART_KEEP,
                "restarts": sup.restarts, "events": sup.events,
                "bits_equal": bits, "max_ulps_of_leaf_max": dev_ulps,
                "nondeterministic_ops": nondet,
                "control_checkpoint_two_steps_before_equal": ctrl_equal,
                "checkpoint_gib": save_bytes / 2**30,
                "save_s": save_s, "restore_s": restore_s,
                "step_ms_median": statistics.median(step_s) * 1e3,
                "ok": ok}
    finally:
        torch.use_deterministic_algorithms(False)
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
        shutil.rmtree(base, ignore_errors=True)


def long_step_reckoning(cfg, n_params, state_b, tokens_mb, blocks) -> dict:
    """What a long step holds at once, reckoned from the shapes (bytes):
    the train state, the f32 accumulator, one microbatch's bf16
    gradients, the layer boundaries the √R remat keeps (R/g outer and g
    inner inputs, bf16), one layer's recomputed activations (q, k, v and
    the attention output in bf16; SwiGLU's gate and up products in f32,
    their product and the layer's input in bf16), and the head's f32
    logits with their log-softmax and gradient.  The head's terms and the
    last microbatch's gradients need not all be live at the peak."""
    r = cfg.groups[0].repeats
    g = blocks._layer_chunk(r)
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    attn = tokens_mb * (cfg.num_heads + 2 * cfg.num_kv_heads
                        + cfg.num_heads) * hd * 2
    ffn = tokens_mb * (2 * f * 4 + f * 2 + d * 2)
    parts = {"state": state_b, "accumulator_f32": n_params * 4,
             "gradients_bf16": n_params * 2,
             "layer_boundaries": (r // g + g) * tokens_mb * d * 2,
             "one_layer": attn + ffn,
             "head": 3 * tokens_mb * cfg.vocab_size * 4}
    return {"parts_gib": {k: v / 2**30 for k, v in parts.items()},
            "reckoned_gib": sum(parts.values()) / 2**30}


def training_phase(seed: int, smi: str, card: str, dev: torch.device,
                   root: Path) -> None:
    """Phase 7c: train h2o-danube-1.8b at its published size (20 steps at
    the train CLI's defaults, then one long step), check its gradients,
    hold every smoke variant's train step on the card to the CPU's (f32
    and bf16), and restart xlstm-125m exactly; each check beside its
    control.  Reports the ``train`` line."""
    import gc

    from repro_torch import configs, keypaths
    from repro_torch.data import pipeline
    from repro_torch.launch import steps, train
    from repro_torch.models import attention, blocks, model
    from repro_torch.optim import adamw

    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("chip_smoke: phase 7c needs TF32 off")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    residual = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bf16 = next(v for k_, v in BF16_PEAK.items() if k_ in card)

    cfg = configs.get(TRAIN_ARCH)
    shape = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
             cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.window,
             cfg.param_dtype)
    if shape != TRAIN_SHAPE:
        raise SystemExit(f"chip_smoke: {TRAIN_ARCH} is not its published "
                         f"size: {shape}")
    n_params = cfg.param_count()
    opt = train.optimizer(cfg, TRAIN_LR, TRAIN_STEPS)
    t0 = time.perf_counter()
    state = steps.init_train_state(
        torch.Generator(device=dev).manual_seed(seed), cfg, opt, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_b = state_bytes(state, keypaths)
    untrained = keypaths.map_with_path(lambda _, p: p.clone(),
                                       state["params"])
    dcfg = pipeline.DataConfig(TRAIN_BATCH, TRAIN_SEQ)
    log = []
    step_fn = train.make_step_fn(
        cfg, opt, dcfg, microbatches=1, device=dev,
        on_metrics=lambda s, m: log.append((float(m["loss"]),
                                            float(m["grad_norm"]))))
    times = []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state = step_fn(state, step)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    losses = [x for x, _ in log]
    gnorms = [x for _, x in log]
    finite = all(math.isfinite(x) for x in losses + gnorms)
    tail = statistics.mean(losses[-TRAIN_TAIL:])
    with torch.no_grad():
        ctrl_tail = statistics.mean(float(model.loss_fn(
            untrained, cfg, pipeline.make_batch(cfg, dcfg, s, device=dev))[0])
            for s in range(TRAIN_STEPS - TRAIN_TAIL, TRAIN_STEPS))
    del untrained
    step_ms = statistics.median(times[1:]) * 1e3
    n_kernels, kernel_ms = decode_trace(
        lambda: step_fn(state, TRAIN_STEPS), "train_step")
    peak_short = torch.cuda.max_memory_allocated()

    # -- one long step: flash_sdpa and the f32 accumulator under remat
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    lb, ls, lm = TRAIN_LONG
    long_batch = pipeline.make_batch(cfg, pipeline.DataConfig(lb, ls),
                                     TRAIN_STEPS + 1, device=dev)
    calls = []
    inner = attention.flash_sdpa

    def counted(*a, **k):
        calls.append(bool(k.get("remat")))
        return inner(*a, **k)

    attention.flash_sdpa = counted
    try:
        long_step = steps.make_train_step(cfg, opt, microbatches=lm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, metrics = long_step(state["params"], state["opt"], long_batch)
        long_loss, long_gnorm = float(metrics["loss"]), float(
            metrics["grad_norm"])
        torch.cuda.synchronize()
        long_s = time.perf_counter() - t0
    finally:
        attention.flash_sdpa = inner
    long_peak = torch.cuda.max_memory_allocated()
    reckoned = long_step_reckoning(cfg, n_params, state_b, lb * ls // lm,
                                   blocks)
    long_finite = math.isfinite(long_loss) and math.isfinite(long_gnorm)
    params = state["params"]
    del state, long_batch, metrics
    gc.collect()
    torch.cuda.empty_cache()

    grads = gradient_checks(seed, dev, params, cfg, keypaths, pipeline,
                            steps, model)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    smoke = [train_card_against_cpu(seed, dev, arch, dt, configs, keypaths,
                                    pipeline, steps, model, adamw)
             for arch in configs.ARCH_IDS
             for dt in ("float32", "bfloat16")]
    restart = restart_exactness(seed, dev, root, configs, keypaths,
                                pipeline, steps, train)

    tokens = TRAIN_BATCH * TRAIN_SEQ
    d = grads["directional"]
    b = grads["bf16_vs_f32"]
    checks = {
        "finite": finite and long_finite,
        "loss_falls": {"first": losses[0], "last_mean": tail,
                       "drop": losses[0] - tail, "least": TRAIN_LOSS_DROP,
                       "control_untrained_drop": losses[0] - ctrl_tail},
        "long_step_flash_calls": len(calls),
        "gradients": grads, "smoke_card_vs_cpu": smoke, "restart": restart,
    }
    emit({"phase": "train", "card": smi, "arch": cfg.name,
          "params": n_params, "state_gib": state_b / 2**30,
          "residual_gib_before": residual / 2**30, "init_s": init_s,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "lr": TRAIN_LR, "losses": losses, "grad_norms": gnorms,
          "step_ms": step_ms, "step_ms_first": times[0] * 1e3,
          "tok_s": tokens / step_ms * 1e3,
          "step_bound_ms": 6 * n_params * tokens / bf16 * 1e3,
          "step_bound_note": "6·N·tokens over the dense bf16 peak; the "
                             "backward's f32-output products run as f32 "
                             "GEMMs, below that peak",
          "step_kernels": n_kernels, "step_kernel_ms": kernel_ms,
          "step_busy_share": kernel_ms / step_ms,
          "peak_gib": peak_short / 2**30,
          "long": {"batch": lb, "seq": ls, "microbatches": lm,
                   "ms": long_s * 1e3, "tok_s": lb * ls / long_s,
                   "bound_ms": 6 * n_params * lb * ls / bf16 * 1e3,
                   "loss": long_loss, "grad_norm": long_gnorm,
                   "peak_gib": long_peak / 2**30, **reckoned},
          "checks": checks})
    bad = [name for name, ok in (
        ("finite", checks["finite"]),
        ("loss_falls", losses[0] - tail >= TRAIN_LOSS_DROP
         > losses[0] - ctrl_tail),
        ("long_step_flash", len(calls) >= lm * cfg.num_layers
         and all(calls)),
        ("directional_derivative", d["err"] <= GRAD_FD_LIMIT
         < min(d["control_last_layer_zeroed"], d["control_opposite_sign"])),
        ("bf16_vs_f32_gradients", b["err"] <= GRAD_BF16_LIMIT
         < min(b["control_last_layer_zeroed"], b["control_opposite_sign"])),
        ("smoke_card_vs_cpu", all(
            r["err"] <= 1 < min(r["control"].values()) for r in smoke)),
        ("restart", restart["ok"])) if not ok]
    if bad:
        raise SystemExit(f"chip_smoke: phase 7c failed {bad}")


# ---------------------------------------------------------------------------
# Phase 7d: the multi-device layer (launch/mesh.py, parallel/sharding.py and
# collectives.py, the expert-parallel MoE, the sharded train step, the
# elastic restore) on ranks that share the card.  NCCL refuses two ranks of
# one communicator on one GPU, so: (a) one NCCL rank; (b) and (c) gloo
# ranks whose compute runs on the card and whose collectives go through the
# host (parallel/collectives.py stages a CUDA tensor through the host on a
# gloo group).  Neither says anything of NVLink or of scaling.
# ---------------------------------------------------------------------------
# (b): the (data, model) mesh and the elastic restore's mesh; the elastic
# restore's state is danube cut to MESH_ELASTIC_LAYERS layers at published
# widths (3.0 GiB: gloo moves the checkpoint's leaves through the host at
# well under 1 GB/s, and the whole 17.05 GiB would take most of the phase's
# 150 s)
MESH_SHAPE, MESH_ELASTIC, MESH_ELASTIC_LAYERS = (2, 2), (1, 2), 2
# (b)'s sharded step against the unsharded step from one state, per leaf:
# the params beyond one bf16 ulp over the largest update, m and v over
# their largest |value|.  The sharded step's gradient is the f32 mean of
# two half-batch gradients, each rounded to bf16 (≤ 2**-9 of each half),
# where the unsharded step rounds the whole batch's once, and the
# embedding's backward sums a token's repeats in bf16; v squares the
# gradient, doubling its relative error.  The first run on an H100 read
# 2**-6.1 on the embedding's v (0.014 of max |v|), every other leaf below
# 2**-10 (phase 7c's card-vs-CPU bf16 limit, where both steps see one
# gradient).
# Set after that reading, 2x above it.  Control: the unsharded step on
# another batch, which read 10-35x this limit.
MESH_STEP_LIMIT = 2.0 ** -5
# (c): one MoE layer at published widths, mesh, and the cases as (rows,
# positions, the dispatch the reference picks there)
EP_CELLS = {"deepseek_v3_671b": ((2, 2), ((8, 1, "ep2d"), (8, 1024, "ep"))),
            "dbrx_132b": ((3, 2), ((6, 1, "ep_dstat"),))}
# (c): max |EP − plain| over max |plain| on the tokens no routing flip
# reaches.  The combine sums a token's slots on each rank in f32 and then
# the ranks' partials (another association of the same f32 sum, ~2**-20),
# and adds the shared expert in bf16 after casting the routed part (the
# plain path adds in f32 and casts once): two bf16 roundings where the
# plain path has one, at most 2**-8 of the largest |y| each, so 2**-7.
# Control: one rank's experts zeroed, which drops their share (O(|y|)).
EP_LIMIT = 2.0 ** -7
# the phase's wall seconds at most
MESH_PHASE_S = 150.0


def _digest(t: torch.Tensor, offsets=None, full_shape=None) -> torch.Tensor:
    """Two int64 sums of ``t``'s bits: plain and weighted by each element's
    flat index in the full leaf (``offsets``: the shard's place in it), so
    shards' digests add up to the full leaf's."""
    bits = t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32).long()
    full_shape = tuple(full_shape or t.shape)
    offsets = offsets or (0,) * t.ndim
    idx = torch.zeros((), dtype=torch.int64, device=t.device)
    stride = 1
    for d in reversed(range(t.ndim)):
        ar = torch.arange(t.shape[d], device=t.device) + offsets[d]
        idx = idx + (ar * stride).view([-1 if i == d else 1
                                        for i in range(t.ndim)])
        stride *= full_shape[d]
    w = idx % 65521 + 1
    return torch.stack([bits.sum(), (bits * w).sum()])


def _tree_digests(state, spec_of, mesh, keypaths, shd, col, dev) -> dict:
    """{leaf: [Σ bits, Σ bits·w]} of a train state's full leaves, from this
    rank's shards (each leaf counted once: its owner rank along the axes it
    is replicated over), summed over the mesh; each taken on ``dev``."""
    rows, keys = [], []
    for path, t in keypaths.leaves_with_path(state):
        key = keypaths.key(path)
        if path[0] == "params":
            spec = spec_of(path[1:])
        elif path[1] in ("m", "v"):
            spec = spec_of(path[2:])
        else:
            spec = shd.P()
        held = shd.sharded_axes(spec)
        owner = all(c == 0 for a, c in mesh.coords.items() if a not in held)
        full = list(t.shape)
        offs = []
        for i, e in enumerate(spec):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n = mesh.axes_size(axes)
            full[i] *= n
            offs.append(mesh.index(axes) * t.shape[i] if n > 1 else 0)
        offs += [0] * (t.ndim - len(offs))
        d = _digest(t.to(dev), offs, full).cpu()
        rows.append(d if owner else torch.zeros_like(d))
        keys.append(key)
    total = col.all_reduce(torch.stack(rows), mesh, mesh.axis_names)
    return {k: v.tolist() for k, v in zip(keys, total.cpu())}


def _elastic_cfg(cfg):
    """``cfg`` with its one scan group cut to MESH_ELASTIC_LAYERS."""
    (group,) = cfg.groups
    return dataclasses.replace(cfg, groups=(dataclasses.replace(
        group, repeats=MESH_ELASTIC_LAYERS),))


def _rank_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":           # every rank shares the one card
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gib(dev: torch.device):
    return torch.cuda.max_memory_allocated(dev) / 2**30 \
        if dev.type == "cuda" else None


def _mesh_cfg(arch: str, small: bool):
    from repro_torch import configs
    return configs.get_smoke(arch) if small else configs.get(arch)


def _carried_moments(params, rms, seed, keypaths, shd, spec_of, mesh):
    """This rank's shards of moments at each leaf's gradient scale s (phase
    7c's ``carried_state``: m ~ N(0, s²), v ~ s² · U[1/2, 3/2]), each leaf
    drawn whole on the card from a generator of its own (``seed``, the
    leaf's index) and cut at once; ``rms`` maps a leaf to (s, its full
    shape)."""
    ms, vs = {}, {}
    for i, (path, p) in enumerate(keypaths.leaves_with_path(params)):
        key = keypaths.key(path)
        s, shape = rms[key]
        gen = torch.Generator(device=p.device).manual_seed(
            seed * 1_000_003 + i)
        m = torch.randn(shape, generator=gen, device=p.device) * s
        v = (torch.rand(shape, generator=gen, device=p.device) + 0.5) * s * s
        ms[key] = shd.shard(m, spec_of(path), mesh)
        vs[key] = shd.shard(v, spec_of(path), mesh)
    return (keypaths.map_with_path(lambda p, _: ms[keypaths.key(p)], params),
            keypaths.map_with_path(lambda p, _: vs[keypaths.key(p)], params))


def world1_rank(rank, world, job):
    """(a): one NCCL rank on a (1, 1) mesh: the sharded step from the state
    the unsharded step starts from, under deterministic algorithms; per
    leaf digests of both results and of the sharded step on another
    batch."""
    import torch.distributed as dist

    from repro_torch import keypaths
    from repro_torch.data import pipeline
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_host_mesh

    dev = _rank_device(job["device"])
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = _mesh_cfg(job["arch"], job["small"])
    opt = train.optimizer(cfg, TRAIN_LR, TRAIN_STEPS)
    mesh = make_host_mesh()
    dcfg = pipeline.DataConfig(*job["batch"])
    batches = [pipeline.make_batch(cfg, dcfg, s, device=dev) for s in (0, 1)]
    probe = torch.ones((), device=dev)
    dist.all_reduce(probe)                 # the NCCL communicator is live

    def digests(state):
        return [_digest(t).tolist() for t in keypaths.leaves(state)]

    def drawn():
        return steps.init_train_state(
            torch.Generator(device=dev).manual_seed(job["seed"]), cfg, opt,
            device=dev)

    state = drawn()
    shards = steps.shard_train_state(state, cfg, mesh)  # whole-leaf copies
    steps.make_train_step(cfg, opt)(state["params"], state["opt"],
                                    batches[0])
    want = digests(state)
    del state
    step = steps.make_sharded_train_step(cfg, opt, mesh)
    _sync(dev)
    t0 = time.perf_counter()
    step(shards["params"], shards["opt"], batches[0])
    _sync(dev)
    step_s = time.perf_counter() - t0
    got = digests(shards)
    del shards
    shards = steps.shard_train_state(drawn(), cfg, mesh)
    step(shards["params"], shards["opt"], batches[1])
    ctrl = digests(shards)
    return {"backend": dist.get_backend(), "world": world,
            "leaves": len(want), "bits_equal": got == want,
            "control_other_batch_equal": ctrl == want,
            "step_ms": step_s * 1e3, "peak_gib": _peak_gib(dev),
            "all_reduce_probe": float(probe)}


def mesh_rank(rank, world, job):
    """Six gloo ranks: (b) and the elastic restore on a (2, 2) mesh of
    ranks 0–3 (onto (1, 2), ranks 0–1), (c)'s deepseek cell on the (2, 2)
    mesh, then dbrx's on (3, 2), all six; returns each rank's report
    (rank 0's holds the checks)."""
    import gc

    import torch.distributed as dist

    from repro_torch import keypaths, set_default_device
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data import pipeline
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.models import model
    from repro_torch.optim import adamw, compress
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.activations import activation_mesh
    from repro_torch.runtime.elastic import restore_on_mesh

    dev = _rank_device(job["device"])
    set_default_device(dev)
    out = {"rank": rank}
    cfg = _mesh_cfg(job["arch"], job["small"])
    opt = train.optimizer(cfg, TRAIN_LR, TRAIN_STEPS)
    # every rank makes every mesh's groups, in one order
    mesh = Mesh(MESH_SHAPE, ("data", "model")).connect()
    small = Mesh(MESH_ELASTIC, ("data", "model")).connect()
    wide = make_host_mesh(*EP_CELLS["dbrx_132b"][0])
    spec_of = steps._spec_of(steps.train_specs(cfg, mesh))
    dcfg = pipeline.DataConfig(*job["batch"])
    batches = [pipeline.make_batch(cfg, dcfg, s, device=dev) for s in (0, 1)]
    t_all = time.perf_counter()
    started = time.time() - job["spawned"]

    def note(stage: str, **more) -> None:
        """Rank 0's progress, a line a stage (the phase's time budget)."""
        if rank == 0:
            emit({"phase": "mesh_progress", "stage": stage,
                  "s": time.perf_counter() - t_all,
                  "peak_gib": _peak_gib(dev), **more})

    note("connected", since_spawn_s=started)

    if mesh.rank is not None:
        # -- the state the unsharded step started from, as this rank's shards
        full = model.init_params(
            torch.Generator(device=dev).manual_seed(job["seed"]), cfg,
            device=dev)
        params = keypaths.map_with_path(
            lambda p, t: shd.shard(t, spec_of(p), mesh), full)
        del full
        rms = {k: (s, tuple(shape)) for k, (s, shape) in job["rms"].items()}
        m, v = _carried_moments(params, rms, job["seed"] + 1, keypaths, shd,
                                spec_of, mesh)
        # the moments' shards live on the host (AdamW computes each piece on
        # the card and writes it back): four ranks' gathered weights and
        # gradients fill the card's memory
        m, v = (keypaths.map_with_path(
            lambda _, t: t.cpu().pin_memory() if t.is_cuda else t, x)
            for x in (m, v))
        state = {"params": params, "opt": {
            "m": m, "v": v,
            "count": torch.tensor(3, dtype=torch.int32, device=dev)}}
        # the parameters the step starts from, kept on the host (the card's
        # memory is the four ranks' budget)
        old = [t.to("cpu", copy=True) for t in keypaths.leaves(params)]
        out["resident_gib"] = sum(t.numel() * t.element_size()
                                  for t in keypaths.leaves(state)) / 2**30
        out["resident_card_gib"] = sum(
            t.numel() * t.element_size() for t in keypaths.leaves(state)
            if t.device.type == dev.type) / 2**30
        if dev.type == "cuda":     # the moments' whole-leaf draws are cached
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        note("state_drawn")
        step = steps.make_sharded_train_step(cfg, opt, mesh)
        mesh.comm_log = []
        _sync(dev)
        t0 = time.perf_counter()
        _, _, metrics = step(state["params"], state["opt"], batches[0])
        _sync(dev)
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        out["step_collective_ms"] = sum(c["s"] for c in mesh.comm_log) * 1e3
        out["step_collectives"] = len(mesh.comm_log)
        out["step_collective_ms_by_op"] = {}
        for c in mesh.comm_log:
            by = out["step_collective_ms_by_op"]
            by[c["op"]] = by.get(c["op"], 0.0) + c["s"] * 1e3
        out["step_peak_gib"] = _peak_gib(dev)
        out["loss"] = float(metrics["loss"])
        mesh.comm_log = None
        note("step", step_ms=out["step_ms"],
             collective_ms=out["step_collective_ms_by_op"])

        # -- against the unsharded step: its gradient and norm (the parent's),
        # its AdamW update applied to this rank's shard (elementwise)
        grads = job["grads"]

        # the moments the step started from, drawn again (on the card: the
        # step is done) for both comparisons
        ms0, vs0 = _carried_moments(state["params"], rms, job["seed"] + 1,
                                    keypaths, shd, spec_of, mesh)
        ms0, vs0 = keypaths.leaves(ms0), keypaths.leaves(vs0)

        def errors(g_tree, norm):
            errs = {}
            m0 = [t.clone() for t in ms0]
            v0 = [t.clone() for t in vs0]
            for i, (path, p_got) in enumerate(
                    keypaths.leaves_with_path(state["params"])):
                key = keypaths.key(path)
                g = shd.shard(g_tree[key], spec_of(path), mesh).to(dev)
                p = old[i].to(dev, copy=True)
                st = {"m": {"x": m0[i]}, "v": {"x": v0[i]},
                      "count": torch.tensor(3, dtype=torch.int32, device=dev)}
                adamw.update({"x": g}, st, {"x": p}, opt,
                             grad_norm=torch.tensor(norm, device=dev))
                o64 = old[i].to(dev).double()
                w64 = p.double()
                ulp = torch.exp2(torch.floor(torch.log2(
                    w64.abs().clamp_min(1e-30))) - 7)
                dp = ((p_got.double() - w64).abs() - ulp).clamp_min(0.0)
                parts = {
                    "params": (dp.max(), (w64 - o64).abs().max()),
                    "opt/m": ((keypaths.leaves(state["opt"]["m"])[i].to(dev)
                               .double() - st["m"]["x"].double()).abs().max(),
                              st["m"]["x"].double().abs().max()),
                    "opt/v": ((keypaths.leaves(state["opt"]["v"])[i].to(dev)
                               .double() - st["v"]["x"].double()).abs().max(),
                              st["v"]["x"].double().abs().max())}
                for part, (e, scale) in parts.items():
                    pair = col.all_reduce(
                        torch.stack([e, scale]).float(), mesh,
                        mesh.axis_names, op="max")
                    errs[f"{part}/{key}"] = float(pair[0]) / max(
                        float(pair[1]) * job["limit"], 1e-30)
            return errs

        t0 = time.perf_counter()
        ratio = errors(grads[0], job["norms"][0])
        ctrl = errors(grads[1], job["norms"][1])
        out["compare_s"] = time.perf_counter() - t0
        del ms0, vs0
        note("compare")
        worst = max(ratio, key=ratio.get)
        out["step_vs_unsharded"] = {
            "limit": job["limit"], "err_over_limit": ratio[worst],
            "worst_leaf": worst,
            "control_other_batch": {
                part: max(v for k, v in ctrl.items() if k.startswith(part))
                for part in ("params", "opt/m", "opt/v")}}

        # -- compressed_psum over data on the unsharded step's gradient
        # trees, batch 0's on data rank 0 and batch 1's on data rank 1,
        # each rank's model half of every leaf (so the two ranks of a data
        # group hold the same part); the exact mean of both, here
        t0 = time.perf_counter()
        half = {k: shd.P(*[e if e == "model" else None for e in sp])
                for k, sp in ((keypaths.key(p), spec_of(p))
                              for p, _ in keypaths.leaves_with_path(
                                  state["params"]))}
        worst_err = worst_res = 0.0
        for key in half:
            pair = [shd.shard(gt[key], half[key], mesh).to(dev).float()
                    for gt in grads]
            g = pair[mesh.coords["data"]]
            one = {"g": g}
            mean, resid = compress.compressed_psum(
                one, compress.init_residuals(one), "data", mesh=mesh)
            exact = (pair[0] + pair[1]) / 2
            scale = max(max(float(p.abs().max()) for p in pair),
                        1e-12) / 127.0
            worst_err = max(worst_err, float(
                (mean["g"] - exact).abs().max()) / (2 * scale))
            own = max(float(g.abs().max()), 1e-12) / 127.0
            worst_res = max(worst_res, float(resid["g"].abs().max()) / own)
            del pair, g, one, mean, resid, exact
        out["compressed_psum"] = {"err_over_2scale": worst_err,
                                  "resid_over_scale": worst_res,
                                  "seconds": time.perf_counter() - t0}
        del grads, state, old
        gc.collect()
        note("compressed_psum")

        # -- elastic: danube cut to MESH_ELASTIC_LAYERS layers (published
        # widths), checkpointed from (2, 2)'s shards
        t0 = time.perf_counter()
        ecfg = _elastic_cfg(cfg)
        espec = steps._spec_of(steps.train_specs(ecfg, mesh))
        est = steps.shard_train_state(steps.init_train_state(
            torch.Generator(device=dev).manual_seed(job["seed"] + 2), ecfg,
            opt, device=dev), ecfg, mesh)
        before = _tree_digests(est, espec, mesh, keypaths, shd, col, dev)
        saved = steps.collect_train_state(est, ecfg, mesh)
        out["elastic_gib"] = sum(t.numel() * t.element_size()
                                 for t in keypaths.leaves(est)) / 2**30
        del est
        if mesh.rank == 0:
            CheckpointManager(job["ckpt"]).save(1, saved)
        del saved
    dist.barrier()
    if mesh.rank is not None:
        out["save_s"] = time.perf_counter() - t0
    note("save")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if small.rank is not None:
        ecfg = _elastic_cfg(_mesh_cfg(job["arch"], job["small"]))
        t0 = time.perf_counter()
        restored = restore_on_mesh(CheckpointManager(job["ckpt"]), 1,
                                   steps.abstract_train_state(ecfg, opt),
                                   ecfg, small, device=dev)
        _sync(dev)
        out["restore_s"] = time.perf_counter() - t0
        spec_small = steps._spec_of(steps.train_specs(ecfg, small))
        after = _tree_digests(restored, spec_small, small, keypaths, shd,
                              col, dev)
        out["restore_bits_equal"] = after == before
        step_small = steps.make_sharded_train_step(ecfg, opt, small)
        _, _, m2 = step_small(restored["params"], restored["opt"],
                              batches[1])
        moved = _tree_digests(restored, spec_small, small, keypaths, shd,
                              col, dev)
        out["elastic_step"] = {"loss": float(m2["loss"]),
                               "params_moved": moved != after}
        del restored
        gc.collect()
    dist.barrier()
    note("elastic")
    out["mesh_s"] = time.perf_counter() - t_all
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- (c): the EP dispatches of deepseek-v3's MoE layer on (2, 2), then
    # dbrx's on (3, 2)
    if mesh.rank is not None:
        out["ep"] = _ep_cases(job["ep"], mesh, dev, mesh.rank)
    note("ep_deepseek")
    out["ep_wide"] = _ep_cases(job["ep_wide"], wide, dev, wide.rank)
    note("ep_dbrx")
    return out


def _ep_layer(arch: str, small: bool, factor: float):
    from repro_torch import configs
    cfg = configs.get(arch)
    if small:       # the same dispatch on a (3, 2)-divisible small layer
        s = configs.get_smoke(arch)
        cfg = dataclasses.replace(s, d_model=96, moe=dataclasses.replace(
            s.moe, num_experts=16 if cfg.moe.num_experts > 16 else 4,
            d_expert=48, top_k=2))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


def _ep_draw(cfg, seed, dev, experts):
    """The MoE layer's router, shared experts and the routed experts in
    ``experts`` (a range), each expert drawn from a generator of its own."""
    d, m = cfg.d_model, cfg.moe
    f, e = m.d_expert, m.num_experts
    dt = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32

    def gen(i):
        return torch.Generator(device=dev).manual_seed(seed * 1_000_003 + i)

    out = {"router": torch.randn((d, e), generator=gen(0), device=dev)
           / math.sqrt(d)}
    experts = list(experts)
    ws = {"w_gate": torch.empty((len(experts), d, f), dtype=dt, device=dev),
          "w_up": torch.empty((len(experts), d, f), dtype=dt, device=dev),
          "w_down": torch.empty((len(experts), f, d), dtype=dt, device=dev)}
    for i, x in enumerate(experts):      # in place: no second copy
        g = gen(16 + x)
        ws["w_gate"][i] = torch.randn((d, f), generator=g, device=dev) \
            / math.sqrt(d)
        ws["w_up"][i] = torch.randn((d, f), generator=g, device=dev) \
            / math.sqrt(d)
        ws["w_down"][i] = torch.randn((f, d), generator=g, device=dev) \
            / math.sqrt(f)
    out["experts"] = ws
    if m.num_shared:
        g = gen(1)
        fs = f * m.num_shared
        out["shared"] = {
            "w_gate": (torch.randn((d, fs), generator=g, device=dev)
                       / math.sqrt(d)).to(dt),
            "w_up": (torch.randn((d, fs), generator=g, device=dev)
                     / math.sqrt(d)).to(dt),
            "w_down": (torch.randn((fs, d), generator=g, device=dev)
                       / math.sqrt(fs)).to(dt)}
    return out


def _ep_x(cfg, rows, seq, seed, dev):
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed * 7919 + rows * seq)
    return torch.randn((rows, seq, cfg.d_model), generator=gen,
                       device=dev).to(dt)


def _ep_cases(job, mesh, dev, rank):
    """This rank's part of each EP case of ``job``: its rows of y, its
    routing ids, times; then the same with the experts of rank
    ``job['zero_rank']`` zeroed (the control)."""
    import gc

    from repro_torch.models import moe
    from repro_torch.parallel.activations import activation_mesh

    cfg = _ep_layer(job["arch"], job["small"], job["factor"])
    e, tp = cfg.moe.num_experts, mesh.shape["model"]
    mine = range(mesh.coords["model"] * (e // tp),
                 (mesh.coords["model"] + 1) * (e // tp))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = _ep_draw(cfg, job["seed"], dev, mine)
    resident = sum(t.numel() * t.element_size()
                   for t in params["experts"].values()) / 2**30
    routed = []
    inner = moe._route

    def spy(xf, router, m):
        res = inner(xf, router, m)
        routed.append(res[1].cpu())
        return res

    out = {"resident_expert_gib": resident, "cases": []}
    dd = mesh.shape["data"]

    def run(x):
        r = x.shape[0] // dd
        xl = x[mesh.coords["data"] * r:(mesh.coords["data"] + 1) * r]
        with activation_mesh(mesh):
            return moe.moe_apply(params, xl, cfg)

    xs = [_ep_x(cfg, rows, seq, job["seed"], dev)
          for rows, seq, _ in job["cases"]]
    for (rows, seq, _), x in zip(job["cases"], xs):
        case = {"rows": rows, "seq": seq, "data": mesh.coords["data"],
                "dispatch": moe.dispatch_name(cfg.moe, mesh, rows * seq)}
        moe._route = spy
        try:
            mesh.comm_log = []
            _sync(dev)
            t0 = time.perf_counter()
            y, aux = run(x)
            _sync(dev)
            case["ms"] = (time.perf_counter() - t0) * 1e3
            case["collective_ms"] = sum(c["s"] for c in mesh.comm_log) * 1e3
        finally:
            moe._route = inner
            mesh.comm_log = None
        case.update(y=y.cpu(), aux=float(aux), ids=routed[0])
        routed.clear()
        out["cases"].append(case)
    # the control: one rank's experts zeroed (in place, their last use)
    if rank == job["zero_rank"]:
        for w in params["experts"].values():
            w.zero_()
    for case, x in zip(out["cases"], xs):
        case["y_control"] = run(x)[0].cpu()
    out["peak_gib"] = _peak_gib(dev)
    del params
    gc.collect()
    return out


def _ep_reference(arch, small, seed, dev, cases, dd):
    """The plain ``moe_apply`` of the layer on every case (no mesh), its
    routing ids, and the least capacity factor (from the config's, in
    steps of 1/4) at which no token set drops a slot: the whole batch and
    each data rank's rows."""
    import gc

    from repro_torch.models import moe

    cfg = _ep_layer(arch, small, 1.0)
    m = cfg.moe
    params = _ep_draw(cfg, seed, dev, range(m.num_experts))
    xs = [_ep_x(cfg, rows, seq, seed, dev) for rows, seq, _ in cases]
    factor = _mesh_cfg(arch, small).moe.capacity_factor
    while True:
        mm = dataclasses.replace(m, capacity_factor=factor)
        ok = True
        for x in xs:
            flat = x.reshape(-1, cfg.d_model)
            for part in [flat] + list(flat.chunk(dd)):
                _, ids, _, _ = moe._route(part, params["router"], mm)
                counts = torch.bincount(ids.reshape(-1),
                                        minlength=m.num_experts)
                ok &= int(counts.max()) <= moe.capacity(part.shape[0], mm)
        if ok:
            break
        factor += 0.25
    cfg = dataclasses.replace(cfg, moe=mm)
    out = {"factor": factor, "cases": []}
    with torch.no_grad():
        for x in xs:
            _, ids, _, _ = moe._route(x.reshape(-1, cfg.d_model),
                                      params["router"], mm)
            _sync(dev)
            t0 = time.perf_counter()
            y, aux = moe.moe_apply(params, x, cfg)
            _sync(dev)
            out["cases"].append({"y": y.cpu(), "aux": float(aux),
                                 "ids": ids.cpu(),
                                 "ms": (time.perf_counter() - t0) * 1e3})
    out["expert_gib"] = sum(t.numel() * t.element_size()
                            for t in params["experts"].values()) / 2**30
    del params, xs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _ep_check(ref, eps, cases, dd) -> dict:
    """Per case: every rank's routing against its data group's first rank
    (exact) and against the plain path's (flips), the assembled y against
    the plain y on the tokens no flip reaches, beside the control (``eps``:
    each rank's ``_ep_cases``)."""
    out = []
    for c, (rows, seq, want) in enumerate(cases):
        parts = [e["cases"][c] for e in eps]
        dispatch = {p["dispatch"] for p in parts}
        same = all(torch.equal(p["ids"], next(
            q for q in parts if q["data"] == p["data"])["ids"])
                   for p in parts)
        first = sorted((p for p in parts), key=lambda p: p["data"])
        by_data = {}
        for p in first:
            by_data.setdefault(p["data"], p)
        y = torch.cat([by_data[d]["y"] for d in range(dd)], 0).float()
        y_ctrl = torch.cat([by_data[d]["y_control"] for d in range(dd)],
                           0).float()
        ref_ids = ref["cases"][c]["ids"]
        # the token sets each rank routed: all rows (gathered) or its own
        ids = by_data[0]["ids"]
        if ids.shape[0] == ref_ids.shape[0]:
            got_ids = ids
        else:
            got_ids = torch.cat([by_data[d]["ids"] for d in range(dd)], 0)
        flip = (got_ids.sort(-1).values != ref_ids.sort(-1).values).any(-1)
        keep = ~flip.reshape(rows, seq)
        want_y = ref["cases"][c]["y"].float()
        scale = float(want_y.abs().max())
        err = float((y - want_y)[keep].abs().max()) / scale
        ctrl = float((y_ctrl - want_y)[keep].abs().max()) / scale
        out.append({"rows": rows, "seq": seq, "dispatch": sorted(dispatch),
                    "want_dispatch": want, "routing_equal_rank0": same,
                    "flips": int(flip.sum()), "tokens": rows * seq,
                    "flip_cap": FAMILY_FLIP_CAP, "err": err,
                    "limit": EP_LIMIT, "control_rank_zeroed": ctrl,
                    "aux": [p["aux"] for p in parts],
                    "aux_plain": ref["cases"][c]["aux"],
                    "ms": [p["ms"] for p in parts],
                    "collective_ms": [p["collective_ms"] for p in parts],
                    "plain_ms": ref["cases"][c]["ms"]})
    return out


def _ep_ok(c) -> bool:
    aux = max(abs(a - c["aux_plain"]) for a in c["aux"]) \
        <= 1e-3 * abs(c["aux_plain"])
    return (c["dispatch"] == [c["want_dispatch"]] and c["routing_equal_rank0"]
            and c["flips"] <= FAMILY_FLIP_CAP * c["tokens"]
            and c["err"] <= EP_LIMIT < c["control_rank_zeroed"] and aux)


def mesh_phase(seed: int, smi: str, card: str, dev: torch.device,
               root: Path, *, small: bool = False) -> None:
    """Phase 7d: (a) the sharded step on one NCCL rank to the bit; (b)
    four gloo ranks on (data 2, model 2): danube's sharded step against
    the unsharded one, compressed_psum, the elastic restore on (1, 2); (c)
    the EP dispatches at published widths.  Reports the ``mesh`` line;
    ``small`` runs the smoke configs (a rehearsal on the CPU)."""
    import gc

    from repro_torch import keypaths
    from repro_torch.data import pipeline
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import model
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    arch = TRAIN_ARCH
    batch = (TRAIN_BATCH, TRAIN_SEQ) if not small else (8, 16)
    device = str(dev.type)
    base = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=root / "build")
    timings = {}
    try:
        # -- (a) one NCCL rank, its process run beside (b)'s preparation
        # here (deterministic algorithms: cuBLAS wants its workspace fixed
        # before it starts, in the rank's environment)
        t0 = time.perf_counter()
        cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        world1_run = pool.submit(
            run_ranks, world1_rank, 1,
            backend="nccl" if device == "cuda" else "gloo", timeout=600,
            args=({"device": device, "arch": arch, "small": small,
                   "seed": seed, "batch": batch},))

        # -- (b)'s unsharded gradients (batch 0 and, for the control, 1),
        # their norms, and the moments' scale from batch 0's
        t0 = time.perf_counter()
        cfg = _mesh_cfg(arch, small)
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
        dcfg = pipeline.DataConfig(*batch)
        files, norms, rms = [], [], {}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for s in (0, 1):
            b = pipeline.make_batch(cfg, dcfg, s, device=dev)
            _, g = steps._value_and_grad(params, cfg, b)
            norms.append(float(adamw.global_norm(g)))
            if s == 0:
                rms = {keypaths.key(p): (
                    float(t.float().pow(2).mean().sqrt()) + 1e-12,
                    tuple(t.shape)) for p, t in keypaths.leaves_with_path(g)}
            # to the ranks through shared memory, not a file
            files.append({keypaths.key(p): torch.empty(
                t.shape, dtype=t.dtype).share_memory_().copy_(t)
                for p, t in keypaths.leaves_with_path(g)})
            del g, b
        timings["unsharded_grad_peak_gib"] = _peak_gib(dev)
        timings["grads_s"] = time.perf_counter() - t0
        del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        try:
            (world1,) = world1_run.result()
        finally:
            pool.shutdown()
            if cublas is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
        timings["a_s"] = time.perf_counter() - t0
        emit({"phase": "mesh_world1", "card": smi, **world1,
              "seconds": timings["a_s"], "beside": "(b)'s gradients"})
        # (c)'s plain dispatches, once the card is (a)'s no more
        ep_ds = EP_CELLS["deepseek_v3_671b"]
        cases_ds = list(ep_ds[1])
        ref_ds = _ep_reference("deepseek_v3_671b", small, seed, dev,
                               cases_ds, ep_ds[0][0])
        ep_db = EP_CELLS["dbrx_132b"]
        ref_db = _ep_reference("dbrx_132b", small, seed, dev, ep_db[1],
                               ep_db[0][0])
        timings["b_prep_s"] = time.perf_counter() - t0
        timings["ep_refs_s"] = timings["b_prep_s"] - timings["a_s"]
        emit({"phase": "mesh_progress", "stage": "parent_prep",
              **timings})

        # -- (b), the elastic restore and (c) on six ranks
        t0 = time.perf_counter()
        job = {"device": device, "arch": arch, "small": small, "seed": seed,
               "batch": batch, "rms": rms, "norms": norms,
               # the smoke rehearsal is f32: both steps' gradients agree
               # far below the bf16 halves' rounding
               "limit": TRAIN_BF16_CPU_LIMIT if small else MESH_STEP_LIMIT,
               "grads": files, "ckpt": os.path.join(base, "ckpt"),
               "ep": {"arch": "deepseek_v3_671b", "small": small,
                      "seed": seed, "factor": ref_ds["factor"],
                      "cases": cases_ds, "zero_rank": 1},
               "ep_wide": {"arch": "dbrx_132b", "small": small,
                           "seed": seed, "factor": ref_db["factor"],
                           "cases": list(ep_db[1]), "zero_rank": 1}}
        job["spawned"] = time.time()
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            ranks6 = run_ranks(mesh_rank, 6, backend="gloo", args=(job,),
                               timeout=900)
        finally:
            if alloc is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        timings["ranks_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(base, ignore_errors=True)

    ranks4 = ranks6[:4]               # the (2, 2) mesh's
    r0 = ranks4[0]
    ep = {}
    for arch_ep, (mesh_ep, cases), ref, eps in (
            ("deepseek_v3_671b", ep_ds, ref_ds, [r["ep"] for r in ranks4]),
            ("dbrx_132b", ep_db, ref_db, [r["ep_wide"] for r in ranks6])):
        ep[arch_ep] = {
            "mesh": list(mesh_ep), "factor": ref["factor"],
            "expert_gib": ref["expert_gib"],
            "resident_expert_gib_per_rank": [
                e["resident_expert_gib"] for e in eps],
            "peak_gib_per_rank": [e["peak_gib"] for e in eps],
            "cases": _ep_check(ref, eps, cases, mesh_ep[0])}
    state_gib = sum(t.numel() * t.element_size() for t in keypaths.leaves(
        steps.abstract_train_state(cfg, train.optimizer(
            cfg, TRAIN_LR, TRAIN_STEPS)))) / 2**30
    seconds = time.perf_counter() - t_phase
    sv = r0["step_vs_unsharded"]
    cp = r0["compressed_psum"]
    line = {"phase": "mesh", "card": smi, "arch": cfg.name,
            "note": "ranks share one H100 over gloo (their collectives "
                    "through the host); (a) is one NCCL rank",
            "world1_nccl": world1,
            "sharded_step": {
                "mesh": list(MESH_SHAPE), "batch": list(batch),
                "state_gib": state_gib,
                "resident_gib_per_rank": [r["resident_gib"] for r in ranks4],
                "resident_card_gib_per_rank": [r["resident_card_gib"]
                                               for r in ranks4],
                "moments": "on the host, each piece updated on the card",
                "peak_gib_per_rank": [r["step_peak_gib"] for r in ranks4],
                "step_ms_per_rank": [r["step_ms"] for r in ranks4],
                "collective_ms_per_rank": [r["step_collective_ms"]
                                           for r in ranks4],
                "collectives": r0["step_collectives"],
                "loss": r0["loss"], **sv},
            "compressed_psum": cp,
            "elastic": {"from": list(MESH_SHAPE), "to": list(MESH_ELASTIC),
                        "layers": MESH_ELASTIC_LAYERS,
                        "state_gib": r0.get("elastic_gib"),
                        "save_s": r0["save_s"],
                        "restore_s": r0.get("restore_s"),
                        "bits_equal": r0.get("restore_bits_equal"),
                        "step": r0.get("elastic_step")},
            "ep": ep, "timings_s": timings, "seconds": seconds,
            "seconds_limit": MESH_PHASE_S}
    emit(line)
    es = r0.get("elastic_step") or {}
    bad = [name for name, ok in (
        ("world1_bits", world1["bits_equal"]
         and not world1["control_other_batch_equal"]),
        ("sharded_step", sv["err_over_limit"] <= 1
         < min(sv["control_other_batch"].values())),
        ("compressed_psum", cp["err_over_2scale"] <= 1
         and cp["resid_over_scale"] <= 1 + 1e-6),
        ("elastic", bool(r0.get("restore_bits_equal"))
         and math.isfinite(es.get("loss", math.nan))
         and es.get("params_moved")),
        ("ep", all(_ep_ok(c) for a in ep.values() for c in a["cases"])),
        ("seconds", small or seconds <= MESH_PHASE_S)) if not ok]
    if bad:
        raise SystemExit(f"chip_smoke: phase 7d failed {bad}")


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
        rows, card, smi = run(root, args.seed, cache_dir)
        # -- 7. the serving phase, once the earlier phases' tensors are gone
        serve_phase(args.seed, smi, card, torch.device("cuda"))
        # -- 7b. the experts, MLA and the recurrent mixers, phase 7's gone
        families_phase(args.seed, smi, card, torch.device("cuda"))
        # -- 7c. training, phase 7b's tensors gone
        training_phase(args.seed, smi, card, torch.device("cuda"), root)
        # -- 7d. the multi-device layer, on ranks that share the card
        mesh_phase(args.seed, smi, card, torch.device("cuda"), root)
        # -- 8. result ------------------------------------------------------
        emit({"kernels": rows})
        emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                     "count": torch.cuda.device_count()}})
        return 0
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def run(root: Path, seed: int, cache_dir: str):
    """Phases 1–6 (all but the serving phase): returns the kernels line's
    rows, the card's name and its ``nvidia-smi`` line."""
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
    # B8 (static, its three dtypes), K1, K2, B1 and B2 (static, every
    # build; CTAs an SM of their f32 builds in 16-byte packs) and each of
    # K4's eight builds
    attributes["base_scan"] = hopper.kernel_attributes("base_scan")
    # B5 and B7 (the most over their builds; CTAs an SM of B5's f32 tile
    # in 16-byte loads and of B7's 16-byte loads) likewise
    for name in ("reduce_mul", "map_relu", "base_reduce", "base_relu",
                 "base_stencil1d", "base_spmm"):
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
    # R12: the most registers and local bytes over its instantiations
    attributes["ring_rescale_attention"] = hopper.kernel_attributes(
        "ring_rescale_attention")
    # K8 (its two tiles and the weights, as its entry and the wrapper's
    # mirror count them) and R9 at the main path's ring: depth 4 on the
    # DAG cell's 8-row blocks, the weights and the tiles its ring lands in
    attributes["dag_mlp"] = hopper.kernel_attributes("dag_mlp")
    attributes["dag_mlp"]["smemBytes"] = hopper.kernel_smem_bytes("dag_mlp")
    attributes["dag_mlp"]["smemMirror"] = hopper.MLP_STAGED_BYTES
    r9_smem = hopper.MLP_WEIGHT_BYTES + hopper.mlp_ring_tiles(
        DAG_MAIN_DEPTH, 8) * hopper.MLP_TILE_BYTES
    attributes["ring_dag_mlp"] = hopper.kernel_attributes("ring_dag_mlp",
                                                          r9_smem)
    attributes["ring_dag_mlp"]["smemBytes"] = r9_smem
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
    # the cluster cells (phase 4b; their device kernels traced in phase 2)
    cluster_inputs = {"dot": ((x, y), {}), "relu": ((xr,), {}),
                      "gemm": ((a, b), {}), "gemv": ((ga, gx), {}),
                      "stencil1d": ((xs, ws), {}),
                      "sum_sq_diff": ((x, y), {}),
                      "axpy_dot": ((x, y, w), {"alpha": 0.5})}
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
    # one K1 call on the dot cell its one kernel; one fused mlp_block call
    # K8's one, its unfused composition three;
    # one scan_2p26 call runs K14's one pass, one at GATHER_MAIN_DEPTH
    # R15's and one baseline call B8's (each after a memset of its state,
    # which is no kernel)
    k1_call = lowering.prepare_call(compiler.dot_product_nest(n_vec),
                                    reduction.MUL, {"A": x, "B": y})
    # the baselines' padded layouts, as their MonolithicKernels prepare them
    xp, yp = frontend.pad_vector(x), frontend.pad_vector(y)
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
        # K1 and B1 on the dot cell: one kernel each, its last CTA folding
        # the partials
        "dot_k1": (k1_call.run, 1, 1, ("reduce_mul_kernel<",)),
        "dot_b1": (lambda: hopper.base_reduce(xp, yp), 1, 1,
                   ("base_reduce_kernel<",)),
        # B5 on the stencil1d cell and B7 on spmm_hpcg's planes: one
        # kernel each
        "stencil1d_b5": (lambda: hopper.base_stencil1d(
            xs.reshape(1, -1), ws.reshape(1, -1)), 1, 1,
            ("base_stencil1d_kernel<",)),
        "spmm_b7": (lambda: hopper.base_spmm(sv, sc, sX), 1, 1,
                    ("base_spmm_kernel<",)),
        # K8 on the mlp_block cell: the fused call one kernel, the unfused
        # composition one a stage (the residual alone its own kernel)
        "mlp_block": (path["mlp_block"], 1, 1, ("dag_mlp_kernel<",)),
        "mlp_block_unfused": (path["mlp_block_unfused"], 3, 3,
                              ("dag_mlp_kernel<", "dag_mlp_residual<")),
        # each cluster cell's call at 1, 2, 4 and 8 cores: C cores' kernels
        # and the combine's or the assembly's (traced here, where the
        # run's traces are whole at the first try: after phase 4 most took
        # two, PERF.md §7)
        **cluster_traced_calls(dev, cluster_inputs)})
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
    # B1 likewise, to reduce_mul_model's bits at its own packs on K1's runs
    # (one element an access off 16 bytes); five B1 runs of the dot cell
    # give the main path's bits, and its run on the first block zeroed
    # differs; where B1 reads 16-byte f32 packs it is K1 to the bit

    def b1_model(key, x_, y_):
        xp_, yp_ = frontend.pad_vector(x_), frontend.pad_vector(y_)
        got_ = np.float32(float(hopper.base_reduce(xp_, yp_)))
        runs_, per_ = hopper.reduce_split(xp_.shape[0] // hopper.ROWS,
                                          sms)[:2]
        vec_ = hopper._vector_width((xp_, yp_), ())
        a_, b_ = (t.float().cpu().numpy() for t in (xp_, yp_))
        model = hopper.reduce_mul_model(a_, b_, per_, runs_, vec=vec_)
        checks[f"b1_model_{key}"] = {
            "exact": bool(got_.view(np.int32) == model.view(np.int32)),
            "abs_err": abs(float(got_) - float(model)), "limit": 0.0,
            "vec": vec_, "kernel": "base_reduce",
            "against": "hopper.reduce_mul_model"}

    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).removeprefix("torch.")
        b1_model(f"dot_{tag}", x.to(dt), y.to(dt))
        for n_ in (1000, (1 << 20) - 1024, (1 << 20) + 1024):
            b1_model(f"{tag}_{n_}",
                     torch.rand(n_, generator=gen, device=dev).to(dt),
                     torch.rand(n_, generator=gen, device=dev).to(dt))
    dot_b1 = main["dot_baseline"].reshape(-1)
    runs = [hopper.base_reduce(xp, yp) for _ in range(5)]
    xz = xp.clone()
    xz[:hopper.ROWS] = 0
    ctrl = hopper.base_reduce(xz, yp)
    checks["b1_dot_five_runs"] = {
        "exact": all(torch.equal(r_.reshape(-1), dot_b1) for r_ in runs)
        and not torch.equal(ctrl.reshape(-1), dot_b1),
        "abs_err": max(abs(float(r_) - float(dot_b1)) for r_ in runs),
        "limit": 0.0, "kernel": "base_reduce",
        "zeroed_block_control": float(ctrl)}
    b1_vec = hopper._vector_width((xp, yp), ())
    checks["b1_dot_is_k1"] = {
        "exact": b1_vec != 4 or torch.equal(dot_b1, main["dot"].reshape(-1)),
        "abs_err": abs(float(dot_b1) - float(main["dot"])), "limit": 0.0,
        "vec": b1_vec, "kernel": "base_reduce", "against": "reduce_mul"}
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
        # B2 on a view one element off a 16-byte boundary: one element an
        # access, against its plain version and K2 on the same view
        view = inp[1:1 + (1 << 20)]
        vp = frontend.pad_vector(view)
        got_b = hopper.base_relu(vp)
        errors["base_relu"] = max(
            errors["base_relu"],
            exact(f"{key}_baseline_misaligned", got_b,
                  base_plain["base_relu"](vp)))
        exact(f"{key}_baseline_misaligned_vs_ssr",
              frontend.trim_vector(got_b, view.numel()),
              relu.ssr_relu(view).reshape(-1))
        checks[f"{key}_baseline_misaligned"]["vec"] = \
            hopper._vector_width((vp,), ())
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
    # B5 to hopper.base_stencil1d_model's bits on the cell (tap 1's product
    # rounded, tap 0's fused onto it, taps 2 .. 10 by one FMA each), in f32
    # and on x rounded to bf16; five runs of the f32 cell one set of bits
    b5_w = bwt.reshape(-1).cpu().numpy()
    for tag, bx_ in (("f32", bx), ("bf16", bx.to(torch.bfloat16))):
        got_ = main["stencil1d_baseline"].reshape(-1) if tag == "f32" \
            else hopper.base_stencil1d(bx_, bwt).reshape(-1)
        model = torch.from_numpy(hopper.base_stencil1d_model(
            bx_.float().reshape(-1).cpu().numpy(), b5_w)).to(dev)
        runs = [got_] if tag != "f32" else \
            [got_] + [hopper.base_stencil1d(bx_, bwt).reshape(-1)
                      for _ in range(5)]
        checks[f"b5_model_stencil1d_{tag}"] = {
            "exact": all(torch.equal(r_.view(torch.int32),
                                     model.view(torch.int32)) for r_ in runs),
            "abs_err": max(float((r_ - model).abs().max()) for r_ in runs),
            "limit": 0.0, "runs": len(runs), "kernel": "base_stencil1d",
            "against": "hopper.base_stencil1d_model"}
        del model, runs, got_
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
    # K11 on danube's 96 live lanes against K11 told the head dim is 128
    # (every lane staged and summed), to the bit on the same zero-padded
    # layouts, beside its run on K's first block zeroed, which must differ
    dcall = att_calls["attention_danube"]

    def k11_at_dim(dim, layouts):
        prog = dcall.kernel.program
        program = dataclasses.replace(
            prog, params=(prog.params[0][:5] + (dim,),))
        return hopper.rescale_attention(dcall.kernel.geometry, layouts,
                                        dcall.kernel.out_dtype,
                                        program=program)
    live = k11_at_dim(ATTENTION_CELLS["attention_danube"][2], dcall.layouts)
    full = k11_at_dim(128, dcall.layouts)
    kz = dcall.layouts[0].clone()
    kz[:, :dcall.kernel.geometry.ins[0].block[0]] = 0
    zeroed = k11_at_dim(ATTENTION_CELLS["attention_danube"][2],
                        (kz, *dcall.layouts[1:]))
    checks["rescale_attention_live_lanes_danube"] = {
        "exact": bool(torch.equal(live.view(torch.int32),
                                  full.view(torch.int32))),
        "control_differs": not torch.equal(zeroed.view(torch.int32),
                                           live.view(torch.int32)),
        "abs_err": float((live - full).abs().max()), "limit": 0.0,
        "live_lanes": hopper.rescale_attention_tiles(
            ATTENTION_CELLS["attention_danube"][2], 128)["live"]}
    if not checks["rescale_attention_live_lanes_danube"]["control_differs"]:
        failed.append("rescale_attention_live_lanes_danube: the zeroed "
                      "first K block left the result unchanged")
    del live, full, kz, zeroed

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
    # B7 to hopper.base_spmm_model's bits on spmm_hpcg (each output the
    # fmaf chain over its row's 27 elements from 0, pads included); five
    # runs one set of bits
    b7_model = torch.from_numpy(hopper.base_spmm_model(
        sv.cpu().numpy(), sc.cpu().numpy(), sX.cpu().numpy())).to(dev)
    runs = [main["spmm_baseline"]] + [hopper.base_spmm(sv, sc, sX)
                                      for _ in range(5)]
    checks["b7_model_spmm_hpcg"] = {
        "exact": all(torch.equal(r_.view(torch.int32),
                                 b7_model.view(torch.int32)) for r_ in runs),
        "abs_err": max(float((r_ - b7_model).abs().max()) for r_ in runs),
        "limit": 0.0, "runs": len(runs), "vec": hopper._vector_width(
            (sX,), ()), "kernel": "base_spmm",
        "against": "hopper.base_spmm_model"}
    del b7_model, runs
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
                 *(f"rescale_attention_{lanes}_d{dim}"
                   for lanes, dim in K11_TILES), "ring_rescale_attention",
                 "base_scan", "reduce_mul", "map_relu", "base_reduce",
                 "base_relu",
                 *(f"contract_gemv_{b}" for b in hopper.GEMV_BUILDS)):
        local = attributes[name]["localSizeBytes"]
        checks[f"{name}_local_bytes"] = {
            "exact": local == 0, "local_bytes": local, "local_limit": 0,
            "abs_err": 0.0, "limit": 0.0}
    # B5 and B7 spill nothing in any build; their registers and CTAs an SM
    for name in ("base_stencil1d", "base_spmm"):
        checks[f"{name}_local_bytes"] = {
            "exact": attributes[name]["localSizeBytes"] == 0,
            "local_bytes": attributes[name]["localSizeBytes"],
            "local_limit": 0, "registers": attributes[name]["numRegs"],
            "ctas_per_sm": attributes[name]["ctasPerSm"],
            "abs_err": 0.0, "limit": 0.0}
    # B1's runs, one CTA each, are one wave at REDUCE_PER_SM CTAs an SM
    checks["base_reduce_ctas_per_sm"] = {
        "exact": attributes["base_reduce"]["ctasPerSm"]
        >= hopper.REDUCE_PER_SM,
        "ctas_per_sm": attributes["base_reduce"]["ctasPerSm"],
        "abs_err": 0.0, "limit": 0.0}
    # every K4 build reaches the CTAs an SM its one-wave split counts on
    k4_ctas = {b: attributes[f"contract_gemv_{b}"]["ctasPerSm"]
               for b in hopper.GEMV_BUILDS}
    checks["contract_gemv_ctas_per_sm"] = {
        "exact": all(c_ >= hopper.GEMV_PER_SM for c_ in k4_ctas.values()),
        "ctas_per_sm": k4_ctas, "abs_err": 0.0, "limit": 0.0}
    # K8 and R9 spill nothing, in any instantiation; K8's shared memory as
    # its entry counts it is the wrapper's mirror, within the opt-in limit;
    # R9's entry counts what the wrapper counts at the DAG rings' depths on
    # the cell's 8-row blocks (the weights and tiles of K8's instantiations,
    # the residual's step slots)
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for name in ("dag_mlp", "ring_dag_mlp"):
        local = attributes[name]["localSizeBytes"]
        checks[f"{name}_local_bytes"] = {
            "exact": local == 0, "local_bytes": local, "local_limit": 0,
            "ctas_per_sm": attributes[name]["ctasPerSm"],
            "registers": attributes[name]["numRegs"],
            "abs_err": 0.0, "limit": 0.0}
    k8_smem = attributes["dag_mlp"]
    checks["dag_mlp_smem_mirror"] = {
        "exact": k8_smem["smemBytes"] == k8_smem["smemMirror"] <= optin,
        "smem": k8_smem["smemBytes"], "mirror": k8_smem["smemMirror"],
        "optin": optin, "abs_err": 0.0, "limit": 0.0}
    r9_counts = {}
    geo_ = fused_calls["mlp_block"].kernel.geometry
    rows_ = geo_.out.block[0]
    for depth in (*RING_DEPTHS, (4, 2)):
        if isinstance(depth, tuple):      # the residual alone: H, Y slots
            entry = hopper.kernel_smem_bytes("ring_dag_mlp", 4, *depth, rows_)
            mirror = sum(depth) * rows_ * hopper.MLP_PITCH * 4
        else:
            entry = hopper.kernel_smem_bytes("ring_dag_mlp", 7, depth, 0,
                                             rows_)
            mirror = hopper._staged_bytes(
                "ring_dag_mlp", fused_calls["mlp_block"].kernel.program.ops,
                geo_, hopper.RingProgram((depth,), (False,)))
        r9_counts[str(depth)] = (entry, mirror)
    checks["ring_dag_mlp_smem_mirror"] = {
        "exact": all(e == m <= optin for e, m in r9_counts.values()),
        "entry_and_wrapper": r9_counts, "optin": optin, "abs_err": 0.0,
        "limit": 0.0}
    # K11's shared memory: the wrapper's mirror is the entry's count, and
    # each tile fits what a CTA may opt into
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

    def entry_fn(wrapper_call):
        """The C entry ``wrapper_call()`` launches, with the arguments its
        wrapper passes (and the output it allocated, kept alive): its device
        time without the wrapper's host work."""
        got = {}
        real = hopper._launch
        hopper._launch = lambda name, dev_, *a: got.update(name=name, args=a)
        try:
            out = wrapper_call()
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
            rows[-1].update(c_entry_ms=time_ms(entry_fn(kernel)),
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
            c_at = {2: time_ms(entry_fn(kernel_fn(cell_call(cell, 2))))}
            for depth in depths:
                c_at[depth] = time_ms(entry_fn(kernel_fn(
                    ring_calls[cell, depth])))
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

    # -- 4b. the cluster on the full-size cells -------------------------------
    cluster_phase(dev, cluster_inputs, smi)

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

    return rows, card, smi


if __name__ == "__main__":
    sys.exit(main())
