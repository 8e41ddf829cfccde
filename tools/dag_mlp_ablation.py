#!/usr/bin/env python3
"""K8 ``dag_mlp`` and R9 ``ring_dag_mlp`` beside their parent design, and
the PyTorch calls that compose the same block, in one process a tree.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 tools/dag_mlp_ablation.py [--seed 0] [--out FILE]
    python3 tools/dag_mlp_ablation.py --trees PARENT CHANGE [--out FILE]

With ``--trees`` the script measures each tree (a checkout, e.g. unpacked
by ``git archive``) in a process of its own, in the order parent, change,
change, parent, and reports each side as the mean of its two runs; without
it, the tree it sits in.  Each tree builds its own kernels under its own
``build/``.

The cell is chip_smoke.py's ``mlp_block``: x (2**19 rows of 128) ~ N(0, 1),
W1, W2 (128 × 128) and b1, b2 (128) ~ N(0, 0.1²), f32.

* ``digest``: a checksum of the bits of every instantiation a legal cut of
  the block runs (stages (0, 1, 2), (0,), (1,), (2,), (1, 2): K8's masks
  7, 1, 2, 4 and 6), each on the values the kernels before it produced,
  in 16-byte packs (``v4``) and, with x and the weights read through views
  4 bytes off a 16-byte boundary, in elements (``v1``); and of R9 on each
  at depths 3, 4 and 8 (the residual alone also at (4, 2)).  ``exact``:
  R9 to K8's bits at each of them, the residual on its first block zeroed
  differing (R9's control), every output finite.
* ``ms``: K8 fused through the main path's prepared call (``k8_fused``)
  and through its C entry with the arguments the wrapper passes
  (``k8_fused_entry``), each stage alone and the three unfused launches
  summed (``k8_unfused``), R9 fused at depth 4 (``r9_fused_4``, and its C
  entry), and the block composed of PyTorch calls (``composed``:
  ``addmm``, ``relu``, ``addmm``, ``+``, TF32 off; no single call computes
  it).
* K8's source variants (its source, or the header it includes, with some
  lines replaced, compiled into the tree's ``build/dag_mlp_ablation/``),
  launched through its C entry with the arguments the wrapper passes, on
  the fused cell: ``as_is``; ``dense_load`` (each row's address as row ×
  128 instead of through the streams' block walk: the same bytes on this
  cell's dense layout) and ``dense_store`` (the same for the output);
  ``unroll2`` (the k loop unrolled twice), ``no_read_ahead`` (the
  product's operands read where they are used, not a chunk ahead),
  ``threads128`` (CTAs of 128 threads, 8 x 8 outputs a thread, against
  256 of 4 x 8; also ``threads128_no_read_ahead``), ``threads512`` (2 x 8
  a thread), ``tile128_serial`` (one 128-row tile, 8 x 8 outputs a thread
  at 256 threads, each tile copied in after the last one's product; also
  without the read-ahead), ``three_tiles`` (K8 at R9's 232,448 bytes of
  shared memory, a third tile unused) and ``serial_fetch`` (each next
  tile waited for as soon as its copies are issued, so its read no longer
  hides behind the FMAs); and, wrong on purpose, to split the time:
  ``fixed_tile`` (every tile read from the first tile's rows: no HBM
  reads), ``no_store`` (outputs kept from device memory), ``no_product1``
  and ``no_product2`` (the hidden or the out stage's product skipped, its
  sums 0).  Null where the lines are not in the tree's source; the others
  held to ``as_is``'s bits.
* R9's source variants, likewise on the fused cell at depth 4 through its
  C entry: ``as_is``; ``hook8``, ``hook32``, ``hook64`` (its fetches
  issued every 8, 32 or 64 values of k of a product, against 128),
  ``no_read_ahead``, ``fetch_at_top`` (the next tile's steps all issued at
  the tile's barrier) and ``dense_fetch`` (a step's address as step ×
  rows × 128), held to K8's bits; and ``fixed_tile`` (every step read
  from the first block) and ``no_store``, wrong on purpose.
* ``host_ms``: the host time of one K8 and one R9 call (fused, issued back
  to back once warm): the wrapper's own work, with its launch.
* ``ptxas``: registers and spill bytes of each instantiation as ``nvcc
  -Xptxas -v`` printed them; ``attributes``: as the runtime reads them
  (registers, local bytes, CTAs an SM) and K8's shared memory as its entry
  and the wrapper count it, where the tree's port reports them.

The timed calls run in two turns (forward, then backward), each the median
of CUDA-event samples of back-to-back calls lasting about 2 ms; ``ms`` is
the mean of the turns' medians.  Prints one JSON line with the card's name
and power limit (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from scan_attention_ablation import (build_variant, card,  # noqa: E402
                                     host_ms, ptxas_counts, time_ms)

ROWS = 1 << 19
#: R9's depths on every instantiation, and the residual's per-stream pair
R9_DEPTHS = (3, 4, 8)
R9_PAIR = ((2,), (4, 2))
#: K8's variant → alternatives, each a tuple of (file, old, new)
#: replacements; the first alternative whose lines are all in the tree's
#: sources is built (the parent's lines first, then the change's)
_P_LOAD = ("        v = mlp_load4<V>(src + row_origin(ss, g, r0 + r, "
           "rows_per_step) + 4 * q);\n")
_P_STORE = ("      mlp_store_row<V>(out + row_origin(so, g, row, "
            "rows_per_step), c0, c1,\n                       acc[i]);\n")
_P_LOOP = "#pragma unroll 1\n  for (int k = 0; k < kMlpN; k += 4) {"
_C_LOAD = ("      row < rows_total ? row_origin(s, g, row, rows_per_step) "
           ": -1;\n")
_C_STORE = ("        srow < rows_total ? row_origin(so, g, srow, rows_per_step)"
            " : -1;\n")
_C_STORE_ROW = "      if (o >= 0) mlp_store_row<V>(out + o, c0, c1, acc[i]);\n"
_C_LOOP = ("#pragma unroll 1\n    for (int k = h * kMlpHookK; k < (h + 1) * "
           "kMlpHookK; k += 8) {")
#: the product's loop with the next chunk read ahead, and read where used
_C_AHEAD = ("    for (int k = h * kMlpHookK; k < (h + 1) * kMlpHookK; k += 8) {\n"
            "      c1.load(T, W, rt, ct, k + 4);\n"
            "      c0.fma(acc);\n"
            "      c0.load(T, W, rt, ct, (k + 8) & (kMlpN - 1));"
            "  // (the last: unused)\n"
            "      c1.fma(acc);\n")
_C_IN_PLACE = ("    for (int k = h * kMlpHookK; k < (h + 1) * kMlpHookK; k += 8) {\n"
               "      c0.load(T, W, rt, ct, k);\n"
               "      c0.fma(acc);\n"
               "      c0.load(T, W, rt, ct, k + 4);\n"
               "      c0.fma(acc);\n")
_C_THREADS = "constexpr int kMlpThreads = 256;"
#: (no change: only a tree whose thread tile follows kMlpThreads has it)
_C_PLACED = ("ssr_dag.cuh", "void mlp_place(", "void mlp_place(")
_C_NEXT = "    ssr_cp_async_commit();\n    mlp_tile<MASK>("
#: one 128-row tile (8 x 8 outputs a thread at 256 threads), each tile's
#: rows copied in after the last tile's product: the product's rate at the
#: parent's thread tile
_C_LOOP_TOP = ("  for (int b = 0; t < tiles_total; t += gridDim.x, b ^= 1) {\n"
               "    ssr_cp_async_wait<0>();\n")
_C_PREFETCH = ("    if (t + gridDim.x < tiles_total)\n"
               "      fetch(tiles + (b ^ 1) * kMlpTileFloats, t + gridDim.x);\n"
               "    ssr_cp_async_commit();\n")
_C_TILE128 = (
    ("ssr_dag.cuh", "constexpr int kMlpTile = 64;", "constexpr int kMlpTile = 128;"),
    ("ssr_dag.cuh", "kMlpWeightBytes + 2 * kMlpTileBytes;",
     "kMlpWeightBytes + 1 * kMlpTileBytes;"),
    ("dag_mlp.cu", _C_LOOP_TOP,
     "  for (int b = 0; t < tiles_total; t += gridDim.x) {\n"
     "    __syncthreads();\n    if (t != blockIdx.x) fetch(tiles, t);\n"
     "    ssr_cp_async_commit();\n    ssr_cp_async_wait<0>();\n"),
    ("dag_mlp.cu", _C_PREFETCH, ""))
K8_VARIANTS = {
    "as_is": ((),),
    "dense_load": (
        (("dag_mlp.cu", _P_LOAD,
          "        v = mlp_load4<V>(src + (r0 + r) * kN + 4 * q);\n"),),
        (("dag_mlp.cu", _C_LOAD, "      row < rows_total ? row * kN : -1;\n"),)),
    "dense_store": (
        (("dag_mlp.cu", _P_STORE,
          "      mlp_store_row<V>(out + row * kN, c0, c1, acc[i]);\n"),),
        (("dag_mlp.cu", _C_STORE,
          "        srow < rows_total ? srow * kN : -1;\n"),)),
    "unroll2": (
        (("ssr_dag.cuh", _P_LOOP, _P_LOOP.replace("unroll 1", "unroll 2")),),
        (("ssr_dag.cuh", _C_LOOP, _C_LOOP.replace("unroll 1", "unroll 2")),)),
    "no_read_ahead": (
        (("ssr_dag.cuh", _C_AHEAD, _C_IN_PLACE),),),
    "threads128": (
        (("ssr_dag.cuh", _C_THREADS, _C_THREADS.replace("256", "128")),
         _C_PLACED),),
    "threads512": (
        (("ssr_dag.cuh", _C_THREADS, _C_THREADS.replace("256", "512")),
         _C_PLACED),),
    "threads128_no_read_ahead": (
        (("ssr_dag.cuh", _C_THREADS, _C_THREADS.replace("256", "128")),
         ("ssr_dag.cuh", _C_AHEAD, _C_IN_PLACE)),),
    "tile128_serial": (_C_TILE128,),
    "tile128_serial_no_read_ahead": (
        (*_C_TILE128,
         ("ssr_dag.cuh", _C_AHEAD, _C_IN_PLACE)),),
    "three_tiles": (
        (("ssr_dag.cuh", "kMlpWeightBytes + 2 * kMlpTileBytes;",
          "kMlpWeightBytes + 3 * kMlpTileBytes;"),),),
    "serial_fetch": (
        (("dag_mlp.cu", _C_NEXT, _C_NEXT.replace(
            "    mlp_tile", "    ssr_cp_async_wait<0>();\n    mlp_tile")),),),
    "fixed_tile": (
        (("dag_mlp.cu", _P_LOAD,
          "        v = mlp_load4<V>(src + r * kN + 4 * q);\n"),),
        (("dag_mlp.cu", _C_LOAD,
          "      row < rows_total ? (row - r0) * kN : -1;\n"),)),
    "no_store": (
        (("dag_mlp.cu", _P_STORE,
          "      if (acc[i][0] == 1.25e-38f)\n" + _P_STORE),),
        (("dag_mlp.cu", _C_STORE_ROW, _C_STORE_ROW.replace(
            "o >= 0", "o >= 0 && acc[i][0] == 1.25e-38f")),)),
    "no_product1": (
        (("ssr_dag.cuh", "    mlp_tile_product(T, W1s, ty, c0, c1, acc);\n",
          "    for (int i = 0; i < 8; ++i)\n      for (int j = 0; j < 8; ++j)"
          " acc[i][j] = 0.f;\n"),),
        (("ssr_dag.cuh", "    mlp_tile_product(T, W1s, rt, ct, acc, 0, hook);\n",
          "    mlp_zero(acc);\n"),)),
    "no_product2": (
        (("ssr_dag.cuh", "    mlp_tile_product(T, W2s, ty, c0, c1, acc);\n",
          "    for (int i = 0; i < 8; ++i)\n      for (int j = 0; j < 8; ++j)"
          " acc[i][j] = 0.f;\n"),),
        (("ssr_dag.cuh",
          "    mlp_tile_product(T, W2s, rt, ct, acc, kH ? kMlpN / kMlpHookK : 0,"
          " hook);\n",
          "    mlp_zero(acc);\n"),)),
}
_C_HOOK = "constexpr int kMlpHookK = 128;"
#: R9's variants, as K8's: its hook points every 8, 32 or 64 values of k
#: (against 128)
R9_VARIANTS = {
    "as_is": ((),),
    **{f"hook{k}": ((("ssr_dag.cuh", _C_HOOK, _C_HOOK.replace("128", str(k))),),)
       for k in (8, 32, 64)},
    "dense_fetch": ((
        ("ring_dag_mlp.cu", "          at = ssr_block_origin(sx, g, step);",
         "          at = step * rows * kN;"),),),
    "fixed_tile": ((
        ("ring_dag_mlp.cu", "          at = ssr_block_origin(sx, g, step);",
         "          at = 0;"),),),
    "no_store": ((
        ("ring_dag_mlp.cu",
         "      if (o >= 0) mlp_store_row<V>(out + o, c0, c1, acc[r]);",
         "      if (o >= 0 && acc[r][0] == 1.25e-38f)\n"
         "        mlp_store_row<V>(out + o, c0, c1, acc[r]);"),),),
    "no_read_ahead": ((("ssr_dag.cuh", _C_AHEAD, _C_IN_PLACE),),),
    "fetch_at_top": ((
        ("ring_dag_mlp.cu", "    ahead = i + 1 < mine ? steps_of(i + 1) : 0;\n",
         "    ahead = i + 1 < mine ? steps_of(i + 1) : 0;\n    hook(kQ - 1);\n"
         "    auto no_hook = [](int) {};\n"),
        ("ring_dag_mlp.cu", "                   acc, hook);",
         "                   acc, no_hook);")),),
}
#: K8's and R9's variants that compute wrong values on purpose
K8_INEXACT = ("fixed_tile", "no_store", "no_product1", "no_product2")


def pick_variant(csrc: Path, alternatives) -> tuple | None:
    """The first alternative whose replaced lines are all in the sources."""
    for subs in alternatives:
        if all(old in (csrc / name).read_text() for name, old, _ in subs):
            return subs
    return None


def measure_tree(root: Path, seed: int) -> dict:
    """Every number of one tree, in this process."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.core import autotune, hopper, lowering
    from repro_torch.kernels import dag

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    logs = hopper.build(("dag_mlp", "ring_dag_mlp"))
    ptxas = {n: ptxas_counts(log) for n, log in logs.items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    stream = torch.cuda.current_stream().cuda_stream
    timed, exact, digest, attributes, host = {}, {}, {}, {}, {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def bits(t):
        return t.contiguous().view(torch.int32)

    def checksum(t) -> str:
        b = bits(t).reshape(-1).to(torch.int64)
        w = torch.arange(1, b.numel() + 1, device=b.device) % 65521
        return f"{int(b.sum())}:{int((b * w).sum())}"

    def grabbed(fn):
        got = {}
        real = hopper._launch

        def grab(name, dev_, *args):
            got["name"], got["args"] = name, list(args)
        hopper._launch = grab
        try:
            out = fn()
        finally:
            hopper._launch = real
        return got["name"], out, got["args"]

    def entry(name, args, keep):
        fn = getattr(hopper._lib(name), f"ssr_{name}")

        def call(fn=fn, a=tuple(args)):
            rc = fn(*a, stream)
            if rc != 0:
                raise SystemExit(f"{name}: CUDA error {rc}")
        keep.append(args)
        return call

    def off16(t):
        """``t`` as a view 4 bytes off a 16-byte boundary."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    def instance_call(inst, sched):
        nests, bodies, env, mode, uniforms = inst
        if len(nests) == 1:
            return lowering.prepare_call(nests[0], bodies[0], env, mode=mode,
                                         schedule=sched, uniforms=uniforms)
        return lowering.prepare_dag_call(nests, bodies, env, mode=mode,
                                         schedule=sched, uniforms=uniforms)

    def instances(args):
        """Every instantiation of a legal cut, on the values the kernels
        before it produced: stages -> (call inputs, K8's output)."""
        case = {c.name: c for c in dag.dag_cases()}["mlp_block"]
        nests, bodies, operands, mode, uniforms = case.spec(*args)
        graph = lowering._dag_for(nests, None)
        out = {}
        for cut in autotune.enumerate_cuts(graph):
            if not autotune.dag_cut_is_legal(
                    graph, cut, nests=nests, bodies=bodies, mode=mode,
                    uniforms=uniforms, device=dev)[0]:
                continue
            env = dict(operands)
            for comp in lowering.dag_components(graph, nests, bodies, cut,
                                                mode=mode):
                inst = (comp.nests, comp.bodies, dict(env), comp.mode,
                        uniforms)
                if comp.stages not in out:
                    out[comp.stages] = (inst, instance_call(
                        inst, lowering.DEFAULT_SCHEDULE).run())
                if comp.exported is not None:
                    env[comp.exported] = out[comp.stages][1]
        return out

    x = randn(ROWS, 128)
    w1, w2 = randn(128, 128) * 0.1, randn(128, 128) * 0.1
    b1, b2 = randn(128) * 0.1, randn(128) * 0.1
    keep = []
    v4 = instances((x, w1, b1, w2, b2))
    v1 = instances(tuple(off16(t) for t in (x, w1, b1, w2, b2)))
    for tag, insts in (("v4", v4), ("v1", v1)):
        for stages, (inst, k8) in insts.items():
            name = "".join(map(str, stages))
            digest[f"k8_{name}_{tag}"] = checksum(k8)
            exact[f"k8_{name}_{tag}/finite"] = bool(torch.isfinite(k8).all())
            scheds = [lowering.Schedule(buffer_depth=d) for d in R9_DEPTHS]
            if stages == R9_PAIR[0]:
                scheds.append(lowering.Schedule(stream_depths=R9_PAIR[1]))
            for sched in scheds:
                depth = sched.stream_depths or sched.buffer_depth
                dn = "_".join(map(str, depth)) if isinstance(depth, tuple) \
                    else str(depth)
                rc = instance_call(inst, sched)
                r9 = rc.run()
                digest[f"r9_{name}_{tag}_{dn}"] = checksum(r9)
                exact[f"r9_{name}_{tag}_{dn}/is_k8"] = bool(
                    rc.kernel.pipelined and torch.equal(bits(r9), bits(k8)))
                if stages == (2,) and sched.buffer_depth == 4:
                    zl = [t.clone() for t in rc.layouts]
                    zl[0][:8].zero_()          # H's first block
                    ctrl = rc.finish(rc.kernel(*zl))
                    exact[f"r9_{name}_{tag}_{dn}/control_differs"] = \
                        not torch.equal(bits(ctrl), bits(k8))
                    del zl, ctrl
                del r9
    # -- the timed calls (fused cell, 16-byte packs) -----------------------
    fused_inst = v4[(0, 1, 2)][0]
    fc = instance_call(fused_inst, lowering.DEFAULT_SCHEDULE)
    rc4 = instance_call(fused_inst, lowering.Schedule(buffer_depth=4))
    keep += [fc, rc4]
    timed["k8_fused"] = lambda: fc.kernel(*fc.layouts)
    timed["r9_fused_4"] = lambda: rc4.kernel(*rc4.layouts)
    host["k8_fused"] = host_ms(timed["k8_fused"], torch)
    host["r9_fused_4"] = host_ms(timed["r9_fused_4"], torch)
    name, out, args = grabbed(timed["k8_fused"])
    keep.append(out)
    timed["k8_fused_entry"] = entry(name, args, keep)
    k8_args = args
    rname, rout, rargs = grabbed(timed["r9_fused_4"])
    keep.append(rout)
    timed["r9_fused_4_entry"] = entry(rname, rargs, keep)
    stage_calls = [instance_call(v4[(k,)][0], lowering.DEFAULT_SCHEDULE)
                   for k in range(3)]
    keep += stage_calls
    for k, c in enumerate(stage_calls):
        timed[f"k8_stage{k}"] = (lambda c=c: c.kernel(*c.layouts))
    timed["k8_unfused"] = lambda: [c.kernel(*c.layouts) for c in stage_calls]

    def composed():
        h = torch.relu(torch.addmm(b1, x, w1))
        return torch.addmm(b2, h, w2) + h
    timed["composed"] = composed
    # -- the source variants, built together -------------------------------
    vroot = root / "build" / "dag_mlp_ablation"
    todo = {**{("dag_mlp", v): pick_variant(hopper.CSRC, alts)
               for v, alts in K8_VARIANTS.items()},
            **{("ring_dag_mlp", v): pick_variant(hopper.CSRC, alts)
               for v, alts in R9_VARIANTS.items()}}
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        built = dict(zip(todo, pool.map(
            lambda kv: None if kv[1] is None else build_variant(
                hopper.CSRC, vroot / "_".join(kv[0]), kv[0][0], kv[1]),
            todo.items())))
    want = bits(fc.finish(fc.kernel(*fc.layouts)))
    for (kernel, var), b in built.items():
        ptxas[f"{kernel}/{var}"] = None if b is None else \
            {k: v for k, v in b.items() if k != "so"}
        if b is None:
            continue
        fn = getattr(ctypes.CDLL(b["so"]), f"ssr_{kernel}")
        fn.argtypes = hopper._SIGNATURES[kernel]
        fn.restype = ctypes.c_int
        o = torch.zeros_like(out)
        ptr = out.data_ptr() if kernel == "dag_mlp" else rout.data_ptr()
        a = [o.data_ptr() if v == ptr else v
             for v in (k8_args if kernel == "dag_mlp" else rargs)]
        keep += [o, a]

        def call_(fn=fn, a=a, t=f"{kernel} {var}"):
            rc = fn(*a, stream)
            if rc != 0:
                raise SystemExit(f"{t}: CUDA error {rc}")
        call_()
        torch.cuda.synchronize()
        tag = "k8" if kernel == "dag_mlp" else "r9"
        if var not in K8_INEXACT:
            exact[f"{tag}_variant_{var}_is_k8"] = bool(torch.equal(
                bits(fc.finish(o)), want))
        timed[f"{tag}_fused{'' if tag == 'k8' else '_4'}_entry/{var}"] = call_
    # -- registers, local bytes, CTAs an SM, shared memory -----------------
    for key in ("dag_mlp", "ring_dag_mlp"):
        try:
            smem = () if key == "dag_mlp" else (
                hopper.MLP_WEIGHT_BYTES + hopper.mlp_ring_tiles(4, 8)
                * hopper.MLP_TILE_BYTES,)
            attributes[key] = hopper.kernel_attributes(key, *smem)
        except (AttributeError, TypeError, RuntimeError) as e:
            attributes[key] = f"not reported: {type(e).__name__}"
    attributes["dag_mlp_smem"] = {
        "entry": hopper.kernel_smem_bytes("dag_mlp"),
        "mirror": getattr(hopper, "MLP_STAGED_BYTES", None)}
    # -- the turns ---------------------------------------------------------
    keys = list(timed)
    medians = {k: [] for k in keys}
    for k in [*keys, *reversed(keys)]:
        medians[k].append(statistics.median(time_ms(timed[k], torch)))
    ms = {k: statistics.mean(v) for k, v in medians.items()}
    return {"root": str(root), "exact": exact, "digest": digest, "ms": ms,
            "host_ms": host, "ptxas": ptxas, "attributes": attributes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trees", nargs=2, type=Path, default=None,
                    metavar=("PARENT", "CHANGE"))
    ap.add_argument("--tree", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("dag_mlp_ablation: needs a CUDA device")
    if args.tree is not None:          # one run, in a process of its own
        print(json.dumps(measure_tree(args.tree.resolve(), args.seed)))
        return 0
    smi = card()
    trees = {"change": [HERE.parent]} if args.trees is None else \
        {"parent": [args.trees[0]], "change": [args.trees[1]]}
    order = (("change", 0),) if args.trees is None else \
        (("parent", 0), ("change", 0), ("change", 0), ("parent", 0))
    runs = {side: [] for side in trees}
    for side, i in order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--tree",
             str(trees[side][i].resolve()), "--seed", str(args.seed)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{side} run failed:\n{proc.stderr[-4000:]}")
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    sides = {}
    for side, rs in runs.items():
        ms = {k: statistics.mean(r["ms"][k] for r in rs) for k in rs[0]["ms"]}
        sides[side] = {"ms": ms, "runs_ms": [r["ms"] for r in rs],
                       "exact": {k: all(r["exact"].get(k, False) for r in rs)
                                 for k in rs[0]["exact"]},
                       "digest": rs[0]["digest"],
                       "same_digest_in_runs": all(
                           r["digest"] == rs[0]["digest"] for r in rs),
                       "host_ms": {k: statistics.mean(r["host_ms"][k]
                                                      for r in rs)
                                   for k in rs[0]["host_ms"]},
                       "ptxas": rs[0]["ptxas"],
                       "attributes": rs[0]["attributes"]}
    result = {"phase": "dag_mlp_ablation", "card": smi,
              "device": torch.cuda.get_device_name(0), "sides": sides}
    if "parent" in sides:
        pd, cd = sides["parent"]["digest"], sides["change"]["digest"]
        result["same_bits_as_parent"] = {k: pd.get(k) == v
                                         for k, v in cd.items()}
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    ok = all(all(s["exact"].values()) and s["same_digest_in_runs"]
             for s in sides.values()) and all(
        result.get("same_bits_as_parent", {}).values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
