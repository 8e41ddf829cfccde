#!/usr/bin/env python3
"""K1 ``reduce_mul`` and K2 ``map_relu`` beside their parent designs, their
baselines B1 and B2, the kernels and compositions that share their code
paths, and one PyTorch call for each function, in one process a tree.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 tools/reduce_relu_ablation.py [--seed 0] [--out FILE]
    python3 tools/reduce_relu_ablation.py --trees PARENT CHANGE [--out FILE]

With ``--trees`` the script measures each tree (a checkout, e.g. unpacked
by ``git archive``) in a process of its own, in the order parent, change,
change, parent, and reports each side as the mean of its two runs; without
it, the tree it sits in.  Each tree builds its own kernels under its own
``build/``.

The cells are chip_smoke.py's: ``dot`` (x, y ~ U[0, 1), n = 2**26, f32,
and the same rounded to bf16) and ``relu`` (x ~ N(0, 1), n = 2**26, its
first five elements -0, +0, NaN, -inf, +inf, in f32 and rounded to bf16;
int32 in ±2**30).

* Each of K1, K2, B1 and B2 through its wrapper (back-to-back calls, as
  chip_smoke.py's kernels line times it) and its C entry with the
  wrapper's arguments (``_entry``), with ``host_ms``, the host's time to
  issue one wrapper call, beside ``torch.dot`` or ``torch.relu`` on the same
  tensors (``library``).  K1 and B1 split into their device kernels and
  memsets by a ``torch.profiler`` trace (``split``: ms a call by name; the
  parent's K1 is the partials kernel, then the one-CTA fold).
* The neighbours: R1 and R2 at depth 4 through their wrappers and C
  entries; the unfused compositions that launch K1 or K2 (axpy_dot's K5
  map then K1, gemv_relu's K4 then K2, stencil1d_relu's K9 then K2: each
  stage's wrapper in turn, ``*_unfused``); K4 on gemv 8192**2 (wrapper and
  C entry).
* Source variants of this change's K1 and K2 (the tree's source, or a
  header it includes, with some lines replaced, compiled into the tree's
  ``build/reduce_relu_ablation/``), launched through the C entry with the
  wrapper's arguments (K1's with a scratch of their own): K2 ``ahead2``/
  ``ahead8`` (packs read ahead, against 4), ``ctas6``/``ctas8`` (built for
  that many 256-thread CTAs an SM, against 4),
  ``evict_first`` (x by ld.global.cs), ``stream_stores`` (the output by
  st.global.cs), ``threads256`` (bf16 on 256-thread CTAs, half of them
  idle, as the parent) and ``split64``/``split256`` (K2's own build on the
  split of 64 or 256 CTAs an SM asked for, against 128); K1 ``ahead2``
  (against 4), ``ctas3`` (3 CTAs an SM, each CTA on that split's runs,
  against 4), ``plain_loads`` (a and b without
  ld.global.cs), ``threadfence`` (the ticket taken by atomicAdd between
  two __threadfence, not by an acquire-release atomic), ``two_launches``
  (the fold as a second one-CTA launch,
  ``ssr_fold_partials``) and ``ticket_memset`` (the ticket zeroed by a
  memset before each launch, not by the last CTA).  Null where the lines
  are not in the tree's source (a parent tree builds none); each held to
  the tree's own bits.  Earlier rounds' variants (K1 with 6 or 8 packs
  ahead, or 5, 6 or 8 CTAs an SM, spilled at the registers those allow)
  are in PERF.md, with K2's split of 32.
* ``wrapper_split``: K1's and K2's wrappers in their parts, each timed
  alone on the host (``time.perf_counter``, mean of many calls): the key,
  the memo's lookup, ``torch.empty`` of the output, the scratch
  (``_work``), ``_launch`` and the whole call; on a tree with the memo.
* ``digest``: a checksum of each output's bits, so that two trees' outputs
  compare to the bit: K1 in f32 and bf16, R1, B1, K2 in the three dtypes,
  R2, B2, the compositions, K4.
* ``ptxas``: registers and spill bytes of each kernel's instantiations as
  ``nvcc -Xptxas -v`` printed them; ``attributes``: as the runtime reads
  them (registers, local bytes, CTAs an SM), where the tree's port reports
  them.

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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from scan_attention_ablation import (build_variant, card,  # noqa: E402
                                     ptxas_counts, split_ms, time_ms)

N = 1 << 26
GEMV = 8192
_K2_AHEAD = "constexpr int kAhead = 4;"
_K2_CTAS = "constexpr int kMinCtas = 4;"
_K1_AHEAD = "constexpr int kAhead = 4;"
_K1_CTAS = "constexpr int kMinCtas = 4;"
_K1_LAUNCH = ("  const int64_t ctas = (runs + runs_per_cta - 1) / "
              "runs_per_cta;\n")
_K1_LAUNCHED = ("runs, runs_per_cta);\n"
                "  return static_cast<int>(cudaGetLastError());\n")
#: (kernel, variant) → (file, old, new) replacements
VARIANTS = {
    **{("map_relu", f"ahead{n}"): (("map_relu.cu", _K2_AHEAD,
                                     _K2_AHEAD.replace("4", str(n))),)
       for n in (2, 8)},
    **{("map_relu", f"ctas{n}"): (("map_relu.cu", _K2_CTAS,
                                    _K2_CTAS.replace("4", str(n))),)
       for n in (6, 8)},
    # K2's own build on other splits of the steps (K2_SPLIT)
    **{("map_relu", f"split{n}"): () for n in (64, 256)},
    # the flat walk's stores by st.global.cs, its loads by ld.global.cs
    ("map_relu", "stream_stores"): (
        ("map_relu.cu",
         "*reinterpret_cast<Words*>(po + u * dout) = ssr_relu_pack<T, V>(p[u]);",
         "__stcs(reinterpret_cast<Words*>(po + u * dout), "
         "ssr_relu_pack<T, V>(p[u]));"),),
    ("map_relu", "evict_first"): (
        ("map_relu.cu",
         "p[u] = *reinterpret_cast<const Words*>(px + u * dx);",
         "p[u] = ssr_load_once(reinterpret_cast<const Words*>(px + u * dx));"),),
    ("map_relu", "threads256"): (
        ("map_relu.cu", "return sizeof(T) == 2 && V == 8 ? 128 : 256;",
         "return 256;"),),
    ("reduce_mul", "ahead2"): (("reduce_mul.cu", _K1_AHEAD,
                                _K1_AHEAD.replace("4", "2")),),
    ("reduce_mul", "ctas3"): (("reduce_mul.cu", _K1_CTAS,
                               _K1_CTAS.replace("4", "3")),),
    ("reduce_mul", "plain_loads"): (("ssr_run.cuh", "  return __ldcs(p);",
                                     "  return *p;"),),
    # the fold as the parent's second launch: the shared ssr_fold_partials
    ("reduce_mul", "two_launches"): (
        ("reduce_mul.cu", '#include "ssr_run.cuh"\n',
         '#include "ssr_run.cuh"\n#include "ssr_rows.cuh"\n'),
        ("reduce_mul.cu",
         "  // the last CTA to publish its partials folds them all:",
         "  return;\n  // the last CTA to publish its partials folds them all:"),
        ("reduce_mul.cu", _K1_LAUNCHED,
         "runs, runs_per_cta);\n"
         "  const cudaError_t err = cudaGetLastError();\n"
         "  if (err != cudaSuccess) return static_cast<int>(err);\n"
         "  ssr_fold_partials<<<1, kFoldThreads, 0, st>>>(part, runs, out);\n"
         "  return static_cast<int>(cudaGetLastError());\n")),
    # the ticket after a __threadfence (atomicAdd), not by an
    # acquire-release atomic
    ("reduce_mul", "threadfence"): (
        ("reduce_mul.cu",
         "    last = ssr_take_ticket(ticket) == gridDim.x - 1;\n",
         "  {\n    __threadfence();\n"
         "    last = atomicAdd(ticket, 1u) == gridDim.x - 1;\n  }\n"),
        ("reduce_mul.cu", "  if (!last) return;\n",
         "  if (!last) return;\n  __threadfence();\n")),
    ("reduce_mul", "ticket_memset"): (
        ("reduce_mul.cu",
         "    *ticket = 0u;      // ready for the next launch on this stream\n",
         ""),
        ("reduce_mul.cu", _K1_LAUNCH,
         "  cudaMemsetAsync(ticket, 0, sizeof(unsigned), st);\n"
         + _K1_LAUNCH)),
}
#: K1's variants built for other CTAs an SM than the wrapper's
K1_PER_SM = {"ctas3": 3}
#: K2's variants on other splits: CTAs an SM asked for (K2's own, 128)
K2_SPLIT = {"split64": 64, "split256": 256}


def measure_tree(root: Path, seed: int) -> dict:
    """Every number of one tree, in this process."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.core import compiler, hopper, lowering
    from repro_torch.kernels import (chained, frontend, gemv, reduction,
                                     relu, stencil)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("reduce_mul", "map_relu", "base_reduce", "base_relu",
             "ring_reduce_mul", "ring_map_relu", "chain_elem",
             "contract_gemv", "halo_stencil1d")
    logs = hopper.build(names)
    ptxas = {n: ptxas_counts(log) for n, log in logs.items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    timed, exact, digest, split, host, keep = {}, {}, {}, {}, {}, []
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def bits(t):
        return t.contiguous().view(
            torch.int16 if t.element_size() == 2 else torch.int32)

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

    def entry(fn):
        """The C entry ``fn()``'s wrapper launches, with its arguments."""
        name, out, args = grabbed(fn)
        keep.extend([out, args])
        f = getattr(hopper._lib(name), f"ssr_{name}")
        f.argtypes = hopper._SIGNATURES[name]
        f.restype = ctypes.c_int

        def call(a=tuple(args)):
            rc = f(*a, stream)
            if rc != 0:
                raise SystemExit(f"{name}: CUDA error {rc}")
        return call, name, out, args

    def wrapper(call):
        kern = call.kernel
        dk, kw = kern.device_kernel(), kern.device_args()
        return lambda: dk(kern.geometry, call.layouts, kern.out_dtype,
                          kern.acc_dtype, **kw)

    def issue_ms(fn, calls=200) -> float:
        """The host's time to issue one call of ``fn``, back to back."""
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = (time.perf_counter() - t0) / calls * 1e3
        torch.cuda.synchronize()
        return dt

    # -- the source variants, built together -------------------------------
    vroot = root / "build" / "reduce_relu_ablation"
    # the variants are of this change's designs (K1's one launch)
    todo = VARIANTS if hasattr(hopper, "reduce_split") else {}
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        built = dict(zip(todo, pool.map(
            lambda kv: build_variant(hopper.CSRC, vroot / "_".join(kv[0]),
                                     kv[0][0], kv[1]), todo.items())))
    for (kernel, v), b in built.items():
        ptxas[f"{kernel}/{v}"] = None if b is None else \
            {k: x for k, x in b.items() if k != "so"}

    def variants_of(kernel, fn, key, n_in):
        """Each built variant of ``kernel`` launched with the arguments its
        wrapper passes in ``fn()``, into an output of its own, beside the
        tree's own output; K1's built for other CTAs an SM on that split."""
        want = fn()
        _, name, out, args = entry(fn)
        for (k, v), b in built.items():
            if k != kernel or b is None:
                continue
            o = torch.empty_like(out)
            a = list(args)
            a[n_in] = o.data_ptr()           # the output
            if kernel == "reduce_mul":       # a scratch (ticket) of its own
                runs = a[n_in + 7]
                work = torch.zeros(runs + 1, dtype=torch.int32, device=dev)
                keep.append(work)
                a[n_in + 1] = work.data_ptr()
                if v in K1_PER_SM:
                    a[n_in + 9] = hopper._fewest_on_an_sm(
                        runs, K1_PER_SM[v], sms)
            if kernel == "map_relu" and v in K2_SPLIT:
                a[n_in + 6], a[n_in + 7] = hopper._k_split(
                    N // (hopper.ROWS * hopper.LANES), K2_SPLIT[v] * sms)
            f = getattr(ctypes.CDLL(b["so"]), f"ssr_{name}")
            f.argtypes = hopper._SIGNATURES[name]
            f.restype = ctypes.c_int
            keep.extend([o, a, want])

            def run(f=f, a=tuple(a), v=v):
                rc = f(*a, stream)
                if rc != 0:
                    raise SystemExit(f"{name}/{v}: CUDA error {rc}")
            run()
            run()
            torch.cuda.synchronize()
            exact[f"{key}/variant_{v}_is_as_is"] = bool(
                torch.equal(bits(o), bits(want)))
            timed[key, f"{kernel}_entry/{v}"] = run

    def time_pair(key, kname, fn):
        """``fn`` (a wrapper call) and its C entry, timed; its host time."""
        timed[key, kname] = fn
        timed[key, f"{kname}_entry"] = entry(fn)[0]
        host[f"{key}/{kname}"] = issue_ms(fn)

    # -- dot: K1, B1, R1 at depth 4 ----------------------------------------
    x = torch.rand(N, generator=gen, device=dev)
    y = torch.rand(N, generator=gen, device=dev)
    deep = lowering.Schedule(buffer_depth=4)
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        xd, yd = x.to(dt), y.to(dt)
        keep.extend([xd, yd])
        key = f"dot_{tag}"
        nest = compiler.dot_product_nest(N)
        call = lowering.prepare_call(nest, reduction.MUL, {"A": xd, "B": yd})
        if tag == "f32":
            dot_f32_call = call
        k1 = wrapper(call)
        got = k1()
        digest[f"{key}/reduce_mul"] = checksum(got)
        exact[f"{key}/k1_twice"] = bool(torch.equal(bits(k1()), bits(got)))
        time_pair(key, "reduce_mul", k1)
        split[f"{key}/reduce_mul"] = split_ms(k1, root)
        xp, yp = frontend.pad_vector(xd), frontend.pad_vector(yd)
        keep.extend([xp, yp, call])
        b1 = (lambda xp=xp, yp=yp: hopper.base_reduce(xp, yp))
        digest[f"{key}/base_reduce"] = checksum(b1())
        time_pair(key, "base_reduce", b1)
        split[f"{key}/base_reduce"] = split_ms(b1, root)
        ring = lowering.prepare_call(nest, reduction.MUL, {"A": xd, "B": yd},
                                     schedule=deep)
        keep.append(ring)
        r1 = wrapper(ring)
        digest[f"{key}/ring_reduce_mul_4"] = checksum(r1())
        exact[f"{key}/r1_is_k1"] = bool(torch.equal(bits(r1()), bits(got)))
        time_pair(key, "ring_reduce_mul_4", r1)
        timed[key, "library"] = lambda xd=xd, yd=yd: torch.dot(xd, yd)
        if tag == "f32":
            variants_of("reduce_mul", k1, key, 2)
    # -- relu: K2, B2, R2 at depth 4 ---------------------------------------
    xr = torch.randn(N, generator=gen, device=dev)
    xr[:5] = torch.tensor([-0.0, 0.0, float("nan"), float("-inf"),
                           float("inf")])
    xi = torch.randint(-(1 << 30), 1 << 30, (N,), generator=gen, device=dev,
                       dtype=torch.int32)
    for xx, tag in ((xr, "f32"), (xr.bfloat16(), "bf16"), (xi, "int32")):
        keep.append(xx)
        key = f"relu_{tag}"
        nest = compiler.elementwise_nest(N)
        call = lowering.prepare_call(nest, relu.RELU, {"X": xx}, mode="map",
                                     out_dtype=xx.dtype)
        if tag == "f32":
            relu_f32_call = call
        k2 = wrapper(call)
        got = k2()
        digest[f"{key}/map_relu"] = checksum(got)
        # past the five odd values (K2 gives -0 → +0 and keeps a NaN's
        # payload, bit for bit as jnp.maximum; torch.relu need not)
        exact[f"{key}/k2_is_torch_relu"] = bool(torch.equal(
            bits(got.reshape(-1)[5:N]), bits(torch.relu(xx)[5:])))
        time_pair(key, "map_relu", k2)
        xp = frontend.pad_vector(xx)
        keep.extend([xp, call])
        b2 = (lambda xp=xp: hopper.base_relu(xp))
        digest[f"{key}/base_relu"] = checksum(b2())
        time_pair(key, "base_relu", b2)
        ring = lowering.prepare_call(nest, relu.RELU, {"X": xx}, mode="map",
                                     out_dtype=xx.dtype, schedule=deep)
        keep.append(ring)
        r2 = wrapper(ring)
        digest[f"{key}/ring_map_relu_4"] = checksum(r2())
        exact[f"{key}/r2_is_k2"] = bool(torch.equal(bits(r2()), bits(got)))
        time_pair(key, "ring_map_relu_4", r2)
        timed[key, "library"] = lambda xx=xx: torch.relu(xx)
        if tag in ("f32", "bf16"):
            variants_of("map_relu", k2, key, 1)
    # -- the compositions that launch K1 or K2, and K4 ---------------------
    w = torch.rand(N, generator=gen, device=dev)
    pair2 = compiler.elementwise_nest(N, ("X", "Y"), 2)
    ax_call = lowering.prepare_call(pair2, chained.axpy_block(0.5),
                                    {"X": x, "Y": y}, mode="map")
    t_ax = wrapper(ax_call)()
    dot_call = lowering.prepare_call(
        compiler.elementwise_nest(N, ("T", "W"), 1), chained.DOT,
        {"T": t_ax, "W": w})
    ga = torch.randn(GEMV, GEMV, generator=gen, device=dev)
    gx = torch.randn(GEMV, generator=gen, device=dev)
    gv_call = lowering.prepare_call(compiler.gemv_nest(GEMV, GEMV),
                                    gemv.MATVEC, {"A": ga, "x": gx})
    y_gv = wrapper(gv_call)()
    gr_call = lowering.prepare_call(compiler.elementwise_nest(GEMV),
                                    relu.RELU, {"X": y_gv}, mode="map",
                                    out_dtype=torch.float32)
    xs = torch.randn(N + stencil.TAPS - 1, generator=gen, device=dev)
    ws = torch.randn(stencil.TAPS, generator=gen, device=dev) * 0.3
    st_call = lowering.prepare_call(
        compiler.stencil_nest(N, stencil.TAPS), stencil.STENCIL1D,
        {"x": xs, "w": ws})
    y_st = wrapper(st_call)()
    sr_call = lowering.prepare_call(compiler.elementwise_nest(N), relu.RELU,
                                    {"X": y_st}, mode="map",
                                    out_dtype=torch.float32)
    keep.extend([w, t_ax, ga, gx, y_gv, xs, ws, y_st])
    for cell, stages in (("axpy_dot", (ax_call, dot_call)),
                         ("gemv_relu", (gv_call, gr_call)),
                         ("stencil1d_relu", (st_call, sr_call))):
        fns = [wrapper(c) for c in stages]
        keep.extend(stages)

        def composed(fns=fns):
            out = None
            for f in fns:
                out = f()
            return out
        digest[f"{cell}/unfused"] = checksum(composed())
        timed[cell, "unfused"] = composed
    time_pair("gemv", "contract_gemv", wrapper(gv_call))
    digest["gemv/contract_gemv"] = checksum(y_gv)
    # -- K1's and K2's wrappers in their parts, on the host ------------------
    wrapper_split = {}
    if hasattr(hopper, "_launch_key"):
        for key, name, call in (("dot_f32", "reduce_mul", dot_f32_call),
                                ("relu_f32", "map_relu", relu_f32_call)):
            kern = call.kernel
            geo, lay = kern.geometry, call.layouts
            op = ("reduce", "mul") if name == "reduce_mul" else ("map", "relu")
            fn = getattr(hopper, name)
            k_args = (name, op, geo, None, kern.program, kern.out_dtype,
                      kern.acc_dtype, lay)
            prep = hopper._PREPARED[hopper._launch_key(*k_args)]
            _, out, args = grabbed(lambda: fn(geo, lay, kern.out_dtype,
                                              program=kern.program))
            keep.extend([out, args])
            parts = {
                "key": lambda a=k_args: hopper._launch_key(*a),
                "lookup": lambda a=k_args: hopper._prepared(
                    hopper._launch_key(*a), None),
                "torch_empty": lambda p=prep: torch.empty(
                    p.out_shape, dtype=p.out_dtype, device=dev),
                "work": lambda p=prep: hopper._work(dev, max(p.work, 1)),
                "_launch": lambda n=name, a=args: hopper._launch(n, dev, *a),
                "wrapper": lambda f=fn, g_=geo, l_=lay, o=kern.out_dtype,
                p_=kern.program: f(g_, l_, o, program=p_),
            }
            for part, f in parts.items():
                for _ in range(20):
                    f()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(300):
                    f()
                wrapper_split[f"{key}/{part}"] = \
                    (time.perf_counter() - t0) / 300 * 1e3
                torch.cuda.synchronize()
    # -- registers, local bytes, CTAs an SM ----------------------------------
    attributes = {}
    for name in ("reduce_mul", "map_relu"):
        try:
            attributes[name] = hopper.kernel_attributes(name)
        except (AttributeError, TypeError, RuntimeError) as e:
            attributes[name] = f"not reported: {type(e).__name__}"
    # -- the turns ---------------------------------------------------------
    keys = list(timed)
    medians = {k: [] for k in keys}
    for k in [*keys, *reversed(keys)]:
        medians[k].append(statistics.median(time_ms(timed[k], torch)))
    ms = {"/".join(k): statistics.mean(v) for k, v in medians.items()}
    return {"root": str(root), "exact": exact, "digest": digest, "ms": ms,
            "host_ms": host, "wrapper_split": wrapper_split, "split": split,
            "ptxas": ptxas, "attributes": attributes}


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
        raise SystemExit("reduce_relu_ablation: needs a CUDA device")
    if args.tree is not None:          # one run, in a process of its own
        print(json.dumps(measure_tree(args.tree.resolve(), args.seed)))
        return 0
    smi = card()
    if args.trees is None:
        runs = {"change": [measure_tree(Path(__file__).resolve().parents[1],
                                        args.seed)]}
    else:
        runs = {"parent": [], "change": []}
        order = (("parent", 0), ("change", 1), ("change", 1), ("parent", 0))
        for side, i in order:
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--tree",
                 str(args.trees[i].resolve()), "--seed", str(args.seed)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise SystemExit(f"{side} run failed:\n{proc.stderr[-4000:]}")
            runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    sides = {}
    for side, rs in runs.items():
        def mean(field):
            return {k: statistics.mean(r[field][k] for r in rs)
                    for k in rs[0][field]}
        sides[side] = {"ms": mean("ms"), "host_ms": mean("host_ms"),
                       "wrapper_split": mean("wrapper_split"),
                       "runs_ms": [r["ms"] for r in rs],
                       "exact": {k: all(r["exact"].get(k, False) for r in rs)
                                 for k in rs[0]["exact"]},
                       "digest": rs[0]["digest"],
                       "same_digest_in_runs": all(r["digest"] == rs[0]["digest"]
                                                  for r in rs),
                       "split": rs[0]["split"], "ptxas": rs[0]["ptxas"],
                       "attributes": rs[0]["attributes"]}
    result = {"phase": "reduce_relu_ablation", "card": smi,
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
             for s in sides.values())
    if "parent" in sides:
        ok = ok and all(result["same_bits_as_parent"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
