#!/usr/bin/env python3
"""B8 ``base_scan`` and K4 ``contract_gemv`` beside their parent designs,
the kernels that share their code paths, and one PyTorch call for each
function, in one process a tree.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 tools/scan_gemv_ablation.py [--seed 0] [--out FILE]
    python3 tools/scan_gemv_ablation.py --trees PARENT CHANGE [--out FILE]

With ``--trees`` the script measures each tree (a checkout, e.g. unpacked
by ``git archive``) in a process of its own, in the order parent, change,
change, parent, and reports each side as the mean of its two runs; without
it, the tree it sits in.  Each tree builds its own kernels under its own
``build/``.

The cells are chip_smoke.py's: ``scan_2p26`` (x ~ N(0, 1), n = 2**26, in
f32, rounded to bf16, and int32 in ±2**30), ``gemv`` and ``gemv_relu`` (A
8192 x 8192, x 8192, ~ N(0, 1); grid (16, 16) of 512 x 512 blocks) in f32
and bf16, and ``gemm`` (4096**3, f32).

* The scan: B8 through its wrapper and its C entry (``entry``), with
  ``host_ms``, the host's time to issue one wrapper call; K14 likewise,
  R15 at depth 4 and ``torch.cumsum`` (f32 out); each wrapper
  split into its device kernels and memsets by a ``torch.profiler`` trace
  (``split``: ms a call by name).
* The gemv: K4 through its wrapper (back-to-back calls, as chip_smoke.py's
  kernels line times it) and its C entry, with ``host_ms``, the host's
  time to issue one wrapper call; R4 at depth 4 likewise; B4
  ``base_gemv``; ``torch.mv``; ``ops.gemv`` by the host's clock, each call
  ending in a synchronize (``wall``).  ``wrapper_split``: K4's wrapper in
  its parts, each timed alone on the host (``time.perf_counter``, mean of
  many calls): ``_checked``, ``_refusal``, ``_vector_width``, the ctypes
  structs, the ``torch.cuda.device`` context with the stream's handle,
  ``torch.empty`` of the output, ``_launch`` and the whole call.
* The neighbours that share the wrapper or the look-back: K3 and R3 at
  depth 3 on the gemm cell, through their wrappers and C entries.
* Source variants (the tree's source, or a header it includes, with some
  lines replaced, compiled into the tree's ``build/scan_gemv_ablation/``),
  launched through the C entry with the wrapper's arguments: B8 ``ctas5``
  and ``ctas6`` (built for that many CTAs an SM, against 8), ``pause0``
  and ``pause512`` (ns between polls of a look-back word, against 128),
  ``issue_early_ctas5`` (the look-back's words loaded before the block
  walk, at the 5 CTAs an SM its registers then allow), ``plain_loads`` and ``plain_stores`` (x read and the sums
  written without the evict-first hints, ld/st.global.cs) and ``no_wait``
  (the look-back's wait taken out: wrong sums, the time of the pass
  without its waits); K4 ``ahead0``, ``ahead1`` and ``ahead3`` (a chunk's
  first steps of A prefetched to L2 while x is staged, against 2) and
  ``no_hint`` (A by plain loads, not ld.global.cs).  Null where the lines
  are not in the tree's source (a parent tree builds none); each but
  ``no_wait`` held to the tree's own bits.
* ``digest``: a checksum of each output's bits, so that two trees' outputs
  compare to the bit: B8 in f32, bf16 and int32; K4 in its eight builds
  (f32 or bf16 in and out; A in 16-byte packs, or one element off a
  16-byte boundary) with and without relu; R4, K3, R3, K14, R15.
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

SCAN_N = 1 << 26
GEMV, GEMM = 8192, 4096
WAIT_LINE = ("ssr_scan.cuh",
             "  while (!(word >> 32)) word = load_word(w);\n")
_B8_CTAS = "constexpr int kMinCtas = 8; "
_B8_PAUSE = "constexpr int kPauseNs = 128; "
_B8_WORDS = "    float carry = w.offset(w.issue(tile), tile, gv, sh);\n"
_B8_LOOP = "    const int64_t base = static_cast<int64_t>(tile) * kTile;\n"
_K4_AHEAD = "constexpr int kAhead = 2; "
_K4_LOOP = "#pragma unroll 4\n          for (int c = lane; c < len / V; c += 32) {"
#: (kernel, variant) → (file, old, new) replacements
VARIANTS = {
    **{("base_scan", f"ctas{n}"): (("base_scan.cu", _B8_CTAS,
                                     _B8_CTAS.replace("8", str(n))),)
       for n in (5, 6)},
    ("base_scan", "pause0"): (("base_scan.cu", _B8_PAUSE,
                               _B8_PAUSE.replace("128", "0")),),
    ("base_scan", "pause512"): (("base_scan.cu", _B8_PAUSE,
                                 _B8_PAUSE.replace("128", "512")),),
    # the look-back's words loaded before the sums (5 CTAs an SM fit)
    ("base_scan", "issue_early_ctas5"): (
        ("base_scan.cu", _B8_CTAS, _B8_CTAS.replace("8", "5")),
        ("base_scan.cu", _B8_WORDS,
         "    float carry = w.offset(pend, tile, gv, sh);\n"),
        ("base_scan.cu", _B8_LOOP,
         _B8_LOOP + "    const scan::Pending pend = w.issue(tile);\n")),
    # x by plain loads and the sums by plain stores, not ld/st.global.cs
    ("base_scan", "plain_loads"): (
        ("base_scan.cu", "      const float4 v = load4_first(x + blk",
         "      const float4 v = ssr_load4_f32(x + blk"),),
    ("base_scan", "plain_stores"): (
        ("base_scan.cu",
         "      __stcs(reinterpret_cast<float4*>(out + base + k * kBlock + kPer * t),\n"
         "             make_float4(carry + sums[k].x, carry + sums[k].y,\n"
         "                         carry + sums[k].z, carry + sums[k].w));",
         "      *reinterpret_cast<float4*>(out + base + k * kBlock + kPer * t) =\n"
         "          make_float4(carry + sums[k].x, carry + sums[k].y,\n"
         "                      carry + sums[k].z, carry + sums[k].w);"),),
    ("base_scan", "no_wait"): (("ssr_scan.cuh",
                                "    word = load_word(w);\n  }\n",
                                "    break;\n  }\n"),),
    **{("contract_gemv", f"ahead{n}"): (("contract_gemv.cu", _K4_AHEAD,
                                          _K4_AHEAD.replace("2", str(n))),)
       for n in (0, 1, 3)},
    ("contract_gemv", "no_hint"): (
        ("contract_gemv.cu",
         "__ldcs(reinterpret_cast<const uint4*>(p));",
         "*reinterpret_cast<const uint4*>(p);"),),
}
#: variants that compute wrong values on purpose
INEXACT = ("no_wait",)


def measure_tree(root: Path, seed: int) -> dict:
    """Every number of one tree, in this process."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.core import compiler, hopper, lowering
    from repro_torch.kernels import chained, gemm, gemv, ops, scan

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("base_scan", "stream_scan", "ring_stream_scan", "contract_gemv",
             "ring_contract_gemv", "base_gemv", "contract_gemm",
             "ring_contract_gemm")
    logs = hopper.build(names)
    ptxas = {n: ptxas_counts(log) for n, log in logs.items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    timed, exact, digest, split, host, keep = {}, {}, {}, {}, {}, []
    stream = torch.cuda.current_stream().cuda_stream

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

    def entry(fn, lib=None):
        """The C entry ``fn()``'s wrapper launches, with its arguments."""
        name, out, args = grabbed(fn)
        keep.extend([out, args])
        f = getattr(lib or hopper._lib(name), f"ssr_{name}")
        f.argtypes = hopper._SIGNATURES[name]
        f.restype = ctypes.c_int

        def call(a=tuple(args)):
            rc = f(*a, stream)
            if rc != 0:
                raise SystemExit(f"{name}: CUDA error {rc}")
        return call, name, out, args

    # -- the source variants, built together -------------------------------
    vroot = root / "build" / "scan_gemv_ablation"
    # the variants are of this change's designs: B8 in one pass (with its
    # model), K4 in one wave (with its split)
    todo = {k: subs for k, subs in VARIANTS.items()
            if hasattr(hopper, {"base_scan": "base_scan_model",
                                "contract_gemv": "gemv_split"}[k[0]])}
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        built = dict(zip(todo, pool.map(
            lambda kv: build_variant(hopper.CSRC, vroot / "_".join(kv[0]),
                                     kv[0][0], kv[1]), todo.items())))
    for (kernel, v), b in built.items():
        ptxas[f"{kernel}/{v}"] = None if b is None else \
            {k: x for k, x in b.items() if k != "so"}

    def variants_of(kernel, fn, key):
        """Each built variant of ``kernel`` launched with the arguments its
        wrapper passes in ``fn()``, into an output of its own, beside the
        tree's own output."""
        want = fn()
        _, name, out, args = entry(fn)
        for (k, v), b in built.items():
            if k != kernel or b is None:
                continue
            o = torch.empty_like(out)
            a = list(args)
            a[2] = o.data_ptr()              # the output
            f = getattr(ctypes.CDLL(b["so"]), f"ssr_{name}")
            f.argtypes = hopper._SIGNATURES[name]
            f.restype = ctypes.c_int
            keep.extend([o, a, want])

            def run(f=f, a=tuple(a), v=v):
                rc = f(*a, stream)
                if rc != 0:
                    raise SystemExit(f"{name}/{v}: CUDA error {rc}")
            run()
            torch.cuda.synchronize()
            if v not in INEXACT:
                exact[f"{key}/variant_{v}_is_as_is"] = bool(
                    torch.equal(bits(o), bits(want)))
            timed[key, f"{kernel}_entry/{v}"] = run

    # -- the scan ----------------------------------------------------------
    xsc = torch.randn(SCAN_N, generator=gen, device=dev)
    xint = torch.randint(-(1 << 30), 1 << 30, (SCAN_N,), generator=gen,
                         device=dev, dtype=torch.int32)
    for x, tag in ((xsc, "f32"), (xsc.bfloat16(), "bf16"), (xint, "int32")):
        arrays, static, _ = scan._prepare(x)
        arrays = tuple(arrays)
        lc = scan._launch(static, *arrays)
        key = f"scan_2p26_{tag}"
        b8 = hopper.base_scan(arrays[0])
        exact[f"{key}/b8_twice"] = bool(torch.equal(
            bits(hopper.base_scan(arrays[0])), bits(b8)))
        digest[f"{key}/base_scan"] = checksum(b8)
        k14 = hopper.stream_scan(lc, arrays[0])[0]
        digest[f"{key}/stream_scan"] = checksum(k14)
        fns = {"base_scan": lambda a=arrays: hopper.base_scan(a[0]),
               "stream_scan": lambda lc=lc, a=arrays: hopper.stream_scan(
                   lc, a[0])}
        fns["base_scan_entry"] = entry(fns["base_scan"])[0]
        fns["stream_scan_entry"] = entry(fns["stream_scan"])[0]
        if tag == "f32":
            from repro_torch.core import agu
            ring = agu.RingProgram((4,), (False,))
            fns["ring_stream_scan_4"] = (
                lambda lc=lc, a=arrays, r=ring: hopper.ring_stream_scan(
                    lc, a[0], r))
            digest[f"{key}/ring_stream_scan_4"] = checksum(
                fns["ring_stream_scan_4"]()[0])
            variants_of("base_scan", fns["base_scan"], key)
        for k, fn in fns.items():
            timed[key, k] = fn
        fns["base_scan"]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fns["base_scan"]()
        host[f"{key}/base_scan"] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        for k in ("base_scan", "stream_scan"):
            split[f"{key}/{k}"] = split_ms(fns[k], root)
        timed[key, "library"] = lambda x=x: torch.cumsum(x, 0,
                                                         dtype=torch.float32)
        keep.append(arrays)
        del b8, k14
    # -- the gemv ----------------------------------------------------------
    ga = torch.randn(GEMV, GEMV, generator=gen, device=dev)
    gx = torch.randn(GEMV, generator=gen, device=dev)
    nest = compiler.gemv_nest(GEMV, GEMV)
    calls = {}
    for dt, dtag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        a_, x_ = ga.to(dt), gx.to(dt)
        # one element off a 16-byte boundary: A's elements route
        a1 = torch.empty(GEMV * GEMV + 1, device=dev, dtype=dt)[1:].view(
            GEMV, GEMV)
        a1.copy_(a_)
        x1 = torch.empty(GEMV + 1, device=dev, dtype=dt)[1:]
        x1.copy_(x_)
        keep.extend([a_, x_, a1, x1])
        for body, btag in ((gemv.MATVEC, "gemv"),
                           (chained.MATVEC_RELU, "gemv_relu")):
            for out_dt, otag in ((torch.float32, "f32"),
                                 (torch.bfloat16, "bf16")):
                for route, (aa, xx) in (("packs", (a_, x_)),
                                        ("elements", (a1, x1))):
                    c = lowering.prepare_call(nest, body, {"A": aa, "x": xx},
                                              out_dtype=out_dt)
                    got = c.run()
                    digest[f"{btag}/{dtag}_{otag}_{route}/contract_gemv"] = \
                        checksum(got)
                    calls[btag, dtag, otag, route] = c
    for (btag, dtag), body in ((("gemv", "f32"), gemv.MATVEC),
                               (("gemv_relu", "f32"), chained.MATVEC_RELU),
                               (("gemv", "bf16"), gemv.MATVEC)):
        c = calls[btag, dtag, "f32", "packs"]
        kern = c.kernel
        key = f"{btag}_{dtag}" if dtag != "f32" else btag

        def k4(c=c, kern=kern):
            return kern.device_kernel()(kern.geometry, c.layouts,
                                        kern.out_dtype, kern.acc_dtype,
                                        **kern.device_args())
        timed[key, "contract_gemv"] = k4
        timed[key, "contract_gemv_entry"] = entry(k4)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            k4()
        host[f"{key}/contract_gemv"] = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        deep = lowering.prepare_call(
            nest, body, {"A": ga.to(torch.bfloat16 if dtag == "bf16" else
                                    torch.float32),
                         "x": gx.to(torch.bfloat16 if dtag == "bf16" else
                                    torch.float32)},
            schedule=lowering.Schedule(buffer_depth=4))
        keep.append(deep)
        r4 = deep.run()
        digest[f"{key}/ring_contract_gemv_4"] = checksum(r4)
        exact[f"{key}/r4_is_k4"] = bool(torch.equal(bits(r4), bits(c.run())))
        kd = deep.kernel

        def r4f(c=deep, kern=kd):
            return kern.device_kernel()(kern.geometry, c.layouts,
                                        kern.out_dtype, kern.acc_dtype,
                                        **kern.device_args())
        timed[key, "ring_contract_gemv_4"] = r4f
        timed[key, "ring_contract_gemv_4_entry"] = entry(r4f)[0]
        if key == "gemv":
            variants_of("contract_gemv", k4, key)
    ab = ga.bfloat16()
    xb = gx.bfloat16()
    keep.extend([ab, xb])
    timed["gemv", "library"] = lambda: torch.mv(ga, gx)
    timed["gemv_bf16", "library"] = lambda: torch.mv(ab, xb)
    gxp = gx.reshape(1, GEMV)
    timed["gemv", "base_gemv"] = lambda: hopper.base_gemv(ga, gxp)
    # ops.gemv by the host's clock, each call ending in a synchronize
    walls = []
    for _ in range(3):
        ops.gemv(ga, gx, ssr=True)
    torch.cuda.synchronize()
    for _ in range(20):
        t0 = time.perf_counter()
        ops.gemv(ga, gx, ssr=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = {"ops.gemv": statistics.median(walls)}
    # K4's wrapper in its parts, each on the host alone
    c = calls["gemv", "f32", "f32", "packs"]
    geo, lay = c.kernel.geometry, c.layouts
    op = ("nest", "matvec")
    _, out, args = grabbed(lambda: hopper.contract_gemv(geo, lay,
                                                        torch.float32))
    keep.extend([out, args])

    def structs():
        g_ = hopper._grid_arg(geo.grid)
        s_ = [hopper._stream_arg(a_, t_) for a_, t_ in zip(geo.ins, lay)]
        return g_, s_, hopper._stream_arg(geo.out, out)

    def context():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    parts = {
        "_checked": lambda: hopper._checked("contract_gemv", geo, lay, None,
                                            None, op),
        "_refusal": lambda: hopper._refusal("contract_gemv", geo,
                                            torch.float32, dev),
        "_vector_width": lambda: hopper._vector_width(lay[:1], geo.ins[:1]),
        "structs": structs,
        "device_context": context,
        "torch_empty": lambda: torch.empty(geo.out_shape, device=dev),
        "_launch": lambda: hopper._launch("contract_gemv", dev, *args),
        "wrapper": lambda: hopper.contract_gemv(geo, lay, torch.float32),
    }
    wrapper_split = {}
    for k, fn in parts.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(300):
            fn()
        wrapper_split[k] = (time.perf_counter() - t0) / 300 * 1e3
        torch.cuda.synchronize()
    # -- the gemm: K3 and R3 at depth 3 ------------------------------------
    a3 = torch.randn(GEMM, GEMM, generator=gen, device=dev)
    b3 = torch.randn(GEMM, GEMM, generator=gen, device=dev)
    gnest = compiler.gemm_nest(GEMM, GEMM, GEMM)
    for depth, name in ((2, "contract_gemm"), (3, "ring_contract_gemm_3")):
        c = lowering.prepare_call(
            gnest, gemm.DOT, {"A": a3, "B": b3},
            schedule=lowering.Schedule(buffer_depth=depth))
        keep.append(c)
        digest[f"gemm/{name}"] = checksum(c.run())
        kern = c.kernel

        def fn(c=c, kern=kern):
            return kern.device_kernel()(kern.geometry, c.layouts,
                                        kern.out_dtype, kern.acc_dtype,
                                        **kern.device_args())
        timed["gemm", name] = fn
        timed["gemm", f"{name}_entry"] = entry(fn)[0]
    timed["gemm", "library"] = lambda: torch.matmul(a3, b3)
    # -- registers, local bytes, CTAs an SM ----------------------------------
    attributes = {}
    for key, name, kw in (("base_scan", "base_scan", {}),
                          ("stream_scan", "stream_scan", {}),
                          *((f"contract_gemv/{b}", "contract_gemv",
                             {"build": b})
                            for b in getattr(hopper, "GEMV_BUILDS", ()))):
        try:
            attributes[key] = hopper.kernel_attributes(name, **kw)
        except (AttributeError, TypeError, RuntimeError) as e:
            attributes[key] = f"not reported: {type(e).__name__}"
    # -- the turns ---------------------------------------------------------
    keys = list(timed)
    medians = {k: [] for k in keys}
    for k in [*keys, *reversed(keys)]:
        medians[k].append(statistics.median(time_ms(timed[k], torch)))
    ms = {"/".join(k): statistics.mean(v) for k, v in medians.items()}
    return {"root": str(root), "exact": exact, "digest": digest, "ms": ms,
            "host_ms": host, "wall_ms": wall, "wrapper_split": wrapper_split,
            "split": split, "ptxas": ptxas, "attributes": attributes}


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
        raise SystemExit("scan_gemv_ablation: needs a CUDA device")
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
                       "wall_ms": mean("wall_ms"),
                       "wrapper_split": mean("wrapper_split"),
                       "runs_ms": [r["ms"] for r in rs],
                       "exact": {k: all(r["exact"].get(k, False) for r in rs)
                                 for k in rs[0]["exact"]},
                       "digest": rs[0]["digest"],
                       "same_digest_in_runs": all(r["digest"] == rs[0]["digest"]
                                                  for r in rs),
                       "split": rs[0]["split"], "ptxas": rs[0]["ptxas"],
                       "attributes": rs[0]["attributes"]}
    result = {"phase": "scan_gemv_ablation", "card": smi,
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
