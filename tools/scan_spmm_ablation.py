#!/usr/bin/env python3
"""What holds R15 and K13 back: the scan ring split into its device
kernels beside K14, B8 and ``torch.cumsum``, and the spmm gather beside
copies of itself with one cause changed, B7 and cuSPARSE.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 tools/scan_spmm_ablation.py [--seed 0] [--out FILE]

The cells are chip_smoke.py's: ``scan_2p26`` (x ~ N(0, 1), n = 2**26, in
f32 and rounded to bf16) and ``spmm_hpcg`` (HPCG's 27-point operator on
64**3 times X ~ N(0, 1) of 128 columns).

* The scan: R15 ``ring_stream_scan`` at depths 3, 4 and 8, K14
  ``stream_scan`` and B8 ``base_scan``, each through its wrapper (device
  time of back-to-back calls), each split into its device kernels and
  memsets by a ``torch.profiler`` trace of a few calls (``split``: ms a
  call by kernel name), and ``torch.cumsum``.  Every R15 output is held to
  K14's bits (``exact``), and R15 at depth 4 to its own bits over five
  runs.
* R15's source variants, launched through its C entry at each depth on
  scan_2p26 (f32): ``as_is`` (held to K14's bits); ``no_wait`` (each word
  of a tile's offset read once, not waited for: wrong sums, the time of
  the pass without its waits).  Null where the entry is another
  design's.
* K13 ``gather_spmm``: each source variant (its source, or a header it
  includes, with some lines replaced, compiled into
  ``build/scan_spmm_ablation/``) launched through its C entry with the
  arguments the port's wrapper passes, on the lowering's padded (m, 128)
  layouts (``padded``) and on ``pack_ell``'s (m, 27) planes at pitch 27
  (``planes``): ``as_is``; ``ctas8`` (built for eight CTAs an SM, a thread
  capped at 32 registers), ``ctas3`` (three, 85); ``per6`` and ``per8``
  (six or eight entries' gathers in flight a lane, against four);
  ``ctas8_per4`` (both) and ``ctas5_per4`` … ``ctas8_per1`` (CTAs an SM
  and entries in flight together); ``loop_per1`` (a grid of several
  steps gathering one entry at a time); ``one_step`` (the loop
  over contraction steps cut to the one step HPCG's grid has) and
  ``step_loop`` (a one-step grid through the loop).  A variant whose
  lines are not in the source is ``null``: copied into a checkout of an
  earlier design, the script times that design's kernels (``as_is`` is
  then its own).  Every variant on either layout is held to the padded
  ``as_is`` result to the bit.  Beside them B7 ``base_spmm`` on the planes,
  cuSPARSE (``sparse_csr_tensor @ X``), K13's wrapper on the main path's
  layouts (``wrapper``: device ms and the host's ms to issue one call)
  and the spmm entry point's wall time (``ops.spmm``, CSR on the card,
  host work included: ``entry_wall_ms``).

The timed calls run in turns (forward, then backward), each time the
median of CUDA-event samples of back-to-back launches; ``spread`` is the
distance between the quartiles of all of a call's samples.  Also
recorded: each K13 variant's registers, stack and spill bytes from ``nvcc
-Xptxas -v`` and its registers and local bytes as the runtime reads
them.  Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import compiler, hopper, lowering  # noqa: E402
from repro_torch.kernels import ops, scan, sparse  # noqa: E402

SCAN_N = 1 << 26
SPMM_GRID, SPMM_RHS = 64, 128
SCAN_DEPTHS = (3, 4, 8)
OUT = ROOT / "build" / "scan_spmm_ablation"

_CTAS4 = "constexpr int kCtasPerSm = 4;"
_PER8 = "constexpr int kPer = 4;"
_PARENT_ROW = "spmm_row<true>("     # the design before kPer: R14's batch
#: K13 variant → alternative sets of (file, old, new) replacements, the
#: first set whose lines are all in the sources taken (a pair with old ==
#: new only requires its line)
K13_VARIANTS = {
    "as_is": [()],
    "ctas8": [(("gather_spmm.cu", _CTAS4, "constexpr int kCtasPerSm = 8;"),),
              (("gather_spmm.cu", "__launch_bounds__(kThreads, 4)",
                "__launch_bounds__(kThreads, 8)"),)],
    "per8": [(("gather_spmm.cu", _PARENT_ROW, _PARENT_ROW),
              ("ssr_gather.cuh", "constexpr int kSpmmBatch = 4;",
               "constexpr int kSpmmBatch = 8;")),
             (("gather_spmm.cu", _PER8, "constexpr int kPer = 8;"),)],
    "per6": [(("gather_spmm.cu", _PER8, "constexpr int kPer = 6;"),)],
    "loop_per1": [(("gather_spmm.cu", "constexpr int kLoopPer = 2;",
                    "constexpr int kLoopPer = 1;"),)],
    "ctas3": [(("gather_spmm.cu", _CTAS4, "constexpr int kCtasPerSm = 3;"),)],
    **{f"ctas{c}_per{k}": [(("gather_spmm.cu", _CTAS4,
                            f"constexpr int kCtasPerSm = {c};"),
                           ("gather_spmm.cu", _PER8,
                            f"constexpr int kPer = {k};"),
                           ("gather_spmm.cu", "constexpr int kLoopPer = 2;",
                            f"constexpr int kLoopPer = {min(k, 2)};"))]
       for c, k in ((5, 4), (6, 4), (6, 2), (8, 2), (8, 1))},
    "ctas8_per4": [(("gather_spmm.cu", _CTAS4,
                     "constexpr int kCtasPerSm = 8;"),
                    ("gather_spmm.cu", _PER8, "constexpr int kPer = 4;"))],
    "one_step": [(("gather_spmm.cu",
                   "for (int64_t z = 0; z < zsteps; ++z, odo.advance(g)) {",
                   "for (int64_t z = 0; z < 1; ++z) {"),)],
    "step_loop": [(("gather_spmm.cu", "  if (zsteps == 1) {   // one",
                    "  if (false) {   // one"),)],
}


#: R15 variant → replacement sets in ring_stream_scan.cu, as K13's
R15_VARIANTS = {
    "as_is": [()],
    "no_wait": [(("ring_stream_scan.cu",
                  "  while (!(word >> 32)) word = load_word(w);\n", ""),)],
}
#: R15's variants that compute the wrong sums on purpose
R15_INEXACT = ("no_wait",)


def variant_files(csrc: Path, subs_sets) -> dict:
    """The changed files (name → text) of the first replacement set that
    applies to ``csrc``, {} for none to make, or None where none applies."""
    for subs in subs_sets:
        files, ok = {}, True
        for name, old, new in subs:
            text = files.get(name, (csrc / name).read_text())
            if old not in text:
                ok = False
                break
            files[name] = text.replace(old, new, 1)
        if ok:
            return files
    return None


def compile_(csrc: Path, kernel: str, variant: str, files: dict) -> dict:
    """Build ``kernel``'s ``variant`` (its changed files beside its
    source); its library path and nvcc's -Xptxas -v counts."""
    vdir = OUT / f"{kernel}_{variant}"
    shutil.rmtree(vdir, ignore_errors=True)
    vdir.mkdir(parents=True)
    cu = f"{kernel}.cu"
    src = files.get(cu, (csrc / cu).read_text())
    for name, text in {**files, cu: src}.items():
        (vdir / name).write_text(text)
    so = vdir / f"{kernel}.so"
    proc = subprocess.run([hopper._nvcc(), *hopper.NVCC_FLAGS, "-I",
                           str(csrc), "-o", str(so), str(vdir / cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {kernel} {variant}:\n"
                         f"{proc.stderr}")
    err = proc.stderr + proc.stdout

    def nums(pattern):
        return [int(v) for v in re.findall(pattern, err)]
    return {"so": str(so), "registers": nums(r"Used (\d+) registers"),
            "stack_bytes": nums(r"(\d+) bytes stack frame"),
            "spill_store_bytes": nums(r"(\d+) bytes spill stores"),
            "spill_load_bytes": nums(r"(\d+) bytes spill loads")}


def grabbed(fn):
    """(kernel name, output, arguments) of the one launch ``fn()`` makes
    through the port's wrapper, not launched."""
    got = {}
    real = hopper._launch

    def grab(name, dev, *args):
        got["name"], got["args"] = name, list(args)
    hopper._launch = grab
    try:
        out = fn()
    finally:
        hopper._launch = real
    return got["name"], out, got["args"]


def time_ms(fn, samples: int = 15, calls: int = 20) -> list:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def quartile_gap(xs: list) -> float:
    q = statistics.quantiles(xs, n=4)
    return q[2] - q[0]


def split_ms(fn, calls: int = 5) -> dict:
    """Device ms a call of ``fn`` by kernel (and memset) name, from a
    torch.profiler trace of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)
    events = events.get("traceEvents", events) \
        if isinstance(events, dict) else events
    out: dict = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memset") and "dur" in e:
            key = f"{e['cat']}:{e['name']}"
            out[key] = out.get(key, 0.0) + float(e["dur"]) / 1e3 / calls
    return out


def wall_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_spmm_ablation: needs a CUDA device")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    csrc = hopper.CSRC
    OUT.mkdir(parents=True, exist_ok=True)
    # -- the cells, as chip_smoke.py makes them ---------------------------
    n_m = SPMM_GRID ** 3
    scsr = sparse.hpcg_operator(SPMM_GRID, SPMM_GRID, SPMM_GRID, device=dev)
    sX = torch.randn(n_m, SPMM_RHS, generator=gen, device=dev)
    xsc = torch.randn(SCAN_N, generator=gen, device=dev)
    sv, sc, sm, sk = sparse.pack_ell(*scsr, n_m)
    timed, exact, split, wrapper = {}, {}, {}, {}
    # -- the scan: R15 at each depth, K14, B8, each through its wrapper ----
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = xsc.to(dt)
        arrays, static, _ = scan._prepare(x)
        arrays = tuple(arrays)
        lc = scan._launch(static, *arrays)
        k14 = hopper.stream_scan(lc, arrays[0])[0]
        fns = {"stream_scan": lambda lc=lc, a=arrays: hopper.stream_scan(
                   lc, a[0]),
               "base_scan": lambda a=arrays: hopper.base_scan(a[0])}
        for depth in SCAN_DEPTHS:
            ring = scan._ssr._build(static, arrays, lowering.Schedule(
                buffer_depth=depth)).ring
            fn = (lambda lc=lc, a=arrays, r=ring:
                  hopper.ring_stream_scan(lc, a[0], r))
            fns[f"ring_stream_scan_{depth}"] = fn
            exact[f"scan_2p26_{tag}/ring_stream_scan_{depth}"] = bool(
                torch.equal(bits(fn()[0]), bits(k14)))
            if depth == 4:
                first = bits(fn()[0])
                exact[f"scan_2p26_{tag}/ring_stream_scan_4_five_runs"] = all(
                    bool(torch.equal(bits(fn()[0]), first)) for _ in range(5))
        for name, fn in fns.items():
            timed[f"scan_2p26_{tag}", name] = fn
            split[f"scan_2p26_{tag}/{name}"] = split_ms(fn)
        timed[f"scan_2p26_{tag}", "library"] = (
            lambda x=x: torch.cumsum(x, 0))
        del k14
    # -- the source variants, built together ------------------------------
    plan = {v: variant_files(csrc, s) for v, s in K13_VARIANTS.items()}
    # R15's entry as this design takes it (its state's words), or none
    one_pass = hasattr(hopper, "scan_state_words")
    r15_plan = {v: variant_files(csrc, s) if one_pass else None
                for v, s in R15_VARIANTS.items()}
    todo = {("gather_spmm", v): f for v, f in plan.items() if f is not None}
    todo.update({("ring_stream_scan", v): f for v, f in r15_plan.items()
                 if f is not None})
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        built_all = dict(zip(todo, pool.map(
            lambda kv: compile_(csrc, *kv[0], kv[1]), todo.items())))
    built = {v: b for (k, v), b in built_all.items() if k == "gather_spmm"}
    r15_built = {v: b for (k, v), b in built_all.items()
                 if k == "ring_stream_scan"}
    libs = {v: ctypes.CDLL(b["so"]) for v, b in built.items()}
    stream = torch.cuda.current_stream().cuda_stream
    # R15's variants through its C entry on scan_2p26 (f32)
    r15_keep = []
    if r15_built:
        arrays, static, _ = scan._prepare(xsc)
        arrays = tuple(arrays)
        lc = scan._launch(static, *arrays)
        geo = hopper.launch_geometry(lc)
        k14 = hopper.stream_scan(lc, arrays[0])[0]
        x0 = arrays[0]
        tiles = -(-x0.numel() // hopper.SCAN_TILE)
        nwords = hopper.scan_state_words(tiles)
        for v, b in r15_built.items():
            entry = ctypes.CDLL(b["so"]).ssr_ring_stream_scan
            entry.argtypes = hopper._SIGNATURES["ring_stream_scan"]
            entry.restype = ctypes.c_int
            for depth in SCAN_DEPTHS:
                ring = scan._ssr._build(static, arrays, lowering.Schedule(
                    buffer_depth=depth)).ring
                dr = hopper.device_ring("ring_stream_scan", geo, ring,
                                        x0.dtype)
                ring_arg = hopper._ring_arg(dr)
                o = torch.empty(x0.shape, dtype=torch.float32, device=dev)
                words = torch.empty(nwords, dtype=torch.int64, device=dev)
                a = (x0.data_ptr(), 0, o.data_ptr(), words.data_ptr(),
                     x0.numel(), tiles, nwords, ctypes.byref(ring_arg),
                     dr.ring_bytes + hopper._staged_bytes(
                         "ring_stream_scan", (), geo))
                r15_keep += [ring_arg, o, words]

                def call_(fn=entry, a_=a, t=f"{v}/{depth}"):
                    rc = fn(*a_, stream)
                    if rc != 0:
                        raise SystemExit(f"ring_stream_scan {t}: CUDA "
                                         f"error {rc}")
                call_()
                torch.cuda.synchronize()
                if v not in R15_INEXACT:
                    exact[f"scan_2p26_f32/ring_stream_scan_{depth}/{v}"] = \
                        bool(torch.equal(bits(o), bits(k14)))
                timed["scan_2p26_f32",
                      f"ring_stream_scan_entry_{depth}/{v}"] = call_
        del k14
    attrs = {}
    for v, lib in libs.items():
        fn = lib.ssr_gather_spmm_attributes
        fn.argtypes = [ctypes.POINTER(ctypes.c_int64)]
        fn.restype = ctypes.c_int
        o = (ctypes.c_int64 * 3)()
        fn(o)
        attrs[v] = {"numRegs": int(o[0]), "localSizeBytes": int(o[1])}
    call = lowering.prepare_call(compiler.spmm_nest(sm, SPMM_RHS, sk,
                                                    SPMM_RHS),
                                 sparse.SPMM, {"vals": sv, "cidx": sc,
                                               "X": sX})
    kern, geo = call.kernel, call.kernel.geometry
    padded = lowering.stream_layouts(call.lowered, [sv, sc, sX])
    name, out, a_pad = grabbed(lambda: kern.device_kernel()(
        geo, padded, kern.out_dtype, kern.acc_dtype, program=kern.program))
    assert name == "gather_spmm", name
    svs, scs = hopper._stream_arg(geo.ins[0], sv), \
        hopper._stream_arg(geo.ins[1], sc)
    a_planes = list(a_pad)
    a_planes[0], a_planes[1] = sv.data_ptr(), sc.data_ptr()
    a_planes[5], a_planes[6] = ctypes.byref(svs), ctypes.byref(scs)
    outs, keep = {}, [padded, svs, scs, out]
    for v, lib in libs.items():
        entry = lib.ssr_gather_spmm
        entry.argtypes = hopper._SIGNATURES["gather_spmm"]
        entry.restype = ctypes.c_int
        for layout, a in (("padded", a_pad), ("planes", a_planes)):
            o = torch.empty_like(out)
            launched = tuple(o.data_ptr() if x_ == out.data_ptr() else x_
                             for x_ in a)

            def call_(fn=entry, a_=launched, t=f"{v}/{layout}"):
                rc = fn(*a_, stream)
                if rc != 0:
                    raise SystemExit(f"gather_spmm {t}: CUDA error {rc}")
            timed["spmm_hpcg", f"gather_spmm/{layout}/{v}"] = call_
            outs[v, layout] = o
    for fn in list(timed.values()):
        fn()
    torch.cuda.synchronize()
    want = outs.get(("as_is", "padded"))
    for (v, layout), o in outs.items():
        exact[f"spmm_hpcg/gather_spmm/{layout}/{v}"] = want is not None and \
            bool(torch.equal(bits(o), bits(want)))
    bname, bout, ba = grabbed(lambda: hopper.base_spmm(sv, sc, sX))
    keep.append(bout)
    blib = hopper._lib(bname)

    def base_call(a_=tuple(ba)):
        rc = blib.ssr_base_spmm(*a_, stream)
        if rc != 0:
            raise SystemExit(f"base_spmm: CUDA error {rc}")
    timed["spmm_hpcg", "base_spmm/planes/as_is"] = base_call
    csr = torch.sparse_csr_tensor(scsr[2].to(torch.int32), scsr[1], scsr[0],
                                  size=(n_m, n_m))
    timed["spmm_hpcg", "library"] = lambda: csr @ sX
    # -- the turns ------------------------------------------------------------
    keys = list(timed)
    samples = {k: [] for k in keys}
    medians = {k: [] for k in keys}
    for k in [*keys, *reversed(keys)]:
        t = time_ms(timed[k])
        samples[k] += t
        medians[k].append(statistics.median(t))
    # K13 through its wrapper on the main path's layouts, and the entry
    def fn_wrapper(c_=call):
        return c_.kernel(*c_.layouts)
    t = time_ms(fn_wrapper)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fn_wrapper()
    host = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    wrapper["spmm_hpcg/gather_spmm"] = {
        "ms": statistics.median(t), "host_ms": host,
        "planes": bool(call.planes),
        "layout_shapes": [list(t_.shape) for t_ in call.layouts]}
    wrapper["spmm_hpcg/entry_wall_ms"] = wall_ms(
        lambda: ops.spmm(*scsr, sX, ssr=True))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    ms = {f"spmm_hpcg/gather_spmm/{layout}/{v}": None
          for v, f in plan.items() if f is None
          for layout in ("padded", "planes")}
    ms.update({f"scan_2p26_f32/ring_stream_scan_entry_{d}/{v}": None
               for v, f in r15_plan.items() if f is None
               for d in SCAN_DEPTHS})
    for k in keys:
        ms["/".join(k)] = {"ms": statistics.mean(medians[k]),
                           "spread": quartile_gap(samples[k])}
    result = {
        "phase": "scan_spmm_ablation", "card": smi,
        "device": torch.cuda.get_device_name(0), "sms": sms,
        "exact": exact,
        "ptxas": {f"{k}/{v}": {key: val for key, val in b.items()
                               if key != "so"}
                  for (k, v), b in built_all.items()},
        "attributes": attrs, "split": split, "ms": ms, "wrapper": wrapper}
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0 if all(exact.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
