#!/usr/bin/env python3
"""What holds R4 and K12 back: the gemv ring and the spmv gather beside
copies of themselves with one cause changed, and beside K4, B6,
``torch.mv`` and cuSPARSE.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 tools/gemv_spmv_ablation.py [--seed 0] [--out FILE]

The cells are chip_smoke.py's: ``gemv`` and ``gemv_relu`` (A 8192 x 8192,
x 8192, both ~ N(0, 1); grid (16, 16) of 512 x 512 blocks) in f32 and bf16,
R4 at depths 3, 4 and 8 and per stream (2, 4) and (4, 2); ``spmv_hpcg``
(HPCG's 27-point operator on 128**3, x ~ U[0, 1)) for K12.  Each variant
is a kernel's source with some lines replaced, or its launch with other
arguments, compiled into ``build/gemv_spmv_ablation/`` and launched through
its C entry with the arguments the port's wrapper passes (``launch_args``):

* R4: ``no_compute`` (the multiply-adds replaced by one add a pack: the
  delivery alone); ``no_barrier`` (the CTA barrier of the step loop taken
  out, where the design has one; the ring then races); ``one_wave`` (as
  many output blocks a CTA as put every CTA in one wave at the CTAs an SM
  its ring lets fit); ``k4_split`` (one output block a CTA, K4's split);
  ``ctas_1`` .. ``ctas_4`` (the split of that many CTAs an SM, where the
  ring lets them fit); ``elements`` (``vec`` 1 and x's elements route: the
  route of layouts with no 16-byte rows; K4 is timed on it too);
  ``no_fence``: the computing warps' proxy fence before they free a slot
  taken out (the ring then races);
* K12: every source variant on the lowering's padded (m, 128) planes
  (``padded``) and on ``pack_ell``'s (m, 27) planes at pitch 27
  (``planes``, the same source and arguments but the two planes and their
  pitch); ``odo64``: each thread's odometer unflattened by 64-bit
  divisions, not 32-bit ones; ``loop_only``: a grid of one column step
  through the general loop of steps; ``per4``: four entries a thread in
  flight, not eight; B6 ``base_spmv`` on the planes; cuSPARSE through
  ``sparse_csr_tensor @``.

A variant whose lines are not in the source, or whose arguments the entry
does not take, is reported as ``null``: copied into a checkout of an
earlier design, the script times that design's kernels.  R4's ``as_is``
and launch variants are held to K4's bits (``elements`` to K4's on that
route) and every K12 variant to the padded ``as_is`` result, to the bit.
The variants run in turns (forward, then backward), each time the median
of CUDA-event samples of back-to-back launches; ``spread`` is the
distance between the quartiles of all of a variant's samples.  Also
recorded: each kernel's registers, stack and spill bytes from ``nvcc
-Xptxas -v``, and each cell and depth through the port's wrapper
(``wrapper``): the device time of back-to-back calls (``ms``) and the
host's time to issue one (``host_ms``).  Prints one JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import compiler, hopper, lowering  # noqa: E402
from repro_torch.kernels import chained, gemv, sparse  # noqa: E402

GEMV = 8192
SPMV_GRID = 128
DEPTHS = (3, 4, 8, (2, 4), (4, 2))
OUT = ROOT / "build" / "gemv_spmv_ablation"

_NO_FMA = ("#pragma unroll\n        for (int j = 0; j < V; ++j)\n"
           "          part = fmaf(ssr_f32(av.v[j]), ssr_f32(xv.v[j]), part);\n",
           "        part += ssr_f32(av.v[0]) + ssr_f32(xv.v[0]);\n")
_NO_BARRIER = ("    side.wait();\n    __syncthreads();\n",
               "    side.wait();\n")
_NO_FENCE = ("    done_reading();\n    if (lane == 0) {\n      ra.release();",
             "    __syncwarp();\n    if (lane == 0) {\n      ra.release();")
_ODO64 = ("  SsrOdometer odo = odometer32(g, p * static_cast<unsigned>(zsteps));",
          "  SsrOdometer odo(g, static_cast<int64_t>(p) * zsteps);")
_ONE_STEP = ("  if (zsteps == 1) {", "  if (false) {")
_PER4 = ("constexpr int kRowPer = 8;", "constexpr int kRowPer = 4;")

#: variants that launch a kernel as it is, on other arguments
LAUNCH = ("one_wave", "k4_split", "ctas_1", "ctas_2", "ctas_3", "ctas_4",
          "elements", "planes")


def variants() -> dict:
    """kernel → variant → source replacements (launch variants have
    none)."""
    return {
        "contract_gemv": {"as_is": (), "elements": ()},
        "ring_contract_gemv": {
            "as_is": (), "no_compute": (_NO_FMA,),
            "no_barrier": (_NO_BARRIER,), "no_fence": (_NO_FENCE,),
            "one_wave": (), "k4_split": (),
            "ctas_1": (), "ctas_2": (), "ctas_3": (), "ctas_4": (),
            "elements": ()},
        "gather_spmv": {"as_is": (), "planes": (), "odo64": (_ODO64,),
                        "loop_only": (_ONE_STEP,), "per4": (_PER4,)},
        "base_spmv": {"as_is": ()},
    }


def source(csrc: Path, name: str, subs) -> str:
    """Kernel ``name``'s source with ``subs`` replaced, or None where a
    line to replace is not in it."""
    src = (csrc / f"{name}.cu").read_text()
    for old, new in subs:
        if old not in src:
            return None
        src = src.replace(old, new, 1)
    return src


def compile_(csrc: Path, name: str, variant: str, src: str) -> dict:
    """Build one variant; its library path and nvcc's -Xptxas -v counts."""
    cu = OUT / f"{name}_{variant}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    proc = subprocess.run([hopper._nvcc(), *hopper.NVCC_FLAGS, "-I",
                           str(csrc), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name} {variant}:\n{proc.stderr}")
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


def launch_args(call, ring=None, layouts=None):
    kern = call.kernel
    return grabbed(lambda: kern.device_kernel()(
        kern.geometry, layouts or call.layouts, kern.out_dtype,
        kern.acc_dtype, program=kern.program, ring=ring))


def gemv_split(groups: int, blocks: int, per_sm: int, sms: int) -> int:
    """Output blocks a CTA of R4 walks so that ``groups`` row groups, each
    over ``blocks`` output blocks, take at most ``per_sm`` CTAs on each of
    ``sms`` SMs: the fewest that fit one wave (all of them where none
    do)."""
    for per in range(1, blocks + 1):
        if groups * -(-blocks // per) <= per_sm * sms:
            return per
    return blocks


def r4_variant_args(a: list, variant: str, geo, dtype, sms: int):
    """R4's arguments under launch ``variant``, or None where the ring
    lets no such split fit.  R4's entry: (a, x, y, in, out, vec, xvec,
    grid, A, x, y walks, steps a block, blocks a run, relu, ring,
    smem)."""
    a = list(a)
    z = geo.contraction_steps
    blocks = geo.steps // z
    groups = -(-geo.ins[0].block[0] // hopper.GEMV_RING_ROWS)
    fit = hopper.SMEM_SM_BYTES // (a[15] + hopper.SMEM_CTA_RESERVED)
    # and the registers: the CTAs an SM the kernel is built for, where the
    # design says
    fit = min(fit, getattr(hopper, "GEMV_RING_PER_SM", {}).get(dtype, fit))
    if variant == "elements":
        a[5], a[6] = 1, 0
    elif variant == "k4_split":
        a[12] = 1
    elif variant == "one_wave":
        a[12] = gemv_split(groups, blocks, max(1, fit), sms)
    else:
        n = int(variant[5:])
        if n > fit:
            return None
        a[12] = gemv_split(groups, blocks, n, sms)
    return a


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


def tag(depth) -> str:
    return "x".join(map(str, depth)) if isinstance(depth, tuple) \
        else str(depth)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemv_spmv_ablation: needs a CUDA device")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    csrc = hopper.CSRC
    OUT.mkdir(parents=True, exist_ok=True)
    # the cells, as chip_smoke.py makes them
    ga = torch.randn(GEMV, GEMV, generator=gen, device=dev)
    gx = torch.randn(GEMV, generator=gen, device=dev)
    n_v = SPMV_GRID ** 3
    hcsr = sparse.hpcg_operator(SPMV_GRID, SPMV_GRID, SPMV_GRID, device=dev)
    hx = torch.rand(n_v, generator=gen, device=dev)
    hv, hc, hm, hk = sparse.pack_ell(*hcsr, n_v)
    gnest = compiler.gemv_nest(GEMV, GEMV)
    gemv_cells = {}
    for dt, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        ops_ = {"A": ga.to(dt), "x": gx.to(dt)}
        gemv_cells["gemv" + suffix] = (gemv.MATVEC, ops_)
        gemv_cells["gemv_relu" + suffix] = (chained.MATVEC_RELU, ops_)
    plan = variants()
    srcs = {(n, v): source(csrc, n, subs)
            for n, vs in plan.items() for v, subs in vs.items()
            if v not in LAUNCH}
    todo = {k: s for k, s in srcs.items() if s is not None}
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        built = dict(zip(todo, pool.map(
            lambda kv: compile_(csrc, *kv[0], kv[1]), todo.items())))
    libs = {k: ctypes.CDLL(b["so"]) for k, b in built.items()}
    stream = torch.cuda.current_stream().cuda_stream
    fns, outs, calls, keep = {}, {}, {}, []

    def add(key, name, variant, launched, out):
        lib = libs.get((name, "as_is" if variant in LAUNCH else variant))
        if launched is None or lib is None:
            fns[key] = None
            return
        fn = getattr(lib, f"ssr_{name}")
        fn.argtypes = hopper._SIGNATURES[name]
        fn.restype = ctypes.c_int
        o = torch.empty_like(out)
        launched = [o.data_ptr() if v == out.data_ptr() else v
                    for v in launched]

        def call_(fn=fn, a_=tuple(launched), t=key):
            rc = fn(*a_, stream)
            if rc != 0:
                raise SystemExit(f"{t}: CUDA error {rc}")
        fns[key], outs[key] = call_, o

    for cell, (body, ops_) in gemv_cells.items():
        for depth in (2, *DEPTHS):
            sched = lowering.Schedule(stream_depths=depth) \
                if isinstance(depth, tuple) else \
                lowering.Schedule(buffer_depth=depth)
            call = lowering.prepare_call(gnest, body, ops_, schedule=sched)
            calls[cell, tag(depth)] = call
            ring = call.kernel.ring if depth != 2 else None
            name, out, a = launch_args(call, ring)
            keep.append(out)
            for variant in plan[name]:
                launched = a
                if name == "ring_contract_gemv" and variant in LAUNCH:
                    launched = r4_variant_args(a, variant,
                                               call.kernel.geometry,
                                               call.layouts[0].dtype, sms)
                elif variant == "elements":
                    launched = list(a)
                    launched[5] = 1
                add((cell, tag(depth), name, variant), name, variant,
                    launched, out)
    # K12 on the lowering's padded planes and on pack_ell's planes
    scall = lowering.prepare_call(compiler.spmv_nest(hm, hk), sparse.SPMV,
                                  {"vals": hv, "cidx": hc, "x": hx})
    lowered = scall.lowered
    padded = lowering.stream_layouts(lowered, [hv, hc, hx])
    geo = scall.kernel.geometry
    name, out, a = launch_args(scall, None, padded)
    assert name == "gather_spmv", name
    sv, sc = hopper._stream_arg(geo.ins[0], hv), \
        hopper._stream_arg(geo.ins[1], hc)
    keep += [out, sv, sc, padded]
    planes = list(a)
    planes[0], planes[1] = hv.data_ptr(), hc.data_ptr()
    planes[5], planes[6] = ctypes.byref(sv), ctypes.byref(sc)
    for variant in plan["gather_spmv"]:
        if variant == "planes":
            continue
        add(("spmv_hpcg", "padded", "gather_spmv", variant), "gather_spmv",
            variant, a, out)
        add(("spmv_hpcg", "planes", "gather_spmv", variant), "gather_spmv",
            variant, planes, out)
    bname, bout, ba = grabbed(lambda: hopper.base_spmv(hv, hc,
                                                       hx.reshape(1, -1)))
    keep.append(bout)
    add(("spmv_hpcg", "planes", bname, "as_is"), bname, "as_is", ba, bout)
    live = {k: f for k, f in fns.items() if f is not None}
    for f in live.values():
        f()
    torch.cuda.synchronize()
    exact = {}
    for key, o in outs.items():
        cell, depth, name, variant = key
        if name == "ring_contract_gemv" and variant in ("as_is", *LAUNCH):
            want = outs.get((cell, "2", "contract_gemv",
                             "elements" if variant == "elements"
                             else "as_is"))
        elif name == "gather_spmv":
            want = outs.get(("spmv_hpcg", "padded", "gather_spmv", "as_is"))
        else:
            continue
        bits = torch.int16 if o.dtype == torch.bfloat16 else torch.int32
        exact["/".join(key)] = want is not None and bool(torch.equal(
            o.contiguous().view(bits), want.contiguous().view(bits)))
    csr = torch.sparse_csr_tensor(hcsr[2].to(torch.int32), hcsr[1], hcsr[0],
                                  size=(n_v, n_v))
    lib_fns = {
        "gemv": lambda: torch.mv(ga, gx),
        "gemv_bf16": (lambda ab=ga.bfloat16(), xb=gx.bfloat16():
                      torch.mv(ab, xb)),
        "spmv_hpcg": lambda: csr @ hx}
    keys = [*live, *(("library", c) for c in lib_fns)]
    call_of = {**live, **{("library", c): f for c, f in lib_fns.items()}}
    samples = {k: [] for k in keys}
    medians = {k: [] for k in keys}
    for k in [*keys, *reversed(keys)]:
        t = time_ms(call_of[k])
        samples[k] += t
        medians[k].append(statistics.median(t))
    # each gemv cell and depth through the port's wrapper, as
    # chip_smoke.py times it: the device time of back-to-back calls, and
    # the host's time to issue one call (checks, arguments, launch)
    wrapper = {}
    for (cell, depth), call in calls.items():
        def fn(c_=call):
            return c_.kernel(*c_.layouts)
        t = time_ms(fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        host = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        wrapper[f"{cell}/{depth}"] = {"ms": statistics.median(t),
                                      "host_ms": host}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    ms = {"/".join(map(str, k)): None for k, f in fns.items() if f is None}
    for k in keys:
        ms["/".join(map(str, k))] = {"ms": statistics.mean(medians[k]),
                                     "spread": quartile_gap(samples[k])}
    result = {
        "phase": "gemv_spmv_ablation", "card": smi,
        "device": torch.cuda.get_device_name(0), "sms": sms,
        "exact": exact,
        "ptxas": {f"{n}/{v}": {k: val for k, val in b.items() if k != "so"}
                  for (n, v), b in built.items()},
        "ms": ms, "wrapper": wrapper}
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0 if all(exact.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
