#!/usr/bin/env python3
"""What holds R1 and R2 back: the stage rings of the main path's dot and
relu beside copies of themselves with one cause changed, and beside K1,
K2, ``torch.dot`` and ``torch.relu``.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 tools/stage_ring_ablation.py [--seed 0] [--out FILE]

The cells are chip_smoke.py's: 2**26 elements in (8, 128) blocks, the dot
(``reduction.MUL``, x, y ~ U[0, 1)) in f32 and bf16, relu (``relu.RELU``,
x ~ N(0, 1)) in f32, bf16 and int32, the rings at depths 3, 4 and 8.
Each variant is a kernel's source with some lines replaced, or its launch
with other arguments, compiled into ``build/stage_ring_ablation/`` and
launched through its C entry with the arguments the port's wrapper passes
(``launch_args``):

* ``no_compute``: the multiply-adds (R1) or the selects (R2) taken out;
  ``no_store``: R2's stores taken out (and with them its reads of the
  slot): what the ring's delivery alone takes;
* ``k_split``: R1 on one of K1's runs a CTA (the same partials) in place
  of its persistent CTAs; ``one_wave``: R2 on persistent CTAs, as many as
  its build lets an SM hold, in place of K2's split;
* ``seven_ctas``, ``five_ctas``: built for that many CTAs an SM (32 or 40
  registers a thread) in place of R1's 5 and R2's 4;
* ``elements``: launched with ``vec`` 1, the route of layouts that allow
  no 16-byte packs (element copies in place of one bulk copy a block); K1
  and K2 are timed on it too.

A variant whose lines are not in the source, or whose arguments the entry
does not take, is reported as ``null``: copied into a checkout of the
earlier, CTA-wide ring design, the script times that design's R1 and R2 as
they are, on the elements route, and its R2 on persistent CTAs.  ``as_is``
and every launch variant are checked to the bit against the sync kernel on
the same route, on every cell and depth.  The variants run in turns
(forward, then backward), each time the median of CUDA-event samples of
back-to-back launches; ``spread`` is the distance between the quartiles of
all of a variant's samples.  Also recorded: each kernel's registers, stack
and spill bytes from ``nvcc -Xptxas -v`` and, where the entries report
them, each ring's registers, local bytes and CTAs an SM at the cell's
ring, from the runtime; and each cell and depth through the port's
wrapper (``wrapper``), as ``chip_smoke.py`` times it: the device time of
back-to-back calls (``ms``) and the host's time to issue one (``host_ms``:
the wrapper's checks and arguments and the launch).  Prints one JSON line
with the card's name and power limit.
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
from repro_torch.kernels import reduction, relu  # noqa: E402

N = 1 << 26
DEPTHS = (3, 4, 8)
OUT = ROOT / "build" / "stage_ring_ablation"
#: the CTAs an SM R2 is built for (``csrc/ring_map_relu.cu``)
R2_CTAS = 4

_STORE = """      *reinterpret_cast<Pack*>(po + static_cast<int64_t>(w.r) * so.pitch +
                               w.c * V) = p;
"""
_NO_MUL = ("      for (int j = 0; j < V; ++j) acc += ssr_f32(xa.v[j]) * "
           "ssr_f32(xb.v[j]);\n",
           "      acc += ssr_f32(xa.v[0]) + ssr_f32(xb.v[0]);\n")
_NO_RELU = ("      for (int j = 0; j < V; ++j) p.v[j] = ssr_relu(p.v[j]);\n",
            "")


def _ctas(n: int, old: int) -> tuple:
    """Built for ``n`` CTAs an SM, not ``old``."""
    return (f"constexpr int kMinCtas = {old};",
            f"constexpr int kMinCtas = {n};")


#: variants that launch the kernel as it is, on other arguments
LAUNCH = ("k_split", "one_wave", "elements")


def variants() -> dict:
    """kernel → variant → source replacements (launch variants have
    none)."""
    return {
        "reduce_mul": {"as_is": (), "elements": ()},
        "map_relu": {"as_is": (), "elements": ()},
        "ring_reduce_mul": {"as_is": (), "no_compute": (_NO_MUL,),
                            "seven_ctas": (_ctas(7, 5),), "k_split": (),
                            "elements": ()},
        "ring_map_relu": {"as_is": (), "no_compute": (_NO_RELU,),
                          "no_store": ((_STORE, ""),),
                          "five_ctas": (_ctas(5, 4),),
                          "seven_ctas": (_ctas(7, 4),),
                          "one_wave": (),
                          "elements": ()},
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


def launch_args(call, ring=None) -> tuple:
    """What the port's wrapper passes the kernel for ``call`` (``ring``:
    its ring kernel's): (kernel name, output tensor, arguments)."""
    got = {}
    real = hopper._launch

    def grab(name, dev, *args):
        got["name"], got["args"] = name, list(args)
    hopper._launch = grab
    try:
        kern = call.kernel
        out = kern.device_kernel()(kern.geometry, call.layouts,
                                   kern.out_dtype, kern.acc_dtype,
                                   program=kern.program, ring=ring)
    finally:
        hopper._launch = real
    return got["name"], out, got["args"]


def split_args(args: list, variant: str, steps: int, sms: int) -> list:
    """The arguments of launch ``variant``, or None where the entry takes
    no such split."""
    args = list(args)
    if variant == "elements":
        args[3] = 1
    elif variant == "one_wave":   # R2: (..., ring, smem, CTAs, steps a CTA)
        per = -(-steps // min(steps, R2_CTAS * sms))
        args[-2:] = [-(-steps // per), per]
    elif len(args) == 14:   # R1: (..., partials, runs, steps a run,
        args[-2] = 1        # runs a CTA, out)
    else:
        return None   # the earlier design's R1 takes no runs a CTA
    return args


def ring_occupancy(lib, name: str, args: list) -> dict:
    """The ring kernel's registers a thread, local bytes and CTAs an SM at
    this launch's shared memory, as its attributes entry reads them, and
    the CTAs the launch holds."""
    fn = getattr(lib, f"ssr_{name}_attributes")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int64 * 3)()
    if fn(out, args[8]) != 0:
        raise SystemExit(f"{name}: cudaFuncGetAttributes failed")
    ctas = args[-2] if name == "ring_map_relu" else -(-args[-4] // args[-2])
    return {"numRegs": out[0], "localSizeBytes": out[1], "ctasPerSm": out[2],
            "ctas": ctas}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_ring_ablation: needs a CUDA device")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    csrc = hopper.CSRC
    OUT.mkdir(parents=True, exist_ok=True)
    # the cells, as chip_smoke.py makes them
    x = torch.rand(N, generator=gen, device=dev)
    y = torch.rand(N, generator=gen, device=dev)
    xr = torch.randn(N, generator=gen, device=dev)
    xr[:5] = torch.tensor([-0.0, 0.0, float("nan"), float("-inf"),
                           float("inf")])
    xi = torch.randint(-(1 << 30), 1 << 30, (N,), generator=gen, device=dev,
                       dtype=torch.int32)
    dot, ew = compiler.dot_product_nest(N), compiler.elementwise_nest(N)
    cells = {
        "dot": (dot, reduction.MUL, {"A": x, "B": y}, {}),
        "dot_bf16": (dot, reduction.MUL, {"A": x.bfloat16(),
                                          "B": y.bfloat16()}, {}),
        "relu": (ew, relu.RELU, {"X": xr},
                 {"mode": "map", "out_dtype": xr.dtype}),
        "relu_bf16": (ew, relu.RELU, {"X": xr.bfloat16()},
                      {"mode": "map", "out_dtype": torch.bfloat16}),
        "relu_int32": (ew, relu.RELU, {"X": xi},
                       {"mode": "map", "out_dtype": torch.int32})}
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
    fns, outs, occupancy, parts, calls = {}, {}, {}, [], {}
    for cell, (nest, body, ops_, kw) in cells.items():
        for depth in (2, *DEPTHS):
            sched = lowering.Schedule(buffer_depth=depth)
            call = lowering.prepare_call(nest, body, ops_, schedule=sched,
                                         **kw)
            ring = call.kernel.ring if depth > 2 else None
            calls[cell, depth] = call
            name, out, a = launch_args(call, ring)
            if name.endswith("reduce_mul"):
                # partials of the script's own: the wrapper's were freed
                # when it returned
                parts.append(torch.empty(1 << 16, device=dev))
                a[7 if name == "reduce_mul" else 9] = parts[-1].data_ptr()
            for variant in plan[name]:
                launched = a if variant not in LAUNCH else split_args(
                    a, variant, call.kernel.geometry.steps, sms)
                lib = libs.get((name, "as_is" if variant in LAUNCH
                                else variant))
                if launched is None or lib is None:
                    fns[cell, depth, name, variant] = None
                    continue
                if variant == "as_is" and hasattr(lib,
                                                  f"ssr_{name}_attributes"):
                    occupancy[f"{cell}/{depth}"] = ring_occupancy(
                        lib, name, launched)
                fn = getattr(lib, f"ssr_{name}")
                fn.argtypes = hopper._SIGNATURES[name]
                fn.restype = ctypes.c_int
                o = out if variant == "as_is" else torch.empty_like(out)
                if o is not out:   # the output pointer: out's slot
                    launched = [o.data_ptr() if v == out.data_ptr() else v
                                for v in launched]

                def call_(fn=fn, a_=tuple(launched),
                          tag=(cell, depth, name, variant)):
                    rc = fn(*a_, stream)
                    if rc != 0:
                        raise SystemExit(f"{tag}: CUDA error {rc}")
                fns[cell, depth, name, variant] = call_
                outs[cell, depth, name, variant] = o
    live = {k: f for k, f in fns.items() if f is not None}
    for k, f in live.items():   # K1 and K2 first, the rings after them
        if k[3] in ("as_is", *LAUNCH):
            f()
    torch.cuda.synchronize()
    bits = {c: (torch.int16 if c == "relu_bf16" else torch.int32)
            for c in cells}
    exact = {}
    for (cell, depth, name, variant), o in outs.items():
        if variant in ("as_is", *LAUNCH) and depth > 2:
            want = outs[cell, 2, name.replace("ring_", ""),
                        "elements" if variant == "elements" else "as_is"]
            exact[f"{cell}_{depth}_{variant}"] = bool(torch.equal(
                o.contiguous().view(bits[cell]),
                want.contiguous().view(bits[cell])))
    lib_fns = {
        "dot": lambda: torch.dot(x, y),
        "dot_bf16": (lambda xb=x.bfloat16(), yb=y.bfloat16():
                     torch.dot(xb, yb)),
        "relu": lambda: torch.relu(xr),
        "relu_bf16": lambda xb=xr.bfloat16(): torch.relu(xb),
        "relu_int32": lambda: torch.relu(xi)}
    keys = [*live, *(("library", c) for c in lib_fns)]
    call_of = {**live, **{("library", c): f for c, f in lib_fns.items()}}
    samples = {k: [] for k in keys}
    medians = {k: [] for k in keys}
    for k in [*keys, *reversed(keys)]:
        t = time_ms(call_of[k])
        samples[k] += t
        medians[k].append(statistics.median(t))
    # each cell and depth through the port's wrapper, as chip_smoke.py
    # times it: the device time of back-to-back calls, and the host's time
    # to issue one call (its checks, arguments and launch)
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
        "phase": "stage_ring_ablation", "card": smi,
        "device": torch.cuda.get_device_name(0), "sms": sms,
        "as_is_exact": exact,
        "ptxas": {f"{n}/{v}": {k: val for k, val in b.items() if k != "so"}
                  for (n, v), b in built.items()},
        "occupancy": occupancy, "ms": ms, "wrapper": wrapper}
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0 if all(exact.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
