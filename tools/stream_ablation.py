#!/usr/bin/env python3
"""Where K15 and K16 spend their time: each kernel beside copies of itself
with one part taken out.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 tools/stream_ablation.py [--seed 0]

Each variant is the kernel's source (``csrc/stream_fft.cu``,
``csrc/stream_bitonic.cu``) with some lines replaced (``VARIANTS``),
compiled into ``build/stream_ablation/`` and launched through its C entry
on the main cells: K15 on 32,768 rows of 2048 points, K16 on one row of
2**26 f32 (inputs ~ N(0, 1) from ``--seed``).  A variant without a part
computes a wrong result; only ``as_is`` is checked (to the bit against the
plain version or ``torch.sort``).  The variants run in turns (forward, then
backward), each timed as the median of CUDA-event samples.  The time a
part costs is ``as_is`` less the variant without it: what the kernel waits
on is read off the differences, as a profiler's stall counts would give it
where one runs; K16's variants are also split by pass kind from a profiler
trace.  Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import hopper  # noqa: E402
from repro_torch.kernels import bitonic, fft  # noqa: E402

_TW = ("__ldg(wr + s * kHalf + p)", "__ldg(wi + s * kHalf + p)")

#: kernel → variant → (old, new) replacements of its source
VARIANTS = {
    "stream_fft": {
        "as_is": (),
        # every twiddle load hits a 32-word table: the same loads, no misses
        "twiddles_in_l1": ((_TW[0], "__ldg(wr + (p & 31))"),
                           (_TW[1], "__ldg(wi + (p & 31))")),
        # no twiddle loads at all (one value read once a row)
        "no_twiddle_loads": ((_TW[0], "w_r0"), (_TW[1], "w_i0"),
                             ("  const int w_t = exchange_word(t);",
                              "  const int w_t = exchange_word(t);\n"
                              "  const float w_r0 = __ldg(wr), "
                              "w_i0 = __ldg(wi);")),
        # no barriers (the exchanges race)
        "no_barriers": (("__syncthreads();", ";"),),
        # no shared-memory exchange (each group runs on its own registers)
        "no_exchanges": (("          vr[c] = sr[w];\n          vi[c] = si[w];",
                          "          (void)w;"),
                         ("          sr[w] = vr[c];\n          si[w] = vi[c];",
                          "          (void)w;"),
                         ("__syncthreads();", ";")),
        # radix 16: four stages a group (no conflict-free swizzle for it)
        "radix16": (("constexpr int kRadixLog2 = 3;",
                     "constexpr int kRadixLog2 = 4;"),),
    },
    "stream_bitonic": {
        "as_is": (),
        # the runs cross shared memory, no compare-exchange
        "no_stages": (("      reg_stage<O, Exact>(v, code & 7, dflag, "
                       "kind == 2 ? 1u << bit : 0u);",
                       "      (void)dflag;"),),
        # each pass only copies its tiles in and out
        "copy_only": (("    if (exact)\n"
                       "      run_stages<O, O::kNan>(sm, tile, pass);\n"
                       "    else\n"
                       "      run_stages<O, false>(sm, tile, pass);",
                       "    (void)exact;"),),
    },
}


OUT = ROOT / "build" / "stream_ablation"


def build(name: str, variant: str, subs) -> ctypes.CDLL:
    """Kernel ``name``'s source with ``subs`` (old, new) replaced, built
    into ``OUT``; nvcc's register and spill counts on ``lib.ptxas``."""
    src = (hopper.CSRC / f"{name}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name} {variant}: {old!r} is not in the source")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}_{variant}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    proc = subprocess.run([hopper._nvcc(), *hopper.NVCC_FLAGS,
                           "-I", str(hopper.CSRC), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name} {variant}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.ptxas = {
        "registers": sorted(set(re.findall(r"Used (\d+) registers",
                                           proc.stderr))),
        "spill_stores": sorted(set(re.findall(r"(\d+) bytes spill stores",
                                              proc.stderr)))}
    return lib


def pass_times(fn, n: int) -> dict:
    """Device ms of one K16 call, summed by pass kind (tile sort, group,
    tile merge), from a ``torch.profiler`` trace: its kernels in launch
    order are ``sort_passes``'s passes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    OUT.mkdir(parents=True, exist_ok=True)
    trace = OUT / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())
    events = events.get("traceEvents", []) if isinstance(events, dict) \
        else events
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    passes = bitonic.sort_passes(n)
    if len(kernels) != len(passes):
        return {"kernels": len(kernels), "passes": len(passes)}
    out = {}
    for p, e in zip(passes, kernels):
        out[p.kind] = out.get(p.kind, 0.0) + e["dur"] / 1e3
    return out


def time_ms(fn, samples: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stream_ablation: needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    # K15's cell and its plain version
    rows, n = 32768, 2048
    stages = n.bit_length() - 1
    re, im = (torch.randn(rows, n, generator=gen, device="cuda")
              for _ in range(2))
    wr, wi = fft._twiddles_on(n, re.device)
    yr, yi = (torch.empty_like(re) for _ in range(2))
    want_f = fft.stockham_grouped(re, im, wr, wi)
    # K16's cell
    x = torch.randn(1 << 26, generator=gen, device="cuda")
    out = torch.empty_like(x)
    want_s = torch.sort(x).values
    calls, ok = {}, {}
    for name, variants in VARIANTS.items():
        for variant, subs in variants.items():
            lib = build(name, variant, subs)
            fn = getattr(lib, f"ssr_{name}")
            fn.restype = ctypes.c_int
            if name == "stream_fft":
                fn.argtypes = [P, P, ctypes.c_int, P, P, P, P, P, P, I64,
                               I64, ctypes.c_int, P]
                args_ = (re.data_ptr(), im.data_ptr(), 0, wr.data_ptr(),
                         wi.data_ptr(), yr.data_ptr(), yi.data_ptr(), None,
                         None, rows, n, stages, stream)
            else:
                fn.argtypes = [P, P, ctypes.c_int, I64, I64, P]
                args_ = (x.data_ptr(), out.data_ptr(), 0, 1, 1 << 26, stream)

            def call(fn=fn, args_=args_, tag=(name, variant)):
                rc = fn(*args_)
                if rc != 0:
                    raise SystemExit(f"{tag}: CUDA error {rc}")
            calls[(name, variant)] = call
            if variant == "as_is":
                call()
                torch.cuda.synchronize()
                ok[name] = (all(torch.equal(a.view(torch.int32),
                                            b.view(torch.int32))
                                for a, b in zip((yr, yi), want_f))
                            if name == "stream_fft" else
                            torch.equal(out.view(torch.int32),
                                        want_s.view(torch.int32)))
    keys = list(calls)
    ms = {k: [] for k in keys}
    for k in [*keys, *reversed(keys)]:
        ms[k].append(time_ms(calls[k]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    # K16's variants by pass kind (tile sort, group passes, tile merges)
    by_kind = {v: pass_times(calls[("stream_bitonic", v)], 1 << 26)
               for v in VARIANTS["stream_bitonic"]}
    result = {"phase": "stream_ablation", "card": smi,
              "stream_bitonic_pass_ms": by_kind,
              "device": torch.cuda.get_device_name(0), "as_is_exact": ok,
              "launches": {"stream_fft": 1,
                           "stream_bitonic": len(bitonic.sort_passes(1 << 26))},
              "ms": {name: {v: ms[(name, v)] for v in variants}
                     for name, variants in VARIANTS.items()}}
    print(json.dumps(result))
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
