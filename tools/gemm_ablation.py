#!/usr/bin/env python3
"""What holds R3 and B3 back: the gemm kernels beside copies of themselves
with one cause changed.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 tools/gemm_ablation.py [--seed 0] [--depths 3,4,8]

The cell is chip_smoke.py's ``gemm``: C = A · B at 4096**3 in f32, A and B
~ N(0, 1) made on the card from ``--seed``; K3 and B3 on it, R3 at each of
``--depths``.  Each variant is a kernel's source with some lines replaced
(``variants``), compiled into ``build/gemm_ablation/`` and launched
through its C entry with the arguments the port's wrapper would pass
(``launch_args``):

* ``no_compute``: R3's FMA loop replaced by one read of each slot, so the
  run is the ring's delivery alone (the delivery floor);
* ``no_barrier``: the step loop's ``__syncthreads()`` taken out of the
  CTA-barrier ring (the ring races; a design without one has no such
  variant);
* ``ctas_1``, ``ctas_2``: R3 bounded by ``__launch_bounds__`` to that many
  CTAs an SM (registers; shared memory may allow fewer);
* ``k3_rows``: R3 reading A with K3's thread-to-row map (a warp's two row
  sets four rows apart) instead of adjacent rows, where the design has
  the choice: the bank conflicts the adjacent rows avoid;
* ``cp_async``: R3's TMA route switched off, so an aligned f32 layout
  takes the producer warp's cp.async route;
* ``chunk_128``, ``chunk_64``, ``chunk_32``: B3's k chunk at that width
  (the one buffer shrinks with it); ``ctas_1``, ``ctas_2``: B3 bounded to
  that many CTAs an SM (the design with a 128-wide chunk: at a 32-wide one).

The script runs on the sources of the checkout it sits in; copied into a
checkout of an earlier design it measures that one.  A variant whose lines
are not in the source (another design) is reported as ``null``.  Only
``as_is`` is checked: R3 to the bit against K3, B3 within CONTRACT_LIMIT
of K3 relative to |A|·|B|.  Each compiled variant also carries a probe
that reads, for the instantiation the cell launches, its registers and
local bytes (``cudaFuncGetAttributes``) and its CTAs an SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the launch's
threads and dynamic shared memory); ``ptxas`` holds ``nvcc -Xptxas -v``'s
registers, stack and spill bytes of every instantiation in the source.
The variants run in turns (forward, then backward), each the median of
CUDA-event samples of back-to-back launches.  Prints one JSON line with
the card's name and power limit.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import compiler, hopper, lowering  # noqa: E402
from repro_torch.kernels import gemm  # noqa: E402

SIZE = 4096
CONTRACT_LIMIT = 5e-6
OUT = ROOT / "build" / "gemm_ablation"

#: kernel → ((a line that marks the design, the instantiation the cell
#: launches, the dynamic shared memory the probe asks for: ``smem`` is the
#: launch's argument), ...); the first design whose line is in the source
#: is probed
PROBES = {
    "contract_gemm": (("contract_gemm_kernel<T, O, 4><<<",
                       "contract_gemm_kernel<float, float, 4>", "0"),),
    "base_gemm": (("base_gemm_kernel<T, O, V>",
                   "base_gemm_kernel<float, float, 4>", "kSmemBytes"),),
    "ring_contract_gemm": (
        ("SsrRingSide side(ring, mine);",
         "ring_contract_gemm_kernel<float, float>", "smem"),
        ("ring_contract_gemm_kernel<float, float, true>",
         "ring_contract_gemm_kernel<float, float, true>", "smem")),
}

_PROBE = """
extern "C" int ablation_probe(int64_t* out, int64_t smem) {
  auto kernel = &%s;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t dyn = %s;
  if (dyn > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, kernel, kThreads, static_cast<size_t>(dyn));
  out[0] = fa.numRegs;
  out[1] = static_cast<int64_t>(fa.localSizeBytes);
  out[2] = ctas;
  out[3] = static_cast<int64_t>(fa.sharedSizeBytes);
  return static_cast<int>(err);
}
"""


def _between(start: str, end: str, new: str) -> tuple:
    """A replacement of the text from ``start`` up to (not including)
    ``end`` by ``new``."""
    return ("between", start, end, new)


#: R3's A fragments read two k at a time (8-byte loads in f32), 16
#: registers of A instead of 32
_PAIRS = (
    ("template <typename T, typename O, bool TMA>\n__global__",
     "__device__ __forceinline__ float2 pair_f32(const float* p) {\n"
     "  return *reinterpret_cast<const float2*>(p);\n}\n"
     "__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {\n"
     "  return __bfloat1622float2(\n"
     "      *reinterpret_cast<const __nv_bfloat162*>(p));\n}\n"
     "template <typename T, typename O, bool TMA>\n__global__"),
    ("sgemm::chunk<kBK, kALd>(acc, As, Bs, rows, tx);",
     "#pragma unroll\n"
     "    for (int kp = 0; kp < kBK / 2; ++kp) {\n"
     "      float2 a2[8];\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < 8; ++i)\n"
     "        a2[i] = pair_f32(As + rows(i) * kALd + kp * 2);\n"
     "#pragma unroll\n"
     "      for (int k2 = 0; k2 < 2; ++k2) {\n"
     "        float am[8], bn[8];\n"
     "#pragma unroll\n"
     "        for (int i = 0; i < 8; ++i) am[i] = k2 ? a2[i].y : a2[i].x;\n"
     "        sgemm::load_b(bn, Bs, kp * 2 + k2, tx);\n"
     "        sgemm::fma_step(acc, am, bn);\n"
     "      }\n"
     "    }"))


#: kernel → variant → alternatives, each a tuple of replacements for one
#: design: (old, new) pairs or ``_between`` spans
def variants() -> dict:
    return {
        "contract_gemm": {"as_is": ((),)},
        "base_gemm": {
            "as_is": ((),),
            "chunk_128": (
                (("kBK = 64;", "kBK = 128;"),),),
            "chunk_64": (
                (("kBN = 128, kBK = 128;", "kBN = 128, kBK = 64;"),),),
            "chunk_32": (
                (("kBN = 128, kBK = 128;", "kBN = 128, kBK = 32;"),),
                (("kBK = 64;", "kBK = 32;"),)),
            "ctas_2": (
                (("kBN = 128, kBK = 128;", "kBN = 128, kBK = 32;"),
                 ("__launch_bounds__(kThreads)",
                  "__launch_bounds__(kThreads, 2)")),),
            "ctas_1": (
                (("__launch_bounds__(kThreads, 2)",
                  "__launch_bounds__(kThreads, 1)"),),),
        },
        "ring_contract_gemm": {
            "as_is": ((),),
            "no_compute": (
                # the CTA-barrier ring: the kq loop up to the steps
                (_between("#pragma unroll\n    for (int kq = 0; kq < kBK / 4;",
                          "    ra.step();\n",
                          "    acc[0][0] += ssr_f32(As[threadIdx.x]) + "
                          "ssr_f32(Bs[threadIdx.x]);\n"),),
                # the producer-warp ring: the shared FMA core's call
                (("sgemm::chunk<kBK, kALd>(acc, As, Bs, rows, tx);",
                  "acc[0][0] += ssr_f32(As[threadIdx.x]) + "
                  "ssr_f32(Bs[threadIdx.x]);"),)),
            "no_barrier": (
                (("    side.wait();\n    __syncthreads();\n",
                  "    side.wait();\n"),),),
            "ctas_1": (
                (("__launch_bounds__(kThreads)\n",
                  "__launch_bounds__(kThreads, 1)\n"),),),
            "ctas_2": (
                (("__launch_bounds__(kThreads)\n",
                  "__launch_bounds__(kThreads, 2)\n"),),
                (("__launch_bounds__(kThreads, 1)",
                  "__launch_bounds__(kThreads, 2)"),)),
            "pairs_1": (_PAIRS,),
            "pairs_2": ((*_PAIRS, ("__launch_bounds__(kThreads, 1)",
                                   "__launch_bounds__(kThreads, 2)")),),
            "k3_rows": (
                (("sgemm::RowsAdjacent rows(ty);",
                  "sgemm::RowsK3 rows(ty);"),),),
            "cp_async": (
                (("const bool tma = cvec == 2;", "const bool tma = false;"),),),
        },
    }


def apply(src: str, subs) -> str:
    """``src`` with ``subs`` replaced, or None where a line to replace is
    not in it."""
    for sub in subs:
        if sub[0] == "between":
            _, start, end, new = sub
            i = src.find(start)
            j = src.find(end, i + 1) if i >= 0 else -1
            if i < 0 or j < 0:
                return None
            src = src[:i] + new + src[j:]
        else:
            old, new = sub
            if old not in src:
                return None
            src = src.replace(old, new, 1)
    return src


def source(csrc: Path, name: str, alternatives) -> str:
    """Kernel ``name``'s source under the first alternative whose lines it
    holds, with the probe of its design appended; None if none applies."""
    base = (csrc / f"{name}.cu").read_text()
    probe = next(((inst, smem) for mark, inst, smem in PROBES[name]
                  if mark in base), None)
    if probe is None:
        return None
    for subs in alternatives:
        src = apply(base, subs)
        if src is not None:
            return src + _PROBE % probe
    return None


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


def launch_args(fn) -> tuple:
    """What the port's wrapper passes its kernel when ``fn`` calls it:
    (kernel name, output tensor, arguments)."""
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


def time_ms(fn, samples: int = 7) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 5)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depths", default="3,4,8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemm_ablation: needs a CUDA device")
    depths = [int(d) for d in args.depths.split(",")]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    a = torch.randn(SIZE, SIZE, generator=gen, device=dev)
    b = torch.randn(SIZE, SIZE, generator=gen, device=dev)
    csrc = hopper.CSRC
    OUT.mkdir(parents=True, exist_ok=True)
    nest = compiler.gemm_nest(SIZE, SIZE, SIZE)
    calls = {d: lowering.prepare_call(
        nest, gemm.DOT, {"A": a, "B": b},
        schedule=lowering.Schedule(buffer_depth=d)) for d in [2, *depths]}

    def contract(call, ring):
        kern = call.kernel
        return lambda: kern.device_kernel()(
            kern.geometry, call.layouts, kern.out_dtype, kern.acc_dtype,
            program=kern.program, ring=ring)

    plan = variants()
    srcs = {(n, v): source(csrc, n, alts)
            for n, vs in plan.items() for v, alts in vs.items()}
    todo = {k: s for k, s in srcs.items() if s is not None}
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        built = dict(zip(todo, pool.map(
            lambda kv: compile_(csrc, *kv[0], kv[1]), todo.items())))
    stream = torch.cuda.current_stream().cuda_stream
    # kernel → (tag, the wrapper's call): R3 at each depth
    cells = {"contract_gemm": [("", contract(calls[2], None))],
             "base_gemm": [("", lambda: hopper.base_gemm(a, b))],
             "ring_contract_gemm": [
                 (str(d), contract(calls[d], calls[d].kernel.ring))
                 for d in depths]}
    fns, outs, probes = {}, {}, {}
    for (name, variant), b_ in built.items():
        lib = ctypes.CDLL(b_["so"])
        entry = getattr(lib, f"ssr_{name}")
        entry.argtypes = hopper._SIGNATURES[name]
        entry.restype = ctypes.c_int
        probe = lib.ablation_probe
        probe.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        probe.restype = ctypes.c_int
        for tag, wrapper in cells[name]:
            launched, out, a_ = launch_args(wrapper)
            assert launched == name, (launched, name)
            key = (name, variant, tag)
            res = (ctypes.c_int64 * 4)()
            smem = a_[-1] if name == "ring_contract_gemm" else 0
            rc = probe(res, smem)
            probes[key] = {"registers": res[0], "local_bytes": res[1],
                           "ctas_per_sm": res[2], "static_smem": res[3],
                           "dynamic_smem": smem} if rc == 0 else {"error": rc}

            def call_(fn=entry, a_=tuple(a_), key=key):
                rc = fn(*a_, stream)
                if rc != 0:
                    raise SystemExit(f"{key}: CUDA error {rc}")
            fns[key] = call_
            outs[key] = out
    for key in fns:
        if key[1] == "as_is":
            fns[key]()
    torch.cuda.synchronize()
    k3 = outs["contract_gemm", "as_is", ""]
    scale = torch.abs(a) @ torch.abs(b)
    ok = {f"ring_contract_gemm_{d}": bool(torch.equal(
        outs["ring_contract_gemm", "as_is", str(d)].view(torch.int32),
        k3.view(torch.int32))) for d in depths}
    b3_err = float(((outs["base_gemm", "as_is", ""] - k3).abs()
                    / scale).max())
    ok["base_gemm"] = b3_err <= CONTRACT_LIMIT
    del scale
    keys = list(fns)
    ms = {k: [] for k in keys}
    for k in [*keys, *reversed(keys)]:
        ms[k].append(time_ms(fns[k]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()

    def label(name, variant, tag):
        return variant if not tag else f"{variant}@{tag}"
    result = {
        "phase": "gemm_ablation", "card": smi,
        "device": torch.cuda.get_device_name(0), "depths": depths,
        "as_is_exact": ok, "base_gemm_rel_to_abs_prod": b3_err,
        "ptxas": {n: {k: v for k, v in built[n, "as_is"].items()
                      if k != "so"} for n in plan if (n, "as_is") in built},
        "probe": {n: {label(*k): probes[k] for k in probes if k[0] == n}
                  for n in plan},
        "ms": {n: {**{label(n, v, t): statistics.mean(ms[n, v, t])
                      for (n_, v, t) in ms if n_ == n},
                   **{v: None for v in vs if (n, v) not in built}}
               for n, vs in plan.items()}}
    print(json.dumps(result))
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
