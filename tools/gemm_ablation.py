#!/usr/bin/env python3
"""What holds K3, R3 and B3 back: the gemm kernels beside copies of
themselves with one cause changed.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 tools/gemm_ablation.py [--seed 0] [--depths 2,3,4,8]

The cell is chip_smoke.py's ``gemm``: C = A · B at 4096**3 in f32, A and B
~ N(0, 1) made on the card from ``--seed``; K3 and B3 on it, R3 at each of
``--depths`` (``as_is@2`` is R3's producer-warp design launched through its
own C entry at depths (2, 2), the depth K3 runs at).  K3 also runs, each of
its variants too, on two more layouts of the same product: ``@lanes_126``
(the schedule of 126 lanes: f32 blocks 378 wide on a 4158-element pitch,
so K3's copies move 4-byte words) and ``@bf16`` (A and B rounded to bf16,
in 16-byte packs).  Each variant is a kernel's source with some lines
replaced (``variants``), compiled into ``build/gemm_ablation/`` and
launched through its C entry with the arguments the port's wrapper would
pass (``launch_args``).  K3's (its two buffers of 32 k: A staged through
registers in two rounds of 16 k, B by cp.async):

* ``k3_no_compute``: K3's FMAs replaced by one read of each buffer, so the
  run is its delivery alone (the delivery floor);
* ``k3_no_barrier``: the CTA barrier of K3's step loop taken out (the
  buffers race; the result is not checked);
* ``k3_chunk_16``, ``k3_chunk_48``, ``k3_chunk_64``: K3's k chunk at that
  width (its buffers grow or shrink with it);
* ``k3_words``: the copies one element each (4-byte words in f32) where
  the layout allows 16-byte packs (what the packs buy);
* ``k3_rounds_rolled``, ``k3_prologue_unrolled``: the step loop's two
  rounds kept rolled, the prologue's unrolled (the compiler's schedule);
* ``k3_ctas_1``: the register cap lifted (one CTA an SM).

R3's and B3's:

* ``no_compute``: R3's FMA core replaced by one read of each slot, so the
  run is the ring's delivery alone (the delivery floor);
* ``ctas_2``: R3 bounded by ``__launch_bounds__`` to two CTAs an SM;
* ``pairs_1``, ``pairs_2``: R3 reading A two k at a time, at one or two
  CTAs an SM;
* ``k3_rows``: R3 reading A with K3's thread-to-row map (a warp's two row
  sets four rows apart) instead of adjacent rows: the bank conflicts the
  adjacent rows avoid;
* ``cp_async``: R3's TMA route switched off, so an aligned f32 layout
  takes the producer warp's cp.async route;
* ``chunk_128``, ``chunk_32``: B3's k chunk at that width (the one buffer
  grows or shrinks with it); ``ctas_1``: B3 bounded to one CTA an SM.

The script runs on the sources of the checkout it sits in; copied into a
checkout of an earlier design it times that one's ``as_is`` kernels (a
variant whose lines are not in the source is reported as ``null``, and a
kernel whose probed instantiation is not in it is built without the
probe).  The ``as_is`` kernels are checked (``as_is_exact``): R3 to the bit
against K3, K3 on ``lanes_126`` to the bit against K3 on the cell, B3 and
K3 on ``bf16`` within CONTRACT_LIMIT of the product (TF32 off) relative to
|A|·|B|; and so are K3's variants that keep its arithmetic, to the bits of
K3 on the same layout (``k3_variants_exact``; not the delivery floor, nor
the racing one).  Each compiled variant also carries a probe that reads,
for the f32 instantiation the cell launches, its registers and local bytes
(``cudaFuncGetAttributes``) and its CTAs an SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the launch's threads
and dynamic shared memory); ``ptxas`` holds ``nvcc -Xptxas -v``'s
registers, stack and spill bytes of every instantiation in the source,
beside the instantiations' (mangled) names.  The variants run in turns
(forward, then backward), each the median of CUDA-event samples of
back-to-back launches.  Prints one JSON line with the card's name and
power limit.
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
from repro_torch.core.agu import RingProgram  # noqa: E402
from repro_torch.kernels import gemm  # noqa: E402

SIZE = 4096
CONTRACT_LIMIT = 5e-6
OUT = ROOT / "build" / "gemm_ablation"

#: kernel → (a line that marks the design, the f32 instantiation the cell
#: launches, the dynamic shared memory the probe asks for: ``smem`` is the
#: launch's argument)
PROBES = {
    "contract_gemm": ("contract_gemm_kernel<T, O, ROUTE>",
                      "contract_gemm_kernel<float, float, kPacks>",
                      "ssr_contract_gemm_smem_bytes(SSR_F32)"),
    "base_gemm": ("base_gemm_kernel<T, O, V>",
                  "base_gemm_kernel<float, float, 4>", "kSmemBytes"),
    "ring_contract_gemm": ("ring_contract_gemm_kernel<float, float, true>",
                           "ring_contract_gemm_kernel<float, float, true>",
                           "smem"),
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


#: kernel → variant → its (old, new) replacements
def variants() -> dict:
    return {
        "contract_gemm": {
            "as_is": (),
            "k3_no_compute": (
                ("      sgemm::chunk_kmajor<kRound, kPadM>(acc, As + r * "
                 "kRound * kPadM,\n"
                 "                                         Bs + r * kRound * "
                 "kBN, ty, tx);",
                 "      acc[0][0] += As[threadIdx.x + r] + "
                 "ssr_f32(Bs[threadIdx.x + r]);"),),
            "k3_no_barrier": (
                ("    ssr_cp_async_wait<0>();\n    __syncthreads();",
                 "    ssr_cp_async_wait<0>();"),),
            "k3_chunk_16": (
                ("constexpr int kBK = 32;", "constexpr int kBK = 16;"),),
            "k3_chunk_48": (
                ("constexpr int kBK = 32;", "constexpr int kBK = 48;"),),
            "k3_chunk_64": (
                ("constexpr int kBK = 32;", "constexpr int kBK = 64;"),),
            "k3_words": (
                ("    return launch_route<T, O, kPacks>(",
                 "    return launch_route<T, O, kOff>("),),
            "k3_rounds_rolled": (
                ("#pragma unroll\n    for (int r = 0; r < kBK / kRound; "
                 "++r) {   // and A's",
                 "#pragma unroll 1\n    for (int r = 0; r < kBK / kRound; "
                 "++r) {   // and A's"),),
            "k3_ctas_1": (
                ("__launch_bounds__(kThreads, ROUTE == kPacks ? 2 : 1)",
                 "__launch_bounds__(kThreads, 1)"),),
            "k3_prologue_unrolled": (
                ("#pragma unroll 1\n  for (int r = 0; r < kBK / kRound; "
                 "++r) {\n    load_round",
                 "#pragma unroll\n  for (int r = 0; r < kBK / kRound; ++r) "
                 "{\n    load_round"),),
        },
        "base_gemm": {
            "as_is": (),
            "chunk_128": (("kBK = 64;", "kBK = 128;"),),
            "chunk_32": (("kBK = 64;", "kBK = 32;"),),
            "ctas_1": (("__launch_bounds__(kThreads, 2)",
                        "__launch_bounds__(kThreads, 1)"),),
        },
        "ring_contract_gemm": {
            "as_is": (),
            "no_compute": (
                ("sgemm::chunk<kBK, kALd>(acc, As, Bs, rows, tx);",
                 "acc[0][0] += ssr_f32(As[threadIdx.x]) + "
                 "ssr_f32(Bs[threadIdx.x]);"),),
            "ctas_2": (("__launch_bounds__(kThreads, 1)",
                        "__launch_bounds__(kThreads, 2)"),),
            "pairs_1": _PAIRS,
            "pairs_2": (*_PAIRS, ("__launch_bounds__(kThreads, 1)",
                                  "__launch_bounds__(kThreads, 2)")),
            "k3_rows": (("sgemm::RowsAdjacent rows(ty);",
                         "sgemm::RowsK3 rows(ty);"),),
            "cp_async": (("const bool tma = cvec == 2;",
                          "const bool tma = false;"),),
        },
    }


def source(csrc: Path, name: str, subs) -> str:
    """Kernel ``name``'s source with ``subs`` replaced and, where it holds
    the design the probe knows, the probe appended; None where a line to
    replace is not in it."""
    src = (csrc / f"{name}.cu").read_text()
    for old, new in subs:
        if old not in src:
            return None
        src = src.replace(old, new, 1)
    mark, inst, smem = PROBES[name]
    return src + _PROBE % (inst, smem) if mark in src else src


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
    return {"so": str(so),
            "entries": re.findall(r"Compiling entry function '([^']+)'", err),
            "registers": nums(r"Used (\d+) registers"),
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
    ap.add_argument("--depths", default="2,3,4,8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemm_ablation: needs a CUDA device")
    depths = [int(d) for d in args.depths.split(",")]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    a = torch.randn(SIZE, SIZE, generator=gen, device=dev)
    b = torch.randn(SIZE, SIZE, generator=gen, device=dev)
    a16, b16 = a.bfloat16(), b.bfloat16()
    csrc = hopper.CSRC
    OUT.mkdir(parents=True, exist_ok=True)
    nest = compiler.gemm_nest(SIZE, SIZE, SIZE)
    calls = {d: lowering.prepare_call(
        nest, gemm.DOT, {"A": a, "B": b},
        schedule=lowering.Schedule(buffer_depth=d)) for d in {2, *depths}}
    # K3's other layouts of the same product
    k3_calls = {
        "": calls[2],
        "lanes_126": lowering.prepare_call(
            nest, gemm.DOT, {"A": a, "B": b},
            schedule=lowering.Schedule(lanes=126)),
        "bf16": lowering.prepare_call(nest, gemm.DOT, {"A": a16, "B": b16})}

    def ring_at(d):
        """R3's ring at depth d: the schedule's above 2; at 2, where the
        schedule runs K3, the ring (2, 2) given to the wrapper itself."""
        kern = calls[d].kernel
        return kern.ring if kern.pipelined else RingProgram((d, d),
                                                            (False, False))

    def contract(call, ring):
        kern = call.kernel
        return lambda: kern.device_kernel()(
            kern.geometry, call.layouts, kern.out_dtype, kern.acc_dtype,
            program=kern.program, ring=ring)

    plan = variants()
    srcs = {(n, v): source(csrc, n, subs)
            for n, vs in plan.items() for v, subs in vs.items()}
    todo = {k: s for k, s in srcs.items() if s is not None}
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        built = dict(zip(todo, pool.map(
            lambda kv: compile_(csrc, *kv[0], kv[1]), todo.items())))
    stream = torch.cuda.current_stream().cuda_stream
    # kernel → (tag, the wrapper's call): K3 on each layout, R3 at each depth
    cells = {"contract_gemm": [(t, contract(c, None))
                               for t, c in k3_calls.items()],
             "base_gemm": [("", lambda: hopper.base_gemm(a, b))],
             "ring_contract_gemm": [
                 (str(d), contract(calls[d], ring_at(d))) for d in depths]}
    fns, outs, probes = {}, {}, {}
    for (name, variant), b_ in built.items():
        lib = ctypes.CDLL(b_["so"])
        entry = getattr(lib, f"ssr_{name}")
        entry.argtypes = hopper._SIGNATURES[name]
        entry.restype = ctypes.c_int
        probe = getattr(lib, "ablation_probe", None)
        if probe is not None:
            probe.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
            probe.restype = ctypes.c_int
        for tag, wrapper in cells[name]:
            launched, out, a_ = launch_args(wrapper)
            assert launched == name, (launched, name)
            key = (name, variant, tag)
            res = (ctypes.c_int64 * 4)()
            smem = a_[-1] if name == "ring_contract_gemm" else 0
            rc = -1 if probe is None else probe(res, smem)
            probes[key] = None if probe is None else {
                "registers": res[0], "local_bytes": res[1],
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

    def k3(tag):
        return outs["contract_gemm", "as_is", tag]

    def same_bits(x, y):
        return bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))

    def rel_err(got, x, y):
        """max |got - x·y| / |x|·|y| over the product's outputs."""
        x, y = x.float(), y.float()
        want = x @ y
        scale = x.abs() @ y.abs()
        return float(((got[:SIZE, :SIZE] - want).abs() / scale).max())

    ok = {f"ring_contract_gemm_{d}": same_bits(
        outs["ring_contract_gemm", "as_is", str(d)], k3(""))
        for d in depths}
    ok["contract_gemm_lanes_126"] = same_bits(
        k3("lanes_126")[:SIZE, :SIZE].contiguous(), k3(""))
    errs = {"base_gemm": rel_err(outs["base_gemm", "as_is", ""], a, b),
            "contract_gemm_bf16": rel_err(k3("bf16"), a16, b16)}
    ok.update({k: e <= CONTRACT_LIMIT for k, e in errs.items()})
    keys = list(fns)
    ms = {k: [] for k in keys}
    for k in [*keys, *reversed(keys)]:
        ms[k].append(time_ms(fns[k]))
    # K3's variants that keep its arithmetic, to its bits on each layout
    same = {f"{v}@{t}" if t else v: same_bits(out, k3(t))
            for (n, v, t), out in outs.items() if n == "contract_gemm"
            and v not in ("as_is", "k3_no_compute", "k3_no_barrier")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()

    def label(variant, tag):
        return variant if not tag else f"{variant}@{tag}"
    result = {
        "phase": "gemm_ablation", "card": smi,
        "device": torch.cuda.get_device_name(0), "depths": depths,
        "as_is_exact": ok, "rel_to_abs_prod": errs,
        "k3_variants_exact": same,
        "ptxas": {n: {k: v for k, v in built[n, "as_is"].items()
                      if k != "so"} for n in plan if (n, "as_is") in built},
        "probe": {n: {label(*k[1:]): probes[k] for k in probes if k[0] == n}
                  for n in plan},
        "ms": {n: {**{label(v, t): statistics.mean(ms[n, v, t])
                      for (n_, v, t) in ms if n_ == n},
                   **{v: None for v in vs if srcs[n, v] is None}}
               for n, vs in plan.items()}}
    print(json.dumps(result))
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
