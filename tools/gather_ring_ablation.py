#!/usr/bin/env python3
"""What holds R13 and R14 back: the gather rings beside copies of
themselves and of K12 and K13 with one cause changed.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 tools/gather_ring_ablation.py [--seed 0] [--depth 4]

The cells are chip_smoke.py's: ``spmv_hpcg`` (HPCG's 27-point operator on
128**3, x ~ U[0, 1)) for K12 and R13, ``spmm_hpcg`` (the operator on 64**3
times X (n, 128) ~ N(0, 1)) for K13 and R14, the rings at ``--depth``.
Each variant is a kernel's source with some lines replaced
(``variants``), compiled into ``build/gather_ring_ablation/`` and
launched through its C entry with the arguments the port's wrapper would
pass (``launch_args``), but where a variant sets the CTAs an SM:

* ``carveout_min`` / ``carveout_max``: the shared-memory carveout forced to
  0 or 100 % (``cudaFuncAttributePreferredSharedMemoryCarveout``), so the
  L1 the gathers hit in grows or shrinks (K12 and the rings);
* ``ctas_2`` … ``ctas_4``: R13 padded with shared memory to that many CTAs
  an SM, its persistent grid sized for them (a count its ring alone does
  not fit is reported as ``null``); ``ctas_3_by_registers`` and
  ``ctas_4_by_registers``: K13 or R14 bounded by registers to that many;
* ``no_compute``: the row arithmetic replaced by one read of the slot, so
  no table gather runs: the delivery floor of vals and cidx;
* ``no_barrier``: the step loop's ``__syncthreads()`` taken out of the
  CTA-barrier ring (the ring races); ``cta_barrier``: one put into R14's
  warp rings, so that a CTA's rows gather at the same step;
* ``four_gathers`` / ``eight_gathers``: R13's gathers a thread in flight
  forced to four (56 registers) or eight (three CTAs an SM by registers),
  where the kernel picks by the CTAs an SM that fit beside its rings.

The script runs on the sources of the checkout it sits in; copied into a
checkout of an earlier design it measures that one.  A variant whose lines
are not in the source (another design) is reported as ``null``.  Only
``as_is`` is checked, to the bit against the sync kernel.  The variants
run in turns (forward, then backward), each the median of CUDA-event
samples of back-to-back launches.  Also recorded: each ``as_is`` kernel's
registers, stack and spill bytes from ``nvcc -Xptxas -v``, its registers
and local bytes from ``cudaFuncGetAttributes`` where the kernels report
them, and whether ``ncu`` is installed.  Prints one JSON line with the
card's name and power limit.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import compiler, hopper, lowering  # noqa: E402
from repro_torch.kernels import sparse  # noqa: E402

SPMV_GRID, SPMM_GRID, SPMM_RHS = 128, 64, 128
OUT = ROOT / "build" / "gather_ring_ablation"


#: The line of a ring kernel's launcher that sets its shared memory (in
#: either design), after ``kernel`` names it
_SMEM_LINE = "  cudaError_t err = ssr_ring_smem(kernel, smem_bytes);\n"


def _carveout(name: str, pct: int, ring: bool) -> tuple:
    """Set the carveout preference of kernel ``name`` before its launch."""
    if ring:
        return ((_SMEM_LINE, "  cudaFuncSetAttribute(kernel, "
                 f"cudaFuncAttributePreferredSharedMemoryCarveout, {pct});\n"
                 + _SMEM_LINE),)
    set_ = (f"cudaFuncSetAttribute({name}_kernel, "
            f"cudaFuncAttributePreferredSharedMemoryCarveout, {pct});")
    return ((f"  {name}_kernel<<<", f"  {set_}\n  {name}_kernel<<<"),)


def _pad_smem(smem: int) -> tuple:
    """Launch with at least ``smem`` bytes of dynamic shared memory."""
    return ((_SMEM_LINE,
             f"  if (smem_bytes < {smem}) smem_bytes = {smem};\n" + _SMEM_LINE),)


_NS = "using namespace gather;\n"
#: kind → design → ((old call, its stand-in), ...), the stand-ins' code:
#: the row arithmetic replaced by one read of the slot, no table gathered
_NO_ROW = {
    ("spmv", "slots"): ((("spmv_row<false", "ablation_row<false"),),
                       "template <bool, int = 4>\n"
                       "__device__ __forceinline__ float ablation_row(\n"
                       "    const float* pv, const int32_t* pc, int64_t,\n"
                       "    int t, const float* __restrict__, int64_t,\n"
                       "    int64_t, int64_t, float acc) {\n"
                       "  return acc + pv[t] + static_cast<float>(pc[t]);\n}\n"),
    ("spmm", "slots"): ((("spmm_row<false>(", "ablation_row("),),
                       "__device__ __forceinline__ void ablation_row(\n"
                       "    const float* pv, const int32_t* pc, int64_t,\n"
                       "    int lane, const float* __restrict__, int64_t,\n"
                       "    int64_t, int64_t, float4& acc) {\n"
                       "  acc.x += pv[lane & 3] + static_cast<float>("
                       "pc[lane & 3]);\n}\n"),
}


def _no_compute(kind: str, design: str) -> tuple:
    subs, fn = _NO_ROW[kind, design]
    return (*subs, (_NS, _NS + "\n" + fn))


_BARRIER = ("    side.wait();\n    __syncthreads();\n", "    side.wait();\n")


#: R13's choice of its four-gather form: four CTAs an SM fit
_FOUR_CTAS = "(kSmemSm / (smem_bytes + kSmemCtaReserved) >= 4)"


def _bound(old: int, new: int) -> tuple:
    """The kernel bounded to ``new`` CTAs an SM by registers, not ``old``."""
    return (f"__launch_bounds__(kThreads, {old})",
            f"__launch_bounds__(kThreads, {new})")


def variants() -> dict:
    """kernel → variant → (replacements, CTAs an SM or None).  Both
    designs' variants are listed; a source runs those whose lines it has."""
    per = hopper.SMEM_SM_BYTES
    ctas = {f"ctas_{n}": (_pad_smem(per // n - hopper.SMEM_CTA_RESERVED), n)
            for n in (2, 3, 4)}
    return {
        "gather_spmv": {
            "as_is": ((), None),
            "carveout_min": (_carveout("gather_spmv", 0, False), None),
            "carveout_max": (_carveout("gather_spmv", 100, False), None)},
        "ring_gather_spmv": {
            "as_is": ((), None),
            "carveout_min": (_carveout("ring_gather_spmv", 0, True), None),
            "carveout_max": (_carveout("ring_gather_spmv", 100, True), None),
            **ctas,
            "no_compute": (_no_compute("spmv", "slots"), None),
            "no_barrier": ((_BARRIER,), None),
            # R13's gathers a thread in flight forced to four or to eight,
            # whatever the CTAs an SM (the kernel picks by them)
            "four_gathers": (((_FOUR_CTAS, "true"),), None),
            "eight_gathers": (((_FOUR_CTAS, "false"),), 3)},
        "gather_spmm": {"as_is": ((), None),
                        "ctas_3_by_registers": ((_bound(4, 3),), None)},
        "ring_gather_spmm": {
            "as_is": ((), None),
            "carveout_min": (_carveout("ring_gather_spmm", 0, True), None),
            "carveout_max": (_carveout("ring_gather_spmm", 100, True), None),
            "no_compute": (_no_compute("spmm", "slots"), None),
            "no_barrier": ((_BARRIER,), None),
            "ctas_3_by_registers": ((_bound(4, 3),), 3),
            "ctas_4_by_registers": ((_bound(3, 4),), 4),
            # the warp rings' warps held together by a CTA barrier a step
            # (their rows' X segments then gathered at the same time)
            "cta_barrier": (((
                "    __syncwarp();\n    if (u + dv - 1 >= 0",
                "    __syncthreads();\n    if (u + dv - 1 >= 0"),), None)},
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


def run_blocks(call, rname: str, per_sm: int, sms: int) -> int:
    """Output blocks a CTA walks with ``per_sm`` CTAs an SM: the same runs
    for every row group (and column chunk), as many as fit that count."""
    geo = call.kernel.geometry
    blocks = geo.steps // geo.contraction_steps
    groups = -(-geo.ins[1].block[0] // (64 if rname == "ring_gather_spmv"
                                        else 8))
    if rname == "ring_gather_spmm":
        groups *= geo.gathers[0].tiles[0] // 128
    runs = min(blocks, max(1, per_sm * sms // groups))
    return -(-blocks // runs)


def time_ms(fn, samples: int = 9) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depth", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gather_ring_ablation: needs a CUDA device")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    csrc = hopper.CSRC
    OUT.mkdir(parents=True, exist_ok=True)
    # the cells, as chip_smoke.py builds them
    n_v, n_m = SPMV_GRID ** 3, SPMM_GRID ** 3
    hv, hc, hm, hk = sparse.pack_ell(*sparse.hpcg_operator(
        SPMV_GRID, SPMV_GRID, SPMV_GRID, device=dev), n_v)
    sv, sc, sm, sk = sparse.pack_ell(*sparse.hpcg_operator(
        SPMM_GRID, SPMM_GRID, SPMM_GRID, device=dev), n_m)
    x = torch.rand(n_v, generator=gen, device=dev)
    X = torch.randn(n_m, SPMM_RHS, generator=gen, device=dev)
    deep = lowering.Schedule(buffer_depth=args.depth)
    calls = {
        "spmv": lowering.prepare_call(compiler.spmv_nest(hm, hk), sparse.SPMV,
                                      {"vals": hv, "cidx": hc, "x": x},
                                      schedule=deep),
        "spmm": lowering.prepare_call(
            compiler.spmm_nest(sm, SPMM_RHS, sk, SPMM_RHS), sparse.SPMM,
            {"vals": sv, "cidx": sc, "X": X}, schedule=deep)}
    plan = variants()
    srcs = {(n, v): source(csrc, n, subs)
            for n, vs in plan.items() for v, (subs, _) in vs.items()}
    todo = {k: s for k, s in srcs.items() if s is not None}
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        built = dict(zip(todo, pool.map(
            lambda kv: compile_(csrc, *kv[0], kv[1]), todo.items())))
    stream = torch.cuda.current_stream().cuda_stream
    fns, outs, ok = {}, {}, {}
    for (name, variant), b in built.items():
        kind = "spmv" if name.endswith("spmv") else "spmm"
        call = calls[kind]
        ring = call.kernel.ring if name.startswith("ring_") else None
        launched, out, a = launch_args(call, ring)
        assert launched == name, (launched, name)
        per_sm = plan[name][variant][1]
        if variant.startswith("batches_"):
            # R14's gather buffers of another depth: its shared memory, and
            # the CTAs an SM that fit it
            a[-1] += (int(variant[8:]) - 3) * 8 * 4 * 32 * 16
            per_sm = hopper._ctas_per_sm(a[-1], 4)
        if per_sm is not None:
            if name == "ring_gather_spmv" and hopper.SMEM_SM_BYTES // (
                    a[-1] + hopper.SMEM_CTA_RESERVED) < per_sm:
                continue    # the ring alone holds fewer CTAs an SM
            # blocks_per_run: fifth from the end where the arguments hold
            # vec16 between it and the ring (the CTA-barrier ring), else
            # fourth
            vec16 = hopper._SIGNATURES[name][-4] is ctypes.c_int
            a[len(a) - (5 if vec16 else 4)] = run_blocks(call, name, per_sm,
                                                         sms)
        lib = ctypes.CDLL(b["so"])
        fn = getattr(lib, f"ssr_{name}")
        fn.argtypes = hopper._SIGNATURES[name]
        fn.restype = ctypes.c_int

        def call_(fn=fn, a=tuple(a), tag=(name, variant)):
            rc = fn(*a, stream)
            if rc != 0:
                raise SystemExit(f"{tag}: CUDA error {rc}")
        fns[name, variant] = call_
        outs[name, variant] = out
    for name in plan:
        fns[name, "as_is"]()
    torch.cuda.synchronize()
    for ring_, sync in (("ring_gather_spmv", "gather_spmv"),
                        ("ring_gather_spmm", "gather_spmm")):
        ok[ring_] = torch.equal(outs[ring_, "as_is"].view(torch.int32),
                                outs[sync, "as_is"].view(torch.int32))
    keys = list(fns)
    ms = {k: [] for k in keys}
    for k in [*keys, *reversed(keys)]:
        ms[k].append(time_ms(fns[k]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {
        "phase": "gather_ring_ablation", "card": smi,
        "device": torch.cuda.get_device_name(0), "depth": args.depth,
        "as_is_exact": ok,
        "ncu": shutil.which("ncu") or (
            "/usr/local/cuda/bin/ncu"
            if os.path.exists("/usr/local/cuda/bin/ncu") else None),
        "ptxas": {n: {k: v for k, v in built[n, "as_is"].items()
                      if k != "so"} for n in plan},
        "attributes": {n: hopper.kernel_attributes(n) for n in plan}
        if hasattr(hopper, "kernel_attributes") else None,
        "ms": {n: {v: (statistics.mean(ms[n, v]) if (n, v) in ms else None)
                   for v in vs} for n, vs in plan.items()}}
    print(json.dumps(result))
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
