#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py [--seed N]     # about a minute, the build included

The main path is the paper's compile-and-run loop (``ssrify`` →
``lower_plan``/``lower_nest`` → ``ssr_call``) behind ``repro_torch.kernels
.ops`` with ``ssr=True``, and each registry entry's monolithic
``baseline`` beside it; then the fused chains (``ssr_chain_call``) and DAGs
(``ssr_dag_call``) through their registry entries, each beside its
``baseline``, the unfused composition.  The schedule cache is a fresh directory under
``build/`` (``REPRO_SCHEDULE_CACHE``), so no run reads or writes the
user's cache and phases 2–4 run the default schedules.  Phases, each
printing JSON lines:

1. build every Hopper kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all at once) and print the card's name and power limit;
2. drive the main path once, with every launch counter at 0 before it:
   dot and relu (f32, int32 above 2**24, bf16) at n = 2**26, gemm at
   4096**3 and gemv at 8192**2 in f32, plus one direct ``ssr_call``, and
   each kernel's baseline at the same inputs; the fused cells fused and
   unfused: ``gemv_relu`` 8192**2, ``sum_sq_diff`` and ``axpy_dot`` at
   n = 2**26, ``layernorm``, ``softmax_xent`` and ``mlp_block`` at 2**19
   rows of 128; check that every kernel launched, that a fused call is one
   launch and an unfused one one per stage, and that no fallback fired;
3. hold each kernel's output against its plain PyTorch version on the
   card, on the same inputs, and each baseline's against the streamed
   kernel's; each instantiation of K5–K8 (every component of every legal
   cut, on the values the kernels before it produced) and K4's relu drain
   likewise, and each fused result against its unfused one; each limit
   beside a control that must read above it;
4. time each kernel, its plain version and one PyTorch library call with
   CUDA events, beside the least time the card could take, each baseline
   against its streamed kernel (``ssr_over_baseline``), each fused cell
   against its unfused stages (``fused_over_unfused``), and each entry
   point of the main path by the host's clock once warm;
5. tune gemm 4096**3 over the quick candidates into the cache (one
   candidate per distinct kernel; a winner within the race's spread of
   the default is held back), and check that the next ``ops.matmul`` runs
   the committed schedule, correctly;
6. arm one ``compile`` fault and check that ``ops.matmul`` under the tuned
   schedule degrades to the default, quarantines the entry and stays
   right;
5b. search layernorm's graph cuts at full size into the cache (the race
   holds back a cut within its spread of all-fused), then commit the cut
   that fuses nothing and check that the next ``fused_layernorm`` runs the
   three singleton instantiations, correctly;
6b. arm one ``compile`` fault under that cut and check that the call
   degrades to all-fused (one K6 launch), quarantines the entry and stays
   right;
7. print the ``{"kernels": [...]}`` line (K1–K8 and B1–B4), then the
   device line last.

Any failure exits non-zero; without a CUDA device, or without the repo's
``src/repro_torch`` beside this file, it exits non-zero before any result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPS = 10   # timed samples per kernel; the median is reported

# Published peaks of the H100 SXM (80 GB HBM3), dense, at the full 700 W
# power limit (NVIDIA data sheet): memory bytes/s, FP32 FLOP/s outside the
# tensor cores.  Only this card has been run; another needs its own entry.
CARD_PEAKS = {"H100 80GB HBM3": (3.35e12, 67e12)}

# gemm/gemv limit on max |kernel - plain| / (|a|·|b|) per output.  Sound
# f32 kernels read below 5e-7 at k = 4096; a kernel that rounds its inputs
# to TF32 reads about 1e-5 and more, and the run fails unless its TF32
# control lands above the limit.
CONTRACT_LIMIT = 5e-6
# dot limit relative to Σ|x·y| (= x·y: the inputs are uniform in [0, 1)).
DOT_LIMIT = 1e-6

# The DAG kernels' map outputs: max |kernel − plain| / max(1, |plain|).
# rsqrtf, expf and the order of a row's sums differ from PyTorch's by a few
# ulp (≈ 1e-7 of values of order 1); the same plain version on inputs
# rounded to bf16 reads about 1e-3, and the run fails unless it lands above.
MAP_LIMIT = 1e-5

FUSED_ROWS = 1 << 19   # the DAG cells: 2**19 rows of 128 (256 MiB each)

# fused cell → the launches of one fused and one unfused (baseline) call
FUSED_LAUNCHES = {
    "gemv_relu": ({"contract_gemv": 1}, {"contract_gemv": 1, "map_relu": 1}),
    "sum_sq_diff": ({"chain_elem": 1}, {"chain_elem": 2}),
    "axpy_dot": ({"chain_elem": 1}, {"chain_elem": 1, "reduce_mul": 1}),
    "layernorm": ({"dag_layernorm": 1}, {"dag_layernorm": 3}),
    "softmax_xent": ({"dag_softmax_xent": 1}, {"dag_softmax_xent": 3}),
    "mlp_block": ({"dag_mlp": 1}, {"dag_mlp": 3}),
}
# the fused instantiation each K5–K8 row of the kernels line times
FUSED_ROW = {"chain_elem": "sum_sq_diff", "dag_layernorm": "layernorm",
             "dag_softmax_xent": "softmax_xent", "dag_mlp": "mlp_block"}

# streamed kernel → its monolithic baseline
PAIRS = {"reduce_mul": "base_reduce", "map_relu": "base_relu",
         "contract_gemm": "base_gemm", "contract_gemv": "base_gemv"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    raise SystemExit(f"chip_smoke: no published peaks for card {name!r}")


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to TF32's 10-bit mantissa, to nearest even."""
    bits = t.view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def time_ms(fn, warmup: int = 3) -> float:
    """Median CUDA-event time of one ``fn`` call, over ``REPS`` samples.

    Each sample times enough back-to-back calls to last about 2 ms and
    divides by their count, so the host's launch work overlaps the
    device's and a fast kernel is not timed as its launch gap.
    """
    def sample(calls: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    for _ in range(warmup):
        fn()
    calls = max(1, min(100, int(2.0 / max(sample(1), 1e-3))))
    return statistics.median(sample(calls) for _ in range(REPS))


def wall_ms(fn) -> float:
    """Median host wall time of one call that ends in a synchronize: what a
    caller of the entry point waits, host work included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rel_to_abs_prod(got, want, scale) -> float:
    return float(((got.float() - want.float()).abs() / scale).max())


def map_err(got, want) -> float:
    """max |got − want| / max(1, |want|): MAP_LIMIT's measure."""
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def first_block_zeroed(call):
    """The call's layouts with every stream's first block zeroed (uniforms
    kept): what a kernel that dropped one grid step would have read."""
    n = call.kernel.program.n_streams
    out = []
    for k, t in enumerate(call.layouts):
        if k < n:
            t = t.clone()
            rows, cols = call.kernel.geometry.ins[k].block
            t[:rows, :cols] = 0
        out.append(t)
    return tuple(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the inputs, made on the card")
    args = ap.parse_args()

    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    (root / "build").mkdir(exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_schedules_",
                                 dir=root / "build")
    os.environ["REPRO_SCHEDULE_CACHE"] = cache_dir
    # the main path must run its kernels: no opt-in rung may stand in
    os.environ.pop("REPRO_BASELINE_FALLBACK", None)
    try:
        return run(root, args.seed, cache_dir)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def run(root: Path, seed: int, cache_dir: str) -> int:
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch.core import (autotune, compiler, hopper, lowering,
                                  resilience)
    from repro_torch.kernels import (chained, dag, frontend, gemm, gemv, ops,
                                     reduction, registry, relu)

    dev = torch.device("cuda")
    repro_torch.set_default_device(dev)
    resilience.reset()               # no fault armed from the environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "setup", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "schedule_cache": cache_dir,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = hopper.build()
    build_s = time.perf_counter() - t0
    out_dir = root / "chiprun_out"
    if logs and out_dir.is_dir():
        (out_dir / "chip_smoke_nvcc.log").write_text(
            "\n".join(f"== {n}\n{log}" for n, log in logs.items()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit({"phase": "build", "seconds": build_s, "compiled": sorted(logs),
          "kernels": sorted(hopper.KERNELS)})
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    bw, fp32 = card_peaks(kind)

    # -- inputs, made on the card from the seed ---------------------------
    n_vec, (m, n, k), (gm, gn) = 1 << 26, (4096, 4096, 4096), (8192, 8192)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # dot's inputs are non-negative, so Σ|x·y| is the dot itself and a
    # limit relative to it sees a dropped or doubled grid step
    x = torch.rand(n_vec, generator=gen, device=dev)
    y = torch.rand(n_vec, generator=gen, device=dev)
    xi = torch.randint(-(1 << 30), 1 << 30, (n_vec,), generator=gen,
                       device=dev, dtype=torch.int32)
    xr = randn(n_vec)          # relu's input: signed zeros, NaN and infinities
    xr[:5] = torch.tensor([-0.0, 0.0, float("nan"), float("-inf"),
                           float("inf")])
    xb = xr.to(torch.bfloat16)
    a, b = randn(m, k), randn(k, n)
    ga, gx = randn(gm, gn), randn(gn)
    # the fused cells: axpy_dot's w uniform in [0, 1) like x and y (every
    # term non-negative); the DAGs' rows of 128; one-hot targets; weights
    # and biases ~ N(0, 0.1²)
    w = torch.rand(n_vec, generator=gen, device=dev)
    lx, lz, mx = (randn(FUSED_ROWS, 128) for _ in range(3))
    lp = torch.nn.functional.one_hot(
        torch.randint(0, 128, (FUSED_ROWS,), generator=gen, device=dev),
        128).float()
    w1, w2 = randn(128, 128) * 0.1, randn(128, 128) * 0.1
    b1, b2 = randn(128) * 0.1, randn(128) * 0.1
    fused_args = {"gemv_relu": ((ga, gx), {}), "sum_sq_diff": ((x, y), {}),
                  "axpy_dot": ((x, y, w), {"alpha": 0.5}),
                  "layernorm": ((lx,), {}), "softmax_xent": ((lz, lp), {}),
                  "mlp_block": ((mx, w1, b1, w2, b2), {})}
    torch.cuda.synchronize()

    # -- 2. the main path, counters at 0 just before it --------------------
    base = {name: registry.get(name).baseline
            for name in ("reduction", "relu", "gemm", "gemv")}
    path = {
        "dot": lambda: ops.dot(x, y, ssr=True),
        "dot_ssr_call": lambda: lowering.ssr_call(
            compiler.dot_product_nest(n_vec), reduction.MUL,
            {"A": x, "B": y}),
        "relu": lambda: ops.relu(xr, ssr=True),
        "relu_int32": lambda: ops.relu(xi, ssr=True),
        "relu_bf16": lambda: ops.relu(xb, ssr=True),
        "gemm": lambda: ops.matmul(a, b, ssr=True),
        "gemv": lambda: ops.gemv(ga, gx, ssr=True),
        "dot_baseline": lambda: base["reduction"](x, y),
        "relu_baseline": lambda: base["relu"](xr),
        "relu_int32_baseline": lambda: base["relu"](xi),
        "relu_bf16_baseline": lambda: base["relu"](xb),
        "gemm_baseline": lambda: base["gemm"](a, b),
        "gemv_baseline": lambda: base["gemv"](ga, gx),
        # the fused chains and DAGs through their entry points, and each
        # registry entry's baseline: the unfused composition
        "gemv_relu": lambda: ops.gemv_relu(ga, gx, ssr=True),
        "sum_sq_diff": lambda: ops.sum_sq_diff(x, y, ssr=True),
        "axpy_dot": lambda: ops.axpy_dot(x, y, w, alpha=0.5, ssr=True),
        "layernorm": lambda: registry.dispatch("layernorm", lx, ssr=True),
        "softmax_xent": lambda: registry.dispatch("softmax_xent", lz, lp,
                                                  ssr=True),
        "mlp_block": lambda: registry.dispatch("mlp_block", mx, w1, b1, w2,
                                               b2, ssr=True),
        **{f"{cell}_unfused": (lambda c=cell: registry.get(c).baseline(
            *fused_args[c][0], **fused_args[c][1]))
           for cell in FUSED_LAUNCHES},
    }
    lowering.reset_dispatch_stats()
    frontend.reset_dispatch_stats()
    resilience.reset_fallback_log()
    hopper.reset_launches()
    main, wall, per_call = {}, {}, {}
    for key, fn in path.items():   # first calls: plans, lowering, loading
        before = dict(hopper.LAUNCHES)
        t0 = time.perf_counter()
        main[key] = fn()
        torch.cuda.synchronize()
        wall[key] = time.perf_counter() - t0
        per_call[key] = {k_: v - before[k_] for k_, v in hopper.LAUNCHES.items()
                         if v != before[k_]}
    launches = dict(hopper.LAUNCHES)
    ladder = {"fallback_events": len(resilience.fallback_events()),
              "lowering": {c: lowering.DISPATCH_STATS[c]
                           for c in ("fallbacks", "degraded")},
              "frontend": {c: frontend.DISPATCH_STATS[c]
                           for c in ("fallbacks", "degraded")}}
    emit({"phase": "main_path", "seconds": sum(wall.values()),
          "first_call_seconds": wall, "launches": launches, "ladder": ladder,
          "shapes": {k_: list(v.shape) for k_, v in main.items()}})
    idle = [name for name, cnt in launches.items() if cnt == 0]
    if idle:
        raise SystemExit(f"chip_smoke: kernels never launched on the main "
                         f"path: {idle}")
    # a fused call is one launch of its kernel, an unfused one one per stage
    # (the counterpart of the reference's HLO fusion audit)
    counts = {key: per_call[key] for cell in FUSED_LAUNCHES
              for key in (cell, f"{cell}_unfused")}
    emit({"phase": "fusion_launches", "launches": counts})
    wrong = [cell for cell, (f, u) in FUSED_LAUNCHES.items()
             if counts[cell] != f or counts[f"{cell}_unfused"] != u]
    if wrong:
        raise SystemExit(f"chip_smoke: fused or unfused calls launched "
                         f"other kernels than expected: {wrong}: {counts}")
    if resilience.fallback_events() or any(
            v for stats in (ladder["lowering"], ladder["frontend"])
            for v in stats.values()):
        raise SystemExit(f"chip_smoke: a fallback fired on the healthy main "
                         f"path: {ladder}, {resilience.fallback_events()}")

    # -- 3. each kernel against its plain version, on the card ------------
    calls = {
        "reduce_mul": lowering.prepare_call(
            compiler.dot_product_nest(n_vec), reduction.MUL,
            {"A": x, "B": y}),
        "map_relu": lowering.prepare_call(
            compiler.elementwise_nest(n_vec), relu.RELU, {"X": xr},
            mode="map", out_dtype=xr.dtype),
        "contract_gemm": lowering.prepare_call(
            compiler.gemm_nest(m, n, k), gemm.DOT, {"A": a, "B": b}),
        "contract_gemv": lowering.prepare_call(
            compiler.gemv_nest(gm, gn), gemv.MATVEC, {"A": ga, "x": gx}),
    }
    # the baselines' padded layouts, as their MonolithicKernels prepare them
    xp, yp = frontend.pad_vector(x), frontend.pad_vector(y)
    gxp = gx.reshape(1, gn)
    base_layouts = {"base_reduce": (xp, yp),
                    "base_relu": (frontend.pad_vector(xr),),
                    "base_gemm": (a, b), "base_gemv": (ga, gxp)}
    base_plain = {
        "base_reduce": hopper.plain_base_reduce,
        "base_relu": lambda t: hopper.plain_base_map(relu.relu_block, t),
        "base_gemm": hopper.plain_base_gemm,
        "base_gemv": hopper.plain_base_gemv,
    }

    def plain(call):
        kern = call.kernel
        return call.finish(hopper.PLAIN[kern.mode](
            kern.body, kern.geometry, call.layouts, kern.out_dtype,
            kern.acc_dtype))

    checks, errors, failed = {}, {}, []
    # dot: f32 sums of 2**26 products in two orders.  The control is what a
    # kernel that dropped one grid step (one (8, 128) block) would be off
    # by; the limit must lie below it, or the check could not see such a
    # kernel.
    ref = plain(calls["reduce_mul"])
    ref_b = base_plain["base_reduce"](xp, yp)[0, 0]
    scale = float(torch.sum(torch.abs(x * y)))
    step = math.prod(calls["reduce_mul"].kernel.geometry.ins[0].block)
    dropped = float(torch.dot(x[:step], y[:step]))
    if dropped <= DOT_LIMIT * scale:
        failed.append("dot: limit above the dropped-step control")
    for key, kname, want in (("dot", "reduce_mul", ref),
                             ("dot_ssr_call", "reduce_mul", ref),
                             ("dot_baseline", "base_reduce", ref_b)):
        err = abs(float(main[key]) - float(want))
        checks[key] = {"abs_err": err, "rel_err": err / scale,
                       "limit": DOT_LIMIT, "dropped_step_rel": dropped / scale}
        errors[kname] = max(errors.get(kname, 0.0), err)
    err = abs(float(main["dot_baseline"]) - float(main["dot"]))
    checks["dot_baseline_vs_ssr"] = {"abs_err": err, "rel_err": err / scale,
                                     "limit": DOT_LIMIT}
    # relu: the value is selected, never computed — exact to the bit in
    # every dtype, NaN payloads and signed zeros included.
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int32: torch.int32}

    def exact(key, got, want):
        same = bool(torch.equal(got.view(bits[got.dtype]),
                                want.view(bits[want.dtype])))
        diff = (got.float() - want.float()).abs()
        err = float(diff[~diff.isnan()].max())
        checks[key] = {"exact": same, "abs_err": err, "limit": 0.0}
        return err

    for key, inp in (("relu", xr), ("relu_int32", xi), ("relu_bf16", xb)):
        want = plain(lowering.prepare_call(
            compiler.elementwise_nest(n_vec), relu.RELU, {"X": inp},
            mode="map", out_dtype=inp.dtype))
        errors["map_relu"] = max(errors.get("map_relu", 0.0),
                                 exact(key, main[key], want))
        want_b = frontend.trim_vector(
            base_plain["base_relu"](frontend.pad_vector(inp)), n_vec)
        errors["base_relu"] = max(
            errors.get("base_relu", 0.0),
            exact(f"{key}_baseline", main[f"{key}_baseline"], want_b))
        exact(f"{key}_baseline_vs_ssr", main[f"{key}_baseline"], main[key])
    # gemm/gemv: k-long f32 dot products summed in two orders, held to
    # CONTRACT_LIMIT·(|a|·|b|) per output.  The control is the same product
    # from TF32 inputs (cuBLAS with TF32 on for gemm; inputs rounded to TF32
    # for gemv, since cuBLAS's gemv has no TF32 path); it must read above
    # the limit, or the check could not see a TF32 shortcut.
    def tf32_matmul():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.matmul(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    for key, kname, bname, absmat, control in (
            ("gemm", "contract_gemm", "base_gemm",
             lambda: torch.abs(a) @ torch.abs(b), tf32_matmul),
            ("gemv", "contract_gemv", "base_gemv",
             lambda: torch.abs(ga) @ torch.abs(gx),
             lambda: torch.mv(tf32_round(ga), tf32_round(gx)))):
        scale_t = absmat()
        ctrl = control()
        for ckey, cname, got, want in (
                (key, kname, main[key], plain(calls[kname])),
                (f"{key}_baseline", bname, main[f"{key}_baseline"],
                 base_plain[bname](*base_layouts[bname]).reshape(
                     main[f"{key}_baseline"].shape))):
            c = {"abs_err": float((got - want).abs().max()),
                 "rel_to_abs_prod": rel_to_abs_prod(got, want, scale_t),
                 "limit": CONTRACT_LIMIT,
                 "tf32_control": rel_to_abs_prod(ctrl, want, scale_t)}
            checks[ckey] = c
            errors[cname] = c["abs_err"]
            if c["tf32_control"] <= CONTRACT_LIMIT:
                failed.append(f"{ckey}: limit above the TF32 control")
        checks[f"{key}_baseline_vs_ssr"] = {
            "rel_to_abs_prod": rel_to_abs_prod(main[f"{key}_baseline"],
                                               main[key], scale_t),
            "abs_err": float((main[f"{key}_baseline"] - main[key])
                             .abs().max()),
            "limit": CONTRACT_LIMIT}
    # -- 3b. the fused kernels' instantiations against their plain versions
    def inst_check(label, kname, call, kind):
        """One instantiation, run on the card and plain on the same inputs,
        held to the limit of its kind beside a control above it."""
        kern = call.kernel
        got = call.run()
        want = call.finish(kern.plain(call.layouts))
        n_s = kern.program.n_streams
        if kind == "reduce":
            ref_ = abs(float(want))
            ctrl = call.finish(kern.plain(first_block_zeroed(call)))
            err = abs(float(got) - float(want))
            c = {"abs_err": err, "rel_err": err / ref_, "limit": DOT_LIMIT,
                 "dropped_step_rel": abs(float(ctrl) - float(want)) / ref_}
            control = c["dropped_step_rel"]
        elif kind == "map":
            ctrl = call.finish(kern.plain(tuple(
                t.to(torch.bfloat16).float() if k_ < n_s else t
                for k_, t in enumerate(call.layouts))))
            c = {"abs_err": float((got - want).abs().max()),
                 "rel_err": map_err(got, want), "limit": MAP_LIMIT,
                 "bit_exact": bool(torch.equal(got, want)),
                 "bf16_control": map_err(ctrl, want)}
            control = c["bf16_control"]
        else:   # products: error relative to |a|·|b|, TF32 control
            scale_t = call.finish(kern.plain(tuple(
                t.abs() for t in call.layouts))) + 1e-30
            ctrl = call.finish(kern.plain(tuple(
                tf32_round(t) for t in call.layouts)))
            c = {"abs_err": float((got - want).abs().max()),
                 "rel_to_abs_prod": rel_to_abs_prod(got, want, scale_t),
                 "limit": CONTRACT_LIMIT,
                 "tf32_control": rel_to_abs_prod(ctrl, want, scale_t)}
            control = c["tf32_control"]
        c["kernel"] = kname
        checks[label] = c
        errors[kname] = max(errors.get(kname, 0.0), c["abs_err"])
        if control <= c["limit"]:
            failed.append(f"{label}: limit above the control")
        return got

    n_v = n_vec
    ssd_ops, axd_ops = {"X": x, "Y": y}, {"X": x, "Y": y, "W": w}
    fused_calls = {
        "sum_sq_diff": lowering.prepare_chain_call(
            chained._chain_nests(n_v, False),
            (chained.SQ_DIFF, chained.IDENTITY), ssd_ops, mode="reduce"),
        "axpy_dot": lowering.prepare_chain_call(
            chained._chain_nests(n_v, True),
            (chained.axpy_block(0.5), chained.DOT), axd_ops, mode="reduce"),
        "gemv_relu": lowering.prepare_call(
            compiler.gemv_nest(gm, gn), chained.MATVEC_RELU,
            {"A": ga, "x": gx}),
    }
    for cell in ("sum_sq_diff", "axpy_dot"):
        inst_check(f"{cell}_fused", "chain_elem", fused_calls[cell],
                   "reduce")
    pair2 = compiler.elementwise_nest(n_v, ("X", "Y"), 2)
    sq_call = lowering.prepare_call(pair2, chained.SQ_DIFF, ssd_ops,
                                    mode="map")
    ax_call = lowering.prepare_call(pair2, chained.axpy_block(0.5), ssd_ops,
                                    mode="map")
    t_sq = inst_check("sq_diff_map", "chain_elem", sq_call, "map")
    t_ax = inst_check("axpy_map", "chain_elem", ax_call, "map")
    id_call = lowering.prepare_call(
        compiler.elementwise_nest(n_v, ("T",), 1), chained.IDENTITY,
        {"T": t_sq})
    inst_check("identity_reduce", "chain_elem", id_call, "reduce")
    dot_call = lowering.prepare_call(
        compiler.elementwise_nest(n_v, ("T", "W"), 1), chained.DOT,
        {"T": t_ax, "W": w})
    relu_call = lowering.prepare_call(
        compiler.elementwise_nest(gm), relu.RELU, {"X": main["gemv"]},
        mode="map", out_dtype=torch.float32)
    unfused_calls = {"sum_sq_diff": [sq_call, id_call],
                     "axpy_dot": [ax_call, dot_call],
                     "gemv_relu": [calls["contract_gemv"], relu_call]}
    # K4's relu drain: the gemv limit and TF32 control, and bit for bit the
    # selection of K4's own drain
    gscale = torch.abs(ga) @ torch.abs(gx)
    gr_call = fused_calls["gemv_relu"]
    want = gr_call.finish(gr_call.kernel.plain(gr_call.layouts))
    c = {"abs_err": float((main["gemv_relu"] - want).abs().max()),
         "rel_to_abs_prod": rel_to_abs_prod(main["gemv_relu"], want, gscale),
         "limit": CONTRACT_LIMIT, "kernel": "contract_gemv",
         "tf32_control": rel_to_abs_prod(relu.relu_block(torch.mv(
             tf32_round(ga), tf32_round(gx))), want, gscale)}
    checks["gemv_relu"] = c
    if c["tf32_control"] <= CONTRACT_LIMIT:
        failed.append("gemv_relu: limit above the TF32 control")
    checks["gemv_relu_vs_selection"] = {
        "exact": bool(torch.equal(
            main["gemv_relu"].view(torch.int32),
            relu.relu_block(main["gemv"]).view(torch.int32))),
        "abs_err": 0.0, "limit": 0.0}
    # the DAGs: every component of every legal cut, each on the values the
    # kernels before it produced
    cases = {cs.name: cs for cs in dag.dag_cases()}
    dag_kernel = {"layernorm": "dag_layernorm",
                  "softmax_xent": "dag_softmax_xent", "mlp_block": "dag_mlp"}
    stage_calls = {}
    for cell, kname in dag_kernel.items():
        nests, bodies, operands, mode, uniforms = cases[cell].spec(
            *fused_args[cell][0])
        graph = lowering._dag_for(nests, None)
        stage_calls[cell], finals = {}, {}
        for cut in autotune.enumerate_cuts(graph):
            if not autotune.dag_cut_is_legal(
                    graph, cut, nests=nests, bodies=bodies, mode=mode,
                    uniforms=uniforms, device=dev)[0]:
                continue
            env = dict(operands)
            for comp in lowering.dag_components(graph, nests, bodies, cut,
                                                mode=mode):
                if len(comp.stages) == 1:
                    call = lowering.prepare_call(
                        comp.nests[0], comp.bodies[0], env, mode=comp.mode,
                        schedule=lowering.DEFAULT_SCHEDULE,
                        uniforms=uniforms)
                else:
                    call = lowering.prepare_dag_call(
                        comp.nests, comp.bodies, env, mode=comp.mode,
                        uniforms=uniforms)
                how = "products" if cell == "mlp_block" else comp.mode
                if comp.stages in stage_calls[cell]:
                    out = call.run()
                else:
                    stage_calls[cell][comp.stages] = call
                    out = inst_check(
                        f"{cell}_{''.join(map(str, comp.stages))}", kname,
                        call, how)
                if comp.exported is not None:
                    env[comp.exported] = out
            finals[cut] = out
        checks[f"{cell}_cuts"] = {
            "cuts": [list(cut) for cut in finals], "abs_err": 0.0,
            "limit": 0.0, "exact": set(stage_calls[cell]) ==
            {(0, 1, 2), (0,), (1,), (2,), (1, 2)}}
        fused_calls[cell] = stage_calls[cell][(0, 1, 2)]
        for cut, out in finals.items():     # each cut against all-fused
            base_out = finals[()]
            c = {"abs_err": float((out - base_out).abs().max())}
            if cell == "softmax_xent":
                c.update(rel_err=c["abs_err"] / abs(float(base_out)),
                         limit=DOT_LIMIT)
            elif cell == "layernorm":
                c.update(rel_err=map_err(out, base_out), limit=MAP_LIMIT)
            else:
                fc = fused_calls[cell]
                c.update(rel_to_abs_prod=rel_to_abs_prod(
                    out, base_out, fc.finish(fc.kernel.plain(tuple(
                        t.abs() for t in fc.layouts))) + 1e-30),
                    limit=CONTRACT_LIMIT)
            checks[f"{cell}_cut_{''.join(map(str, cut)) or 'none'}"] = c
        unfused_calls[cell] = [stage_calls[cell][(k_,)] for k_ in range(3)]
    # fused against unfused, within the same limits
    for cell in FUSED_LAUNCHES:
        f_, u_ = main[cell], main[f"{cell}_unfused"]
        if cell in ("sum_sq_diff", "axpy_dot", "softmax_xent"):
            err = abs(float(f_) - float(u_))
            c = {"abs_err": err, "rel_err": err / abs(float(f_)),
                 "limit": DOT_LIMIT}
        elif cell == "layernorm":
            c = {"abs_err": float((f_ - u_).abs().max()),
                 "rel_err": map_err(u_, f_), "limit": MAP_LIMIT}
        else:
            fc = fused_calls[cell]
            sc_ = gscale if cell == "gemv_relu" else fc.finish(
                fc.kernel.plain(tuple(t.abs() for t in fc.layouts))
            ).reshape(f_.shape) + 1e-30
            c = {"abs_err": float((f_ - u_).abs().max()),
                 "rel_to_abs_prod": rel_to_abs_prod(u_, f_, sc_),
                 "limit": CONTRACT_LIMIT}
        checks[f"{cell}_fused_vs_unfused"] = c
        for key in (cell, f"{cell}_unfused"):
            if not bool(torch.isfinite(main[key]).all()):
                failed.append(f"{key}: non-finite")
    for key, c in checks.items():
        ok = (c.get("exact", True) and
              c.get("rel_to_abs_prod", c.get("rel_err", c["abs_err"]))
              <= c["limit"])
        c["ok"] = ok
        if not ok:
            failed.append(key)
    for key in ("dot", "dot_ssr_call", "gemm", "gemv", "dot_baseline",
                "gemm_baseline", "gemv_baseline"):
        if not bool(torch.isfinite(main[key]).all()):
            failed.append(f"{key}: non-finite")
    # the repo's own oracle on small odd inputs, within the registry tol
    rng = np.random.default_rng(seed)
    for entry in registry.entries():
        ex_args, ex_kw = entry.example(rng, odd=True)
        want = entry.ref(*[t.to(dev) for t in ex_args], **ex_kw)
        for variant in ("ssr", "baseline"):
            got = getattr(entry, variant)(*ex_args, device=dev, **ex_kw)
            ok = bool(torch.allclose(got, want, **entry.tol))
            checks[f"registry_{entry.name}_{variant}"] = {"ok": ok}
            if not ok:
                failed.append(f"registry_{entry.name}_{variant}")
    torch.cuda.synchronize()
    emit({"phase": "check", "checks": checks})
    if failed:
        raise SystemExit(f"chip_smoke: checks failed: {failed}")

    # -- 4. timing ----------------------------------------------------------
    def kernel_fn(call):
        kern = call.kernel
        dk = kern.device_kernel()
        return lambda: dk(kern.geometry, call.layouts, kern.out_dtype,
                          kern.acc_dtype, program=kern.program)

    work = {   # (bytes each input read once + output written once, FLOPs)
        "reduce_mul": (2 * n_vec * 4 + 4, 2 * n_vec),
        "map_relu": (2 * n_vec * 4, n_vec),
        "contract_gemm": ((m * k + k * n + m * n) * 4, 2 * m * n * k),
        "contract_gemv": ((gm * gn + gn + gm) * 4, 2 * gm * gn),
    }
    library = {
        "reduce_mul": lambda: torch.dot(x, y),
        "map_relu": lambda: torch.relu(xr),
        "contract_gemm": lambda: torch.matmul(a, b),
        "contract_gemv": lambda: torch.mv(ga, gx),
    }
    timed = {name: (kernel_fn(call), lambda c=call: plain(c))
             for name, call in calls.items()}
    for kname, bname in PAIRS.items():   # a baseline does the K row's work
        work[bname], library[bname] = work[kname], library[kname]
        wrapper, layouts = getattr(hopper, bname), base_layouts[bname]
        timed[bname] = (lambda w=wrapper, t=layouts: w(*t),
                        lambda p=base_plain[bname], t=layouts: p(*t))
    rows = []
    for name, (kernel, plain_fn) in timed.items():
        nbytes, flops = work[name]
        t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32 * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": hopper.KERNELS[name]["source"],
            "replaces": hopper.KERNELS[name]["replaces"],
            "launches": launches[name],
            "max_abs_err": errors[name],
            "ms": time_ms(kernel),
            "plain_ms": time_ms(plain_fn),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(library[name]),
        })
        emit({"phase": "time", **rows[-1]})
    # the fused cells: the fused instantiation against the unfused stages'
    # kernels run one after another, each timed alone; bytes each input
    # read once and each output written once (unfused: every intermediate
    # written and read back), FP32 operations for the MLP's products
    nf = FUSED_ROWS * 128
    mlp_ops = 4 * FUSED_ROWS * 128 * 128 + 3 * nf
    weights = 2 * (128 * 128 + 128) * 4
    cell_work = {   # cell: (fused bytes, unfused bytes, operations)
        "gemv_relu": ((gm * gn + gn + gm) * 4, (gm * gn + gn + 3 * gm) * 4,
                      2 * gm * gn),
        "sum_sq_diff": (2 * n_vec * 4 + 4, 4 * n_vec * 4 + 4, 3 * n_vec),
        "axpy_dot": (3 * n_vec * 4 + 4, 5 * n_vec * 4 + 4, 4 * n_vec),
        "layernorm": (2 * nf * 4, 7 * nf * 4, 6 * nf),
        "softmax_xent": (2 * nf * 4 + 4, 7 * nf * 4 + 4, 7 * nf),
        "mlp_block": (2 * nf * 4 + weights, 7 * nf * 4 + 3 * weights,
                      mlp_ops),
    }
    # one PyTorch call computing the same function, where there is one;
    # else the composition of library calls, labelled as such
    library_one = {
        "sum_sq_diff": lambda: F.mse_loss(x, y, reduction="sum"),
        "layernorm": lambda: F.layer_norm(lx, (128,)),
        "softmax_xent": lambda: F.cross_entropy(lz, lp, reduction="sum"),
    }
    library_composed = {
        "gemv_relu": lambda: torch.relu(torch.mv(ga, gx)),
        "axpy_dot": lambda: torch.dot(torch.add(y, x, alpha=0.5), w),
        "mlp_block": lambda: (lambda h: torch.addmm(b2, h, w2) + h)(
            torch.relu(torch.addmm(b1, mx, w1))),
    }
    cells = {}
    for cell, (fb, ub, flops) in cell_work.items():
        fused_t = time_ms(kernel_fn(fused_calls[cell]))
        stages_t = [time_ms(kernel_fn(c_)) for c_ in unfused_calls[cell]]
        unfused_t = sum(stages_t)
        t_ops = flops / fp32 * 1e3
        cells[cell] = {
            "fused_ms": fused_t, "unfused_ms": unfused_t,
            "unfused_stage_ms": stages_t,
            "fused_over_unfused": unfused_t / fused_t,
            "fused_bound_ms": max(fb / bw * 1e3, t_ops),
            "unfused_bound_ms": max(ub / bw * 1e3, t_ops),
            "bound_by": "bytes" if fb / bw * 1e3 >= t_ops else "operations",
            "entry_fused_ms": time_ms(path[cell]),
            "entry_unfused_ms": time_ms(path[f"{cell}_unfused"]),
            "library_ms": (time_ms(library_one[cell])
                           if cell in library_one else None),
            "library_composed_ms": (time_ms(library_composed[cell])
                                    if cell in library_composed else None),
        }
        emit({"phase": "fused_time", "cell": cell, **cells[cell]})
    for kname, cell in FUSED_ROW.items():
        fb, _, flops = cell_work[cell]
        t_bytes, t_ops = fb / bw * 1e3, flops / fp32 * 1e3
        call = fused_calls[cell]
        rows.append({
            "name": kname, "route": "cuda",
            "source": hopper.KERNELS[kname]["source"],
            "replaces": hopper.KERNELS[kname]["replaces"],
            "launches": launches[kname],
            "max_abs_err": errors[kname],
            "ms": cells[cell]["fused_ms"],
            "plain_ms": time_ms(lambda c_=call: c_.kernel.plain(c_.layouts)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cells[cell]["library_ms"],
        })
        emit({"phase": "time", "cell": cell, **rows[-1]})
    ms = {r["name"]: r["ms"] for r in rows}
    emit({"phase": "ssr_vs_baseline", "ssr_over_baseline": {
        kname: ms[bname] / ms[kname] for kname, bname in PAIRS.items()}})
    emit({"phase": "fused_vs_unfused", "fused_over_unfused": {
        cell: c_["fused_over_unfused"] for cell, c_ in cells.items()}})
    # the main path's entry points once warm, host work included; beside
    # them a direct ssr_call with its schedule pinned, and the schedule
    # cache probe that an unpinned ssr_call makes once per problem and epoch
    dot_nest, dot_ops = compiler.dot_product_nest(n_vec), {"A": x, "B": y}
    probes = {
        "dot_ssr_call_pinned": lambda: lowering.ssr_call(
            dot_nest, reduction.MUL, dot_ops,
            schedule=lowering.DEFAULT_SCHEDULE),
        "dot_ssr_call_unpinned": lambda: lowering.ssr_call(
            dot_nest, reduction.MUL, dot_ops),
        "schedule_lookup": lambda: autotune.lookup(dot_nest, dot_ops,
                                                   device=dev),
    }
    emit({"phase": "entry_points",
          "wall_ms": {key: wall_ms(fn)
                      for key, fn in {**path, **probes}.items()}})

    # -- 5. the tuner on the card --------------------------------------------
    nest, operands = compiler.gemm_nest(m, n, k), {"A": a, "B": b}
    cands = autotune.candidate_schedules(nest, quick=True, operands=operands,
                                         body=gemm.DOT, device=dev)
    # ten samples per survivor, so the spread that a winner must beat is
    # the race's own (the default of three samples sees little of it)
    res = autotune.autotune(nest, gemm.DOT, operands, candidates=cands,
                            iters=10)
    if not res.committed or res.degraded:
        raise SystemExit(f"chip_smoke: the tuner did not commit: {res}")
    emit({"phase": "tune", "candidates": [s.to_json() for s in cands],
          "measured": res.measured, "default_us": res.default_us,
          "tuned_us": res.tuned_us, "winner": res.schedule.to_json(),
          "winner_is_default": res.is_default, "held_back": res.held_back,
          "timings_us": [[s.to_json(), us] for s, us in res.timings]})
    before = hopper.LAUNCHES["contract_gemm"]
    tuned_out = ops.matmul(a, b, ssr=True)
    torch.cuda.synchronize()
    resolved = gemm._ssr.schedule_for(a, b)
    want = plain(lowering.prepare_call(nest, gemm.DOT, operands,
                                       schedule=res.schedule))
    scale_t = torch.abs(a) @ torch.abs(b)
    tuned_err = rel_to_abs_prod(tuned_out, want, scale_t)
    emit({"phase": "tuned_dispatch", "resolved": resolved.to_json(),
          "launched": hopper.LAUNCHES["contract_gemm"] - before,
          "rel_to_abs_prod": tuned_err, "limit": CONTRACT_LIMIT})
    if resolved != res.schedule or tuned_err > CONTRACT_LIMIT or \
            hopper.LAUNCHES["contract_gemm"] == before:
        raise SystemExit("chip_smoke: ops.matmul did not run the committed "
                         "winner correctly")

    # -- 6. the degradation ladder on the card --------------------------------
    tuned, note = res.schedule, "the committed winner, committed again"
    if res.is_default:
        others = [(us, i, s) for i, (s, us) in enumerate(res.timings)
                  if s != lowering.DEFAULT_SCHEDULE]
        if not others:
            raise SystemExit("chip_smoke: no non-default survivor to tune")
        tuned = min(others)[2]
        note = "the winner is the default: the fastest non-default survivor"
    cache = autotune.global_cache()
    # a commit bumps the epoch, so the gemm NestKernel builds its entry anew
    # and the armed fault fires there
    cache.put(res.key, tuned, meta={"note": note})
    lowering.reset_dispatch_stats()
    frontend.reset_dispatch_stats()
    resilience.reset_fallback_log()
    with resilience.inject_faults("compile") as specs:
        degraded_out = ops.matmul(a, b, ssr=True)
    torch.cuda.synchronize()
    events = resilience.fallback_events()
    want = plain(calls["contract_gemm"])
    ladder_err = rel_to_abs_prod(degraded_out, want, scale_t)
    corrupt = os.path.exists(os.path.join(cache.path,
                                          f"{res.key}.json.corrupt"))
    emit({"phase": "ladder", "tuned": tuned.to_json(), "note": note,
          "fired": specs[0].fired,
          "degraded": frontend.DISPATCH_STATS["degraded"],
          "events": [[e.seam, e.site, e.from_schedule, e.to_schedule]
                     for e in events],
          "quarantined": corrupt,
          "now_resolves": gemm._ssr.schedule_for(a, b).to_json(),
          "rel_to_abs_prod": ladder_err, "limit": CONTRACT_LIMIT})
    if not (specs[0].fired == 1 and frontend.DISPATCH_STATS["degraded"] == 1
            and [e.site for e in events] == ["nest_kernel:gemm"]
            and corrupt and cache.get(res.key) is None
            and gemm._ssr.schedule_for(a, b) == lowering.DEFAULT_SCHEDULE
            and ladder_err <= CONTRACT_LIMIT):
        raise SystemExit("chip_smoke: the compile fault did not degrade "
                         "to the default schedule correctly")

    # -- 5b. the DAG cut search on the card -----------------------------------
    ln_case = cases["layernorm"]
    nests, bodies, operands, mode, _ = ln_case.spec(lx)
    graph = lowering._dag_for(nests, None)
    legal = [cut for cut in autotune.enumerate_cuts(graph)
             if autotune.dag_cut_is_legal(graph, cut, nests=nests,
                                          bodies=bodies, mode=mode,
                                          device=dev)[0]]
    dres = autotune.autotune_dag(nests, bodies, operands, mode=mode,
                                 iters=10, force=True)
    if not dres.committed or dres.degraded:
        raise SystemExit(f"chip_smoke: the DAG tuner did not commit: {dres}")
    emit({"phase": "tune_dag", "cell": "layernorm",
          "legal_cuts": [list(c_) for c_ in legal],
          "survivors": [[list(s_.cut_edges), us] for s_, us in dres.timings],
          "winner": list(dres.schedule.cut_edges),
          "fused_us": dres.default_us, "winner_us": dres.tuned_us,
          "held_back": dres.held_back})
    # commit the cut that fuses nothing: the next fused_layernorm with no
    # schedule runs the three singleton instantiations
    full_cut = lowering.Schedule(cut_edges=tuple(range(len(graph.edges))))
    cache = autotune.global_cache()
    cache.put(dres.key, full_cut, meta={"note": "every edge cut"})
    fused_ln = fused_calls["layernorm"]
    ln_want = fused_ln.finish(fused_ln.kernel.plain(fused_ln.layouts)
                              ).reshape(lx.shape)
    before = dict(hopper.LAUNCHES)
    cut_out = dag.fused_layernorm(lx)
    torch.cuda.synchronize()
    cut_launches = {k_: v - before[k_] for k_, v in hopper.LAUNCHES.items()
                    if v != before[k_]}
    cut_err = map_err(cut_out, ln_want)
    emit({"phase": "committed_cut", "cut": list(full_cut.cut_edges),
          "launches": cut_launches, "rel_err": cut_err, "limit": MAP_LIMIT})
    if cut_launches != {"dag_layernorm": 3} or cut_err > MAP_LIMIT:
        raise SystemExit("chip_smoke: the committed cut did not run the "
                         "singleton instantiations correctly")

    # -- 6b. a compile fault under the committed cut --------------------------
    lowering.clear_caches()          # the components' kernels build anew
    lowering.reset_dispatch_stats()
    resilience.reset_fallback_log()
    before = dict(hopper.LAUNCHES)
    with resilience.inject_faults("compile") as specs:
        degraded_ln = dag.fused_layernorm(lx)
    torch.cuda.synchronize()
    deg_launches = {k_: v - before[k_] for k_, v in hopper.LAUNCHES.items()
                    if v != before[k_]}
    events = resilience.fallback_events()
    deg_err = map_err(degraded_ln, ln_want)
    corrupt = os.path.exists(os.path.join(cache.path,
                                          f"{dres.key}.json.corrupt"))
    emit({"phase": "dag_ladder", "fired": specs[0].fired,
          "degraded": lowering.DISPATCH_STATS["degraded"],
          "launches": deg_launches,
          "events": [[e.seam, e.site, e.from_schedule, e.to_schedule]
                     for e in events],
          "quarantined": corrupt, "rel_err": deg_err, "limit": MAP_LIMIT})
    if not (specs[0].fired == 1 and lowering.DISPATCH_STATS["degraded"] == 1
            and deg_launches == {"dag_layernorm": 1}
            and [e.site for e in events] == ["ssr_dag_call"]
            and corrupt and cache.get(dres.key) is None
            and deg_err <= MAP_LIMIT):
        raise SystemExit("chip_smoke: the compile fault under the committed "
                         "cut did not degrade to all-fused correctly")

    # -- 7. result ----------------------------------------------------------
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
