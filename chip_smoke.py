#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py [--seed N]     # about half a minute, the build included

The main path is the paper's compile-and-run loop (``ssrify`` →
``lower_plan``/``lower_nest`` → ``ssr_call``) behind ``repro_torch.kernels
.ops`` with ``ssr=True``, and each registry entry's monolithic
``baseline`` beside it.  The schedule cache is a fresh directory under
``build/`` (``REPRO_SCHEDULE_CACHE``), so no run reads or writes the
user's cache and phases 2–4 run the default schedules.  Phases, each
printing JSON lines:

1. build every Hopper kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all at once) and print the card's name and power limit;
2. drive the main path once, with every launch counter at 0 before it:
   dot and relu (f32, int32 above 2**24, bf16) at n = 2**26, gemm at
   4096**3 and gemv at 8192**2 in f32, plus one direct ``ssr_call``, and
   each kernel's baseline at the same inputs; check that every kernel
   launched and that no fallback fired;
3. hold each kernel's output against its plain PyTorch version on the
   card, on the same inputs, and each baseline's against the streamed
   kernel's, each limit beside a control that must read above it;
4. time each kernel, its plain version and one PyTorch library call with
   CUDA events, beside the least time the card could take, each baseline
   against its streamed kernel (``ssr_over_baseline``), and each entry
   point of the main path by the host's clock once warm;
5. tune gemm 4096**3 over the quick candidates into the cache (one
   candidate per distinct kernel; a winner within the race's spread of
   the default is held back), and check that the next ``ops.matmul`` runs
   the committed schedule, correctly;
6. arm one ``compile`` fault and check that ``ops.matmul`` under the tuned
   schedule degrades to the default, quarantines the entry and stays
   right;
7. print the ``{"kernels": [...]}`` line, then the device line last.

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
    from repro_torch.kernels import (frontend, gemm, gemv, ops, reduction,
                                     registry, relu)

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
    }
    lowering.reset_dispatch_stats()
    frontend.reset_dispatch_stats()
    resilience.reset_fallback_log()
    hopper.reset_launches()
    main, wall = {}, {}
    for key, fn in path.items():   # first calls: plans, lowering, loading
        t0 = time.perf_counter()
        main[key] = fn()
        torch.cuda.synchronize()
        wall[key] = time.perf_counter() - t0
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
                          kern.acc_dtype)

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
    ms = {r["name"]: r["ms"] for r in rows}
    emit({"phase": "ssr_vs_baseline", "ssr_over_baseline": {
        kname: ms[bname] / ms[kname] for kname, bname in PAIRS.items()}})
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

    # -- 7. result ----------------------------------------------------------
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
