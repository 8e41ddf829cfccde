#!/usr/bin/env python3
"""K14 ``stream_scan`` and K11 ``rescale_attention`` beside their parent
design, the ring kernels that share their arithmetic, and one PyTorch call
for each function, in one process a tree.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 tools/scan_attention_ablation.py [--seed 0] [--parts scan attention] [--out FILE]
    python3 tools/scan_attention_ablation.py --trees PARENT CHANGE [--out FILE]

With ``--trees`` the script measures each tree (a checkout, e.g. unpacked
by ``git archive``) in a process of its own, in the order parent, change,
change, parent, and reports each side as the mean of its two runs; without
it, the tree it sits in.  Each tree builds its own kernels under its own
``build/``.  ``--parts`` picks the scan, attention or both (the default).

The cells are chip_smoke.py's: ``scan_2p26`` (x ~ N(0, 1), n = 2**26, in
f32 and rounded to bf16) and the four attention cells (causal, in f32 and
rounded to bf16): ``attention_qwen3`` (40 heads, 4096**2, D = 128),
``attention_danube`` (32 heads, 8192**2, D = 80, window 4096),
``attention_d192`` and ``attention_d256`` (8 heads, 2048**2).

* The scan: K14 through its wrapper and its C entry (``entry``), R15
  ``ring_stream_scan`` at depth 4, B8 ``base_scan`` and ``torch.cumsum``;
  each wrapper split into its device kernels and memsets by a
  ``torch.profiler`` trace (``split``: ms a call by name).  ``no_wait``:
  K14's source with the look-back's wait taken out (each word of a tile's
  offset read once, never waited for: wrong sums, the time of the pass
  without its waits), through its C entry, null where K14 has no
  look-back.  ``exact``: K14 twice to the bit, R15 to K14's bits, and K14
  (f32) to ``hopper.scan_model``'s bits.
* Attention: K11 on the main path's layouts (the kernel call of a prepared
  call, as chip_smoke.py times it) in f32 and bf16, R12
  ``ring_rescale_attention`` at depth 4 on the same layouts (timed on
  attention_qwen3 and attention_d256 in f32, through its wrapper and its C
  entry, and held to K11's bits on every cell in both dtypes) and ``scaled_dot_product_attention`` in f32
  (danube with a boolean mask of the visible pairs).
* K11's source variants (its source, or the header it includes, with some
  lines replaced, compiled into the tree's
  ``build/scan_attention_ablation/``), launched through its C entry with
  the arguments the wrapper passes, on every attention cell in f32:
  ``as_is``; ``score_unroll2`` and ``score_unroll4`` (the 128-lane tile's
  score loop unrolled twice or four times, against eight);
  ``one_buffer`` (the 128-lane tile with one K and one V buffer, against
  two, each copied a sub-tile earlier);
  ``wide_unroll1`` and ``wide_unroll4`` (the wide tile's, against twice);
  ``pv_unroll4`` (the 128-lane tile's p v loop, against eight) and
  ``wide_pv_unroll8`` (the wide tile's, against four); ``contiguous_v``
  (the 128-lane tile's 8 acc lanes a thread consecutive, against two runs
  of 4); ``always_masked`` (the 128-lane tile's rescale masks every
  sub-tile, against only those some row does not see whole); and three
  that compute wrong values on purpose,
  to split a tile's time: ``no_pv`` (no p v products), ``no_scores`` (no
  score FMAs: every raw score 0) and ``fast_exp`` (the rescale's ``expf``
  as ``__expf``).  Null where the lines are not in the tree's source; each
  but the last three held to ``as_is``'s bits.
* ``host_ms``: the host time of one K11 call and of one R12 call (f32,
  issued back to back once warm): the wrapper's own work, with its launch.
* ``digest``: a checksum of each output's bits, so that two trees' outputs
  compare to the bit.
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
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SCAN_N = 1 << 26
#: cell → (heads, sequence, head dim, causal, window), as chip_smoke.py's
ATTENTION_CELLS = {"attention_qwen3": (40, 4096, 128, True, None),
                   "attention_danube": (32, 8192, 80, True, 4096),
                   "attention_d192": (8, 2048, 192, True, None),
                   "attention_d256": (8, 2048, 256, True, None)}
#: K14's look-back wait, taken out for the no_wait control
WAIT_LINE = ("ssr_scan.cuh",
             "  while (!(word >> 32)) word = load_word(w);\n")
#: the attention cells whose R12 at depth 4 is timed (the main path's)
R12_TIMED = ("attention_qwen3", "attention_d256")
_SCORE_LOOP = ("#pragma unroll 8\n  for (int d = 0; d < DL; d += 4) {\n"
               "    float4 kv[kSC];")
_WIDE_LOOP = "#pragma unroll 2\n  for (int d = 0; d < NL; d += 4) {"
_PV = "  constexpr int kPvUnroll = 8;"
_WIDE_PV = "    accumulate_pv<L, kBK>(acc, pt, vs, DL, tr, tc);\n"
_SPLIT = "  constexpr int kSplit = kNA == 8 ? DL / 2 : 0;"
_FULL = "    if (unmasked(kv0, kvalid, row_min, row_max, mk))\n"
#: K11 variant → (file, old, new) replacements
K11_VARIANTS = {
    "as_is": (),
    "score_unroll2": (("ssr_attention.cuh", _SCORE_LOOP,
                       _SCORE_LOOP.replace("unroll 8", "unroll 2")),),
    "score_unroll4": (("ssr_attention.cuh", _SCORE_LOOP,
                       _SCORE_LOOP.replace("unroll 8", "unroll 4")),),
    "wide_unroll1": (("ssr_attention.cuh", _WIDE_LOOP,
                      _WIDE_LOOP.replace("unroll 2", "unroll 1")),),
    "wide_unroll4": (("ssr_attention.cuh", _WIDE_LOOP,
                      _WIDE_LOOP.replace("unroll 2", "unroll 4")),),
    "pv_unroll4": (("ssr_attention.cuh", _PV,
                    _PV.replace("= 8", "= 4")),),
    "wide_pv_unroll8": (("rescale_attention.cu", _WIDE_PV,
                         _WIDE_PV.replace("<L, kBK>", "<L, kBK, 0, 8>")),
                        # (a tree whose p v loop takes its unroll)
                        ("ssr_attention.cuh", "#pragma unroll (kUnroll)",
                         "#pragma unroll (kUnroll)")),
    "one_buffer": (("rescale_attention.cu",
                    "  static constexpr int kBuffers = 2;",
                    "  static constexpr int kBuffers = 1;"),),
    "contiguous_v": (("ssr_attention.cuh", _SPLIT,
                      "  constexpr int kSplit = 0;"),),
    "always_masked": (("ssr_attention.cuh", _FULL,
                       "    if (false)\n"),),
    "no_pv": (("ssr_attention.cuh",
               "    accumulate_pv<L, kBK, kSplit, kPvUnroll>(acc, pt, vbuf + vget * "
               "kBK * VP, VP, tr, tc);\n", ""),
              ("rescale_attention.cu", _WIDE_PV, "")),
    "no_scores": (("ssr_attention.cuh", _SCORE_LOOP,
                   _SCORE_LOOP.replace("d < DL", "d < 0")),
                  ("ssr_attention.cuh", _WIDE_LOOP,
                   _WIDE_LOOP.replace("d < NL", "d < 0"))),
    "fast_exp": (("ssr_attention.cuh",
                  "    const float alpha = expf(m[i] - m_new);",
                  "    const float alpha = __expf(m[i] - m_new);"),
                 ("ssr_attention.cuh",
                  "      s[i][k] = expf(s[i][k] - m_new);",
                  "      s[i][k] = __expf(s[i][k] - m_new);")),
}
#: K11's variants that compute wrong values on purpose
K11_INEXACT = ("no_pv", "no_scores", "fast_exp")


def build_variant(csrc: Path, out: Path, kernel: str, subs) -> dict | None:
    """``kernel`` built with the replacements ``subs`` (its changed files
    beside a copy of its source, which includes them before the
    originals); its library and nvcc's counts, or None where a replaced
    line is not in the source."""
    files = {}
    for name, old, new in subs:
        text = files.get(name, (csrc / name).read_text())
        if old not in text:
            return None
        files[name] = text.replace(old, new, 1)
    cu = f"{kernel}.cu"
    files.setdefault(cu, (csrc / cu).read_text())
    so = out / f"{kernel}.so"
    log = out / "nvcc.log"
    if so.is_file() and log.is_file() and all(
            (out / n).is_file() and (out / n).read_text() == t
            for n, t in files.items()) and len(list(out.glob("*.cu*"))) \
            == len(files):       # built from these sources in an earlier run
        return {"so": str(so), **ptxas_counts(log.read_text())}
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for name, text in files.items():
        (out / name).write_text(text)
    from repro_torch.core import hopper
    proc = subprocess.run([hopper._nvcc(), *hopper.NVCC_FLAGS, "-I",
                           str(csrc), "-o", str(so), str(out / cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {out.name}:\n{proc.stderr}")
    log.write_text(proc.stderr + proc.stdout)
    return {"so": str(so), **ptxas_counts(proc.stderr + proc.stdout)}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def ptxas_counts(log: str) -> dict:
    def nums(pattern):
        return [int(v) for v in re.findall(pattern, log)]
    return {"registers": nums(r"Used (\d+) registers"),
            "spill_store_bytes": nums(r"(\d+) bytes spill stores"),
            "spill_load_bytes": nums(r"(\d+) bytes spill loads")}


def measure_tree(root: Path, seed: int, parts=("scan", "attention")) -> dict:
    """Every number of one tree, in this process."""
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.core import agu, hopper, lowering
    from repro_torch.kernels import attention, scan

    dev = torch.device("cuda")
    kernels = {"scan": ("stream_scan", "ring_stream_scan", "base_scan"),
               "attention": ("rescale_attention", "ring_rescale_attention")}
    logs = hopper.build(tuple(n for part in parts for n in kernels[part]))
    gen = torch.Generator(device=dev).manual_seed(seed)
    timed, exact, digest, split, attributes, host = {}, {}, {}, {}, {}, {}
    ptxas = {n: ptxas_counts(log) for n, log in logs.items()}
    stream = torch.cuda.current_stream().cuda_stream

    def bits(t):
        return t.contiguous().view(torch.int32)

    def checksum(t) -> str:
        b = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
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

    # -- the source variants, built together -------------------------------
    vroot = root / "build" / "scan_attention_ablation"
    todo = {("rescale_attention", v): subs for v, subs in K11_VARIANTS.items()
            if "attention" in parts}
    if hasattr(hopper, "scan_schedule_model") and "scan" in parts:
        name, line = WAIT_LINE
        todo["stream_scan", "no_wait"] = ((name, line, ""),)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        built = dict(zip(todo, pool.map(
            lambda kv: build_variant(hopper.CSRC, vroot / "_".join(kv[0]),
                                     kv[0][0], kv[1]), todo.items())))
    for (kernel, v), b in built.items():
        ptxas[f"{kernel}/{v}"] = None if b is None else \
            {k: x for k, x in b.items() if k != "so"}
    nowait = built.get(("stream_scan", "no_wait"))
    nowait_lib = None if nowait is None else ctypes.CDLL(nowait["so"])
    # -- the scan ----------------------------------------------------------
    xsc = torch.randn(SCAN_N, generator=gen, device=dev)
    keep = []
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")) \
            if "scan" in parts else ():
        x = xsc.to(dt)
        arrays, static, _ = scan._prepare(x)
        arrays = tuple(arrays)
        lc = scan._launch(static, *arrays)
        ring = agu.RingProgram((4,), (False,))
        k14 = hopper.stream_scan(lc, arrays[0])[0]
        r15 = hopper.ring_stream_scan(lc, arrays[0], ring)[0]
        exact[f"scan_2p26_{tag}/k14_twice"] = bool(torch.equal(
            bits(hopper.stream_scan(lc, arrays[0])[0]), bits(k14)))
        exact[f"scan_2p26_{tag}/r15_is_k14"] = bool(torch.equal(bits(r15),
                                                                bits(k14)))
        if tag == "f32" and hasattr(hopper, "scan_model"):
            model = hopper.scan_model(arrays[0].reshape(-1).cpu().numpy())
            exact["scan_2p26_f32/k14_is_scan_model"] = bool(
                (torch.from_numpy(model).view(torch.int32) ==
                 bits(k14).reshape(-1).cpu()).all())
        digest[f"scan_2p26_{tag}/stream_scan"] = checksum(k14)
        fns = {"stream_scan": lambda lc=lc, a=arrays: hopper.stream_scan(
                   lc, a[0]),
               "ring_stream_scan_4": lambda lc=lc, a=arrays, r=ring:
                   hopper.ring_stream_scan(lc, a[0], r),
               "base_scan": lambda a=arrays: hopper.base_scan(a[0])}
        name, out, args = grabbed(lambda lc=lc, a=arrays:
                                  hopper.stream_scan(lc, a[0]))
        keep += [out, args]
        lib = hopper._lib(name)

        def entry(fn=lib.ssr_stream_scan, a=tuple(args)):
            rc = fn(*a, stream)
            if rc != 0:
                raise SystemExit(f"stream_scan: CUDA error {rc}")
        fns["stream_scan_entry"] = entry
        if nowait_lib is not None:
            fn = nowait_lib.ssr_stream_scan
            fn.argtypes = hopper._SIGNATURES["stream_scan"]
            fn.restype = ctypes.c_int

            def nowait(fn=fn, a=tuple(args)):
                rc = fn(*a, stream)
                if rc != 0:
                    raise SystemExit(f"stream_scan no_wait: CUDA error {rc}")
            fns["stream_scan_entry/no_wait"] = nowait
        for k, fn in fns.items():
            timed[f"scan_2p26_{tag}", k] = fn
        for k in ("stream_scan", "ring_stream_scan_4", "base_scan"):
            split[f"scan_2p26_{tag}/{k}"] = split_ms(fns[k], root)
        timed[f"scan_2p26_{tag}", "library"] = lambda x=x: torch.cumsum(x, 0)
        del k14, r15
    # -- attention ---------------------------------------------------------
    cells = ATTENTION_CELLS.items() if "attention" in parts else ()
    for cell, (heads, s_, d, causal, window) in cells:
        q32, k32, v32 = (torch.randn(heads, s_, d, generator=gen, device=dev)
                         for _ in range(3))
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v = (t.to(dt) for t in (q32, k32, v32))
            _, static, _ = attention._prepare(q[0], k[0], v[0], causal,
                                              window)

            def prepared(sched, q=q, k=k, v=v, static=static, dt=dt,
                         heads=heads):
                one = lowering.prepare_call(
                    attention._nest(static), attention._body(static),
                    {"Q": q[0], "K": k[0], "V": v[0]}, out_dtype=dt,
                    schedule=sched)
                batch = {"Q": q, "K": k, "V": v}
                return one.kernel, lowering.stream_layouts(
                    one.lowered, [batch[t.name] for t in one.lowered.in_streams],
                    lead=(heads,))
            kern, layouts = prepared(lowering.DEFAULT_SCHEDULE)
            out = kern(*layouts)
            key = cell if tag == "f32" else f"{cell}_{tag}"
            digest[f"{key}/rescale_attention"] = checksum(out)
            exact[f"{key}/finite"] = bool(torch.isfinite(out).all())
            rkern, rlayouts = prepared(lowering.Schedule(buffer_depth=4))
            r12 = rkern(*rlayouts)
            digest[f"{key}/ring_rescale_attention_4"] = checksum(r12)
            exact[f"{key}/r12_4_is_k11"] = bool(torch.equal(bits(r12),
                                                            bits(out)))
            keep += [q, k, v, layouts, rlayouts]
            timed[key, "rescale_attention"] = (lambda kern=kern, l_=layouts:
                                               kern(*l_))
            if tag == "f32" and cell in R12_TIMED:
                line = (lambda kern=rkern, l_=rlayouts: kern(*l_))
                timed[key, "ring_rescale_attention_4"] = line
                host[f"{key}/ring_rescale_attention_4"] = host_ms(line, torch)
                rname, _, rargs = grabbed(line)
                o = torch.empty_like(r12)
                rargs[3] = o.data_ptr()         # the output
                keep += [o, rargs]
                rfn = hopper._lib(rname).ssr_ring_rescale_attention

                def rentry(fn=rfn, a=tuple(rargs), t=cell):
                    rc = fn(*a, stream)
                    if rc != 0:
                        raise SystemExit(f"ring_rescale_attention {t}: "
                                         f"CUDA error {rc}")
                timed[key, "ring_rescale_attention_4_entry"] = rentry
            del r12
            if tag != "f32":
                del out
                continue
            host[f"{key}/rescale_attention"] = host_ms(
                lambda k_=kern, l_=layouts: k_(*l_), torch)
            name, _, args = grabbed(lambda k_=kern, l_=layouts: k_(*l_))
            keep.append(args)
            for var, b in built.items():
                if var[0] != "rescale_attention" or b is None:
                    continue
                fn = ctypes.CDLL(b["so"]).ssr_rescale_attention
                fn.argtypes = hopper._SIGNATURES[name]
                fn.restype = ctypes.c_int
                o = torch.empty_like(out)
                a = list(args)
                a[3] = o.data_ptr()             # the output
                keep += [o, a]

                def call_(fn=fn, a=a, t=f"{cell}/{var[1]}"):
                    rc = fn(*a, stream)
                    if rc != 0:
                        raise SystemExit(f"rescale_attention {t}: CUDA "
                                         f"error {rc}")
                call_()
                torch.cuda.synchronize()
                if var[1] not in K11_INEXACT:
                    exact[f"{cell}/variant_{var[1]}_is_k11"] = bool(
                        torch.equal(bits(o), bits(out)))
                timed[cell, f"rescale_attention_entry/{var[1]}"] = call_
            if window is None:
                timed[cell, "library"] = (
                    lambda q=q, k=k, v=v, c=causal:
                    F.scaled_dot_product_attention(q, k, v, is_causal=c))
            else:
                i = torch.arange(s_, device=dev)
                mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                     - window)
                keep.append(mask)
                timed[cell, "library"] = (
                    lambda q=q, k=k, v=v, m=mask:
                    F.scaled_dot_product_attention(q, k, v, attn_mask=m))
            del out
    # -- registers, local bytes, CTAs an SM (where the port reports them) ---
    for key, name, extra in (
            ("stream_scan", "stream_scan", {}),
            ("rescale_attention_128_d80", "rescale_attention",
             {"tile": (128, 80)}),
            ("rescale_attention_128", "rescale_attention",
             {"tile": (128, 128)}),
            ("rescale_attention_256_d192", "rescale_attention",
             {"tile": (256, 192)}),
            ("rescale_attention_256_d256", "rescale_attention",
             {"tile": (256, 256)}),
            ("ring_rescale_attention", "ring_rescale_attention", {})):
        if ("scan" if key == "stream_scan" else "attention") not in parts:
            continue
        try:
            attributes[key] = hopper.kernel_attributes(name, **extra)
        except (AttributeError, TypeError, RuntimeError) as e:
            attributes[key] = f"not reported: {type(e).__name__}"
    # -- the turns ---------------------------------------------------------
    keys = list(timed)
    medians = {k: [] for k in keys}
    for k in [*keys, *reversed(keys)]:
        medians[k].append(statistics.median(time_ms(timed[k], torch)))
    ms = {"/".join(k): statistics.mean(v) for k, v in medians.items()}
    return {"root": str(root), "exact": exact, "digest": digest, "ms": ms,
            "host_ms": host, "split": split, "ptxas": ptxas,
            "attributes": attributes}


def host_ms(fn, torch, calls: int = 20) -> float:
    """Host time to issue one ``fn`` call back to back, once warm (the
    mean of ``calls``): a wrapper's own work, with its launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return t


def time_ms(fn, torch, samples: int = 10) -> list:
    """Samples of one call's device time: back-to-back calls lasting about
    2 ms (one call for a slower one), CUDA events around them."""
    def sample(calls: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    for _ in range(3):
        fn()
    calls = max(1, min(100, int(2.0 / max(sample(1), 1e-3))))
    return [sample(calls) for _ in range(samples)]


def split_ms(fn, root: Path, calls: int = 5) -> dict:
    """Device ms a call of ``fn`` by kernel (and memset) name, from a
    torch.profiler trace of ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    tmpdir = root / "build"
    tmpdir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmpdir) as tmp:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trees", nargs=2, type=Path, default=None,
                    metavar=("PARENT", "CHANGE"))
    ap.add_argument("--tree", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON line to this file")
    ap.add_argument("--parts", nargs="+", choices=("scan", "attention"),
                    default=("scan", "attention"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("scan_attention_ablation: needs a CUDA device")
    if args.tree is not None:          # one run, in a process of its own
        print(json.dumps(measure_tree(args.tree.resolve(), args.seed,
                                      tuple(args.parts))))
        return 0
    smi = card()
    if args.trees is None:
        runs = {"change": [measure_tree(Path(__file__).resolve().parents[1],
                                        args.seed, tuple(args.parts))]}
    else:
        runs = {"parent": [], "change": []}
        order = (("parent", 0), ("change", 1), ("change", 1), ("parent", 0))
        for side, i in order:
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--tree",
                 str(args.trees[i].resolve()), "--seed", str(args.seed),
                 "--parts", *args.parts],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise SystemExit(f"{side} run failed:\n{proc.stderr[-4000:]}")
            runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    sides = {}
    for side, rs in runs.items():
        ms = {k: statistics.mean(r["ms"][k] for r in rs) for k in rs[0]["ms"]}
        sides[side] = {"ms": ms, "runs_ms": [r["ms"] for r in rs],
                       "exact": {k: all(r["exact"].get(k, False) for r in rs)
                                 for k in rs[0]["exact"]},
                       "digest": rs[0]["digest"],
                       "same_digest_in_runs": all(r["digest"] == rs[0]["digest"]
                                                  for r in rs),
                       "host_ms": {k: statistics.mean(r["host_ms"][k]
                                                      for r in rs)
                                   for k in rs[0].get("host_ms", {})},
                       "split": rs[0]["split"], "ptxas": rs[0]["ptxas"],
                       "attributes": rs[0]["attributes"]}
    result = {"phase": "scan_attention_ablation", "card": smi,
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
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
