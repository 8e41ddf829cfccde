#!/usr/bin/env python3
"""B7 ``base_spmm`` and B5 ``base_stencil1d`` beside their parent design,
their streamed kernels K13 and K9, and one PyTorch call for each function,
in one process a tree.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 tools/base_spmm_stencil_ablation.py [--seed 0] [--out FILE]
    python3 tools/base_spmm_stencil_ablation.py --trees PARENT CHANGE [--out FILE]

With ``--trees`` the script measures each tree (a checkout, e.g. unpacked
by ``git archive``) in a process of its own, in the order parent, change,
change, parent, and reports each side as the mean of its two runs; without
it, the tree it sits in.  Each tree builds its own kernels under its own
``build/``.

The cells are chip_smoke.py's: ``spmm_hpcg`` (HPCG's 27-point operator on
a 64**3 grid, packed by ``sparse.pack_ell`` into (m, 27) planes, times X
(m, 128) ~ N(0, 1)) and ``stencil1d`` (x ~ N(0, 1), n = 2**26, taps
~ N(0, 0.3**2)).

* ``digest``: a checksum of the bits of B7 on spmm_hpcg at c = 128
  (X aligned: 16-byte loads in the change) and at c = 200 (X a view 4
  bytes off a 16-byte boundary: 4-byte loads), and of B5 on stencil1d in
  f32 and in bf16 (x rounded) and in f32 off a 16-byte boundary (one
  element a load in the change).
* ``exact``: B7 against ``hopper.base_spmm_model`` on its first and last
  8,192 rows at c = 128 and 200, and B5 against
  ``hopper.base_stencil1d_model`` on its first and last 2**20 outputs, in
  f32 and bf16, with tap 1's product rounded alone (``rounded_tap1``:
  fmaf(w0, x0, w1·x1)) and with tap 0's (``rounded_tap0``): which
  contraction the tree's build made; every output finite.  The model is
  the change's; a parent tree without it is checked against the change's
  copy, loaded from the tool's own tree.
* ``ms``: B7 through its wrapper (``b7``) and its C entry with the
  arguments the wrapper passes (``b7_entry``), K13 on the planes
  (``k13``), cuSPARSE (``torch.sparse_csr_tensor @ X``); B5 in f32 and
  bf16 (wrapper and C entry), K9 on the cell (``k9``) and ``F.conv1d``
  (TF32 off); ``ssr_over_baseline``: B / K.
* the variants, each taking out one cause (launched through the C entry
  with the wrapper's arguments, held to ``as_is``'s bits unless wrong on
  purpose; null where the tree's source lacks the lines).  B7 in the
  parent: ``idx_reg`` (each element's index from a register: the row's
  indices loaded once, one a lane, and shuffled), ``vec4`` (16-byte
  loads), ``self_row`` (every gather at the row's own X row, so in L1;
  wrong on purpose), ``band64`` (a CTA walks 64 consecutive rows, 8 at a
  time), ``rows2``/``rows4`` (2 or 4 rows a warp at once, 4-byte loads),
  ``vec4_rows4``, and ``template`` (the parent's design from the variants'
  template: its time should be ``as_is``'s).  B7 in the change: ``rows1``,
  ``rows2c``, ``rows3`` (rows a warp), ``vec1`` (4-byte loads on the same
  aligned X), ``lane_idx`` (every lane loads each row's index and value
  itself, no shuffles), ``threads64``, ``threads256`` (the CTA, with the
  CTAs an SM it is built for), ``min_ctas10`` (built for 10 CTAs an SM)
  and ``self_row_c`` (wrong on purpose).  B5 in either tree: ``per_sm4``,
  ``per_sm8``, ``per_sm16`` (the split at 4, 8 or 16 CTAs an SM) and
  ``threads256`` (2 outputs a thread); in the parent ``tap0_only`` (one
  tap: what the other ten cost; wrong on purpose) and ``smem_tile`` (the
  taps from the step's tile, staged by element loads); in the change
  ``vec1`` (the tile by element loads), ``min_ctas8`` (built for and run
  at 8 CTAs an SM), ``threads256c`` (256 threads at 8 CTAs an SM),
  ``tap0_only_c`` (two taps) and ``no_stage`` (the tile never loaded);
  the last two wrong on purpose.
* ``host_ms``: the host time of one B7 and one B5 call issued back to back
  once warm (the mean of 200): the wrapper's own work, with its launch;
  beside them B1's on a padded vector of 2**20 (``b1``).
* ``ptxas``: registers and spill bytes of each build as ``nvcc -Xptxas -v``
  printed them; ``attributes``: as the runtime reads them (registers,
  local bytes, CTAs an SM), where the tree's port reports them.

The timed calls run in two turns (forward, then backward), each the median
of CUDA-event samples of back-to-back calls lasting about 2 ms; ``ms`` is
the mean of the turns' medians.  Prints one JSON line with the card's name
and power limit (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from scan_attention_ablation import (build_variant, card,  # noqa: E402
                                     host_ms, ptxas_counts, time_ms)

GRID, RHS, WIDE = 64, 128, 200
STENCIL_N = 1 << 26
#: rows of B7 and outputs of B5 held to the model at each end of the cell
MODEL_ROWS, MODEL_OUTPUTS = 8192, 1 << 20
#: calls a host time is the mean of
HOST_CALLS = 200

# -- B7's variants ----------------------------------------------------------
#
# The parent's kernel is replaced whole by a kernel from this template: R
# rows a warp at once, P passes of 8R rows a CTA, V-wide loads, the index
# loaded (or from a register), the gather at its clipped column (or at the
# row's own X row).

_P7_KERNEL_START = ("__global__ void __launch_bounds__(kThreads)\n"
                    "    base_spmm_kernel(")
_P7_KERNEL_END = "  }\n}\n\n}  // namespace\n"
_P7_CTAS = "  const int64_t ctas = (m + kRowsPerCta - 1) / kRowsPerCta;\n"


def _p7_kernel(rows: int = 1, passes: int = 1, vec: int = 1,
               idx_reg: bool = False, self_row: bool = False) -> str:
    cols = "4 * lane" if vec == 4 else "lane"
    index = ("__shfl_sync(0xffffffffu, idx_lane[r], static_cast<int>(j))"
             if idx_reg else "cidx[row * k + j]")
    where = ("(i == -12345 ? 0 : (row < n ? row : n - 1))" if self_row
             else "(i < 0 ? 0 : (i >= n ? n - 1 : i))")
    if vec == 4:
        use = ("        if (col0 < c) {\n"
               "          const float4 g = *reinterpret_cast<const float4*>"
               "(px + col0);\n"
               "          acc[r][0] = fmaf(v, g.x, acc[r][0]);\n"
               "          acc[r][1] = fmaf(v, g.y, acc[r][1]);\n"
               "          acc[r][2] = fmaf(v, g.z, acc[r][2]);\n"
               "          acc[r][3] = fmaf(v, g.w, acc[r][3]);\n"
               "        }\n")
        store = ("      if (row0 + r < m && col0 < c)\n"
                 "        for (int q = 0; q < 4; ++q)\n"
                 "          out[(row0 + r) * c + col0 + q] = acc[r][q];\n")
    else:
        use = ("#pragma unroll\n"
               "        for (int q = 0; q < 4; ++q) {\n"
               "          const int64_t col = col0 + 32 * q;\n"
               "          if (col < c) acc[r][q] = fmaf(v, px[col], "
               "acc[r][q]);\n"
               "        }\n")
        store = ("      if (row0 + r < m)\n"
                 "        for (int q = 0; q < 4; ++q)\n"
                 "          if (col0 + 32 * q < c)\n"
                 "            out[(row0 + r) * c + col0 + 32 * q] = "
                 "acc[r][q];\n")
    reg = ("    int32_t idx_lane[R];\n"
           "#pragma unroll\n"
           "    for (int r = 0; r < R; ++r) {\n"
           "      const int64_t row = row0 + r < m ? row0 + r : m - 1;\n"
           "      idx_lane[r] = lane < k ? cidx[row * k + lane] : 0;\n"
           "    }\n") if idx_reg else ""
    return (
        "constexpr int R = %d, P = %d;\n" % (rows, passes)
        + _P7_KERNEL_START
        + "const float* __restrict__ vals,\n"
        "                     const int32_t* __restrict__ cidx,\n"
        "                     const float* __restrict__ x, float* "
        "__restrict__ out,\n"
        "                     int64_t m, int64_t k, int64_t n, int64_t c) {\n"
        "  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n"
        f"  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kCols + "
        f"{cols};\n"
        "#pragma unroll 1\n"
        "  for (int pass = 0; pass < P; ++pass) {\n"
        "    const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * P + "
        "pass) * (kRowsPerCta * R) + warp * R;\n"
        "    if (row0 >= m) break;\n"
        "    float acc[R][4];\n"
        "#pragma unroll\n"
        "    for (int r = 0; r < R; ++r)\n"
        "      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;\n"
        + reg +
        "#pragma unroll 1\n"
        "    for (int64_t j = 0; j < k; ++j) {\n"
        "#pragma unroll\n"
        "      for (int r = 0; r < R; ++r) {\n"
        "        const int64_t row = row0 + r < m ? row0 + r : m - 1;\n"
        f"        const int64_t i = {index};\n"
        f"        const float* px = x + {where} * c;\n"
        "        const float v = vals[row * k + j];\n"
        + use +
        "      }\n"
        "    }\n"
        "#pragma unroll\n"
        "    for (int r = 0; r < R; ++r) {\n"
        + store +
        "    }\n"
        "  }\n"
        "}\n\n}  // namespace\n")


def _p7(**kw) -> tuple:
    """The parent's kernel and its grid replaced by the template's."""
    rows, passes = kw.get("rows", 1), kw.get("passes", 1)
    return (("base_spmm.cu", "@kernel", _p7_kernel(**kw)),
            ("base_spmm.cu", _P7_CTAS,
             f"  const int64_t ctas = (m + kRowsPerCta * {rows * passes} - 1)"
             f" / (kRowsPerCta * {rows * passes});\n"))


_C7_ROWS = "constexpr int kRows = 4;"
_C7_THREADS = "constexpr int kThreads = 128;"
_C7_MIN = "constexpr int kMinCtas = 8;"
_C7_IDX = "      const int64_t i = __shfl_sync(kAll, idx, r);"
_C7_VAL = "      v[r] = __shfl_sync(kAll, val, r);"
_C7_ROW = "(row0 + r < m ? row0 + r : m - 1) * k + j"
_C7_WHERE = "      xrow[r] = (i < 0 ? 0 : (i >= n ? n - 1 : i)) * c;"


def _c7(threads: int = 128, min_ctas: int = 8, rows: int = 4) -> tuple:
    """The change's CTA, CTAs an SM built for and rows a warp replaced."""
    return tuple(("base_spmm.cu", old, old.replace(str(was), str(now)))
                 for old, was, now in ((_C7_THREADS, 128, threads),
                                       (_C7_MIN, 8, min_ctas),
                                       (_C7_ROWS, 4, rows))
                 if was != now)


#: variant -> (file, old, new) replacements ("@kernel" as old: the
#: parent's kernel, start to end, replaced whole); ``vec1`` is the
#: change's kernel launched with vec = 1 on the same X
B7_VARIANTS = {
    "as_is": (),
    "template": _p7(),
    "idx_reg": _p7(idx_reg=True),
    "vec4": _p7(vec=4),
    "self_row": _p7(self_row=True),
    "band64": _p7(passes=8),
    "rows2": _p7(rows=2),
    "rows4": _p7(rows=4),
    "vec4_rows4": _p7(rows=4, vec=4),
    "rows1": _c7(rows=1),
    "rows2c": _c7(rows=2),
    "rows3": _c7(rows=3),
    "lane_idx": (("base_spmm.cu", _C7_IDX,
                  f"      const int64_t i = cidx[{_C7_ROW}];"),
                 ("base_spmm.cu", _C7_VAL, f"      v[r] = vals[{_C7_ROW}];")),
    "threads64": _c7(threads=64, min_ctas=16),
    "threads256": _c7(threads=256, min_ctas=4),
    "min_ctas10": _c7(min_ctas=10),
    "self_row_c": (("base_spmm.cu", _C7_WHERE,
                    "      xrow[r] = (i == -12345 ? 0 : (row0 + r < n ? "
                    "row0 + r : n - 1)) * c;"),),
}
B7_INEXACT = ("self_row", "self_row_c")
#: B7's variants of the change's launch arguments (its entry's last is
#: vec): the change's kernel reading 4-byte loads on the aligned X
B7_ARGS = {"vec1": lambda args: args[:-1] + [1]}

# -- B5's variants ----------------------------------------------------------

_P5_STEP_LOOP = (
    "  for (int64_t step = first; step < last; ++step) {\n"
    "#pragma unroll\n"
    "    for (int k = 0; k < kPer; ++k) {\n"
    "      const int64_t i = step * kTile + k * kThreads + threadIdx.x;\n"
    "      if (i >= n) continue;\n"
    "      float acc = wr[0] * ssr_f32(x[i]);\n"
    "#pragma unroll\n"
    "      for (int j = 1; j < kTaps; ++j) acc = acc + wr[j] * "
    "ssr_f32(x[i + j]);\n"
    "      y[i] = acc;\n"
    "    }\n"
    "  }\n")
#: the parent's step loop with the taps read from the step's tile, staged
#: by element loads (the parent's arithmetic as written)
_P5_SMEM_LOOP = (
    "  __shared__ float tile[kTile + kTaps - 1];\n"
    "  const int64_t total = n + kTaps - 1;\n"
    "  for (int64_t step = first; step < last; ++step) {\n"
    "    const int64_t base = step * kTile;\n"
    "    for (int e = threadIdx.x; e < kTile + kTaps - 1; e += kThreads)\n"
    "      if (base + e < total) tile[e] = ssr_f32(x[base + e]);\n"
    "    __syncthreads();\n"
    "#pragma unroll\n"
    "    for (int k = 0; k < kPer; ++k) {\n"
    "      const int t = k * kThreads + threadIdx.x;\n"
    "      const int64_t i = base + t;\n"
    "      if (i >= n) continue;\n"
    "      float acc = wr[0] * tile[t];\n"
    "#pragma unroll\n"
    "      for (int j = 1; j < kTaps; ++j) acc = acc + wr[j] * tile[t + j];\n"
    "      y[i] = acc;\n"
    "    }\n"
    "    __syncthreads();\n"
    "  }\n")
_P5_THREADS = "constexpr int kThreads = 128;\nconstexpr int kPer = 4;"
_P5_TAPS = "      for (int j = 1; j < kTaps; ++j) acc = acc + wr[j]"
_C5_TAPS = "      for (int j = 2; j < kTaps; ++j) acc = fmaf("
_C5_MIN = "constexpr int kMinCtas = 16;"
_C5_STAGE = "        stage<T, V>(x, e, tile + p * V);"
#: variant -> (replacements, CTAs an SM of the split (None: the
#: wrapper's), vec (None: the wrapper's))
B5_VARIANTS = {
    "as_is": ((), None, None),
    "per_sm4": ((), 4, None),
    "per_sm8": ((), 8, None),
    "per_sm16": ((), 16, None),
    "tap0_only": ((("base_stencil1d.cu", _P5_TAPS,
                    _P5_TAPS.replace("j < kTaps", "j < 1")),), None, None),
    "smem_tile": ((("base_stencil1d.cu", _P5_STEP_LOOP, _P5_SMEM_LOOP),),
                  None, None),
    "threads256": ((("base_stencil1d.cu", _P5_THREADS,
                     "constexpr int kThreads = 256;\nconstexpr int kPer = "
                     "2;"),), None, None),
    "vec1": ((), None, 1),
    "min_ctas8": ((("base_stencil1d.cu", _C5_MIN,
                    _C5_MIN.replace("16", "8")),), 8, None),
    "threads256c": ((("base_stencil1d.cu", _P5_THREADS,
                      "constexpr int kThreads = 256;\nconstexpr int kPer = "
                      "2;"),
                     ("base_stencil1d.cu", _C5_MIN,
                      _C5_MIN.replace("16", "8"))), 8, None),
    "tap0_only_c": ((("base_stencil1d.cu", _C5_TAPS,
                      _C5_TAPS.replace("j < kTaps", "j < 2")),), None, None),
    "no_stage": ((("base_stencil1d.cu", _C5_STAGE, ""),), None, None),
}
B5_INEXACT = ("tap0_only", "tap0_only_c", "no_stage")
#: ``vec1`` changes an argument only the change's entry takes
B5_CHANGE_ONLY = ("vec1",)


def _substituted(csrc: Path, subs) -> tuple | None:
    """``subs`` with "@kernel" resolved to the parent's kernel text, or
    None where a replaced line is not in the source."""
    out = []
    for name, old, new in subs:
        text = (csrc / name).read_text()
        if old == "@kernel":
            a, b = text.find(_P7_KERNEL_START), text.find(_P7_KERNEL_END)
            if a < 0 or b < 0 or "kRowsPerCta" not in text:
                return None
            old = text[a:b + len(_P7_KERNEL_END)]
        if old not in text:
            return None
        out.append((name, old, new))
    return tuple(out)


def _model_module(root: Path):
    """``hopper`` of the tree if it has the models, else this tool's
    tree's copy (loaded under another name)."""
    from repro_torch.core import hopper
    if hasattr(hopper, "base_spmm_model"):
        return hopper
    path = HERE.parent / "src" / "repro_torch" / "core" / "hopper.py"
    # in the tree's package, so its relative imports resolve there (agu,
    # which the models do not use)
    spec = importlib.util.spec_from_file_location(
        "repro_torch.core._hopper_with_models", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def measure_tree(root: Path, seed: int) -> dict:
    """Every number of one tree, in this process."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.core import compiler, hopper, lowering
    from repro_torch.kernels import frontend, sparse, stencil

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    logs = hopper.build(("base_spmm", "base_stencil1d", "gather_spmm",
                         "halo_stencil1d"))
    ptxas = {n: ptxas_counts(log) for n, log in logs.items()}
    models = _model_module(root)
    gen = torch.Generator(device=dev).manual_seed(seed)
    stream = torch.cuda.current_stream().cuda_stream
    timed, exact, digest, attributes, host = {}, {}, {}, {}, {}
    keep = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def checksum(t) -> str:
        b = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
        w = torch.arange(1, b.numel() + 1, device=b.device) % 65521
        return f"{int(b.sum())}:{int((b * w).sum())}"

    def off16(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

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

    def entry(name, args):
        fn = getattr(hopper._lib(name), f"ssr_{name}")
        keep.append(args)

        def call(fn=fn, a=tuple(args)):
            rc = fn(*a, stream)
            if rc != 0:
                raise SystemExit(f"{name}: CUDA error {rc}")
        return call

    def same(a, b) -> bool:
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))

    # -- the cells ----------------------------------------------------------
    n2 = GRID ** 3
    csr = sparse.hpcg_operator(GRID, GRID, GRID, device=dev)
    sv, sc, sm, sk = sparse.pack_ell(*csr, n2)
    X = randn(n2, RHS)
    Xw = off16(randn(n2, WIDE))
    xs, ws = randn(STENCIL_N + stencil.TAPS - 1), randn(stencil.TAPS) * 0.3
    xl, wl = xs.reshape(1, -1), ws.reshape(1, -1)
    xb = xl.to(torch.bfloat16)
    xo = off16(xl)
    b7_in = {"c128": (sv, sc, X), "c200": (sv, sc, Xw)}
    b5_in = {"f32": (xl, wl), "bf16": (xb, wl), "f32_off16": (xo, wl)}
    b7_out, b5_out = {}, {}
    for tag, args in b7_in.items():
        b7_out[tag] = hopper.base_spmm(*args)
        digest[f"b7_{tag}"] = checksum(b7_out[tag])
        exact[f"b7_{tag}/finite"] = bool(torch.isfinite(b7_out[tag]).all())
        v_, c_, x_ = (t.cpu().numpy() for t in args)
        for lo in (0, sm - MODEL_ROWS):
            want = models.base_spmm_model(v_[lo:lo + MODEL_ROWS],
                                          c_[lo:lo + MODEL_ROWS], x_)
            got = b7_out[tag][lo:lo + MODEL_ROWS].cpu().numpy()
            exact[f"b7_{tag}_rows{lo}/is_model"] = bool(
                np.array_equal(got.view(np.int32), want.view(np.int32)))
    for tag, (x_, w_) in b5_in.items():
        b5_out[tag] = hopper.base_stencil1d(x_, w_).reshape(-1)
        digest[f"b5_{tag}"] = checksum(b5_out[tag])
        exact[f"b5_{tag}/finite"] = bool(torch.isfinite(b5_out[tag]).all())
        xn = x_.float().reshape(-1).cpu().numpy()
        wn = w_.reshape(-1).cpu().numpy()
        got = b5_out[tag].cpu().numpy()
        for rt in (1, 0):
            hits = []
            for lo in (0, STENCIL_N - MODEL_OUTPUTS):
                want = models.base_stencil1d_model(
                    xn[lo:lo + MODEL_OUTPUTS + stencil.TAPS - 1], wn, rt)
                hits.append(np.array_equal(
                    got[lo:lo + MODEL_OUTPUTS].view(np.int32),
                    want.view(np.int32)))
            exact[f"b5_{tag}/rounded_tap{rt}"] = bool(all(hits))
    # -- the timed calls ----------------------------------------------------
    timed["b7"] = lambda: hopper.base_spmm(sv, sc, X)
    timed["b5_f32"] = lambda: hopper.base_stencil1d(xl, wl)
    timed["b5_bf16"] = lambda: hopper.base_stencil1d(xb, wl)
    # B1 on a padded vector of 2**20 beside them: B1's wrapper is the
    # memoized one the others are held to
    xp = frontend.pad_vector(randn(1 << 20))
    for key, fn in (("b7", timed["b7"]), ("b5_f32", timed["b5_f32"]),
                    ("b1", lambda: hopper.base_reduce(xp, xp))):
        host[key] = host_ms(fn, torch, calls=HOST_CALLS)
    grabs = {}
    for key in ("b7", "b5_f32", "b5_bf16"):
        name, out, args = grabbed(timed[key])
        keep.append(out)
        grabs[key] = (name, out, args)
        timed[f"{key}_entry"] = entry(name, args)
    k13 = lowering.prepare_call(compiler.spmm_nest(sm, RHS, sk, RHS),
                                sparse.SPMM, {"vals": sv, "cidx": sc, "X": X})
    k9 = lowering.prepare_call(compiler.stencil_nest(STENCIL_N, stencil.TAPS),
                               stencil.STENCIL1D, {"x": xs, "w": ws})
    keep += [k13, k9]
    timed["k13"] = lambda: k13.kernel(*k13.layouts)
    timed["k9"] = lambda: k9.kernel(*k9.layouts)
    A = torch.sparse_csr_tensor(csr[2].to(torch.int32), csr[1], csr[0],
                                size=(n2, n2))
    keep.append(A)
    timed["cusparse"] = lambda: A @ X
    timed["conv1d"] = lambda: F.conv1d(xs.view(1, 1, -1), ws.view(1, 1, -1))
    # -- the source variants, built together ---------------------------------
    vroot = root / "build" / "base_spmm_stencil_ablation"
    todo = {}
    for var, subs in B7_VARIANTS.items():
        todo[("base_spmm", var)] = _substituted(hopper.CSRC, subs)
    for var in B7_ARGS:
        todo[("base_spmm", var)] = ()
    for var, (subs, _, _) in B5_VARIANTS.items():
        todo[("base_stencil1d", var)] = _substituted(hopper.CSRC, subs)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        built = dict(zip(todo, pool.map(
            lambda kv: None if kv[1] is None else build_variant(
                hopper.CSRC, vroot / "_".join(kv[0]), kv[0][0], kv[1]),
            todo.items())))
    # a variant of no replacement is the tree's source: keep it only where
    # its launch differs (B5's splits and vec)
    change_tree = len(hopper._SIGNATURES["base_stencil1d"]) == 9
    for (kernel, var), b in built.items():
        ptxas[f"{kernel}/{var}"] = None if b is None else \
            {k: v for k, v in b.items() if k != "so"}
        if b is None:
            continue
        if kernel == "base_spmm":
            if var in B7_ARGS and not change_tree:
                continue
            name, out, args = grabs["b7"]
            if var in B7_ARGS:
                args = B7_ARGS[var](list(args))
            inexact = var in B7_INEXACT
            want = b7_out["c128"]
        else:
            if var in B5_CHANGE_ONLY and not change_tree:
                continue
            name, out, args = grabs["b5_f32"]
            _, per_sm, vec = B5_VARIANTS[var]
            args = list(args)
            if per_sm is not None:
                steps = -(-STENCIL_N // hopper.STENCIL_TILE)
                args[-2:] = list(hopper._k_split(steps, per_sm * sms))
            if vec is not None:
                args[4] = vec
            inexact = var in B5_INEXACT
            want = b5_out["f32"]
        fn = getattr(ctypes.CDLL(b["so"]), f"ssr_{kernel}")
        fn.argtypes = hopper._SIGNATURES[kernel]
        fn.restype = ctypes.c_int
        o = torch.zeros_like(out)
        a = [o.data_ptr() if v == out.data_ptr() else v for v in args]
        keep += [o, a]

        def call_(fn=fn, a=a, t=f"{kernel} {var}"):
            rc = fn(*a, stream)
            if rc != 0:
                raise SystemExit(f"{t}: CUDA error {rc}")
        call_()
        torch.cuda.synchronize()
        tag = "b7" if kernel == "base_spmm" else "b5"
        if not inexact:
            exact[f"{tag}_variant_{var}_is_as_is"] = same(
                o.reshape(want.shape), want)
        timed[f"{tag}_entry/{var}"] = call_
    # -- registers, local bytes, CTAs an SM ----------------------------------
    for key in ("base_spmm", "base_stencil1d"):
        try:
            attributes[key] = hopper.kernel_attributes(key)
        except (AttributeError, TypeError, RuntimeError) as e:
            attributes[key] = f"not reported: {type(e).__name__}"
    # -- the turns -----------------------------------------------------------
    keys = list(timed)
    medians = {k: [] for k in keys}
    for k in [*keys, *reversed(keys)]:
        medians[k].append(statistics.median(time_ms(timed[k], torch)))
    ms = {k: statistics.mean(v) for k, v in medians.items()}
    ms["ssr_over_baseline_spmm"] = ms["b7"] / ms["k13"]
    ms["ssr_over_baseline_stencil1d"] = ms["b5_f32"] / ms["k9"]
    return {"root": str(root), "exact": exact, "digest": digest, "ms": ms,
            "host_ms": host, "ptxas": ptxas, "attributes": attributes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trees", nargs=2, type=Path, default=None,
                    metavar=("PARENT", "CHANGE"))
    ap.add_argument("--tree", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("base_spmm_stencil_ablation: needs a CUDA device")
    if args.tree is not None:          # one run, in a process of its own
        print(json.dumps(measure_tree(args.tree.resolve(), args.seed)))
        return 0
    smi = card()
    trees = {"change": HERE.parent} if args.trees is None else \
        {"parent": args.trees[0], "change": args.trees[1]}
    order = ("change",) if args.trees is None else \
        ("parent", "change", "change", "parent")
    runs = {side: [] for side in trees}
    for side in order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--tree",
             str(trees[side].resolve()), "--seed", str(args.seed)],
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
                       "same_digest_in_runs": all(
                           r["digest"] == rs[0]["digest"] for r in rs),
                       "host_ms": {k: statistics.mean(r["host_ms"][k]
                                                      for r in rs)
                                   for k in rs[0]["host_ms"]},
                       "ptxas": rs[0]["ptxas"],
                       "attributes": rs[0]["attributes"]}
    result = {"phase": "base_spmm_stencil_ablation", "card": smi,
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
    # the parent's contraction is settled by its exact entries: one of
    # rounded_tap0/1 holds, and the change must hold the same one
    ok = all(s["same_digest_in_runs"] for s in sides.values()) and all(
        result.get("same_bits_as_parent", {}).values()) and all(
        v for k, v in sides["change"]["exact"].items()
        if "rounded_tap0" not in k)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
