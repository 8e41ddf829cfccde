"""The Hopper kernels of the port, and their plain PyTorch versions.

The streamed kernels each run one lowered SSR schedule — a grid plus the
streams' affine block walks (:class:`~repro_torch.core.agu.StreamGeometry`):

==============  ===========  ===============================================
kernel          call mode    body op
==============  ===========  ===============================================
reduce_mul      reduce       ``mul``    (reduction: Fig. 4's dot product)
map_relu        map          ``relu``   (relu)
contract_gemm   nest         ``dot``    (gemm's C += A·B)
contract_gemv   nest         ``matvec`` (gemv's y += A·x)
==============  ===========  ===============================================

The monolithic baselines (``MonolithicKernel``) take the padded layouts of
the reference's baseline bodies instead, and walk them with an explicit,
serialised load per block (:data:`BASELINE_KERNELS`, by body op):
``base_reduce`` (``mul``), ``base_relu`` (``relu``), ``base_gemm``
(``dot``) and ``base_gemv`` (``matvec``).  Each runs on the same number of
CTAs, with the same CTA tile, as its streamed counterpart, so the time of
the pair is the card's SSR-against-baseline comparison.

The kernels are CUDA C++ for ``sm_90a`` under ``repro_torch/csrc``, each
built by ``nvcc`` into a shared library with a plain C interface at first
use (into ``build/repro_torch/`` of the checkout, keyed on a hash of the
sources and flags) and bound with ``ctypes``.  A wrapper takes the prepared
layouts, checks what its kernel accepts and raises on anything else,
launches on PyTorch's current stream and counts the launch in
:data:`LAUNCHES`.  It never falls back to anything.

The plain versions of the streamed kernels (:func:`plain_reduce`,
:func:`plain_map`, :func:`plain_contract`) run the same lowered computation
with any PyTorch body: they gather every step's blocks through the same AGU
programming, apply the body to all steps at once (``torch.vmap``) and apply
the reference's epilogue — the vector accumulator fold, the dense map
write, the f32 contraction accumulator with its drain cast.  Those of the
baselines (``plain_base_*``) run the baseline bodies' block walks on the
same padded layouts.  The CPU runs them; the tests and ``chip_smoke.py``
hold each kernel against them.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import (Any, Callable, Dict, Iterable, Optional, Sequence, Tuple,
                    Union)

import torch

from .agu import SSR_MAX_AXES, BlockAGU, StreamGeometry

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: What each kernel replaces in the JAX package (file:line), and its source.
KERNELS: Dict[str, Dict[str, str]] = {
    "reduce_mul": {"replaces": "src/repro/core/lowering.py:1259",
                   "source": "src/repro_torch/csrc/reduce_mul.cu"},
    "map_relu": {"replaces": "src/repro/core/lowering.py:1289",
                 "source": "src/repro_torch/csrc/map_relu.cu"},
    "contract_gemm": {"replaces": "src/repro/core/lowering.py:1510",
                      "source": "src/repro_torch/csrc/contract_gemm.cu"},
    "contract_gemv": {"replaces": "src/repro/kernels/gemv.py:29",
                      "source": "src/repro_torch/csrc/contract_gemv.cu"},
    "base_reduce": {"replaces": "src/repro/kernels/reduction.py:53",
                    "source": "src/repro_torch/csrc/base_reduce.cu"},
    "base_relu": {"replaces": "src/repro/kernels/relu.py:48",
                  "source": "src/repro_torch/csrc/base_relu.cu"},
    "base_gemm": {"replaces": "src/repro/kernels/gemm.py:112",
                  "source": "src/repro_torch/csrc/base_gemm.cu"},
    "base_gemv": {"replaces": "src/repro/kernels/gemv.py:62",
                  "source": "src/repro_torch/csrc/base_gemv.cu"},
}

#: Wrapper calls per kernel since the last :func:`reset_launches`: one per
#: call that launched its kernel.  A ``reduce_mul`` or ``base_reduce`` call
#: is two device launches (the per-CTA partials, then the one-CTA fold);
#: every other kernel's call is one.
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- build and bind ---------------------------------------------------------


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "Hopper kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where the built library of ``name`` lives, keyed on its inputs."""
    h = hashlib.sha256()
    for f in (CSRC / "ssr_common.cuh", CSRC / f"{name}.cu"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, str]:
    """Compile every named kernel not built yet, one ``nvcc`` each, together.

    Returns the compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) for each kernel it compiled; raises if any compile failed.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(n))
        else:
            failed.append(n)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


class _Grid(ctypes.Structure):
    _fields_ = [("ndim", ctypes.c_int64),
                ("dims", ctypes.c_int64 * SSR_MAX_AXES)]


class _Stream(ctypes.Structure):
    _fields_ = [("offset", ctypes.c_int64 * 2),
                ("coeff", (ctypes.c_int64 * 2) * SSR_MAX_AXES),
                ("block", ctypes.c_int64 * 2),
                ("pitch", ctypes.c_int64)]


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_GP, _SP = ctypes.POINTER(_Grid), ctypes.POINTER(_Stream)
_SIGNATURES = {
    "reduce_mul": [_P, _P, _I, _I, _GP, _SP, _SP, _P, _I64, _I64, _P, _P],
    "map_relu": [_P, _P, _I, _I, _GP, _SP, _SP, _I64, _I64, _P],
    "contract_gemm": [_P, _P, _P, _I, _I, _I, _GP, _SP, _SP, _SP, _I64, _P],
    "contract_gemv": [_P, _P, _P, _I, _I, _I, _GP, _SP, _SP, _SP, _I64, _P],
    "base_reduce": [_P, _P, _I, _I64, _P, _I64, _I64, _P, _P],
    "base_relu": [_P, _P, _I, _I64, _I64, _I64, _P],
    "base_gemm": [_P, _P, _P, _I, _I, _I, _I64, _I64, _I64, _P],
    "base_gemv": [_P, _P, _P, _I, _I, _I64, _I64, _P],
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        try:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
        except OSError as e:
            # a kernel that cannot be built or loaded is broken, not cache
            # I/O: no fallback rung may take it for a transient OSError
            raise RuntimeError(f"{name}: cannot build or load the kernel: "
                               f"{e}") from e
        entry = getattr(lib, f"ssr_{name}")
        entry.argtypes = _SIGNATURES[name]
        entry.restype = ctypes.c_int
        smem = getattr(lib, f"ssr_{name}_smem_bytes")
        smem.argtypes, smem.restype = [], ctypes.c_int64
        lib.ssr_error_string.argtypes = [ctypes.c_int]
        lib.ssr_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _grid_arg(grid: Sequence[int]) -> _Grid:
    if len(grid) > SSR_MAX_AXES:
        raise ValueError(f"grid {grid} has more than {SSR_MAX_AXES} axes")
    g = _Grid(len(grid))
    for k, d in enumerate(grid):
        g.dims[k] = d
    return g


def _stream_arg(agu: BlockAGU, layout: torch.Tensor) -> _Stream:
    s = _Stream()
    s.offset[0], s.offset[1] = agu.offset
    for k, (c0, c1) in enumerate(agu.coeffs):
        s.coeff[k][0], s.coeff[k][1] = c0, c1
    s.block[0], s.block[1] = agu.block
    s.pitch = layout.shape[1]
    return s


_FLOATS = (torch.float32, torch.bfloat16)


def _gemm_composes(geo: StreamGeometry) -> bool:
    (tm, tk), (tk2, tn) = geo.ins[0].block, geo.ins[1].block
    return (tk2, geo.out.block) == (tk, (tm, tn))


def _gemv_composes(geo: StreamGeometry) -> bool:
    tm, tn = geo.ins[0].block
    return (geo.ins[1].block, geo.out.block) == ((1, tn), (1, tm))


#: What each streamed kernel takes: read streams, input dtypes, and the
#: block composition it computes (as text, and as a test of the geometry).
_TAKES: Dict[str, tuple] = {
    "reduce_mul": (2, _FLOATS, "one block shape for every read stream",
                   lambda geo: len({a.block for a in geo.ins}) == 1),
    "map_relu": (1, _FLOATS + (torch.int32,), "read block = write block",
                 lambda geo: geo.ins[0].block == geo.out.block),
    "contract_gemm": (2, _FLOATS, "C += A·B", _gemm_composes),
    "contract_gemv": (2, _FLOATS, "y += A·xᵀ", _gemv_composes),
}


def _smem_refusal(name: str, dev: torch.device) -> Optional[str]:
    need = getattr(_lib(name), f"ssr_{name}_smem_bytes")()
    limit = _card(dev).shared_memory_per_block_optin
    if need > limit:
        return (f"{name}: a CTA needs {need} bytes of shared memory, the "
                f"card allows {limit}")
    return None


def _refusal(name: str, geo: StreamGeometry, dtype: torch.dtype,
             dev: torch.device) -> Optional[str]:
    """Why kernel ``name`` refuses this geometry at ``dtype``, or None."""
    n_in, dtypes, formula, composes = _TAKES[name]
    if len(geo.ins) != n_in:
        return f"{name}: takes {n_in} streams, the schedule has {len(geo.ins)}"
    if dtype not in dtypes:
        return (f"{name}: takes {[str(d) for d in dtypes]}, not {dtype}")
    if len(geo.grid) > SSR_MAX_AXES:
        return f"{name}: grid {geo.grid} has more than {SSR_MAX_AXES} axes"
    for agu in (*geo.ins, geo.out):
        if math.prod(agu.block) >= 2 ** 31:
            return (f"{name}: block {agu.block} has 2**31 or more elements; "
                    "the kernels index blocks in 32 bits")
    if len(geo.out_shape) != 2:
        return f"{name}: output layout {geo.out_shape} is not 2-D"
    if not composes(geo):
        return (f"{name}: blocks {[a.block for a in geo.ins]} → "
                f"{geo.out.block} do not compose as {formula}")
    return _smem_refusal(name, dev) if dev.type == "cuda" else None


def accepts(op: tuple, geo: StreamGeometry, dtype: torch.dtype,
            device: Union[str, torch.device]) -> Tuple[bool, str]:
    """(takes, reason): whether the streamed kernel of ``op`` — a (call
    mode, body op) pair of :data:`DEVICE_KERNELS` — takes this geometry at
    this input dtype on ``device``.  The wrappers refuse exactly what this
    refuses; the autotuner filters its candidates with it.  On a CUDA
    device the shared-memory check builds the kernel."""
    kernel = DEVICE_KERNELS.get(op)
    if kernel is None:
        return False, f"no Hopper kernel for {op}"
    reason = _refusal(kernel.__name__, geo, dtype, torch.device(device))
    return reason is None, reason or "ok"


def _checked_operands(name: str, tensors: Sequence[torch.Tensor],
                      dtypes: Sequence[torch.dtype]) -> torch.device:
    """What every wrapper's kernel takes of its operands — one CUDA device,
    one dtype of ``dtypes``, contiguous 2-D layouts; return the device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: launches on CUDA tensors, got {dev}")
    for k, t in enumerate(tensors):
        if t.device != dev:
            raise ValueError(f"{name}: operand {k} on {t.device}, not {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: operand {k} has dtype {t.dtype}; the "
                            f"kernel takes {[str(d) for d in dtypes]}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: operand {k} needs a contiguous 2-D "
                             f"layout, got shape {tuple(t.shape)}")
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"{name}: operands of mixed dtypes "
                        f"{[str(t.dtype) for t in tensors]}")
    return dev


def _checked(name: str, geo: StreamGeometry,
             layouts: Sequence[torch.Tensor]) -> torch.device:
    """Validate what every streamed wrapper's kernel takes; return the
    device."""
    n_in, dtypes = _TAKES[name][:2]
    if len(layouts) != n_in:
        raise ValueError(f"{name}: takes {n_in} streams, got {len(layouts)}")
    dev = _checked_operands(name, layouts, dtypes)
    for k, (t, agu) in enumerate(zip(layouts, geo.ins)):
        agu.check_within(geo.grid, tuple(t.shape), f"{name}[{k}]")
    reason = _refusal(name, geo, layouts[0].dtype, dev)
    if reason is not None:
        raise ValueError(reason)
    geo.out.check_within(geo.grid, geo.out_shape, f"{name}[out]")
    return dev


_CARDS: Dict[int, Any] = {}


def _card(dev: torch.device):
    """The card's properties (SM count, shared-memory limit), read once."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _CARDS:
        _CARDS[index] = torch.cuda.get_device_properties(index)
    return _CARDS[index]


def _launch(name: str, dev: torch.device, *args) -> None:
    lib = _lib(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"ssr_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc} "
                           f"({lib.ssr_error_string(rc).decode()})")
    LAUNCHES[name] += 1


def _ctas(dev: torch.device, steps: int, per_sm: int) -> tuple:
    """(CTAs, steps per CTA) that spread ``steps`` over the card's SMs."""
    sms = _card(dev).multi_processor_count
    per_cta = -(-steps // min(steps, per_sm * sms))
    return -(-steps // per_cta), per_cta


def _vector_width(tensors: Sequence[torch.Tensor],
                  agus: Sequence[BlockAGU]) -> int:
    """Elements per 16-byte access where every base pointer, row pitch and
    block width allows one (then every block row starts aligned), else 1."""
    v = 16 // tensors[0].element_size()
    if all(t.data_ptr() % 16 == 0 and t.shape[1] % v == 0 for t in tensors) \
            and all(a.block[1] % v == 0 for a in agus):
        return v
    return 1


# -- the four wrappers ------------------------------------------------------


def reduce_mul(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
               out_dtype: torch.dtype,
               acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1: Σ promote(a)·promote(b) over every step → (1, 1) f32."""
    dev = _checked("reduce_mul", geo, layouts)
    if out_dtype != torch.float32:
        raise TypeError(f"reduce_mul: accumulates in float32, asked for "
                        f"{out_dtype}")
    a, b = layouts
    ctas, per_cta = _ctas(dev, geo.steps, per_sm=8)
    partials = torch.empty(ctas, dtype=torch.float32, device=dev)
    out = torch.empty((1, 1), dtype=torch.float32, device=dev)
    g, sa, sb = _grid_arg(geo.grid), _stream_arg(geo.ins[0], a), \
        _stream_arg(geo.ins[1], b)
    _launch("reduce_mul", dev, a.data_ptr(), b.data_ptr(),
            _DTYPE_CODE[a.dtype], _vector_width(layouts, geo.ins),
            ctypes.byref(g), ctypes.byref(sa),
            ctypes.byref(sb), partials.data_ptr(), ctas, per_cta,
            out.data_ptr())
    return out


def map_relu(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
             out_dtype: torch.dtype,
             acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K2: each step's block → max(0, block) through the dense out map."""
    dev = _checked("map_relu", geo, layouts)
    (x,) = layouts
    if out_dtype != x.dtype:
        raise TypeError(f"map_relu: keeps the dtype ({x.dtype}), asked for "
                        f"{out_dtype}")
    ctas, per_cta = _ctas(dev, geo.steps, per_sm=64)
    out = torch.empty(geo.out_shape, dtype=x.dtype, device=dev)
    g, sx, so = _grid_arg(geo.grid), _stream_arg(geo.ins[0], x), \
        _stream_arg(geo.out, out)
    _launch("map_relu", dev, x.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[x.dtype],
            _vector_width((x, out), (geo.ins[0], geo.out)),
            ctypes.byref(g), ctypes.byref(sx),
            ctypes.byref(so), ctas, per_cta)
    return out


def _contract(name: str, geo: StreamGeometry,
              layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
              acc_dtype: torch.dtype,
              vec_of: Callable[[], int]) -> torch.Tensor:
    dev = _checked(name, geo, layouts)
    if acc_dtype != torch.float32:
        raise TypeError(f"{name}: accumulates in float32, the schedule asks "
                        f"for {acc_dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: drains to float32 or bfloat16, asked for "
                        f"{out_dtype}")
    out = torch.empty(geo.out_shape, dtype=out_dtype, device=dev)
    g = _grid_arg(geo.grid)
    s0, s1 = (_stream_arg(a, t) for a, t in zip(geo.ins, layouts))
    so = _stream_arg(geo.out, out)
    _launch(name, dev, layouts[0].data_ptr(), layouts[1].data_ptr(),
            out.data_ptr(), _DTYPE_CODE[layouts[0].dtype],
            _DTYPE_CODE[out_dtype], vec_of(), ctypes.byref(g),
            ctypes.byref(s0), ctypes.byref(s1), ctypes.byref(so),
            geo.contraction_steps)
    return out


def contract_gemm(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                  out_dtype: torch.dtype,
                  acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K3: C block (tm, tn) += A block (tm, tk) · B block (tk, tn)."""
    # A and B are read in 16-byte packs where they can be (f32 only)
    return _contract(
        "contract_gemm", geo, layouts, out_dtype, acc_dtype,
        lambda: 4 if layouts[0].dtype == torch.float32
        and _vector_width(layouts, geo.ins) == 4 else 1)


def contract_gemv(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                  out_dtype: torch.dtype,
                  acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K4: y block (1, tm) += A block (tm, tn) · x block (1, tn)ᵀ."""
    # A is read in 16-byte packs where it can be; x is staged element-wise
    return _contract("contract_gemv", geo, layouts, out_dtype, acc_dtype,
                     lambda: _vector_width(layouts[:1], geo.ins[:1]))


#: (call mode, body op) → the kernel that runs it on the card.
DEVICE_KERNELS: Dict[tuple, Callable[..., torch.Tensor]] = {
    ("reduce", "mul"): reduce_mul,
    ("map", "relu"): map_relu,
    ("nest", "dot"): contract_gemm,
    ("nest", "matvec"): contract_gemv,
}


# -- the four baseline wrappers ---------------------------------------------
#
# They take the padded layouts of the reference's baseline bodies: x and y
# as (rows, 128) with rows a multiple of 8 (``frontend.pad_vector``); A as
# (m, k) with k a multiple of 128 and B as (k, n); A as (m8, n) with m8 a
# multiple of 8 and x as (1, n).

ROWS, LANES = 8, 128


def _checked_base(name: str, tensors: Sequence[torch.Tensor],
                  dtypes: Sequence[torch.dtype]) -> torch.device:
    """Validate what every baseline wrapper's kernel takes; return the
    device."""
    dev = _checked_operands(name, tensors, dtypes)
    reason = _smem_refusal(name, dev)
    if reason is not None:
        raise ValueError(reason)
    return dev


def _row_blocks(name: str, t: torch.Tensor) -> int:
    """(8, 128) blocks of a padded vector layout; at least one."""
    rows, lanes = t.shape
    if lanes != LANES or rows % ROWS or rows == 0:
        raise ValueError(f"{name}: needs a (rows, {LANES}) layout with rows "
                         f"a positive multiple of {ROWS}, got {tuple(t.shape)}")
    return rows // ROWS


def base_reduce(x: torch.Tensor, y: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B1: Σ promote(x)·promote(y) over the (8, 128) blocks → (1, 1) f32."""
    dev = _checked_base("base_reduce", (x, y), _FLOATS)
    if out_dtype != torch.float32:
        raise TypeError(f"base_reduce: accumulates in float32, asked for "
                        f"{out_dtype}")
    if x.shape != y.shape:
        raise ValueError(f"base_reduce: layouts {tuple(x.shape)} and "
                         f"{tuple(y.shape)} differ")
    nblk = _row_blocks("base_reduce", x)
    ctas, per_cta = _ctas(dev, nblk, per_sm=8)       # K1's split
    partials = torch.empty(ctas, dtype=torch.float32, device=dev)
    out = torch.empty((1, 1), dtype=torch.float32, device=dev)
    _launch("base_reduce", dev, x.data_ptr(), y.data_ptr(),
            _DTYPE_CODE[x.dtype], nblk, partials.data_ptr(), ctas, per_cta,
            out.data_ptr())
    return out


def base_relu(x: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """B2: each (8, 128) block → max(0, block), dtype kept."""
    dev = _checked_base("base_relu", (x,), _FLOATS + (torch.int32,))
    if out_dtype not in (None, x.dtype):
        raise TypeError(f"base_relu: keeps the dtype ({x.dtype}), asked for "
                        f"{out_dtype}")
    nblk = _row_blocks("base_relu", x)
    ctas, per_cta = _ctas(dev, nblk, per_sm=64)      # K2's split
    out = torch.empty_like(x)
    _launch("base_relu", dev, x.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[x.dtype], nblk, ctas, per_cta)
    return out


def base_gemm(a: torch.Tensor, b: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B3: C (m, n) = A (m, k) · B (k, n) over 128-wide k chunks, f32
    accumulator, cast to ``out_dtype`` once."""
    dev = _checked_base("base_gemm", (a, b), _FLOATS)
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2 or k % LANES or k == 0:
        raise ValueError(f"base_gemm: needs A (m, k) · B (k, n) with k a "
                         f"positive multiple of {LANES}, got {tuple(a.shape)}"
                         f" · {tuple(b.shape)}")
    if out_dtype not in _FLOATS:
        raise TypeError(f"base_gemm: drains to float32 or bfloat16, asked "
                        f"for {out_dtype}")
    if m == 0 or n == 0:
        raise ValueError(f"base_gemm: empty output ({m}, {n})")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    # 16-byte loads where A and B are f32 and every row starts aligned
    vec = 4 if (a.dtype == torch.float32
                and _vector_width((a, b), ()) == 4) else 1
    _launch("base_gemm", dev, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype], vec, m, n, k)
    return out


def base_gemv(a: torch.Tensor, x: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B4: y (m8, 1) f32, each 8-row panel of A times x (1, n), with x
    re-read from device memory for every panel."""
    dev = _checked_base("base_gemv", (a, x), _FLOATS)
    (m8, n) = a.shape
    if m8 % ROWS or m8 == 0 or n == 0 or tuple(x.shape) != (1, n):
        raise ValueError(f"base_gemv: needs A (m8, n) with m8 a positive "
                         f"multiple of {ROWS} and x (1, n), got "
                         f"{tuple(a.shape)} and {tuple(x.shape)}")
    if out_dtype != torch.float32:
        raise TypeError(f"base_gemv: writes float32, asked for {out_dtype}")
    out = torch.empty((m8, 1), dtype=torch.float32, device=dev)
    _launch("base_gemv", dev, a.data_ptr(), x.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[a.dtype], _vector_width((a, x), ()), m8 // ROWS, n)
    return out


#: Body op → the baseline kernel that runs it on the card.  Every wrapper
#: is called as ``kernel(*layouts, out_dtype=...)``, like the plain versions.
BASELINE_KERNELS: Dict[str, Callable[..., torch.Tensor]] = {
    "mul": base_reduce,
    "relu": base_relu,
    "dot": base_gemm,
    "matvec": base_gemv,
}


# -- plain versions ---------------------------------------------------------


def _step_blocks(geo: StreamGeometry,
                 layouts: Sequence[torch.Tensor]) -> list:
    if len(layouts) != len(geo.ins):
        raise ValueError(f"{len(geo.ins)} streams, got {len(layouts)} "
                         "operands")
    for k, (agu, t) in enumerate(zip(geo.ins, layouts)):
        agu.check_within(geo.grid, tuple(t.shape), f"in[{k}]")
    return [agu.gather(t, geo.grid) for agu, t in zip(geo.ins, layouts)]


def _write_blocks(geo: StreamGeometry, blocks: torch.Tensor,
                  out_dtype: torch.dtype, every: int = 1) -> torch.Tensor:
    """Scatter one block per ``every`` steps through the output stream."""
    out = torch.zeros(geo.out_shape, dtype=out_dtype, device=blocks.device)
    idx = geo.out.element_index(geo.grid, geo.out_shape, blocks.device)
    out.view(-1)[idx[::every]] = blocks.to(out_dtype)
    return out


def plain_reduce(body: Callable, geo: StreamGeometry,
                 layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
                 acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reduce epilogue: accumulate every step's partial, fold once → (1, 1).

    A block-shaped partial sums into a (rows, lanes) vector accumulator
    folded to the scalar at the end; a scalar partial into a (1, 1) one.
    """
    parts = torch.vmap(body)(*_step_blocks(geo, layouts)).to(out_dtype)
    shape = tuple(parts.shape[1:])
    vector = len(shape) == 2 and math.prod(shape) > 1
    acc = parts.reshape(geo.steps, *(shape if vector else (1, 1))).sum(0)
    return acc.sum().reshape(1, 1) if vector else acc


def plain_map(body: Callable, geo: StreamGeometry,
              layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
              acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Map epilogue: each step's body block → the dense write stream."""
    parts = torch.vmap(body)(*_step_blocks(geo, layouts))
    parts = parts.to(out_dtype).reshape(geo.steps, *geo.out.block)
    return _write_blocks(geo, parts, out_dtype)


def plain_contract(body: Callable, geo: StreamGeometry,
                   layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
                   acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Level-mapped epilogue: accumulate over the contraction steps, drain.

    The contraction axes trail the grid, so the visits of one output block
    are ``contraction_steps`` consecutive steps; their partials sum in
    ``acc_dtype`` and the sum is cast to ``out_dtype`` once.  Without
    contraction axes every step writes its own block.
    """
    parts = torch.vmap(body)(*_step_blocks(geo, layouts))
    if not geo.contraction_axes:
        parts = parts.to(out_dtype).reshape(geo.steps, *geo.out.block)
        return _write_blocks(geo, parts, out_dtype)
    z = geo.contraction_steps
    acc = parts.to(acc_dtype).reshape(-1, z, *geo.out.block).sum(1)
    return _write_blocks(geo, acc, out_dtype, every=z)


PLAIN: Dict[str, Callable[..., torch.Tensor]] = {
    "reduce": plain_reduce, "map": plain_map, "nest": plain_contract}


# -- plain versions of the baselines ------------------------------------------
#
# The reference's baseline bodies on the same padded layouts: the same
# (8, 128) blocks, 128-wide k chunks and 8-row panels, promoted to f32.


def _promote(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def plain_base_reduce(x: torch.Tensor, y: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Each (8, 128) block's Σ promote(x)·promote(y), summed → (1, 1)."""
    blocks = x.reshape(-1, ROWS * LANES), y.reshape(-1, ROWS * LANES)
    parts = (_promote(blocks[0]) * _promote(blocks[1])).sum(1)
    return parts.sum().reshape(1, 1).to(out_dtype)


def plain_base_map(fn: Callable, x: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``fn`` on each (8, 128) block, written in place of the block."""
    blocks = x.reshape(-1, ROWS, LANES)
    out = torch.vmap(fn)(blocks).reshape(x.shape)
    return out.to(out_dtype or x.dtype)


def plain_base_gemm(a: torch.Tensor, b: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """acc (m, n) += A[:, kc] · B[kc, :] over 128-wide k chunks, in f32."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    bk = min(a.shape[1], LANES)
    for k0 in range(0, a.shape[1], bk):
        acc += _promote(a[:, k0:k0 + bk]) @ _promote(b[k0:k0 + bk, :])
    return acc.to(out_dtype)


def plain_base_gemv(a: torch.Tensor, x: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Each 8-row panel of A times x (1, n)ᵀ → (m8, 1) f32."""
    panels = _promote(a).reshape(-1, ROWS, a.shape[1])
    return (panels @ _promote(x).mT).reshape(-1, 1).to(out_dtype)
