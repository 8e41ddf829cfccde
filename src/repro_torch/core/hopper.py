"""The streamed emitter's Hopper kernels, and their plain PyTorch versions.

Each kernel runs one lowered SSR schedule — a grid plus the streams' affine
block walks (:class:`~repro_torch.core.agu.StreamGeometry`) — on the card:

==============  ===========  ===============================================
kernel          call mode    body op
==============  ===========  ===============================================
reduce_mul      reduce       ``mul``    (reduction: Fig. 4's dot product)
map_relu        map          ``relu``   (relu)
contract_gemm   nest         ``dot``    (gemm's C += A·B)
contract_gemv   nest         ``matvec`` (gemv's y += A·x)
==============  ===========  ===============================================

The kernels are CUDA C++ for ``sm_90a`` under ``repro_torch/csrc``, each
built by ``nvcc`` into a shared library with a plain C interface at first
use (into ``build/repro_torch/`` of the checkout, keyed on a hash of the
sources and flags) and bound with ``ctypes``.  A wrapper takes the prepared
layouts, checks what its kernel accepts and raises on anything else,
launches on PyTorch's current stream and counts the launch in
:data:`LAUNCHES`.  It never falls back to anything.

The plain versions (:func:`plain_reduce`, :func:`plain_map`,
:func:`plain_contract`) run the same lowered computation with any PyTorch
body: they gather every step's blocks through the same AGU programming,
apply the body to all steps at once (``torch.vmap``) and apply the
reference's epilogue — the vector accumulator fold, the dense map write, the
f32 contraction accumulator with its drain cast.  The CPU runs them; the
tests and ``chip_smoke.py`` hold each kernel against them.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Sequence

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
}

#: Wrapper calls per kernel since the last :func:`reset_launches`: one per
#: call that launched its kernel.  A ``reduce_mul`` call is two device
#: launches (the per-CTA partials, then the one-CTA fold); every other
#: kernel's call is one.
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
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
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


def _checked(name: str, geo: StreamGeometry,
             layouts: Sequence[torch.Tensor], n_in: int,
             dtypes: Sequence[torch.dtype]) -> torch.device:
    """Validate what every wrapper's kernel takes; return the device."""
    if len(layouts) != n_in:
        raise ValueError(f"{name}: takes {n_in} streams, got {len(layouts)}")
    dev = layouts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: launches on CUDA tensors, got {dev}")
    for k, (t, agu) in enumerate(zip(layouts, geo.ins)):
        if t.device != dev:
            raise ValueError(f"{name}: stream {k} on {t.device}, not {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: stream {k} has dtype {t.dtype}; the "
                            f"kernel takes {[str(d) for d in dtypes]}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: stream {k} needs a contiguous 2-D "
                             f"layout, got shape {tuple(t.shape)}")
        if math.prod(agu.block) >= 2 ** 31:
            raise ValueError(f"{name}: block {agu.block} has 2**31 or more "
                             "elements; the kernels index blocks in 32 bits")
        agu.check_within(geo.grid, tuple(t.shape), f"{name}[{k}]")
    if len({t.dtype for t in layouts}) != 1:
        raise TypeError(f"{name}: streams of mixed dtypes "
                        f"{[str(t.dtype) for t in layouts]}")
    if len(geo.out_shape) != 2:
        raise ValueError(f"{name}: output layout {geo.out_shape} is not 2-D")
    geo.out.check_within(geo.grid, geo.out_shape, f"{name}[out]")
    need = getattr(_lib(name), f"ssr_{name}_smem_bytes")()
    limit = _card(dev).shared_memory_per_block_optin
    if need > limit:
        raise ValueError(f"{name}: a CTA needs {need} bytes of shared memory, "
                         f"the card allows {limit}")
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


def _blocks_equal(name: str, *agus: BlockAGU) -> None:
    if len({a.block for a in agus}) != 1:
        raise ValueError(f"{name}: streams need one block shape, got "
                         f"{[a.block for a in agus]}")


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
    dev = _checked("reduce_mul", geo, layouts, 2,
                   (torch.float32, torch.bfloat16))
    if out_dtype != torch.float32:
        raise TypeError(f"reduce_mul: accumulates in float32, asked for "
                        f"{out_dtype}")
    _blocks_equal("reduce_mul", *geo.ins)
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
    dev = _checked("map_relu", geo, layouts, 1,
                   (torch.float32, torch.bfloat16, torch.int32))
    (x,) = layouts
    if out_dtype != x.dtype:
        raise TypeError(f"map_relu: keeps the dtype ({x.dtype}), asked for "
                        f"{out_dtype}")
    _blocks_equal("map_relu", geo.ins[0], geo.out)
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
              acc_dtype: torch.dtype, blocks_compose: bool, formula: str,
              vec_of: Callable[[], int]) -> torch.Tensor:
    dev = _checked(name, geo, layouts, 2, (torch.float32, torch.bfloat16))
    if not blocks_compose:
        raise ValueError(f"{name}: blocks {[a.block for a in geo.ins]} → "
                         f"{geo.out.block} do not compose as {formula}")
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
    (tm, tk), (tk2, tn) = geo.ins[0].block, geo.ins[1].block
    # A and B are read in 16-byte packs where they can be (f32 only)
    return _contract(
        "contract_gemm", geo, layouts, out_dtype, acc_dtype,
        (tk2, geo.out.block) == (tk, (tm, tn)), "C += A·B",
        lambda: 4 if layouts[0].dtype == torch.float32
        and _vector_width(layouts, geo.ins) == 4 else 1)


def contract_gemv(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                  out_dtype: torch.dtype,
                  acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K4: y block (1, tm) += A block (tm, tn) · x block (1, tn)ᵀ."""
    tm, tn = geo.ins[0].block
    # A is read in 16-byte packs where it can be; x is staged element-wise
    return _contract("contract_gemv", geo, layouts, out_dtype, acc_dtype,
                     (geo.ins[1].block, geo.out.block) == ((1, tn), (1, tm)),
                     "y += A·xᵀ",
                     lambda: _vector_width(layouts[:1], geo.ins[:1]))


#: (call mode, body op) → the kernel that runs it on the card.
DEVICE_KERNELS: Dict[tuple, Callable[..., torch.Tensor]] = {
    ("reduce", "mul"): reduce_mul,
    ("map", "relu"): map_relu,
    ("nest", "dot"): contract_gemm,
    ("nest", "matvec"): contract_gemv,
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
