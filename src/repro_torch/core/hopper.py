"""The Hopper kernels of the port, and their plain PyTorch versions.

The streamed kernels each run one lowered SSR schedule — a grid plus the
streams' affine block walks (:class:`~repro_torch.core.agu.StreamGeometry`):

================  ===========  =============================================
kernel            call mode    body op (stage ops of a fused chain or DAG)
================  ===========  =============================================
reduce_mul        reduce       ``mul``    (reduction: Fig. 4's dot product)
map_relu          map          ``relu``   (relu)
contract_gemm     nest         ``dot``    (gemm's C += A·B)
contract_gemv     nest         ``matvec`` (gemv's y += A·x); ``matvec_relu``
                               with its relu drain (the fused gemv_relu)
chain_elem        reduce, map  K5: ``(sq_diff, identity)``, ``(axpy, mul)``
                               fused; ``sq_diff``, ``axpy`` (map) and
                               ``identity`` (reduce) alone
dag_layernorm     map          K6: ``ln_centre``, ``ln_square``,
                               ``ln_normalise`` — all three, each alone,
                               and the last two
dag_softmax_xent  reduce, map  K7: ``sx_shift``, ``sx_exp``, ``sx_loss`` —
                               the same subsets (with ``sx_loss``: reduce)
dag_mlp           map          K8: ``mlp_hidden``, ``mlp_out``,
                               ``mlp_residual`` — the same subsets
================  ===========  =============================================

A fused kernel (K5–K8) is one template per family of stages, instantiated
for every subset a legal cut of its DAG can produce (:data:`_FAMILIES`): a
value whose producer runs in the subset stays on chip, any other comes
from its stream, and the subset's last stage writes its value.  Its wrapper
reads the stage program (:class:`~repro_torch.core.ssr.StageProgram`) to
find which stream carries which value.

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
:func:`plain_map`, :func:`plain_contract`, :func:`plain_stages`) run the
same lowered computation with any PyTorch bodies: they gather every step's
blocks through the same AGU programming, apply the body (or the stages in
order) to all steps at once (``torch.vmap``) and apply the reference's
epilogue — the vector accumulator fold, the dense map write, the f32
contraction accumulator with its drain.  Those of the
baselines (``plain_base_*``) run the baseline bodies' block walks on the
same padded layouts.  The CPU runs them; the tests and ``chip_smoke.py``
hold each kernel against them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import (Any, Callable, Dict, Iterable, NamedTuple, Optional,
                    Sequence, Tuple, Union)

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
    "chain_elem": {"replaces": "src/repro/core/lowering.py:1615",
                   "source": "src/repro_torch/csrc/chain_elem.cu"},
    "dag_layernorm": {"replaces": "src/repro/kernels/dag.py:88",
                      "source": "src/repro_torch/csrc/dag_layernorm.cu"},
    "dag_softmax_xent": {"replaces": "src/repro/kernels/dag.py:145",
                         "source": "src/repro_torch/csrc/dag_softmax_xent.cu"},
    "dag_mlp": {"replaces": "src/repro/kernels/dag.py:215",
                "source": "src/repro_torch/csrc/dag_mlp.cu"},
}

#: Wrapper calls per kernel since the last :func:`reset_launches`: one per
#: call that launched its kernel.  A call of ``reduce_mul``, ``base_reduce``,
#: or of a reduce of ``chain_elem`` or ``dag_softmax_xent``, is two device
#: launches (the per-CTA partials, then the one-CTA fold); every other
#: kernel's call is one.  K4's relu drain counts as ``contract_gemv``.
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
    """Where the built library of ``name`` lives, keyed on its inputs: its
    source, every shared header and the flags."""
    h = hashlib.sha256()
    for f in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(f.name.encode())
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
    "contract_gemv": [_P, _P, _P, _I, _I, _I, _GP, _SP, _SP, _SP, _I64, _I,
                      _P],
    "base_reduce": [_P, _P, _I, _I64, _P, _I64, _I64, _P, _P],
    "base_relu": [_P, _P, _I, _I64, _I64, _I64, _P],
    "base_gemm": [_P, _P, _P, _I, _I, _I, _I64, _I64, _I64, _P],
    "base_gemv": [_P, _P, _P, _I, _I, _I64, _I64, _P],
    "chain_elem": [_I, _P, _P, _P, _P, ctypes.c_float, _I, _GP, _SP, _SP,
                   _SP, _SP, _P, _I64, _I64, _P],
    "dag_layernorm": [_I, _P, _P, _P, _P, _I, _GP, _SP, _SP, _SP, _SP, _I64,
                      _I64, _P],
    "dag_softmax_xent": [_I, _P, _P, _P, _P, _P, _P, _I, _GP, _SP, _SP, _SP,
                         _SP, _SP, _I64, _I64, _P],
    "dag_mlp": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _GP, _SP, _SP, _SP,
                _SP, _I64, _P],
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
    "contract_gemv_relu": (2, _FLOATS, "y = relu(Σ A·xᵀ)", _gemv_composes),
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
    return _smem_refusal(_LIB_OF.get(name, name), dev) \
        if dev.type == "cuda" else None


#: Wrappers that launch another wrapper's library.
_LIB_OF = {"contract_gemv_relu": "contract_gemv"}


def accepts(op: tuple, geo: StreamGeometry, dtype: torch.dtype,
            device: Union[str, torch.device],
            program: Optional[Any] = None) -> Tuple[bool, str]:
    """(takes, reason): whether the streamed kernel of ``op`` — a (call
    mode, body op or tuple of stage ops) pair of :data:`DEVICE_KERNELS` —
    takes this geometry at this input dtype on ``device``, running
    ``program`` (a :class:`~repro_torch.core.ssr.StageProgram`; the stage
    kernels need it).  The wrappers refuse exactly what this refuses; the
    autotuners filter their candidates with it.  On a CUDA device the
    shared-memory check builds the kernel."""
    kernel = DEVICE_KERNELS.get(op)
    if kernel is None:
        return False, f"no Hopper kernel for {op}"
    name, dev = kernel.__name__, torch.device(device)
    if name in _TAKES:
        reason = _program_refusal(name, program) or \
            _refusal(name, geo, dtype, dev)
    else:
        reason = _stage_refusal(name, program, geo, dtype, dev)
    return reason is None, reason or "ok"


def _program_refusal(name: str, program: Optional[Any]) -> Optional[str]:
    """A single-op kernel of slices 1-2 runs one body over its streams in
    order, with no parameters, permutation or uniforms."""
    if program is not None and not program.plain:
        return (f"{name}: runs one body over its streams in order; the "
                "program has uniforms, parameters or a permutation")
    return None


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
             layouts: Sequence[torch.Tensor],
             program: Optional[Any] = None) -> torch.device:
    """Validate what every streamed wrapper's kernel takes; return the
    device."""
    reason = _program_refusal(name, program)
    if reason is not None:
        raise ValueError(reason)
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
               acc_dtype: torch.dtype = torch.float32,
               program: Optional[Any] = None) -> torch.Tensor:
    """K1: Σ promote(a)·promote(b) over every step → (1, 1) f32."""
    dev = _checked("reduce_mul", geo, layouts, program)
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
             acc_dtype: torch.dtype = torch.float32,
             program: Optional[Any] = None) -> torch.Tensor:
    """K2: each step's block → max(0, block) through the dense out map."""
    dev = _checked("map_relu", geo, layouts, program)
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
              acc_dtype: torch.dtype, vec_of: Callable[[], int],
              program: Optional[Any], *extra) -> torch.Tensor:
    dev = _checked(name, geo, layouts, program)
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
            geo.contraction_steps, *extra)
    return out


def contract_gemm(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                  out_dtype: torch.dtype,
                  acc_dtype: torch.dtype = torch.float32,
                  program: Optional[Any] = None) -> torch.Tensor:
    """K3: C block (tm, tn) += A block (tm, tk) · B block (tk, tn)."""
    # A and B are read in 16-byte packs where they can be (f32 only)
    return _contract(
        "contract_gemm", geo, layouts, out_dtype, acc_dtype,
        lambda: 4 if layouts[0].dtype == torch.float32
        and _vector_width(layouts, geo.ins) == 4 else 1, program)


def contract_gemv(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                  out_dtype: torch.dtype,
                  acc_dtype: torch.dtype = torch.float32,
                  program: Optional[Any] = None, *,
                  relu: bool = False) -> torch.Tensor:
    """K4: y block (1, tm) += A block (tm, tn) · x block (1, tn)ᵀ; with
    ``relu`` the drain writes max(0, y) (selected, as K2 does), once per
    output block, never to a partial."""
    # A is read in 16-byte packs where it can be; x is staged element-wise
    return _contract("contract_gemv", geo, layouts, out_dtype, acc_dtype,
                     lambda: _vector_width(layouts[:1], geo.ins[:1]),
                     program, int(relu))


def contract_gemv_relu(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                       out_dtype: torch.dtype,
                       acc_dtype: torch.dtype = torch.float32,
                       program: Optional[Any] = None) -> torch.Tensor:
    """K4 with its relu drain: y = max(0, A·x) (``matvec_relu``)."""
    return contract_gemv(geo, layouts, out_dtype, acc_dtype, program,
                         relu=True)


# -- the stage kernels: fused chains and DAGs ----------------------------------
#
# A CUDA kernel cannot take the stage bodies, so each family of stages is one
# kernel source, a template over the subset of the family's stages it runs.
# A family names its stages (body ops), the values each stage reads (the
# family's inputs, or another stage's product) and its uniforms.  Within a
# subset a value whose producer runs there stays on chip; any other value
# comes from a stream; the subset's last stage writes its value through the
# map epilogue (a dense intermediate in device memory) or, for the family's
# final stage, through the family's epilogue.


@dataclasses.dataclass(frozen=True)
class _Family:
    """The stages one fused kernel runs: their body ops, the values each
    reads (the family's inputs or another stage's product), what each
    produces, the final stage's call mode, the subsets instantiated, the
    uniforms' shapes, each stage's number of parameters, and the lane
    width its bodies assume (``None``: any).  ``code`` tells apart two
    families of one kernel."""

    kernel: str
    stages: Tuple[str, ...]
    args: Tuple[Tuple[str, ...], ...]
    products: Tuple[str, ...]
    final_mode: str
    subsets: Tuple[Tuple[int, ...], ...]
    code: int = 0
    uniforms: Tuple[Tuple[int, int], ...] = ()
    params: Tuple[int, ...] = (0, 0, 0)
    lanes: Optional[int] = None

    def mode_of(self, subset: Tuple[int, ...]) -> str:
        return self.final_mode if subset[-1] == len(self.stages) - 1 \
            else "map"


_CHAIN_ELEM = (
    _Family("chain_elem", ("sq_diff", "identity"), (("X", "Y"), ("T",)),
            ("T", "S"), "reduce", ((0, 1), (0,), (1,)), code=0,
            params=(0, 0)),
    _Family("chain_elem", ("axpy", "mul"), (("X", "Y"), ("T", "W")),
            ("T", "S"), "reduce", ((0, 1), (0,)), code=1, params=(1, 0)),
)
_DAG_SUBSETS = ((0, 1, 2), (0,), (1,), (2,), (1, 2))
_LAYERNORM = _Family(
    "dag_layernorm", ("ln_centre", "ln_square", "ln_normalise"),
    (("X",), ("C",), ("C", "V")), ("C", "V", "Y"), "map", _DAG_SUBSETS,
    lanes=128)
_SOFTMAX_XENT = _Family(
    "dag_softmax_xent", ("sx_shift", "sx_exp", "sx_loss"),
    (("Z",), ("C",), ("C", "E", "P")), ("C", "E", "L"), "reduce",
    _DAG_SUBSETS, lanes=128)
_MLP = _Family(
    "dag_mlp", ("mlp_hidden", "mlp_out", "mlp_residual"),
    (("X",), ("H",), ("H", "Y")), ("H", "Y", "O"), "map", _DAG_SUBSETS,
    uniforms=((128, 128), (1, 128), (128, 128), (1, 128)), lanes=128)
_FAMILIES: Tuple[_Family, ...] = (*_CHAIN_ELEM, _LAYERNORM, _SOFTMAX_XENT,
                                  _MLP)


class _Resolved(NamedTuple):
    """A program matched against its family: the stage bit mask, the
    stream each value read from device memory comes from, and the
    parameters."""

    family: _Family
    mask: int
    streams: Dict[str, int]
    params: Tuple[float, ...]


def _resolve(name: str, program: Optional[Any]) -> _Resolved:
    """Match ``program`` to a family of kernel ``name``; ValueError with
    the reason when it is none of the kernel's instantiations."""
    if program is None:
        raise ValueError(f"{name}: runs a stage program; none was given")
    for fam in _FAMILIES:
        if fam.kernel != name or not all(op in fam.stages
                                         for op in program.ops):
            continue
        idx = tuple(fam.stages.index(op) for op in program.ops)
        if idx not in fam.subsets:
            have = [tuple(fam.stages[i] for i in sub) for sub in fam.subsets]
            raise ValueError(f"{name}: stages {program.ops} are no "
                             f"instantiation of {fam.stages}; it has {have}")
        if program.mode != fam.mode_of(idx):
            raise ValueError(f"{name}: stages {program.ops} run in "
                             f"{fam.mode_of(idx)} mode, not {program.mode}")
        if program.n_uniform != len(fam.uniforms):
            raise ValueError(f"{name}: takes {len(fam.uniforms)} uniforms, "
                             f"the program has {program.n_uniform}")
        streams: Dict[str, int] = {}
        params: Tuple[float, ...] = ()
        for k, s in enumerate(idx):
            want = fam.args[s]
            got = program.canonical(k)[:len(program.sources[k])]
            if len(got) != len(want):
                raise ValueError(f"{name}: stage {fam.stages[s]} takes "
                                 f"{len(want)} blocks, the program passes "
                                 f"{len(got)}")
            for value, (kind, j) in zip(want, got):
                producer = fam.products.index(value) \
                    if value in fam.products else None
                if kind == "stage":
                    if producer is None or idx[j] != producer:
                        raise ValueError(
                            f"{name}: stage {fam.stages[s]} reads {value} "
                            f"from stage {program.ops[j]}, which does not "
                            "produce it")
                elif producer is not None and producer in idx:
                    raise ValueError(
                        f"{name}: stage {fam.stages[s]} reads {value} from "
                        f"a stream while its producer "
                        f"{fam.stages[producer]} runs in the kernel")
                else:
                    streams.setdefault(value, j)
            p = program.params[k] if program.params else ()
            if len(p) != fam.params[s]:
                raise ValueError(f"{name}: stage {fam.stages[s]} takes "
                                 f"{fam.params[s]} parameters, got {p}")
            params += tuple(float(v) for v in p)
        return _Resolved(fam, sum(1 << s for s in idx), streams, params)
    raise ValueError(f"{name}: no family of this kernel runs stages "
                     f"{program.ops}")


def _stage_refusal(name: str, program: Optional[Any], geo: StreamGeometry,
                   dtype: torch.dtype, dev: torch.device) -> Optional[str]:
    """Why stage kernel ``name`` refuses this program and geometry at
    ``dtype``, or None.  Every stream's block is the policy block (the
    stages' values are elementwise on it); a family that works on rows
    takes 128-wide blocks, one data row per block row; uniforms are whole
    arrays of the family's shapes."""
    try:
        res = _resolve(name, program)
    except ValueError as e:
        return str(e)
    if dtype != torch.float32:
        return f"{name}: takes float32, not {dtype}"
    if len(geo.grid) > SSR_MAX_AXES:
        return f"{name}: grid {geo.grid} has more than {SSR_MAX_AXES} axes"
    n_s = program.n_streams
    if len(geo.ins) != n_s + program.n_uniform:
        return (f"{name}: the program has {n_s} streams and "
                f"{program.n_uniform} uniforms, the schedule "
                f"{len(geo.ins)} read streams")
    blocks = {a.block for a in geo.ins[:n_s]}
    if program.mode == "map":
        blocks.add(geo.out.block)
    elif geo.out.block != (1, 1):
        return f"{name}: a reduce writes one (1, 1) block, not {geo.out.block}"
    if len(blocks) != 1 or len(next(iter(blocks))) != 2:
        return (f"{name}: every stream needs one 2-D block shape, got "
                f"{sorted(blocks)}")
    (block,) = blocks
    if math.prod(block) >= 2 ** 31:
        return (f"{name}: block {block} has 2**31 or more elements; the "
                "kernels index blocks in 32 bits")
    lanes = res.family.lanes
    if lanes is not None and block[1] != lanes:
        return (f"{name}: the {res.family.stages} bodies work on rows of "
                f"{lanes} (one data row per block row); the schedule's "
                f"blocks are {block}")
    for a, want in zip(geo.ins[n_s:], res.family.uniforms):
        if a.block != want or any(any(c) for c in a.coeffs):
            return (f"{name}: uniform block {a.block} is not the whole "
                    f"{want} array at every step")
    if len(geo.out_shape) != 2:
        return f"{name}: output layout {geo.out_shape} is not 2-D"
    return _smem_refusal(name, dev) if dev.type == "cuda" else None


def _checked_stages(name: str, geo: StreamGeometry,
                    layouts: Sequence[torch.Tensor],
                    program: Optional[Any]) -> Tuple[torch.device,
                                                     _Resolved]:
    """Validate what a stage kernel takes; return the device and the
    program matched to its family."""
    from .ssr import LoweringError

    dev = _checked_operands(name, layouts, (torch.float32,))
    reason = _stage_refusal(name, program, geo, layouts[0].dtype, dev)
    if reason is not None:      # a schedule the kernel does not take
        raise LoweringError(reason)
    for k, (t, agu) in enumerate(zip(layouts, geo.ins)):
        agu.check_within(geo.grid, tuple(t.shape), f"{name}[{k}]")
    geo.out.check_within(geo.grid, geo.out_shape, f"{name}[out]")
    return dev, _resolve(name, program)


def _value_streams(res: _Resolved, names: Sequence[str], geo: StreamGeometry,
                   layouts: Sequence[torch.Tensor]) -> list:
    """(pointer, stream argument) of each named value, in ``names`` order;
    a value kept on chip (or not read) gets a null pointer and the first
    stream's walk."""
    out = []
    for v in names:
        j = res.streams.get(v)
        if j is None:
            out.append((None, _stream_arg(geo.ins[0], layouts[0])))
        else:
            out.append((layouts[j].data_ptr(),
                        _stream_arg(geo.ins[j], layouts[j])))
    return out


def _stage_vec(res: _Resolved, geo: StreamGeometry,
               layouts: Sequence[torch.Tensor], out: torch.Tensor,
               mode: str, n_streams: int) -> int:
    """4 when every stream the kernel reads, every uniform and a map's
    output allow 16-byte accesses, else 1 (f32 only)."""
    used = sorted(set(res.streams.values()))
    tensors = [layouts[j] for j in used] + list(layouts[n_streams:])
    agus = [geo.ins[j] for j in used] + list(geo.ins[n_streams:])
    if mode == "map":
        tensors.append(out)
    return _vector_width(tensors, agus)


def _stage_out(geo: StreamGeometry, dev: torch.device, mode: str,
               ctas: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The output (and per-CTA partials of a reduce) of a stage kernel."""
    out = torch.empty(geo.out_shape, dtype=torch.float32, device=dev)
    if mode == "reduce":
        return out, torch.empty(ctas, dtype=torch.float32, device=dev)
    return out, None


def _f32_out(name: str, out_dtype: torch.dtype) -> None:
    if out_dtype != torch.float32:
        raise TypeError(f"{name}: writes float32, asked for {out_dtype}")


def chain_elem(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
               out_dtype: torch.dtype, acc_dtype: torch.dtype = torch.float32,
               program: Optional[Any] = None) -> torch.Tensor:
    """K5: the elementwise chains: Σ (x − y)², Σ (αx + y)·w fused (the
    intermediate in registers), their map producers (x − y)² and αx + y,
    and Σ t, over the streams' AGU walks."""
    dev, res = _checked_stages("chain_elem", geo, layouts, program)
    _f32_out("chain_elem", out_dtype)
    prog = {(0, 3): 0, (1, 3): 1, (0, 1): 2, (1, 1): 3, (0, 2): 4}[
        (res.family.code, res.mask)]
    ctas, per_cta = _ctas(dev, geo.steps, per_sm=8 if program.mode ==
                          "reduce" else 64)
    out, partials = _stage_out(geo, dev, program.mode, ctas)
    (pa, sa), (pb, sb), (pc, sc) = _value_streams(
        res, ("X", "Y", "W") if prog != 4 else ("T", "Y", "W"), geo,
        layouts)
    so = _stream_arg(geo.out, out)
    vec = _stage_vec(res, geo, layouts, out, program.mode,
                     program.n_streams)
    g = _grid_arg(geo.grid)
    _launch("chain_elem", dev, prog, pa, pb, pc, out.data_ptr(),
            res.params[0] if res.params else 0.0, vec, ctypes.byref(g),
            ctypes.byref(sa), ctypes.byref(sb), ctypes.byref(sc),
            ctypes.byref(so),
            partials.data_ptr() if partials is not None else None, ctas,
            per_cta)
    return out


def dag_layernorm(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                  out_dtype: torch.dtype,
                  acc_dtype: torch.dtype = torch.float32,
                  program: Optional[Any] = None) -> torch.Tensor:
    """K6: layernorm's diamond x → {C = x − μ, V = C²} → C·rsqrt(mean V + ε)
    on 128-wide rows, any subset of its stages, one warp per row."""
    dev, res = _checked_stages("dag_layernorm", geo, layouts, program)
    _f32_out("dag_layernorm", out_dtype)
    ctas, per_cta = _ctas(dev, geo.steps, per_sm=8)
    out, _ = _stage_out(geo, dev, "map", ctas)
    (px, sx), (pc, sc), (pv, sv) = _value_streams(res, ("X", "C", "V"),
                                                  geo, layouts)
    g, so = _grid_arg(geo.grid), _stream_arg(geo.out, out)
    _launch("dag_layernorm", dev, res.mask, px, pc, pv, out.data_ptr(),
            _stage_vec(res, geo, layouts, out, "map", program.n_streams),
            ctypes.byref(g), ctypes.byref(sx), ctypes.byref(sc),
            ctypes.byref(sv), ctypes.byref(so), ctas, per_cta)
    return out


def dag_softmax_xent(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
                     out_dtype: torch.dtype,
                     acc_dtype: torch.dtype = torch.float32,
                     program: Optional[Any] = None) -> torch.Tensor:
    """K7: softmax cross-entropy's diamond z → {C = z − max, E = eᶜ} →
    Σ mask·(lse − p·C) on 128-wide rows, any subset of its stages; the
    loss is folded from per-CTA partials in a fixed order."""
    dev, res = _checked_stages("dag_softmax_xent", geo, layouts, program)
    _f32_out("dag_softmax_xent", out_dtype)
    ctas, per_cta = _ctas(dev, geo.steps, per_sm=8)
    out, partials = _stage_out(geo, dev, program.mode, ctas)
    (pz, sz), (pc, sc), (pe, se), (pp, sp) = _value_streams(
        res, ("Z", "C", "E", "P"), geo, layouts)
    g, so = _grid_arg(geo.grid), _stream_arg(geo.out, out)
    _launch("dag_softmax_xent", dev, res.mask, pz, pc, pe, pp,
            out.data_ptr(),
            partials.data_ptr() if partials is not None else None,
            _stage_vec(res, geo, layouts, out, program.mode,
                       program.n_streams),
            ctypes.byref(g), ctypes.byref(sz), ctypes.byref(sc),
            ctypes.byref(se), ctypes.byref(sp), ctypes.byref(so), ctas,
            per_cta)
    return out


def dag_mlp(geo: StreamGeometry, layouts: Sequence[torch.Tensor],
            out_dtype: torch.dtype, acc_dtype: torch.dtype = torch.float32,
            program: Optional[Any] = None) -> torch.Tensor:
    """K8: the MLP block's diamond x → H = relu(xW₁ + b₁) → {Y = HW₂ + b₂,
    Y + H} on 128-wide rows, any subset of its stages, in FP32 FMA; W₁ and
    W₂ (uniforms) staged in shared memory once per CTA."""
    dev, res = _checked_stages("dag_mlp", geo, layouts, program)
    _f32_out("dag_mlp", out_dtype)
    out, _ = _stage_out(geo, dev, "map", 0)
    (px, sx), (ph, sh), (py, sy) = _value_streams(res, ("X", "H", "Y"), geo,
                                                  layouts)
    w1, b1, w2, b2 = layouts[program.n_streams:]
    rows = geo.steps * geo.out.block[0]      # 128-row tiles, persistent CTAs
    ctas = min(-(-rows // 128), _card(dev).multi_processor_count)
    g, so = _grid_arg(geo.grid), _stream_arg(geo.out, out)
    _launch("dag_mlp", dev, res.mask, px, ph, py, w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            _stage_vec(res, geo, layouts, out, "map", program.n_streams),
            ctypes.byref(g), ctypes.byref(sx), ctypes.byref(sh),
            ctypes.byref(sy), ctypes.byref(so), ctas)
    return out


def _stage_keys(fam: _Family, wrapper: Callable) -> Dict[tuple, Callable]:
    """The DEVICE_KERNELS entries of one family: one per instantiated
    subset, a single stage under its op, several under their tuple."""
    keys = {}
    for sub in fam.subsets:
        ops = tuple(fam.stages[i] for i in sub)
        keys[(fam.mode_of(sub), ops[0] if len(ops) == 1 else ops)] = wrapper
    return keys


#: (call mode, body op — or the tuple of stage ops of a fused chain or DAG)
#: → the kernel that runs it on the card.
DEVICE_KERNELS: Dict[tuple, Callable[..., torch.Tensor]] = {
    ("reduce", "mul"): reduce_mul,
    ("map", "relu"): map_relu,
    ("nest", "dot"): contract_gemm,
    ("nest", "matvec"): contract_gemv,
    ("nest", "matvec_relu"): contract_gemv_relu,
    **_stage_keys(_CHAIN_ELEM[0], chain_elem),
    **_stage_keys(_CHAIN_ELEM[1], chain_elem),
    **_stage_keys(_LAYERNORM, dag_layernorm),
    **_stage_keys(_SOFTMAX_XENT, dag_softmax_xent),
    **_stage_keys(_MLP, dag_mlp),
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


def _invariant_block(agu: BlockAGU, t: torch.Tensor) -> torch.Tensor:
    """The one block a walk with no varying coefficient delivers."""
    return t[tuple(slice(o * b, (o + 1) * b)
                   for o, b in zip(agu.offset, agu.block))]


def _step_inputs(geo: StreamGeometry,
                 layouts: Sequence[torch.Tensor]) -> Tuple[list, tuple]:
    """Every step's blocks of each stream, and their ``vmap`` dims.

    A stream whose walk has no varying coefficient (a loop-invariant block,
    a uniform) delivers the same block at every step: it is passed once,
    unbatched (dim ``None``), not gathered ``steps`` times.
    """
    if len(layouts) != len(geo.ins):
        raise ValueError(f"{len(geo.ins)} streams, got {len(layouts)} "
                         "operands")
    for k, (agu, t) in enumerate(zip(geo.ins, layouts)):
        agu.check_within(geo.grid, tuple(t.shape), f"in[{k}]")
    fixed = [not any(any(c) for c in agu.coeffs) for agu in geo.ins]
    if all(fixed):        # vmap needs one batched input
        fixed[0] = False
    blocks = [_invariant_block(agu, t) if f else agu.gather(t, geo.grid)
              for agu, t, f in zip(geo.ins, layouts, fixed)]
    return blocks, tuple(None if f else 0 for f in fixed)


def _step_blocks(geo: StreamGeometry,
                 layouts: Sequence[torch.Tensor]) -> list:
    """Every step's blocks of each stream, gathered ``(steps, *block)``."""
    blocks, dims = _step_inputs(geo, layouts)
    return [b.expand(geo.steps, *b.shape) if d is None else b
            for b, d in zip(blocks, dims)]


def _each_step(fn: Callable, geo: StreamGeometry,
               layouts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``fn`` applied to every step's blocks at once: (steps, *partial)."""
    blocks, dims = _step_inputs(geo, layouts)
    return torch.vmap(fn, in_dims=dims)(*blocks)


def _write_blocks(geo: StreamGeometry, blocks: torch.Tensor,
                  out_dtype: torch.dtype, every: int = 1) -> torch.Tensor:
    """Scatter one block per ``every`` steps through the output stream."""
    out = torch.zeros(geo.out_shape, dtype=out_dtype, device=blocks.device)
    idx = geo.out.element_index(geo.grid, geo.out_shape, blocks.device)
    out.view(-1)[idx[::every]] = blocks.to(out_dtype)
    return out


def _reduce_epilogue(parts: torch.Tensor, geo: StreamGeometry,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Accumulate every step's partial, fold once → (1, 1).

    A block-shaped partial sums into a (rows, lanes) vector accumulator
    folded to the scalar at the end; a scalar partial into a (1, 1) one.
    """
    parts = parts.to(out_dtype)
    shape = tuple(parts.shape[1:])
    vector = len(shape) == 2 and math.prod(shape) > 1
    acc = parts.reshape(geo.steps, *(shape if vector else (1, 1))).sum(0)
    return acc.sum().reshape(1, 1) if vector else acc


def _map_epilogue(parts: torch.Tensor, geo: StreamGeometry,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Each step's block → the dense write stream."""
    parts = parts.to(out_dtype).reshape(geo.steps, *geo.out.block)
    return _write_blocks(geo, parts, out_dtype)


def plain_reduce(body: Callable, geo: StreamGeometry,
                 layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
                 acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reduce epilogue: accumulate every step's partial, fold once → (1, 1)
    (see :func:`_reduce_epilogue`)."""
    return _reduce_epilogue(_each_step(body, geo, layouts), geo, out_dtype)


def plain_map(body: Callable, geo: StreamGeometry,
              layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
              acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Map epilogue: each step's body block → the dense write stream."""
    return _map_epilogue(_each_step(body, geo, layouts), geo, out_dtype)


def plain_contract(body: Callable, geo: StreamGeometry,
                   layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
                   acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Level-mapped epilogue: accumulate over the contraction steps, drain.

    The contraction axes trail the grid, so the visits of one output block
    are ``contraction_steps`` consecutive steps; their partials sum in
    ``acc_dtype``, the body's ``drain`` (if any) applies to each sum once,
    and the result is cast to ``out_dtype``.  Without contraction axes every
    step writes its own block.
    """
    parts = _each_step(body, geo, layouts)
    drain = getattr(body, "drain", None) or (lambda t: t)
    if not geo.contraction_axes:
        parts = drain(parts).to(out_dtype).reshape(geo.steps, *geo.out.block)
        return _write_blocks(geo, parts, out_dtype)
    z = geo.contraction_steps
    acc = parts.to(acc_dtype).reshape(-1, z, *geo.out.block).sum(1)
    return _write_blocks(geo, drain(acc), out_dtype, every=z)


def plain_stages(bodies: Sequence[Callable], program: StageProgram,
                 mode: str, geo: StreamGeometry,
                 layouts: Sequence[torch.Tensor], out_dtype: torch.dtype,
                 acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A stage program's plain version: on every step's blocks at once, run
    the stages in order — each carried value cast to ``out_dtype`` and
    shaped as the policy block, as the reference writes it to its scratch
    slot — and apply the final stage's map or reduce epilogue."""
    n_s = program.n_streams

    def step(*xs):
        uni = xs[n_s:]
        vals: list = []
        for k, body in enumerate(bodies):
            args = [vals[j] if kind == "stage" else xs[j]
                    for kind, j in program.sources[k]]
            cur = body(*args, *uni)
            if k < len(bodies) - 1:
                cur = torch.as_tensor(cur).to(out_dtype).reshape(
                    program.block)
            vals.append(cur)
        return vals[-1]

    parts = _each_step(step, geo, layouts)
    if mode == "reduce":
        return _reduce_epilogue(parts, geo, out_dtype)
    if mode == "map":
        return _map_epilogue(parts, geo, out_dtype)
    raise ValueError(f"stage programs run in map or reduce mode, not {mode!r}")


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
