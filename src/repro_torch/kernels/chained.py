"""Fused producer→consumer kernels — stream chaining over the registry.

Every unfused composition pays the same tax: the producer kernel stores its
full result to device memory and the consumer streams it straight back in.
Chaining fuses the pair into ONE kernel whose intermediate stays on chip,
eliminating one store and one load per element.  Two fusion mechanisms, as
in ``repro.kernels.chained``:

* **nest reuse** (:class:`~repro_torch.kernels.frontend.NestKernel`) —
  ``gemv+relu`` shares the gemv nest; relu applies once to each drained
  output block, never to a k-tile partial.  On the card that is K4's relu
  drain (body op ``matvec_relu``), so no library relu runs after it;
* **nest-level chaining** (:func:`repro_torch.core.lowering.ssr_chain_call`)
  — ``sum_sq_diff`` (reduction-of-map) and ``axpy_dot`` go through the full
  compiler path: ``chain()`` unifies the producer's WRITE ref with the
  consumer's READ ref, ``lower_chain()`` emits the single fused grid, and
  the reduce epilogue uses the vectorised (rows, lanes) accumulator.  On the
  card they run as K5 ``chain_elem`` (``csrc/chain_elem.cu``).

Each registry entry exposes ``ssr`` = the fused kernel, ``baseline`` = the
honest unfused composition (the same streamed engine pinned to the default
schedule, intermediate through device memory), and ``ref`` = the PyTorch
oracle.  ``stencil1d_relu`` arrives with the stencils (port slice 4) and the
``cluster_*`` variants with the cluster (port slice 7).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..core import compiler
from ..core.compiler import LoopNest, MemRef
from ..core.lowering import (DEFAULT_POLICY, DEFAULT_SCHEDULE, ssr_call,
                             ssr_chain_call)
from ..core.ssr import KernelBody
from ..core.stream import Direction
from .frontend import BLOCK_ELEMS, NestKernel
from .gemv import matvec_block, ssr_gemv
from .registry import KernelEntry, register_kernel
from .relu import relu_block, ssr_relu


def _padded_blocks(n: int) -> Tuple[int, int]:
    """Padded 2-D (rows, lanes) layout of an n-element streamed vector."""
    steps = -(-n // BLOCK_ELEMS)
    return (steps * DEFAULT_POLICY.rows, DEFAULT_POLICY.lanes)


# --------------------------------------------------------------------------
# gemv + relu (nest-reuse fusion)
# --------------------------------------------------------------------------

#: The gemv body whose drain applies relu once per output block (K4's relu
#: drain on the card), never to a partial of the contraction.
MATVEC_RELU = KernelBody(matvec_block, "matvec_relu", drain=relu_block)

_gemv_relu = NestKernel(
    "gemv_relu",
    prepare=lambda a, x: ({"A": a, "x": x}, tuple(a.shape), None),
    nest=lambda static: compiler.gemv_nest(*static),
    body=lambda static: MATVEC_RELU)


def fused_gemv_relu(a: torch.Tensor, x: torch.Tensor, *, schedule=None,
                    device=None) -> torch.Tensor:
    """relu(A·x) as one kernel: relu rides the accumulator's drain."""
    return _gemv_relu(a, x, schedule=schedule, device=device)


def unfused_gemv_relu(a: torch.Tensor, x: torch.Tensor, *,
                      device=None) -> torch.Tensor:
    """The two-kernel composition: A·x round-trips through device memory.

    Pinned to the default schedule, like every fused/unfused pair, so
    fusion is the only variable.
    """
    return ssr_relu(ssr_gemv(a, x, device=device),
                    schedule=DEFAULT_SCHEDULE, device=device)


# --------------------------------------------------------------------------
# sum_sq_diff: reduction-of-map through the full chain() compiler path
# --------------------------------------------------------------------------


def _chain_nests(n: int, consumer_reads_w: bool) -> Tuple[LoopNest, LoopNest]:
    """Producer writes the dense intermediate T; consumer reads it back."""
    producer = LoopNest(
        bounds=(n,),
        refs=(MemRef("X", Direction.READ, (1,)),
              MemRef("Y", Direction.READ, (1,)),
              MemRef("T", Direction.WRITE, (1,))),
        compute_per_level=(2,))
    consumer_refs = [MemRef("T", Direction.READ, (1,))]
    if consumer_reads_w:
        consumer_refs.append(MemRef("W", Direction.READ, (1,)))
    consumer = LoopNest(bounds=(n,), refs=tuple(consumer_refs),
                        compute_per_level=(1,))
    return producer, consumer


def _map_nest(n: int, names: Tuple[str, ...], compute: int) -> LoopNest:
    return compiler.elementwise_nest(n, names, compute)


def _sq_diff(a, b):
    d = a - b
    return d * d


def _identity(t):
    return t


SQ_DIFF = KernelBody(_sq_diff, "sq_diff")
IDENTITY = KernelBody(_identity, "identity")


def fused_sum_sq_diff(x: torch.Tensor, y: torch.Tensor, *, schedule=None,
                      device=None) -> torch.Tensor:
    """Σ (x − y)² as one fused map→reduce kernel (vector accumulator).

    ``schedule=None`` pins the default geometry (the fused-vs-unfused
    like-for-like requirement); pass an explicit schedule to tune.
    """
    n = x.shape[0]
    return ssr_chain_call(_chain_nests(n, consumer_reads_w=False),
                          (SQ_DIFF, IDENTITY), {"X": x, "Y": y},
                          mode="reduce", schedule=schedule or DEFAULT_SCHEDULE,
                          device=device)


def unfused_sum_sq_diff(x: torch.Tensor, y: torch.Tensor, *,
                        device=None) -> torch.Tensor:
    """Two streamed kernels: (x−y)² materialised, then reduced."""
    n = x.shape[0]
    t = ssr_call(_map_nest(n, ("X", "Y"), 2), SQ_DIFF, {"X": x, "Y": y},
                 mode="map", schedule=DEFAULT_SCHEDULE, device=device)
    return ssr_call(_map_nest(n, ("T",), 1), IDENTITY, {"T": t},
                    mode="reduce", schedule=DEFAULT_SCHEDULE, device=device)


# --------------------------------------------------------------------------
# axpy → dot: (α·x + y) · w through the chain() compiler path
# --------------------------------------------------------------------------


def _axpy(a, b, alpha):
    return alpha * a + b


def axpy_block(alpha: float) -> KernelBody:
    """αx + y with α a parameter of the body: it keys the kernel caches
    and is passed to the kernel, so two α values never share an entry."""
    return KernelBody(_axpy, "axpy", params=(float(alpha),))


def _dot(t, w):
    return t * w


DOT = KernelBody(_dot, "mul")


def fused_axpy_dot(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
                   alpha: float = 1.0, schedule=None,
                   device=None) -> torch.Tensor:
    """(α·x + y)·w fused: the axpy result never leaves the chip.

    ``schedule=None`` pins the default geometry (see fused_sum_sq_diff).
    """
    n = x.shape[0]
    return ssr_chain_call(_chain_nests(n, consumer_reads_w=True),
                          (axpy_block(alpha), DOT),
                          {"X": x, "Y": y, "W": w}, mode="reduce",
                          schedule=schedule or DEFAULT_SCHEDULE,
                          device=device)


def unfused_axpy_dot(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
                     alpha: float = 1.0, device=None) -> torch.Tensor:
    """αx + y materialised (K5's map), then its dot with w (K1)."""
    n = x.shape[0]
    t = ssr_call(_map_nest(n, ("X", "Y"), 2), axpy_block(alpha),
                 {"X": x, "Y": y}, mode="map", schedule=DEFAULT_SCHEDULE,
                 device=device)
    return ssr_call(_map_nest(n, ("T", "W"), 1), DOT, {"T": t, "W": w},
                    mode="reduce", schedule=DEFAULT_SCHEDULE, device=device)


# --------------------------------------------------------------------------
# Fused-case table: tests, chip_smoke.py and the registry iterate this.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedCase:
    """One fused variant plus what the fusion audit needs.

    ``inter_type(*args)`` returns the (dtype, dims) of the padded 2-D
    buffer the *unfused* composition materialises for the intermediate.
    """

    name: str
    fused: Callable
    unfused: Callable
    ref: Callable
    example: Callable
    inter_type: Callable[..., Tuple[str, Tuple[int, ...]]]
    tol: Dict[str, float]


def _vector_inter(x, *rest, **kw) -> Tuple[str, Tuple[int, ...]]:
    return ("f32", _padded_blocks(x.shape[0]))


def _gemv_inter(a, x, **kw) -> Tuple[str, Tuple[int, ...]]:
    # the unfused relu stage pads the trimmed gemv result to whole blocks
    return ("f32", _padded_blocks(a.shape[0]))


def _f32(rng: np.random.Generator, *shape) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _mk_examples():
    def ex_gemv(rng, odd: bool = False):
        m, n = (60, 64) if odd else (64, 64)
        return (_f32(rng, m, n), _f32(rng, n)), {}

    def ex_ssd(rng, odd: bool = False):
        n = 5000 if odd else 4096
        return (_f32(rng, n), _f32(rng, n)), {}

    def ex_axpy(rng, odd: bool = False):
        n = 3000 if odd else 4096
        return (_f32(rng, n), _f32(rng, n), _f32(rng, n)), {"alpha": 0.5}

    return ex_gemv, ex_ssd, ex_axpy


def fused_cases() -> Tuple[FusedCase, ...]:
    from . import ref

    ex_gemv, ex_ssd, ex_axpy = _mk_examples()
    loose = {"rtol": 1e-3, "atol": 1e-3}
    reduce_tol = {"rtol": 1e-2, "atol": 1e-2}
    return (
        FusedCase("gemv_relu", fused_gemv_relu, unfused_gemv_relu,
                  ref.gemv_relu_ref, ex_gemv, _gemv_inter, loose),
        FusedCase("sum_sq_diff", fused_sum_sq_diff, unfused_sum_sq_diff,
                  ref.sum_sq_diff_ref, ex_ssd, _vector_inter, reduce_tol),
        FusedCase("axpy_dot", fused_axpy_dot, unfused_axpy_dot,
                  ref.axpy_dot_ref, ex_axpy, _vector_inter, reduce_tol),
    )


def _register(case: FusedCase) -> None:
    @register_kernel(case.name)
    def _entry() -> KernelEntry:
        return KernelEntry(name=case.name, ssr=case.fused,
                           baseline=case.unfused, ref=case.ref,
                           example=case.example, tol=dict(case.tol),
                           problem=f"fused chain: {case.name}")


for _case in fused_cases():
    _register(_case)
