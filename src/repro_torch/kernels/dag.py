"""Fused-DAG kernels — multi-consumer chaining over the registry.

The linear chains in :mod:`repro_torch.kernels.chained` fuse one producer
into one consumer.  Real pre/post-processing blocks are *DAGs*:
layernorm's centred input feeds both the variance pass and the final
normalise, and an MLP's activation feeds both the second matmul and the
residual add.  :func:`repro_torch.core.lowering.ssr_dag_call` fuses the
whole graph into ONE kernel — every intermediate stays on chip, a diamond
costs no round trip through device memory.

Three kernels ride the path, each a three-stage diamond over rows of
``DEFAULT_POLICY.lanes`` (= 128) elements, each one Hopper kernel source
(a template over the subset of its stages; ``core/hopper.py``):

* ``layernorm``     — x → {centre, square} → normalise           (map, K6)
* ``softmax_xent``  — z → {shift, exp} → masked row loss         (reduce, K7)
* ``mlp_block``     — x → relu(xW₁+b₁) → {xW₂+b₂, residual add}  (map, K8)

Per-row reductions (mean, max, logsumexp) work because a streamed ``(n,)``
vector with ``n`` a multiple of 128 lays out as one data row per block row
— the bodies assume the 128-lane block policy, and the kernels refuse any
other.

Each registry entry exposes ``ssr`` = the fused DAG, ``baseline`` = the
honest unfused composition (every intermediate through device memory,
schedules pinned to the default so fusion is the only variable), and
``ref`` = the PyTorch oracle.  :func:`dag_cases` also hands out the raw
``(nests, bodies, operands, mode, uniforms)`` spec, so ``autotune_dag`` can
search cuts of exactly the graph the fused kernel executes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..core import compiler
from ..core.compiler import LoopNest, MemRef
from ..core.lowering import (DEFAULT_POLICY, DEFAULT_SCHEDULE, ssr_call,
                             ssr_dag_call)
from ..core.ssr import KernelBody
from ..core.stream import Direction
from .frontend import BLOCK_ELEMS
from .registry import KernelEntry, register_kernel
from .relu import relu_block

LANES = DEFAULT_POLICY.lanes  # data-row width every body assumes
EPS = 1e-5


def _padded_blocks(n: int) -> Tuple[int, int]:
    """Padded 2-D (rows, lanes) layout of an n-element streamed vector."""
    steps = -(-n // BLOCK_ELEMS)
    return (steps * DEFAULT_POLICY.rows, DEFAULT_POLICY.lanes)


def _rows_of(x: torch.Tensor) -> int:
    if x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(
            f"dag kernels stream rows of exactly {LANES} elements; got "
            f"shape {tuple(x.shape)}")
    return x.shape[0]


def _dag_nests(n: int,
               stages: Tuple[Tuple[Tuple[str, ...], Tuple[str, ...], int],
                             ...]) -> Tuple[LoopNest, ...]:
    """Flat (n,)-bounds nests from ((reads, writes, compute), ...)."""
    out = []
    for reads, writes, cost in stages:
        refs = tuple([MemRef(r, Direction.READ, (1,)) for r in reads]
                     + [MemRef(w, Direction.WRITE, (1,)) for w in writes])
        out.append(LoopNest(bounds=(n,), refs=refs,
                            compute_per_level=(cost,)))
    return tuple(out)


def _map_nest(n: int, names: Tuple[str, ...], compute: int) -> LoopNest:
    return compiler.elementwise_nest(n, names, compute)


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).reshape(-1)


# --------------------------------------------------------------------------
# layernorm: x → {C = x − μ, V = C²} → C·rsqrt(mean(V) + ε)
# --------------------------------------------------------------------------


def _ln_centre(xb):
    return xb - xb.mean(dim=1, keepdim=True)


def _ln_square(cb):
    return cb * cb


def _ln_normalise(cb, vb):
    return cb * torch.rsqrt(vb.mean(dim=1, keepdim=True) + EPS)


_LN_STAGES = ((("X",), ("C",), 2), (("C",), ("V",), 1),
              (("C", "V"), (), 3))
_LN_BODIES = (KernelBody(_ln_centre, "ln_centre"),
              KernelBody(_ln_square, "ln_square"),
              KernelBody(_ln_normalise, "ln_normalise"))


def layernorm_spec(x: torch.Tensor):
    """(nests, bodies, operands, mode, uniforms) — raw ssr_dag_call args."""
    n = _rows_of(x) * LANES
    return (_dag_nests(n, _LN_STAGES), _LN_BODIES, {"X": _flat(x)}, "map",
            {})


def fused_layernorm(x: torch.Tensor, *, schedule=None,
                    device=None) -> torch.Tensor:
    """Per-row layernorm as ONE kernel: C is consumed twice, on chip.

    ``schedule=None`` resolves through the DAG autotune cache (the best
    committed graph cut); pass ``DEFAULT_SCHEDULE`` to pin all-fused.
    """
    m = _rows_of(x)
    nests, bodies, operands, mode, _ = layernorm_spec(x)
    out = ssr_dag_call(nests, bodies, operands, mode=mode,
                       schedule=schedule, device=device)
    return out.reshape(m, LANES)


def unfused_layernorm(x: torch.Tensor, *, device=None) -> torch.Tensor:
    """Three streamed kernels: C and V both round-trip through memory."""
    m = _rows_of(x)
    n = m * LANES
    centre, square, normalise = _LN_BODIES
    kw = dict(mode="map", schedule=DEFAULT_SCHEDULE, device=device)
    c = ssr_call(_map_nest(n, ("X",), 2), centre, {"X": _flat(x)}, **kw)
    v = ssr_call(_map_nest(n, ("C",), 1), square, {"C": c}, **kw)
    out = ssr_call(_map_nest(n, ("C", "V"), 3), normalise,
                   {"C": c, "V": v}, **kw)
    return out.reshape(m, LANES)


# --------------------------------------------------------------------------
# softmax cross-entropy: z → {C = z − max, E = exp C} → masked row loss
# --------------------------------------------------------------------------


def _sx_shift(zb):
    return zb - zb.amax(dim=1, keepdim=True)


def _sx_exp(cb):
    return torch.exp(cb)


def _sx_loss(cb, eb, pb):
    # mask = Σp per row: 1 on real rows (targets sum to one), 0 on padding
    # rows — the padding-neutrality the reduce epilogue requires.  Real
    # rows have Σexp(C) ≥ exp(0) = 1, so the clamp only rescues padding
    # rows, where E re-padded with zeros after a round trip through memory
    # would otherwise give mask·log(0) = NaN.
    mask = pb.sum(dim=1, keepdim=True)
    lse = torch.log(torch.clamp(eb.sum(dim=1, keepdim=True), min=1e-30))
    dot = (pb * cb).sum(dim=1, keepdim=True)
    return torch.broadcast_to(mask * (lse - dot) / cb.shape[1], cb.shape)


_SX_STAGES = ((("Z",), ("C",), 2), (("C",), ("E",), 1),
              (("C", "E", "P"), (), 4))
_SX_BODIES = (KernelBody(_sx_shift, "sx_shift"),
              KernelBody(_sx_exp, "sx_exp"),
              KernelBody(_sx_loss, "sx_loss"))


def softmax_xent_spec(z: torch.Tensor, p: torch.Tensor):
    n = _rows_of(z) * LANES
    if p.shape != z.shape:
        raise ValueError(f"targets shape {tuple(p.shape)} != logits "
                         f"{tuple(z.shape)}")
    return (_dag_nests(n, _SX_STAGES), _SX_BODIES,
            {"Z": _flat(z), "P": _flat(p)}, "reduce", {})


def fused_softmax_xent(z: torch.Tensor, p: torch.Tensor, *, schedule=None,
                       device=None) -> torch.Tensor:
    """Σ_rows [logΣexp(z) − Σ p·z] as one fused DAG (reduce epilogue).

    The shifted logits C feed both the exp pass and the p·C dot — the
    two-consumer pattern a linear chain cannot express.
    """
    nests, bodies, operands, mode, _ = softmax_xent_spec(z, p)
    return ssr_dag_call(nests, bodies, operands, mode=mode,
                        schedule=schedule, device=device)


def unfused_softmax_xent(z: torch.Tensor, p: torch.Tensor, *,
                         device=None) -> torch.Tensor:
    n = _rows_of(z) * LANES
    shift, exp, loss = _SX_BODIES
    kw = dict(schedule=DEFAULT_SCHEDULE, device=device)
    c = ssr_call(_map_nest(n, ("Z",), 2), shift, {"Z": _flat(z)},
                 mode="map", **kw)
    e = ssr_call(_map_nest(n, ("C",), 1), exp, {"C": c}, mode="map", **kw)
    return ssr_call(_map_nest(n, ("C", "E", "P"), 4), loss,
                    {"C": c, "E": e, "P": _flat(p)}, mode="reduce", **kw)


# --------------------------------------------------------------------------
# 2-layer MLP block: x → H = relu(xW₁+b₁) → {Y = HW₂+b₂, Y + H}
# --------------------------------------------------------------------------

# The weights ride as *uniform operands* — whole arrays every grid step
# needs in full, one loop-invariant block each, appended to EVERY stage
# body's arguments.  Uniform order is dict order: W1, B1, W2, B2.  The
# products are f32 (the reference asks for preferred_element_type=f32).


def _mlp_hidden(xb, w1, b1, w2, b2):
    return relu_block(torch.matmul(xb, w1) + b1)


def _mlp_out(hb, w1, b1, w2, b2):
    return torch.matmul(hb, w2) + b2


def _mlp_residual(hb, yb, *uniforms):
    return yb + hb


_MLP_STAGES = ((("X",), ("H",), 2 * LANES),
               (("H",), ("Y",), 2 * LANES),
               (("H", "Y"), (), 1))
_MLP_BODIES = (KernelBody(_mlp_hidden, "mlp_hidden"),
               KernelBody(_mlp_out, "mlp_out"),
               KernelBody(_mlp_residual, "mlp_residual"))


def mlp_block_spec(x, w1, b1, w2, b2):
    n = _rows_of(x) * LANES
    for w in (w1, w2):
        if tuple(w.shape) != (LANES, LANES):
            raise ValueError(
                f"mlp_block weights must be ({LANES}, {LANES}); "
                f"got {tuple(w.shape)}")
    f = torch.float32
    uniforms = {"W1": w1.to(f), "B1": b1.to(f), "W2": w2.to(f),
                "B2": b2.to(f)}
    return (_dag_nests(n, _MLP_STAGES), _MLP_BODIES, {"X": _flat(x)}, "map",
            uniforms)


def fused_mlp_block(x, w1, b1, w2, b2, *, schedule=None,
                    device=None) -> torch.Tensor:
    """relu(xW₁+b₁) → second matmul + residual add, H consumed twice."""
    m = _rows_of(x)
    nests, bodies, operands, mode, uniforms = mlp_block_spec(
        x, w1, b1, w2, b2)
    out = ssr_dag_call(nests, bodies, operands, mode=mode,
                       schedule=schedule, device=device, uniforms=uniforms)
    return out.reshape(m, LANES)


def unfused_mlp_block(x, w1, b1, w2, b2, *, device=None) -> torch.Tensor:
    m = _rows_of(x)
    n = m * LANES
    _, bodies, operands, _, uniforms = mlp_block_spec(x, w1, b1, w2, b2)
    hidden, out_, residual = bodies
    kw = dict(mode="map", schedule=DEFAULT_SCHEDULE, device=device,
              uniforms=uniforms)
    h = ssr_call(_map_nest(n, ("X",), 2 * LANES), hidden, operands, **kw)
    y = ssr_call(_map_nest(n, ("H",), 2 * LANES), out_, {"H": h}, **kw)
    out = ssr_call(_map_nest(n, ("H", "Y"), 1), residual, {"H": h, "Y": y},
                   **kw)
    return out.reshape(m, LANES)


# --------------------------------------------------------------------------
# DAG-case table: tests, chip_smoke.py and the cut search iterate it.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DagCase:
    """One fused-DAG variant plus what its audit and tuning need.

    ``inters(*args)`` returns the (dtype, dims) of EVERY padded buffer the
    unfused composition materialises (one per distinct intermediate).
    ``spec(*args)`` returns the raw ``(nests, bodies, operands, mode,
    uniforms)`` quintuple, so :func:`repro_torch.core.autotune.autotune_dag`
    runs on exactly the graph the fused kernel executes.
    """

    name: str
    fused: Callable
    unfused: Callable
    ref: Callable
    example: Callable
    inters: Callable[..., Tuple[Tuple[str, Tuple[int, ...]], ...]]
    spec: Callable
    tol: Dict[str, float]


def _two_vector_inters(x, *rest, **kw):
    dims = _padded_blocks(x.shape[0] * LANES)
    return (("f32", dims), ("f32", dims))


def _f32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _mk_examples():
    def ex_layernorm(rng, odd: bool = False):
        m = 37 if odd else 32
        return (_f32(rng.standard_normal((m, LANES))),), {}

    def ex_softmax(rng, odd: bool = False):
        m = 37 if odd else 32
        z = _f32(rng.standard_normal((m, LANES)))
        p = _f32(np.eye(LANES)[rng.integers(0, LANES, m)])
        return (z, p), {}

    def ex_mlp(rng, odd: bool = False):
        m = 37 if odd else 32
        x = _f32(rng.standard_normal((m, LANES)))
        w1 = _f32(rng.standard_normal((LANES, LANES)) * 0.1)
        b1 = _f32(rng.standard_normal(LANES) * 0.1)
        w2 = _f32(rng.standard_normal((LANES, LANES)) * 0.1)
        b2 = _f32(rng.standard_normal(LANES) * 0.1)
        return (x, w1, b1, w2, b2), {}

    return ex_layernorm, ex_softmax, ex_mlp


def dag_cases() -> Tuple[DagCase, ...]:
    from . import ref

    ex_ln, ex_sx, ex_mlp = _mk_examples()
    loose = {"rtol": 1e-3, "atol": 1e-3}
    reduce_tol = {"rtol": 1e-2, "atol": 1e-2}
    return (
        DagCase("layernorm", fused_layernorm, unfused_layernorm,
                ref.layernorm_ref, ex_ln, _two_vector_inters,
                layernorm_spec, loose),
        DagCase("softmax_xent", fused_softmax_xent, unfused_softmax_xent,
                ref.softmax_xent_ref, ex_sx, _two_vector_inters,
                softmax_xent_spec, reduce_tol),
        DagCase("mlp_block", fused_mlp_block, unfused_mlp_block,
                ref.mlp_block_ref, ex_mlp, _two_vector_inters,
                mlp_block_spec, loose),
    )


def _register(case: DagCase) -> None:
    @register_kernel(case.name)
    def _entry() -> KernelEntry:
        return KernelEntry(name=case.name, ssr=case.fused,
                           baseline=case.unfused, ref=case.ref,
                           example=case.example, tol=dict(case.tol),
                           problem=f"fused DAG: {case.name}")


for _case in dag_cases():
    _register(_case)
