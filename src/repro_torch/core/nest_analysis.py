"""Loop-nest IR + shared analysis for the §3.2 pipeline.

This module owns the compiler's input "MIR" — :class:`LoopNest` of affine
:class:`MemRef` accesses — and the analyses every stage of the pipeline
needs.  Before it existed, ``compiler.ssrify``, ``compiler.chain``,
``compiler.cluster_cost`` and ``lowering.ssr_call`` each re-derived the same
facts privately (ref depth, lane counts, residual instruction folding);
now there is exactly one answer per question:

* **depth / classification** — :func:`ref_depth`, :func:`reads`,
  :func:`writes`, :func:`affine_refs`, :func:`output_ref`;
* **lane inference** — :func:`auto_lanes`: the ``num_lanes=None``
  convention (allocate every affine ref) used by ``ssr_call``, ``chain``
  and ``cluster_cost``;
* **contraction detection** — :func:`contraction_axes`: the loop levels a
  ref is *revisited* across (coefficient 0 while the level iterates).  For
  a READ ref these are the repeat-register levels (§3.1); for the output
  WRITE ref they are the reduction loops whose partial sums the lowering
  must keep in an accumulator (init on first step, drain on last);
* **layout** — :func:`storage_order`: the permutation of varying levels
  that makes the ref a dense row-major array, or ``None`` when no such
  layout exists (the access is not expressible as whole-block DMA).

Everything here is pure Python over frozen dataclasses — importable by the
compiler, the lowering, the cluster layer and the benchmarks without any
jax dependency.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from .stream import Direction, MAX_DIMS


@dataclasses.dataclass(frozen=True)
class MemRef:
    """One load/store whose address is affine in the loop indices.

    ``coeffs[k]`` multiplies loop index ``k`` (outermost first); accesses with
    a non-affine address are represented by ``coeffs=None`` and are never
    SSR-ified (the MIR pattern-match fails — §3.2 step 2).

    **Indirect refs** (Indirection-SSR, arXiv 2011.08070 / Sparse SSR,
    arXiv 2305.05559): when ``index_of`` names another READ ref in the same
    nest, this ref's address is *data-dependent* — the value produced by the
    index stream at each step drives the address::

        addr = index_scale * value(index_of) + Σ_k coeffs[k]·i_k + offset

    ``coeffs`` then holds only the affine *additive* part (e.g. the dense
    column walk of SpMM's B operand); the gather base walks wherever the
    index stream points.  Indirect refs are not affine (:meth:`is_affine` is
    False — no static storage order exists), but they *are* streamable: the
    compiler allocates them a lane and the lowering serves them with an
    in-kernel gather from a VMEM-resident table.

    **Halo (overlapping-read) refs**: ``window[l] > 1`` declares that each
    iteration reads elements ``addr .. addr + (window[l]−1)·coeffs[l]``
    along level ``l`` — the overlapping stencil window the flat AGU model
    cannot express as disjoint blocks.  ``coeffs`` still describes the
    *base-corner* walk (one step per loop index), so the logical array is
    ``bounds[l] + window[l] − 1`` elements long on each windowed level.
    The lowering fetches the halo via shifted index_maps (DESIGN.md §13).

    **Online-rescaled accumulators**: ``acc_kind="online_softmax"`` on a
    WRITE ref revisited across a contraction axis asks the lowering for the
    flash-attention-style carried (max, sum, acc) triple instead of a plain
    sum accumulator — each contraction step rescales the running state by
    ``exp(m_old − m_new)``, so the softmax normaliser streams in one pass.
    """

    name: str
    kind: Direction
    coeffs: Optional[Tuple[int, ...]]  # None => not affine
    offset: int = 0
    depth: Optional[int] = None  # innermost loop level the access lives in
    index_of: Optional[str] = None  # name of the index stream driving addrs
    index_scale: int = 1  # elements per index step (row pitch of the table)
    window: Optional[Tuple[int, ...]] = None  # per-level read extents (halo)
    acc_kind: str = "sum"  # "sum" | "online_softmax" (WRITE refs only)

    def is_indirect(self) -> bool:
        return self.index_of is not None

    def is_affine(self) -> bool:
        return self.coeffs is not None and self.index_of is None

    def has_window(self) -> bool:
        """True when any level reads an overlapping (halo) window."""
        return self.window is not None and any(w > 1 for w in self.window)


@dataclasses.dataclass(frozen=True)
class LoopNest:
    """A perfect loop nest with known bounds (outermost first)."""

    bounds: Tuple[int, ...]
    refs: Tuple[MemRef, ...]
    compute_per_level: Tuple[int, ...]  # useful ops per body, per level

    def __post_init__(self) -> None:
        if len(self.bounds) > MAX_DIMS:
            raise ValueError(
                f"nest depth {len(self.bounds)} exceeds AGU dims ({MAX_DIMS}); "
                "outer levels must stay in software (paper §3.1)"
            )
        if len(self.compute_per_level) != len(self.bounds):
            raise ValueError("compute_per_level must match nest depth")
        by_name = {r.name: r for r in self.refs}
        for r in self.refs:
            if r.acc_kind not in ("sum", "online_softmax"):
                raise ValueError(
                    f"ref {r.name!r}: unknown acc_kind {r.acc_kind!r} "
                    "(expected 'sum' or 'online_softmax')")
            if r.acc_kind == "online_softmax" and r.kind != Direction.WRITE:
                raise ValueError(
                    f"ref {r.name!r}: acc_kind='online_softmax' only makes "
                    "sense on the output WRITE ref (the rescaled accumulator)")
            if r.window is not None:
                if not r.is_affine() or r.kind != Direction.READ:
                    raise ValueError(
                        f"ref {r.name!r}: halo windows are only supported on "
                        "affine READ refs")
                if len(r.window) != len(self.bounds):
                    raise ValueError(
                        f"ref {r.name!r}: window {r.window} must give one "
                        f"extent per loop level ({len(self.bounds)})")
                for l, w in enumerate(r.window):
                    if w < 1:
                        raise ValueError(
                            f"ref {r.name!r}: window extents must be >= 1, "
                            f"got {r.window}")
                    if w > 1 and r.coeffs[l] == 0:
                        raise ValueError(
                            f"ref {r.name!r}: window {r.window} opens on "
                            f"level {l}, whose coefficient is 0 — a halo "
                            "only widens levels the address varies with")
        for r in self.refs:
            if not r.is_indirect():
                continue
            idx = by_name.get(r.index_of)
            if idx is None:
                raise ValueError(
                    f"indirect ref {r.name!r} names index stream "
                    f"{r.index_of!r}, which is not a ref of this nest")
            if not idx.is_affine() or idx.kind != Direction.READ:
                raise ValueError(
                    f"indirect ref {r.name!r}: its index stream "
                    f"{r.index_of!r} must be an affine READ ref")
            if r.coeffs is None:
                raise ValueError(
                    f"indirect ref {r.name!r} needs coeffs for the affine "
                    "additive part of its address (all-zero for pure gather)")
            if r.kind != Direction.READ:
                raise ValueError(
                    f"indirect ref {r.name!r}: indirect WRITE (scatter) is "
                    "not supported — only gather streams are lowered")
            if r.index_scale < 1:
                raise ValueError(
                    f"indirect ref {r.name!r}: index_scale must be >= 1")

    @property
    def depth(self) -> int:
        return len(self.bounds)


# -- classification ----------------------------------------------------------


def reads(nest: LoopNest) -> Tuple[MemRef, ...]:
    return tuple(r for r in nest.refs if r.kind == Direction.READ)


def writes(nest: LoopNest) -> Tuple[MemRef, ...]:
    return tuple(r for r in nest.refs if r.kind == Direction.WRITE)


def affine_refs(nest: LoopNest) -> Tuple[MemRef, ...]:
    return tuple(r for r in nest.refs if r.is_affine())


def indirect_refs(nest: LoopNest) -> Tuple[MemRef, ...]:
    """Refs whose addresses are driven by an index stream (gathers)."""
    return tuple(r for r in nest.refs if r.is_indirect())


def streamable_refs(nest: LoopNest) -> Tuple[MemRef, ...]:
    """Every ref a data-mover lane can serve: affine walks plus gathers."""
    return tuple(r for r in nest.refs if r.is_affine() or r.is_indirect())


def index_stream_of(ref: MemRef, nest: LoopNest) -> MemRef:
    """The affine READ ref whose values drive ``ref``'s addresses."""
    assert ref.is_indirect(), f"ref {ref.name!r} is not indirect"
    return next(r for r in nest.refs if r.name == ref.index_of)


def output_ref(nest: LoopNest) -> Optional[MemRef]:
    """The nest's single output WRITE ref, or ``None`` for read-only nests.

    A nest with more than one write has no single-accumulator lowering;
    callers that need one (``ssr_call``'s nest-output path) treat that as a
    lowering failure.
    """
    ws = writes(nest)
    if not ws:
        return None
    if len(ws) > 1:
        raise ValueError(
            f"nest has {len(ws)} write refs "
            f"({[w.name for w in ws]}); expected at most one output")
    return ws[0]


def ref_depth(ref: MemRef, nest: LoopNest) -> int:
    """Deepest loop level whose index the address actually varies with.

    An indirect ref's address changes whenever its *index stream* advances
    or its own affine additive part varies, so its depth is the max of the
    two.
    """
    if ref.depth is not None:
        return ref.depth
    if ref.is_indirect():
        depth = ref_depth(index_stream_of(ref, nest), nest)
        for k, c in enumerate(ref.coeffs):
            if c != 0:
                depth = max(depth, k)
        return depth
    if not ref.is_affine():
        return -1
    depth = 0
    for k, c in enumerate(ref.coeffs):
        if c != 0:
            depth = k
    return depth


def varying_levels(ref: MemRef) -> Tuple[int, ...]:
    """Loop levels (outermost first) the ref's address varies with."""
    assert ref.coeffs is not None, "non-affine refs have no varying levels"
    return tuple(k for k, c in enumerate(ref.coeffs) if c != 0)


def contraction_axes(ref: MemRef, nest: LoopNest) -> Tuple[int, ...]:
    """Levels the ref is *revisited* across (coefficient 0, bound iterates).

    For a READ ref these are the repeat-register levels (§3.1: "a value
    loaded from memory is used as an operand multiple times"); for a WRITE
    ref they are the contraction (reduction) loops — the same address is
    written once per surrounding iteration, so the lowering must accumulate
    partials and drain only on the last revisit.
    """
    assert ref.coeffs is not None
    return tuple(k for k, c in enumerate(ref.coeffs)
                 if c == 0 and nest.bounds[k] > 1)


# -- lane inference ----------------------------------------------------------


def auto_lanes(nest: LoopNest, num_lanes: Optional[int] = None) -> int:
    """Data-mover lanes to allocate: every affine ref, unless overridden.

    This is the ``num_lanes=None`` convention shared by ``ssr_call``,
    ``chain`` and ``cluster_cost`` — the execution layer streams every
    pattern-matched access, leaving Eq. (3) to the *static* verdict only.
    """
    if num_lanes is not None:
        return num_lanes
    return max(1, len(streamable_refs(nest)))


# -- cost-model helpers ------------------------------------------------------


def instr_counts(nest: LoopNest,
                 residual: Sequence[MemRef] = ()) -> List[int]:
    """Per-level body instruction counts with residual accesses folded in.

    Residual (non-streamed) loads/stores stay in the body at their depth —
    the Eq. (1)/(2) accounting both ``ssrify`` and ``chain`` apply.  A
    residual *indirect* access costs two body instructions, not one: the
    address computation from the index value (pointer arithmetic) plus the
    data load itself — the index-handling overhead the indirection
    extensions (arXiv 2011.08070 / 2305.05559) exist to eliminate.
    """
    counts = list(nest.compute_per_level)
    for ref in residual:
        counts[max(0, ref_depth(ref, nest))] += 2 if ref.is_indirect() else 1
    return counts


def nest_compute(nest: LoopNest) -> int:
    """Useful ops of one nest execution: Σ_i I_i · Π_{n≤i} L_n."""
    prod, total = 1, 0
    for Li, Ii in zip(nest.bounds, nest.compute_per_level):
        prod *= Li
        total += Ii * prod
    return total


# -- layout ------------------------------------------------------------------


def level_extent(ref: MemRef, nest: LoopNest, level: int) -> int:
    """The ref's logical extent at ``level``: the loop bound, widened by the
    halo window when one is open (``bounds[l] + window[l] − 1``)."""
    w = 1 if ref.window is None else ref.window[level]
    return nest.bounds[level] + w - 1


def storage_order(ref: MemRef, nest: LoopNest) -> Optional[Tuple[int, ...]]:
    """Varying levels ordered outermost-first *in storage*, if dense.

    A ref is whole-block streamable when, sorted by descending coefficient,
    its varying levels form a dense row-major array: the fastest level has
    coefficient 1 and every slower level's coefficient equals the extent
    product of the faster ones.  The order may be any *permutation* of the
    loop order — GEMM's B operand walks the innermost loop (k) with stride
    n because its storage order is (k, n) while the loop order is
    (m, n, k).  Returns ``None`` when no dense layout exists (e.g. the
    overlapping windows of a stencil walk *without* a declared halo).

    A halo ref's density is judged against its *widened* extents: a 2-D
    stencil reading a (H+2r) × (W+2r) padded grid has row stride W+2r, and
    that is exactly ``level_extent`` of the faster level — the base-corner
    walk is dense over the widened array even though the per-iteration
    windows overlap.

    A bound-1 level multiplies the running extent by 1, so its coefficient
    *ties* the next-faster real level's; a naive coefficient sort can then
    pick the non-dense permutation and reject a valid layout (GEMM's B
    with n == 1 has coefficients (0, 1, 1): (k, n) is dense, (n, k) is
    not).  Ties break toward the fast side for bound-1 levels, where the
    running extent still equals their coefficient.
    """
    assert ref.coeffs is not None
    lv = varying_levels(ref)
    if not lv:
        return ()
    order = sorted(lv, key=lambda l: (-ref.coeffs[l],
                                      level_extent(ref, nest, l) == 1, l))
    expect = 1
    for l in reversed(order):
        if ref.coeffs[l] != expect:
            return None
        expect *= level_extent(ref, nest, l)
    return tuple(order)


def logical_shape(ref: MemRef, nest: LoopNest) -> Tuple[int, ...]:
    """The dense array shape implied by :func:`storage_order` — widened by
    the halo window on windowed levels."""
    order = storage_order(ref, nest)
    assert order is not None, f"ref {ref.name!r} has no dense storage order"
    return tuple(level_extent(ref, nest, l) for l in order)
