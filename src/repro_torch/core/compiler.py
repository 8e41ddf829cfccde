"""The §3.2 "SSR-ification" compiler pass, ported from LLVM MIR to a loop IR.

The paper's pass runs after instruction selection and before register
allocation: it (1) finds loops, (2) pattern-matches affine load/store address
expressions, (3) allocates candidates to the available data movers
*deepest-first*, (4) emits stream configuration before the loop header,
(5) replaces the memory ops with stream-register uses, and (6) blocks the
stream registers during register allocation.

Our input "MIR" is a :class:`LoopNest` of affine :class:`MemRef` accesses plus
a compute-op count — the information the MIR pattern-match extracts.  The
output :class:`StreamPlan` carries the allocated :class:`StreamSpec` per lane,
the residual (non-SSRable) accesses, and the Eq. (1)–(3) cost verdict, and can
be lowered straight to ``ssr_pallas`` streams.  The paper's caveat that "not
every loop benefits from SSRs" is the Eq. (3) test, applied per nest exactly
as §3.2 recommends ("at compile time based on the expected number of
iterations").
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from . import isa
from . import nest_analysis
from .nest_analysis import LoopNest, MemRef  # noqa: F401  (re-exported API)
from .stream import Direction, StreamSpec, MAX_DIMS  # noqa: F401

DEFAULT_NUM_LANES = 2  # the implementation in the paper has two data movers


@dataclasses.dataclass(frozen=True)
class Allocation:
    lane: int
    ref: MemRef
    spec: StreamSpec


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    nest: LoopNest
    allocations: Tuple[Allocation, ...]
    residual: Tuple[MemRef, ...]   # accesses that stay as explicit loads/stores
    ssrified: bool                 # Eq. (3) verdict (False => emit baseline)
    n_ssr: int
    n_base: int
    # Index-handling instructions (index load + per-element pointer
    # arithmetic) the baseline pays for each *allocated* indirect ref and
    # the indirection extension elides — the quantity Indirection-SSR
    # (arXiv 2011.08070) / Sparse SSR (arXiv 2305.05559) report per nnz.
    eliminated_idx_instrs: int = 0

    @property
    def speedup(self) -> float:
        return self.n_base / self.n_ssr if self.ssrified else 1.0


# Depth/lane/instruction analyses live in core/nest_analysis.py — one
# derivation shared by ssrify, chain, cluster_cost and the lowering.
_ref_depth = nest_analysis.ref_depth


def _to_spec(ref: MemRef, nest: LoopNest) -> StreamSpec:
    """Build the AGU configuration for an affine access in this nest.

    Loop levels whose coefficient is zero become ``repeat`` (read streams:
    the same datum re-emitted — the paper's repeat register) when they are
    innermost, or bound-1 dims otherwise.

    An *indirect* ref has no static walk of its own — its AGU is slaved to
    the index stream's (arXiv 2011.08070: the index FIFO feeds the address
    stage), so its spec is the index stream's walk rebased at the gather
    table.
    """
    assert ref.coeffs is not None
    if ref.is_indirect():
        idx_spec = _to_spec(nest_analysis.index_stream_of(ref, nest), nest)
        return dataclasses.replace(idx_spec, base=ref.offset,
                                   direction=ref.kind)
    bounds: List[int] = []
    strides: List[int] = []
    repeat = 1
    # walk from outermost; trailing zero-coeff levels of a read stream fold
    # into the repeat register.
    coeffs = list(ref.coeffs)
    trailing_zero = 0
    for c in reversed(coeffs):
        if c == 0:
            trailing_zero += 1
        else:
            break
    if ref.kind == Direction.READ and trailing_zero:
        for lvl in range(len(coeffs) - trailing_zero, len(coeffs)):
            repeat *= nest.bounds[lvl]
        coeffs = coeffs[: len(coeffs) - trailing_zero]
    for lvl, c in enumerate(coeffs):
        bounds.append(nest.bounds[lvl])
        strides.append(c)
    if not bounds:  # scalar (loop-invariant) access
        bounds, strides = [1], [0]
    return StreamSpec(bounds=tuple(bounds), strides=tuple(strides),
                      base=ref.offset, repeat=repeat, direction=ref.kind)


def ssrify(nest: LoopNest, *, num_lanes: int = DEFAULT_NUM_LANES,
           force: bool = False) -> StreamPlan:
    """Run the pass: allocate streams deepest-first, then apply Eq. (3).

    ``force=True`` skips the profitability test (the paper's "runtime
    decision" path where both variants exist and the caller knows N).
    """
    candidates = [r for r in nest.refs if r.is_affine() or r.is_indirect()]
    residual = [r for r in nest.refs
                if not (r.is_affine() or r.is_indirect())]
    # §3.2 step 3: deepest-first — a simple heuristic for iteration count.
    candidates.sort(key=lambda r: _ref_depth(r, nest), reverse=True)
    allocations: List[Allocation] = []
    for ref in candidates:
        if len(allocations) < num_lanes:
            allocations.append(
                Allocation(lane=len(allocations), ref=ref,
                           spec=_to_spec(ref, nest)))
        else:
            residual.append(ref)

    d = len(nest.bounds)
    s = len(allocations)
    L = list(nest.bounds)
    # Residual explicit memory ops stay in the body at their depth: fold
    # them into per-level instruction counts for the cost model.  Streamed
    # and baseline bodies carry the same residual ops — only the allocated
    # lanes differ — so one count serves both Eq. (1) and Eq. (2)...
    I = nest_analysis.instr_counts(nest, residual)
    # ...except for allocated *indirect* refs: Eq. (2)'s s-term charges one
    # explicit memory instruction per lane per iteration, but a gather also
    # pays the index→pointer arithmetic in the baseline body.  The
    # indirection extension folds that into the AGU, so the extra charge
    # lands on the baseline count only (arXiv 2011.08070 §III).
    I_base = list(I)
    eliminated = 0
    for a in allocations:
        if not a.ref.is_indirect():
            continue
        depth = max(0, _ref_depth(a.ref, nest))
        I_base[depth] += 1
        iters = 1
        for lvl in range(depth + 1):
            iters *= nest.bounds[lvl]
        # Per executed element the baseline issues an index load plus the
        # pointer arithmetic; both vanish once the lane gathers directly.
        eliminated += 2 * iters
    n_with = isa.n_ssr(L, I, max(s, 1)) if s else isa.n_base(L, I, 0)
    n_without = isa.n_base(L, I_base, s)
    # force=True is the paper's "runtime decision" path: both variants are
    # compiled and the caller elects SSR regardless of the static verdict.
    profitable = bool(s) and (
        force or (isa.ssr_profitable(L) and n_with <= n_without))
    if not profitable:
        return StreamPlan(nest=nest, allocations=(), residual=tuple(nest.refs),
                          ssrified=False, n_ssr=n_without, n_base=n_without)
    return StreamPlan(nest=nest, allocations=tuple(allocations),
                      residual=tuple(residual), ssrified=True,
                      n_ssr=n_with, n_base=n_without,
                      eliminated_idx_instrs=eliminated)


# --------------------------------------------------------------------------
# Stream chaining: fuse producer→consumer nests into one stream region.
#
# "A RISC-V ISA Extension for Chaining in Scalar Processors" (Colagrande et
# al., 2025) chains a producer's output stream directly into a consumer's
# input stream, so the intermediate never round-trips through memory.  Our
# block-granular analogue fuses whole LoopNests: if nest k writes a ref that
# nest k+1 reads with the *same* affine walk over the *same* iteration
# space, the store and the load cancel and both bodies run inside one
# stream region.  The Eq. (1)–(3) accounting extends naturally: one setup
# instead of len(nests), fewer allocated lanes, and — the quantity that
# actually decides memory-bound kernels — 2·ΠL eliminated loads+stores per
# link.
# --------------------------------------------------------------------------


class ChainError(ValueError):
    """The nests cannot be unified into one chained stream region."""


@dataclasses.dataclass(frozen=True)
class ChainLink:
    """One producer→consumer edge: the unified intermediate ref.

    ``coeffs``/``offset`` are the (identical) affine walk of the producer's
    write and the consumer's read; ``elems`` is ΠL — the number of elements
    that never touch memory once the link is fused.
    """

    name: str
    producer_stage: int
    coeffs: Tuple[int, ...]
    offset: int
    elems: int


@dataclasses.dataclass(frozen=True)
class ChainedPlan:
    """A sequence of StreamPlans fused over one shared iteration space.

    ``stages[k]`` is the per-stage plan with the link refs *stripped* (the
    producer no longer stores its output, the consumer no longer loads it);
    ``links[k]`` records the unified intermediate between stages k and k+1.
    The cost fields extend Eq. (1)/(2):

    * ``n_chain``   — one fused stream region: a single setup, the union of
      the surviving lanes, the sum of all stage bodies;
    * ``n_unfused`` — Σ over stages of the stand-alone Eq. (1) count, each
      with its own setup and its intermediate store/load lane;
    * ``eliminated_loads``/``eliminated_stores`` — the intermediate memory
      accesses that simply never happen (ΠL each per link) — the chaining
      paper's headline quantity, invisible to pure instruction counts on a
      machine where streamed accesses are free but bandwidth is not.
    """

    stages: Tuple[StreamPlan, ...]
    links: Tuple[ChainLink, ...]
    bounds: Tuple[int, ...]
    n_chain: int
    n_unfused: int
    eliminated_loads: int
    eliminated_stores: int

    @property
    def eliminated_accesses(self) -> int:
        return self.eliminated_loads + self.eliminated_stores

    @property
    def chain_speedup(self) -> float:
        """Instruction-count speedup of the fused region vs the sequence."""
        return self.n_unfused / self.n_chain

    @property
    def num_lanes(self) -> int:
        return sum(len(s.allocations) for s in self.stages)


def _dense_strides(bounds: Sequence[int]) -> Tuple[int, ...]:
    strides = [1] * len(bounds)
    for k in range(len(bounds) - 2, -1, -1):
        strides[k] = strides[k + 1] * bounds[k + 1]
    return tuple(strides)


def _stage_instr_counts(plan: StreamPlan) -> List[int]:
    """Per-level body instruction counts with residual accesses folded in."""
    return nest_analysis.instr_counts(plan.nest, plan.residual)


def _unify_walk(name: str, w: MemRef, r: MemRef) -> None:
    """Raise ChainError unless the producer's write walk and the consumer's
    read walk of ``name`` are the same affine address sequence — the
    condition under which the store and the load cancel."""
    if w.coeffs is None or r.coeffs is None:
        raise ChainError(
            f"intermediate '{name}' is not affine on both sides")
    if w.coeffs != r.coeffs or w.offset != r.offset:
        raise ChainError(
            f"intermediate '{name}': producer walk "
            f"{w.coeffs}+{w.offset} != consumer walk "
            f"{r.coeffs}+{r.offset}; streams cannot be unified")


def _fused_region_count(stages: Sequence[StreamPlan],
                        bounds: Sequence[int]) -> int:
    """Eq. (1) for one fused stream region: a single setup over the union
    of the surviving lanes, per-level bodies summed across stages."""
    L = list(bounds)
    I = [0] * len(bounds)
    for plan in stages:
        for lvl, c in enumerate(_stage_instr_counts(plan)):
            I[lvl] += c
    s = sum(len(p.allocations) for p in stages)
    return isa.n_ssr(L, I, s) if s else isa.n_base(L, I, 0)


def chain(nests: Sequence[LoopNest], *,
          num_lanes: Optional[int] = None,
          force: bool = False) -> ChainedPlan:
    """Fuse a producer→consumer sequence of nests into one ChainedPlan.

    Adjacent nests are unified through exactly one intermediate ref: the
    producer's WRITE and the consumer's READ of the same name, with equal
    affine coefficients and offset, over identical iteration spaces.  The
    link refs are stripped and each stage is SSR-ified independently
    (``num_lanes=None`` allocates every affine ref, the ``ssr_call``
    convention); the cost model charges one fused setup and credits the
    eliminated intermediate traffic.
    """
    nests = tuple(nests)
    if len(nests) < 2:
        raise ChainError("chaining needs at least two nests")
    bounds = nests[0].bounds
    for k, nest in enumerate(nests[1:], start=1):
        if nest.bounds != bounds:
            raise ChainError(
                f"stage {k} iteration space {nest.bounds} != stage 0 "
                f"{bounds}; chained nests must share one iteration space")

    links: List[ChainLink] = []
    for k in range(len(nests) - 1):
        p, c = nests[k], nests[k + 1]
        writes = {r.name: r for r in p.refs if r.kind == Direction.WRITE}
        reads = {r.name: r for r in c.refs if r.kind == Direction.READ}
        common = sorted(set(writes) & set(reads))
        if len(common) != 1:
            raise ChainError(
                f"stages {k}→{k + 1}: need exactly one producer-write / "
                f"consumer-read ref in common, found {common or 'none'}")
        w, r = writes[common[0]], reads[common[0]]
        _unify_walk(common[0], w, r)
        links.append(ChainLink(name=common[0], producer_stage=k,
                               coeffs=w.coeffs, offset=w.offset,
                               elems=math.prod(bounds)))

    # Strip the unified refs: the producer's store and the consumer's load
    # vanish — that is the fusion.
    stage_nests: List[LoopNest] = []
    for k, nest in enumerate(nests):
        incoming = links[k - 1].name if k > 0 else None
        outgoing = links[k].name if k < len(nests) - 1 else None
        refs = tuple(
            r for r in nest.refs
            if not (r.name == incoming and r.kind == Direction.READ)
            and not (r.name == outgoing and r.kind == Direction.WRITE))
        stage_nests.append(dataclasses.replace(nest, refs=refs))

    stages = tuple(
        ssrify(sn, num_lanes=nest_analysis.auto_lanes(sn, num_lanes),
               force=force)
        for sn in stage_nests)

    # Unfused cost: each original nest as its own stream region (its link
    # ref occupies a lane and its setup is paid per stage).
    unfused_plans = [
        ssrify(n, num_lanes=nest_analysis.auto_lanes(n, num_lanes),
               force=force)
        for n in nests]
    n_unfused = sum(
        p.n_ssr if p.ssrified else p.n_base for p in unfused_plans)

    # Fused cost: one setup over the union of surviving lanes; the body at
    # each level is the sum of every stage's body (+ residual accesses).
    n_chain = _fused_region_count(stages, bounds)

    elems = sum(link.elems for link in links)
    return ChainedPlan(stages=stages, links=tuple(links), bounds=bounds,
                       n_chain=n_chain, n_unfused=n_unfused,
                       eliminated_loads=elems, eliminated_stores=elems)


# --------------------------------------------------------------------------
# Chain DAGs: whole-program fusion beyond linear pipelines.
#
# Production dataflow — layernorm, softmax cross-entropy, MLP blocks — is
# not a pipeline: one produced value feeds *several* consumers (diamonds,
# residual adds).  The scalar-chaining follow-up (arXiv 2503.20609) shows
# register chaining generalizes to arbitrary DAGs; our block-granular
# analogue lifts ChainedPlan to a ChainDAG whose edges each record one
# producer-WRITE → consumer-READ unification.  A multi-consumer
# intermediate is written to VMEM scratch once and read K times, so the
# accounting credits ONE eliminated store and K eliminated loads — the
# refcount the lowering uses to free the scratch slot after its last
# consumer.  ChainedPlan remains the linear special case (exactly one
# consumer per edge, consumer == producer + 1) and keeps its own
# entry point so linear-chain behavior is unchanged.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DagEdge:
    """One producer→consumer dataflow edge of a :class:`ChainDAG`.

    Like :class:`ChainLink` plus an explicit ``consumer_stage`` — in a DAG
    the consumer is no longer implied by ``producer_stage + 1``, and one
    producer may appear in several edges (multi-consumer intermediate).
    """

    name: str
    producer_stage: int
    consumer_stage: int
    coeffs: Tuple[int, ...]
    offset: int
    elems: int


@dataclasses.dataclass(frozen=True)
class ChainDAG:
    """Stages fused over one iteration space along an arbitrary DAG.

    ``stages[k]`` is the per-stage plan with every edge ref stripped (a
    produced value is stored by no one, loaded by no one); ``edges`` are
    the unified intermediates in deterministic ``(consumer, producer,
    name)`` order.  Stage order is topological by construction (an edge
    always points forward).  The cost fields mirror :class:`ChainedPlan`:

    * ``n_dag``     — ONE fused stream region (single setup, union of
      surviving lanes, bodies summed);
    * ``n_unfused`` — Σ of stand-alone per-stage counts, each paying its
      own setup and its intermediate store/load lanes;
    * ``eliminated_stores`` — ΠL per *distinct* intermediate (written
      once no matter how many consumers);
    * ``eliminated_loads``  — ΠL per *edge* (each consumer's load is a
      separate eliminated access — the multi-consumer credit).
    """

    stages: Tuple[StreamPlan, ...]
    edges: Tuple[DagEdge, ...]
    bounds: Tuple[int, ...]
    n_dag: int
    n_unfused: int
    eliminated_loads: int
    eliminated_stores: int

    @property
    def links(self) -> Tuple[DagEdge, ...]:
        """Lowering-compatible view: the edges are the chain's links."""
        return self.edges

    @property
    def eliminated_accesses(self) -> int:
        return self.eliminated_loads + self.eliminated_stores

    @property
    def dag_speedup(self) -> float:
        """Instruction-count speedup of the fused region vs the sequence."""
        return self.n_unfused / self.n_dag

    @property
    def num_lanes(self) -> int:
        return sum(len(s.allocations) for s in self.stages)

    @property
    def intermediates(self) -> Tuple[str, ...]:
        """Distinct produced names, in producer-stage order."""
        seen: List[str] = []
        for e in sorted(self.edges, key=lambda e: (e.producer_stage, e.name)):
            if e.name not in seen:
                seen.append(e.name)
        return tuple(seen)

    def in_edges(self, stage: int) -> Tuple[DagEdge, ...]:
        """Incoming edges of ``stage`` in (producer, name) order — the
        order the stage's body receives its carried blocks."""
        return tuple(sorted((e for e in self.edges
                             if e.consumer_stage == stage),
                            key=lambda e: (e.producer_stage, e.name)))

    def out_edges(self, stage: int) -> Tuple[DagEdge, ...]:
        return tuple(sorted((e for e in self.edges
                             if e.producer_stage == stage),
                            key=lambda e: (e.consumer_stage, e.name)))

    def last_consumer(self, name: str) -> int:
        """The stage after which ``name``'s scratch slot is dead — the
        refcount-to-zero point the lowering frees at."""
        return max(e.consumer_stage for e in self.edges if e.name == name)


def chain_dag(nests: Sequence[LoopNest], *,
              num_lanes: Optional[int] = None,
              force: bool = False) -> ChainDAG:
    """Fuse a topologically-ordered sequence of nests into one ChainDAG.

    Dataflow is discovered by name: a ref WRITTEN by stage p and READ by a
    later stage c becomes an edge p→c (one write may feed many reads); a
    read name no earlier stage writes stays an external operand stream.
    The same loud :class:`ChainError` failures as :func:`chain` apply to
    still-illegal graphs — mismatched iteration spaces, non-affine or
    mismatched walks — plus the DAG-specific ones: a name written twice,
    a read before its write (the sequence must be topological), a
    disconnected stage, and more than one terminal stage (only the final
    stage's value may leave the fused region).
    """
    nests = tuple(nests)
    if len(nests) < 2:
        raise ChainError("chaining needs at least two nests")
    bounds = nests[0].bounds
    for k, nest in enumerate(nests[1:], start=1):
        if nest.bounds != bounds:
            raise ChainError(
                f"stage {k} iteration space {nest.bounds} != stage 0 "
                f"{bounds}; chained nests must share one iteration space")

    writers: dict = {}
    for k, nest in enumerate(nests):
        for r in nest.refs:
            if r.kind != Direction.WRITE:
                continue
            if r.name in writers:
                raise ChainError(
                    f"intermediate '{r.name}' is written by both stage "
                    f"{writers[r.name][0]} and stage {k}; each intermediate "
                    "needs exactly one producer")
            writers[r.name] = (k, r)

    edges: List[DagEdge] = []
    for k, nest in enumerate(nests):
        for r in nest.refs:
            if r.kind != Direction.READ or r.name not in writers:
                continue
            p, w = writers[r.name]
            if p >= k:
                raise ChainError(
                    f"stage {k} reads '{r.name}' which stage {p} has not "
                    "produced yet; stages must be listed in topological "
                    "order (producers before consumers)")
            _unify_walk(r.name, w, r)
            edges.append(DagEdge(name=r.name, producer_stage=p,
                                 consumer_stage=k, coeffs=w.coeffs,
                                 offset=w.offset, elems=math.prod(bounds)))
    edges.sort(key=lambda e: (e.consumer_stage, e.producer_stage, e.name))

    consumed = {e.name for e in edges}
    touched = {e.producer_stage for e in edges} \
        | {e.consumer_stage for e in edges}
    for k in range(len(nests)):
        if k not in touched:
            raise ChainError(
                f"stage {k} is disconnected from the dag: no produced "
                "value links it to any other stage")
    sinks = [k for k in range(len(nests))
             if not any(e.producer_stage == k for e in edges)]
    if sinks != [len(nests) - 1]:
        raise ChainError(
            f"stages {sinks} all terminate the dag; exactly one final "
            "stage (the last) may produce the fused region's output")
    for name, (k, _w) in writers.items():
        if name not in consumed:
            raise ChainError(
                f"stage {k} writes '{name}' but no later stage reads it; "
                "dead intermediates cannot leave the fused region")

    # Strip every unified ref: each produced name loses its single WRITE
    # and each of its consumer READs — the store and K loads all vanish.
    stage_nests: List[LoopNest] = []
    for k, nest in enumerate(nests):
        incoming = {e.name for e in edges if e.consumer_stage == k}
        outgoing = {e.name for e in edges if e.producer_stage == k}
        refs = tuple(
            r for r in nest.refs
            if not (r.name in incoming and r.kind == Direction.READ)
            and not (r.name in outgoing and r.kind == Direction.WRITE))
        stage_nests.append(dataclasses.replace(nest, refs=refs))

    stages = tuple(
        ssrify(sn, num_lanes=nest_analysis.auto_lanes(sn, num_lanes),
               force=force)
        for sn in stage_nests)

    unfused_plans = [
        ssrify(n, num_lanes=nest_analysis.auto_lanes(n, num_lanes),
               force=force)
        for n in nests]
    n_unfused = sum(
        p.n_ssr if p.ssrified else p.n_base for p in unfused_plans)
    n_dag = _fused_region_count(stages, bounds)

    elems = math.prod(bounds)
    return ChainDAG(stages=stages, edges=tuple(edges), bounds=bounds,
                    n_dag=n_dag, n_unfused=n_unfused,
                    eliminated_loads=elems * len(edges),
                    eliminated_stores=elems * len(consumed))


# --------------------------------------------------------------------------
# Cluster cost model: Eq. (1)–(3) extended to a C-core cluster (§5.3–5.5).
#
# The paper runs the kernels on an 8-core cluster sharing one TCDM and
# reports speedup-vs-cores (Fig. 10/11), near-100 % utilization, and the
# iso-performance claim that 3× fewer SSR cores match a baseline cluster.
# Here the model is made explicit: the outermost loop level is tiled across
# C cores (ceil tiles — the max core bounds the cluster, exactly Amdahl's
# straggler), each core pays its own Eq. (1) count including its own stream
# setup, and the combine is a log2-depth barrier/psum tree (the event-unit
# + shared-TCDM reduction).  η per cluster charges idle issue slots on
# underloaded cores, which is how the paper's single-core 3× decays toward
# 2.2× at six cores (§5.4).
# --------------------------------------------------------------------------

#: Instructions charged per stage of the combine tree: the §5.3 hardware
#: barrier (event-unit wait/wake) plus one partial-sum load+add+store.
COMBINE_COST = 16


@dataclasses.dataclass(frozen=True)
class CoreCost:
    """One core's share of a clustered nest, in Eq. (1) accounting.

    ``n`` is the executed-instruction count on this core (0 for cores left
    idle by a ragged split); on a single-issue core every executed
    instruction is also an instruction *fetch*, so ``fetches == n`` — the
    quantity behind the paper's 3.5× i-fetch reduction (§5.6).
    ``bytes_moved`` counts the unique elements this core's allocated
    streams pull from shared memory (repeat streams once), at 4 B/elem.
    """

    core: int
    bounds: Tuple[int, ...]
    n: int
    compute: int
    bytes_moved: int

    @property
    def eta(self) -> float:
        return self.compute / self.n if self.n else 0.0

    @property
    def fetches(self) -> int:
        return self.n


@dataclasses.dataclass(frozen=True)
class ClusterReport:
    """Eq. (1)–(3) extended to C cores (§5.3–5.5 / Fig. 10–11).

    ``n_single`` is the one-core streamed count; the cluster finishes when
    its slowest core does, plus the combine tree: ``n_cluster =
    max_c n_c + combine``.  ``speedup`` is therefore the architectural
    speedup-vs-cores curve, and ``eta_cluster`` the cluster-wide useful
    utilization (idle cores charged), the two §V quantities
    ``benchmarks/cluster_bench.py`` sweeps.
    """

    cores: int
    bounds: Tuple[int, ...]
    per_core: Tuple[CoreCost, ...]
    n_single: int
    n_base_single: int
    combine: int
    chained: bool = False
    eliminated_accesses: int = 0

    @property
    def n_cluster(self) -> int:
        return max(c.n for c in self.per_core) + self.combine

    @property
    def speedup(self) -> float:
        """Architectural speedup of the C-core cluster over one SSR core."""
        return self.n_single / self.n_cluster

    @property
    def speedup_vs_base(self) -> float:
        """Speedup over one *baseline* (no-SSR) core — the Fig. 11 axis."""
        return self.n_base_single / self.n_cluster

    @property
    def eta_cluster(self) -> float:
        total_compute = sum(c.compute for c in self.per_core)
        return total_compute / (self.cores * self.n_cluster)

    @property
    def total_fetches(self) -> int:
        return sum(c.fetches for c in self.per_core) \
            + self.cores * self.combine

    @property
    def bytes_moved(self) -> int:
        return sum(c.bytes_moved for c in self.per_core)


_nest_compute = nest_analysis.nest_compute


def _plan_bytes(plan: StreamPlan, itemsize: int = 4) -> int:
    """Unique streamed elements across the plan's lanes, in bytes."""
    total = 0
    for a in plan.allocations:
        elems = 1
        for b, c in zip(plan.nest.bounds, a.ref.coeffs):
            if c != 0:
                elems *= b
        total += elems * itemsize
    return total


def _tile_extents(b0: int, cores: int) -> List[int]:
    """Ceil-tile split of the outer bound: the max tile bounds the cluster."""
    tile = -(-b0 // cores)
    return [max(0, min(tile, b0 - c * tile)) for c in range(cores)]


def _combine_instrs(cores: int, combine_cost: int) -> int:
    return combine_cost * (cores - 1).bit_length() if cores > 1 else 0


_auto_lanes = nest_analysis.auto_lanes


def cluster_cost(nests, cores: int, *,
                 num_lanes: Optional[int] = None,
                 combine_cost: int = COMBINE_COST) -> ClusterReport:
    """Cost a nest (or producer→consumer chain) on a C-core cluster.

    Accepts a single :class:`LoopNest` or a chainable sequence (routed
    through :func:`chain` per core, so chained intermediates stay core-
    local and their eliminated accesses scale with the split).  The split
    is ceil-tiled on the outermost level — no divisibility requirement
    here, unlike the execution layer, because the *model's* cluster time is
    set by the largest tile either way.
    """
    if cores < 1:
        raise ValueError(f"cores must be >= 1, got {cores}")
    single = isinstance(nests, LoopNest)
    seq: Tuple[LoopNest, ...] = (nests,) if single else tuple(nests)
    bounds = seq[0].bounds
    extents = _tile_extents(bounds[0], cores)

    def sub_nests(e: int) -> Tuple[LoopNest, ...]:
        return tuple(dataclasses.replace(n, bounds=(e,) + n.bounds[1:])
                     for n in seq)

    if single:
        lanes = _auto_lanes(seq[0], num_lanes)
        full = ssrify(seq[0], num_lanes=lanes, force=True)
        n_single, n_base_single = full.n_ssr, full.n_base
    else:
        full_chain = chain(seq, num_lanes=num_lanes, force=True)
        n_single = full_chain.n_chain
        n_base_single = sum(
            ssrify(n, num_lanes=_auto_lanes(n, num_lanes)).n_base
            for n in seq)

    per_core: List[CoreCost] = []
    eliminated = 0
    for c, e in enumerate(extents):
        if e == 0:
            per_core.append(CoreCost(core=c, bounds=(0,) + bounds[1:],
                                     n=0, compute=0, bytes_moved=0))
            continue
        subs = sub_nests(e)
        if single:
            plan = ssrify(subs[0], num_lanes=_auto_lanes(subs[0], num_lanes),
                          force=True)
            n = plan.n_ssr
            comp = _nest_compute(subs[0])
            nbytes = _plan_bytes(plan)
        else:
            cp = chain(subs, num_lanes=num_lanes, force=True)
            n = cp.n_chain
            comp = sum(_nest_compute(s) for s in subs)
            nbytes = sum(_plan_bytes(p) for p in cp.stages)
            eliminated += cp.eliminated_accesses
        per_core.append(CoreCost(core=c, bounds=subs[0].bounds, n=n,
                                 compute=comp, bytes_moved=nbytes))

    return ClusterReport(cores=cores, bounds=bounds,
                         per_core=tuple(per_core),
                         n_single=n_single, n_base_single=n_base_single,
                         combine=_combine_instrs(cores, combine_cost),
                         chained=not single,
                         eliminated_accesses=eliminated)


def iso_performance_cores(nests, baseline_cores: int, *,
                          num_lanes: Optional[int] = None,
                          combine_cost: int = COMBINE_COST,
                          max_cores: int = 64) -> int:
    """Smallest SSR-core count matching a C-core *baseline* cluster.

    The §5.5/Fig. 11 claim — "3x fewer cores are needed in a cluster to
    achieve the same performance" — replayed on the explicit per-core
    model: the baseline cluster runs Eq. (2) counts (explicit loads in the
    hot loop) on each tile; we grow the SSR cluster until its ``n_cluster``
    is no worse.
    """
    single = isinstance(nests, LoopNest)
    seq: Tuple[LoopNest, ...] = (nests,) if single else tuple(nests)
    extents = _tile_extents(seq[0].bounds[0], baseline_cores)
    worst = 0
    for e in extents:
        if e == 0:
            continue
        n_b = 0
        for nest in seq:
            sub = dataclasses.replace(nest, bounds=(e,) + nest.bounds[1:])
            n_b += ssrify(sub, num_lanes=_auto_lanes(sub, num_lanes)).n_base
        worst = max(worst, n_b)
    target = worst + _combine_instrs(baseline_cores, combine_cost)
    for c in range(1, max_cores + 1):
        rep = cluster_cost(nests if single else seq, c,
                           num_lanes=num_lanes, combine_cost=combine_cost)
        if rep.n_cluster <= target:
            return c
    raise ValueError(
        f"no SSR cluster of <= {max_cores} cores matches {baseline_cores} "
        "baseline cores — combine overhead dominates this nest")


def dot_product_nest(n: int) -> LoopNest:
    """The running example (Fig. 4): sum += A[i]*B[i]."""
    return LoopNest(
        bounds=(n,),
        refs=(MemRef("A", Direction.READ, (1,)),
              MemRef("B", Direction.READ, (1,))),
        compute_per_level=(1,),
    )


def elementwise_nest(n: int, names: Sequence[str] = ("X",),
                     compute: int = 1) -> LoopNest:
    """1-D map nest: one unit-stride read stream per operand name."""
    return LoopNest(
        bounds=(n,),
        refs=tuple(MemRef(nm, Direction.READ, (1,)) for nm in names),
        compute_per_level=(compute,),
    )


def stencil_nest(n: int, taps: int) -> LoopNest:
    """Executable nest for the 1-D star stencil: y[i] = Σ_j w[j]·x[i+j].

    ``x`` is a *windowed* READ — its unit-stride walk revisits
    ``taps - 1`` neighbours per step (the halo), which ``lower_nest``
    serves with a +1-shifted twin stream and in-kernel slice taps
    (DESIGN.md §13; the §2.3 second-AGU trick at block granularity).
    ``w`` rides as a loop-invariant coefficient block (repeat register);
    the operand ``x`` carries the widened ``n + taps - 1`` logical extent.
    Shared by ``kernels/stencil.py``, ``kernel_bench`` and
    ``cluster_bench`` as both the execution schedule and the Eq. (1)–(3)
    accounting.
    """
    return LoopNest(
        bounds=(n,),
        refs=(MemRef("x", Direction.READ, (1,), window=(taps,)),
              MemRef("w", Direction.READ, (0,)),
              MemRef("y", Direction.WRITE, (1,))),
        compute_per_level=(taps,),
    )


def stencil2d_nest(h: int, w: int, taps: int) -> LoopNest:
    """Executable nest for the 2-D cross stencil (kernels/stencil.py).

    ``x`` reads a ``taps × taps`` neighbourhood around each (i, j) — a
    halo window on *both* levels, so the lowering emits 4 shifted streams
    (2**k for k halo'd levels) and stitches the widened block in-kernel.
    The operand is the padded ``(h + taps - 1, w + taps - 1)`` grid; its
    row pitch is the widened width, hence the ``w + taps - 1`` row
    coefficient.  ``wx``/``wy`` are the invariant tap coefficients.
    """
    return LoopNest(
        bounds=(h, w),
        refs=(MemRef("x", Direction.READ, (w + taps - 1, 1),
                     window=(taps, taps)),
              MemRef("wx", Direction.READ, (0, 0)),
              MemRef("wy", Direction.READ, (0, 0)),
              MemRef("y", Direction.WRITE, (w, 1))),
        compute_per_level=(0, 2 * taps),
    )


def attention_nest(sq: int, sk: int, d: int) -> LoopNest:
    """Executable nest for O[q,:] = softmax(Q·Kᵀ·scale)·V (flash form).

    Loop order (q, d, k): K/V walk the contraction level k with row
    pitch d (storage order (k, d), a permutation — GEMM's B pattern); Q
    repeats across k (§2.3 repeat register); O revisits each (q, d)
    block across the whole k walk with ``acc_kind="online_softmax"`` —
    ``lower_nest`` carries the flash-attention (max, sum, acc) triple in
    VMEM and rescales on every k step (DESIGN.md §13).  The body owns
    the score scaling and masking; the kernel owns the recurrence.
    """
    return LoopNest(
        bounds=(sq, d, sk),
        refs=(MemRef("K", Direction.READ, (0, 1, d)),
              MemRef("V", Direction.READ, (0, 1, d)),
              MemRef("Q", Direction.READ, (d, 1, 0)),
              MemRef("O", Direction.WRITE, (d, 1, 0),
                     acc_kind="online_softmax")),
        compute_per_level=(0, 0, 2),
    )


def gemv_nest(m: int, n: int) -> LoopNest:
    """Executable nest for y[m] = A[m,n]·x[n] (kernels/gemv.py).

    A walks both loops dense (row-major), x repeats across rows (the §2.3
    repeat register — coefficient 0 on the m level), y writes once per
    row and is revisited across the n walk, so ``lower_nest`` carries a
    VMEM accumulator across the contraction — the standard level-mapped
    path (no waiver); the autotuner searches its full block geometry.
    """
    return LoopNest(
        bounds=(m, n),
        refs=(MemRef("A", Direction.READ, (n, 1)),
              MemRef("x", Direction.READ, (0, 1)),   # repeated per row
              MemRef("y", Direction.WRITE, (1, 0))),
        compute_per_level=(0, 1),
    )


def gemm_nest(m: int, n: int, k: int) -> LoopNest:
    """C[m,n] += A[m,k]·B[k,n] — 3-deep, with A reused across n (repeat).

    The full §3.2 pattern, write side included: C's coefficient is 0 on the
    contraction level (k), so the output address is *revisited* across the
    whole inner loop — the lowering turns that into a VMEM accumulator that
    initialises on the first k step and drains on the last (see
    ``lowering.lower_nest``).  B walks the innermost loop with stride n
    (its storage order is (k, n), a permutation of the loop order) — fine
    for the word-granular AGU and for the level-mapped block lowering,
    not for the flattened 1-D schedule of ``lower_plan``.
    """
    return LoopNest(
        bounds=(m, n, k),
        refs=(
            MemRef("A", Direction.READ, (k, 0, 1)),   # varies with m,k; reused over n
            MemRef("B", Direction.READ, (0, 1, n)),   # varies with n,k
            MemRef("C", Direction.WRITE, (n, 1, 0)),  # revisited across k
        ),
        # fmadd inner only: C's writeback is the explicit WRITE ref above —
        # charged as a residual store when it has no lane, free when streamed
        compute_per_level=(0, 0, 1),
    )


def spmv_nest(m: int, k: int) -> LoopNest:
    """y[m] = Σ_j vals[i,j] · x[cidx[i,j]] over an ELL-packed CSR matrix.

    ``k`` is the row capacity (max nnz per row after ELL padding): vals and
    cidx walk the packed (m, k) arrays dense, x is the *gather* — an
    indirect ref whose addresses are the column indices streaming out of
    cidx (arXiv 2011.08070's index stream feeding the address stage).  y is
    revisited across j, so the lowering accumulates.  This is also the
    sparse-row generalisation of :func:`gemv_nest`: set cidx = iota and it
    degenerates to the dense row walk.
    """
    return LoopNest(
        bounds=(m, k),
        refs=(
            MemRef("vals", Direction.READ, (k, 1)),
            MemRef("cidx", Direction.READ, (k, 1)),
            MemRef("x", Direction.READ, (0, 0), index_of="cidx"),
            MemRef("y", Direction.WRITE, (1, 0)),     # revisited across j
        ),
        compute_per_level=(0, 1),
    )


def spmm_nest(m: int, c: int, k: int, pitch: int) -> LoopNest:
    """Y[m,c] = Σ_j vals[i,j] · X[cidx[i,j], c] — CSR × dense (SpMM).

    Loop order (i, c, j) keeps the contraction innermost so the lowering's
    accumulator rule applies.  vals/cidx repeat across the dense column
    loop c (coefficient 0 — the §2.3 repeat register); X is the indirect
    ref: its base address is ``pitch·cidx[i,j]`` (``pitch`` = padded row
    pitch of the flattened X table) plus the affine column walk ``c``.
    """
    return LoopNest(
        bounds=(m, c, k),
        refs=(
            MemRef("vals", Direction.READ, (k, 0, 1)),
            MemRef("cidx", Direction.READ, (k, 0, 1)),
            MemRef("X", Direction.READ, (0, 1, 0),
                   index_of="cidx", index_scale=pitch),
            MemRef("Y", Direction.WRITE, (c, 1, 0)),  # revisited across j
        ),
        compute_per_level=(0, 0, 1),
    )
