"""Exact ISA-level model of the paper's §4.1 performance analysis.

Everything here is closed-form and technology-independent ("Architectural
performance improvements in terms of cycles or unit utilization are technology
independent", §5.1), so we reproduce the paper's numbers *exactly* and assert
them in tests — this is the faithful-reproduction baseline demanded by the
brief.  Sources:

* Eq. (1)/(2): instruction-count model for SSR vs baseline loop nests.
* Eq. (3): amortization break-even  4d + 2 ≤ Σ_i Π_{n≤i} L_n.
* Table 2: hot-loop instruction counts, utilization η, speedup S for
  {standard RV32, +hardware loops, +post-increment} × {int32, fp32}.
* Fig. 4: dot product, N = 1000 → 3001 baseline vs 1012 SSR instructions.
* Fig. 6: η for reductions over d-dimensional hypercubes of side l.
* Eq. (5)/(6) & §5.6.1: utilization limits 33 % → 100 %; η(100)=93 %,
  η(1000)=99.3 % (the paper's "overhead 7, body 1" accounting).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

# --------------------------------------------------------------------------
# Eq. (1) / (2): executed-instruction model for a d-deep loop nest.
# Index convention follows the paper: i = 1 is the OUTERMOST level, so
# Π_{n=1..i} L_n grows toward the innermost loop.
# --------------------------------------------------------------------------


def _check(L: Sequence[int], I: Sequence[int]) -> None:
    if len(L) != len(I) or not L:
        raise ValueError("L and I must be equal-length, non-empty")
    if any(x < 1 for x in L) or any(x < 0 for x in I):
        raise ValueError("bounds must be >=1 and body counts >=0")


def n_ssr(L: Sequence[int], I: Sequence[int], s: int) -> int:
    """Eq. (1): N_ssr = (4ds + s + 2) + Σ_i (I_i + 1)·Π_{n≤i} L_n − Π_i L_i.

    (a) = 4ds + s + 2 is the one-time data-mover setup before the nest
    (Fig. 4 ①: per lane per dim a bound and a stride store, the stride
    immediate, the trigger store, plus the two ``csrwi`` enable/disable and
    the config-base ``la``).
    """
    _check(L, I)
    d = len(L)
    setup = 4 * d * s + s + 2
    prod = 1
    total = setup
    for Li, Ii in zip(L, I):
        prod *= Li
        total += (Ii + 1) * prod
    total -= prod
    return total


def n_base(L: Sequence[int], I: Sequence[int], s: int) -> int:
    """Eq. (2): N_base = 1 + Σ_i (I_i + 1 + s)·Π_{n≤i} L_n − Π_i L_i.

    (b) = s explicit memory instructions per iteration that SSR elides; the
    +1 per level is loop maintenance, cancelled for the innermost level by
    the trailing −Π L (hardware loops need no in-loop branch).
    """
    _check(L, I)
    prod = 1
    total = 1
    for Li, Ii in zip(L, I):
        prod *= Li
        total += (Ii + 1 + s) * prod
    total -= prod
    return total


def breakeven_lhs(d: int) -> int:
    """Eq. (3) LHS: 4d + 2."""
    return 4 * d + 2


def breakeven_rhs(L: Sequence[int]) -> int:
    """Eq. (3) RHS: Σ_i Π_{n≤i} L_n."""
    prod, total = 1, 0
    for Li in L:
        prod *= Li
        total += prod
    return total


def ssr_profitable(L: Sequence[int]) -> bool:
    """Eq. (3): SSR wins iff 4d + 2 ≤ Σ_i Π_{n≤i} L_n.

    Remarkably independent of both the per-level body size I_i and the
    data-mover count s (paper §4.1.1) — asserted by a hypothesis test.
    """
    return breakeven_lhs(len(L)) <= breakeven_rhs(L)


def min_side_length(d: int) -> int:
    """Smallest hypercube side l such that an l^d nest is SSR-profitable.

    Paper: "more than 5, 4, 1, or 1 overall iterations l^d for 1D, 2D, 3D,
    4D" → minimal sides 6, 3, 2, 2.
    """
    l = 1
    while not ssr_profitable([l] * d):
        l += 1
    return l


# --------------------------------------------------------------------------
# Utilization of a d-dimensional reduction (Fig. 6) and the §5.6.1 limits.
# --------------------------------------------------------------------------


def utilization_reduction(l: int, d: int, s: int = 2) -> float:
    """Useful utilization η for a reduction over an l^d hypercube with SSRs.

    One useful op (fmadd) per element; per-level body I = (0,…,0,1); Eq. (1)
    gives total instructions.  Fig. 6's family of curves.
    """
    L = [l] * d
    I = [0] * (d - 1) + [1]
    return (l ** d) / n_ssr(L, I, s)


def utilization_limit_dot(n: int, ssr: bool) -> float:
    """Eq. (5)/(6) with the paper's §5.6.1 accounting.

    Without SSR: overhead 2, body 3  → N/(2+3N) → 33 %.
    With SSR:    overhead 7, body 1  → N/(7+N)  → 100 %;
    η(100) = 93 %, η(1000) = 99.3 % (§5.6.1).  Note the paper uses a leaner
    setup accounting here (7) than Fig. 4's full count (12 = Eq. (1) setup
    with d=1, s=2); both yield the same limit.  We reproduce each where the
    paper uses it.
    """
    if ssr:
        return n / (7 + n)
    return n / (2 + 3 * n)


# --------------------------------------------------------------------------
# Table 2: hot-loop schedules.  Each row is an explicit instruction mix for
# one unrolled hot-loop body, from which N, η and S follow.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HotLoop:
    """One steady-state hot-loop body (per U unrolled iterations)."""

    loads: int
    stores: int
    ptr_arith: int   # pointer/counter arithmetic
    branches: int
    compute: int     # instructions that contribute to the result (fmadd/mac)

    @property
    def n(self) -> int:
        return self.loads + self.stores + self.ptr_arith + self.branches + self.compute

    @property
    def eta(self) -> float:
        return self.compute / self.n


@dataclasses.dataclass(frozen=True)
class Table2Row:
    kernel: str
    arith: str
    unroll: int
    base: HotLoop
    ssr: HotLoop

    @property
    def speedup(self) -> float:
        return self.base.n / self.ssr.n


def table2() -> Tuple[Table2Row, ...]:
    """The six rows of Table 2, as explicit schedules.

    * Standard RV32 (U=1): base = 2 loads + 2 pointer bumps + 1 mac + 1
      branch/counter = 6 (η=17 %); SSR elides loads & pointer bumps but the
      software loop remains: counter dec + mac + branch = 3 (η=33 %) → 2×.
    * +Hardware loops (int, U=1): base = 2 loads + 2 bumps + mac = 5 (η=20 %);
      SSR = mac alone = 1 (η=100 %) → 5×.
    * +Post-increment (int, U=2): base = 4 p.lw! + 2 mac = 6 (η=33 %);
      SSR = 2 mac (2-fold unroll hides the 2-cycle load latency) → 3×.
    * fp32 standard RV32: same counts as int32.
    * +HWL (fp, U=3): base = 6 flw + 2 ptr bumps (amortised over the unroll)
      + 3 fmadd = 11 (η=27 %); SSR = 3 fmadd (3-fold unroll hides the 3-cycle
      FMA latency on the accumulator) → 3.7×.
    * +Post-incr (fp, U=3): base = 6 p.flw! + 3 fmadd = 9 (η=33 %);
      SSR = 3 fmadd → 3×.
    """
    rows = (
        Table2Row("Standard RV32", "int32", 1,
                  HotLoop(loads=2, stores=0, ptr_arith=2, branches=1, compute=1),
                  HotLoop(loads=0, stores=0, ptr_arith=1, branches=1, compute=1)),
        Table2Row("+ Hardware Loops", "int32", 1,
                  HotLoop(loads=2, stores=0, ptr_arith=2, branches=0, compute=1),
                  HotLoop(loads=0, stores=0, ptr_arith=0, branches=0, compute=1)),
        Table2Row("+ Post-Increment", "int32", 2,
                  HotLoop(loads=4, stores=0, ptr_arith=0, branches=0, compute=2),
                  HotLoop(loads=0, stores=0, ptr_arith=0, branches=0, compute=2)),
        Table2Row("Standard RV32", "fp32", 1,
                  HotLoop(loads=2, stores=0, ptr_arith=2, branches=1, compute=1),
                  HotLoop(loads=0, stores=0, ptr_arith=1, branches=1, compute=1)),
        Table2Row("+ Hardware Loops", "fp32", 3,
                  HotLoop(loads=6, stores=0, ptr_arith=2, branches=0, compute=3),
                  HotLoop(loads=0, stores=0, ptr_arith=0, branches=0, compute=3)),
        Table2Row("+ Post-Increment", "fp32", 3,
                  HotLoop(loads=6, stores=0, ptr_arith=0, branches=0, compute=3),
                  HotLoop(loads=0, stores=0, ptr_arith=0, branches=0, compute=3)),
    )
    return rows


# --------------------------------------------------------------------------
# Kernel-suite schedules (§4.2 / Fig. 7 / Fig. 8).  Steady-state hot-loop
# models for the eight evaluated kernels on RI5CY (+HWL +post-increment
# baseline, the paper's strongest baseline) vs SSR.  The paper reports the
# resulting speedups as 2.0×–3.7×, "generally at or above 2×" — our models
# must land inside that band (asserted in tests, reported in benchmarks).
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelModel:
    name: str
    problem: str
    base: HotLoop          # per steady-state body
    ssr: HotLoop
    iters: int             # hot-loop executions for the paper's problem size
    base_setup: int = 2
    ssr_setup: int = 12    # Eq.(1) setup with d=1, s=2 unless overridden

    @property
    def speedup(self) -> float:
        nb = self.base_setup + self.base.n * self.iters
        ns = self.ssr_setup + self.ssr.n * self.iters
        return nb / ns

    @property
    def eta_base(self) -> float:
        return self.base.eta

    @property
    def eta_ssr(self) -> float:
        nb = self.ssr_setup + self.ssr.n * self.iters
        return (self.ssr.compute * self.iters) / nb


def kernel_suite() -> Tuple[KernelModel, ...]:
    """The eight §4.2 kernels as steady-state schedules.

    Baseline = RI5CY with hardware loops + post-increment loads (the paper's
    own baseline).  Stores count like loads; SSR elides both.  Where a kernel
    keeps coefficients resident in registers we model the *hot* loop only, as
    the paper does ("implementations are fully optimized such that the loop
    bodies only consist of mandatory non-amortizable instructions").
    """
    return (
        # dot product over 2048: 2 loads + fmadd  →  fmadd          (3×)
        KernelModel("reduction", "dot product, n=2048",
                    HotLoop(2, 0, 0, 0, 1), HotLoop(0, 0, 0, 0, 1), 2048),
        # prefix sums over 4096: load + add + store → add           (3×)
        KernelModel("scan", "prefix sums, n=4096",
                    HotLoop(1, 1, 0, 0, 1), HotLoop(0, 0, 0, 0, 1), 4096),
        # 1D 11-point stencil: taps' coefficients reside in registers; per
        # output: 11 loads + 11 fmadd + 1 store → 11 fmadd (+ streamed store)
        KernelModel("stencil1d", "11-point star, n=1024",
                    HotLoop(11, 1, 0, 0, 11), HotLoop(0, 0, 0, 0, 11), 1024),
        # 2D 11-diameter star stencil (5+5+1 taps per axis → 11 taps): same
        # structure per output point over a 64×64 grid, 2-deep nest.
        KernelModel("stencil2d", "11-point star, 64×64",
                    HotLoop(11, 1, 0, 0, 11), HotLoop(0, 0, 0, 0, 11), 64 * 64,
                    ssr_setup=4 * 2 * 2 + 2 + 2),
        # GEMV 64×64: inner dot of 64 (2 loads + fmadd → fmadd), x streamed
        # with repeat; per row one store handled by write stream.  2-deep.
        KernelModel("gemv", "64×64 · 64",
                    HotLoop(2, 0, 0, 0, 1), HotLoop(0, 0, 0, 0, 1), 64 * 64,
                    base_setup=2 + 64,           # per-row store+ptr in base
                    ssr_setup=4 * 2 * 2 + 2 + 2),
        # GEMM 32×32×32: inner fmadd; A-element reuse via repeat register,
        # B streamed; C accumulated in registers per tile.  3-deep nest.
        KernelModel("gemm", "32×32 · 32×32",
                    HotLoop(2, 0, 0, 0, 1), HotLoop(0, 0, 0, 0, 1), 32 ** 3,
                    base_setup=2 + 32 * 32,      # C writebacks in base
                    ssr_setup=4 * 3 * 2 + 2 + 2 + 32 * 32),
        # ReLU over 1024: load + max + store → max                  (3×)
        KernelModel("relu", "max(0,x), n=1024",
                    HotLoop(1, 1, 0, 0, 1), HotLoop(0, 0, 0, 0, 1), 1024),
        # FFT radix-2 butterfly over 2048 pts, log2(n)=11 stages: per
        # butterfly 4 data loads + 2 twiddle loads + 4 stores vs 10 flops
        # (complex mul = 4 mul + 2 add, two complex adds = 4 add).  SSR
        # streams data+twiddles+results; index swizzle folded into AGU
        # strides per stage.
        KernelModel("fft", "radix-2, n=2048",
                    HotLoop(6, 4, 0, 0, 10), HotLoop(0, 0, 0, 0, 10),
                    (2048 // 2) * 11,
                    base_setup=11 * 4, ssr_setup=11 * (4 * 2 * 2 + 2 + 2)),
        # bitonic sort network over 1024: compare-exchange = 2 loads +
        # min + max + 2 stores → min + max.  log2(n)(log2(n)+1)/2 = 55
        # stages of n/2 comparators.
        KernelModel("bitonic", "sort network, n=1024",
                    HotLoop(2, 2, 0, 0, 2), HotLoop(0, 0, 0, 0, 2),
                    (1024 // 2) * 55,
                    base_setup=55 * 2, ssr_setup=55 * (4 * 1 * 2 + 2 + 2)),
    )


def fig4_dot_product(n: int = 1000, s: int = 2) -> Tuple[int, int]:
    """Fig. 4's headline counts: (baseline, SSR) executed instructions.

    n=1000 → (3001, 1012).
    """
    return n_base([n], [1], s), n_ssr([n], [1], s)


# --------------------------------------------------------------------------
# §5.3/5.4 cluster model: Amdahl with per-core SSR speedup.
# --------------------------------------------------------------------------


def cluster_time(n_cores: int, ssr: bool, *, work: float = 1.0,
                 sync_overhead: float = 0.0444,
                 ssr_speedup: float = 3.0) -> float:
    """Relative execution time of a kernel on an n-core cluster (§5.3/5.4).

    T(n) = σ·(1 − 1/n) + work / (n · speed): the compute is SSR-accelerated,
    but work-splitting/synchronisation (σ, the hardware-barrier/event-unit
    cost) is not — which is exactly why the paper's single-core 3× drops to
    ~2.2× on six cores (§5.4).  σ is calibrated to that 2.2× point; the same
    σ then *predicts* Fig. 11's equivalences (2 SSR cores ≈ 6 baseline cores
    for 3×-kernels, 3 cores for 2×-kernels) — asserted in tests.
    """
    speed = ssr_speedup if ssr else 1.0
    return sync_overhead * (1.0 - 1.0 / n_cores) + work / (n_cores * speed)


def equivalent_cores(target_cores: int = 6, *, ssr_speedup: float = 3.0,
                     sync_overhead: float = 0.0444) -> int:
    """Smallest SSR-core count matching an n-core non-SSR cluster (Fig. 11)."""
    t_target = cluster_time(target_cores, ssr=False,
                            sync_overhead=sync_overhead,
                            ssr_speedup=ssr_speedup)
    n = 1
    while cluster_time(n, ssr=True, sync_overhead=sync_overhead,
                       ssr_speedup=ssr_speedup) > t_target:
        n += 1
    return n


def utilization_class(issue_width: int, streaming: bool) -> float:
    """§5.6.1 "efficiency classes" on long reductions (Table 3's Util. Limit).

    Single-issue in-order: 33 %; dual-issue: 50 %; streaming/vector: 100 %.
    """
    if streaming:
        return 1.0
    if issue_width == 1:
        return 1.0 / 3.0
    if issue_width == 2:
        return 0.5
    return min(1.0, issue_width / 3.0)
