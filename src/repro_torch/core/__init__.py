"""The stream compiler and its lowering, in PyTorch (no JAX).

``stream``, ``isa``, ``nest_analysis``, ``compiler`` and ``region`` are
copies of the reference's framework-free modules; ``agu``, ``ssr`` and
``lowering`` are ported to tensors, and ``hopper`` holds the CUDA kernels
the lowered schedules run on.  The names re-exported here are the
reference package's, but for its TPU-only ``ssr_pallas``,
``VMEM_BUDGET_BYTES`` and ``check_mxu_alignment``: a kernel here checks its
CTA's shared memory against the card (``hopper.accepts``) instead.
"""

from .stream import (Direction, MAX_DIMS, StreamSpec,  # noqa: F401
                     contiguous, strided_2d, validate_no_race)
from .agu import (address_sequence, affine_coefficients,  # noqa: F401
                  block_grid, gather_stream, scatter_stream)
from .isa import (HotLoop, KernelModel, Table2Row, breakeven_lhs,  # noqa: F401
                  breakeven_rhs, cluster_time, equivalent_cores,
                  fig4_dot_product, kernel_suite, min_side_length, n_base,
                  n_ssr, ssr_profitable, table2, utilization_class,
                  utilization_limit_dot, utilization_reduction)
from .ssr import (BlockStream, KernelBody, StreamReport,  # noqa: F401
                  auto_block)
from . import nest_analysis  # noqa: F401
from .compiler import (Allocation, COMBINE_COST, ChainDAG,  # noqa: F401
                       ChainError, ChainLink, ChainedPlan, ClusterReport,
                       CoreCost, DagEdge, LoopNest, MemRef, StreamPlan,
                       attention_nest, chain, chain_dag, cluster_cost,
                       dot_product_nest, elementwise_nest, gemm_nest,
                       gemv_nest, iso_performance_cores, spmm_nest,
                       spmv_nest, ssrify, stencil2d_nest, stencil_nest)
from .lowering import (DEFAULT_POLICY, DEFAULT_SCHEDULE,  # noqa: F401
                       BlockPolicy, LoweredChain, LoweredNest, LoweredPlan,
                       LoweredStream, LoweringError, NestStream, Schedule,
                       lower_chain, lower_nest, lower_plan, plan_stats,
                       ssr_call, ssr_chain_call, ssr_dag_call)
from . import autotune  # noqa: F401
from .autotune import (ScheduleCache, TuneResult,  # noqa: F401
                       candidate_schedules, schedule_is_legal)
from .region import set_ssr, ssr_enabled, ssr_region  # noqa: F401
