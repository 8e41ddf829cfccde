"""The stream compiler and its lowering, in PyTorch (no JAX).

``stream``, ``isa``, ``nest_analysis``, ``compiler`` and ``region`` are
copies of the reference's framework-free modules; ``agu``, ``ssr`` and
``lowering`` are ported to tensors, and ``hopper`` holds the CUDA kernels
the lowered schedules run on.
"""

from .compiler import (LoopNest, MemRef, StreamPlan, dot_product_nest,  # noqa: F401
                       elementwise_nest, gemm_nest, gemv_nest, ssrify)
from .lowering import (DEFAULT_POLICY, DEFAULT_SCHEDULE, BlockPolicy,  # noqa: F401
                       LoweringError, Schedule, lower_nest, lower_plan,
                       ssr_call)
from .region import set_ssr, ssr_enabled, ssr_region  # noqa: F401
from .ssr import BlockStream, KernelBody, StreamReport  # noqa: F401
from .stream import Direction, StreamSpec  # noqa: F401
