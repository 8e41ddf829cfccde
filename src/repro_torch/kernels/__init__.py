"""The port's streamed kernel suite: reduction, relu, gemm, gemv, the fused
chains (gemv_relu, sum_sq_diff, axpy_dot) and DAGs (layernorm, softmax_xent,
mlp_block).

Each module declares its kernel as a LoopNest plus a tagged block body
(:class:`~repro_torch.core.ssr.KernelBody`) and registers it; ``ops`` is
the public API with the ``ssrcfg`` switch.
"""

from . import frontend, ops, ref, registry  # noqa: F401
from .chained import (fused_axpy_dot, fused_cases, fused_gemv_relu,  # noqa: F401
                      fused_sum_sq_diff)
from .dag import (dag_cases, fused_layernorm, fused_mlp_block,  # noqa: F401
                  fused_softmax_xent)
from .gemm import ssr_matmul  # noqa: F401
from .gemv import ssr_gemv  # noqa: F401
from .reduction import ssr_dot  # noqa: F401
from .registry import entries, get, register_kernel  # noqa: F401
from .relu import ssr_elementwise, ssr_relu  # noqa: F401
