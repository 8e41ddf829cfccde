"""The port's streamed kernel suite: reduction, scan, relu, gemm, gemv, the
stencils, fft, the bitonic sort, attention, the sparse products (spmv,
spmm), the fused chains (gemv_relu, sum_sq_diff, axpy_dot, stencil1d_relu)
and DAGs (layernorm, softmax_xent, mlp_block).

Each module declares its kernel as a LoopNest plus a tagged block body
(:class:`~repro_torch.core.ssr.KernelBody`), or — scan, fft and the sort,
with a lowering waiver — as a raw Launch, and registers it; ``ops`` is the
public API with the ``ssrcfg`` switch.
"""

from . import frontend, ops, ref, registry  # noqa: F401
from .attention import ssr_flash_attention  # noqa: F401
from .bitonic import ssr_sort  # noqa: F401
from .chained import (fused_axpy_dot, fused_cases, fused_gemv_relu,  # noqa: F401
                      fused_stencil1d_relu, fused_sum_sq_diff)
from .dag import (dag_cases, fused_layernorm, fused_mlp_block,  # noqa: F401
                  fused_softmax_xent)
from .fft import ssr_fft  # noqa: F401
from .gemm import baseline_matmul, ssr_matmul  # noqa: F401
from .gemv import baseline_gemv, ssr_gemv  # noqa: F401
from .reduction import baseline_dot, ssr_dot  # noqa: F401
from .registry import entries, get, register_kernel  # noqa: F401
from .relu import baseline_relu, ssr_elementwise, ssr_relu  # noqa: F401
from .scan import baseline_scan, ssr_scan  # noqa: F401
from .sparse import ssr_sparse_gemv, ssr_spmm, ssr_spmv  # noqa: F401
from .stencil import (baseline_stencil1d, ssr_stencil1d,  # noqa: F401
                      ssr_stencil2d)
