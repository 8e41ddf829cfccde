"""The port's streamed kernel suite: reduction, relu, gemm and gemv.

Each module declares its kernel as a LoopNest plus a tagged block body
(:class:`~repro_torch.core.ssr.KernelBody`) and registers it; ``ops`` is
the public API with the ``ssrcfg`` switch.
"""

from . import frontend, ops, ref, registry  # noqa: F401
from .gemm import ssr_matmul  # noqa: F401
from .gemv import ssr_gemv  # noqa: F401
from .reduction import ssr_dot  # noqa: F401
from .registry import entries, get, register_kernel  # noqa: F401
from .relu import ssr_elementwise, ssr_relu  # noqa: F401
