"""Public kernel API with ``ssrcfg`` dispatch.

Every op picks the streamed kernel inside an ``ssr_region`` (or with
``ssr=True``) and the plain-PyTorch path otherwise — the software form of
the paper's opt-in CSR (§2.2.2): flipping the bit never changes semantics,
only the engine.  ``device=`` picks where the call runs (default:
:func:`repro_torch.default_device`).
"""

from __future__ import annotations

from typing import Optional

from .. import DeviceLike
from . import registry


def dot(x, y, *, ssr: Optional[bool] = None, device: DeviceLike = None):
    return registry.dispatch("reduction", x, y, ssr=ssr, device=device)


def relu(x, *, ssr: Optional[bool] = None, device: DeviceLike = None):
    return registry.dispatch("relu", x, ssr=ssr, device=device)


def gemv(a, x, *, ssr: Optional[bool] = None, device: DeviceLike = None):
    return registry.dispatch("gemv", a, x, ssr=ssr, device=device)


def matmul(a, b, *, ssr: Optional[bool] = None, device: DeviceLike = None,
           **kw):
    return registry.dispatch("gemm", a, b, ssr=ssr, device=device, **kw)


# -- fused (stream-chained) ops ---------------------------------------------
# One kernel each: the producer's result reaches the consumer on chip, never
# through device memory.  ``ssr=False`` runs the PyTorch oracle.


def gemv_relu(a, x, *, ssr: Optional[bool] = None,
              device: DeviceLike = None):
    return registry.dispatch("gemv_relu", a, x, ssr=ssr, device=device)


def sum_sq_diff(x, y, *, ssr: Optional[bool] = None,
                device: DeviceLike = None):
    return registry.dispatch("sum_sq_diff", x, y, ssr=ssr, device=device)


def axpy_dot(x, y, w, *, alpha: float = 1.0, ssr: Optional[bool] = None,
             device: DeviceLike = None):
    return registry.dispatch("axpy_dot", x, y, w, alpha=alpha, ssr=ssr,
                             device=device)
