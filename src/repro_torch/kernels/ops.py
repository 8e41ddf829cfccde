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


def prefix_sum(x, *, ssr: Optional[bool] = None, device: DeviceLike = None):
    return registry.dispatch("scan", x, ssr=ssr, device=device)


def relu(x, *, ssr: Optional[bool] = None, device: DeviceLike = None):
    return registry.dispatch("relu", x, ssr=ssr, device=device)


def gemv(a, x, *, ssr: Optional[bool] = None, device: DeviceLike = None):
    return registry.dispatch("gemv", a, x, ssr=ssr, device=device)


def matmul(a, b, *, ssr: Optional[bool] = None, device: DeviceLike = None,
           **kw):
    return registry.dispatch("gemm", a, b, ssr=ssr, device=device, **kw)


def stencil1d(x, w, *, ssr: Optional[bool] = None,
              device: DeviceLike = None):
    return registry.dispatch("stencil1d", x, w, ssr=ssr, device=device)


def stencil2d(x, wx, wy, *, ssr: Optional[bool] = None,
              device: DeviceLike = None):
    return registry.dispatch("stencil2d", x, wx, wy, ssr=ssr, device=device)


def flash_attention(q, k, v, *, causal: bool = False,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    ssr: Optional[bool] = None, device: DeviceLike = None):
    """Attention over q (…, Sq, D), k/v (…, Sk, D); leading dims are heads,
    run by the streamed kernel in one launch."""
    return registry.dispatch("attention", q, k, v, causal=causal,
                             window=window, scale=scale, ssr=ssr,
                             device=device)


def spmv(data, indices, indptr, x, *, ssr: Optional[bool] = None,
         device: DeviceLike = None):
    """CSR sparse-matrix × dense-vector via the indirection-stream path."""
    return registry.dispatch("spmv", data, indices, indptr, x, ssr=ssr,
                             device=device)


def spmm(data, indices, indptr, x, *, ssr: Optional[bool] = None,
         device: DeviceLike = None):
    """CSR sparse-matrix × dense-matrix via the indirection-stream path."""
    return registry.dispatch("spmm", data, indices, indptr, x, ssr=ssr,
                             device=device)


def sparse_gemv(data, indices, indptr, x, *, ssr: Optional[bool] = None,
                device: DeviceLike = None):
    """The sparse-row generalisation of :func:`gemv` (alias of spmv)."""
    return registry.dispatch("spmv", data, indices, indptr, x, ssr=ssr,
                             device=device)


def fft(re, im, *, ssr: Optional[bool] = None, device: DeviceLike = None):
    """Forward DFT of power-of-two rows, split re/im; leading dims are a
    batch of transforms."""
    return registry.dispatch("fft", re, im, ssr=ssr, device=device)


def sort(x, *, ssr: Optional[bool] = None, device: DeviceLike = None):
    """Ascending sort of power-of-two rows (the bitonic network); leading
    dims are a batch of rows."""
    return registry.dispatch("bitonic", x, ssr=ssr, device=device)


# -- fused (stream-chained) ops ---------------------------------------------
# One kernel each: the producer's result reaches the consumer on chip, never
# through device memory.  ``ssr=False`` runs the PyTorch oracle.


def gemv_relu(a, x, *, ssr: Optional[bool] = None,
              device: DeviceLike = None):
    return registry.dispatch("gemv_relu", a, x, ssr=ssr, device=device)


def sum_sq_diff(x, y, *, ssr: Optional[bool] = None,
                device: DeviceLike = None):
    return registry.dispatch("sum_sq_diff", x, y, ssr=ssr, device=device)


def stencil1d_relu(x, w, *, ssr: Optional[bool] = None,
                   device: DeviceLike = None):
    return registry.dispatch("stencil1d_relu", x, w, ssr=ssr, device=device)


def axpy_dot(x, y, w, *, alpha: float = 1.0, ssr: Optional[bool] = None,
             device: DeviceLike = None):
    return registry.dispatch("axpy_dot", x, y, w, alpha=alpha, ssr=ssr,
                             device=device)
