"""Optimisers and distributed-optimisation tricks: AdamW (``adamw``) and
int8 gradient compression (``compress``, with its all-reduce over a mesh
axis, ``compressed_psum``)."""

from .adamw import AdamWConfig, global_norm, init, update, warmup_cosine  # noqa: F401
from .compress import (  # noqa: F401
    compress_leaf,
    compressed_psum,
    dequantize,
    init_residuals,
    quantize,
)
