"""Optimisers and distributed-optimisation tricks: AdamW (``adamw``) and
int8 gradient compression (``compress``; its mesh all-reduce is slice 9d)."""

from .adamw import AdamWConfig, global_norm, init, update, warmup_cosine  # noqa: F401
from .compress import (  # noqa: F401
    compress_leaf,
    compressed_psum,
    dequantize,
    init_residuals,
    quantize,
)
