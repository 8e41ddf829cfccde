"""Input-shape cells for the LM-family architectures (brief: 4 per arch).

``train_4k``    seq 4096,   global batch 256  → lowers ``train_step``
``prefill_32k`` seq 32768,  global batch 32   → lowers ``prefill_step``
``decode_32k``  context 32768, batch 128      → lowers ``serve_step``
``long_500k``   context 524288, batch 1       → lowers ``serve_step``

Skips (DESIGN.md §4): encoder-only archs have no decode step; ``long_500k``
requires a sub-quadratic context mechanism (recurrent state, sliding window,
or MLA latent cache).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
)


def get_shape(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def skip_reason(cfg: ModelConfig, cell: ShapeCell) -> Optional[str]:
    """None if the (arch × shape) cell runs; else the documented skip."""
    if cell.kind == "decode" and not cfg.has_decode:
        return "encoder-only architecture: no decode step"
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention architecture: 500k-token KV cache is "
                "quadratic-regime; skipped per brief")
    return None


def cells_for(cfg: ModelConfig) -> List[Tuple[ShapeCell, Optional[str]]]:
    return [(s, skip_reason(cfg, s)) for s in SHAPES]
