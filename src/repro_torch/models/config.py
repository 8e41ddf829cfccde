"""Model configuration system.

A :class:`ModelConfig` describes any of the ten assigned architectures plus
the paper's own kernel-suite workloads.  The layer stack is expressed as
*scan groups*: ``(pattern, repeats)`` pairs, where a pattern is a tuple of
(mixer, ffn) block kinds.  A group's parameters and caches are stacked on a
leading ``repeats`` axis, and the port walks that axis in a Python loop.

Block kinds
-----------
mixer: ``attn`` (GQA, optional qk-norm / sliding window), ``mla``
(DeepSeek multi-head latent attention), ``mamba`` (selective SSM),
``mlstm`` / ``slstm`` (xLSTM cells).
ffn:   ``mlp`` (SwiGLU), ``gelu_mlp`` (encoder-style), ``moe``
(top-k routed experts, optional shared expert), ``none`` (xLSTM blocks
carry their own projections).

Every kind runs on one device; under a device mesh the MoE takes the
reference's expert-parallel dispatch (``models/moe.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # dispatch implementation: "auto" picks expert parallelism when a mesh
    # with a dividing 'model' axis is ambient; "xla" forces the plain path
    impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_dim(self) -> int:
        """Per-token per-layer latent cache width (the MLA selling point)."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ScanGroup:
    """``pattern`` applied ``repeats`` times, parameters stacked per repeat."""

    pattern: Tuple[Tuple[str, str], ...]  # ((mixer, ffn), ...)
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    groups: Tuple[ScanGroup, ...]
    head_dim: Optional[int] = None
    qk_norm: bool = False
    window: Optional[int] = None     # sliding-window attention (SWA)
    rope_theta: float = 10000.0
    causal: bool = True              # False => encoder-only (no decode step)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    frontend: Optional[str] = None   # 'audio' | 'vision' | None (stub inputs)
    frontend_len: int = 0            # prefix positions fed by the frontend
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # distribution / training knobs (overridable per run)
    remat: bool = True
    microbatches: int = 1
    optimizer_dtype: str = "float32"
    # dtype of the cross-microbatch gradient accumulator (the train step's;
    # the 405B/671B configs use bf16)
    grad_accum_dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be divisible by num_kv_heads")
        for g in self.groups:
            for mixer, ffn in g.pattern:
                if mixer not in ("attn", "mla", "mamba", "mlstm", "slstm"):
                    raise ValueError(f"unknown mixer {mixer}")
                if ffn not in ("mlp", "gelu_mlp", "moe", "none", "dense_mlp"):
                    raise ValueError(f"unknown ffn {ffn}")
                if ffn == "moe" and self.moe is None:
                    raise ValueError("moe block without MoEConfig")

    # -- derived ----------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return sum(g.num_layers for g in self.groups)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """True if a 500k-token decode context is feasible.

        Recurrent state (ssm/xlstm), sliding window (bounded KV), or MLA
        latent cache (O(seq · 576 B) per layer) qualify; dense full-KV
        attention does not.
        """
        if self.family in ("ssm", "hybrid"):
            return True
        if self.window is not None:
            return True
        if self.mla is not None:
            return True
        return False

    @property
    def has_decode(self) -> bool:
        return self.causal

    def param_count(self) -> int:
        """Exact parameter count (used for 6·N·D roofline bookkeeping),
        from the parameters built on the ``meta`` device: shapes, no
        storage (qwen3-14b would take 59 GB in f32)."""
        from . import blocks, model  # noqa: PLC0415

        params = model.init_params(0, self, device="meta")
        return sum(math.prod(x.shape) for x in blocks.tree_leaves(params))

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top-k + shared experts):
        every leaf whose key path holds ``experts`` counts ``k / e`` of its
        size, from the ``meta`` tree (no storage)."""
        total = self.param_count()
        if self.moe is None:
            return total
        from torch.utils import _pytree as pytree  # noqa: PLC0415

        from . import model  # noqa: PLC0415

        params = model.init_params(0, self, device="meta")
        e, k = self.moe.num_experts, self.moe.top_k
        inactive = 0
        for path, leaf in pytree.tree_flatten_with_path(params)[0]:
            if leaf is not None and "experts" in pytree.keystr(path):
                inactive += math.prod(leaf.shape) * (1 - k / e)
        return int(total - inactive)


def uniform_dense_groups(num_layers: int, ffn: str = "mlp",
                         mixer: str = "attn") -> Tuple[ScanGroup, ...]:
    return (ScanGroup(pattern=((mixer, ffn),), repeats=num_layers),)


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests.

    Shrinks width/depth/experts/vocab while preserving every structural
    feature (pattern kinds, GQA ratio, MLA/MoE/SWA presence).
    """
    ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, heads // min(ratio, heads))
    head_dim = 16
    d_model = heads * head_dim * 2
    groups = tuple(
        dataclasses.replace(g, repeats=1) for g in cfg.groups[:2]
    )
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, num_experts=min(4, cfg.moe.num_experts),
            top_k=min(2, cfg.moe.top_k), d_expert=32,
            num_shared=min(1, cfg.moe.num_shared))
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                        qk_rope_head_dim=8, v_head_dim=16)
    mamba = cfg.mamba and dataclasses.replace(cfg.mamba, d_state=4)
    defaults = dict(
        name=cfg.name + "-smoke", d_model=d_model, num_heads=heads,
        num_kv_heads=kv, d_ff=(0 if cfg.d_ff == 0 else 4 * head_dim),
        vocab_size=256, groups=groups, head_dim=head_dim, moe=moe, mla=mla,
        mamba=mamba, window=(8 if cfg.window else None),
        frontend_len=(8 if cfg.frontend else 0),
        param_dtype="float32", compute_dtype="float32",
        remat=False, microbatches=1,
    )
    defaults.update(overrides)
    return dataclasses.replace(cfg, **defaults)
