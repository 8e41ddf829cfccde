"""jamba-v0.1-52b — Mamba+attention 1:7 interleave with MoE [arXiv:2403.19887; hf].

32 layers (4 Jamba blocks of 8), d_model 4096, 32 heads (GQA kv=8),
d_ff 14336, vocab 65536; 16 experts top-2, MoE every other layer, the
single attention layer at position 4 of each 8-layer block.
"""

from repro_torch.models.config import (MambaConfig, ModelConfig, MoEConfig,
                                 ScanGroup, smoke_variant)

_PATTERN = (
    ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("attn", "moe"),
    ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    groups=(ScanGroup(pattern=_PATTERN, repeats=4),),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer_dtype="bfloat16",
    microbatches=8,
)


def smoke():
    return smoke_variant(CONFIG)
