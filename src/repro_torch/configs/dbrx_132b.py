"""dbrx-132b — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base; unverified].

40 layers, d_model 6144, 48 heads (GQA kv=8), per-expert d_ff 10752,
vocab 100352; every layer's FFN is MoE.
"""

from repro_torch.models.config import ModelConfig, MoEConfig, ScanGroup, smoke_variant

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    groups=(ScanGroup(pattern=(("attn", "moe"),), repeats=40),),
    moe=MoEConfig(num_experts=16, top_k=4, d_expert=10752),
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer_dtype="bfloat16",
    microbatches=8,
)


def smoke():
    return smoke_variant(CONFIG)
