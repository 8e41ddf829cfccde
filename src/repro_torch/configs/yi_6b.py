"""yi-6b — llama-architecture GQA decoder [arXiv:2403.04652; hf].

32 layers, d_model 4096, 32 heads (GQA kv=4), d_ff 11008, vocab 64000.
"""

from repro_torch.models.config import ModelConfig, smoke_variant, uniform_dense_groups

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    groups=uniform_dense_groups(32),
    rope_theta=5_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    microbatches=4,
)


def smoke():
    return smoke_variant(CONFIG)
