"""internvl2-26b — InternViT frontend + InternLM2-20B backbone [arXiv:2404.16821; hf].

Backbone: 48 layers, d_model 6144, 48 heads (GQA kv=8), d_ff 16384,
vocab 92553.  The InternViT vision tower is a STUB per the brief:
``input_specs`` provides 256 precomputed patch embeddings per image which a
linear adapter projects into the LM space (prefix positions).
"""

from repro_torch.models.config import ModelConfig, smoke_variant, uniform_dense_groups

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    groups=uniform_dense_groups(48),
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_len=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    microbatches=4,
)


def smoke():
    return smoke_variant(CONFIG)
