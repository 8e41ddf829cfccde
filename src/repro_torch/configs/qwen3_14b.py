"""qwen3-14b — GQA with per-head qk RMS-norm [hf:Qwen/Qwen3-8B; hf].

40 layers, d_model 5120, 40 heads (GQA kv=8), d_ff 17408, vocab 151936.
"""

from repro_torch.models.config import ModelConfig, smoke_variant, uniform_dense_groups

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    groups=uniform_dense_groups(40),
    qk_norm=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    microbatches=4,
)


def smoke():
    return smoke_variant(CONFIG)
