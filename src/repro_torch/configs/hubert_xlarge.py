"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447; unverified].

48 layers, d_model 1280, 16 heads, d_ff 5120, target vocab 504 (k-means
units).  The conv waveform frontend is a STUB per the brief: ``input_specs``
feeds precomputed frame embeddings (B, S, d_model).  Encoder-only ⇒ no
decode shapes (DESIGN.md §4).  Positional handling: HuBERT's conv positional
embedding is replaced by RoPE in this implementation (positional mechanism
is orthogonal to operand streaming; recorded as a hardware-adaptation note).
"""

from repro_torch.models.config import ModelConfig, smoke_variant, uniform_dense_groups

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    head_dim=80,
    groups=uniform_dense_groups(48, ffn="gelu_mlp"),
    causal=False,
    frontend="audio",
    frontend_len=4096,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    microbatches=2,
)


def smoke():
    return smoke_variant(CONFIG)
