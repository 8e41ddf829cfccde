"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf].

24 layers, d_model 2560, 32 heads (GQA kv=8), d_ff 6912, vocab 32000,
SWA window 4096.  The bounded ring-buffer KV cache is what makes the
long_500k decode cell runnable (DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig, smoke_variant, uniform_dense_groups

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    head_dim=80,
    groups=uniform_dense_groups(24),
    window=4096,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    microbatches=2,
)


def smoke():
    return smoke_variant(CONFIG)
