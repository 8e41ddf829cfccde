"""llama3-405b — dense GQA, 128k vocab [arXiv:2407.21783; unverified].

126 layers, d_model 16384, 128 heads (GQA kv=8), d_ff 53248, vocab 128256.
The scale stressor: its bf16 weights alone (812 GB) exceed one card, so no
card serves or trains it whole; the dry run (``launch/dryrun.py``) reckons
a rank's share of it on the production meshes.
"""

from repro_torch.models.config import ModelConfig, smoke_variant, uniform_dense_groups

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    head_dim=128,
    groups=uniform_dense_groups(126),
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
    microbatches=16,
)


def smoke():
    return smoke_variant(CONFIG)
