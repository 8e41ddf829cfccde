"""deepseek-v3-671b — MLA + 1 shared / 256 routed top-8 MoE [arXiv:2412.19437; hf].

61 layers (first 3 dense, 58 MoE), d_model 7168, 128 heads with multi-head
latent attention (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128),
dense d_ff 18432, expert d_ff 2048 (the assignment table's d_ff=2048 is the
per-expert width), vocab 129280.  MTP (multi-token prediction) is omitted —
it is a training-objective add-on orthogonal to operand streaming; noted in
DESIGN.md §Arch-applicability.  The MLA latent cache (576/token/layer) makes
the long_500k decode cell feasible.
"""

from repro_torch.models.config import (MLAConfig, ModelConfig, MoEConfig, ScanGroup,
                                 smoke_variant)

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    head_dim=128,
    groups=(
        ScanGroup(pattern=(("mla", "mlp"),), repeats=3),
        ScanGroup(pattern=(("mla", "moe"),), repeats=58),
    ),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
    microbatches=16,
)


def smoke():
    return smoke_variant(CONFIG)
