"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12 layers, d_model 768, 4 heads, d_ff = 0 (xLSTM blocks own their
projections: mLSTM pre-up-projection x2, sLSTM post gated FFN x4/3),
vocab 50304.  Block ratio mLSTM:sLSTM ~ 7:1 per the paper's xLSTM[7:1];
with 12 layers we use two (5xmLSTM + 1xsLSTM) groups.
"""

from repro_torch.models.config import ModelConfig, ScanGroup, XLSTMConfig, smoke_variant

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    groups=(
        ScanGroup(pattern=(("mlstm", "none"),) * 5 + (("slstm", "none"),),
                  repeats=2),
    ),
    xlstm=XLSTMConfig(),
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    microbatches=4,
)


def smoke():
    return smoke_variant(CONFIG)
