"""Composable model stack for the assigned architectures: GQA and latent
attention, dense and expert FFNs, Mamba and xLSTM mixers."""

from .config import (  # noqa: F401
    MLAConfig,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    ScanGroup,
    XLSTMConfig,
    smoke_variant,
    uniform_dense_groups,
)
from .model import (  # noqa: F401
    decode_step,
    forward,
    init_caches,
    init_params,
    loss_fn,
)
