"""Composable model stack for the assigned architectures (the dense
families; the experts, MLA and the recurrent mixers are port slice 9b)."""

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
