"""Architecture registry: the ten assigned configs + the paper's own suite.

Each module defines ``CONFIG`` (the exact published configuration) and
``smoke()`` (a reduced same-family variant for CPU tests).  ``get(name)``
resolves either.  Input-shape cells are defined in ``shapes.py``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig, smoke_variant

ARCH_IDS: List[str] = [
    "xlstm_125m",
    "jamba_v01_52b",
    "yi_6b",
    "llama3_405b",
    "h2o_danube_18b",
    "qwen3_14b",
    "deepseek_v3_671b",
    "dbrx_132b",
    "hubert_xlarge",
    "internvl2_26b",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch '{name}'; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_smoke(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    if hasattr(mod, "smoke"):
        return mod.smoke()
    return smoke_variant(mod.CONFIG)


def all_configs() -> Dict[str, ModelConfig]:
    return {i: get(i) for i in ARCH_IDS}
