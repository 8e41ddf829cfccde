"""Deterministic synthetic data pipeline (restart-stable).

Every batch is a pure function of (seed, step) — a restarted run resumes the
exact token stream from its checkpointed step.  For LM archs the "dataset"
is a Zipf-ish token distribution with a learnable structure (next token
correlates with the current one) so a few hundred steps show a genuinely
decreasing loss.  Audio/VLM frontends get matching synthetic frame/patch
embeddings per the stub contract.

The reference draws from ``jax.random``, whose bits the port cannot
reproduce, so the port's tokens are other tokens of the same law: the same
shapes, dtypes, range and Markov structure, drawn from a ``torch``
generator seeded from (seed, step).  They are drawn on the CPU and then
moved to the device, so a CPU run and a card run see the same batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from .. import resolve_device
from ..models.config import ModelConfig
from ..models.layers import META, dtype_of


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator that depends on (seed, step) alone."""
    state = np.random.SeedSequence([seed, step]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator().manual_seed(int(state >> np.uint64(1)))


def _lm_tokens(gen: torch.Generator, cfg: ModelConfig,
               dcfg: DataConfig) -> torch.Tensor:
    """Markov-ish stream: t_{i+1} = (a·t_i + noise) mod V, Zipf-biased."""
    b, s, v = dcfg.global_batch, dcfg.seq_len + 1, cfg.vocab_size
    zipf = torch.softmax(
        -0.9 * torch.log1p(torch.arange(v, dtype=torch.float32)), dim=0)
    base = torch.multinomial(zipf, b * s, replacement=True,
                             generator=gen).reshape(b, s)
    noise = torch.randint(0, 5, (b, s), generator=gen)
    step_sizes = base // max(v // 64, 1) + noise   # low-entropy increments
    mixed = torch.cumsum(step_sizes, dim=1) % v
    return mixed.to(torch.int32)


def make_batch(cfg: ModelConfig, dcfg: DataConfig, step: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    gen = _generator(dcfg.seed, step)
    cd = dtype_of(cfg.compute_dtype)
    batch: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "audio":
        batch["embeds"] = (torch.randn(
            (dcfg.global_batch, dcfg.seq_len, cfg.d_model), generator=gen)
            .to(cd) * 0.1)
        batch["labels"] = torch.randint(
            0, cfg.vocab_size, (dcfg.global_batch, dcfg.seq_len),
            generator=gen, dtype=torch.int32)
    else:
        toks = _lm_tokens(gen, cfg, dcfg)
        batch["tokens"] = toks[:, :-1]
        batch["labels"] = toks[:, 1:]
        if cfg.frontend == "vision":
            batch["embeds"] = (torch.randn(
                (dcfg.global_batch, cfg.frontend_len, cfg.d_model),
                generator=gen).to(cd) * 0.1)
            # labels cover only the text tail (model aligns logits
            # accordingly)
    return {k: v.contiguous().to(dev) for k, v in batch.items()}


def iterate(cfg: ModelConfig, dcfg: DataConfig, start_step: int = 0, *,
            device=None) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield make_batch(cfg, dcfg, step, device=device)
        step += 1


def input_specs(cfg: ModelConfig, dcfg: DataConfig
                ) -> Dict[str, torch.Tensor]:
    """Every model input as a ``meta`` tensor: its shape and dtype, no
    storage (the reference's ``ShapeDtypeStruct`` stand-ins)."""
    b, s = dcfg.global_batch, dcfg.seq_len
    cd = dtype_of(cfg.compute_dtype)

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)

    if cfg.frontend == "audio":
        return {"embeds": spec((b, s, cfg.d_model), cd),
                "labels": spec((b, s), torch.int32)}
    out = {"tokens": spec((b, s), torch.int32),
           "labels": spec((b, s), torch.int32)}
    if cfg.frontend == "vision":
        out["embeds"] = spec((b, cfg.frontend_len, cfg.d_model), cd)
    return out
