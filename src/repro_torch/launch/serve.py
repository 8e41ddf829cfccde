"""Batched serving: prefill a request batch, decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_14b \\
        [--smoke] --batch 8 --prompt-len 64 --gen 32 [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; asked for ``cuda``
where there is none, it raises.  Weights are random, drawn on the device
from ``--seed``; the prompts come from the data pipeline (seed 11, step 0).

A vision config's prompt is its frontend prefix and then its tokens, so its
first decode position is the prefix's length plus the prompt's (the
reference starts at the prompt's length alone and rotates the first
generated token as if the prefix were not there).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import torch

from .. import configs, resolve_device
from ..data import pipeline
from ..models import init_params
from ..models.config import ModelConfig
from . import steps as step_lib


@dataclasses.dataclass
class Generation:
    """A greedy continuation and what it took."""

    tokens: torch.Tensor        # (B, gen) int32: the greedy tokens
    prefill_s: float            # prefill, to its logits on the host's clock
    decode_s: float             # the gen − 1 decode steps likewise
    start: int                  # the first decode position
    logits: List[torch.Tensor]  # (B, 1, V) f32 per token, if kept
    caches: list                # the decode caches after the last step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg: ModelConfig, prompts: Dict[str, torch.Tensor], *,
             gen: int, keep_logits: bool = False) -> Generation:
    """Prefill ``prompts`` and decode ``gen`` greedy tokens a row (the first
    from prefill's logits, then ``gen − 1`` decode steps)."""
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    toks = prompts["tokens"]
    device, b = toks.device, toks.shape[0]
    # the positions a prompt fills: the frontend prefix (vision), the tokens
    start = toks.shape[1] + (prompts["embeds"].shape[1]
                             if "embeds" in prompts else 0)
    prefill = step_lib.make_prefill_step(cfg, cache_len=start + gen + 1)
    serve = step_lib.make_decode_step(cfg)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompts)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    kept = [logits] if keep_logits else []
    cur = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [cur]
    pos = torch.full((b,), start, dtype=torch.int32, device=device)
    t1 = time.perf_counter()
    for t in range(gen - 1):
        logits, caches = serve(params, caches, cur, pos + t)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(cur)
        if keep_logits:
            kept.append(logits)
    tokens = torch.cat(out, dim=1)
    _sync(device)
    t_decode = time.perf_counter() - t1
    return Generation(tokens=tokens, prefill_s=t_prefill, decode_s=t_decode,
                      start=start, logits=kept, caches=caches)


def report(cfg: ModelConfig, batch: int, prompt_len: int, gen: int,
           res: Generation) -> List[str]:
    """The reference's report lines."""
    total = batch * gen
    return [
        f"arch={cfg.name} batch={batch} prompt={prompt_len} gen={gen}",
        f"prefill: {res.prefill_s*1e3:8.1f} ms "
        f"({batch*prompt_len/res.prefill_s:,.0f} tok/s)",
        f"decode:  {res.decode_s*1e3:8.1f} ms "
        f"({total/max(res.decode_s,1e-9):,.0f} tok/s, "
        f"{res.decode_s/max(gen-1,1)*1e3:.1f} ms/step)",
        f"sample continuation (seq 0): {res.tokens[0, :16].tolist()}",
    ]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_14b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke if args.smoke else configs.get)(args.arch)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    device = resolve_device(args.device)

    params = init_params(args.seed, cfg, device=device)
    dcfg = pipeline.DataConfig(args.batch, args.prompt_len, seed=11)
    prompts = pipeline.make_batch(cfg, dcfg, 0, device=device)
    prompts.pop("labels", None)
    res = generate(params, cfg, prompts, gen=args.gen)
    for line in report(cfg, args.batch, args.prompt_len, args.gen, res):
        print(line)


if __name__ == "__main__":
    main()
