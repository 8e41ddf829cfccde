"""The training loop: checkpointed and fault-tolerant, on one device.

Examples::

    # smoke-scale run on the CPU with failure injection + restart
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --smoke \
        --steps 50 --fail-at 17 --ckpt build/ckpt --device cpu

    # h2o-danube-1.8b at its published size on the card
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o_danube_18b --steps 20

The flags and report lines are the reference's, plus ``--device``
(default ``cuda``) and ``--seed`` (the weights' seed).  ``--ckpt`` left
out writes the checkpoints to a fresh temporary directory, removed at the
end; a directory given is kept, and a run resumes from its latest
checkpoint.  ``--mesh`` (sharding over devices) is port slice 9d.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import torch

from .. import configs, resolve_device
from ..checkpoint.manager import CheckpointManager
from ..data import pipeline
from ..launch import steps as step_lib
from ..models.config import ModelConfig
from ..optim import adamw
from ..runtime.fault import FailureInjector, StragglerMonitor, Supervisor


def optimizer(cfg: ModelConfig, lr: float, steps: int) -> adamw.AdamWConfig:
    """The CLI's optimiser: AdamW, warmup of 10 steps, then a cosine to
    ``steps``, moments in the config's ``optimizer_dtype``."""
    return adamw.AdamWConfig(learning_rate=adamw.warmup_cosine(lr, 10, steps),
                             moment_dtype=cfg.optimizer_dtype)


def make_step_fn(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                 dcfg: pipeline.DataConfig, *, microbatches: int,
                 device: torch.device,
                 on_metrics: Callable[[int, Dict], None]) -> Callable:
    """``step_fn(state, step) -> state`` for ``Supervisor.run``: one train
    step on ``make_batch(cfg, dcfg, step)``, its metrics handed to
    ``on_metrics(step, metrics)``."""
    train = step_lib.make_train_step(cfg, opt_cfg, microbatches=microbatches)

    def step_fn(st: Dict, step: int) -> Dict:
        batch = pipeline.make_batch(cfg, dcfg, step, device=device)
        params, opt, metrics = train(st["params"], st["opt"], batch)
        on_metrics(step, metrics)
        return {"params": params, "opt": opt}

    return step_fn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory, kept and resumed from "
                         "(default: a temporary one, removed at the end)")
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject simulated node failures at these steps")
    ap.add_argument("--mesh", default=None,
                    help="data,model (the multi-device layer, slice 9d)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights")
    args = ap.parse_args()
    if args.mesh:
        raise NotImplementedError(
            "--mesh shards the train step over devices: the multi-device "
            "layer is port slice 9d")
    dev = resolve_device(args.device)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    opt_cfg = optimizer(cfg, args.lr, args.steps)
    dcfg = pipeline.DataConfig(global_batch=args.batch, seq_len=args.seq)

    state = step_lib.init_train_state(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, opt_cfg,
        device=dev)
    metrics_log: List[Tuple[int, float]] = []

    def log(step: int, metrics: Dict) -> None:
        if step % args.log_every == 0:
            loss = float(metrics["loss"])
            metrics_log.append((step, loss))
            print(f"step {step:5d}  loss {loss:8.4f}  "
                  f"gnorm {float(metrics['grad_norm']):8.3f}", flush=True)

    step_fn = make_step_fn(cfg, opt_cfg, dcfg,
                           microbatches=args.microbatches, device=dev,
                           on_metrics=log)

    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        sup = Supervisor(
            ckpt=CheckpointManager(ckpt_dir, keep=3),
            checkpoint_every=args.checkpoint_every,
            injector=FailureInjector(fail_at_steps=tuple(args.fail_at)),
            straggler=StragglerMonitor())
        latest = sup.ckpt.latest_step()
        start = 0
        if latest is not None:
            print(f"resuming from checkpoint step {latest}")
            state = sup.ckpt.restore(latest, state)
            start = latest

        t0 = time.time()
        state = sup.run(state, step_fn, args.steps, start_step=start)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.time() - t0
    finally:
        if args.ckpt is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    tok = (args.steps - start) * args.batch * args.seq
    print(f"done: {args.steps} steps, {tok/max(dt,1e-9):,.0f} tok/s, "
          f"restarts={sup.restarts}, events={sup.events}")
    if len(metrics_log) >= 2:
        print(f"loss: first {metrics_log[0][1]:.4f} -> "
              f"last {metrics_log[-1][1]:.4f}")


if __name__ == "__main__":
    main()
