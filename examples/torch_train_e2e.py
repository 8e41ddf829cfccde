"""End-to-end training example on the PyTorch port: a ~20M (default) or
~100M parameter dense LM trained for a few hundred steps on the synthetic
Markov stream, with checkpointing and (optional) an injected failure and
automatic restart.  The reference's ``examples/train_e2e.py`` on
``repro_torch``.

Run:  PYTHONPATH=src python examples/torch_train_e2e.py [--preset 100m]
      [--steps 200] [--fail-at 57] [--device cpu]

``--device`` defaults to ``cuda``; without a card, pass ``--device cpu``.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import steps as step_lib  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.models.config import uniform_dense_groups  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.fault import FailureInjector, Supervisor  # noqa: E402

PRESETS = {
    # ~20M: CPU-friendly "few hundred steps" demo
    "20m": dict(d_model=256, num_heads=8, num_kv_heads=4, d_ff=1024,
                layers=8, vocab=8192, batch=8, seq=128),
    # ~100M: the end-to-end scale (slower on the CPU)
    "100m": dict(d_model=512, num_heads=8, num_kv_heads=4, d_ff=2048,
                 layers=12, vocab=32768, batch=8, seq=256),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default="20m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    p = PRESETS[args.preset]
    dev = resolve_device(args.device)

    cfg = ModelConfig(
        name=f"train-e2e-{args.preset}", family="dense",
        d_model=p["d_model"], num_heads=p["num_heads"],
        num_kv_heads=p["num_kv_heads"], d_ff=p["d_ff"],
        vocab_size=p["vocab"], groups=uniform_dense_groups(p["layers"]),
        remat=False, tie_embeddings=True)
    print(f"model: {cfg.name}  params ~{cfg.param_count()/1e6:.1f}M")

    opt_cfg = adamw.AdamWConfig(
        learning_rate=adamw.warmup_cosine(3e-3, 20, args.steps))
    dcfg = pipeline.DataConfig(global_batch=p["batch"], seq_len=p["seq"])
    state = step_lib.init_train_state(0, cfg, opt_cfg, device=dev)
    train = step_lib.make_train_step(cfg, opt_cfg, microbatches=1)

    losses = []

    def step_fn(st, step):
        batch = pipeline.make_batch(cfg, dcfg, step, device=dev)
        params, opt, metrics = train(st["params"], st["opt"], batch)
        if step % 10 == 0:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"step {step:4d}  loss {loss:.4f}", flush=True)
        return {"params": params, "opt": opt}

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_e2e_")
    try:
        sup = Supervisor(
            ckpt=CheckpointManager(ckpt_dir, keep=2), checkpoint_every=25,
            injector=FailureInjector(
                fail_at_steps=(args.fail_at,) if args.fail_at else ()))
        t0 = time.time()
        sup.run(state, step_fn, args.steps)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.time() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"\n{args.steps} steps in {dt:.1f}s "
          f"({args.steps*p['batch']*p['seq']/dt:,.0f} tok/s); "
          f"restarts={sup.restarts}")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'LEARNED' if losses[-1] < losses[0] - 0.5 else 'check run'})")


if __name__ == "__main__":
    main()
