"""Elastic-scaling example: train on an 8-rank mesh, checkpoint, then
resume on a 4-rank mesh (half the fleet "failed") with the global batch
preserved via gradient accumulation.

Run:  PYTHONPATH=src python examples/torch_elastic_restart.py --device cpu

Phase 1 trains 6 steps on a (data 4, model 2) mesh and checkpoints the
full state; it then takes step 6 as well, the step the resumed run takes
first (``reference step 6``).  Phase 2 starts 4 new ranks on (2, 2),
restores each rank's shards (``runtime.elastic.restore_on_mesh``) and
takes 4 more steps at ``plan_rescale``'s microbatches.  Ranks are gloo
processes (on the CPU, or sharing one card); with ``--device cuda`` each
rank runs on the card (its own where there are enough cards, over NCCL).
"""

import argparse
import shutil
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import pipeline
from repro_torch.launch import steps as SL
from repro_torch.launch.mesh import Mesh, describe, make_host_mesh, run_ranks
from repro_torch.models import ModelConfig
from repro_torch.models.config import uniform_dense_groups
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import plan_rescale, restore_on_mesh

CFG = ModelConfig(name="elastic", family="dense", d_model=128, num_heads=4,
                  num_kv_heads=2, d_ff=256, vocab_size=512,
                  groups=uniform_dense_groups(2), remat=False,
                  microbatches=1)
OPT = adamw.AdamWConfig(learning_rate=1e-3)
DCFG = pipeline.DataConfig(global_batch=8, seq_len=32)


def _device(rank: int, device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _say(mesh, *words) -> None:
    if mesh.rank == 0:
        print(*words, flush=True)


def phase1(rank: int, world: int, ckpt_dir: str, device: str) -> None:
    dev = _device(rank, device)
    big = make_host_mesh(data=4, model=2)
    _say(big, "phase 1: training on", describe(big))
    full = SL.init_train_state(torch.Generator(device=dev).manual_seed(0),
                               CFG, OPT, device=dev)
    state = SL.shard_train_state(full, CFG, big)
    del full
    train = SL.make_sharded_train_step(CFG, OPT, big, microbatches=1)
    for step in range(7):
        if step == 6:
            saved = SL.gather_train_state(state, CFG, big)
            if big.rank == 0:
                CheckpointManager(ckpt_dir).save(6, saved)
                print("checkpoint saved at step 6 ->", ckpt_dir)
            torch.distributed.barrier()
        batch = pipeline.make_batch(CFG, DCFG, step, device=dev)
        p, o, m = train(state["params"], state["opt"], batch)
        state = {"params": p, "opt": o}
        label = "reference step" if step == 6 else "step"
        _say(big, f"  {label} {step} loss {float(m['loss']):.6f}")


def phase2(rank: int, world: int, ckpt_dir: str, device: str) -> None:
    dev = _device(rank, device)
    small = make_host_mesh(data=2, model=2)
    plan = plan_rescale(CFG, DCFG.global_batch,
                        Mesh((4, 2), ("data", "model")), small)
    _say(small, "phase 2: resuming on", describe(small), "|", plan.note)
    template = SL.abstract_train_state(CFG, OPT)
    state = restore_on_mesh(CheckpointManager(ckpt_dir), 6, template, CFG,
                            small, device=dev)
    train = SL.make_sharded_train_step(CFG, OPT, small,
                                       microbatches=plan.microbatches)
    for step in range(6, 10):
        batch = pipeline.make_batch(CFG, DCFG, step, device=dev)
        p, o, m = train(state["params"], state["opt"], batch)
        state = {"params": p, "opt": o}
        _say(small, f"  step {step} loss {float(m['loss']):.6f}  "
                    f"(ranks={small.size})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each phase's ranks may take")
    args = ap.parse_args()
    dev = torch.device(args.device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = {w: "nccl" if n >= w else "gloo" for w in (8, 4)}
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    try:
        run_ranks(phase1, 8, backend=backend[8],
                  args=(ckpt_dir, args.device), timeout=args.timeout)
        run_ranks(phase2, 4, backend=backend[4],
                  args=(ckpt_dir, args.device), timeout=args.timeout)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print("elastic restart OK: same stream, half the fleet")


if __name__ == "__main__":
    main()
