"""The training loop: checkpointed and fault-tolerant, on one device.

Examples::

    # smoke-scale run on the CPU with failure injection + restart
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --smoke \
        --steps 50 --fail-at 17 --ckpt build/ckpt --device cpu

    # h2o-danube-1.8b at its published size on the card
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o_danube_18b --steps 20

    # sharded over a (data 2, model 2) mesh: four ranks (gloo on the CPU)
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --smoke \
        --steps 3 --mesh 2,2 --device cpu

The flags and report lines are the reference's, plus ``--device``
(default ``cuda``) and ``--seed`` (the weights' seed).  ``--ckpt`` left
out writes the checkpoints to a fresh temporary directory, removed at the
end; a directory given is kept, and a run resumes from its latest
checkpoint.  ``--mesh d,m`` starts d·m ranks (``launch.mesh.run_ranks``),
each running ``steps.make_sharded_train_step`` on its shards: over NCCL
where every rank has a card of its own, else over gloo (on the CPU, or
ranks sharing the card).  Rank 0 reports; checkpoints hold the full
state (gathered from the shards), so a run resumes on any mesh.
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
from ..launch.mesh import describe, make_host_mesh, run_ranks
from ..models.config import ModelConfig
from ..optim import adamw
from ..runtime.elastic import restore_on_mesh
from ..runtime.fault import FailureInjector, StragglerMonitor, Supervisor


#: the most seconds the ranks of ``--mesh`` may take in all (also their
#: process group's timeout: a collective that waits longer fails)
RANK_TIMEOUT_S = 24 * 3600.0


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
                    help="data,model: shard over that many ranks")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        if args.mesh:
            d, m = (int(x) for x in args.mesh.split(","))
            world = d * m
            # NCCL needs a card a rank; ranks sharing the card, or the CPU,
            # meet over gloo
            backend = "nccl" if dev.type == "cuda" and \
                torch.cuda.device_count() >= world else "gloo"
            run_ranks(_train_rank, world, backend=backend,
                      args=(vars(args), ckpt_dir, (d, m)),
                      timeout=RANK_TIMEOUT_S)
        else:
            _train(args, dev, ckpt_dir, None)
    finally:
        if args.ckpt is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


class MeshCheckpoint:
    """A :class:`CheckpointManager` for the ranks of a mesh: ``save``
    gathers the full state from the shards (every rank calls it) and rank
    0 writes it; ``restore`` gives each rank its shards
    (``runtime.elastic.restore_on_mesh``)."""

    def __init__(self, mgr: CheckpointManager, cfg: ModelConfig,
                 opt_cfg: adamw.AdamWConfig, mesh, device):
        self.mgr, self.cfg, self.mesh, self.device = mgr, cfg, mesh, device
        self.template = step_lib.abstract_train_state(cfg, opt_cfg)

    def save(self, step: int, state, *, blocking: bool = True,
             extra=None) -> None:
        full = step_lib.collect_train_state(state, self.cfg, self.mesh)
        if self.mesh.rank == 0:
            self.mgr.save(step, full, extra=extra)
        torch.distributed.barrier()

    def wait(self) -> None:
        self.mgr.wait()

    def latest_step(self):
        return self.mgr.latest_step()

    def restore(self, step: int, template=None):
        return restore_on_mesh(self.mgr, step, self.template, self.cfg,
                               self.mesh, device=self.device)


def _train_rank(rank: int, world: int, argv: Dict, ckpt_dir: str,
                shape: Tuple[int, int]) -> None:
    """One rank of ``--mesh``: its card (or the CPU), its shards."""
    args = argparse.Namespace(**argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    mesh = make_host_mesh(data=shape[0], model=shape[1])
    _train(args, dev, ckpt_dir, mesh)


def _train(args, dev: torch.device, ckpt_dir: str, mesh) -> None:
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    opt_cfg = optimizer(cfg, args.lr, args.steps)
    dcfg = pipeline.DataConfig(global_batch=args.batch, seq_len=args.seq)
    speak = mesh is None or mesh.rank == 0
    if mesh is not None and speak:
        print(f"mesh: {describe(mesh)}", flush=True)

    state = step_lib.init_train_state(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, opt_cfg,
        device=dev)
    metrics_log: List[Tuple[int, float]] = []

    def log(step: int, metrics: Dict) -> None:
        if step % args.log_every == 0 and speak:
            loss = float(metrics["loss"])
            metrics_log.append((step, loss))
            print(f"step {step:5d}  loss {loss:8.4f}  "
                  f"gnorm {float(metrics['grad_norm']):8.3f}", flush=True)

    mgr = CheckpointManager(ckpt_dir, keep=3)
    if mesh is None:
        step_fn = make_step_fn(cfg, opt_cfg, dcfg,
                               microbatches=args.microbatches, device=dev,
                               on_metrics=log)
    else:
        state = step_lib.shard_train_state(state, cfg, mesh)
        mgr = MeshCheckpoint(mgr, cfg, opt_cfg, mesh, dev)
        train = step_lib.make_sharded_train_step(
            cfg, opt_cfg, mesh, microbatches=args.microbatches)

        def step_fn(st: Dict, step: int) -> Dict:
            batch = pipeline.make_batch(cfg, dcfg, step, device=dev)
            params, opt, metrics = train(st["params"], st["opt"], batch)
            log(step, metrics)
            return {"params": params, "opt": opt}

    sup = Supervisor(
        ckpt=mgr, checkpoint_every=args.checkpoint_every,
        injector=FailureInjector(fail_at_steps=tuple(args.fail_at)),
        straggler=StragglerMonitor())
    latest = sup.ckpt.latest_step()
    start = 0
    if latest is not None:
        if speak:
            print(f"resuming from checkpoint step {latest}")
        state = sup.ckpt.restore(latest, state)
        start = latest

    t0 = time.time()
    state = sup.run(state, step_fn, args.steps, start_step=start)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    if not speak:
        return
    tok = (args.steps - start) * args.batch * args.seq
    print(f"done: {args.steps} steps, {tok/max(dt,1e-9):,.0f} tok/s, "
          f"restarts={sup.restarts}, events={sup.events}")
    if len(metrics_log) >= 2:
        print(f"loss: first {metrics_log[0][1]:.4f} -> "
              f"last {metrics_log[-1][1]:.4f}")


if __name__ == "__main__":
    main()
