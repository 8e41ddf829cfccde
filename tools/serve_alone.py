#!/usr/bin/env python3
"""chip_smoke.py's model phases alone, in a fresh process.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/serve_alone.py [--seed 0] [--phases 7 7b 7c 7d]

Phase 7 serves qwen3-14b at its published size (random bf16 weights drawn
on the card from ``--seed``) and prints its ``serve`` line; phase 7b
serves deepseek-v3 (2 layers), jamba (one period) and xlstm-125m at their
published widths and prints the ``serve_families`` line; phase 7c trains
h2o-danube-1.8b at its published size, checks its gradients, holds the
smoke variants' train step on the card to the CPU's and restarts
xlstm-125m exactly, and prints the ``train`` line; phase 7d runs the
multi-device layer on ranks that share the card (one NCCL rank, then gloo
ranks) and prints the ``mesh`` line; each exactly as
``chip_smoke.py`` runs it, with its checks.  No kernel is built, so phase
7 takes about a minute and a half.  Beside ``chip_smoke.py``'s run it
separates what the model path costs from what the earlier phases leave in
the process.  Exits non-zero without a CUDA device or if a check fails.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", nargs="+", default=["7", "7b", "7c", "7d"],
                    choices=["7", "7b", "7c", "7d"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_alone: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    # the profiler's traces land in a temporary directory
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    traces = tempfile.mkdtemp(prefix="serve_alone_", dir=os.path.join(
        ROOT, "build"))
    os.environ["REPRO_SCHEDULE_CACHE"] = traces
    try:
        card, dev = torch.cuda.get_device_name(0), torch.device("cuda")
        if "7" in args.phases:
            chip_smoke.serve_phase(args.seed, smi, card, dev)
        if "7b" in args.phases:
            chip_smoke.families_phase(args.seed, smi, card, dev)
        from pathlib import Path
        if "7c" in args.phases:
            chip_smoke.training_phase(args.seed, smi, card, dev, Path(ROOT))
        if "7d" in args.phases:
            chip_smoke.mesh_phase(args.seed, smi, card, dev, Path(ROOT))
    finally:
        shutil.rmtree(traces, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
