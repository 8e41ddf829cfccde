"""Quickstart: Stream Semantic Registers in five minutes, on the PyTorch port.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]

The streamed kernels run on ``--device`` (default ``cuda``: the Hopper
kernels; ``cpu``: their plain PyTorch versions).  Asking for ``cuda``
without a card fails at once.  §6 writes its tuned schedule under
``REPRO_SCHEDULE_CACHE``, a new temporary directory where that is unset.
"""

import argparse
import os
import tempfile

import numpy as np
import torch

import repro_torch
from repro_torch.core import (contiguous, dot_product_nest, fig4_dot_product,
                              gather_stream, isa, ssr_region, ssrify)
from repro_torch.kernels import ops
from repro_torch.kernels.reduction import MUL

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="where the streamed kernels run: cuda or cpu")
dev = repro_torch.resolve_device(ap.parse_args().device)
repro_torch.set_default_device(dev)

print("=" * 64)
print("1. The paper's headline numbers (Fig. 4, exact)")
print("=" * 64)
base, ssr = fig4_dot_product(1000)
print(f"dot product over 1000 elements: {base} instructions without SSR, "
      f"{ssr} with SSR -> {base/ssr:.2f}x fewer\n")

print("=" * 64)
print("2. The compiler pass (paper §3.2): SSR-ify a loop nest")
print("=" * 64)
plan = ssrify(dot_product_nest(2048))
print(f"dot(2048): ssrified={plan.ssrified}, lanes={len(plan.allocations)}, "
      f"speedup={plan.speedup:.2f}x")
for a in plan.allocations:
    print(f"  lane {a.lane}: {a.ref.name} <- AGU bounds={a.spec.bounds} "
          f"strides={a.spec.strides}")
short = ssrify(dot_product_nest(4))
print(f"dot(4): ssrified={short.ssrified}  "
      f"(Eq. 3 break-even: 1-D nests need > 5 iterations)\n")

print("=" * 64)
print("3. Stream semantics = AGU address pattern (what ft0 'sees')")
print("=" * 64)
data = torch.arange(16.0)
spec = contiguous(6, base=2)
print(f"read stream base=2 bound=6 stride=1 delivers: "
      f"{np.asarray(gather_stream(data, spec))}\n")

print("=" * 64)
print(f"4. The streamed kernel on {dev.type} vs the oracle (ssrcfg on/off)")
print("=" * 64)
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.standard_normal(2048).astype(np.float32)).to(dev)
y = torch.from_numpy(rng.standard_normal(2048).astype(np.float32)).to(dev)
with ssr_region():            # csrwi ssrcfg, 1
    streamed = ops.dot(x, y)  # -> the streamed kernel (K1 on the card)
plain = ops.dot(x, y)         # ssrcfg=0 -> plain PyTorch
print(f"ssr={float(streamed):.4f}  torch={float(plain):.4f}  "
      f"|diff|={abs(float(streamed - plain)):.2e}\n")

print("=" * 64)
print("5. Where the speedup comes from (Table 2)")
print("=" * 64)
for r in isa.table2():
    print(f"{r.kernel:18s} {r.arith}: eta {r.base.eta:4.0%} -> "
          f"{r.ssr.eta:4.0%}, speedup {r.speedup:.2f}x")

print()
print("=" * 64)
print("6. The schedule autotuner: search -> prune -> measure -> persist")
print("=" * 64)
os.environ.setdefault("REPRO_SCHEDULE_CACHE",
                      tempfile.mkdtemp(prefix="repro_quickstart_"))
from repro_torch.core import autotune  # noqa: E402
from repro_torch.core.lowering import DEFAULT_SCHEDULE, Schedule  # noqa: E402

nest = dot_product_nest(2048)
operands = {"A": x, "B": y}
result = autotune.autotune(
    nest, MUL, operands,
    candidates=[DEFAULT_SCHEDULE, Schedule(rows=16, lanes=128)],
    warmup=1, iters=2)
s = result.schedule
print(f"winner: {s.rows}x{s.lanes} blocks "
      f"({'default' if result.is_default else 'non-default'}), "
      f"tuned {result.tuned_us:.0f}us vs default {result.default_us:.0f}us"
      + ("  [cache hit]" if result.from_cache else ""))
again = autotune.autotune(nest, MUL, operands,
                          candidates=[DEFAULT_SCHEDULE], iters=1)
print(f"second call: from_cache={again.from_cache} "
      f"(persisted under {autotune.default_cache_dir()})")
with ssr_region():
    tuned = ops.dot(x, y)     # registry dispatch now runs the winner
print(f"tuned dispatch agrees with PyTorch: "
      f"|diff|={abs(float(tuned - plain)):.2e}")
