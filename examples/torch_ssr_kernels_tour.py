"""Tour of the §4.2 kernel suite on the PyTorch port: each streamed kernel
against its PyTorch oracle, beside the instruction-level model behind its
speedup.

Run:  PYTHONPATH=src python examples/torch_ssr_kernels_tour.py [--device cuda|cpu]

The streamed kernels run on ``--device`` (default ``cuda``: the Hopper
kernels; ``cpu``: their plain PyTorch versions).  Asking for ``cuda``
without a card fails at once.
"""

import argparse

import numpy as np
import torch

import repro_torch
from repro_torch.core import isa
from repro_torch.kernels import ops, ref

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="where the streamed kernels run: cuda or cpu")
dev = repro_torch.resolve_device(ap.parse_args().device)
repro_torch.set_default_device(dev)

rng = np.random.default_rng(1)


def f32(*shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


x2048 = f32(2048)
y2048 = f32(2048)
x4096 = f32(4096)
x1024 = f32(1024)
xs = f32(1034)
w11 = f32(11, scale=0.2)
g2d = f32(74, 74)
a64 = f32(64, 64)
v64 = f32(64)
a32 = f32(32, 32)
b32 = f32(32, 32)

CASES = [
    ("reduction", lambda: (ops.dot(x2048, y2048, ssr=True),
                           ref.dot_ref(x2048, y2048))),
    ("scan", lambda: (ops.prefix_sum(x4096, ssr=True), ref.scan_ref(x4096))),
    ("stencil1d", lambda: (ops.stencil1d(xs, w11, ssr=True),
                           ref.stencil1d_ref(xs, w11))),
    ("stencil2d", lambda: (ops.stencil2d(g2d, w11, w11, ssr=True),
                           ref.stencil2d_ref(g2d, w11, w11))),
    ("gemv", lambda: (ops.gemv(a64, v64, ssr=True), ref.gemv_ref(a64, v64))),
    ("gemm", lambda: (ops.matmul(a32, b32, ssr=True),
                      ref.matmul_ref(a32, b32))),
    ("relu", lambda: (ops.relu(x1024, ssr=True), ref.relu_ref(x1024))),
    ("fft", lambda: (ops.fft(x2048, y2048, ssr=True)[0],
                     ref.fft_ref(x2048, y2048)[0])),
    ("bitonic", lambda: (ops.sort(x1024, ssr=True), ref.sort_ref(x1024))),
]

models = {k.name: k for k in isa.kernel_suite()}

print(f"{'kernel':10s} {'max |err|':>12s} {'model speedup':>14s} "
      f"{'eta base->ssr':>16s}")
for name, case in CASES:
    got, want = case()
    err = float((got.float() - want.float()).abs().max())
    m = models.get(name, models["stencil1d"])
    print(f"{name:10s} {err:12.2e} {m.speedup:13.2f}x "
          f"{m.eta_base:7.0%} -> {m.eta_ssr:5.0%}")
engine = "the Hopper kernels" if dev.type == "cuda" else "plain PyTorch"
print(f"\nAll streamed kernels validated against the PyTorch oracle "
      f"({engine} on {dev.type}).")
