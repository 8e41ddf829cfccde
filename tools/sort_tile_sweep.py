#!/usr/bin/env python3
"""Time K16 (``csrc/stream_bitonic.cu``) at several tile sizes on one row.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 tools/sort_tile_sweep.py [--log2n 26] [--seed 0]

The kernel's source is compiled once a variant (``stream_ablation.build``,
into ``build/stream_ablation/``): as it stands (a 16,384-element tile, up
to 9 stages a group pass, 32 elements a thread, one CTA an SM) and with
its tile, group, register-width and CTAs-per-SM constants replaced, or its
group passes split evenly (``VARIANTS``: the 8,192-element tile, 64 KiB of
shared memory a CTA with its staging buffer).  Each sorts the same row
of ``2**log2n`` f32 ~ N(0, 1) from ``--seed``, in turns (A, B, …, B, A),
timed as the median of CUDA-event samples; each must equal ``torch.sort``
to the bit.  Prints one JSON line: the card's name and power limit, for
each variant its launches (``sort_passes``), ms and ptxas registers and
spills, and the first variant's device time by pass kind from a profiler
trace.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from stream_ablation import bitonic, build, pass_times, time_ms

#: Each variant's constants of csrc/stream_bitonic.cu; the first is the
#: source as it stands.
VARIANTS = (
    {"kTileLog2": 14, "kGroup": 9, "kRegLog2": 5, "kMinCtas": 1},
    {"kTileLog2": 14, "kGroup": 9, "kRegLog2": 5, "kMinCtas": 1,
     "split": "even"},
    {"kTileLog2": 13, "kGroup": 8, "kRegLog2": 5, "kMinCtas": 3},
    {"kTileLog2": 13, "kGroup": 8, "kRegLog2": 5, "kMinCtas": 2},
)
#: the source's split of a k's stages into group passes (from the top,
#: kGroup each), and the even split a variant with "split": "even" takes
_GREEDY = """\
    for (int jhi = ks - 1; err == cudaSuccess && jhi >= len_log2; jhi -= kGroup) {
      const int g = jhi - len_log2 + 1 < kGroup ? jhi - len_log2 + 1 : kGroup;
      err = run(o, len_log2 - g, jhi - g + 1, Stages{ks, jhi, ks, jhi - g + 1, 0});
    }
"""
_EVEN = """\
    const int m = ks - len_log2, parts = (m + kGroup - 1) / kGroup;
    for (int k = 0, jhi = ks - 1; err == cudaSuccess && k < parts; ++k) {
      const int g = m / parts + (k < m % parts ? 1 : 0);
      err = run(o, len_log2 - g, jhi - g + 1, Stages{ks, jhi, ks, jhi - g + 1, 0});
      jhi -= g;
    }
"""


def substitutions(consts: dict) -> list:
    """(old, new) replacements that turn the source into the variant."""
    subs = [(f"constexpr int {name} = {value};",
             f"constexpr int {name} = {consts[name]};")
            for name, value in VARIANTS[0].items()]
    if consts.get("split") == "even":
        subs.append((_GREEDY, _EVEN))
    return subs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2n", type=int, default=26)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sort_tile_sweep: needs a CUDA device")
    n = 1 << args.log2n
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn(n, generator=gen, device="cuda")
    want = torch.sort(x).values
    stream = torch.cuda.current_stream().cuda_stream
    runs = []
    for k, consts in enumerate(VARIANTS):
        lib, out = build("stream_bitonic", f"sweep{k}",
                         substitutions(consts)), torch.empty_like(x)
        fn = lib.ssr_stream_bitonic
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(fn=fn, out=out, consts=consts):
            rc = fn(x.data_ptr(), out.data_ptr(), 0, 1, n, stream)
            if rc != 0:
                raise SystemExit(f"{consts}: CUDA error {rc}")
        runs.append((call, out, lib.ptxas))
    order = [*range(len(VARIANTS)), *reversed(range(len(VARIANTS)))]
    ms = [[] for _ in VARIANTS]
    for v in order:
        ms[v].append(time_ms(runs[v][0], 5))
    by_kind = pass_times(runs[0][0], n)
    same = all(torch.equal(o.view(torch.int32), want.view(torch.int32))
               for _c, o, _p in runs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "phase": "sort_tile_sweep", "card": smi, "n": n,
        "device": torch.cuda.get_device_name(0), "bit_exact": same,
        "variants": [{**consts, "smem_bytes": 8 << consts["kTileLog2"],
                      "launches": len(bitonic.sort_passes(
                          n, tile=1 << consts["kTileLog2"],
                          group=consts["kGroup"])),
                      "ms": ms[k], "ptxas": runs[k][2]}
                     for k, consts in enumerate(VARIANTS)],
        "pass_ms": by_kind}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
