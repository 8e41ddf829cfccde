"""Multi-pod dry run: one record per (arch × shape × mesh) cell.

The reference lowers and compiles every cell's step for the production
meshes (16×16 single-pod, 2×16×16 multi-pod) on 512 fake host devices and
reads XLA's memory and cost analyses and the HLO.  PyTorch lowers no HLO,
so the port runs one rank — rank 0 — of the same mesh in one process, on
a *dry* mesh (``launch/mesh.py``: collectives record what they would move
and move nothing), and each record says what it measures instead:

* ``memory``: per-device bytes of params, optimizer moments, inputs and
  caches, exact, from the sharding policy's spec trees
  (``parallel/sharding.py``) on ``meta`` shapes — reckoned, not measured;
* ``flops``: the FLOPs of rank 0's local step, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` while the step runs on
  ``meta`` tensors (shapes only, nothing allocated).  A train cell runs its
  step on one microbatch's rows and multiplies by ``microbatches``;
* ``collectives``: the port's own collective calls in that run (their
  counts, bytes, and link traffic under ``hlo_analysis.ring_traffic``'s
  ring factors).

``temp_bytes``, ``alias_bytes``, the peak and ``cost_analysis_raw`` have
no counterpart and are ``null``, with the reason beside them.  The port's
step computes the dense products on every ``model`` rank and decode
attention over the whole cached sequence (no sequence parallelism), so its
FLOPs are those of the port's step, not of the reference's partitioned
program.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both]
"""

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import configs, keypaths
from ..configs import shapes as shp
from ..data import pipeline
from ..launch import steps
from ..launch.mesh import Mesh, describe, make_production_mesh
from ..models import config as mcfg
from ..models import model as mdl
from ..models.layers import META, dtype_of
from ..optim import adamw
from ..parallel import sharding as shd
from ..parallel.activations import activation_mesh

RESULTS_PATH = "dryrun_results.json"

#: why the reference's keys that the port cannot fill are null
NULL_REASONS = {
    "temp_bytes": "XLA's scratch allocation; the port compiles no program",
    "alias_bytes": "XLA's donated-buffer aliasing; the port updates the "
                   "state in place, with no second copy to alias",
    "peak_per_device_gib": "XLA's memory_analysis sum; the port reckons the "
                           "resident state only (memory.*_bytes)",
    "cost_analysis_raw": "XLA's cost model of the compiled HLO; the port "
                         "counts FLOPs by FlopCounterMode instead (flops)",
}


def _clamp_microbatches(cfg, cell, mesh) -> int:
    """Largest m ≤ cfg.microbatches with (B/m) divisible by the dp size."""
    dp = shd.dp_size(mesh)
    m = min(cfg.microbatches, cell.global_batch)
    while m > 1 and (cell.global_batch % m
                     or (cell.global_batch // m) % dp):
        m -= 1
    return max(m, 1)


def _nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype).element_size()


def local_bytes(tree: Any, specs: Any, mesh: Mesh, dtype=None) -> int:
    """Σ over the leaves of one rank's shard bytes (``dtype``, where given,
    for every leaf: a moment tree's)."""
    spec = {keypaths.key(p): s for p, s in keypaths.leaves_with_path(specs)}
    return sum(_nbytes(shd.local_shape(t.shape, spec[keypaths.key(p)], mesh),
                       dtype or t.dtype)
               for p, t in keypaths.leaves_with_path(tree))


def _batch_specs(cfg, cell, mesh, dcfg):
    ispecs = pipeline.input_specs(cfg, dcfg)
    bspec = shd.batch_spec(cfg, mesh, cell.global_batch)
    return ispecs, {k: shd.P(*([bspec[0]] + [None] * (v.ndim - 1)))
                    for k, v in ispecs.items()}


def _local(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """``meta`` tensors of one rank's shard shapes."""
    spec = {keypaths.key(p): s for p, s in keypaths.leaves_with_path(specs)}
    return keypaths.map_with_path(
        lambda p, t: torch.empty(shd.local_shape(
            t.shape, spec[keypaths.key(p)], mesh), dtype=t.dtype,
            device=META), tree)


def _gathered(params, pspec, mesh: Mesh, cfg) -> Any:
    """The step's view of the params: each leaf gathered over its sharded
    axes; expert leaves under expert parallelism keep their ``model``
    shard."""
    from ..models import moe
    ep = cfg.moe is not None and moe.expert_parallel(cfg.moe, mesh)
    spec = {keypaths.key(p): s for p, s in keypaths.leaves_with_path(pspec)}
    return keypaths.map_with_path(
        lambda p, t: shd.gather(t, spec[keypaths.key(p)], mesh,
                                keep=("model",) if ep and "experts" in p
                                else ()), params)


def _count_flops(run) -> int:
    with FlopCounterMode(display=False) as fc:
        run()
    return fc.get_total_flops()


def _collectives(log) -> Dict[str, Any]:
    counts: Dict[str, int] = {}
    for c in log:
        counts[c["op"]] = counts.get(c["op"], 0) + 1
    return {"counts": counts,
            "bytes_per_device": sum(c["bytes"] for c in log),
            "traffic_per_device": sum(c["traffic"] for c in log)}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               cfg_override: Optional[mcfg.ModelConfig] = None,
               extra_tag: str = "", count_flops: bool = True
               ) -> Dict[str, Any]:
    cfg = cfg_override or configs.get(arch)
    cell = shp.get_shape(shape_name)
    skip = shp.skip_reason(cfg, cell)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": cell.kind, "tag": extra_tag,
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
    }
    if skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = skip
        return rec

    prod = make_production_mesh(multi_pod=multi_pod)
    rec["mesh_desc"] = describe(prod)
    mesh = Mesh(tuple(prod.shape.values()), prod.axis_names, rank=0,
                dry=True)
    mesh.comm_log = []
    t0 = time.time()
    opt_cfg = adamw.AdamWConfig(moment_dtype=cfg.optimizer_dtype)
    params = mdl.init_params(0, cfg, device=META)
    mem: Dict[str, Any] = {}

    if cell.kind == "train":
        micro = _clamp_microbatches(cfg, cell, mesh)
        rec["microbatches"] = micro
        seq = cell.seq_len - (cfg.frontend_len if cfg.frontend == "vision"
                              else 0)
        dcfg = pipeline.DataConfig(cell.global_batch, seq)
        pspec = shd.param_spec_tree(params, cfg, mesh)
        ispecs, bspec = _batch_specs(cfg, cell, mesh, dcfg)
        mem["param_bytes"] = local_bytes(params, pspec, mesh)
        mem["moment_bytes"] = 2 * local_bytes(
            params, pspec, mesh, dtype_of(cfg.optimizer_dtype)) + 4
        mem["input_bytes"] = local_bytes(ispecs, bspec, mesh)
        mem["argument_bytes"] = (mem["param_bytes"] + mem["moment_bytes"]
                                 + mem["input_bytes"])
        mem["output_bytes"] = mem["param_bytes"] + mem["moment_bytes"]

        def run():
            state = {"params": _local(params, pspec, mesh),
                     "opt": adamw.init(_local(params, pspec, mesh),
                                       opt_cfg)}
            one = pipeline.input_specs(cfg, pipeline.DataConfig(
                cell.global_batch // micro, seq))
            fn = steps.make_sharded_train_step(cfg, opt_cfg, mesh,
                                               microbatches=1)
            fn(state["params"], state["opt"], one)
    elif cell.kind == "prefill":
        seq = cell.seq_len - (cfg.frontend_len if cfg.frontend == "vision"
                              else 0)
        dcfg = pipeline.DataConfig(cell.global_batch, seq)
        pspec = shd.param_spec_tree(params, cfg, mesh)
        ispecs, bspec = _batch_specs(cfg, cell, mesh, dcfg)
        ispecs.pop("labels", None)
        bspec.pop("labels", None)
        mem["param_bytes"] = local_bytes(params, pspec, mesh)
        mem["input_bytes"] = local_bytes(ispecs, bspec, mesh)
        mem["cache_bytes"] = 0
        cache_len = cell.seq_len
        if cfg.has_decode:
            cache_len = min(cell.seq_len, cfg.window) if cfg.window \
                else cell.seq_len
            caches = steps.abstract_caches(cfg, cell.global_batch,
                                           cache_len,
                                           dtype_of(cfg.compute_dtype))
            mem["cache_bytes"] = local_bytes(
                caches, shd.cache_spec_tree(caches, cfg, mesh), mesh)
        mem["argument_bytes"] = mem["param_bytes"] + mem["input_bytes"]
        mem["output_bytes"] = mem["cache_bytes"]

        def run():
            local = {k: torch.empty(shd.local_shape(v.shape, bspec[k], mesh),
                                    dtype=v.dtype, device=META)
                     for k, v in ispecs.items()}
            full = _gathered(_local(params, pspec, mesh), pspec, mesh, cfg)
            with activation_mesh(mesh):
                steps.make_prefill_step(cfg, cache_len=cell.seq_len)(
                    full, local)
    else:  # decode
        b = cell.global_batch
        pspec = shd.param_spec_tree(params, cfg, mesh, inference=True)
        caches = steps.abstract_caches(cfg, b, cell.seq_len,
                                       dtype_of(cfg.compute_dtype))
        cspec = shd.cache_spec_tree(caches, cfg, mesh)
        bsp = shd.batch_spec(cfg, mesh, b)
        mem["param_bytes"] = local_bytes(params, pspec, mesh)
        mem["cache_bytes"] = local_bytes(caches, cspec, mesh)
        mem["input_bytes"] = _nbytes(shd.local_shape(
            (b, 1), shd.P(bsp[0], None), mesh), torch.int32) + _nbytes(
            shd.local_shape((b,), shd.P(bsp[0]), mesh), torch.int32)
        mem["argument_bytes"] = (mem["param_bytes"] + mem["cache_bytes"]
                                 + mem["input_bytes"])
        mem["output_bytes"] = mem["cache_bytes"]

        def run():
            rows = shd.local_shape((b,), shd.P(bsp[0]), mesh)[0]
            full = _gathered(_local(params, pspec, mesh), pspec, mesh, cfg)
            # the port's decode attends over the whole cached sequence
            local_caches = steps.abstract_caches(
                cfg, rows, cell.seq_len, dtype_of(cfg.compute_dtype))
            tok = torch.empty((rows, 1), dtype=torch.int32, device=META)
            pos = torch.empty((rows,), dtype=torch.int32, device=META)
            with activation_mesh(mesh):
                steps.make_decode_step(cfg)(full, local_caches, tok, pos)

    for k in ("temp_bytes", "alias_bytes", "peak_per_device_gib"):
        mem[k] = None
    rec["memory"] = mem
    rec["cost_analysis_raw"] = None
    rec["null_reasons"] = dict(NULL_REASONS)
    rec["setup_s"] = round(time.time() - t0, 2)
    if count_flops:
        t1 = time.time()
        scale = rec.get("microbatches", 1)
        rec["flops"] = {"flops_per_device": _count_flops(run) * scale,
                        "counted_microbatches": 1,
                        "microbatches": scale}
        rec["collectives"] = _collectives(mesh.comm_log)
        rec["collectives"]["note"] = (
            "one microbatch's step: the MoE's collectives repeat once a "
            "microbatch" if cell.kind == "train" else "one step")
        rec["measure_s"] = round(time.time() - t1, 2)
    rec["status"] = "ok"
    return rec


def load_results(path: str = RESULTS_PATH) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(results: Dict[str, Any], path: str = RESULTS_PATH) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def cell_key(arch: str, shape: str, mesh: str, tag: str = "") -> str:
    k = f"{arch}|{shape}|{mesh}"
    return f"{k}|{tag}" if tag else k


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"],
                    default="both")
    ap.add_argument("--out", default=RESULTS_PATH)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = configs.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in shp.SHAPES] if (args.all or not args.shape) \
        else [args.shape]
    pods = {"on": [True], "off": [False], "both": [False, True]}[
        args.multi_pod]

    results = load_results(args.out)
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                key = cell_key(arch, shape, mesh_name)
                if key in results and not args.force \
                        and results[key].get("status") in ("ok", "skipped"):
                    print(f"[cached] {key}", flush=True)
                    continue
                print(f"[run] {key}", flush=True)
                try:
                    rec = lower_cell(arch, shape, multi_pod=mp)
                except Exception as e:  # noqa: BLE001 - record and continue
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()[-2000:]}
                results[key] = rec
                save_results(results, args.out)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    gib = rec["memory"]["argument_bytes"] / 2**30
                    extra = f" args={gib:.3f}GiB"
                    if "flops" in rec:
                        fl = rec["flops"]["flops_per_device"]
                        extra += f" flops={fl:.3e}"
                elif status == "skipped":
                    extra = f" ({rec['skip_reason'][:60]})"
                else:
                    extra = f" ({rec['error'][:80]})"
                print(f"  -> {status}{extra}", flush=True)


if __name__ == "__main__":
    main()
