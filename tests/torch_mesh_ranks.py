"""Rank bodies for the port's multi-device tests (``launch.mesh.run_ranks``).

Each function runs in a spawned rank process: it imports the port only
(no JAX: the reference's side of each test is computed once, in one
subprocess, and handed over as an ``.npz`` file) and returns numpy arrays
or plain values.  Not a test module: pytest collects nothing here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import keypaths
from repro_torch.launch import steps as SL
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import config as pconfig
from repro_torch.models import moe
from repro_torch.optim import adamw, compress
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.activations import activation_mesh


def tree_from_flat(flat, prefix: str, template):
    """A tree shaped as ``template`` from ``flat[prefix + key]`` arrays
    (bf16 arrives as its bits, uint16)."""
    def one(path, t):
        a = np.asarray(flat[prefix + keypaths.key(path)])
        if t.dtype == torch.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy()).to(t.dtype)
    return keypaths.map_with_path(one, template)


def tree_to_flat(tree, prefix: str = "") -> dict:
    def host(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return {prefix + keypaths.key(p): host(t)
            for p, t in keypaths.leaves_with_path(tree)}


def fail_on_rank_1(rank, world):
    if rank == 1:
        return 1 // 0
    return rank


# -- collectives -------------------------------------------------------------

def collectives_rank(rank, world, path):
    z = np.load(path)
    x, w = torch.from_numpy(z["x"]), torch.from_numpy(z["w"])
    mesh = make_host_mesh(data=4, model=2)
    di, mi = mesh.coords["data"], mesh.coords["model"]
    out = {}
    # the ring over data: w's rows in 4 blocks; x replicated, then x's rows
    # sharded over data
    wl = w[di * 16:(di + 1) * 16].clone().requires_grad_()
    y = col.ring_matmul(x, wl, mesh, axis="data")
    y.sum().backward()
    out["ring"], out["ring_grad"] = y.detach().numpy(), wl.grad.numpy()
    wl = w[di * 16:(di + 1) * 16].clone().requires_grad_()
    xr = x[di * 4:(di + 1) * 4].clone().requires_grad_()
    y = col.ring_matmul(xr, wl, mesh, axis="data", batch_axes=("data",))
    y.sum().backward()
    out["ring_b"], out["ring_b_grad"] = y.detach().numpy(), wl.grad.numpy()
    out["ring_b_xgrad"] = xr.grad.numpy()
    # the reduce-scatter matmul over model: x's columns, w's rows
    out["rs"] = col.reduce_scatter_matmul(
        x[:, mi * 32:(mi + 1) * 32], w[mi * 32:(mi + 1) * 32], mesh,
        axis="model").numpy()
    # reduce_scatter over data (dim 1) and all_reduce over model, of a
    # tensor that differs by rank
    t = torch.arange(6 * 8, dtype=torch.float32).reshape(6, 8) * (rank + 1)
    out["rs_data"] = col.reduce_scatter(t, mesh, "data", dim=1).numpy()
    out["ar_model"] = col.all_reduce(t, mesh, "model").numpy()
    out["coords"] = (di, mi)
    # compressed_psum over 8 ranks of data
    mesh8 = make_host_mesh(data=8, model=1)
    g = torch.from_numpy(z["g"])[rank]
    with activation_mesh(mesh8):
        mean, resid = compress.compressed_psum(
            {"g": g}, {"g": torch.zeros_like(g)}, "data")
    out["cp_mean"], out["cp_resid"] = mean["g"].numpy(), resid["g"].numpy()
    return out


def roundtrip_rank(rank, world, archs):
    """shard_tree then gather_tree of each smoke config's params (and a
    bf16 copy) on (4, 2) and (2, 2, 2): the bits back on every rank."""
    from repro_torch import configs
    from repro_torch.models import model as mdl

    meshes = [make_host_mesh(data=4, model=2),
              make_host_mesh(pod=2, data=2, model=2)]
    ok = {}
    for arch in archs:
        cfg = configs.get_smoke(arch)
        params = mdl.init_params(7, cfg, device="cpu")
        bf = keypaths.map_with_path(lambda _, t: t.to(torch.bfloat16),
                                    params)
        for mesh in meshes:
            for infer in (False, True):
                specs = shd.param_spec_tree(params, cfg, mesh,
                                            inference=infer)
                for name, tree in (("f32", params), ("bf16", bf)):
                    back = shd.gather_tree(shd.shard_tree(tree, specs, mesh),
                                           specs, mesh)
                    ok[f"{arch}/{len(mesh.axis_names)}d/{infer}/{name}"] = \
                        all(torch.equal(a.view(torch.int16)
                                        if a.dtype == torch.bfloat16 else a,
                                        b.view(torch.int16)
                                        if b.dtype == torch.bfloat16 else b)
                            for a, b in zip(keypaths.leaves(tree),
                                            keypaths.leaves(back)))
    return ok


# -- the expert-parallel MoE -------------------------------------------------

def moe_cfg(e=4, k=2, factor=1.25, shared=1, d=64, f=32):
    return pconfig.ModelConfig(
        name="moe", family="moe", d_model=d, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=97, head_dim=16,
        groups=(pconfig.ScanGroup((("attn", "moe"),), 2),),
        moe=pconfig.MoEConfig(num_experts=e, top_k=k, d_expert=f,
                              num_shared=shared, capacity_factor=factor),
        param_dtype="float32", compute_dtype="float32", remat=False)


def moe_rank(rank, world, jobs):
    """This rank's rows of ``moe_apply`` for each job ({key, path, shape,
    cfg_kw, layouts}) under a (data, model) mesh of ``shape``, its experts
    given in each of ``layouts``: "full", "model" (the train step's) or
    "stored" (``param_spec_tree(..., inference=True)``'s shard)."""
    out = {}
    meshes = {}
    for job in jobs:
        shape = tuple(job["shape"])
        if shape not in meshes:
            meshes[shape] = make_host_mesh(data=shape[0], model=shape[1])
        mesh = meshes[shape]
        z = np.load(job["path"])
        cfg = moe_cfg(**job["cfg_kw"])
        full = {"router": torch.from_numpy(z["router"]),
                "experts": {k: torch.from_numpy(z[k])
                            for k in ("w_gate", "w_up", "w_down")}}
        if "s_w_gate" in z.files:
            full["shared"] = {k: torch.from_numpy(z["s_" + k])
                              for k in ("w_gate", "w_up", "w_down")}
        model_specs = {k: shd.P("model", None, None)
                       for k in full["experts"]}
        stored = shd.param_spec_tree(
            {"experts": {k: torch.empty(v.shape, device="meta")
                         for k, v in full["experts"].items()}},
            cfg, mesh, inference=True)["experts"]
        x = torch.from_numpy(z["x"])
        r = x.shape[0] // mesh.shape["data"]
        xl = x[mesh.coords["data"] * r:(mesh.coords["data"] + 1) * r]
        for layout in job["layouts"]:
            p = dict(full)
            if layout != "full":
                specs = model_specs if layout == "model" else stored
                p["experts"] = {k: shd.shard(v, specs[k], mesh)
                                for k, v in full["experts"].items()}
            with activation_mesh(mesh):
                name = moe.dispatch_name(cfg.moe, mesh,
                                         x.shape[0] * x.shape[1])
                y, aux = moe.moe_apply(p, xl, cfg)
            out[(job["key"], layout)] = {
                "y": y.numpy(), "aux": float(aux), "name": name,
                "data": mesh.coords["data"], "model": mesh.coords["model"]}
    return out


# -- the sharded train step --------------------------------------------------

def _state_from(z, cfg, opt):
    template = SL.abstract_train_state(cfg, opt)
    return {"params": tree_from_flat(z, "params/", template["params"]),
            "opt": {"m": tree_from_flat(z, "m/", template["opt"]["m"]),
                    "v": tree_from_flat(z, "v/", template["opt"]["v"]),
                    "count": torch.tensor(int(z["count"]),
                                          dtype=torch.int32)}}


def train_rank(rank, world, jobs):
    """One sharded step for each job ({key, path, cfg_kw, shape, micro,
    ckpt_dir}) from the npz's state on the npz's batch; returns the
    gathered new params and the metrics.  Where ``ckpt_dir`` is set, rank
    0 first saves the state collected from the shards
    (``steps.collect_train_state``)."""
    from repro_torch.checkpoint.manager import CheckpointManager

    out = {}
    for job in jobs:
        z = np.load(job["path"])
        cfg = pconfig.ModelConfig(**job["cfg_kw"])
        opt = adamw.AdamWConfig(learning_rate=1e-3)
        mesh = make_host_mesh(data=job["shape"][0], model=job["shape"][1])
        shards = SL.shard_train_state(_state_from(z, cfg, opt), cfg, mesh)
        if job.get("ckpt_dir"):
            full = SL.collect_train_state(shards, cfg, mesh)
            if rank == 0:
                CheckpointManager(job["ckpt_dir"]).save(0, full)
            torch.distributed.barrier()
        batch = {k[len("batch/"):]: torch.from_numpy(z[k])
                 for k in z.files if k.startswith("batch/")}
        step = SL.make_sharded_train_step(cfg, opt, mesh,
                                          microbatches=job["micro"])
        p, o, metrics = step(shards["params"], shards["opt"], batch)
        new = SL.gather_train_state({"params": p, "opt": o}, cfg, mesh)
        out[job["key"]] = {"loss": float(metrics["loss"]),
                           "grad_norm": float(metrics["grad_norm"]),
                           **tree_to_flat(new["params"], "params/")}
    return out


def dense_cfg_kw(**over):
    kw = dict(name="t", family="dense", d_model=64, num_heads=4,
              num_kv_heads=2, d_ff=128, vocab_size=128,
              groups=(pconfig.ScanGroup((("attn", "mlp"),), 2),),
              remat=False)
    kw.update(over)
    return kw


def moe_cfg_kw(**over):
    cfg = moe_cfg(factor=4.0)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw.update(over)
    return kw
