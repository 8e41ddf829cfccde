"""The port's sharded train step (``launch/steps.py::make_sharded_train_step``)
on gloo ranks, its elastic restore, and the train CLI's ``--mesh``.

* The reference's dense config of ``tests/test_distributed.py`` at batch
  8 × 32 in 2 microbatches on a (4, 2) mesh: after one sharded step the
  loss within 2e-4 and every parameter within atol 3e-5 / rtol 3e-4 (the
  reference's own single-device-vs-sharded limits) of the port's unsharded
  step and of the reference's single-device and sharded steps, from one
  state (the reference's, carried across through a flat ``.npz``) with
  moments at the gradient's scale; from zero moments, of the port's
  unsharded step (Adam's first update flips sign on a gradient within its
  rounding of 0, and the port's unsharded step and the reference's differ
  there on one element in 16,384 of this config).
* A small MoE through each expert-parallel dispatch — ep2d on (2, 2),
  ep_dstat on (2, 2) at 6 experts, ep on (1, 4) — against the port's own
  unsharded step, within the same limits (an ample capacity, so no slot
  drops on either side).
* Elastic: the state saved from (4, 2)'s shards, restored on (2, 2) by
  ``restore_on_mesh``, is every rank's shard of it to the bit.

The reference's side runs once, in one subprocess with 8 fake host
devices; the ranks import the port only.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import keypaths
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import pipeline
from repro_torch.launch import steps as SL
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models import config as pconfig
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.elastic import restore_on_mesh

import torch_mesh_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
LOSS_TOL, ATOL, RTOL = 2e-4, 3e-5, 3e-4

REFERENCE = """
import sys
import numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro.models import ModelConfig
from repro.models.config import ScanGroup
from repro.launch import steps as SL
from repro.launch.mesh import make_host_mesh
from repro.parallel import sharding as shd
from repro.parallel.activations import activation_mesh
from repro.data import pipeline
from repro.optim import adamw

def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[prefix + key] = np.asarray(leaf)
    return out

cfg = ModelConfig(name="t", family="dense", d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=128,
    groups=(ScanGroup((("attn","mlp"),), 2),), remat=False)
opt = adamw.AdamWConfig(learning_rate=1e-3)
dcfg = pipeline.DataConfig(global_batch=8, seq_len=32)
batch = pipeline.make_batch(cfg, dcfg, 0)
state = SL.init_train_state(jax.random.PRNGKey(0), cfg, opt)
out = {**flat(state["params"], "params/"), **flat(state["opt"]["m"], "m/"),
       **flat(state["opt"]["v"], "v/"),
       "count": np.asarray(state["opt"]["count"]),
       **flat(dict(batch), "batch/")}
train = SL.make_train_step(cfg, opt, microbatches=2)
mesh = make_host_mesh(data=4, model=2)
pspec = shd.param_spec_tree(jax.eval_shape(lambda: state["params"]), cfg,
                            mesh)
ospec = {"m": pspec, "v": pspec, "count": P()}
bspec = {k: P("data") for k in batch}
with mesh, activation_mesh(mesh):
    sharded = jax.jit(train, in_shardings=(shd.named(mesh, pspec),
                                           shd.named(mesh, ospec),
                                           shd.named(mesh, bspec)),
                      out_shardings=(shd.named(mesh, pspec),
                                     shd.named(mesh, ospec), None))

# moments carried at each leaf's gradient scale s (m ~ N(0, s^2),
# v ~ s^2 U[1/2, 3/2], count 3), as tests/test_torch_train.py carries them
(_, _), g = jax.value_and_grad(
    lambda p: SL.mdl.loss_fn(p, cfg, batch), has_aux=True)(state["params"])
rng = np.random.default_rng(1)
rms = jax.tree.map(lambda x: float(np.sqrt(np.mean(np.square(
    np.asarray(x, np.float64))))) + 1e-12, g)
carried = {"params": state["params"], "opt": {
    "m": jax.tree.map(lambda p, s: (rng.standard_normal(p.shape) * s)
                      .astype(np.float32), state["params"], rms),
    "v": jax.tree.map(lambda p, s: ((rng.random(p.shape) + 0.5) * s * s)
                      .astype(np.float32), state["params"], rms),
    "count": np.asarray(3, np.int32)}}
out.update(flat(carried["opt"]["m"], "cm/"))
out.update(flat(carried["opt"]["v"], "cv/"))
for tag, st in (("", state), ("c", carried)):
    p1, o1, m1 = jax.jit(train)(st["params"], st["opt"], batch)
    with mesh, activation_mesh(mesh):
        p8, o8, m8 = sharded(st["params"], st["opt"], batch)
    out.update(flat(p1, tag + "p1/"))
    out.update(flat(p8, tag + "p8/"))
    out[tag + "loss1"] = np.asarray(m1["loss"])
    out[tag + "loss8"] = np.asarray(m8["loss"])
np.savez(sys.argv[1], **out)
"""

#: key → (cfg kwargs, mesh, microbatches)
MOE_RUNS = {"ep2d_2x2": (dict(), (2, 2), 1),
            "dstat_2x2": (dict(e=6), (2, 2), 1),
            "ep_1x4": (dict(), (1, 4), 1)}


def _moe_kw(e=4):
    kw = ranks.moe_cfg_kw()
    kw["moe"] = pconfig.MoEConfig(num_experts=e, top_k=2, d_expert=32,
                                  num_shared=1, capacity_factor=float(e))
    return kw


def _port_step(z, cfg, micro):
    opt = adamw.AdamWConfig(learning_rate=1e-3)
    state = ranks._state_from(z, cfg, opt)
    batch = {k[len("batch/"):]: torch.from_numpy(z[k])
             for k in z if k.startswith("batch/")}
    p, _, m = SL.make_train_step(cfg, opt, microbatches=micro)(
        state["params"], state["opt"], batch)
    return float(m["loss"]), ranks.tree_to_flat(p, "params/")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    dense = str(tmp / "dense.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                          dense], capture_output=True, text=True, env=env,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    z = dict(np.load(dense))
    carried = str(tmp / "carried.npz")
    np.savez(carried, **{k: v for k, v in z.items()
                         if not k.startswith(("m/", "v/", "count"))},
             **{k[1:]: v for k, v in z.items() if k.startswith(("cm/",
                                                                "cv/"))},
             count=np.asarray(3, np.int32))
    jobs8 = [{"key": "dense", "path": dense, "shape": (4, 2), "micro": 2,
              "cfg_kw": ranks.dense_cfg_kw(),
              "ckpt_dir": str(tmp / "ckpt")},
             {"key": "carried", "path": carried, "shape": (4, 2),
              "micro": 2, "cfg_kw": ranks.dense_cfg_kw()}]
    jobs4 = []
    for key, (over, shape, micro) in MOE_RUNS.items():
        cfg = pconfig.ModelConfig(**_moe_kw(**over))
        opt = adamw.AdamWConfig(learning_rate=1e-3)
        state = SL.init_train_state(3, cfg, opt, device="cpu")
        batch = pipeline.make_batch(cfg, pipeline.DataConfig(8, 32), 0,
                                    device="cpu")
        path = str(tmp / f"{key}.npz")
        np.savez(path, **ranks.tree_to_flat(state["params"], "params/"),
                 **ranks.tree_to_flat(state["opt"]["m"], "m/"),
                 **ranks.tree_to_flat(state["opt"]["v"], "v/"),
                 count=np.asarray(0, np.int32),
                 **{f"batch/{k}": v.numpy() for k, v in batch.items()})
        jobs4.append({"key": key, "path": path, "shape": shape,
                      "micro": micro, "cfg_kw": _moe_kw(**over)})
    got = run_ranks(ranks.train_rank, 8, backend="gloo", args=(jobs8,),
                    timeout=TIMEOUT)
    got4 = run_ranks(ranks.train_rank, 4, backend="gloo", args=(jobs4,),
                     timeout=TIMEOUT)
    for r, extra in enumerate(got4):
        got[r].update(extra)
    return z, got, {j["key"]: j for j in jobs4}, tmp, carried


def _close(got: dict, want: dict, prefix_want: str):
    keys = [k for k in got if k.startswith("params/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[prefix_want + k[7:]],
                                   atol=ATOL, rtol=RTOL, err_msg=k)


def test_the_sharded_step_matches_both_unsharded_steps(runs):
    """From moments carried at the gradient's scale (a step is then a
    smooth function of the gradient), the sharded step within the limits of
    the port's unsharded step, the reference's single-device step and the
    reference's own sharded step."""
    ref, got, _, _, carried = runs
    cfg = pconfig.ModelConfig(**ranks.dense_cfg_kw())
    loss, params = _port_step(np.load(carried), cfg, 2)
    for r in range(8):
        mine = got[r]["carried"]
        assert abs(mine["loss"] - float(ref["closs1"])) < LOSS_TOL
        assert abs(mine["loss"] - loss) < LOSS_TOL
        _close(mine, {("p1/" + k[7:]): v for k, v in params.items()}, "p1/")
        _close(mine, ref, "cp1/")
        _close(mine, ref, "cp8/")


def test_from_zero_moments_the_sharded_step_matches_the_unsharded_one(runs):
    """From zero moments (the reference's state as drawn), Adam's first
    update is g / (|g| + ε), whose sign flips for a gradient within its
    rounding of 0: the sharded step within the limits of the port's
    unsharded one (same library, other summation order) and the loss of
    the reference's single-device step."""
    ref, got, _, _, _ = runs
    cfg = pconfig.ModelConfig(**ranks.dense_cfg_kw())
    loss, params = _port_step(ref, cfg, 2)
    for r in range(8):
        mine = got[r]["dense"]
        assert abs(mine["loss"] - float(ref["loss1"])) < LOSS_TOL
        assert abs(mine["loss"] - loss) < LOSS_TOL
        _close(mine, {("p1/" + k[7:]): v for k, v in params.items()}, "p1/")


@pytest.mark.parametrize("key", sorted(MOE_RUNS))
def test_the_expert_parallel_step_matches_the_unsharded_one(runs, key):
    _, got, jobs, _, _ = runs
    job = jobs[key]
    cfg = pconfig.ModelConfig(**job["cfg_kw"])
    z = np.load(job["path"])
    loss, params = _port_step(z, cfg, job["micro"])
    for r in range(4):
        mine = got[r][key]
        assert abs(mine["loss"] - loss) < LOSS_TOL
        _close(mine, {("p/" + k[7:]): v for k, v in params.items()}, "p/")
    # the experts' gradient is not zero: the step moved them
    k = next(k for k in params if k.endswith("experts/w_gate"))
    assert not np.array_equal(got[0][key][k], z[k])


def test_an_elastic_restore_gives_every_rank_its_shards_to_the_bit(runs):
    ref, _, _, tmp, _ = runs
    cfg = pconfig.ModelConfig(**ranks.dense_cfg_kw())
    opt = adamw.AdamWConfig(learning_rate=1e-3)
    state = ranks._state_from(ref, cfg, opt)
    mgr = CheckpointManager(str(tmp / "ckpt"))
    whole = mgr.restore(0, state)          # saved from (4, 2)'s shards
    for a, b in zip(keypaths.leaves(state), keypaths.leaves(whole)):
        assert torch.equal(a, b)
    template = SL.abstract_train_state(cfg, opt)
    for rank in range(4):
        small = Mesh((2, 2), ("data", "model"), rank=rank)
        got = restore_on_mesh(mgr, 0, template, cfg, small, device="cpu")
        specs = shd.param_spec_tree(template["params"], cfg, small)
        want = SL.shard_train_state(state, cfg, small)
        for a, b in zip(keypaths.leaves(want), keypaths.leaves(got)):
            assert a.shape == b.shape and torch.equal(a, b)
        assert any(s != shd.P(*([None] * len(s)))
                   for s in keypaths.leaves(specs))
