"""The port's expert-parallel MoE (``models/moe.py``: ``_moe_apply_ep``,
``_moe_apply_ep2d``, ``_moe_apply_ep_dstat`` and its fallback) against the
reference's same dispatch on fake devices, and against its own no-mesh
``moe_apply``.

Each case runs on a mesh that selects its dispatch: ep on (1, 4) and on
(2, 2) above 4,096 tokens, ep2d on (2, 2), ep_dstat on (3, 2) with widths
that divide by 3, and the fallback to ep on (3, 2) with widths that do
not.  The reference's side runs once, in one subprocess with 8 fake host
devices; the port's on gloo ranks (``launch.mesh.run_ranks``), each given
its experts as the full leaves, as its ``model`` shard and as the
weights-stationary shard of ``param_spec_tree(..., inference=True)``.
Routing (the expert ids and the slots' positions in their experts) is
held exactly equal on every token set a rank routes; outputs within
``tests/test_torch_moe.py``'s f32 limit (``F32_LAYER``: 1e-6 of the
reference's max |value|) at capacity factor 1.25, where slots drop, and
against the port's own no-mesh dispatch at an ample factor, where none
does.  The selection rule is held to the reference's at 4,096 and 4,097
tokens.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import AbstractMesh
from repro.models import moe as jmoe
from repro.parallel import activations as jact

from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models import moe

import torch_mesh_ranks as ranks
from test_torch_models import F32_LAYER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

#: key → (mesh (data, model), cfg_kw, x shape, the dispatch it selects)
CASES = {
    "ep_1x4": ((1, 4), dict(e=8, k=2), (4, 8, 64), "ep"),
    "ep2d_2x2": ((2, 2), dict(e=4, k=2), (4, 8, 64), "ep2d"),
    "dstat_3x2": ((3, 2), dict(e=4, k=2, d=96, f=48), (6, 4, 96),
                  "ep_dstat"),
    "fallback_3x2": ((3, 2), dict(e=4, k=2), (6, 4, 64), "ep_dstat"),
    "ep_big_2x2": ((2, 2), dict(e=4, k=2), (2, 2056, 64), "ep"),
}
FACTORS = {"tight": 1.25, "ample": None}      # None: e / k, no slot drops

REFERENCE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.models import config as C
from repro.models import moe as jmoe
from repro.parallel.activations import activation_mesh

jobs = json.loads(sys.argv[1])
for job in jobs:
    kw = job["cfg_kw"]
    d, f, e, k = kw.get("d", 64), kw.get("f", 32), kw["e"], kw["k"]
    cfg = C.ModelConfig(
        name="moe", family="moe", d_model=d, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=97, head_dim=16,
        groups=(C.ScanGroup((("attn", "moe"),), 2),),
        moe=C.MoEConfig(num_experts=e, top_k=k, d_expert=f, num_shared=1,
                        capacity_factor=kw["factor"]),
        param_dtype="float32", compute_dtype="float32", remat=False)
    rng = np.random.default_rng(job["seed"])
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f),
         "s_w_gate": rng.standard_normal((d, f)) / np.sqrt(d),
         "s_w_up": rng.standard_normal((d, f)) / np.sqrt(d),
         "s_w_down": rng.standard_normal((f, d)) / np.sqrt(f),
         "x": rng.standard_normal(tuple(job["x"]))}
    p = {n: a.astype(np.float32) for n, a in p.items()}
    jp = {"router": jnp.asarray(p["router"]),
          "experts": {n: jnp.asarray(p[n])
                      for n in ("w_gate", "w_up", "w_down")},
          "shared": {n: jnp.asarray(p["s_" + n])
                     for n in ("w_gate", "w_up", "w_down")}}
    dd, mm = job["shape"]
    mesh = Mesh(np.array(jax.devices()[:dd * mm]).reshape(dd, mm),
                ("data", "model"))
    with mesh, activation_mesh(mesh):
        y, aux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, cfg))(
            jp, jnp.asarray(p["x"]))
    np.savez(job["path"], y_ref=np.asarray(y), aux_ref=np.asarray(aux),
             **p)
"""


def _jobs(tmp):
    jobs = []
    for key, (shape, kw, xs, _) in CASES.items():
        for fname, factor in FACTORS.items():
            kw2 = dict(kw, factor=factor or kw["e"] / kw["k"])
            jobs.append({"key": f"{key}/{fname}", "shape": shape,
                         "cfg_kw": kw2, "x": xs, "seed": len(jobs),
                         "path": str(tmp / f"{key}_{fname}.npz"),
                         "layouts": ("full", "model", "stored")})
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    jobs = _jobs(tmp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), json.dumps(jobs)],
        capture_output=True, text=True, env=env, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    got = {}
    for world in (4, 6):
        mine = [j for j in jobs if j["shape"][0] * j["shape"][1] == world]
        for rank_out in run_ranks(ranks.moe_rank, world, backend="gloo",
                                  args=(mine,), timeout=TIMEOUT):
            for k, v in rank_out.items():
                got.setdefault(k, []).append(v)
    return {j["key"]: j for j in jobs}, got


def _assemble(outs):
    """The global y from the ranks' rows (model rank 0's), and every
    rank's aux and dispatch."""
    mine = sorted((o for o in outs if o["model"] == 0),
                  key=lambda o: o["data"])
    return (np.concatenate([o["y"] for o in mine], axis=0),
            [o["aux"] for o in outs], {o["name"] for o in outs})


def _cfg_pair(kw):
    from repro.models import config as jconfig
    from repro_torch.models import config as pconfig

    def one(C):
        return C.ModelConfig(
            name="moe", family="moe", d_model=kw.get("d", 64), num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=97, head_dim=16,
            groups=(C.ScanGroup((("attn", "moe"),), 2),),
            moe=C.MoEConfig(num_experts=kw["e"], top_k=kw["k"],
                            d_expert=kw.get("f", 32), num_shared=1,
                            capacity_factor=kw["factor"]),
            param_dtype="float32", compute_dtype="float32", remat=False)
    return one(jconfig), one(pconfig)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("factor", sorted(FACTORS))
@pytest.mark.parametrize("layout", ["full", "model", "stored"])
def test_the_dispatch_matches_the_reference(runs, case, factor, layout):
    jobs, got = runs
    job = jobs[f"{case}/{factor}"]
    z = np.load(job["path"])
    y, auxes, names = _assemble(got[(job["key"], layout)])
    assert names == {CASES[case][3]}
    ref = z["y_ref"]
    scale = float(np.abs(ref).max())
    assert np.abs(y - ref).max() <= F32_LAYER * scale, \
        np.abs(y - ref).max() / scale
    for aux in auxes:
        assert abs(aux - float(z["aux_ref"])) <= 1e-6 * abs(
            float(z["aux_ref"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_dispatch_matches_the_ports_own_without_a_mesh(runs, case):
    """At an ample capacity no slot drops, so every dispatch computes the
    plain one's function; its output within the f32 limit of it."""
    jobs, got = runs
    job = jobs[f"{case}/ample"]
    z = np.load(job["path"])
    _, pcfg = _cfg_pair(job["cfg_kw"])
    p = {"router": torch.from_numpy(z["router"]),
         "experts": {k: torch.from_numpy(z[k])
                     for k in ("w_gate", "w_up", "w_down")},
         "shared": {k: torch.from_numpy(z["s_" + k])
                    for k in ("w_gate", "w_up", "w_down")}}
    want, _ = moe.moe_apply(p, torch.from_numpy(z["x"]), pcfg)
    want = want.numpy()
    y, _, _ = _assemble(got[(job["key"], "model")])
    assert np.abs(y - want).max() <= F32_LAYER * float(np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_token_set_routes_exactly_as_the_reference(runs, case):
    """The expert ids and the slots' positions of every token set a rank
    routes (its rows for ep; its data group's rows, gathered, for ep2d and
    ep_dstat), exactly the reference's."""
    jobs, _ = runs
    job = jobs[f"{case}/tight"]
    z = np.load(job["path"])
    jcfg, pcfg = _cfg_pair(job["cfg_kw"])
    x = z["x"].reshape(-1, z["x"].shape[-1])
    dd = job["shape"][0]
    sets = [x] if CASES[case][3] in ("ep2d", "ep_dstat") and \
        case != "fallback_3x2" else np.split(x, dd)
    for xs in sets:
        _, jids, _, _ = jmoe._route(jnp.asarray(xs),
                                    jnp.asarray(z["router"]), jcfg.moe)
        _, pids, _, _ = moe._route(torch.from_numpy(xs),
                                   torch.from_numpy(z["router"]), pcfg.moe)
        np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
        flat = np.array(jids).reshape(-1)
        np.testing.assert_array_equal(
            moe._positions_in_expert(torch.from_numpy(flat).long(),
                                     pcfg.moe.num_experts).numpy(),
            np.asarray(jmoe._positions_in_expert(jnp.asarray(flat),
                                                 jcfg.moe.num_experts)))


@pytest.mark.parametrize("tokens", [4096, 4097])
@pytest.mark.parametrize("shape, e", [((1, 4), 8), ((2, 2), 4), ((3, 2), 4),
                                      ((2, 4), 8), ((4, 2), 6), ((1, 1), 4),
                                      ((2, 1), 4)])
def test_the_selection_rule_is_the_references(monkeypatch, tokens, shape, e):
    """The path ``moe_apply`` takes at 4,096 and 4,097 tokens, against the
    reference's (its variants replaced by recorders, on an abstract
    mesh)."""
    jcfg, pcfg = _cfg_pair(dict(e=e, k=2, factor=1.25))
    taken = []
    for name in ("_moe_apply_ep", "_moe_apply_ep2d", "_moe_apply_ep_dstat",
                 "_moe_apply_xla"):
        monkeypatch.setattr(jmoe, name, lambda *a, _n=name: taken.append(
            _n) or (None, None))
    jmesh = AbstractMesh(shape, ("data", "model"))
    with jact.activation_mesh(jmesh):
        jmoe.moe_apply({}, jnp.zeros((1, tokens, 64)), jcfg)
    want = taken[0].removeprefix("_moe_apply_")
    got = moe.dispatch_name(pcfg.moe, Mesh(shape, ("data", "model")),
                            tokens)
    assert got == want


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 2), (2, 16, 16),
                                   (16, 16), (3, 2)])
@pytest.mark.parametrize("e", [4, 6, 8, 16, 256])
def test_ep2d_axes_are_the_references(shape, e):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    assert moe.ep2d_axes(Mesh(shape, axes), e) == jmoe.ep2d_axes(
        AbstractMesh(shape, axes), e)
