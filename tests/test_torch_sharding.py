"""The port's sharding policy and meshes (``parallel/sharding.py``,
``launch/mesh.py``, ``runtime/elastic.py``'s plan) against the reference's.

The policy is pure Python over shapes and a mesh's axes, so both sides run
in this process: the reference's on ``jax.sharding.AbstractMesh`` (no
devices), the port's on an abstract :class:`repro_torch.launch.mesh.Mesh`,
each over its own package's parameter and cache trees (``jax.eval_shape``
and ``meta`` tensors).  Every spec must equal the reference's, leaf for
leaf: ``param_spec_tree`` on all ten configs, for training and
``inference=True``, on meshes (1, 1), (2, 4), (4, 2), (16, 16) and
(2, 16, 16); ``cache_spec_tree``, ``batch_spec``, ``heuristic_spec``,
``activations.resolve_spec``, ``describe``, ``plan_rescale`` and the dry
run's ``_clamp_microbatches`` likewise.  Last, each new module exports the
reference module's public names.
"""

import importlib
import itertools
import os
import types

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.parallel import activations as jact
from repro.parallel import sharding as jshd
from repro.runtime import elastic as jelastic

from repro_torch import configs, keypaths
from repro_torch.configs import shapes as pshapes
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import steps as psteps
from repro_torch.models import model as pmodel
from repro_torch.models.layers import META
from repro_torch.parallel import activations as pact
from repro_torch.parallel import sharding as pshd
from repro_torch.runtime import elastic as pelastic

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _meshes(shape, axes):
    return AbstractMesh(shape, axes), pmesh.Mesh(shape, axes)


def _jkey(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _ref_specs(tree):
    return {_jkey(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def _port_specs(tree):
    out = {}
    for p, s in keypaths.leaves_with_path(tree):
        assert isinstance(s, pshd.PartitionSpec)
        out[p] = tuple(s)
    return out


@pytest.fixture(scope="module")
def shapes():
    """Each config's parameter tree in both packages (shapes only)."""
    out = {}
    for arch in configs.ARCH_IDS:
        jcfg, pcfg = jconfigs.get(arch), configs.get(arch)
        out[arch] = (jcfg, pcfg, jax.eval_shape(
            lambda c=jcfg: jmodel.init_params(jax.random.PRNGKey(0), c)),
            pmodel.init_params(0, pcfg, device=META))
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])))
@pytest.mark.parametrize("inference", [False, True])
def test_param_spec_trees_are_the_references(shapes, arch, mesh,
                                             inference):
    jcfg, pcfg, jtree, ptree = shapes[arch]
    jm, pm = _meshes(*mesh)
    want = _ref_specs(jshd.param_spec_tree(jtree, jcfg, jm,
                                           inference=inference))
    got = _port_specs(pshd.param_spec_tree(ptree, pcfg, pm,
                                           inference=inference))
    assert got == want


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if configs.get(a).has_decode])
@pytest.mark.parametrize("batch, max_len", [(4, 64), (128, 32768), (1, 8)])
def test_cache_spec_trees_are_the_references(arch, batch, max_len):
    jcfg, pcfg = jconfigs.get(arch), configs.get(arch)
    jc = jsteps.abstract_caches(jcfg, batch, max_len, jnp.bfloat16)
    pc = psteps.abstract_caches(pcfg, batch, max_len, torch.bfloat16)
    for mesh in MESHES:
        jm, pm = _meshes(*mesh)
        assert _port_specs(pshd.cache_spec_tree(pc, pcfg, pm)) == \
            _ref_specs(jshd.cache_spec_tree(jc, jcfg, jm))


@pytest.mark.parametrize("mesh", MESHES + [((3, 2), ("data", "model")),
                                           ((2, 3, 4),
                                            ("pod", "data", "model"))],
                         ids=lambda m: "x".join(map(str, m[0])))
def test_batch_heuristic_and_resolved_specs_are_the_references(mesh):
    jm, pm = _meshes(*mesh)
    cfg = configs.get("yi_6b")
    for b in (1, 2, 3, 8, 12, 32, 128, 256):
        assert tuple(pshd.batch_spec(cfg, pm, b)) == tuple(
            jshd.batch_spec(jconfigs.get("yi_6b"), jm, b))
    for shape in itertools.product((1, 2, 6, 16), (1, 4, 32, 4096),
                                   (3, 8, 128)):
        for seq_dim in (None, 1, 2):
            assert tuple(pshd.heuristic_spec(shape, pm, seq_dim=seq_dim)) \
                == tuple(jshd.heuristic_spec(shape, jm, seq_dim=seq_dim))
        for pattern in itertools.product(
                (pact.BATCH, pact.MODEL, pact.BOTH, None, "data"),
                repeat=2):
            full = (shape[0],) + shape[2:]
            assert tuple(pact.resolve_spec(full, pattern, pm)) == tuple(
                jact.resolve_spec(full, pattern, jm))
    assert pshd.dp_axes(pm) == jshd.dp_axes(jm)
    assert pshd.dp_size(pm) == jshd.dp_size(jm)
    assert pshd.model_size(pm) == jshd.model_size(jm)
    assert pshd.mesh_axes(pm) == jshd.mesh_axes(jm)


def test_specs_normalise_as_the_references():
    for entries in [((),), (("data",),), (("pod", "data"), None), (),
                    (None, "model"), (("model", "data"), None, None)]:
        assert tuple(pshd.P(*entries)) == tuple(JP(*entries))


def test_meshes_are_described_as_the_references():
    for multi in (False, True):
        p = pmesh.make_production_mesh(multi_pod=multi)
        assert pmesh.describe(p) == "×".join(
            f"{a}={n}" for a, n in p.shape.items()) + f" ({p.size} chips)"
        assert p.rank is None and p.size == (512 if multi else 256)
    for shape, axes in MESHES + [((3,), ("cores",))]:
        jm, pm = _meshes(shape, axes)
        assert pmesh.describe(pm) == jmesh.describe(jm)
    # outside a run of ranks, a one-rank mesh is rank 0; a larger one is
    # abstract
    assert pmesh.make_host_mesh().rank == 0
    assert pmesh.make_host_mesh(data=2, model=2).rank is None
    assert pmesh.make_cluster_mesh(4).shape == {"cores": 4}
    with pytest.raises(ValueError, match="cores must be >= 1"):
        pmesh.make_cluster_mesh(0)


def test_a_mesh_lays_out_ranks_row_major_and_indexes_spec_order():
    m = pmesh.Mesh((2, 3, 4), ("pod", "data", "model"), rank=17)
    assert m.coords == {"pod": 1, "data": 1, "model": 1}
    assert m.index(("model", "data")) == 1 * 3 + 1
    assert m.index(("data", "model")) == 1 * 4 + 1
    assert m.members(("model",)) == [16, 17, 18, 19]
    assert m.members(("model", "data")) == sorted(
        range(12, 24), key=lambda r: (r % 4, (r // 4) % 3))


@pytest.mark.parametrize("micro", [1, 2, 3, 4])
@pytest.mark.parametrize("batch", [8, 12, 16, 256])
def test_plan_rescale_is_the_references(micro, batch):
    import dataclasses
    cfgs = [dataclasses.replace(c.get("yi_6b"), microbatches=micro)
            for c in (jconfigs, configs)]
    shapes = [((4, 2), ("data", "model")), ((2, 2), ("data", "model")),
              ((1, 4), ("data", "model")), ((2, 16, 16),
                                            ("pod", "data", "model")),
              ((16, 16), ("data", "model")), ((3, 2), ("data", "model"))]
    for old, new in itertools.product(shapes, repeat=2):
        jo, po = _meshes(*old)
        jn, pn = _meshes(*new)
        want = jelastic.plan_rescale(cfgs[0], batch, jo, jn)
        got = pelastic.plan_rescale(cfgs[1], batch, po, pn)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without leaving its XLA_FLAGS
    (set at import for 512 host devices) in this process's environment."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_clamped_microbatches_are_the_references(arch):
    from repro_torch.launch import dryrun
    jdry = _reference_dryrun()
    for cell, multi in itertools.product(pshapes.SHAPES, (False, True)):
        jcell = jshapes.get_shape(cell.name)
        jm = AbstractMesh((2, 16, 16) if multi else (16, 16),
                          ("pod", "data", "model") if multi
                          else ("data", "model"))
        pm = pmesh.make_production_mesh(multi_pod=multi)
        assert dryrun._clamp_microbatches(configs.get(arch), cell, pm) == \
            jdry._clamp_microbatches(jconfigs.get(arch), jcell, jm)


def _public(mod):
    """Public names that the module defines or takes from its package
    (not modules, nor what it imports from the standard library, typing,
    numpy, JAX or torch) — ``tests/test_torch_fault.py``'s rule."""
    out = set()
    for n in dir(mod):
        obj = getattr(mod, n)
        if n.startswith("_") or isinstance(obj, types.ModuleType):
            continue
        owner = getattr(obj, "__module__", None)
        if owner is None or owner.split(".")[0] == "repro":
            out.add(n)
    return out


@pytest.mark.parametrize("module", [
    "launch.mesh", "launch.hlo_analysis", "launch.dryrun",
    "parallel.sharding", "parallel.collectives", "parallel.activations",
    "runtime.elastic"])
def test_the_new_modules_export_the_references_names(module):
    ref = _reference_dryrun() if module == "launch.dryrun" else \
        importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    want = _public(ref)
    assert want - set(dir(port)) == set()
    for name in want:   # the same kind of object: class, function, value
        assert callable(getattr(ref, name)) is \
            callable(getattr(port, name)), name


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "jamba_v01_52b"])
@pytest.mark.parametrize("inference", [False, True])
def test_a_ranks_shards_of_the_references_params_are_its_slices(arch,
                                                                inference):
    """``interop.shards_from_reference``: each rank of (2, 2)'s shard of
    every leaf is the slice of the reference's array that the reference's
    spec assigns to that rank (its devices laid out row-major, a dim over
    several axes split first-axis-major), to the bit."""
    import numpy as np
    from repro_torch import interop

    jcfg, pcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    ref = jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(2), jcfg))
    jm = AbstractMesh((2, 2), ("data", "model"))
    specs = {_jkey(p): tuple(s) for p, s in
             jax.tree_util.tree_flatten_with_path(
                 jshd.param_spec_tree(ref, jcfg, jm, inference=inference),
                 is_leaf=lambda x: isinstance(x, JP))[0]}
    leaves = {_jkey(p): a for p, a in
              jax.tree_util.tree_flatten_with_path(ref)[0]}
    for rank in range(4):
        pm = pmesh.Mesh((2, 2), ("data", "model"), rank=rank)
        coords = {"data": rank // 2, "model": rank % 2}
        got = interop.shards_from_reference(ref, pcfg, pm, device="cpu",
                                            inference=inference)
        for path, t in keypaths.leaves_with_path(got):
            want = leaves[path]
            for dim, entry in enumerate(specs[path]):
                axes = () if entry is None else (
                    entry if isinstance(entry, tuple) else (entry,))
                n, i = 1, 0
                for a in axes:
                    n, i = n * 2, i * 2 + coords[a]
                size = want.shape[dim] // n
                want = np.take(want, range(i * size, (i + 1) * size),
                               axis=dim)
            assert t.shape == want.shape, path
            np.testing.assert_array_equal(
                t.float().numpy(), want.astype(np.float32), err_msg=str(path))
