"""The port's dry run (``launch/dryrun.py``) against the reference's
sharding arithmetic, on the pod16x16 mesh, one rank.

For train_4k, prefill_32k and decode_32k of yi-6b and deepseek-v3: the
per-device bytes of params and moments (and of the caches, where a cell
has them) equal the sum over the reference's spec trees' local shards
(``jax.sharding.AbstractMesh``: no devices); ``microbatches`` equals the
reference's ``_clamp_microbatches``; the record's keys are the
reference's, each without a counterpart ``null`` with its reason; and the
run leaves no process group behind.  The decode cells also count their
FLOPs (``FlopCounterMode`` on ``meta`` tensors), at least 2 · the active
parameters · the rank's tokens, and record the expert-parallel dispatch's
collectives.
"""

import importlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.parallel import sharding as jshd

from repro_torch import configs
from repro_torch.launch import dryrun

CELLS = [(a, s) for a in ("yi_6b", "deepseek_v3_671b")
         for s in ("train_4k", "prefill_32k", "decode_32k")]


def _reference_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _local_bytes(tree, specs, mesh, dtype=None):
    leaves = jax.tree_util.tree_leaves(tree)
    flat = jax.tree_util.tree_leaves(specs,
                                     is_leaf=lambda x: isinstance(x, JP))
    total = 0
    for leaf, spec in zip(leaves, flat):
        n = 1
        for size, entry in zip(leaf.shape, tuple(spec) + (None,) * 8):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= size // math.prod(mesh.shape[a] for a in axes)
        total += n * np.dtype(dtype or leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch, shape", CELLS)
def test_a_cells_bytes_and_microbatches_are_the_references(arch, shape):
    decode = shape.startswith("decode")
    rec = dryrun.lower_cell(arch, shape, multi_pod=False,
                            count_flops=decode)
    assert rec["status"] == "ok" and rec["mesh"] == "pod16x16"
    assert not torch.distributed.is_initialized()
    jcfg = jconfigs.get(arch)
    cell = jshapes.get_shape(shape)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    params = jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    pspec = jshd.param_spec_tree(params, jcfg, mesh, inference=decode)
    mem = rec["memory"]
    assert mem["param_bytes"] == _local_bytes(params, pspec, mesh)
    if cell.kind == "train":
        assert mem["moment_bytes"] == 2 * _local_bytes(
            params, pspec, mesh, jnp.dtype(jcfg.optimizer_dtype)) + 4
        assert rec["microbatches"] == _reference_dryrun()._clamp_microbatches(
            jcfg, cell, mesh)
    else:
        length = cell.seq_len
        if cell.kind == "prefill" and jcfg.window:
            length = min(cell.seq_len, jcfg.window)
        caches = jsteps.abstract_caches(jcfg, cell.global_batch, length,
                                        jnp.dtype(jcfg.compute_dtype))
        assert mem["cache_bytes"] == _local_bytes(
            caches, jshd.cache_spec_tree(caches, jcfg, mesh), mesh)
    for key in ("temp_bytes", "alias_bytes", "peak_per_device_gib"):
        assert mem[key] is None and rec["null_reasons"][key]
    assert rec["cost_analysis_raw"] is None
    assert dryrun.cell_key(arch, shape, "pod16x16") == \
        _reference_dryrun().cell_key(arch, shape, "pod16x16")
    if decode:
        cfg = configs.get(arch)
        tokens = cell.global_batch // 16
        assert rec["flops"]["flops_per_device"] >= \
            2 * cfg.active_param_count() * tokens
        assert rec["collectives"]["counts"]["all-gather"] > 0
        if cfg.moe is not None:       # ep2d's combine: one all-reduce a layer
            assert rec["collectives"]["counts"]["all-reduce"] >= sum(
                g.repeats for g in cfg.groups
                if any(f == "moe" for _, f in g.pattern))


def test_skipped_cells_say_why_as_the_reference():
    rec = dryrun.lower_cell("hubert_xlarge", "decode_32k", multi_pod=True)
    want = jshapes.skip_reason(jconfigs.get("hubert_xlarge"),
                               jshapes.get_shape("decode_32k"))
    assert rec["status"] == "skipped" and rec["skip_reason"] == want
    assert rec["mesh"] == "pod2x16x16"


def test_the_results_file_resumes(tmp_path):
    path = str(tmp_path / "r.json")
    results = dryrun.load_results(path)
    assert results == {}
    key = dryrun.cell_key("yi_6b", "decode_32k", "pod2x16x16")
    results[key] = dryrun.lower_cell("yi_6b", "decode_32k", multi_pod=True,
                                     count_flops=False)
    dryrun.save_results(results, path)
    assert dryrun.load_results(path)[key]["status"] == "ok"
