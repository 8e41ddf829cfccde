"""The port's checkpoint manager (``checkpoint/manager.py``), on the CPU,
and its files against the JAX package's.

The reference's own manager tests (``tests/test_substrate.py``,
``TestCheckpoint``) are ported as cases; then the cross-reads: a train
state the reference writes (f32, and bf16 parameters) restores in the
port to the bits; an f32 state the port writes restores in the reference,
with the manifests equal; each leaf's ``.npy`` member is the reference's
bytes, bf16's ``|V2`` included.  The reference cannot restore its own bf16
checkpoint (C10): its ``restore`` hands numpy's ``|V2`` to
``jax.numpy.asarray``, which raises ``TypeError``.
"""

import dataclasses
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.launch import steps as jsteps
from repro.optim import adamw as jadamw

from repro_torch import configs, interop, keypaths
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import steps
from repro_torch.optim import adamw


def _state(x=1.0):
    return {"params": {"w": torch.full((4, 4), x), "b": torch.arange(4.0)},
            "opt": {"m": {"w": torch.zeros(4, 4), "b": torch.zeros(4)},
                    "count": torch.tensor(3, dtype=torch.int32)}}


def _zeros_like(state):
    return keypaths.map_with_path(lambda _, x: torch.zeros_like(x), state)


# -- the reference's TestCheckpoint, on the port ------------------------------

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state(2.5)
    mgr.save(10, state)
    assert mgr.latest_step() == 10
    restored = mgr.restore(10, _zeros_like(state))
    for a, b in zip(keypaths.leaves(restored), keypaths.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(float(s)), blocking=False)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_manifest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, _state(), extra={"data_step": 7})
    m = mgr.manifest(7)
    assert m["step"] == 7
    assert m["extra"]["data_step"] == 7
    assert "params/w" in m["leaves"]


def test_atomic_no_partial_on_existing(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1.0))
    mgr.save(1, _state(9.0))  # overwrite same step atomically
    r = mgr.restore(1, _state(0.0))
    assert float(r["params"]["w"][0, 0]) == 9.0


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    bad = _state()
    bad["params"]["w"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, bad)


# -- the port's own ------------------------------------------------------------

def test_an_async_save_snapshots_before_it_returns(tmp_path):
    """The train step updates its tensors in place: a non-blocking save
    copies every leaf to host memory before it returns, so what it writes
    is the state at the call, not after later updates."""
    mgr = CheckpointManager(str(tmp_path))
    state = _state(2.0)
    mgr.save(5, state, blocking=False)
    for x in keypaths.leaves(state):
        x.add_(1)
    mgr.wait()
    r = mgr.restore(5, _zeros_like(state))
    for a, b in zip(keypaths.leaves(r), keypaths.leaves(_state(2.0))):
        assert torch.equal(a, b)


def test_keys_are_the_references_paths(tmp_path):
    """A model's train state: leaves named by ``"/".join`` of dict keys and
    list indices, in the reference's (sorted) order, e.g.
    ``params/groups/0/0/mixer/wq`` and ``opt/count``."""
    cfg = configs.get_smoke("yi_6b")
    opt = adamw.AdamWConfig()
    state = steps.init_train_state(0, cfg, opt, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state)
    names = list(mgr.manifest(0)["leaves"])
    assert "params/groups/0/0/mixer/wq" in names and "opt/count" in names
    assert "opt/m/groups/0/0/ffn/w_down" in names
    jstate = jax.eval_shape(lambda: jsteps.init_train_state(
        jax.random.PRNGKey(0), jconfigs.get_smoke("yi_6b"),
        jadamw.AdamWConfig()))
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert names == want
    with np.load(tmp_path / "step_00000000" / "leaves.npz") as z:
        assert z.files == want


def test_restore_onto_a_meta_template_places_leaves_on_the_device(tmp_path):
    cfg = configs.get_smoke("h2o_danube_18b")
    opt = adamw.AdamWConfig()
    state = steps.init_train_state(1, cfg, opt, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    r = mgr.restore(3, steps.abstract_train_state(cfg, opt), device="cpu")
    for a, b in zip(keypaths.leaves(r), keypaths.leaves(state)):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_a_missing_leaf_is_named(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    bigger = _state()
    bigger["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/extra"):
        mgr.restore(1, bigger)


# -- cross-reads with the reference -------------------------------------------

def _reference_state(dtype: str):
    """The reference's train state for yi-6b's smoke variant in ``dtype``,
    moments drawn from a seed (so no leaf is all zeros), count 5; and the
    port's config and optimiser config."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("yi_6b"), param_dtype=dtype)
    pcfg = dataclasses.replace(configs.get_smoke("yi_6b"), param_dtype=dtype)
    jopt = jadamw.AdamWConfig(moment_dtype=dtype)
    popt = adamw.AdamWConfig(moment_dtype=dtype)
    st = jsteps.init_train_state(jax.random.PRNGKey(4), jcfg, jopt)
    rng = np.random.default_rng(4)
    noise = lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.01,
                                  x.dtype)  # noqa: E731
    st["opt"] = {"m": jax.tree.map(noise, st["opt"]["m"]),
                 "v": jax.tree.map(lambda x: jnp.abs(noise(x)),
                                   st["opt"]["v"]),
                 "count": jnp.asarray(5, jnp.int32)}
    return st, pcfg, popt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_port_restores_the_references_checkpoint_to_the_bits(tmp_path,
                                                                 dtype):
    jstate, pcfg, popt = _reference_state(dtype)
    JManager(str(tmp_path)).save(5, jstate)
    got = CheckpointManager(str(tmp_path)).restore(
        5, steps.abstract_train_state(pcfg, popt), device="cpu")
    want = interop.train_state_from_reference(
        jax.tree.map(np.asarray, jstate), pcfg, popt, device="cpu")
    for (path, a), b in zip(keypaths.leaves_with_path(got),
                            keypaths.leaves(want)):
        assert a.dtype == b.dtype, keypaths.key(path)
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_the_reference_restores_the_ports_f32_checkpoint(tmp_path):
    """The port writes an f32 train state; the reference restores it to the
    bits and the manifests are equal (both written by their managers)."""
    jstate, pcfg, popt = _reference_state("float32")
    pstate = interop.train_state_from_reference(
        jax.tree.map(np.asarray, jstate), pcfg, popt, device="cpu")
    CheckpointManager(str(tmp_path / "port")).save(5, pstate,
                                                   extra={"data_step": 5})
    JManager(str(tmp_path / "ref")).save(5, jstate, extra={"data_step": 5})
    jmgr = JManager(str(tmp_path / "port"))
    restored = jmgr.restore(5, jax.tree.map(jnp.zeros_like, jstate))
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jmgr.manifest(5) == JManager(str(tmp_path / "ref")).manifest(5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_leaf_is_the_references_bytes(tmp_path, dtype):
    """Each ``.npy`` member of ``leaves.npz`` (header and data) is the one
    the reference writes for the same state: a bf16 leaf is its 16 bits
    as ``|V2``, and the manifest says ``bfloat16``."""
    jstate, pcfg, popt = _reference_state(dtype)
    pstate = interop.train_state_from_reference(
        jax.tree.map(np.asarray, jstate), pcfg, popt, device="cpu")
    CheckpointManager(str(tmp_path / "port")).save(5, pstate)
    JManager(str(tmp_path / "ref")).save(5, jstate)
    members = {}
    for who in ("port", "ref"):
        with zipfile.ZipFile(tmp_path / who / "step_00000005" /
                             "leaves.npz") as z:
            members[who] = {n: z.read(n) for n in z.namelist()}
    assert list(members["port"]) == list(members["ref"])
    for name in members["ref"]:
        assert members["port"][name] == members["ref"][name], name
    m = CheckpointManager(str(tmp_path / "port")).manifest(5)
    assert m["leaves"]["params/embed"][1] == dtype
    assert m == JManager(str(tmp_path / "ref")).manifest(5)
    if dtype == "bfloat16":
        with np.load(tmp_path / "port" / "step_00000005" / "leaves.npz") as z:
            assert z["params/embed"].dtype == np.dtype("V2")


def test_the_reference_cannot_restore_its_own_bf16_checkpoint_c10(tmp_path):
    """Reference fault C10: ``np.savez`` writes a bf16 leaf as ``|V2`` and
    the reference's ``restore`` calls ``jax.numpy.asarray`` on it, which
    raises ``TypeError``.  The port restores the same files through the
    manifest's dtype."""
    jstate, pcfg, popt = _reference_state("bfloat16")
    mgr = JManager(str(tmp_path))
    mgr.save(5, jstate)
    with pytest.raises(TypeError, match="V2"):
        mgr.restore(5, jstate)
    got = CheckpointManager(str(tmp_path)).restore(
        5, steps.abstract_train_state(pcfg, popt), device="cpu")
    assert got["params"]["embed"].dtype == torch.bfloat16
