"""Fault tolerance (``runtime/fault.py``) on the port's train step, on the
CPU: the reference's ``tests/test_fault.py`` ported.  The key property: a
run interrupted by failures ends in exactly the state of an uninterrupted
run (checkpoint + deterministic data stream ⇒ bit-identical replay),
though the train step updates its tensors in place.

Also here: the training modules export the reference modules' public
names.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch import keypaths
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.resilience import InjectedFault
from repro_torch.data import pipeline
from repro_torch.launch import steps as step_lib
from repro_torch.models import ModelConfig
from repro_torch.models.config import ScanGroup
from repro_torch.optim import adamw
from repro_torch.runtime.fault import (FailureInjector, SimulatedFailure,
                                       StragglerMonitor, Supervisor)

CFG = ModelConfig(name="ft", family="dense", d_model=32, num_heads=2,
                  num_kv_heads=2, d_ff=64, vocab_size=64,
                  groups=(ScanGroup((("attn", "mlp"),), 1),), remat=False)
OPT = adamw.AdamWConfig(learning_rate=1e-3)
DCFG = pipeline.DataConfig(global_batch=2, seq_len=16, seed=1)


def make_step_fn():
    train = step_lib.make_train_step(CFG, OPT, microbatches=1)

    def step_fn(state, step):
        batch = pipeline.make_batch(CFG, DCFG, step, device="cpu")
        params, opt, _ = train(state["params"], state["opt"], batch)
        return {"params": params, "opt": opt}

    return step_fn


def run(num_steps, fail_at=(), ckpt_dir=None, checkpoint_every=2):
    mgr = CheckpointManager(ckpt_dir, keep=3)
    sup = Supervisor(ckpt=mgr, checkpoint_every=checkpoint_every,
                     injector=FailureInjector(fail_at_steps=fail_at))
    state = step_lib.init_train_state(0, CFG, OPT, device="cpu")
    final = sup.run(state, make_step_fn(), num_steps)
    return final, sup


def test_failure_recovery_is_exact(tmp_path):
    clean, _ = run(10, ckpt_dir=str(tmp_path / "a"))
    faulty, sup = run(10, fail_at=(3, 7), ckpt_dir=str(tmp_path / "b"))
    assert sup.restarts == 2
    assert any("restored@" in e for e in sup.events)
    for a, b in zip(keypaths.leaves(clean), keypaths.leaves(faulty)):
        assert torch.equal(a, b)
    # the control: one step fewer is another state
    short, _ = run(9, ckpt_dir=str(tmp_path / "c"))
    assert any(not torch.equal(a, b) for a, b in
               zip(keypaths.leaves(clean["params"]),
                   keypaths.leaves(short["params"])))


def test_failure_before_first_checkpoint(tmp_path):
    clean, _ = run(6, ckpt_dir=str(tmp_path / "a"))
    faulty, sup = run(6, fail_at=(1,), ckpt_dir=str(tmp_path / "b"))
    assert sup.restarts == 1
    for a, b in zip(keypaths.leaves(clean["params"]),
                    keypaths.leaves(faulty["params"])):
        assert torch.equal(a, b)


def test_too_many_failures_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    inj = FailureInjector(fail_at_steps=(2,))
    sup = Supervisor(ckpt=mgr, max_restarts=0, injector=inj)
    state = step_lib.init_train_state(0, CFG, OPT, device="cpu")
    with pytest.raises(SimulatedFailure):
        sup.run(state, make_step_fn(), 5)


def test_a_simulated_failure_is_an_injected_fault():
    e = SimulatedFailure("lost", step=4)
    assert isinstance(e, InjectedFault) and isinstance(e, RuntimeError)
    assert (e.seam, e.kind, e.step) == ("step", "fault", 4)


def test_flags_outliers():
    mon = StragglerMonitor(threshold_sigma=3.0, warmup_steps=5)
    rng = np.random.default_rng(0)
    flagged = []
    for i in range(50):
        dt = 0.10 + rng.normal(0, 0.005)
        if i in (20, 40):
            dt = 0.5  # injected straggler
        if mon.observe(i, dt):
            flagged.append(i)
    assert 20 in flagged and 40 in flagged
    assert len(flagged) <= 4  # few false positives


def test_supervisor_straggler_hook(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mon = StragglerMonitor(threshold_sigma=3.0, warmup_steps=3)
    hits = []
    # deterministic fake clock, advanced by the step function
    fake = {"t": 0.0}
    sup = Supervisor(ckpt=mgr, straggler=mon, on_straggler=hits.append,
                     checkpoint_every=100, clock=lambda: fake["t"])

    def slow_step(state, step):
        fake["t"] += 0.25 if step == 8 else 0.01
        return state

    sup.run({"x": torch.zeros(())}, slow_step, 12)
    assert hits == [8]


# -- the training modules' names ----------------------------------------------

#: names of the reference's training modules that the port leaves out, by
#: module: none (the mesh all-reduce ``compressed_psum`` runs over a mesh
#: axis, ``tests/test_torch_collectives.py``)
DEFERRED = {}


def _public(mod):
    """Public names that the module defines or takes from its package
    (not modules, nor what it imports from the standard library, typing,
    numpy or JAX)."""
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
    "optim", "optim.adamw", "optim.compress", "checkpoint",
    "checkpoint.manager", "runtime.fault", "launch.steps"])
def test_the_training_modules_export_the_references_names(module):
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    want = _public(ref) - DEFERRED.get(module, set())
    assert want - set(dir(port)) == set()
    for name in want:   # the same kind of object: class, function, value
        assert callable(getattr(ref, name)) is \
            callable(getattr(port, name)), name
