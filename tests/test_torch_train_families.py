"""The train step on the experts, the latent attention and the recurrent
mixers against the JAX package, on the CPU: xlstm-125m, deepseek-v3 and
dbrx's smoke variants at 1 and 2 microbatches, with
``tests/test_torch_train.py``'s state, limits and controls; and the bf16
gradient accumulator (llama3-405b's and deepseek-v3's configs) held to the
reference's formula on the port's own gradients.
"""

import pytest
import torch

from repro_torch import configs, keypaths
from repro_torch.launch import steps
from repro_torch.optim import adamw

from test_torch_train import check_step


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("kind", ["xlstm_125m", "deepseek_v3_671b",
                                  "dbrx_132b"])
def test_train_step_matches_reference(kind, microbatches):
    check_step(kind, microbatches)


@pytest.mark.parametrize("arch", ["llama3_405b", "deepseek_v3_671b"])
def test_bf16_accumulator_is_the_references_formula(arch):
    """The reference's ``lax.scan`` adds ``g.astype(acc_dt)`` to a zero
    accumulator microbatch by microbatch, divides by their count in
    ``acc_dt`` and hands that to the optimiser.  The port's step at 2
    microbatches equals, to the bit, that formula computed on the port's
    own gradients of the two halves; the control, the same halves summed
    in f32, differs."""
    cfg = configs.get_smoke(arch)
    assert cfg.grad_accum_dtype == "bfloat16"
    opt = adamw.AdamWConfig(learning_rate=1e-2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16),
                                     generator=torch.Generator().manual_seed(
                                         1), dtype=torch.int32)}
    batch["labels"] = (batch["tokens"] * 7 + 3) % cfg.vocab_size
    halves = [{k: v[i * 2:i * 2 + 2] for k, v in batch.items()}
              for i in range(2)]

    def fresh():
        return steps.init_train_state(0, cfg, opt, device="cpu")

    got = fresh()
    steps.make_train_step(cfg, opt, microbatches=2)(got["params"],
                                                    got["opt"], batch)
    results = {}
    for acc_dt in (torch.bfloat16, torch.float32):
        st = fresh()
        gs = [steps._value_and_grad(st["params"], cfg, h)[1]
              for h in halves]
        acc = keypaths.map_with_path(
            lambda _, p: torch.zeros(p.shape, dtype=acc_dt), st["params"])
        for g in gs:
            for a, x in zip(keypaths.leaves(acc), keypaths.leaves(g)):
                a.add_(x.to(acc_dt))
        for a in keypaths.leaves(acc):
            a.div_(torch.full((), 2, dtype=acc_dt))
        adamw.update(acc, st["opt"], st["params"], opt)
        results[acc_dt] = st
    for a, b in zip(keypaths.leaves(got), keypaths.leaves(
            results[torch.bfloat16])):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(
        keypaths.leaves(got["params"]),
        keypaths.leaves(results[torch.float32]["params"])))
