"""The port's serving path against the JAX package, on the CPU.

``launch/steps.py``'s prefill (``batch_chunks`` 1 and 2) and decode steps
on one set of weights (``interop.params_from_reference``), a prefill and
16 teacher-forced decode steps across the sliding window's ring, greedy
generation against a teacher-forced forward, ``abstract_caches``, and the
serve CLI and ``examples/torch_serve_batched.py`` run as a user would.
Logits agree within ``F32_LOGITS`` (1e-5) of the reference's max |logit|,
as in ``tests/test_torch_models.py``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import configs as jconfigs
from repro.launch import steps as jsteps

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.launch import serve, steps
from repro_torch.models import model

from test_torch_models import (F32_LOGITS, FAMILIES, both, logits_limit,
                               rel_err, weights)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _prompts(jcfg, b, s, seed=20):
    rng = np.random.default_rng(seed)
    kw = {"tokens": rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)}
    if jcfg.frontend == "vision":
        kw["embeds"] = (rng.standard_normal(
            (b, jcfg.frontend_len, jcfg.d_model)) * 0.1).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in kw.items()},
            {k: torch.from_numpy(v) for k, v in kw.items()})


@pytest.mark.parametrize("kind", ["swa", "qwen3_14b", "dbrx_132b",
                                  "jamba_v01_52b", "deepseek_v3_671b",
                                  "xlstm"])
@pytest.mark.parametrize("chunks", [1, 2])
def test_prefill_step_matches_reference(kind, chunks):
    """Every cache kind (k/v, MLA latents, Mamba's conv and ssm, mLSTM's
    C/n/m, sLSTM's c/n/h/m) joined on its batch axis; a chunk's experts
    have the chunk's capacity, as the reference's ``lax.map`` gives."""
    jcfg, pcfg = both(kind)
    jp, pp = weights(jcfg, pcfg)
    jb, pb = _prompts(jcfg, 4, 16)
    want_l, want_c = jax.jit(jsteps.make_prefill_step(
        jcfg, cache_len=40, batch_chunks=chunks))(jp, jb)
    got_l, got_c = steps.make_prefill_step(
        pcfg, cache_len=40, batch_chunks=chunks)(pp, pb)
    assert got_l.shape == (4, 1, pcfg.vocab_size)
    limit = logits_limit(pcfg)
    assert rel_err(want_l, got_l) <= limit
    for jg, pg in zip(want_c, got_c):
        for je, pe in zip(jg, pg):
            assert sorted(je) == sorted(pe)
            for name in je:
                assert pe[name].shape[1] == 4
                assert rel_err(je[name], pe[name]) <= limit, name


def test_prefill_chunks_must_divide_the_batch():
    _, pcfg = both("swa")
    _, pp = weights(*both("swa"))
    with pytest.raises(ValueError, match="does not split"):
        steps.make_prefill_step(pcfg, cache_len=40, batch_chunks=3)(
            pp, {"tokens": torch.zeros(4, 8, dtype=torch.int32)})


def test_encoder_prefill_is_a_plain_forward():
    jcfg, pcfg = both("hubert_xlarge")
    jp, pp = weights(jcfg, pcfg)
    emb = (np.random.default_rng(21).standard_normal(
        (2, 12, jcfg.d_model)) * 0.1).astype(np.float32)
    want, wc = jax.jit(jsteps.make_prefill_step(jcfg, cache_len=0))(
        jp, {"embeds": jnp.asarray(emb)})
    got, gc = steps.make_prefill_step(pcfg, cache_len=0, batch_chunks=2)(
        pp, {"embeds": torch.from_numpy(emb)})
    assert wc == () and gc == ()
    assert rel_err(want, got) <= F32_LOGITS


def test_teacher_forced_decode_across_the_window():
    """The swa config (window 24): prefill 16 tokens, then 16 decode steps
    of given tokens, positions 16–31; the ring (24 slots) wraps at 24.
    Each step's logits against the reference's step's."""
    jcfg, pcfg = both("swa")
    jp, pp = weights(jcfg, pcfg)
    jb, pb = _prompts(jcfg, 2, 16)
    _, jc = jax.jit(jsteps.make_prefill_step(jcfg, cache_len=33))(jp, jb)
    _, pc = steps.make_prefill_step(pcfg, cache_len=33)(pp, pb)
    assert pc[0][0]["k"].shape[2] == 24
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    pdec = steps.make_decode_step(pcfg)
    toks = np.random.default_rng(22).integers(
        0, jcfg.vocab_size, (16, 2, 1)).astype(np.int32)
    buf = pc[0][0]["k"]
    for t in range(16):
        pos = np.full((2,), 16 + t, np.int32)
        want, jc = jdec(jp, jc, jnp.asarray(toks[t]), jnp.asarray(pos))
        got, pc = pdec(pp, pc, torch.from_numpy(toks[t]),
                       torch.from_numpy(pos))
        assert rel_err(want, got) <= F32_LOGITS, t
    # the caches were updated in place, never copied
    assert pc[0][0]["k"] is buf
    np.testing.assert_allclose(np.asarray(jc[0][0]["k"]), buf.numpy(),
                               rtol=0, atol=F32_LOGITS)


@pytest.mark.parametrize("arch", ["qwen3_14b", "internvl2_26b", *FAMILIES])
def test_greedy_generation_matches_teacher_forcing(arch):
    """generate's decode logits at each position equal one forward over
    the prompt and the generated tokens.  A vision prompt's first decode
    position is its prefix's length plus its tokens' (the reference's
    serve starts at the tokens' alone).  Experts run at an ample capacity
    (factor e / k: no slot can drop), since decode's token count gives
    another capacity than the forward's."""
    cfg = configs.get_smoke(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    params = model.init_params(0, cfg, device="cpu")
    prompts = pipeline.make_batch(cfg, pipeline.DataConfig(3, 16, seed=11),
                                  0, device="cpu")
    prompts.pop("labels")
    res = serve.generate(params, cfg, prompts, gen=6, keep_logits=True)
    start = 16 + (cfg.frontend_len if cfg.frontend == "vision" else 0)
    assert res.start == start and res.tokens.shape == (3, 6)
    assert len(res.logits) == 6
    full, _, _ = model.forward(
        params, cfg, tokens=torch.cat([prompts["tokens"], res.tokens[:, :-1]],
                                      dim=1), embeds=prompts.get("embeds"))
    for t, step in enumerate(res.logits):
        want = full[:, start - 1 + t]
        assert rel_err(want, step[:, 0]) <= logits_limit(cfg), t
        assert torch.equal(res.tokens[:, t], want.argmax(-1).to(torch.int32))


@pytest.mark.parametrize("arch", ["qwen3_14b", *FAMILIES])
def test_abstract_caches_are_the_references_shapes(arch):
    """Every cache kind's shapes and dtypes (recurrent state in f32) on
    ``meta``, at the published widths."""
    jcfg, pcfg = jconfigs.get(arch), configs.get(arch)
    got = steps.abstract_caches(pcfg, 4, 50, torch.bfloat16)
    want = jsteps.abstract_caches(jcfg, 4, 50, jnp.bfloat16)
    assert len(want) == len(got)
    for jg, pg in zip(want, got):
        for je, pe in zip(jg, pg):
            assert sorted(je) == sorted(pe)
            for name in je:
                assert pe[name].is_meta
                assert tuple(pe[name].shape) == tuple(je[name].shape)
                assert str(pe[name].dtype) == f"torch.{je[name].dtype}"


def _run(args, tmp_path, module=True):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               HOME=str(tmp_path))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args] \
        if module else [sys.executable, os.path.join(
            REPO, "examples", "torch_serve_batched.py"), *args]
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=300, cwd=str(tmp_path))


def test_serve_cli_runs_on_the_cpu_when_asked(tmp_path):
    proc = _run(["--smoke", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "8", "--gen", "4"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "arch=qwen3-14b-smoke batch=2 prompt=8 gen=4"
    assert lines[1].startswith("prefill:") and "tok/s" in lines[1]
    assert lines[2].startswith("decode:") and "ms/step" in lines[2]
    assert lines[3].startswith("sample continuation (seq 0): [")
    enc = _run(["--smoke", "--arch", "hubert_xlarge", "--device", "cpu"],
               tmp_path)
    assert enc.returncode != 0 and "encoder-only" in enc.stderr


def test_serve_cli_serves_deepseek_on_the_cpu(tmp_path):
    proc = _run(["--arch", "deepseek_v3_671b", "--smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "8", "--gen", "3"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[0] == \
        "arch=deepseek-v3-671b-smoke batch=2 prompt=8 gen=3"


def test_example_runs_on_the_cpu_when_asked(tmp_path):
    proc = _run(["--smoke", "--device", "cpu"], tmp_path, module=False)
    assert proc.returncode == 0, proc.stderr
    assert "SWA window 512" in proc.stdout and "request 1:" in proc.stdout


@pytest.mark.parametrize("module", [True, False], ids=["serve", "example"])
def test_without_a_card_the_default_device_fails_at_once(tmp_path, module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks a machine "
                    "without one")
    proc = _run(["--smoke"], tmp_path, module=module)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "tok/s" not in proc.stdout


def test_generation_is_encoder_only_aware():
    cfg = dataclasses.replace(configs.get_smoke("qwen3_14b"), causal=False)
    with pytest.raises(ValueError, match="encoder-only"):
        serve.generate({}, cfg, {"tokens": torch.zeros(
            1, 4, dtype=torch.int32)}, gen=2)
