"""The port's examples and its train CLI run to the end on the CPU.

``examples/torch_quickstart.py``, ``examples/torch_ssr_kernels_tour.py``
and ``examples/torch_train_e2e.py`` are the reference's ``quickstart.py``,
``ssr_kernels_tour.py`` and ``train_e2e.py`` on ``repro_torch``, with a
``--device`` argument (default ``cuda``).  Here they run with ``--device
cpu`` and a temporary ``REPRO_SCHEDULE_CACHE``; the quickstart's
closed-form sections (1, 2, 3 and 5) print the reference example's lines,
and its autotuner writes under that cache and nowhere in ``HOME``.  The
training example runs 21 of its 200 steps with a failure injected, and
``python -m repro_torch.launch.train`` its smoke run with a restart.
"""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def _run(script, tmp_path, *args, env_extra=None, module=False):
    env = dict(os.environ)
    env.update(PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               HOME=str(tmp_path / "home"),
               REPRO_SCHEDULE_CACHE=str(tmp_path / "schedules"))
    env.update(env_extra or {})
    cmd = ["-m", script] if module else [os.path.join(EXAMPLES, script)]
    return subprocess.run([sys.executable, *cmd, *args],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=str(tmp_path))


def _sections(text: str) -> dict:
    """The quickstart's output by section number (the line after each
    ``====`` rule that opens a section)."""
    out, current = {}, None
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if line.startswith("=" * 64) and i + 1 < len(lines) \
                and lines[i + 1][:2].rstrip(".").isdigit():
            current = lines[i + 1].split(".", 1)[0]
            out[current] = []
        elif current is not None and not line.startswith("=" * 64):
            out[current].append(line)
    return out


def test_quickstart_runs_and_its_closed_form_sections_are_the_references(
        tmp_path):
    (tmp_path / "home").mkdir()
    port = _run("torch_quickstart.py", tmp_path, "--device", "cpu")
    assert port.returncode == 0, port.stderr
    ref = _run("quickstart.py", tmp_path,
               env_extra={"REPRO_SCHEDULE_CACHE": str(tmp_path / "ref")})
    assert ref.returncode == 0, ref.stderr
    ours, theirs = _sections(port.stdout), _sections(ref.stdout)
    assert sorted(ours) == sorted(theirs) == ["1", "2", "3", "4", "5", "6"]
    for sec in ("1", "2", "3", "5"):
        assert ours[sec] == theirs[sec], sec
    assert "from_cache=True" in port.stdout
    # the autotuner wrote its winner under REPRO_SCHEDULE_CACHE, nothing
    # under HOME
    assert any((tmp_path / "schedules").iterdir())
    assert not any((tmp_path / "home").iterdir())


def test_tour_runs_every_kernel_to_the_end(tmp_path):
    out = _run("torch_ssr_kernels_tour.py", tmp_path, "--device", "cpu")
    assert out.returncode == 0, out.stderr
    rows = [line.split() for line in out.stdout.splitlines()[1:10]]
    assert [r[0] for r in rows] == ["reduction", "scan", "stencil1d",
                                    "stencil2d", "gemv", "gemm", "relu",
                                    "fft", "bitonic"]
    assert all(float(r[1]) < 1e-3 for r in rows)
    assert "All streamed kernels validated" in out.stdout


def test_train_e2e_learns_and_restarts(tmp_path):
    """21 steps of the 20m preset, a failure at step 12: one restart from
    the checkpoint at 0 (it checkpoints every 25), whose replay logs steps
    0 and 10 again with the same losses; the loss falls by more than 0.5
    from step 0 to 20 (``LEARNED``), and the temporary checkpoints are
    gone."""
    (tmp_path / "tmp").mkdir()
    # two threads: the suite's other workers share the cores
    out = _run("torch_train_e2e.py", tmp_path, "--device", "cpu",
               "--steps", "21", "--fail-at", "12",
               env_extra={"TMPDIR": str(tmp_path / "tmp"),
                          "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("model: train-e2e-20m")
    logged = [ln.split() for ln in lines if ln.startswith("step")]
    assert [x[1] for x in logged] == ["0", "10", "0", "10", "20"]
    assert logged[0] == logged[2] and logged[1] == logged[3]
    assert "restarts=1" in out.stdout
    assert lines[-1].endswith("(LEARNED)"), lines[-1]
    assert not any((tmp_path / "tmp").iterdir())


def test_the_train_cli_restarts_once(tmp_path):
    """``python -m repro_torch.launch.train --arch yi_6b --smoke --steps 6
    --fail-at 3 --device cpu``: the reference CLI's report lines, one
    restart, and its temporary checkpoint directory removed."""
    (tmp_path / "tmp").mkdir()
    out = _run("repro_torch.launch.train", tmp_path, "--arch", "yi_6b",
               "--smoke", "--steps", "6", "--fail-at", "3", "--device",
               "cpu", "--log-every", "1", module=True,
               env_extra={"TMPDIR": str(tmp_path / "tmp")})
    assert out.returncode == 0, out.stderr
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("done:")]
    assert len(done) == 1 and "restarts=1" in done[0]
    assert "failure@3" in done[0] and "restored@0" in done[0]
    assert out.stdout.splitlines()[-1].startswith("loss: first ")
    steps = [ln.split()[1] for ln in out.stdout.splitlines()
             if ln.startswith("step")]
    assert steps == ["0", "1", "2", "0", "1", "2", "3", "4", "5"]
    assert not any((tmp_path / "tmp").iterdir())


def _losses(stdout: str) -> list:
    return [float(ln.split()[3]) for ln in stdout.splitlines()
            if ln.startswith("step")]


def test_the_train_cli_refuses_a_mesh_naming_9d(tmp_path):
    """``--mesh 2,2 --smoke --steps 3 --device cpu`` runs four gloo ranks
    of the sharded step: the mesh line, rank 0's report lines, and each
    loss within 2e-4 (the reference's sharded-vs-single limit) of the
    single-device CLI's."""
    (tmp_path / "tmp").mkdir()
    args = ["--arch", "yi_6b", "--smoke", "--steps", "3", "--device", "cpu",
            "--log-every", "1"]
    env = {"TMPDIR": str(tmp_path / "tmp")}
    out = _run("repro_torch.launch.train", tmp_path, *args, "--mesh", "2,2",
               module=True, env_extra=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[0] == "mesh: data=2×model=2 (4 chips)"
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("done:")]
    assert len(done) == 1 and "restarts=0" in done[0]
    single = _run("repro_torch.launch.train", tmp_path, *args, module=True,
                  env_extra=env)
    assert single.returncode == 0, single.stderr[-3000:]
    got, want = _losses(out.stdout), _losses(single.stdout)
    assert len(got) == len(want) == 3
    assert max(abs(a - b) for a, b in zip(got, want)) < 2e-4
    assert not any((tmp_path / "tmp").iterdir())


def test_the_elastic_example_resumes_the_stream(tmp_path):
    """``examples/torch_elastic_restart.py --device cpu``: 6 steps on
    (4, 2), a checkpoint, then 4 on (2, 2) at twice the microbatches; the
    resumed run's first loss continues the first run's stream (within 2e-4
    of what the (4, 2) run takes at that step), unlike its step before."""
    (tmp_path / "tmp").mkdir()
    out = _run("torch_elastic_restart.py", tmp_path, "--device", "cpu",
               "--timeout", "300", env_extra={"TMPDIR": str(tmp_path / "tmp")})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "elastic restart OK: same stream, half the fleet"
    loss = {}
    for ln in lines:
        words = ln.split()
        if words[:2] == ["reference", "step"]:
            loss["ref6"] = float(words[4])
        elif words and words[0] == "step":
            loss.setdefault(int(words[1]), []).append(float(words[3]))
    assert sorted(k for k in loss if k != "ref6") == list(range(10))
    assert "grad-accum ×2" in out.stdout
    assert abs(loss[6][0] - loss["ref6"]) < 2e-4
    assert abs(loss[5][0] - loss["ref6"]) > 2e-4
    assert not any((tmp_path / "tmp").iterdir())


@pytest.mark.parametrize("script", ["torch_quickstart.py",
                                    "torch_ssr_kernels_tour.py",
                                    "torch_train_e2e.py"])
def test_without_a_card_the_default_device_fails_at_once(tmp_path, script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks a machine "
                    "without one")
    out = _run(script, tmp_path)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert out.stdout == ""
