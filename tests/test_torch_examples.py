"""The port's two kernel examples run to the end on the CPU.

``examples/torch_quickstart.py`` and ``examples/torch_ssr_kernels_tour.py``
are the reference's ``quickstart.py`` and ``ssr_kernels_tour.py`` on
``repro_torch``, with a ``--device`` argument (default ``cuda``).  Here they
run with ``--device cpu`` and a temporary ``REPRO_SCHEDULE_CACHE``; the
quickstart's closed-form sections (1, 2, 3 and 5) print the reference
example's lines, and its autotuner writes under that cache and nowhere in
``HOME``.
"""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def _run(script, tmp_path, *args, env_extra=None):
    env = dict(os.environ)
    env.update(PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               HOME=str(tmp_path / "home"),
               REPRO_SCHEDULE_CACHE=str(tmp_path / "schedules"))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, os.path.join(EXAMPLES, script),
                           *args], capture_output=True, text=True, env=env,
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


@pytest.mark.parametrize("script", ["torch_quickstart.py",
                                    "torch_ssr_kernels_tour.py"])
def test_without_a_card_the_default_device_fails_at_once(tmp_path, script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks a machine "
                    "without one")
    out = _run(script, tmp_path)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert out.stdout == ""
