"""The port's collectives (``parallel/collectives.py``, ``optim.compress
.compressed_psum``) and its shard/gather round trip, on 8 gloo ranks.

The reference's side runs once per module, in one subprocess with 8 fake
host devices (as ``tests/test_distributed.py``), and is handed to the
ranks as an ``.npz`` file; the ranks (``launch.mesh.run_ranks``) import
the port only.  Limits: the reference's own 2e-5 for the matmuls; for
``compressed_psum`` its bounds (the error at most 2 × scale, the residual
at most scale) and, against the reference's outputs, one ulp of the scale.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.launch.mesh import RankError, run_ranks

import torch_mesh_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_host_mesh
from repro.optim import compress
from repro.parallel.collectives import reduce_scatter_matmul, ring_matmul

rng = np.random.default_rng(0)
x = rng.standard_normal((16, 64)).astype(np.float32)
w = rng.standard_normal((64, 32)).astype(np.float32)
g = rng.standard_normal((8, 64)).astype(np.float32)
out = {"x": x, "w": w, "g": g}
mesh = make_host_mesh(data=4, model=2)
out["ring"] = np.asarray(jax.jit(
    lambda x, w: ring_matmul(x, w, mesh, axis="data"))(x, w))
out["ring_grad"] = np.asarray(jax.jit(jax.grad(
    lambda w: ring_matmul(x, w, mesh, axis="data").sum()))(w))
out["ring_b"] = np.asarray(jax.jit(lambda x, w: ring_matmul(
    x, w, mesh, axis="data", batch_axes=("data",)))(x, w))
out["ring_b_grad"] = np.asarray(jax.jit(jax.grad(lambda w: ring_matmul(
    x, w, mesh, axis="data", batch_axes=("data",)).sum()))(w))
out["rs"] = np.asarray(jax.jit(
    lambda x, w: reduce_scatter_matmul(x, w, mesh, axis="model"))(x, w))
mesh8 = make_host_mesh(data=8, model=1)

def body(gs, rs):
    mean, new_r = compress.compressed_psum({"g": gs[0]}, {"g": rs[0]},
                                           "data")
    return mean["g"][None], new_r["g"][None]

f = shard_map(body, mesh=mesh8, in_specs=(P("data", None), P("data", None)),
              out_specs=(P("data", None), P("data", None)))
mean, resid = f(jnp.asarray(g), jnp.zeros_like(jnp.asarray(g)))
out["cp_mean"], out["cp_resid"] = np.asarray(mean), np.asarray(resid)
np.savez(sys.argv[1], **out)
"""


def _reference(path):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                          path], capture_output=True, text=True, env=env,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("collectives") / "ref.npz")
    ref = _reference(path)
    got = run_ranks(ranks.collectives_rank, 8, backend="gloo", args=(path,),
                    timeout=TIMEOUT)
    return ref, got


def _blocks(got, key):
    """The ranks' blocks joined in data order (model rank 0's: the ranks
    along model hold the same)."""
    return np.concatenate([got[r][key] for r in range(8)
                           if r % 2 == 0], axis=0)


def test_ring_matmul_matches_the_reference(both):
    ref, got = both
    for r in range(8):           # x replicated: every rank's y is all of y
        np.testing.assert_allclose(got[r]["ring"], ref["ring"],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got[r]["ring"], ref["x"] @ ref["w"],
                                   rtol=2e-5, atol=2e-5)
    # x's rows sharded over data: each rank its rows
    np.testing.assert_allclose(_blocks(got, "ring_b"), ref["ring_b"],
                               rtol=2e-5, atol=2e-5)


def test_ring_matmul_gradients(both):
    """The ring's adjoint: with x replicated, this rank's block of the
    plain gradient xᵀ·1 (the reference's gradient, replicated over model,
    is the same); with x's rows sharded over the ring axis, the block sums
    every rank's rows (the reduce-scatter ring) — again the plain
    gradient's block.  dx is 1·Wᵀ on each rank's rows."""
    ref, got = both
    plain = ref["x"].T @ np.ones((16, 32), np.float32)
    np.testing.assert_allclose(_blocks(got, "ring_grad"), plain,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_blocks(got, "ring_b_grad"), plain,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_blocks(got, "ring_b_grad"),
                               ref["ring_b_grad"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_blocks(got, "ring_grad"), ref["ring_grad"],
                               rtol=2e-5, atol=2e-5)
    dx = np.ones((16, 32), np.float32) @ ref["w"].T
    np.testing.assert_allclose(_blocks(got, "ring_b_xgrad"), dx,
                               rtol=2e-5, atol=2e-5)


def test_reduce_scatter_matmul_matches_the_reference(both):
    ref, got = both
    for r in range(8):
        np.testing.assert_allclose(got[r]["rs"], ref["rs"], rtol=2e-5,
                                   atol=2e-5)


def test_reduce_scatter_and_all_reduce_sum_their_groups(both):
    """``reduce_scatter`` gives each rank its block (in flat-index order)
    of the sum over its group, ``all_reduce`` every rank the sum."""
    _, got = both
    base = np.arange(48, dtype=np.float32).reshape(6, 8)
    for r in range(8):
        di, mi = got[r]["coords"]
        data_group = [q for q in range(8) if q % 2 == mi]
        total = sum(q + 1 for q in data_group) * base
        np.testing.assert_array_equal(got[r]["rs_data"],
                                      total[:, 2 * di:2 * di + 2])
        model_group = [2 * di, 2 * di + 1]
        np.testing.assert_array_equal(
            got[r]["ar_model"], sum(q + 1 for q in model_group) * base)


def test_compressed_psum_within_the_references_bounds(both):
    ref, got = both
    g = ref["g"]
    scale = float(np.abs(g).max()) / 127.0
    exact = g.mean(axis=0)
    for r in range(8):
        mean, resid = got[r]["cp_mean"], got[r]["cp_resid"]
        assert np.abs(mean - exact).max() <= 2 * scale
        assert np.abs(resid).max() <= scale + 1e-6
        # the reference's outputs, within one ulp of the scale
        ulp = np.spacing(np.float32(scale))
        assert np.abs(mean - ref["cp_mean"][r]).max() <= ulp
        assert np.abs(resid - ref["cp_resid"][r]).max() <= ulp
        np.testing.assert_array_equal(mean, got[0]["cp_mean"])


def test_shard_then_gather_gives_back_the_bits():
    ok = run_ranks(ranks.roundtrip_rank, 8, backend="gloo",
                   args=(("yi_6b", "deepseek_v3_671b", "jamba_v01_52b"),),
                   timeout=TIMEOUT)
    for r in range(8):
        assert ok[r] and all(ok[r].values()), \
            [k for k, v in ok[r].items() if not v]


def test_a_failing_rank_raises_with_its_traceback():
    with pytest.raises(RankError, match="ZeroDivisionError"):
        run_ranks(ranks.fail_on_rank_1, 2, backend="gloo", timeout=60,
                  grace=5)
