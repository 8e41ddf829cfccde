"""The port's cluster layer against the JAX package's, on the CPU.

``repro_torch.parallel.cluster`` splits a nest's outer level over C cores
that run one after another on one device; ``repro.parallel.cluster`` runs
them on a device mesh.  The reference needs one device a core, so its
outputs come from one subprocess with 8 forced host devices, as
``tests/test_cluster.py`` runs them: every registry ``cluster`` variant at
cores 2, 4 and 8 on its example and odd example, ``LAST_DISPATCH`` after
``cluster_call`` and ``cluster_chain_call``, ``factor_cores``,
``pad_to_cores`` and every ``ClusterError`` message both packages raise.
The port must agree within rtol = atol = 1e-5 (the reference test's own
tolerance), to the word for the messages, field for field for the
dispatch record.  Beside that: ``cores=1`` is ``ssr_call`` to the bit, the
lookup's faults and device key, views instead of copies, the locality
audit, and the one divergence (ROADMAP Queue C: ``cores > 1`` runs on one
device here, where the reference raises).
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
from repro.core import compiler as jcompiler
from repro.parallel import cluster as jcluster

import repro_torch
from repro_torch.core import autotune, compiler, lowering, resilience
from repro_torch.core.compiler import MemRef
from repro_torch.core.lowering import Schedule, ssr_call
from repro_torch.core.stream import Direction
from repro_torch.kernels import chained, gemv, reduction, registry, stencil
from repro_torch.launch.audit import check_cluster_locality
from repro_torch.parallel import cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLUSTERED = ["axpy_dot", "gemm", "gemv", "reduction", "relu", "stencil1d",
             "sum_sq_diff"]
CORES = (2, 4, 8)
REDUCE = {"reduction", "sum_sq_diff", "axpy_dot"}


def _seed(name: str, odd: bool) -> int:
    return CLUSTERED.index(name) * 2 + int(odd)


# Each (name, odd) case draws its inputs from its own seed, so both
# packages see the same numbers (the examples draw alike: the registry
# tests hold them equal).  The subprocess writes the reference's outputs
# to an npz and the rest as one JSON line.
_REFERENCE = """
    import json, sys
    import numpy as np, jax.numpy as jnp
    from repro.core import compiler
    from repro.core.compiler import Direction, MemRef
    from repro.kernels import registry
    from repro.parallel import cluster as pc

    names, cores, out_path = {names!r}, {cores!r}, sys.argv[1]
    arrays, info = {{}}, {{}}
    for i, name in enumerate(names):
        entry = registry.get(name)
        for odd in (False, True):
            args, kw = entry.example(np.random.default_rng(2 * i + odd),
                                     odd=odd)
            for c in cores:
                arrays[f"{{name}}-{{int(odd)}}-{{c}}"] = np.asarray(
                    entry.cluster(*args, cores=c, **kw))

    def dispatch():
        d = pc.LAST_DISPATCH
        return {{"schedule": d["schedule"].to_json(), "tuned": d["tuned"],
                 "cores": d["cores"], "tile_bounds": list(d["tile_bounds"])}}

    dot = registry.get("reduction")
    ssd = registry.get("sum_sq_diff")
    info["dispatch"] = {{}}
    for c in (1, 4):
        for key, entry in (("cluster_call", dot), ("cluster_chain_call", ssd)):
            args, kw = entry.example(np.random.default_rng(0))
            pc.LAST_DISPATCH.clear()
            entry.cluster(*args, cores=c, **kw)
            info["dispatch"][f"{{key}}-{{c}}"] = dispatch()
    info["factor_cores"] = [list(pc.factor_cores(c)) for c in range(1, 65)]
    for n, c in ((10, 4), (12, 4), (5000, 8), (1025, 8)):
        x = jnp.arange(n, dtype=jnp.float32)
        (px, py), n_pad = pc.pad_to_cores((x, x + 1), c)
        arrays[f"pad-{{n}}-{{c}}"] = np.stack([np.asarray(px), np.asarray(py)])
        info[f"pad-{{n}}-{{c}}"] = n_pad

    nest = compiler.dot_product_nest(100)
    x = jnp.ones(100, jnp.float32)
    body = lambda a, b: a * b
    cases = {{
        "indivisible": lambda: pc._split_level0(
            compiler.dot_product_nest(10), 4),
        "indivisible_call": lambda: pc.cluster_call(
            nest, body, {{"A": x, "B": x}}, cores=8, mode="reduce"),
        "mode": lambda: pc.cluster_call(nest, body, {{"A": x}}, cores=1,
                                        mode="scanz"),
        "cores": lambda: pc.cluster_call(nest, body, {{"A": x}}, cores=0,
                                         mode="map"),
        "factor_cores": lambda: pc.factor_cores(0),
        "non_affine": lambda: pc._shard_layout(
            MemRef("A", Direction.READ, None), nest),
        "offset": lambda: pc._shard_layout(
            MemRef("A", Direction.READ, (1,), offset=3), nest),
        "unmatched": lambda: pc._operand_ref([nest], "Z"),
        "reshape": lambda: pc._prepare_operands(
            [nest], {{"A": jnp.ones(99, jnp.float32)}}),
        "in_dims": lambda: pc.cluster_kernel(
            lambda a: a, (x,), cores=2, in_dims=(0, None), out_dim=0),
        "in_dims_2d": lambda: pc.cluster_kernel2d(
            lambda a: a, (x,), cores=2, in_dims=((0, None), (None, 0))),
        "out_dim": lambda: pc.cluster_kernel(lambda a: a, (x,), cores=2,
                                             in_dims=(0,)),
        "kernel_extent": lambda: pc.cluster_kernel(
            lambda a: a, (x[:10],), cores=4, in_dims=(0,), out_dim=0),
        "kernel2d_extent": lambda: pc.cluster_kernel2d(
            lambda a: a, (jnp.ones((9, 4)),), cores=4,
            in_dims=((0, None),)),
    }}
    info["errors"] = {{}}
    for key, fn in cases.items():
        try:
            fn()
        except pc.ClusterError as e:
            info["errors"][key] = str(e)
    np.savez(out_path, **arrays)
    print("REFERENCE " + json.dumps(info))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cluster_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["REPRO_SCHEDULE_CACHE"] = str(tmp / "schedules")
    code = textwrap.dedent(_REFERENCE.format(names=CLUSTERED, cores=CORES))
    out = subprocess.run([sys.executable, "-c", code, str(tmp / "ref.npz")],
                         capture_output=True, text=True, env=env, timeout=900)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    line = [l_ for l_ in out.stdout.splitlines()
            if l_.startswith("REFERENCE ")][-1]
    info = json.loads(line[len("REFERENCE "):])
    with np.load(tmp / "ref.npz") as z:
        info["arrays"] = {k: z[k] for k in z.files}
    return info


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _example(name: str, odd: bool):
    return registry.get(name).example(np.random.default_rng(_seed(name, odd)),
                                      odd=odd)


# --------------------------------------------------------------------------
# The degenerate path: cores=1 is the single-core call
# --------------------------------------------------------------------------


def test_cores1_identical_to_ssr_call():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(2048).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(2048).astype(np.float32))
    nest = compiler.dot_product_nest(2048)
    got = cluster.cluster_call(nest, reduction.MUL, {"A": x, "B": y},
                               cores=1, mode="reduce")
    want = ssr_call(nest, reduction.MUL, {"A": x, "B": y}, mode="reduce")
    assert torch.equal(got, want)


@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("name", CLUSTERED)
def test_cores1_registry_variant_is_its_ssr(name, odd):
    entry = registry.get(name)
    args, kw = _example(name, odd)
    got = entry.cluster(*args, cores=1, **kw)
    want = entry.ssr(*args, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_cluster_variants_are_the_references():
    from repro.kernels import registry as jregistry

    ours = {n for n in registry.names() if registry.get(n).cluster_variants()}
    theirs = {n for n in jregistry.names()
              if jregistry.get(n).cluster is not None}
    assert ours == theirs == set(CLUSTERED)
    for name in CLUSTERED:
        assert sorted(registry.get(name).cluster_variants()) == ["cluster"]
        assert "cluster" not in registry.get(name).variants()


# --------------------------------------------------------------------------
# Against the reference's cluster output
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cores", CORES)
@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("name", CLUSTERED)
def test_cluster_matches_the_reference(reference, name, odd, cores):
    args, kw = _example(name, odd)
    got = registry.get(name).cluster(*args, cores=cores, **kw)
    want = reference["arrays"][f"{name}-{int(odd)}-{cores}"]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5,
                               atol=1e-5, err_msg=f"{name} cores={cores}")


@pytest.mark.parametrize("cores", CORES)
@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("name", CLUSTERED)
def test_cluster_matches_the_single_core_entry(name, odd, cores):
    """Maps are exact (a tile's per-output arithmetic does not change with
    the split); reduces within the reference test's tolerance."""
    entry = registry.get(name)
    args, kw = _example(name, odd)
    got = entry.cluster(*args, cores=cores, **kw)
    want = entry.ssr(*args, **kw)
    if name in REDUCE:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("key", ["cluster_call-1", "cluster_call-4",
                                 "cluster_chain_call-1",
                                 "cluster_chain_call-4"])
def test_last_dispatch_matches_the_reference(reference, key):
    call, cores = key.rsplit("-", 1)
    entry = registry.get("reduction" if call == "cluster_call"
                         else "sum_sq_diff")
    args, kw = entry.example(np.random.default_rng(0))
    cluster.LAST_DISPATCH.clear()
    entry.cluster(*args, cores=int(cores), **kw)
    d = cluster.LAST_DISPATCH
    got = {"schedule": d["schedule"].to_json(), "tuned": d["tuned"],
           "cores": d["cores"], "tile_bounds": list(d["tile_bounds"])}
    assert got == reference["dispatch"][key]


def test_factor_cores_matches_the_reference(reference):
    assert [list(cluster.factor_cores(c)) for c in range(1, 65)] == \
        reference["factor_cores"]


@pytest.mark.parametrize("n, cores", [(10, 4), (12, 4), (5000, 8),
                                      (1025, 8)])
def test_pad_to_cores_matches_the_reference(reference, n, cores):
    x = torch.arange(n, dtype=torch.float32)
    y = x + 1
    (px, py), n_pad = cluster.pad_to_cores((x, y), cores)
    assert n_pad == reference[f"pad-{n}-{cores}"]
    np.testing.assert_array_equal(np.stack([px.numpy(), py.numpy()]),
                                  reference["arrays"][f"pad-{n}-{cores}"])
    if n % cores == 0:           # nothing to pad: the inputs themselves
        assert px is x and py is y


def _port_error_cases():
    nest = compiler.dot_product_nest(100)
    x = torch.ones(100)
    body = reduction.MUL
    pc = cluster
    return {
        "indivisible": lambda: pc._split_level0(
            compiler.dot_product_nest(10), 4),
        "indivisible_call": lambda: pc.cluster_call(
            nest, body, {"A": x, "B": x}, cores=8, mode="reduce"),
        "mode": lambda: pc.cluster_call(nest, body, {"A": x}, cores=1,
                                        mode="scanz"),
        "cores": lambda: pc.cluster_call(nest, body, {"A": x}, cores=0,
                                         mode="map"),
        "factor_cores": lambda: pc.factor_cores(0),
        "non_affine": lambda: pc._shard_layout(
            MemRef("A", Direction.READ, None), nest),
        "offset": lambda: pc._shard_layout(
            MemRef("A", Direction.READ, (1,), offset=3), nest),
        "unmatched": lambda: pc._operand_ref([nest], "Z"),
        "reshape": lambda: pc._prepare_operands([nest], {"A": torch.ones(99)}),
        "in_dims": lambda: pc.cluster_kernel(
            lambda a: a, (x,), cores=2, in_dims=(0, None), out_dim=0),
        "in_dims_2d": lambda: pc.cluster_kernel2d(
            lambda a: a, (x,), cores=2, in_dims=((0, None), (None, 0))),
        "out_dim": lambda: pc.cluster_kernel(lambda a: a, (x,), cores=2,
                                             in_dims=(0,)),
        "kernel_extent": lambda: pc.cluster_kernel(
            lambda a: a, (x[:10],), cores=4, in_dims=(0,), out_dim=0),
        "kernel2d_extent": lambda: pc.cluster_kernel2d(
            lambda a: a, (torch.ones(9, 4),), cores=4,
            in_dims=((0, None),)),
    }


@pytest.mark.parametrize("case", sorted(_port_error_cases()))
def test_cluster_error_matches_the_reference_word_for_word(reference, case):
    want = reference["errors"][case]
    with pytest.raises(cluster.ClusterError) as e:
        _port_error_cases()[case]()
    assert str(e.value) == want


# --------------------------------------------------------------------------
# The schedule lookup: faults and the device key
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cores, site", [(1, "cluster_call"),
                                         (2, "cluster:_core_schedule")])
def test_safe_lookup_degrades_on_an_injected_fault(cores, site):
    # a fresh cache directory (the autouse fixture) is a new epoch: the
    # first call of this problem looks the cache up
    x, y = torch.rand(2048), torch.rand(2048)
    nest = compiler.dot_product_nest(2048)
    lowering.reset_dispatch_stats()
    resilience.reset_fallback_log()
    with resilience.inject_faults("cache.read") as specs:
        got = cluster.cluster_call(nest, reduction.MUL, {"A": x, "B": y},
                                   cores=cores)
    assert specs[0].fired == 1
    assert lowering.DISPATCH_STATS["fallbacks"] == 1
    assert [e.site for e in resilience.fallback_events()] == [site]
    healthy = cluster.cluster_call(nest, reduction.MUL, {"A": x, "B": y},
                                   cores=cores)
    assert torch.equal(got, healthy)


def test_the_lookup_is_resolved_once_per_problem_and_epoch(monkeypatch):
    """As ``ssr_call`` resolves its schedule (ROADMAP Queue C,
    freshness): one probe for repeated calls, another after a commit."""
    probes = []
    lookup = autotune.lookup
    monkeypatch.setattr(autotune, "lookup",
                        lambda *a, **k: probes.append(a) or lookup(*a, **k))
    x, y = torch.rand(2048), torch.rand(2048)
    nest = compiler.dot_product_nest(2048)
    cluster.cluster_call(nest, reduction.MUL, {"A": x, "B": y}, cores=2)
    first = len(probes)         # the tile's, the cluster's and the shards'
    assert first == 2 and probes[0][0] == probes[1][0]
    for _ in range(2):
        cluster.cluster_call(nest, reduction.MUL, {"A": x, "B": y}, cores=2)
    assert len(probes) == first
    autotune.global_cache().put("unrelated", Schedule(rows=16))  # an epoch
    cluster.cluster_call(nest, reduction.MUL, {"A": x, "B": y}, cores=2)
    assert len(probes) == 2 * first


def test_a_committed_winner_for_the_shard_is_found_through_the_device_key():
    n = 4096
    x, y = torch.rand(n), torch.rand(n)
    sub = compiler.dot_product_nest(n // 2)
    shard = {"A": ((n // 2,), "float32"), "B": ((n // 2,), "float32")}
    committed = Schedule(rows=16)
    autotune.global_cache().put(autotune.cache_key(
        sub, shard, mode="reduce", out_dtype="float32", device="cpu"),
        committed)
    got = cluster._core_schedule([sub], {"A": x, "B": y}, mode="reduce",
                                 out_dtype=torch.float32, device="cpu")
    assert got == committed
    cluster.LAST_DISPATCH.clear()
    out = cluster.cluster_call(compiler.dot_product_nest(n), reduction.MUL,
                               {"A": x, "B": y}, cores=2)
    assert cluster.LAST_DISPATCH["schedule"] == committed
    assert cluster.LAST_DISPATCH["tuned"]
    torch.testing.assert_close(out, (x * y).sum(), rtol=1e-5, atol=1e-5)


def test_cores1_stays_the_ssr_entry_after_a_commit():
    n = 2048
    x, y = torch.rand(n), torch.rand(n)
    committed = Schedule(rows=4, lanes=512)
    autotune.global_cache().put(autotune.cache_key(
        compiler.dot_product_nest(n), {"A": x, "B": y}, mode="reduce",
        out_dtype="float32", device="cpu"), committed)
    got = reduction.cluster_dot(x, y, cores=1)
    assert torch.equal(got, reduction.ssr_dot(x, y))
    assert cluster.LAST_DISPATCH["schedule"] == committed
    assert cluster.LAST_DISPATCH["tuned"]


# --------------------------------------------------------------------------
# Views, not copies; the mesh
# --------------------------------------------------------------------------


def test_each_core_reads_a_view_of_its_rows():
    x = torch.arange(64, dtype=torch.float32)
    seen = []

    def tile(ops, dev):
        seen.append((ops["A"].data_ptr(), ops["B"].data_ptr()))
        return (ops["A"] * ops["B"]).sum()

    out = cluster._sharded_call([compiler.dot_product_nest(64)], tile,
                                {"A": x, "B": x}, cores=4, mode="reduce",
                                mesh=None, dev=torch.device("cpu"))
    base = x.data_ptr()
    assert seen == [(base + 64 * c, base + 64 * c) for c in range(4)]
    assert float(out) == float((x * x).sum())


def test_gemv_and_stencil_cores_read_views(monkeypatch):
    reads = []

    def record(real):
        def fn(a, *rest, **kw):
            reads.append((a.data_ptr(), tuple(a.shape)))
            return real(a, *rest, **kw)
        return fn

    a, x = torch.rand(128, 16), torch.rand(16)
    monkeypatch.setattr(gemv, "ssr_gemv", record(gemv.ssr_gemv))
    gemv.cluster_gemv(a, x, cores=4)         # 128 % (4 · 8) == 0: no copy
    assert reads == [(a.data_ptr() + 4 * 32 * 16 * c, (32, 16))
                     for c in range(4)]
    reads.clear()
    xs, w = torch.rand(1024 + stencil.TAPS - 1), torch.rand(stencil.TAPS)
    monkeypatch.setattr(stencil, "ssr_stencil1d",
                        record(stencil.ssr_stencil1d))
    stencil.cluster_stencil1d(xs, w, cores=8)   # overlapping views of xs
    assert reads == [(xs.data_ptr() + 4 * 128 * c, (128 + stencil.TAPS - 1,))
                     for c in range(8)]


def test_a_mesh_runs_each_core_on_its_device():
    x, y = torch.rand(1024), torch.rand(1024)
    nest = compiler.dot_product_nest(1024)
    got = cluster.cluster_call(nest, reduction.MUL, {"A": x, "B": y},
                               cores=4, mesh=["cpu"] * 4)
    want = cluster.cluster_call(nest, reduction.MUL, {"A": x, "B": y},
                                cores=4)
    assert torch.equal(got, want)
    with pytest.raises(cluster.ClusterError, match="axis of size 4"):
        cluster.cluster_call(nest, reduction.MUL, {"A": x, "B": y}, cores=4,
                             mesh=["cpu"] * 2)


def test_the_combine_is_one_fixed_order_sum_core_0_first():
    parts = [torch.tensor(v) for v in (1e8, 1.0, -1e8, 1.0)]
    # left to right in f32: ((1e8 + 1) − 1e8) + 1 = 1, where a pairwise
    # tree gives (1e8 + 1) + (−1e8 + 1) = 0
    assert float(cluster._combine(parts, None)) == 1.0
    pairs = [(torch.tensor(1.0), torch.tensor(2.0)),
             (torch.tensor(3.0), torch.tensor(4.0))]
    assert [float(t) for t in cluster._combine(pairs, None)] == [4.0, 6.0]


# --------------------------------------------------------------------------
# The locality audit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name, mode", [("reduction", "reduce"),
                                        ("relu", "map"), ("gemm", "map"),
                                        ("gemv", "map"),
                                        ("stencil1d", "map"),
                                        ("sum_sq_diff", "reduce"),
                                        ("axpy_dot", "reduce")])
def test_locality_holds_for_every_variant(name, mode):
    entry = registry.get(name)
    args, kw = _example(name, True)
    chk = check_cluster_locality(lambda *a: entry.cluster(*a, cores=4, **kw),
                                 args, mode=mode, world=4)
    assert chk.ok, chk.counts
    assert chk.counts == ({"all-reduce": 1} if mode == "reduce" else {})


def test_locality_fails_for_a_function_that_combines_twice():
    x, y = torch.rand(4096), torch.rand(4096)
    chk = check_cluster_locality(
        lambda a, b: reduction.cluster_dot(a, b, cores=4)
        + reduction.cluster_dot(a, b, cores=2), (x, y), mode="reduce")
    assert chk.counts == {"all-reduce": 2}
    assert not chk.ok


def test_locality_names_the_op_that_reads_partials_off_core():
    x = torch.rand(4096)
    partials = []

    def shard(t):
        partials.append(t.sum())
        return partials[-1]

    def leaky(t):
        partials.clear()
        total = cluster.cluster_kernel(shard, (t,), cores=4, in_dims=(0,),
                                       reduce=True)
        return total + partials[0], partials[1].clone()

    chk = check_cluster_locality(leaky, (x,), mode="reduce")
    assert chk.counts == {"all-reduce": 1, "aten::add.Tensor": 1,
                          "aten::clone": 1}
    assert not chk.ok


# --------------------------------------------------------------------------
# The divergence (ROADMAP Queue C): cores > 1 on one device
# --------------------------------------------------------------------------


def test_the_port_runs_cores_2_on_one_device_where_the_reference_raises():
    """ROADMAP Queue C, deliberate divergences: the reference's cores are
    mesh devices, so ``cores > 1`` on this one-device process raises
    ``ClusterError`` naming the devices; the port's cores are shards run in
    turn on one device, so the call runs."""
    nest = compiler.dot_product_nest(64)
    with pytest.raises(jcluster.ClusterError, match="device"):
        jcluster.cluster_call(jcompiler.dot_product_nest(64),
                              lambda a, b: a * b,
                              {"A": jnp.ones(64), "B": jnp.ones(64)},
                              cores=2, mode="reduce")
    x = torch.ones(64)
    got = cluster.cluster_call(nest, reduction.MUL, {"A": x, "B": x},
                               cores=2, mode="reduce")
    assert float(got) == 64.0


def test_fused_case_table_forwards_the_cluster_variants():
    cases = {c.name: c for c in chained.fused_cases()}
    assert cases["sum_sq_diff"].cluster is chained.cluster_sum_sq_diff
    assert cases["axpy_dot"].cluster is chained.cluster_axpy_dot
    assert cases["gemv_relu"].cluster is None
    assert registry.get("axpy_dot").cluster is chained.cluster_axpy_dot
