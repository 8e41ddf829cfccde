"""The DAG rings in the port: K6–K8's families under the N-deep rotation.

A schedule deeper than 2 makes a fused DAG (``ssr_dag_call``) and each
component of a cut of it (a singleton ``ssr_call`` or a sub-DAG) pipelined:
its read streams arrive through the ring (on the CPU
:func:`hopper.ring_delivery` under ``StageKernel.plain``, on the card R7
``ring_dag_layernorm``, R8 ``ring_dag_softmax_xent`` and R9
``ring_dag_mlp``).  On the CPU, at small sizes and on inputs from a numpy
seed:

* **delivery changes, the arithmetic does not** — every instantiation of
  each family, at depths 3, 4, 8 and at per-stream depths, gives the
  depth-2 bits; the fused entries at depth 3 agree with the reference's
  within the registry ``tol``;
* **the reference's rotation** — the ring's fetch log on the DAG
  geometries is ``_pipelined_call``'s formula;
* **pipelined where a ring runs** — at a depth above 2 on a grid of more
  than one step, every component of a cut too; not at depth 2, on a
  one-step grid or under ``REPRO_DISABLE_PIPELINE``;
* **one budget** — ``accepts`` counts R9's staged weights and the tiles
  its ring lands in, refuses over it with the kernel's name and depths,
  and takes the largest depth that fits; the card's race keeps depth-only
  DAG candidates.

The card's own checks (R7–R9 against K6–K8 to the bit) are in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.lowering import Schedule as JSchedule
from repro.kernels import dag as jdag
from repro.kernels import registry as jregistry

import repro_torch
from repro_torch.core import agu, autotune, compiler, hopper, lowering, ssr
from repro_torch.core.lowering import DEFAULT_SCHEDULE, Schedule
from repro_torch.kernels import dag

from test_torch_pipeline import _formula

FAMILIES = ("layernorm", "softmax_xent", "mlp_block")
RING = {"layernorm": "ring_dag_layernorm",
        "softmax_xent": "ring_dag_softmax_xent", "mlp_block": "ring_dag_mlp"}
SUBSETS = ((0, 1, 2), (0,), (1,), (2,), (1, 2))
# per-stream depths where an instantiation reads two or more streams:
# softmax_xent fused (Z, P) and its loss alone (C, E, P), the MLP's
# residual alone (H, Y), layernorm's normalise alone (C, V)
PAIRS = {("softmax_xent", (0, 1, 2)): [(2, 4), (4, 2)],
         ("softmax_xent", (2,)): [(2, 4, 3)],
         ("mlp_block", (2,)): [(4, 2)],
         ("layernorm", (2,)): [(2, 4), (4, 2)]}


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    monkeypatch.delenv("REPRO_DISABLE_PIPELINE", raising=False)
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _args(name, rows, seed):
    """The family's inputs as numpy arrays: rows of 128 ~ N(0, 1), one-hot
    targets, weights and biases ~ N(0, 0.1²)."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if name == "layernorm":
        return (f(rows, 128),)
    if name == "softmax_xent":
        return (f(rows, 128),
                np.eye(128, dtype=np.float32)[rng.integers(0, 128, rows)])
    return (f(rows, 128), f(128, 128, scale=0.1), f(128, scale=0.1),
            f(128, 128, scale=0.1), f(128, scale=0.1))


def _spec(name, rows, seed):
    case = {c.name: c for c in dag.dag_cases()}[name]
    return case.spec(*(torch.from_numpy(a) for a in _args(name, rows, seed)))


def _instances(name, rows=200, seed=3):
    """Each instantiation a legal cut runs, as ``stages -> (nests, bodies,
    operands, mode, uniforms)``, on the values the depth-2 kernels before
    it produced."""
    nests, bodies, operands, mode, uniforms = _spec(name, rows, seed)
    graph = lowering._dag_for(nests, None)
    out = {}
    for cut in autotune.enumerate_cuts(graph):
        if not autotune.dag_cut_is_legal(graph, cut, nests=nests,
                                         bodies=bodies, mode=mode,
                                         uniforms=uniforms, device="cpu")[0]:
            continue
        env = dict(operands)
        for comp in lowering.dag_components(graph, nests, bodies, cut,
                                            mode=mode):
            inst = (comp.nests, comp.bodies, dict(env), comp.mode, uniforms)
            out.setdefault(comp.stages, inst)
            if comp.exported is not None:
                env[comp.exported] = _call(inst, DEFAULT_SCHEDULE).run()
    return out


def _call(inst, sched):
    nests, bodies, env, mode, uniforms = inst
    if len(nests) == 1:
        return lowering.prepare_call(nests[0], bodies[0], env, mode=mode,
                                     schedule=sched, uniforms=uniforms)
    return lowering.prepare_dag_call(nests, bodies, env, mode=mode,
                                     schedule=sched, uniforms=uniforms)


def _sched(depth) -> Schedule:
    if isinstance(depth, tuple):
        return Schedule(stream_depths=depth)
    return Schedule(buffer_depth=depth)


_CASES = [(name, sub, depth) for name in FAMILIES for sub in SUBSETS
          for depth in [3, 4, 8, *PAIRS.get((name, sub), [])]]


@pytest.mark.parametrize("name, stages, depth", _CASES, ids=str)
def test_every_instantiation_gives_the_depth_2_bits(name, stages, depth):
    inst = _instances(name)[stages]
    ring = _call(inst, _sched(depth))
    kern = ring.kernel
    assert kern.pipelined and kern.geometry.steps > 1
    assert hopper.RING_KERNELS[kern.device_key] == RING[name]
    want = _call(inst, DEFAULT_SCHEDULE)
    assert not want.kernel.pipelined
    got = ring.run()
    assert torch.equal(got.view(torch.int32), want.run().view(torch.int32))


@pytest.mark.parametrize("name", FAMILIES)
def test_fused_entry_at_depth_3_agrees_with_the_reference(name):
    """The port's fused entry at depth 3 runs its ring; the reference's at
    the same schedule runs synchronously on the installed jax (ROADMAP C1:
    its ``pipeline_supported()`` is False), so the two agree within the
    registry entry's ``tol``, and the port's ring gives its own depth-2
    bits."""
    arrays = _args(name, 96, 7)
    port = {"layernorm": dag.fused_layernorm,
            "softmax_xent": dag.fused_softmax_xent,
            "mlp_block": dag.fused_mlp_block}[name]
    ref = {"layernorm": jdag.fused_layernorm,
           "softmax_xent": jdag.fused_softmax_xent,
           "mlp_block": jdag.fused_mlp_block}[name]
    ts = tuple(torch.from_numpy(a) for a in arrays)
    got = port(*ts, schedule=Schedule(buffer_depth=3))
    assert torch.equal(got, port(*ts, schedule=DEFAULT_SCHEDULE))
    want = ref(*(jnp.asarray(a) for a in arrays),
               schedule=JSchedule(buffer_depth=3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **jregistry.get(name).tol)


_LOG_CASES = [(name, (0, 1, 2), d) for name in FAMILIES
              for d in (3, 8, *PAIRS.get((name, (0, 1, 2)), []))] + [
    ("softmax_xent", (2,), (2, 4, 3)), ("mlp_block", (2,), (4, 2)),
    ("layernorm", (2,), 4)]


@pytest.mark.parametrize("run", [None, 1, 2, 5], ids=str)
@pytest.mark.parametrize("name, stages, depth", _LOG_CASES, ids=str)
def test_fetch_log_is_the_reference_rotation(name, stages, depth, run):
    """R7–R9's ring on the DAG geometries, in the plain version: the
    reference's prime / run-ahead / no-fetch-past-the-run formula for runs
    of several lengths; K8's uniforms are invariant, fetched once a run."""
    call = _call(_instances(name, rows=104)[stages], _sched(depth))
    kern = call.kernel
    assert kern.pipelined and kern.geometry.steps == 13
    inputs, log = hopper.ring_delivery(kern.geometry, call.layouts,
                                       kern.ring, run)
    assert log == _formula(kern.depths, kern.ring.invariant, 13, run or 13)
    n_uniform = kern.program.n_uniform
    assert kern.ring.invariant == (False,) * (len(kern.depths) - n_uniform) \
        + (True,) * n_uniform
    got = hopper.plain_stages(kern.bodies, kern.program, kern.mode,
                              kern.geometry, call.layouts, kern.out_dtype,
                              inputs=inputs) if isinstance(
        kern, ssr.StageKernel) else hopper.PLAIN[kern.mode](
            kern.body, kern.geometry, call.layouts, kern.out_dtype,
            inputs=inputs)
    assert torch.equal(got, kern.plain(call.layouts))


@pytest.mark.parametrize("name", FAMILIES)
def test_pipelined_only_where_the_ring_runs(name, monkeypatch):
    nests, bodies, operands, mode, uniforms = _spec(name, 200, 1)

    def kernel(sched, ops=operands, ns=nests):
        return lowering.prepare_dag_call(ns, bodies, ops, mode=mode,
                                         schedule=sched,
                                         uniforms=uniforms).kernel

    assert kernel(Schedule(buffer_depth=3)).pipelined
    assert kernel(Schedule(buffer_depth=3)).geometry.steps > 1
    assert not kernel(DEFAULT_SCHEDULE).pipelined
    # one grid step: 8 rows of 128 are one (8, 128) block
    small_nests, _, small_ops, _, _ = _spec(name, 8, 1)
    one = kernel(Schedule(buffer_depth=3), small_ops, small_nests)
    assert one.geometry.steps == 1 and not one.pipelined
    monkeypatch.setenv("REPRO_DISABLE_PIPELINE", "1")
    assert not kernel(Schedule(buffer_depth=3)).pipelined


@pytest.mark.parametrize("name", FAMILIES)
def test_disable_pipeline_keeps_the_bits(name, monkeypatch):
    case = {c.name: c for c in dag.dag_cases()}[name]
    ts = tuple(torch.from_numpy(a) for a in _args(name, 200, 2))
    deep = case.fused(*ts, schedule=Schedule(buffer_depth=4))
    monkeypatch.setenv("REPRO_DISABLE_PIPELINE", "1")
    assert torch.equal(case.fused(*ts, schedule=Schedule(buffer_depth=4)),
                       deep)


def _legal_cuts(name):
    nests, bodies, operands, mode, uniforms = _spec(name, 200, 4)
    graph = lowering._dag_for(nests, None)
    return [cut for cut in autotune.enumerate_cuts(graph)
            if autotune.dag_cut_is_legal(graph, cut, nests=nests,
                                         bodies=bodies, mode=mode,
                                         uniforms=uniforms,
                                         device="cpu")[0]]


@pytest.mark.parametrize("name, cut", [(n, c) for n in FAMILIES
                                       for c in _legal_cuts(n)], ids=str)
def test_every_component_of_a_cut_dag_is_pipelined(name, cut):
    """A cut DAG at depth 3 runs each component — singleton or sub-DAG —
    through the ring (the reference pipelines those too), and gives the
    depth-2 cut's bits."""
    nests, bodies, operands, mode, uniforms = _spec(name, 200, 4)
    graph = lowering._dag_for(nests, None)
    sched = Schedule(buffer_depth=3, cut_edges=tuple(cut))
    shapes = tuple(tuple(u.shape) for u in uniforms.values())
    for comp in lowering.dag_components(graph, nests, bodies, cut,
                                        mode=mode):
        kern = lowering.component_kernel(comp, out_dtype=torch.float32,
                                         schedule=sched, uniforms=shapes)
        assert kern.pipelined, comp.stages
        assert hopper.RING_KERNELS[kern.device_key] == RING[name]
    got = lowering.ssr_dag_call(nests, bodies, operands, mode=mode,
                                schedule=sched, uniforms=uniforms)
    want = lowering.ssr_dag_call(nests, bodies, operands, mode=mode,
                                 schedule=Schedule(cut_edges=tuple(cut)),
                                 uniforms=uniforms)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_every_instantiation_has_a_ring_kernel():
    keys = {k: v for k, v in hopper.RING_KERNELS.items()
            if v in RING.values()}
    fams = {v: k for k, v in RING.items()}
    dev_keys = {k for k, v in hopper.DEVICE_KERNELS.items()
                if v.__name__ in ("dag_layernorm", "dag_softmax_xent",
                                  "dag_mlp")}
    assert set(keys) == dev_keys and len(dev_keys) == 15
    for key, rname in keys.items():
        assert hopper.DEVICE_KERNELS[key].__name__ == rname[len("ring_"):]
        assert fams[rname]
        info = hopper.KERNELS[rname]
        assert info["source"] == f"src/repro_torch/csrc/{rname}.cu"
        assert info["replaces"] == "src/repro/core/ssr.py:215"


def _mlp_kernel(stages, rows, depth):
    inst = _instances("mlp_block", rows=256)[stages]
    nests, bodies, env, mode, uniforms = inst
    sched = Schedule(rows=rows, buffer_depth=depth)
    return _call(inst, sched).kernel


@pytest.mark.parametrize("stages, rows, fits", [
    ((0, 1, 2), 8, 8), ((0, 1, 2), 16, 5), ((0, 1, 2), 32, 3),
    ((0,), 16, 5), ((1, 2), 16, 5), ((2,), 16, 8), ((2,), 32, 6)], ids=str)
def test_accepts_counts_r9s_staged_weights_and_tile(stages, rows, fits):
    """R9's ring with K8's staged W1 and W2 and the 64-row tiles its steps
    land in against the opt-in budget: the largest depth that fits is
    taken, the next refused with the exact message, on the CPU as on the
    card.  The tiles are the one multiplied and those its fetches, depth −
    1 steps ahead of the next tile's, reach: 3 + (depth − 2) // (64 //
    rows).  The residual alone stages nothing and rings H and Y in step
    slots; a value two stages read (H in {1, 2}) is fetched once."""
    for depth in range(3, ssr.MAX_BUFFER_DEPTH + 1):
        kern = _mlp_kernel(stages, rows, depth)
        assert kern.pipelined
        takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                    torch.float32, "cpu",
                                    **kern.device_args())
        if stages == (2,):
            staged, need = 0, 2 * depth * rows * 132 * 4
        else:
            tiles = 3 + (depth - 2) // (64 // rows)
            staged = need = 4 * (2 * 128 * 128 + tiles * 64 * 132)
        assert takes is (depth <= fits) is (need <= hopper.SMEM_OPTIN_BYTES)
        if not takes:
            also = f" ({staged} of them its staged weights and the tiles " \
                "its ring lands in)" if staged else ""
            assert why == (f"ring_dag_mlp: its ring at depths {kern.depths} "
                           f"needs {need} bytes of shared memory a CTA"
                           f"{also}, the card allows 232448")


def test_ring_over_the_budget_is_a_lowering_error_on_any_device():
    """The wrapper refuses what accepts refuses, before it touches the
    card: the LoweringError names the kernel and its depths."""
    kern = _mlp_kernel((0, 1, 2), 16, 6)
    res = hopper._resolve("dag_mlp", kern.program)
    staged = hopper._staged_bytes("ring_dag_mlp", kern.program.ops,
                                  kern.geometry, kern.ring)
    assert staged == 266240
    with pytest.raises(lowering.LoweringError,
                       match=r"ring_dag_mlp: its ring at depths \(6, 6, 6, "
                             r"6, 6\) needs 266240 bytes"):
        hopper._read_ring("ring_dag_mlp", res, ("X", "H", "Y"),
                          kern.geometry, kern.ring, staged)


@pytest.mark.parametrize("name, rows", [("layernorm", 64),
                                        ("softmax_xent", 32)])
def test_accepts_refuses_r7_and_r8_over_the_budget(name, rows):
    """R7 and R8 count one slot of a (rows, 128) block per stream read
    and depth, nothing staged."""
    nests, bodies, operands, mode, uniforms = _spec(name, 1024, 6)
    n_read = 1 if name == "layernorm" else 2
    for depth in (3, ssr.MAX_BUFFER_DEPTH):
        kern = lowering.prepare_dag_call(
            nests, bodies, operands, mode=mode,
            schedule=Schedule(rows=rows, buffer_depth=depth)).kernel
        takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                    torch.float32, "cpu",
                                    **kern.device_args())
        need = n_read * depth * rows * 128 * 4
        assert takes is (need <= hopper.SMEM_OPTIN_BYTES), why
        if not takes:
            assert why == (f"{RING[name]}: its ring at depths {kern.depths} "
                           f"needs {need} bytes of shared memory a CTA, the "
                           "card allows 232448")


def test_device_ring_slots_are_the_read_streams():
    """{1, 2} of softmax_xent takes C in both stages (two streams of the
    lowering) and P: the ring fetches C once."""
    kern = _call(_instances("softmax_xent")[(1, 2)], Schedule(
        buffer_depth=4)).kernel
    assert len(kern.depths) == 3
    reads = hopper._stage_reads("dag_softmax_xent", kern.program)
    assert len(reads) == 2
    dr = hopper.device_ring("ring_dag_softmax_xent", kern.geometry,
                            kern.ring, torch.float32, reads)
    assert dr.ring_bytes == 2 * 4 * 8 * 128 * 4
    assert sorted(dr.slot_bytes) == [0, 4096, 4096]


@pytest.mark.parametrize("stage", ["ln_centre", "sx_loss", "ln_normalise"])
def test_card_race_keeps_depth_only_dag_candidates(stage):
    """A DAG component's kernel stages now, so a depth-only candidate is a
    kernel of its own and survives the card's filter beside its depth-2
    twin."""
    n = 1 << 14
    names = {"ln_centre": ("X",), "sx_loss": ("C", "E", "P"),
             "ln_normalise": ("C", "V")}[stage]
    body = {b.op: b for b in (*dag._LN_BODIES, *dag._SX_BODIES)}[stage]
    mode = "reduce" if stage == "sx_loss" else "map"
    nest = compiler.elementwise_nest(n, names, 2)
    ops = {k: torch.ones(n) for k in names}
    cands = autotune.candidate_schedules(nest, quick=True)
    kept = autotune._card_candidates(nest, cands, body, mode=mode,
                                     out_dtype="float32", operands=ops,
                                     dev=torch.device("cpu"))
    assert kept[0] == DEFAULT_SCHEDULE
    deep = [s for s in kept if s.buffer_depth == 3]
    assert deep, kept
    shallow = {autotune._candidate_kernel(nest, s, body, mode, "float32",
                                          ops).geometry
               for s in kept if s.buffer_depth == 2}
    for s in deep:
        k = autotune._candidate_kernel(nest, s, body, mode, "float32", ops)
        assert k.pipelined and k.geometry in shallow
        assert hopper.RING_KERNELS[k.device_key].startswith("ring_dag_")


def test_ring_program_is_the_kernels_stream_order():
    """The ring a DAG kernel hands its ring kernel lists the values it
    reads in the kernel's order (x or C, then V; z or C, then E, then P;
    x or H, then Y), each at its stream's depth."""
    kern = _call(_instances("softmax_xent")[(2,)],
                 Schedule(stream_depths=(2, 4, 3))).kernel
    res = hopper._resolve("dag_softmax_xent", kern.program)
    dr = hopper._read_ring("ring_dag_softmax_xent", res, ("Z", "C", "E", "P"),
                           kern.geometry, kern.ring)
    assert dr.depths == tuple(kern.depths[res.streams[v]]
                              for v in ("C", "E", "P"))
    kern = _call(_instances("mlp_block")[(2,)],
                 Schedule(stream_depths=(4, 2))).kernel
    res = hopper._resolve("dag_mlp", kern.program)
    dr = hopper._read_ring("ring_dag_mlp", res, ("X", "H", "Y"),
                           kern.geometry, kern.ring)
    assert dr.depths == (4, 2) and dr.invariant == (False, False)
    assert dr.slot_bytes == (8 * hopper.MLP_PITCH * 4,) * 2
    assert isinstance(dr, agu.RingProgram)
