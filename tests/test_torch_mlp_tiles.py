"""K8's 64-row tiles and R9's ring landing in them, on the CPU.

K8 (``csrc/dag_mlp.cu``) multiplies one 64-row tile while the next lands
in a second buffer; R9 (``csrc/ring_dag_mlp.cu``) lands its step blocks in
such tiles, :func:`hopper.mlp_ring_tiles` of them, each step fetched depth
− 1 ahead during the product before.  Here, without a card:

* **one budget** — R9's bytes at depths 2 to 9 on every instantiation and
  step block: the weights and tiles of K8's tiled instantiations, the
  residual's two rings of step slots; what ``accepts`` takes and refuses
  (by name, depths and bytes), and the wrapper's count beside it;
* **every row once** — K8's and R9's splits (:func:`hopper.mlp_split`)
  walk every row of an 8-row-step grid exactly once, and R9's fetches
  every step once, at rows around the tile and the mlp_block cell's 2**19
  rows plus a step;
* **R9's schedule** (:func:`hopper.mlp_ring_schedule`, the kernel's order
  of fetches, waits and products): no fetch lands in a tile that is being
  multiplied or waits for its product; a tile's product starts with all its
  steps landed in its rows, exactly depth − 1 later steps (or the rest of
  the run) in flight.

The card's checks (R9 to K8's bits, K8 against its plain version at these
row counts, no local bytes, the entries' shared memory) are in
``tests/test_torch_cuda.py``.
"""

import pytest
import torch

import repro_torch
from repro_torch.core import agu, autotune, hopper, lowering
from repro_torch.kernels import dag

OPTIN = hopper.SMEM_OPTIN_BYTES
WHAT = "its staged weights and the tiles its ring lands in"
INSTANCES = {(0, 1, 2): ("mlp_hidden", "mlp_out", "mlp_residual"),
             (0,): ("mlp_hidden",), (1,): ("mlp_out",),
             (2,): ("mlp_residual",), (1, 2): ("mlp_out", "mlp_residual")}
# the row counts of the walk: a tile of 1 row, one short, whole, one over,
# two and one over, and the cell's 2**19 rows with one more 8-row step
WALK_ROWS = [1, 37, 63, 64, 65, 129, (1 << 19) + 8]


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    monkeypatch.delenv("REPRO_DISABLE_PIPELINE", raising=False)
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _kernel(stages, rows):
    """The depth-3 kernel of an instantiation of the MLP block (a component
    of one of its legal cuts) on 64 steps of ``rows``-row blocks."""
    x = torch.zeros(64 * rows, 128)
    w, b = torch.zeros(128, 128), torch.zeros(128)
    nests, bodies, operands, mode, uniforms = dag.mlp_block_spec(
        x, w, b, w, b)
    graph = lowering._dag_for(nests, None)
    env = {"X": operands["X"], "H": operands["X"], "Y": operands["X"]}
    sched = lowering.Schedule(rows=rows, buffer_depth=3)
    for cut in autotune.enumerate_cuts(graph):
        if not autotune.dag_cut_is_legal(graph, cut, nests=nests,
                                         bodies=bodies, mode=mode,
                                         uniforms=uniforms, device="cpu")[0]:
            continue
        for comp in lowering.dag_components(graph, nests, bodies, cut,
                                            mode=mode):
            if comp.stages != stages:
                continue
            if len(stages) == 1:
                call = lowering.prepare_call(
                    comp.nests[0], comp.bodies[0], env, mode=comp.mode,
                    schedule=sched, uniforms=uniforms)
            else:
                call = lowering.prepare_dag_call(
                    comp.nests, comp.bodies, env, mode=comp.mode,
                    schedule=sched, uniforms=uniforms)
            kern = call.kernel
            assert kern.program.ops == INSTANCES[stages] and kern.pipelined
            return kern
    raise AssertionError(f"no legal cut runs {stages}")


@pytest.mark.parametrize("rows", [8, 16, 32])
@pytest.mark.parametrize("stages", list(INSTANCES), ids=str)
def test_r9_bytes_and_refusals_at_every_depth(stages, rows):
    """At depths 2 to 9, what R9 takes on each instantiation: K8's tiled
    ones W1, W2 and 3 + (depth − 2) // (64 // rows) tiles of 64 rows on
    the 132-float pitch; the residual alone its H and Y step slots.  Over
    the opt-in budget it is refused with its bytes, then outside depths 2 to
    8 with its depths, each naming ring_dag_mlp; where it is taken the
    wrapper counts the same bytes."""
    kern = _kernel(stages, rows)
    n, invariant = len(kern.geometry.ins), kern.ring.invariant
    res = hopper._resolve("dag_mlp", kern.program)
    for depth in range(2, 10):
        ring = agu.RingProgram((depth,) * n, invariant)
        takes, why = hopper.accepts(kern.device_key, kern.geometry,
                                    torch.float32, "cpu",
                                    program=kern.program, ring=ring)
        if stages == (2,):
            staged, need = 0, 2 * depth * rows * 132 * 4
        else:
            tiles = 3 + (depth - 2) // (64 // rows)
            assert hopper.mlp_ring_tiles(depth, rows) == tiles
            staged = need = 4 * (2 * 128 * 128 + tiles * 64 * 132)
        depths = f"ring_dag_mlp: its ring at depths {ring.depths}"
        if need > OPTIN:
            also = f" ({staged} of them {WHAT})" if staged else ""
            assert not takes and why == (
                f"{depths} needs {need} bytes of shared memory a CTA{also}, "
                f"the card allows {OPTIN}")
        elif depth > 8:
            assert not takes and why == (
                f"{depths} has a stream outside the 2 to 8 slots it takes")
        else:
            assert takes, why
            got = hopper._staged_bytes("ring_dag_mlp", kern.program.ops,
                                       kern.geometry, ring)
            assert got == staged
            dr = hopper._read_ring("ring_dag_mlp", res, ("X", "H", "Y"),
                                   kern.geometry, ring, got)
            assert dr.ring_bytes + got == need
            assert dr.depths == (depth,) * (2 if stages == (2,) else 1)
            assert not any(dr.invariant)


@pytest.mark.parametrize("rows", WALK_ROWS)
def test_k8_and_r9_walk_every_row_once(rows):
    """On a grid of 8-row steps covering ``rows`` rows, K8's tiles and R9's
    (eight steps a tile) give every row to exactly one CTA, at most one
    CTA an SM; R9's schedule fetches every step once, at depths 3, 4, 8."""
    steps = -(-rows // 8)
    for ring in (False, True):
        walk = hopper.mlp_tile_walk(steps, 8, 132, ring)
        assert len(walk) == hopper.mlp_split(steps, 8, 132, ring)[0] <= 132
        covered = sorted(r for cta in walk for r in cta)
        assert covered[0][0] == 0 and covered[-1][1] == steps * 8
        assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))
        assert all(stop - start <= 64 for start, stop in covered)
    ctas = hopper.mlp_split(steps, 8, 132, True)[0]
    for depth in (3, 4, 8):
        fetched = [e[1] for cta in hopper.mlp_ring_schedule(
            steps, 8, depth, ctas, 4) for e in cta if e[0] == "fetch"]
        assert sorted(fetched) == list(range(steps))


@pytest.mark.parametrize("depth", range(2, 9))
@pytest.mark.parametrize("rows", [1, 2, 8, 16, 24, 32, 64])
def test_r9_schedule_keeps_its_tiles(rows, depth):
    """No fetch of R9 overwrites a tile before its product is done and
    the CTA has met at the next barrier; each product starts with every
    step of its tile landed in the tile's rows, in run order, and exactly
    min(depth − 1, the steps left) later steps in flight (at most 7
    commit groups a thread)."""
    per, nb = 64 // rows, hopper.mlp_ring_tiles(depth, rows)
    for steps in (1, 5, 37, 64, 65, 129, 1000):
        for ctas in (1, 3, 132):
            for hook in (1, 2, 4, 32):
                sched = hopper.mlp_ring_schedule(steps, rows, depth, ctas,
                                                 hook)
                for cta, ev in enumerate(sched):
                    _check_run(ev, cta, ctas, steps, rows, nb, depth)


def _check_run(ev, cta, ctas, steps, rows, nb, depth):
    per = 64 // rows
    order = [(cta + i * ctas) * per + p
             for i in range(-(-steps // per))
             if cta + i * ctas < -(-steps // per)
             for p in range(per) if (cta + i * ctas) * per + p < steps]
    fetches = [e for e in ev if e[0] == "fetch"]
    assert [e[1] for e in fetches] == order
    landed = {}           # tile index of the CTA -> rows fetched into it
    holds = {}            # buffer -> the tile index whose rows it holds
    done, released = set(), set()
    issued = 0
    pending = None
    for e in ev:
        if e[0] == "fetch":
            _, step, buf, row = e
            i = (step // per - cta) // ctas
            assert buf == i % nb and row == (step % per) * rows
            old = holds.get(buf)
            assert old is None or old == i or old in released, (e, old)
            holds[buf] = i
            landed.setdefault(i, set()).add(step)
            issued += 1
        elif e[0] == "wait":
            pending = e[1]
            assert 0 <= pending <= min(depth - 1, 7)
        elif e[0] == "tile":
            _, i, buf, n = e
            released |= done          # the barrier before the product
            assert buf == i % nb and holds.get(buf) == i
            mine = [s for s in order if (s // per - cta) // ctas == i]
            assert len(mine) == n and landed.get(i) == set(mine)
            end = order.index(mine[-1]) + 1
            assert issued - pending == end
            assert pending == min(depth - 1, len(order) - end)
        else:
            done.add(e[1])
