"""Every ring kernel refuses, by name, a ring depth it cannot take.

The ring kernels R1–R15 each hold 2 to ``MAX_BUFFER_DEPTH`` (8) slots a
read stream: a depth-1 "ring" runs nothing ahead, and R3's and R13's
mbarriers are laid out for 8 slots a stream.  ``hopper.accepts`` (and
every wrapper, through the same refusal) refuses a ring outside that
range, naming the ring kernel and the depths: on the CPU, for every key
of ``hopper.RING_KERNELS`` at depths 1 and 9, each on a pipelined call of
its own family at a small size (the key's geometry and program, the
depths replaced), and for R15 on the scan's Launch.
"""

import dataclasses
import functools

import pytest
import torch

import repro_torch
from repro_torch.core import compiler, hopper, lowering
from repro_torch.core.agu import RingProgram
from repro_torch.core.lowering import Schedule
from repro_torch.core.ssr import BlockStream
from repro_torch.core.stream import Direction
from repro_torch.kernels import chained, frontend, gemm, gemv, reduction, \
    relu, scan

from test_torch_dag_ring import FAMILIES, _instances
from test_torch_dag_ring import _call as _dag_call
from test_torch_halo_attention_ring import _call as _halo_call
from test_torch_pipeline import _gather_families

N = 5000
DEEP = Schedule(buffer_depth=3)


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    monkeypatch.delenv("REPRO_DISABLE_PIPELINE", raising=False)
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _flat_launch(n_in: int) -> frontend.Launch:
    """A ChainedKernel's Launch: ``n_in`` streams of (8, 128) blocks on a
    4-step grid, one output stream."""
    walk = BlockStream((8, 128), lambda i: (i, 0))
    return frontend.Launch(
        grid=(4,), in_streams=(walk,) * n_in,
        out_streams=(BlockStream((8, 128), lambda i: (i, 0),
                                 Direction.WRITE),),
        out_shapes=(frontend.ShapeDtype((32, 128), torch.float32),))


@functools.lru_cache(maxsize=None)
def _pipelined() -> dict:
    """RING_KERNELS key → (geometry, program, ring) of a depth-3 call of
    its family (a ChainedKernel's: its Launch's geometry, no program)."""
    x = torch.ones(N)
    calls = [
        lowering.prepare_call(compiler.dot_product_nest(N), reduction.MUL,
                              {"A": x, "B": x}, schedule=DEEP),
        lowering.prepare_call(compiler.elementwise_nest(N), relu.RELU,
                              {"X": x}, mode="map", schedule=DEEP),
        lowering.prepare_call(compiler.gemm_nest(300, 260, 1100), gemm.DOT,
                              {"A": torch.ones(300, 1100),
                               "B": torch.ones(1100, 260)}, schedule=DEEP),
        *(lowering.prepare_call(compiler.gemv_nest(1000, 1536), body,
                                {"A": torch.ones(1000, 1536),
                                 "x": torch.ones(1536)}, schedule=DEEP)
          for body in (gemv.MATVEC, chained.MATVEC_RELU)),
        lowering.prepare_chain_call(
            chained._chain_nests(N, False), (chained.SQ_DIFF,
                                             chained.IDENTITY),
            {"X": x, "Y": x}, mode="reduce", schedule=DEEP),
        lowering.prepare_chain_call(
            chained._chain_nests(N, True), (chained.axpy_block(0.5),
                                            chained.DOT),
            {"X": x, "Y": x, "W": x}, mode="reduce", schedule=DEEP),
        *(lowering.prepare_call(compiler.elementwise_nest(N, ("X", "Y"), 2),
                                body, {"X": x, "Y": x}, mode="map",
                                schedule=DEEP)
          for body in (chained.SQ_DIFF, chained.axpy_block(0.5))),
        lowering.prepare_call(compiler.elementwise_nest(N, ("T",), 1),
                              chained.IDENTITY, {"T": x}, mode="reduce",
                              schedule=DEEP),
        *(_halo_call(name, DEEP) for name in ("stencil1d", "stencil1d_relu",
                                              "stencil2d", "causal_d80")),
        *(lowering.prepare_call(nest, body, ops, mode=mode, schedule=DEEP)
          for nest, body, mode, ops in _gather_families().values()),
        *(_dag_call(inst, DEEP) for name in FAMILIES
          for inst in _instances(name).values()),
    ]
    got = {}
    for call in calls:
        kern = call.kernel
        assert kern.pipelined, kern.device_key
        got[kern.device_key] = (kern.geometry, kern.program, kern.ring)
    for pair in hopper.CHAINED_PROGRAMS:
        n_in = hopper.CHAINED_PRODUCERS[pair[0]][0]
        got["chained", pair] = (
            hopper.chained_geometry(_flat_launch(n_in)), None,
            RingProgram((3,) * n_in, (False,) * n_in))
    return got


def test_every_ring_kernel_has_a_pipelined_call_here():
    assert set(_pipelined()) == set(hopper.RING_KERNELS)
    for key, (geo, program, ring) in _pipelined().items():
        assert hopper.accepts(key, geo, torch.float32, "cpu",
                              program=program, ring=ring) == (True, "ok")


@pytest.mark.parametrize("depth", [1, 9])
@pytest.mark.parametrize("key", sorted(hopper.RING_KERNELS, key=str),
                         ids=str)
def test_ring_depth_outside_2_to_8_is_refused_by_name(key, depth):
    geo, program, ring = _pipelined()[key]
    bad = dataclasses.replace(ring, depths=(depth,) * len(ring.depths))
    takes, why = hopper.accepts(key, geo, torch.float32, "cpu",
                                program=program, ring=bad)
    rname = hopper.RING_KERNELS[key]
    assert not takes
    assert why.startswith(f"{rname}: its ring at depths {bad.depths} ")
    if depth == 1:      # never over the budget: the depth is the reason
        assert why.endswith("has a stream outside the 2 to 8 slots it "
                            "takes")
    # the largest legal depth is taken wherever the budget holds it
    legal = dataclasses.replace(ring, depths=(8,) * len(ring.depths))
    takes, why = hopper.accepts(key, geo, torch.float32, "cpu",
                                program=program, ring=legal)
    assert takes or "needs" in why, why


@pytest.mark.parametrize("depth", [1, 9])
def test_r15_refuses_a_ring_depth_outside_2_to_8_by_name(depth):
    x = torch.ones(1 << 15)
    arrays, static, _ = scan._prepare(x)
    geo = hopper.launch_geometry(scan._launch(static, *arrays))
    ring = RingProgram((depth,), (False,))
    why = hopper._ring_budget_refusal(
        "ring_stream_scan", geo, torch.float32, ring,
        hopper._staged_bytes("ring_stream_scan", (), geo))
    assert why == (f"ring_stream_scan: its ring at depths ({depth},) has a "
                   "stream outside the 2 to 8 slots it takes")
    assert hopper._ring_budget_refusal(
        "ring_stream_scan", geo, torch.float32, RingProgram((8,), (False,)),
        hopper._staged_bytes("ring_stream_scan", (), geo)) is None
