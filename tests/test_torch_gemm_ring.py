"""R3's ring on the CPU: the budget of its producer-warp design and the
route its producer takes, beside the JAX package's gemm.

R3 ``ring_contract_gemm`` rings 16-wide k chunks of A and B, each stream at
its own depth: an A slot is 128 rows of 16 k and a B slot 16 rows of 128,
unpadded (what a TMA box lands as), and the CTA keeps a full and an empty
mbarrier for each of up to 8 slots of each stream besides (256 bytes,
``_staged_bytes``).  On the CPU, at the gemm cell's geometry (4096**3) and
at small sizes on inputs from a numpy seed:

* **one budget** — ``device_ring`` and ``_staged_bytes`` give those bytes
  at depths 3, 4, 8, (2, 4), (4, 2) in f32 and bf16, ``accepts`` admits
  every one of them, and a ring over ``SMEM_OPTIN_BYTES`` is refused by
  name with its bytes;
* **the route is the layout's** — ``gemm_ring_route`` gives TMA for f32 on
  16-byte packs with ``tk`` a multiple of the chunk, the cp.async packs for
  bf16 or a ``tk`` off the chunk, element copies on a pitch that is no
  multiple of 16 bytes;
* **every route computes the gemm** — on the schedules that send R3 down
  the cp.async routes, the pipelined call gives the port's depth-2 bits
  and agrees with the JAX package's gemm at the same schedule (Pallas
  interpret mode) within the registry's tol.

The card's own checks (R3 to K3's bits by each route, B3 on ragged m and
n) are in ``tests/test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.lowering import Schedule as JSchedule
from repro.kernels import registry as jregistry

import repro_torch
from repro_torch.core import compiler, hopper, lowering
from repro_torch.core.agu import RingProgram
from repro_torch.core.lowering import Schedule
from repro_torch.kernels import gemm

DEPTHS = [3, 4, 8, (2, 4), (4, 2)]
DTYPES = [torch.float32, torch.bfloat16]
CELL = 4096      # chip_smoke.py's gemm cell: 4096**3


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    monkeypatch.delenv("REPRO_DISABLE_PIPELINE", raising=False)
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _sched(depth, **kw) -> Schedule:
    if isinstance(depth, tuple):
        return Schedule(stream_depths=depth, **kw)
    return Schedule(buffer_depth=depth, **kw)


@functools.lru_cache(maxsize=None)
def _cell_call(dtype, depth):
    """The gemm cell's call (operands never read: only its geometry, ring
    and program are)."""
    a = torch.empty(CELL, CELL, dtype=dtype)
    return lowering.prepare_call(compiler.gemm_nest(CELL, CELL, CELL),
                                 gemm.DOT, {"A": a, "B": a},
                                 schedule=_sched(depth))


def _depths(depth):
    return depth if isinstance(depth, tuple) else (depth, depth)


# -- one budget ----------------------------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_r3_ring_bytes_are_unpadded_chunks_and_barriers(dtype, depth):
    kern = _cell_call(dtype, depth).kernel
    geo = kern.geometry
    size = 4 if dtype == torch.float32 else 2
    dr = hopper.device_ring("ring_contract_gemm", geo, kern.ring, dtype)
    da, db = _depths(depth)
    assert kern.ring.depths == dr.depths == (da, db)
    assert dr.invariant == (False, False)
    # a slot of A: 128 rows of 16 k; of B: 16 rows of 128, no padding
    assert dr.slot_bytes == (128 * 16 * size, 16 * 128 * size)
    assert dr.ring_bytes == (da + db) * 2048 * size
    # full and empty mbarriers for 8 slots of each stream, whatever the
    # depths
    assert hopper._staged_bytes("ring_contract_gemm", ("dot",), geo) == 256
    assert hopper.RING_BARRIER_BYTES == 256
    if dtype == torch.float32:
        assert dr.ring_bytes + 256 == {3: 49408, 4: 65792, 8: 131328,
                                       (2, 4): 49408, (4, 2): 49408}[depth]


@pytest.mark.parametrize("depth", DEPTHS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_accepts_admits_r3_on_the_gemm_cell(dtype, depth):
    kern = _cell_call(dtype, depth).kernel
    assert kern.pipelined and kern.device_key == ("nest", "dot")
    assert hopper.RING_KERNELS[kern.device_key] == "ring_contract_gemm"
    takes, why = hopper.accepts(kern.device_key, kern.geometry, dtype, "cpu",
                                **kern.device_args())
    assert (takes, why) == (True, "ok")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_r3_over_the_budget_is_refused_by_name(dtype):
    """No schedule depth (at most 8) takes R3 past the budget; a ring of 16
    slots a stream in f32 (262,400 bytes with the barriers) is over it, and
    refused for its bytes; one in bf16 (131,328) is within it, and refused
    for its depth: R3's entry takes 2 to 8 slots a stream."""
    kern = _cell_call(dtype, 3).kernel
    ring = RingProgram((16, 16), (False, False))
    takes, why = hopper.accepts(kern.device_key, kern.geometry, dtype, "cpu",
                                program=kern.program, ring=ring)
    need = 32 * 2048 * (4 if dtype == torch.float32 else 2) + 256
    if dtype == torch.float32:
        assert need == 262400 and not takes
        assert why == (f"ring_contract_gemm: its ring at depths (16, 16) "
                       f"needs {need} bytes of shared memory a CTA (256 of "
                       f"them its slots' barriers), the card allows "
                       f"{hopper.SMEM_OPTIN_BYTES}")
    else:
        assert need == 131328 and not takes
        assert why == ("ring_contract_gemm: its ring at depths (16, 16) has "
                       "a stream outside the 2 to 8 slots it takes")


# -- the route is the layout's -------------------------------------------------


@pytest.mark.parametrize("dtype, lanes, tk, pitch, route", [
    (torch.float32, 128, 384, 1152, "tma"),
    (torch.bfloat16, 128, 384, 1152, "cp.async"),
    (torch.float32, 8, 24, 1104, "cp.async"),          # tk off the chunk
    (torch.float32, 136, 408, 1224, "cp.async"),
    (torch.float32, 130, 390, 1170, "cp.async elements"),   # odd pitch
    (torch.bfloat16, 130, 390, 1170, "cp.async elements"),
], ids=str)
def test_gemm_ring_route_is_the_layouts(dtype, lanes, tk, pitch, route):
    a = torch.zeros(300, 1100, dtype=dtype)
    b = torch.zeros(1100, 260, dtype=dtype)
    call = lowering.prepare_call(compiler.gemm_nest(300, 260, 1100),
                                 gemm.DOT, {"A": a, "B": b},
                                 schedule=_sched(3, lanes=lanes))
    geo = call.kernel.geometry
    assert geo.ins[0].block[1] == tk and call.layouts[0].shape[1] == pitch
    assert hopper.gemm_ring_route(geo, call.layouts) == route


# -- every route computes the gemm ---------------------------------------------


@pytest.mark.parametrize("lanes", [8, 130, 136])
@pytest.mark.parametrize("depth", [3, (2, 4)], ids=str)
def test_cp_async_schedules_match_depth_2_and_the_reference(lanes, depth):
    rng = np.random.default_rng(lanes)
    an = rng.standard_normal((300, 1100)).astype(np.float32)
    bn = rng.standard_normal((1100, 260)).astype(np.float32)
    a, b = torch.from_numpy(an), torch.from_numpy(bn)
    nest = compiler.gemm_nest(300, 260, 1100)
    call = lowering.prepare_call(nest, gemm.DOT, {"A": a, "B": b},
                                 schedule=_sched(depth, lanes=lanes))
    assert call.kernel.pipelined
    assert hopper.gemm_ring_route(call.kernel.geometry,
                                  call.layouts) != "tma"
    got = gemm.ssr_matmul(a, b, schedule=_sched(depth, lanes=lanes))
    want = gemm.ssr_matmul(a, b, schedule=Schedule(lanes=lanes))
    assert torch.equal(got, want)
    assert torch.equal(call.run().reshape(got.shape), got)
    jdepth = dict(stream_depths=depth) if isinstance(depth, tuple) \
        else dict(buffer_depth=depth)
    ref = jregistry.get("gemm").ssr(jnp.asarray(an), jnp.asarray(bn),
                                    schedule=JSchedule(lanes=lanes, **jdepth))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               **jregistry.get("gemm").tol)
