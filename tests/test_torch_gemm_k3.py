"""K3 on the CPU: what its wrapper decides before the launch.

K3 ``contract_gemm`` delivers 32-wide k chunks of A and B into two
shared-memory buffers: A through registers, stored k-major in f32, B by
cp.async, each in 16-byte packs where the layouts allow, else one element
a copy (``contract_gemm_route``), each buffer 32 k of A on a pitch of 132
floats and 32 rows of B's 128 columns (``contract_gemm_smem_bytes``).
On the CPU, at the gemm cell's geometry (4096**3) and on the layouts of
other schedules:

* **the route is the layout's** — packs where A's and B's base pointers,
  pitches and block widths are in 16-byte packs; off them, words in f32
  and elements in bf16;
* **one shared-memory count** — two buffers, 66,560 bytes in f32 and
  50,176 in bf16, two CTAs an SM within the card's 228 KiB;
* **accepts admits K3 on the cell** in f32 and bf16, at depth 2, and
  runs K3, not R3, there.

The card's checks (K3 against its plain version on each route, in bf16
in and out; R3 to K3's bits) are in ``tests/test_torch_cuda.py``.
"""

import pytest
import torch

import repro_torch
from repro_torch.core import compiler, hopper, lowering
from repro_torch.core.lowering import Schedule
from repro_torch.kernels import gemm

CELL = 4096      # chip_smoke.py's gemm cell: 4096**3


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


@pytest.mark.parametrize("dtype, lanes, tk, pitch, route", [
    (torch.float32, 128, 384, 1152, "packs"),
    (torch.bfloat16, 128, 384, 1152, "packs"),
    (torch.float32, 8, 24, 1104, "packs"),            # tk under the chunk
    (torch.float32, 130, 390, 1170, "words"),         # A's pitch 1170
    (torch.bfloat16, 130, 390, 1170, "elements"),
    (torch.float32, 131, 393, 1179, "words"),         # an odd pitch
    (torch.bfloat16, 126, 378, 1134, "elements"),
    (torch.bfloat16, 131, 393, 1179, "elements"),     # an odd pitch
], ids=str)
def test_contract_gemm_route_is_the_layouts(dtype, lanes, tk, pitch, route):
    a = torch.zeros(300, 1100, dtype=dtype)
    b = torch.zeros(1100, 260, dtype=dtype)
    call = lowering.prepare_call(compiler.gemm_nest(300, 260, 1100),
                                 gemm.DOT, {"A": a, "B": b},
                                 schedule=Schedule(lanes=lanes))
    geo = call.kernel.geometry
    assert not call.kernel.pipelined and geo.contraction_steps > 1
    assert geo.ins[0].block[1] == tk and call.layouts[0].shape[1] == pitch
    assert hopper.contract_gemm_route(geo, call.layouts) == route


def test_contract_gemm_route_follows_base_pointers():
    """A view starting off a 16-byte boundary loses the packs: f32 then
    moves by words, bf16 by elements."""
    call = lowering.prepare_call(compiler.gemm_nest(256, 256, 256),
                                 gemm.DOT, {"A": torch.zeros(256, 256),
                                            "B": torch.zeros(256, 256)})
    geo, (la, lb) = call.kernel.geometry, call.layouts
    assert hopper.contract_gemm_route(geo, (la, lb)) == "packs"
    off = torch.zeros(lb.numel() + 1)[1:].view(lb.shape)
    assert hopper.contract_gemm_route(geo, (la, off)) == "words"
    la16, lb16 = la.bfloat16(), lb.bfloat16()
    assert hopper.contract_gemm_route(geo, (la16, lb16)) == "packs"
    off16 = torch.zeros(lb16.numel() + 1,
                        dtype=torch.bfloat16)[1:].view(lb16.shape)
    assert hopper.contract_gemm_route(geo, (la16, off16)) == "elements"


@pytest.mark.parametrize("dtype, smem", [(torch.float32, 66560),
                                         (torch.bfloat16, 50176)], ids=str)
def test_contract_gemm_takes_two_buffers_of_32_k(dtype, smem):
    size = 4 if dtype == torch.float32 else 2
    assert hopper.CONTRACT_GEMM_CHUNK_K == 32
    # A: 32 k in f32 on a 132-float pitch; B: 32 rows of 128 elements
    assert smem == 2 * (32 * 132 * 4 + 32 * 128 * size)
    assert hopper.contract_gemm_smem_bytes(dtype) == smem
    # two CTAs an SM fit beside the card's reserve, and opt in above 48 KB
    assert 2 * (smem + hopper.SMEM_CTA_RESERVED) <= hopper.SMEM_SM_BYTES
    assert smem <= hopper.SMEM_OPTIN_BYTES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_accepts_admits_k3_on_the_gemm_cell(dtype):
    a = torch.empty(CELL, CELL, dtype=dtype)
    call = lowering.prepare_call(compiler.gemm_nest(CELL, CELL, CELL),
                                 gemm.DOT, {"A": a, "B": a})
    kern = call.kernel
    assert not kern.pipelined and kern.device_key == ("nest", "dot")
    assert kern.device_kernel() is hopper.contract_gemm
    assert kern.geometry.grid == (16, 8, 8)
    assert kern.geometry.ins[0].block == (256, 512)
    assert hopper.accepts(kern.device_key, kern.geometry, dtype, "cpu",
                          **kern.device_args()) == (True, "ok")
    assert hopper.contract_gemm_route(kern.geometry, call.layouts) == "packs"
