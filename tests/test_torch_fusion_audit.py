"""The port's fusion audits (``launch/audit.py``) on the CPU.

The reference compiles a fused program and its unfused composition and
counts, in their HLO, the buffers of the intermediate's exact padded type
and the output bytes (``tests/test_chained.py``, ``tests/test_dag.py``).
The port runs each program and takes the same census from what ran.  On
the CPU the fused programs run as the plain block walk: their
intermediates are block-sized, so the whole (padded) intermediate never
appears, and the strict byte criterion holds for every registry case.  A
program audited against itself (the unfused composition passed as the
fused one) saves nothing and must not read as eliminated.
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.lowering import DEFAULT_SCHEDULE
from repro_torch.kernels import chained, dag
from repro_torch.launch import audit


@pytest.fixture(autouse=True)
def _cpu():
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


@pytest.mark.parametrize("case", chained.fused_cases(), ids=lambda c: c.name)
def test_fused_case_eliminates_its_intermediate(case):
    args, kwargs = case.example(np.random.default_rng(7))
    dtype, dims = case.inter_type(*args, **kwargs)
    chk = audit.check_fusion(case.fused, case.unfused, args, kwargs,
                             dtype, dims)
    # the unfused composition materialises the padded intermediate
    assert chk.unfused_buffers >= 1
    assert chk.fused_buffers <= chk.unfused_buffers, chk
    assert chk.bytes_saved > 0
    assert chk.intermediate_eliminated
    assert chk.fused_device_ops is None and chk.unfused_device_ops is None


@pytest.mark.parametrize("case", chained.fused_cases()[:2],
                         ids=lambda c: c.name)
def test_an_unfused_program_does_not_read_as_eliminated(case):
    args, kwargs = case.example(np.random.default_rng(7))
    dtype, dims = case.inter_type(*args, **kwargs)
    chk = audit.check_fusion(case.unfused, case.unfused, args, kwargs,
                             dtype, dims)
    assert chk.fused_buffers == chk.unfused_buffers >= 1
    assert chk.bytes_saved == 0
    assert not chk.intermediate_eliminated


def _pinned(case):
    return lambda *a, **k: case.fused(*a, schedule=DEFAULT_SCHEDULE, **k)


@pytest.mark.parametrize("case", dag.dag_cases(), ids=lambda c: c.name)
def test_dag_case_eliminates_its_intermediates(case):
    args, kwargs = case.example(np.random.default_rng(3))
    inters = case.inters(*args, **kwargs)
    chk = audit.check_dag_fusion(_pinned(case), case.unfused, args, kwargs,
                                 inters)
    assert chk.intermediates_eliminated, chk
    assert chk.bytes_saved > 0
    assert chk.fused_buffers <= chk.unfused_buffers
    # two intermediates of one padded shape: one census entry
    assert chk.inters == tuple((d, tuple(s)) for d, s in inters)
    assert len(chk.per_shape) == len(set(chk.inters))


def test_the_dag_control_does_not_read_as_eliminated():
    case = dag.dag_cases()[0]
    args, kwargs = case.example(np.random.default_rng(3))
    chk = audit.check_dag_fusion(case.unfused, case.unfused, args, kwargs,
                                 case.inters(*args, **kwargs))
    assert chk.bytes_saved == 0 and not chk.intermediates_eliminated


def test_census_counts_what_an_op_writes():
    """Views write nothing; each made tensor counts its bytes; the watched
    (dtype, shape) counts each op output of it."""
    x = torch.ones(32, 128)

    def program(x):
        y = x * 2.0                 # 16 KiB, watched
        z = y.view(4096)            # a view: nothing written
        return z.sum()              # 4 bytes

    def fewer(x):
        return (x * 2.0).sum()

    chk = audit.check_fusion(fewer, program, (x,), {}, "f32", (32, 128))
    assert chk.unfused_buffers == chk.fused_buffers == 1
    assert chk.unfused_bytes_out == chk.fused_bytes_out == 32 * 128 * 4 + 4
    assert not chk.intermediate_eliminated
    bf = audit.check_fusion(fewer, program, (x,), {}, "bf16", (32, 128))
    assert bf.unfused_buffers == 0
    with pytest.raises(ValueError, match="unknown HLO dtype"):
        audit.check_fusion(fewer, program, (x,), {}, "float", (32, 128))


@pytest.mark.parametrize("spelling, dtype", [("f32", torch.float32),
                                             ("bf16", torch.bfloat16),
                                             ("s32", torch.int32),
                                             ("pred", torch.bool)])
def test_hlo_spellings(spelling, dtype):
    assert audit.HLO_DTYPES[spelling] is dtype
