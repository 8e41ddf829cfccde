"""The port stands alone: no JAX, no ``repro``, no silent CPU path."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import agu, compiler, hopper, lowering
from repro_torch.core.ssr import BlockStream, KernelBody, LoweringError
from repro_torch.core.stream import Direction
from repro_torch.kernels import chained, frontend, ops, reduction, relu

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).replace(
        ".__init__", "")
    for p in PORT.rglob("*.py"))


def test_every_port_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(MODULES) >= 18


@pytest.mark.parametrize(
    "path", [*sorted(PORT.rglob("*.py")), SRC.parent / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(PORT)) if p.is_relative_to(PORT)
    else p.name)
def test_no_source_imports_jax_or_repro(path):
    text = path.read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)",
                     text, flags=re.M)
    assert not bad, bad


def test_csrc_holds_every_kernel():
    names = sorted(p.stem for p in (PORT / "csrc").glob("*.cu"))
    assert names == sorted(hopper.KERNELS)
    # the kernels whose attributes kernel_attributes reads define the
    # entry in their own source
    for name in ("contract_gemm", "ring_contract_gemm", "base_gemm",
                 "ring_reduce_mul", "ring_map_relu", "reduce_mul",
                 "map_relu"):
        src = (PORT / "csrc" / f"{name}.cu").read_text()
        assert f'extern "C" int ssr_{name}_attributes(' in src
    for name, info in hopper.KERNELS.items():
        src = (SRC.parent / info["source"]).read_text()
        assert "Replaces" in src and "Bound on H100" in src
        assert f'extern "C" int ssr_{name}(' in src
        file, line = info["replaces"].split(":")
        assert (SRC.parent / file).is_file() and int(line) > 0


def test_asking_for_cuda_without_it_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU sandbox")
    x = torch.ones(64)
    with pytest.raises(RuntimeError, match="cuda"):
        lowering.ssr_call(compiler.dot_product_nest(64), reduction.MUL,
                          {"A": x, "B": x}, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ops.dot(x, x, ssr=True, device="cuda")
    prev = repro_torch.default_device()
    try:
        repro_torch.set_default_device("cuda")
        with pytest.raises(RuntimeError, match="is_available"):
            ops.relu(x, ssr=True)
    finally:
        repro_torch.set_default_device(prev)
    with pytest.raises(ValueError, match="neither"):
        repro_torch.set_default_device("meta")


def test_bodies_without_a_device_kernel_are_refused_for_the_card():
    call = lowering.prepare_call(compiler.dot_product_nest(64),
                                 lambda a, b: a * b,
                                 {"A": torch.ones(64), "B": torch.ones(64)},
                                 device="cpu")
    with pytest.raises(LoweringError, match="no Hopper kernel"):
        call.kernel.device_kernel()
    tagged = lowering.prepare_call(
        compiler.dot_product_nest(64), KernelBody(lambda a, b: a * b, "mul"),
        {"A": torch.ones(64), "B": torch.ones(64)}, device="cpu")
    assert tagged.kernel.device_kernel() is hopper.reduce_mul
    assert float(tagged.run()) == 64.0


@pytest.mark.parametrize("name", sorted(hopper.KERNELS))
def test_wrappers_refuse_cpu_tensors(name):
    """On the CPU the plain versions run only through SsrKernel and
    MonolithicKernel; a wrapper handed a CPU tensor raises instead of
    computing anything."""
    geo = agu.StreamGeometry(
        grid=(1,), ins=(agu.BlockAGU((8, 128), (0, 0), ((0, 0),)),) * 2,
        out=agu.BlockAGU((8, 128), (0, 0), ((0, 0),)), out_shape=(8, 128))
    t = torch.zeros(8, 128)
    baseline_args = {"base_reduce": (t, t), "base_relu": (t,),
                     "base_gemm": (t, torch.zeros(128, 8)),
                     "base_gemv": (t, torch.zeros(1, 128)),
                     "base_stencil1d": (torch.zeros(1, 138),
                                        torch.zeros(1, 11)),
                     "base_spmv": (t, torch.zeros(8, 128, dtype=torch.int32),
                                   torch.zeros(1, 64)),
                     "base_spmm": (t, torch.zeros(8, 128, dtype=torch.int32),
                                   torch.zeros(64, 8)),
                     "base_scan": (t,)}
    # the stream kernels take a Launch and the prepared arrays
    row = torch.zeros(1, 8)
    stream_args = {"stream_scan": (t,), "stream_fft": (row, row, row, row),
                   "stream_bitonic": (row,)}
    # a ring kernel launches from its sync kernel's wrapper, given a ring
    # (every key of RING_KERNELS maps onto a sync kernel's, and the stream
    # rings onto STREAM_KERNELS'); K17 and R5 take a ChainedKernel's Launch
    # and its two bodies
    rings = {ring: hopper.DEVICE_KERNELS[key].__name__
             for key, ring in hopper.RING_KERNELS.items()
             if key[0] != "chained"}
    assert {("nest", "spmv"), ("nest", "spmm")} <= set(hopper.RING_KERNELS)
    rings["ring_chained_map"] = "chained_map"
    for op, ring in hopper.STREAM_RING_KERNELS.items():
        assert op in hopper.STREAM_KERNELS
        stream_args[ring.__name__] = stream_args[
            hopper.STREAM_KERNELS[op].__name__]
        rings[ring.__name__] = ring.__name__
    assert set(rings) <= set(hopper.KERNELS)
    wrapper = rings.get(name, name)
    n_in = 1 if wrapper in ("map_relu", "ring_stream_scan") else 2
    kw = {"ring": agu.RingProgram((3,) * n_in, (False,) * n_in)} \
        if name in rings else {}
    whole = BlockStream((8, 128), lambda i: (0, 0))
    launch = frontend.Launch(
        grid=(1,), in_streams=(whole, whole),
        out_streams=(BlockStream((8, 128), lambda i: (0, 0),
                                 Direction.WRITE),),
        out_shapes=(frontend.ShapeDtype((8, 128), torch.float32),))
    before = dict(hopper.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if name in baseline_args:
            getattr(hopper, name)(*baseline_args[name])
        elif name in stream_args:
            getattr(hopper, name)(None, *stream_args[name], **kw)
        elif wrapper == "chained_map":
            hopper.chained_map(chained.axpy_block(0.5), relu.RELU, launch,
                               t, t, **kw)
        else:
            getattr(hopper, wrapper)(geo, [t] * n_in, torch.float32, **kw)
    assert hopper.LAUNCHES == before


def test_plain_versions_need_in_range_walks():
    geo = agu.StreamGeometry(
        grid=(2,), ins=(agu.BlockAGU((8, 128), (0, 0), ((1, 0),)),),
        out=agu.BlockAGU((8, 128), (0, 0), ((1, 0),)), out_shape=(16, 128))
    with pytest.raises(ValueError, match="outside the layout"):
        hopper.plain_map(lambda x: x, geo, [torch.zeros(8, 128)],
                         torch.float32)
    out = hopper.plain_map(lambda x: x + 1, geo, [torch.zeros(16, 128)],
                           torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.ones((16, 128)))


def test_build_key_follows_the_sources(tmp_path, monkeypatch):
    path = hopper.library_path("reduce_mul")
    assert path.parent == hopper.BUILD_DIR
    assert path.name.startswith("reduce_mul-") and path.suffix == ".so"
    assert "sm_90a" in " ".join(hopper.NVCC_FLAGS)
    assert "--use_fast_math" not in hopper.NVCC_FLAGS
    # every header a source includes, directly or through another, joins
    # its key: an edited header never loads a library built from the old
    # one, and a header a kernel does not include leaves its key alone
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(hopper.CSRC, csrc)
    monkeypatch.setattr(hopper, "CSRC", csrc)
    keys = {n: hopper.library_path(n) for n in hopper.KERNELS}
    assert keys == {n: hopper.library_path(n) for n in hopper.KERNELS}
    headers = sorted(p.name for p in csrc.glob("*.cuh"))
    assert headers == ["ssr_attention.cuh", "ssr_chain.cuh",
                       "ssr_chained_map.cuh", "ssr_common.cuh", "ssr_dag.cuh",
                       "ssr_gather.cuh", "ssr_gather_ring.cuh", "ssr_gemm.cuh",
                       "ssr_mbarrier.cuh", "ssr_ring.cuh", "ssr_rows.cuh",
                       "ssr_run.cuh", "ssr_scan.cuh", "ssr_stage_ring.cuh",
                       "ssr_stencil1d.cuh", "ssr_stencil2d.cuh"]
    dags = {"dag_layernorm", "dag_softmax_xent", "dag_mlp",
            "ring_dag_layernorm", "ring_dag_softmax_xent", "ring_dag_mlp"}
    rows = {"ring_reduce_mul", "chain_elem", "ring_chain_elem", *dags}
    stage = {"ring_reduce_mul", "ring_map_relu", "ring_contract_gemv",
             "ring_stream_scan"}
    users = {"ssr_attention.cuh": {"rescale_attention",
                                   "ring_rescale_attention"},
             "ssr_stencil1d.cuh": {"halo_stencil1d", "ring_halo_stencil1d"},
             "ssr_stencil2d.cuh": {"halo_stencil2d", "ring_halo_stencil2d"},
             "ssr_chain.cuh": {"chain_elem", "ring_chain_elem"},
             "ssr_chained_map.cuh": {"chained_map", "ring_chained_map"},
             "ssr_common.cuh": set(hopper.KERNELS),
             "ssr_dag.cuh": dags,
             "ssr_gather.cuh": {"gather_spmv", "gather_spmm",
                                "ring_gather_spmv", "ring_gather_spmm"},
             "ssr_gather_ring.cuh": {"ring_gather_spmv", "ring_gather_spmm",
                                     *stage},
             "ssr_gemm.cuh": {"contract_gemm", "ring_contract_gemm",
                              "base_gemm"},
             "ssr_mbarrier.cuh": {"ring_contract_gemm", "ring_gather_spmv",
                                  "ring_gather_spmm", "stream_scan",
                                  "base_scan", *stage},
             "ssr_scan.cuh": {"stream_scan", "ring_stream_scan", "base_scan"},
             "ssr_stage_ring.cuh": stage,
             "ssr_ring.cuh": {n for n in hopper.KERNELS
                              if n.startswith("ring_")}
             | {"contract_gemm", "rescale_attention"},
             "ssr_rows.cuh": {n for n in hopper.KERNELS if n in rows},
             "ssr_run.cuh": {"reduce_mul", "map_relu"}}
    for header in headers:
        with open(csrc / header, "a") as f:
            f.write("\n// edited\n")
        moved = {n: hopper.library_path(n) for n in hopper.KERNELS}
        assert {n for n in keys if moved[n] != keys[n]} == users[header], \
            header
        keys = moved
    with open(csrc / "dag_mlp.cu", "a") as f:
        f.write("\n// edited\n")
    moved = {n: hopper.library_path(n) for n in hopper.KERNELS}
    assert [n for n in keys if moved[n] != keys[n]] == ["dag_mlp"]


def test_every_stage_kernel_instantiation_is_listed():
    """(mode, ops) keys of the fused kernels: a tuple of stage ops for a
    fused call, the single op for an unfused stage."""
    keys = {k for k, v in hopper.DEVICE_KERNELS.items()
            if v.__name__ in ("chain_elem", "dag_layernorm",
                              "dag_softmax_xent", "dag_mlp")}
    assert ("reduce", ("sq_diff", "identity")) in keys
    assert ("reduce", ("axpy", "mul")) in keys
    assert {("map", "sq_diff"), ("map", "axpy"),
            ("reduce", "identity")} <= keys
    for ops, final in ((("ln_centre", "ln_square", "ln_normalise"), "map"),
                       (("sx_shift", "sx_exp", "sx_loss"), "reduce"),
                       (("mlp_hidden", "mlp_out", "mlp_residual"), "map")):
        assert (final, ops) in keys and (final, ops[1:]) in keys
        assert {("map", ops[0]), ("map", ops[1]), (final, ops[2])} <= keys
    assert hopper.DEVICE_KERNELS[("reduce", "mul")] is hopper.reduce_mul
    assert hopper.DEVICE_KERNELS[("nest", "matvec_relu")].__name__ == \
        "contract_gemv_relu"


@pytest.mark.parametrize("op, args", [
    ("stencil1d", ((1010,), (11,))),
    ("stencil2d", ((30, 40), (11,), (11,))),
    ("stencil1d_relu", ((1010,), (11,))),
    ("flash_attention", ((2, 16, 8), (2, 16, 8), (2, 16, 8))),
], ids=["stencil1d", "stencil2d", "stencil1d_relu", "flash_attention"])
def test_new_entry_points_never_run_plain_for_the_card(op, args):
    """Asked for the card without one, the halo and attention entry points
    raise; on the CPU they run the plain versions."""
    tensors = [torch.ones(s) for s in args]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU sandbox")
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(ops, op)(*tensors, ssr=True, device="cuda")
    out = getattr(ops, op)(*tensors, ssr=True, device="cpu")
    assert out.device.type == "cpu" and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("op", ["spmv", "sparse_gemv", "spmm"])
def test_sparse_entry_points_never_run_plain_for_the_card(op):
    """Asked for the card without one, the sparse entry points raise
    before packing anything; on the CPU they run the plain versions."""
    from repro_torch.kernels import sparse
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks a machine "
                    "without one")
    csr = sparse.hpcg_operator(3, 3, 3)
    x = torch.ones(27) if op != "spmm" else torch.ones(27, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(ops, op)(*csr, x, ssr=True, device="cuda")
    out = getattr(ops, op)(*csr, x, ssr=True, device="cpu")
    assert out.device.type == "cpu" and bool(torch.isfinite(out).all())
    # the operator's rows sum to 26 − (neighbours): the corner row has 7
    assert float(out.reshape(27, -1)[0, 0]) == 26.0 - 7.0
