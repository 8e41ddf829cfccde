"""K4's one wave and its wrapper's memo, on the CPU.

K4 ``contract_gemv`` (``csrc/contract_gemv.cu``) runs one wave of CTAs.
A unit is a GEMV_ROWS-row group of one lowered output block; the units run
output block by output block in grid order and CTA c walks units [c·per,
(c + 1)·per), ``per`` from ``hopper.gemv_split``, a pure function of the
geometry and the SM count.  ``hopper.gemv_walk`` is the
walk the kernel's loops make on that split.  On the CPU:

* **the split** — every output row of every output block is owned by one
  unit of one CTA; a unit reads its block's contraction steps in grid
  order; the 8192 x 8192 gemv cell, odd geometries (rows not a multiple of
  32, one contraction step, many output blocks, a block wider than the
  staged x) and bf16 run in one wave on 132 SMs at ``GEMV_PER_SM``;
* **the memo** — ``_contract`` checks and builds a launch once per key
  (``hopper._launch_key``): every field of the key changes it, the
  second call of a key runs no check and passes the first call's
  arguments, and a new key runs every check again.

The card's checks (K4 = R4 to the bit on odd layouts, every build without
local bytes) are in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

import repro_torch
from repro_torch.core import agu, autotune, compiler, hopper
from repro_torch.core.lowering import Schedule
from repro_torch.kernels import chained, gemv

SMS = 132
DTYPES = [torch.float32, torch.bfloat16]
#: (m, n, schedule): the gemv cell, rows off 32, a contraction of one step,
#: many output blocks, a block wider than K4's staged x, odd lanes
GEOMETRIES = [(8192, 8192, Schedule()), (1000, 1536, Schedule()),
              (33, 4100, Schedule()), (2048, 512, Schedule()),
              (65536, 256, Schedule()), (100, 20000, Schedule(lanes=10240)),
              (300, 5000, Schedule(lanes=130))]


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "schedules"))
    prev = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(prev)


def _geometry(m, n, schedule, dtype=torch.float32, body=gemv.MATVEC):
    """The sync kernel's geometry a schedule builds (no operands)."""
    return autotune._candidate_kernel(compiler.gemv_nest(m, n), schedule,
                                      body, "nest", dtype).geometry


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mns", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def test_every_row_of_every_block_is_owned_once(mns, dtype):
    geo = _geometry(*mns, dtype=dtype)
    per, ctas = hopper.gemv_split(geo, SMS)
    walk = hopper.gemv_walk(geo, per)
    assert len(walk) == ctas and all(1 <= len(run) <= per for run in walk)
    tm = geo.ins[0].block[0]
    owned = {}
    for c, run in enumerate(walk):
        for p, lo, hi, _ in run:
            assert 0 <= lo < hi <= tm and hi - lo <= hopper.GEMV_ROWS
            for r in range(lo, hi):
                assert (p, r) not in owned
                owned[p, r] = c
    blocks = geo.steps // geo.contraction_steps
    assert set(owned) == {(p, r) for p in range(blocks) for r in range(tm)}


@pytest.mark.parametrize("mns", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def test_the_contraction_steps_run_in_grid_order(mns):
    geo = _geometry(*mns)
    per, _ = hopper.gemv_split(geo, SMS)
    z = geo.contraction_steps
    units = [u for run in hopper.gemv_walk(geo, per) for u in run]
    # the units in grid order: output block by output block, rows upward
    assert [(p, lo) for p, lo, _, _ in units] == sorted(
        (p, lo) for p, lo, _, _ in units)
    for p, _, _, steps in units:
        assert steps == tuple(range(p * z, (p + 1) * z))
        # every step of the unit visits output block p
        odo = [agu.grid_steps(geo.grid)[s] for s in steps]
        assert len({tuple(int(v) for v in g[:len(geo.grid)
                                          - len(geo.contraction_axes)])
                    for g in odo}) == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mns", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def test_every_cta_is_in_one_wave(mns, dtype):
    geo = _geometry(*mns, dtype=dtype)
    per, ctas = hopper.gemv_split(geo, SMS)
    assert ctas <= hopper.GEMV_PER_SM * SMS
    groups = -(-geo.ins[0].block[0] // hopper.GEMV_ROWS)
    units = geo.steps // geo.contraction_steps * groups
    assert (ctas - 1) * per < units <= ctas * per
    # a pure function: the same split every time, and per SM count
    assert hopper.gemv_split(geo, SMS) == (per, ctas)
    assert hopper.gemv_split(geo, 2 * SMS)[1] <= \
        2 * hopper.GEMV_PER_SM * SMS


def test_the_gemv_cell_is_one_unit_a_cta():
    """8192 x 8192: 16 output blocks of 512 rows, 16 row groups each —
    256 units, one a CTA, on 264 slots."""
    geo = _geometry(8192, 8192, Schedule())
    assert geo.grid == (16, 16) and geo.ins[0].block == (512, 512)
    assert hopper.gemv_split(geo, SMS) == (1, 256)
    geo16 = _geometry(8192, 8192, Schedule(), dtype=torch.bfloat16)
    assert hopper.gemv_split(geo16, SMS) == (1, 256)


# -- the memo ------------------------------------------------------------------


def _operands(m=64, n=256, dtype=torch.float32, off=0):
    a = torch.randn(m * n + 4, dtype=torch.float32).to(dtype)
    x = torch.randn(n + 4, dtype=torch.float32).to(dtype)
    return a[off:off + m * n].view(m, n), x[off:off + n].view(1, n)


def _key(**change):
    geo = _geometry(64, 256, Schedule())
    a, x = _operands()
    fields = dict(name="contract_gemv", op=("nest", "matvec"), geo=geo,
                  ring=None, program=None, out_dtype=torch.float32,
                  acc_dtype=torch.float32, a=a, b=x)
    fields.update(change)
    fields["layouts"] = (fields.pop("a"), fields.pop("b"))
    return hopper._launch_key(**fields)


def test_every_field_of_the_key_changes_it():
    geo = _geometry(64, 256, Schedule())
    a, x = _operands()
    base = _key(a=a, b=x, geo=geo)
    assert _key(a=a, b=x, geo=geo) == base
    other_geo = _geometry(64, 256, Schedule(lanes=128))
    if other_geo == geo:
        other_geo = dataclasses.replace(geo, out_shape=(1, 512))
    wide = torch.randn(64, 512)[:, :256]          # other strides
    changes = {
        "name": "contract_gemm", "op": ("nest", "matvec_relu"),
        "geo": other_geo, "ring": agu.RingProgram((3, 3), (False, False)),
        "program": "a program", "out_dtype": torch.bfloat16,
        "acc_dtype": torch.bfloat16,
        "a": torch.randn(64, 255), "b": torch.randn(1, 255)}
    for field, value in changes.items():
        assert _key(**{"a": a, "b": x, "geo": geo, field: value}) != base, \
            field
    for which, t in (("a", a), ("b", x)):
        for value in (wide if which == "a" else torch.randn(1, 512)[:, ::2],
                      t.to(torch.bfloat16), t.to("meta"),
                      _operands(off=1)[0 if which == "a" else 1]):
            assert _key(**{"a": a, "b": x, "geo": geo, which: value}) \
                != base, (which, value.shape, value.dtype)


def _recorded(monkeypatch):
    """(checks run, launches) of K4's wrapper with an empty memo, the
    launch recorded instead of made."""
    checked, launched = [], []
    real = hopper._checked

    def spy(*args, **kw):
        checked.append(args[0])
        try:
            return real(*args, **kw)
        except ValueError:           # the CPU is no CUDA device: go on
            return args[2][0].device
    monkeypatch.setattr(hopper, "_checked", spy)
    monkeypatch.setattr(hopper, "_card",
                        lambda dev: SimpleNamespace(multi_processor_count=SMS))
    monkeypatch.setattr(hopper, "_launch",
                        lambda name, dev, *a: launched.append((name, a)))
    monkeypatch.setattr(hopper, "_PREPARED", {})
    return checked, launched


def test_the_second_call_of_a_key_runs_no_check(monkeypatch):
    """The first call of a key runs the checks and builds the arguments,
    the second reuses them; an operand moved off a 16-byte boundary is a
    new key, checked again, and the arguments follow (A's elements
    route)."""
    geo = _geometry(64, 256, Schedule())
    checked, launched = _recorded(monkeypatch)
    a, x = _operands()
    for _ in range(2):
        hopper.contract_gemv(geo, (a, x), torch.float32)
    assert checked == ["contract_gemv"]
    (n1, a1), (n2, a2) = launched
    assert n1 == n2 == "contract_gemv" and a1[3:] == a2[3:]
    assert a1[5:7] == (4, 1)          # vec 4, x in 16-byte packs
    per, _ = hopper.gemv_split(geo, SMS)
    assert a1[-2:] == (per, 0)
    a_off, x_off = _operands(off=1)
    hopper.contract_gemv(geo, (a_off, x_off), torch.float32)
    hopper.contract_gemv_relu(geo, (a, x), torch.float32)
    assert checked == ["contract_gemv"] * 3
    assert launched[2][1][5] == 1 and launched[3][1][-1] == 1
    assert len(hopper._PREPARED) == 3


def test_a_full_memo_is_emptied_before_its_next_key(monkeypatch):
    """At ``_PREPARED_MOST`` keys the memo is emptied before a new key is
    kept, so it stays bounded; a key dropped so is checked again."""
    geo = _geometry(64, 256, Schedule())
    checked, _ = _recorded(monkeypatch)
    monkeypatch.setattr(hopper, "_PREPARED_MOST", 2)
    a, x = _operands()
    a_off, x_off = _operands(off=1)
    hopper.contract_gemv(geo, (a, x), torch.float32)
    hopper.contract_gemv(geo, (a_off, x_off), torch.float32)
    assert len(hopper._PREPARED) == 2
    hopper.contract_gemv_relu(geo, (a, x), torch.float32)
    assert len(hopper._PREPARED) == 1
    hopper.contract_gemv_relu(geo, (a, x), torch.float32)
    assert checked == ["contract_gemv"] * 3
    hopper.contract_gemv(geo, (a, x), torch.float32)
    assert checked == ["contract_gemv"] * 4


def test_a_gemv_relu_key_is_its_own(monkeypatch):
    geo = _geometry(64, 256, Schedule(), body=chained.MATVEC_RELU)
    a, x = _operands()
    plain = _key(a=a, b=x, geo=geo)
    relu = _key(a=a, b=x, geo=geo, op=("nest", "matvec_relu"))
    assert plain != relu
