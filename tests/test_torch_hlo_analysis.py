"""The port's HLO parser (``launch/hlo_analysis.py``, standard library
only) against the reference's, on the same texts.

The texts are the reference's own test inputs: programs lowered and
compiled here by ``jax.jit(...).lower(...).compile().as_text()`` (a scan
at three trip counts, nested scans, a matmul, a batched einsum, a scan of
a collective-free body, an elementwise fusion) and hand-written modules
for every collective kind (synchronous and ``-start``, both spellings of
``replica_groups``).  Both parsers must give equal results, field for
field: the computations, the ``Analysis`` (FLOPs, dot FLOPs, bytes,
collective bytes, counts and detail, while trips), ``collective_counts``
and ``count_materialized``; and the ring factors equal the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.launch import hlo_analysis as J

from repro_torch.launch import hlo_analysis as H


def lower_text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _scan(r):
    def f(w, x):
        def body(h, wi):
            return jnp.tanh(h @ wi), None
        h, _ = jax.lax.scan(body, x, w)
        return h.sum()
    return lower_text(f, jnp.ones((r, 64, 64)), jnp.ones((8, 64)))


def _nested():
    def f(x):
        def outer(c, _):
            def inner(ci, _):
                return jnp.tanh(ci @ ci), None
            ci, _ = jax.lax.scan(inner, c, None, length=5)
            return ci, None
        c, _ = jax.lax.scan(outer, x, None, length=4)
        return c.sum()
    return lower_text(f, jnp.ones((32, 32)))


_COLLECTIVE = """
HloModule m

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

ENTRY %main (p: f32[64]) -> f32[64] {
  %p = f32[64]{0} parameter(0)
  %ar = f32[64]{0} all-reduce(%p), replica_groups=[1,4]<=[4], to_apply=%add
  %ag = f32[256]{0} all-gather(%ar), replica_groups={{0,1,2,3}}, dimensions={0}
  %rs = f32[16]{0} reduce-scatter(%p), replica_groups=[2,2]<=[4], to_apply=%add
  %aa = f32[64]{0} all-to-all(%p), replica_groups={{0,1},{2,3}}
  %cp = f32[64]{0} collective-permute(%p), source_target_pairs={{0,1},{1,0}}
  %ars = f32[64]{0} all-reduce-start(%p), replica_groups=[1,4]<=[4], to_apply=%add
  %ags = bf16[8,128]{1,0} all-gather-start(%p), replica_groups=[4,2]<=[8]
  ROOT %out = f32[64]{0} add(%ar, %cp)
}
"""

_WHILE = """
HloModule w

%cond (c: (s32[], f32[8])) -> pred[] {
  %c = (s32[], f32[8]) parameter(0)
  %i = s32[] get-tuple-element(%c), index=0
  %n = s32[] constant(12)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

%body (c: (s32[], f32[8])) -> (s32[], f32[8]) {
  %c = (s32[], f32[8]) parameter(0)
  %x = f32[8]{0} get-tuple-element(%c), index=1
  %y = f32[8]{0} all-reduce(%x), replica_groups={{0,1}}, to_apply=%add
  %e = f32[8]{0} exponential(%y)
  ROOT %t = (s32[], f32[8]) tuple(%c, %e)
}

ENTRY %main (x: f32[8]) -> f32[8] {
  %x = f32[8]{0} parameter(0)
  %w = (s32[], f32[8]) while(%x), condition=%cond, body=%body
  ROOT %r = f32[8]{0} get-tuple-element(%w), index=1
}
"""


def _texts():
    yield "scan3", lambda: _scan(3)
    yield "scan7", lambda: _scan(7)
    yield "scan16", lambda: _scan(16)
    yield "nested", _nested
    yield "matmul", lambda: lower_text(lambda a, b: a @ b, jnp.ones((64, 128)),
                                       jnp.ones((128, 256)))
    yield "einsum", lambda: lower_text(
        lambda a, b: jnp.einsum("bij,bjk->bik", a, b), jnp.ones((4, 32, 64)),
        jnp.ones((4, 64, 16)))
    yield "fusion", lambda: lower_text(
        lambda x: jnp.exp(jnp.tanh(x) * 2.0 + 1.0).sum(axis=0),
        jnp.ones((128, 64)))
    yield "collectives", lambda: _COLLECTIVE
    yield "while", lambda: _WHILE


TEXTS = dict(_texts())


@pytest.fixture(scope="module")
def texts():
    return {k: make() for k, make in TEXTS.items()}


@pytest.mark.parametrize("name", sorted(TEXTS))
@pytest.mark.parametrize("world", [1, 4, 8])
def test_the_analysis_is_the_references(texts, name, world):
    hlo = texts[name]
    want = J.analyze_hlo(hlo, world)
    got = H.analyze_hlo(hlo, world)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert H.collective_counts(hlo, world) == J.collective_counts(hlo, world)
    jc, je = J.parse_computations(hlo)
    pc, pe = H.parse_computations(hlo)
    assert pe == je
    assert {k: [dataclasses.asdict(o) for o in c.ops] for k, c in pc.items()} \
        == {k: [dataclasses.asdict(o) for o in c.ops] for k, c in jc.items()}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_materialisation_counts_are_the_references(texts, name):
    hlo = texts[name]
    for dtype, dims in (("f32", (8, 64)), ("f32", (64,)), ("f32", (8,)),
                        ("f32", (64, 64)), ("bf16", (8, 128)),
                        ("f32", (4, 32, 16))):
        assert H.count_materialized(hlo, dtype, dims) == \
            J.count_materialized(hlo, dtype, dims)


def test_the_trip_counts_and_flops_scale_as_the_references(texts):
    for r in (3, 7, 16):
        an = H.analyze_hlo(texts[f"scan{r}"], world=1)
        assert an.dot_flops == pytest.approx(r * 2 * 8 * 64 * 64, rel=0.01)
        assert r in an.while_trips
    an = H.analyze_hlo(texts["nested"], world=1)
    assert an.dot_flops == pytest.approx(4 * 5 * 2 * 32 ** 3, rel=0.01)
    an = H.analyze_hlo(texts["while"], world=2)
    assert an.while_trips == [12]
    assert an.collective_counts == {"all-reduce": 12}


def test_the_ring_factors_are_the_references():
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
        for n in (1, 2, 4, 16):
            hlo = f"""
HloModule m

ENTRY %main (p: f32[64]) -> f32[64] {{
  %p = f32[64]{{0}} parameter(0)
  ROOT %c = f32[64]{{0}} {op}(%p), replica_groups=[1,{n}]<=[{n}]
}}
"""
            want = J.analyze_hlo(hlo, n).collective_bytes
            assert H.ring_traffic(op, 256, n) == want
            assert H.analyze_hlo(hlo, n).collective_bytes == want
    for s in ("bf16[128,256]{1,0}", "(f32[8,8]{1,0}, s32[4]{0})",
              "pred[3]", "token[]", "f8e4m3fn[2,2]"):
        assert H._shape_bytes_elems(s) == J._shape_bytes_elems(s)
    for line in ("replica_groups=[2,4]<=[8]",
                 "replica_groups={{0,1,2,3},{4,5,6,7}}", "no groups here"):
        assert H._group_size(line, 8) == J._group_size(line, 8)


def test_the_audits_keep_the_references_names():
    from repro_torch.launch import audit
    for name in ("LocalityCheck", "check_cluster_locality", "FusionCheck",
                 "check_fusion", "DagFusionCheck", "check_dag_fusion"):
        assert getattr(H, name) is getattr(audit, name)
        assert name in dir(H)
