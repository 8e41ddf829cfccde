"""Trip-count-aware HLO analysis: FLOPs, memory traffic, collective bytes.

The port's own copy of the reference's parser (standard library only): it
reads HLO text, which the port does not make — the reference's compiled
programs, or any XLA dump — and gives the same :class:`Analysis`:

* builds the computation graph (entry, fusions, while bodies/conditions),
* extracts while trip counts from the loop-condition constants,
* accumulates per-device dot FLOPs (2 · |out| · contraction), elementwise
  FLOPs (1 · |out| for arithmetic ops), output bytes (an HBM-traffic proxy),
  and per-collective link traffic with ring-model factors
  (:func:`ring_traffic`):

    all-gather: (n−1)/n · |out|      reduce-scatter: (n−1)/n · |in|
    all-reduce: 2(n−1)/n · |buf|     all-to-all:     (n−1)/n · |buf|
    collective-permute: |buf|

  where n is the participant-group size parsed from ``replica_groups``.

The port's dry run (``launch/dryrun.py``) prices its own collective calls
with the same ring factors.  The audits keep the reference's names here:
``LocalityCheck``, ``check_cluster_locality``, ``FusionCheck``,
``check_fusion``, ``DagFusionCheck`` and ``check_dag_fusion`` are
``launch/audit.py``'s, which audit a program by running it (PyTorch lowers
no HLO); they are imported from there when first read.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "f8e4m3b11fnuz": 1, "f8e4m3": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
    "token": 0, "opaque": 0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\](?:\{[^}]*\})?")
_ELEMENTWISE = (
    "add(", "subtract(", "multiply(", "divide(", "maximum(", "minimum(",
    "exponential(", "tanh(", "rsqrt(", "sqrt(", "log(", "power(", "negate(",
    "logistic(", "cosine(", "sine(", "select(", "compare(", "and(", "or(",
)
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def ring_traffic(op: str, nbytes: float, n: int) -> float:
    """Per-device link traffic of one collective of ``nbytes`` (its output
    for an all-gather, its buffer otherwise) over ``n`` participants."""
    if op == "all-reduce":
        return 2.0 * nbytes * (n - 1) / max(n, 1)
    if op == "collective-permute":
        return float(nbytes)
    return nbytes * (n - 1) / max(n, 1)


def _shape_bytes_elems(text: str) -> Tuple[int, int]:
    """Total (bytes, elements) across all array shapes in a type string."""
    total_b = 0
    total_e = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        if dtype not in _DTYPE_BYTES:
            continue
        elems = 1
        if dims:
            elems = math.prod(int(d) for d in dims.split(","))
        total_e += elems
        total_b += elems * _DTYPE_BYTES[dtype]
    return total_b, total_e


@dataclasses.dataclass
class OpLine:
    name: str
    kind: str
    result_type: str
    line: str


@dataclasses.dataclass
class Computation:
    name: str
    ops: List[OpLine]


@dataclasses.dataclass
class Analysis:
    flops: float = 0.0
    dot_flops: float = 0.0
    bytes_out: float = 0.0          # Σ output bytes (HBM-traffic proxy)
    collective_bytes: float = 0.0   # per-device link traffic, ring model
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_detail: List[Dict] = dataclasses.field(default_factory=list)
    while_trips: List[int] = dataclasses.field(default_factory=list)

    def add(self, other: "Analysis", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.dot_flops += other.dot_flops * mult
        self.bytes_out += other.bytes_out * mult
        self.collective_bytes += other.collective_bytes * mult
        for k, v in other.collective_counts.items():
            self.collective_counts[k] = self.collective_counts.get(k, 0) \
                + int(v * mult)


_COMP_HEADER = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*\(.*\)\s*->.*\{")
_OP_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w\.\-]+)\s*=\s*(.+?)\s+([\w\-]+)\(")


def parse_computations(hlo: str) -> Tuple[Dict[str, Computation], str]:
    comps: Dict[str, Computation] = {}
    entry: Optional[str] = None
    cur: Optional[Computation] = None
    for raw in hlo.splitlines():
        line = raw.rstrip()
        m = _COMP_HEADER.match(line.strip())
        if m and line.strip().endswith("{"):
            cur = Computation(name=m.group(1), ops=[])
            comps[cur.name] = cur
            if line.strip().startswith("ENTRY"):
                entry = cur.name
            continue
        if line.strip() == "}":
            cur = None
            continue
        if cur is None:
            continue
        om = _OP_RE.match(line)
        if om:
            name, rtype, kind = om.groups()
            cur.ops.append(OpLine(name=name, kind=kind, result_type=rtype,
                                  line=line.strip()))
    if entry is None:  # fall back: computation named main*
        for n in comps:
            if n.startswith("main"):
                entry = n
                break
    return comps, entry or next(iter(comps))


def _attr(line: str, key: str) -> Optional[str]:
    m = re.search(key + r"=%?([\w\.\-]+)", line)
    return m.group(1) if m else None


def _group_size(line: str, world: int) -> int:
    # replica_groups=[G,N]<=[...]  → N participants per group
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]", line)
    if m:
        return int(m.group(2))
    # explicit groups: {{0,1,2,3},{4,5,6,7}}
    m = re.search(r"replica_groups=\{\{([^}]*)\}", line)
    if m:
        return len(m.group(1).split(","))
    return world


def _trip_count(comps: Dict[str, Computation], cond_name: str,
                default: int = 1) -> int:
    """Largest integer constant reachable from the while condition."""
    best = default
    seen = set()
    stack = [cond_name]
    while stack:
        cname = stack.pop()
        if cname in seen or cname not in comps:
            continue
        seen.add(cname)
        for op in comps[cname].ops:
            if op.kind == "constant":
                m = re.search(r"constant\((-?\d+)\)", op.line)
                if m:
                    best = max(best, int(m.group(1)))
            called = _attr(op.line, "calls")
            if called:
                stack.append(called)
    return best


def _dot_flops(op: OpLine, shapes: Dict[str, str]) -> float:
    """2 · |out| · contraction-size.  Contraction from lhs dims.

    Handles both HLO operand spellings: inline-typed
    (``dot(f32[8,64]{1,0} %a, f32[64,64]{1,0} %b)``, jax ≤ 0.4.x) and bare
    names (``dot(%a, %b)``), falling back to the computation's shape table.
    """
    out_b, out_e = _shape_bytes_elems(op.result_type)
    m = re.search(r"\bdot\((.*?)\)", op.line)
    contraction = 1
    if m:
        operands = m.group(1)
        # lhs shape: first inline type if present, else look the name up
        shape_m = _SHAPE_RE.search(operands)
        if shape_m is None:
            name = operands.split(",")[0].strip().lstrip("%")
            lhs_type = shapes.get(name)
            shape_m = _SHAPE_RE.search(lhs_type) if lhs_type else None
        cd = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.line)
        if shape_m and shape_m.group(2) and cd and cd.group(1):
            dims = [int(d) for d in shape_m.group(2).split(",")]
            for i in cd.group(1).split(","):
                i = int(i)
                if i < len(dims):
                    contraction *= dims[i]
    return 2.0 * out_e * contraction


def analyze_computation(comps: Dict[str, Computation], name: str,
                        world: int, _memo: Dict[str, Analysis]) -> Analysis:
    if name in _memo:
        return _memo[name]
    comp = comps.get(name)
    out = Analysis()
    if comp is None:
        _memo[name] = out
        return out
    _memo[name] = out  # break cycles defensively
    shapes = {op.name: op.result_type for op in comp.ops}
    # also record parameter shapes from declaration lines
    for op in comp.ops:
        kind = op.kind
        line = op.line
        ob, oe = _shape_bytes_elems(op.result_type)
        if kind == "dot":
            f = _dot_flops(op, shapes)
            out.flops += f
            out.dot_flops += f
            out.bytes_out += ob
        elif kind == "while":
            body = _attr(line, "body")
            cond = _attr(line, "condition")
            trips = _trip_count(comps, cond, 1) if cond else 1
            out.while_trips.append(trips)
            sub = analyze_computation(comps, body, world, _memo) if body \
                else Analysis()
            out.add(sub, trips)
            if cond:
                out.add(analyze_computation(comps, cond, world, _memo), trips)
        elif kind in ("fusion", "call", "map", "reduce", "reduce-window",
                      "scatter", "sort", "conditional", "custom-call"):
            called = _attr(line, "calls") or _attr(line, "to_apply")
            if called:
                sub = analyze_computation(comps, called, world, _memo)
                # to_apply bodies (reduce etc.) run per element; approximate
                # with |out| applications for reduce-likes, 1 for fusion/call
                mult = 1.0 if kind in ("fusion", "call", "conditional") \
                    else float(oe)
                out.add(sub, mult)
            out.bytes_out += ob
            if kind == "fusion":
                out.flops += oe  # fused elementwise ≈ 1 flop/elem
        elif (kind + "(") in _ELEMENTWISE:
            out.flops += oe
            out.bytes_out += ob
        else:
            out.bytes_out += ob
        # collectives
        for cname in _COLLECTIVES:
            if kind == cname or kind == cname + "-start":
                n = _group_size(line, world)
                traffic = ring_traffic(cname, ob, n)
                out.collective_bytes += traffic
                out.collective_counts[cname] = \
                    out.collective_counts.get(cname, 0) + 1
                out.collective_detail.append(
                    {"op": cname, "bytes": ob, "group": n,
                     "traffic": traffic})
                break
    return out


def analyze_hlo(hlo: str, world: int) -> Analysis:
    comps, entry = parse_computations(hlo)
    return analyze_computation(comps, entry, world, {})


# --------------------------------------------------------------------------
# Cluster locality audit: do per-core intermediates stay core-local?
# --------------------------------------------------------------------------


def collective_counts(hlo: str, world: int = 1) -> Dict[str, int]:
    """Per-op collective counts of a compiled module (trip-count-aware)."""
    return dict(analyze_hlo(hlo, world).collective_counts)


# --------------------------------------------------------------------------
# Fusion audit: is the chained intermediate's HBM buffer actually gone?
# --------------------------------------------------------------------------


def count_materialized(hlo: str, dtype: str, dims: Tuple[int, ...]) -> int:
    """Ops (parameters excluded) whose result materialises ``dtype[dims]``.

    Tuple-typed results (while-loop state etc.) count every matching
    component: a buffer carried through a loop is still a live buffer.
    """
    comps, _ = parse_computations(hlo)
    want = (dtype, ",".join(str(d) for d in dims))
    n = 0
    for comp in comps.values():
        for op in comp.ops:
            if op.kind == "parameter":
                continue
            for dt, ds in _SHAPE_RE.findall(op.result_type):
                if (dt, ds) == want:
                    n += 1
    return n


#: the audits, ``launch/audit.py``'s (read lazily: that module imports
#: the cluster layer, which this parser does not need)
_AUDITS = ("LocalityCheck", "check_cluster_locality", "FusionCheck",
           "check_fusion", "DagFusionCheck", "check_dag_fusion")


def __getattr__(name: str):
    if name in _AUDITS:
        from . import audit
        return getattr(audit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_AUDITS))
