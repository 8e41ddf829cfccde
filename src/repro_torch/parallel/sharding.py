"""Sharding policy: DP / FSDP / TP / EP / SP rules as PartitionSpec trees.

Axes
----
``data``  — batch (DP) and the FSDP shard axis for parameters/optimizer state
``model`` — tensor parallelism (attention heads, FFN hidden, MoE experts=EP,
            long-context cache sequence=SP)
``pod``   — outer data-parallel axis on the multi-pod mesh

The rules are the reference's, leaf for leaf: parameters get explicit
per-leaf rules (FSDP+TP hybrid, ZeRO-3 style: every weight is sharded on
both an FSDP dim and, where it exists, a TP dim); optimizer moments mirror
their parameter's spec; caches use a shape-driven heuristic
(divisibility-checked), which also covers the B=1 long-context cells by
falling back to sequence sharding (SP) when batch cannot split.  A spec is
the port's :class:`PartitionSpec` (``P``), equal to the reference's as a
tuple; trees are walked in ``keypaths`` order.

How the port uses a spec (explicit SPMD, ``launch/steps.py``): a leaf is
stored as its rank's shard (:func:`shard_tree`), and the train step joins
it over its sharded axes before use (:func:`gather_tree`).  A dim sharded
over several axes, ``('model', 'data')``, is cut in the order the spec
names them, the first axis major — the order of the reference's flat rank
in ``models/moe.py``'s 2-D expert parallelism, so each rank stores the
experts it runs.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from .. import keypaths
from ..launch.mesh import Mesh
from ..models.config import ModelConfig  # noqa: F401 - the reference's name
from . import collectives


class PartitionSpec:
    """One entry a dim: ``None`` (replicated), an axis name, or a tuple of
    axis names (sharded over their product, the first major).  Entries are
    normalised as the reference's: a 1-tuple becomes its axis, ``()``
    becomes ``None``.  It iterates, indexes and compares as the tuple of
    its entries, but is not a tuple, so a tree walk (``keypaths``) takes it
    as a leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        self._entries = tuple(norm(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other._entries
        return isinstance(other, tuple) and self._entries == other

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


P = PartitionSpec


def mesh_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def dp_axes(mesh: Mesh):
    """The data-parallel axes ('pod','data') or ('data',)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def dp_size(mesh: Mesh) -> int:
    return int(mesh.axes_size(dp_axes(mesh)))


def model_size(mesh: Mesh) -> int:
    return int(mesh.shape.get("model", 1))


# --- parameter rules -------------------------------------------------------
# map: leaf name -> (spec pattern per dim); DP marks the FSDP axis group,
# "model" the TP axis.  1-D leaves (norms, biases) follow their own rules.

_DP = "__dp__"

_PARAM_RULES = {
    # embeddings / head
    "embed": ("model", _DP),
    "lm_head": (_DP, "model"),
    "frontend_proj": (_DP, "model"),
    # attention
    "wq": (_DP, "model"),
    "wk": (_DP, None),     # GQA: kv heads replicated across TP shards
    "wv": (_DP, None),
    "wo": ("model", _DP),
    # MLA
    "wdq": (_DP, None),
    "wuq": (None, "model"),
    "wdkv": (_DP, None),
    "wkr": (_DP, None),
    "wuk": (None, "model"),
    "wuv": (None, "model"),
    # mlp
    "w_gate": (_DP, "model"),
    "w_up": (_DP, "model"),
    "w_down": ("model", _DP),
    "ffn_up": (_DP, "model"),
    "ffn_down": ("model", _DP),
    # router
    "router": (None, None),
    # mamba
    "w_in": (_DP, "model"),
    "conv_w": (None, "model"),
    "w_xproj": ("model", None),
    "w_dt": (None, "model"),
    "a_log": ("model", None),
    "w_out": ("model", _DP),
    # xlstm
    "w_ifo": ("model", None),
    "w_zifo": (_DP, "model"),
    "r_zifo": (_DP, "model"),
}

_EXPERT_RULES = {  # leaves under an "experts" subtree: dim0 = expert (EP)
    "w_gate": ("model", _DP, None),
    "w_up": ("model", _DP, None),
    "w_down": ("model", None, _DP),
}

_VEC_RULES = {  # 1-D leaves
    "conv_b": ("model",),
    "dt_bias": ("model",),
    "d_skip": ("model",),
    "b_zifo": ("model",),
}


def _resolve(pattern, mesh: Mesh, shape) -> P:
    dp = dp_axes(mesh)
    spec = tuple(dp if x == _DP else x for x in pattern)
    # drop axes that don't divide the dim (e.g. tiny models on big meshes)
    out = []
    for size, axis in zip(shape, spec):
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        keep: list = []
        for a in axes:
            n = mesh.shape[a]
            prod = mesh.axes_size(keep + [a])
            if size % n == 0 and size // n >= 1 and size // prod >= 1 \
                    and size % prod == 0:
                keep.append(a)
        out.append(tuple(keep) if len(keep) > 1
                   else (keep[0] if keep else None))
    return P(*out)


def _names(path) -> list:
    """The dict keys of a key path (the reference's ``DictKey``s)."""
    return [p for p in path if isinstance(p, str)]


def param_spec_tree(shapes: Any, cfg: ModelConfig, mesh: Mesh, *,
                    inference: bool = False):
    """PartitionSpec tree matching the parameter tree ``shapes`` (tensors
    or ``meta`` tensors: only their shapes are read).

    ``inference=True`` stores MoE expert weights sharded over
    ('model', 'data') jointly on the expert dim (weights-stationary 2-D EP
    for decode) when E divides the combined size.
    """

    expert_rules = _EXPERT_RULES
    if inference and cfg.moe is not None:
        combined = mesh.axes_size([a for a in mesh.axis_names
                                   if a in ("model", "data")])
        if cfg.moe.num_experts % combined == 0:
            # 2-D EP: experts spread over (model × data) jointly
            ep2d = tuple(a for a in ("model", "data")
                         if a in mesh.axis_names)
            expert_rules = {
                "w_gate": (ep2d, None, None),
                "w_up": (ep2d, None, None),
                "w_down": (ep2d, None, None),
            }
        elif "data" in mesh.axis_names:
            # D-stationary small-E decode: experts over model, hidden over
            # data — matches _moe_apply_ep_dstat's layout exactly
            expert_rules = {
                "w_gate": ("model", "data", None),
                "w_up": ("model", "data", None),
                "w_down": ("model", "data", None),
            }

    def _inference_2d(core_shape) -> Optional[P]:
        """Weights-stationary decode sharding: shard a feature dim over
        ('model','data') jointly.  Prefers the output dim; falls back to
        the input dim; else replicates."""
        axes = tuple(a for a in ("model", "data") if a in mesh.axis_names)
        size = mesh.axes_size(axes)
        if len(core_shape) != 2 or size <= 1:
            return None
        d_in, d_out = core_shape
        if d_out % size == 0:
            return P(None, axes)
        if d_in % size == 0:
            return P(axes, None)
        if d_out % mesh.shape["model"] == 0 if "model" in mesh.axis_names \
                else False:
            return P(None, "model")
        return P(None, None)

    def rule(path, leaf) -> P:
        names = _names(path)
        name = names[-1] if names else ""
        in_group = bool(names) and names[0] == "groups"
        in_experts = "experts" in names
        shape = tuple(leaf.shape)
        core_shape = shape[1:] if in_group else shape  # strip repeats axis
        if in_experts and name in expert_rules:
            spec = _resolve(expert_rules[name], mesh, core_shape)
        elif inference and len(core_shape) == 2:
            spec = _inference_2d(core_shape)
            if spec is None:
                spec = _resolve((None,) * len(core_shape), mesh, core_shape)
        elif len(core_shape) == 1:
            spec = _resolve(_VEC_RULES.get(name, (None,)), mesh, core_shape)
        elif name in _PARAM_RULES:
            spec = _resolve(_PARAM_RULES[name], mesh, core_shape)
        else:
            spec = _resolve((None,) * len(core_shape), mesh, core_shape)
        if in_group:
            spec = P(None, *spec)
        return spec

    return keypaths.map_with_path(rule, shapes)


# --- activation / cache / batch heuristics ---------------------------------


def batch_spec(cfg: ModelConfig, mesh: Mesh, global_batch: int) -> P:
    """Leading-dim spec for per-example inputs (tokens/labels/embeds)."""
    keep = []
    rem = global_batch
    for a in dp_axes(mesh):
        if rem % mesh.shape[a] == 0:
            keep.append(a)
            rem //= mesh.shape[a]
    return P(tuple(keep) if keep else None)


def heuristic_spec(shape: Sequence[int], mesh: Mesh, *, batch_dim: int = 0,
                   seq_dim: Optional[int] = None) -> P:
    """Greedy: shard batch over dp; then the sequence (or largest) dim over
    'model'; leave the rest replicated.  Used for KV caches and decode state.
    """
    dp = dp_axes(mesh)
    spec: list = [None] * len(shape)
    rem = shape[batch_dim]
    keep = []
    for a in dp:
        if rem % mesh.shape[a] == 0 and rem // mesh.shape[a] >= 1:
            keep.append(a)
            rem //= mesh.shape[a]
    if keep:
        spec[batch_dim] = tuple(keep) if len(keep) > 1 else keep[0]
    unused = [a for a in dp if a not in keep] + ["model"]
    # choose the dim to shard over remaining axes: prefer seq_dim, else max
    cand = seq_dim
    if cand is None or spec[cand] is not None or shape[cand] < 2:
        sizes = [(s, i) for i, s in enumerate(shape)
                 if spec[i] is None and i != batch_dim]
        cand = max(sizes)[1] if sizes else None
    if cand is not None:
        keep2 = []
        rem2 = shape[cand]
        for a in unused:
            if a in mesh.shape and rem2 % mesh.shape[a] == 0 \
                    and rem2 // mesh.shape[a] >= 1:
                keep2.append(a)
                rem2 //= mesh.shape[a]
        if keep2:
            spec[cand] = tuple(keep2) if len(keep2) > 1 else keep2[0]
    return P(*spec)


def cache_spec_tree(cache_shapes: Any, cfg: ModelConfig, mesh: Mesh):
    """Specs for decode caches: batch over dp, sequence over model (SP)."""

    def rule(path, leaf):
        names = _names(path)
        name = names[-1] if names else ""
        core = tuple(leaf.shape)[1:]     # group caches: a leading repeats axis
        seq_dim = None
        if name in ("k", "v"):
            seq_dim = 1  # (B, S, KV, dh)
        elif name == "lat":
            seq_dim = 1  # (B, S, latent)
        spec = heuristic_spec(core, mesh, batch_dim=0, seq_dim=seq_dim)
        return P(None, *spec)

    return keypaths.map_with_path(rule, cache_shapes)


# --- placing leaves by their specs ------------------------------------------


def _dim_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def sharded_axes(spec: P) -> Tuple[str, ...]:
    """Every mesh axis that ``spec`` shards some dim over."""
    return tuple(a for e in spec for a in _dim_axes(e))


def local_shape(shape: Sequence[int], spec: P, mesh: Mesh) -> Tuple[int, ...]:
    """A rank's shard shape of a leaf of ``shape`` under ``spec``."""
    out = list(shape)
    for i, e in enumerate(spec):
        n = mesh.axes_size(_dim_axes(e))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"{n} ways under {spec}")
        out[i] //= n
    return tuple(out)


def _cut_axes(entry, keep: Sequence[str]) -> Tuple[str, ...]:
    """The axes of a spec entry but ``keep``, which must lead it (the
    tensor's dim already is the kept axes' shard)."""
    axes = _dim_axes(entry)
    cut = tuple(a for a in axes if a not in keep)
    if axes[:len(axes) - len(cut)] != tuple(a for a in axes if a in keep):
        raise ValueError(f"cannot keep {tuple(keep)} of {entry}: they do "
                         f"not lead it")
    return cut


def shard(leaf: torch.Tensor, spec: P, mesh: Mesh, *,
          keep: Sequence[str] = ()) -> torch.Tensor:
    """This rank's shard of ``leaf`` (a copy, so the full leaf can go);
    ``leaf`` is full but along ``keep``, where it already is this rank's
    shard."""
    out = leaf
    for i, e in enumerate(spec):
        axes = _cut_axes(e, keep)
        n = mesh.axes_size(axes)
        if n == 1:
            continue
        size = leaf.shape[i] // n
        out = out.narrow(i, mesh.index(axes) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def gather(local: torch.Tensor, spec: P, mesh: Mesh, *,
           keep: Sequence[str] = ()) -> torch.Tensor:
    """The full leaf from this rank's shard, all-gathered over every axis
    of ``spec`` but ``keep`` (a collective on every rank that shares
    them)."""
    out = local
    for i, e in enumerate(spec):
        axes = _cut_axes(e, keep)
        if mesh.axes_size(axes) > 1:
            out = collectives.all_gather(out, mesh, axes, dim=i)
    return out


def collect(local: torch.Tensor, spec: P, mesh: Mesh,
            root: int = 0) -> Optional[torch.Tensor]:
    """The full leaf on mesh rank ``root``'s host (``None`` elsewhere),
    from the shards of the ranks it needs: one of each, those that share
    ``root``'s coordinates along the axes ``spec`` leaves replicated
    (collective among them; the other ranks return at once)."""
    held = sharded_axes(spec)
    mine, theirs = mesh.coords, mesh.coords_of(root)
    if any(mine[a] != theirs[a] for a in mesh.axis_names if a not in held):
        return None
    parts = collectives.gather_to(local, mesh, held, root)
    if parts is None:
        return None
    shape = list(local.shape)
    for i, e in enumerate(spec):
        shape[i] *= mesh.axes_size(_dim_axes(e))
    full = torch.empty(shape, dtype=local.dtype)
    for r, part in parts:
        view = full
        for i, e in enumerate(spec):
            axes = _dim_axes(e)
            if axes:
                view = view.narrow(i, mesh.index(axes, r) * part.shape[i],
                                   part.shape[i])
        view.copy_(part)
    return full


def shard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """This rank's shard of every leaf of ``tree`` (specs: a tree of the
    same structure, e.g. :func:`param_spec_tree`'s)."""
    flat = {keypaths.key(p): s for p, s in keypaths.leaves_with_path(specs)}
    return keypaths.map_with_path(
        lambda path, t: shard(t, flat[keypaths.key(path)], mesh), tree)


def gather_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """The full leaves from this rank's shards (collective)."""
    flat = {keypaths.key(p): s for p, s in keypaths.leaves_with_path(specs)}
    return keypaths.map_with_path(
        lambda path, t: gather(t, flat[keypaths.key(path)], mesh), tree)


class NamedSharding:
    """A leaf's placement on a mesh: its spec and the mesh (the
    reference's ``jax.sharding.NamedSharding``); :meth:`shard` cuts a full
    leaf to this rank's shard."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def shard(self, leaf: torch.Tensor) -> torch.Tensor:
        return shard(leaf, self.spec, self.mesh)


def named(mesh: Mesh, spec_tree):
    return keypaths.map_with_path(lambda _, s: NamedSharding(mesh, s),
                                  spec_tree)
