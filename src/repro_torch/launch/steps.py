"""Step functions: train (gradient-accumulated), prefill, decode.

The reference's steps are its jit roots; the port's are plain functions.
``train_step(params, opt_state, batch) → (params, opt_state, metrics)``
takes the gradient of ``model.loss_fn`` by autograd, microbatch by
microbatch (contiguous chunks of the batch, the gradients accumulated in
``cfg.grad_accum_dtype``, then divided by their count, as the reference's
``lax.scan``), and applies ``optim.adamw.update``, which writes the new
parameters and moments into the tensors given (the reference donates
them to its jitted step).  ``make_sharded_train_step`` is the same step
on one rank of a mesh, its state stored as the rank's shards of
``parallel.sharding.param_spec_tree`` (the reference's ``jit`` with
``in_shardings``).  Prefill and decode run without autograd; the decode
step updates the caches it is given in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from .. import keypaths
from ..models import config as mcfg
from ..models import model as mdl
from ..models import moe as moe_mod
from ..models.layers import META, dtype_of
from ..optim import adamw
from ..parallel import collectives as col
from ..parallel import sharding as shd
from ..parallel.activations import activation_mesh


def _value_and_grad(params, cfg: mcfg.ModelConfig, batch):
    """(loss, the gradient tree) of ``loss_fn`` at ``params``; the
    parameters themselves are not marked for autograd (detached aliases of
    them are)."""
    leaves = keypaths.leaves(params)
    alias = [p.detach().requires_grad_() for p in leaves]
    of = {id(p): a for p, a in zip(leaves, alias)}
    with torch.enable_grad():
        loss, _ = mdl.loss_fn(
            keypaths.map_with_path(lambda _, p: of[id(p)], params), cfg,
            batch)
        grads = torch.autograd.grad(loss, alias, allow_unused=True)
    of = {id(p): torch.zeros_like(p) if g is None else g
          for p, g in zip(leaves, grads)}
    return loss.detach(), keypaths.map_with_path(lambda _, p: of[id(p)],
                                                 params)


def _accumulate(params, cfg: mcfg.ModelConfig, batch, m: int):
    """(loss, gradient tree) over ``m`` microbatches: contiguous chunks of
    the batch, the gradients summed in ``cfg.grad_accum_dtype`` and divided
    by their count, as the reference's ``lax.scan``."""
    if m <= 1:
        return _value_and_grad(params, cfg, batch)
    acc_dt = dtype_of(cfg.grad_accum_dtype)
    rows = next(iter(batch.values())).shape[0]
    if rows % m:
        raise ValueError(f"a batch of {rows} does not split into "
                         f"{m} microbatches")
    split = {k: v.chunk(m) for k, v in batch.items()}
    acc = keypaths.map_with_path(
        lambda _, p: torch.zeros(p.shape, dtype=acc_dt, device=p.device),
        params)
    lsum = torch.zeros((), dtype=torch.float32,
                       device=keypaths.leaves(params)[0].device)
    for i in range(m):
        lv, grads = _value_and_grad(
            params, cfg, {k: v[i] for k, v in split.items()})
        for a, g in zip(keypaths.leaves(acc), keypaths.leaves(grads)):
            a.add_(g.to(acc_dt))
        del grads
        lsum = lsum + lv
    # divisors as tensors: the card divides by a host scalar through its
    # reciprocal, another rounding
    for a in keypaths.leaves(acc):
        a.div_(torch.full((), m, dtype=acc_dt, device=a.device))
    return lsum / torch.full((), m, dtype=torch.float32,
                             device=lsum.device), acc


def make_train_step(cfg: mcfg.ModelConfig, opt_cfg: adamw.AdamWConfig,
                    *, microbatches: Optional[int] = None) -> Callable:
    """(params, opt_state, batch) → (params, opt_state, {"loss",
    "grad_norm", "lr"}); ``params`` and ``opt_state`` are updated in place
    and returned."""
    m = microbatches or cfg.microbatches

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        lv, grads = _accumulate(params, cfg, batch, m)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, {"loss": lv, **om}

    return train_step


# ---------------------------------------------------------------------------
# the sharded train step (explicit SPMD over a mesh)
# ---------------------------------------------------------------------------


def train_specs(cfg: mcfg.ModelConfig, mesh) -> Any:
    """The parameter spec tree of the train state on ``mesh`` (moments
    mirror it, ``count`` is replicated)."""
    return shd.param_spec_tree(mdl.init_params(0, cfg, device=META), cfg,
                               mesh)


def _spec_of(specs) -> Callable:
    flat = {keypaths.key(p): s for p, s in keypaths.leaves_with_path(specs)}
    return lambda path: flat[keypaths.key(path)]


def shard_train_state(state: Dict[str, Any], cfg: mcfg.ModelConfig,
                      mesh) -> Dict[str, Any]:
    """This rank's shard of a full train state: params and both moments cut
    by :func:`train_specs`, ``count`` as it is."""
    spec = _spec_of(train_specs(cfg, mesh))

    def cut(tree):
        return keypaths.map_with_path(
            lambda p, t: shd.shard(t, spec(p), mesh), tree)

    opt = state["opt"]
    return {"params": cut(state["params"]),
            "opt": {"m": cut(opt["m"]), "v": cut(opt["v"]),
                    "count": opt["count"].clone()}}


def gather_train_state(state: Dict[str, Any], cfg: mcfg.ModelConfig,
                       mesh) -> Dict[str, Any]:
    """The full train state from every rank's shards (collective)."""
    spec = _spec_of(train_specs(cfg, mesh))

    def join(tree):
        return keypaths.map_with_path(
            lambda p, t: shd.gather(t, spec(p), mesh), tree)

    opt = state["opt"]
    return {"params": join(state["params"]),
            "opt": {"m": join(opt["m"]), "v": join(opt["v"]),
                    "count": opt["count"].clone()}}


def collect_train_state(state: Dict[str, Any], cfg: mcfg.ModelConfig,
                        mesh, *, root: int = 0) -> Optional[Dict[str, Any]]:
    """The full train state on the host of mesh rank ``root`` (``None`` on
    the others), each leaf gathered to it from one shard of each (only
    ``root`` receives, into host memory): what a sharded run's checkpoint
    writes (collective)."""
    spec = _spec_of(train_specs(cfg, mesh))

    def join(tree):
        return keypaths.map_with_path(
            lambda p, t: shd.collect(t, spec(p), mesh, root), tree)

    opt = state["opt"]
    out = {"params": join(state["params"]),
           "opt": {"m": join(opt["m"]), "v": join(opt["v"]),
                   "count": opt["count"].cpu()}}
    return out if mesh.rank == root else None


def make_sharded_train_step(cfg: mcfg.ModelConfig,
                            opt_cfg: adamw.AdamWConfig, mesh, *,
                            microbatches: Optional[int] = None) -> Callable:
    """The train step of one rank of ``mesh`` (every rank calls it): (its
    params and opt_state shards, the *global* batch) → (the same, updated
    in place, and the metrics, the loss averaged over the dp axes).

    * The rank takes its rows of the batch (split over every dp axis).
    * Each leaf is gathered over its sharded axes before use; expert
      leaves, where the MoE dispatch is expert-parallel, are gathered over
      the dp axes only and stay this rank's ``model`` shard.  Ranks along
      ``model`` compute the same dense products (state is sharded over
      ``model``, the products are not).
    * The gradients (the microbatches accumulated as
      :func:`make_train_step` does) are averaged over the dp axes in f32
      and cut back to the rank's shards; the global norm counts each leaf
      once (the rank at coordinate 0 of every axis the leaf is replicated
      over adds it), and AdamW runs on the shards.
    """
    m = microbatches or cfg.microbatches
    spec = _spec_of(train_specs(cfg, mesh))
    dp = shd.dp_axes(mesh)
    n_dp = mesh.axes_size(dp)
    ep = cfg.moe is not None and moe_mod.expert_parallel(cfg.moe, mesh)

    def keep(path):
        return ("model",) if ep and "experts" in path else ()

    def owner(path) -> bool:
        held = shd.sharded_axes(spec(path))
        return all(c == 0 for a, c in mesh.coords.items() if a not in held)

    def _mean_shard(g, sp, kept):
        """This rank's shard of the mean over the dp axes, in f32: the
        leaf cut along its other axes first, then its dp-sharded dim
        reduce-scattered over them (the dp axes it is replicated over
        all-reduced); a leaf stacked on its repeats axis a layer at a time,
        so one layer's f32 copy is alive at once."""
        entries = [shd._dim_axes(e) for e in sp]
        local = shd.P(*[tuple(a for a in ax if a not in dp)
                        for ax in entries])
        dims = [i for i, ax in enumerate(entries) if set(ax) & set(dp)]
        over = tuple(a for a in dp if a not in
                     sum((entries[i] for i in dims), ()))

        def one(piece):
            piece = shd.shard(piece, local, mesh, keep=kept).float()
            if n_dp == 1:
                return piece
            if over:
                piece = col.all_reduce(piece, mesh, over)
            for i in dims:
                piece = col.reduce_scatter(
                    piece, mesh, tuple(a for a in entries[i] if a in dp),
                    dim=i)
            return piece.div_(torch.full((), n_dp, dtype=torch.float32,
                                         device=piece.device))
        if g.ndim >= 3 and len(sp) and sp[0] is None:
            return torch.cat([one(piece) for piece in g.split(1)])
        return one(g)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        rows = next(iter(batch.values())).shape[0]
        if rows % (n_dp * m):
            raise ValueError(f"a batch of {rows} does not split over {n_dp} "
                             f"data-parallel ranks and {m} microbatches")
        i, r = mesh.index(dp), rows // n_dp
        local = {k: v[i * r:(i + 1) * r] for k, v in batch.items()}
        with activation_mesh(mesh):
            full = keypaths.map_with_path(
                lambda p, t: shd.gather(t, spec(p), mesh, keep=keep(p)),
                params)
            lv, grads = _accumulate(full, cfg, local, m)
        del full
        # each full gradient is averaged, cut to this rank's shard and
        # dropped in turn, so one full f32 leaf is alive at a time
        flat = keypaths.leaves_with_path(grads)
        del grads
        shards, sums = {}, []
        for j, (path, g) in enumerate(flat):
            flat[j] = None
            g = _mean_shard(g, spec(path), keep(path))
            sums.append(torch.sum(torch.square(g)) if owner(path)
                        else torch.zeros((), device=g.device))
            shards[keypaths.key(path)] = g
        grads = keypaths.map_with_path(
            lambda p, _: shards[keypaths.key(p)], params)
        total = col.all_reduce(torch.stack(sums), mesh, mesh.axis_names)
        gnorm = torch.sqrt(sum(total.unbind()))
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             opt_cfg, grad_norm=gnorm)
        if n_dp > 1:
            lv = col.all_reduce(lv, mesh, dp) / torch.full(
                (), n_dp, dtype=torch.float32, device=lv.device)
        return params, opt_state, {"loss": lv, **om}

    return train_step


def make_prefill_step(cfg: mcfg.ModelConfig, *, cache_len: int,
                      batch_chunks: int = 1) -> Callable:
    """(params, batch) → (last-position logits, caches).

    ``batch_chunks > 1`` processes the request batch in sequential chunks,
    which bounds prefill's activations to one chunk's; the chunks' logits
    and caches are joined on the batch axis.
    """

    def one_chunk(params, batch):
        if not cfg.has_decode:  # encoder: plain forward, no cache
            logits, _, _ = mdl.forward(
                params, cfg, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"))
            return logits, ()
        logits, caches, _ = mdl.forward(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), want_cache=True, cache_len=cache_len)
        return logits[:, -1:], caches

    @torch.no_grad()
    def prefill_step(params, batch):
        if batch_chunks <= 1:
            return one_chunk(params, batch)
        rows = next(iter(batch.values())).shape[0]
        if rows % batch_chunks:
            raise ValueError(f"a batch of {rows} does not split into "
                             f"{batch_chunks} chunks")
        split = {k: v.chunk(batch_chunks) for k, v in batch.items()}
        parts = [one_chunk(params, {k: v[i] for k, v in split.items()})
                 for i in range(batch_chunks)]
        logits = torch.cat([lg for lg, _ in parts], dim=0)
        if not cfg.has_decode:
            return logits, ()
        # stacked caches are (repeats, batch, ...): join on axis 1
        caches = [[{name: torch.cat([c[g][e][name] for _, c in parts],
                                    dim=1)
                    for name in parts[0][1][g][e]}
                   for e in range(len(parts[0][1][g]))]
                  for g in range(len(parts[0][1]))]
        return logits, caches

    return prefill_step


def make_decode_step(cfg: mcfg.ModelConfig) -> Callable:
    """(params, caches, tokens (B,1), positions (B,)) → (logits, caches);
    the caches are updated in place."""

    @torch.no_grad()
    def serve_step(params, caches, tokens, positions):
        return mdl.decode_step(params, cfg, tokens, caches, positions)

    return serve_step


def init_train_state(key, cfg: mcfg.ModelConfig,
                     opt_cfg: adamw.AdamWConfig, *,
                     device=None) -> Dict[str, Any]:
    """{"params": drawn from ``key`` (an int seed or a ``torch.Generator``)
    on ``device``, "opt": zero moments and count}."""
    params = mdl.init_params(key, cfg, device=device)
    return {"params": params, "opt": adamw.init(params, opt_cfg)}


def abstract_train_state(cfg: mcfg.ModelConfig,
                         opt_cfg: adamw.AdamWConfig) -> Dict[str, Any]:
    """The train state as ``meta`` tensors (no allocation)."""
    return init_train_state(0, cfg, opt_cfg, device=META)


def abstract_caches(cfg: mcfg.ModelConfig, batch: int, max_len: int, dtype):
    """The decode caches as ``meta`` tensors (no allocation)."""
    return mdl.init_caches(cfg, batch, max_len, dtype, device=META)
