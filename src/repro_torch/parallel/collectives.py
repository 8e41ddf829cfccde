"""Collectives over a mesh's axes, and the collective-overlap matmuls.

Explicit SPMD: every rank runs the same program on its own tensors and
calls these where the reference's ``shard_map`` bodies call ``psum``,
``all_gather`` or ``ppermute``.  Each takes the :class:`~repro_torch.launch
.mesh.Mesh` and the axes it spans; the ranks that differ only along those
axes take part.

* Transport.  On a ``gloo`` group a CUDA tensor goes through the host and
  back (gloo moves CPU tensors; ranks that share one card use gloo): the
  choice follows the group's backend, never a failure.  A bf16 tensor
  moves as its 16 bits (viewed as f16, a type every backend moves).
* Record.  Where ``mesh.comm_log`` is a list, each call appends ``{"op",
  "bytes", "group", "traffic", "s"}``, the traffic by the ring model of
  ``launch/hlo_analysis.py`` (:func:`~repro_torch.launch.hlo_analysis
  .ring_traffic`) and ``s`` the call's wall seconds (the device
  synchronised before and after; only while recording).  On a *dry* mesh
  recording is all a call does: it returns a tensor of the shape it would
  return (the dry run, ``launch/dryrun.py``).
* Gradients.  Downstream of a replicated value, ranks along ``model``
  compute the same thing (the port shards dense state over ``model``, not
  its products), and ranks along the data-parallel axes compute on
  different rows.  So a rank's cotangent of a value replicated over
  ``model`` is the whole cotangent, and of one replicated over a dp axis
  is its rows' share (the train step averages gradients over the dp
  axes).  Hence the adjoints of the autograd functions below:
  :func:`psum_replicated` sums its cotangent over the dp axes it spans
  only; :func:`enter_model` (the identity) sums its cotangent over
  ``model`` (the ranks along it hold different experts' parts);
  :func:`gather_rows` sums over its axes and keeps this rank's rows;
  :func:`pmean` is its own adjoint.

The matmuls are the SSR data-mover idea at cluster scale:
:func:`ring_matmul` multiplies the weight block it holds while the next
block moves around the ring (``batch_isend_irecv``), f32 accumulator;
:func:`reduce_scatter_matmul` is the contraction-parallel partner, a
partial product and one all-reduce.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..launch.hlo_analysis import ring_traffic
from ..launch.mesh import Mesh

_DP_AXES = ("pod", "data")


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@contextlib.contextmanager
def _record(mesh: Mesh, op: str, t: torch.Tensor, n: int):
    """Times and logs the collective run inside (see the module
    docstring)."""
    if mesh.comm_log is None:
        yield
        return
    cuda = t.is_cuda and not mesh.dry
    if cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(t.device)
    nbytes = t.numel() * t.element_size()
    mesh.comm_log.append({"op": op, "bytes": nbytes, "group": n,
                          "traffic": ring_traffic(op, nbytes, n),
                          "s": time.perf_counter() - t0})


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's backend moves it: contiguous, on the host for
    gloo, a bf16 tensor's bits as f16 (moved, never computed on)."""
    if dist.get_backend(group) == "gloo" and t.is_cuda:
        t = t.cpu()
    t = t.contiguous()
    return t.view(torch.float16) if t.dtype == torch.bfloat16 else t


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def all_reduce(x: torch.Tensor, mesh: Mesh, axes, op: str = "sum"
               ) -> torch.Tensor:
    """A new tensor: ``x`` reduced (``"sum"`` or ``"max"``) over ``axes``."""
    axes = _axes(axes)
    n = mesh.axes_size(axes)
    if n == 1:
        return x.clone()
    if x.dtype == torch.bfloat16:
        raise TypeError("all_reduce sums in the tensor's dtype; reduce a "
                        "bf16 tensor in f32")
    with _record(mesh, "all-reduce", x, n):
        if mesh.dry:
            return x.clone()
        group = mesh.group(axes)
        buf = (x.cpu() if dist.get_backend(group) == "gloo" and x.is_cuda
               else x.clone()).contiguous()
        dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op], group=group)
        return buf.to(x.device)


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int = 0
               ) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim`` in the order of their flat
    index over ``axes`` (the first axis major)."""
    axes = _axes(axes)
    n = mesh.axes_size(axes)
    if n == 1:
        return x
    with _record(mesh, "all-gather", x, n):
        if mesh.dry:
            shape = list(x.shape)
            shape[dim] *= n
            return x.new_empty(shape)
        group = mesh.group(axes)
        w = _wire(x, group)
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=group)
        order = [mesh.index(axes, r - mesh.offset)
                 for r in dist.get_process_group_ranks(group)]
        parts = [p for _, p in sorted(zip(order, parts),
                                      key=lambda z: z[0])]
        return _unwire(torch.cat(parts, dim=dim), x)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's block of the sum over ``axes``: ``x`` split along
    ``dim`` in the ranks' flat-index order over ``axes``, each block
    summed onto the rank it belongs to (one reduce a block: each rank
    sends (n − 1)/n of ``x`` and receives its block's n − 1 parts, where
    an all-reduce moves twice that)."""
    axes = _axes(axes)
    n = mesh.axes_size(axes)
    if n == 1:
        return x.clone()
    if x.dtype == torch.bfloat16:
        raise TypeError("reduce_scatter sums in the tensor's dtype; reduce "
                        "a bf16 tensor in f32")
    with _record(mesh, "reduce-scatter", x, n):
        blocks = x.chunk(n, dim=dim)
        if mesh.dry:
            return blocks[mesh.index(axes)].clone()
        group = mesh.group(axes)
        host = dist.get_backend(group) == "gloo" and x.is_cuda
        mine = None
        for j, r in enumerate(mesh.members(axes)):
            buf = (blocks[j].cpu() if host else blocks[j].clone()
                   ).contiguous()
            dist.reduce(buf, dst=r, op=dist.ReduceOp.SUM, group=group)
            if j == mesh.index(axes):
                mine = buf.to(x.device)
        return mine


def gather_to(x: torch.Tensor, mesh: Mesh, axes, root: int = 0):
    """On mesh rank ``root``: ``[(mesh rank, its x on the host)]`` of every
    rank that differs from it only along ``axes``; on those ranks
    ``None``.  Only
    the ranks of ``root``'s group call it (``root`` receives; nothing is
    sent to the others, as an all-gather would)."""
    axes = _axes(axes)
    n = mesh.axes_size(axes)
    if n == 1:
        return [(mesh.rank, x.cpu())] if mesh.rank == root else None
    with _record(mesh, "gather", x, n):
        group = mesh.group(axes)
        w = _wire(x, group)
        ranks = dist.get_process_group_ranks(group)
        parts = [torch.empty_like(w) for _ in ranks] \
            if mesh.rank == root else None
        dist.gather(w, parts, dst=mesh.offset + root, group=group)
        if parts is None:
            return None
        host = x.new_empty((), device="cpu")
        return [(r - mesh.offset, _unwire(p, host))
                for r, p in zip(ranks, parts)]


def _shift(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The tensor of the next rank along ``axis``: each rank sends its
    ``t`` to the previous one (the reference's ``perm = (i, i − 1)``)."""
    n = mesh.shape[axis]
    with _record(mesh, "collective-permute", t, n):
        if mesh.dry:
            return torch.empty_like(t)
        group = mesh.group((axis,))
        ring = mesh.members((axis,))
        me = mesh.coords[axis]
        w = _wire(t, group)
        got = torch.empty_like(w)
        ops = [dist.P2POp(dist.isend, w, ring[(me - 1) % n], group),
               dist.P2POp(dist.irecv, got, ring[(me + 1) % n], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return _unwire(got, t)


# ---------------------------------------------------------------------------
# differentiable collectives (the adjoints of the module docstring)
# ---------------------------------------------------------------------------


def _dp_part(axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in axes if a in _DP_AXES)


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        dp = _dp_part(ctx.axes)
        return (all_reduce(g, ctx.mesh, dp) if dp else g), None, None


def psum_replicated(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Sum over ``axes`` (f32); the result is replicated over them, and
    its cotangent is summed over the dp axes among them only."""
    return _PsumReplicated.apply(x, mesh, _axes(axes))


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.mesh.shape.get("model", 1) == 1:
            return g, None
        return all_reduce(g.float(), ctx.mesh, ("model",)).to(g.dtype), None


def enter_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The identity; its cotangent is summed over ``model`` (where ranks
    along ``model`` each compute a part, the experts they hold, from one
    replicated value)."""
    return _EnterModel.apply(x, mesh)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.rows = mesh, axes, x.shape[0]
        return all_gather(x, mesh, axes, dim=0)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g.float(), ctx.mesh, ctx.axes).to(g.dtype)
        i = ctx.mesh.index(ctx.axes)
        return total[i * ctx.rows:(i + 1) * ctx.rows], None, None


def gather_rows(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """All ranks' rows along ``axes`` (dim 0, flat-index order); the
    cotangent is summed over them and this rank's rows kept."""
    axes = _axes(axes)
    if mesh.axes_size(axes) == 1:
        return x
    return _GatherRows.apply(x, mesh, axes)


def _mean(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    n = torch.full((), mesh.axes_size(axes), dtype=x.dtype, device=x.device)
    return all_reduce(x, mesh, axes) / n


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _mean(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _mean(g, ctx.mesh, ctx.axes), None, None


def pmean(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The mean over ``axes``; its own adjoint."""
    axes = _axes(axes)
    if mesh.axes_size(axes) == 1:
        return x
    return _Pmean.apply(x, mesh, axes)


# ---------------------------------------------------------------------------
# the collective-overlap matmuls
# ---------------------------------------------------------------------------


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    from ..models.layers import dot_f32
    return dot_f32(a, b)


def _ring_forward(x, w, mesh: Mesh, axis: str) -> torch.Tensor:
    """x (b, D) @ concat_j w_j, the blocks moving around the ring."""
    n = mesh.shape[axis]
    me = mesh.coords[axis]
    blk = w.shape[0]
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    w_cur = w
    for t in range(n):
        j = (me + t) % n                       # block id currently held
        acc = acc + _dot_f32(x[:, j * blk:(j + 1) * blk], w_cur)
        if t + 1 < n:                          # stream the next block in
            w_cur = _shift(w_cur, mesh, axis)
    return acc


class _RingMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mesh, axis, rows_differ):
        ctx.save_for_backward(x, w)
        ctx.mesh, ctx.axis, ctx.rows_differ = mesh, axis, rows_differ
        return _ring_forward(x, w, mesh, axis).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        n, me, blk = mesh.shape[axis], mesh.coords[axis], w.shape[0]
        gf = g.float()
        # dx = g @ W^T, W's blocks around the ring again
        dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        w_cur = w
        for t in range(n):
            j = (me + t) % n
            dx[:, j * blk:(j + 1) * blk] = _dot_f32(gf, w_cur.float().T)
            if t + 1 < n:
                w_cur = _shift(w_cur, mesh, axis)
        xf = x.float()

        def part(j):
            return _dot_f32(xf[:, j * blk:(j + 1) * blk].T, gf)

        if ctx.rows_differ:
            # dW_j sums every rank's rows: the accumulator for block j
            # visits ranks j + n − 1, ..., j (the reduce-scatter ring)
            acc = part((me + 1) % n)
            for t in range(1, n):
                acc = _shift(acc, mesh, axis) + part((me + t + 1) % n)
            dw = acc
        else:
            dw = part(me)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def ring_matmul(x: torch.Tensor, w: torch.Tensor, mesh: Mesh, *,
                axis: str = "data",
                batch_axes: Optional[tuple] = None) -> torch.Tensor:
    """y = x @ W with W row-sharded over ``axis`` and streamed by the ring.

    ``x`` (b, D) is this rank's rows (sharded over ``batch_axes``, or all
    of them), ``w`` (D/n, F) this rank's block of W; returns this rank's
    rows of y.  The gradient of ``w`` sums the rows of the ranks along
    ``axis`` when ``axis`` is one of ``batch_axes`` (their rows differ),
    else this rank's own (replicas); sums over other batch axes are the
    caller's (the train step's mean over the dp axes).
    """
    n = mesh.shape[axis]
    if w.shape[0] * n != x.shape[1]:
        raise ValueError(f"contraction dim {x.shape[1]} is not the ring's "
                         f"{n} blocks of {w.shape[0]}")
    return _RingMatmul.apply(x, w, mesh, axis,
                             axis in _axes(batch_axes or ()))


def reduce_scatter_matmul(x: torch.Tensor, w: torch.Tensor, mesh: Mesh, *,
                          axis: str = "model",
                          batch_axes: Optional[tuple] = None
                          ) -> torch.Tensor:
    """y = x @ W with x col-sharded and W row-sharded over ``axis`` (the
    TP down-projection): this rank's partial product, then one all-reduce
    over ``axis``.  ``x`` (b, D/n) and ``w`` (D/n, F) are this rank's
    parts; returns this rank's rows of y, replicated over ``axis``."""
    del batch_axes  # x's rows are this rank's, whatever shards them
    part = _dot_f32(x, w)
    return psum_replicated(part, mesh, (axis,)).to(x.dtype)
