"""Device meshes and the ranks that run them.

``make_production_mesh`` describes the reference's target fleet meshes:

* single pod: 16×16 = 256 ranks, axes ``(data, model)``
* multi-pod:  2×16×16 = 512 ranks, axes ``(pod, data, model)`` — ``pod`` is
  the outer data-parallel axis.

A :class:`Mesh` is named axes and their sizes, ranks laid out row-major
(the last axis varies fastest), and, inside a run of ranks, this
process's rank and one ``torch.distributed`` process group for every set
of axes that a collective spans (``parallel/collectives.py``).  Outside a
run it is abstract (no rank): the sharding policy (``parallel/sharding.py``)
and the dry run read only its shape.  A *dry* mesh has a rank but no
groups: collectives record what they would move and return tensors of the
shape they would return, so one rank of a 512-rank mesh runs in one
process (``launch/dryrun.py``).

:func:`run_ranks` starts the ranks: ``world`` processes by the ``spawn``
start method (a parent may already hold a CUDA context), which meet
through a ``FileStore`` in a fresh temporary directory (no TCP port, so
concurrent runs never clash), on the backend the caller names — ``nccl``
where each rank has a card of its own, ``gloo`` on the CPU or where ranks
share a card.  It waits at most ``timeout`` seconds and raises with every
failed rank's traceback.

Functions, not module constants: importing this module starts no process
and touches no device.
"""

from __future__ import annotations

import collections
import datetime
import itertools
import math
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Axes = Tuple[str, ...]


class Mesh:
    """Named axes over ranks; see the module docstring.

    ``shape`` maps each axis to its size in axis order (as
    ``jax.sharding.Mesh.shape``); ``rank`` is this process's global rank
    (``None``: abstract); ``dry`` makes collectives record without moving
    anything.  :meth:`connect` makes the process groups, collectively.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: Optional[int] = None, dry: bool = False):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} does not name its axes "
                             f"{tuple(axis_names)}")
        self.axis_names: Axes = tuple(axis_names)
        self.shape = collections.OrderedDict(
            (a, int(n)) for a, n in zip(self.axis_names, shape))
        self.size = math.prod(self.shape.values())
        if rank is not None and not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside a mesh of {self.size}")
        self.rank = rank
        self.dry = dry
        #: the global rank of this mesh's rank 0 (a mesh may span a part of
        #: the run's ranks: :meth:`connect`)
        self.offset = 0
        self._groups: Dict[frozenset, Any] = {}
        #: the collectives' record (``parallel.collectives``); a list turns
        #: recording on
        self.comm_log: Optional[List[Dict[str, Any]]] = None

    def __repr__(self) -> str:
        where = "abstract" if self.rank is None else f"rank {self.rank}"
        return f"Mesh({describe(self)}, {where}{', dry' if self.dry else ''})"

    # -- coordinates ------------------------------------------------------
    def coords_of(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    @property
    def coords(self) -> Dict[str, int]:
        if self.rank is None:
            raise ValueError("an abstract mesh has no rank")
        return self.coords_of(self.rank)

    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """The rank's flat index over ``axes``, the first axis major (the
        order of a ``PartitionSpec`` entry such as ``('model', 'data')``)."""
        c = self.coords if rank is None else self.coords_of(rank)
        i = 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def members(self, axes: Sequence[str]) -> List[int]:
        """The global ranks that differ from this one only along ``axes``,
        in the order of their flat index over ``axes``."""
        fixed = {a: v for a, v in self.coords.items() if a not in axes}
        ranks = [r for r in range(self.size)
                 if all(self.coords_of(r)[a] == v for a, v in fixed.items())]
        return [self.offset + r
                for r in sorted(ranks, key=lambda r: self.index(axes, r))]

    # -- process groups ---------------------------------------------------
    def connect(self, offset: int = 0) -> "Mesh":
        """Make a process group for every non-empty set of axes over global
        ranks ``offset`` .. ``offset + size − 1``; every rank of the run
        calls this, in the same order.  A rank outside them gets an
        abstract mesh (``rank`` None).  Returns the mesh."""
        if self.dry:
            raise ValueError(f"{self!r} has no process groups to make")
        world, me = dist.get_world_size(), dist.get_rank()
        if not 0 <= offset <= world - self.size:
            raise ValueError(f"a mesh of {self.size} ranks from rank "
                             f"{offset} in a run of {world}")
        self.offset = offset
        self.rank = me - offset if offset <= me < offset + self.size \
            else None
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                key = frozenset(axes)
                if self.axes_size(axes) == 1:
                    continue
                if len(axes) == len(names) and self.size == world:
                    self._groups[key] = dist.group.WORLD
                    continue
                rest = [a for a in names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    ranks = [offset + r for r in range(self.size) if all(
                        self.coords_of(r)[a] == v
                        for a, v in zip(rest, fixed))]
                    g = dist.new_group(ranks)
                    if me in ranks:
                        self._groups[key] = g
        return self

    def group(self, axes: Sequence[str]):
        """The process group over ``axes`` (``None`` where they span one
        rank, or on a dry mesh)."""
        if self.axes_size(axes) == 1 or self.dry:
            return None
        try:
            return self._groups[frozenset(axes)]
        except KeyError:
            raise ValueError(f"{self!r} is not connected: call connect() "
                             f"in every rank") from None


def _host_mesh(shape, axes) -> Mesh:
    """A mesh of the running ranks: this process's rank and groups where
    ``torch.distributed`` is up (its world must be the mesh's size), rank
    0 of a one-rank mesh, else abstract."""
    mesh = Mesh(shape, axes)
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != mesh.size:
            raise ValueError(f"a mesh of {mesh.size} ranks in a run of "
                             f"{dist.get_world_size()}")
        return mesh.connect()
    if mesh.size == 1:
        mesh.rank = 0
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0) -> Mesh:
    """A small mesh over the ranks of this run (see :func:`_host_mesh`)."""
    if pod:
        return _host_mesh((pod, data, model), ("pod", "data", "model"))
    return _host_mesh((data, model), ("data", "model"))


def make_cluster_mesh(cores: int) -> Mesh:
    """1-D ``cores`` mesh for the SSR cluster layer (paper §5.3–5.5).

    The port's cluster (``parallel/cluster.py``) runs its cores as shards
    on one device, so the mesh is abstract: it names the axis and its
    size, and needs no device a core.
    """
    if cores < 1:
        raise ValueError(f"cores must be >= 1, got {cores}")
    return Mesh((cores,), ("cores",))


def describe(mesh: Mesh) -> str:
    return "×".join(f"{a}={mesh.shape[a]}" for a in mesh.axis_names) + \
        f" ({mesh.size} chips)"


# ---------------------------------------------------------------------------
# the rank launcher
# ---------------------------------------------------------------------------

class RankError(RuntimeError):
    """One or more ranks failed or did not finish; the message holds every
    failed rank's traceback."""


def _rank_main(fn, rank: int, world: int, backend: str, store: str,
               results, args: tuple, timeout: float) -> None:
    try:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 - reported to the parent, re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, *, backend: str, args: tuple = (),
              timeout: float = 600.0, grace: float = 10.0) -> List[Any]:
    """``[fn(rank, world, *args) for each rank]``, each rank a process.

    ``fn`` and ``args`` must pickle (``fn`` importable by name); each
    result comes back pickled.  The ranks meet in a ``FileStore`` under a
    fresh temporary directory, removed at the end.  A rank that fails
    gives the others ``grace`` seconds to finish; then every process left
    is killed and :class:`RankError` raised with the tracebacks.  The whole
    run is bounded by ``timeout`` seconds (also the process group's).
    """
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend,
                               os.path.join(tmp, "store"), results, args,
                               timeout))
             for r in range(world)]
    out: Dict[int, Any] = {}
    failed: Dict[int, str] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout

        def take(item) -> None:
            nonlocal deadline
            rank, ok, payload = item
            if ok:
                out[rank] = pickle.loads(payload)
            else:
                failed[rank] = payload
                deadline = min(deadline, time.monotonic() + grace)

        while len(out) + len(failed) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                take(results.get(timeout=min(left, 1.0)))
                continue
            except queue.Empty:
                pass
            # a rank that exited without a word (killed, or its start
            # failed) fails now, not at the timeout; what a rank put before
            # it exited is in the pipe already
            dead = [r for r, p in enumerate(procs) if p.exitcode is not None
                    and r not in out and r not in failed]
            while dead:
                try:
                    take(results.get(timeout=0.5))
                except queue.Empty:
                    break
            for r in dead:
                if r not in out and r not in failed:
                    failed[r] = (f"exited with code {procs[r].exitcode} "
                                 f"before reporting")
                    deadline = min(deadline, time.monotonic() + grace)
        for p in procs:
            p.join(timeout=max(0.0, min(grace, deadline - time.monotonic()))
                   if len(out) == world else 0.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    missing = [r for r in range(world) if r not in out and r not in failed]
    if failed or missing:
        msg = [f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items())]
        if missing:
            msg.append(f"ranks {missing} did not finish within "
                       f"{timeout:.0f} s (or the grace after a failure)")
        raise RankError("\n".join(msg))
    return [out[r] for r in range(world)]
