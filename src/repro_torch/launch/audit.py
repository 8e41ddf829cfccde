"""Cluster locality audit: do per-core intermediates stay core-local?

The counterpart of the audit half of ``repro.launch.hlo_analysis``
(``LocalityCheck``, ``check_cluster_locality``).  The reference compiles a
clustered call and counts the collectives in its HLO; here the call runs
once under ``torch.profiler`` and the counts come from its trace:

* ``"all-reduce"`` counts the combine's ranges
  (:data:`repro_torch.parallel.cluster.COMBINE_RANGE`), the one place a
  reduction's per-core partials meet;
* every other op that reads a core's output anywhere but inside that core,
  the combine or a map's assembly — a second sum of the partials, a copy of
  one, a core reading another core's tile — leaks it off core.  While the
  call runs, a dispatch mode follows each storage back to the core that
  wrote it and wraps such an op in a ``cluster.leak::<op>`` range; the
  leak is counted under the op's name.  View ops read nothing and are not
  counted.

The fusion audits (``check_fusion``, ``check_dag_fusion``) and the HLO
parser are port slice 8.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Callable, Dict, Sequence

import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..parallel import cluster

#: The prefix of the range around a leaking op; the op's name follows it.
LEAK_RANGE = "cluster.leak::"


@dataclasses.dataclass(frozen=True)
class LocalityCheck:
    """Trace evidence that a clustered call communicates only through its
    final combine (paper §5.3: cores share results via the TCDM *once*,
    everything else is core-local).

    A ``reduce``-mode cluster call may hold exactly one ``all-reduce``
    (the combine); a ``map``-mode call none at all — any other count means
    a per-core intermediate leaked off core.
    """

    mode: str
    counts: Dict[str, int]

    @property
    def ok(self) -> bool:
        extras = {k: v for k, v in self.counts.items() if k != "all-reduce"}
        n_ar = self.counts.get("all-reduce", 0)
        if extras:
            return False
        return n_ar == (1 if self.mode == "reduce" else 0)


def _makes_data(func) -> bool:
    """Whether ``func`` writes what it returns (a new tensor, or an input
    it updates in place); a view returns an input's storage unwritten."""
    return not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)


class _CoreOutputs(TorchDispatchMode):
    """Remembers which core wrote each storage, and puts every op that reads
    a core's output off core in a ``LEAK_RANGE`` range."""

    def __init__(self):
        super().__init__()
        # keyed on the storage itself: an entry goes with its storage, so
        # memory used again later is never taken for the old writer's
        self.writer: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind, core = cluster.SCOPES[-1] if cluster.SCOPES else (None, None)
        here = core if kind == "core" else None
        makes = _makes_data(func)
        leak = False
        if makes and kind not in ("combine", "assemble"):
            read = {self.writer.get(t.untyped_storage())
                    for t in tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor)}
            leak = bool(read - {None, here})
        if leak:
            with record_function(LEAK_RANGE + func.name()):
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        if makes:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.writer[t.untyped_storage()] = here
        return out


def check_cluster_locality(fn: Callable, args: Sequence, kwargs=None, *,
                           mode: str, world: int = 1) -> LocalityCheck:
    """Run a clustered call once under the profiler and audit its trace.

    ``fn(*args, **kwargs)`` must be the full cluster call.  ``world`` is
    the reference's participant count, which scales its HLO counts; a
    trace of one process counts each range once, so it is not read.
    Returns the verdict; callers assert ``.ok``.
    """
    kwargs = kwargs or {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with _CoreOutputs():
            fn(*args, **kwargs)
    counts: Dict[str, int] = collections.Counter()
    for e in prof.events():
        if e.name == cluster.COMBINE_RANGE:
            counts["all-reduce"] += 1
        elif e.name.startswith(LEAK_RANGE):
            counts[e.name[len(LEAK_RANGE):]] += 1
    return LocalityCheck(mode=mode, counts=dict(counts))
