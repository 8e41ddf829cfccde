"""Kernel registry: one uniform handle per kernel in the suite.

As in ``repro.kernels.registry``, a module self-registers a lazy
:class:`KernelEntry` at import time and every consumer iterates
:func:`entries`; :func:`dispatch` consults ``region.ssr_enabled()`` — the
software ``ssrcfg`` CSR — to pick the streamed or the plain-PyTorch
variant, with the degradation ladder's opt-in last rung,
``baseline_fallback``, which on the card runs the monolithic baseline's
Hopper kernel, never PyTorch.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import os
from typing import Callable, Dict, List, Optional

import torch

from .. import DeviceLike, resolve_device
from ..core import resilience
from ..core.region import ssr_enabled
from .frontend import on_device

# Every module under repro_torch.kernels that registers a kernel.
_KERNEL_MODULES = ("reduction", "relu", "gemv", "gemm", "chained", "dag")


@dataclasses.dataclass(frozen=True, eq=False)
class KernelEntry:
    """One kernel's public variants.

    ``ssr``      — the streamed kernel (takes ``device=``)
    ``ref``      — the plain-PyTorch oracle, also the ``ssrcfg``-off path
    ``baseline`` — the monolithic baseline (explicit in-body loads; takes
                   ``device=``)
    ``example``  — ``example(rng, odd=False) -> (args, kwargs)``, CPU
                   tensors drawn from a numpy ``Generator``
    ``tol``      — allclose tolerances for ssr-vs-ref comparisons
    ``problem``  — human-readable §4.2 problem description
    """

    name: str
    ssr: Callable
    ref: Callable
    baseline: Optional[Callable] = None
    example: Optional[Callable] = None
    tol: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"rtol": 1e-3, "atol": 1e-3})
    problem: str = ""

    def variants(self) -> Dict[str, Callable]:
        out = {"ssr": self.ssr, "ref": self.ref}
        if self.baseline is not None:
            out["baseline"] = self.baseline
        return out


_FACTORIES: Dict[str, Callable[[], KernelEntry]] = {}
_RESOLVED: Dict[str, KernelEntry] = {}


def register_kernel(name: str):
    """Function decorator registering a lazy :class:`KernelEntry`."""

    def deco(factory: Callable[[], KernelEntry]):
        if name in _FACTORIES:
            raise ValueError(f"kernel {name!r} registered twice")
        _FACTORIES[name] = factory
        return factory

    return deco


def _ensure_loaded() -> None:
    for mod in _KERNEL_MODULES:
        importlib.import_module(f"repro_torch.kernels.{mod}")


def names() -> List[str]:
    _ensure_loaded()
    return sorted(_FACTORIES)


def get(name: str) -> KernelEntry:
    _ensure_loaded()
    if name not in _RESOLVED:
        if name not in _FACTORIES:
            raise KeyError(
                f"no kernel {name!r}; registered: {sorted(_FACTORIES)}")
        entry = _FACTORIES[name]()
        if entry.name != name:
            raise ValueError(
                f"entry name {entry.name!r} != registered name {name!r}")
        _RESOLVED[name] = entry
    return _RESOLVED[name]


def entries() -> List[KernelEntry]:
    return [get(n) for n in names()]


def _baseline_fallback_enabled() -> bool:
    return os.environ.get("REPRO_BASELINE_FALLBACK", "") not in ("", "0")


def fallback_variant(entry: KernelEntry,
                     dev: torch.device) -> Optional[Callable]:
    """The ladder's last rung on ``dev``, or ``None`` when there is none.

    On the CPU it is the plain-PyTorch ``ref``, the reference's rung.  On
    the card it is the entry's monolithic ``baseline``, whose Hopper kernel
    runs in place of the streamed one, so tensors on the card are never
    handed to PyTorch; an entry without a baseline has no rung there.
    """
    if dev.type == "cpu":
        return entry.ref
    if entry.baseline is None:
        return None
    return functools.partial(entry.baseline, device=dev)


def dispatch(name: str, *args, ssr: Optional[bool] = None,
             baseline_fallback: Optional[bool] = None,
             device: DeviceLike = None, **kwargs):
    """Run a kernel through the ``ssrcfg`` gate (paper §2.2.2).

    ``ssr=None`` consults :func:`region.ssr_enabled`; semantics are the
    same either way — only the engine changes.  Array arguments move to
    ``device`` first, for both variants.

    ``baseline_fallback`` is the ladder's last rung: when the streamed
    variant fails with a typed error
    (:func:`resilience.fallback_error_types`) even after the schedule
    ladder, the call runs again through :func:`fallback_variant` — ``ref``
    on the CPU, the baseline kernel on the card.  Opt-in
    (``baseline_fallback=True`` or ``REPRO_BASELINE_FALLBACK=1``).  A kernel
    that fails to build or launch is not a typed error, so it propagates
    even then, and so does a typed error on a card with no baseline.
    """
    entry = get(name)
    dev = resolve_device(device)
    args = on_device(args, dev)
    use = ssr_enabled() if ssr is None else ssr
    if not use:
        return entry.ref(*args, **kwargs)
    if baseline_fallback is None:
        baseline_fallback = _baseline_fallback_enabled()
    if not baseline_fallback:
        return entry.ssr(*args, device=dev, **kwargs)
    try:
        return entry.ssr(*args, device=dev, **kwargs)
    except resilience.fallback_error_types() as e:
        rung = fallback_variant(entry, dev)
        if rung is None:
            raise
        resilience.record_fallback(
            seam=resilience.classify(e), site=f"registry:{name}", error=e,
            from_schedule="ssr", to_schedule="baseline")
        return rung(*args, **kwargs)
