"""Kernel registry: one uniform handle per kernel in the suite.

As in ``repro.kernels.registry``, a module self-registers a lazy
:class:`KernelEntry` at import time and every consumer iterates
:func:`entries`; :func:`dispatch` consults ``region.ssr_enabled()`` — the
software ``ssrcfg`` CSR — to pick the streamed or the plain-PyTorch
variant.  The degradation ladder's ``baseline_fallback`` comes with the
resilience slice of the port.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List, Optional

from .. import DeviceLike, resolve_device
from ..core.region import ssr_enabled
from .frontend import on_device

# Every module under repro_torch.kernels that registers a kernel.
_KERNEL_MODULES = ("reduction", "relu", "gemv", "gemm")


@dataclasses.dataclass(frozen=True, eq=False)
class KernelEntry:
    """One kernel's public variants.

    ``ssr``      — the streamed kernel (takes ``device=``)
    ``ref``      — the plain-PyTorch oracle, also the ``ssrcfg``-off path
    ``baseline`` — the monolithic baseline (``None`` until the port has it)
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


def dispatch(name: str, *args, ssr: Optional[bool] = None,
             device: DeviceLike = None, **kwargs):
    """Run a kernel through the ``ssrcfg`` gate (paper §2.2.2).

    ``ssr=None`` consults :func:`region.ssr_enabled`; semantics are the
    same either way — only the engine changes.  Array arguments move to
    ``device`` first, for both variants.
    """
    entry = get(name)
    dev = resolve_device(device)
    args = on_device(args, dev)
    if ssr_enabled() if ssr is None else ssr:
        return entry.ssr(*args, device=dev, **kwargs)
    return entry.ref(*args, **kwargs)
