"""The ``ssrcfg`` CSR analogue: opt-in stream semantics, off by default.

Paper §2.2.2: "The SSR extension needs to be opt-in and disabled by default
[...] Sections of code using SSR are expected to set this bit at their
beginning and clear it at their end, essentially defining an 'SSR region'."

Model code consults :func:`ssr_enabled` when choosing between the streamed
Pallas kernel path and the plain-XLA path; both are semantically identical
(tested), so flipping the bit is always safe — exactly the compatibility
property the CSR gives existing RISC-V binaries.
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def ssr_enabled() -> bool:
    return getattr(_state, "enabled", False)


@contextlib.contextmanager
def ssr_region(enabled: bool = True):
    """``csrwi ssrcfg, 1`` … ``csrwi ssrcfg, 0`` as a context manager."""
    prev = ssr_enabled()
    _state.enabled = enabled
    try:
        yield
    finally:
        _state.enabled = prev


def set_ssr(enabled: bool) -> None:
    _state.enabled = enabled
