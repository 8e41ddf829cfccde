"""Resilience layer: fault-injection seams, typed fallback set, retry.

The PyTorch counterpart of ``repro.core.resilience``, with the same seams,
fault kinds and environment variable, so one ``REPRO_FAULTS`` string arms
both packages.  The paper frames SSR as non-invasive — the baseline stays
available as a correct fallback — and the dispatch stack honours that in
software: a tuned fast path degrades to a correct slower path.

* **Seams** (:data:`SEAMS`) — named points where a fault can be injected
  deterministically: schedule-cache reads and writes, the lowering of a
  plan to block walks, the build of a streamed kernel (``SsrKernel``, or a
  ``NestKernel`` entry), and the autotuner's timing loop.  Production code
  calls :func:`inject` at each seam; it is a no-op until a fault is armed by
  :func:`arm`, the :func:`inject_faults` context manager or the
  ``REPRO_FAULTS`` variable (``"seam[:kind[:times]]"``, comma-separated).

* **Typed fallback set** — :func:`fallback_error_types`.  Dispatch degrades
  only on injected faults, cache I/O ``OSError`` and ``LoweringError``.
  Unlike the reference, the set has no counterpart of XLA's compile error:
  a Hopper kernel that fails to build (``nvcc``) or to launch
  (``RuntimeError`` from ``hopper._launch``) propagates through every rung
  — ``NestKernel``'s and ``ssr_call``'s tuned → default ladders and
  ``registry.dispatch``'s opt-in ``baseline_fallback`` — so no fallback
  ever hides a broken kernel.  And on the card that last rung runs the
  monolithic baseline's Hopper kernel, never the plain-PyTorch ``ref``.
  User errors (missing operands, shapes, dtypes) propagate too.

* **FallbackEvent log** — every degradation is recorded (seam, dispatch
  site, error, from → to schedule, quarantined key), so tests assert the
  ladder, not just the result.

* **retry()** — bounded retry with jittered exponential backoff for
  transient I/O (the schedule cache's commit path).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: The dispatch stack's injection points.  ``cache.read``/``cache.write``
#: fire inside :class:`~repro_torch.core.autotune.ScheduleCache` probes and
#: commits, ``lowering`` inside ``lower_plan``/``lower_nest``, ``compile``
#: just before a streamed kernel is built (``ssr_call``, ``NestKernel``),
#: ``measure`` inside the autotuner's timing loop.
SEAMS = ("cache.read", "cache.write", "lowering", "compile", "measure")

#: Injection flavours: ``fault`` raises :class:`InjectedFault` (a generic
#: infrastructure failure), ``oserror`` raises :class:`InjectedOSError` (a
#: transient I/O failure — what :func:`retry` absorbs).
KINDS = ("fault", "oserror")

_ENV_FAULTS = "REPRO_FAULTS"


class InjectedFault(RuntimeError):
    """A deterministic injected infrastructure failure at a named seam."""

    def __init__(self, seam: str, kind: str = "fault"):
        super().__init__(f"injected {kind} at seam {seam!r}")
        self.seam = seam
        self.kind = kind


class InjectedOSError(OSError):
    """Injected *transient* I/O failure — retriable, typed as OSError."""

    def __init__(self, seam: str):
        super().__init__(f"injected transient OSError at seam {seam!r}")
        self.seam = seam
        self.kind = "oserror"


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: fire ``times`` times at ``seam`` then go quiet.

    ``times < 0`` means unlimited.  ``fired`` records how often it went off.
    """

    seam: str
    kind: str = "fault"
    times: int = 1
    fired: int = 0

    def exhausted(self) -> bool:
        return 0 <= self.times <= self.fired

    def raise_(self) -> None:
        self.fired += 1
        FAULT_STATS["injected"] += 1
        FAULT_STATS[self.seam] = FAULT_STATS.get(self.seam, 0) + 1
        if self.kind == "oserror":
            raise InjectedOSError(self.seam)
        raise InjectedFault(self.seam, self.kind)


_ARMED: List[FaultSpec] = []
_ARMED_LOCK = threading.Lock()
_ENV_CONSUMED = False

#: ``injected`` total plus a per-seam firing count.
FAULT_STATS: Dict[str, int] = {"injected": 0}


def _check_seam_kind(seam: str, kind: str) -> None:
    if seam not in SEAMS:
        raise ValueError(f"unknown fault seam {seam!r}; seams: {SEAMS}")
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; kinds: {KINDS}")


def parse_faults(text: str) -> List[FaultSpec]:
    """Parse a ``REPRO_FAULTS`` value: ``seam[:kind[:times]]``, commas.

    Unknown seams and kinds raise: a typo must not silently disarm a run.
    """
    specs = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        seam = bits[0]
        kind = bits[1] if len(bits) > 1 and bits[1] else "fault"
        _check_seam_kind(seam, kind)
        times = int(bits[2]) if len(bits) > 2 else 1
        specs.append(FaultSpec(seam=seam, kind=kind, times=times))
    return specs


def arm(seam: str, *, kind: str = "fault", times: int = 1) -> FaultSpec:
    """Arm one fault; returns the spec so callers can inspect ``fired``."""
    _check_seam_kind(seam, kind)
    spec = FaultSpec(seam=seam, kind=kind, times=times)
    with _ARMED_LOCK:
        _ARMED.append(spec)
    return spec


def disarm(spec: FaultSpec) -> None:
    with _ARMED_LOCK:
        if spec in _ARMED:
            _ARMED.remove(spec)


def armed_specs() -> List[FaultSpec]:
    with _ARMED_LOCK:
        return list(_ARMED)


def reset_faults(*, reload_env: bool = False) -> None:
    """Disarm everything and zero the firing stats.

    ``reload_env=True`` re-reads ``REPRO_FAULTS`` on the next
    :func:`inject`; the default marks the variable as consumed.
    """
    global _ENV_CONSUMED
    with _ARMED_LOCK:
        _ARMED.clear()
    FAULT_STATS.clear()
    FAULT_STATS["injected"] = 0
    _ENV_CONSUMED = not reload_env


def _arm_from_env() -> None:
    global _ENV_CONSUMED
    if _ENV_CONSUMED:
        return
    _ENV_CONSUMED = True
    text = os.environ.get(_ENV_FAULTS, "")
    if not text:
        return
    specs = parse_faults(text)
    with _ARMED_LOCK:
        _ARMED.extend(specs)


def inject(seam: str) -> None:
    """The seam hook: raise if a fault is armed here, else do nothing.

    The first non-exhausted armed spec for ``seam`` fires (in arming
    order); an exhausted spec never fires again.
    """
    _arm_from_env()
    if not _ARMED:          # nothing armed: one list test
        return
    with _ARMED_LOCK:
        spec = next((s for s in _ARMED
                     if s.seam == seam and not s.exhausted()), None)
    if spec is not None:
        spec.raise_()


@contextlib.contextmanager
def inject_faults(*seams: str, kind: str = "fault", times: int = 1):
    """Arm faults for a ``with`` block; disarmed on exit.  Yields the
    armed :class:`FaultSpec` list."""
    specs = [arm(s, kind=kind, times=times) for s in seams]
    try:
        yield specs
    finally:
        for s in specs:
            disarm(s)


# -- typed fallback set and classification ----------------------------------


def fallback_error_types() -> Tuple[type, ...]:
    """The closed set of error types dispatch may degrade on.

    Injected faults, cache-I/O ``OSError`` and the lowering's own
    rejection.  No kernel build or launch error is in it (see the module
    docstring).
    """
    from .ssr import LoweringError

    return (InjectedFault, OSError, LoweringError)


def classify(exc: BaseException) -> str:
    """Best-effort seam attribution of a fallback-triggering error."""
    seam = getattr(exc, "seam", None)
    if isinstance(seam, str):
        return seam
    if type(exc).__name__ == "LoweringError":
        return "lowering"
    if isinstance(exc, OSError):
        return "cache.read"
    return "compile"


# -- structured fallback log ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FallbackEvent:
    """One recorded rung-descent on the degradation ladder."""

    seam: str            # which seam failed (classify() of the error)
    site: str            # dispatch entry: "ssr_call", "nest_kernel:gemm", ...
    error_type: str      # type name of the triggering error
    error: str           # str() of the triggering error
    from_schedule: str   # what was being attempted ("tuned", "ssr", ...)
    to_schedule: str     # the rung landed on ("default", "baseline", ...)
    key: Optional[str] = None   # quarantined cache key, if any


FALLBACK_LOG: List[FallbackEvent] = []
_FALLBACK_LOG_MAX = 4096


def record_fallback(*, seam: str, site: str, error: BaseException,
                    from_schedule: str, to_schedule: str,
                    key: Optional[str] = None) -> FallbackEvent:
    event = FallbackEvent(seam=seam, site=site,
                          error_type=type(error).__name__,
                          error=str(error), from_schedule=from_schedule,
                          to_schedule=to_schedule, key=key)
    if len(FALLBACK_LOG) >= _FALLBACK_LOG_MAX:
        del FALLBACK_LOG[:_FALLBACK_LOG_MAX // 2]
    FALLBACK_LOG.append(event)
    return event


def fallback_events() -> List[FallbackEvent]:
    return list(FALLBACK_LOG)


def reset_fallback_log() -> None:
    FALLBACK_LOG.clear()


# -- bounded retry with jittered exponential backoff ------------------------

#: Deterministic jitter source: reproducible backoff sequences.
_RETRY_RNG = random.Random(0x5E51)


def retry(fn: Callable[[], Any], *, attempts: int = 3,
          base_delay: float = 0.005, max_delay: float = 0.1,
          retry_on: Tuple[type, ...] = (OSError,),
          sleep: Callable[[float], None] = time.sleep,
          rng: Optional[random.Random] = None,
          on_retry: Optional[Callable[[int, BaseException], None]] = None
          ) -> Any:
    """Call ``fn`` up to ``attempts`` times, backing off between tries.

    Retries only on ``retry_on``; any other exception, and the last
    ``retry_on`` failure, propagates.  Backoff is exponential with full
    jitter, capped at ``max_delay``; ``on_retry(attempt, error)`` fires
    before each re-try.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    rng = rng or _RETRY_RNG
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as e:
            if attempt == attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            delay = min(max_delay, base_delay * (2 ** (attempt - 1)))
            sleep(rng.uniform(0, delay))


def reset() -> None:
    """Full module reset: armed faults, stats, and the fallback log."""
    reset_faults()
    reset_fallback_log()
