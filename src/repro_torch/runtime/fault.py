"""Fault tolerance: failure injection, supervised restart, straggler watch.

On a real fleet the supervisor is an external agent watching heartbeats;
here it is modelled in-process so the restart logic is testable:
``Supervisor.run`` drives a step function, a :class:`FailureInjector`
raises :class:`SimulatedFailure` at scheduled steps (standing in for a node
loss or a preemption), and recovery restores the latest checkpoint and
replays the data stream from the restored step.

Straggler watch: :class:`StragglerMonitor` keeps an EWMA of step wall time
and flags steps slower than ``mean + k·σ`` (also the autotuner's
measurement loop's watch).  The mitigation hook is pluggable; the default
records the event.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..checkpoint.manager import CheckpointManager
# retry is re-exported, as the reference's: the dispatch stack's seam-keyed
# injection and bounded retry live in core/resilience.py and are shared
from ..core.resilience import InjectedFault, retry  # noqa: F401


class SimulatedFailure(InjectedFault):
    """Stands in for a lost node or a preempted slice.

    An :class:`~repro_torch.core.resilience.InjectedFault`, so one typed
    ``except`` covers the step-indexed injector below and the seam-keyed
    dispatch injector alike.
    """

    def __init__(self, message: str, step: Optional[int] = None):
        RuntimeError.__init__(self, message)
        self.seam = "step"
        self.kind = "fault"
        self.step = step


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: Sequence[int] = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}",
                                   step=step)


@dataclasses.dataclass
class StragglerMonitor:
    """Per-step wall-time watchdog: flags steps slower than mean + k·σ.

    Warmup samples seed the statistics; afterwards mean and variance drift
    by EWMA over *unflagged* steps only (a straggler must not poison the
    baseline).  σ is floored at ``rel_floor·mean`` so very stable step
    times do not hair-trigger.
    """

    threshold_sigma: float = 3.0
    ewma_alpha: float = 0.1
    warmup_steps: int = 5
    rel_floor: float = 0.05
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    _warmup: List[float] = dataclasses.field(default_factory=list)
    events: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self.n += 1
        if self.n <= self.warmup_steps:
            self._warmup.append(seconds)
            self.mean = sum(self._warmup) / len(self._warmup)
            self.var = sum((x - self.mean) ** 2 for x in self._warmup) \
                / max(len(self._warmup) - 1, 1)
            return False
        std = max(math.sqrt(max(self.var, 0.0)),
                  self.rel_floor * self.mean, 1e-9)
        flagged = seconds > self.mean + self.threshold_sigma * std
        if flagged:
            self.events.append({"step": step, "seconds": seconds,
                                "mean": self.mean, "std": std})
        else:
            a = self.ewma_alpha
            self.mean = (1 - a) * self.mean + a * seconds
            self.var = (1 - a) * self.var + a * (seconds - self.mean) ** 2
        return flagged


@dataclasses.dataclass
class Supervisor:
    """Checkpointed, restartable training loop."""

    ckpt: CheckpointManager
    checkpoint_every: int = 10
    max_restarts: int = 10
    injector: Optional[FailureInjector] = None
    straggler: Optional[StragglerMonitor] = None
    on_straggler: Optional[Callable[[int], None]] = None
    restarts: int = 0
    events: List[str] = dataclasses.field(default_factory=list)
    # an injectable time source, so straggler detection is testable
    # without real wall-clock noise
    clock: Callable[[], float] = time.perf_counter

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            num_steps: int, *, start_step: int = 0,
            restore_fn: Optional[Callable[[int, Any], Any]] = None) -> Any:
        """Run ``step_fn`` for ``num_steps``, surviving injected failures.

        ``restore_fn(step, template_state) -> state`` defaults to the
        checkpoint manager's restore with the template's structure.
        """
        step = start_step
        if self.ckpt.latest_step() is None:
            # a restore point before any work: a failure before the first
            # periodic checkpoint replays from the initial state, not from
            # a half-updated one (the train step updates in place)
            self.ckpt.save(start_step, state)
        while step < num_steps:
            try:
                if self.injector is not None:
                    self.injector.check(step)
                t0 = self.clock()
                state = step_fn(state, step)
                dt = self.clock() - t0
                if self.straggler is not None and self.straggler.observe(
                        step, dt):
                    self.events.append(f"straggler@{step}")
                    if self.on_straggler is not None:
                        self.on_straggler(step)
                step += 1
                if step % self.checkpoint_every == 0:
                    self.ckpt.save(step, state, blocking=False)
            except SimulatedFailure as e:
                self.restarts += 1
                self.events.append(f"failure@{step}: {e}")
                if self.restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    step = start_step
                    continue  # restart from scratch
                if restore_fn is not None:
                    state = restore_fn(latest, state)
                else:
                    state = self.ckpt.restore(latest, state)
                step = latest
                self.events.append(f"restored@{latest}")
        self.ckpt.wait()
        return state
