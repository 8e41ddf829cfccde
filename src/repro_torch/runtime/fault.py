"""Straggler watch for timed work (the autotuner's measurement loop).

The counterpart of ``repro.runtime.fault.StragglerMonitor``; the rest of
the reference's ``runtime`` (supervised restart, failure injection by step)
belongs to the model stack, a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List


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
