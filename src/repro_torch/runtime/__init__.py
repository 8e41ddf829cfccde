"""Run-time support: failure injection, supervised restart and the
straggler watch (``fault``)."""

from .fault import (FailureInjector, SimulatedFailure,  # noqa: F401
                    StragglerMonitor, Supervisor)
