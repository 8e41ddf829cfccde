"""Run-time support of the port: so far the straggler watch (``fault``)."""

from .fault import StragglerMonitor  # noqa: F401
