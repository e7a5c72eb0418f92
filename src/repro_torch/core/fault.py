"""Fault-tolerance cost model (paper §IV "Handling training failures"):
the part of ``repro/core/fault.py`` that the simulated round time uses.
The Weibull fitting and checkpoint-interval search of the reference are
host-side analysis tools, not ported yet.
"""
from __future__ import annotations


def recovery_overhead(recovery_time, frac: float = 0.01):
    """Per-failed-client recovery term of the simulated round time: a
    checkpoint restart resumes near the failure point, so only
    ``frac·t_r`` is charged per failure."""
    return recovery_time * frac
