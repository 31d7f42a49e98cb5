"""Deterministic fault injection for tests and drills.

Port of the JAX package's ``runtime/chaos.py``, for this slice only its
`VirtualClock`: serving deadlines then advance only when a test says so.
"""
from __future__ import annotations


class VirtualClock:
    """Injectable monotonic clock for serving tests: deadlines and queue age
    advance only when the test says so."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def time(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t
