"""Per-step wall accounting for the train loop.

The port's copy of ``StepClock`` from ``polyaxon_tpu/tracking/profiling.py``
(the JAX module's profiler and annotation hooks are not ported yet).
"""

from __future__ import annotations

from time import perf_counter
from typing import Optional


class StepClock:
    """Per-step wall/section accounting for the train hot loop.

    ``tick()`` marks a step boundary and accumulates ``step_wall_s``;
    ``add(name, seconds)`` folds in externally measured sections.
    :meth:`summary` reports per-step means.
    """

    def __init__(self) -> None:
        self.steps = 0
        self.totals: dict = {"step_wall_s": 0.0}
        self._last: Optional[float] = None

    def start(self) -> None:
        """Arm at loop entry (the first tick measures the first step)."""
        self._last = perf_counter()

    def tick(self) -> Optional[float]:
        """Call once at the end of every step; returns this step's wall
        seconds (None on the unarmed first call)."""
        now = perf_counter()
        dt: Optional[float] = None
        if self._last is not None:
            dt = now - self._last
            self.totals["step_wall_s"] += dt
            self.steps += 1
        self._last = now
        return dt

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds

    def summary(self) -> dict:
        """Per-step means, keyed by section name (empty if no steps ran)."""
        if not self.steps:
            return {}
        return {k: v / self.steps for k, v in self.totals.items()}
