"""Per-step tracing and profiling hooks.

The port's copy of ``polyaxon_tpu/tracking/profiling.py``: a windowed
trace written into the run's outputs dir, named trace spans, and
``StepClock``.  Where the JAX module calls ``jax.profiler``, the port calls
:data:`profiler`, the process's one ``torch.profiler`` session
(:class:`TorchProfiler`); its traces are Chrome trace JSON files
(``*.pt.trace.json``), readable by Perfetto and TensorBoard's profiler
plugin, with the card's kernels when CUDA is present.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import time
from pathlib import Path
from time import perf_counter
from typing import Optional, Union

import torch

logger = logging.getLogger(__name__)


class TorchProfiler:
    """The process's trace session over ``torch.profiler``: one trace at a
    time, as ``jax.profiler`` allows (a second ``start_trace`` raises)."""

    def __init__(self) -> None:
        self._prof = None
        self._dir: Optional[Path] = None

    def start_trace(self, trace_dir: Union[str, Path]) -> None:
        """Start tracing host ops, and the card's kernels when CUDA is present."""
        if self._prof is not None:
            raise RuntimeError("a trace is already active")
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        self._prof, self._dir = prof, Path(trace_dir)

    def stop_trace(self) -> Path:
        """Stop the trace and write it under the start's directory; returns
        the file."""
        if self._prof is None:
            raise RuntimeError("no trace is active")
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the window's kernels end inside the trace
        prof.stop()
        self._dir.mkdir(parents=True, exist_ok=True)
        path = self._dir / f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        return path

    def device_memory_profile(self) -> bytes:
        """The card's allocator state (``torch.cuda.memory_snapshot()``) as
        JSON; raises without CUDA."""
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device to snapshot")
        return json.dumps(torch.cuda.memory_snapshot(), default=str).encode()


#: The process's trace session (tests swap in a fake).
profiler = TorchProfiler()


class StepProfiler:
    """Capture a trace for steps [start, start+num_steps) under
    ``<outputs_dir>/profile``.

    Failure policy: profiling is diagnostics, never the workload — any
    ``start_trace``/``stop_trace`` failure (another trace already active,
    trace dir unwritable) warns and DISABLES the profiler instead of
    crashing the train loop.  ``close()`` is idempotent.
    """

    def __init__(
        self,
        outputs_dir: Union[str, Path],
        start_step: int = -1,
        num_steps: int = 0,
    ) -> None:
        self.trace_dir = str(Path(outputs_dir) / "profile")
        self.start_step = start_step
        self.num_steps = num_steps
        self._active = False
        self._broken = False

    @property
    def enabled(self) -> bool:
        return self.num_steps > 0 and self.start_step >= 0 and not self._broken

    def _disable(self, op: str, exc: Exception) -> None:
        logger.warning(
            "StepProfiler %s failed (%s: %s); disabling profiling for this run",
            op,
            type(exc).__name__,
            exc,
        )
        self._broken = True
        self._active = False

    def on_step(self, step: int) -> None:
        """Call once per train step (before dispatch)."""
        if not self.enabled:
            return
        if not self._active and step == self.start_step:
            try:
                profiler.start_trace(self.trace_dir)
                self._active = True
            except Exception as e:
                self._disable("start_trace", e)
        elif self._active and step >= self.start_step + self.num_steps:
            try:
                profiler.stop_trace()
                self._active = False
            except Exception as e:
                self._disable("stop_trace", e)

    def close(self) -> None:
        if self._active:
            self._active = False
            try:
                profiler.stop_trace()
            except Exception as e:
                self._disable("stop_trace", e)


def annotate(name: str):
    """Named trace span (``torch.profiler.record_function``); a no-op
    context when the profiler is unavailable."""
    try:
        from torch.profiler import record_function

        return record_function(name)
    except Exception:
        return contextlib.nullcontext()


class StepClock:
    """Per-step wall/section accounting for the train hot loop.

    ``tick()`` marks a step boundary and accumulates ``step_wall_s``;
    ``add(name, seconds)`` folds in externally measured sections
    (``ckpt_block_s`` from the checkpoint manager).  :meth:`summary` reports
    per-step means.
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
