"""Stall watchdog and crash-forensics flight recorder (worker side).

The port's copy of ``polyaxon_tpu/tracking/flightrec.py``:

- :class:`Progress`, a process-wide beacon the hot loops feed: ``lm_train``
  beats once a step, the serving engine once a prefill chunk and once a
  decode step.  A beat is a lock and a few attribute writes.
- :class:`FlightRecorder`, a daemon watchdog thread that relays the beacon
  upstream as throttled typed ``progress`` report lines and dumps a forensic
  snapshot when no beat lands within an adaptive deadline: k x the rolling
  median step time, clamped between a floor and a ceiling.

The snapshot holds every live thread's stack (``sys._current_frames()``),
the tracer's span ring (``tracking/trace.py``), the cards' memory
(``monitor/resources.py:sample_devices``: the caching allocator's
counters, never a new CUDA context) and the tail of this process's report
file.  It is written to ``reports/flightrec-<proc>-<n>.json`` beside the
report channel, and a typed ``anomaly`` line points the control plane at
it.  :meth:`FlightRecorder.crash_dump` writes the same postmortem on an
entry point's crash path.

A step the host has only dispatched still counts as progress: the beat
lands when the host queues the step, so a card that hangs shows as a stall
once the host blocks on it (a full queue, a read back, the end-of-loop
synchronize).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import threading
import time
import traceback
from collections import deque
from pathlib import Path
from typing import Any, Dict, Optional

from polyaxon_tpu_torch.conf.knobs import knob_float


class Progress:
    """Shared progress beacon: hot loops call :meth:`beat`, nothing else.

    Thread-safe; the watchdog (and tests) read a consistent copy via
    :meth:`snapshot`.  The deadline math runs on ``perf_counter`` so wall
    clock adjustments can never fake a stall; wall time is kept alongside
    for the upstream ``progress`` lines.
    """

    def __init__(self, window: int = 64) -> None:
        self._lock = threading.Lock()
        self._dts: deque = deque(maxlen=window)
        self._beats = 0
        self._step: Optional[int] = None
        self._epoch: Optional[int] = None
        self._last_mono: Optional[float] = None
        self._last_wall: Optional[float] = None

    def beat(
        self, step: Optional[int] = None, *, epoch: Optional[int] = None
    ) -> None:
        """Record one unit of forward progress (a train step, a decode tick)."""
        mono = time.perf_counter()
        with self._lock:
            if self._last_mono is not None:
                self._dts.append(mono - self._last_mono)
            self._beats += 1
            self._last_mono = mono
            self._last_wall = time.time()
            if step is not None:
                self._step = step
            if epoch is not None:
                self._epoch = epoch

    def reset(self) -> None:
        """Disarm the beacon (between entrypoints / in tests)."""
        with self._lock:
            self._dts.clear()
            self._beats = 0
            self._step = self._epoch = None
            self._last_mono = self._last_wall = None

    def snapshot(self) -> Dict[str, Any]:
        """Consistent view: armed/step/epoch, beat age, rolling median dt."""
        with self._lock:
            median_dt = statistics.median(self._dts) if self._dts else None
            age = (
                time.perf_counter() - self._last_mono
                if self._last_mono is not None
                else None
            )
            return {
                "armed": self._beats > 0,
                "beats": self._beats,
                "step": self._step,
                "epoch": self._epoch,
                "age_s": age,
                "last_beat_at": self._last_wall,
                "median_dt_s": median_dt,
                "throughput": (1.0 / median_dt) if median_dt else None,
            }


#: Process-wide beacon, mirroring the tracer singleton: hot loops reach it
#: via :func:`get_progress` with no plumbing through Context/engine APIs.
_progress = Progress()


def get_progress() -> Progress:
    return _progress


def thread_stacks() -> Dict[str, Any]:
    """Every live thread's current stack, keyed ``<name>:<ident>``.

    ``sys._current_frames()`` is a point-in-time copy — no tracing overhead
    until the moment of the dump, which is exactly the flight-recorder
    trade: free when healthy, complete when stuck.
    """
    names = {t.ident: t.name for t in threading.enumerate()}
    return {
        f"{names.get(ident, 'unknown')}:{ident}": traceback.format_stack(frame)
        for ident, frame in sys._current_frames().items()
    }


def dump_forensics(
    out_dir: Path,
    process_id: int,
    seq: int,
    *,
    kind: str,
    message: Optional[str] = None,
    progress: Optional[Dict[str, Any]] = None,
    report_path: Optional[Path] = None,
    exc: Optional[BaseException] = None,
    span_tail: int = 200,
    report_tail_lines: int = 50,
) -> Optional[Path]:
    """Write ``flightrec-<proc>-<seq>.json`` and return its path.

    Every ingredient is gathered best-effort behind its own guard: a
    postmortem with a missing section beats no postmortem — this runs on
    the crash path and inside the watchdog thread, where a second failure
    must never mask the first.
    """
    snapshot: Dict[str, Any] = {
        "kind": kind,
        "ts": time.time(),
        "process_id": process_id,
        "message": message,
        "progress": progress,
    }
    try:
        snapshot["threads"] = thread_stacks()
    except Exception as e:
        snapshot["threads"] = {"error": repr(e)}
    try:
        from polyaxon_tpu_torch.tracking.trace import get_tracer

        snapshot["spans"] = get_tracer().spans()[-span_tail:]
    except Exception as e:
        snapshot["spans"] = [{"error": repr(e)}]
    try:
        from polyaxon_tpu_torch.monitor.resources import sample_devices

        snapshot["devices"] = sample_devices()
    except Exception as e:
        snapshot["devices"] = {"error": repr(e)}
    if exc is not None:
        snapshot["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": traceback.format_exception(type(exc), exc, exc.__traceback__),
        }
    if report_path is not None:
        try:
            with open(report_path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                size = fh.tell()
                fh.seek(max(0, size - 64 * 1024))
                tail = fh.read().decode("utf-8", errors="replace")
            snapshot["report_tail"] = tail.splitlines()[-report_tail_lines:]
        except Exception as e:
            snapshot["report_tail"] = [f"error: {e!r}"]
    try:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"flightrec-{process_id}-{seq}.json"
        path.write_text(json.dumps(snapshot, default=str, indent=1))
        return path
    except Exception:
        return None


class FlightRecorder:
    """Watchdog thread over a :class:`Progress` beacon.

    Env knobs (all read at construction, overridable per instance):

    - ``POLYAXON_TPU_WATCHDOG_K`` (8.0) — deadline = k × rolling median dt
    - ``POLYAXON_TPU_WATCHDOG_FLOOR_S`` (30.0) — deadline lower clamp
    - ``POLYAXON_TPU_WATCHDOG_CEILING_S`` (600.0) — deadline upper clamp
      (also the deadline before any dt sample exists)
    - ``POLYAXON_TPU_WATCHDOG_INTERVAL_S`` (1.0) — poll period; <= 0
      disables the thread entirely
    - ``POLYAXON_TPU_PROGRESS_INTERVAL_S`` (2.0) — min spacing of typed
      ``progress`` report lines

    One dump fires per stall episode (re-armed by the next beat), so a
    long hang costs one snapshot, not one per poll.
    """

    def __init__(
        self,
        progress: Optional[Progress] = None,
        *,
        reporter: Any = None,
        out_dir: Optional[Path] = None,
        process_id: int = 0,
        k: Optional[float] = None,
        floor_s: Optional[float] = None,
        ceiling_s: Optional[float] = None,
        interval_s: Optional[float] = None,
        progress_interval_s: Optional[float] = None,
    ) -> None:
        self.progress = progress if progress is not None else get_progress()
        self.reporter = reporter
        self.out_dir = Path(out_dir) if out_dir is not None else None
        self.process_id = process_id
        self.k = k if k is not None else knob_float("POLYAXON_TPU_WATCHDOG_K")
        self.floor_s = (
            floor_s
            if floor_s is not None
            else knob_float("POLYAXON_TPU_WATCHDOG_FLOOR_S")
        )
        self.ceiling_s = (
            ceiling_s
            if ceiling_s is not None
            else knob_float("POLYAXON_TPU_WATCHDOG_CEILING_S")
        )
        self.interval_s = (
            interval_s
            if interval_s is not None
            else knob_float("POLYAXON_TPU_WATCHDOG_INTERVAL_S")
        )
        self.progress_interval_s = (
            progress_interval_s
            if progress_interval_s is not None
            else knob_float("POLYAXON_TPU_PROGRESS_INTERVAL_S")
        )
        self._seq = 0
        self._fired = False
        self._last_progress_emit = 0.0
        self._last_emitted_beats = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- deadline -------------------------------------------------------------
    def deadline_s(self, median_dt: Optional[float]) -> float:
        if median_dt is None:
            return self.ceiling_s
        return min(max(self.k * median_dt, self.floor_s), self.ceiling_s)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None or self.interval_s <= 0:
            return
        self._thread = threading.Thread(
            target=self._loop, name="flightrec", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        # Final progress flush: short runs finish between emit intervals,
        # and the control plane should still see their last step.
        self._emit_progress(force=True)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:
                # The watchdog must never take the worker down.
                pass

    # -- one poll -------------------------------------------------------------
    def check(self, now: Optional[float] = None) -> Optional[Path]:
        """Emit due progress, fire the stall dump when the deadline lapses.

        Returns the dump path when a dump fired (for tests); ``None``
        otherwise.
        """
        snap = self.progress.snapshot()
        if not snap["armed"]:
            return None
        self._emit_progress(snap=snap)
        age = snap["age_s"] or 0.0
        deadline = self.deadline_s(snap["median_dt_s"])
        if age <= deadline:
            self._fired = False
            return None
        if self._fired:
            return None
        self._fired = True
        return self.record(
            "stall",
            message=(
                f"no progress for {age:.1f}s "
                f"(deadline {deadline:.1f}s, step {snap['step']})"
            ),
            progress=snap,
            age_s=age,
            deadline_s=deadline,
            step=snap["step"],
        )

    def _emit_progress(
        self, snap: Optional[Dict[str, Any]] = None, force: bool = False
    ) -> None:
        if self.reporter is None:
            return
        snap = snap or self.progress.snapshot()
        if not snap["armed"]:
            return
        now = time.perf_counter()
        due = now - self._last_progress_emit >= self.progress_interval_s
        fresh = snap["beats"] != self._last_emitted_beats
        if not fresh or not (due or force):
            return
        self._last_progress_emit = now
        self._last_emitted_beats = snap["beats"]
        try:
            self.reporter.progress(
                step=snap["step"],
                epoch=snap["epoch"],
                throughput=snap["throughput"],
                at=snap["last_beat_at"],
            )
        except Exception:
            pass

    # -- forensics ------------------------------------------------------------
    def record(
        self,
        kind: str,
        *,
        message: Optional[str] = None,
        progress: Optional[Dict[str, Any]] = None,
        exc: Optional[BaseException] = None,
        **attrs: Any,
    ) -> Optional[Path]:
        """Dump a forensic snapshot + emit the typed ``anomaly`` line."""
        path: Optional[Path] = None
        if self.out_dir is not None:
            self._seq += 1
            path = dump_forensics(
                self.out_dir,
                self.process_id,
                self._seq,
                kind=kind,
                message=message,
                progress=progress or self.progress.snapshot(),
                report_path=getattr(self.reporter, "path", None),
                exc=exc,
            )
        if self.reporter is not None:
            try:
                self.reporter.anomaly(
                    kind,
                    message=message,
                    dump=str(path) if path else None,
                    # Run-relative artifact key (``reports/<file>``) so the
                    # anomaly row — and any alert built on it — links to
                    # the postmortem via the run artifacts API, not a path
                    # that only means something on the worker host.
                    dump_artifact=(
                        f"{self.out_dir.name}/{path.name}" if path else None
                    ),
                    **attrs,
                )
            except Exception:
                pass
        return path

    def crash_dump(self, exc: BaseException) -> Optional[Path]:
        """The entrypoint crash path: postmortem for every FAILED run."""
        return self.record(
            "crash",
            message=f"{type(exc).__name__}: {exc}",
            exc=exc,
        )
