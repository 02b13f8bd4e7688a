"""The worker-to-control-plane report channel of the port.

The port's copy of ``polyaxon_tpu/tracking/reporter.py``: each process
appends typed JSON lines to its own file, ``<run dir>/reports/proc<N>.jsonl``
(:func:`report_file`), and the control plane's watcher tails those files into
its registry.  The lines keep the reference's format key for key, so the JAX
``GangWatcher`` takes a port process's file as it takes a JAX one.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Union


def report_file(run_dir: Union[str, Path], process_id: int = 0) -> Path:
    """Where process ``process_id`` of the run at ``run_dir`` reports (the
    run layout's ``reports/proc<N>.jsonl``)."""
    return Path(run_dir) / "reports" / f"proc{process_id}.jsonl"


class Reporter:
    """Append-only typed-line writer, safe for one writer per file."""

    # Lines that must survive a host crash: statuses drive scheduling,
    # anomalies often immediately precede the crash they describe, and
    # command/capture lines drive the control plane's lifecycle roll-ups.
    # Everything else (metrics, logs, spans, ledger rows) is flushed to the
    # OS only: an fsync per metric line would tie the train loop to disk
    # latency.
    FSYNC_TYPES = ("status", "anomaly", "command", "capture")

    def __init__(
        self,
        path: Union[str, Path],
        process_id: int = 0,
        fsync_all: bool = False,
    ) -> None:
        self.path = Path(path)
        self.process_id = process_id
        self.fsync_all = fsync_all
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        #: Callbacks the heartbeat thread runs every beat (the command
        #: mailbox's poll rides here).  Must be cheap; a hook that raises is
        #: skipped, never the beat.
        self._beat_hooks: list = []

    def _emit(self, type_: str, **payload: Any) -> None:
        line = json.dumps({"type": type_, "ts": time.time(), **payload}, default=str)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()
            if self.fsync_all or type_ in self.FSYNC_TYPES:
                os.fsync(self._fh.fileno())

    # -- typed events ---------------------------------------------------------
    def status(self, status: str, message: Optional[str] = None) -> None:
        self._emit("status", status=status, message=message)

    def metric(self, values: Dict[str, Any], step: Optional[int] = None) -> None:
        self._emit("metric", values=values, step=step)

    def log(self, line: str) -> None:
        self._emit("log", line=line)

    def heartbeat(self) -> None:
        self._emit("heartbeat")

    def resources(self, values: Dict[str, Any]) -> None:
        """Telemetry samples (cpu, rss, device memory), streamed like metrics."""
        self._emit("resources", values=values)

    def progress(
        self,
        *,
        step: Optional[int] = None,
        epoch: Optional[int] = None,
        throughput: Optional[float] = None,
        at: Optional[float] = None,
    ) -> None:
        """Forward-progress beacon relay (``tracking/flightrec.py``).  ``at``
        is the wall time of the beat itself: emission is throttled, so the
        line's own ``ts`` can postdate the progress it describes."""
        self._emit("progress", step=step, epoch=epoch, throughput=throughput, at=at)

    def anomaly(self, kind: str, message: Optional[str] = None, **attrs: Any) -> None:
        """A detected anomaly (stall, crash) with its forensic context, such
        as the path of a flight-recorder dump in ``attrs['dump']``."""
        self._emit("anomaly", kind=kind, message=message, **attrs)

    def span(self, record: Dict[str, Any]) -> None:
        """A finished tracer span (``tracking/trace.py``); the tracer's sink."""
        self._emit("span", **record)

    def ledger(self, record: Dict[str, Any]) -> None:
        """A utilization-ledger row (``tracking/ledger.py``); the ledger's sink."""
        self._emit("ledger", **record)

    def service(self, *, url: Optional[str] = None, query: Optional[str] = None) -> None:
        """Advertise (``url``) or refine (``query``, appended) this run's
        service URL."""
        self._emit("service", url=url, query=query)

    def command_event(
        self,
        uuid: str,
        state: str,
        message: Optional[str] = None,
        **attrs: Any,
    ) -> None:
        """This process's lifecycle state for a bus command (acked,
        complete, failed)."""
        self._emit("command", uuid=uuid, state=state, message=message, **attrs)

    def capture(self, record: Dict[str, Any]) -> None:
        """An on-demand profiling capture record (``tracking/capture.py``)."""
        self._emit("capture", **record)

    def error(self, exc: BaseException) -> None:
        self._emit(
            "status",
            status="failed",
            message=f"{type(exc).__name__}: {exc}",
            traceback=traceback.format_exc(),
        )

    # -- heartbeat thread -----------------------------------------------------
    def add_beat_hook(self, hook) -> None:
        """Run ``hook()`` on the heartbeat thread every beat interval."""
        self._beat_hooks.append(hook)

    def _run_beat_hooks(self) -> None:
        for hook in self._beat_hooks:
            try:
                hook()
            except Exception:
                # A broken hook must not take the liveness signal with it.
                pass

    def start_heartbeat(self, interval: float) -> None:
        if self._hb_thread is not None or interval <= 0:
            return
        self.heartbeat()  # an immediate first beat: no zombie window at start
        self._run_beat_hooks()

        def beat() -> None:
            while not self._hb_stop.wait(interval):
                self.heartbeat()
                self._run_beat_hooks()

        self._hb_thread = threading.Thread(target=beat, name="heartbeat", daemon=True)
        self._hb_thread.start()

    def close(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)
            self._hb_thread = None
        with self._lock:
            self._fh.close()
