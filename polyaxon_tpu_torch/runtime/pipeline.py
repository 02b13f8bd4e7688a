"""Off-loop metric reads for the train loop.

The port's ``MetricsDrain`` from ``polyaxon_tpu/runtime/pipeline.py``.  The
JAX module's ``HostPrefetcher``, ``device_prefetch`` and ``TrainPipeline``
belong to the dataset path and are not ported yet.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch


class MetricsDrain:
    """Fetch per-step device metrics off the hot loop.

    ``push(step, {name: tensor})`` returns at once; a daemon thread reads
    the values and hands ``{name: float}`` to ``emit`` in push order, so the
    loop never pays a device sync just to log.  On the card ``push`` starts
    a non-blocking copy of each scalar into pinned host memory and records
    an event; the drain thread waits on the event, never the loop thread.

    The queue is bounded (a queued value pins its buffer): if the host falls
    ``depth`` fetches behind, ``push`` blocks.  ``close()`` drains everything
    still queued, so no pushed metric is lost; an ``emit`` or fetch error is
    re-raised there.  :attr:`close_wait_s` is the seconds ``close()`` spent
    draining the backlog.
    """

    _DONE = object()

    def __init__(
        self,
        emit: Callable[[Optional[int], Dict[str, float]], None],
        *,
        depth: int = 8,
    ) -> None:
        self._emit = emit
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, depth))
        self._error: Optional[BaseException] = None
        #: Last drained values / step (host floats), for end-of-run logs.
        self.last: Dict[str, float] = {}
        self.last_step: Optional[int] = None
        self.close_wait_s = 0.0
        self._thread = threading.Thread(target=self._run, name="metrics-drain", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            got = self._q.get()
            if got is self._DONE:
                return
            step, values, ready = got
            try:
                if ready is not None:
                    ready.synchronize()
                host = {k: float(v) for k, v in values.items()}
                self._emit(step, host)
                self.last, self.last_step = host, step
            except Exception as exc:  # surfaced by close()
                if self._error is None:
                    self._error = exc

    def push(self, step: Optional[int], values: Dict[str, Any]) -> None:
        ready = None
        if any(isinstance(v, torch.Tensor) and v.is_cuda for v in values.values()):
            staged = {}
            for k, v in values.items():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    host.copy_(v.detach(), non_blocking=True)
                    v = host
                staged[k] = v
            ready = torch.cuda.Event()
            ready.record()
            values = staged
        self._q.put((step, values, ready))

    def close(self) -> None:
        """Drain everything queued, join the thread, surface any error."""
        t0 = time.perf_counter()
        try:
            self._q.put(self._DONE)
            self._thread.join()
        finally:
            self.close_wait_s += time.perf_counter() - t0
        if self._error is not None:
            raise self._error
