"""The in-process stats registry.

The port's own copy of ``MemoryStats`` from ``polyaxon_tpu/stats/backends.py``
(the statsd and no-op backends are not ported): counters, gauges and a
log-bucketed :class:`Histogram` per timing or ``observe`` key, behind one
lock.  The port records flat keys only, so the reference's labeled-series
cap and its raw timing windows (which nothing in the port reads) are left
out.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Dict

from polyaxon_tpu_torch.stats.metrics import Histogram


class MemoryStats:
    """In-process aggregation for ``/v1/stats`` and the ``/metrics`` scrape.

    Mutated from several threads (the serving loop, HTTP handlers) and read
    by iteration: all access goes through one lock, and readers use
    :meth:`snapshot` rather than the live dicts.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = defaultdict(int)
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    def incr(self, key: str, value: int = 1) -> None:
        with self._lock:
            self.counters[key] += value

    def gauge(self, key: str, value: float) -> None:
        with self._lock:
            self.gauges[key] = value

    def timing(self, key: str, seconds: float) -> None:
        self.observe(key, seconds)

    def observe(self, key: str, value: float) -> None:
        with self._lock:
            hist = self.histograms.get(key)
            if hist is None:
                hist = self.histograms[key] = Histogram()
            hist.observe(value)

    def snapshot(self) -> Dict[str, Any]:
        """Consistent copy of all state, in the shape ``render_prometheus``
        reads."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: h.state() for k, h in self.histograms.items()},
            }

    def summaries(self) -> Dict[str, Dict[str, float]]:
        """Per-key histogram summaries (count/sum/mean/p50/p95/p99)."""
        with self._lock:
            return {k: h.summary() for k, h in self.histograms.items()}
