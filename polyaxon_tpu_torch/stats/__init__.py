"""Serving stats of the port (the parts of ``polyaxon_tpu.stats`` it uses)."""

import threading

from polyaxon_tpu_torch.stats.backends import MemoryStats
from polyaxon_tpu_torch.stats.metrics import (
    PROMETHEUS_CONTENT_TYPE,
    Histogram,
    default_buckets,
    render_prometheus,
    render_standard_gauges,
)
from polyaxon_tpu_torch.stats.tsdb import RatioWindow

__all__ = [
    "MemoryStats",
    "Histogram",
    "default_buckets",
    "render_prometheus",
    "render_standard_gauges",
    "PROMETHEUS_CONTENT_TYPE",
    "RatioWindow",
    "get_stats",
]

_default_stats = None
_default_stats_lock = threading.Lock()


def get_stats() -> MemoryStats:
    """Process-wide ``MemoryStats`` registry: what ``lm_server``'s engine
    records into, so one ``/metrics`` scrape of the process sees it all."""
    global _default_stats
    if _default_stats is None:
        with _default_stats_lock:
            if _default_stats is None:
                _default_stats = MemoryStats()
    return _default_stats
