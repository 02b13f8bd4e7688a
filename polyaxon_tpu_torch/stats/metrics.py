"""Log-bucketed histograms and Prometheus text exposition.

The port's own copy of ``polyaxon_tpu/stats/metrics.py`` (less
``fold_labeled_key``, ``Histogram.cumulative`` and the deprecated
``Histogram.reset``): :class:`Histogram` keeps count and sum per
geometric bucket, so a percentile costs O(buckets) memory for the life of
the process, and the buckets map 1:1 onto Prometheus histogram exposition.
Per-series labels ride inside a stats key in exposition syntax
(:func:`labeled_key`, as the fleet router and autoscaler key their series).
:func:`render_prometheus` turns a ``MemoryStats.snapshot()`` into text
exposition v0.0.4, the payload of ``lm_server``'s and the router's
``GET /metrics``.
"""

from __future__ import annotations

import math
import re
import time as _time
from bisect import bisect_left
from typing import Any, Dict, List, Mapping, Optional, Sequence

__all__ = [
    "Histogram",
    "default_buckets",
    "labeled_key",
    "split_labeled_key",
    "render_prometheus",
    "render_standard_gauges",
    "PROMETHEUS_CONTENT_TYPE",
]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def default_buckets(start: float = 1e-4, factor: float = 2.0, count: int = 20) -> List[float]:
    """Geometric bucket edges ``start * factor**k`` for k in [0, count): by
    default 100 µs .. ~52 s at 2x resolution."""
    edges: List[float] = []
    edge = start
    for _ in range(count):
        edges.append(edge)
        edge *= factor
    return edges


class Histogram:
    """Fixed-bucket histogram with cumulative export and quantile estimates.

    Not internally locked: ``MemoryStats`` serializes access.
    """

    __slots__ = ("edges", "counts", "count", "sum")

    def __init__(self, edges: Optional[Sequence[float]] = None) -> None:
        self.edges: List[float] = list(edges) if edges is not None else default_buckets()
        if not self.edges:
            raise ValueError("histogram needs at least one bucket edge")
        if any(b <= a for a, b in zip(self.edges, self.edges[1:])):
            raise ValueError("bucket edges must be strictly increasing")
        # One slot per edge plus the +Inf overflow bucket.
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile by linear interpolation within a bucket."""
        if self.count <= 0:
            return 0.0
        target = max(1.0, q * self.count)
        running = 0
        for i, n in enumerate(self.counts):
            if n and running + n >= target:
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i] if i < len(self.edges) else self.edges[-1]
                return lo + (hi - lo) * ((target - running) / n)
            running += n
        return self.edges[-1]

    def summary(self) -> Dict[str, float]:
        mean = self.sum / self.count if self.count else 0.0
        return {
            "count": float(self.count),
            "sum": self.sum,
            "mean": mean,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    def state(self) -> Dict[str, Any]:
        """Copyable snapshot (what ``MemoryStats.snapshot()`` exports)."""
        return {
            "edges": list(self.edges),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
        }


# -- Prometheus text exposition (v0.0.4) ---------------------------------------

_INVALID_NAME_CHARS = re.compile(r"[^a-zA-Z0-9_:]")

#: Fallback process start time when psutil is unavailable: first import of
#: this module, early in every entrypoint's life.
_IMPORT_TIME = _time.time()


def _process_start_time() -> float:
    try:
        import psutil

        return float(psutil.Process().create_time())
    except Exception:
        return _IMPORT_TIME


def _metric_name(key: str, prefix: str) -> str:
    name = _INVALID_NAME_CHARS.sub("_", key)
    if prefix:
        name = f"{prefix}_{name}"
    if not re.match(r"[a-zA-Z_:]", name):
        name = f"_{name}"
    return name


def _escape_label_value(value: Any) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


# Stats backends key counters and gauges by flat strings; per-series labels
# (``fleet_replica_state{replica="r0"}``) ride inside the key in exposition
# syntax, made by :func:`labeled_key` and split back out by the renderer so
# base labels merge in.  Labels are sorted: one series per (name, labels)
# whatever the caller's keyword order.
_LABELED_KEY = re.compile(r"^(?P<name>[^{]+)\{(?P<body>.*)\}$")
_LABEL_PAIR = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def labeled_key(name: str, **labels: Any) -> str:
    if not labels:
        return name
    body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items()))
    return f"{name}{{{body}}}"


def split_labeled_key(key: str) -> "tuple[str, Dict[str, str]]":
    m = _LABELED_KEY.match(key)
    if not m:
        return key, {}
    return m.group("name"), dict(_LABEL_PAIR.findall(m.group("body")))


def _labels(pairs: Mapping[str, Any]) -> str:
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs.items())
    return "{%s}" % body


def _fmt(value: float) -> str:
    v = float(value)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def render_prometheus(
    snapshot: Mapping[str, Any],
    prefix: str = "polyaxon_tpu",
    labels: Optional[Mapping[str, Any]] = None,
) -> str:
    """Render a ``MemoryStats.snapshot()`` as Prometheus text exposition.

    Counters get a ``_total`` suffix (not doubled on a key already named
    ``*_total``), gauges render verbatim, histograms as cumulative
    ``_bucket{le=...}`` series plus ``_sum`` and ``_count``.  ``labels`` are
    added to every sample, beside the labels a :func:`labeled_key` carries.
    """
    base_labels = dict(labels or {})
    lines: List[str] = []

    # Labeled keys of one metric sort next to each other, so one TYPE line
    # per name is "do not repeat the last one".
    last_typed = ""
    for key in sorted(snapshot.get("counters", {})):
        value = snapshot["counters"][key]
        base, own = split_labeled_key(key)
        name = _metric_name(base, prefix)
        if not name.endswith("_total"):
            name += "_total"
        if name != last_typed:
            lines.append(f"# TYPE {name} counter")
            last_typed = name
        lines.append(f"{name}{_labels(dict(base_labels, **own))} {_fmt(value)}")

    last_typed = ""
    for key in sorted(snapshot.get("gauges", {})):
        value = snapshot["gauges"][key]
        base, own = split_labeled_key(key)
        name = _metric_name(base, prefix)
        if name != last_typed:
            lines.append(f"# TYPE {name} gauge")
            last_typed = name
        lines.append(f"{name}{_labels(dict(base_labels, **own))} {_fmt(value)}")

    last_typed = ""
    for key in sorted(snapshot.get("histograms", {})):
        state = snapshot["histograms"][key]
        base, own = split_labeled_key(key)
        name = _metric_name(base, prefix)
        edges: Sequence[float] = state["edges"]
        counts: Sequence[int] = state["counts"]
        if name != last_typed:
            lines.append(f"# TYPE {name} histogram")
            last_typed = name
        series = dict(base_labels, **own)
        running = 0
        for edge, n in zip(edges, counts):
            running += n
            bucket_labels = dict(series)
            bucket_labels["le"] = _fmt(edge)
            lines.append(f"{name}_bucket{_labels(bucket_labels)} {running}")
        inf_labels = dict(series)
        inf_labels["le"] = "+Inf"
        lines.append(f"{name}_bucket{_labels(inf_labels)} {state['count']}")
        lines.append(f"{name}_sum{_labels(series)} {_fmt(state['sum'])}")
        lines.append(f"{name}_count{_labels(series)} {state['count']}")

    return "\n".join(lines) + "\n"


def render_standard_gauges(labels: Optional[Mapping[str, Any]] = None) -> str:
    """Exposition hygiene every scrape target carries: the standard
    ``process_start_time_seconds`` and a ``polyaxon_tpu_build_info``
    info-gauge whose ``version`` label is the port's version."""
    from polyaxon_tpu_torch import __version__ as version

    base_labels = dict(labels or {})
    info_labels = dict(base_labels)
    info_labels["version"] = version
    lines = [
        "# TYPE process_start_time_seconds gauge",
        f"process_start_time_seconds{_labels(base_labels)} {_fmt(_process_start_time())}",
        "# TYPE polyaxon_tpu_build_info gauge",
        f"polyaxon_tpu_build_info{_labels(info_labels)} 1",
    ]
    return "\n".join(lines) + "\n"
