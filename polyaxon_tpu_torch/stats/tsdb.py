"""Windowed ratios over cumulative counters.

The port's own copy of ``RatioWindow`` (and the ``CounterWindow`` it is made
of) from ``polyaxon_tpu/stats/tsdb.py``: "events over opportunities in the
last W seconds" for the engine's windowed prefix-hit and speculative-accept
rates and the fleet autoscaler's shed fraction.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional, Sequence, Tuple


def _increase(points: Sequence[Tuple[float, float]], since: float) -> Optional[float]:
    """Counter increase over ``[since, now]`` with reset clamping.

    Baseline = newest sample at or before ``since`` (else the oldest); the
    increase sums positive deltas from there on, and a decrease (a counter
    restart) counts the post-reset value.  Needs at least two samples.
    """
    if len(points) < 2:
        return None
    start = 0
    for i, (at, _v) in enumerate(points):
        if at <= since:
            start = i
        else:
            break
    total = 0.0
    prev = points[start][1]
    for _at, v in points[start + 1:]:
        total += v - prev if v >= prev else v
        prev = v
    return total


class CounterWindow:
    """Trailing window over one cumulative counter: ``(at, value)`` samples
    kept for ``horizon_s``, one at or before the window start always kept."""

    __slots__ = ("horizon_s", "_samples")

    def __init__(self, horizon_s: float = 600.0) -> None:
        self.horizon_s = float(horizon_s)
        self._samples: Deque[Tuple[float, float]] = deque()

    def observe(self, value: float, at: float) -> None:
        self._samples.append((float(at), float(value)))
        while len(self._samples) > 1 and self._samples[1][0] <= at - self.horizon_s:
            self._samples.popleft()

    def increase(self, window_s: float, now: float) -> Optional[float]:
        return _increase(list(self._samples), now - float(window_s))


class RatioWindow:
    """Windowed numerator/denominator pair over two cumulative counters."""

    __slots__ = ("num", "den")

    def __init__(self, horizon_s: float = 600.0) -> None:
        self.num = CounterWindow(horizon_s)
        self.den = CounterWindow(horizon_s)

    def observe(self, num: float, den: float, at: float) -> None:
        self.num.observe(num, at)
        self.den.observe(den, at)

    def deltas(self, window_s: float, now: float) -> Optional[Tuple[float, float]]:
        d_num = self.num.increase(window_s, now)
        d_den = self.den.increase(window_s, now)
        if d_num is None or d_den is None:
            return None
        return d_num, d_den

    def ratio(self, window_s: float, now: float) -> Optional[float]:
        d = self.deltas(window_s, now)
        if d is None:
            return None
        d_num, d_den = d
        return d_num / d_den if d_den > 0 else 0.0
