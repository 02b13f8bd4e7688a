"""The environment knobs the port reads, with the reference's names and defaults.

The port's own copy of the part of ``polyaxon_tpu/conf/knobs.py`` its
serving engine, its KV tiers, its tracer, its serving fleet (router,
fleet, autoscaler), its utilization ledger, its stall watchdog and its
resource sampler use: the same ``POLYAXON_TPU_*`` variables,
the same defaults, the same parsing (a bool is false for ``0``, ``false``,
``off``, ``no`` and the empty string; an unparsable number keeps the
default).  Reading a knob that is not in :data:`KNOBS` raises ``KeyError``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

_FALSY = ("0", "false", "off", "no", "")

#: name -> default (its type is the default's).
KNOBS: Dict[str, Any] = {
    "POLYAXON_TPU_SERVING_WARMUP": True,
    "POLYAXON_TPU_SERVING_SPEC_DECODE": False,
    "POLYAXON_TPU_SERVING_SPEC_K": 4,
    "POLYAXON_TPU_SERVING_SPEC_MIN_NGRAM": 2,
    "POLYAXON_TPU_SERVING_STATS_WINDOW_S": 60.0,
    # tracing
    "POLYAXON_TPU_TRACE_SAMPLE": 1.0,
    "POLYAXON_TPU_TRACE_HOT_SAMPLE": 0.05,
    "POLYAXON_TPU_TRACE_REQUESTS": True,
    "POLYAXON_TPU_TRACE_EXEMPLARS": 5,
    "POLYAXON_TPU_TRACE_EXEMPLAR_WINDOW_S": 300.0,
    # the utilization ledger
    "POLYAXON_TPU_LEDGER_INTERVAL_S": 30.0,
    # the stall watchdog (tracking/flightrec.py)
    "POLYAXON_TPU_WATCHDOG_K": 8.0,
    "POLYAXON_TPU_WATCHDOG_FLOOR_S": 30.0,
    "POLYAXON_TPU_WATCHDOG_CEILING_S": 600.0,
    "POLYAXON_TPU_WATCHDOG_INTERVAL_S": 1.0,
    "POLYAXON_TPU_PROGRESS_INTERVAL_S": 2.0,
    # the resource sampler (monitor/resources.py)
    "POLYAXON_TPU_RESOURCE_INTERVAL": 10.0,
    # the host KV tier and the persistent prefix store
    "POLYAXON_TPU_KV_OFFLOAD": False,
    "POLYAXON_TPU_KV_OFFLOAD_BLOCKS": 0,
    "POLYAXON_TPU_KV_PERSIST_DIR": "",
    "POLYAXON_TPU_KV_PERSIST_BLOCKS": 64,
    "POLYAXON_TPU_KV_PERSIST_INTERVAL_S": 60.0,
    # the fleet router
    "POLYAXON_TPU_ROUTER_PROBE_INTERVAL_S": 1.0,
    "POLYAXON_TPU_ROUTER_PROBE_TIMEOUT_S": 2.0,
    "POLYAXON_TPU_ROUTER_REQUEST_TIMEOUT_S": 600.0,
    "POLYAXON_TPU_ROUTER_SHED_OCCUPANCY": 0.95,
    "POLYAXON_TPU_ROUTER_RETRY_AFTER_S": 1.0,
    "POLYAXON_TPU_ROUTER_RETRY_LIMIT": 2,
    "POLYAXON_TPU_ROUTER_EJECT_FAILURES": 2,
    "POLYAXON_TPU_ROUTER_EJECT_BACKOFF_S": 1.0,
    "POLYAXON_TPU_ROUTER_EJECT_BACKOFF_MAX_S": 30.0,
    "POLYAXON_TPU_ROUTER_AFFINITY_TOKENS": 16,
    "POLYAXON_TPU_ROUTER_AFFINITY_SLACK": 0.25,
    "POLYAXON_TPU_ROUTER_AFFINITY_HIT_SLACK": 0.75,
    # the serving fleet
    "POLYAXON_TPU_FLEET_REPLICAS": 2,
    "POLYAXON_TPU_FLEET_DRAIN_DEADLINE_S": 30.0,
    "POLYAXON_TPU_FLEET_READY_TIMEOUT_S": 120.0,
    # the fleet autoscaler (a zero budget inherits the remediation budget)
    "POLYAXON_TPU_AUTOSCALER_ENABLED": True,
    "POLYAXON_TPU_AUTOSCALER_SHED_RATE": 0.05,
    "POLYAXON_TPU_AUTOSCALER_IDLE_OCCUPANCY": 0.1,
    "POLYAXON_TPU_AUTOSCALER_MIN_REPLICAS": 1,
    "POLYAXON_TPU_AUTOSCALER_MAX_REPLICAS": 4,
    "POLYAXON_TPU_AUTOSCALER_UP_HOLD_S": 5.0,
    "POLYAXON_TPU_AUTOSCALER_DOWN_HOLD_S": 30.0,
    "POLYAXON_TPU_AUTOSCALER_UP_COOLDOWN_S": 15.0,
    "POLYAXON_TPU_AUTOSCALER_DOWN_COOLDOWN_S": 60.0,
    "POLYAXON_TPU_AUTOSCALER_BUDGET": 0,
    "POLYAXON_TPU_REMEDIATION_BUDGET": 16,
}


def _default(name: str) -> Any:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(f"Unknown knob {name!r}: declare it in polyaxon_tpu_torch/conf/knobs.py") from None


def knob_str(name: str) -> str:
    default = _default(name)
    raw = os.environ.get(name)
    return default if raw is None else raw


def knob_bool(name: str) -> bool:
    default = _default(name)
    raw = os.environ.get(name)
    if raw is None:
        return bool(default)
    return raw.strip().lower() not in _FALSY


def knob_int(name: str) -> int:
    default = _default(name)
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(float(raw))
    except ValueError:
        return default


def knob_float(name: str) -> float:
    default = _default(name)
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default
