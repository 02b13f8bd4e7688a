"""The environment knobs the port reads, with the reference's names and defaults.

The port's own copy of the part of ``polyaxon_tpu/conf/knobs.py`` its
gang env contract (``runtime/env.py``), its serving engine, its KV tiers,
its tracer, its serving fleet (router, fleet, autoscaler), its utilization
ledger, its stall watchdog, its resource sampler, its gang worker and its
control plane (the registry's retention sweep, the secret options' key,
the watcher, the alert and remediation engines, the metric history, the
notifier's fallbacks, the health checks' static-analysis state), its API,
its CLI and its static analysis (``analysis/``, whose GL005 holds this
catalog and the code to each other) use: the
same ``POLYAXON_TPU_*`` variables, the same defaults, the same parsing (a
bool is false for ``0``, ``false``, ``off``, ``no`` and the empty string; an
unparsable number keeps the default).  Reading a knob that is not in
:data:`KNOBS` raises ``KeyError``.  A family (:data:`FAMILIES`) is a
declared prefix with dynamic suffixes, read through the ``family_*``
accessors: ``POLYAXON_TPU_ALERT_<RULE>_<PARAM>``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

_FALSY = ("0", "false", "off", "no", "")

#: name -> default (its type is the default's; None where the reference
#: declares none, and a read of an unset one gives None).
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
    # the gang rendezvous contract (runtime/env.py: the spawner writes these,
    # the worker reads them; None where the reference declares no default)
    "POLYAXON_TPU_RUN_ID": None,
    "POLYAXON_TPU_RUN_UUID": None,
    "POLYAXON_TPU_RUN_DIR": None,
    "POLYAXON_TPU_SPEC_PATH": None,
    "POLYAXON_TPU_PROCESS_ID": None,
    "POLYAXON_TPU_NUM_PROCESSES": None,
    "POLYAXON_TPU_COORDINATOR": "",
    "POLYAXON_TPU_DEVICES_PER_HOST": 1,
    "POLYAXON_TPU_ACCELERATOR": "cpu",
    "POLYAXON_TPU_MESH": "{}",
    "POLYAXON_TPU_MESH_DCN": "{}",
    "POLYAXON_TPU_STRATEGY": "ddp",
    "POLYAXON_TPU_STRATEGY_OPTIONS": "{}",
    "POLYAXON_TPU_HEARTBEAT_INTERVAL": 5.0,
    "POLYAXON_TPU_SEED": None,
    "POLYAXON_TPU_DATA_DIR": "",
    "POLYAXON_TPU_COMPILE_CACHE_DIR": "",
    # a service gang's dispatch-time port (runtime/worker.py)
    "POLYAXON_TPU_SERVICE_PORT": "",
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
    # the control plane's state: the registry's retention sweep and the
    # key of secret options at rest (conf/encryptor.py)
    "POLYAXON_TPU_RETENTION_SWEEP_ROWS": 20000,
    "POLYAXON_TPU_SECRET_KEY": "",
    # the gang watcher and its stall / straggler detector
    "POLYAXON_TPU_WATCHER_POLL_BYTES": 4 * 1024 * 1024,
    "POLYAXON_TPU_STALL_AFTER_S": 60.0,
    "POLYAXON_TPU_STRAGGLER_LAG_STEPS": 50.0,
    "POLYAXON_TPU_STALL_HEARTBEAT_FRESH_S": 30.0,
    # the alert engine (its rule parameters are the ALERT_ family)
    "POLYAXON_TPU_ALERT_INTERVAL_S": 1.0,
    # the remediation engine
    "POLYAXON_TPU_REMEDIATION_ENABLED": True,
    "POLYAXON_TPU_REMEDIATION_BACKOFF_BASE_S": "",
    "POLYAXON_TPU_REMEDIATION_BACKOFF_MAX_S": 300.0,
    "POLYAXON_TPU_REMEDIATION_CHECKPOINT_ALERTS": "run_stalled",
    "POLYAXON_TPU_REMEDIATION_EVICT": False,
    "POLYAXON_TPU_REMEDIATION_COMMAND_TIMEOUT_S": 30.0,
    "POLYAXON_TPU_REMEDIATION_DRAIN_ALERTS": "serving_ttft_p99,heartbeat_stale",
    # the metric history (in-process TSDB and the monitor tick's scrape)
    "POLYAXON_TPU_TSDB_ENABLED": True,
    "POLYAXON_TPU_TSDB_SCRAPE_INTERVAL_S": 5.0,
    "POLYAXON_TPU_TSDB_RAW_POINTS": 720,
    "POLYAXON_TPU_TSDB_ROLLUP_POINTS": 360,
    "POLYAXON_TPU_TSDB_MAX_SERIES": 2048,
    "POLYAXON_TPU_TSDB_FLUSH_ROWS": 512,
    "POLYAXON_TPU_TSDB_PENDING_MAX": 8192,
    "POLYAXON_TPU_BASELINE_ALPHA": 0.3,
    # the notifier's fallbacks for the notifier.webhook_* options
    "POLYAXON_TPU_WEBHOOK_URL": "",
    "POLYAXON_TPU_WEBHOOK_KIND": "",
    # the platform's state dir, and the static-analysis state that
    # checks/health.py's check_static_analysis reads ('' = under the home)
    "POLYAXON_TPU_HOME": "~/.polyaxon_tpu",
    "POLYAXON_TPU_LINT_STATE": "",
    "POLYAXON_TPU_LINT_STALE_S": 7 * 86400.0,
    # the API (its bearer token, the metric query's cap, a WS tail's batch)
    "POLYAXON_TPU_AUTH_TOKEN": "",
    "POLYAXON_TPU_TSDB_QUERY_MAX_POINTS": 2000,
    "POLYAXON_TPU_WS_TAIL_MAX_BATCH": 500,
}

#: Declared prefixes of knobs with dynamic suffixes.
FAMILIES = ("POLYAXON_TPU_ALERT_",)


def _default(name: str) -> Any:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(f"Unknown knob {name!r}: declare it in polyaxon_tpu_torch/conf/knobs.py") from None


def knob_default(name: str) -> Any:
    """The catalog default for ``name``."""
    return _default(name)


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


def family_prefix(prefix: str) -> str:
    """``prefix``, which must be a declared family."""
    if prefix not in FAMILIES:
        raise KeyError(f"Unknown knob family {prefix!r}: declare it in polyaxon_tpu_torch/conf/knobs.py")
    return prefix


def family_value(prefix: str, suffix: str) -> Optional[str]:
    """Raw read of a family member (None when unset)."""
    return os.environ.get(family_prefix(prefix) + suffix)


def family_float(prefix: str, suffix: str, default: float) -> float:
    raw = family_value(prefix, suffix)
    if raw is None:
        return default
    try:
        return float(raw)
    except (TypeError, ValueError):
        return default
