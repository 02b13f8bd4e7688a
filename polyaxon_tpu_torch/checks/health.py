"""Health checks, the port's copy of ``polyaxon_tpu/checks/health.py``: one
probe for each moving part of the port's control plane (the registry, the
task bus, the store filesystem, stale heartbeats, the compile-cache dir, the
alert and remediation engines, the serving fleets and their autoscalers, the
static-analysis state) and, where asked, the card; the report is a
``/status`` payload.

Three probes depart from the reference:

- :func:`check_devices` reads ``torch.cuda`` (imported inside the probe):
  the count of visible CUDA devices and the first one's name, and ``False``
  when none is visible.  It never reports the CPU instead.
- :func:`check_compile_cache` keeps the reference's checks on the layout's
  ``compile_cache_dir`` (creatable, writable, its entry count); its
  per-process part says that the port keeps no persistent compile cache: a
  CUDA graph is captured again at each start.  It loads no torch.
- :func:`check_static_analysis` reads the state that the port's own lint
  (``python -m polyaxon_tpu_torch.analysis``) records, through the port's
  ``analysis/reporter.py``: the same state file and keys as the
  reference's, but the rules it names are the port's (GL001 and GL002
  check CUDA-graph captures), and a probe that finds no state names the
  port's lint, not the reference's ``make lint``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

from polyaxon_tpu_torch.analysis.reporter import read_state, state_file_path
from polyaxon_tpu_torch.conf.knobs import knob_float


def check_registry(orch) -> Tuple[bool, str]:
    try:
        orch.registry.count_by_status()
        return True, "ok"
    except Exception as e:  # pragma: no cover - exercised via fault tests
        return False, f"registry error: {e}"


def check_bus(orch) -> Tuple[bool, str]:
    bus = orch.bus
    n_errors = len(getattr(bus, "errors", ()))
    detail = f"{bus.pending()} pending, {n_errors} dead-lettered tasks"
    # Dead-lettered tasks are diagnostic, not fatal — the bus itself is
    # healthy as long as it can report.
    return True, detail


def check_stores(orch) -> Tuple[bool, str]:
    base = orch.layout.base_dir
    if not os.access(base, os.W_OK):
        return False, f"store base dir {base} not writable"
    usage = shutil.disk_usage(base)
    free_frac = usage.free / usage.total
    if free_frac < 0.05:
        return False, f"disk nearly full ({free_frac:.1%} free)"
    return True, f"{free_frac:.0%} free"


def check_heartbeats(orch) -> Tuple[bool, str]:
    """Running runs with stale heartbeats — the zombie cron's worklist,
    surfaced here as diagnostic detail (the cron, not /status, acts on
    it; a wedged worker doesn't make the control plane unhealthy)."""
    ttl = getattr(getattr(orch, "ctx", None), "heartbeat_ttl", None) or 600.0
    stale = orch.registry.zombie_runs(ttl)
    if not stale:
        return True, "no stale heartbeats"
    ids = ", ".join(str(r.id) for r in stale[:5])
    more = f" (+{len(stale) - 5} more)" if len(stale) > 5 else ""
    return True, (
        f"{len(stale)} running run(s) with heartbeat older than "
        f"{ttl:.0f}s: {ids}{more}"
    )


#: The per-process part of :func:`check_compile_cache`'s detail.
NO_COMPILE_CACHE = (
    "this process: the port keeps no persistent compile cache "
    "(CUDA graphs are captured again at each start)"
)


def check_compile_cache(orch) -> Tuple[bool, str]:
    """Compile-cache dir readiness: the per-layout cache dir must be
    creatable and writable.  The port's workers write nothing there: an
    eager step has no executable to cache, and a CUDA graph is captured
    again at each start (see :data:`NO_COMPILE_CACHE`)."""
    cache_dir = orch.layout.compile_cache_dir
    try:
        cache_dir.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        return False, f"cache dir {cache_dir} not creatable: {e}"
    if not os.access(cache_dir, os.W_OK):
        return False, f"cache dir {cache_dir} not writable"
    try:
        entries = sum(1 for _ in cache_dir.iterdir())
    except OSError:
        entries = 0
    return True, f"{entries} cached executable(s) at {cache_dir}; {NO_COMPILE_CACHE}"


def check_alerts(orch) -> Tuple[bool, str]:
    """Alert-engine liveness: is the rule engine ticking, and are rule
    evaluations erroring (counted, never raised — so /status is the place
    they surface).  Unhealthy only when gangs are live but the engine has
    not ticked for many multiples of its interval — an idle control plane
    legitimately never ticks."""
    engine = getattr(orch, "alerts", None)
    if engine is None:
        return True, "alert engine not wired"
    st = engine.status()
    errors = f", {st['eval_errors']} rule-eval error(s)" if st["eval_errors"] else ""
    gangs = getattr(getattr(orch, "ctx", None), "gangs", None) or {}
    if not st["ticks"]:
        if gangs:
            return False, (
                f"{len(gangs)} live gang(s) but the engine has never ticked"
            )
        return True, f"{len(st['rules'])} rules armed, no live runs yet{errors}"
    age = time.time() - st["last_tick_at"]
    if gangs and age > max(10.0, 10 * st["interval_s"]):
        return False, (
            f"last tick {age:.0f}s ago with {len(gangs)} live gang(s){errors}"
        )
    return True, (
        f"{len(st['rules'])} rules, {st['ticks']} ticks, "
        f"last {age:.1f}s ago{errors}"
    )


def check_remediation(orch) -> Tuple[bool, str]:
    """Remediation-engine posture: wired, enabled, and whether its
    reactions are erroring (counted, never raised — same contract as the
    alert engine).  Reaction errors with zero successful actions mean the
    reflex arc is broken, not merely noisy."""
    engine = getattr(orch, "remediation", None)
    if engine is None:
        return True, "remediation engine not wired"
    try:
        st = engine.status()
    except Exception as e:
        return False, f"status() failed: {type(e).__name__}: {e}"
    if not st["enabled"]:
        return True, "disabled (POLYAXON_TPU_REMEDIATION_ENABLED=0)"
    if st["errors"] and not st["actions"]:
        return False, f"{st['errors']} reaction error(s), no action succeeded"
    evict = "on" if st["evict_enabled"] else "off"
    errors = f", {st['errors']} reaction error(s)" if st["errors"] else ""
    return True, (
        f"enabled, {st['actions']} action(s), budget {st['budget']}/run, "
        f"evict {evict}{errors}"
    )


def check_fleet(orch) -> Tuple[bool, str]:
    """Serving-fleet posture: replica states, ejections, and shed rate
    per registered fleet.  No fleets is fine (most control planes serve
    nothing); a fleet whose every replica is unroutable is not — traffic
    is being refused while the registry thinks the runs are healthy."""
    fleets = getattr(orch, "fleets", None) or []
    if not fleets:
        return True, "no serving fleets registered"
    parts = []
    ok = True
    for fleet in fleets:
        try:
            st = fleet.status()
        except Exception as e:
            ok = False
            parts.append(f"{getattr(fleet, 'name', '?')}: status() failed: {e}")
            continue
        router = st.get("router") or {}
        by_state = router.get("by_state") or {}
        n_ready = int(router.get("n_ready") or 0)
        total = sum(by_state.values())
        counters = router.get("counters") or {}
        if total and not n_ready:
            ok = False
        states = ", ".join(f"{k}={v}" for k, v in sorted(by_state.items()))
        parts.append(
            f"{st.get('name', '?')}: {n_ready}/{total} ready"
            + (f" ({states})" if states else "")
            + f", ejections {counters.get('ejections', 0)}"
            + f", shed rate {router.get('shed_rate', 0.0):.2%}"
            + (
                f", {len(st.get('open_ops') or {})} drain/replace open"
                if st.get("open_ops")
                else ""
            )
        )
    return ok, "; ".join(parts)


def check_autoscaler(orch) -> Tuple[bool, str]:
    """Autoscaler posture per fleet: state, last decision, and budget
    headroom.  No autoscaled fleet is fine (fixed-size fleets are a
    choice); an autoscaler with zero budget remaining is diagnostic —
    the fleet can no longer self-size and an operator should know."""
    fleets = getattr(orch, "fleets", None) or []
    scalers = [
        f.autoscaler
        for f in fleets
        if getattr(f, "autoscaler", None) is not None
    ]
    if not scalers:
        return True, "no fleet autoscaler attached"
    parts = []
    for scaler in scalers:
        try:
            st = scaler.status()
        except Exception as e:
            return False, f"status() failed: {type(e).__name__}: {e}"
        last = st.get("last_decision") or {}
        decision = (
            f"last {last.get('direction')}:{last.get('outcome')}"
            if last
            else "no decisions yet"
        )
        parts.append(
            f"{st['fleet']}: {st['state']}"
            + ("" if st["enabled"] else " (disabled)")
            + f", target {st['target_replicas']} "
            + f"[{st['min_replicas']}..{st['max_replicas']}]"
            + f", shed {st['shed_rate']:.2%}, occ {st['occupancy']:.2f}"
            + f", {decision}, budget {st['budget_remaining']}/{st['budget']}"
        )
    return True, "; ".join(parts)


def check_static_analysis(orch) -> Tuple[bool, str]:
    """Static-analysis posture: what the last recorded run found, and whether
    it is stale.  Never-run and stale are diagnostic (ok=True) — a fresh
    deployment hasn't linted yet and that shouldn't page anyone; recorded
    *unsuppressed findings* are a real defect signal (ok=False)."""
    state = read_state()
    if state is None:
        return True, (
            f"never run (no state at {state_file_path()}; "
            "run `python -m polyaxon_tpu_torch.analysis`)"
        )
    rules = ", ".join(
        f"{rid} v{meta['version']}"
        for rid, meta in sorted((state.get("rules") or {}).items())
    )
    age = time.time() - float(state.get("ts", 0.0))
    stale_after = knob_float("POLYAXON_TPU_LINT_STALE_S")
    unsuppressed = int(state.get("unsuppressed", 0))
    suppressed = int(state.get("suppressed", 0))
    if unsuppressed:
        by_rule = state.get("by_rule") or {}
        worst = ", ".join(f"{k}={v}" for k, v in sorted(by_rule.items()))
        return False, (
            f"last run recorded {unsuppressed} unsuppressed finding(s) "
            f"({worst}) {age:.0f}s ago [{rules}]"
        )
    freshness = (
        f"stale ({age / 86400.0:.1f}d old)" if age > stale_after
        else f"{age:.0f}s old"
    )
    return True, (
        f"clean, {suppressed} suppressed finding(s), {freshness} [{rules}]"
    )


def check_devices(orch) -> Tuple[bool, str]:
    """Card visibility — only meaningful in-process on a worker/bench host;
    the control plane itself may legitimately see no card."""
    try:
        import torch

        n = torch.cuda.device_count()
        if n < 1:
            return False, "no accelerator backend: no CUDA device is visible"
        return True, f"{n}x {torch.cuda.get_device_name(0)}"
    except Exception as e:
        return False, f"no accelerator backend: {e}"


CHECKS: Dict[str, Callable] = {
    "registry": check_registry,
    "bus": check_bus,
    "stores": check_stores,
    "heartbeats": check_heartbeats,
    "compile_cache": check_compile_cache,
    "alerts": check_alerts,
    "remediation": check_remediation,
    "fleet": check_fleet,
    "autoscaler": check_autoscaler,
    "static_analysis": check_static_analysis,
}


def run_health_checks(orch, include_devices: bool = False) -> Dict[str, Any]:
    checks = dict(CHECKS)
    if include_devices:
        checks["devices"] = check_devices
    results = {}
    healthy = True
    for name, fn in checks.items():
        try:
            ok, detail = fn(orch)
        except Exception as e:  # a probe crashing is itself a failure
            ok, detail = False, f"probe crashed: {e}"
        results[name] = {"ok": ok, "detail": detail}
        healthy = healthy and ok
    return {"healthy": healthy, "checks": results, "at": time.time()}


def task_counter_snapshot(orch, top: int = 20) -> Dict[str, int]:
    """Top task counters from an in-memory stats backend ({} otherwise).

    Uses the backend's locked ``snapshot()``: the bus thread inserts keys
    concurrently and iterating the live mapping would race.
    """
    stats = getattr(orch, "stats", None)
    snapshot = getattr(stats, "snapshot", None)
    if snapshot is None:
        return {}
    counters = snapshot().get("counters") or {}
    return dict(sorted(counters.items(), key=lambda kv: -kv[1])[:top])
