"""Control-plane saturation loadgen, the port's copy of
``polyaxon_tpu/monitor/cploadgen.py``: the flight-instrument bench harness.

Everything else in ``monitor/`` watches *workloads*; this module watches
the *watcher*.  It builds a real control plane (registry + watcher +
alert engine + aiohttp API — the same objects ``serve`` wires up, minus
the task bus) and then leans on it the way a busy deployment would:

- a registry pre-populated with ~1000 historical runs, so every list
  query and retention-facing read pays realistic row counts;
- N concurrent fake gangs whose writer threads append progress /
  heartbeat / metric report lines at a configured rate — the watcher
  must tail every file through its bounded-read ingest path;
- a monitor thread driving ``watcher.observe`` + ``alerts.evaluate``
  over every gang at a monitor-tick cadence, exactly like the scheduler
  monitor task;
- an API hammer issuing concurrent reads (run list, run detail,
  statuses, alerts, /metrics) against the in-process aiohttp app.

Mid-flight one gang's progress lines stop while its heartbeats continue —
the alive-but-stuck shape — and the harness times how long the
stall→alert pipeline takes beyond the configured ``stall_after_s``
threshold.  The three numbers the ``controlplane_saturation`` bench
section gates on come straight out of this run:

- ``watcher_ingest_lag_p99_s``: p99 of the fleet ingest-lag histogram
  the watcher itself exports (now − newest ingested line's own wall
  time) — the single best "is the control plane keeping up" signal;
- ``alert_fire_latency_s``: wall time from the earliest moment the
  stall *could* fire to the ``run_stalled`` FIRING transition;
- ``api_p99_s``: client-side p99 over all hammer requests, measured
  while ingest and monitoring run concurrently.

No part of this module is imported by the control plane proper; it is a
bench/test harness with zero production dependencies beyond the package
itself.  It runs over the port's ``Orchestrator``, ``GangHandle``,
``GangPlan`` and ``api.app.create_app`` with the reference's arguments,
defaults and result keys, and like the control plane it loads no torch.
:data:`SPEC` is the reference's: it names the ``cpu`` accelerator and is
never dispatched.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from polyaxon_tpu_torch.compiler import GangPlan
from polyaxon_tpu_torch.lifecycles import StatusOptions as S
from polyaxon_tpu_torch.spawner.local import GangHandle

#: Minimal experiment spec — enough for ``create_run`` and the API's
#: run serializers; the loadgen never dispatches it.
SPEC: Dict[str, Any] = {
    "kind": "experiment",
    "run": {"entrypoint": "noop:main"},
    "environment": {"topology": {"accelerator": "cpu", "num_devices": 2}},
}


class _IdleRef:
    """ProcessRef stand-in that is forever alive (poll → None)."""

    pid = 0

    def poll(self) -> Optional[int]:
        return None

    def signal(self, sig: int) -> None:  # pragma: no cover - never signalled
        pass


def populate(registry: Any, n_runs: int) -> int:
    """Bulk-create ``n_runs`` historical runs so every registry read and
    list query pays realistic row volume.  Returns the count created."""
    for i in range(n_runs):
        registry.create_run(dict(SPEC), name=f"hist-{i}", project="loadgen")
    return n_runs


def make_gang(orch: Any, *, num_procs: int = 2, name: str = "gang") -> GangHandle:
    """One live fake gang: a real run row, RUNNING process rows (so
    ``reconcile`` rolls up RUNNING), real report files under the store
    layout, and a real ``GangHandle`` whose members never exit."""
    run = orch.registry.create_run(dict(SPEC), name=name, project="loadgen")
    paths = orch.layout.run_paths(run.uuid).ensure()
    plan = GangPlan(
        num_hosts=num_procs,
        devices_per_host=1,
        mesh_axes={"data": num_procs},
        strategy="data_parallel",
    )
    handle = GangHandle(
        run_id=run.id,
        run_uuid=run.uuid,
        plan=plan,
        paths=paths,
        processes={pid: _IdleRef() for pid in range(num_procs)},
    )
    for pid in range(num_procs):
        orch.registry.upsert_process(
            run.id, pid, pid=10_000 + pid, status=S.RUNNING
        )
    return handle


class _GangWriter(threading.Thread):
    """Appends report lines for every process of one gang at ``write_hz``.

    Clearing ``progress_on`` simulates the alive-but-stuck failure shape:
    heartbeats and metrics keep flowing (liveness stays fresh) while
    forward progress stops — exactly what the stall detector keys on.
    """

    def __init__(self, handle: GangHandle, *, write_hz: float, stop: threading.Event) -> None:
        super().__init__(daemon=True, name=f"loadgen-writer-{handle.run_id}")
        self.handle = handle
        self.interval = 1.0 / max(write_hz, 0.1)
        self.stop_event = stop
        self.progress_on = threading.Event()
        self.progress_on.set()
        #: Wall time of the last progress line written (stall T0 anchor).
        self.last_progress_at = 0.0
        self.step = 0

    def run(self) -> None:
        files = {
            pid: open(self.handle.paths.report_file(pid), "a", encoding="utf-8")
            for pid in range(self.handle.plan.num_hosts)
        }
        try:
            while not self.stop_event.is_set():
                now = time.time()
                self.step += 1
                for pid, fh in files.items():
                    lines = [
                        {"type": "heartbeat", "ts": now},
                        {
                            "type": "metric",
                            "ts": now,
                            "step": self.step,
                            "values": {"loss": 1.0 / self.step},
                        },
                    ]
                    if self.progress_on.is_set():
                        lines.append(
                            {
                                "type": "progress",
                                "step": self.step,
                                "at": now,
                                "ts": now,
                                "throughput": 100.0,
                            }
                        )
                        self.last_progress_at = now
                    for line in lines:
                        fh.write(json.dumps(line) + "\n")
                    fh.flush()
                self.stop_event.wait(self.interval)
        finally:
            for fh in files.values():
                fh.close()


class _MonitorLoop(threading.Thread):
    """The scheduler monitor task, reduced to its watcher+alerts core:
    one ``observe`` + ``evaluate`` pass per gang per tick.  Records the
    wall time of the first ``run_stalled`` FIRING transition."""

    def __init__(
        self,
        orch: Any,
        handles: List[GangHandle],
        *,
        interval_s: float,
        stop: threading.Event,
    ) -> None:
        super().__init__(daemon=True, name="loadgen-monitor")
        self.orch = orch
        self.handles = handles
        self.interval_s = interval_s
        self.stop_event = stop
        self.stall_fired_at: Optional[float] = None
        self.ticks = 0
        self.errors = 0

    def run(self) -> None:
        while not self.stop_event.is_set():
            self.ticks += 1
            for handle in self.handles:
                try:
                    self.orch.watcher.observe(handle)
                    transitions = self.orch.alerts.evaluate(handle)
                except Exception:
                    self.errors += 1
                    continue
                if self.stall_fired_at is None:
                    for row in transitions:
                        if (
                            row.get("rule") == "run_stalled"
                            and row.get("state") == "firing"
                        ):
                            self.stall_fired_at = time.time()
            self.stop_event.wait(self.interval_s)


async def _hammer_api(
    app: Any,
    paths: List[str],
    *,
    duration_s: float,
    concurrency: int,
    done: threading.Event,
) -> Dict[str, Any]:
    """Concurrent read hammer against the in-process aiohttp app; returns
    client-side latency samples.  Stops at ``duration_s`` or when the
    caller sets ``done`` (whichever is first)."""
    from aiohttp.test_utils import TestClient, TestServer

    latencies: List[float] = []
    errors = [0]
    server = TestServer(app)
    client = TestClient(server)
    await client.start_server()
    try:
        deadline = time.perf_counter() + duration_s

        async def worker(offset: int) -> None:
            i = offset
            while time.perf_counter() < deadline and not done.is_set():
                path = paths[i % len(paths)]
                i += 1
                t0 = time.perf_counter()
                try:
                    async with client.get(path) as resp:
                        await resp.read()
                        if resp.status >= 500:
                            errors[0] += 1
                except Exception:
                    errors[0] += 1
                latencies.append(time.perf_counter() - t0)

        await asyncio.gather(*(worker(i) for i in range(concurrency)))
    finally:
        await client.close()
    return {"latencies": latencies, "errors": errors[0]}


def _p99(samples: List[float]) -> Optional[float]:
    if not samples:
        return None
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1, int(0.99 * (len(ordered) - 1)))]


def run_saturation(
    base_dir: Union[str, Path],
    *,
    n_registry_runs: int = 1000,
    n_gangs: int = 8,
    procs_per_gang: int = 2,
    duration_s: float = 6.0,
    write_hz: float = 20.0,
    api_concurrency: int = 4,
    stall_after_s: float = 0.75,
    monitor_interval_s: float = 0.05,
) -> Dict[str, Any]:
    """One full saturation episode; returns the bench metrics dict.

    The ``run_stalled`` rule reads its threshold through the env knob
    (``RuleContext.anomaly`` resolves knobs, not watcher ctor state), so
    the stall window is installed via environment for the duration of
    the run and restored after.
    """
    from polyaxon_tpu_torch.api.app import API_PREFIX, create_app
    from polyaxon_tpu_torch.orchestrator import Orchestrator

    knobs = {"POLYAXON_TPU_STALL_AFTER_S": str(stall_after_s)}
    saved_env = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    stop = threading.Event()
    writers: List[_GangWriter] = []
    monitor: Optional[_MonitorLoop] = None
    try:
        orch = Orchestrator(base_dir, monitor_interval=monitor_interval_s)
        populate(orch.registry, n_registry_runs)
        # Alert cadence: evaluate every monitor pass — the throttle is the
        # thing under test, not a variable.
        orch.alerts.interval_s = 0.0
        orch.watcher.stall_after_s = stall_after_s

        handles = [
            make_gang(orch, num_procs=procs_per_gang, name=f"gang-{i}")
            for i in range(n_gangs)
        ]
        for handle in handles:
            writers.append(_GangWriter(handle, write_hz=write_hz, stop=stop))
        monitor = _MonitorLoop(
            orch, handles, interval_s=monitor_interval_s, stop=stop
        )
        for w in writers:
            w.start()
        monitor.start()

        stalled = writers[0]
        stall_at = time.perf_counter() + duration_s * 0.35

        async def drive() -> Dict[str, Any]:
            app = create_app(orch)
            rid = handles[-1].run_id
            paths = [
                f"{API_PREFIX}/runs?limit=50",
                f"{API_PREFIX}/runs/{rid}",
                f"{API_PREFIX}/runs/{rid}/statuses",
                f"{API_PREFIX}/alerts",
                "/metrics",
            ]
            hammer = asyncio.create_task(
                _hammer_api(
                    app,
                    paths,
                    duration_s=duration_s,
                    concurrency=api_concurrency,
                    done=stop,
                )
            )
            # Mid-flight stall injection: progress stops, heartbeats
            # continue — the alert must fire while the hammer still runs.
            await asyncio.sleep(max(0.0, stall_at - time.perf_counter()))
            stalled.progress_on.clear()
            return await hammer

        api_out = asyncio.run(drive())
        progress_stopped_at = stalled.last_progress_at or time.time()
        # Give the monitor loop a short grace window past the hammer to
        # catch a fire that lands right at the deadline.
        fire_deadline = time.time() + max(2.0, stall_after_s * 2)
        while monitor.stall_fired_at is None and time.time() < fire_deadline:
            time.sleep(monitor_interval_s)
    finally:
        stop.set()
        for w in writers:
            w.join(timeout=5)
        if monitor is not None:
            monitor.join(timeout=5)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    lag_summary = {}
    try:
        lag_summary = orch.stats.summaries().get("watcher_ingest_lag_s", {})
    except Exception:
        pass
    alert_fire_latency = None
    if monitor.stall_fired_at is not None:
        # Earliest possible fire = last progress beat + stall threshold;
        # anything beyond that is control-plane detection latency.
        alert_fire_latency = max(
            0.0, monitor.stall_fired_at - (progress_stopped_at + stall_after_s)
        )
    return {
        "n_registry_runs": n_registry_runs,
        "n_gangs": n_gangs,
        "procs_per_gang": procs_per_gang,
        "duration_s": duration_s,
        "write_hz": write_hz,
        "monitor_ticks": monitor.ticks,
        "monitor_errors": monitor.errors,
        "report_bytes_ingested": sum(
            sum(h.report_offsets.values()) for h in handles
        ),
        "watcher_ingest_lag_p99_s": (
            round(lag_summary["p99"], 4) if "p99" in lag_summary else None
        ),
        "watcher_ingest_lag_samples": int(lag_summary.get("count", 0)),
        "alert_fire_latency_s": (
            round(alert_fire_latency, 3)
            if alert_fire_latency is not None
            else None
        ),
        "api_requests": len(api_out["latencies"]),
        "api_errors": api_out["errors"],
        "api_p99_s": (
            round(_p99(api_out["latencies"]), 4)
            if api_out["latencies"]
            else None
        ),
    }


class _StubRouter:
    """In-process stand-in for ``serving/router.py``: advances its
    counters on every ``stats()`` read so the scraper's windowed deltas
    see monotonically growing traffic, and serves a full ``/v1/stats``
    field set per replica so the per-replica series fan-out is paid at
    realistic width."""

    def __init__(self, n_replicas: int) -> None:
        self.n_replicas = n_replicas
        self._requests = 0
        self._sheds = 0

    def stats(self) -> Dict[str, Any]:
        self._requests += 37
        self._sheds += 2
        return {
            "n_ready": self.n_replicas,
            "counters": {
                "requests": self._requests,
                "sheds": self._sheds,
                "retries": 0,
                "failovers": 0,
                "ejections": 0,
                "readmissions": 0,
                "drains": 0,
                "upstream_errors": 0,
            },
        }

    def replica_stats(self) -> Dict[str, Dict[str, Any]]:
        return {
            f"r{i}": {
                "slots": 8,
                "slots_active": i % 8,
                "queue_depth": i % 4,
                "blocks_free": 1000 - i,
                "block_occupancy": 0.5,
                "prefix_cache_hit_rate": 0.7,
                "prefix_cache_hit_rate_window": 0.65,
                "spec_accept_rate": 0.8,
                "spec_accept_rate_window": 0.75,
                "requests_submitted": self._requests,
                "requests_finished": max(0, self._requests - 1),
                "requests_shed": self._sheds,
                "tokens_generated": self._requests * 40,
                "tokens_per_s": 1200.0,
                "decode_steps": self._requests * 10,
            }
            for i in range(self.n_replicas)
        }


class _StubFleet:
    """Fleet stand-in the scraper sees through ``orch.fleets``."""

    def __init__(self, name: str, n_replicas: int) -> None:
        self.name = name
        self.router = _StubRouter(n_replicas)


def run_scrape_overhead(
    base_dir: Union[str, Path],
    *,
    n_registry_runs: int = 1000,
    n_replicas: int = 16,
    n_gangs: int = 4,
    duration_s: float = 4.0,
    monitor_interval_s: float = 0.05,
    api_duration_s: float = 2.0,
    api_concurrency: int = 2,
) -> Dict[str, Any]:
    """Measure the metric-history pipeline's two bench numbers:

    - ``scrape_share``: the scrape phase's fraction of the monitor
      tick's total work at the production cadence ratio — one full
      fleet scrape + registry flush per 25 ticks (default 5s scrape
      interval over the default 0.2s monitor interval), amortised over
      the whole run so throttled no-op passes count like they do in a
      real deployment;
    - ``query_p99_s``: client-side p99 of ``/api/v1/metrics/query`` and
      the per-run history read against the in-process aiohttp app, on a
      registry pre-populated with ``n_registry_runs`` historical runs.
    """
    from polyaxon_tpu_torch.api.app import API_PREFIX, create_app
    from polyaxon_tpu_torch.orchestrator import Orchestrator

    # Production fires one scrape per scrape_interval/monitor_interval
    # ticks (5s / 0.2s = 25); the bench compresses both intervals by the
    # same factor so the amortised phase share is cadence-faithful.
    scrape_every_ticks = 25
    knobs = {
        "POLYAXON_TPU_TSDB_ENABLED": "1",
        "POLYAXON_TPU_TSDB_SCRAPE_INTERVAL_S": str(
            monitor_interval_s * scrape_every_ticks
        ),
    }
    saved_env = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    stop = threading.Event()
    writers: List[_GangWriter] = []
    try:
        orch = Orchestrator(base_dir, monitor_interval=monitor_interval_s)
        populate(orch.registry, n_registry_runs)
        orch.alerts.interval_s = 0.0
        orch.fleets.append(_StubFleet("bench", n_replicas))
        handles = [
            make_gang(orch, num_procs=2, name=f"gang-scrape-{i}")
            for i in range(n_gangs)
        ]
        writers.extend(
            _GangWriter(h, write_hz=20.0, stop=stop) for h in handles
        )
        for w in writers:
            w.start()

        # Warm pass: first scrape allocates every series ring + the key
        # cache and first observe creates cursors — steady state is what
        # the phase-share gate is about.
        orch.scraper.tick(time.time())
        for handle in handles:
            orch.watcher.observe(handle)
            orch.alerts.evaluate(handle)

        # The scheduler fans the monitor tick out per gang but the
        # scraper throttles itself, so one pass here = one scrape check
        # plus a full watcher+alerts sweep — the same per-tick work mix.
        scrape_s = 0.0
        base_s = 0.0
        ticks = 0
        deadline = time.perf_counter() + duration_s
        while time.perf_counter() < deadline:
            ticks += 1
            t0 = time.perf_counter()
            orch.scraper.tick(time.time())
            t1 = time.perf_counter()
            for handle in handles:
                orch.watcher.observe(handle)
                orch.alerts.evaluate(handle)
            t2 = time.perf_counter()
            scrape_s += t1 - t0
            base_s += t2 - t1
            time.sleep(monitor_interval_s)

        rid = handles[0].run_id

        async def drive() -> Dict[str, Any]:
            app = create_app(orch)
            paths = [
                f"{API_PREFIX}/metrics/query?series=replica_slots_active"
                "&fleet=bench&step=1",
                f"{API_PREFIX}/metrics/query?series=router_requests_total"
                "&fleet=bench",
                f"{API_PREFIX}/runs/{rid}/metrics/history?limit=200",
            ]
            return await _hammer_api(
                app,
                paths,
                duration_s=api_duration_s,
                concurrency=api_concurrency,
                done=stop,
            )

        api_out = asyncio.run(drive())
    finally:
        stop.set()
        for w in writers:
            w.join(timeout=5)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    store_status = orch.metrics.status() if orch.metrics is not None else {}
    scraper_status = orch.scraper.status() if orch.scraper is not None else {}
    total = scrape_s + base_s
    return {
        "n_registry_runs": n_registry_runs,
        "n_replicas": n_replicas,
        "ticks": ticks,
        "scrape_s_total": round(scrape_s, 4),
        "tick_s_total": round(total, 4),
        "scrape_share": round(scrape_s / total, 4) if total > 0 else None,
        "series": store_status.get("series"),
        "dropped_samples": store_status.get("dropped"),
        "flushed_rows": scraper_status.get("flushed_rows"),
        "scrape_errors": scraper_status.get("errors"),
        "query_requests": len(api_out["latencies"]),
        "query_errors": api_out["errors"],
        "query_p99_s": (
            round(_p99(api_out["latencies"]), 4)
            if api_out["latencies"]
            else None
        ),
    }


def measure_idle_tick_us(base_dir: Union[str, Path], *, iters: int = 200) -> float:
    """Instrumentation overhead floor: µs per watcher+alerts pass over one
    idle gang (no new report lines, nothing pending).  This is the cost
    every deployment pays per monitor tick whether or not anything is
    happening — the number the bench holds to the ``alert_tick_us``-style
    budget."""
    from polyaxon_tpu_torch.orchestrator import Orchestrator

    orch = Orchestrator(base_dir)
    orch.alerts.interval_s = 0.0
    handle = make_gang(orch, num_procs=1, name="idle")
    # Warm the path (first observe creates cursors/rows).
    orch.watcher.observe(handle)
    orch.alerts.evaluate(handle)
    t0 = time.perf_counter()
    for _ in range(iters):
        orch.watcher.observe(handle)
        orch.alerts.evaluate(handle)
    return (time.perf_counter() - t0) / iters * 1e6
