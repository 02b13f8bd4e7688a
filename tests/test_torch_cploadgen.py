"""The port's control-plane saturation harness (``monitor/cploadgen.py``)
against the JAX package's.

The reference's five flight-instrument tests
(``tests/test_monitor/test_flight_instruments.py``) run here against the
port's watcher, registry and ``Orchestrator``: the ingest-lag gauge rises
behind a backlog and recovers, resets at a terminal roll-up, and is absent
before anything is ingested; the monitor tick's phase histograms sum within
its wall (a real ``sleepy`` gang of the port's worker on the CPU, the
threads capped through the spec's ``env_vars``); the saturation smoke run
lands every bench metric.  Then both planes side by side: ``make_gang``
writes the same registry and process rows (uuids and times masked), and
``run_saturation``, ``run_scrape_overhead`` and ``measure_idle_tick_us`` at a
small size return the same keys with finite values.  No latency is compared
across planes.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import math
import time
from types import SimpleNamespace

import pytest

from polyaxon_tpu.monitor import cploadgen as jcploadgen
from polyaxon_tpu.orchestrator import Orchestrator as JOrchestrator
from polyaxon_tpu_torch.api.app import run_to_dict
from polyaxon_tpu_torch.db import RunRegistry
from polyaxon_tpu_torch.lifecycles import StatusOptions as S
from polyaxon_tpu_torch.monitor import GangWatcher, cploadgen
from polyaxon_tpu_torch.monitor.cploadgen import make_gang, run_saturation
from polyaxon_tpu_torch.orchestrator import Orchestrator
from polyaxon_tpu_torch.stats import MemoryStats
from polyaxon_tpu_torch.stats.metrics import labeled_key
from polyaxon_tpu_torch.stores import StoreLayout
from polyaxon_tpu.api.app import run_to_dict as jrun_to_dict
from tests.torch_api_parity import mask

PLANES = {"port": (cploadgen, Orchestrator, run_to_dict),
          "jax": (jcploadgen, JOrchestrator, jrun_to_dict)}

#: The reference test's small saturation run (test_flight_instruments.py:147-157).
SMOKE = dict(n_registry_runs=20, n_gangs=2, procs_per_gang=1, duration_s=1.5, write_hz=20.0,
             api_concurrency=2, stall_after_s=0.4, monitor_interval_s=0.05)


@pytest.fixture()
def rig(tmp_path):
    reg = RunRegistry(tmp_path / "registry.db")
    stats = MemoryStats()
    reg.attach_stats(stats)
    layout = StoreLayout(tmp_path / "store")
    watcher = GangWatcher(reg, stats=stats)
    return SimpleNamespace(registry=reg, layout=layout, stats=stats, watcher=watcher)


def _write_lines(handle, lines, process_id=0):
    with open(handle.paths.report_file(process_id), "a") as fh:
        for line in lines:
            fh.write(json.dumps(line) + "\n")


# -- the reference's five flight-instrument tests, against the port ----------

def test_lag_rises_behind_backlog_and_recovers_after_catchup(rig):
    handle = make_gang(rig, num_procs=1)
    key = labeled_key("watcher_ingest_lag_run_s", run=handle.run_id)
    now = time.time()
    _write_lines(handle, [{"type": "progress", "step": i, "at": now - 30 + i * 0.6, "ts": now}
                          for i in range(50)])
    # A tiny poll budget: the first observe reaches only the old lines.
    rig.watcher.max_poll_bytes = 256
    rig.watcher.observe(handle)
    assert rig.stats.gauges[key] > 5.0
    for _ in range(100):
        rig.watcher.observe(handle)
    assert rig.stats.gauges[key] < 2.0
    summary = rig.stats.summaries()["watcher_ingest_lag_s"]
    assert summary["count"] >= 2
    assert summary["p99"] > 0.0


def test_lag_gauge_resets_to_zero_on_terminal(rig):
    handle = make_gang(rig, num_procs=1)
    key = labeled_key("watcher_ingest_lag_run_s", run=handle.run_id)
    _write_lines(handle, [{"type": "progress", "step": 1, "at": time.time() - 7.0}])
    rig.watcher.observe(handle)
    assert rig.stats.gauges[key] > 5.0
    assert handle.ingest_lag_live
    handle.processes[0] = SimpleNamespace(poll=lambda: 0, pid=0)
    rig.watcher.observe(handle)
    assert rig.stats.gauges[key] == 0.0
    assert not handle.ingest_lag_live


def test_no_gauge_without_ingested_wall_times(rig):
    handle = make_gang(rig, num_procs=1)
    key = labeled_key("watcher_ingest_lag_run_s", run=handle.run_id)
    rig.watcher.observe(handle)
    assert key not in rig.stats.gauges


def test_phase_histograms_sum_close_to_tick_wall(tmp_path):
    orch = Orchestrator(tmp_path / "plat", monitor_interval=0.05, heartbeat_interval=0.2,
                        heartbeat_ttl=30.0)
    try:
        run = orch.submit({
            "kind": "experiment",
            "run": {"entrypoint": "polyaxon_tpu_torch.builtins.trainers:sleepy"},
            "declarations": {"seconds": 1.0},
            "environment": {"topology": {"accelerator": "cpu-1", "num_devices": 1,
                                         "num_hosts": 1},
                            "env_vars": {"OMP_NUM_THREADS": "1"}},
        })
        done = orch.wait(run.id, timeout=60)
        assert done.status == S.SUCCEEDED
        summaries = orch.stats.summaries()
        tick = summaries["monitor_tick_s"]
        assert tick["count"] >= 1
        phase_sums = []
        for phase in ("watcher", "alerts", "remediation"):
            s = summaries[labeled_key("tick_phase_s", phase=phase)]
            assert s["count"] >= 1, phase
            phase_sums.append(s["sum"])
        assert sum(phase_sums) <= tick["sum"] * 1.05 + 1e-3
        assert sum(phase_sums) >= tick["sum"] * 0.2
    finally:
        orch.stop()


def _smoke_assertions(out):
    assert out["monitor_errors"] == 0
    assert out["monitor_ticks"] > 0
    assert out["api_requests"] > 0
    assert out["api_errors"] == 0
    assert out["api_p99_s"] is not None and out["api_p99_s"] > 0.0
    assert out["watcher_ingest_lag_p99_s"] is not None
    assert out["watcher_ingest_lag_samples"] > 0
    assert out["report_bytes_ingested"] > 0
    assert out["alert_fire_latency_s"] is not None
    assert out["alert_fire_latency_s"] >= 0.0


def test_smoke_run_lands_every_bench_metric(tmp_path):
    _smoke_assertions(run_saturation(tmp_path / "plat", **SMOKE))


# -- both planes side by side ------------------------------------------------

def test_make_gang_writes_the_reference_s_rows(tmp_path):
    got = {}
    for plane, (mod, Orch, to_dict) in PLANES.items():
        orch = Orch(tmp_path / plane)
        try:
            handle = mod.make_gang(orch, num_procs=2, name="gang")
            run = orch.registry.get_run(handle.run_id)
            base = str(tmp_path / plane)
            got[plane] = mask({
                "run": to_dict(run),
                "processes": orch.registry.get_processes(handle.run_id),
                "statuses": [s["status"] for s in orch.registry.get_statuses(handle.run_id)],
                "handle": {"run_id": handle.run_id, "processes": sorted(handle.processes),
                           "poll": handle.poll(), "all_exited": handle.all_exited,
                           "plan": [handle.plan.num_hosts, handle.plan.devices_per_host,
                                    handle.plan.mesh_axes, handle.plan.strategy],
                           "report_files": [str(handle.paths.report_file(i)) for i in range(2)]},
            }, base)
            assert handle.paths.root.is_dir()
        finally:
            orch.stop()
    assert got["port"] == got["jax"]
    assert [p["status"] for p in got["port"]["processes"]] == [S.RUNNING, S.RUNNING]
    assert got["port"]["run"]["spec"]["environment"]["topology"]["accelerator"] == "cpu"


def test_run_saturation_on_both_planes(tmp_path):
    got = {plane: mod.run_saturation(tmp_path / plane, **SMOKE)
           for plane, (mod, _, _) in PLANES.items()}
    assert got["port"].keys() == got["jax"].keys()
    for out in got.values():
        _smoke_assertions(out)
        assert all(math.isfinite(v) for v in out.values())
    for key in SMOKE.keys() & got["port"].keys():
        assert got["port"][key] == got["jax"][key] == SMOKE[key]


def test_scrape_overhead_and_idle_tick_on_both_planes(tmp_path):
    small = dict(n_registry_runs=20, n_replicas=4, n_gangs=2, duration_s=0.5,
                 monitor_interval_s=0.05, api_duration_s=0.3, api_concurrency=2)
    got, idle = {}, {}
    for plane, (mod, _, _) in PLANES.items():
        got[plane] = mod.run_scrape_overhead(tmp_path / f"{plane}-scrape", **small)
        idle[plane] = mod.measure_idle_tick_us(tmp_path / f"{plane}-idle", iters=20)
    assert got["port"].keys() == got["jax"].keys()
    for plane, out in got.items():
        assert all(v is not None and math.isfinite(v) for v in out.values()), (plane, out)
        assert out["ticks"] > 0 and out["query_requests"] > 0 and out["query_errors"] == 0
        assert out["scrape_errors"] == 0 and out["dropped_samples"] == 0
        assert out["series"] > 0 and 0.0 <= out["scrape_share"] <= 1.0
        assert math.isfinite(idle[plane]) and idle[plane] > 0.0
    for key in ("n_registry_runs", "n_replicas"):
        assert got["port"][key] == got["jax"][key] == small[key]


def test_the_harness_keeps_the_reference_s_signature_and_spec():
    import inspect

    for name in ("populate", "make_gang", "run_saturation", "run_scrape_overhead",
                 "measure_idle_tick_us"):
        assert str(inspect.signature(getattr(cploadgen, name))) == \
            str(inspect.signature(getattr(jcploadgen, name))), name
    assert cploadgen.SPEC == jcploadgen.SPEC
    assert cploadgen._p99([3.0, 1.0, 2.0]) == jcploadgen._p99([3.0, 1.0, 2.0])
    assert cploadgen._p99([]) is None
