"""The port's health checks against the JAX package's, and the knobs they
read.

Both packages' ``Orchestrator`` are put in the same state (runs in the
registry, two of them running with no heartbeat, a task pending on the bus,
a serving fleet of two replicas that never came up and one with an
autoscaler, a static-analysis state file) and every probe of ``CHECKS``
must give the reference's ``ok`` and detail string, including a full disk
faked through ``shutil.disk_usage`` and the lint state's four cases (none,
clean, stale, unsuppressed findings).  Where the port departs:

- ``check_compile_cache``: the same checks on the layout's cache dir and the
  same first half; its per-process half says the port keeps no persistent
  compile cache;
- ``check_devices``: ``torch.cuda``, ``False`` without a card (the
  reference reports JAX's CPU device).

The knobs ``POLYAXON_TPU_HOME``, ``_LINT_STATE`` and ``_LINT_STALE_S`` carry
the reference's names, types and defaults and read the environment as it
does.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import shutil
import time
from collections import namedtuple

import pytest

from polyaxon_tpu.checks import health as jhealth
from polyaxon_tpu.conf import knobs as jknobs
from polyaxon_tpu.orchestrator import Orchestrator as JOrchestrator
from polyaxon_tpu.serving.fleet import ServingFleet as JServingFleet
from polyaxon_tpu.serving.router import FleetRouter as JFleetRouter
from polyaxon_tpu_torch.checks import health
from polyaxon_tpu_torch.conf import knobs as tknobs
from polyaxon_tpu_torch.orchestrator import Orchestrator
from polyaxon_tpu_torch.serving.fleet import ServingFleet
from polyaxon_tpu_torch.serving.router import FleetRouter

PLANES = {"port": (Orchestrator, ServingFleet, FleetRouter, health),
          "jax": (JOrchestrator, JServingFleet, JFleetRouter, jhealth)}
SPEC = {"kind": "experiment", "run": {"cmd": "true"},
        "environment": {"topology": {"accelerator": "cpu-1"}}}
SAME = [name for name in jhealth.CHECKS if name != "compile_cache"]


def _state(orch, Fleet, Router, fleets):
    runs = [orch.registry.create_run(SPEC, name=f"r{i}") for i in range(3)]
    for run in runs[:2]:
        for status in ("queued", "scheduled", "starting", "running"):
            orch.registry.set_status(run.id, status)
    orch.submit(SPEC)  # one task pending on the bus, never pumped
    out = []
    for name, autoscaled in fleets:
        router = Router(probe_interval_s=60.0)
        for i in range(2):
            router.add_replica(f"{name}-r{i}", "http://127.0.0.1:9")  # never ready
        fleet = Fleet(orch, name=name, replicas=0, router=router)
        if autoscaled:
            fleet.attach_autoscaler(enabled=True, min_replicas=1, max_replicas=3)
        out.append(fleet)
    return out


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    """Both planes in one state: {package: (orchestrator, fleets, health)}."""
    out = {}
    try:
        for name, (Orch, Fleet, Router, mod) in PLANES.items():
            orch = Orch(tmp_path_factory.mktemp(name) / "plat", heartbeat_ttl=600.0)
            out[name] = orch, [], mod
            out[name][1].extend(_state(orch, Fleet, Router, [("a", False), ("b", True)]))
        yield out
    finally:
        for orch, fleets, _ in out.values():
            for fleet in fleets:
                fleet.stop()
            orch.stop()


def _as_reference(result):
    """A probe's (ok, detail) with the port's one departure in the static
    analysis probe's text put back: with no state the port names its own
    lint where the reference names its own and `make lint`."""
    ok, detail = result
    return ok, detail.replace("`python -m polyaxon_tpu_torch.analysis`)",
                              "`python -m polyaxon_tpu.analysis` or `make lint`)")


def _probe(planes, name):
    return {p: mod.CHECKS[name](orch) if name in mod.CHECKS else getattr(mod, name)(orch)
            for p, (orch, _, mod) in planes.items()}


@pytest.mark.parametrize("name", SAME)
def test_a_probe_reports_what_the_reference_reports(planes, name, tmp_path, monkeypatch):
    monkeypatch.setenv("POLYAXON_TPU_LINT_STATE", str(tmp_path / "absent.json"))
    got = _probe(planes, name)
    assert _as_reference(got["port"]) == got["jax"]
    if name == "static_analysis":
        assert "`python -m polyaxon_tpu_torch.analysis`" in got["port"][1]
    if name == "fleet":
        assert got["port"][0] is False and "a: 0/2 ready" in got["port"][1]
    if name == "autoscaler":
        assert got["port"][1].startswith("b: ")
    if name == "heartbeats":
        assert got["port"][1].startswith("2 running run(s) with heartbeat older than 600s")
    if name == "bus":
        assert got["port"][1].startswith("1 pending")


def test_the_compile_cache_probe_keeps_the_reference_checks(planes):
    got = _probe(planes, "compile_cache")
    assert got["port"][0] is got["jax"][0] is True
    first = {p: got[p][1].split("; ")[0].replace(str(orch.layout.base_dir), "<base>")
             for p, (orch, _, _) in planes.items()}
    assert first["port"] == first["jax"] == "0 cached executable(s) at <base>/compile_cache"
    assert got["port"][1].split("; ")[1] == health.NO_COMPILE_CACHE


_Usage = namedtuple("_Usage", "total used free")


@pytest.mark.parametrize("free", [1, 4, 5, 50])
def test_the_stores_probe_reads_a_faked_disk_as_the_reference_does(planes, free, monkeypatch):
    monkeypatch.setattr(shutil, "disk_usage", lambda path: _Usage(100, 100 - free, free))
    got = _probe(planes, "stores")
    assert got["port"] == got["jax"]
    assert got["port"][0] is (free >= 5)


LINT = {
    "clean": ({"ts": 0.0, "unsuppressed": 0, "suppressed": 2,
               "rules": {"GL001": {"version": 2}, "GL005": {"version": 1}}}, True),
    "stale": ({"ts": -8 * 86400.0, "unsuppressed": 0, "suppressed": 0,
               "rules": {"GL001": {"version": 2}}}, True),
    "findings": ({"ts": -30.0, "unsuppressed": 3, "suppressed": 1,
                  "by_rule": {"GL002": 2, "GL001": 1}, "rules": {"GL001": {"version": 2}}},
                 False),
    "garbled": (None, True),
}


@pytest.mark.parametrize("case", list(LINT))
def test_the_static_analysis_probe_reads_the_state_as_the_reference_does(planes, case,
                                                                         tmp_path, monkeypatch):
    state, ok = LINT[case]
    path = tmp_path / "last_run.json"
    if state is None:
        path.write_text("{not json")
    else:
        path.write_text(json.dumps(dict(state, ts=time.time() + state["ts"])))
    monkeypatch.setenv("POLYAXON_TPU_LINT_STATE", str(path))
    got = _probe(planes, "static_analysis")
    assert got["port"][0] is ok
    # The age in seconds is formatted from each probe's own clock.
    assert got["port"][0] == got["jax"][0]
    strip = lambda s: " ".join(w for w in s.split() if not w.rstrip("s").isdigit())  # noqa: E731
    assert strip(_as_reference(got["port"])[1]) == strip(got["jax"][1])
    monkeypatch.delenv("POLYAXON_TPU_LINT_STATE")
    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path))
    assert health.state_file_path() == tmp_path / "analysis" / "last_run.json"


def test_devices_is_false_without_a_card_and_the_report_is_the_reference_shape(planes,
                                                                              tmp_path,
                                                                              monkeypatch):
    import torch

    monkeypatch.setenv("POLYAXON_TPU_LINT_STATE", str(tmp_path / "absent.json"))
    ok, detail = health.check_devices(None)
    if torch.cuda.is_available():
        assert ok and torch.cuda.get_device_name(0) in detail
    else:
        assert ok is False and detail.startswith("no accelerator backend")
    reports = {p: mod.run_health_checks(orch, include_devices=True)
               for p, (orch, _, mod) in planes.items()}
    assert list(reports["port"]["checks"]) == list(reports["jax"]["checks"])
    assert reports["port"]["healthy"] is False  # fleet "a" routes nothing
    for name in SAME:
        port = reports["port"]["checks"][name]
        assert dict(port, detail=_as_reference((port["ok"], port["detail"]))[1]) == \
            reports["jax"]["checks"][name]
    assert health.task_counter_snapshot(planes["port"][0]).keys() == \
        jhealth.task_counter_snapshot(planes["jax"][0]).keys()
    assert health.task_counter_snapshot(object()) == {}


def test_stopping_a_fleet_unregisters_it(tmp_path):
    orch = Orchestrator(tmp_path / "plat")
    try:
        fleet = ServingFleet(orch, name="x", replicas=0)
        assert orch.fleets == [fleet] and fleet in orch.remediation._fleets
        assert health.check_fleet(orch) == (True, "x: 0/0 ready, ejections 0, shed rate 0.00%")
        fleet.stop()
        assert orch.fleets == [] and fleet not in orch.remediation._fleets
        assert health.check_fleet(orch) == (True, "no serving fleets registered")
        assert health.check_autoscaler(orch) == (True, "no fleet autoscaler attached")
    finally:
        orch.stop()


KNOBS = ["POLYAXON_TPU_HOME", "POLYAXON_TPU_LINT_STATE", "POLYAXON_TPU_LINT_STALE_S"]
_READERS = {"int": "knob_int", "float": "knob_float", "str": "knob_str"}
_SAMPLES = {"float": ("0.125", "nope", "86400"), "str": ("x", "", "~/elsewhere")}


@pytest.mark.parametrize("name", KNOBS)
def test_a_health_knob_equals_the_reference(name, monkeypatch):
    ref = jknobs.KNOBS[name]
    default = tknobs.KNOBS[name]
    assert type(default).__name__ == ref.kind and default == ref.default
    reader = _READERS[ref.kind]
    assert getattr(tknobs, reader)(name) == getattr(jknobs, reader)(name)
    for raw in _SAMPLES[ref.kind]:
        monkeypatch.setenv(name, raw)
        assert getattr(tknobs, reader)(name) == getattr(jknobs, reader)(name), raw
