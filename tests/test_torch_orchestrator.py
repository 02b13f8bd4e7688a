"""The port's control plane (``orchestrator.py``, ``scheduler/tasks.py``) on
its own gangs against the JAX ``Orchestrator`` on JAX gangs.

The reference's end-to-end flows, run on both planes with the same specs,
one package's builtins each: ``noop``; ``failing``; ``flaky_once`` under a
restart policy and a failing run that exhausts its policy; a running run
stopped; the 2-process ``synthetic_regression`` gang (losses within 1e-6:
float32, summation order); two runs on one registered slice, one after the
other; a stranded ``created`` run, a live gang reattached and a gang that
finished while no control plane ran, all recovered by a second
orchestrator; the lease; outputs synced to a ``file://`` store and a resume
from it after the run directories are wiped; a preempted tiny ``lm_train``
that resumes from its latest complete checkpoint.  What is compared: each
run's status sequence (``running`` left out: a run may finish within one
poll), its audited event types, its process rows, remediation rows and
status messages.  ``lm_train`` losses are not compared across the packages
(their RNGs differ).  ``recover`` re-kicks a group and a pipeline row and
``submit`` takes both kinds, on both planes alike.  A
subprocess runs a port ``Orchestrator`` and a gang with no module of
``polyaxon_tpu`` (or ``jax``) loaded in either.

Every wait polls to a deadline; the runs of each flow are submitted
together and share module fixtures.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from polyaxon_tpu.orchestrator import Orchestrator as JOrchestrator
from polyaxon_tpu_torch.exceptions import SchemaError
from polyaxon_tpu_torch.lifecycles import StatusOptions as S
from polyaxon_tpu_torch.orchestrator import Orchestrator as TOrchestrator
from polyaxon_tpu_torch.schemas import PolyaxonFile

REPO = Path(__file__).resolve().parents[1]
WAIT_S = 120.0
THREADS = {"OMP_NUM_THREADS": "1"}
TWO_HOSTS = {"accelerator": "cpu", "num_devices": 2, "num_hosts": 2, "mesh": {"data": 2}}
REGRESSION = {"lr": 0.5, "steps": 8, "batch": 16, "dim": 4}
TINY_LM = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, head_dim=16, d_ff=64,
               seq=16, batch=4)
PACKAGES = {"port": "polyaxon_tpu_torch", "jax": "polyaxon_tpu"}
PLANES = {"port": TOrchestrator, "jax": JOrchestrator}


def spec(package, entry, *, declarations=None, topology=None, **env):
    return {"kind": "experiment",
            "run": {"entrypoint": f"{package}.builtins.trainers:{entry}"},
            "declarations": dict(declarations or {}),
            "environment": {"seed": 11, "env_vars": dict(THREADS),
                            "topology": topology or {"accelerator": "cpu-1"}, **env}}


FLOWS = {
    "noop": ("noop", {}),
    "failing": ("failing", {}),
    "flaky": ("flaky_once", {"restart_policy": {"max_restarts": 2, "backoff_seconds": 0.1}}),
    "exhausted": ("failing", {"restart_policy": {"max_restarts": 1, "backoff_seconds": 0.1}}),
    "stopped": ("sleepy", {"declarations": {"seconds": 60.0}}),
    "regression": ("synthetic_regression", {"declarations": REGRESSION, "topology": TWO_HOSTS}),
    "counter": ("resume_counter", {}),
    "preempted": ("lm_train", {"declarations": dict(TINY_LM, steps=6, save_every=1,
                                                    preempt_step=4),
                               "restart_policy": {"max_restarts": 1, "backoff_seconds": 0.1}}),
}


def _plane(name, base, **env):
    old = {}
    import os

    for k, v in env.items():
        old[k] = os.environ.get(k)
        os.environ[k] = v
    try:
        return PLANES[name](base, monitor_interval=0.1, heartbeat_interval=0.2,
                            heartbeat_ttl=60.0)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    """Both control planes (a ``file://`` artifact store each) with every
    flow of FLOWS submitted: {package: (orchestrator, {flow: run id})}."""
    out = {}
    try:
        for name, package in PACKAGES.items():
            base = tmp_path_factory.mktemp(name)
            orch = _plane(name, base / "plat",
                          POLYAXON_TPU_STORES_ARTIFACTS_URL=f"file://{base}/artifacts")
            out[name] = orch, {flow: orch.submit(spec(package, entry, **dict(kw)), name=flow).id
                               for flow, (entry, kw) in FLOWS.items()}
        yield out
    finally:
        for orch, _ in out.values():
            orch.stop()


def _wait(orch, run_id, timeout=WAIT_S):
    return orch.wait(run_id, timeout=timeout)


def _record(orch, run_id):
    """What a flow leaves in the registry, ids and clocks left out."""
    run = orch.get_run(run_id)
    # The artifact sync's event comes off the bus thread after the run is
    # done: the sync has a test of its own.
    events = [a["event_type"] for a in reversed(orch.registry.get_activities())
              if (a.get("context") or {}).get("run_id") == run_id
              and a["event_type"] != "experiment.artifacts_synced"]
    return {
        "status": run.status,
        "restarts": run.restarts,
        "statuses": [(s["status"], s["message"]) for s in orch.registry.get_statuses(run_id)
                     if s["status"] != S.RUNNING],
        "events": events,
        "processes": [(p["process_id"], p["status"], p["exit_code"])
                      for p in orch.registry.get_processes(run_id)],
        "remediations": [(r["action"], r["trigger"], r["status"], r["message"],
                          {k: v for k, v in (r["attrs"] or {}).items() if k != "deadline"})
                         for r in orch.registry.get_remediations(run_id)],
    }


def _both(planes, flow, timeout=WAIT_S):
    got = {}
    for name, (orch, runs) in planes.items():
        _wait(orch, runs[flow], timeout)
        got[name] = _record(orch, runs[flow])
    return got


@pytest.mark.parametrize("flow,status,restarts", [
    ("noop", S.SUCCEEDED, 0), ("failing", S.FAILED, 0), ("flaky", S.SUCCEEDED, 1),
    ("exhausted", S.FAILED, 1)])
def test_a_run_ends_as_the_reference_s(planes, flow, status, restarts):
    got = _both(planes, flow)
    assert got["port"] == got["jax"]
    assert (got["port"]["status"], got["port"]["restarts"]) == (status, restarts)


def test_a_stopped_run_stops_as_the_reference_s(planes):
    for orch, runs in planes.values():
        deadline = time.monotonic() + WAIT_S
        while orch.get_run(runs["stopped"]).status != S.RUNNING:
            assert time.monotonic() < deadline, orch.get_run(runs["stopped"]).status
            orch.pump(max_wait=0.1)
        orch.stop_run(runs["stopped"], actor="tester")
    got = _both(planes, "stopped", timeout=30.0)
    assert got["port"] == got["jax"]
    assert got["port"]["status"] == S.STOPPED
    assert [s for s, _ in got["port"]["statuses"]][-2:] == [S.STOPPING, S.STOPPED]


def test_a_two_process_gang_logs_the_reference_s_losses(planes):
    got = _both(planes, "regression")
    assert got["port"] == got["jax"]
    assert got["port"]["processes"] == [(0, S.SUCCEEDED, 0), (1, S.SUCCEEDED, 0)]
    losses = {name: [(m["step"], m["values"]["loss"])
                     for m in orch.registry.get_metrics(runs["regression"])]
              for name, (orch, runs) in planes.items()}
    assert [s for s, _ in losses["port"]] == [s for s, _ in losses["jax"]] == [0, 5, 7]
    assert [x for _, x in losses["port"]] == pytest.approx([x for _, x in losses["jax"]],
                                                           abs=1e-6)


def test_a_preempted_run_resumes_from_its_latest_complete_checkpoint(planes):
    got = _both(planes, "preempted", timeout=180.0)
    assert got["port"] == got["jax"]
    assert (got["port"]["status"], got["port"]["restarts"]) == (S.SUCCEEDED, 1)
    (resume,) = [r for r in got["port"]["remediations"] if r[0] == "resume"]
    assert resume[2] == "succeeded" and resume[4]["from_step"] == 2
    for orch, runs in planes.values():
        logs = "\n".join(line["line"] for line in orch.registry.get_logs(runs["preempted"]))
        assert "restored checkpoint at step 2" in logs


def test_outputs_sync_and_a_clone_resumes_from_the_store(planes):
    got = {}
    for name, (orch, runs) in planes.items():
        done = _wait(orch, runs["counter"])
        deadline = time.monotonic() + WAIT_S
        while not [a for a in orch.registry.get_activities("experiment.artifacts_synced")
                   if a["context"]["run_id"] == done.id]:
            assert time.monotonic() < deadline
            orch.pump(max_wait=0.1)
        prefix = f"runs/{done.uuid}/"
        stored = sorted(k[len(prefix):] for k in orch.artifact_store.list(prefix.rstrip("/"))
                        if not k.startswith(prefix + "logs/"))
        listed = orch.list_artifacts(done.id)
        marker = orch.get_artifact(done.id, "outputs/attempt_1.marker")
        refused = orch.get_artifact(done.id, "../escape"), orch.artifact_local_path(done.id, "/abs")
        shutil.rmtree(orch.layout.run_paths(done.uuid).root)
        from_store = orch.get_artifact(done.id, "checkpoints/counter.txt")
        clone = orch.clone_run(done.id, strategy="resume")
        restored = (orch.layout.run_paths(clone.uuid).checkpoints / "counter.txt").read_text()
        again = _wait(orch, clone.id)
        got[name] = (stored, all(k in listed for k in stored), marker, refused, from_store,
                     restored, again.status, again.last_metric.get("counter"),
                     _record(orch, clone.id)["statuses"])
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (["checkpoints/counter.txt", "outputs/attempt_1.marker"], True)
    assert got["port"][5:8] == ("1", S.SUCCEEDED, 2.0)


def _admission(name, base):
    orch = _plane(name, base)
    try:
        orch.register_device("slice0", "cpu-1", 1)
        first = orch.submit(spec(PACKAGES[name], "sleepy", declarations={"seconds": 1.0}))
        second = orch.submit(spec(PACKAGES[name], "sleepy", declarations={"seconds": 0.2}))
        deadline = time.monotonic() + WAIT_S
        while orch.get_run(first.id).status != S.RUNNING:
            assert time.monotonic() < deadline
            orch.pump(max_wait=0.05)
        queued = orch.get_run(second.id).status
        holders = [d["holders"] for d in orch.registry.list_devices()]
        a, b = _wait(orch, first.id), _wait(orch, second.id)
        return (queued, holders, a.status, b.status, b.started_at >= a.finished_at - 0.05,
                [d["holders"] for d in orch.registry.list_devices()],
                _record(orch, first.id)["statuses"], _record(orch, second.id)["statuses"])
    finally:
        orch.stop()


def test_two_runs_on_one_slice_run_one_after_the_other(tmp_path):
    got = {name: _admission(name, tmp_path / name) for name in PACKAGES}
    assert got["port"] == got["jax"]
    assert got["port"][:6] == (S.QUEUED, [[1]], S.SUCCEEDED, S.SUCCEEDED, True, [[]])


def _until(orch, run_id, statuses):
    deadline = time.monotonic() + WAIT_S
    while orch.registry.get_run(run_id).status not in statuses:
        assert time.monotonic() < deadline, orch.registry.get_run(run_id).status
        orch.pump(max_wait=0.05)


def _recovery(name, base):
    """A control plane dies with a live gang (``sleepy``), a gang that then
    finishes on its own (``resume_counter``) and a run not yet dispatched;
    a second one recovers all three; a third defers to its lease."""
    package = PACKAGES[name]
    first = _plane(name, base)
    live = first.submit(spec(package, "sleepy", declarations={"seconds": 5.0}))
    ends = first.submit(spec(package, "resume_counter"))
    _until(first, live.id, (S.STARTING, S.RUNNING))
    _until(first, ends.id, (S.STARTING, S.RUNNING))
    stranded = first.submit(spec(package, "noop"))
    pids = [p["pid"] for p in first.registry.get_processes(live.id)]
    first.registry.close()  # the control plane's process died; its gangs did not
    # Wait for that gang to end on its own (the dead plane's handle only
    # polls its process; nothing drives the plane's bus).
    handle = first.ctx.gangs[ends.id]
    deadline = time.monotonic() + WAIT_S
    while not handle.all_exited:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    second = _plane(name, base)
    try:
        recovered = second.recover()
        reattached = live.id in second.ctx.gangs
        done = [_wait(second, r.id) for r in (live, ends, stranded)]
        out = {"recovered": recovered, "reattached": reattached,
               "statuses": [d.status for d in done], "counter": done[1].last_metric["counter"],
               "same_pids": [p["pid"] for p in second.registry.get_processes(live.id)] == pids,
               "records": [_record(second, r.id)["statuses"] for r in (live, ends, stranded)]}
        second.refresh_lease()
        third = _plane(name, base)
        try:
            out["lease"] = [third.another_control_plane_active(), third.recover()]
            second.stop()
            out["lease"] += [third.another_control_plane_active(), third.recover()]
        finally:
            third.stop()
    finally:
        second.stop()
    return out


def test_a_second_control_plane_recovers_what_the_first_left(tmp_path):
    got = {name: _recovery(name, tmp_path / name) for name in PACKAGES}
    assert got["port"] == got["jax"]
    assert got["port"]["recovered"] == 3 and got["port"]["reattached"]
    assert got["port"]["statuses"] == [S.SUCCEEDED] * 3 and got["port"]["same_pids"]
    assert got["port"]["counter"] == 1.0  # finalized from its reports, not re-run
    assert got["port"]["lease"] == [True, 0, False, 0]


def test_the_port_leaves_a_group_row_and_refuses_a_group(tmp_path):
    """Since search and pipelines are ported the port no longer leaves
    group and pipeline rows or refuses such specs: ``recover`` re-kicks a
    created group and a running pipeline as the reference's does (each
    counted), and ``submit`` takes a group (an ``hptuning`` section or a
    legacy top-level ``matrix``) and a pipeline."""
    docs = ({"kind": "group", "run": {"cmd": "x"},
             "hptuning": {"matrix": {"lr": {"values": [1]}}}},
            json.dumps({"run": {"cmd": "x"}, "hptuning": {"matrix": {"lr": {"values": [1]}}}}),
            {"run": {"cmd": "x"}, "matrix": {"lr": {"values": [1, 2]}}},
            {"kind": "pipeline", "ops": []})
    got = {}
    for name in PACKAGES:
        orch = _plane(name, tmp_path / name / "plat")
        try:
            group = orch.registry.create_run({"kind": "group", "run": {"cmd": "true"},
                                              "hptuning": {"matrix": {"lr": {"values": [1]}}}})
            running = orch.registry.create_run({"kind": "pipeline", "ops": []})
            orch.registry.set_status(running.id, S.RUNNING)
            got[name] = ([orch.recover(), orch.recover()], orch.get_run(group.id).status,
                         [orch.submit(doc).kind for doc in docs])
        finally:
            orch.stop()
    assert got["port"] == got["jax"]
    assert got["port"] == ([2, 2], S.CREATED, ["group", "group", "group", "pipeline"])
    with pytest.raises(SchemaError):  # a group still needs its run section
        PolyaxonFile.load({"kind": "group", "hptuning": {"matrix": {"lr": {"values": [1]}}}})


PROBE = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
from polyaxon_tpu_torch.orchestrator import Orchestrator
orch = Orchestrator(sys.argv[2], monitor_interval=0.1, heartbeat_interval=0.2)
run = orch.submit({"kind": "experiment", "run": {"entrypoint": "tests.torch_orch_probe:main"},
                   "environment": {"env_vars": {"OMP_NUM_THREADS": "1"},
                                   "topology": {"accelerator": "cpu-1"}}})
done = orch.wait(run.id, timeout=120)
gang = [json.loads(l["line"][len("modules "):]) for l in orch.registry.get_logs(run.id)
        if l["line"].startswith("modules ")]
plane = sorted({m.split(".")[0] for m in sys.modules})
orch.stop()
print(json.dumps({"status": done.status, "gang": gang, "plane": plane}))
"""


def test_the_port_plane_and_its_gangs_load_no_jax_package(tmp_path):
    proc = subprocess.run([sys.executable, "-c", PROBE, str(REPO), str(tmp_path / "plat")],
                          capture_output=True, text=True, timeout=180, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["status"] == S.SUCCEEDED and len(got["gang"]) == 1
    for roots in (got["plane"], got["gang"][0]):
        assert "polyaxon_tpu_torch" in roots
        assert not {"polyaxon_tpu", "jax", "jaxlib"} & set(roots), roots
    assert "torch" not in got["plane"]  # the control plane itself loads no torch
