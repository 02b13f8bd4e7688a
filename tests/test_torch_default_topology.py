"""A spec naming no accelerator runs on the card, on every path that creates a run.

The schema's default topology is the reference's (``accelerator: cpu``, 8
devices), and ``spec.to_dict()`` keeps it, as the schema parity tests hold.
What a port run row stores is the topology that runs: where the spec names
no accelerator, the card (``h100``, one device on one host where the spec
gives no counts), with the spec's other topology keys kept
(``TopologyConfig.stored``).  So the port's worker, its scheduler and the
API's ``spec`` all read the card, and on a host without one the run fails
with the worker's ``GangLayoutError``; it never succeeds on the CPU.

Each path that creates a run is taken, on both planes, with no topology and
with a topology that names no accelerator: ``submit``, a clone (``restart``
of a submitted run), a one-trial group, a one-op pipeline and a CI trigger.
The JAX plane keeps the reference's behaviour: it stores ``cpu`` and runs
on JAX's CPU.  Both planes submit all their runs at once and share one
orchestrator each (module fixtures).
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import time

import pytest

from polyaxon_tpu.orchestrator import Orchestrator as JOrchestrator
from polyaxon_tpu_torch.orchestrator import Orchestrator as TOrchestrator
from polyaxon_tpu_torch.schemas import PolyaxonFile

PLANES = {"port": (TOrchestrator, "polyaxon_tpu_torch"), "jax": (JOrchestrator, "polyaxon_tpu")}
PATHS = ("submit", "clone", "group_trial", "pipeline_op", "ci_trigger")
#: The two ways to name no accelerator: no topology, and a topology with
#: other keys only (which the port keeps).
TOPOLOGIES = {"no_topology": None,
              "no_accelerator": {"strategy": "fsdp", "num_devices": 1, "num_hosts": 1}}
WAIT_S = 120.0


def _spec(package, topology, kind="experiment"):
    environment = {"env_vars": {"OMP_NUM_THREADS": "1"}}
    if topology is not None:
        environment["topology"] = dict(topology)
    return {"kind": kind, "run": {"entrypoint": f"{package}.builtins.trainers:noop"},
            "environment": environment}


def _drive(orch, ids, deadline):
    while time.time() < deadline:
        orch.pump(max_wait=0.05)
        if all(orch.get_run(i).is_done for i in ids.values()):
            return
    raise AssertionError({k: orch.get_run(i).status for k, i in ids.items()})


def _children(orch, **parent):
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        runs = orch.registry.list_runs(**parent)
        if runs:
            return runs
        orch.pump(max_wait=0.05)
    raise AssertionError(f"no run under {parent}")


def _outcomes(plane, base):
    """Every path's run on ``plane``: {(path, topology): (stored topology,
    status, the run's log text)}."""
    cls, package = PLANES[plane]
    orch = cls(base, monitor_interval=0.05, heartbeat_interval=0.2)
    code = base / "code"
    code.mkdir(parents=True)
    (code / "main.py").write_text("print('ci')\n")
    try:
        deadline = time.time() + WAIT_S
        ids = {}
        for name, topology in TOPOLOGIES.items():
            ids["submit", name] = orch.submit(_spec(package, topology)).id
            group = dict(_spec(package, topology, "group"),
                         hptuning={"concurrency": 1, "matrix": {"x": {"values": [1]}}})
            ids["group", name] = orch.submit(group).id
            op = {k: v for k, v in _spec(package, topology).items() if k != "kind"}
            if topology is None:
                op.pop("environment")
            pipeline = {"kind": "pipeline", "ops": [dict(op, name="only")]}
            ids["pipeline", name] = orch.submit(pipeline).id
            orch.set_project_ci(f"ci-{name}", _spec(package, topology))
            ids["ci_trigger", name] = orch.trigger_ci(f"ci-{name}", context=str(code)).id
        for name in TOPOLOGIES:
            ids["group_trial", name] = _children(orch, group_id=ids.pop(("group", name)))[0].id
            ids["pipeline_op", name] = _children(
                orch, pipeline_id=ids.pop(("pipeline", name)))[0].id
        _drive(orch, ids, deadline)
        for name in TOPOLOGIES:
            ids["clone", name] = orch.clone_run(ids["submit", name], "restart").id
        _drive(orch, ids, deadline)
        out = {}
        for key, run_id in ids.items():
            run = orch.get_run(run_id)
            logs = "\n".join(row["line"] for row in orch.registry.get_logs(run_id))
            out[key] = (run.spec_data["environment"]["topology"], run.status, logs)
        return out
    finally:
        orch.stop()


_CACHE = {}


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    def get(plane):
        if plane not in _CACHE:
            _CACHE[plane] = _outcomes(plane, tmp_path_factory.mktemp(plane))
        return _CACHE[plane]

    yield get
    _CACHE.clear()


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
@pytest.mark.parametrize("path", PATHS)
def test_the_port_stores_the_card_and_fails_without_one(outcomes, path, topology):
    stored, status, logs = outcomes("port")[path, topology]
    assert stored["accelerator"] == "h100"
    given = TOPOLOGIES[topology] or {"num_devices": 1, "num_hosts": 1}
    assert {k: stored[k] for k in given} == given
    assert status == "failed", logs
    assert "GangLayoutError" in logs and "runs on the card and this host has none" in logs, logs


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
@pytest.mark.parametrize("path", PATHS)
def test_the_reference_keeps_its_cpu_default(outcomes, path, topology):
    stored, status, logs = outcomes("jax")[path, topology]
    assert stored["accelerator"] == "cpu"
    assert status == "succeeded", logs
    assert "noop trainer running" in logs


def test_to_dict_keeps_the_reference_default_and_a_named_accelerator_is_kept():
    spec = PolyaxonFile.load(_spec("polyaxon_tpu_torch", None)).specification
    assert spec.to_dict()["environment"]["topology"]["accelerator"] == "cpu"
    assert spec.stored_dict()["environment"]["topology"] == dict(
        spec.to_dict()["environment"]["topology"], accelerator="h100", num_devices=1)
    for accelerator in ("cpu", "cpu-1"):
        named = PolyaxonFile.load(_spec("polyaxon_tpu_torch", {"accelerator": accelerator}))
        assert named.specification.stored_dict() == named.specification.to_dict()
    meshed = PolyaxonFile.load(_spec("polyaxon_tpu_torch", {"mesh": {"data": 4, "tensor": 2}}))
    topology = meshed.specification.stored_dict()["environment"]["topology"]
    assert (topology["accelerator"], topology["num_devices"], topology["mesh"]) == (
        "h100", 8, {"axes": {"data": 4, "tensor": 2}})
