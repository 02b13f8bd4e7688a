"""Sweeps and pipelines through the port's ``Orchestrator``.

The reference's ``tests/test_e2e/test_hpsearch_flow.py`` and
``tests/test_e2e/test_pipeline_flow.py`` cases run on the port's control
plane with the port's ``metric_probe``, ``noop`` and ``failing`` entry
points (gangs on ``cpu-1``): random, grid, hyperband, BO and an early
stopped sweep; a linear pipeline, one whose failed op skips its downstream,
one under ``concurrency: 1`` and one with a cycle.  Beside the reference's
assertions:

- every iteration's trial declarations equal the JAX search manager's
  suggestions for the same config and seed: its first suggestions, its
  hyperband reductions and next brackets given the metrics the port's
  trials reported, and its BO suggestions (scikit-learn's GP there, the
  port's own here) within 1e-6 of the bound's span;
- a second orchestrator's ``recover()`` re-kicks a group left mid-sweep (an
  iteration's trials created, one of them done) and finishes it.

The hyperband sweep takes ``max_iterations`` 2 where the reference's takes
4 (5 trials, not 14): two brackets, the first with a reduction step.  All
the flows are submitted together to one module-scoped orchestrator.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import time

import pytest

from polyaxon_tpu.hpsearch import search_managers as jsm
from polyaxon_tpu.schemas.hptuning import HPTuningConfig as JHPTuningConfig
from polyaxon_tpu_torch.lifecycles import StatusOptions as S
from polyaxon_tpu_torch.orchestrator import Orchestrator

WAIT_S = 240.0
ENV = {"topology": {"accelerator": "cpu-1", "num_devices": 1, "num_hosts": 1},
       "env_vars": {"OMP_NUM_THREADS": "1"}}
TRAINERS = "polyaxon_tpu_torch.builtins.trainers"
SCORE = {"name": "score", "optimization": "maximize"}

GROUPS = {
    "random": {"matrix": {"lr": {"uniform": [0, 1]}}, "concurrency": 2,
               "random_search": {"n_experiments": 4, "seed": 5}},
    "grid": {"matrix": {"lr": {"values": [0.1, 0.5, 0.9]}}, "concurrency": 3, "grid_search": {}},
    "hyperband": {"matrix": {"lr": {"uniform": [0, 1]}}, "concurrency": 4,
                  "hyperband": {"max_iterations": 2, "eta": 2,
                                "resource": {"name": "epochs", "optimization": "maximize"},
                                "metric": SCORE, "seed": 2}},
    "bo": {"matrix": {"lr": {"uniform": [0, 1]}}, "concurrency": 3,
           "bo": {"n_initial_trials": 3, "n_iterations": 2, "metric": SCORE, "seed": 1}},
    "early_stopping": {"matrix": {"lr": {"values": [0.7, 0.1, 0.2, 0.3, 0.4, 0.5]}},
                       "concurrency": 1, "grid_search": {},
                       "early_stopping": [{"metric": SCORE, "value": -0.001}]},
}


def group_spec(hptuning):
    return {"kind": "group", "run": {"entrypoint": f"{TRAINERS}:metric_probe"},
            "environment": ENV, "hptuning": hptuning}


def op(name, entrypoint="noop", deps=None):
    o = {"name": name, "run": {"entrypoint": f"{TRAINERS}:{entrypoint}"}, "environment": ENV}
    if deps:
        o["dependencies"] = list(deps)
    return o


PIPELINES = {
    "linear": {"ops": [op("a"), op("b", deps=["a"]), op("c", deps=["b"])]},
    "failure": {"ops": [op("good"), op("bad", entrypoint="failing"),
                        op("after_bad", deps=["bad"]), op("after_good", deps=["good"])]},
    "concurrency": {"concurrency": 1, "ops": [op("a"), op("b"), op("c")]},
    "cycle": {"ops": [op("a", deps=["b"]), op("b", deps=["a"])]},
}


def _pump_until_done(orch, run_ids, timeout=WAIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        orch.pump(max_wait=0.05)
        if all(orch.get_run(i).is_done for i in run_ids):
            return
    raise AssertionError({i: orch.get_run(i).status for i in run_ids})


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    """One orchestrator with every sweep and pipeline submitted at once:
    (orchestrator, {name: run id})."""
    orch = Orchestrator(tmp_path_factory.mktemp("plane") / "plat", monitor_interval=0.05,
                        heartbeat_interval=0.2, heartbeat_ttl=30.0)
    try:
        ids = {f"group:{k}": orch.submit(group_spec(v), name=k).id for k, v in GROUPS.items()}
        ids.update({f"pipeline:{k}": orch.submit({"kind": "pipeline", **v}, name=k).id
                    for k, v in PIPELINES.items()})
        _pump_until_done(orch, [i for k, i in ids.items() if k != "pipeline:cycle"])
        yield orch, ids
    finally:
        orch.stop()


def _trials(orch, group_id):
    return orch.registry.list_runs(group_id=group_id)


def _jax_manager(name):
    return jsm.get_search_manager(JHPTuningConfig.model_validate(GROUPS[name]))


def _iterations(orch, group_id):
    """Each iteration's data with the declarations its trials ran."""
    runs = {t.id: t for t in _trials(orch, group_id)}
    out = []
    for row in orch.registry.get_iterations(group_id):
        data = row["data"]
        declared = [runs[i].spec.declarations for i in data["trial_ids"]]
        out.append((data, declared, [runs[i] for i in data["trial_ids"]]))
    return out


def test_a_random_sweep_runs_the_reference_suggestions(plane):
    orch, ids = plane
    group = orch.get_run(ids["group:random"])
    assert group.status == S.SUCCEEDED
    trials = _trials(orch, group.id)
    assert len(trials) == 4 and all(t.status == S.SUCCEEDED for t in trials)
    assert all("score" in t.last_metric for t in trials)
    for t in trials:
        assert S.QUEUED in [row["status"] for row in orch.registry.get_statuses(t.id)]
    ((data, declared, _),) = _iterations(orch, group.id)
    assert declared == data["configs"] == _jax_manager("random").get_suggestions(
        {"iteration": 0})


def test_a_grid_sweep_runs_every_point(plane):
    orch, ids = plane
    group = orch.get_run(ids["group:grid"])
    assert group.status == S.SUCCEEDED
    trials = _trials(orch, group.id)
    assert sorted(t.spec.declarations["lr"] for t in trials) == [0.1, 0.5, 0.9]
    ((_, declared, _),) = _iterations(orch, group.id)
    assert declared == _jax_manager("grid").get_suggestions({"iteration": 0})


def test_a_hyperband_sweep_runs_the_reference_brackets(plane):
    orch, ids = plane
    group = orch.get_run(ids["group:hyperband"])
    assert group.status == S.SUCCEEDED
    ref = _jax_manager("hyperband")
    iterations = _iterations(orch, group.id)
    # s_max 1: bracket 1 (2 configs at 1 epoch, then the best at 2), then
    # bracket 0 (2 configs at 2 epochs).
    assert [(d["iteration"], d["bracket_iteration"]) for d, _, _ in iterations] == \
        [(0, 0), (0, 1), (1, 0)]
    for data, declared, runs in iterations:
        assert declared == data["configs"]
        if data["bracket_iteration"] == 0:
            want = ref.get_suggestions({"iteration": data["iteration"],
                                        "bracket_iteration": 0})
        else:
            prev_data, _, prev_runs = iterations[0]
            metrics = [r.last_metric.get("score") for r in prev_runs]
            want = ref.reduce_configs(0, 0, prev_data["configs"], metrics)
        assert declared == want
    assert all(t.is_done for t in _trials(orch, group.id))
    assert len({t.spec.declarations["epochs"] for t in _trials(orch, group.id)}) >= 2


def test_a_bo_sweep_runs_the_reference_suggestions(plane):
    pytest.importorskip("sklearn")
    orch, ids = plane
    group = orch.get_run(ids["group:bo"])
    assert group.status == S.SUCCEEDED
    trials = _trials(orch, group.id)
    assert len(trials) == 5 and all(t.status == S.SUCCEEDED for t in trials)
    ref = _jax_manager("bo")
    iterations = _iterations(orch, group.id)
    assert iterations[0][1] == ref.get_suggestions({})
    seen_configs, seen_metrics = [], []
    for data, declared, runs in iterations:
        if data["iteration"] > 0:
            (want,) = ref.get_suggestions({"configs": seen_configs, "metrics": seen_metrics})
            ((got,),) = [declared]
            assert abs(got["lr"] - want["lr"]) <= 1e-6, (got, want)
        seen_configs += data["configs"]
        seen_metrics += [r.last_metric.get("score") for r in runs]


def test_early_stopping_stops_the_sweep(plane):
    orch, ids = plane
    group = orch.get_run(ids["group:early_stopping"])
    assert group.status == S.SUCCEEDED
    finished = [t for t in _trials(orch, group.id) if t.status == S.SUCCEEDED]
    assert len(finished) < 6


def _ops(orch, pipeline_id):
    return {r.name: r for r in orch.registry.list_runs(pipeline_id=pipeline_id)}


def test_a_linear_pipeline_runs_in_order(plane):
    orch, ids = plane
    assert orch.get_run(ids["pipeline:linear"]).status == S.SUCCEEDED
    ops = _ops(orch, ids["pipeline:linear"])
    assert all(r.status == S.SUCCEEDED for r in ops.values())
    assert ops["a"].finished_at <= ops["b"].started_at
    assert ops["b"].finished_at <= ops["c"].started_at


def test_a_failed_op_skips_its_downstream(plane):
    orch, ids = plane
    assert orch.get_run(ids["pipeline:failure"]).status == S.FAILED
    ops = _ops(orch, ids["pipeline:failure"])
    assert ops["bad"].status == S.FAILED
    assert ops["after_bad"].status == S.SKIPPED
    assert ops["after_good"].status == S.SUCCEEDED


def test_pipeline_concurrency_serialises_its_ops(plane):
    orch, ids = plane
    assert orch.get_run(ids["pipeline:concurrency"]).status == S.SUCCEEDED
    spans = sorted((r.started_at, r.finished_at) for r in _ops(orch, ids["pipeline:concurrency"])
                   .values())
    for (s1, f1), (s2, f2) in zip(spans, spans[1:]):
        assert f1 <= s2 + 1e-6


def test_a_cyclic_pipeline_fails_at_start(plane):
    orch, ids = plane
    got = orch.get_run(ids["pipeline:cycle"])
    assert got.status == S.FAILED
    assert "cycle" in orch.registry.get_statuses(got.id)[-1]["message"]
    assert _ops(orch, ids["pipeline:cycle"]) == {}


def test_recover_rekicks_a_group_left_mid_sweep(tmp_path):
    """A group left by a control plane mid-sweep (its iteration's trials
    created, one done) is finished by the next control plane's recover."""
    base = tmp_path / "plat"
    first = Orchestrator(base, monitor_interval=0.05, heartbeat_interval=0.2,
                         heartbeat_ttl=30.0)
    try:
        spec = group_spec({"matrix": {"lr": {"values": [0.6, 0.7]}}, "concurrency": 2,
                           "grid_search": {}})
        group = first.registry.create_run(spec, name="left")
        first.registry.set_status(group.id, S.RUNNING)
        parsed = first.registry.get_run(group.id).spec
        trial_ids = []
        for s in ({"lr": 0.6}, {"lr": 0.7}):
            trial = first.registry.create_run(parsed.get_experiment_spec(s), group_id=group.id,
                                              tags=["trial"])
            trial_ids.append(trial.id)
        first.registry.create_iteration(group.id, {"iteration": 0, "configs": [
            {"lr": 0.6}, {"lr": 0.7}], "trial_ids": trial_ids})
        for status in (S.QUEUED, S.SCHEDULED, S.STARTING, S.RUNNING, S.SUCCEEDED):
            first.registry.set_status(trial_ids[0], status)
    finally:
        first.stop()
    second = Orchestrator(base, monitor_interval=0.05, heartbeat_interval=0.2,
                          heartbeat_ttl=30.0)
    try:
        assert second.recover() == 1  # the group's wave, not its created trial
        _pump_until_done(second, [group.id])
        assert second.get_run(group.id).status == S.SUCCEEDED
        assert second.get_run(trial_ids[1]).status == S.SUCCEEDED
        assert second.get_run(trial_ids[1]).last_metric["score"] == 0.0
        assert len(_trials(second, group.id)) == 2
    finally:
        second.stop()
