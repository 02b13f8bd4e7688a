"""The port's query DSL against the JAX package's.

``parse_query``, ``apply_query``, ``compile_to_sql`` and
``filters_archived`` run on both packages over rows of both registries:
the same runs (names, projects, tags, statuses, metrics, declarations, an
archived run) are written into a port ``RunRegistry`` and a JAX one, and
every query of the reference's ``tests/test_query/`` cases (and a few
more) must select the same run names on both, in process and pushed down
to SQL with the residual filtered in process.  Malformed queries are
refused on both.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
from dataclasses import asdict

import pytest

from polyaxon_tpu import query as jquery
from polyaxon_tpu.db.registry import RunRegistry as JRunRegistry
from polyaxon_tpu_torch import query
from polyaxon_tpu_torch.db.registry import RunRegistry

SPEC = {"kind": "experiment", "run": {"entrypoint": "x:y"}, "declarations": {"lr": 0.1},
        "environment": {"topology": {"accelerator": "cpu-1", "num_devices": 1, "num_hosts": 1}}}
PACKAGES = {"port": (RunRegistry, query), "jax": (JRunRegistry, jquery)}


def _fill(reg):
    a = reg.create_run(SPEC, name="a", project="vision", tags=["prod"])
    b = reg.create_run(SPEC, name="b", project="nlp", tags=["dev"])
    c = reg.create_run(dict(SPEC, declarations={"lr": 0.7}), name=None, project="vision",
                       tags=["prod", "dev"])
    d = reg.create_run(SPEC, name="d", project="nlp")
    for status in ("scheduled", "starting", "running"):
        reg.set_status(b.id, status)
    reg.set_status(c.id, "queued")
    reg.add_metric(a.id, {"loss": 0.2, "acc": 0.9})
    reg.add_metric(b.id, {"loss": 0.9})
    reg.set_status(d.id, "stopped")
    reg.archive_run(d.id)
    return [a.id, b.id, c.id, d.id]


@pytest.fixture(scope="module")
def registries(tmp_path_factory):
    out = {}
    for name, (Registry, _) in PACKAGES.items():
        reg = Registry(tmp_path_factory.mktemp(name) / "r.db")
        _fill(reg)
        out[name] = reg
    yield out
    for reg in out.values():
        reg.close()


QUERIES = [
    "status:running", "metric.loss:<0.5", "metric.loss:>=0.2", "metric.acc:0.9",
    "declarations.lr:0.1", "declarations.lr:>0.5", "params.lr:0.7", "tags:prod", "tags:prod|dev",
    "tags:~dev", "status:~running", "status:running, metric.loss:<0.5", "project:vision",
    "project:~vision", "status:created|queued", "status:~created|queued", "id:>1", "id:1..2",
    "id:~1..2", "name:a", "name:~a", "project:vision,status:created",
    "project:vision,metric.loss:<0.5", "created_at:a..b", "created_at:>=2020-01-01",
    "archived:true", "archived:false", "archived:~true", "kind:experiment", "restarts:0",
    "group_id:1", "finished_at:>0", "",
]
REFUSED = ["statusrunning", "status:", "nonsense:1", "archived:yes", "archived:>1",
           "archived:true|false"]


def _names(runs):
    return sorted(str(r.name) for r in runs)


def _run(package, reg, q):
    mod = PACKAGES[package][1]
    conds = mod.parse_query(q)
    # A listing surface's default: live runs, unless the query takes over
    # the archived dimension.
    archived = None if mod.filters_archived(conds) else False
    pure = mod.apply_query(reg.list_runs(archived=archived), q)
    clauses, params, residual = mod.compile_to_sql(conds)
    runs = reg.list_runs(extra_where=(clauses, params) if clauses else None, archived=archived)
    pushed = mod.apply_query(runs, conditions=residual) if residual else runs
    return [asdict(c) for c in conds], (clauses, params), _names(pure), _names(pushed)


@pytest.mark.parametrize("q", QUERIES)
def test_a_query_selects_the_runs_the_reference_selects(registries, q):
    port = _run("port", registries["port"], q)
    assert port == _run("jax", registries["jax"], q)
    assert port[2] == port[3]  # pushdown + residual == the in-process filter


@pytest.mark.parametrize("q", REFUSED)
def test_a_query_the_reference_refuses_is_refused(registries, q):
    for package, reg in registries.items():
        with pytest.raises(PACKAGES[package][1].QueryError):
            _run(package, reg, q)


def test_the_reference_query_cases_hold_on_the_port(registries):
    conds = query.parse_query("status:running, metric.loss:<0.5, id:1..10, kind:~job, tags:a|b")
    by_field = {c.field: c for c in conds}
    assert by_field["status"].op == "eq" and by_field["status"].value == "running"
    assert by_field["metric.loss"].op == "lt" and by_field["metric.loss"].value == 0.5
    assert by_field["id"].op == "range" and by_field["id"].value == (1, 10)
    assert by_field["kind"].negated
    assert by_field["tags"].op == "in" and by_field["tags"].value == ["a", "b"]
    assert query.parse_query(None) == [] and query.parse_query("  ") == []
    runs = registries["port"].list_runs()
    assert [r.name for r in query.apply_query(runs, "status:running")] == ["b"]
    assert query.apply_query(runs, "declarations.lr:>0.9") == []
    assert query.filters_archived(query.parse_query("archived:true"))
    assert not query.filters_archived(query.parse_query("status:running"))
    clauses, params, residual = query.compile_to_sql(query.parse_query("metric.loss:<0.5"))
    assert clauses == [] and params == [] and len(residual) == 1
