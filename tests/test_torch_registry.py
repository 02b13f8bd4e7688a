"""The port's run registry (``db/registry.py``) against the JAX package's.

One operation script runs on both ``RunRegistry``s, each on its own sqlite
file: runs of every kind (groups and pipelines too), legal and illegal
status writes, metrics with labels, logs, heartbeats, progress, processes,
commands and their acks, anomalies, alerts, remediations, captures,
iterations, activity, options, archiving and deletion.  Every step's result
is compared (an exception by its type name and message), and then every
table's rows, apart from ids, uuids, token hashes and timestamps.
``Run.spec`` reads every kind, groups and pipelines included, as the
reference's does, and refuses a stored row whose spec does not validate.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
import json
import multiprocessing
import sqlite3

import pytest

from polyaxon_tpu.db import registry as jreg
from polyaxon_tpu.stats.metrics import labeled_key as jax_labeled_key
from polyaxon_tpu_torch import db as tdb
from polyaxon_tpu_torch.db import registry as treg
from polyaxon_tpu_torch.exceptions import SchemaError
from polyaxon_tpu_torch.stats.metrics import labeled_key

RUN = {"cmd": "python train.py"}
SPECS = {
    "experiment": {"kind": "experiment", "run": RUN, "tags": ["a"]},
    "job": {"kind": "job", "run": RUN},
    "build": {"kind": "build", "run": RUN},
    "notebook": {"kind": "notebook"},
    "tensorboard": {"kind": "tensorboard"},
    "service": {"kind": "service", "port": 8000},
    "group": {"kind": "group", "hptuning": {"matrix": {"lr": {"values": [0.1, 0.2]}}},
              "run": RUN},
    "pipeline": {"kind": "pipeline", "ops": [{"name": "a", "run": RUN}]},
}
#: Columns left out of the row comparison: ids, uuids, secrets, timestamps.
SKIP_COLUMNS = {"id", "uuid", "token_hash", "at", "pending_since", "start", "duration"}
#: Keys left out of JSON columns and returned dicts, for the same reason.
SKIP_KEYS = SKIP_COLUMNS | {"ts", "time"}


def _clean(value):
    """``value`` without ids, uuids and timestamps, at any depth."""
    if dataclasses.is_dataclass(value):
        value = dataclasses.asdict(value)
    if isinstance(value, dict):
        return {k: _clean(v) for k, v in value.items()
                if k not in SKIP_KEYS and not str(k).endswith("_at")}
    if isinstance(value, (list, tuple)):
        return [_clean(v) for v in value]
    return value


def script(mod, path):
    """The operation script on ``mod``'s registry at ``path``: each step's
    cleaned result, or its exception's type name and message."""
    reg = mod.RunRegistry(path)
    seen = []

    def step(fn, *args, **kwargs):
        try:
            seen.append(("ok", _clean(fn(*args, **kwargs))))
        except Exception as e:  # noqa: BLE001 — compared by type and message
            seen.append((type(e).__name__, str(e)))

    S = mod.S
    try:
        runs = {kind: reg.create_run(spec, name=f"r-{kind}", project="p")
                for kind, spec in SPECS.items()}
        seen.append(("ok", _clean(list(runs.values()))))
        step(reg.create_run, {"run": RUN})
        step(reg.create_run, SPECS["experiment"], status=S.RUNNING)
        child = reg.create_run(SPECS["experiment"], group_id=runs["group"].id, tags=["b"])
        exp = runs["experiment"].id
        # Status writes, legal then illegal, on an experiment and a service.
        for status in (S.QUEUED, S.SCHEDULED, S.STARTING, S.RUNNING, S.CREATED,
                       S.WARNING, S.RUNNING, S.SUCCEEDED, S.RUNNING, S.FAILED):
            step(reg.set_status, exp, status, message=f"to {status}")
        for status in (S.QUEUED, S.SCHEDULED, S.RUNNING, S.STOPPING, S.STOPPED, S.RUNNING):
            step(reg.set_status, runs["service"].id, status)
        for status in (S.RUNNING, S.SUCCEEDED):
            step(reg.set_status, runs["group"].id, status)
        step(reg.set_status, 999, S.RUNNING)
        step(reg.set_status, exp, "no-such-status")
        step(reg.get_statuses, exp)
        # Metrics with labels, logs, heartbeats, progress, processes.
        train = labeled_key("loss", split="train")
        assert train == jax_labeled_key("loss", split="train")
        for i in range(3):
            step(reg.add_metric, child.id, {"loss": 1.0 / (i + 1), train: 0.5 * i}, step=i)
        step(reg.add_metric, child.id, {"acc": 0.9})
        step(reg.get_metrics, child.id)
        step(reg.last_metric, child.id)
        step(reg.add_log, child.id, "hello", process_id=0, created_at=5.0)
        step(reg.add_logs, child.id, [(0, "a"), (1, "b"), (None, "c")])
        step(reg.get_logs, child.id, process_id=1)
        step(reg.get_logs, child.id, since_id=1, limit=2)
        step(reg.ping_heartbeat, child.id, at=100.0)
        step(reg.last_heartbeat, child.id)
        step(reg.upsert_progress, child.id, 0, step=3, epoch=1, throughput=12.5, at=101.0)
        step(reg.get_progress, child.id)
        for pid in (0, 1):
            step(reg.upsert_process, child.id, pid, pid=4000 + pid, status=S.RUNNING)
        step(reg.upsert_process, child.id, 1, status=S.FAILED, exit_code=3)
        step(reg.set_report_offset, child.id, 0, 77)
        step(reg.get_processes, child.id)
        step(reg.add_anomaly, child.id, "stall", process_id=0, message="m", attrs={"k": 1})
        step(reg.get_anomalies, child.id, kind="stall")
        # Commands and acks.
        step(reg.enqueue_command, child.id, "profile", payload={"steps": 2}, expected=2,
             uuid="cmd-1")
        step(reg.enqueue_command, child.id, "drain", process_id=0, uuid="cmd-2")
        step(reg.mark_command, "cmd-1", 0, "acked")
        step(reg.mark_command, "cmd-1", 0, "complete", message="done", attrs={"n": 1})
        step(reg.mark_command, "cmd-1", 1, "failed", message="no")
        step(reg.mark_command, "cmd-9", 0, "acked")
        step(reg.get_command, "cmd-1")
        step(reg.expire_commands, child.id)
        step(reg.get_commands, child.id)
        step(reg.get_commands, child.id, status="expired")
        # Alerts and remediations.
        AS, AV = mod.AlertState, mod.AlertSeverity
        step(reg.upsert_alert, child.id, "loss_spike", state=AS.PENDING, severity=AV.WARNING,
             value=2.0, for_s=30.0, pending_since=10.0)
        step(reg.upsert_alert, child.id, "loss_spike", state=AS.FIRING, severity=AV.CRITICAL,
             fired_at=40.0, episodes=1)
        step(reg.upsert_alert, child.id, "stall", state=AS.FIRING, severity=AV.INFO)
        step(reg.get_alerts, child.id)
        step(reg.get_alerts, state=AS.FIRING, severity=AV.CRITICAL)
        step(reg.delete_alert, child.id, "stall")
        step(reg.delete_alert, child.id, "stall")
        RS = mod.RemediationStatus
        rem = reg.add_remediation(child.id, "restart", trigger="stall", attrs={"a": 1})
        seen.append(("ok", _clean(rem)))
        step(reg.update_remediation, rem["id"], status=RS.IN_PROGRESS, message="go")
        step(reg.add_remediation, child.id, "scale_up", status=RS.SKIPPED, message="budget")
        step(reg.count_remediations, child.id, statuses=RS.OPEN)
        step(reg.expire_remediations, child.id)
        step(reg.get_remediations, child.id)
        # Captures, iterations, activity, options.
        step(reg.upsert_capture, child.id, "cap-1", 0, status="running", start_step=4,
             num_steps=2)
        step(reg.upsert_capture, child.id, "cap-1", 0, status="done", artifacts=["x.json"])
        step(reg.get_captures, child.id)
        step(reg.create_iteration, runs["group"].id, {"wave": 1})
        step(reg.update_iteration, runs["group"].id, 1, {"wave": 1, "best": 0.2})
        step(reg.get_iterations, runs["group"].id)
        step(reg.record_activity, "experiment.done", {"run_id": exp})
        step(reg.get_activities, "experiment.done")
        step(reg.set_option, "spawner.hosts", "a,b")
        step(reg.set_option, "sso.auto_create", True)
        step(reg.get_option, "spawner.hosts")
        step(reg.get_option, "missing", 7)
        step(reg.delete_option, "spawner.hosts")
        # Run updates, listing, archiving and deletion.
        step(reg.update_run, child.id, outputs_path="/o", service_url="http://h:1")
        step(reg.update_run, child.id, no_such_field=1)
        step(reg.merge_run_meta, child.id, elastic={"num_hosts": 1})
        step(reg.get_run, runs["service"].uuid)
        step(reg.get_run, 999)
        step(reg.list_runs, kind="experiment")
        step(reg.list_runs, group_id=runs["group"].id)
        step(reg.list_runs, statuses=[S.CREATED], limit=3, offset=1)
        step(reg.count_by_status)
        step(reg.count_by_status, kind="experiment")
        step(reg.archive_run, runs["job"].id)
        step(reg.archive_run, runs["job"].id)
        step(reg.list_runs, archived=True)
        step(reg.restore_run, runs["job"].id)
        step(reg.delete_run, runs["build"].id)
        step(reg.zombie_runs, 50.0, now=1000.0)
        step(lambda: runs["experiment"].lifecycle.is_done(S.SUCCEEDED))
        step(lambda: reg.get_run(exp).is_done)
    finally:
        reg.close()
    return seen


def rows(path):
    """Every table's rows, cleaned, in id order."""
    conn = sqlite3.connect(path)
    conn.row_factory = sqlite3.Row
    try:
        out = {}
        for (table,) in conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table' AND name != 'sqlite_sequence' "
                "ORDER BY name"):
            got = []
            for row in conn.execute(f"SELECT * FROM {table} ORDER BY rowid"):
                clean = {}
                for k in row.keys():
                    if k in SKIP_COLUMNS or k.endswith("_at"):
                        continue
                    v = row[k]
                    if isinstance(v, str) and v[:1] in "{[":
                        try:
                            v = _clean(json.loads(v))
                        except ValueError:
                            pass
                    clean[k] = v
                got.append(clean)
            out[table] = got
        return out
    finally:
        conn.close()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("registries")
    return (script(jreg, d / "jax.db"), rows(d / "jax.db"),
            script(treg, d / "port.db"), rows(d / "port.db"))


def test_every_step_of_the_script_gives_the_references_result(both):
    want, _, got, _ = both
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i


def test_every_tables_rows_are_the_references(both):
    _, want, _, got = both
    assert sorted(got) == sorted(want)
    for table in want:
        assert got[table] == want[table], table


def test_the_row_vocabularies_are_the_references():
    for name in ("CommandStatus", "AlertState", "AlertSeverity", "RemediationStatus"):
        got, want = getattr(treg, name), getattr(jreg, name)
        assert {k: v for k, v in vars(got).items() if k.isupper()} == {
            k: v for k, v in vars(want).items() if k.isupper()}, name
    assert tdb.RemediationStatus is treg.RemediationStatus
    from polyaxon_tpu_torch.serving import autoscaler

    assert autoscaler.RemediationStatus is treg.RemediationStatus


def test_a_group_row_is_stored_and_listed_but_its_spec_is_refused(tmp_path):
    """Since search and pipelines are ported, a group's and a pipeline's
    ``Run.spec`` are the reference's; only a row whose spec does not
    validate (a group without its run section) is refused, on both."""
    regs = {"port": treg.RunRegistry(tmp_path / "t.db"),
            "jax": jreg.RunRegistry(tmp_path / "j.db")}
    try:
        specs = {}
        for name, reg in regs.items():
            rows = [reg.create_run(SPECS[k]) for k in ("group", "pipeline", "experiment")]
            broken = reg.create_run({"kind": "group", "hptuning": SPECS["group"]["hptuning"]})
            assert [r.kind for r in reg.list_runs()] == ["group", "pipeline", "experiment",
                                                        "group"]
            specs[name] = [json.loads(json.dumps(reg.get_run(r.id).spec.to_dict()))
                           for r in rows]
            with pytest.raises(Exception, match="run"):
                reg.get_run(broken.id).spec
        assert specs["port"] == specs["jax"]
        with pytest.raises(SchemaError):
            regs["port"].get_run(4).spec
        assert regs["port"].get_run(3).spec.resolved_run().cmd == "python train.py"
    finally:
        for reg in regs.values():
            reg.close()


def _write_metrics(path, worker, n):
    reg = treg.RunRegistry(path)
    try:
        for i in range(n):
            reg.add_metric(1, {"loss": float(i), "worker": float(worker)}, step=i)
    finally:
        reg.close()


def test_two_processes_write_metrics_to_one_wal_database(tmp_path):
    path = tmp_path / "wal.db"
    reg = treg.RunRegistry(path)
    try:
        reg.create_run(SPECS["experiment"])
        procs = [multiprocessing.get_context("spawn").Process(target=_write_metrics,
                                                               args=(path, w, 40))
                 for w in (0, 1)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(60)
            assert p.exitcode == 0
        got = reg.get_metrics(1)
        assert sorted((m["values"]["worker"], m["step"]) for m in got) == [
            (float(w), i) for w in (0, 1) for i in range(40)]
        mode = sqlite3.connect(path).execute("PRAGMA journal_mode").fetchone()[0]
        assert mode.lower() == "wal"
    finally:
        reg.close()
