"""The port's report channel against the JAX package's.

Counterparts of ``tests/test_tracking/test_reporter.py`` on the port's
``Reporter`` (its fsync policy, the command, capture and span line shapes,
the heartbeat's hooks), every typed line equal to the JAX reporter's for the
same call (``ts`` aside), and the ingestion check: a port report file with a
line of every type goes through the JAX ``GangWatcher`` into a
``RunRegistry`` and gives the same registry rows as a JAX reporter's file
for the same events.  Also: ``Context``'s reporter and the capture agent's
poll riding the reporter's heartbeat.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import time
from types import SimpleNamespace

import pytest

import polyaxon_tpu.tracking.reporter as jrep_mod
import polyaxon_tpu_torch.tracking.reporter as trep_mod
from polyaxon_tpu.db.registry import RunRegistry
from polyaxon_tpu.monitor.watcher import GangWatcher, goodput_status
from polyaxon_tpu.stores.layout import RunPaths
from polyaxon_tpu.tracking.reporter import Reporter as JaxReporter
from polyaxon_tpu_torch.tracking import Reporter
from polyaxon_tpu_torch.tracking import capture as capture_mod
from polyaxon_tpu_torch.tracking.context import Context
from polyaxon_tpu_torch.tracking.reporter import report_file

SPEC = {"kind": "experiment", "run": {"entrypoint": "polyaxon_tpu.builtins.trainers:noop"}}


@pytest.fixture()
def fsync_calls(monkeypatch):
    calls = []
    real = trep_mod.os.fsync

    def spy(fd):
        calls.append(fd)
        return real(fd)

    monkeypatch.setattr(trep_mod.os, "fsync", spy)
    return calls


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_fsync_types_are_the_reference_s():
    assert Reporter.FSYNC_TYPES == JaxReporter.FSYNC_TYPES == (
        "status", "anomaly", "command", "capture")


#: (call, whether its line is fsynced) — every typed method of the reporter.
CALLS = {
    "status": (lambda r: r.status("running", message="up"), True),
    "anomaly": (lambda r: r.anomaly("stall", message="wedged", age_s=1.5), True),
    "command": (lambda r: r.command_event("u1", "acked"), True),
    "capture": (lambda r: r.capture({"capture_id": "c1", "status": "complete"}), True),
    "metric": (lambda r: r.metric({"loss": 1.0}, step=1), False),
    "log": (lambda r: r.log("hello"), False),
    "heartbeat": (lambda r: r.heartbeat(), False),
    "resources": (lambda r: r.resources({"sys/rss_mb": 1.0}), False),
    "progress": (lambda r: r.progress(step=3, epoch=1, throughput=2.0, at=5.0), False),
    "span": (lambda r: r.span({"name": "s", "start": 1.0, "duration": 0.1}), False),
    "ledger": (lambda r: r.ledger({"source": "train", "wall_s": 1.0}), False),
    "service": (lambda r: r.service(url="http://h:1/"), False),
}


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_fsync_policy(tmp_path, fsync_calls, kind):
    call, fsynced = CALLS[kind]
    r = Reporter(tmp_path / "p0.jsonl")
    call(r)
    assert len(fsync_calls) == int(fsynced)
    assert len(_lines(r.path)) == 1  # flushed and readable at once either way
    r.close()


def test_error_status_fsyncs(tmp_path, fsync_calls):
    r = Reporter(tmp_path / "p0.jsonl")
    try:
        raise RuntimeError("boom")
    except RuntimeError as exc:
        r.error(exc)
    assert len(fsync_calls) == 1  # error() emits a status event
    r.close()
    (line,) = _lines(tmp_path / "p0.jsonl")
    assert line["status"] == "failed" and line["message"] == "RuntimeError: boom"
    assert "boom" in line["traceback"]


def test_fsync_all_escape_hatch(tmp_path, fsync_calls):
    r = Reporter(tmp_path / "p0.jsonl", fsync_all=True)
    r.metric({"loss": 1.0})
    r.log("x")
    r.span({"name": "s"})
    r.status("running")
    assert len(fsync_calls) == 4
    r.close()


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_each_line_is_the_jax_reporter_s(tmp_path, kind):
    call, _ = CALLS[kind]
    lines = []
    for cls, name in ((Reporter, "port.jsonl"), (JaxReporter, "jax.jsonl")):
        r = cls(tmp_path / name, process_id=2)
        call(r)
        r.close()
        (line,) = _lines(tmp_path / name)
        assert line.pop("ts") > 0
        lines.append(line)
    assert lines[0] == lines[1]


def test_command_and_capture_line_shapes(tmp_path):
    r = Reporter(tmp_path / "p0.jsonl")
    r.command_event("u1", "failed", message="boom")
    r.capture({"capture_id": "c1", "status": "complete",
               "artifacts": ["profiles/c1/proc0/memory.prof"], "attrs": {"trace": True}})
    r.close()
    command, capture = _lines(tmp_path / "p0.jsonl")
    assert (command["type"], command["uuid"], command["state"], command["message"]) == (
        "command", "u1", "failed", "boom")
    assert capture["type"] == "capture" and capture["capture_id"] == "c1"
    assert capture["artifacts"] == ["profiles/c1/proc0/memory.prof"]
    assert capture["attrs"] == {"trace": True}


def test_span_line_shape_and_order(tmp_path):
    r = Reporter(tmp_path / "p0.jsonl", process_id=2)
    record = {"name": "worker.entrypoint", "trace_id": "abc", "span_id": "2.1",
              "parent_id": None, "start": 123.0, "duration": 0.5, "process_id": 2,
              "thread": "MainThread", "attrs": {"entrypoint": "m:f"}}
    r.status("running")
    r.span(record)
    r.metric({"loss": 2.0}, step=1)
    r.close()
    lines = _lines(tmp_path / "p0.jsonl")
    assert [line["type"] for line in lines] == ["status", "span", "metric"]
    assert "ts" in lines[1]
    assert all(lines[1][k] == v for k, v in record.items())


def _wait_for(cond, timeout=2.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)


def test_beat_hooks_run_on_the_heartbeat_and_survive_a_broken_one(tmp_path):
    r = Reporter(tmp_path / "p0.jsonl")
    calls = []

    def bad():
        raise RuntimeError("hook boom")

    r.add_beat_hook(bad)
    r.add_beat_hook(lambda: calls.append(1))
    r.start_heartbeat(interval=0.05)
    _wait_for(lambda: len(calls) >= 2)
    r.close()
    assert len(calls) >= 2  # kept beating past the broken hook
    beats = [line for line in _lines(tmp_path / "p0.jsonl") if line["type"] == "heartbeat"]
    assert len(beats) >= 2


def test_context_sends_metrics_text_and_service_to_its_reporter(tmp_path):
    r = Reporter(report_file(tmp_path, 0))
    records = []
    ctx = Context(params={}, reporter=r, records=records)
    ctx.log_metrics(step=3, loss=0.5)
    ctx.log_text("hello")
    ctx.report_service(query="token=t")
    r.close()
    assert report_file(tmp_path, 0) == tmp_path / "reports" / "proc0.jsonl"
    lines = _lines(report_file(tmp_path, 0))
    assert [(line["type"], line.get("values"), line.get("line")) for line in lines] == [
        ("metric", {"loss": 0.5}, None), ("log", None, "hello"), ("service", None, None)]
    assert lines[2]["query"] == "token=t"
    assert records == [{"kind": "metric", "step": 3, "values": {"loss": 0.5}},
                       {"kind": "log", "line": "hello"}]


def test_context_with_a_reporter_and_no_list_prints_nothing(tmp_path, capsys):
    r = Reporter(tmp_path / "p0.jsonl")
    ctx = Context(params={}, reporter=r)
    ctx.log_metrics(step=1, loss=1.0)
    ctx.log_text("x")
    r.close()
    assert capsys.readouterr().out == ""
    assert len(_lines(tmp_path / "p0.jsonl")) == 2


def test_capture_agent_polls_on_the_reporter_heartbeat(tmp_path):
    r = Reporter(tmp_path / "p0.jsonl")
    mailbox = tmp_path / "commands" / "proc0"
    mailbox.mkdir(parents=True)
    handled = []
    agent = capture_mod.configure(reporter=r, mailbox=mailbox, profiles_root=tmp_path / "p")
    try:
        capture_mod.configure(reporter=r)  # configuring again hooks the poll once
        assert r._beat_hooks == [agent.poll]
        agent.register_handler("ping", lambda cmd: handled.append(cmd["uuid"]))
        (mailbox / "c1.json").write_text(json.dumps({"kind": "ping", "uuid": "c1"}))
        r.start_heartbeat(interval=0.05)
        _wait_for(lambda: handled)
        assert handled == ["c1"] and not list(mailbox.iterdir())
    finally:
        r.close()
        agent._handlers.pop("ping", None)
        capture_mod.configure(reporter=None, mailbox=None, profiles_root=None)


# -- ingestion through the JAX watcher -----------------------------------------

def _every_type(r, exc):
    """One line of every type the reporter writes, command lines against
    the registry's command ``cmd1``."""
    r.status("running", message="up")
    r.metric({"loss": 1.5, "grad_norm": 0.5}, step=3)
    r.log("hello")
    r.heartbeat()
    r.resources({"sys/rss_mb": 12.0, "sys/hbm0_mb": 3.0})
    r.progress(step=4, epoch=1, throughput=2.5, at=990.0)
    r.anomaly("stall", message="wedged", dump="/r/reports/flightrec-0-1.json",
              dump_artifact="reports/flightrec-0-1.json", age_s=3.0, step=4)
    r.span({"name": "train.loop", "trace_id": "t1", "span_id": "0.1", "parent_id": None,
            "start": 900.0, "duration": 2.0, "process_id": 0, "thread": "MainThread",
            "attrs": {"steps": 5}})
    r.ledger({"source": "train", "process_id": 0, "wall_s": 10.0,
              "buckets": {"xla_compile_s": 0.5, "data_wait_s": 0.2, "step_compute_s": 8.0,
                          "ckpt_block_s": 0.1, "metric_drain_s": 0.0, "idle_s": 1.2},
              "steps": 5, "tokens": 500, "flops": 1e9, "goodput": 0.8, "mfu": 0.1,
              "tokens_per_device_s": 50.0, "compile_s": 0.5, "compile_events": 2,
              "compile_cache_hits": 1, "compile_cache_misses": 1, "hbm_peak_bytes": 1e9,
              "devices": 1, "device_kind": "NVIDIA H100 80GB HBM3",
              "peak_flops_per_s": 989e12, "seq": 1, "final": True,
              "extra": {"kv_pool_bytes": 1024}})
    r.service(url="http://h:1/")
    r.command_event("cmd1", "acked")
    r.command_event("cmd1", "complete", step=7)
    r.capture({"capture_id": "cmd1", "status": "complete", "start_step": 2, "num_steps": 3,
               "started_at": 950.0, "finished_at": 960.0,
               "artifacts": ["profiles/cmd1/proc0/trace.json"], "attrs": {"trace": True}})
    try:
        raise exc
    except RuntimeError as e:
        r.error(e)


def _ingested(tmp_path, reporter_cls):
    tmp_path.mkdir()
    registry = RunRegistry(tmp_path / "registry.sqlite")
    run = registry.create_run(SPEC, name="ingest")
    registry.enqueue_command(run.id, "profile", uuid="cmd1")
    paths = RunPaths(tmp_path / "run").ensure()
    handle = SimpleNamespace(run_id=run.id, run_uuid=run.uuid,
                             plan=SimpleNamespace(num_hosts=1), paths=paths, report_offsets={})
    r = reporter_cls(paths.report_file(0), process_id=0)
    _every_type(r, RuntimeError("boom"))
    r.close()
    GangWatcher(registry).ingest(handle)
    rid = run.id

    def rows(getter):
        return [{k: v for k, v in row.items() if k != "id"} for row in getter(rid)]

    got = {
        "metrics": rows(registry.get_metrics),
        "logs": rows(registry.get_logs),
        "spans": rows(registry.get_spans),
        "utilization": rows(registry.get_utilization),
        "progress": rows(registry.get_progress),
        "anomalies": rows(registry.get_anomalies),
        "commands": rows(registry.get_commands),
        "captures": rows(registry.get_captures),
        "processes": rows(registry.get_processes),
        "goodput": goodput_status(registry, rid),
        "service_url": registry.get_run(rid).service_url,
    }
    registry.close()
    return got


def test_the_jax_watcher_ingests_a_port_file_as_a_jax_one(tmp_path, monkeypatch):
    # One clock for both files and both registries: rows equal, ts included.
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    port = _ingested(tmp_path / "port", Reporter)
    jax_ = _ingested(tmp_path / "jax", JaxReporter)
    for table in port:
        assert port[table] == jax_[table], table
    # Every type landed somewhere.
    assert port["metrics"] and port["logs"] and port["spans"] and port["utilization"]
    assert port["progress"][0]["step"] == 4 and port["progress"][0]["at"] == 990.0
    assert port["anomalies"][0]["kind"] == "stall"
    assert port["commands"][0]["status"] == "complete"
    assert port["captures"][0]["status"] == "complete"
    assert port["processes"][0]["status"] == "failed"
    assert port["service_url"] == "http://h:1/"
    assert port["goodput"]["rows"] == 1 and port["goodput"]["kv_pool_bytes"] == 1024.0
    assert jrep_mod.Reporter is JaxReporter
