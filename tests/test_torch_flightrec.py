"""The port's stall watchdog, flight recorder and resource sampler against
the JAX package's.

Counterparts of ``tests/test_tracking/test_flightrec.py`` on the port's
``Progress`` and ``FlightRecorder`` (the beacon, the adaptive deadline equal
to the JAX one over a grid, the edge-triggered stall dump, the crash
postmortem, the typed ``progress`` and ``anomaly`` lines through a real
reporter), the port's ``monitor/resources.py`` on the CPU (no card: no
device rows, and no CUDA context made to find that out), and a small
``lm_train`` with ``stall_at_step`` under a recorder: one ``stall``
anomaly, a dump whose main-thread stack is in the fault injector, ingested
by the JAX watcher.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import inspect
import itertools
import json
import time
from types import SimpleNamespace

import pytest
import torch

import polyaxon_tpu.tracking.flightrec as jflight
import polyaxon_tpu_torch.builtins.trainers as trainers
from polyaxon_tpu.db.registry import RunRegistry
from polyaxon_tpu.monitor.watcher import GangWatcher
from polyaxon_tpu.stores.layout import RunPaths
from polyaxon_tpu_torch.monitor import resources
from polyaxon_tpu_torch.tracking import Reporter
from polyaxon_tpu_torch.tracking.context import Context
from polyaxon_tpu_torch.tracking.flightrec import (
    FlightRecorder,
    Progress,
    dump_forensics,
    get_progress,
    thread_stacks,
)


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


# -- the beacon ------------------------------------------------------------------

def test_unarmed_until_first_beat():
    snap = Progress().snapshot()
    assert snap["armed"] is False and snap["age_s"] is None and snap["median_dt_s"] is None


def test_beat_tracks_step_epoch_and_median():
    p = Progress()
    for i in range(5):
        p.beat(step=i, epoch=1)
        time.sleep(0.01)
    snap = p.snapshot()
    assert snap["armed"] is True and snap["beats"] == 5
    assert snap["step"] == 4 and snap["epoch"] == 1
    assert snap["median_dt_s"] == pytest.approx(0.01, abs=0.05)
    assert snap["throughput"] == pytest.approx(1 / snap["median_dt_s"])
    assert snap["last_beat_at"] == pytest.approx(time.time(), abs=1.0)


def test_beat_without_step_keeps_last_step_and_reset_disarms():
    p = Progress()
    p.beat(step=7)
    p.beat()  # a serving-style anonymous tick
    assert p.snapshot()["step"] == 7
    p.reset()
    assert p.snapshot()["armed"] is False
    assert get_progress() is get_progress()
    assert set(Progress().snapshot()) == set(jflight.Progress().snapshot())


# -- the deadline ------------------------------------------------------------------

GRID = list(itertools.product((2.0, 8.0), (0.5, 1.0), (3.0, 10.0),
                              (None, 0.001, 0.2, 0.5, 2.0, 100.0)))


@pytest.mark.parametrize("k, floor_s, ceiling_s, median", GRID)
def test_deadline_is_the_reference_s(k, floor_s, ceiling_s, median):
    kw = dict(k=k, floor_s=floor_s, ceiling_s=ceiling_s)
    port = FlightRecorder(Progress(), **kw).deadline_s(median)
    assert port == jflight.FlightRecorder(jflight.Progress(), **kw).deadline_s(median)
    assert floor_s <= port <= ceiling_s or median is None
    if median is None:
        assert port == ceiling_s  # no dt sample yet: the most patience


@pytest.mark.parametrize("env, attrs", [
    ({}, (8.0, 30.0, 600.0, 1.0, 2.0)),
    ({"POLYAXON_TPU_WATCHDOG_K": "2.0", "POLYAXON_TPU_WATCHDOG_FLOOR_S": "0.5",
      "POLYAXON_TPU_WATCHDOG_CEILING_S": "3.0", "POLYAXON_TPU_WATCHDOG_INTERVAL_S": "0.25",
      "POLYAXON_TPU_PROGRESS_INTERVAL_S": "4"}, (2.0, 0.5, 3.0, 0.25, 4.0)),
])
def test_knobs(monkeypatch, env, attrs):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for rec in (FlightRecorder(Progress()), jflight.FlightRecorder(jflight.Progress())):
        assert (rec.k, rec.floor_s, rec.ceiling_s, rec.interval_s,
                rec.progress_interval_s) == attrs


# -- the watchdog --------------------------------------------------------------------

def _stalled_recorder(tmp_path, **kw):
    """A beacon that beat fast, then went silent past its deadline."""
    p = Progress()
    for i in range(4):
        p.beat(step=i)
        time.sleep(0.005)
    rec = FlightRecorder(p, out_dir=tmp_path, k=2.0, floor_s=0.05, ceiling_s=0.2, **kw)
    time.sleep(0.25)  # past the ceiling: past any deadline
    return p, rec


def test_not_armed_no_dump(tmp_path):
    assert FlightRecorder(Progress(), out_dir=tmp_path, floor_s=0.01).check() is None


def test_stall_fires_once_per_episode_and_a_beat_rearms(tmp_path):
    p, rec = _stalled_recorder(tmp_path)
    path = rec.check()
    assert path is not None and path.exists() and path.name == "flightrec-0-1.json"
    assert rec.check() is None  # the same episode: no second dump
    p.beat(step=99)
    assert rec.check() is None  # recovered
    time.sleep(0.25)
    assert rec.check().name == "flightrec-0-2.json"  # a new episode, a new dump


def test_dump_contents(tmp_path):
    p, rec = _stalled_recorder(tmp_path)
    doc = json.loads(rec.check().read_text())
    assert doc["kind"] == "stall" and doc["progress"]["step"] == 3
    assert any(k.startswith("MainThread") for k in doc["threads"])
    assert "File " in "".join(doc["threads"][next(iter(doc["threads"]))])
    assert isinstance(doc["spans"], list)
    assert doc["devices"] == {}  # the CPU: no card memory to sample


def test_disabled_by_interval_and_thread_lifecycle(tmp_path):
    rec = FlightRecorder(Progress(), interval_s=0.0)
    rec.start()
    assert rec._thread is None
    rec.stop()
    p = Progress()
    p.beat(step=0)
    rec = FlightRecorder(p, out_dir=tmp_path, interval_s=0.01, floor_s=0.03, ceiling_s=0.05)
    rec.start()
    try:
        deadline = time.time() + 2.0
        while time.time() < deadline and not any(tmp_path.glob("flightrec-*")):
            time.sleep(0.02)
    finally:
        rec.stop()
    assert any(tmp_path.glob("flightrec-*.json"))


# -- forensics ------------------------------------------------------------------------

def test_crash_dump_carries_the_exception(tmp_path):
    rec = FlightRecorder(Progress(), out_dir=tmp_path, process_id=3)
    try:
        raise ValueError("boom")
    except ValueError as e:
        path = rec.crash_dump(e)
    doc = json.loads(path.read_text())
    assert doc["kind"] == "crash" and doc["process_id"] == 3
    assert doc["exception"]["type"] == "ValueError"
    assert any("boom" in line for line in doc["exception"]["traceback"])


def test_dump_survives_unserializable_ingredients_and_names_the_main_thread(tmp_path):
    path = dump_forensics(tmp_path, 0, 1, kind="stall", progress={"odd": object()})
    assert path is not None and json.loads(path.read_text())
    assert any(k.startswith("MainThread") for k in thread_stacks())


def test_dump_keys_are_the_reference_s(tmp_path):
    port = json.loads(dump_forensics(tmp_path / "p", 0, 1, kind="stall",
                                     report_path=tmp_path / "none.jsonl").read_text())
    ref = json.loads(jflight.dump_forensics(tmp_path / "j", 0, 1, kind="stall",
                                            report_path=tmp_path / "none.jsonl").read_text())
    assert set(port) == set(ref)


# -- through a reporter -----------------------------------------------------------------

def test_anomaly_line_points_at_the_dump(tmp_path):
    report = tmp_path / "proc0.jsonl"
    reporter = Reporter(report, process_id=0)
    rec = FlightRecorder(Progress(), reporter=reporter, out_dir=tmp_path, process_id=0)
    path = rec.record("stall", message="wedged", age_s=12.5)
    reporter.close()
    (event,) = [e for e in _lines(report) if e["type"] == "anomaly"]
    assert (event["kind"], event["message"], event["age_s"]) == ("stall", "wedged", 12.5)
    assert event["dump"] == str(path)
    assert event["dump_artifact"] == f"{tmp_path.name}/{path.name}"
    assert "report_tail" in json.loads(path.read_text())


def test_progress_lines_deduped_per_beat(tmp_path):
    report = tmp_path / "proc0.jsonl"
    reporter = Reporter(report, process_id=0)
    p = Progress()
    rec = FlightRecorder(p, reporter=reporter, progress_interval_s=0.0, interval_s=0.0)
    p.beat(step=0)
    rec.check()
    rec.check()  # beats unchanged: no duplicate line
    p.beat(step=1)
    rec.check()
    reporter.close()
    lines = [e for e in _lines(report) if e["type"] == "progress"]
    assert [e["step"] for e in lines] == [0, 1]
    assert lines[-1]["at"] <= lines[-1]["ts"]  # the beat's time, not the emit's


def test_progress_throttled_but_flushed_at_stop(tmp_path):
    report = tmp_path / "proc0.jsonl"
    reporter = Reporter(report, process_id=0)
    p = Progress()
    rec = FlightRecorder(p, reporter=reporter, progress_interval_s=60.0, interval_s=0.0)
    rec._last_progress_emit = time.perf_counter()
    p.beat(step=0)
    rec.check()
    p.beat(step=1)
    rec.check()
    rec.stop()  # the final flush ships the last step regardless
    reporter.close()
    assert [e["step"] for e in _lines(report) if e["type"] == "progress"] == [1]


# -- resources -----------------------------------------------------------------------------

def test_sample_devices_is_empty_without_a_cuda_context():
    resources._reset_device_probe()
    assert resources.sample_devices() == {}
    assert not torch.cuda.is_initialized()  # asking made none


def test_sample_process_primes_then_reports_cpu():
    first = resources.sample_process()
    assert "sys/cpu_percent" not in first or first["sys/cpu_percent"] >= 0
    assert first["sys/rss_mb"] > 1 and first["sys/threads"] >= 1
    sum(i * i for i in range(200_000))
    second = resources.sample_process()
    assert second["sys/cpu_percent"] >= 0
    assert resources.sample_process(pid=2 ** 22 + 12345) == {}  # no such process


def test_resource_sampler_reports_resources_lines(tmp_path):
    reporter = Reporter(tmp_path / "proc0.jsonl")
    sampler = resources.ResourceSampler(reporter, interval=0.05)
    sampler.start()
    try:
        deadline = time.time() + 3.0
        while time.time() < deadline and not (tmp_path / "proc0.jsonl").read_text():
            time.sleep(0.02)
    finally:
        sampler.stop()
        reporter.close()
    (line, *_) = _lines(tmp_path / "proc0.jsonl")
    assert line["type"] == "resources" and line["values"]["sys/rss_mb"] > 1
    assert "sys/cpu_percent" in line["values"]


# -- a stalled lm_train -----------------------------------------------------------------------

SMALL_TRAIN = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128,
                   seq=32, batch=2)


def test_a_stalled_lm_train_leaves_one_stall_anomaly_and_a_dump(tmp_path):
    paths = RunPaths(tmp_path / "run").ensure()
    reporter = Reporter(paths.report_file(0), process_id=0)
    progress = get_progress()
    progress.reset()
    rec = FlightRecorder(progress, reporter=reporter, out_dir=paths.reports, floor_s=0.3,
                         interval_s=0.05, progress_interval_s=0.1)
    rec.start()
    try:
        trainers.lm_train(Context(params=dict(SMALL_TRAIN, steps=6, stall_at_step=3,
                                              stall_s=1.5, device="cpu"), reporter=reporter))
    finally:
        rec.stop()
        progress.reset()
        reporter.close()
    lines = _lines(paths.report_file(0))
    stalls = [e for e in lines if e["type"] == "anomaly"]
    assert [e["kind"] for e in stalls] == ["stall"]
    assert stalls[0]["step"] == 2 and stalls[0]["dump_artifact"] == "reports/flightrec-0-1.json"
    doc = json.loads((paths.reports / "flightrec-0-1.json").read_text())
    main = "".join(next(v for k, v in doc["threads"].items() if k.startswith("MainThread")))
    lines_of, first = inspect.getsourcelines(trainers._fault_injection)
    frames = [ln for ln in main.splitlines() if "trainers.py" in ln and "in on_step" in ln]
    assert frames, main
    lineno = int(frames[-1].split("line ")[1].split(",")[0])
    assert first <= lineno < first + len(lines_of)  # inside _fault_injection
    assert doc["progress"]["step"] == 2 and doc["devices"] == {}
    assert [e["step"] for e in lines if e["type"] == "progress"][-1] == 5
    # The JAX watcher files the anomaly and the progress like a JAX worker's.
    registry = RunRegistry(tmp_path / "registry.sqlite")
    run = registry.create_run({"kind": "experiment", "run": {"entrypoint": "m:f"}})
    handle = SimpleNamespace(run_id=run.id, run_uuid=run.uuid,
                             plan=SimpleNamespace(num_hosts=1), paths=paths, report_offsets={})
    GangWatcher(registry).ingest(handle)
    (anomaly,) = registry.get_anomalies(run.id)
    assert anomaly["kind"] == "stall"
    assert registry.get_progress(run.id)[0]["step"] == 5
    registry.close()
