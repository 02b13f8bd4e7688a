"""The port's command bus and profiling hooks on the CPU:
``tracking/capture.py`` (``CaptureAgent``) and ``tracking/profiling.py``
(``StepProfiler``, ``annotate``, ``TorchProfiler``).

The cases are ``tests/test_tracking/test_capture.py``'s and
``tests/test_tracking/test_profiling.py``'s, on the port's classes: a
recording reporter, and a fake trace session in place of
``profiling.profiler`` where those tests fake ``jax.profiler`` — the full
lifecycle (command file, ack, step window, artifacts, capture and command
records) without a real trace.  One test runs a real ``torch.profiler``
window on the CPU.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from polyaxon_tpu_torch.tracking import profiling
from polyaxon_tpu_torch.tracking.capture import (
    DEFAULT_NUM_STEPS,
    CaptureAgent,
    configure,
    get_capture_agent,
)
from polyaxon_tpu_torch.tracking.profiling import StepProfiler, TorchProfiler, annotate


class _Reporter:
    def __init__(self):
        self.captures = []
        self.commands = []

    def capture(self, record):
        self.captures.append(dict(record))

    def command_event(self, uuid, state, message=None, **attrs):
        self.commands.append({"uuid": uuid, "state": state, "message": message})


class _FakeProfiler:
    """The trace session's three calls: ``start_trace`` records its dir (or
    raises), ``stop_trace`` writes a trace file there (or raises),
    ``device_memory_profile`` returns bytes."""

    def __init__(self, fail_start=False, fail_stop=False):
        self.fail_start = fail_start
        self.fail_stop = fail_stop
        self.starts = []
        self.stops = 0
        self.trace_dir = None

    def start_trace(self, path):
        if self.fail_start:
            raise RuntimeError("a trace is already active")
        self.starts.append(str(path))
        self.trace_dir = Path(path)

    def stop_trace(self):
        if self.fail_stop:
            raise RuntimeError("no trace is active")
        self.stops += 1
        if self.trace_dir:
            self.trace_dir.mkdir(parents=True, exist_ok=True)
            (self.trace_dir / "host.1.pt.trace.json").write_text("{}")
        self.trace_dir = None

    def device_memory_profile(self):
        return b"memory-snapshot"


@pytest.fixture()
def fake_profiler(monkeypatch):
    prof = _FakeProfiler()
    monkeypatch.setattr(profiling, "profiler", prof)
    return prof


@pytest.fixture()
def rig(tmp_path, fake_profiler):
    reporter = _Reporter()
    mailbox = tmp_path / "commands" / "proc0"
    mailbox.mkdir(parents=True)
    agent = CaptureAgent().configure(reporter=reporter, mailbox=mailbox,
                                     profiles_root=tmp_path / "profiles", process_id=0)
    return SimpleNamespace(agent=agent, reporter=reporter, mailbox=mailbox,
                           profiler=fake_profiler, run_root=tmp_path)


def _drop(rig, uuid="cmd1", kind="profile", payload=None):
    body = {"uuid": uuid, "kind": kind, "payload": payload or {}}
    (rig.mailbox / f"{uuid}.json").write_text(json.dumps(body))


# -- the mailbox --------------------------------------------------------------


def test_idle_poll_is_noop(rig):
    rig.agent.poll()
    assert rig.reporter.commands == [] and rig.reporter.captures == []


def test_unconfigured_agent_poll_is_noop():
    CaptureAgent().poll()  # no mailbox — must not raise


def test_garbage_command_file_dropped(rig):
    (rig.mailbox / "bad.json").write_text("{not json")
    (rig.mailbox / "list.json").write_text("[1, 2]")
    rig.agent.poll()
    assert list(rig.mailbox.iterdir()) == []
    assert rig.reporter.commands == []


def test_unknown_kind_fails_typed(rig):
    _drop(rig, uuid="u1", kind="quantum_teleport")
    rig.agent.poll()
    assert list(rig.mailbox.iterdir()) == []
    (evt,) = rig.reporter.commands
    assert evt["state"] == "failed" and "quantum_teleport" in evt["message"]


def test_register_handler_extends_the_bus(rig):
    seen = []
    rig.agent.register_handler("checkpoint-now", seen.append)
    _drop(rig, uuid="u2", kind="checkpoint-now")
    rig.agent.poll()
    assert seen and seen[0]["uuid"] == "u2"
    assert [e["state"] for e in rig.reporter.commands] == ["acked"]


def test_a_failing_handler_fails_its_command(rig):
    def broken(cmd):
        raise OSError("no room")

    rig.agent.register_handler("drain", broken)
    _drop(rig, uuid="u3", kind="drain")
    rig.agent.poll()
    assert [e["state"] for e in rig.reporter.commands] == ["acked", "failed"]
    assert "OSError: no room" in rig.reporter.commands[-1]["message"]


# -- the profile window -------------------------------------------------------


def test_full_window_capture(rig):
    _drop(rig, uuid="cap1", payload={"num_steps": 2})
    rig.agent.poll()
    assert rig.reporter.commands[0] == {"uuid": "cap1", "state": "acked", "message": None}
    assert rig.reporter.captures[0]["status"] == "started"
    # a registered executable contributes its text
    rig.agent.register_executable("train_step", SimpleNamespace(as_text=lambda: "module m"))
    rig.agent.on_step(10)
    assert rig.profiler.trace_dir is not None  # tracing
    rig.agent.on_step(11)  # window filled -> finalize
    record = rig.reporter.captures[-1]
    assert record["status"] == "complete"
    assert record["start_step"] == 10 and record["num_steps"] == 2
    assert record["attrs"]["trace"] is True
    out = rig.run_root / "profiles" / "cap1" / "proc0"
    assert (out / "memory.json").read_bytes() == b"memory-snapshot"
    assert "module m" in (out / "hlo.txt").read_text()
    assert json.loads((out / "manifest.json").read_text())["capture_id"] == "cap1"
    # artifact keys are run-root relative and include the trace
    assert all(a.startswith("profiles/cap1/proc0/") for a in record["artifacts"])
    assert any(a.endswith(".pt.trace.json") for a in record["artifacts"])
    assert rig.reporter.commands[-1]["state"] == "complete"
    # the agent is free for the next capture
    _drop(rig, uuid="cap2", payload={"num_steps": 1})
    rig.agent.poll()
    rig.agent.on_step(12)
    assert rig.reporter.captures[-1]["capture_id"] == "cap2"


def test_default_window_length(rig):
    _drop(rig, uuid="cap3")
    rig.agent.poll()
    for i in range(DEFAULT_NUM_STEPS):
        rig.agent.on_step(i)
    assert rig.reporter.captures[-1]["status"] == "complete"
    assert rig.reporter.captures[-1]["num_steps"] == DEFAULT_NUM_STEPS


def test_trace_failure_degrades_not_fails(rig):
    rig.profiler.fail_start = True
    _drop(rig, uuid="cap4", payload={"num_steps": 1})
    rig.agent.poll()
    rig.agent.on_step(0)
    record = rig.reporter.captures[-1]
    assert record["status"] == "complete"
    assert record["attrs"]["trace"] is False and "trace_error" in record["attrs"]
    assert any(a.endswith("memory.json") for a in record["artifacts"])  # still collected


def test_second_command_while_in_flight_fails_typed(rig):
    _drop(rig, uuid="cap5", payload={"num_steps": 10})
    rig.agent.poll()
    rig.agent.on_step(0)
    _drop(rig, uuid="cap6")
    rig.agent.poll()
    failed = [e for e in rig.reporter.commands if e["uuid"] == "cap6"]
    assert failed[-1]["state"] == "failed" and "in flight" in failed[-1]["message"]


def test_deadline_reap_without_steps(rig):
    """A capture on a workload that never steps resolves at its deadline."""
    _drop(rig, uuid="cap7", payload={"duration_s": 1.0})
    rig.agent.poll()
    rig.agent._job["deadline"] = time.time() - 1  # fast-forward
    rig.agent.poll()
    record = rig.reporter.captures[-1]
    assert record["status"] == "complete" and record["attrs"]["no_step_window"] is True
    assert rig.reporter.commands[-1] == {"uuid": "cap7", "state": "complete", "message": None}


def test_deadline_reap_mid_window_truncates(rig):
    _drop(rig, uuid="cap8", payload={"num_steps": 100, "duration_s": 1.0})
    rig.agent.poll()
    rig.agent.on_step(0)
    rig.agent._job["deadline"] = time.time() - 1
    rig.agent.poll()
    record = rig.reporter.captures[-1]
    assert record["status"] == "complete" and record["attrs"]["window_truncated"] is True
    assert record["num_steps"] == 1 and rig.profiler.stops == 1


def test_close_mid_capture_reports_failed(rig):
    _drop(rig, uuid="cap9", payload={"num_steps": 100})
    rig.agent.poll()
    rig.agent.on_step(0)
    rig.agent.close()
    record = rig.reporter.captures[-1]
    assert record["status"] == "failed" and "exited" in record["message"]
    assert rig.reporter.commands[-1]["state"] == "failed"
    assert rig.profiler.stops == 1
    # closed agents ignore further mailbox traffic
    _drop(rig, uuid="cap10")
    rig.agent.poll()
    assert rig.reporter.commands[-1]["uuid"] == "cap9"


def test_on_step_fast_path_without_job(rig):
    rig.agent.on_step(0)  # no capture armed — must be free of effects
    assert rig.reporter.captures == [] and rig.profiler.starts == []


def test_configure_returns_shared_agent(tmp_path):
    agent = configure(reporter=None, mailbox=tmp_path, profiles_root=tmp_path / "profiles",
                      process_id=3)
    try:
        assert agent is get_capture_agent()
        assert agent.process_id == 3
    finally:
        configure(reporter=None, mailbox=None, profiles_root=None, process_id=0)


# -- StepProfiler -------------------------------------------------------------


def test_profiler_disabled_by_default(fake_profiler, tmp_path):
    p = StepProfiler(tmp_path)
    assert not p.enabled
    for i in range(5):
        p.on_step(i)
    p.close()
    assert fake_profiler.starts == [] and fake_profiler.stops == 0


def test_profiler_exact_window(fake_profiler, tmp_path):
    p = StepProfiler(tmp_path, start_step=2, num_steps=3)
    for i in range(10):
        p.on_step(i)
    assert len(fake_profiler.starts) == 1 and fake_profiler.starts[0].endswith("profile")
    assert fake_profiler.stops == 1
    p.close()
    assert fake_profiler.stops == 1  # window already closed; close() is a no-op


def test_profiler_start_at_step_zero(fake_profiler, tmp_path):
    p = StepProfiler(tmp_path, start_step=0, num_steps=1)
    p.on_step(0)
    p.on_step(1)
    assert len(fake_profiler.starts) == 1 and fake_profiler.stops == 1


def test_profiler_window_past_end_closed_by_close(fake_profiler, tmp_path):
    p = StepProfiler(tmp_path, start_step=3, num_steps=100)
    for i in range(5):
        p.on_step(i)
    assert len(fake_profiler.starts) == 1 and fake_profiler.stops == 0
    p.close()
    assert fake_profiler.stops == 1


def test_profiler_step_jump_past_window_stops_trace(fake_profiler, tmp_path):
    """A resumed loop can skip steps; landing past the window end stops it."""
    p = StepProfiler(tmp_path, start_step=1, num_steps=2)
    p.on_step(1)
    p.on_step(50)
    assert fake_profiler.stops == 1


def test_profiler_never_started_close_is_noop(fake_profiler, tmp_path):
    p = StepProfiler(tmp_path, start_step=90, num_steps=5)
    p.on_step(1)
    p.close()
    p.close()
    assert fake_profiler.starts == [] and fake_profiler.stops == 0


def test_profiler_start_failure_warns_and_disables(fake_profiler, tmp_path, caplog):
    fake_profiler.fail_start = True
    p = StepProfiler(tmp_path, start_step=0, num_steps=2)
    with caplog.at_level("WARNING", logger=profiling.logger.name):
        p.on_step(0)
    assert any("start_trace" in r.message for r in caplog.records)
    assert not p.enabled
    fake_profiler.fail_start = False  # later steps never retry a broken profiler
    p.on_step(0)
    p.on_step(1)
    assert fake_profiler.starts == []
    p.close()


def test_profiler_stop_failure_disables_and_close_stays_idempotent(fake_profiler, tmp_path):
    fake_profiler.fail_stop = True
    p = StepProfiler(tmp_path, start_step=0, num_steps=1)
    p.on_step(0)
    p.on_step(1)  # stop blows up -> disabled, not raised
    assert not p.enabled
    p.close()
    p.close()


def test_profiler_close_idempotent_mid_window(fake_profiler, tmp_path):
    p = StepProfiler(tmp_path, start_step=0, num_steps=10)
    p.on_step(0)
    p.close()
    p.close()
    assert fake_profiler.stops == 1


def test_annotate_falls_back_to_a_null_context(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_profiler(name, *a, **k):
        if name == "torch.profiler":
            raise ImportError("no profiler here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_profiler)
    cm = annotate("step")
    assert isinstance(cm, contextlib.nullcontext)
    with cm:
        pass


def test_a_real_torch_profiler_window_on_the_cpu(tmp_path):
    """StepProfiler over the process's real trace session: one Chrome trace
    under <outputs>/profile holding the window's ops and its annotation, and
    a second session refused while the first runs."""
    p = StepProfiler(tmp_path, start_step=1, num_steps=2)
    x = torch.randn(32, 32)
    for step in range(4):
        p.on_step(step)
        if step == 1:
            with pytest.raises(RuntimeError, match="already active"):
                profiling.profiler.start_trace(tmp_path / "other")
        with annotate(f"step{step}"):
            x = torch.mm(x, x).tanh()
    p.close()
    (trace,) = (tmp_path / "profile").glob("*.pt.trace.json")
    names = [e.get("name") for e in json.loads(trace.read_text())["traceEvents"]]
    assert "step1" in names and "step2" in names and "step0" not in names
    assert "aten::mm" in names
    assert isinstance(profiling.profiler, TorchProfiler)
    with pytest.raises(RuntimeError, match="no trace is active"):
        profiling.profiler.stop_trace()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiling.profiler.device_memory_profile()


def test_annotate_is_a_record_function_span():
    from torch.profiler import record_function

    cm = annotate("fwd")
    assert isinstance(cm, record_function)
    with cm:
        torch.ones(2).sum()


# -- StepClock ----------------------------------------------------------------


def test_step_clock_unarmed_first_tick_returns_none():
    clock = profiling.StepClock()
    assert clock.tick() is None  # start() never called
    assert clock.tick() is not None


def test_step_clock_summary_means(monkeypatch):
    now = [0.0]
    monkeypatch.setattr(profiling, "perf_counter", lambda: now[0])
    clock = profiling.StepClock()
    clock.start()
    for dt in (1.0, 3.0):
        now[0] += dt
        clock.tick()
    clock.add("ckpt_block_s", 0.5)
    summary = clock.summary()
    assert summary["step_wall_s"] == pytest.approx(2.0)
    assert summary["ckpt_block_s"] == pytest.approx(0.25)


def test_step_clock_empty_summary():
    assert profiling.StepClock().summary() == {}
