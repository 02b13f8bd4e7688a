"""The port's worker and spawner alone: gangs of
``python -m polyaxon_tpu_torch.runtime.worker`` launched by
``spawner.local.LocalGangSpawner`` on the CPU (``cpu*`` accelerators, gloo).

A module fixture launches the gangs together and waits for all of them
(60 s at most); each test reads its gang's exit codes and report files.
Every gang caps its threads through the spec's ``env_vars``
(``OMP_NUM_THREADS=1``).  Tolerances: the 2-process ``synthetic_regression``
logs the JAX ``synthetic_regression``'s losses (run in process on a
``{"data": 2}`` virtual mesh) within 1e-6; the 2-process ``lm_train`` logs a
one-rank port ``lm_train``'s losses on the same global batch and seed within
1e-2 relative (its compute is bf16, and each rank's partial weight grads
round to bf16 before the sum; float32 exactness across ranks is held against
the JAX step in ``test_torch_gang_step.py``).
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import os
import signal
import time
from types import SimpleNamespace

import jax
import pytest
import torch

from polyaxon_tpu.builtins import trainers as jtrainers
from polyaxon_tpu.runtime.mesh import build_mesh as jax_build_mesh
from polyaxon_tpu.tracking import Context as JaxContext
from polyaxon_tpu.tracking import Reporter as JaxReporter
from polyaxon_tpu_torch.builtins.trainers import lm_train
from polyaxon_tpu_torch.compiler import compile_gang_plan
from polyaxon_tpu_torch.runtime import worker
from polyaxon_tpu_torch.spawner.local import LocalGangSpawner, LocalRun
from polyaxon_tpu_torch.stores.layout import StoreLayout
from polyaxon_tpu_torch.tracking.context import Context

GANG_TIMEOUT_S = 60.0
THREADS = {"OMP_NUM_THREADS": "1"}
REGRESSION = {"lr": 0.5, "steps": 8, "batch": 16, "dim": 4}
TINY_LM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
               seq=16, batch=4, steps=3)
BF16_RTOL = 1e-2


def spec(entry, declarations=None, seed=11, **topology):
    return {
        "kind": "experiment",
        "run": {"entrypoint": f"polyaxon_tpu_torch.builtins.trainers:{entry}"},
        "declarations": dict(declarations or {}),
        "environment": {"seed": seed, "env_vars": dict(THREADS),
                        "topology": topology or {"accelerator": "cpu-1"}},
    }


def service_without_topology():
    """An ``lm_server`` service spec that names no topology."""
    doc = spec("noop", {"host": "127.0.0.1"})
    del doc["environment"]["topology"]
    return dict(doc, kind="service",
                run={"entrypoint": "polyaxon_tpu_torch.builtins.services:lm_server"})


TWO_CPU_HOSTS = dict(accelerator="cpu", num_devices=2, num_hosts=2, mesh={"data": 2})
GANGS = {
    "noop": spec("noop"),
    "failing": spec("failing"),
    "regression": spec("synthetic_regression", REGRESSION, **TWO_CPU_HOSTS),
    "lm_train": spec("lm_train", TINY_LM, seed=5, **TWO_CPU_HOSTS, strategy="ddp"),
    **{f"lm_train_{strategy}": spec("lm_train", TINY_LM, seed=5,
                                    **dict(TWO_CPU_HOSTS, mesh={axis: 2}), strategy=strategy)
       for strategy, axis in (("fsdp", "data"), ("tp", "tensor"), ("ulysses", "sequence"),
                              ("pp", "pipeline"))},
    # The catalog's default cpu slice: 8 devices on one host.
    "dph_lm_train": spec("lm_train", TINY_LM, accelerator="cpu"),
    "dph_noop": spec("noop", accelerator="cpu"),
    "h100_no_card": spec("noop", accelerator="h100", num_devices=1, num_hosts=1),
    # No topology: the schema fills in the catalog's cpu, the worker the card.
    "server_no_topology": service_without_topology(),
    "metric_probe": spec("metric_probe", {"lr": 0.5, "epochs": 3}),
    "resume_counter": spec("resume_counter"),
}


def reports(handle, process_id=0):
    path = handle.paths.report_file(process_id)
    return [json.loads(line) for line in path.read_text().splitlines()]


def of_type(lines, kind):
    return [line for line in lines if line["type"] == kind]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    spawner = LocalGangSpawner(StoreLayout(tmp_path_factory.mktemp("gangs")),
                               heartbeat_interval=0.5)
    handles = {}
    try:
        for i, (name, doc) in enumerate(GANGS.items()):
            handles[name] = spawner.start(LocalRun(doc, id=i + 1), compile_gang_plan(doc))
        deadline = time.monotonic() + GANG_TIMEOUT_S
        while not all(h.all_exited for h in handles.values()):
            assert time.monotonic() < deadline, {n: h.poll() for n, h in handles.items()}
            time.sleep(0.1)
        yield handles
    finally:
        for h in handles.values():
            spawner.stop(h, grace=1.0)


def test_a_noop_gang_starts_runs_and_succeeds(gangs):
    h = gangs["noop"]
    assert h.poll() == {0: 0}
    lines = reports(h)
    assert [s["status"] for s in of_type(lines, "status")] == ["starting", "running",
                                                               "succeeded"]
    assert [(m["step"], m["values"]) for m in of_type(lines, "metric")] == [(0, {"done": 1.0})]


def test_a_failing_gang_reports_its_error_and_dumps(gangs):
    h = gangs["failing"]
    assert h.poll() == {0: 1}
    statuses = of_type(reports(h), "status")
    assert [s["status"] for s in statuses] == ["starting", "running", "failed"]
    assert statuses[-1]["message"] == "RuntimeError: intentional failure"
    assert "raise RuntimeError" in statuses[-1]["traceback"]
    dumps = sorted(h.paths.reports.glob("flightrec-0-*.json"))
    assert dumps, list(h.paths.reports.iterdir())
    dump = json.loads(dumps[0].read_text())
    assert dump["kind"] == "crash" and dump["exception"]["message"] == "intentional failure"
    assert "intentional failure" in h.paths.log_file(0).read_text()


def _jax_regression(tmp_path):
    """The JAX synthetic_regression in process on a {data: 2} virtual mesh:
    its logged (step, loss) pairs."""
    path = tmp_path / "jax.jsonl"
    reporter = JaxReporter(path, 0)
    mesh = jax_build_mesh({"data": 2}, devices=jax.devices()[:2])
    # A jax Mesh is callable (a context decorator): hand it over as a thunk.
    jtrainers.synthetic_regression(JaxContext(params=dict(REGRESSION), mesh=lambda: mesh,
                                              reporter=reporter, seed=11))
    reporter.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    return [(m["step"], m["values"]["loss"]) for m in of_type(lines, "metric")]


def test_a_two_process_regression_logs_the_jax_losses(gangs, tmp_path):
    h = gangs["regression"]
    assert h.poll() == {0: 0, 1: 0}
    port = [(m["step"], m["values"]["loss"]) for m in of_type(reports(h), "metric")]
    want = _jax_regression(tmp_path)
    assert [s for s, _ in port] == [s for s, _ in want] == [0, 5, 7]
    assert [x for _, x in port] == pytest.approx([x for _, x in want], abs=1e-6)
    assert not of_type(reports(h, 1), "metric")  # the leader logs
    finals = [of_type(reports(h, i), "log")[-1]["line"] for i in (0, 1)]
    assert finals[0] == finals[1] and finals[0].startswith("final loss")


def test_a_two_process_lm_train_logs_the_one_rank_losses(gangs):
    h = gangs["lm_train"]
    assert h.poll() == {0: 0, 1: 0}, h.paths.log_file(1).read_text()[-2000:]
    losses = {m["step"]: m["values"]["loss"] for m in of_type(reports(h), "metric")
              if "loss" in m["values"]}
    records = []
    lm_train(Context(params=dict(TINY_LM, device="cpu"), seed=5, records=records))
    want = {r["step"]: r["values"]["loss"] for r in records
            if r["kind"] == "metric" and "loss" in r["values"]}
    assert sorted(losses) == sorted(want) == [0, 2]
    assert [losses[s] for s in (0, 2)] == pytest.approx([want[s] for s in (0, 2)],
                                                        rel=BF16_RTOL)
    assert "strategy=ddp" in of_type(reports(h), "log")[-1]["line"]
    for i in (0, 1):  # each rank's ledger accounts its own half of the batch
        final = [row for row in of_type(reports(h, i), "ledger") if row.get("final")][-1]
        assert final["tokens"] == 3 * 2 * TINY_LM["seq"]


@pytest.mark.parametrize("strategy", ["fsdp", "tp", "ulysses", "pp"])
def test_a_two_process_sharded_lm_train_succeeds_with_the_one_rank_losses(gangs, strategy):
    """The same run under ``fsdp`` (each process holds half of every param
    and gathers each at its use), ``tp`` (half of the heads, MLP columns and
    vocabulary), ``ulysses`` (half of the sequence, all-to-all attention)
    and ``pp`` (one layer a stage, 2 microbatches through the GPipe
    schedule): both processes end ``succeeded`` and the leader logs the
    one-rank losses."""
    h = gangs[f"lm_train_{strategy}"]
    assert h.poll() == {0: 0, 1: 0}, h.paths.log_file(1).read_text()[-2000:]
    for i in (0, 1):
        assert of_type(reports(h, i), "status")[-1]["status"] == "succeeded"
    losses = {m["step"]: m["values"]["loss"] for m in of_type(reports(h), "metric")
              if "loss" in m["values"]}
    records = []
    lm_train(Context(params=dict(TINY_LM, device="cpu"), seed=5, records=records))
    want = {r["step"]: r["values"]["loss"] for r in records
            if r["kind"] == "metric" and "loss" in r["values"]}
    assert sorted(losses) == sorted(want) == [0, 2]
    assert [losses[s] for s in (0, 2)] == pytest.approx([want[s] for s in (0, 2)],
                                                        rel=BF16_RTOL)
    assert f"strategy={strategy}" in of_type(reports(h), "log")[-1]["line"]


def test_more_devices_than_one_a_process_raise_only_where_the_mesh_is_read(gangs):
    h = gangs["dph_lm_train"]
    assert h.poll() == {0: 1}
    failed = of_type(reports(h), "status")[-1]
    assert failed["status"] == "failed" and failed["message"].startswith("GangLayoutError")
    assert "8 devices" in failed["message"]
    assert gangs["dph_noop"].poll() == {0: 0}


@pytest.mark.parametrize("name, named", [
    ("h100_no_card", "accelerator 'h100'"),
    ("server_no_topology", "a spec naming no accelerator"),
])
def test_a_card_accelerator_without_a_card_raises_before_init(gangs, name, named):
    """Only a spec naming a ``cpu*`` accelerator runs on the CPU: one naming
    the card, or naming none, fails on a host without a card before the
    entrypoint runs."""
    h = gangs[name]
    assert h.poll() == {0: 1}
    statuses = of_type(reports(h), "status")
    assert [s["status"] for s in statuses] == ["starting", "failed"]
    assert f"{named} runs on the card and this host has none" in statuses[-1]["message"]


def test_a_second_spawner_reattaches_and_stops_a_gang(tmp_path):
    doc = spec("sleepy", {"seconds": 60})
    layout = StoreLayout(tmp_path)
    first = LocalGangSpawner(layout, heartbeat_interval=0.5)
    run = LocalRun(doc, id=9)
    plan = compile_gang_plan(doc)
    handle = first.start(run, plan)
    try:
        deadline = time.monotonic() + GANG_TIMEOUT_S
        while not any(line["type"] == "status" and line["status"] == "running"
                      for line in (reports(handle) if handle.paths.report_file(0).exists()
                                   else [])):
            assert time.monotonic() < deadline and handle.poll() == {0: None}
            time.sleep(0.1)
        rows = [{"process_id": 0, "pid": handle.processes[0].pid, "report_offset": 7}]
        second = LocalGangSpawner(layout, heartbeat_interval=0.5)
        assert second.reattach(run, plan, []) is None  # pids unrecorded
        assert second.reattach(LocalRun(doc, uuid="gone"), plan, rows) is None  # no run dir
        again = second.reattach(run, plan, rows)
        assert again.report_offsets == {0: 7} and again.poll() == {0: None}
        second.stop(again, grace=5.0)
        assert handle.processes[0].wait(5.0) == -signal.SIGTERM  # the group got the TERM
        assert again.poll() == {0: 1}  # dead, no rc file: the reference's exit 1
        handle.paths.log_file(0).with_suffix(".rc").write_text("3\n")
        assert second.reattach(run, plan, rows).poll() == {0: 3}  # an rc file wins
    finally:
        first.stop(handle, grace=1.0)
    with pytest.raises(ProcessLookupError):
        os.killpg(handle.processes[0].pid, 0)


def test_the_worker_reads_a_jax_style_run(tmp_path):
    """The spawner takes the run duck-typed: a JAX-registry-like object with
    ``id``, ``uuid``, ``spec_data``, ``code_ref`` and ``spec``."""
    doc = spec("noop")
    run = SimpleNamespace(id=3, uuid="jaxlike", spec_data=doc, code_ref=None,
                          spec=SimpleNamespace(environment=SimpleNamespace(seed=None)))
    spawner = LocalGangSpawner(StoreLayout(tmp_path), heartbeat_interval=0.5)
    handle = spawner.start(run, compile_gang_plan(doc))
    try:
        assert handle.processes[0].wait(GANG_TIMEOUT_S) == 0
        assert of_type(reports(handle), "status")[-1]["status"] == "succeeded"
    finally:
        spawner.stop(handle, grace=1.0)


def test_the_probe_entry_points_report_as_the_references(gangs):
    h = gangs["metric_probe"]
    assert h.poll() == {0: 0}
    (metric,) = of_type(reports(h), "metric")
    assert metric["step"] == 3
    assert metric["values"] == pytest.approx({"score": -0.04, "loss": 0.04})
    h = gangs["resume_counter"]
    assert h.poll() == {0: 0}
    assert (h.paths.checkpoints / "counter.txt").read_text() == "1"
    assert (h.paths.outputs / "attempt_1.marker").read_text() == "ok"
    assert [(m["step"], m["values"]) for m in of_type(reports(h), "metric")] == [
        (1, {"counter": 1.0})]


def test_a_card_gang_takes_one_rank_a_card(monkeypatch):
    """Device and backend from the accelerator: ``cpu*`` is the CPU and gloo;
    a card accelerator is ``cuda:<LOCAL_RANK>`` and NCCL, and a host whose
    ranks outnumber its cards raises before the distributed init (the cards
    counted as torch counts them, stubbed here)."""
    info = SimpleNamespace(process_id=1, num_processes=2)
    assert worker.device_and_backend("cpu-1", info) == ("cpu", "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2, raising=False)
    card = SimpleNamespace(process_id=1, num_processes=2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert worker.device_and_backend("h100", card) == ("cuda:1", "nccl")
    assert worker.device_and_backend(None, card) == ("cuda:1", "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1, raising=False)
    with pytest.raises(worker.GangLayoutError, match="2 ranks of the gang share this host's 1"):
        worker.device_and_backend("h100", card)
