"""The port's utilization ledger against the JAX package's.

Counterparts of ``tests/test_tracking/test_ledger.py`` on the port's
``UtilizationLedger`` (the bucket decomposition, goodput and MFU, the
throttled and final rows, the analytic FLOPs), the port's compile events
(kernel builds and loads, ``record_compile``), a scripted sequence of
``start``, ``account``, ``step``, ``mark_loop_start`` and ``flush`` through
both ledgers on one patched ``time.perf_counter`` (rows equal but for the
device fields), port rows through the JAX ``GangWatcher`` and
``goodput_status``, and the two workloads that feed it on the CPU:
``lm_train``'s final row and the serving engine's, against the JAX engine's
on the same weights and requests.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polyaxon_tpu.tracking.ledger as jledger
import polyaxon_tpu_torch._build as build_mod
import polyaxon_tpu_torch.tracking.ledger as tledger
from polyaxon_tpu.db.registry import RunRegistry
from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.monitor.watcher import GangWatcher, goodput_status
from polyaxon_tpu.serving import ServingEngine as JaxEngine
from polyaxon_tpu.stores.layout import RunPaths
from polyaxon_tpu_torch.builtins.trainers import lm_train
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.serving import ServingEngine
from polyaxon_tpu_torch.tracking import Reporter
from polyaxon_tpu_torch.tracking.context import Context
from polyaxon_tpu_torch.tracking.ledger import (
    BUCKETS,
    PEAK_FLOPS,
    UtilizationLedger,
    conv_classifier_flops_per_image,
    record_compile,
    transformer_flops_per_token,
)

SPEC = {"kind": "experiment", "run": {"entrypoint": "polyaxon_tpu.builtins.trainers:noop"}}
#: Fields that describe the device rather than the accounting.
DEVICE_FIELDS = ("devices", "device_kind", "peak_flops_per_s", "tokens_per_device_s",
                 "hbm_peak_bytes")


# -- accounting ----------------------------------------------------------------

def test_buckets_are_the_reference_s_and_sum_to_wall():
    assert BUCKETS == jledger.BUCKETS
    led = UtilizationLedger(interval_s=1e9)
    led.start()
    led.account("data_wait_s", 0.002)
    led.step(0.01, tokens=100)
    led.step(0.01, tokens=100)
    time.sleep(0.03)
    row = led.snapshot()
    assert set(row["buckets"]) == set(BUCKETS)
    assert sum(row["buckets"].values()) == pytest.approx(row["wall_s"], rel=1e-6)
    assert row["buckets"]["idle_s"] > 0  # idle absorbs the sleep the steps didn't cover
    assert row["steps"] == 2 and row["tokens"] == 200


@pytest.mark.parametrize("source, acc, steps, want", [
    # Step compute derived from step wall less the waits measured in the loop.
    ("train", {"data_wait_s": 0.4, "ckpt_block_s": 0.1}, [1.0], 0.5),
    # The serving engine accounts device-busy time itself: no double count.
    ("serving", {"step_compute_s": 0.25}, [None], 0.25),
])
def test_step_compute(source, acc, steps, want):
    led = UtilizationLedger(interval_s=1e9)
    led.start(source=source)
    led.mark_loop_start()
    for bucket, seconds in acc.items():
        led.account(bucket, seconds)
    for dt in steps:
        led.step(dt, tokens=4)
    row = led.snapshot()
    assert row["source"] == source
    assert row["buckets"]["step_compute_s"] == pytest.approx(want)


def test_goodput_clamped_to_one():
    led = UtilizationLedger(interval_s=1e9)
    led.start()
    led.account("step_compute_s", 99.0)
    led.step()
    assert led.snapshot()["goodput"] == 1.0


def test_flops_per_step_accumulates_and_mfu_needs_a_peak():
    led = UtilizationLedger(interval_s=1e9)
    led.start(device="cpu")
    led.set_flops_per_step(1e6)
    led.step(0.01)
    led.step(0.01, flops=5e5)
    row = led.snapshot()
    assert row["flops"] == pytest.approx(1.5e6)
    assert row["mfu"] == 0.0  # the CPU has no peak: MFU 0, not a made-up ratio
    assert (row["devices"], row["device_kind"], row["peak_flops_per_s"]) == (0, "", 0.0)
    assert led.sample_hbm() == 0.0


def test_peak_table_is_the_reference_s_plus_the_h100():
    assert {k: v for k, v in PEAK_FLOPS.items() if k in jledger.PEAK_FLOPS} == jledger.PEAK_FLOPS
    assert set(PEAK_FLOPS) - set(jledger.PEAK_FLOPS) == {"NVIDIA H100 80GB HBM3"}
    assert PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == 989e12


@pytest.mark.parametrize("name, peak", [("NVIDIA H100 80GB HBM3", 989e12),
                                        ("NVIDIA A100-SXM4-80GB", 0.0)])
def test_a_card_gives_one_device_its_name_and_its_peak(monkeypatch, name, peak):
    monkeypatch.setattr(tledger.torch.cuda, "get_device_name", lambda dev=None: name)
    led = UtilizationLedger(interval_s=1e9)
    led.start(device="cuda")
    led.set_flops_per_step(1e12)
    led.step(0.5, tokens=10)
    row = led.snapshot()
    assert (row["devices"], row["device_kind"], row["peak_flops_per_s"]) == (1, name, peak)
    want = 1e12 / (row["wall_s"] * peak) if peak else 0.0
    assert row["mfu"] == pytest.approx(want, rel=1e-3)
    assert row["tokens_per_device_s"] == pytest.approx(10 / row["wall_s"], rel=1e-3)


def test_flush_emits_seq_numbered_cumulative_rows():
    rows = []
    led = UtilizationLedger(sink=rows.append, process_id=3, interval_s=1e9)
    led.start()
    led.step(0.01, tokens=10)
    led.flush()
    led.step(0.01, tokens=10)
    led.flush(final=True)
    assert [r["seq"] for r in rows] == [1, 2]
    assert [r["final"] for r in rows] == [False, True]
    assert rows[1]["tokens"] == 20 and rows[0]["process_id"] == 3


def test_sink_errors_never_propagate_and_an_unarmed_ledger_is_inert():
    def bad_sink(row):
        raise RuntimeError("sink down")

    led = UtilizationLedger(sink=bad_sink, interval_s=1e9)
    led.step(1.0)
    assert led.flush(final=True) is None  # never started
    led.start()
    led.step(0.01)
    assert led.flush() is not None  # the sink's failure stays in the ledger


def test_maybe_flush_throttles():
    rows = []
    led = UtilizationLedger(sink=rows.append, interval_s=60.0)
    led.start()
    for _ in range(5):
        led.step(0.001)
        led.maybe_flush()
    assert rows == []
    led.interval_s = 0.0
    led.step(0.001)
    assert led.maybe_flush() is True and len(rows) == 1


def test_interval_knob(monkeypatch):
    monkeypatch.setenv("POLYAXON_TPU_LEDGER_INTERVAL_S", "0.25")
    assert UtilizationLedger().interval_s == 0.25 == jledger.UtilizationLedger().interval_s


# -- compile telemetry ---------------------------------------------------------

def test_record_compile_counts_and_start_takes_a_baseline():
    record_compile(1.0, events=2, misses=2)
    led = UtilizationLedger(interval_s=1e9)
    led.start()
    assert led.snapshot()["compile_s"] == 0.0  # compiled before start()
    record_compile(0.25, events=1, misses=1)
    record_compile(hits=3)
    row = led.snapshot()
    assert row["compile_s"] == pytest.approx(0.25) and row["compile_events"] == 1
    assert (row["compile_cache_hits"], row["compile_cache_misses"]) == (3, 1)
    assert row["buckets"]["xla_compile_s"] == pytest.approx(0.25)


def test_an_in_loop_compile_comes_out_of_step_compute():
    led = UtilizationLedger(interval_s=1e9)
    led.start()
    record_compile(0.5, events=1)  # before the loop: not step wall
    led.mark_loop_start()
    record_compile(0.2, events=1)  # a graph captured by the first step
    led.step(1.0)
    row = led.snapshot()
    assert row["buckets"]["step_compute_s"] == pytest.approx(0.8)
    assert row["buckets"]["xla_compile_s"] == pytest.approx(0.7)


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    """``_build`` over a fake compiler that writes its output file."""
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build_mod, "library_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(build_mod, "_nvcc_command",
                        lambda name, out: ["sh", "-c", f"sleep 0.05; echo built > {out}"])
    monkeypatch.setattr(build_mod.ctypes, "CDLL", lambda path: SimpleNamespace(path=path))
    monkeypatch.setattr(build_mod, "_loaded", {})
    return tmp_path


def test_kernel_builds_are_misses_and_loads_of_built_libraries_hits(fake_nvcc):
    led = UtilizationLedger(interval_s=1e9)
    led.start()
    reports = build_mod.build(["a", "b"])
    assert (fake_nvcc / "liba.so").exists() and reports["a"] == ""
    row = led.snapshot()
    assert row["compile_events"] == 2 and row["compile_cache_misses"] == 2
    assert 0.05 <= row["compile_s"] < 5  # the two builds ran together: one wall
    assert build_mod.build(["a"]) == {"a": "cached"}
    build_mod.load("b")
    build_mod.load("b")  # already loaded: nothing more
    row = led.snapshot()
    assert (row["compile_events"], row["compile_cache_hits"], row["compile_cache_misses"]) == (
        2, 2, 2)


# -- the port's and the reference's ledger on one script ------------------------

def _script(leds, clock, source):
    def both(fn):
        for led in leds:
            fn(led)

    both(lambda led: led.start(source=source))
    record_compile(0.7, events=1, misses=1)
    clock[0] += 1.0
    if source == "train":
        both(lambda led: led.set_flops_per_step(1e6))
        both(lambda led: led.mark_loop_start())
    for i in range(8):
        clock[0] += 0.25
        if i == 2:
            record_compile(0.1, events=1)  # a capture inside the loop
        if source == "train":
            both(lambda led: led.account("data_wait_s", 0.01))
            both(lambda led: led.step(0.25, tokens=64))
        else:
            both(lambda led: led.account("step_compute_s", 0.2))
            if i % 3:
                both(lambda led: led.step(tokens=i))
            both(lambda led: led.merge_extra(decode_busy_frac=i / 10, slot_occupancy=0.5))
        both(lambda led: led.maybe_flush())
    both(lambda led: led.account("ckpt_block_s", 0.05))
    both(lambda led: led.account("metric_drain_s", 0.02))
    clock[0] += 0.3
    both(lambda led: led.flush(final=True))


@pytest.mark.parametrize("source", ["train", "serving"])
def test_the_port_s_rows_are_the_reference_s_under_one_script(monkeypatch, source):
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    # Both ledgers read the port's compile counters (the reference's come
    # from jax.monitoring; the script's compile events are the port's).
    monkeypatch.setattr(jledger, "compile_telemetry", tledger.compile_telemetry)
    monkeypatch.setattr(jledger, "compile_cache_telemetry", tledger.compile_cache_telemetry)
    rows = {"port": [], "jax": []}
    leds = (UtilizationLedger(sink=rows["port"].append, process_id=1, interval_s=0.6),
            jledger.UtilizationLedger(sink=rows["jax"].append, process_id=1, interval_s=0.6))
    _script(leds, clock, source)

    def accounting(row):
        return {k: v for k, v in row.items() if k not in DEVICE_FIELDS}

    assert len(rows["port"]) > 2 and rows["port"][-1]["final"]
    assert [accounting(r) for r in rows["port"]] == [accounting(r) for r in rows["jax"]]


# -- port rows through the JAX watcher --------------------------------------------

@pytest.fixture()
def rig(tmp_path):
    registry = RunRegistry(tmp_path / "registry.sqlite")
    run = registry.create_run(SPEC, name="ledgered")
    paths = RunPaths(tmp_path / "run").ensure()
    handle = SimpleNamespace(run_id=run.id, run_uuid=run.uuid,
                             plan=SimpleNamespace(num_hosts=2), paths=paths, report_offsets={})
    yield registry, GangWatcher(registry), handle
    registry.close()


def _rows(monkeypatch, pid, *walls):
    """A port ledger's rows, one per (wall, step compute) on a patched clock;
    the last is final."""
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    rows = []
    led = UtilizationLedger(sink=rows.append, process_id=pid, interval_s=1e9)
    led.start()
    for i, (wall, compute) in enumerate(walls):
        led.account("step_compute_s", compute - led.snapshot()["buckets"]["step_compute_s"])
        led.step(tokens=1000)
        clock[0] = wall
        led.flush(final=i == len(walls) - 1)
    monkeypatch.undo()
    return rows


def test_port_rows_through_the_watcher_and_goodput_status(rig, monkeypatch):
    registry, watcher, handle = rig
    for pid, rows in ((0, _rows(monkeypatch, 0, (5.0, 4.0), (10.0, 8.0))),
                      (1, _rows(monkeypatch, 1, (12.0, 6.0)))):
        r = Reporter(handle.paths.report_file(pid), process_id=pid)
        for row in rows:
            r.ledger(row)
        r.close()
    watcher.ingest(handle)
    got = registry.get_utilization(handle.run_id)
    assert [(r["process_id"], r["seq"], r["final"]) for r in got] == [
        (0, 1, False), (0, 2, True), (1, 1, True)]
    assert got[1]["buckets"]["step_compute_s"] == 8.0 and got[1]["wall_s"] == 10.0
    g = goodput_status(registry, handle.run_id)
    assert (g["rows"], g["processes"], g["wall_s"]) == (3, 2, 12.0)
    assert g["buckets"]["step_compute_s"]["sum"] == pytest.approx(14.0)
    assert g["goodput_ratio"] == pytest.approx(14.0 / 22.0)
    assert g["final"] is True


# -- the workloads on the CPU ------------------------------------------------------

SMALL_TRAIN = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128)
STEPS, BATCH, SEQ = 12, 4, 32


def test_lm_train_s_final_row_decomposes_its_wall(rig, monkeypatch):
    registry, watcher, handle = rig
    monkeypatch.setenv("POLYAXON_TPU_LEDGER_INTERVAL_S", "0.0")
    r = Reporter(handle.paths.report_file(0), process_id=0)
    led = tledger.configure(sink=r.ledger, interval_s=0.0)
    try:
        lm_train(Context(params=dict(SMALL_TRAIN, steps=STEPS, batch=BATCH, seq=SEQ,
                                     device="cpu"), reporter=r))
    finally:
        led.configure(sink=None, interval_s=30.0)
        r.close()
    watcher.ingest(handle)
    rows = registry.get_utilization(handle.run_id)
    final = rows[-1]
    assert final["final"] is True and final["source"] == "train" and len(rows) > 2
    for row in rows:
        assert set(row["buckets"]) == set(BUCKETS)
        assert sum(row["buckets"].values()) == pytest.approx(row["wall_s"], rel=0.05)
        assert 0.0 < row["goodput"] <= 1.0
    cfg = ttr.TransformerConfig(max_seq=SEQ, **SMALL_TRAIN)
    per_token = transformer_flops_per_token(cfg.n_params, cfg.n_layers, cfg.n_heads,
                                            cfg.head_dim, SEQ)
    assert (final["steps"], final["tokens"]) == (STEPS, STEPS * BATCH * SEQ)
    assert final["flops"] == pytest.approx(STEPS * BATCH * SEQ * per_token)
    assert (final["devices"], final["device_kind"], final["mfu"]) == (0, "", 0.0)
    g = goodput_status(registry, handle.run_id)
    assert g["steps"] == STEPS and g["final"] is True
    assert g["goodput_ratio"] == pytest.approx(
        final["buckets"]["step_compute_s"] / final["wall_s"], rel=1e-6)
    metrics = [json.loads(line) for line in handle.paths.report_file(0).read_text().splitlines()
               if json.loads(line)["type"] == "metric"]
    assert {"step_wall_s_p50", "step_wall_s_p95", "step_wall_s_p99"} <= set(
        metrics[-1]["values"])


SMALL_SERVE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
                   max_seq=48)


def test_the_engine_s_final_row_carries_the_jax_engine_s_extras():
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **SMALL_SERVE)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **SMALL_SERVE)
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    shared = [int(x) for x in rng.integers(0, 64, 16)]
    prompts = [shared + [int(x) for x in rng.integers(0, 64, n)] for n in (3, 9, 5, 12)]
    prompts += [[int(x) for x in rng.integers(0, 64, n)] for n in (7, 20)]
    kw = dict(slots=2, block_size=4, prefill_chunk=8, prefix_cache=True, warmup=False)
    rows = {"jax": [], "port": []}
    jledger.configure(sink=rows["jax"].append)
    tledger.configure(sink=rows["port"].append)
    outs = {}
    try:
        for name, engine in (("jax", JaxEngine(jp, jcfg, **kw)),
                             ("port", ServingEngine(tp, tcfg, device="cpu", **kw))):
            try:
                engine.start()
                outs[name] = [engine.submit(p, 6).wait(timeout=120) for p in prompts[:3]]
                reqs = [engine.submit(p, 6) for p in prompts[3:]]
                outs[name] += [r.wait(timeout=120) for r in reqs]
                tokens = engine.stats()["tokens_generated"]
            finally:
                engine.stop()
            assert rows[name][-1]["tokens"] == tokens
    finally:
        jledger.configure(sink=None)
        tledger.configure(sink=None)
    assert outs["port"] == outs["jax"]
    jrow, trow = rows["jax"][-1], rows["port"][-1]
    assert trow["final"] and trow["source"] == "serving"
    assert set(trow["extra"]) == set(jrow["extra"])
    assert (trow["steps"], trow["tokens"]) == (jrow["steps"], jrow["tokens"])
    for key in ("prefix_cache_hits", "prefix_cache_misses", "prefix_cache_evictions",
                "requests_shed", "parked_sequences", "host_spilled_blocks_total",
                "host_restored_blocks_total", "prefill_backlog_chunks", "spec_proposed_total",
                "spec_accepted_total", "kv_dtype"):
        assert trow["extra"][key] == jrow["extra"][key], key
    assert trow["extra"]["prefix_cache_hits"] > 0
    assert 0.0 < trow["extra"]["decode_busy_frac"] <= 1.0
    assert sum(trow["buckets"].values()) == pytest.approx(trow["wall_s"], rel=0.05)


# -- analytic FLOPs ------------------------------------------------------------------

@pytest.mark.parametrize("args", [(1000, 2, 4, 16, 64), (671_000_000, 8, 32, 64, 1024)])
def test_transformer_flops_are_the_reference_s(args):
    assert transformer_flops_per_token(*args) == jledger.transformer_flops_per_token(*args)
    n, layers, heads, hd, seq = args
    assert transformer_flops_per_token(*args) == 6 * n + 12 * layers * heads * hd * seq


@pytest.mark.parametrize("args", [(8, 3, (4,), 16, 10), (32, 3, (32, 64), 128, 10)])
def test_conv_classifier_flops_are_the_reference_s(args):
    assert conv_classifier_flops_per_image(*args) == jledger.conv_classifier_flops_per_image(*args)


def test_conv_classifier_counts_macs_at_each_resolution():
    conv = 2 * 8 * 8 * 9 * 3 * 4
    dense = 2 * (4 * 4 * 4) * 16 + 2 * 16 * 10
    assert conv_classifier_flops_per_image(8, 3, (4,), 16, 10) == pytest.approx(3 * (conv + dense))
