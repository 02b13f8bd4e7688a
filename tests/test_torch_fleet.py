"""The port's LocalServingFleet: real replica subprocesses under real faults.

Every case of ``tests/test_serving/test_fleet_local.py`` runs here on the
port: replicas are ``python -m polyaxon_tpu_torch.serving.replica``
subprocesses with ``device="cpu"`` on the reference tests' small model
(vocab 64, d_model 32, 2 layers, 4 heads x 8, d_ff 64, seq 64, 4 slots),
behind the port's ``FleetRouter``.  One module-scoped fleet of 2 replicas
serves every test, its replicas run with ``OMP_NUM_THREADS=1`` (the tier-1
run shares the machine among several workers), and destructive tests run
last in file order.  Beside the reference's cases:

- greedy tokens through the router equal an in-process port engine built
  from the same seed (every replica makes the same weights);
- a JAX ``FleetRouter`` in front of the port's replicas gets the port
  router's answers (the wire contract is shared);
- a SIGSTOPped replica is ejected once its probes time out and re-admitted
  after SIGCONT, and its request ends completed or typed;
- ``poll()`` reaps a SIGKILLed replica and times the autoscaler's tick;
- a prefix-store writer SIGKILLed mid-snapshot leaves a store the next
  reader reads or skips.

No test here holds a server-side time to client wall time: on a loaded
machine that bound is noise (the card's run checks it, chip_smoke phase 24).
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from polyaxon_tpu.serving.router import FleetRouter as JaxFleetRouter
from polyaxon_tpu.serving.router import RouterError as JaxRouterError
from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params
from polyaxon_tpu_torch.serving import ServingEngine, kvstore
from polyaxon_tpu_torch.serving.fleet import LocalServingFleet
from polyaxon_tpu_torch.serving.loadgen import http_poisson_load, shared_prefix_prompts
from polyaxon_tpu_torch.serving.router import FleetRouter, RouterError
from polyaxon_tpu_torch.stats.metrics import labeled_key
from polyaxon_tpu_torch.tracking.trace import get_tracer

REPO = Path(__file__).resolve().parent.parent
MODEL = {
    "vocab_size": 64,
    "d_model": 32,
    "n_layers": 2,
    "n_heads": 4,
    "head_dim": 8,
    "d_ff": 64,
}
SEQ, SLOTS, SEED = 64, 4, 0
REPLICA_ENV = {"OMP_NUM_THREADS": "1", "POLYAXON_TPU_SERVING_WARMUP": "0"}


def _sustained_load(router, stop, outcomes):
    """Fire sequential requests until told to stop; every request ends
    as ``("ok", replica)`` or ``("err", kind)`` — typed, never silent."""
    while not stop.is_set():
        try:
            out = router.generate([[3, 1, 4, 1]], max_new_tokens=4)
            outcomes.append(("ok", out["replica"]))
        except RouterError as e:
            outcomes.append(("err", e.kind))


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    router = FleetRouter(
        probe_interval_s=0.2,
        probe_timeout_s=1.0,
        request_timeout_s=60.0,
        retry_limit=2,
        eject_failures=2,
        eject_backoff_s=0.3,
    )
    f = LocalServingFleet(
        tmp_path_factory.mktemp("fleet"),
        MODEL,
        replicas=2,
        seq=SEQ,
        slots=SLOTS,
        seed=SEED,
        router=router,
        env=REPLICA_ENV,
        device="cpu",
    )
    f.start()
    try:
        assert f.wait_ready(timeout_s=120), "fleet never reached ready"
        yield f
    finally:
        f.stop()


def _engine_tokens(prompts, max_new):
    """The same prompts through an in-process port engine built as a
    replica builds its own (same seed, same shapes), one thread as the
    replicas run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = TransformerConfig(max_seq=SEQ, **MODEL)
    params = init_params(cfg, torch.Generator(device="cpu").manual_seed(SEED))
    engine = ServingEngine(params, cfg, slots=SLOTS, max_len=SEQ, seed=SEED, warmup=False,
                           device="cpu").start()
    try:
        return [engine.submit(p, max_new).wait(timeout=60) for p in prompts]
    finally:
        engine.stop()
        torch.set_num_threads(threads)


PROBE_PROMPTS = [[1, 2, 3, 4], [5, 3, 2, 6, 7, 9], [11, 12], [63, 0, 62, 1, 61]]


class TestFleetServing:
    def test_boot_is_clean_and_generates(self, fleet):
        st = fleet.router.stats()
        assert st["n_ready"] == 2
        # Booting replicas stay warming — no spurious ejections.
        assert st["counters"]["ejections"] == 0
        out = fleet.router.generate([[1, 2, 3, 4]], max_new_tokens=8)
        assert len(out["tokens"][0]) == 8
        assert out["replica"] in st["replicas"]
        assert out["ttft_s"][0] is not None

    def test_traced_generate_yields_merged_waterfall(self, fleet):
        """One traced /generate across processes: the answer carries the
        replica's waterfall, and the router's merged export puts router and
        replica spans on distinct labeled tracks under one trace id."""
        out = fleet.router.generate([[5, 3, 2, 6]], max_new_tokens=24)
        (wf,) = out["trace"]["waterfalls"]
        assert wf["outcome"] == "completed"
        assert all(v >= 0 for v in wf["waterfall"].values())
        tid = out["trace"]["trace_id"]
        assert len(tid) == 32
        merged = fleet.router.merged_trace(tid)
        assert merged is not None
        assert {s["trace_id"] for s in merged["spans"]} == {tid}
        names = {s["name"] for s in merged["spans"]}
        assert {
            "router.request",
            "router.attempt",
            "serving.generate",
            "serving.request",
            "serving.queue_wait",
        } <= names
        tracks = {
            e["args"]["name"]
            for e in merged["chrome_trace"]["traceEvents"]
            if e["ph"] == "M" and e["name"] == "process_name"
        }
        assert "router" in tracks
        assert out["replica"] in tracks  # replica spans on their own row

    def test_shared_prefix_traffic_is_sticky(self, fleet):
        # The shared prefix must cover the router's affinity window —
        # shorter prefixes hash the private suffix too and spread.
        prompts = shared_prefix_prompts(
            6, MODEL["vocab_size"],
            prefix_len=fleet.router.affinity_tokens, suffix_len=4,
            groups=1, seed=3,
        )
        replicas = {
            fleet.router.generate([p], max_new_tokens=2)["replica"]
            for p in prompts
        }
        assert len(replicas) == 1  # one family → one PrefixCache

    def test_http_poisson_load_no_faults_loses_nothing(self, fleet):
        prompts = shared_prefix_prompts(
            10, MODEL["vocab_size"], prefix_len=6, suffix_len=4,
            groups=2, seed=7,
        )
        res = http_poisson_load(
            fleet.router.replica(fleet.router.replica_names()[0]).base_url,
            prompts,
            4,
            rate_rps=20.0,
            seed=7,
            timeout_s=120.0,
        )
        assert res["hangs"] == 0
        assert res["completed"] + res["sheds"] == res["n_requests"]
        assert res["failures"] == 0 and res["errors"] == 0
        assert res["tokens_per_s"] > 0

    def test_tokens_through_the_router_equal_an_in_process_engine(self, fleet):
        want = _engine_tokens(PROBE_PROMPTS, 12)
        got = [fleet.router.generate([p], max_new_tokens=12)["tokens"][0]
               for p in PROBE_PROMPTS]
        assert got == want
        # And from every replica directly: the same seed makes the same weights.
        for name in fleet.router.replica_names():
            rep = fleet.router.replica(name)
            direct = [_direct(rep.base_url, p, 12) for p in PROBE_PROMPTS]
            assert direct == want, name

    def test_a_jax_router_in_front_of_port_replicas_answers_alike(self, fleet):
        jrouter = JaxFleetRouter(probe_interval_s=3600, probe_timeout_s=2.0,
                                 request_timeout_s=60.0, affinity_tokens=4)
        for name in fleet.router.replica_names():
            jrouter.add_replica(name, fleet.router.replica(name).base_url)
        jrouter.probe_all()
        assert jrouter.stats()["n_ready"] == 2
        fleet.router.probe_all()
        assert {n: r["slots"] for n, r in jrouter.stats()["replicas"].items()} == {
            n: r["slots"] for n, r in fleet.router.stats()["replicas"].items()}
        for p in PROBE_PROMPTS:
            mine = fleet.router.generate([p], max_new_tokens=6)
            theirs = jrouter.generate([p], max_new_tokens=6)
            assert theirs["tokens"] == mine["tokens"]
            assert set(theirs) == set(mine)
            assert len(theirs["trace"]["trace_id"]) == len(mine["trace"]["trace_id"]) == 32
        with pytest.raises(JaxRouterError) as e:
            jrouter.generate([[99, 1]], max_new_tokens=2)  # out of vocabulary
        assert (e.value.kind, e.value.status) == ("bad_request", 400)
        with pytest.raises(RouterError) as e:
            fleet.router.generate([[99, 1]], max_new_tokens=2)
        assert (e.value.kind, e.value.status) == ("bad_request", 400)

    # -- resize under load (fleet ends where it started: 2 ready) -------------
    def test_scale_up_under_load_loses_nothing(self, fleet):
        router = fleet.router
        stop = threading.Event()
        outcomes = []
        threads = [
            threading.Thread(
                target=_sustained_load,
                args=(router, stop, outcomes),
                daemon=True,
            )
            for _ in range(2)
        ]
        for th in threads:
            th.start()
        try:
            name = fleet.scale_up()
            assert fleet.wait_ready(n=3, timeout_s=120), "3rd replica not ready"
        finally:
            stop.set()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive(), "load thread hung across scale-up"
        assert outcomes, "no load was offered during the resize"
        # Every request completed or was a typed load signal — adding a
        # replica must never fault traffic in flight.
        bad = [o for o in outcomes if o[0] == "err" and o[1] not in
               ("overloaded", "shed")]
        assert bad == []
        assert router.replica(name).state == "ready"
        assert router.stats()["n_ready"] == 3

    def test_drain_idlest_under_load_loses_nothing(self, fleet):
        router = fleet.router
        assert router.stats()["n_ready"] == 3
        stop = threading.Event()
        outcomes = []
        threads = [
            threading.Thread(
                target=_sustained_load,
                args=(router, stop, outcomes),
                daemon=True,
            )
            for _ in range(2)
        ]
        for th in threads:
            th.start()
        try:
            ready = [
                n for n in router.replica_names()
                if router.replica(n).state == "ready"
            ]
            victim = min(ready, key=lambda n: (router.replica(n).load(), n))
            assert router.drain(victim, deadline_s=30.0)
            deadline = time.time() + 60
            while time.time() < deadline and not router.is_drained(victim):
                time.sleep(0.2)
            assert router.is_drained(victim), "drain never completed"
            fleet.retire_replica(victim)
            time.sleep(0.5)  # keep load flowing on the shrunk fleet
        finally:
            stop.set()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive(), "load thread hung across drain-down"
        assert outcomes
        bad = [o for o in outcomes if o[0] == "err" and o[1] not in
               ("overloaded", "shed")]
        assert bad == []
        assert victim not in router.replica_names()
        assert router.stats()["n_ready"] == 2

    # -- destructive from here on ---------------------------------------------
    def test_stalled_replica_is_ejected_then_readmitted(self, fleet):
        router = fleet.router
        name = sorted(n for n in fleet._procs if router.replica(n).state == "ready")[0]
        rep = router.replica(name)
        # A prompt the router sends to the replica about to stall.
        prompt = next([i, i + 1, i + 2, i + 3] for i in range(64)
                      if router._affine([i, i + 1, i + 2, i + 3],
                                        [router.replica(n) for n in router.replica_names()]) is rep)
        outcome = {}

        def go():
            try:
                outcome["ok"] = router.generate([prompt], max_new_tokens=40)
            except RouterError as e:
                outcome["err"] = e

        th = threading.Thread(target=go)
        th.start()
        deadline = time.time() + 30
        while rep.inflight == 0 and time.time() < deadline:
            time.sleep(0.005)
        fleet.stall_replica(name)
        try:
            deadline = time.time() + 30
            while rep.state != "ejected" and time.time() < deadline:
                time.sleep(0.1)
            assert rep.state == "ejected", router.stats()
        finally:
            fleet.resume_replica(name)
        deadline = time.time() + 30
        while rep.state != "ready" and time.time() < deadline:
            time.sleep(0.1)
        assert rep.state == "ready" and router.counters["readmissions"] >= 1
        th.join(timeout=60)
        assert not th.is_alive(), "request hung across SIGSTOP/SIGCONT"
        assert ("ok" in outcome) ^ ("err" in outcome)
        if "ok" in outcome:
            assert len(outcome["ok"]["tokens"][0]) == 40

    def test_kill_mid_stream_gives_one_typed_error_or_failover(self, fleet):
        router = fleet.router
        victim = next(
            n for n in fleet._procs if router.replica(n).state == "ready"
        )
        outcome = {}

        def go():
            try:
                outcome["ok"] = router.generate(
                    [[9, 9, 9, 9]], max_new_tokens=48
                )
            except RouterError as e:
                outcome["err"] = e

        th = threading.Thread(target=go)
        th.start()
        time.sleep(0.3)
        fleet.kill_replica(victim)
        th.join(timeout=60)
        assert not th.is_alive(), "request hung after replica SIGKILL"
        # Completed via failover or exactly one typed error — never silent.
        assert ("ok" in outcome) ^ ("err" in outcome)
        if "err" in outcome:
            assert outcome["err"].kind in ("upstream_error", "no_replicas")
        else:
            # The whole ride — including any failover — was ONE trace:
            # one router.attempt span per upstream try, and the merge
            # still works with the killed replica unreachable.
            out = outcome["ok"]
            tid = out["trace"]["trace_id"]
            attempts = [
                s
                for s in get_tracer().spans()
                if s.get("trace_id") == tid and s["name"] == "router.attempt"
            ]
            assert len(attempts) == out["retries"] + 1
            merged = fleet.router.merged_trace(tid)
            assert merged is not None
            if out["retries"]:
                assert "serving.request" in {
                    s["name"] for s in merged["spans"]
                }

    def test_dead_replica_ejects_and_traffic_continues(self, fleet):
        router = fleet.router
        deadline = time.time() + 30
        while time.time() < deadline:
            router.probe_all()
            states = {
                n: router.replica(n).state for n in router.replica_names()
            }
            if "ejected" in states.values() and "ready" in states.values():
                break
            time.sleep(0.2)
        else:
            pytest.fail(f"dead replica never ejected: {router.stats()}")
        out = router.generate([[2, 3, 4]], max_new_tokens=4)
        assert len(out["tokens"][0]) == 4

    def test_replace_restores_capacity(self, fleet):
        router = fleet.router
        dead = next(
            n for n in router.replica_names()
            if router.replica(n).state != "ready"
        )
        fleet.replace_replica(dead)
        assert fleet.wait_ready(n=2, timeout_s=120)
        assert router.stats()["n_ready"] == 2

    def test_poll_reaps_a_killed_replica_and_times_the_autoscaler_tick(self, fleet):
        router = fleet.router
        scaler = fleet.attach_autoscaler(enabled=False)
        try:
            victim = sorted(fleet._procs)[0]
            fleet.kill_replica(victim)
            deadline = time.time() + 30
            while victim in fleet._procs and time.time() < deadline:
                fleet.poll()
                time.sleep(0.05)
            assert victim not in fleet._procs and victim not in router.replica_names()
            hist = router.metrics.snapshot()["histograms"]
            assert hist[labeled_key("tick_phase_s", phase="autoscaler")]["count"] >= 1
            assert scaler.status()["state"] == "idle"
            out = router.generate([[2, 3, 4]], max_new_tokens=4)
            assert out["replica"] != victim
        finally:
            fleet.autoscaler = None


def _direct(base_url, prompt, max_new):
    import json
    import urllib.request

    req = urllib.request.Request(
        base_url + "/generate",
        data=json.dumps({"prompts": [prompt], "max_new_tokens": max_new}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)["tokens"][0]


_SNAPSHOT_WRITER = """
import sys, torch
from polyaxon_tpu_torch.serving import kvstore
root = sys.argv[1]
payload = {"k": torch.zeros(4, 16, 2, 8), "v": torch.ones(4, 16, 2, 8)}
entries = [((i, i + 1, i + 2), payload) for i in range(64)]
print("writing", flush=True)
while True:
    kvstore.save_prefix_store(root, entries, {"sig": "s"})
"""


def test_a_snapshot_torn_by_sigkill_is_read_or_skipped(tmp_path):
    """Replicas of a fleet share one prefix store and a replica can die in
    the middle of a snapshot: whatever a SIGKILL leaves, the next reader
    gets a whole snapshot or none, and the next writer claims past it."""
    root = tmp_path / "kv"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for delay in (0.05, 0.3, 0.9):
        proc = subprocess.Popen([sys.executable, "-c", _SNAPSHOT_WRITER, str(root)], env=env,
                                stdout=subprocess.PIPE, text=True)
        try:
            assert proc.stdout.readline().strip() == "writing"
            time.sleep(delay)
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
        loaded = kvstore.load_prefix_store(root, expect={"sig": "s"})
        assert loaded is None or (len(loaded) == 64 and all(
            torch.equal(d["v"], torch.ones(4, 16, 2, 8)) for _, d in loaded))
    entries = [((7, 8), {"k": torch.full((4, 16, 2, 8), 3.0)})]
    version = kvstore.save_prefix_store(root, entries, {"sig": "s"})
    assert version is not None and version == kvstore.latest_complete_version(root)
    (chain, data), = kvstore.load_prefix_store(root, expect={"sig": "s"})
    assert chain == (7, 8) and torch.equal(data["k"], entries[0][1]["k"])
