"""The port's FleetRouter against scriptable fake replicas, and against the
JAX package's router.

Every case of ``tests/test_serving/test_router.py`` runs here on the port's
router (``polyaxon_tpu_torch.serving.router``) against the same tiny stub
HTTP servers, whose ``/healthz`` / ``/v1/stats`` / ``/generate`` answers
each test scripts.  Then the parity cases: one script of fake-replica
events driven through both routers gives the same replica choices, states,
counters, typed error kinds, HTTP codes and ``Retry-After``; and for 500
seeded prompts over 2-5 replica names both routers' rendezvous affinity
picks the same replica.  No torch model runs here: the router is control
plane.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from polyaxon_tpu.serving import router as jax_router
from polyaxon_tpu_torch.serving import router as port_router
from polyaxon_tpu_torch.serving.router import (
    FleetRouter,
    RouterError,
    make_router_handler,
)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class FakeReplica:
    """A scriptable lm_server stand-in: mutate ``.state`` / ``.stats`` /
    ``.generate_response`` between calls to script scenarios."""

    def __init__(self):
        self.state = "ready"
        self.stats = {"slots": 4, "slots_active": 0, "queue_depth": 0}
        #: (status_code, payload) for POST /generate; or "close" to
        #: drop the connection mid-request (a dying replica).
        self.generate_response = (200, {"tokens": [[1, 2]], "ttft_s": [0.01]})
        self.requests = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _json(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/v1/stats":
                    return self._json(200, dict(outer.stats))
                return self._json(200, {"ok": True, "state": outer.state})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                outer.requests.append(json.loads(self.rfile.read(n)))
                resp = outer.generate_response
                if resp == "close":
                    self.connection.close()
                    return
                return self._json(*resp)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture()
def router():
    r = FleetRouter(
        probe_interval_s=0.05,
        probe_timeout_s=0.5,
        request_timeout_s=5.0,
        shed_occupancy=0.9,
        retry_after_s=2.0,
        retry_limit=1,
        eject_failures=2,
        eject_backoff_s=0.2,
        eject_backoff_max_s=5.0,
        affinity_tokens=4,
    )
    yield r
    r.stop()


@pytest.fixture()
def fakes():
    reps = [FakeReplica(), FakeReplica()]
    yield reps
    for rep in reps:
        rep.close()


class TestSelection:
    def test_all_warming_is_503_warming_not_429(self, router, fakes):
        for f in fakes:
            f.state = "warming"
        router.add_replica("a", fakes[0].url)
        router.add_replica("b", fakes[1].url)
        router.probe_all()
        with pytest.raises(RouterError) as e:
            router.select([1, 2, 3])
        assert e.value.kind == "warming"
        assert e.value.status == 503
        assert router.counters["sheds"] == 0

    def test_no_replicas_is_typed_503(self, router):
        with pytest.raises(RouterError) as e:
            router.select([1])
        assert e.value.kind == "no_replicas" and e.value.status == 503

    def test_overload_sheds_429_with_retry_after(self, router, fakes):
        for f in fakes:
            f.stats = {"slots": 4, "slots_active": 4, "queue_depth": 2}
        router.add_replica("a", fakes[0].url)
        router.add_replica("b", fakes[1].url)
        router.probe_all()
        with pytest.raises(RouterError) as e:
            router.select([1, 2, 3])
        assert e.value.kind == "overloaded"
        assert e.value.status == 429
        assert e.value.retry_after_s == 2.0
        assert router.counters["sheds"] == 1

    def test_least_loaded_wins_without_affinity(self, router, fakes):
        fakes[0].stats = {"slots": 4, "slots_active": 3, "queue_depth": 0}
        fakes[1].stats = {"slots": 4, "slots_active": 0, "queue_depth": 0}
        router.affinity_tokens = 0  # pure load balancing
        router.add_replica("busy", fakes[0].url)
        router.add_replica("idle", fakes[1].url)
        router.probe_all()
        assert router.select([1, 2]).name == "idle"

    def test_prefix_affinity_sticky_and_falls_back_when_ejected(
        self, router, fakes
    ):
        router.add_replica("a", fakes[0].url)
        router.add_replica("b", fakes[1].url)
        router.probe_all()
        prompt = [7, 8, 9, 10, 11]
        first = router.select(list(prompt))
        # Same prefix → same replica, independent of the private suffix.
        again = router.select(prompt[:4] + [99, 100])
        assert again.name == first.name
        for rep in (first, again):
            rep.inflight = 0
        # Eject the affine replica: traffic must fall back, not 503.
        router.note_request_failure(first, "boom")
        router.note_request_failure(first, "boom")
        assert first.state == "ejected"
        fallback = router.select(list(prompt))
        assert fallback.name != first.name


class TestPrefixHitAwareAffinity:
    """The two regimes of warm-but-busy affinity: a COLD affine replica
    yields to least-loaded at the base slack; a WARM one (high probed
    prefix_hit_rate) earns extra slack and keeps its traffic."""

    def _setup(self, router, fakes, prompt):
        router.affinity_slack = 0.25
        router.affinity_hit_slack = 0.75
        router.add_replica("a", fakes[0].url)
        router.add_replica("b", fakes[1].url)
        router.probe_all()
        with router._lock:
            ready = list(router._replicas.values())
        affine = router._affine(prompt, ready)
        other = next(r for r in ready if r.name != affine.name)
        # Affine replica busy at 0.75 load; the other idle.
        affine.slots, affine.slots_active = 4, 3
        other.slots, other.slots_active = 4, 0
        return affine, other

    def test_cold_busy_affine_yields_to_least_loaded(self, router, fakes):
        prompt = [7, 8, 9, 10, 11]
        affine, other = self._setup(router, fakes, prompt)
        affine.prefix_hit_rate = 0.0  # cold cache: nothing to protect
        # excess 0.75 > slack 0.25 + 0.0×0.75 → fall back.
        assert router.select(list(prompt)).name == other.name

    def test_warm_busy_affine_keeps_traffic(self, router, fakes):
        prompt = [7, 8, 9, 10, 11]
        affine, other = self._setup(router, fakes, prompt)
        affine.prefix_hit_rate = 0.9  # warm cache
        # excess 0.75 <= slack 0.25 + 0.9×0.75 = 0.925 → stay affine.
        assert router.select(list(prompt)).name == affine.name

    def test_saturated_affine_always_yields(self, router, fakes):
        prompt = [7, 8, 9, 10, 11]
        affine, other = self._setup(router, fakes, prompt)
        affine.prefix_hit_rate = 1.0
        affine.slots_active = 4  # load 1.0: no slack saves a full replica
        assert router.select(list(prompt)).name == other.name


class TestAllReplicasDown:
    """Every replica ejected/dead/drained ⇒ ONE typed 503 no_replicas,
    distinct from the retry-exhausted 502 upstream_error."""

    def test_all_ejected_is_typed_no_replicas(self, router, fakes):
        router.add_replica("a", fakes[0].url)
        router.add_replica("b", fakes[1].url)
        router.probe_all()
        for name in ("a", "b"):
            rep = router.replica(name)
            router.note_request_failure(rep, "boom")
            router.note_request_failure(rep, "boom")
            assert rep.state == "ejected"
        with pytest.raises(RouterError) as e:
            router.select([1, 2])
        assert e.value.kind == "no_replicas"
        assert e.value.status == 503

    def test_mixed_dead_and_drained_is_no_replicas(self, router, fakes):
        router.add_replica("a", fakes[0].url)
        router.add_replica("b", fakes[1].url)
        router.probe_all()
        router.replica("a").state = "dead"
        router.replica("b").state = "drained"
        with pytest.raises(RouterError) as e:
            router.select([1, 2])
        assert e.value.kind == "no_replicas" and e.value.status == 503

    def test_draining_replica_keeps_it_unavailable_not_no_replicas(
        self, router, fakes
    ):
        router.add_replica("a", fakes[0].url)
        router.add_replica("b", fakes[1].url)
        router.probe_all()
        router.replica("a").state = "ejected"
        router.replica("b").state = "draining"
        # In-flight work is still finishing somewhere: the fleet is not
        # EMPTY, it is momentarily unavailable.
        with pytest.raises(RouterError) as e:
            router.select([1, 2])
        assert e.value.kind == "unavailable" and e.value.status == 503

    def test_generate_surfaces_no_replicas_without_attempts(
        self, router, fakes
    ):
        router.add_replica("a", fakes[0].url)
        router.probe_all()
        rep = router.replica("a")
        router.note_request_failure(rep, "boom")
        router.note_request_failure(rep, "boom")
        with pytest.raises(RouterError) as e:
            router.generate([[1, 2]], max_new_tokens=2)
        # Nothing was attemptable — NOT the 502 that means "attempted
        # and failed" (test_exhausted_failover_is_one_typed_error).
        assert e.value.kind == "no_replicas"
        assert e.value.status == 503


class TestEjection:
    def test_ejects_after_consecutive_failures_and_readmits(self, router, fakes):
        router.add_replica("a", fakes[0].url)
        router.probe_all()
        rep = router.replica("a")
        assert rep.state == "ready"
        router.note_request_failure(rep, "conn reset")
        assert rep.state == "ready"  # one strike is not an ejection
        router.note_request_failure(rep, "conn reset")
        assert rep.state == "ejected"
        assert router.counters["ejections"] == 1
        # Inside the backoff window probe_all skips it entirely.
        router.probe_all(now=rep.ejected_until - 0.05)
        assert rep.state == "ejected"
        # After the window a healthy probe re-admits and resets streaks.
        router.probe_all(now=rep.ejected_until + 0.01)
        assert rep.state == "ready"
        assert rep.eject_streak == 0
        assert router.counters["readmissions"] == 1

    def test_failed_readmission_backoff_grows_exponentially(self, router, fakes):
        router.add_replica("a", fakes[0].url)
        router.probe_all()
        rep = router.replica("a")
        fakes[0].close()  # replica is now genuinely dead
        router.note_request_failure(rep, "dead")
        router.note_request_failure(rep, "dead")
        assert rep.state == "ejected"
        windows = []
        now = rep.ejected_until
        for _ in range(3):
            now += 0.01
            router.probe_all(now=now)  # re-admission probe fails
            assert rep.state == "ejected"
            windows.append(rep.ejected_until - now)
            now = rep.ejected_until
        assert windows[1] > windows[0] and windows[2] > windows[1]
        assert windows[2] <= router.eject_backoff_max_s

    def test_warming_replica_is_not_ejected_by_boot_failures(self, router):
        # A replica whose socket nobody listens on yet stays WARMING —
        # clients see 503 "warming", and no ejection counters fire.
        router.add_replica("booting", f"http://127.0.0.1:{_free_port()}")
        for _ in range(4):
            router.probe_all()
        rep = router.replica("booting")
        assert rep.state == "warming"
        assert router.counters["ejections"] == 0


class TestDrain:
    def test_drain_stops_routing_and_completes_when_idle(self, router, fakes):
        drained = []
        router.on_drained = lambda name, timed_out: drained.append(
            (name, timed_out)
        )
        router.add_replica("a", fakes[0].url)
        router.add_replica("b", fakes[1].url)
        router.probe_all()
        assert router.drain("a", deadline_s=30.0)
        assert router.replica("a").state == "draining"
        # Draining replicas take no new traffic.
        for _ in range(4):
            rep = router.select([1, 2, 3, 4])
            assert rep.name == "b"
            rep.inflight = 0
        # Idle + a probe newer than the drain start → drained.
        router.probe_all()
        assert router.is_drained("a")
        assert drained == [("a", False)]

    def test_drain_deadline_expiry_forces_drained(self, router, fakes):
        drained = []
        router.on_drained = lambda name, timed_out: drained.append(
            (name, timed_out)
        )
        fakes[0].stats = {"slots": 4, "slots_active": 2, "queue_depth": 1}
        router.add_replica("a", fakes[0].url)
        router.probe_all()
        router.drain("a", deadline_s=0.2)
        router.probe_all()
        assert not router.is_drained("a")  # still busy, deadline not hit
        time.sleep(0.25)
        router.probe_all()
        assert router.is_drained("a")
        assert drained == [("a", True)]

    def test_drain_unknown_replica_returns_false(self, router):
        assert router.drain("ghost") is False


class TestGenerate:
    def test_proxies_and_reports_replica(self, router, fakes):
        router.add_replica("a", fakes[0].url)
        router.probe_all()
        out = router.generate([[1, 2, 3]], max_new_tokens=2)
        assert out["tokens"] == [[1, 2]]
        assert out["replica"] == "a"
        assert out["retries"] == 0
        assert fakes[0].requests[-1]["max_new_tokens"] == 2

    def test_failover_to_live_replica_on_connection_error(self, router, fakes):
        # "dead" is a port with no listener: instant connection refusal.
        router.affinity_tokens = 0  # pure least-loaded steering
        router.add_replica("dead", f"http://127.0.0.1:{_free_port()}")
        router.add_replica("live", fakes[0].url)
        router.probe_all()
        # Force the dead replica to look routable so generate targets it.
        rep = router.replica("dead")
        rep.state = "ready"
        rep.slots = 4
        router.replica("live").slots_active = 1  # dead sorts least-loaded
        out = router.generate([[5, 6]], max_new_tokens=2)
        assert out["replica"] == "live"
        assert out["retries"] == 1
        assert router.counters["retries"] == 1
        assert router.counters["failovers"] == 1

    def test_exhausted_failover_is_one_typed_error(self, router):
        router.retry_limit = 2
        for name in ("d1", "d2"):
            router.add_replica(name, f"http://127.0.0.1:{_free_port()}")
            rep = router.replica(name)
            rep.state = "ready"
            rep.slots = 4
        with pytest.raises(RouterError) as e:
            router.generate([[1]], max_new_tokens=2)
        assert e.value.kind == "upstream_error"
        assert e.value.status == 502

    def test_engine_shed_429_propagates_typed(self, router, fakes):
        fakes[0].generate_response = (
            429,
            {"error": {"kind": "shed", "message": "pool exhausted"}},
        )
        router.add_replica("a", fakes[0].url)
        router.probe_all()
        with pytest.raises(RouterError) as e:
            router.generate([[1, 2]], max_new_tokens=2)
        assert e.value.kind == "shed"
        assert e.value.status == 429
        assert e.value.retry_after_s is not None
        assert router.counters["sheds"] == 1

    def test_midstream_connection_drop_fails_over_then_types_out(
        self, router, fakes
    ):
        fakes[0].generate_response = "close"  # dies after accepting
        fakes[1].generate_response = "close"
        router.add_replica("a", fakes[0].url)
        router.add_replica("b", fakes[1].url)
        router.probe_all()
        with pytest.raises(RouterError) as e:
            router.generate([[1, 2]], max_new_tokens=2)
        assert e.value.kind == "upstream_error"
        assert e.value.status == 502
        # Exactly one typed error; both replicas were attempted.
        assert router.counters["retries"] == 2

    def test_inflight_always_released(self, router, fakes):
        fakes[0].generate_response = (
            400, {"error": {"kind": "bad_request", "message": "nope"}}
        )
        router.add_replica("a", fakes[0].url)
        router.probe_all()
        with pytest.raises(RouterError):
            router.generate([[1]], max_new_tokens=2)
        assert router.replica("a").inflight == 0


class TestMetrics:
    def test_state_gauge_and_counters_land_on_stats(self, router, fakes):
        router.add_replica("a", fakes[0].url)
        router.probe_all()
        snap = router.metrics.snapshot()
        key = 'fleet_replica_state{replica="a"}'
        assert snap["gauges"][key] == 1.0  # ready
        rep = router.replica("a")
        router.note_request_failure(rep, "x")
        router.note_request_failure(rep, "x")
        snap = router.metrics.snapshot()
        assert snap["gauges"][key] == 3.0  # ejected
        assert snap["counters"]["router_ejections_total"] == 1

    def test_stats_shed_rate(self, router, fakes):
        fakes[0].stats = {"slots": 2, "slots_active": 2, "queue_depth": 2}
        router.add_replica("a", fakes[0].url)
        router.probe_all()
        router.counters["requests"] = 4
        for _ in range(2):
            with pytest.raises(RouterError):
                router.select([1])
        assert router.stats()["shed_rate"] == 0.5


class TestRouterHTTP:
    @pytest.fixture()
    def front(self, router, fakes):
        router.add_replica("a", fakes[0].url)
        router.probe_all()
        handler = make_router_handler(router, {"fleet_name": "test"})
        server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        yield f"http://127.0.0.1:{server.server_address[1]}"
        server.shutdown()
        server.server_close()

    def _post(self, url, payload):
        req = urllib.request.Request(
            url + "/generate",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, json.load(r), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e), dict(e.headers)

    def test_generate_roundtrip(self, front):
        status, body, _ = self._post(
            front, {"prompts": [[1, 2, 3]], "max_new_tokens": 2}
        )
        assert status == 200
        assert body["tokens"] == [[1, 2]]
        assert body["replica"] == "a"

    def test_shed_has_retry_after_header_and_kind(self, front, router):
        router.shed_occupancy = 0.0  # everything sheds
        status, body, headers = self._post(front, {"prompts": [[1]]})
        assert status == 429
        assert body["error"]["kind"] == "overloaded"
        assert int(headers["Retry-After"]) >= 1

    def test_bad_request_is_typed_400(self, front):
        status, body, _ = self._post(front, {"prompts": "nope"})
        assert status == 400
        assert body["error"]["kind"] == "bad_request"

    def test_healthz_and_stats(self, front):
        with urllib.request.urlopen(front + "/healthz", timeout=10) as r:
            health = json.load(r)
        assert health["ok"] and health["state"] == "ready"
        assert health["fleet"] == {"ready": 1}
        with urllib.request.urlopen(front + "/v1/stats", timeout=10) as r:
            stats = json.load(r)
        assert stats["n_ready"] == 1
        assert "a" in stats["replicas"]

    def test_metrics_exposition(self, front, router):
        rep = router.replica("a")
        router.note_request_failure(rep, "x")
        router.note_request_failure(rep, "x")
        with urllib.request.urlopen(front + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "polyaxon_tpu_fleet_replica_state" in text
        assert "polyaxon_tpu_router_ejections_total" in text



# -- parity with the JAX package's router ---------------------------------------


def _router(mod, **overrides):
    kwargs = dict(
        probe_interval_s=3600.0,  # the script drives every probe itself
        probe_timeout_s=0.5,
        request_timeout_s=5.0,
        shed_occupancy=0.9,
        retry_after_s=2.0,
        retry_limit=1,
        eject_failures=2,
        eject_backoff_s=0.2,
        eject_backoff_max_s=5.0,
        affinity_tokens=4,
    )
    kwargs.update(overrides)
    return mod.FleetRouter(**kwargs)


def _front(mod, router):
    server = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_router_handler(router, {"fleet_name": "t"}))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, payload):
    req = urllib.request.Request(
        url + "/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.load(r), r.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, json.load(e), e.headers.get("Retry-After")


def _script(mod):
    """One run of fake-replica events through ``mod``'s router; returns
    everything observable: choices, states, counters, typed errors, HTTP
    codes and Retry-After, and the re-admission backoff windows."""
    fakes = [FakeReplica(), FakeReplica(), FakeReplica()]
    router = _router(mod)
    server, url = _front(mod, router)
    seen = []

    def record(tag, fn):
        try:
            value = fn()
        except mod.RouterError as e:
            value = ("RouterError", e.kind, e.status, e.retry_after_s)
        seen.append((tag, value))

    def states():
        return {n: router.replica(n).state for n in sorted(router.replica_names())}

    def select(prompt):
        rep = router.select(prompt)
        rep.inflight = 0
        return rep.name

    try:
        for f in fakes:
            f.state = "warming"
        for name, f in zip("abc", fakes):
            router.add_replica(name, f.url)
        router.probe_all()
        record("warming", lambda: select([1, 2, 3]))
        record("states0", states)
        for f in fakes:
            f.state = "ready"
        fakes[0].stats = {"slots": 4, "slots_active": 3, "queue_depth": 0, "prefix_cache_hit_rate": 0.9}
        fakes[1].stats = {"slots": 4, "slots_active": 1, "queue_depth": 0}
        fakes[2].stats = {"slots": 2, "slots_active": 0, "queue_depth": 1}
        router.probe_all()
        record("states1", states)
        for k in range(12):
            record(f"select{k}", lambda k=k: select([k, k + 1, k + 2, k + 3, 99]))
        router.affinity_tokens = 0
        record("least_loaded", lambda: select([5, 6]))
        router.affinity_tokens = 4
        record("generate", lambda: {k: v for k, v in router.generate([[1, 2, 3]], max_new_tokens=2).items()
                                    if k != "trace"})
        record("http_ok", lambda: _post(url, {"prompts": [[4, 5, 6]], "max_new_tokens": 2})[:2][0])
        fakes[1].generate_response = (429, {"error": {"kind": "shed", "message": "pool"}})
        fakes[0].generate_response = fakes[2].generate_response = fakes[1].generate_response
        record("engine_shed", lambda: router.generate([[7, 7, 7, 7]], max_new_tokens=2))
        status, body, retry_after = _post(url, {"prompts": [[7, 7, 7, 7]]})
        record("http_shed", lambda: (status, body["error"]["kind"], retry_after))
        for f in fakes:
            f.generate_response = "close"
        record("midstream", lambda: router.generate([[8, 8, 8, 8]], max_new_tokens=2))
        record("states2", states)
        router.shed_occupancy = 0.0
        status, body, retry_after = _post(url, {"prompts": [[1]]})
        record("http_overload", lambda: (status, body["error"]["kind"], retry_after))
        router.shed_occupancy = 0.9
        status, body, _ = _post(url, {"prompts": "nope"})
        record("http_bad", lambda: (status, body["error"]["kind"]))
        rep = router.replica("b")
        router.note_request_failure(rep, "x")
        router.note_request_failure(rep, "x")
        record("states3", states)
        fakes[1].close()
        now = rep.ejected_until
        windows = []
        for _ in range(3):
            now += 0.01
            router.probe_all(now=now)
            windows.append(round(rep.ejected_until - now, 6))
            now = rep.ejected_until
        record("backoff", lambda: windows)
        fakes[0].stats = {"slots": 4, "slots_active": 0, "queue_depth": 0}
        router.drain("a", deadline_s=30.0)
        record("drain_select", lambda: select([1, 2, 3, 4]))
        router.probe_all()
        record("drained", lambda: router.is_drained("a"))
        record("unknown_drain", lambda: router.drain("ghost"))
        router.replica("c").state = "dead"
        record("none_left", lambda: select([1]))
        snap = router.stats()
        record("stats", lambda: {k: snap[k] for k in ("by_state", "n_ready", "counters", "shed_rate")})
        record("metrics_keys", lambda: sorted(router.metrics.snapshot()["counters"]))
        record("gauges", lambda: router.metrics.snapshot()["gauges"])
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            health = json.load(r)
        record("healthz", lambda: health)
    finally:
        server.shutdown()
        server.server_close()
        for f in fakes:
            f.close()
    return seen


def test_a_scripted_fleet_routes_like_the_jax_router():
    port = _script(port_router)
    ref = _script(jax_router)
    assert [tag for tag, _ in port] == [tag for tag, _ in ref]
    for (tag, mine), (_, theirs) in zip(port, ref):
        assert mine == theirs, tag
    # The script reaches every typed refusal it means to.
    kinds = {v[1] for _, v in port if isinstance(v, tuple) and v and v[0] == "RouterError"}
    assert {"warming", "shed", "upstream_error", "no_replicas"} <= kinds


@pytest.mark.parametrize("n_replicas", [2, 3, 4, 5])
@pytest.mark.parametrize("affinity_tokens", [4, 16])
def test_rendezvous_affinity_picks_the_jax_routers_replica(n_replicas, affinity_tokens):
    rng = np.random.default_rng(n_replicas * 100 + affinity_tokens)
    names = [f"r{i}" for i in range(n_replicas)]
    port = port_router.FleetRouter(affinity_tokens=affinity_tokens)
    ref = jax_router.FleetRouter(affinity_tokens=affinity_tokens)
    port_ready = [port_router.Replica(n, f"http://127.0.0.1:{8000 + i}") for i, n in enumerate(names)]
    ref_ready = [jax_router.Replica(n, f"http://127.0.0.1:{8000 + i}") for i, n in enumerate(names)]
    picks = set()
    for _ in range(500):
        prompt = rng.integers(0, 32768, int(rng.integers(1, 40))).tolist()
        mine = port._affine(prompt, port_ready).name
        assert mine == ref._affine(prompt, ref_ready).name
        picks.add(mine)
    assert picks == set(names)  # every replica wins some prefixes
    assert port._affine([], port_ready) is None and ref._affine([], ref_ready) is None
