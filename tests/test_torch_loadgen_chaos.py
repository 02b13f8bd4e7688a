"""The port's chaos layer: the reference's cases, and the same chaos run
through both packages.

Every case of ``tests/test_serving/test_loadgen_chaos.py`` runs here on the
port's ``serving/loadgen.py`` (seeded determinism, phase accounting, event
dispatch, the zero-silent-drops contract) against an in-process stub
server, no replica processes.  The parity cases drive the JAX and the port
``chaos_poisson_load`` with the same seed, phases and events against one
stub whose answer depends on the prompt (so outcomes do not depend on
thread timing): the accounting, ``by_phase``, the outcome of each arrival
and the fleet calls must be equal; and ``http_poisson_load``'s fault
schedule fires the same kills and stalls.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from polyaxon_tpu.serving import loadgen as jlg
from polyaxon_tpu_torch.serving import loadgen as tlg
from polyaxon_tpu_torch.serving.loadgen import (
    ChaosEvent,
    chaos_poisson_load,
    chaos_schedule,
)


class StubServer:
    """Minimal /generate endpoint; scriptable status code."""

    def __init__(self):
        self.code = 200
        self.hits = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                outer.hits += 1
                n = int(self.headers.get("Content-Length", 0))
                self.rfile.read(n)
                if outer.code == 200:
                    body = json.dumps(
                        {"tokens": [[1, 2, 3]], "ttft_s": [0.01]}
                    ).encode()
                else:
                    body = json.dumps(
                        {"error": {"kind": "overloaded", "message": "shed"}}
                    ).encode()
                self.send_response(outer.code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture()
def stub():
    s = StubServer()
    yield s
    s.close()


class FakeChaosFleet:
    def __init__(self):
        self.calls = []

    def chaos_target(self):
        return "r0"

    def kill_replica(self, name):
        self.calls.append(("kill", name))

    def stall_replica(self, name):
        self.calls.append(("stall", name))

    def resume_replica(self, name):
        self.calls.append(("resume", name))


class TestChaosSchedule:
    def test_same_seed_same_timeline(self):
        args = dict(seed=11, events=[ChaosEvent(1.2, "burst", n=3)])
        a = chaos_schedule([(1.0, 8.0), (1.0, 0.0)], **args)
        b = chaos_schedule([(1.0, 8.0), (1.0, 0.0)], **args)
        assert a == b and len(a) > 3

    def test_rate_zero_phase_has_no_arrivals(self):
        sched = chaos_schedule([(1.0, 10.0), (2.0, 0.0)], seed=5)
        assert sched
        assert all(idx == 0 for _, idx in sched)
        assert all(t < 1.0 for t, _ in sched)

    def test_burst_lands_in_containing_phase(self):
        sched = chaos_schedule(
            [(1.0, 0.0), (1.0, 0.0)],
            seed=0,
            events=[ChaosEvent(1.5, "burst", n=4)],
        )
        assert sched == [(1.5, 1)] * 4

    def test_schedules_are_time_sorted(self):
        sched = chaos_schedule(
            [(0.5, 20.0), (0.5, 20.0)],
            seed=2,
            events=[ChaosEvent(0.1, "burst", n=2)],
        )
        assert sched == sorted(sched)

    def test_bad_phase_duration_raises(self):
        with pytest.raises(ValueError):
            chaos_schedule([(0.0, 5.0)])


class TestChaosEvent:
    def test_unknown_action_rejected(self):
        with pytest.raises(ValueError):
            ChaosEvent(1.0, "explode")

    def test_resume_requires_target(self):
        with pytest.raises(ValueError):
            ChaosEvent(1.0, "resume")

    def test_burst_requires_n(self):
        with pytest.raises(ValueError):
            ChaosEvent(1.0, "burst")


class TestChaosPoissonLoad:
    def test_accounting_and_by_phase(self, stub):
        res = chaos_poisson_load(
            stub.url,
            [[1, 2, 3], [4, 5, 6]],
            4,
            phases=[(0.6, 15.0), (0.3, 0.0)],
            seed=9,
            timeout_s=30.0,
        )
        n = res["n_requests"]
        assert n > 0
        assert (
            res["completed"] + res["sheds"] + res["errors"]
            + res["failures"] + res["hangs"] == n
        )
        assert res["hangs"] == 0
        assert res["completed"] == n
        assert len(res["by_phase"]) == 2
        assert res["by_phase"][0]["n"] == n  # idle phase offered nothing
        assert res["by_phase"][1]["n"] == 0
        assert sum(p["completed"] for p in res["by_phase"]) == n

    def test_sheds_counted_apart_from_errors(self, stub):
        stub.code = 429
        res = chaos_poisson_load(
            stub.url,
            [[1, 2]],
            4,
            phases=[(0.4, 15.0)],
            seed=3,
            timeout_s=30.0,
        )
        assert res["sheds"] == res["n_requests"]
        assert res["errors"] == 0 and res["failures"] == 0

    def test_events_fire_and_pump_ticks(self, stub):
        fleet = FakeChaosFleet()
        pumps = []
        res = chaos_poisson_load(
            stub.url,
            [[7, 7]],
            4,
            phases=[(0.5, 6.0)],
            seed=1,
            events=[
                ChaosEvent(0.1, "stall", target="rX"),
                ChaosEvent(0.2, "resume", target="rX"),
                ChaosEvent(0.3, "kill"),  # untargeted → fleet.chaos_target()
            ],
            fleet=fleet,
            pump=lambda: pumps.append(1),
            pump_interval_s=0.02,
            timeout_s=30.0,
        )
        assert fleet.calls == [
            ("stall", "rX"), ("resume", "rX"), ("kill", "r0")
        ]
        assert len(pumps) >= 5  # the pump ticked throughout the run
        assert res["hangs"] == 0

    def test_burst_injects_extra_arrivals(self, stub):
        base = chaos_poisson_load(
            stub.url, [[1]], 2, phases=[(0.3, 5.0)], seed=4, timeout_s=30.0
        )
        burst = chaos_poisson_load(
            stub.url, [[1]], 2, phases=[(0.3, 5.0)], seed=4,
            events=[ChaosEvent(0.1, "burst", n=5)], timeout_s=30.0,
        )
        assert burst["n_requests"] == base["n_requests"] + 5



# -- parity with the JAX package's chaos load ---------------------------------


class PromptStub:
    """/generate whose answer is a function of the prompt: first id % 3 == 0
    sheds (429), == 1 is a typed 503, else 200 with tokens."""

    def __init__(self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                first = json.loads(self.rfile.read(n))["prompts"][0][0]
                code, body = {
                    0: (429, {"error": {"kind": "overloaded", "message": "shed"}}),
                    1: (503, {"error": {"kind": "draining", "message": "draining"}}),
                }.get(first % 3, (200, {"tokens": [[1, 2, 3]], "ttft_s": [0.01]}))
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture()
def prompt_stub():
    s = PromptStub()
    yield s
    s.close()


_KEYS = ("n_requests", "completed", "sheds", "errors", "failures", "hangs", "total_tokens",
         "by_phase", "outcomes")


def _chaos(lg, url, seed):
    fleet = FakeChaosFleet()
    res = lg.chaos_poisson_load(
        url,
        [[i, i + 1] for i in range(7)],
        3,
        phases=[(0.3, 20.0), (0.2, 0.0), (0.3, 12.0)],
        seed=seed,
        events=[lg.ChaosEvent(0.05, "stall", target="rA"), lg.ChaosEvent(0.1, "burst", n=4),
                lg.ChaosEvent(0.25, "resume", target="rA"), lg.ChaosEvent(0.6, "kill")],
        fleet=fleet,
        pump_interval_s=0.02,
        timeout_s=30.0,
    )
    return {k: res[k] for k in _KEYS}, fleet.calls


@pytest.mark.parametrize("seed", [0, 5, 23])
def test_chaos_poisson_load_accounts_like_the_jax_one(prompt_stub, seed):
    mine, my_calls = _chaos(tlg, prompt_stub.url, seed)
    theirs, their_calls = _chaos(jlg, prompt_stub.url, seed)
    assert mine == theirs
    assert my_calls == their_calls == [("stall", "rA"), ("resume", "rA"), ("kill", "r0")]
    assert mine["completed"] and mine["sheds"] and mine["errors"]
    assert sum(p["n"] for p in mine["by_phase"]) == mine["n_requests"]


def test_a_victim_already_gone_is_skipped_like_the_jax_one(stub):
    class GoneFleet(FakeChaosFleet):
        def kill_replica(self, name):
            raise KeyError(name)

    for lg in (tlg, jlg):
        res = lg.chaos_poisson_load(
            stub.url, [[1]], 2, phases=[(0.3, 5.0)], seed=4,
            events=[lg.ChaosEvent(0.1, "kill", target="r9")], fleet=GoneFleet(),
            timeout_s=30.0,
        )
        assert res["hangs"] == 0 and res["completed"] == res["n_requests"]


def test_http_fault_schedule_fires_like_the_jax_schedule(stub):
    def run(lg):
        fleet = FakeChaosFleet()
        res = lg.http_poisson_load(
            stub.url, [[1, 2]] * 6, 2, rate_rps=30.0, seed=2, timeout_s=30.0,
            kill_at_s={"r1": 0.05}, stall_at_s={"r0": 0.02}, fleet=fleet,
        )
        return {k: res[k] for k in ("n_requests", "completed", "hangs", "outcomes")}, fleet.calls

    mine, my_calls = run(tlg)
    theirs, their_calls = run(jlg)
    assert mine == theirs
    assert my_calls == their_calls == [("stall", "r0"), ("kill", "r1")]
    # A schedule that outlives the load is cancelled, never fired late.
    fleet = FakeChaosFleet()
    tlg.http_poisson_load(stub.url, [[1]], 2, rate_rps=50.0, seed=1, timeout_s=30.0,
                          kill_at_s={"r0": 30.0}, fleet=fleet)
    assert fleet.calls == []
