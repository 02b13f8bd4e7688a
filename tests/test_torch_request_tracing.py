"""Request tracing in the port's engine and HTTP handler, against the JAX
package's.

The same request mix goes through both engines (the reference tests' small
float32 model, the same weights): a finished request, one cancelled while
queued and one while decoding, one shed by a pool deadlock, one parked and
restored through the host tier, and requests still pending at ``stop()``.
Each request's outcome, the names of the spans recorded under its trace and
its waterfall's keys must equal the JAX engine's; every terminal path closes
the request's root span; and the waterfall sums to the request's server-side
``total_s`` (one clock, the same readings: the sum differs only by the
rounding to 6 places).  Then the production handler: ``traceparent`` in, the
same trace id and one waterfall per prompt out, ``/v1/trace/<id>`` from this
process's spans, a malformed header giving a fresh trace.  No test here
holds server phases to a client's wall time.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
import json
import socket
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.builtins.services import _make_lm_handler as jax_handler
from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.serving import ServingEngine as JaxEngine
from polyaxon_tpu.tracking import trace as jtrace
from polyaxon_tpu_torch.builtins.services import _make_lm_handler, lm_server
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.serving import ServingEngine
from polyaxon_tpu_torch.tracking import trace as ttrace
from polyaxon_tpu_torch.tracking.context import Context

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64, max_seq=48)
WATERFALL_KEYS = {"queue_wait_s", "prefill_s", "decode_s", "parked_s"}
SUMMARY_KEYS = {"trace_id", "span_id", "request_id", "outcome", "total_s", "ttft_s", "tokens",
                "finished_at", "waterfall"}


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **SMALL)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **SMALL)
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture
def hot_spans_off():
    """Hot spans (a decode step, a draft) are sampled at random: off in both
    tracers, so the span names of a request are deterministic."""
    saved = [(t, t.hot_sample) for t in (jtrace.get_tracer(), ttrace.get_tracer())]
    for t, _ in saved:
        t.configure(hot_sample=0.0)
    yield
    for t, rate in saved:
        t.configure(hot_sample=rate)


def _ctx(mod, i):
    return mod.TraceContext(f"{i:032x}", f"client.0.{i}")


def _record(mod, req):
    """What a request's trace shows: outcome, its spans' names, its
    waterfall's keys; and the checks every ended traced request meets."""
    s = req.trace_summary
    assert s is not None and set(s) == SUMMARY_KEYS
    spans = [sp for sp in mod.get_tracer().spans() if sp.get("trace_id") == s["trace_id"]]
    roots = [sp for sp in spans if sp["name"] == "serving.request"]
    assert len(roots) == 1 and roots[0]["span_id"] == s["span_id"]
    assert roots[0]["parent_id"] == req.trace.ctx.span_id
    assert roots[0]["attrs"]["outcome"] == s["outcome"]
    assert all(sp["parent_id"] == s["span_id"] for sp in spans if sp is not roots[0])
    assert abs(sum(s["waterfall"].values()) - s["total_s"]) <= 3e-6
    assert set(s["waterfall"]) <= WATERFALL_KEYS
    return s["outcome"], sorted({sp["name"] for sp in spans}), sorted(s["waterfall"])


def _mix(mod, engine_cls, params, cfg, **common):
    """The request mix on one package's engines; returns each request's
    record in a fixed order."""
    out = {}
    # finished, with a prefix hit, and cancelled while queued
    eng = engine_cls(params, cfg, slots=1, max_len=48, block_size=4, **common)
    pre = list(range(1, 9))
    reqs = {"finished": eng.submit(pre + [9, 10], 4, trace=_ctx(mod, 1)),
            "prefix_hit": eng.submit(pre + [11], 4, trace=_ctx(mod, 2)),
            "cancelled_queued": eng.submit([3, 4], 4, trace=_ctx(mod, 3))}
    assert eng.cancel(reqs["cancelled_queued"].id)
    eng.start()
    for r in reqs.values():
        r.done.wait(120)
    # cancelled while decoding, then pending at stop (one decoding, one
    # queued), with room for 300-token generations so that each is still
    # running when the test acts on it (the weights do not depend on max_seq)
    eng2 = engine_cls(params, dataclasses.replace(cfg, max_seq=400), slots=1, max_len=400,
                      block_size=4, **common)
    r = eng2.submit([5, 6, 7], 300, trace=_ctx(mod, 4))
    eng2.start()
    assert r.stream.get(timeout=120) is not None
    eng2.cancel(r.id)
    r.done.wait(120)
    reqs["cancelled_decoding"] = r
    stopped = [eng2.submit([8, 9], 300, trace=_ctx(mod, 5)),
               eng2.submit([10, 11], 300, trace=_ctx(mod, 6))]
    assert stopped[0].stream.get(timeout=120) is not None
    eng2.stop()
    eng.stop()
    reqs["stopped_decoding"], reqs["stopped_queued"] = stopped
    # a pool deadlock sheds one of two requests that each need 7 of 8 blocks
    eng3 = engine_cls(params, cfg, slots=2, max_len=48, block_size=4, num_blocks=9,
                      prefix_cache=False, **common)
    pair = [eng3.submit([1, 2, 3, 4], 24, trace=_ctx(mod, 7)),
            eng3.submit([5, 6, 7, 8], 24, trace=_ctx(mod, 8))]
    eng3.start()
    for x in pair:
        x.done.wait(120)
    eng3.stop()
    reqs["deadlock_a"], reqs["deadlock_b"] = pair
    # parked, spilled and restored through the host tier
    eng4 = engine_cls(params, cfg, slots=2, max_len=48, block_size=4, num_blocks=9,
                      prefix_cache=False, kv_offload=True, **common)
    rng = np.random.default_rng(24)
    pa, pb = [int(x) for x in rng.integers(0, 64, 24)], [int(x) for x in rng.integers(0, 64, 4)]
    pair = [eng4.submit(pa, 8, trace=_ctx(mod, 9)), eng4.submit(pb, 4, trace=_ctx(mod, 10))]
    eng4.start()
    for x in pair:
        x.done.wait(120)
    assert eng4.stats()["host_restored_blocks_total"] >= 1
    eng4.stop()
    reqs["parked_a"], reqs["parked_b"] = pair
    for name, req in reqs.items():
        out[name] = _record(mod, req)
    return out


def test_phase_names_and_waterfalls_equal_the_jax_engines(models, hot_spans_off):
    jcfg, tcfg, jp, tp = models
    jout = _mix(jtrace, JaxEngine, jp, jcfg, warmup=False)
    tout = _mix(ttrace, ServingEngine, tp, tcfg, warmup=False, device="cpu")
    assert tout == jout
    outcomes = {name: rec[0] for name, rec in tout.items()}
    assert outcomes == {
        "finished": "completed", "prefix_hit": "completed", "cancelled_queued": "cancelled",
        "cancelled_decoding": "cancelled", "stopped_decoding": "stopped",
        "stopped_queued": "stopped", "deadlock_a": "completed", "deadlock_b": "shed",
        "parked_a": "completed", "parked_b": "completed",
    }
    names = {name: set(rec[1]) for name, rec in tout.items()}
    assert "serving.prefix_cache.hit" in names["prefix_hit"]
    assert {"serving.park", "serving.spill", "serving.restore"} <= names["parked_a"] | names[
        "parked_b"]
    assert any("parked_s" in rec[2] for name, rec in tout.items() if name.startswith("parked"))
    assert tout["cancelled_queued"][2] == ["queue_wait_s"]


def test_untraced_requests_record_nothing_and_the_switch_is_the_knob(models, monkeypatch):
    _, tcfg, _, tp = models
    before = len(ttrace.get_tracer().spans())
    eng = ServingEngine(tp, tcfg, slots=1, max_len=48, device="cpu", warmup=False).start()
    try:
        req = eng.submit([4, 5], 3)
        req.wait(timeout=60)
        assert req.trace is None and req.trace_summary is None
        eng.trace_requests = False
        req = eng.submit([4, 5], 3, trace=ttrace.TraceContext(ttrace.new_trace_id()))
        req.wait(timeout=60)
        assert req.trace_summary is None
        unsampled = ttrace.TraceContext(ttrace.new_trace_id(), sampled=False)
        eng.trace_requests = True
        assert eng.submit([4, 5], 3, trace=unsampled).wait(timeout=60)
    finally:
        eng.stop()
    assert all(s["name"] != "serving.request" for s in ttrace.get_tracer().spans()[before:])
    monkeypatch.setenv("POLYAXON_TPU_TRACE_REQUESTS", "0")
    eng = ServingEngine(tp, tcfg, slots=1, max_len=48, device="cpu")
    assert eng.trace_requests is False
    eng.stop()


def test_exemplars_keep_the_slowest_requests(models, monkeypatch):
    monkeypatch.setenv("POLYAXON_TPU_TRACE_EXEMPLARS", "2")
    _, tcfg, _, tp = models
    eng = ServingEngine(tp, tcfg, slots=2, max_len=48, device="cpu", warmup=False).start()
    try:
        reqs = [eng.submit([1, 2, 3], n, trace=ttrace.TraceContext(ttrace.new_trace_id()))
                for n in (2, 9, 5)]
        for r in reqs:
            r.wait(timeout=60)
        ex = eng.stats()["trace_exemplars"]
    finally:
        eng.stop()
    assert len(ex) == 2
    assert ex[0]["total_s"] >= ex[1]["total_s"]
    slowest = sorted(reqs, key=lambda r: r.trace_summary["total_s"])[-2:]
    assert {e["request_id"] for e in ex} == {r.id for r in slowest}


# -- the HTTP handler ---------------------------------------------------------


def _serve(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(base, payload, headers=None):
    req = urllib.request.Request(base + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return json.loads(resp.read())


def _spans_named(base, trace_id, names, timeout=10.0):
    """``/v1/trace/<id>``'s spans once ``names`` are all there (the handler
    records ``serving.generate`` after it has flushed the answer)."""
    deadline = time.time() + timeout
    while True:
        spans = _get(base, f"/v1/trace/{trace_id}")["spans"]
        if names <= {s["name"] for s in spans} or time.time() > deadline:
            return spans
        time.sleep(0.02)


@pytest.fixture(scope="module")
def servers(models):
    jcfg, tcfg, jp, tp = models
    teng = ServingEngine(tp, tcfg, slots=2, max_len=48, device="cpu", warmup=False).start()
    jeng = JaxEngine(jp, jcfg, slots=2, max_len=48, warmup=False).start()
    meta = {"default_max_new": 4}
    out = {"torch": _serve(_make_lm_handler(teng, tcfg, meta)),
           "jax": _serve(jax_handler(jeng, jcfg, meta))}
    yield {side: (base, eng) for (side, (_, base)), eng in zip(out.items(), (teng, jeng))}
    for httpd, _ in out.values():
        httpd.shutdown()
        httpd.server_close()
    teng.stop()
    jeng.stop()


HEADER_CASES = {
    "joined": {"traceparent": "00-" + "ab" * 16 + "-00f067aa0ba902b7-01"},
    "malformed": {"traceparent": "00-not-a-trace-01"},
    "absent": {},
    "unsampled": {"traceparent": "00-" + "cd" * 16 + "-00f067aa0ba902b7-00"},
}


@pytest.mark.parametrize("case", sorted(HEADER_CASES))
def test_generate_answers_carry_the_jax_trace_block(servers, case):
    headers = HEADER_CASES[case]
    bodies = {}
    for side, (base, _) in servers.items():
        status, body = _post(base, {"prompts": [[1, 2, 3], [4, 5]], "max_new_tokens": 3}, headers)
        assert status == 200
        bodies[side] = body
    t, j = bodies["torch"], bodies["jax"]
    assert t["tokens"] == j["tokens"]
    assert set(t) == set(j)
    if case == "unsampled":
        assert "trace" not in t
        return
    assert set(t["trace"]) == set(j["trace"]) == {"trace_id", "waterfalls"}
    assert len(t["trace"]["waterfalls"]) == len(j["trace"]["waterfalls"]) == 2
    for wt, wj in zip(t["trace"]["waterfalls"], j["trace"]["waterfalls"]):
        assert set(wt) == set(wj) == SUMMARY_KEYS
        assert set(wt["waterfall"]) == set(wj["waterfall"])
        assert wt["trace_id"] == t["trace"]["trace_id"] and wt["outcome"] == "completed"
    if case == "joined":
        assert t["trace"]["trace_id"] == j["trace"]["trace_id"] == "ab" * 16
    else:  # a fresh trace, never an error
        assert len(t["trace"]["trace_id"]) == 32 and t["trace"]["trace_id"] != j["trace"]["trace_id"]


def test_trace_route_returns_the_requests_spans(servers):
    base, _ = servers["torch"]
    trace_id = ttrace.new_trace_id()
    status, body = _post(base, {"prompts": [[7, 8, 9]], "max_new_tokens": 3},
                         {"traceparent": f"00-{trace_id}-00f067aa0ba902b7-01"})
    assert status == 200 and body["trace"]["trace_id"] == trace_id
    want = {"serving.generate", "serving.request", "serving.queue_wait"}
    spans = _spans_named(base, trace_id, want)
    by = {s["name"]: s for s in spans}
    assert want <= set(by)
    assert by["serving.generate"]["parent_id"] == "00f067aa0ba902b7"
    assert by["serving.request"]["parent_id"] == by["serving.generate"]["span_id"]
    assert by["serving.queue_wait"]["parent_id"] == by["serving.request"]["span_id"]
    assert _get(base, "/v1/trace/" + "0" * 32) == {"trace_id": "0" * 32, "spans": []}


def test_lm_server_labels_its_spans_with_its_port():
    tracer = ttrace.get_tracer()
    label = tracer.process
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = Context(params=dict(SMALL, seq=48, service_port=port, host="127.0.0.1", device="cpu"),
                  records=[])
    ctx.stop.set()
    try:
        lm_server(ctx)
        assert tracer.process == f"lm_server-{port}"
    finally:
        tracer.configure(process=label)
