"""The port's LM HTTP front end, over an engine on the CPU.

Drives the handler ``lm_server`` installs (``_make_lm_handler``) over the
port's engine on an ephemeral ``ThreadingHTTPServer``, as
``tests/test_serving/test_lm_http.py`` drives the JAX one: every
``/generate`` answer must equal the JAX package's greedy ``generate`` on the
same weights (the reference tests' small float32 model), also when many
client threads overlap.  Then ``lm_server`` itself, started and stopped
in-process on the CPU, with random weights and with a ``target`` run's
checkpoint, and its ``drain`` command through the capture agent's mailbox.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import decode as jdec
from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu_torch.builtins.services import _make_lm_handler, lm_server
from polyaxon_tpu_torch.builtins.trainers import lm_train
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.runtime.checkpoint import CheckpointManager
from polyaxon_tpu_torch.serving import ServingEngine
from polyaxon_tpu_torch.tracking.capture import configure
from polyaxon_tpu_torch.tracking.context import Context

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64, max_seq=48)
JCFG = jtr.TransformerConfig(dtype=jnp.float32, **SMALL)
TCFG = ttr.TransformerConfig(dtype=torch.float32, **SMALL)


def _start(engine, meta):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_lm_handler(engine, TCFG, meta))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _close(httpd, engine):
    httpd.shutdown()
    httpd.server_close()
    engine.stop()


@pytest.fixture(scope="module")
def server():
    jp = jtr.init_params(jax.random.PRNGKey(0), JCFG)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    engine = ServingEngine(tp, TCFG, slots=3, max_len=48, device="cpu").start()
    httpd, base = _start(engine, {"checkpoint_step": None, "default_max_new": 8})
    yield base, jp
    _close(httpd, engine)


@pytest.fixture()
def slow_server():
    """One slot with room for 400-token generations (so a request is still
    running when the test acts on it) and a server-side wait of 1 ms: every
    /generate times out."""
    jp = jtr.init_params(jax.random.PRNGKey(1), JCFG)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    engine = ServingEngine(tp, TCFG.scaled(max_seq=512), slots=1, device="cpu").start()
    httpd, base = _start(engine, {"checkpoint_step": None, "default_max_new": 8,
                                  "request_timeout_s": 0.001})
    yield base, engine
    _close(httpd, engine)


def _post(base, path, payload, timeout=120):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path, raw=False):
    with urllib.request.urlopen(base + path, timeout=30) as resp:
        body = resp.read()
        return resp.status, resp.headers, (body.decode() if raw else json.loads(body))


def _ref(jp, prompt, max_new):
    return np.asarray(jdec.generate(jp, jnp.asarray([prompt]), JCFG, max_new_tokens=max_new))[0].tolist()


def _await_idle(engine, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        s = engine.stats()
        if s["slots_active"] == 0 and s["blocks_free"] == s["blocks_total"]:
            return s
        time.sleep(0.02)
    return engine.stats()


def test_mixed_length_prompts_in_one_request(server):
    base, jp = server
    prompts = [[1, 2], [3], [4, 5, 6, 7]]
    status, body = _post(base, "/generate", {"prompts": prompts, "max_new_tokens": 5})
    assert status == 200
    assert body["tokens"] == [_ref(jp, p, 5) for p in prompts]
    assert body["decode_tokens_per_s"] > 0 and all(t > 0 for t in body["ttft_s"])


def test_overlapping_requests_share_the_engine(server):
    base, jp = server
    rng = np.random.default_rng(11)
    jobs = [([int(x) for x in rng.integers(0, 64, t)], mn)
            for t, mn in [(3, 9), (8, 5), (5, 12), (11, 4), (6, 7), (4, 10)]]
    results = [None] * len(jobs)

    def worker(i, prompt, mn):
        results[i] = _post(base, "/generate", {"prompts": [prompt], "max_new_tokens": mn})

    threads = [threading.Thread(target=worker, args=(i, p, mn)) for i, (p, mn) in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()
    for i, (prompt, mn) in enumerate(jobs):
        status, body = results[i]
        assert status == 200, body
        assert body["tokens"] == [_ref(jp, prompt, mn)], f"job {i}"


def test_stats_healthz_and_metrics(server):
    base, _ = server
    _post(base, "/generate", {"prompts": [[9, 8, 7]], "max_new_tokens": 3})
    status, _, body = _get(base, "/v1/stats")
    assert status == 200 and body["slots"] == 3 and body["device"] == "cpu"
    assert {"queue_depth", "slots_active", "tokens_per_s", "decode_steps", "requests_finished",
            "block_occupancy", "blocks_free", "prefix_cache_hit_rate", "prefill_backlog_chunks",
            "requests_cancelled"} <= set(body)
    assert {"queue_wait_s", "ttft_s", "decode_step_s", "batch_occupancy"} <= set(body["latency"])
    status, _, health = _get(base, "/healthz")
    assert status == 200 and health["ok"] is True and health["state"] == "ready"
    assert health["model"]["vocab_size"] == 64 and health["engine"]["slots"] == 3
    status, headers, text = _get(base, "/metrics", raw=True)
    assert status == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
    assert "# TYPE polyaxon_tpu_serving_ttft_s histogram" in text
    assert 'polyaxon_tpu_serving_ttft_s_bucket{component="lm_server",le="+Inf"}' in text
    assert 'polyaxon_tpu_serving_block_occupancy{component="lm_server"}' in text
    assert "process_start_time_seconds" in text and "polyaxon_tpu_build_info" in text


def test_bad_requests_are_400_and_unknown_paths_404(server):
    base, _ = server
    for payload in ({}, {"prompts": [1, 2]}, {"prompts": []}, {"prompts": [[1, 999]]},
                    {"prompts": [[1, 2]], "max_new_tokens": 0},
                    {"prompts": [[1] * 47], "max_new_tokens": 10}):
        status, body = _post(base, "/generate", payload)
        assert status == 400, payload
        assert body["error"]["kind"] == "bad_request"
    status, body = _post(base, "/elsewhere", {})
    assert status == 404 and body["error"]["kind"] == "not_found"
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(base, "/nope")
    assert err.value.code == 404


def test_cancel_route(slow_server):
    base, engine = slow_server
    req = engine.submit([1, 2, 3], 400)
    assert req.stream.get(timeout=60) is not None  # in flight
    status, body = _post(base, "/v1/cancel", {"request_id": req.id})
    assert status == 200 and body["cancelled"] is True
    with pytest.raises(RuntimeError, match="cancelled"):
        req.wait(timeout=30)
    s = _await_idle(engine)
    assert s["slots_active"] == 0 and s["blocks_free"] == s["blocks_total"]
    assert _post(base, "/v1/cancel", {"request_id": 10**9}) == (200, {"cancelled": False})
    status, body = _post(base, "/v1/cancel", {})
    assert status == 400 and body["error"]["kind"] == "bad_request"


def test_stats_show_the_id_a_client_cancels_by(slow_server):
    base, engine = slow_server
    assert _get(base, "/v1/stats")[2]["slot_request_ids"] == [None]
    req = engine.submit([4, 5, 6], 400)
    assert req.stream.get(timeout=60) is not None  # holds the one slot
    (rid,) = _get(base, "/v1/stats")[2]["slot_request_ids"]
    assert rid == req.id
    assert _post(base, "/v1/cancel", {"request_id": rid}) == (200, {"cancelled": True})
    with pytest.raises(RuntimeError, match="cancelled"):
        req.wait(timeout=30)
    s = _await_idle(engine)
    assert s["slot_request_ids"] == [None] and s["blocks_free"] == s["blocks_total"]


def test_generate_timeout_cancels_the_abandoned_request(slow_server):
    base, engine = slow_server
    status, body = _post(base, "/generate", {"prompts": [[1, 2, 3]], "max_new_tokens": 400})
    assert status == 503 and body["error"]["kind"] == "timeout"
    s = _await_idle(engine)
    assert s["slots_active"] == 0 and s["blocks_free"] == s["blocks_total"]
    assert s["requests_cancelled"] >= 1


def test_drain_is_a_typed_503(slow_server):
    base, engine = slow_server
    engine.drain()
    status, body = _post(base, "/generate", {"prompts": [[1, 2]], "max_new_tokens": 2})
    assert status == 503 and body["error"]["kind"] == "draining"
    assert _get(base, "/healthz")[2]["state"] == "draining"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_lm_server_serves_on_the_cpu_and_stops():
    records = []
    ctx = Context(params=dict(SMALL, seq=48, slots=2, block_size=8, prefill_chunk=8,
                              max_new_tokens=8, service_port=_free_port(), host="127.0.0.1",
                              device="cpu"),
                  seed=3, records=records)
    thread = threading.Thread(target=lm_server, args=(ctx,), daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{ctx.params['service_port']}"
    deadline = time.time() + 60
    while True:
        try:
            if _get(base, "/healthz")[2]["state"] == "ready":
                break
        except OSError:
            pass
        assert time.time() < deadline, records
        time.sleep(0.05)
    status, body = _post(base, "/generate", {"prompts": [[1, 2, 3], [4] * 20]})
    assert status == 200 and [len(t) for t in body["tokens"]] == [8, 8]
    engine_health = _get(base, "/healthz")[2]["engine"]
    stats = _get(base, "/v1/stats")[2]
    assert engine_health["steady_state_compiles"] == stats["steady_state_compiles"]
    # without the warmup, the 8-token chunk and the decode step are built
    # on first use
    assert stats["steady_state_compiles"] == (0 if stats["warmup"]["total"] else 2)
    ctx.stop.set()
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert any("lm_server: " in r["line"] and "slots" in r["line"] for r in records)


def test_lm_server_refuses_what_is_not_ported(tmp_path):
    """The host KV tier and the prefix store are ported: lm_server takes
    ``kv_offload`` and ``kv_persist`` (the store beside the runs root, as the
    reference puts it); without a card it refuses the default device."""
    runs = tmp_path / "runs"
    runs.mkdir()
    records = []
    ctx = Context(params=dict(SMALL, seq=48, service_port=_free_port(), host="127.0.0.1",
                              device="cpu", kv_offload="true", kv_persist="true"),
                  runs_root=str(runs), seed=5, records=records)
    ctx.stop.set()  # serve nothing: build, start and stop
    lm_server(ctx)
    lines = [r["line"] for r in records]
    assert any("host KV offload tier enabled" in line for line in lines), lines
    assert any(f"prefix KV persistence at {tmp_path / 'kv_cache'}" in line for line in lines)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lm_server(Context(params=dict(SMALL, seq=48, service_port=1), records=[]))


class _Reporter:
    def __init__(self):
        self.captures, self.commands = [], []

    def capture(self, record):
        self.captures.append(dict(record))

    def command_event(self, uuid, state, message=None, **attrs):
        self.commands.append((uuid, state, message))


def _drop(mailbox, uuid, kind, payload=None):
    (mailbox / f"{uuid}.json").write_text(json.dumps({"uuid": uuid, "kind": kind,
                                                      "payload": payload or {}}))


def test_lm_server_target_serves_the_checkpoint_and_drains_on_command(tmp_path):
    """lm_server with a ``target`` run serves its newest checkpoint (the JAX
    ``generate``'s tokens on the restored weights) and reports the step; a
    ``profile`` command through the mailbox traces two decode steps and a
    ``drain`` command turns new requests into a typed 503."""
    train = dict(SMALL, seq=16, batch=2, steps=2, save_every=1, device="cpu")
    del train["max_seq"]
    run = tmp_path / "runs" / "trained"
    lm_train(Context(params=train, seed=5, outputs_path=str(run / "outputs"),
                     checkpoints_path=str(run / "checkpoints"), records=[]))
    params = ttr.init_params(TCFG, torch.Generator().manual_seed(0))
    mgr = CheckpointManager(run / "checkpoints")
    assert mgr.restore_params(params)["step"] == 1
    mgr.close()
    jp = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), params)

    mailbox, reporter = tmp_path / "commands" / "proc0", _Reporter()
    mailbox.mkdir(parents=True)
    agent = configure(reporter=reporter, mailbox=mailbox, profiles_root=tmp_path / "profiles")
    records = []
    ctx = Context(params=dict(SMALL, seq=48, slots=2, block_size=8, max_new_tokens=8,
                              service_port=_free_port(), host="127.0.0.1", device="cpu",
                              target="trained"),
                  seed=3, outputs_path=str(tmp_path / "runs" / "server" / "outputs"),
                  records=records)
    thread = threading.Thread(target=lm_server, args=(ctx,), daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{ctx.params['service_port']}"
    try:
        deadline = time.time() + 60
        while True:
            try:
                health = _get(base, "/healthz")[2]
                if health["state"] == "ready":
                    break
            except OSError:
                pass
            assert time.time() < deadline and thread.is_alive(), records
            time.sleep(0.05)
        assert health["target"] == "trained" and health["checkpoint_step"] == 1
        lines = [r["line"] for r in records if r["kind"] == "log"]
        assert "lm_server: restored run trained step 1" in lines
        assert any("(cpu, checkpoint step 1)" in line for line in lines)
        prompts = [[1, 2, 3], [4] * 20]
        status, body = _post(base, "/generate", {"prompts": prompts})
        assert status == 200 and body["tokens"] == [_ref(jp, p, 8) for p in prompts]

        _drop(mailbox, "cap1", "profile", {"num_steps": 2})
        agent.poll()
        assert _post(base, "/generate", {"prompts": [[5, 6]], "max_new_tokens": 6})[0] == 200
        manifest = json.loads((tmp_path / "profiles" / "cap1" / "proc0" /
                               "manifest.json").read_text())
        assert manifest["num_steps"] == 2 and manifest["attrs"]["trace"] is True
        assert any(a.endswith(".pt.trace.json") for a in manifest["artifacts"])

        _drop(mailbox, "drain1", "drain")
        agent.poll()
        assert _get(base, "/healthz")[2]["state"] == "draining"
        status, body = _post(base, "/generate", {"prompts": [[1, 2]], "max_new_tokens": 2})
        assert status == 503 and body["error"]["kind"] == "draining"
        assert reporter.commands[-2:] == [("drain1", "acked", None),
                                          ("drain1", "complete", "engine draining")]
        assert ("cap1", "complete", None) in reporter.commands
        assert "lm_server: drain command — no new admissions" in [
            r["line"] for r in records if r["kind"] == "log"]
    finally:
        ctx.stop.set()
        thread.join(timeout=60)
        configure(reporter=None, mailbox=None, profiles_root=None)
    assert not thread.is_alive()


def test_lm_server_target_without_a_checkpoint_raises(tmp_path):
    ctx = Context(params=dict(SMALL, seq=48, service_port=1, device="cpu", target="none"),
                  runs_root=str(tmp_path), records=[])
    with pytest.raises(RuntimeError, match="No checkpoint under"):
        lm_server(ctx)
