"""Known-good fixture of the port: the real capture shapes; zero findings
expected.

Mirrors the port's idioms: ``generate``'s captured decode step updated in
place, the engine's step entries over static buffers, a captured body fed
by ``copy_``; the sections from the registry on are the reference's
(tests/test_analysis/fixtures/good_patterns.py), as they are.
"""

import threading
import urllib.request

import torch

from polyaxon_tpu_torch.models.decode import capture_step


# -- pure captured functions, inputs written in place (decode.py shape) ------

def decode_loop(decode_step, pick, logits, token, pos, steps):
    def one_step():
        return decode_step(token, pos)

    graph, captured = capture_step(one_step)
    for _ in range(steps):
        graph.replay()
        logits = captured
        pos += 1
        token.copy_(pick(logits))
    return token


# -- static input buffers (serving/engine.py:_StepEntry shape) ---------------

class StepEntry:
    def __init__(self, fn, inputs, pool=None):
        self.fn = fn
        self.inputs = inputs
        self.graph, self.out = capture_step(lambda: fn(**inputs), pool=pool)

    def __call__(self, **host):
        for name, arr in host.items():
            self.inputs[name].copy_(arr, non_blocking=True)
        self.graph.replay()
        return self.out


def body_in_place(model, static_x, batches):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        static_y = model(static_x)
    for batch in batches:
        static_x.copy_(batch)
        g.replay()
    return static_y.clone()


# -- registry writes under the lock (db/registry.py shape) -------------------

class GoodRegistry:
    def __init__(self, conn):
        self._lock = threading.Lock()
        self._db = conn

    def write(self, run_id):
        with self._lock, self._db as conn:
            conn.execute("UPDATE runs SET x = 1 WHERE id = ?", (run_id,))

    def _delete_tree_locked(self, run_id):
        # *_locked convention: caller holds self._lock
        self._db.execute("DELETE FROM runs WHERE id = ?", (run_id,))

    def read(self, run_id):
        return self._db.execute(
            "SELECT * FROM runs WHERE id = ?", (run_id,)
        ).fetchone()


# -- non-blocking tick paths (capture.py shape) ------------------------------

class QuietAgent:
    def poll(self):
        return list(self._pending())

    def _pending(self):
        return ()


def wire(reporter):
    agent = QuietAgent()
    reporter.add_beat_hook(agent.poll)


# -- catalogued knobs + bounded network I/O ----------------------------------

KNOWN = "POLYAXON_TPU_WATCHDOG_K"
FAMILY_MEMBER = "POLYAXON_TPU_ALERT_GOODPUT_LOW_FLOOR"
WILDCARD_MENTION = "tune via POLYAXON_TPU_REMEDIATION_* knobs"


def notify(url, payload):
    return urllib.request.urlopen(url, data=payload, timeout=5.0)


# -- GL007: bounded metric labels ---------------------------------------------

def labeled_key(name, **labels):  # stand-in for stats.metrics.labeled_key
    return name


_CODE_CLASSES = {2: "2xx", 4: "4xx", 5: "5xx"}


def export_good_labels(stats, run_id, method, code):
    # Plain variables and catalogued keys: the runtime series cap is the
    # backstop for value cardinality; no interpolation at the call site.
    stats.gauge(labeled_key("queue_depth_ok", run=run_id), 1.0)
    stats.incr(
        labeled_key(
            "api_request_ok",
            method=method,
            code=_CODE_CLASSES.get(code // 100, "other"),
        )
    )
    stats.incr(labeled_key("plain_counter_ok"))


# -- GL008: span-name hygiene -------------------------------------------------

def trace_good_spans(tracer, match, step):
    # Catalogued literal name; the variable part rides as an attribute.
    with tracer.span("train.step", step=step):
        pass
    # re.Match.span() / .span(group) — not tracer calls, must not flag.
    match.span()
    match.span(1)


class EngineLikeForwarders:
    """The serving engine's forwarding-wrapper shape: the name parameter
    passes through verbatim, so the literal check applies at call sites."""

    def __init__(self, tracer):
        self._tracer = tracer

    def _trace_span(self, req, name, start, duration, **attrs):
        self._tracer.record_span(name, start=start, duration=duration, **attrs)

    def _trace_hot(self, req, name, start, duration, **attrs):
        self._trace_span(req, name, start, duration, **attrs)

    def prefill(self, req, t0, dt):
        self._trace_span(req, "serving.prefill", t0, dt)
        self._trace_hot(req, "serving.decode.step", t0, dt)
