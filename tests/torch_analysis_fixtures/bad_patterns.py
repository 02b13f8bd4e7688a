"""Known-bad fixture of the port: every rule must fire on its section.

Not imported anywhere: parsed by tests/test_torch_analysis.py.  The names
intentionally don't resolve; graft-lint is lexical.  GL001 and GL002 are
the port's (CUDA-graph captures); the sections from GL003 on are the
reference's (tests/test_analysis/fixtures/bad_patterns.py), as they are.
"""

import threading
import time
import urllib.request

import numpy as np
import torch

from polyaxon_tpu_torch.models.decode import capture_step


# -- GL001: host syncs inside captured functions -----------------------------

def impure_step():
    print("stepping")  # host I/O: runs at capture, never at replay
    t0 = time.time()  # time.* at capture only
    host = np.asarray(static_x)  # host sync
    n = static_x.item()  # device-to-host wait
    rows = static_x.tolist()  # device-to-host wait
    torch.cuda.synchronize()  # a sync the capture refuses
    return host, n, rows, t0


graph, out = capture_step(impure_step)


def graphed_forward(x):
    scale = float(x)  # a host read of an argument
    return x.cpu() * scale  # device-to-host copy


graphed = torch.cuda.make_graphed_callables(graphed_forward, (static_x,))


def capture_body(g, x):
    with torch.cuda.graph(g):
        y = x * 2
        peak = y.max().item()  # a sync inside the captured body
    return y, peak


# -- GL002: rebinding a captured step's inputs -------------------------------

def generate_rebinds(decode_step, pick, logits, token, pos, steps):
    # models/decode.py:generate's loop with its write in place undone.
    def one_step():
        return decode_step(token, pos)

    graph, captured = capture_step(one_step)
    for _ in range(steps):
        graph.replay()
        logits = captured
        pos += 1
        token = pick(logits)  # replays go on reading the old token
    return token


def body_rebinds(model, static_x, batches):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        static_y = model(static_x)
    for batch in batches:
        static_x = batch  # a buffer the graph never reads
        g.replay()
    return static_y


# -- GL003: registry write outside the lock ----------------------------------

class BadRegistry:
    def __init__(self, conn):
        self._lock = threading.Lock()
        self._db = conn

    def good_write(self, run_id):
        with self._lock:
            self._db.execute("UPDATE runs SET x = 1 WHERE id = ?", (run_id,))

    def bad_write(self, run_id):
        self._db.execute("DELETE FROM runs WHERE id = ?", (run_id,))

    def read_ok(self, run_id):
        return self._db.execute(
            "SELECT * FROM runs WHERE id = ?", (run_id,)
        ).fetchone()


# -- GL004: blocking calls in tick paths -------------------------------------

class SleepyAgent:
    def poll(self):
        time.sleep(1.0)  # blocks the beat thread

    def fetch(self):
        urllib.request.urlopen("http://example.com/hook")  # no timeout


def wire(reporter):
    agent = SleepyAgent()
    reporter.add_beat_hook(agent.poll)
    reporter.add_beat_hook(agent.fetch)


# -- GL005: phantom knob ------------------------------------------------------

PHANTOM = "POLYAXON_TPU_DOES_NOT_EXIST"


# -- GL006: network I/O without a timeout ------------------------------------

def notify(url, payload):
    return urllib.request.urlopen(url, data=payload)


# -- GL007: metric label hygiene ----------------------------------------------

def labeled_key(name, **labels):  # stand-in for stats.metrics.labeled_key
    return name


def export_bad_labels(stats, run_id, replica_name):
    # f-string label value: one series per run id.
    stats.gauge(labeled_key("queue_depth_bad", run=f"run-{run_id}"), 1.0)
    # .format() label value.
    stats.incr(labeled_key("events_bad", rule="rule-{}".format(run_id)))
    # string concatenation.
    stats.gauge(labeled_key("state_bad", replica="rep-" + replica_name), 0.0)
    # label key outside the allowed catalog.
    stats.incr(labeled_key("orders_bad", customer_id="42"))
    # **kwargs label set: unreviewable keys.
    stats.incr(labeled_key("dyn_bad", **{"run": str(run_id)}))


# -- GL008: span-name hygiene -------------------------------------------------

def trace_bad_spans(tracer, task_name):
    # f-string span name: one Perfetto track per task.
    with tracer.span(f"task:{task_name}"):
        pass
    # Literal but not dot-delimited.
    with tracer.span("NotDotted"):
        pass
    # Dot-delimited but not in the catalog.
    tracer.record_span("serving.bogus_phase", start=0.0, duration=0.0)
