"""The port's span tracer and trace propagation against the JAX package's.

``polyaxon_tpu_torch/tracking/trace.py`` is the port's own copy of
``polyaxon_tpu/tracking/trace.py``.  The same inputs go through both: the
``traceparent`` headers they write, what they extract from well-formed and
malformed headers, the span records of a ``Tracer`` (with the clock and the
span ids fixed), the sampling rules, the bounded ring and the Chrome-trace
rendering must be equal.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import itertools
import re

import pytest

from polyaxon_tpu.tracking import trace as jtrace
from polyaxon_tpu_torch.tracking import trace as ttrace

TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"

CONTEXTS = {
    "sampled": (TRACE_ID, "00f067aa0ba902b7", True),
    "unsampled": (TRACE_ID, "00f067aa0ba902b7", False),
    "no_parent": (TRACE_ID, "", True),
    "internal_span_id": (TRACE_ID, "router.0.1f", True),
}


@pytest.mark.parametrize("name", sorted(CONTEXTS))
def test_header_child_and_inject_equal_the_jax_module(name):
    args = CONTEXTS[name]
    j, t = jtrace.TraceContext(*args), ttrace.TraceContext(*args)
    assert t.header() == j.header()
    assert t.child("lm_server.0.2").header() == j.child("lm_server.0.2").header()
    assert ttrace.inject(t, {"x": "1"}) == jtrace.inject(j, {"x": "1"})
    assert ttrace.inject(None, {}) == jtrace.inject(None, {}) == {}
    assert ttrace.TRACEPARENT_HEADER == jtrace.TRACEPARENT_HEADER


HEADERS = {
    "valid": {"traceparent": f"00-{TRACE_ID}-00f067aa0ba902b7-01"},
    "valid_unsampled": {"traceparent": f"00-{TRACE_ID}-00f067aa0ba902b7-00"},
    "title_case_key": {"Traceparent": f"00-{TRACE_ID}-00f067aa0ba902b7-01"},
    "zero_span_id": {"traceparent": f"00-{TRACE_ID}-0000000000000000-01"},
    "internal_span_id": {"traceparent": f"00-{TRACE_ID}-router.0.1f-01"},
    "padded": {"traceparent": f"  00-{TRACE_ID}-00f067aa0ba902b7-03  "},
    "missing": {},
    "none": None,
    "empty": {"traceparent": ""},
    "not_a_string": {"traceparent": 17},
    "three_parts": {"traceparent": f"00-{TRACE_ID}-01"},
    "five_parts": {"traceparent": f"00-{TRACE_ID}-00f067aa0ba902b7-01-x"},
    "long_version": {"traceparent": f"000-{TRACE_ID}-00f067aa0ba902b7-01"},
    "zero_trace_id": {"traceparent": "00-" + "0" * 32 + "-00f067aa0ba902b7-01"},
    "short_trace_id": {"traceparent": "00-4bf92f35-00f067aa0ba902b7-01"},
    "non_hex_trace_id": {"traceparent": "00-" + "z" * 32 + "-00f067aa0ba902b7-01"},
    "non_hex_flags": {"traceparent": f"00-{TRACE_ID}-00f067aa0ba902b7-zz"},
    "garbage": {"traceparent": "not a header at all"},
}


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_extract_equals_the_jax_module(name):
    j, t = jtrace.extract(HEADERS[name]), ttrace.extract(HEADERS[name])
    assert (j is None) == (t is None)
    if j is not None:
        assert (t.trace_id, t.span_id, t.sampled) == (j.trace_id, j.span_id, j.sampled)


def test_extract_of_an_unreadable_mapping_is_none_in_both():
    class Broken:
        def get(self, key):
            raise RuntimeError("unreadable")

    assert ttrace.extract(Broken()) is None and jtrace.extract(Broken()) is None


def test_new_trace_ids_are_32_hex_and_fresh():
    ids = {ttrace.new_trace_id() for _ in range(50)}
    assert len(ids) == 50
    assert all(re.fullmatch("[0-9a-f]{32}", i) for i in ids)
    assert len(jtrace.new_trace_id()) == len(ttrace.new_trace_id())


@pytest.fixture
def fixed_clock(monkeypatch):
    """time.time and time.perf_counter as counters (both modules read the
    same clock); calling the fixture's value starts them again."""
    clock = {}

    def reset():
        clock["wall"], clock["perf"] = itertools.count(1000), itertools.count(5)

    reset()
    monkeypatch.setattr(jtrace.time, "time", lambda: float(next(clock["wall"])))
    monkeypatch.setattr(jtrace.time, "perf_counter", lambda: 0.5 * next(clock["perf"]))
    return reset


def _script(mod):
    """Spans through every recording path of one fresh Tracer."""
    tracer = mod.Tracer(sample=1.0, hot_sample=1.0, buffer=16, process_id=3,
                        trace_id="run-trace")
    with tracer.span("outer", step=1) as outer:
        outer.set(found="later")
        with tracer.span("inner"):
            pass
        with tracer.span("explicit", trace_id=TRACE_ID, parent_id="remote.1"):
            pass
    with pytest.raises(ValueError):
        with tracer.span("fails"):
            raise ValueError("x")
    tracer.configure(process="lm_server-8000")
    tracer.record_span("recorded", start=12.5, duration=0.25, trace_id=TRACE_ID,
                       parent_id="p", request_id=7)
    tracer.record_span("relabelled", start=13.0, duration=0.0, process="router")
    assert tracer.span("off", sample=0.0).__enter__() is not None
    ids = [tracer.next_span_id() for _ in range(2)]
    return tracer.spans(), ids


def test_span_records_equal_the_jax_module(fixed_clock):
    jspans, jids = _script(jtrace)
    fixed_clock()
    tspans, tids = _script(ttrace)
    assert tspans == jspans
    assert tids == jids
    names = [s["name"] for s in tspans]
    assert names == ["inner", "explicit", "outer", "fails", "recorded", "relabelled"]
    by = {s["name"]: s for s in tspans}
    assert by["inner"]["parent_id"] == by["outer"]["span_id"]
    assert by["explicit"]["parent_id"] == "remote.1" and by["explicit"]["trace_id"] == TRACE_ID
    assert by["fails"]["attrs"] == {"error": "ValueError"}
    assert by["outer"]["attrs"] == {"step": 1, "found": "later"}
    assert by["recorded"]["process"] == "lm_server-8000"
    assert by["relabelled"]["process"] == "router"


def test_sampled_out_spans_are_the_shared_noop_in_both():
    for mod in (jtrace, ttrace):
        tracer = mod.Tracer(sample=0.0)
        with tracer.span("never") as sp:
            sp.set(a=1)
        assert tracer.spans() == []
        assert tracer.span("never") is tracer.span("again")
        assert type(tracer.span("forced", sample=1.0)).__name__ == "_Span"


def test_ring_keeps_the_newest_records_and_a_broken_sink_is_ignored():
    out = {}
    for mod in (jtrace, ttrace):
        seen = []

        def sink(record, seen=seen):
            seen.append(record["name"])
            raise RuntimeError("sink down")

        tracer = mod.Tracer(buffer=3, sink=sink)
        for i in range(5):
            tracer.record_span(f"s{i}", start=float(i), duration=0.0, span_id=str(i))
        out[mod] = ([s["name"] for s in tracer.spans()], seen)
        tracer.clear()
        assert tracer.spans() == []
    assert out[ttrace] == out[jtrace] == (["s2", "s3", "s4"], [f"s{i}" for i in range(5)])


def test_span_ids_with_and_without_a_process_label():
    for mod in (jtrace, ttrace):
        tracer = mod.Tracer(process_id=2)
        assert tracer.next_span_id() == "2.1"
        tracer.configure(process="router")
        assert tracer.next_span_id() == "router.2.2"


def test_the_process_tracer_reads_the_same_knobs(monkeypatch):
    assert ttrace.get_tracer().sample == jtrace.get_tracer().sample
    assert ttrace.get_tracer().hot_sample == jtrace.get_tracer().hot_sample
    tracer = ttrace.get_tracer()
    label = tracer.process
    try:
        assert ttrace.configure(process="x") is tracer and tracer.process == "x"
    finally:
        tracer.configure(process=label)


def _spans_for_chrome():
    return [
        {"name": "a", "trace_id": TRACE_ID, "span_id": "1", "parent_id": None, "start": 1.5,
         "duration": 0.25, "process_id": 0, "thread": "main"},
        {"name": "b", "trace_id": TRACE_ID, "span_id": "2", "parent_id": "1", "start": 1.6,
         "duration": 0.1, "process_id": 0, "thread": "serving-engine", "process": "router",
         "attrs": {"request_id": 3}},
        {"name": "c", "span_id": "3", "start": 1.7, "duration": 0.0, "process_id": 0,
         "thread": "main", "process": "lm_server-1"},
        {"name": "d", "start": 2.0, "duration": 1.0, "process_id": 4},
        {"start": None, "duration": None, "process": "router", "thread": "main"},
    ]


def test_chrome_trace_equals_the_jax_rendering():
    spans = _spans_for_chrome()
    got = ttrace.chrome_trace(spans)
    assert got == jtrace.chrome_trace(spans)
    pids = {e["pid"] for e in got["traceEvents"] if e["ph"] == "X"}
    assert len(pids) == 4  # process 0, router, lm_server-1, process 4
