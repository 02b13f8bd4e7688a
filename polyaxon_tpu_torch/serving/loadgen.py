"""Poisson-arrival load harness for the port's serving engine.

Counterpart of ``polyaxon_tpu/serving/loadgen.py`` (numpy and threads; the
port's own copy).  :func:`poisson_load` drives a running engine the way
traffic arrives: exponential inter-arrival gaps at a target rate drawn up
front from a seed, one watcher thread per request reading its token stream
(so TTFT is measured when the first token is readable by a client), and
aggregate tokens/s over the loaded wall clock.  :func:`http_poisson_load`
does the same against ``lm_server``'s or the fleet router's ``/generate``
with typed outcomes and a seeded fault schedule; :func:`chaos_poisson_load`
composes phased load with a chaos timeline (kills, stalls, bursts) and a
control-loop pump.  The prompt builders give the same byte-for-byte prompt
sets as the reference's for the same seed.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def _pct(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(np.ceil(q / 100.0 * len(sorted_vals))) - 1)
    return sorted_vals[max(idx, 0)]


def poisson_load(
    engine: Any,
    prompts: Sequence[Sequence[int]],
    max_new_tokens: int,
    *,
    rate_rps: float,
    temperature: float = 0.0,
    seed: int = 0,
    timeout_s: float = 600.0,
) -> Dict[str, Any]:
    """Offer ``prompts`` to a RUNNING engine at ``rate_rps`` Poisson
    arrivals; returns loaded-throughput and TTFT-percentile metrics.

    The arrival schedule is drawn up front from ``seed``, so two runs
    with the same (prompts, rate, seed) offer the identical load — the
    property that makes chunked-vs-full prefill A/B comparisons fair.
    """
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be positive, got {rate_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=len(prompts))

    results: List[Optional[tuple]] = [None] * len(prompts)

    def watch(i: int, req: Any, t_submit: float) -> None:
        ttft = None
        n_tokens = 0
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                tok = req.stream.get(timeout=remaining)
            except Exception:
                break
            if tok is None:
                break
            if ttft is None:
                ttft = time.perf_counter() - t_submit
            n_tokens += 1
        results[i] = (
            ttft,
            n_tokens,
            time.perf_counter() - t_submit,
            req.error,
            getattr(req, "error_kind", None),
        )

    threads: List[threading.Thread] = []
    t_start = time.perf_counter()
    for i, prompt in enumerate(prompts):
        time.sleep(float(gaps[i]))
        t_submit = time.perf_counter()
        req = engine.submit(list(prompt), max_new_tokens, temperature)
        th = threading.Thread(
            target=watch, args=(i, req, t_submit), daemon=True
        )
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=timeout_s)
    wall = time.perf_counter() - t_start

    done = [r for r in results if r is not None]
    ttfts = sorted(r[0] for r in done if r[0] is not None)
    total_tokens = sum(r[1] for r in done)
    completed = sum(
        1 for r in done if r[3] is None and r[1] >= max_new_tokens
    )
    # A shed (engine refusing work it cannot fit) is LOAD SIGNAL, not a
    # fault: count it apart from errors so an A/B at fixed offered load
    # can't trade sheds for "failures" and call it even.
    sheds = sum(1 for r in done if r[4] == "shed")
    errors = sum(1 for r in done if r[3] is not None and r[4] != "shed")
    return {
        "n_requests": len(prompts),
        "completed": completed,
        "sheds": sheds,
        "errors": errors,
        "offered_rps": round(float(rate_rps), 4),
        "wall_s": round(wall, 3),
        "tokens_per_s": round(total_tokens / wall, 1) if wall > 0 else 0.0,
        "total_tokens": total_tokens,
        "ttft_mean_s": (
            round(float(np.mean(ttfts)), 6) if ttfts else 0.0
        ),
        "ttft_p50_s": round(_pct(ttfts, 50), 6),
        "ttft_p95_s": round(_pct(ttfts, 95), 6),
        "ttft_p99_s": round(_pct(ttfts, 99), 6),
        # Per-request TTFT by submission index (None = no first token),
        # so callers can compute percentiles over request CLASSES —
        # e.g. interactive shorts vs batch longs, which chunked prefill
        # deliberately trades against each other.
        "ttft_s": [
            (round(r[0], 6) if r is not None and r[0] is not None else None)
            for r in results
        ],
    }


def shared_prefix_prompts(
    n: int,
    vocab_size: int,
    *,
    prefix_len: int,
    suffix_len: int,
    groups: int = 4,
    seed: int = 0,
) -> List[List[int]]:
    """``n`` prompts in ``groups`` families sharing a common prefix —
    the traffic class prefix-affinity routing exists for.

    Every prompt in a family starts with the family's ``prefix_len``
    tokens (drawn once) followed by a private ``suffix_len`` suffix.
    Fully determined by ``seed``, so a fleet A/B offers the identical
    byte-for-byte prompt set to both arms.
    """
    if n <= 0 or groups <= 0:
        raise ValueError(f"need n > 0 and groups > 0, got n={n} groups={groups}")
    rng = np.random.default_rng(seed)
    prefixes = [
        rng.integers(0, vocab_size, size=prefix_len).tolist()
        for _ in range(groups)
    ]
    prompts = []
    for i in range(n):
        suffix = rng.integers(0, vocab_size, size=suffix_len).tolist()
        prompts.append(prefixes[i % groups] + suffix)
    return prompts


def templated_prompts(
    n: int,
    vocab_size: int,
    *,
    n_templates: int = 4,
    header_len: int = 16,
    motif_len: int = 4,
    rows: int = 4,
    field_len: int = 2,
    seed: int = 0,
) -> List[List[int]]:
    """``n`` prompts from ``n_templates`` template families with high
    n-gram SELF-overlap — the traffic class speculative decoding's
    prompt-lookup drafter wins on.

    Each family fixes a ``header_len``-token header (shared across the
    family, so prefix caching composes) and a ``motif_len``-token record
    motif; each prompt is the header followed by ``rows`` records of
    ``motif + private fields`` (``field_len`` tokens drawn per prompt).
    The motif recurring every record gives the drafter's suffix index
    repeated n-grams to match mid-generation, the way real templated
    traffic (forms, logs, structured extraction) repeats boilerplate.
    Fully determined by ``seed`` — an A/B offers byte-identical prompts
    to both arms.
    """
    if n <= 0 or n_templates <= 0:
        raise ValueError(
            f"need n > 0 and n_templates > 0, got n={n} "
            f"n_templates={n_templates}"
        )
    rng = np.random.default_rng(seed)
    templates = [
        (
            rng.integers(0, vocab_size, size=header_len).tolist(),
            rng.integers(0, vocab_size, size=motif_len).tolist(),
        )
        for _ in range(n_templates)
    ]
    prompts = []
    for i in range(n):
        header, motif = templates[i % n_templates]
        body: List[int] = []
        for _ in range(rows):
            body += motif
            body += rng.integers(0, vocab_size, size=field_len).tolist()
        prompts.append(header + body)
    return prompts


def _fire_one(
    base: str,
    prompt: Sequence[int],
    max_new_tokens: int,
    temperature: float,
    timeout_s: float,
    t_submit: float,
) -> "tuple[str, Optional[float], int, Optional[Dict[str, Any]]]":
    """One ``/generate`` round-trip → (typed outcome, ttft, n_tokens,
    trace block).

    The typed-outcome contract shared by every HTTP load harness:
    ``completed`` / ``shed`` (429) / ``error:<kind>`` /
    ``failure:<ExcType>`` — exactly one outcome per request.  The trace
    block is the server's ``{"trace_id", "waterfalls"}`` response key
    (None when tracing is off or the request failed).
    """
    import json as json_mod
    import urllib.error
    import urllib.request

    payload = json_mod.dumps(
        {
            "prompts": [list(prompt)],
            "max_new_tokens": max_new_tokens,
            "temperature": temperature,
        }
    ).encode()
    req = urllib.request.Request(
        base + "/generate",
        data=payload,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            body = json_mod.loads(resp.read() or b"{}")
        n_tok = sum(len(t) for t in body.get("tokens") or [])
        server_ttfts = [
            t for t in (body.get("ttft_s") or []) if t is not None
        ]
        # Client-observed TTFT = queueing delay to the server plus
        # the server-side first-token latency it reports.
        ttft = (
            min(server_ttfts) if server_ttfts
            else time.perf_counter() - t_submit
        )
        trace = body.get("trace")
        return "completed", ttft, n_tok, (
            trace if isinstance(trace, dict) else None
        )
    except urllib.error.HTTPError as e:
        try:
            err = (json_mod.loads(e.read() or b"{}").get("error")) or {}
        except ValueError:
            err = {}
        kind = str(err.get("kind") or f"http_{e.code}")
        return ("shed" if e.code == 429 else f"error:{kind}"), None, 0, None
    except Exception as e:
        return f"failure:{type(e).__name__}", None, 0, None


def http_poisson_load(
    base_url: str,
    prompts: Sequence[Sequence[int]],
    max_new_tokens: int,
    *,
    rate_rps: float,
    temperature: float = 0.0,
    seed: int = 0,
    timeout_s: float = 600.0,
    kill_at_s: Optional[Dict[str, float]] = None,
    stall_at_s: Optional[Dict[str, float]] = None,
    fleet: Any = None,
) -> Dict[str, Any]:
    """Poisson load over HTTP against a router or a single ``lm_server``.

    The fleet analogue of :func:`poisson_load`, plus a seeded FAULT
    SCHEDULE: ``kill_at_s`` / ``stall_at_s`` map replica name → seconds
    after load start at which ``fleet.kill_replica`` /
    ``fleet.stall_replica`` fires — so "one replica dies mid-load" is a
    reproducible arm, not a flaky race.

    Per-request outcomes are typed, mirroring the router's error model:

    - ``completed`` — HTTP 200, all tokens;
    - ``shed`` — typed 429 (engine pool or router occupancy ceiling);
    - ``error:<kind>`` — any other typed HTTP error (exactly one per
      request — the zero-silent-drops contract);
    - ``failure`` — connection-level failure reaching the endpoint;
    - ``hang`` — no outcome within ``timeout_s`` (must be ZERO — a hang
      means a request was silently dropped).
    """
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be positive, got {rate_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=len(prompts))
    base = base_url.rstrip("/")

    outcomes: List[Optional[str]] = [None] * len(prompts)
    ttfts_by_idx: List[Optional[float]] = [None] * len(prompts)
    latencies: List[Optional[float]] = [None] * len(prompts)
    tokens_out = [0] * len(prompts)
    traces: List[Optional[Dict[str, Any]]] = [None] * len(prompts)

    def fire(i: int, prompt: Sequence[int], t_submit: float) -> None:
        outcome, ttft, n_tok, trace = _fire_one(
            base, prompt, max_new_tokens, temperature, timeout_s, t_submit
        )
        tokens_out[i] = n_tok
        ttfts_by_idx[i] = ttft
        outcomes[i] = outcome
        traces[i] = trace
        latencies[i] = time.perf_counter() - t_submit

    # Fault schedule: one timer thread per event, armed relative to load
    # start so the schedule is part of the (seeded) experiment.
    timers: List[threading.Timer] = []
    for name, at_s in (kill_at_s or {}).items():
        timers.append(threading.Timer(float(at_s), fleet.kill_replica, args=(name,)))
    for name, at_s in (stall_at_s or {}).items():
        timers.append(threading.Timer(float(at_s), fleet.stall_replica, args=(name,)))

    threads: List[threading.Thread] = []
    t_start = time.perf_counter()
    for t in timers:
        t.daemon = True
        t.start()
    try:
        for i, prompt in enumerate(prompts):
            time.sleep(float(gaps[i]))
            th = threading.Thread(
                target=fire,
                args=(i, prompt, time.perf_counter()),
                daemon=True,
            )
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=timeout_s)
    finally:
        for t in timers:
            t.cancel()
    wall = time.perf_counter() - t_start

    hangs = sum(1 for th in threads if th.is_alive())
    completed = sum(1 for o in outcomes if o == "completed")
    sheds = sum(1 for o in outcomes if o == "shed")
    errors = sum(1 for o in outcomes if o and o.startswith("error:"))
    failures = sum(1 for o in outcomes if o and o.startswith("failure:"))
    total_tokens = sum(tokens_out)
    ttfts = sorted(t for t in ttfts_by_idx if t is not None)
    return {
        "n_requests": len(prompts),
        "completed": completed,
        "sheds": sheds,
        "errors": errors,
        "failures": failures,
        "hangs": hangs,
        "offered_rps": round(float(rate_rps), 4),
        "wall_s": round(wall, 3),
        "tokens_per_s": round(total_tokens / wall, 1) if wall > 0 else 0.0,
        "total_tokens": total_tokens,
        "ttft_mean_s": round(float(np.mean(ttfts)), 6) if ttfts else 0.0,
        "ttft_p50_s": round(_pct(ttfts, 50), 6),
        "ttft_p95_s": round(_pct(ttfts, 95), 6),
        "ttft_p99_s": round(_pct(ttfts, 99), 6),
        "ttft_s": [
            round(t, 6) if t is not None else None for t in ttfts_by_idx
        ],
        "outcomes": list(outcomes),
        "trace_ids": [
            t.get("trace_id") if t is not None else None for t in traces
        ],
        "slow_requests": _slowest_traced(traces, latencies, n=5),
    }


def _slowest_traced(
    traces: "List[Optional[Dict[str, Any]]]",
    latencies: "List[Optional[float]]",
    *,
    n: int,
) -> List[Dict[str, Any]]:
    """The ``n`` slowest traced requests (by client-observed latency)
    with their server waterfalls — the load summary's "where did the
    tail go" exhibit.  Empty when the server traced nothing."""
    slow = []
    for trace, latency in zip(traces, latencies):
        if trace is None or latency is None:
            continue
        waterfalls = trace.get("waterfalls") or [None]
        slow.append(
            {
                "trace_id": trace.get("trace_id"),
                "request_id": (waterfalls[0] or {}).get("request_id"),
                "latency_s": round(latency, 6),
                "waterfall": (waterfalls[0] or {}).get("waterfall"),
            }
        )
    slow.sort(key=lambda e: e["latency_s"], reverse=True)
    return slow[:n]


class ChaosEvent:
    """One scheduled fault/traffic event on the chaos timeline.

    ``at_s`` seconds after load start, ``action`` one of:

    - ``kill`` — SIGKILL ``target`` (or the fleet's deterministic
      default victim) mid-whatever-it-was-doing;
    - ``stall`` — SIGSTOP: freeze with sockets open;
    - ``resume`` — SIGCONT a stalled replica (``target`` required);
    - ``burst`` — ``n`` extra back-to-back arrivals on top of the
      phase schedule (traffic chaos, not process chaos).
    """

    ACTIONS = ("kill", "stall", "resume", "burst")

    def __init__(
        self,
        at_s: float,
        action: str,
        *,
        target: Optional[str] = None,
        n: int = 0,
    ) -> None:
        if action not in self.ACTIONS:
            raise ValueError(f"unknown chaos action {action!r}")
        if action == "resume" and target is None:
            raise ValueError("resume requires an explicit target")
        if action == "burst" and n <= 0:
            raise ValueError("burst requires n > 0")
        self.at_s = float(at_s)
        self.action = action
        self.target = target
        self.n = int(n)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"ChaosEvent({self.at_s}, {self.action!r}, "
            f"target={self.target!r}, n={self.n})"
        )


def chaos_schedule(
    phases: Sequence["tuple[float, float]"],
    *,
    seed: int = 0,
    events: Sequence[ChaosEvent] = (),
) -> "List[tuple[float, int]]":
    """Expand a phased-rate schedule + burst events into the exact
    arrival timeline: a sorted list of ``(at_s, phase_idx)``.

    ``phases`` is ``[(duration_s, rate_rps), ...]``; within each phase
    arrivals are Poisson at that rate (rate 0 = idle phase, no
    arrivals), drawn entirely from ``seed`` — same (phases, seed,
    events) ⇒ byte-identical offered load, the property every chaos
    A/B leans on.  ``burst`` events inject ``n`` simultaneous arrivals
    at ``at_s``, tagged with the phase containing them.
    """
    rng = np.random.default_rng(seed)
    arrivals: List["tuple[float, int]"] = []
    t0 = 0.0
    bounds: List["tuple[float, float]"] = []
    for idx, (duration_s, rate_rps) in enumerate(phases):
        if duration_s <= 0:
            raise ValueError(f"phase {idx}: duration must be > 0")
        bounds.append((t0, t0 + duration_s))
        if rate_rps > 0:
            t = t0
            while True:
                t += float(rng.exponential(1.0 / rate_rps))
                if t >= t0 + duration_s:
                    break
                arrivals.append((t, idx))
        t0 += duration_s
    for ev in events:
        if ev.action != "burst":
            continue
        idx = next(
            (i for i, (lo, hi) in enumerate(bounds) if lo <= ev.at_s < hi),
            max(0, len(bounds) - 1),
        )
        arrivals.extend((ev.at_s, idx) for _ in range(ev.n))
    arrivals.sort()
    return arrivals


def chaos_poisson_load(
    base_url: str,
    prompts: Sequence[Sequence[int]],
    max_new_tokens: int,
    *,
    phases: Sequence["tuple[float, float]"],
    seed: int = 0,
    events: Sequence[ChaosEvent] = (),
    fleet: Any = None,
    pump: Any = None,
    pump_interval_s: float = 0.05,
    temperature: float = 0.0,
    timeout_s: float = 600.0,
) -> Dict[str, Any]:
    """Phased Poisson load composed with a seeded chaos timeline.

    The autoscaler's proving ground: ``phases`` shapes offered load
    over time (ramp → sustain → idle), ``events`` injects
    kill/stall/resume/burst chaos at fixed offsets, and ``pump`` (e.g.
    ``fleet.poll``) is called every ``pump_interval_s`` for the whole
    run — so the thread-free control loop (probes, drain advancement,
    autoscaler ticks) advances at a steady simulated monitor cadence
    while traffic flows.  Prompts are consumed round-robin in arrival
    order.

    Returns the :func:`http_poisson_load` typed-outcome contract
    (``completed + sheds + errors + failures + hangs == n_requests`` —
    zero silent drops) plus ``by_phase`` per-phase accounting.
    """
    base = base_url.rstrip("/")
    arrivals = chaos_schedule(phases, seed=seed, events=events)
    total_s = sum(d for d, _ in phases)
    n = len(arrivals)

    outcomes: List[Optional[str]] = [None] * n
    ttfts_by_idx: List[Optional[float]] = [None] * n
    tokens_out = [0] * n
    traces: List[Optional[Dict[str, Any]]] = [None] * n
    latencies: List[Optional[float]] = [None] * n
    phase_of = [idx for _, idx in arrivals]

    def fire(i: int, prompt: Sequence[int], t_submit: float) -> None:
        outcome, ttft, n_tok, trace = _fire_one(
            base, prompt, max_new_tokens, temperature, timeout_s, t_submit
        )
        tokens_out[i] = n_tok
        ttfts_by_idx[i] = ttft
        outcomes[i] = outcome
        traces[i] = trace
        latencies[i] = time.perf_counter() - t_submit

    def apply_event(ev: ChaosEvent) -> None:
        if fleet is None or ev.action == "burst":
            return
        target = ev.target
        if target is None:
            picker = getattr(fleet, "chaos_target", None)
            target = picker() if picker is not None else None
        if target is None:
            return
        try:
            if ev.action == "kill":
                fleet.kill_replica(target)
            elif ev.action == "stall":
                fleet.stall_replica(target)
            elif ev.action == "resume":
                fleet.resume_replica(target)
        except KeyError:
            pass  # victim already gone — chaos got there first

    # One merged timeline: arrivals and fault events fire in time
    # order off the same clock, with the pump ticking in between.
    timeline: List["tuple[float, int, Any]"] = [
        (at, 0, (i, prompts[i % len(prompts)])) for i, (at, _) in enumerate(arrivals)
    ]
    timeline.extend(
        (ev.at_s, 1, ev) for ev in events if ev.action != "burst"
    )
    timeline.sort(key=lambda item: (item[0], item[1]))

    threads: List[threading.Thread] = []
    t_start = time.perf_counter()
    last_pump = 0.0

    def tick_pump() -> None:
        nonlocal last_pump
        now = time.perf_counter() - t_start
        if pump is not None and now - last_pump >= pump_interval_s:
            last_pump = now
            try:
                pump()
            except Exception:  # pragma: no cover - pump must not kill load
                pass

    for at_s, _, item in timeline:
        while True:
            elapsed = time.perf_counter() - t_start
            if elapsed >= at_s:
                break
            time.sleep(min(pump_interval_s, at_s - elapsed))
            tick_pump()
        if isinstance(item, ChaosEvent):
            apply_event(item)
        else:
            i, prompt = item
            th = threading.Thread(
                target=fire,
                args=(i, prompt, time.perf_counter()),
                daemon=True,
            )
            th.start()
            threads.append(th)
        tick_pump()
    # Run out the remaining schedule (idle tail phases still need the
    # pump — that is where drain-down decisions happen), then wait for
    # stragglers, still pumping so in-flight control ops can finish.
    while time.perf_counter() - t_start < total_s:
        time.sleep(pump_interval_s)
        tick_pump()
    join_deadline = time.perf_counter() + timeout_s
    for th in threads:
        while th.is_alive() and time.perf_counter() < join_deadline:
            th.join(timeout=pump_interval_s)
            tick_pump()
    wall = time.perf_counter() - t_start

    hangs = sum(1 for th in threads if th.is_alive())
    completed = sum(1 for o in outcomes if o == "completed")
    sheds = sum(1 for o in outcomes if o == "shed")
    errors = sum(1 for o in outcomes if o and o.startswith("error:"))
    failures = sum(1 for o in outcomes if o and o.startswith("failure:"))
    total_tokens = sum(tokens_out)
    ttfts = sorted(t for t in ttfts_by_idx if t is not None)
    by_phase = []
    for idx in range(len(phases)):
        sel = [i for i in range(n) if phase_of[i] == idx]
        by_phase.append(
            {
                "n": len(sel),
                "completed": sum(
                    1 for i in sel if outcomes[i] == "completed"
                ),
                "sheds": sum(1 for i in sel if outcomes[i] == "shed"),
                "errors": sum(
                    1
                    for i in sel
                    if outcomes[i] and outcomes[i].startswith("error:")
                ),
                "failures": sum(
                    1
                    for i in sel
                    if outcomes[i] and outcomes[i].startswith("failure:")
                ),
            }
        )
    return {
        "n_requests": n,
        "completed": completed,
        "sheds": sheds,
        "errors": errors,
        "failures": failures,
        "hangs": hangs,
        "wall_s": round(wall, 3),
        "tokens_per_s": round(total_tokens / wall, 1) if wall > 0 else 0.0,
        "total_tokens": total_tokens,
        "ttft_mean_s": round(float(np.mean(ttfts)), 6) if ttfts else 0.0,
        "ttft_p50_s": round(_pct(ttfts, 50), 6),
        "ttft_p95_s": round(_pct(ttfts, 95), 6),
        "ttft_p99_s": round(_pct(ttfts, 99), 6),
        "by_phase": by_phase,
        "outcomes": list(outcomes),
        "trace_ids": [
            t.get("trace_id") if t is not None else None for t in traces
        ],
        "slow_requests": _slowest_traced(traces, latencies, n=5),
    }
