"""Fleet request router: health-aware balancing over ``lm_server`` replicas.

The port's own copy of ``polyaxon_tpu/serving/router.py`` (it imports no
torch: the router is control plane, and talks to replicas only over HTTP).
Replicas stay single-engine simple; everything fleet-shaped lives here:

- **readiness + occupancy balancing** — a background probe thread polls
  every replica's ``/healthz`` and ``/v1/stats``; routing considers only
  ``ready`` replicas and picks the least-loaded by slot occupancy +
  queue depth (+ the router's own in-flight count, so a burst between
  probes doesn't pile onto one replica);
- **prefix affinity** — the first ``affinity_tokens`` prompt ids are
  hashed rendezvous-style (md5, as the reference, so the same replica
  wins) over the ready set, so shared-prefix traffic lands on the replica
  whose ``PrefixCache`` already holds the blocks; when the affine replica
  is busier than the least-loaded alternative, its probed
  ``prefix_hit_rate`` decides how much load excess affinity is worth
  (``affinity_slack`` + hit_rate × ``affinity_hit_slack``); falls back to
  least-loaded beyond that slack or when the affine replica is saturated,
  draining, or ejected;
- **load shedding** — when the fleet-mean occupancy crosses
  ``shed_occupancy`` the router refuses admission with a typed 429
  (``error.kind == "overloaded"``) and a ``Retry-After`` header, same
  shape as the engine's own deadlock-shed;
- **bounded failover** — a connection error or replica death before the
  response is read is retried on a different replica up to
  ``retry_limit`` times.  This is safe because ``/generate`` admission
  is idempotent until the first token reaches the client (the response
  is unread, so re-running it elsewhere duplicates at most wasted
  decode, never client-visible output).  Exhausted retries return ONE
  typed error — never a hang;
- **ejection with exponential backoff** — ``eject_failures``
  consecutive probe/request failures eject a replica; re-admission is
  re-probed after a backoff that doubles per consecutive failed
  re-admission (capped), and a successful probe re-admits and resets it;
- **drain lifecycle** — ``drain(name)`` stops routing to a replica,
  lets in-flight requests finish (watched via probes + the router's own
  in-flight count), and marks it ``drained`` at completion or at a
  deadline; the fleet layer (``serving/fleet.py``) turns that into
  stop-old/launch-replacement.

Every state transition lands on the stats backend
(``fleet_replica_state{replica}`` gauge; ``router_sheds_total`` /
``router_retries_total`` / ``router_ejections_total`` counters) so
``/metrics`` sees the same truth.
"""

from __future__ import annotations

import hashlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.client import HTTPException
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Dict, List, Optional, Sequence

from polyaxon_tpu_torch.conf.knobs import knob_bool, knob_float, knob_int
from polyaxon_tpu_torch.stats import MemoryStats
from polyaxon_tpu_torch.stats.metrics import (
    PROMETHEUS_CONTENT_TYPE,
    labeled_key,
    render_prometheus,
    render_standard_gauges,
)
from polyaxon_tpu_torch.tracking.trace import (
    TraceContext,
    chrome_trace,
    extract,
    get_tracer,
    inject,
    new_trace_id,
)

__all__ = ["FleetRouter", "Replica", "RouterError", "make_router_handler"]

#: Replica lifecycle states (the ``fleet_replica_state`` gauge encodes
#: them in this order).
STATES = ("warming", "ready", "draining", "ejected", "drained", "dead")
_STATE_CODE = {s: i for i, s in enumerate(STATES)}


class RouterError(RuntimeError):
    """A typed routing refusal/failure: HTTP status + machine-readable
    ``kind`` (+ optional ``Retry-After`` seconds for shed responses)."""

    def __init__(
        self,
        kind: str,
        message: str,
        *,
        status: int = 503,
        retry_after_s: Optional[float] = None,
    ) -> None:
        super().__init__(message)
        self.kind = kind
        self.status = int(status)
        self.retry_after_s = retry_after_s

    def payload(self) -> Dict[str, Any]:
        return {"error": {"kind": self.kind, "message": str(self)}}


class Replica:
    """One tracked backend: probe-derived health + router-side load."""

    def __init__(self, name: str, base_url: str) -> None:
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.state = "warming"
        #: Probe-derived engine load (slots_active, queue_depth, slots).
        self.slots = 1
        self.slots_active = 0
        self.queue_depth = 0
        self.prefix_hit_rate = 0.0
        #: Requests this router currently has in flight against it —
        #: fresher than the last probe, so bursts spread correctly.
        self.inflight = 0
        self.requests = 0
        self.consecutive_failures = 0
        #: Consecutive failed re-admission probes since ejection — the
        #: exponent of the re-admission backoff.
        self.eject_streak = 0
        self.ejected_until = 0.0
        self.drain_deadline: Optional[float] = None
        self.drain_started: Optional[float] = None
        self.last_probe_at = 0.0
        self.last_error: Optional[str] = None
        #: Full ``/v1/stats`` body from the last successful probe — the
        #: scrape phase reads history off it instead of re-connecting.
        self.last_stats: Dict[str, Any] = {}

    def load(self) -> float:
        """Occupancy estimate in [0, inf): probed engine load plus the
        router's own unprobed in-flight delta, per slot."""
        engine_busy = self.slots_active + self.queue_depth
        # inflight requests already visible in the probe are counted
        # once: take the max, not the sum, of the two views.
        busy = max(engine_busy, self.inflight)
        return busy / max(1, self.slots)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "base_url": self.base_url,
            "state": self.state,
            "slots": self.slots,
            "slots_active": self.slots_active,
            "queue_depth": self.queue_depth,
            "load": round(self.load(), 4),
            "inflight": self.inflight,
            "requests": self.requests,
            "consecutive_failures": self.consecutive_failures,
            "eject_streak": self.eject_streak,
            "ejected_until": self.ejected_until,
            "prefix_cache_hit_rate": self.prefix_hit_rate,
            "last_error": self.last_error,
        }


def _http_json(
    url: str,
    payload: Optional[Dict[str, Any]] = None,
    *,
    timeout: float,
    headers: Optional[Dict[str, str]] = None,
) -> "tuple[int, Dict[str, Any]]":
    """One JSON round-trip; HTTP error statuses return (code, body),
    connection-level failures raise OSError/HTTPException."""
    data = None
    all_headers = dict(headers or {})
    if payload is not None:
        data = json.dumps(payload).encode()
        all_headers["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, headers=all_headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read() or b"{}")
        except ValueError:
            body = {}
        return e.code, body


class FleetRouter:
    """Routes ``/generate`` traffic across N ``lm_server`` replicas.

    All thresholds default from the ``POLYAXON_TPU_ROUTER_*`` knobs;
    constructor arguments override them (tests shrink the timescales,
    production reads the env).
    """

    def __init__(
        self,
        *,
        stats: Any = None,
        probe_interval_s: Optional[float] = None,
        probe_timeout_s: Optional[float] = None,
        request_timeout_s: Optional[float] = None,
        shed_occupancy: Optional[float] = None,
        retry_after_s: Optional[float] = None,
        retry_limit: Optional[int] = None,
        eject_failures: Optional[int] = None,
        eject_backoff_s: Optional[float] = None,
        eject_backoff_max_s: Optional[float] = None,
        affinity_tokens: Optional[int] = None,
        affinity_slack: Optional[float] = None,
        affinity_hit_slack: Optional[float] = None,
        on_drained: Optional[Callable[[str, bool], None]] = None,
    ) -> None:
        self.metrics = stats if stats is not None else MemoryStats()
        self.probe_interval_s = (
            probe_interval_s
            if probe_interval_s is not None
            else knob_float("POLYAXON_TPU_ROUTER_PROBE_INTERVAL_S")
        )
        self.probe_timeout_s = (
            probe_timeout_s
            if probe_timeout_s is not None
            else knob_float("POLYAXON_TPU_ROUTER_PROBE_TIMEOUT_S")
        )
        self.request_timeout_s = (
            request_timeout_s
            if request_timeout_s is not None
            else knob_float("POLYAXON_TPU_ROUTER_REQUEST_TIMEOUT_S")
        )
        self.shed_occupancy = (
            shed_occupancy
            if shed_occupancy is not None
            else knob_float("POLYAXON_TPU_ROUTER_SHED_OCCUPANCY")
        )
        self.retry_after_s = (
            retry_after_s
            if retry_after_s is not None
            else knob_float("POLYAXON_TPU_ROUTER_RETRY_AFTER_S")
        )
        self.retry_limit = (
            retry_limit
            if retry_limit is not None
            else knob_int("POLYAXON_TPU_ROUTER_RETRY_LIMIT")
        )
        self.eject_failures = (
            eject_failures
            if eject_failures is not None
            else knob_int("POLYAXON_TPU_ROUTER_EJECT_FAILURES")
        )
        self.eject_backoff_s = (
            eject_backoff_s
            if eject_backoff_s is not None
            else knob_float("POLYAXON_TPU_ROUTER_EJECT_BACKOFF_S")
        )
        self.eject_backoff_max_s = (
            eject_backoff_max_s
            if eject_backoff_max_s is not None
            else knob_float("POLYAXON_TPU_ROUTER_EJECT_BACKOFF_MAX_S")
        )
        self.affinity_tokens = (
            affinity_tokens
            if affinity_tokens is not None
            else knob_int("POLYAXON_TPU_ROUTER_AFFINITY_TOKENS")
        )
        self.affinity_slack = (
            affinity_slack
            if affinity_slack is not None
            else knob_float("POLYAXON_TPU_ROUTER_AFFINITY_SLACK")
        )
        self.affinity_hit_slack = (
            affinity_hit_slack
            if affinity_hit_slack is not None
            else knob_float("POLYAXON_TPU_ROUTER_AFFINITY_HIT_SLACK")
        )
        self.on_drained = on_drained
        #: Request tracing: when on, every proxied /generate gets a root
        #: span + per-attempt child spans, and the traceparent rides the
        #: upstream hop so replica/engine spans join the same trace.
        self.trace_requests = knob_bool("POLYAXON_TPU_TRACE_REQUESTS")
        self._replicas: Dict[str, Replica] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Lifetime counters, mirrored onto the stats backend for /metrics.
        self.counters = {
            "requests": 0,
            "sheds": 0,
            "retries": 0,
            "failovers": 0,
            "ejections": 0,
            "readmissions": 0,
            "drains": 0,
            "upstream_errors": 0,
        }

    # -- membership -----------------------------------------------------------
    def add_replica(self, name: str, base_url: str) -> Replica:
        with self._lock:
            rep = Replica(name, base_url)
            self._replicas[name] = rep
        self._set_state(rep, "warming")
        return rep

    def remove_replica(self, name: str) -> None:
        with self._lock:
            self._replicas.pop(name, None)

    def replica(self, name: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(name)

    def replica_names(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._probe_loop, name="fleet-router-probe", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- probing / health -----------------------------------------------------
    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self.probe_all()
            except Exception:  # pragma: no cover - probe must never die
                pass

    def probe_all(self, now: Optional[float] = None) -> None:
        """One probe pass over every replica (also callable synchronously
        from tests — the loop thread only calls it)."""
        now = now if now is not None else time.time()
        for name in self.replica_names():
            rep = self.replica(name)
            if rep is None:
                continue
            if rep.state == "ejected" and now < rep.ejected_until:
                continue  # still backing off
            if rep.state == "drained":
                continue
            self.probe_one(rep, now)
        self._advance_drains(now)

    def probe_one(self, rep: Replica, now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()
        rep.last_probe_at = now
        try:
            code, health = _http_json(
                rep.base_url + "/healthz", timeout=self.probe_timeout_s
            )
            if code != 200:
                raise OSError(f"/healthz returned {code}")
            _, stats = _http_json(
                rep.base_url + "/v1/stats", timeout=self.probe_timeout_s
            )
        except (OSError, HTTPException, ValueError) as e:
            self._note_failure(rep, f"probe: {type(e).__name__}: {e}", now)
            return
        with self._lock:
            rep.consecutive_failures = 0
            rep.slots = int(stats.get("slots") or 1)
            rep.slots_active = int(stats.get("slots_active") or 0)
            rep.queue_depth = int(stats.get("queue_depth") or 0)
            rep.prefix_hit_rate = float(
                stats.get("prefix_cache_hit_rate") or 0.0
            )
            rep.last_stats = dict(stats)
            rep.last_error = None
        engine_state = str(health.get("state") or "ready")
        if rep.state == "ejected":
            self.counters["readmissions"] += 1
            self._incr("router_readmissions_total")
            rep.eject_streak = 0
        if rep.state in ("draining",):
            # Drain status is router-owned; probes only refresh load.
            return
        self._set_state(
            rep, "draining" if engine_state == "draining" else (
                "ready" if engine_state == "ready" else "warming"
            )
        )

    def note_request_failure(self, rep: Replica, error: str) -> None:
        """A proxied request failed at the connection level — counts
        toward ejection exactly like a failed probe."""
        self._note_failure(rep, error, time.time())

    def _note_failure(self, rep: Replica, error: str, now: float) -> None:
        with self._lock:
            rep.last_error = error
            rep.consecutive_failures += 1
            failures = rep.consecutive_failures
            was_ejected = rep.state == "ejected"
        if was_ejected:
            # A failed re-admission probe: double the backoff window.
            with self._lock:
                rep.eject_streak += 1
                rep.ejected_until = now + min(
                    self.eject_backoff_max_s,
                    self.eject_backoff_s * (2 ** rep.eject_streak),
                )
            return
        if rep.state == "warming":
            # A replica that was NEVER ready isn't "ejected" — it is
            # still booting (probes hit a socket nobody listens on
            # yet).  It stays warming (clients see 503 "warming", not
            # "unavailable") and keeps being probed every interval.
            return
        if failures >= self.eject_failures and rep.state != "drained":
            with self._lock:
                rep.eject_streak = 0
                rep.ejected_until = now + self.eject_backoff_s
            self.counters["ejections"] += 1
            self._incr("router_ejections_total")
            self._set_state(rep, "ejected")

    # -- drain ----------------------------------------------------------------
    def drain(self, name: str, deadline_s: Optional[float] = None) -> bool:
        """Stop routing to ``name``; in-flight requests finish (bounded
        by ``deadline_s``).  Returns False for unknown replicas."""
        rep = self.replica(name)
        if rep is None:
            return False
        now = time.time()
        with self._lock:
            rep.drain_started = now
            rep.drain_deadline = (
                now + deadline_s if deadline_s is not None else None
            )
        self.counters["drains"] += 1
        self._incr("router_drains_total")
        self._set_state(rep, "draining")
        return True

    def is_drained(self, name: str) -> bool:
        rep = self.replica(name)
        return rep is not None and rep.state == "drained"

    def _advance_drains(self, now: float) -> None:
        for name in self.replica_names():
            rep = self.replica(name)
            if rep is None or rep.state != "draining":
                continue
            timed_out = (
                rep.drain_deadline is not None and now > rep.drain_deadline
            )
            idle = (
                rep.inflight == 0
                and rep.slots_active == 0
                and rep.queue_depth == 0
            )
            # An unreachable draining replica is as drained as it will
            # ever get — don't wait the full deadline on a corpse.
            if idle and rep.consecutive_failures >= self.eject_failures:
                timed_out = True
            if idle and rep.drain_started is not None:
                # Require one probe newer than the drain start so a
                # stale pre-drain stats snapshot can't declare victory.
                if rep.last_probe_at <= rep.drain_started and not timed_out:
                    continue
            if idle or timed_out:
                self._set_state(rep, "drained")
                cb = self.on_drained
                if cb is not None:
                    try:
                        cb(rep.name, timed_out and not idle)
                    except Exception:  # pragma: no cover - callback guard
                        pass

    # -- selection ------------------------------------------------------------
    def _prefix_key(self, prompt: Sequence[int]) -> Optional[bytes]:
        if self.affinity_tokens <= 0 or not prompt:
            return None
        head = ",".join(str(int(t)) for t in prompt[: self.affinity_tokens])
        return head.encode()

    def _affine(
        self, prompt: Sequence[int], ready: List[Replica]
    ) -> Optional[Replica]:
        """Rendezvous hash of the prompt prefix over the ready set —
        stable under membership churn (losing a replica only remaps the
        keys that pointed at it)."""
        key = self._prefix_key(prompt)
        if key is None:
            return None
        best, best_score = None, b""
        for rep in ready:
            score = hashlib.md5(key + b"|" + rep.name.encode()).digest()
            if best is None or score > best_score:
                best, best_score = rep, score
        return best

    def select(
        self,
        prompt: Sequence[int],
        exclude: Optional[set] = None,
    ) -> Replica:
        """Pick a replica for ``prompt`` (and count it in-flight), or
        raise a typed :class:`RouterError`:

        - 503 ``warming`` — replicas exist but none has reached ready
          (a booting fleet is not overloaded — clients should not back
          off the way a 429 tells them to);
        - 503 ``no_replicas`` — the fleet is EMPTY of live capacity:
          no replicas at all, or every replica ejected/dead/drained.
          Distinct from the retry-exhausted 502 ``upstream_error``
          (requests were attempted and failed) — here nothing was ever
          attemptable;
        - 503 ``unavailable`` — no ready replica right now, but at
          least one is draining (in-flight work still finishing);
        - 429 ``overloaded`` — fleet-mean occupancy at/over the ceiling.
        """
        exclude = exclude or set()
        with self._lock:
            candidates = [
                r
                for r in self._replicas.values()
                if r.name not in exclude
            ]
            ready = [r for r in candidates if r.state == "ready"]
            if not ready:
                if not candidates or all(
                    r.state in ("ejected", "dead", "drained")
                    for r in candidates
                ):
                    raise RouterError(
                        "no_replicas",
                        "fleet has no live replicas"
                        + (
                            " (all ejected, dead, or drained)"
                            if candidates
                            else ""
                        ),
                        status=503,
                    )
                if any(r.state == "warming" for r in candidates):
                    raise RouterError(
                        "warming",
                        "all replicas are still warming",
                        status=503,
                        retry_after_s=self.retry_after_s,
                    )
                raise RouterError(
                    "unavailable",
                    "no ready replica (draining in progress)",
                    status=503,
                    retry_after_s=self.retry_after_s,
                )
            fleet_load = sum(min(1.0, r.load()) for r in ready) / len(ready)
            if fleet_load >= self.shed_occupancy:
                self.counters["sheds"] += 1
                self._incr("router_sheds_total")
                raise RouterError(
                    "overloaded",
                    f"fleet occupancy {fleet_load:.2f} >= "
                    f"{self.shed_occupancy:.2f} (request shed)",
                    status=429,
                    retry_after_s=self.retry_after_s,
                )
            affine = self._affine(prompt, ready)
            rep = min(ready, key=lambda r: r.load())
            if affine is not None and affine.load() < 1.0:
                # Prefix-hit-aware affinity: a warm-but-busy affine
                # replica is worth routing into only in proportion to
                # how warm it actually is — its probed prefix_hit_rate
                # buys extra slack over the least-loaded alternative
                # (a cold replica gets only the base slack, so affinity
                # can still bootstrap a cache).
                slack = (
                    self.affinity_slack
                    + affine.prefix_hit_rate * self.affinity_hit_slack
                )
                if affine.load() - rep.load() <= slack:
                    rep = affine
            rep.inflight += 1
            rep.requests += 1
            return rep

    # -- request proxying ------------------------------------------------------
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: Optional[int] = None,
        temperature: float = 0.0,
        timeout_s: Optional[float] = None,
        trace: Optional[TraceContext] = None,
    ) -> Dict[str, Any]:
        """Proxy one ``/generate`` call with bounded failover.

        All prompts in the call land on ONE replica (affinity is keyed
        on the first prompt).  Connection-level failures fail over to a
        different replica up to ``retry_limit`` times; replica HTTP
        errors come back as typed :class:`RouterError`.  The response
        dict gains ``replica`` and ``retries`` keys.

        When tracing is on, ``trace`` (an inbound client context) or a
        fresh trace id covers the WHOLE call: one ``router.request``
        root span, one ``router.attempt`` child per upstream try — so a
        failover shows every attempt on the same timeline — and the
        traceparent is injected on each hop so replica-side spans join
        the trace.  The response's ``trace`` block gains the trace id.
        """
        timeout = timeout_s if timeout_s is not None else self.request_timeout_s
        payload: Dict[str, Any] = {
            "prompts": [list(p) for p in prompts],
            "temperature": temperature,
        }
        if max_new_tokens is not None:
            payload["max_new_tokens"] = max_new_tokens
        self.counters["requests"] += 1
        self._incr("router_requests_total")
        ctx: Optional[TraceContext] = None
        if self.trace_requests:
            ctx = trace if trace is not None else TraceContext(new_trace_id())
            if not ctx.sampled:
                ctx = None
        if ctx is None:
            return self._attempt_loop(prompts, payload, timeout, None)
        with get_tracer().span(
            "router.request",
            sample=1.0,
            trace_id=ctx.trace_id,
            parent_id=ctx.span_id or None,
            process="router",
            prompts=len(prompts),
        ) as root:
            body = self._attempt_loop(
                prompts, payload, timeout, ctx.child(root.span_id)
            )
        trace_block = body.setdefault("trace", {})
        trace_block["trace_id"] = ctx.trace_id
        return body

    def _attempt_loop(
        self,
        prompts: Sequence[Sequence[int]],
        payload: Dict[str, Any],
        timeout: float,
        ctx: Optional[TraceContext],
    ) -> Dict[str, Any]:
        """The bounded-failover loop behind :meth:`generate`.

        ``ctx``, when given, is parented to the ``router.request`` root
        span; each try wraps its upstream hop in a ``router.attempt``
        span and injects a context parented to THAT span, so the merged
        timeline nests client → router → attempt → replica.
        """
        tracer = get_tracer()
        tried: set = set()
        last_error = "no attempt made"
        for attempt in range(self.retry_limit + 1):
            try:
                rep = self.select(prompts[0] if prompts else (), exclude=tried)
            except RouterError as e:
                if tried and e.kind in ("no_replicas", "unavailable", "warming"):
                    # Nothing left to fail over to: report the FAULT
                    # (what broke the attempts), not the empty set the
                    # exclusions produced.
                    raise RouterError(
                        "upstream_error",
                        f"all {len(tried)} attempted replica(s) failed "
                        f"(last: {last_error})",
                        status=502,
                    )
                raise
            try:
                headers: Dict[str, str] = {}
                if ctx is not None:
                    with tracer.span(
                        "router.attempt",
                        sample=1.0,
                        trace_id=ctx.trace_id,
                        parent_id=ctx.span_id or None,
                        process="router",
                        replica=rep.name,
                        attempt=attempt,
                    ) as asp:
                        inject(ctx.child(asp.span_id), headers)
                        code, body = _http_json(
                            rep.base_url + "/generate",
                            payload,
                            timeout=timeout,
                            headers=headers,
                        )
                        asp.set(status=code)
                else:
                    code, body = _http_json(
                        rep.base_url + "/generate", payload, timeout=timeout
                    )
            except socket.timeout:
                # The replica is alive but slow — retrying elsewhere
                # would double the load that made it slow.
                raise RouterError(
                    "upstream_timeout",
                    f"replica {rep.name} exceeded {timeout:.0f}s",
                    status=504,
                )
            except (OSError, HTTPException, ValueError) as e:
                # Connection refused/reset, mid-response death: the
                # client saw nothing, so replay on another replica.
                tried.add(rep.name)
                last_error = f"{type(e).__name__}: {e}"
                self.note_request_failure(rep, last_error)
                self.counters["retries"] += 1
                self._incr("router_retries_total")
                continue
            finally:
                with self._lock:
                    rep.inflight = max(0, rep.inflight - 1)
            if code == 200:
                if attempt > 0:
                    self.counters["failovers"] += 1
                    self._incr("router_failovers_total")
                body["replica"] = rep.name
                body["retries"] = attempt
                return body
            err = body.get("error") or {}
            if not isinstance(err, dict):
                err = {"kind": "upstream_error", "message": str(err)}
            kind = str(err.get("kind") or "upstream_error")
            if code == 429:
                # The ENGINE shed (pool exhaustion) — propagate the
                # typed 429 verbatim; it is load signal, not a fault.
                self.counters["sheds"] += 1
                self._incr("router_sheds_total")
                raise RouterError(
                    "shed",
                    str(err.get("message") or "request shed by replica"),
                    status=429,
                    retry_after_s=self.retry_after_s,
                )
            self.counters["upstream_errors"] += 1
            self._incr("router_upstream_errors_total")
            raise RouterError(
                kind,
                f"replica {rep.name}: "
                f"{err.get('message') or f'HTTP {code}'}",
                status=502 if code >= 500 else code,
            )
        raise RouterError(
            "upstream_error",
            f"all {len(tried)} attempted replica(s) failed "
            f"(last: {last_error})",
            status=502,
        )

    # -- introspection ---------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            reps = {name: r.snapshot() for name, r in self._replicas.items()}
        by_state: Dict[str, int] = {}
        for r in reps.values():
            by_state[r["state"]] = by_state.get(r["state"], 0) + 1
        requests = self.counters["requests"]
        return {
            "replicas": reps,
            "by_state": by_state,
            "n_ready": by_state.get("ready", 0),
            "counters": dict(self.counters),
            "shed_rate": (
                round(self.counters["sheds"] / requests, 4) if requests else 0.0
            ),
            "shed_occupancy": self.shed_occupancy,
        }

    def replica_stats(self) -> Dict[str, Dict[str, Any]]:
        """Each replica's full ``/v1/stats`` body from its last
        successful probe — the scrape phase's per-replica series source
        (no new connections; a never-probed replica is absent)."""
        with self._lock:
            return {
                name: dict(r.last_stats)
                for name, r in self._replicas.items()
                if r.last_stats
            }

    def merged_trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """All spans of one trace, fleet-wide, as a Perfetto-loadable dict.

        Merges the router's own ring buffer with each replica's
        ``GET /v1/trace/<trace_id>`` response; the chrome-trace export
        keys process rows by span ``process`` label, so router and every
        replica land on distinct named tracks of one timeline.  Returns
        None when no process holds any span for the id (expired from
        the ring buffers, or never sampled).
        """
        spans = [
            s
            for s in get_tracer().spans()
            if s.get("trace_id") == trace_id
        ]
        with self._lock:
            urls = [r.base_url for r in self._replicas.values()]
        for base_url in urls:
            try:
                code, body = _http_json(
                    base_url + "/v1/trace/" + trace_id,
                    timeout=self.probe_timeout_s,
                )
            except (OSError, HTTPException, ValueError):
                continue  # a dead replica must not break the merge
            if code == 200 and isinstance(body.get("spans"), list):
                spans.extend(body["spans"])
        if not spans:
            return None
        spans.sort(key=lambda s: s.get("start", 0.0))
        return {
            "trace_id": trace_id,
            "spans": spans,
            "chrome_trace": chrome_trace(spans),
        }

    # -- stats plumbing --------------------------------------------------------
    def _incr(self, key: str) -> None:
        try:
            self.metrics.incr(key)
        except Exception:  # pragma: no cover - stats must never raise
            pass

    def _set_state(self, rep: Replica, state: str) -> None:
        with self._lock:
            rep.state = state
        try:
            self.metrics.gauge(
                labeled_key("fleet_replica_state", replica=rep.name),
                float(_STATE_CODE.get(state, -1)),
            )
        except Exception:  # pragma: no cover - stats must never raise
            pass


def make_router_handler(router: FleetRouter, meta: Optional[dict] = None):
    """HTTP front-end over a :class:`FleetRouter` — the same route shape
    as ``lm_server`` so clients cannot tell one replica from a fleet:
    ``POST /generate``, ``GET /healthz``, ``GET /v1/stats``,
    ``GET /metrics``.  Typed errors carry ``error.kind`` and shed
    responses carry ``Retry-After``."""
    meta = meta or {}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, code, payload, headers=None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _router_error(self, e: RouterError):
            headers = {}
            if e.retry_after_s is not None:
                headers["Retry-After"] = str(int(max(1, e.retry_after_s)))
            return self._json(e.status, e.payload(), headers)

        def do_GET(self):
            if self.path == "/v1/stats":
                return self._json(200, router.stats())
            if self.path.startswith("/v1/trace/"):
                trace_id = self.path[len("/v1/trace/"):]
                merged = router.merged_trace(trace_id) if trace_id else None
                if merged is None:
                    return self._json(
                        404,
                        {
                            "error": {
                                "kind": "not_found",
                                "message": f"no spans for trace {trace_id!r}",
                            }
                        },
                    )
                return self._json(200, merged)
            if self.path == "/metrics":
                snapshot_fn = getattr(router.metrics, "snapshot", None)
                if snapshot_fn is None:
                    text = "# router stats backend keeps no registry\n"
                else:
                    text = render_prometheus(
                        snapshot_fn(), labels={"component": "router"}
                    )
                text += render_standard_gauges(labels={"component": "router"})
                body = text.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                return self.wfile.write(body)
            if self.path not in ("/healthz", "/"):
                return self._json(
                    404, {"error": {"kind": "not_found", "message": "not found"}}
                )
            st = router.stats()
            state = (
                "ready"
                if st["n_ready"]
                else "warming" if st["by_state"].get("warming") else "unavailable"
            )
            return self._json(
                200,
                {
                    "ok": bool(st["n_ready"]),
                    "state": state,
                    "fleet": st["by_state"],
                    **meta,
                },
            )

        def do_POST(self):
            if self.path != "/generate":
                return self._json(
                    404, {"error": {"kind": "not_found", "message": "not found"}}
                )
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompts = req["prompts"]
                if not prompts or not isinstance(prompts[0], list):
                    raise ValueError("prompts must be a list of id lists")
                max_new = req.get("max_new_tokens")
                temperature = float(req.get("temperature", 0.0))
            except (KeyError, ValueError, TypeError) as e:
                return self._json(
                    400, {"error": {"kind": "bad_request", "message": str(e)}}
                )
            try:
                body = router.generate(
                    prompts,
                    int(max_new) if max_new is not None else None,
                    temperature,
                    # Malformed/missing traceparent → None → fresh trace;
                    # a client header must never turn into a 500.
                    trace=extract(self.headers),
                )
            except RouterError as e:
                return self._router_error(e)
            return self._json(200, body)

    return Handler
