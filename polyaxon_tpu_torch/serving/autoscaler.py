"""Fleet autoscaler: shed/occupancy-driven ``N → N±1`` serving resizes.

The port's own copy of ``polyaxon_tpu/serving/autoscaler.py``, whole: the
closed loop that *changes N* without an operator.  A
:class:`FleetAutoscaler` rides the fleet's thread-free pump
(``LocalServingFleet.poll``): every ``evaluate()`` samples the router's
lifetime counters and per-replica occupancy, and drives exactly one
resize operation at a time through the fleet's own machinery:

- **scale-up** — the windowed shed fraction (Δsheds/Δrequests between
  ticks) holds at/above ``POLYAXON_TPU_AUTOSCALER_SHED_RATE`` for
  ``UP_HOLD_S``: submit one replica through the fleet's registry-run
  path (``fleet.scale_up()``).  The decision only *succeeds* when the
  router's probe machinery walks the newcomer through ``warming →
  ready`` — a submitted-but-stuck replica FAILs the decision at the
  fleet ready timeout and is retired, so the autoscaler never counts
  capacity the router cannot route to.
- **drain-down** — fleet-mean ready occupancy holds below
  ``IDLE_OCCUPANCY`` (with zero sheds in the window) for
  ``DOWN_HOLD_S``: drain the *idlest* ready replica via the router's
  drain path (router stops routing, in-flight requests finish bounded
  by the fleet drain deadline), then retire it.  Never below
  ``MIN_REPLICAS``.
- **capacity repair** — membership fell below the committed target (a
  replica died and the fleet reaped it): submit a replacement without
  waiting for a shed signal, because when nothing is ready there are
  no sheds to rate.  Repair respects only the up-cooldown (bounding
  crash-loop churn) and the budget.

Oscillation control is layered: *hysteresis* (the signal must hold,
not spike), *per-direction cooldowns* (``UP_COOLDOWN_S`` /
``DOWN_COOLDOWN_S``), and *flap suppression* (a completed scale-up
re-arms the down cooldown, so the capacity just added cannot be
drained by the quiet moment it created; scale-up after a drain-down
stays fast — availability beats parsimony).  The remediation budget is
a hard cap: once ``BUDGET`` non-skipped decisions have fired the
autoscaler records one SKIPPED row and goes inert.

Every decision is a ``scale_up`` / ``scale_down`` remediation row on
the affected replica's run (phases ``submitted → ready`` /
``draining → stopped`` on the timeline), an
``autoscaler_decision_total{direction,outcome}`` counter, and a
``fleet_target_replicas`` gauge — the same observability contract as
every other control-plane reflex.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from polyaxon_tpu_torch.conf.knobs import knob_bool, knob_float, knob_int
from polyaxon_tpu_torch.db.registry import RemediationStatus
from polyaxon_tpu_torch.stats.metrics import labeled_key
from polyaxon_tpu_torch.stats.tsdb import RatioWindow

__all__ = ["FleetAutoscaler"]


class FleetAutoscaler:
    """Evaluates resize decisions for one fleet; strictly thread-free.

    ``fleet`` must provide the resize protocol: ``router``,
    ``scale_up() -> name``, ``retire_replica(name)``,
    ``run_id_for(name) -> Optional[int]``, and optionally
    ``orch.registry`` (remediation rows are skipped without one — the
    :class:`LocalServingFleet` chaos harness has no control plane).
    Constructor arguments override the ``POLYAXON_TPU_AUTOSCALER_*``
    knobs, test-style.
    """

    def __init__(
        self,
        fleet: Any,
        *,
        enabled: Optional[bool] = None,
        shed_rate: Optional[float] = None,
        idle_occupancy: Optional[float] = None,
        min_replicas: Optional[int] = None,
        max_replicas: Optional[int] = None,
        up_hold_s: Optional[float] = None,
        down_hold_s: Optional[float] = None,
        up_cooldown_s: Optional[float] = None,
        down_cooldown_s: Optional[float] = None,
        budget: Optional[int] = None,
        ready_timeout_s: Optional[float] = None,
        drain_deadline_s: Optional[float] = None,
    ) -> None:
        self.fleet = fleet
        self.router = fleet.router
        self.enabled = (
            enabled
            if enabled is not None
            else knob_bool("POLYAXON_TPU_AUTOSCALER_ENABLED")
        )
        self.shed_rate = (
            shed_rate
            if shed_rate is not None
            else knob_float("POLYAXON_TPU_AUTOSCALER_SHED_RATE")
        )
        self.idle_occupancy = (
            idle_occupancy
            if idle_occupancy is not None
            else knob_float("POLYAXON_TPU_AUTOSCALER_IDLE_OCCUPANCY")
        )
        self.min_replicas = (
            min_replicas
            if min_replicas is not None
            else knob_int("POLYAXON_TPU_AUTOSCALER_MIN_REPLICAS")
        )
        self.max_replicas = (
            max_replicas
            if max_replicas is not None
            else knob_int("POLYAXON_TPU_AUTOSCALER_MAX_REPLICAS")
        )
        self.up_hold_s = (
            up_hold_s
            if up_hold_s is not None
            else knob_float("POLYAXON_TPU_AUTOSCALER_UP_HOLD_S")
        )
        self.down_hold_s = (
            down_hold_s
            if down_hold_s is not None
            else knob_float("POLYAXON_TPU_AUTOSCALER_DOWN_HOLD_S")
        )
        self.up_cooldown_s = (
            up_cooldown_s
            if up_cooldown_s is not None
            else knob_float("POLYAXON_TPU_AUTOSCALER_UP_COOLDOWN_S")
        )
        self.down_cooldown_s = (
            down_cooldown_s
            if down_cooldown_s is not None
            else knob_float("POLYAXON_TPU_AUTOSCALER_DOWN_COOLDOWN_S")
        )
        if budget is None:
            budget = knob_int("POLYAXON_TPU_AUTOSCALER_BUDGET")
            if budget <= 0:
                budget = knob_int("POLYAXON_TPU_REMEDIATION_BUDGET")
        self.budget = budget
        self.ready_timeout_s = (
            ready_timeout_s
            if ready_timeout_s is not None
            else getattr(
                fleet,
                "ready_timeout_s",
                knob_float("POLYAXON_TPU_FLEET_READY_TIMEOUT_S"),
            )
        )
        self.drain_deadline_s = (
            drain_deadline_s
            if drain_deadline_s is not None
            else getattr(
                fleet,
                "drain_deadline_s",
                knob_float("POLYAXON_TPU_FLEET_DRAIN_DEADLINE_S"),
            )
        )
        self.fleet_name = str(getattr(fleet, "name", "local"))
        #: Windowed sheds/requests counter pair — rates are taken over a
        #: short smoothing window, not a single tick (sparse traffic
        #: would otherwise zero the rate on every empty tick).  Shared
        #: code path with the SLO burn windows (stats.tsdb).
        self._shed_window = RatioWindow(self.up_hold_s / 2.0)
        self._window_req = 0
        #: When the current overload / idle episode started (None = the
        #: signal is not holding).
        self._up_since: Optional[float] = None
        self._down_since: Optional[float] = None
        self._last_up_at = 0.0
        self._last_down_at = 0.0
        #: The one in-flight resize operation (decisions serialize).
        self._op: Optional[Dict[str, Any]] = None
        self.decisions_spent = 0
        self._budget_skip_recorded = False
        self.last_decision: Optional[Dict[str, Any]] = None
        #: Last tick's observed signals, for status()/the health probe.
        self.last_shed_rate = 0.0
        self.last_occupancy = 0.0
        self.target: Optional[int] = None

    # -- plumbing -------------------------------------------------------------
    @property
    def _registry(self) -> Any:
        orch = getattr(self.fleet, "orch", None)
        return getattr(orch, "registry", None)

    def _count(self, direction: str, outcome: str) -> None:
        try:
            self.router.metrics.incr(
                labeled_key(
                    "autoscaler_decision_total",
                    direction=direction,
                    outcome=outcome,
                )
            )
        except Exception:  # pragma: no cover - stats must never raise
            pass

    def _gauge_target(self) -> None:
        try:
            self.router.metrics.gauge(
                labeled_key("fleet_target_replicas", fleet=self.fleet_name),
                float(self.target if self.target is not None else 0),
            )
        except Exception:  # pragma: no cover - stats must never raise
            pass

    def _add_row(
        self, name: str, action: str, status: str, message: str, **attrs: Any
    ) -> Optional[int]:
        """One remediation row on the replica run's timeline (None when
        the fleet has no registry or the replica no run)."""
        registry = self._registry
        if registry is None:
            return None
        run_id = self.fleet.run_id_for(name)
        if run_id is None:
            return None
        try:
            row = registry.add_remediation(
                run_id,
                action,
                trigger="autoscaler",
                status=status,
                message=message,
                attrs=attrs,
            )
            return row["id"]
        except Exception:  # pragma: no cover - rows are best-effort
            return None

    def _update_row(self, op: Dict[str, Any], **kwargs: Any) -> None:
        registry = self._registry
        rem_id = op.get("rem_id")
        if registry is None or rem_id is None:
            return
        try:
            registry.update_remediation(rem_id, **kwargs)
        except Exception:  # pragma: no cover - rows are best-effort
            pass

    # -- signals --------------------------------------------------------------
    def _membership(self) -> int:
        """Replicas the fleet currently owns (any routable state —
        a warming newcomer already counts toward the ceiling)."""
        return sum(
            1
            for n in self.router.replica_names()
            if (r := self.router.replica(n)) is not None
            and r.state not in ("drained", "dead")
        )

    def _observe(self, now: float) -> None:
        """Fold the windowed counter deltas and occupancy into the
        hysteresis timers.

        The shed rate is taken over the trailing half-up-hold window,
        not a single tick: at pump cadence most ticks see zero requests
        on a lightly loaded fleet, and a per-tick rate would reset the
        overload episode on every empty tick, so the hold could never
        be satisfied by sparse (but persistently shedding) traffic.  A
        tick whose window saw no requests at all is no evidence either
        way and leaves the episode timer untouched — the idle branch
        (occupancy near zero, no sheds) is what ends an episode when
        traffic stops entirely.
        """
        counters = self.router.counters
        requests = int(counters.get("requests", 0))
        sheds = int(counters.get("sheds", 0))
        window_s = self.up_hold_s / 2.0
        self._shed_window.observe(sheds, requests, now)
        deltas = self._shed_window.deltas(window_s, now)
        if deltas is None:
            # First tick: no interval to rate over.
            return
        d_shed, d_req = deltas
        self._window_req = int(d_req)
        self.last_shed_rate = (d_shed / d_req) if d_req > 0 else 0.0

        with self.router._lock:
            ready_loads = [
                r.load()
                for r in self.router._replicas.values()
                if r.state == "ready"
            ]
        self.last_occupancy = (
            sum(min(1.0, x) for x in ready_loads) / len(ready_loads)
            if ready_loads
            else 0.0
        )

        if d_req > 0:
            if self.last_shed_rate >= self.shed_rate:
                if self._up_since is None:
                    self._up_since = now
            else:
                self._up_since = None

        idle = (
            bool(ready_loads)
            and self.last_occupancy < self.idle_occupancy
            and d_shed == 0
        )
        if idle:
            if self._down_since is None:
                self._down_since = now
            self._up_since = None  # a quiet fleet is not overloaded
        else:
            self._down_since = None

    # -- decisions ------------------------------------------------------------
    def _budget_ok(self, direction: str, now: float) -> bool:
        if self.decisions_spent < self.budget:
            return True
        if not self._budget_skip_recorded:
            self._budget_skip_recorded = True
            self.last_decision = {
                "direction": direction,
                "outcome": "skipped",
                "reason": f"budget ({self.budget}) exhausted",
                "at": now,
            }
            self._count(direction, "skipped")
            # The skip itself goes on a timeline when one exists — pin
            # it to any current member so the refusal is visible.
            names = self.router.replica_names()
            if names:
                self._add_row(
                    names[0],
                    f"scale_{direction}",
                    RemediationStatus.SKIPPED,
                    f"autoscaler budget ({self.budget}) exhausted",
                    signal="budget",
                )
        return False

    def _start_scale_up(self, now: float, reason: str = "shed") -> None:
        if not self._budget_ok("up", now):
            return
        try:
            name = self.fleet.scale_up()
        except Exception as exc:
            self._last_up_at = now  # cooldown a failing submit path too
            self.last_decision = {
                "direction": "up",
                "outcome": "failed",
                "reason": f"scale_up failed: {exc}",
                "at": now,
            }
            self._count("up", "failed")
            return
        self.decisions_spent += 1
        if reason == "repair":
            message = (
                f"membership fell below target {self.target} "
                f"(replica lost) — submitted replacement {name}"
            )
        else:
            message = (
                f"shed rate {self.last_shed_rate:.2f} >= "
                f"{self.shed_rate:.2f} held {self.up_hold_s:.0f}s — "
                f"submitted replica {name}"
            )
            self.target = self._membership()
            self._gauge_target()
        rem_id = self._add_row(
            name,
            "scale_up",
            RemediationStatus.IN_PROGRESS,
            message,
            phase="submitted",
            signal=reason,
            shed_rate=round(self.last_shed_rate, 4),
            target_replicas=self.target,
        )
        self._op = {
            "direction": "up",
            "name": name,
            "rem_id": rem_id,
            "deadline": now + self.ready_timeout_s,
        }
        self._up_since = None
        self.last_decision = {
            "direction": "up",
            "outcome": "started",
            "replica": name,
            "shed_rate": round(self.last_shed_rate, 4),
            "at": now,
        }
        self._count("up", "started")

    def _start_scale_down(self, now: float) -> None:
        with self.router._lock:
            ready = [
                r
                for r in self.router._replicas.values()
                if r.state == "ready"
            ]
            victim = min(ready, key=lambda r: (r.load(), r.name)) if ready else None
        if victim is None:
            return
        if not self._budget_ok("down", now):
            return
        self.decisions_spent += 1
        self.router.drain(victim.name, deadline_s=self.drain_deadline_s)
        self.target = max(self.min_replicas, self._membership() - 1)
        self._gauge_target()
        rem_id = self._add_row(
            victim.name,
            "scale_down",
            RemediationStatus.IN_PROGRESS,
            f"fleet-mean occupancy {self.last_occupancy:.2f} < "
            f"{self.idle_occupancy:.2f} held {self.down_hold_s:.0f}s — "
            f"draining idlest replica {victim.name}",
            phase="draining",
            occupancy=round(self.last_occupancy, 4),
            target_replicas=self.target,
        )
        self._op = {
            "direction": "down",
            "name": victim.name,
            "rem_id": rem_id,
            "deadline": now + self.drain_deadline_s + self.ready_timeout_s,
        }
        self._down_since = None
        self.last_decision = {
            "direction": "down",
            "outcome": "started",
            "replica": victim.name,
            "occupancy": round(self.last_occupancy, 4),
            "at": now,
        }
        self._count("down", "started")

    # -- op advancement -------------------------------------------------------
    def _advance_op(self, now: float) -> None:
        op = self._op
        if op is None:
            return
        name = op["name"]
        rep = self.router.replica(name)
        if op["direction"] == "up":
            if rep is not None and rep.state == "ready":
                self._update_row(
                    op,
                    status=RemediationStatus.SUCCEEDED,
                    message=f"replica {name} probed ready",
                    attrs={"phase": "ready"},
                )
                self._op = None
                self._last_up_at = now
                # Flap suppression: the quiet window the new capacity
                # just created must not immediately drain it.
                self._last_down_at = max(self._last_down_at, now)
                self._down_since = None
                self.last_decision = {
                    "direction": "up",
                    "outcome": "succeeded",
                    "replica": name,
                    "at": now,
                }
                self._count("up", "succeeded")
            elif now >= op["deadline"] or rep is None:
                # Missed the ready gate (or vanished): retire the stuck
                # submission so target and membership re-converge.
                try:
                    self.fleet.retire_replica(name)
                except Exception:
                    pass
                self._update_row(
                    op,
                    status=RemediationStatus.FAILED,
                    message=(
                        f"replica {name} missed the "
                        f"{self.ready_timeout_s:.0f}s ready deadline"
                    ),
                    attrs={"phase": "failed"},
                )
                self._op = None
                self._last_up_at = now
                self.target = self._membership()
                self._gauge_target()
                self.last_decision = {
                    "direction": "up",
                    "outcome": "failed",
                    "replica": name,
                    "at": now,
                }
                self._count("up", "failed")
            return
        # direction == "down"
        drained = rep is None or rep.state == "drained"
        if not drained and now < op["deadline"]:
            return
        try:
            self.fleet.retire_replica(name)
        except Exception:
            pass
        self._update_row(
            op,
            status=RemediationStatus.SUCCEEDED,
            message=f"replica {name} drained and stopped",
            attrs={"phase": "stopped"},
        )
        self._op = None
        self._last_down_at = now
        self.target = self._membership()
        self._gauge_target()
        self.last_decision = {
            "direction": "down",
            "outcome": "succeeded",
            "replica": name,
            "at": now,
        }
        self._count("down", "succeeded")

    # -- the tick -------------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> None:
        """One autoscaler tick: sample signals, advance the in-flight
        operation, start at most one new decision.  Called from the
        fleet's ``poll()`` — must never sleep or block."""
        now = now if now is not None else time.time()
        if self.target is None:
            self.target = max(self.min_replicas, self._membership())
            self._gauge_target()
        self._observe(now)
        self._advance_op(now)
        if not self.enabled or self._op is not None:
            return
        members = self._membership()
        # Capacity repair: membership fell below the committed target
        # (a replica died and was reaped).  Shed-rate can't form when
        # nothing is ready to shed, so repair doesn't wait for it —
        # only for the up-cooldown, which bounds crash-loop churn.
        floor = max(self.min_replicas, min(self.target, self.max_replicas))
        if members < floor:
            if now - self._last_up_at >= self.up_cooldown_s:
                self._start_scale_up(now, reason="repair")
            return
        if (
            self._up_since is not None
            and self._window_req > 0  # fresh evidence, not a stale episode
            and now - self._up_since >= self.up_hold_s
            and now - self._last_up_at >= self.up_cooldown_s
            and members < self.max_replicas
        ):
            self._start_scale_up(now)
            return
        if (
            self._down_since is not None
            and now - self._down_since >= self.down_hold_s
            and now - self._last_down_at >= self.down_cooldown_s
            and members > self.min_replicas
            and self.router.stats()["n_ready"] > self.min_replicas
        ):
            self._start_scale_down(now)

    # -- introspection --------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        op = self._op
        return {
            "enabled": self.enabled,
            "fleet": self.fleet_name,
            "state": (
                f"scaling_{op['direction']}" if op is not None else "idle"
            ),
            "target_replicas": self.target,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "shed_rate": round(self.last_shed_rate, 4),
            "shed_rate_threshold": self.shed_rate,
            "occupancy": round(self.last_occupancy, 4),
            "idle_occupancy": self.idle_occupancy,
            "budget": self.budget,
            "budget_remaining": max(0, self.budget - self.decisions_spent),
            "last_decision": dict(self.last_decision or {}) or None,
            "open_op": (
                {k: v for k, v in op.items() if k != "rem_id"}
                if op is not None
                else None
            ),
        }
