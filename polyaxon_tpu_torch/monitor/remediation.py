"""Remediation policy, the port's copy of ``polyaxon_tpu/monitor/remediation.py``:
the detection -> action loop.

It takes the alert engine's transitions and the gangs' terminal states from
the scheduler's monitor tick and acts through the existing machinery:

- ``checkpoint_now``: a firing critical alert (``run_stalled`` by default)
  on a run that declares ``save_every`` sends a gang-wide ``checkpoint-now``
  command (``Orchestrator.send_command``); the port's workers force a save
  and ack with its step;
- ``resume`` / ``restart``: a FAILED gang with restart budget relaunches from
  its latest complete checkpoint (the port's
  ``runtime/checkpoint.latest_complete_step``: a torn save never answers)
  with exponential backoff;
- ``evict``: a firing ``gang_straggler`` (opt-in) checkpoints the gang,
  kills the straggling rank process and records an elastic topology
  override in the run's meta, so the resume re-forms the gang smaller;
- ``drain_replace``: a drain-class alert on a replica of a registered serving
  fleet (``serving/fleet.py:ServingFleet`` registers itself) opens the
  operation and hands it to the fleet, whose ``poll()`` drains, replaces and
  closes the row; on a run that is not a replica it does nothing, as the
  reference does.

Every action is a registry row, an audit event and a
``remediation_total{action,outcome}`` counter.  The port's gang handle holds
the rank plan (``spawner/local.py:rank_plan``), so an eviction counts rank
processes, one a card; :meth:`RemediationEngine.apply_elastic_plan` applies
the override to the compiled plan's rank plan, which the spawner launches as
it is (on a ``cpu*`` plan, which launches one process a host, the compiled
plan itself).  Decisions, rows and messages are the reference's.
"""

from __future__ import annotations

import dataclasses
import logging
import signal as _signal
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from polyaxon_tpu_torch.conf.knobs import knob_bool, knob_float, knob_int, knob_str
from polyaxon_tpu_torch.db.registry import (
    CommandStatus,
    RemediationStatus,
    RunRegistry,
    command_ack_attrs,
)
from polyaxon_tpu_torch.events.registry import EventTypes
from polyaxon_tpu_torch.spawner.local import rank_plan
from polyaxon_tpu_torch.stats import get_stats
from polyaxon_tpu_torch.stats.metrics import labeled_key

logger = logging.getLogger(__name__)

#: Mesh axes a shrunken gang may fold its lost hosts into, best first —
#: data-parallel-ish axes replicate state, so shrinking them never
#: orphans a parameter shard the way shrinking a tensor axis would.
_SHRINK_AXES = ("data", "replica", "fsdp")


def shrink_mesh_axes(
    mesh_axes: Dict[str, int],
    dcn_axes: Optional[Dict[str, int]],
    old_hosts: int,
    new_hosts: int,
) -> Optional[Tuple[Dict[str, int], Dict[str, int]]]:
    """Re-plan a gang's mesh for fewer hosts by shrinking one data-like
    axis proportionally; None when no axis divides cleanly (a pure
    tensor-parallel gang cannot lose a host and keep its sharding)."""
    if new_hosts < 1 or new_hosts >= old_hosts:
        return None
    axes = dict(mesh_axes)
    candidates = [n for n in _SHRINK_AXES if n in axes]
    candidates += [n for n in axes if n not in candidates]
    for name in candidates:
        size = int(axes[name])
        if size <= 1:
            continue
        if (size * new_hosts) % old_hosts != 0:
            continue
        new_size = size * new_hosts // old_hosts
        if new_size < 1:
            continue
        axes[name] = new_size
        dcn = dict(dcn_axes or {})
        if name in dcn:
            # The DCN (cross-slice) share of the axis shrinks proportionally
            # when it divides cleanly; otherwise clamp — it can never exceed
            # the mesh axis it splits.
            d = int(dcn[name])
            if d > 1 and (d * new_hosts) % old_hosts == 0:
                dcn[name] = max(1, d * new_hosts // old_hosts)
            else:
                dcn[name] = min(d, new_size)
        return axes, dcn
    return None


class RemediationEngine:
    """Alert-edge + terminal-state driven action executor.

    The scheduler's monitor tick feeds it (``on_transitions`` with the
    alert engine's transition rows, ``tick`` to advance multi-phase
    actions, ``on_gang_failed`` for the relaunch decision); it acts only
    through injected seams — ``sender`` (the orchestrator's
    ``send_command``) and the gang handle's process refs — so it unit
    tests without a live gang.

    Env knobs (all ``POLYAXON_TPU_REMEDIATION_*``):

    - ``ENABLED`` (default 1): master switch; off = legacy blind-restart
      behavior, no rows, no audit.
    - ``BUDGET`` (default 16): max non-skipped actions per run; exhausted
      → a SKIPPED row and no relaunch.
    - ``BACKOFF_BASE_S`` (default: the plan's ``backoff_seconds``) and
      ``BACKOFF_MAX_S`` (default 300): relaunch waits
      ``min(max, base * 2**restarts)``.
    - ``CHECKPOINT_ALERTS`` (default ``run_stalled``): comma-separated
      rules whose firing edge triggers ``checkpoint-now``.
    - ``EVICT`` (default 0): opt-in straggler eviction.
    - ``COMMAND_TIMEOUT_S`` (default 30): how long an issued command may
      stay unresolved before the action fails (or eviction proceeds
      without its checkpoint).
    """

    def __init__(
        self,
        registry: RunRegistry,
        *,
        stats: Any = None,
        auditor: Any = None,
        sender: Optional[Callable[..., Dict[str, Any]]] = None,
    ) -> None:
        self.registry = registry
        self.stats = stats if stats is not None else get_stats()
        self.auditor = auditor
        self.sender = sender
        self.enabled = knob_bool("POLYAXON_TPU_REMEDIATION_ENABLED")
        self.budget = knob_int("POLYAXON_TPU_REMEDIATION_BUDGET")
        base = knob_str("POLYAXON_TPU_REMEDIATION_BACKOFF_BASE_S")
        self.backoff_base_s: Optional[float] = float(base) if base else None
        self.backoff_max_s = knob_float("POLYAXON_TPU_REMEDIATION_BACKOFF_MAX_S")
        self.checkpoint_rules = {
            r.strip()
            for r in knob_str(
                "POLYAXON_TPU_REMEDIATION_CHECKPOINT_ALERTS"
            ).split(",")
            if r.strip()
        }
        self.evict_enabled = knob_bool("POLYAXON_TPU_REMEDIATION_EVICT")
        self.command_timeout_s = knob_float(
            "POLYAXON_TPU_REMEDIATION_COMMAND_TIMEOUT_S"
        )
        self.drain_rules = {
            r.strip()
            for r in knob_str("POLYAXON_TPU_REMEDIATION_DRAIN_ALERTS").split(",")
            if r.strip()
        }
        #: Serving fleets that asked for alert-driven drain/replace
        #: (:meth:`register_fleet`); a firing drain rule on one of their
        #: replica runs opens a drain_replace operation.
        self._fleets: List[Any] = []
        self.actions = 0
        self.errors = 0
        self.last_action_at: Optional[float] = None

    # -- serving fleets --------------------------------------------------------
    def register_fleet(self, fleet: Any) -> None:
        if fleet not in self._fleets:
            self._fleets.append(fleet)

    def unregister_fleet(self, fleet: Any) -> None:
        if fleet in self._fleets:
            self._fleets.remove(fleet)

    def _fleet_for(self, run_id: int) -> Optional[Any]:
        for fleet in self._fleets:
            try:
                if fleet.handles_run(run_id):
                    return fleet
            except Exception:
                continue
        return None

    # -- bookkeeping ----------------------------------------------------------
    def _count(self, action: str, outcome: str) -> None:
        try:
            self.stats.incr(
                labeled_key("remediation_total", action=action, outcome=outcome)
            )
        except Exception:
            pass
        self.actions += 1
        self.last_action_at = time.time()

    def _audit(self, run_id: int, action: str, outcome: str, **attrs: Any) -> None:
        if self.auditor is None:
            return
        try:
            self.auditor.record(
                EventTypes.EXPERIMENT_REMEDIATION,
                run_id=run_id,
                action=action,
                outcome=outcome,
                **attrs,
            )
        except Exception:
            logger.warning("remediation audit failed", exc_info=True)

    def _budget_left(self, run_id: int) -> int:
        spent = self.registry.count_remediations(
            run_id,
            statuses=(
                RemediationStatus.PENDING,
                RemediationStatus.IN_PROGRESS,
                RemediationStatus.SUCCEEDED,
                RemediationStatus.FAILED,
            ),
        )
        return self.budget - spent

    def _declared_save_every(self, run_id: int) -> int:
        run = self.registry.get_run(run_id)
        if run is None:
            return 0
        decls = run.spec_data.get("declarations") or {}
        try:
            return int(decls.get("save_every") or 0)
        except (TypeError, ValueError):
            return 0

    def _open(self, run_id: int, action: str) -> List[Dict[str, Any]]:
        return [
            r
            for r in self.registry.get_remediations(run_id, action=action)
            if r["status"] in RemediationStatus.OPEN
        ]

    # -- alert edges ----------------------------------------------------------
    def on_transitions(self, handle: Any, transitions: List[Dict[str, Any]]) -> None:
        """React to the alert engine's transition rows for one gang."""
        if not self.enabled or not transitions:
            return
        for row in transitions:
            if row.get("state") != "firing":
                continue
            rule = str(row.get("rule") or "")
            try:
                if rule in self.checkpoint_rules:
                    self._on_checkpoint_rule(handle, rule)
                if rule == "gang_straggler" and self.evict_enabled:
                    self._on_straggler(handle, rule, row.get("attrs") or {})
                if rule in self.drain_rules:
                    self._on_drain_rule(handle, rule)
            except Exception:
                self.errors += 1
                logger.warning(
                    "remediation reaction to %s failed for run %s",
                    rule,
                    handle.run_id,
                    exc_info=True,
                )

    def _issue_checkpoint_now(
        self, handle: Any, rem: Dict[str, Any], reason: str
    ) -> Optional[str]:
        """Send the gang-wide command; returns its uuid (None = send
        failed, the row is already marked FAILED)."""
        try:
            cmd = self.sender(
                handle.run_id,
                "checkpoint-now",
                payload={"reason": reason},
                actor="remediation",
            )
        except Exception as exc:
            self.registry.update_remediation(
                rem["id"],
                status=RemediationStatus.FAILED,
                message=f"command send failed: {exc}",
            )
            self._count("checkpoint_now", "failed")
            return None
        if cmd["status"] in CommandStatus.TERMINAL:
            # EXPIRED straight from send: the run is already done.
            self.registry.update_remediation(
                rem["id"],
                status=RemediationStatus.FAILED,
                message=f"command {cmd['status']} at send",
                attrs={"command_uuid": cmd["uuid"]},
            )
            self._count("checkpoint_now", "failed")
            return None
        self.registry.update_remediation(
            rem["id"],
            attrs={
                "command_uuid": cmd["uuid"],
                "deadline": time.time() + self.command_timeout_s,
            },
        )
        return cmd["uuid"]

    def _on_checkpoint_rule(self, handle: Any, rule: str) -> None:
        run_id = handle.run_id
        if self.sender is None or self._declared_save_every(run_id) <= 0:
            return  # nothing to fence — the run doesn't checkpoint
        if self._open(run_id, "checkpoint_now") or self._budget_left(run_id) <= 0:
            return
        rem = self.registry.add_remediation(
            run_id,
            "checkpoint_now",
            trigger=rule,
            status=RemediationStatus.IN_PROGRESS,
            attrs={"alert": rule},
        )
        if self._issue_checkpoint_now(handle, rem, rule) is not None:
            self._audit(run_id, "checkpoint_now", "issued", trigger=rule)
            self._count("checkpoint_now", "issued")

    def _on_drain_rule(self, handle: Any, rule: str) -> None:
        """A drain-class alert (stale heartbeat, TTFT SLO burn) fired on
        a run that belongs to a registered serving fleet: open a
        ``drain_replace`` operation and hand it to the fleet — the fleet's
        ``poll()`` advances the phases and closes the row."""
        run_id = handle.run_id
        fleet = self._fleet_for(run_id)
        if fleet is None:
            return  # not a fleet replica — drain means nothing here
        if self._open(run_id, "drain_replace") or self._budget_left(run_id) <= 0:
            return
        rem = self.registry.add_remediation(
            run_id,
            "drain_replace",
            trigger=rule,
            status=RemediationStatus.IN_PROGRESS,
            attrs={"alert": rule, "phase": "draining"},
        )
        started = False
        try:
            started = bool(
                fleet.request_drain_replace(run_id, rem["id"], rule)
            )
        except Exception as exc:
            self.registry.update_remediation(
                rem["id"],
                status=RemediationStatus.FAILED,
                message=f"fleet drain request failed: {exc}",
            )
            self._count("drain_replace", "failed")
            return
        if not started:
            self.registry.update_remediation(
                rem["id"],
                status=RemediationStatus.SKIPPED,
                message="fleet declined (unknown replica or already draining)",
            )
            self._count("drain_replace", "skipped")
            return
        self._audit(run_id, "drain_replace", "started", trigger=rule)
        self._count("drain_replace", "started")

    def _on_straggler(self, handle: Any, rule: str, attrs: Dict[str, Any]) -> None:
        run_id = handle.run_id
        plan = handle.plan
        if plan.num_hosts <= 1:
            return
        if self._open(run_id, "evict") or self._budget_left(run_id) <= 0:
            return
        stragglers = attrs.get("stragglers") or []
        victim = None
        worst = -1
        for s in stragglers:
            lag = int(s.get("lag_steps") or 0)
            if lag > worst:
                worst, victim = lag, int(s.get("process_id", -1))
        if victim is None or victim < 0 or victim not in handle.processes:
            return
        shrunk = shrink_mesh_axes(
            plan.mesh_axes, plan.dcn_axes, plan.num_hosts, plan.num_hosts - 1
        )
        if shrunk is None:
            self.registry.add_remediation(
                run_id,
                "evict",
                trigger=rule,
                status=RemediationStatus.SKIPPED,
                message="mesh not shrinkable by one host",
                attrs={"process_id": victim, "mesh_axes": dict(plan.mesh_axes)},
            )
            self._count("evict", "skipped")
            return
        rem = self.registry.add_remediation(
            run_id,
            "evict",
            trigger=rule,
            status=RemediationStatus.IN_PROGRESS,
            attrs={"process_id": victim, "lag_steps": worst, "phase": "checkpoint"},
        )
        self._audit(run_id, "evict", "started", process_id=victim, lag_steps=worst)
        self._count("evict", "started")
        # Fence state first when the run checkpoints (excluding the victim:
        # a straggler wedged in a collective can't save — peers can).
        if self.sender is not None and self._declared_save_every(run_id) > 0:
            if self._issue_checkpoint_now(handle, rem, rule) is not None:
                return  # kill proceeds from tick() once the command resolves
            rem = self.registry.get_remediation(rem["id"])
            if rem is None or rem["status"] in RemediationStatus.TERMINAL:
                return
        self._finish_evict(handle, rem)

    def _finish_evict(self, handle: Any, rem: Dict[str, Any]) -> None:
        """Kill the victim and persist the elastic topology override —
        the gang fails, and the resume path relaunches it one host
        smaller."""
        run_id = handle.run_id
        plan = handle.plan
        victim = int(rem["attrs"].get("process_id", -1))
        new_hosts = plan.num_hosts - 1
        shrunk = shrink_mesh_axes(
            plan.mesh_axes, plan.dcn_axes, plan.num_hosts, new_hosts
        )
        if shrunk is None:
            self.registry.update_remediation(
                rem["id"],
                status=RemediationStatus.FAILED,
                message="mesh not shrinkable by one host",
            )
            self._count("evict", "failed")
            return
        mesh_axes, dcn_axes = shrunk
        elastic = {
            "num_hosts": new_hosts,
            "mesh_axes": mesh_axes,
            "dcn_axes": dcn_axes,
            "evicted": [victim],
            "at": time.time(),
        }
        self.registry.merge_run_meta(run_id, elastic=elastic)
        ref = handle.processes.get(victim)
        try:
            if ref is not None and ref.poll() is None:
                ref.signal(_signal.SIGKILL)
        except Exception:
            logger.warning(
                "evict: signalling proc %d of run %s failed", victim, run_id,
                exc_info=True,
            )
        self.registry.update_remediation(
            rem["id"],
            status=RemediationStatus.SUCCEEDED,
            message=f"evicted proc {victim}; gang re-forms on {new_hosts} host(s)",
            attrs={"phase": "killed", "elastic": elastic},
        )
        if self.auditor is not None:
            try:
                self.auditor.record(
                    EventTypes.EXPERIMENT_EVICTED,
                    run_id=run_id,
                    process_id=victim,
                    num_hosts=new_hosts,
                    mesh_axes=mesh_axes,
                )
            except Exception:
                pass
        self._count("evict", "succeeded")

    # -- per-tick advancement -------------------------------------------------
    def tick(self, handle: Any, now: Optional[float] = None) -> None:
        """Advance multi-phase actions (command resolution, timeouts)."""
        if not self.enabled:
            return
        now = now if now is not None else time.time()
        run_id = handle.run_id
        for rem in self._open(run_id, "checkpoint_now"):
            self._tick_checkpoint_now(rem, now)
        for rem in self._open(run_id, "evict"):
            self._tick_evict(handle, rem, now)

    def _resolve_command(
        self, rem: Dict[str, Any], now: float
    ) -> Optional[Tuple[str, Optional[int]]]:
        """(outcome, saved_step) for the row's issued command, or None
        while still pending inside its deadline."""
        uuid = rem["attrs"].get("command_uuid")
        if not uuid:
            return ("failed", None)
        cmd = self.registry.get_command(str(uuid))
        if cmd is None:
            return ("failed", None)
        if cmd["status"] == CommandStatus.COMPLETE:
            steps = [
                command_ack_attrs(v).get("step")
                for v in cmd["acks"].values()
            ]
            steps = [int(s) for s in steps if s is not None]
            return ("succeeded", max(steps) if steps else None)
        if cmd["status"] in CommandStatus.TERMINAL:
            return ("failed", None)
        if now > float(rem["attrs"].get("deadline") or 0):
            return ("timeout", None)
        return None

    def _tick_checkpoint_now(self, rem: Dict[str, Any], now: float) -> None:
        resolved = self._resolve_command(rem, now)
        if resolved is None:
            return
        outcome, saved_step = resolved
        if outcome == "succeeded":
            self.registry.update_remediation(
                rem["id"],
                status=RemediationStatus.SUCCEEDED,
                message=(
                    f"gang checkpointed at step {saved_step}"
                    if saved_step is not None
                    else "gang checkpointed"
                ),
                attrs={"saved_step": saved_step},
            )
            self._audit(
                rem["run_id"], "checkpoint_now", "succeeded", saved_step=saved_step
            )
            self._count("checkpoint_now", "succeeded")
        else:
            self.registry.update_remediation(
                rem["id"],
                status=RemediationStatus.FAILED,
                message=f"checkpoint-now {outcome}",
            )
            self._count("checkpoint_now", "failed")

    def _tick_evict(self, handle: Any, rem: Dict[str, Any], now: float) -> None:
        if rem["attrs"].get("phase") != "checkpoint":
            return
        if rem["attrs"].get("command_uuid"):
            resolved = self._resolve_command(rem, now)
            if resolved is None:
                return  # checkpoint still in flight
            # Timeout/failure doesn't abort the eviction: a wedged gang
            # may be unable to save — proceed with the last durable step.
        self._finish_evict(handle, rem)

    # -- terminal states ------------------------------------------------------
    def on_gang_failed(self, run: Any, handle: Any) -> Optional[Dict[str, Any]]:
        """The relaunch decision for a FAILED gang with restart budget.

        Returns ``{"backoff_s", "from_step", "message"}`` to relaunch
        (the scheduler keeps ``run.restarts`` monotonic and rotates
        reports), or None to let the run fail (remediation budget
        exhausted — recorded as a SKIPPED row so the timeline says why).
        """
        plan = handle.plan
        base = (
            self.backoff_base_s
            if self.backoff_base_s is not None
            else float(plan.backoff_seconds or 0.0)
        )
        attempt = run.restarts + 1
        if not self.enabled:
            # Legacy behavior, verbatim: fixed backoff, blind restart.
            return {
                "backoff_s": base,
                "from_step": None,
                "message": f"gang failed; restart {attempt}/{plan.max_restarts}",
            }
        if self._budget_left(run.id) <= 0:
            self.registry.add_remediation(
                run.id,
                "resume",
                trigger="gang_failed",
                status=RemediationStatus.SKIPPED,
                message=f"remediation budget ({self.budget}) exhausted",
            )
            self._count("resume", "skipped")
            return None
        # Imported here: the checkpoint module loads torch, which the
        # control plane's import does not.
        from polyaxon_tpu_torch.runtime.checkpoint import latest_complete_step

        try:
            from_step = latest_complete_step(handle.paths.checkpoints)
        except Exception:
            from_step = None
        backoff = min(self.backoff_max_s, base * (2 ** run.restarts)) if base > 0 else 0.0
        action = "resume" if from_step is not None else "restart"
        self.registry.add_remediation(
            run.id,
            action,
            trigger="gang_failed",
            status=RemediationStatus.SUCCEEDED,
            message=(
                f"resuming from checkpoint step {from_step}"
                if from_step is not None
                else "no complete checkpoint; restarting from step 0"
            ),
            attrs={"from_step": from_step, "attempt": attempt, "backoff_s": backoff},
        )
        if from_step is not None and self.auditor is not None:
            try:
                self.auditor.record(
                    EventTypes.EXPERIMENT_RESUMED,
                    run_id=run.id,
                    from_step=from_step,
                    attempt=attempt,
                )
            except Exception:
                pass
        self._audit(run.id, action, "succeeded", attempt=attempt, from_step=from_step)
        self._count(action, "succeeded")
        where = (
            f"resume from step {from_step}" if from_step is not None else "restart"
        )
        return {
            "backoff_s": backoff,
            "from_step": from_step,
            "message": (
                f"gang failed; {where} {attempt}/{plan.max_restarts}"
                f" (backoff {backoff:.1f}s)"
            ),
        }

    def apply_elastic_plan(self, run: Any, plan: Any) -> Any:
        """Apply a recorded eviction's topology override to a freshly
        compiled plan (``experiments_start`` calls this on every launch so
        the override survives further restarts).  The override counts rank
        processes, so it replaces the plan's rank plan."""
        elastic = (getattr(run, "meta", None) or {}).get("elastic")
        if not elastic:
            return plan
        try:
            new_hosts = int(elastic.get("num_hosts") or 0)
        except (TypeError, ValueError):
            return plan
        ranks = rank_plan(plan)
        if new_hosts < 1 or new_hosts >= ranks.num_hosts:
            return plan
        return dataclasses.replace(
            ranks,
            num_hosts=new_hosts,
            mesh_axes=dict(elastic.get("mesh_axes") or plan.mesh_axes),
            dcn_axes=dict(elastic.get("dcn_axes") or {}),
        )

    def finalize(self, run_id: int) -> None:
        """Close open action rows when the run reaches a terminal state."""
        self.registry.expire_remediations(run_id)

    def status(self) -> Dict[str, Any]:
        """Introspection for the health probe and the API."""
        return {
            "enabled": self.enabled,
            "evict_enabled": self.evict_enabled,
            "budget": self.budget,
            "actions": self.actions,
            "errors": self.errors,
            "last_action_at": self.last_action_at,
            "checkpoint_rules": sorted(self.checkpoint_rules),
            "drain_rules": sorted(self.drain_rules),
            "fleets": len(self._fleets),
            "backoff_max_s": self.backoff_max_s,
        }
