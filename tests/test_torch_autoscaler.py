"""The port's FleetAutoscaler: the reference's control-loop cases, and the
same timeline through both packages.

Every case of ``tests/test_serving/test_autoscaler.py`` runs here on the
port's autoscaler over a real (threadless) port router and a scripted fake
fleet: no subprocesses, no sockets, time injected through
``evaluate(now=...)``.  The parity case feeds one timeline (shed and idle
ticks, ready flips, a lost member, a stuck scale-up, budget exhaustion)
through the JAX and the port autoscaler: the decisions, the remediation
rows, ``status()`` and the stats keys must be equal tick by tick.
"""

from __future__ import annotations

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import pytest

from polyaxon_tpu.serving import autoscaler as jax_autoscaler
from polyaxon_tpu.serving import router as jax_router
from polyaxon_tpu_torch.serving import autoscaler as port_autoscaler
from polyaxon_tpu_torch.serving import router as port_router
from polyaxon_tpu_torch.serving.autoscaler import FleetAutoscaler
from polyaxon_tpu_torch.serving.router import FleetRouter
from polyaxon_tpu_torch.stats.metrics import labeled_key

# Far from 0.0 so the (initially zero) cooldown anchors never block.
T0 = 1000.0


class FakeFleet:
    """Resize protocol only: launches are router membership flips."""

    def __init__(self, router, registry=None):
        self.router = router
        self.name = "testfleet"
        self.ready_timeout_s = 10.0
        self.drain_deadline_s = 10.0
        self.launched = []
        self.retired = []
        self._n = 0
        self._run_ids = {}
        if registry is not None:
            self.orch = type("O", (), {"registry": registry})()

    def scale_up(self):
        self._n += 1
        name = f"new{self._n}"
        self.router.add_replica(name, f"http://127.0.0.1:{9000 + self._n}")
        self.launched.append(name)
        self._run_ids[name] = 100 + self._n
        return name

    def retire_replica(self, name):
        self.retired.append(name)
        self.router.remove_replica(name)

    def run_id_for(self, name):
        return self._run_ids.get(name)


class FakeRegistry:
    def __init__(self):
        self.rows = []
        self._next = 0

    def add_remediation(self, run_id, action, **kwargs):
        self._next += 1
        row = {"id": self._next, "run_id": run_id, "action": action, **kwargs}
        self.rows.append(row)
        return row

    def update_remediation(self, rem_id, **kwargs):
        for row in self.rows:
            if row["id"] == rem_id:
                attrs = kwargs.pop("attrs", None)
                row.update(kwargs)
                if attrs:
                    row.setdefault("attrs", {}).update(attrs)
                return row
        raise KeyError(rem_id)


def make_router(n_ready=1, router_cls=FleetRouter):
    router = router_cls(
        probe_interval_s=3600,  # probes never fire on their own
        shed_occupancy=0.9,
    )
    for i in range(n_ready):
        rep = router.add_replica(f"r{i}", f"http://127.0.0.1:{8000 + i}")
        rep.state = "ready"
        rep.slots = 4
    return router


def make_scaler(fleet, scaler_cls=FleetAutoscaler, **overrides):
    kwargs = dict(
        enabled=True,
        shed_rate=0.2,
        idle_occupancy=0.2,
        min_replicas=1,
        max_replicas=2,
        up_hold_s=2.0,
        down_hold_s=4.0,
        up_cooldown_s=5.0,
        down_cooldown_s=8.0,
        budget=16,
    )
    kwargs.update(overrides)
    return scaler_cls(fleet, **kwargs)


def shed_tick(router, scaler, now, *, requests=10, sheds=5):
    router.counters["requests"] += requests
    router.counters["sheds"] += sheds
    scaler.evaluate(now)


def idle_tick(router, scaler, now, *, requests=2):
    router.counters["requests"] += requests
    scaler.evaluate(now)


def test_scale_up_requires_hold_then_gates_on_ready():
    router = make_router(1)
    fleet = FakeFleet(router)
    scaler = make_scaler(fleet)
    scaler.evaluate(T0)  # baseline tick — no rate yet
    shed_tick(router, scaler, T0 + 1)
    # Hold not yet satisfied: shedding started at T0+1, hold is 2s.
    shed_tick(router, scaler, T0 + 2)
    assert fleet.launched == []
    shed_tick(router, scaler, T0 + 3.1)
    assert fleet.launched == ["new1"]
    assert scaler.last_decision["outcome"] == "started"
    assert scaler.status()["state"] == "scaling_up"
    # Still warming: decision stays open, no second op starts.
    shed_tick(router, scaler, T0 + 4)
    assert fleet.launched == ["new1"]
    # The warming→ready probe gate: only a ready state completes it.
    router.replica("new1").state = "ready"
    scaler.evaluate(T0 + 5)
    assert scaler.last_decision == {
        "direction": "up",
        "outcome": "succeeded",
        "replica": "new1",
        "at": T0 + 5,
    }
    assert scaler.status()["state"] == "idle"
    assert scaler.target == 2


def test_one_shed_spike_does_not_scale():
    router = make_router(1)
    fleet = FakeFleet(router)
    scaler = make_scaler(fleet)
    scaler.evaluate(T0)
    shed_tick(router, scaler, T0 + 1)
    idle_tick(router, scaler, T0 + 2)  # signal dropped → hysteresis resets
    shed_tick(router, scaler, T0 + 3)
    shed_tick(router, scaler, T0 + 4.5)
    # 1.5s of continuous shedding < 2s hold: the earlier spike must not
    # count toward it.
    assert fleet.launched == []


def test_up_cooldown_blocks_back_to_back_ups():
    router = make_router(1)
    fleet = FakeFleet(router)
    scaler = make_scaler(fleet, max_replicas=3)
    scaler.evaluate(T0)
    shed_tick(router, scaler, T0 + 1)
    shed_tick(router, scaler, T0 + 3.1)
    router.replica("new1").state = "ready"
    scaler.evaluate(T0 + 4)  # up succeeded at T0+4
    shed_tick(router, scaler, T0 + 5)
    shed_tick(router, scaler, T0 + 7.5)  # hold ok, but cooldown (5s) not
    assert fleet.launched == ["new1"]
    shed_tick(router, scaler, T0 + 9.5)  # T0+9.5 - T0+4 > 5s cooldown
    assert fleet.launched == ["new1", "new2"]


def test_never_above_max_replicas():
    router = make_router(2)
    fleet = FakeFleet(router)
    scaler = make_scaler(fleet, max_replicas=2)
    scaler.evaluate(T0)
    for k in range(1, 30):
        shed_tick(router, scaler, T0 + k)
    assert fleet.launched == []


def test_scale_up_deadline_failure_retires_stuck_replica():
    router = make_router(1)
    fleet = FakeFleet(router)
    scaler = make_scaler(fleet)  # fleet.ready_timeout_s = 10
    scaler.evaluate(T0)
    shed_tick(router, scaler, T0 + 1)
    shed_tick(router, scaler, T0 + 3.1)
    assert fleet.launched == ["new1"]
    # never reaches ready; deadline = decision time + 10s
    scaler.evaluate(T0 + 14)
    assert fleet.retired == ["new1"]
    assert scaler.last_decision["outcome"] == "failed"
    assert scaler.target == 1


def test_scale_down_drains_idlest_and_respects_min():
    router = make_router(2)
    # r0 load 0.25 → fleet mean 0.125 < 0.2 floor, and r1 is the idlest
    router.replica("r0").slots_active = 1
    fleet = FakeFleet(router)
    scaler = make_scaler(fleet, min_replicas=1)
    scaler.evaluate(T0)
    idle_tick(router, scaler, T0 + 1)
    idle_tick(router, scaler, T0 + 5.1)  # > 4s hold
    assert router.replica("r1").state == "draining"
    assert scaler.status()["state"] == "scaling_down"
    router.replica("r1").state = "drained"
    scaler.evaluate(T0 + 6)
    assert fleet.retired == ["r1"]
    assert scaler.last_decision["outcome"] == "succeeded"
    assert scaler.target == 1
    # At min now: idle holds forever, no further drain.
    for k in range(7, 40):
        idle_tick(router, scaler, T0 + k)
    assert fleet.retired == ["r1"]
    assert router.replica("r0").state == "ready"


def test_sheds_in_window_veto_scale_down():
    router = make_router(2)
    fleet = FakeFleet(router)
    scaler = make_scaler(fleet)
    scaler.evaluate(T0)
    for k in range(1, 20):
        # Occupancy is 0 (idle) but every window saw a shed — a fleet
        # refusing work is not over-provisioned.
        shed_tick(router, scaler, T0 + k, requests=10, sheds=1)
    assert router.replica("r0").state == "ready"
    assert router.replica("r1").state == "ready"


def test_completed_scale_up_suppresses_immediate_drain():
    router = make_router(1)
    fleet = FakeFleet(router)
    scaler = make_scaler(fleet, down_hold_s=1.0, down_cooldown_s=8.0)
    scaler.evaluate(T0)
    shed_tick(router, scaler, T0 + 1)
    shed_tick(router, scaler, T0 + 3.1)
    router.replica("new1").state = "ready"
    scaler.evaluate(T0 + 4)  # scale-up completes: re-arms down cooldown
    # The new capacity makes everything idle immediately — flap
    # suppression must hold the drain until T0+4 + down_cooldown.
    for t in (5, 6, 7, 8, 9, 10, 11):
        idle_tick(router, scaler, T0 + t)
    assert scaler.status()["state"] == "idle"  # no drain started yet
    idle_tick(router, scaler, T0 + 12.5)  # 8.5s after the up completed
    assert scaler.status()["state"] == "scaling_down"


def test_budget_cap_skips_once_and_goes_inert():
    router = make_router(1)
    fleet = FakeFleet(router)
    scaler = make_scaler(fleet, budget=1, max_replicas=4, up_cooldown_s=0.5)
    scaler.evaluate(T0)
    shed_tick(router, scaler, T0 + 1)
    shed_tick(router, scaler, T0 + 3.1)
    assert fleet.launched == ["new1"]
    router.replica("new1").state = "ready"
    scaler.evaluate(T0 + 4)
    # Budget spent: keep shedding well past hold+cooldown.
    for k in range(5, 20):
        shed_tick(router, scaler, T0 + k)
    assert fleet.launched == ["new1"]
    assert scaler.last_decision["outcome"] == "skipped"
    assert scaler.status()["budget_remaining"] == 0
    snap = router.metrics.snapshot()["counters"]
    key = labeled_key(
        "autoscaler_decision_total", direction="up", outcome="skipped"
    )
    assert snap.get(key) == 1  # edge-triggered: exactly one skip recorded


def test_disabled_autoscaler_observes_but_never_acts():
    router = make_router(1)
    fleet = FakeFleet(router)
    scaler = make_scaler(fleet, enabled=False)
    scaler.evaluate(T0)
    for k in range(1, 20):
        shed_tick(router, scaler, T0 + k)
    assert fleet.launched == []
    assert scaler.last_shed_rate == pytest.approx(0.5)


def test_remediation_rows_record_phases():
    registry = FakeRegistry()
    router = make_router(1)
    fleet = FakeFleet(router, registry=registry)
    scaler = make_scaler(fleet)
    scaler.evaluate(T0)
    shed_tick(router, scaler, T0 + 1)
    shed_tick(router, scaler, T0 + 3.1)
    assert len(registry.rows) == 1
    row = registry.rows[0]
    assert row["action"] == "scale_up"
    assert row["trigger"] == "autoscaler"
    assert row["status"] == "in_progress"
    assert row["attrs"]["phase"] == "submitted"
    assert row["run_id"] == 101
    router.replica("new1").state = "ready"
    scaler.evaluate(T0 + 4)
    assert row["status"] == "succeeded"
    assert row["attrs"]["phase"] == "ready"
    # Drain-down writes its own row with draining→stopped phases.  Load
    # r0 just enough (0.25 < 2×idle floor as fleet mean 0.125) that the
    # idlest — hence the drain victim — is new1, the replica with a run.
    router.replica("r0").slots_active = 1
    for t in (13, 14, 15, 16, 17, 17.6):
        idle_tick(router, scaler, T0 + t)
    down_rows = [r for r in registry.rows if r["action"] == "scale_down"]
    assert len(down_rows) == 1
    assert down_rows[0]["attrs"]["phase"] == "draining"
    assert down_rows[0]["run_id"] == 101
    router.replica("new1").state = "drained"
    scaler.evaluate(T0 + 18)
    assert down_rows[0]["status"] == "succeeded"
    assert down_rows[0]["attrs"]["phase"] == "stopped"


def test_target_gauge_and_status_shape():
    router = make_router(2)
    fleet = FakeFleet(router)
    scaler = make_scaler(fleet, min_replicas=2, max_replicas=4)
    scaler.evaluate(T0)
    snap = router.metrics.snapshot()["gauges"]
    key = labeled_key("fleet_target_replicas", fleet="testfleet")
    assert snap.get(key) == 2.0
    st = scaler.status()
    assert st["fleet"] == "testfleet"
    assert st["state"] == "idle"
    assert st["target_replicas"] == 2
    assert st["min_replicas"] == 2 and st["max_replicas"] == 4
    assert st["budget_remaining"] == st["budget"] == 16
    assert st["last_decision"] is None
    assert st["open_op"] is None


def test_capacity_repair_replaces_dead_member_without_shed_signal():
    # Two committed replicas; one dies and is reaped (removed).  With
    # nothing overloaded there is no shed signal — repair must restore
    # the target anyway, gated only by the up-cooldown and the budget.
    router = make_router(2)
    registry = FakeRegistry()
    fleet = FakeFleet(router, registry=registry)
    scaler = make_scaler(fleet)
    scaler.evaluate(T0)
    assert scaler.target == 2
    router.remove_replica("r1")  # the fleet reaped a SIGKILLed corpse
    # Inside the up-cooldown window (anchor 0.0 is ancient, so only a
    # recent up could block): repair fires on the very next tick.
    idle_tick(router, scaler, T0 + 1)
    assert fleet.launched == ["new1"]
    assert scaler.status()["state"] == "scaling_up"
    row = next(r for r in registry.rows if r["action"] == "scale_up")
    assert row["attrs"]["signal"] == "repair"
    assert row["attrs"]["target_replicas"] == 2
    router.replica("new1").state = "ready"
    scaler.evaluate(T0 + 2)
    assert scaler.last_decision["outcome"] == "succeeded"
    assert scaler.target == 2
    # Replacement also dies immediately: the next repair waits out the
    # up-cooldown (crash-loop churn is bounded).
    router.remove_replica("new1")
    idle_tick(router, scaler, T0 + 3)
    assert fleet.launched == ["new1"]  # cooldown (5s from T0+2) blocks
    idle_tick(router, scaler, T0 + 7.1)
    assert fleet.launched == ["new1", "new2"]


def test_repair_never_exceeds_max_or_budget():
    router = make_router(1)
    fleet = FakeFleet(router)
    scaler = make_scaler(fleet, min_replicas=1, max_replicas=2, budget=1)
    scaler.evaluate(T0)
    assert scaler.target == 1
    # At target: no repair, no spurious launches.
    idle_tick(router, scaler, T0 + 1)
    assert fleet.launched == []
    router.remove_replica("r0")
    idle_tick(router, scaler, T0 + 2)  # min_replicas floor repair
    assert fleet.launched == ["new1"]
    router.replica("new1").state = "ready"
    scaler.evaluate(T0 + 3)
    router.remove_replica("new1")
    # Budget (1) is spent: repair is refused, recorded once as skipped.
    for t in (10, 20, 30):
        idle_tick(router, scaler, T0 + t)
    assert fleet.launched == ["new1"]
    key = labeled_key(
        "autoscaler_decision_total", direction="up", outcome="skipped"
    )
    assert router.metrics.snapshot()["counters"][key] == 1



# -- parity with the JAX package's autoscaler -----------------------------------


def _timeline(router_mod, autoscaler_mod, **overrides):
    """One evaluate(now=...) timeline; returns what each tick leaves behind."""
    registry = FakeRegistry()
    router = make_router(2, router_cls=router_mod.FleetRouter)
    fleet = FakeFleet(router, registry=registry)
    scaler = make_scaler(fleet, scaler_cls=autoscaler_mod.FleetAutoscaler, max_replicas=3,
                         **overrides)
    seen = []

    def tick(t, kind="eval", **kw):
        if kind == "shed":
            shed_tick(router, scaler, T0 + t, **kw)
        elif kind == "idle":
            idle_tick(router, scaler, T0 + t, **kw)
        else:
            scaler.evaluate(T0 + t)
        snap = router.metrics.snapshot()
        seen.append((
            t,
            scaler.status(),
            [dict(r) for r in registry.rows],
            list(fleet.launched),
            list(fleet.retired),
            {n: router.replica(n).state for n in sorted(router.replica_names())},
            snap["counters"],
            snap["gauges"],
        ))

    tick(0)
    for t in (1, 2, 3.1, 4):
        tick(t, "shed")
    if "new1" in router.replica_names():  # not when disabled
        router.replica("new1").state = "ready"
    tick(5)
    for t in (6, 7, 9.5, 10.5, 11.5):
        tick(t, "shed", requests=10, sheds=4)
    tick(26)  # new2 never reached ready: the decision fails, new2 is retired
    router.replica("r1").slots_active = 1
    for t in (27, 28, 29, 30, 31.5, 33, 35.5, 40):
        tick(t, "idle")
    for name in sorted(router.replica_names()):
        if router.replica(name).state == "draining":
            router.replica(name).state = "drained"
    tick(41)
    router.remove_replica("r0")  # a reaped corpse: capacity repair
    for t in (42, 48, 49):
        tick(t, "idle")
    for name in router.replica_names():
        router.replica(name).state = "ready"
    for t in (50, 60, 61, 70, 80):
        tick(t, "shed", requests=20, sheds=19)
    for t in range(81, 100, 3):
        tick(t, "idle", requests=0)
    return seen


@pytest.mark.parametrize("overrides", [
    {},
    {"budget": 3, "up_cooldown_s": 0.5},
    {"enabled": False},
    {"shed_rate": 0.5, "down_hold_s": 1.0, "down_cooldown_s": 2.0},
], ids=["defaults", "budget", "disabled", "tight"])
def test_a_timeline_gives_the_jax_autoscalers_decisions_rows_and_status(overrides):
    port = _timeline(port_router, port_autoscaler, **overrides)
    ref = _timeline(jax_router, jax_autoscaler, **overrides)
    assert len(port) == len(ref)
    for mine, theirs in zip(port, ref):
        assert mine == theirs, f"tick at T0+{mine[0]}"
    decisions = {(s[1]["last_decision"] or {}).get("outcome") for s in port}
    if overrides.get("enabled", True):
        assert {"started", "succeeded"} <= decisions
