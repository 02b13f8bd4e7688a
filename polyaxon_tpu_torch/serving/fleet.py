"""Serving fleets: N ``lm_server`` replicas behind a :class:`FleetRouter`,
the port's copy of ``polyaxon_tpu/serving/fleet.py``.

Two provisioning layers share the router:

- :class:`LocalServingFleet` — replicas as real subprocesses
  (``python -m polyaxon_tpu_torch.serving.replica``) through
  ``spawner.transport.LocalExecTransport``.  This is the fault-injection
  harness: SIGKILL kills a replica mid-request (the failover path), SIGSTOP
  freezes one without closing its sockets (the stall and ejection path).
- :class:`ServingFleet` — replicas as ``kind: service`` runs of the port's
  ``Orchestrator`` (the full registry lifecycle: heartbeats, alerts, the
  command bus).  The fleet registers on ``orch.fleets`` and with the
  remediation engine; a firing ``serving_ttft_p99`` / ``heartbeat_stale``
  alert on a replica run becomes a drain->replace operation whose phases
  land on the run's remediation row:

  ``draining``   the router stops routing; a ``drain`` bus command flips the
                 engine to 503-draining; in-flight requests finish, bounded
                 by ``POLYAXON_TPU_FLEET_DRAIN_DEADLINE_S``;
  ``replacing``  the old run is stopped, a replacement run submitted;
  ``succeeded``  the replacement probed ``ready``: routing resumed;
  ``failed``     the replacement missed ``POLYAXON_TPU_FLEET_READY_TIMEOUT_S``.

Both implement the resize protocol :class:`FleetAutoscaler` drives
(``scale_up``, ``retire_replica``, ``run_id_for``) and a thread-free
``poll()`` pump, driven by whoever owns the orchestrator's pump loop, so
fleet state never races the scheduler.  A replica's ``/v1/stats``
``trace_exemplars`` land as a ``ttft_slow`` anomaly row with a
``reports/ttft_exemplars_*.json`` dump on the replica's run.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import signal
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import polyaxon_tpu_torch
from polyaxon_tpu_torch.conf.knobs import knob_float, knob_int
from polyaxon_tpu_torch.serving.router import FleetRouter, _http_json
from polyaxon_tpu_torch.spawner.transport import LocalExecTransport, _free_port
from polyaxon_tpu_torch.stats.metrics import labeled_key

__all__ = ["LocalServingFleet", "ServingFleet"]

logger = logging.getLogger(__name__)

#: Shared phase key with the scheduler's monitor-tick breakdown — the
#: autoscaler pump is one more control-plane phase on the same histogram.
_AUTOSCALER_PHASE_KEY = labeled_key("tick_phase_s", phase="autoscaler")


def _observe_autoscaler_phase(router: Any, seconds: float) -> None:
    try:
        router.metrics.observe(_AUTOSCALER_PHASE_KEY, seconds)
    except Exception:  # pragma: no cover - stats must never raise
        pass


class LocalServingFleet:
    """Subprocess replicas on this machine + a router fronting them.

    ``model`` is the ``TransformerConfig`` int-field dict each replica
    builds (random init, fixed ``seed`` — every replica serves identical
    weights, so greedy failover replays are token-identical).  ``device``
    (default ``"cuda"``) goes into every replica's spec, as does
    ``prefill_chunk`` (0 = whole prompts; the reference's spec key, which
    its fleet leaves at the replica's default).
    """

    def __init__(
        self,
        workdir: Path,
        model: Dict[str, int],
        *,
        replicas: Optional[int] = None,
        seq: int = 128,
        slots: int = 4,
        block_size: int = 16,
        kv_blocks: Optional[int] = None,
        prefill_chunk: int = 0,
        seed: int = 0,
        spec_decode: Optional[bool] = None,
        spec_k: Optional[int] = None,
        spec_min_ngram: Optional[int] = None,
        kv_offload: Optional[bool] = None,
        kv_offload_blocks: Optional[int] = None,
        kv_persist_dir: Optional[str] = None,
        kv_persist_sig: str = "",
        request_timeout_s: float = 600.0,
        host: str = "127.0.0.1",
        router: Optional[FleetRouter] = None,
        env: Optional[Dict[str, str]] = None,
        device: str = "cuda",
    ) -> None:
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.model = dict(model)
        self.replicas = (
            replicas
            if replicas is not None
            else knob_int("POLYAXON_TPU_FLEET_REPLICAS")
        )
        self.seq = seq
        self.slots = slots
        self.block_size = block_size
        self.kv_blocks = kv_blocks
        self.prefill_chunk = prefill_chunk
        self.seed = seed
        # Speculative decoding rides the replica spec (None = the
        # replica's own POLYAXON_TPU_SERVING_SPEC_* knob defaults).
        self.spec_decode = spec_decode
        self.spec_k = spec_k
        self.spec_min_ngram = spec_min_ngram
        # KV hierarchy rides the spec too: every replica (including
        # autoscaler scale-ups, which re-enter launch_replica) shares
        # one kv_persist_dir, so a new replica boots prefix-warm from
        # whatever the incumbents last persisted.
        self.kv_offload = kv_offload
        self.kv_offload_blocks = kv_offload_blocks
        self.kv_persist_dir = kv_persist_dir
        self.kv_persist_sig = kv_persist_sig
        self.request_timeout_s = request_timeout_s
        self.host = host
        self.env = dict(env or {})
        self.device = device
        self.transport = LocalExecTransport()
        self.router = router if router is not None else FleetRouter()
        self._procs: Dict[str, Any] = {}
        self._counter = itertools.count()
        self.autoscaler: Optional[Any] = None

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "LocalServingFleet":
        for _ in range(self.replicas):
            self.launch_replica()
        self.router.start()
        return self

    def launch_replica(self, name: Optional[str] = None) -> str:
        name = name or f"r{next(self._counter)}"
        port = _free_port()
        spec = {
            "name": name,
            "host": self.host,
            "port": port,
            "seed": self.seed,
            "model": self.model,
            "seq": self.seq,
            "slots": self.slots,
            "block_size": self.block_size,
            "kv_blocks": self.kv_blocks,
            "prefill_chunk": self.prefill_chunk,
            "spec_decode": self.spec_decode,
            "spec_k": self.spec_k,
            "spec_min_ngram": self.spec_min_ngram,
            "kv_offload": self.kv_offload,
            "kv_offload_blocks": self.kv_offload_blocks,
            "kv_persist_dir": self.kv_persist_dir,
            "kv_persist_sig": self.kv_persist_sig,
            "request_timeout_s": self.request_timeout_s,
            "device": self.device,
        }
        spec_path = self.workdir / f"{name}.json"
        spec_path.write_text(json.dumps(spec))
        # The replica runs with cwd=workdir, so an uninstalled (source
        # checkout) polyaxon_tpu_torch must ride on PYTHONPATH explicitly.
        pkg_root = str(Path(polyaxon_tpu_torch.__file__).resolve().parent.parent)
        existing = os.environ.get("PYTHONPATH")
        env = dict(self.env)
        env.setdefault(
            "PYTHONPATH",
            pkg_root + (os.pathsep + existing if existing else ""),
        )
        ref = self.transport.launch(
            "localhost",
            [sys.executable, "-m", "polyaxon_tpu_torch.serving.replica", str(spec_path)],
            env,
            cwd=str(self.workdir),
            log_path=self.workdir / f"{name}.log",
            rc_path=self.workdir / f"{name}.rc",
        )
        self._procs[name] = ref
        self.router.add_replica(name, f"http://{self.host}:{port}")
        return name

    def wait_ready(
        self, n: Optional[int] = None, timeout_s: Optional[float] = None
    ) -> bool:
        """Block until ``n`` replicas probe ``ready`` (default: all)."""
        n = n if n is not None else len(self._procs)
        timeout_s = (
            timeout_s
            if timeout_s is not None
            else knob_float("POLYAXON_TPU_FLEET_READY_TIMEOUT_S")
        )
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            self.router.probe_all()
            if self.router.stats()["n_ready"] >= n:
                return True
            time.sleep(0.2)
        return False

    def stop(self) -> None:
        self.router.stop()
        for ref in self._procs.values():
            ref.signal(signal.SIGKILL)
        for ref in self._procs.values():
            ref.wait(timeout=10)
        self._procs.clear()

    # -- fault injection -------------------------------------------------------
    def kill_replica(self, name: str) -> None:
        """SIGKILL: sockets die mid-request — the failover path."""
        self._procs[name].signal(signal.SIGKILL)

    def stall_replica(self, name: str) -> None:
        """SIGSTOP: the process freezes with sockets OPEN — probes time
        out instead of failing fast, the ejection path's worst case."""
        self._procs[name].signal(signal.SIGSTOP)

    def resume_replica(self, name: str) -> None:
        self._procs[name].signal(signal.SIGCONT)

    def replace_replica(self, name: str) -> str:
        """Kill ``name`` (if alive), drop it from routing, launch a
        fresh replica — the local analogue of drain-and-replace."""
        self.retire_replica(name)
        return self.launch_replica()

    def chaos_target(self) -> Optional[str]:
        """Deterministic victim for an untargeted chaos event: the
        first (by name) ready replica the router still routes to."""
        ready = sorted(
            n
            for n in self.router.replica_names()
            if (r := self.router.replica(n)) is not None
            and r.state == "ready"
            and n in self._procs
        )
        return ready[0] if ready else None

    # -- resize protocol (FleetAutoscaler) -------------------------------------
    def scale_up(self) -> str:
        return self.launch_replica()

    def retire_replica(self, name: str) -> None:
        ref = self._procs.pop(name, None)
        if ref is not None:
            ref.signal(signal.SIGKILL)
            ref.wait(timeout=10)
        self.router.remove_replica(name)

    def run_id_for(self, name: str) -> Optional[int]:
        return None  # subprocess replicas have no registry run

    def attach_autoscaler(self, **kwargs: Any) -> Any:
        from polyaxon_tpu_torch.serving.autoscaler import FleetAutoscaler

        self.autoscaler = FleetAutoscaler(self, **kwargs)
        return self.autoscaler

    def poll(self) -> None:
        """Thread-free pump: reap
        replicas whose subprocess died out from under us (a SIGKILLed
        corpse would otherwise sit ejected forever, pinning autoscaler
        membership at a capacity the router cannot route to), probe
        when no router thread owns it, then tick the autoscaler."""
        for name, ref in list(self._procs.items()):
            if ref.poll() is not None:
                self.retire_replica(name)
        if getattr(self.router, "_thread", None) is None:
            self.router.probe_all()
        if self.autoscaler is not None:
            t0 = time.perf_counter()
            try:
                self.autoscaler.evaluate()
            finally:
                _observe_autoscaler_phase(
                    self.router, time.perf_counter() - t0
                )


class ServingFleet:
    """Control-plane fleet: replicas are ``kind: service`` registry runs.

    ``declarations`` are the per-replica run declarations (model shape,
    ``slots``, ``seq``, optionally ``target`` for checkpointed weights);
    ``environment`` the runs' environment block; without one each replica
    runs on one card, as every run whose spec names no accelerator does
    (``schemas/environments.py:CARD_TOPOLOGY``), and its worker raises on a
    host without one.  Name a ``cpu-1`` topology to run them on the CPU.

    Drive with ``poll()`` from the pump loop.  It (1) registers replica
    ``service_url``s on the router as gangs come up, (2) probes when no
    router thread is running, and (3) advances drain→replace operations
    opened by :meth:`request_drain_replace` (the remediation engine's
    entry point).
    """

    ACTION = "drain_replace"

    def __init__(
        self,
        orch: Any,
        *,
        name: str = "fleet",
        declarations: Optional[Dict[str, Any]] = None,
        environment: Optional[Dict[str, Any]] = None,
        replicas: Optional[int] = None,
        drain_deadline_s: Optional[float] = None,
        ready_timeout_s: Optional[float] = None,
        router: Optional[FleetRouter] = None,
    ) -> None:
        self.orch = orch
        self.name = name
        self.declarations = dict(declarations or {})
        self.environment = dict(environment or {})
        self.replicas = (
            replicas
            if replicas is not None
            else knob_int("POLYAXON_TPU_FLEET_REPLICAS")
        )
        self.drain_deadline_s = (
            drain_deadline_s
            if drain_deadline_s is not None
            else knob_float("POLYAXON_TPU_FLEET_DRAIN_DEADLINE_S")
        )
        self.ready_timeout_s = (
            ready_timeout_s
            if ready_timeout_s is not None
            else knob_float("POLYAXON_TPU_FLEET_READY_TIMEOUT_S")
        )
        self.router = router if router is not None else FleetRouter()
        self.autoscaler: Optional[Any] = None
        #: replica name → registry run id (current membership).
        self._runs: Dict[str, int] = {}
        #: old run id → in-flight drain/replace operation state.
        self._ops: Dict[int, Dict[str, Any]] = {}
        #: replica name → ``finished_at`` of the newest slow-request
        #: exemplar already landed as a ``ttft_slow`` anomaly row.
        self._exemplar_seen: Dict[str, float] = {}
        self._exemplar_harvest_at = 0.0
        self._counter = itertools.count()
        orch.fleets.append(self)
        orch.remediation.register_fleet(self)

    # -- membership ------------------------------------------------------------
    def start(self) -> "ServingFleet":
        for _ in range(self.replicas):
            self._submit_replica()
        return self

    def _submit_replica(self) -> str:
        name = f"{self.name}-r{next(self._counter)}"
        run = self.orch.submit(
            {
                "kind": "service",
                "declarations": dict(self.declarations),
                "environment": dict(self.environment),
            },
            name=name,
        )
        self._runs[name] = run.id
        return name

    def run_ids(self) -> Dict[str, int]:
        return dict(self._runs)

    def handles_run(self, run_id: int) -> bool:
        return run_id in self._runs.values()

    def _name_for(self, run_id: int) -> Optional[str]:
        for name, rid in self._runs.items():
            if rid == run_id:
                return name
        return None

    # -- resize protocol (FleetAutoscaler) -------------------------------------
    def scale_up(self) -> str:
        return self._submit_replica()

    def retire_replica(self, name: str) -> None:
        run_id = self._runs.pop(name, None)
        if run_id is not None:
            try:
                self.orch.stop_run(run_id, actor="autoscaler")
            except Exception:
                pass
        self.router.remove_replica(name)

    def run_id_for(self, name: str) -> Optional[int]:
        return self._runs.get(name)

    def attach_autoscaler(self, **kwargs: Any) -> Any:
        from polyaxon_tpu_torch.serving.autoscaler import FleetAutoscaler

        self.autoscaler = FleetAutoscaler(self, **kwargs)
        return self.autoscaler

    # -- remediation entry point -----------------------------------------------
    def request_drain_replace(
        self, run_id: int, rem_id: int, rule: str
    ) -> bool:
        """Open a drain→replace operation on a replica run (called by
        the remediation engine on a firing alert edge).  Synchronous
        part is flag-flips only; the heavy lifting happens in
        :meth:`poll`."""
        name = self._name_for(run_id)
        if name is None or run_id in self._ops:
            return False
        self._ops[run_id] = {
            "name": name,
            "rem_id": rem_id,
            "rule": rule,
            "phase": "draining",
            "deadline": time.time() + self.drain_deadline_s,
        }
        # Best-effort: the engine 503s new admissions while it finishes
        # in-flight work.  A wedged/dead replica never acks — the router
        # drain deadline covers that.
        try:
            self.orch.send_command(
                run_id, "drain", payload={"rule": rule}, actor="remediation"
            )
        except Exception:
            pass
        self.router.drain(name, deadline_s=self.drain_deadline_s)
        return True

    #: Seconds between exemplar-harvest sweeps — a /v1/stats fetch per
    #: replica, so it must not ride every 50 ms pump tick.
    EXEMPLAR_HARVEST_INTERVAL_S = 2.0

    # -- pump ------------------------------------------------------------------
    def poll(self) -> None:
        self._register_urls()
        if getattr(self.router, "_thread", None) is None:
            self.router.probe_all()
        now = time.time()
        self._harvest_exemplars(now)
        for run_id in list(self._ops):
            op = self._ops[run_id]
            if op["phase"] == "draining":
                self._poll_draining(run_id, op, now)
            elif op["phase"] == "replacing":
                self._poll_replacing(run_id, op, now)
        if self.autoscaler is not None:
            t0 = time.perf_counter()
            try:
                self.autoscaler.evaluate(now)
            finally:
                _observe_autoscaler_phase(
                    self.router, time.perf_counter() - t0
                )

    def _register_urls(self) -> None:
        for name, run_id in list(self._runs.items()):
            if self.router.replica(name) is not None:
                continue
            try:
                run = self.orch.get_run(run_id)
            except Exception:
                continue
            if run.service_url:
                self.router.add_replica(name, run.service_url)

    def _harvest_exemplars(self, now: float) -> None:
        """Land each replica's slow-request exemplars as ``ttft_slow``
        anomaly rows + a run-artifact JSON dump.

        The engine keeps a bounded ring of the slowest fully-traced
        requests per window (``trace_exemplars`` on ``/v1/stats``); the
        control plane copies anything newer than the last sweep into the
        replica run's ``reports/`` dir and records the run-relative key
        on the anomaly row — exactly the flight-recorder ``stall``
        contract, so a firing ``serving_ttft_p99`` alert attaches it via
        ``RuleContext.dump_artifact("ttft_slow")``.
        """
        if now - self._exemplar_harvest_at < self.EXEMPLAR_HARVEST_INTERVAL_S:
            return
        self._exemplar_harvest_at = now
        registry = getattr(self.orch, "registry", None)
        layout = getattr(self.orch, "layout", None)
        if registry is None or layout is None:
            return
        for name, run_id in list(self._runs.items()):
            rep = self.router.replica(name)
            if rep is None or rep.state not in ("ready", "draining"):
                continue
            try:
                code, body = _http_json(
                    rep.base_url + "/v1/stats",
                    timeout=self.router.probe_timeout_s,
                )
            except Exception:
                continue
            if code != 200:
                continue
            exemplars = body.get("trace_exemplars") or []
            newest = max(
                (float(e.get("finished_at") or 0.0) for e in exemplars),
                default=0.0,
            )
            if not exemplars or newest <= self._exemplar_seen.get(name, 0.0):
                continue
            try:
                run = self.orch.get_run(run_id)
                paths = layout.run_paths(run.uuid)
                paths.reports.mkdir(parents=True, exist_ok=True)
                fname = f"ttft_exemplars_{int(newest * 1000)}.json"
                (paths.reports / fname).write_text(
                    json.dumps(
                        {"replica": name, "exemplars": exemplars}, indent=2
                    )
                )
                registry.add_anomaly(
                    run_id,
                    "ttft_slow",
                    message=(
                        f"{len(exemplars)} slow-request exemplar(s) "
                        f"from {name}"
                    ),
                    attrs={
                        "dump_artifact": f"reports/{fname}",
                        "trace_ids": [
                            e.get("trace_id") for e in exemplars
                        ],
                    },
                )
            except Exception:
                continue
            self._exemplar_seen[name] = newest

    def _poll_draining(
        self, run_id: int, op: Dict[str, Any], now: float
    ) -> None:
        name = op["name"]
        rep = self.router.replica(name)
        drained = rep is None or rep.state in ("drained",)
        if not drained and now < op["deadline"]:
            return
        # Drained (or deadline): stop the old run, cut it from routing,
        # and bring up the replacement.
        try:
            self.orch.stop_run(run_id, actor="remediation")
        except Exception:
            pass
        self.router.remove_replica(name)
        self._runs.pop(name, None)
        replacement = self._submit_replica()
        op["phase"] = "replacing"
        op["replacement"] = replacement
        op["deadline"] = now + self.ready_timeout_s
        self._update_rem(
            op,
            attrs={
                "phase": "replacing",
                "replacement": replacement,
                "replacement_run_id": self._runs[replacement],
                "drain_timed_out": not drained,
            },
            message=f"drained {name}; replacing with {replacement}",
        )

    def _poll_replacing(
        self, run_id: int, op: Dict[str, Any], now: float
    ) -> None:
        from polyaxon_tpu_torch.db.registry import RemediationStatus

        rep = self.router.replica(op.get("replacement", ""))
        if rep is not None and rep.state == "ready":
            self._update_rem(
                op,
                status=RemediationStatus.SUCCEEDED,
                attrs={"phase": "done"},
                message=(
                    f"replacement {op['replacement']} ready — routing resumed"
                ),
            )
            self._ops.pop(run_id, None)
            return
        if now >= op["deadline"]:
            self._update_rem(
                op,
                status=RemediationStatus.FAILED,
                attrs={"phase": "failed"},
                message=(
                    f"replacement {op.get('replacement')} missed the "
                    f"{self.ready_timeout_s:.0f}s ready deadline"
                ),
            )
            self._ops.pop(run_id, None)

    def _update_rem(self, op: Dict[str, Any], **kwargs: Any) -> None:
        try:
            self.orch.registry.update_remediation(op["rem_id"], **kwargs)
        except Exception:
            logger.exception(
                "fleet %s: could not record %s on remediation %s",
                self.name, kwargs.get("attrs"), op["rem_id"],
            )

    # -- introspection ---------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        st = self.router.stats()
        return {
            "name": self.name,
            "replicas": {
                name: {"run_id": rid} for name, rid in self._runs.items()
            },
            "router": st,
            "open_ops": {
                rid: {k: v for k, v in op.items() if k != "deadline"}
                for rid, op in self._ops.items()
            },
            "autoscaler": (
                self.autoscaler.status() if self.autoscaler is not None else None
            ),
        }

    def stop(self) -> None:
        self.router.stop()
        self.orch.remediation.unregister_fleet(self)
        if self in self.orch.fleets:
            self.orch.fleets.remove(self)
