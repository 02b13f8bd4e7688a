"""The control-plane service, the port's copy of ``polyaxon_tpu/orchestrator.py``:
one object wiring the registry (state), the task bus, the auditor and the
executor (events), the spawner and the watcher (the gang layer), the alert
and remediation engines, the metric history, the notifier, the tracker and
the crons.  It runs the port's runs: the spawner launches the port's worker,
one rank process a card (``spawner/local.py``); the search tasks
(``hpsearch/``) run a group's sweep and the pipeline tasks (``polyflow/``)
a pipeline's ops, as trial and op runs of the same chain.  Nothing here
imports torch, so building an orchestrator initialises no CUDA.

Two operating modes:

- **eager** (tests, notebooks): :meth:`pump` / :meth:`wait` drive the task
  graph in the calling thread;
- **service**: :meth:`start` runs the bus on a background thread with the
  beat crons and holds the control-plane lease on a timer thread.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from polyaxon_tpu_torch.auditor import Auditor
from polyaxon_tpu_torch.db import Run, RunRegistry
from polyaxon_tpu_torch.events import EventTypes
from polyaxon_tpu_torch.exceptions import PolyaxonTPUError
from polyaxon_tpu_torch.executor import ExecutorHandlers
from polyaxon_tpu_torch.lifecycles import StatusOptions as S
from polyaxon_tpu_torch.monitor import GangWatcher
from polyaxon_tpu_torch.schemas import PolyaxonFile
from polyaxon_tpu_torch.schemas.specifications import BaseSpecification, Kinds
from polyaxon_tpu_torch.scheduler.tasks import SchedulerContext, register_scheduler_tasks
from polyaxon_tpu_torch.stores import StoreLayout
from polyaxon_tpu_torch.workers import CronTasks, SchedulerTasks, TaskBus

logger = logging.getLogger(__name__)


class Orchestrator:
    #: Control-plane lease cadence/TTL: a service refreshes every interval;
    #: another control plane treats the lease as live within the TTL.
    LEASE_KEY = "platform.lease"
    LEASE_INTERVAL = 5.0
    LEASE_TTL = 15.0

    def __init__(
        self,
        base_dir: Union[str, Path],
        *,
        time_scale: float = 1.0,
        monitor_interval: Optional[float] = None,
        heartbeat_interval: Optional[float] = None,
        heartbeat_ttl: Optional[float] = None,
        heartbeat_check_interval: Optional[float] = None,
    ) -> None:
        self.base_dir = Path(base_dir)
        self.layout = StoreLayout(self.base_dir)
        self.registry = RunRegistry(self.base_dir / "registry.db")
        from polyaxon_tpu_torch.conf import ConfService

        # Explicit arguments win; otherwise options resolve through the
        # conf stores (DB option table -> env -> default).
        self.conf = ConfService(
            self.registry,
            encryptor=self._build_encryptor(self.base_dir),
        )
        conf = self.conf
        monitor_interval = (
            monitor_interval
            if monitor_interval is not None
            else conf.get("scheduler.monitor_interval")
        )
        heartbeat_interval = (
            heartbeat_interval
            if heartbeat_interval is not None
            else conf.get("worker.heartbeat_interval")
        )
        heartbeat_ttl = (
            heartbeat_ttl
            if heartbeat_ttl is not None
            else conf.get("scheduler.heartbeat_ttl")
        )
        heartbeat_check_interval = (
            heartbeat_check_interval
            if heartbeat_check_interval is not None
            else conf.get("scheduler.heartbeat_check_interval")
        )
        from polyaxon_tpu_torch.stats import MemoryStats, NoOpStats, StatsdStats

        stats_kind = conf.get("stats.backend")
        if stats_kind == "statsd":
            self.stats = StatsdStats(
                conf.get("stats.statsd_host"), conf.get("stats.statsd_port")
            )
        elif stats_kind == "noop":
            self.stats = NoOpStats()
        else:
            self.stats = MemoryStats()
        # Registry self-telemetry (op-family latency + lock wait/hold)
        # attaches after the fact: the registry must exist first because
        # the stats-backend *choice* is read through it.
        self.registry.attach_stats(self.stats)
        self.bus = TaskBus(time_scale=time_scale, stats=self.stats)
        self.auditor = Auditor(self.registry)
        self.executor = ExecutorHandlers(self.bus)
        self.auditor.subscribe(self.executor)
        # Usage analytics (reference tracker/): per-event counters on the
        # stats backend; external publish only when explicitly configured.
        from polyaxon_tpu_torch.tracker import CLUSTER_ID_KEY, Tracker

        cluster_id = self.registry.get_option(CLUSTER_ID_KEY)
        if not cluster_id:
            import uuid as _uuid

            cluster_id = _uuid.uuid4().hex
            self.registry.set_option(CLUSTER_ID_KEY, cluster_id)
        self.auditor.subscribe(
            Tracker(
                self.stats,
                endpoint=conf.get("tracker.endpoint"),
                cluster_id=cluster_id,
            )
        )
        from polyaxon_tpu_torch.conf.knobs import knob_str

        # Opt-in done/failed notifications (reference notifier/actions +
        # actions/registry/webhooks). Conf-driven; the legacy env vars keep
        # working through the option store's env resolution order.
        webhook = conf.get("notifier.webhook_url") or knob_str(
            "POLYAXON_TPU_WEBHOOK_URL"
        )
        kind = conf.get("notifier.webhook_kind") or knob_str(
            "POLYAXON_TPU_WEBHOOK_KIND"
        )
        actions = []
        if webhook:
            from polyaxon_tpu_torch.notifier import WebhookAction
            from polyaxon_tpu_torch.notifier.actions import SHAPERS, pagerduty_shaper

            if kind == "pagerduty":
                shaper = pagerduty_shaper(conf.get("notifier.pagerduty_routing_key"))
            else:
                shaper = SHAPERS.get(kind)
            actions.append(WebhookAction(webhook, shaper=shaper))
        email_host = conf.get("notifier.email_host")
        email_to = conf.get("notifier.email_to")
        if email_host and email_to:
            from polyaxon_tpu_torch.notifier.actions import EmailAction

            actions.append(
                EmailAction(
                    host=email_host,
                    port=conf.get("notifier.email_port"),
                    sender=conf.get("notifier.email_from"),
                    recipients=[r.strip() for r in email_to.split(",") if r.strip()],
                    use_tls=conf.get("notifier.email_tls"),
                    username=conf.get("notifier.email_user") or None,
                    password=conf.get("notifier.email_password") or None,
                )
            )
        if actions:
            from polyaxon_tpu_torch.notifier import Notifier

            self.auditor.subscribe(
                Notifier(
                    actions,
                    event_types=[
                        EventTypes.EXPERIMENT_SUCCEEDED,
                        EventTypes.EXPERIMENT_FAILED,
                        EventTypes.EXPERIMENT_ZOMBIE,
                        EventTypes.GROUP_DONE,
                        EventTypes.PIPELINE_DONE,
                    ],
                    stats=self.stats,
                )
            )
        # Alert-engine fan-out: named sinks + severity routing.  The log
        # sink is always present, so a deployment with no webhook still
        # sees its pages in the control-plane log.
        from polyaxon_tpu_torch.notifier import LogAction
        from polyaxon_tpu_torch.notifier.service import AlertRouter, parse_alert_routes

        alert_sinks = {"log": LogAction()}
        for action in actions:
            alert_sinks[action.name] = action
        self.alert_router = AlertRouter(
            alert_sinks,
            routes=parse_alert_routes(conf.get("notifier.alert_routes")),
            stats=self.stats,
        )
        self.auditor.subscribe(self.alert_router)
        from polyaxon_tpu_torch.spawner.remote import spawner_from_conf

        self.spawner = spawner_from_conf(
            self.layout, conf, heartbeat_interval=heartbeat_interval
        )
        # Metric history: an in-process TSDB of ring-buffer series with
        # staged rollups, persisted through the registry's metric_samples
        # table.  The scraper runs as its own monitor-tick phase; disable
        # via POLYAXON_TPU_TSDB_ENABLED for minimal-footprint deployments.
        from polyaxon_tpu_torch.conf.knobs import knob_bool, knob_float, knob_int
        from polyaxon_tpu_torch.stats.tsdb import MetricScraper, MetricStore

        self.metrics: Optional[MetricStore] = None
        self.scraper: Optional[MetricScraper] = None
        if knob_bool("POLYAXON_TPU_TSDB_ENABLED"):
            self.metrics = MetricStore(
                raw_points=knob_int("POLYAXON_TPU_TSDB_RAW_POINTS"),
                rollup_points=knob_int("POLYAXON_TPU_TSDB_ROLLUP_POINTS"),
                max_series=knob_int("POLYAXON_TPU_TSDB_MAX_SERIES"),
                pending_max=knob_int("POLYAXON_TPU_TSDB_PENDING_MAX"),
            )
            self.scraper = MetricScraper(
                self.metrics,
                stats=self.stats,
                registry=self.registry,
                fleets=lambda: self.fleets,
                interval_s=knob_float("POLYAXON_TPU_TSDB_SCRAPE_INTERVAL_S"),
                flush_rows=knob_int("POLYAXON_TPU_TSDB_FLUSH_ROWS"),
            )
            # Warm restart: replay the last hour of persisted raw samples
            # so rate()/burn windows don't start cold after a reboot.
            try:
                self.metrics.hydrate(
                    self.registry.get_metric_samples(
                        agg="raw", since=time.time() - 3600.0
                    )
                )
            except Exception:
                logger.warning("Metric history hydrate failed", exc_info=True)
        # The stats backend lets the watcher's stall/straggler detector
        # export its alarm gauges on /metrics; the metric store collects
        # the per-run history series behind the query API.
        self.watcher = GangWatcher(
            self.registry, stats=self.stats, metrics=self.metrics
        )
        # The alert engine ticks in the same monitor task as the watcher,
        # turning the signal tables into a pending→firing→resolved feed.
        from polyaxon_tpu_torch.monitor import AlertEngine

        self.alerts = AlertEngine(
            self.registry,
            stats=self.stats,
            auditor=self.auditor,
            metrics=self.metrics,
        )
        # The remediation engine closes the detection→action loop: alert
        # firing edges trigger checkpoint-now/eviction through the command
        # bus, and FAILED gangs relaunch from their latest complete
        # checkpoint instead of step 0.
        from polyaxon_tpu_torch.monitor import RemediationEngine

        self.remediation = RemediationEngine(
            self.registry,
            stats=self.stats,
            auditor=self.auditor,
            sender=self.send_command,
        )
        #: Serving fleets (serving/fleet.py:ServingFleet) registered on
        #: this control plane — the check_fleet probe and the fleet API
        #: read replica/router state from here.
        self.fleets: List[Any] = []
        artifacts_url = conf.get("stores.artifacts_url")
        self.artifact_store = None
        if artifacts_url:
            from polyaxon_tpu_torch.stores import artifact_store_from_url

            self.artifact_store = artifact_store_from_url(artifacts_url)
        self.ctx = SchedulerContext(
            registry=self.registry,
            bus=self.bus,
            auditor=self.auditor,
            layout=self.layout,
            spawner=self.spawner,
            watcher=self.watcher,
            alerts=self.alerts,
            remediation=self.remediation,
            monitor_interval=monitor_interval,
            heartbeat_ttl=heartbeat_ttl,
            terminal_grace=conf.get("scheduler.terminal_grace"),
            monitor_failure_streak=conf.get("scheduler.monitor_failure_streak"),
            queued_redispatch_ttl=conf.get("scheduler.queued_redispatch_ttl"),
            artifact_store=self.artifact_store,
            scraper=self.scraper,
        )
        register_scheduler_tasks(self.ctx)
        from polyaxon_tpu_torch.hpsearch import HPContext, register_hp_tasks

        register_hp_tasks(
            HPContext(registry=self.registry, bus=self.bus, auditor=self.auditor)
        )
        from polyaxon_tpu_torch.polyflow import PipelineContext, register_pipeline_tasks

        register_pipeline_tasks(
            PipelineContext(
                registry=self.registry, bus=self.bus, auditor=self.auditor
            )
        )
        self._heartbeat_check_interval = heartbeat_check_interval
        import uuid as _uuid

        self._lease_id = _uuid.uuid4().hex

    # -- lifecycle ------------------------------------------------------------
    def refresh_lease(self) -> None:
        self.registry.set_option(
            self.LEASE_KEY, {"owner": self._lease_id, "at": time.time()}
        )

    def another_control_plane_active(self) -> bool:
        """Is a different control plane currently holding the lease?

        Guards :meth:`recover`: a CLI invocation over the base dir of a
        live ``serve`` must not reattach/re-dispatch the gangs that service
        is actively monitoring.
        """
        lease = self.registry.get_option(self.LEASE_KEY)
        return bool(
            lease
            and lease.get("owner") != self._lease_id
            and time.time() - float(lease.get("at", 0)) < self.LEASE_TTL
        )

    def recover(self) -> int:
        """Re-dispatch work stranded by a control-plane restart.

        The registry is durable; the task bus is not. Runs whose dispatch
        task died with the previous process re-enter the build→start chain,
        and sweeps/pipelines get their driving task re-kicked (the
        reference reconciles equivalent state from the k8s API on startup,
        SURVEY §3.2). Gang-phase runs (scheduled/starting/running) have no
        live handle in this process — the heartbeat cron zombies them and
        the restart policy revives what it can.
        """
        from polyaxon_tpu_torch.workers import HPTasks, PipelineTasks

        if self.another_control_plane_active():
            import logging

            logging.getLogger(__name__).info(
                "Skipping recovery: another control plane holds the lease"
            )
            return 0
        n = 0
        for run in self.registry.list_runs(statuses=[S.CREATED, S.QUEUED]):
            if run.kind == Kinds.GROUP:
                # A group with trials already created must not re-create
                # them; re-kick the wave instead.
                has_trials = bool(self.registry.list_runs(group_id=run.id))
                self.bus.send(
                    HPTasks.START if has_trials else HPTasks.CREATE,
                    {"group_id": run.id},
                )
            elif run.kind == Kinds.PIPELINE:
                has_ops = bool(self.registry.list_runs(pipeline_id=run.id))
                self.bus.send(
                    PipelineTasks.CHECK if has_ops else PipelineTasks.START,
                    {"pipeline_id": run.id},
                )
            elif run.status == S.CREATED and (run.group_id or run.pipeline_id):
                # Wave/DAG scheduling owns dispatch of member runs — direct
                # re-entry would bypass concurrency windows and DAG order.
                continue
            else:
                self.bus.send(SchedulerTasks.EXPERIMENTS_BUILD, {"run_id": run.id})
            n += 1
        # Gang-phase runs: reattach to the live gang via the shared run dir
        # (remote rc/pid files, local pgid liveness) and resume monitoring;
        # a gang that can't be reattached is re-dispatched without touching
        # the run's restart budget — a control-plane restart is not the
        # run's failure.
        from polyaxon_tpu_torch.compiler import compile_gang_plan
        from polyaxon_tpu_torch.workers import SchedulerTasks as ST

        gang_phase = self.registry.list_runs(
            statuses=[S.SCHEDULED, S.STARTING, S.RUNNING, S.STOPPING]
        )
        redispatched = set()
        for run in gang_phase:
            if run.kind in (Kinds.GROUP, Kinds.PIPELINE) or run.id in self.ctx.gangs:
                continue
            if run.status == S.STOPPING:
                # The stop task died mid-flight. Reattach first so the stop
                # actually signals the (possibly still live) gang — without
                # a handle experiments_stop would mark the run STOPPED and
                # free its slice while the workers keep holding the chips.
                try:
                    plan = compile_gang_plan(run.spec)
                    handle = self.spawner.reattach(
                        run, plan, self.registry.get_processes(run.id)
                    )
                except PolyaxonTPUError:
                    handle = None
                if handle is not None:
                    self.ctx.gangs[run.id] = handle
                self.bus.send(SchedulerTasks.EXPERIMENTS_STOP, {"run_id": run.id})
                n += 1
                continue
            try:
                plan = compile_gang_plan(run.spec)
            except PolyaxonTPUError:
                continue  # was admitted once; a compile break now is terminal
            handle = self.spawner.reattach(
                run, plan, self.registry.get_processes(run.id)
            )
            attach = False
            if handle is not None:
                if any(ref.poll() is None for ref in handle.processes.values()):
                    attach = True  # gang still live: resume monitoring
                else:
                    # Every member is gone. Drain the report tail first —
                    # a gang that FINISHED while the control plane was down
                    # left terminal status lines — then decide: reported
                    # terminal = let the monitor finalize it; no terminal
                    # report = the gang died with the old control plane
                    # (e.g. took its TERM), which must not burn the run's
                    # restart budget.
                    self.watcher.ingest(handle)
                    procs = self.registry.get_processes(run.id)
                    terminal = (S.SUCCEEDED, S.FAILED, S.STOPPED)
                    attach = bool(procs) and all(
                        p["status"] in terminal for p in procs
                    )
            if attach:
                self.ctx.gangs[run.id] = handle
                self.bus.send(SchedulerTasks.EXPERIMENTS_MONITOR, {"run_id": run.id})
            else:
                self.registry.clear_processes(run.id)
                for process_id in range(plan.num_hosts):
                    report = self.layout.run_paths(run.uuid).report_file(process_id)
                    if report.exists():
                        report.rename(report.with_suffix(".jsonl.lost"))
                self.registry.set_status(
                    run.id,
                    S.WARNING,
                    message="gang lost across control-plane restart; re-dispatching",
                )
                self.bus.send(ST.EXPERIMENTS_START, {"run_id": run.id})
                redispatched.add(run.id)
            n += 1
        for run in self.registry.list_runs(statuses=[S.WARNING]):
            # A WARNING run is a restart whose EXPERIMENTS_START task died
            # with the previous bus; the send is idempotent under the gate.
            if run.id not in self.ctx.gangs and run.id not in redispatched:
                self.bus.send(SchedulerTasks.EXPERIMENTS_START, {"run_id": run.id})
                n += 1
        for group in self.registry.list_runs(kind=Kinds.GROUP, statuses=[S.RUNNING]):
            self.bus.send(HPTasks.START, {"group_id": group.id})
            n += 1
        for pipe in self.registry.list_runs(kind=Kinds.PIPELINE, statuses=[S.RUNNING]):
            self.bus.send(PipelineTasks.CHECK, {"pipeline_id": pipe.id})
            n += 1
        return n

    def start(self) -> None:
        self.refresh_lease()
        self.recover()
        # The lease refresh runs on its own timer thread, NOT as a bus
        # cron: a long blocking bus task (e.g. a multi-GB artifact sync)
        # would starve a cron-based refresh past LEASE_TTL, making a
        # concurrent CLI invocation misread the live service as dead and
        # steal its gangs.
        import threading

        self._lease_stop = threading.Event()

        def _lease_loop() -> None:
            while not self._lease_stop.wait(self.LEASE_INTERVAL):
                try:
                    self.refresh_lease()
                except Exception:  # registry closed mid-shutdown
                    import logging

                    logging.getLogger(__name__).exception("lease refresh failed")
            # Release on the way out, not only in stop(): if stop()'s join
            # timed out while a refresh was blocked on the DB, that refresh
            # would otherwise resurrect the lease AFTER stop() deleted it,
            # stalling the next control plane's recovery for a full TTL.
            try:
                self._release_lease()
            except Exception:
                pass

        self._lease_thread = threading.Thread(
            target=_lease_loop, name="lease-refresh", daemon=True
        )
        self._lease_thread.start()
        self.bus.add_cron(CronTasks.HEARTBEAT_CHECK, self._heartbeat_check_interval)
        self.bus.add_cron(
            CronTasks.CLEAN_ACTIVITY,
            3600.0,
            {"retention_seconds": self.conf.get("logs.retention_days") * 86400.0},
        )
        # Archived-run purge (reference DELETE_ARCHIVED_* beat entries,
        # ``celery_settings.py:740-860``): archived runs past the TTL are
        # deleted outright, data and all.
        self.bus.add_cron(
            CronTasks.CLEAN_ARCHIVES,
            3600.0,
            {"ttl_seconds": self.conf.get("cleaning.archives_ttl_days") * 86400.0},
        )
        self.bus.start()

    def _release_lease(self) -> None:
        """Delete the lease iff this control plane owns it (idempotent)."""
        lease = self.registry.get_option(self.LEASE_KEY)
        if lease and lease.get("owner") == self._lease_id:
            self.registry.delete_option(self.LEASE_KEY)

    @staticmethod
    def _build_encryptor(base_dir: Path):
        """Secret-at-rest encryptor, or None when `cryptography` is absent
        (optional dependency): secrets then store plaintext — the pre-
        round-4 behavior — rather than bricking every startup."""
        try:
            from polyaxon_tpu_torch.conf.encryptor import Encryptor

            return Encryptor.from_base_dir(base_dir)
        except ImportError:
            import logging

            logging.getLogger(__name__).warning(
                "cryptography not installed — secret options will be stored "
                "unencrypted (pip install cryptography to enable at-rest "
                "encryption)"
            )
            return None

    def stop(self) -> None:
        stopper = getattr(self, "_lease_stop", None)
        if stopper is not None:
            stopper.set()
            self._lease_thread.join(timeout=2.0)
        # Clean shutdown releases the lease so the next control plane
        # recovers immediately instead of waiting out the TTL. (If the
        # join above timed out, the lease thread re-releases on exit.)
        self._release_lease()
        self.bus.stop()
        for run_id in list(self.ctx.gangs):
            handle = self.ctx.gangs.pop(run_id)
            self.spawner.stop(handle)
        self.registry.close()

    # -- client surface (the API layer calls these) ---------------------------
    def submit(
        self,
        spec: Union[str, Dict[str, Any], BaseSpecification],
        *,
        project: str = "default",
        name: Optional[str] = None,
        tags: Optional[list] = None,
        actor: Optional[str] = None,
    ) -> Run:
        """Create a run from a spec and fire its created event.

        The reference equivalent is POST /experiments → signals → auditor →
        executor (SURVEY §3.1).
        """
        if not isinstance(spec, BaseSpecification):
            spec = PolyaxonFile.load(spec).specification
        run = self.registry.create_run(spec, project=project, name=name, tags=tags)
        from polyaxon_tpu_torch.events import created_event_for_kind

        event_type, key = created_event_for_kind(run.kind)
        # Actor attribution (reference events carry actor attributes,
        # ``events/event.py:41``): who did it rides the activity feed.
        extra = {"actor": actor} if actor else {}
        self.auditor.record(event_type, **{key: run.id}, **extra)
        return run

    def register_device(
        self,
        name: str,
        accelerator: str,
        chips: int,
        num_hosts: int = 1,
        actor: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Add slice capacity and immediately re-kick admission — queued
        runs and window-clamped sweeps must not wait for an unrelated run
        to finish before seeing the new inventory."""
        device = self.registry.register_device(
            name, accelerator, chips, num_hosts=num_hosts
        )
        self.auditor.record(
            EventTypes.CLUSTER_NODE_UPDATED,
            device=name,
            **({"actor": actor} if actor else {}),
        )
        self.bus.send(SchedulerTasks.ADMISSION_CHECK, {})
        return device

    def stop_run(self, run_id: int, actor: Optional[str] = None) -> None:
        run = self.registry.get_run(run_id)
        extra = {"actor": actor} if actor else {}
        if run.kind == Kinds.GROUP:
            # Stop all trials, then the group itself.
            for trial in self.registry.list_runs(group_id=run_id):
                if not trial.is_done:
                    self.bus.send(
                        SchedulerTasks.EXPERIMENTS_STOP,
                        {"run_id": trial.id, **extra},
                    )
            if self.registry.set_status(run_id, S.STOPPED):
                self.auditor.record(EventTypes.GROUP_STOPPED, group_id=run_id, **extra)
            return
        # The actor rides the stop task so the scheduler's single real
        # stop event carries who asked for it — no phantom/duplicate stops
        # in the feed.
        self.bus.send(
            SchedulerTasks.EXPERIMENTS_STOP, {"run_id": run_id, **extra}
        )

    def get_run(self, run_id: Union[int, str]) -> Run:
        return self.registry.get_run(run_id)

    # -- run command bus (control plane → workers) -----------------------------
    def send_command(
        self,
        run_id: int,
        kind: str,
        *,
        payload: Optional[Dict[str, Any]] = None,
        processes: Optional[List[int]] = None,
        actor: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Enqueue a worker-directed command and deliver it to the gang's
        per-process mailboxes.  Returns the registry command row; a command
        to a finished run resolves immediately to a typed EXPIRED row
        instead of waiting on a gang that will never answer."""
        from polyaxon_tpu_torch.db.registry import CommandStatus

        run = self.registry.get_run(run_id)
        extra = {"actor": actor} if actor else {}
        if run.is_done:
            cmd = self.registry.enqueue_command(
                run.id,
                kind,
                payload=payload,
                expected=0,
                status=CommandStatus.EXPIRED,
                message=f"run already finished ({run.status})",
            )
            self.auditor.record(
                EventTypes.EXPERIMENT_COMMAND_SENT,
                run_id=run.id,
                kind=kind,
                status=CommandStatus.EXPIRED,
                **extra,
            )
            return cmd
        if processes is None:
            handle = self.ctx.gangs.get(run.id)
            if handle is not None:
                targets = list(range(handle.plan.num_hosts))
            else:
                rows = self.registry.get_processes(run.id)
                targets = [p["process_id"] for p in rows] or [0]
        else:
            targets = sorted({int(p) for p in processes})
        cmd = self.registry.enqueue_command(
            run.id,
            kind,
            payload=payload,
            process_id=targets[0] if len(targets) == 1 else None,
            expected=len(targets),
        )
        paths = self.layout.run_paths(run.uuid)
        body = json.dumps(
            {"uuid": cmd["uuid"], "kind": kind, "payload": payload or {}},
            default=str,
        )
        for process_id in targets:
            mailbox = paths.command_dir(process_id)
            mailbox.mkdir(parents=True, exist_ok=True)
            # Atomic drop: the worker's poll must never read a torn file.
            tmp = mailbox / f".{cmd['uuid']}.tmp"
            tmp.write_text(body)
            tmp.rename(mailbox / f"{cmd['uuid']}.json")
        self.auditor.record(
            EventTypes.EXPERIMENT_COMMAND_SENT,
            run_id=run.id,
            kind=kind,
            processes=targets,
            **extra,
        )
        return cmd

    def request_profile(
        self,
        run_id: int,
        *,
        num_steps: Optional[int] = None,
        duration_s: Optional[float] = None,
        processes: Optional[List[int]] = None,
        actor: Optional[str] = None,
    ) -> Dict[str, Any]:
        """On-demand gang-wide device profiling: a ``profile`` command whose
        uuid doubles as the capture id (one handle for the command row, the
        capture rows, and the ``profiles/<id>/`` artifact tree)."""
        payload: Dict[str, Any] = {}
        if num_steps is not None:
            payload["num_steps"] = int(num_steps)
        if duration_s is not None:
            payload["duration_s"] = float(duration_s)
        cmd = self.send_command(
            run_id, "profile", payload=payload, processes=processes, actor=actor
        )
        return {**cmd, "capture_id": cmd["uuid"]}

    # -- CI (per-project trigger; reference api/ci/ + ci/service.py) -----------
    def set_project_ci(
        self, project: str, spec, actor: Optional[str] = None
    ) -> Dict[str, Any]:
        """Enable/replace a project's CI: ``spec`` runs on every new code
        snapshot.  Validated up front — a stored CI spec must never blow
        up at trigger time."""
        if not isinstance(spec, BaseSpecification):
            spec = PolyaxonFile.load(spec).specification
        # The topology that will run, as a run row stores it
        # (``BaseSpecification.stored_dict``).
        data = spec.stored_dict()
        # Persist the build section with ONLY the fields the user set:
        # to_dict() serializes the default context '.', which after a
        # round-trip reads as explicitly set and defeats trigger_ci's
        # explicit-context guard (a default '.' would snapshot the
        # service host's cwd).
        if spec.build is not None:
            build = spec.build.to_dict(exclude_unset=True)
            if build:
                data["build"] = build
            else:
                data.pop("build", None)
        ci = self.registry.set_project_ci(project, data)
        self.auditor.record(
            EventTypes.CI_SET,
            project=project,
            **({"actor": actor} if actor else {}),
        )
        return ci

    def delete_project_ci(self, project: str, actor: Optional[str] = None) -> bool:
        removed = self.registry.delete_project_ci(project)
        if removed:
            self.auditor.record(
                EventTypes.CI_DELETED,
                project=project,
                **({"actor": actor} if actor else {}),
            )
        return removed

    def trigger_ci(
        self,
        project: str,
        context: Optional[str] = None,
        actor: Optional[str] = None,
    ) -> Optional[Run]:
        """Manual CI check: snapshot ``context`` (default: the CI spec's
        build context) and run the CI spec if the code hash is new.
        Returns the created run, or None when the code was already seen —
        the reference's repos-upload trigger, push-shaped for local mode."""
        from polyaxon_tpu_torch.ci import submit_ci_run
        from polyaxon_tpu_torch.schemas.run import BuildConfig
        from polyaxon_tpu_torch.stores import create_snapshot

        ci = self.registry.get_project_ci(project)
        if ci is None:
            raise PolyaxonTPUError(f"Project {project!r} has no CI configured")
        spec = PolyaxonFile.load(ci["spec"]).specification
        build = getattr(spec, "build", None)
        # An EXPLICIT context is required from one side or the other: the
        # default BuildConfig context '.' would snapshot the SERVICE
        # HOST's cwd, which is never the project's code.
        spec_has_context = build is not None and "context" in build.fields_set
        if context is None and not spec_has_context:
            raise PolyaxonTPUError(
                "CI trigger needs a context directory (or a 'build' section "
                "in the CI spec naming one)"
            )
        build = build or BuildConfig()
        ref = create_snapshot(
            build, context or build.context, self.layout.snapshots_dir
        )
        if not self.registry.advance_ci_code_ref(project, ref):
            return None
        return submit_ci_run(
            self.registry, self.auditor, project, spec, ref, actor=actor
        )

    # -- archival + deletion ---------------------------------------------------
    # Parity: reference archive/restore/delete views + the deletion tasks
    # (``api/experiments/views.py`` archive/restore actions,
    # ``scheduler/tasks/deletion.py``).  Archive stops a live run first —
    # an archived run must not keep burning a slice.

    def archive_run(self, run_id: int, actor: Optional[str] = None) -> bool:
        run = self.registry.get_run(run_id)
        extra = {"actor": actor} if actor else {}
        if not run.is_done:
            self.stop_run(run_id, actor=actor)
        changed = self.registry.archive_run(run_id)
        if changed:
            self.auditor.record(
                EventTypes.EXPERIMENT_ARCHIVED, run_id=run_id, **extra
            )
        return changed

    def restore_run(self, run_id: int, actor: Optional[str] = None) -> bool:
        changed = self.registry.restore_run(run_id)
        if changed:
            self.auditor.record(
                EventTypes.EXPERIMENT_RESTORED,
                run_id=run_id,
                **({"actor": actor} if actor else {}),
            )
        return changed

    def delete_run(self, run_id: int, actor: Optional[str] = None) -> int:
        """Purge a run (cascading to trials/ops), its outputs dirs, and its
        store artifacts.  Live runs are stopped SYNCHRONOUSLY first: the
        stop task must not race the row deletion on the bus."""
        run = self.registry.get_run(run_id)
        if not run.is_done:
            self.stop_run(run_id, actor=actor)
            # The stop rides the bus; deletion is destructive, so wait for
            # the gang to die rather than deleting rows out from under the
            # stop handler. A stuck stop doesn't block the purge: the
            # handler's late status writes fail harmlessly once the row is
            # gone (set_status raises on a missing run; the bus logs it).
            try:
                self.wait(run_id, timeout=10.0)
            except PolyaxonTPUError:
                pass
        victims = self.registry.delete_run(run_id)
        self._gc_run_data(victims)
        self.auditor.record(
            EventTypes.EXPERIMENT_DELETED,
            run_id=run_id,
            cascaded=len(victims) - 1,
            **({"actor": actor} if actor else {}),
        )
        return len(victims)

    def delete_project(self, name: str, actor: Optional[str] = None) -> bool:
        """Archive-then-delete flow: refuses while live runs exist, then
        purges the project row AND its archived runs' data."""
        removed, victims = self.registry.delete_project(name)
        self._gc_run_data(victims)
        if removed:
            self.auditor.record(
                EventTypes.PROJECT_DELETED,
                project=name,
                **({"actor": actor} if actor else {}),
            )
        return removed

    def _gc_run_data(self, victims: list) -> None:
        from polyaxon_tpu_torch.stores import gc_run_data

        gc_run_data(self.layout, self.artifact_store, victims)

    def clone_run(
        self, run_id: int, strategy: str = "restart", actor: Optional[str] = None
    ) -> Run:
        """Restart / resume / copy a run as a new run.

        Parity: reference restart/resume/copy views
        (``api/experiments/views.py:329-366``) + ``copy_experiment``
        (``scheduler/tasks/experiments.py:27-56``). ``resume`` and ``copy``
        both duplicate outputs+checkpoints into the clone's directories
        (the clone continues from the last checkpoint); the reference's
        shared-outputs RESUME is deliberately not reproduced — isolated
        dirs stay correct when the original is re-run concurrently.
        """
        if strategy not in ("restart", "resume", "copy"):
            raise PolyaxonTPUError(f"Unknown cloning strategy {strategy!r}")
        orig = self.registry.get_run(run_id)
        if orig.kind not in (Kinds.EXPERIMENT, Kinds.JOB, Kinds.BUILD):
            raise PolyaxonTPUError(
                f"Only experiment/job runs can be cloned, not {orig.kind!r} "
                "(restart a sweep or pipeline by submitting its spec again)"
            )
        # Deliberately NOT propagating group_id: a clone is user-initiated
        # and must not enter the sweep's wave accounting/concurrency window.
        run = self.registry.create_run(
            orig.spec,
            project=orig.project,
            name=f"{orig.name or orig.id}-{strategy}",
            original_id=orig.id,
            cloning_strategy=strategy,
            tags=orig.tags,
        )
        if orig.code_ref:
            self.registry.update_run(run.id, code_ref=orig.code_ref)
        if strategy in ("resume", "copy"):
            self.layout.copy_outputs(orig.uuid, run.uuid)
            if self.artifact_store is not None:
                # The original's local run dir may be gone (a host's local
                # disk is ephemeral; the machine may have been recycled) —
                # the artifact store is the durable source of truth.
                from polyaxon_tpu_torch.stores import run_prefix

                dst = self.layout.run_paths(run.uuid).ensure()
                for sub in ("outputs", "checkpoints"):
                    d = dst.root / sub
                    if not any(d.iterdir()):
                        self.artifact_store.download_tree(
                            f"{run_prefix(orig.uuid)}/{sub}", d
                        )
        event = (
            EventTypes.EXPERIMENT_RESUMED
            if strategy == "resume"
            else EventTypes.EXPERIMENT_CREATED
        )
        self.auditor.record(
            event, run_id=run.id, **({"actor": actor} if actor else {})
        )
        return self.registry.get_run(run.id)

    def list_artifacts(self, run_id: Union[int, str]) -> list:
        """A run's artifact keys: local run dir ∪ the durable store.

        Parity: reference outputs browsing over its store managers
        (``stores/managers/base.py:11-40``).
        """
        run = self.registry.get_run(run_id)
        paths = self.layout.run_paths(run.uuid)
        local = (
            {
                p.relative_to(paths.root).as_posix()
                for p in paths.root.rglob("*")
                if p.is_file()
            }
            if paths.root.is_dir()
            else set()
        )
        stored = set()
        if self.artifact_store is not None:
            from polyaxon_tpu_torch.stores import run_prefix

            prefix = run_prefix(run.uuid) + "/"
            stored = {
                k[len(prefix):]
                for k in self.artifact_store.list(run_prefix(run.uuid))
            }
        return sorted(local | stored)

    @staticmethod
    def _artifact_key_ok(key: str) -> bool:
        # A '..' segment must not reach the store path join — the local
        # branch's resolve() guard doesn't cover the store fallback, where
        # 'runs/<uuid>/../<other-uuid>/x' would read another run's artifacts.
        from pathlib import PurePosixPath

        p = PurePosixPath(key)
        return not p.is_absolute() and ".." not in p.parts

    def artifact_local_path(self, run_id: Union[int, str], key: str):
        """The on-disk path of a local artifact, or None (absent/unsafe key)."""
        if not self._artifact_key_ok(key):
            return None
        run = self.registry.get_run(run_id)
        paths = self.layout.run_paths(run.uuid)
        local = (paths.root / key).resolve()
        if local.is_relative_to(paths.root.resolve()) and local.is_file():
            return local
        return None

    def open_artifact(self, run_id: Union[int, str], key: str):
        """A readable binary stream (local first, store fallback); None if
        absent.  Streams — multi-GB checkpoints never land in control-plane
        memory.  Caller closes."""
        local = self.artifact_local_path(run_id, key)
        if local is not None:
            return local.open("rb")
        if self.artifact_store is not None and self._artifact_key_ok(key):
            from polyaxon_tpu_torch.stores import run_prefix

            run = self.registry.get_run(run_id)
            # One round-trip: attempt the read and treat not-found as None
            # (an exists() probe would double the gsutil subprocess cost).
            try:
                return self.artifact_store.open(f"{run_prefix(run.uuid)}/{key}")
            except PolyaxonTPUError:
                return None
        return None

    def get_artifact(self, run_id: Union[int, str], key: str) -> Optional[bytes]:
        """An artifact's bytes; None if absent. Small-payload convenience —
        prefer :meth:`open_artifact` for anything checkpoint-sized."""
        f = self.open_artifact(run_id, key)
        if f is None:
            return None
        with f:
            return f.read()

    # -- eager driving (tests; service mode doesn't need these) ----------------
    def pump(self, max_wait: float = 0.0) -> int:
        return self.bus.pump(max_wait=max_wait)

    def wait(
        self, run_id: int, timeout: float = 60.0, poll: float = 0.05
    ) -> Run:
        """Drive the bus until the run reaches a terminal status."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            self.bus.pump(max_wait=poll)
            run = self.registry.get_run(run_id)
            if run.is_done:
                return run
            time.sleep(min(poll, max(0.0, deadline - time.time())))
        raise PolyaxonTPUError(
            f"Run {run_id} not done after {timeout}s "
            f"(status={self.registry.get_run(run_id).status!r})"
        )
