"""Scheduler tasks, the port's copy of ``polyaxon_tpu/scheduler/tasks.py``:
the build -> start -> monitor -> done chain on the task bus, the stop task,
the artifact sync, admission, and the crons (activity retention, archive
purge, the heartbeat zombie check with the queued-run re-dispatch).

All tasks are closures over one :class:`SchedulerContext`, so the live gang
handles live in one place.  The port's departures:

- the spawner launches the port's worker (``spawner/local.py``), and the
  handle it returns carries the rank plan: a card plan with D devices a host
  launches D rank processes a host.  The process rows and the watcher count
  those (``range(handle.plan.num_hosts)``);
- a service's URL names the host of rank process 0.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from polyaxon_tpu_torch.auditor import Auditor
from polyaxon_tpu_torch.compiler import compile_gang_plan
from polyaxon_tpu_torch.db.registry import RegistryError, RunRegistry
from polyaxon_tpu_torch.events import EventTypes
from polyaxon_tpu_torch.exceptions import PolyaxonTPUError
from polyaxon_tpu_torch.lifecycles import StatusOptions as S
from polyaxon_tpu_torch.monitor import AlertEngine, GangWatcher, RemediationEngine
from polyaxon_tpu_torch.spawner.local import GangHandle, GangSpawner
from polyaxon_tpu_torch.stats.metrics import labeled_key
from polyaxon_tpu_torch.stores import StoreLayout, create_snapshot
from polyaxon_tpu_torch.workers import CronTasks, SchedulerTasks, TaskBus

logger = logging.getLogger(__name__)

#: Self-managed retry budget for offloaded artifact uploads (the bus Retry
#: budget can't cover them — they run off the bus thread).
ARTIFACT_SYNC_MAX_ATTEMPTS = 20


@dataclass
class SchedulerContext:
    registry: RunRegistry
    bus: TaskBus
    auditor: Auditor
    layout: StoreLayout
    spawner: GangSpawner
    watcher: GangWatcher
    #: Alert rule engine, ticked by the monitor task alongside the watcher
    #: (None = alerting off, e.g. minimal test stands).
    alerts: Optional[AlertEngine] = None
    #: Remediation policy engine — acts on alert firing edges and decides
    #: the relaunch (resume-from-checkpoint, backoff, budget).  None =
    #: legacy blind restart (minimal test stands).
    remediation: Optional[RemediationEngine] = None
    #: Live gang handles keyed by run id (the reference keeps equivalent
    #: state in k8s; a single-service control plane keeps it in-process).
    gangs: Dict[int, GangHandle] = field(default_factory=dict)
    monitor_interval: float = 0.2
    heartbeat_ttl: float = 600.0
    #: How long a logically-done gang may keep live members before the
    #: spawner forces them down (survivors hung in collectives).
    terminal_grace: float = 10.0
    #: Consecutive monitor-poll failures before the run is failed outright.
    monitor_failure_streak: int = 25
    #: How long a run may sit in QUEUED before the cron re-dispatches it.
    queued_redispatch_ttl: float = 60.0
    #: Durable artifact store (None = off-box sync disabled).
    artifact_store: Optional[object] = None
    #: Metric-history scraper (``stats.tsdb.MetricScraper``), ticked by
    #: the monitor task as its own phase; None = metric history off.
    scraper: Optional[object] = None


def _record_done(
    ctx: SchedulerContext, run_id: int, status: str, actor: Optional[str] = None
) -> None:
    # Terminal = the gang's slice goes back into the inventory; freed
    # capacity immediately re-dispatches runs queued at admission.
    if ctx.registry.release_devices(run_id):
        ctx.bus.send(SchedulerTasks.ADMISSION_CHECK, {})
    # Resolve any still-open bus commands (profile etc.) to a typed EXPIRED
    # state — a command against a gang that just finished must answer, not
    # hang PENDING forever.
    expired = ctx.registry.expire_commands(run_id)
    if expired:
        logger.info("Expired %d open command(s) on finished run %s", expired, run_id)
    if ctx.alerts is not None:
        # Close the alert lifecycle with the run: firing → resolved ("run
        # finished"), pendings dropped, alert_state gauges back to 0.
        try:
            ctx.alerts.finalize(run_id)
        except Exception:
            logger.warning(
                "Alert finalize failed for run %s", run_id, exc_info=True
            )
    if ctx.remediation is not None:
        # Mirror the command expiry above: an action row never hangs open
        # past the run's terminal state.
        try:
            ctx.remediation.finalize(run_id)
        except Exception:
            logger.warning(
                "Remediation finalize failed for run %s", run_id, exc_info=True
            )
    run = ctx.registry.get_run(run_id)
    if run.service_url:
        # A terminal service must stop advertising its (now dead) URL.
        ctx.registry.update_run(run_id, service_url=None)
    if status == S.SUCCEEDED:
        # Fold the run's summary series (MFU, goodput, tokens/s, spec
        # acceptance) into its (project, kind) regression baseline, then
        # judge the run against the baseline as it stood *before* the
        # fold — the metric_regression verdict the canary
        # promote/rollback comparator reads.
        try:
            from polyaxon_tpu_torch.conf.knobs import knob_float
            from polyaxon_tpu_torch.stats.tsdb import fold_run_baselines

            folded = fold_run_baselines(
                ctx.registry,
                run,
                alpha=knob_float("POLYAXON_TPU_BASELINE_ALPHA"),
            )
            if folded and ctx.alerts is not None:
                ctx.alerts.evaluate_regression(run, folded)
        except Exception:
            logger.warning(
                "Baseline fold failed for run %s", run_id, exc_info=True
            )
    by_status = {
        S.SUCCEEDED: EventTypes.EXPERIMENT_SUCCEEDED,
        S.FAILED: EventTypes.EXPERIMENT_FAILED,
        S.STOPPED: EventTypes.EXPERIMENT_STOPPED,
    }
    extra = {"actor": actor} if actor else {}
    if status in by_status:
        ctx.auditor.record(by_status[status], run_id=run_id, **extra)
    ctx.auditor.record(
        EventTypes.EXPERIMENT_DONE,
        run_id=run_id,
        status=status,
        group_id=run.group_id,
        pipeline_id=run.pipeline_id,
    )
    if ctx.artifact_store is not None:
        # Ship durable artifacts (outputs/checkpoints/logs) off-box once the
        # gang is fully down and the watcher flushed its final ingest.
        ctx.bus.send(SchedulerTasks.ARTIFACTS_SYNC, {"run_id": run_id})


def register_scheduler_tasks(ctx: SchedulerContext) -> None:
    bus = ctx.bus
    reg = ctx.registry
    # Tick-phase self-telemetry rides the watcher's backend (None on
    # minimal test stands → every phase probe is a no-op).
    stats = getattr(ctx.watcher, "stats", None)
    phase_keys = {
        phase: labeled_key("tick_phase_s", phase=phase)
        for phase in ("watcher", "alerts", "remediation", "retention", "scrape")
    }

    def _observe_phase(phase: str, seconds: float) -> None:
        if stats is not None:
            stats.observe(phase_keys[phase], seconds)

    @bus.register(SchedulerTasks.EXPERIMENTS_BUILD)
    def experiments_build(run_id: int) -> None:
        run = reg.get_run(run_id)
        if run.is_done:
            return
        spec = run.spec
        build = getattr(spec, "build", None)
        if build is not None and run.code_ref is None:
            if not reg.set_status(run_id, S.BUILDING):
                return
            ctx.auditor.record(EventTypes.EXPERIMENT_BUILD_STARTED, run_id=run_id)
            try:
                ref = create_snapshot(build, build.context, ctx.layout.snapshots_dir)
            except Exception as e:
                reg.set_status(run_id, S.FAILED, message=f"build failed: {e}")
                _record_done(ctx, run_id, S.FAILED)
                return
            reg.update_run(run_id, code_ref=ref)
            _maybe_trigger_ci(reg.get_run(run_id), ref)
        ctx.auditor.record(EventTypes.EXPERIMENT_BUILD_DONE, run_id=run_id)

    def _maybe_trigger_ci(run, code_ref: str) -> None:
        """New code snapshot in a CI-enabled project → submit its CI spec.

        Parity: the reference triggers ``ci.trigger(project)`` from its
        repo-upload views (``api/repos/views.py:162``); here code arrives
        as a content-hashed snapshot during the build step, so the hash IS
        the commit.  The 'ci' tag guards against self-retrigger loops, and
        ``advance_ci_code_ref``'s atomic check-and-set makes concurrent
        builds of the same ref fire exactly one CI run.
        """
        # Self-retrigger guard: the CI run itself AND its descendants (a CI
        # group's trials, a CI pipeline's ops) must not fire CI — walk up
        # the parent chain looking for the 'ci' tag.
        node, hops = run, 0
        while node is not None and hops < 8:
            if "ci" in node.tags:
                return
            parent_id = node.group_id or node.pipeline_id
            node = reg.get_run(parent_id) if parent_id else None
            hops += 1
        ci = reg.get_project_ci(run.project)
        if ci is None:
            return
        if not reg.advance_ci_code_ref(run.project, code_ref):
            return
        from polyaxon_tpu_torch.ci import submit_ci_run

        try:
            submit_ci_run(reg, ctx.auditor, run.project, ci["spec"], code_ref)
        except PolyaxonTPUError as e:
            logger.warning("CI trigger for %s failed: %s", run.project, e)

    @bus.register(SchedulerTasks.EXPERIMENTS_START)
    def experiments_start(run_id: int) -> None:
        run = reg.get_run(run_id)
        if run.is_done:
            return
        try:
            plan = compile_gang_plan(run.spec)
        except PolyaxonTPUError as e:
            reg.set_status(run_id, S.FAILED, message=f"compile failed: {e}")
            _record_done(ctx, run_id, S.FAILED)
            return
        if ctx.remediation is not None:
            # A straggler eviction recorded an elastic topology override in
            # the run's meta — every (re)launch re-applies it so the gang
            # stays on the smaller mesh across further restarts.
            try:
                plan = ctx.remediation.apply_elastic_plan(run, plan)
            except Exception:
                logger.warning(
                    "Elastic plan override failed for run %s", run_id,
                    exc_info=True,
                )
        # Gang admission (reference: scheduler/experiment_scheduler.py's
        # k8s-delegated placement; here an explicit slice inventory). No
        # inventory for the family → admission is off; otherwise the run
        # holds a whole slice from SCHEDULED until terminal.
        try:
            device = reg.acquire_device(
                run_id,
                plan.accelerator,
                plan.num_devices,
                num_slices=plan.num_slices,
                num_hosts=plan.num_hosts,
            )
        except PolyaxonTPUError as e:
            # E.g. a chips/num_slices mismatch: a caller bug, but it must
            # surface on the run (FAILED) — escaping the task would strand
            # the run in CREATED forever.
            reg.set_status(run_id, S.FAILED, message=f"admission failed: {e}")
            _record_done(ctx, run_id, S.FAILED)
            return
        if device is None:
            # Queue at admission: the QUEUED re-dispatch cron and the
            # release hook both retry this run later.
            reg.set_status(
                run_id,
                S.QUEUED,
                message=f"waiting for a free {plan.accelerator} slice "
                f"({plan.num_devices} chips)",
            )
            return
        if not reg.set_status(run_id, S.SCHEDULED):
            logger.warning("Run %s not schedulable from %s", run_id, run.status)
            if not device.get("unmanaged") and not device.get("already_held"):
                # This dispatch lost the race but newly claimed a slice:
                # give it back (the winning dispatch holds its own).
                reg.release_devices(run_id)
            return
        if plan.service_port is not None:
            # Service gang: pin the serving port now (the plan's 0 defers
            # to dispatch) — the reference's service object + proxy URL
            # equivalent.
            import dataclasses

            port = plan.service_port or ctx.spawner.allocate_service_port(run)
            plan = dataclasses.replace(
                plan,
                service_port=port,
                env_vars={
                    **plan.env_vars,
                    "POLYAXON_TPU_SERVICE_PORT": str(port),
                },
            )
        try:
            from polyaxon_tpu_torch.tracking.trace import get_tracer

            with get_tracer().span(
                "gang.spawn", run_id=run_id, hosts=plan.num_hosts
            ):
                handle = ctx.spawner.start(run, plan)
        except Exception as e:  # disk-full/permission OSErrors included —
            # anything escaping here would strand the run in SCHEDULED,
            # a status the zombie cron never scans.
            reg.set_status(run_id, S.UNSCHEDULABLE, message=str(e))
            reg.set_status(run_id, S.FAILED, message=str(e))
            _record_done(ctx, run_id, S.FAILED)
            return
        ctx.gangs[run_id] = handle
        if plan.service_port is not None:
            # Advertise only once the gang actually launched; cleared again
            # when the run goes terminal (a dead URL must not linger).  The
            # host is rank process 0's: a plan's host holds a block of
            # ``per_host`` rank processes.
            per_host = handle.plan.num_hosts // plan.num_hosts
            reg.update_run(
                run_id,
                service_url=f"http://{ctx.spawner.host_for(0, per_host)}:{plan.service_port}",
            )
        # One row per rank process: the handle's plan counts them.
        for process_id in range(handle.plan.num_hosts):
            reg.upsert_process(
                run_id, process_id, pid=handle.processes[process_id].pid, status=S.STARTING
            )
        reg.set_status(run_id, S.STARTING)
        bus.send(
            SchedulerTasks.EXPERIMENTS_MONITOR,
            {"run_id": run_id},
            countdown=ctx.monitor_interval,
        )

    def _reschedule_monitor(run_id: int) -> None:
        # A fresh send, NOT Retry: the monitor loop is unbounded by design
        # and must not consume the bus's error-retry budget.
        bus.send(
            SchedulerTasks.EXPERIMENTS_MONITOR,
            {"run_id": run_id},
            countdown=ctx.monitor_interval,
        )

    @bus.register(SchedulerTasks.EXPERIMENTS_MONITOR)
    def experiments_monitor(run_id: int) -> None:
        t0 = time.perf_counter()
        try:
            _monitor_tick(run_id)
        finally:
            if stats is not None:
                stats.observe("monitor_tick_s", time.perf_counter() - t0)

    def _monitor_tick(run_id: int) -> None:
        handle = ctx.gangs.get(run_id)
        if handle is None:
            return
        # Tick lag: how far past its scheduled cadence this poll fired —
        # near-zero while the bus keeps up, climbing when monitor ticks
        # queue behind other work (the first visible symptom of a
        # saturated control plane).
        now = time.monotonic()
        last = getattr(handle, "last_monitor_at", None)
        if stats is not None and last is not None:
            expected = ctx.monitor_interval * ctx.bus.time_scale
            stats.gauge("monitor_tick_lag_s", max(0.0, (now - last) - expected))
        handle.last_monitor_at = now
        if ctx.scraper is not None:
            # Metric-history scrape: runs every tick but internally
            # throttled to its own cadence, so a not-due pass costs
            # microseconds and per-run tick fan-out doesn't multiply the
            # cost.  Never poll-fatal.
            phase_t0 = time.perf_counter()
            try:
                ctx.scraper.tick(time.time())
            except Exception:
                logger.warning("Metric scrape failed", exc_info=True)
            finally:
                _observe_phase("scrape", time.perf_counter() - phase_t0)
        phase_t0 = time.perf_counter()
        try:
            rollup = ctx.watcher.observe(handle)
            run = reg.get_run(run_id)
        except Exception:
            # A poll failure must not orphan the run: keep polling (the
            # zombie cron is the final backstop), but give up after a
            # sustained failure streak and fail the run explicitly.
            logger.exception("Monitor poll failed for run %s", run_id)
            handle.monitor_failures += 1
            if handle.monitor_failures >= ctx.monitor_failure_streak:
                ctx.gangs.pop(run_id, None)
                ctx.spawner.stop(handle)
                reg.set_status(run_id, S.FAILED, message="monitor failed repeatedly")
                _record_done(ctx, run_id, S.FAILED)
                return
            _reschedule_monitor(run_id)
            return
        finally:
            _observe_phase("watcher", time.perf_counter() - phase_t0)
        handle.monitor_failures = 0
        if run.is_done:
            # Stopped externally while we slept.
            ctx.gangs.pop(run_id, None)
            return
        if rollup == S.RUNNING:
            reg.set_status(run_id, S.RUNNING)
            if ctx.alerts is not None:
                # Same cadence as the watcher; the engine throttles itself
                # (interval_s) and counts rule errors instead of raising —
                # but a registry-level failure here must not kill the poll.
                transitions = []
                phase_t0 = time.perf_counter()
                try:
                    transitions = ctx.alerts.evaluate(handle) or []
                except Exception:
                    logger.warning(
                        "Alert evaluation failed for run %s", run_id, exc_info=True
                    )
                finally:
                    _observe_phase("alerts", time.perf_counter() - phase_t0)
                if ctx.remediation is not None:
                    # Detection→action: firing edges trigger typed actions
                    # (checkpoint-now, eviction); the tick advances
                    # multi-phase ones.  Never poll-fatal.
                    phase_t0 = time.perf_counter()
                    try:
                        if transitions:
                            ctx.remediation.on_transitions(handle, transitions)
                        ctx.remediation.tick(handle)
                    except Exception:
                        logger.warning(
                            "Remediation tick failed for run %s",
                            run_id,
                            exc_info=True,
                        )
                    finally:
                        _observe_phase(
                            "remediation", time.perf_counter() - phase_t0
                        )
        if rollup in (S.SUCCEEDED, S.FAILED, S.SKIPPED) and not handle.all_exited:
            # Gang is logically done but members are still alive — typically
            # a survivor blocked in a collective on a dead peer. Give the
            # gang a grace window to drain, then escalate TERM → KILL across
            # monitor ticks (never a blocking wait — a 5s spawner grace per
            # stuck gang would stall every other task on the bus thread);
            # otherwise the run would sit RUNNING forever (the survivor
            # keeps heartbeating, so the zombie cron can't catch it either).
            import signal
            import threading

            now = time.monotonic()
            if handle.terminal_since is None:
                handle.terminal_since = now
            # Grace windows ride the bus clock: time_scale compresses them
            # in tests exactly like every countdown.
            grace = ctx.terminal_grace * ctx.bus.time_scale
            elapsed = now - handle.terminal_since

            def _signal_off_thread(sig: int) -> None:
                # Each stage fires once, on its own thread: the ssh
                # transport's signal is a network round-trip that must not
                # stall the single bus thread (and must not be re-sent
                # every monitor tick).
                threading.Thread(
                    target=ctx.spawner.signal_gang,
                    args=(handle, sig),
                    name=f"gang-signal-{run_id}",
                    daemon=True,
                ).start()

            if elapsed >= 2 * grace and not handle.kill_sent:
                handle.kill_sent = True
                _signal_off_thread(signal.SIGKILL)
            elif elapsed >= grace and not handle.term_sent:
                handle.term_sent = True
                _signal_off_thread(signal.SIGTERM)
            _reschedule_monitor(run_id)
            return
        if rollup in (S.SUCCEEDED, S.FAILED, S.SKIPPED):
            # One final ingest now that every process flushed and exited.
            ctx.watcher.ingest(handle)
            ctx.gangs.pop(run_id, None)
            if ctx.remediation is not None:
                # Last advancement over the final ingest: an ack that
                # landed in the gang's dying flush still resolves its
                # action row (instead of expiring as the run closes).
                try:
                    ctx.remediation.tick(handle)
                except Exception:
                    logger.warning(
                        "Remediation final tick failed for run %s",
                        run_id,
                        exc_info=True,
                    )
            if rollup == S.FAILED and run.restarts < handle.plan.max_restarts:
                # Checkpoint-aware relaunch: the remediation engine decides
                # from-where (latest COMPLETE async checkpoint — finalize
                # markers reject torn saves) and how-long (exponential
                # backoff, per-run budget).  Without an engine, or if its
                # decision errors, fall back to the plan's fixed backoff —
                # the trainer still restores whatever checkpoints/ holds.
                decision = None
                if ctx.remediation is not None:
                    try:
                        decision = ctx.remediation.on_gang_failed(run, handle)
                    except Exception:
                        logger.warning(
                            "Remediation relaunch decision failed for run %s",
                            run_id,
                            exc_info=True,
                        )
                        decision = {
                            "backoff_s": handle.plan.backoff_seconds,
                            "from_step": None,
                            "message": None,
                        }
                else:
                    decision = {
                        "backoff_s": handle.plan.backoff_seconds,
                        "from_step": None,
                        "message": None,
                    }
                if decision is not None:
                    restarts = run.restarts + 1
                    reg.update_run(run_id, restarts=restarts)
                    reg.clear_processes(run_id)
                    # Rotate report files so the next attempt's watcher
                    # (fresh offsets) doesn't re-ingest this attempt's
                    # lines.
                    for process_id in range(handle.plan.num_hosts):
                        report = handle.paths.report_file(process_id)
                        if report.exists():
                            report.rename(
                                report.with_suffix(f".jsonl.attempt{run.restarts}")
                            )
                    reg.set_status(
                        run_id,
                        S.WARNING,
                        message=decision.get("message")
                        or (
                            f"gang failed; restart "
                            f"{restarts}/{handle.plan.max_restarts}"
                        ),
                    )
                    ctx.auditor.record(
                        EventTypes.EXPERIMENT_RESTARTED,
                        run_id=run_id,
                        from_step=decision.get("from_step"),
                    )
                    bus.send(
                        SchedulerTasks.EXPERIMENTS_START,
                        {"run_id": run_id},
                        countdown=decision.get("backoff_s") or 0.0,
                    )
                    return
                # Budget exhausted: fall through to terminal FAILED.
            reg.set_status(run_id, rollup)
            _record_done(ctx, run_id, rollup)
            return
        _reschedule_monitor(run_id)

    @bus.register(SchedulerTasks.EXPERIMENTS_STOP)
    def experiments_stop(
        run_id: int, cleanup: bool = False, actor: Optional[str] = None
    ) -> None:
        handle = ctx.gangs.pop(run_id, None)
        if handle is not None:
            ctx.spawner.stop(handle)
            ctx.watcher.ingest(handle)
        if cleanup:
            return
        run = reg.get_run(run_id)
        if run.is_done:
            return
        reg.set_status(run_id, S.STOPPING)
        for p in reg.get_processes(run_id):
            if p["status"] not in (S.SUCCEEDED, S.FAILED, S.STOPPED):
                reg.upsert_process(run_id, p["process_id"], status=S.STOPPED)
        reg.set_status(run_id, S.STOPPED)
        _record_done(ctx, run_id, S.STOPPED, actor=actor)

    @bus.register(SchedulerTasks.ARTIFACTS_SYNC)
    def artifacts_sync(run_id: int, _attempt: int = 0) -> None:
        """Upload a finished run's durable subdirs to the artifact store.

        Parity: reference outputs/log collection into its stores
        (``stores/managers/base.py:11-40``); here checkpoint shipping is
        first-class too.  The upload itself is offloaded off the bus
        thread (multi-GB gsutil trees must not head-of-line-block gang
        monitors/heartbeats/stop requests); transient store failures
        re-send the task with a bounded attempt counter — a flaky gsutil
        call must not silently drop a checkpoint.
        """
        from polyaxon_tpu_torch.stores import sync_run_up

        store = ctx.artifact_store
        if store is None:
            return
        run = reg.get_run(run_id)
        paths = ctx.layout.run_paths(run.uuid)

        def _upload() -> None:
            n = sync_run_up(store, paths, run.uuid)
            ctx.auditor.record(
                EventTypes.EXPERIMENT_ARTIFACTS_SYNCED, run_id=run_id, files=n
            )

        # Failure handling lives in the bus (same retry/dead-letter
        # counters and error window as in-thread tasks): an upload
        # dead-letter is a LOST checkpoint and must stay operator-visible.
        bus.offload_with_retry(
            _upload,
            task=SchedulerTasks.ARTIFACTS_SYNC,
            kwargs={"run_id": run_id},
            attempt=_attempt,
            max_attempts=ARTIFACT_SYNC_MAX_ATTEMPTS,
            name=f"artifacts-sync-{run_id}",
        )

    @bus.register(SchedulerTasks.ADMISSION_CHECK)
    def admission_check() -> None:
        """Re-dispatch runs queued at admission (oldest first) after capacity
        was freed. Each re-entry retries ``acquire_device``; runs that still
        don't fit simply stay QUEUED (their status write is a no-op)."""
        for run in reg.list_runs(statuses=[S.QUEUED]):
            bus.send(SchedulerTasks.EXPERIMENTS_BUILD, {"run_id": run.id})
        # Sweeps throttle their own waves by free slices, so freed capacity
        # must also re-kick running groups whose trials are still CREATED
        # (no EXPERIMENT_DONE is coming to do it when the slices were held
        # by unrelated runs).
        from polyaxon_tpu_torch.workers import HPTasks

        if bus.has_task(HPTasks.START):
            for group in reg.list_runs(kind="group", statuses=[S.RUNNING]):
                bus.send(HPTasks.START, {"group_id": group.id})

    @bus.register(CronTasks.CLEAN_ACTIVITY)
    def clean_activity(retention_seconds: float = 30 * 86400.0) -> None:
        phase_t0 = time.perf_counter()
        removed = reg.clean_old_rows(retention_seconds)
        _observe_phase("retention", time.perf_counter() - phase_t0)
        if removed.get("truncated"):
            logger.info(
                "Retention sweep hit its per-tick row budget; the "
                "remainder ages out on later ticks"
            )
        if any(removed.values()):
            logger.info("Retention cleanup removed %s", removed)

    @bus.register(CronTasks.CLEAN_ARCHIVES)
    def clean_archives(ttl_seconds: float = 7 * 86400.0) -> None:
        """Purge archived runs past the retention horizon — rows, outputs
        dirs, and store trees.  Parity: the reference's DELETE_ARCHIVED_*
        beat crons (``crons/tasks/deletion.py`` → the scheduler deletion
        tasks), collapsed to one pass over the registry."""
        from polyaxon_tpu_torch.stores import gc_run_data

        for run in reg.archived_runs_older_than(ttl_seconds):
            try:
                victims = reg.delete_run(run.id)
            except RegistryError:
                continue  # already cascaded away with an earlier parent
            gc_run_data(ctx.layout, ctx.artifact_store, victims)
            ctx.auditor.record(
                EventTypes.EXPERIMENT_DELETED,
                run_id=run.id,
                cascaded=len(victims) - 1,
                reason="archive_retention",
            )
            logger.info(
                "Archive retention purged run %s (+%d children)",
                run.id,
                len(victims) - 1,
            )

    @bus.register(CronTasks.HEARTBEAT_CHECK)
    def heartbeat_check() -> None:
        # Heal runs stranded in QUEUED (their dispatched build/start task was
        # dead-lettered): re-enter the chain. EXPERIMENTS_BUILD/START are
        # idempotent under the lifecycle gate, so a re-dispatch can't
        # double-start a gang.
        for run in reg.stale_queued_runs(ctx.queued_redispatch_ttl):
            logger.warning("Re-dispatching run %s stranded in queued", run.id)
            bus.send(SchedulerTasks.EXPERIMENTS_BUILD, {"run_id": run.id})
        for run in reg.zombie_runs(ctx.heartbeat_ttl):
            ctx.auditor.record(EventTypes.EXPERIMENT_ZOMBIE, run_id=run.id)
            handle = ctx.gangs.pop(run.id, None)
            if handle is not None:
                # Off-thread: a zombie usually means an unreachable host,
                # where an ssh-transport stop would hold the bus thread for
                # the full grace + connect timeouts.
                import threading

                threading.Thread(
                    target=ctx.spawner.stop,
                    args=(handle,),
                    name=f"zombie-stop-{run.id}",
                    daemon=True,
                ).start()
            reg.set_status(
                run.id, S.FAILED, message=f"zombie: no heartbeat in {ctx.heartbeat_ttl}s"
            )
            _record_done(ctx, run.id, S.FAILED)
