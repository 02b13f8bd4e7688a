"""hpsearch orchestration, the port's copy of ``polyaxon_tpu/hpsearch/tasks.py``:
create-trials -> start-wave -> iterate loops on the task bus.

``HP_CREATE`` asks the group's search manager for suggestions and creates
one trial run per suggestion (created, not dispatched) with the iteration's
row (``RunRegistry.create_iteration``); ``HP_START`` checks early stopping,
then dispatches at most ``concurrency - running`` trials, bounded by the
free slices of the group's accelerator where a slice inventory is
registered; ``HP_ITERATE``, once every trial is done, advances the
iteration (a hyperband bracket reduction or the next bracket, a BO
observation round) or finishes the group.  Waves are re-triggered by the
executor's EXPERIMENT_DONE -> HP_START chain.  Decisions, rows and messages
are the reference's.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from polyaxon_tpu_torch.auditor import Auditor
from polyaxon_tpu_torch.db.registry import Run, RunRegistry
from polyaxon_tpu_torch.events import EventTypes
from polyaxon_tpu_torch.hpsearch.search_managers import (
    BOSearchManager,
    HyperbandSearchManager,
    get_search_manager,
)
from polyaxon_tpu_torch.lifecycles import StatusOptions as S
from polyaxon_tpu_torch.schemas.hptuning import Optimization, SearchAlgorithms
from polyaxon_tpu_torch.workers import HPTasks, SchedulerTasks, TaskBus

logger = logging.getLogger(__name__)


@dataclass
class HPContext:
    registry: RunRegistry
    bus: TaskBus
    auditor: Auditor


def _metric_value(run: Run, metric_name: str) -> Optional[float]:
    v = run.last_metric.get(metric_name)
    return None if v is None else float(v)


def _best_metric(
    runs: List[Run], metric_name: str, optimization: str
) -> Optional[float]:
    values = [m for m in (_metric_value(r, metric_name) for r in runs) if m is not None]
    if not values:
        return None
    return max(values) if optimization == Optimization.MAXIMIZE else min(values)


def register_hp_tasks(ctx: HPContext) -> None:
    bus, reg = ctx.bus, ctx.registry

    def _group(group_id: int) -> Run:
        return reg.get_run(group_id)

    def _trials(group_id: int) -> List[Run]:
        return reg.list_runs(group_id=group_id)

    def _create_trials(
        group: Run, suggestions: List[Dict[str, Any]]
    ) -> List[int]:
        """Trial rows are created CREATED but NOT dispatched — the start
        wave controls when each enters the build→start chain (reference:
        ``hpsearch/tasks/base.py:33-55`` creates, ``:80-104`` starts)."""
        spec = group.spec
        ids = []
        for suggestion in suggestions:
            trial_spec = spec.get_experiment_spec(suggestion)
            run = reg.create_run(
                trial_spec,
                project=group.project,
                group_id=group.id,
                tags=["trial"],
            )
            # Trials run THEIR GROUP's code: inherit its snapshot ref so
            # every trial tests the same bytes (and a CI-triggered group's
            # trials can't re-snapshot the build context and fire CI again).
            if group.code_ref:
                reg.update_run(run.id, code_ref=group.code_ref)
            ids.append(run.id)
        return ids

    def _early_stopped(group: Run, trials: List[Run]) -> bool:
        hptuning = group.spec.hptuning
        for es in hptuning.early_stopping:
            best = _best_metric(trials, es.metric.name, es.metric.optimization)
            if best is not None and es.passed(best):
                return True
        return False

    def _finish_group(group_id: int, status: str, message: Optional[str] = None) -> None:
        if reg.set_status(group_id, status, message=message):
            event = (
                EventTypes.GROUP_DONE
                if status == S.SUCCEEDED
                else EventTypes.GROUP_STOPPED
            )
            ctx.auditor.record(event, group_id=group_id, status=status)

    @bus.register(HPTasks.CREATE)
    def hp_create(group_id: int) -> None:
        group = _group(group_id)
        if group.is_done:
            return
        manager = get_search_manager(group.spec.hptuning)
        iteration_data: Dict[str, Any] = {"iteration": 0}
        if isinstance(manager, HyperbandSearchManager):
            iteration_data.update(bracket_iteration=0)
        suggestions = manager.get_suggestions(iteration_data)
        ids = _create_trials(group, suggestions)
        iteration_data.update(configs=suggestions, trial_ids=ids)
        number = reg.create_iteration(group_id, iteration_data)
        logger.info(
            "Group %s iteration %s: %s trials created", group_id, number, len(ids)
        )
        reg.set_status(group_id, S.RUNNING)
        bus.send(HPTasks.START, {"group_id": group_id})

    @bus.register(HPTasks.START)
    def hp_start(group_id: int) -> None:
        group = _group(group_id)
        if group.is_done:
            return
        trials = _trials(group_id)
        hptuning = group.spec.hptuning

        if _early_stopped(group, trials):
            for t in trials:
                if not t.is_done:
                    bus.send(SchedulerTasks.EXPERIMENTS_STOP, {"run_id": t.id})
            _finish_group(group_id, S.SUCCEEDED, message="early stopping criterion met")
            return

        running = [t for t in trials if not t.is_done and t.status != S.CREATED]
        pending = [t for t in trials if t.status == S.CREATED]
        window = max(0, hptuning.concurrency - len(running))
        # Waves are bounded by free accelerator slices, not just the sweep's
        # concurrency (SURVEY §7: trials×slices packing): dispatching more
        # trials than the inventory fits would just park them at admission.
        topo = group.spec.environment.topology
        per_slice = int(topo.num_devices)
        free = reg.free_slice_count(
            topo.accelerator, per_slice,
            num_hosts=int(topo.num_hosts) * int(topo.num_slices),
        )
        if free is not None:
            # Conservative window: capacity already QUEUED for this family
            # (any group, or standalone) has first claim on the free
            # count — two sweeps reading the same snapshot must not both
            # dispatch into it (the loser's trials park QUEUED while
            # holding their group's concurrency window: wave stalls).
            # Queued CHIPS convert into this sweep's slot units.
            spoken_chips = reg.queued_chips_count(topo.accelerator)
            spoken_slots = -(-spoken_chips // max(1, per_slice))  # ceil
            # A multi-slice trial consumes num_slices whole slices.
            window = min(
                window,
                max(0, free - spoken_slots) // max(1, int(topo.num_slices)),
            )
        for t in pending[:window]:
            # Mark the trial dispatched BEFORE sending: a trial sitting in
            # the bus queue must not look pending to the next HP_START
            # (every EXPERIMENT_DONE fires one) or back-to-back waves
            # double-dispatch it. The reference debounced this with Redis
            # GroupChecks (``hpsearch/tasks/base.py:93-104``); a QUEUED
            # status is the single-process equivalent and also feeds the
            # dashboard.
            if reg.set_status(t.id, S.QUEUED):
                bus.send(SchedulerTasks.EXPERIMENTS_BUILD, {"run_id": t.id})
        if not pending and not running:
            bus.send(HPTasks.ITERATE, {"group_id": group_id})

    @bus.register(HPTasks.ITERATE)
    def hp_iterate(group_id: int) -> None:
        group = _group(group_id)
        if group.is_done:
            return
        trials = _trials(group_id)
        if any(not t.is_done for t in trials):
            return  # spurious trigger; EXPERIMENT_DONE will re-fire
        hptuning = group.spec.hptuning
        algo = hptuning.search_algorithm
        manager = get_search_manager(hptuning)
        iteration = reg.get_iteration(group_id)
        data = iteration["data"] if iteration else {}
        trial_ids = data.get("trial_ids", [])
        id_to_run = {t.id: t for t in trials}

        if algo == SearchAlgorithms.HYPERBAND:
            assert isinstance(manager, HyperbandSearchManager)
            it = data.get("iteration", 0)
            bi = data.get("bracket_iteration", 0)
            metric = hptuning.hyperband.metric
            # Aligned to trial_ids (None placeholders for vanished runs) so
            # reduce_configs zips each config with ITS trial's metric.
            metrics = [
                _metric_value(id_to_run[i], metric.name) if i in id_to_run else None
                for i in trial_ids
            ]
            configs = data.get("configs", [])
            if manager.should_reduce_configs(it, bi):
                survivors = manager.reduce_configs(it, bi, configs, metrics)
                if survivors:
                    ids = _create_trials(group, survivors)
                    reg.create_iteration(
                        group_id,
                        {
                            "iteration": it,
                            "bracket_iteration": bi + 1,
                            "configs": survivors,
                            "trial_ids": ids,
                        },
                    )
                    bus.send(HPTasks.START, {"group_id": group_id})
                    return
                # A wave too small to halve exhausts its bracket early —
                # fall through to the next-bracket check.
            if manager.should_reschedule(it, bi) or it + 1 <= manager.s_max:
                nxt = it + 1
                iteration_data = {"iteration": nxt, "bracket_iteration": 0}
                suggestions = manager.get_suggestions(iteration_data)
                ids = _create_trials(group, suggestions)
                iteration_data.update(configs=suggestions, trial_ids=ids)
                reg.create_iteration(group_id, iteration_data)
                bus.send(HPTasks.START, {"group_id": group_id})
                return
            _finish_group(group_id, S.SUCCEEDED)
            return

        if algo == SearchAlgorithms.BO:
            assert isinstance(manager, BOSearchManager)
            bo = hptuning.bo
            all_configs = data.get("all_configs", []) + data.get("configs", [])
            metric_by_trial = {
                t.id: _metric_value(t, bo.metric.name) for t in trials
            }
            all_metrics = data.get("all_metrics", []) + [
                metric_by_trial.get(i) for i in trial_ids
            ]
            rounds = data.get("rounds", 0) + 1
            if rounds > bo.n_iterations:
                _finish_group(group_id, S.SUCCEEDED)
                return
            suggestions = manager.get_suggestions(
                {"configs": all_configs, "metrics": all_metrics}
            )
            ids = _create_trials(group, suggestions)
            reg.create_iteration(
                group_id,
                {
                    "iteration": rounds,
                    "rounds": rounds,
                    "configs": suggestions,
                    "trial_ids": ids,
                    "all_configs": all_configs,
                    "all_metrics": all_metrics,
                },
            )
            bus.send(HPTasks.START, {"group_id": group_id})
            return

        # grid / random: one wave, done.
        _finish_group(group_id, S.SUCCEEDED)
