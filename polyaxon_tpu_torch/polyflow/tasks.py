"""Pipeline orchestration, the port's copy of
``polyaxon_tpu/polyflow/tasks.py``: op runs scheduled over the task bus.

``PIPELINES_START`` checks the DAG for cycles and creates one run per op
(each op an experiment: the pipeline's declarations are its defaults, the
pipeline's environment its environment unless it names one);
``PIPELINES_CHECK``, fired by the executor's EXPERIMENT_DONE chain, skips
ops downstream of a failed, stopped or skipped one, dispatches the ready
ops within the pipeline's ``concurrency`` and finishes the pipeline once
every op is done; ``PIPELINES_STOP`` skips what has not started and stops
what has.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict

from polyaxon_tpu_torch.auditor import Auditor
from polyaxon_tpu_torch.db.registry import Run, RunRegistry
from polyaxon_tpu_torch.events import EventTypes
from polyaxon_tpu_torch.lifecycles import StatusOptions as S
from polyaxon_tpu_torch.polyflow.dags import DagError, build_dag, sort_topologically
from polyaxon_tpu_torch.schemas.specifications import ExperimentSpecification, Kinds
from polyaxon_tpu_torch.workers import PipelineTasks, SchedulerTasks, TaskBus

logger = logging.getLogger(__name__)


@dataclass
class PipelineContext:
    registry: RunRegistry
    bus: TaskBus
    auditor: Auditor


def _op_spec(pipeline: Run, op: dict) -> ExperimentSpecification:
    data = {
        k: v for k, v in op.items() if k not in ("name", "dependencies", "kind")
    }
    data["kind"] = Kinds.EXPERIMENT
    # Pipeline-level declarations are the ops' shared defaults.
    merged = dict(pipeline.spec.declarations)
    merged.update(data.get("declarations") or {})
    data["declarations"] = merged
    if "environment" not in data and pipeline.spec_data.get("environment"):
        data["environment"] = pipeline.spec_data["environment"]
    return ExperimentSpecification.from_dict(data)


def register_pipeline_tasks(ctx: PipelineContext) -> None:
    bus, reg = ctx.bus, ctx.registry

    def _ops(pipeline_id: int) -> Dict[str, Run]:
        return {r.name: r for r in reg.list_runs(pipeline_id=pipeline_id)}

    @bus.register(PipelineTasks.START)
    def pipelines_start(pipeline_id: int) -> None:
        pipeline = reg.get_run(pipeline_id)
        if pipeline.is_done:
            return
        spec = pipeline.spec
        dag = build_dag(spec.ops)
        try:
            sort_topologically(dag)  # cycle check up front
        except DagError as e:
            reg.set_status(pipeline_id, S.FAILED, message=str(e))
            return
        for op in spec.ops:
            op_run = reg.create_run(
                _op_spec(pipeline, op),
                name=op["name"],
                project=pipeline.project,
                pipeline_id=pipeline_id,
                tags=["operation"],
            )
            # Ops run THEIR PIPELINE's code (same inheritance as group
            # trials: one snapshot per submission, no per-op re-walks —
            # and no CI self-retrigger from a CI-triggered pipeline).
            if pipeline.code_ref:
                reg.update_run(op_run.id, code_ref=pipeline.code_ref)
        reg.set_status(pipeline_id, S.RUNNING)
        bus.send(PipelineTasks.CHECK, {"pipeline_id": pipeline_id})

    @bus.register(PipelineTasks.CHECK)
    def pipelines_check(pipeline_id: int) -> None:
        pipeline = reg.get_run(pipeline_id)
        if pipeline.is_done:
            return
        spec = pipeline.spec
        dag = build_dag(spec.ops)
        ops = _ops(pipeline_id)

        # Upstream-failure propagation: an op whose dependency failed /
        # stopped / was skipped is skipped (reference skip propagation).
        changed = True
        while changed:
            changed = False
            for name, deps in dag.items():
                run = ops.get(name)
                if run is None or run.status != S.CREATED:
                    continue
                dep_runs = [ops[d] for d in deps if d in ops]
                if any(
                    d.status in (S.FAILED, S.STOPPED, S.SKIPPED) for d in dep_runs
                ):
                    if reg.set_status(
                        run.id, S.SKIPPED, message="upstream op did not succeed"
                    ):
                        ops[name] = reg.get_run(run.id)
                        ctx.auditor.record(
                            EventTypes.OPERATION_DONE,
                            run_id=run.id,
                            pipeline_id=pipeline_id,
                            status=S.SKIPPED,
                        )
                        changed = True

        running = [r for r in ops.values() if not r.is_done and r.status != S.CREATED]
        ready = [
            name
            for name, deps in dag.items()
            if ops[name].status == S.CREATED
            and all(ops[d].status == S.SUCCEEDED for d in deps if d in ops)
        ]
        window = (
            max(0, spec.concurrency - len(running))
            if spec.concurrency
            else len(ready)
        )
        for name in sorted(ready)[:window]:
            # QUEUED before send: back-to-back CHECKs (one per OPERATION_DONE)
            # must not double-dispatch an op still sitting in the bus queue.
            if reg.set_status(ops[name].id, S.QUEUED):
                bus.send(SchedulerTasks.EXPERIMENTS_BUILD, {"run_id": ops[name].id})

        if all(r.is_done for r in ops.values()) and len(ops) == len(dag):
            status = (
                S.SUCCEEDED
                if all(r.status in (S.SUCCEEDED, S.SKIPPED) for r in ops.values())
                else S.FAILED
            )
            if reg.set_status(pipeline_id, status):
                ctx.auditor.record(
                    EventTypes.PIPELINE_DONE, pipeline_id=pipeline_id, status=status
                )

    @bus.register(PipelineTasks.STOP)
    def pipelines_stop(pipeline_id: int) -> None:
        for run in reg.list_runs(pipeline_id=pipeline_id):
            if not run.is_done:
                if run.status == S.CREATED:
                    reg.set_status(run.id, S.SKIPPED, message="pipeline stopped")
                else:
                    bus.send(SchedulerTasks.EXPERIMENTS_STOP, {"run_id": run.id})
        pipeline = reg.get_run(pipeline_id)
        if not pipeline.is_done:
            reg.set_status(pipeline_id, S.STOPPING)
            reg.set_status(pipeline_id, S.STOPPED)
