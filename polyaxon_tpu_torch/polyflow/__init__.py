"""Pipelines, the port's copy of ``polyaxon_tpu.polyflow``: the DAG utilities
and the tasks that run a pipeline's ops."""

from polyaxon_tpu_torch.polyflow.dags import DagError, sort_topologically
from polyaxon_tpu_torch.polyflow.tasks import PipelineContext, register_pipeline_tasks

__all__ = [
    "DagError",
    "PipelineContext",
    "register_pipeline_tasks",
    "sort_topologically",
]
