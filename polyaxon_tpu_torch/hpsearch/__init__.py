"""Hyperparameter search, the port's copy of ``polyaxon_tpu.hpsearch``: the
suggestion engines and the tasks that run a group's sweep."""

from polyaxon_tpu_torch.hpsearch.search_managers import (
    BOSearchManager,
    GridSearchManager,
    HyperbandSearchManager,
    RandomSearchManager,
    get_search_manager,
)
from polyaxon_tpu_torch.hpsearch.tasks import HPContext, register_hp_tasks

__all__ = [
    "BOSearchManager",
    "GridSearchManager",
    "HPContext",
    "HyperbandSearchManager",
    "RandomSearchManager",
    "get_search_manager",
    "register_hp_tasks",
]
