"""graft-lint over the port — the port's copy of ``polyaxon_tpu.analysis``.

See ``rules.py`` for the rule catalog (GL001 and GL002 check CUDA-graph
captures here, the reference's jit purity and donation there); run with
``python -m polyaxon_tpu_torch.analysis``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

from polyaxon_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Project,
    Rule,
    load_project,
    run_rules,
)
from polyaxon_tpu_torch.analysis.rules import ALL_RULES, default_rules, rule_by_id

__all__ = [
    "ALL_RULES",
    "Finding",
    "ModuleInfo",
    "Project",
    "Rule",
    "default_rules",
    "load_project",
    "package_root",
    "rule_by_id",
    "run_analysis",
    "run_rules",
]


def package_root() -> Path:
    """The ``polyaxon_tpu_torch/`` package directory (the default lint target)."""
    return Path(__file__).resolve().parent.parent


def run_analysis(
    paths: Optional[Sequence[Path]] = None,
    rules: Optional[Sequence[Rule]] = None,
) -> List[Finding]:
    """Load + run in one call (the API used by tests, bench, and the
    health probe).  Does **not** write the state file — only the CLI
    persists state, so hermetic callers stay hermetic."""
    if paths is None:
        paths = [package_root()]
    project = load_project(paths)
    return run_rules(project, list(rules) if rules else default_rules())
