"""DAG utilities for pipelines, the port's copy of
``polyaxon_tpu/polyflow/dags.py``: the op list's dependency map, the ops
downstream of one, and Kahn's topological sort with cycle detection.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Sequence, Set

from polyaxon_tpu_torch.exceptions import PolyaxonTPUError


class DagError(PolyaxonTPUError):
    pass


def build_dag(ops: Sequence[dict]) -> Dict[str, Set[str]]:
    """op name -> set of dependency names."""
    return {op["name"]: set(op.get("dependencies", ())) for op in ops}


def downstream(dag: Dict[str, Set[str]], name: str) -> Set[str]:
    """All ops that (transitively) depend on ``name``."""
    out: Set[str] = set()
    frontier = [name]
    while frontier:
        cur = frontier.pop()
        for op, deps in dag.items():
            if cur in deps and op not in out:
                out.add(op)
                frontier.append(op)
    return out


def sort_topologically(dag: Dict[str, Set[str]]) -> List[str]:
    """Kahn's algorithm; raises :class:`DagError` on cycles."""
    indegree = {name: len(deps) for name, deps in dag.items()}
    queue = deque(sorted(n for n, d in indegree.items() if d == 0))
    order: List[str] = []
    while queue:
        n = queue.popleft()
        order.append(n)
        for op, deps in dag.items():
            if n in deps:
                indegree[op] -= 1
                if indegree[op] == 0:
                    queue.append(op)
    if len(order) != len(dag):
        cyclic = sorted(set(dag) - set(order))
        raise DagError(f"Pipeline has a cycle through {cyclic}")
    return order
