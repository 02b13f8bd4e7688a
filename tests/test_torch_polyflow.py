"""The port's pipeline DAG utilities against the JAX package's:
``build_dag``, ``downstream``, ``sort_topologically`` and the cycle error
on the reference's ``tests/test_polyflow/test_dags.py`` cases and on random
DAGs (and random graphs with a cycle) made from a seed with numpy."""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest

from polyaxon_tpu.polyflow import dags as jdags
from polyaxon_tpu_torch.polyflow import dags

OPS = {
    "reference": [{"name": "train", "dependencies": ["prep"]}, {"name": "prep"},
                  {"name": "eval", "dependencies": ["train"]},
                  {"name": "report", "dependencies": ["eval", "prep"]}],
    "chain-and-island": [{"name": "a"}, {"name": "b", "dependencies": ["a"]},
                         {"name": "c", "dependencies": ["b"]}, {"name": "d"}],
    "empty": [],
}


def _random_ops(seed, n=12, cyclic=False):
    rng = np.random.default_rng(seed)
    order = [f"op{i}" for i in rng.permutation(n)]
    ops = []
    for i, name in enumerate(order):
        deps = [order[j] for j in range(i) if rng.uniform() < 0.3]
        ops.append({"name": name, "dependencies": deps} if deps else {"name": name})
    if cyclic:  # an edge from an early op back to a later one
        ops[1].setdefault("dependencies", []).append(order[-1])
        ops[-1].setdefault("dependencies", []).append(order[1])
    rng.shuffle(ops)
    return ops


for seed in range(6):
    OPS[f"random-{seed}"] = _random_ops(seed)


def _outcome(mod, dag):
    try:
        return "ok", mod.sort_topologically(dag)
    except (jdags.DagError, dags.DagError) as e:
        return "cycle", str(e)


@pytest.mark.parametrize("name", list(OPS))
def test_a_dag_is_built_sorted_and_walked_as_the_reference_does(name):
    ops = OPS[name]
    dag, jdag = dags.build_dag(ops), jdags.build_dag(ops)
    assert dag == jdag
    assert _outcome(dags, dag) == _outcome(jdags, jdag)
    order = dags.sort_topologically(dag)
    for op, deps in dag.items():
        assert all(order.index(d) < order.index(op) for d in deps)
        assert dags.downstream(dag, op) == jdags.downstream(jdag, op)


@pytest.mark.parametrize("seed", range(4))
def test_a_cycle_is_refused_with_the_reference_message(seed):
    dag = dags.build_dag(_random_ops(seed, cyclic=True))
    kind, message = _outcome(dags, dag)
    assert (kind, message) == _outcome(jdags, jdags.build_dag(_random_ops(seed, cyclic=True)))
    assert kind == "cycle" and message.startswith("Pipeline has a cycle through")
    with pytest.raises(dags.DagError):
        dags.sort_topologically({"a": {"b"}, "b": {"a"}})
