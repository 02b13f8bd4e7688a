"""Runs the port's ring on gloo ranks, one thread each, for the parity tests.

``run_ranks(n, payload)`` builds ``n`` gloo process groups of one group of
``n`` ranks over an in-memory store, one per thread of this process, gives
each thread a ``{"sequence": n}`` mesh over its group and returns each
rank's results.  CPU autograd runs on the thread that calls it, so a
rotation inside ``backward()`` meets the other ranks' rotations; no
process is spawned and no default process group is made.

``payload`` holds numpy inputs of the whole sequence:

- ``"ring"``: ``(impl, q, k, v, do)`` cases; each rank runs
  ``ring_attention_sharded`` on its sequence shard, back-propagates
  ``sum(out * do)`` and returns ``(out, dq, dk, dv)`` of its shard;
- ``"model"``: ``(cfg_kwargs, params, tokens, targets)`` cases; each rank
  runs ``loss_fn`` under ``sp_ring`` on its shard (``shard_batch`` sets
  the global positions), back-propagates loss / n and returns
  ``(loss, grads)``.  Summed over ranks, those grads are the grads of the
  mean loss over the whole sequence.
"""

from __future__ import annotations

import datetime
import itertools

import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d

from polyaxon_tpu_torch.models.transformer import TransformerConfig, loss_fn
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.parallel.ring import LocalRing, ring_attention_sharded
from polyaxon_tpu_torch.parallel.templates import template_for
from polyaxon_tpu_torch.runtime.mesh import build_mesh
from polyaxon_tpu_torch.runtime.optim import tree_leaves
from polyaxon_tpu_torch.runtime.train import shard_batch

_runs = itertools.count()


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _ring_case(mesh, rank, n, case):
    impl, *arrays = case
    Tl = arrays[0].shape[1] // n
    q, k, v, do = (torch.from_numpy(a[:, rank * Tl:(rank + 1) * Tl].copy()) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = ring_attention_sharded(q, k, v, mesh, "sequence", impl=impl)
    (out * do).sum().backward()
    return tuple(t.detach().numpy().copy() for t in (out, q.grad, k.grad, v.grad))


def _model_case(mesh, n, case):
    cfg_kwargs, params_np, tokens, targets = case
    cfg = TransformerConfig(dtype=torch.float32, **cfg_kwargs)
    params = params_from_jax(params_np, "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    template = template_for("sp_ring", dict(mesh.shape))
    batch = shard_batch({"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)},
                        mesh, template)
    loss = loss_fn(params, batch, cfg, template=template, mesh=mesh, device="cpu")
    (loss / n).backward()
    grads = {"block": {k: v.grad for k, v in params["block"].items()},
             **{k: v.grad for k, v in params.items() if k != "block"}}
    return loss.item(), _np_tree(grads)


def run_ranks(n: int, payload: dict, timeout: float = 240.0) -> list:
    """Each rank's results, in rank order (see the module docstring)."""
    store = dist.PrefixStore(f"ring-ranks-{next(_runs)}", dist.HashStore())
    registered = []

    def rank_main(ring):  # LocalRing only starts the threads and gathers
        rank = ring.rank
        # Waits for all n ranks; a rank that fails leaves the others' sends
        # and receives to end at the timeout.
        group = dist.ProcessGroupGloo(store, rank, n, datetime.timedelta(seconds=timeout))
        # P2POp names its peer by global rank: map this group's ranks onto
        # themselves, as new_group would under a default group.
        distributed_c10d._world.pg_group_ranks[group] = {r: r for r in range(n)}
        registered.append(group)
        mesh = build_mesh({"sequence": n}, groups={"sequence": group})
        return {
            "rank": mesh.rank("sequence"),
            "ring": [_ring_case(mesh, rank, n, c) for c in payload.get("ring", ())],
            "model": [_model_case(mesh, n, c) for c in payload.get("model", ())],
        }

    try:
        return LocalRing.run(n, rank_main, timeout=timeout)
    finally:
        for group in registered:
            distributed_c10d._world.pg_group_ranks.pop(group, None)
