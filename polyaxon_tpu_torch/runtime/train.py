"""The train step of one process.

Counterpart of ``polyaxon_tpu/runtime/train.py``'s ``TrainStep`` and
``build_train_step``: value and grad of the loss, the optimizer's in-place
update, the float32 global grad norm, and ``place_batch``.  It takes the
``ddp`` and ``sp_ring`` templates on meshes whose axes are all 1; across
ranks the grads would need an all-reduce, which belongs to the port worker
(ROADMAP item 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from polyaxon_tpu_torch.parallel.templates import check_ported
from polyaxon_tpu_torch.runtime.optim import tree_leaves


def shard_batch(
    batch: Dict[str, torch.Tensor], mesh=None, template=None
) -> Dict[str, torch.Tensor]:
    """This rank's part of a global batch: under a ring template, the
    contiguous sequence shard of every ``[B, T]`` entry and ``positions``
    set to its global positions; otherwise the batch as given."""
    ring_axis = None if template is None else template.ring_axis
    if ring_axis is None or mesh is None:
        return dict(batch)
    n, r = mesh.shape[ring_axis], mesh.rank(ring_axis)
    B, T = batch["tokens"].shape
    if T % n:
        raise ValueError(f"sequence length {T} does not split over {n} ranks of {ring_axis!r}")
    Tl = T // n
    out = {name: x[:, r * Tl:(r + 1) * Tl] for name, x in batch.items() if name != "positions"}
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(T, device=batch["tokens"].device).expand(B, T)
    out["positions"] = positions[:, r * Tl:(r + 1) * Tl]
    return out


@dataclass
class TrainStep:
    """A train step plus its initializer and batch placement."""

    step: Callable  # (params, opt_state, batch) -> (params, opt_state, metrics)
    init: Callable  # (generator) -> (params, opt_state)
    mesh: Any = None
    template: Any = None

    def place_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's shard of a global batch (:func:`shard_batch`)."""
        return shard_batch(batch, self.mesh, self.template)


def build_train_step(
    *,
    loss_fn: Callable,
    init_fn: Callable,
    optimizer: Any,
    mesh=None,
    template=None,
) -> TrainStep:
    """Wire a loss/init pair into a train step.

    ``loss_fn(params, batch) -> scalar`` and ``init_fn(generator) -> params``
    are closures over the model config (and over ``mesh`` and ``template``,
    as in the JAX package); the device is the generator's.  ``step``
    updates ``params`` and ``opt_state`` in place and returns them with
    ``metrics``: ``loss`` and ``grad_norm`` as float32 device scalars (read
    them where the host needs them; reading syncs the device).  ``mesh``
    and ``template``: ``ddp`` or ``sp_ring`` on a mesh whose axes are all 1,
    or neither.
    """
    _check_one_rank(mesh, template)

    def init(generator: torch.Generator) -> Tuple[Any, Any]:
        params = init_fn(generator)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return params, optimizer.init(params)

    def step(params: Any, opt_state: Any, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(params)
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            gnorm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
        opt_state = optimizer.update_(params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return TrainStep(step=step, init=init, mesh=mesh, template=template)


def _check_one_rank(mesh, template: Optional[Any]) -> None:
    check_ported(template)
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"a train step over mesh {mesh.shape} needs its grads all-reduced across "
            "ranks, which belongs to the port worker (ROADMAP item 7: multi-process "
            "and parallelism)"
        )
