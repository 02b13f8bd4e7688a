"""The single-device train step.

Counterpart of ``polyaxon_tpu/runtime/train.py``'s ``TrainStep`` and
``build_train_step`` for one device: value and grad of the loss, the
optimizer's in-place update, and the float32 global grad norm.  Meshes and
strategy templates are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from polyaxon_tpu_torch.runtime.optim import tree_leaves


@dataclass
class TrainStep:
    """A train step plus its initializer."""

    step: Callable  # (params, opt_state, batch) -> (params, opt_state, metrics)
    init: Callable  # (generator) -> (params, opt_state)


def build_train_step(
    *,
    loss_fn: Callable,
    init_fn: Callable,
    optimizer: Any,
    mesh=None,
    template=None,
) -> TrainStep:
    """Wire a loss/init pair into a train step on one device.

    ``loss_fn(params, batch) -> scalar`` and ``init_fn(generator) -> params``
    are closures over the model config; the device is the generator's.
    ``step`` updates ``params`` and ``opt_state`` in place and returns them
    with ``metrics``: ``loss`` and ``grad_norm`` as float32 device scalars
    (read them where the host needs them; reading syncs the device).
    """
    if mesh is not None or template is not None:
        raise NotImplementedError(
            "meshes and strategy templates are not ported yet "
            "(ROADMAP: multi-process and parallelism)"
        )

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

    return TrainStep(step=step, init=init)
