"""The train step of one rank.

Counterpart of ``polyaxon_tpu/runtime/train.py``'s ``TrainStep`` and
``build_train_step``: value and grad of the loss, the optimizer's in-place
update, the float32 global grad norm, and ``place_batch``.  It takes every
ported template (``parallel.templates.PORTED_STRATEGIES``), on one rank or
across ranks: each rank holds its shard of the params and AdamW state, cut
by the template's rules from the model's ``param_axes`` (whole under
``ddp``, ``sp_ring`` and ``ulysses``), and its shard of the global batch
(its rows along the template's batch axes and, under ``sp_ring`` and
``ulysses``, its sequence shard of them); the step sums the ranks' grads
into what the reference's one program computes on the global batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from polyaxon_tpu_torch.parallel.axes import (
    full_shape,
    gather_shards,
    shard_tensor,
    spec_axes,
    spec_leaves,
    tree_map,
    tree_shard,
    tree_specs,
)
from polyaxon_tpu_torch.parallel.templates import RuntimeLayerError, check_mesh, check_ported
from polyaxon_tpu_torch.runtime.optim import AdamWState, tree_leaves


def _validate_param_shapes(params: Any, param_specs: Any, mesh_axes: Dict[str, int]) -> None:
    """Every sharded param dim must divide by its mesh axes, checked up
    front so that a config and mesh that do not fit (2 GQA kv heads over
    ``tensor: 4``) read as one line naming the parameter (reference
    ``_validate_param_shapes``, ``runtime/train.py:19-55``, the same words)."""
    def check(path: str, leaf: Any, spec: Any) -> None:
        if isinstance(leaf, dict):
            for key in sorted(leaf):  # the reference's order: JAX flattens dicts by sorted key
                check(f"{path}/{key}" if path else key, leaf[key], spec[key])
            return
        for dim, entry in zip(leaf.shape, spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else entry
            size = 1
            for a in axes:
                size *= mesh_axes.get(a, 1)
            if size > 1 and dim % size:
                raise RuntimeLayerError(
                    f"Parameter {path!r} dim of size {dim} cannot shard over "
                    f"mesh axes {axes} (total {size}) — adjust the model "
                    f"config or the mesh (e.g. GQA kv heads vs tensor "
                    f"parallelism)"
                )

    check("", params, param_specs)


def shard_batch(
    batch: Dict[str, torch.Tensor], mesh=None, template=None
) -> Dict[str, torch.Tensor]:
    """This rank's part of a global batch: its rows along the template's
    batch axes (row-major over them, as the reference's batch sharding
    places rows on devices; under a composed pipeline its block of each
    global microbatch in microbatch order), and under a ring
    or Ulysses template the contiguous sequence shard of every ``[B, T]``
    entry of a token batch with ``positions`` set to its global positions.
    A batch without ``tokens`` (images) keeps its rows whole along the
    sequence axis: the image models cut their patches themselves
    (``models/vit.py``).  Without a template or mesh, the batch as given."""
    if template is None or mesh is None:
        return dict(batch)
    out = dict(batch)
    index, count = mesh.shard(template.batch_axes)
    if count > 1:
        micro = template.num_microbatches if template.pipeline_composed else 1
        B = {x.shape[0] for x in out.values()}
        if len(B) != 1 or next(iter(B)) % (count * micro):
            raise ValueError(
                f"batch rows {sorted(B)} do not split over {count} ranks of "
                f"{template.batch_axes} x {micro} microbatches"
            )
        # The reference cuts microbatch m (global rows [m·B/M, (m+1)·B/M))
        # before the data split (polyaxon_tpu/parallel/pipeline.py:64-66, the
        # schedule of pipeline_scan_composed :175-186): a rank's local
        # microbatch m is its block of global microbatch m, whose MoE routing
        # spans the data ranks.  One microbatch: the rank's contiguous rows.
        rows = torch.arange(B.pop()).view(micro, count, -1)[:, index].reshape(-1)
        out = {name: x[rows.to(x.device)] for name, x in out.items()}
    seq_axis = template.ring_axis or template.ulysses_axis
    if seq_axis is None or "tokens" not in out:
        return out
    n, r = mesh.shape[seq_axis], mesh.rank(seq_axis)
    B, T = out["tokens"].shape
    if T % n:
        raise ValueError(f"sequence length {T} does not split over {n} ranks of {seq_axis!r}")
    Tl = T // n
    positions = out.pop("positions", None)
    out = {name: x[:, r * Tl:(r + 1) * Tl] for name, x in out.items()}
    if positions is None:
        positions = torch.arange(T, device=out["tokens"].device).expand(B, T)
    out["positions"] = positions[:, r * Tl:(r + 1) * Tl]
    return out


def _all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum ``tensors`` over ``group`` in one collective a dtype: each dtype's
    tensors ride one flat buffer, the dtypes in a fixed order (thread ranks
    share an autograd thread, so every rank must issue the same sequence)."""
    out: List[torch.Tensor] = list(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype in sorted(by_dtype, key=str):
        idx = by_dtype[dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def _spec_leaves(params: Any, specs: Any) -> List[Tuple]:
    """The spec of each leaf of ``params``, in ``tree_leaves`` order (the
    spec tree may hold its keys in another order)."""
    return spec_leaves(tree_map(lambda p, spec: spec, params, specs))


@dataclass
class TrainStep:
    """A train step plus its initializer, batch placement and, under a
    template that shards the params, the moves between each rank's shards
    and the whole state (the checkpoints' one-rank layout)."""

    step: Callable  # (params, opt_state, batch) -> (params, opt_state, metrics)
    init: Callable  # (generator) -> (params, opt_state)
    mesh: Any = None
    template: Any = None
    #: The params' spec tree (None: every param whole on every rank).
    param_specs: Any = None

    def place_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's shard of a global batch (:func:`shard_batch`)."""
        return shard_batch(batch, self.mesh, self.template)

    @property
    def sharded(self) -> bool:
        """Whether some param is split over a mesh axis above 1."""
        if self.param_specs is None:
            return False
        return any(self.mesh.shape.get(a, 1) > 1
                   for spec in spec_leaves(self.param_specs) for a in spec_axes(spec))

    def _map_state(self, fn, params: Any, opt_state: Any, *rest: Any) -> Tuple[Any, Any]:
        """``fn(leaf, spec, *matching leaves of rest)`` over the params and
        the AdamW moments (the moments take their param's spec)."""
        specs = tree_map(lambda p, spec: spec, params, self.param_specs)
        new_params = tree_map(fn, params, specs, *(r[0] for r in rest))
        if not isinstance(opt_state, AdamWState):
            return new_params, opt_state
        leaf_specs = spec_leaves(specs)
        moments = {}
        for name in ("mu", "nu"):
            others = [getattr(r[1], name) for r in rest]
            moments[name] = [fn(t, spec, *(o[i] for o in others))
                             for i, (t, spec) in enumerate(zip(getattr(opt_state, name),
                                                               leaf_specs))]
        return new_params, AdamWState(opt_state.count, moments["mu"], moments["nu"])

    def full_state(self, params: Any, opt_state: Any) -> Tuple[Any, Any]:
        """The whole params and AdamW state, as one rank holds them: every
        rank of the mesh joins the gathers."""
        with torch.no_grad():
            return self._map_state(lambda t, spec: gather_shards(t.detach(), spec, self.mesh),
                                   params, opt_state)

    def empty_full_state(self, params: Any, opt_state: Any) -> Tuple[Any, Any]:
        """Uninitialized host tensors of the whole state's shapes and dtypes:
        a restore's target (a checkpoint is read on the host); no collective."""
        return self._map_state(
            lambda t, spec: torch.empty(full_shape(t.shape, spec, self.mesh.shape),
                                        dtype=t.dtype),
            params, opt_state)

    def load_shards(self, full: Tuple[Any, Any], params: Any, opt_state: Any) -> None:
        """Copy this rank's shard of the whole state ``full`` (params,
        opt_state) into ``params`` and ``opt_state`` in place."""
        def copy(t, spec, whole):
            t.copy_(shard_tensor(whole, spec, self.mesh))
            return t

        with torch.no_grad():
            self._map_state(copy, params, opt_state, full)
        if isinstance(opt_state, AdamWState):
            opt_state.count = full[1].count


def build_train_step(
    *,
    loss_fn: Callable,
    init_fn: Callable,
    optimizer: Any,
    mesh=None,
    template=None,
    axes_tree: Any = None,
) -> TrainStep:
    """Wire a loss/init pair into a train step.

    ``loss_fn(params, batch) -> scalar`` and ``init_fn(generator) -> params``
    are closures over the model config (and over ``mesh`` and ``template``,
    as in the JAX package); the device is the generator's.  ``step``
    updates ``params`` and ``opt_state`` in place and returns them with
    ``metrics``: ``loss`` and ``grad_norm`` as float32 device scalars (read
    them where the host needs them; reading syncs the device).  ``mesh``
    and ``template``: a ported template (``parallel.templates.check_mesh``),
    a ported template alone (one rank), or neither.  ``axes_tree`` names
    every param's logical axes (the model's ``param_axes``, the reference's
    argument of the same name); without it every param is whole.

    ``init`` draws the whole params, checks that each sharded dimension
    divides over its mesh axes (:func:`_validate_param_shapes`) and keeps
    this rank's shard of each (``parallel.axes.tree_shard``); the AdamW
    moments are made on the shards, so they are sharded alike (``optim.
    AdamW`` is elementwise).

    Across ranks ``batch`` is this rank's shard (:meth:`TrainStep.place_batch`)
    and ``loss_fn`` its mean.  Each rank back-propagates its mean times a
    count ``c`` (the sum of its batch's ``mask``, or 1 without one: every
    rank holds as many positions), and the grads, the weighted losses and
    the counts are summed over the mesh axes that split the batch (the
    template's batch axes and its ring or Ulysses sequence axis), never over
    ``tensor`` or ``expert``, whose ranks hold the same rows, nor over
    ``pipeline``, whose stages compute the loss on the same broadcast
    outputs (each stage's block grads are its own, ``parallel/pipeline.py``;
    ``init`` splits the block's ``layers`` over it); dividing by the summed count
    gives the grads and the loss of the global mean, masked or not, as the
    reference's step takes them on the global batch (its masked loss is
    ``sum(nll * mask) / max(sum(mask), 1)``, ``models/transformer.py:667-670``).
    A param's grad is not summed over an axis that shards it: the backward
    of its fsdp gather (``collectives.gather_along``) already reduce-scattered
    it there.  The sums go one all-reduce a dtype over the mesh's world group
    where they span every axis above 1, else one an axis.  Under ``sp_ring``
    and ``ulysses`` a rank's grads hold what its sequence shard contributes,
    so their sum is the whole sequence's.

    ``grad_norm`` is that of the global grads: each param's sum of squares
    is summed over the axes that shard it, once for a param replicated over
    them.
    """
    if mesh is None:
        check_ported(template)
    else:
        check_mesh(template, mesh)
    spread = mesh is not None and mesh.size > 1
    specs = None
    if axes_tree is not None and template is not None and mesh is not None:
        specs = tree_specs(axes_tree, template.rules, dict(mesh.shape))
    if spread:
        wide = [a for a, n in mesh.shape.items() if n > 1]
        batch_like = set(template.batch_axes) | {template.ring_axis, template.ulysses_axis}
        sum_axes = tuple(a for a in wide if a in batch_like)
    plans: Dict[str, Any] = {}

    def plan(params: Any) -> Dict[str, Any]:
        """Per leaf, the axes its grad is summed over and the axes that shard it."""
        if not plans:
            leaf_specs = (_spec_leaves(params, specs) if specs is not None
                          else [()] * len(tree_leaves(params)))
            by_axes: Dict[Tuple[str, ...], List[int]] = {sum_axes: []}
            shards: Dict[Tuple[str, ...], List[int]] = {}
            for i, spec in enumerate(leaf_specs):
                split = tuple(a for a in spec_axes(spec) if mesh.shape.get(a, 1) > 1)
                by_axes.setdefault(tuple(a for a in sum_axes if a not in split), []).append(i)
                shards.setdefault(split, []).append(i)
            plans.update(reduce=by_axes, shards=shards)
        return plans

    def init(generator: torch.Generator) -> Tuple[Any, Any]:
        params = init_fn(generator)
        if specs is not None:
            _validate_param_shapes(params, specs, dict(mesh.shape))
            params = tree_shard(params, specs, mesh)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return params, optimizer.init(params)

    def reduce(grads: List[torch.Tensor], extras: List[torch.Tensor], params: Any):
        """The grads and ``extras`` (weighted loss, count) summed as above."""
        out = list(grads)
        for axes, idx in plan(params)["reduce"].items():
            tensors = [out[i] for i in idx] + (extras if axes == sum_axes else [])
            if not axes or not tensors:
                continue
            groups = ([mesh.world] if set(axes) == set(wide)
                      else [mesh.group(a) for a in axes])
            for group in groups:
                tensors = _all_reduce_sum(tensors, group)
            for i, t in zip(idx, tensors):
                out[i] = t
            if axes == sum_axes:
                extras = tensors[len(idx):]
        return out, extras

    def global_norm(grads: List[torch.Tensor], params: Any) -> torch.Tensor:
        squares = [g.float().square().sum() for g in grads]
        if not spread or specs is None:
            return torch.stack(squares).sum().sqrt()
        shards = plan(params)["shards"]
        whole = [squares[i] for i in shards.get((), [])]
        split = [s for s in shards if s]
        partials = torch.stack([torch.stack([squares[i] for i in shards[s]]).sum()
                                for s in split]) if split else squares[0].new_zeros(0)
        for a in wide:
            idx = [k for k, s in enumerate(split) if a in s]
            if idx:
                part = partials[idx].contiguous()
                dist.all_reduce(part, op=dist.ReduceOp.SUM, group=mesh.group(a))
                partials = partials.index_copy(0, torch.tensor(idx, device=part.device), part)
        total = partials.sum()
        return (total + torch.stack(whole).sum() if whole else total).sqrt()

    def step(params: Any, opt_state: Any, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(params)
        loss = loss_fn(params, batch)
        if not spread:
            grads = torch.autograd.grad(loss, leaves)
        else:
            mask = batch.get("mask")
            count = (torch.ones((), device=loss.device) if mask is None
                     else mask.float().sum().to(loss.device))
            grads = torch.autograd.grad(loss * count, leaves)
            grads, (loss, count) = reduce(list(grads), [loss.detach() * count, count], params)
            scale = 1.0 / torch.clamp(count, min=1.0)
            grads = [g * scale.to(g.dtype) for g in grads]
            loss = loss * scale
        with torch.no_grad():
            gnorm = global_norm(grads, params)
        opt_state = optimizer.update_(params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return TrainStep(step=step, init=init, mesh=mesh, template=template, param_specs=specs)
