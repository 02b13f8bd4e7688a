"""Pipeline parallelism: the stacked transformer layers as GPipe stages.

Counterpart of ``polyaxon_tpu/parallel/pipeline.py`` (:25-300).  There a
``shard_map`` runs the schedule over global arrays and ``lax.ppermute``
moves the activations; here each rank is one stage: it holds its L/S
contiguous layers (the ``layers`` dimension split over the pipeline axis,
``parallel/axes.py``) and runs :func:`pipeline_scan` on its shard of the
batch.  The schedule is the reference's: the local batch splits into M
microbatches of contiguous rows, and M + S − 1 ticks march them through the
stages; stage s works on microbatch i − s at tick i, exactly on ticks
[s, s + M), and after each tick but the last its output hops to stage s + 1
(``collectives.hop``; stage 0 receives zeros).  A bubble tick skips the
stage's compute, which the reference runs and masks; it does not skip the
hop, so that every rank makes the same calls.

The schedule is one autograd function (:class:`_Schedule`): its forward
keeps each valid tick's graph, and its backward walks the ticks in reverse,
one reverse hop before each tick's backward, so that every rank issues its
hops in one order whatever its stage computes.  (Left to the autograd
engine, a stage that skips a bubble or never reads a hop's output would
never run that hop's backward, and its peer would wait.)

Gradient convention: every pipeline rank computes the final norm, the
unembedding and the loss on the same broadcast activations.  The entry is
Megatron's f over the pipeline axis (``copy_to_group``), so the embedding's
grad, which only stage 0's ticks produce, reaches every rank whole; the
broadcast of the last stage's outputs is a masked all-reduce whose backward
hands the last stage one copy of the cotangent; the aux is summed over the
stages with g (``reduce_from_group``), so each stage's layers see its
cotangent once; nothing is summed over the pipeline axis by the train step.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from polyaxon_tpu_torch.parallel.collectives import (
    copy_to_group,
    group_size,
    hop,
    reduce_from_group,
    sum_over_group,
)
from polyaxon_tpu_torch.parallel.templates import RuntimeLayerError

#: ``block(x, positions, layer) -> (x, aux)``: one layer, as the plain loop runs it.
Block = Callable[[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Any]]


def run_stages(x: torch.Tensor, group, run_stage: Callable[[torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
    """One input through the stages in order, no microbatches and no
    autograd: the stage-owned decode's step (``models/decode.py``) and its
    prefill (``models/transformer.py:forward(return_kv=True)``).  Stage s
    calls ``run_stage`` on what stage s − 1 sent; after each stage but the
    last every rank of ``group`` calls :func:`~polyaxon_tpu_torch.parallel.
    collectives.hop` once, so the last stage ends with the output and the
    others with a tensor of its shape that nothing reads.  ``group`` None (or
    of one rank): ``run_stage(x)``."""
    n = group_size(group)
    for stage in range(n):
        if stage == (0 if group is None else group.rank()):
            x = run_stage(x)
        if stage < n - 1:
            x = hop(x, group)
    return x


def check_stages(n_layers: int, n_stages: int) -> None:
    """Raise unless the layers divide into the stages (reference :180, :261)."""
    if n_layers % n_stages:
        raise RuntimeLayerError(
            f"{n_layers} layers not divisible into {n_stages} pipeline stages"
        )


def _run_stage(block: Block, aux_fn, x, positions, names: Sequence[str],
               leaves: Sequence[torch.Tensor]):
    """The stage's layers in order on one microbatch (the reference's
    ``run_stage``, :74-90): ``(out, aux)``, aux the mean over the layers of
    ``aux_fn(layer aux)`` (None without ``aux_fn``)."""
    per_layer = [w.unbind(0) for w in leaves]  # unbind: one stacked grad a leaf
    auxes = []
    for i in range(leaves[0].shape[0]):
        x, aux = block(x, positions, {name: ws[i] for name, ws in zip(names, per_layer)})
        if aux_fn is not None:
            auxes.append(aux_fn(aux))
    return x, (torch.stack(auxes).mean() if auxes else None)


def _ticks(run, group, n_micro: int, names, x, positions, leaves, keep: bool):
    """The forward ticks of one stage: ``(y, aux_sum, kept)``; ``y`` the
    last stage's outputs of the microbatches in order (zeros on the other
    stages), ``aux_sum`` the stage's aux summed over its valid ticks
    (float32), ``kept`` each valid tick's ``(input, output, aux)`` with its
    graph when ``keep``."""
    S, s = group_size(group), (0 if group is None else group.rank())
    ticks = n_micro + S - 1
    mbs, pos = x.chunk(n_micro), positions.chunk(n_micro)
    kept: Dict[int, Tuple] = {}
    outputs: List[torch.Tensor] = []
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    state = None
    for i in range(ticks):
        if s <= i < s + n_micro:
            inp = mbs[i] if s == 0 else state
            if keep:
                inp = inp.detach().requires_grad_(True)
            with torch.set_grad_enabled(keep):
                # The fed microbatch's positions, as the reference's (:100-104):
                # the same for every microbatch of an LM batch.
                out, aux = run(inp, pos[min(i, n_micro - 1)], names, leaves)
            if keep:
                kept[i] = (inp, out, aux)
            if aux is not None:
                aux_sum = aux_sum + aux.detach().float()
            send = out.detach()
            if s == S - 1:
                outputs.append(send)
        else:
            send = torch.zeros_like(mbs[0])  # a bubble: no compute, the hop all the same
        if i < ticks - 1:  # the last tick's hop would feed nothing
            state = send if S == 1 else hop(send, group)
    y = torch.cat(outputs) if s == S - 1 else torch.zeros_like(x)
    return y, aux_sum, kept


class _Schedule(torch.autograd.Function):
    """The GPipe schedule of one stage (the reference's ``_pp_body``,
    :25-151) as one autograd function over ``x`` and the stage's layers:
    forward :func:`_ticks`, backward the ticks in reverse."""

    @staticmethod
    def forward(ctx, run, group, n_micro, names, x, positions, *leaves):
        inner = [w.detach().requires_grad_(w.requires_grad) for w in leaves]
        y, aux_sum, kept = _ticks(run, group, n_micro, names, x, positions, inner, keep=True)
        ctx.run_state = (group, n_micro, kept, inner, x.chunk(n_micro)[0].shape)
        return y, aux_sum

    @staticmethod
    def backward(ctx, g_y, g_aux):
        group, n_micro, kept, inner, mb_shape = ctx.run_state
        ctx.run_state = None
        S, s = group_size(group), (0 if group is None else group.rank())
        ticks = n_micro + S - 1
        g_y_mbs = g_y.chunk(n_micro) if s == S - 1 else None
        zeros = lambda: g_y.new_zeros(mb_shape)  # noqa: E731
        g_x: List[torch.Tensor] = [zeros() for _ in range(n_micro)] if s == 0 else []
        g_leaves: List[Optional[torch.Tensor]] = [None] * len(inner)
        g_state = zeros()  # the grad of what this stage took in from the hop after tick i
        for i in reversed(range(ticks)):
            g_out = None
            if i < ticks - 1:  # the reverse of the hop after tick i, on every stage
                g_out = g_state if S == 1 else hop(g_state, group, reverse=True)
            g_state = zeros()
            if i not in kept:
                continue
            inp, out, aux = kept.pop(i)
            if s == S - 1:
                g_out = g_y_mbs[i - s]
            outs, cots = [out], [g_out]
            if aux is not None and aux.requires_grad:
                outs.append(aux)
                cots.append(g_aux.to(aux.dtype))
            wants = [inp] + [w for w in inner if w.requires_grad]
            got = iter(torch.autograd.grad(outs, wants, cots, allow_unused=True))
            g_inp = next(got)
            for k, w in enumerate(inner):
                if w.requires_grad:
                    g = next(got)
                    if g is not None:
                        g_leaves[k] = g if g_leaves[k] is None else g_leaves[k] + g
            if g_inp is not None:
                if s == 0:
                    g_x[i] = g_inp
                else:
                    g_state = g_inp
        g_x_full = torch.cat(g_x) if s == 0 else torch.zeros_like(g_y)
        g_leaves = [g if g is not None or not w.requires_grad else torch.zeros_like(w)
                    for g, w in zip(g_leaves, inner)]
        return (None, None, None, None, g_x_full, None, *g_leaves)


def _microbatches(local_batch: int, num_microbatches: int) -> None:
    if num_microbatches < 1 or local_batch % num_microbatches:
        raise RuntimeLayerError(
            f"Local batch {local_batch} not divisible by {num_microbatches} microbatches"
        )


def pipeline_scan(block: Block, x: torch.Tensor, positions: torch.Tensor,
                  stage_layers: Dict[str, torch.Tensor], mesh, *, axis: str = "pipeline",
                  num_microbatches: int = 1, batch_axes: Sequence[str] = (),
                  aux_fn: Optional[Callable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer loop, pipelined over ``axis`` (reference ``pipeline_scan``,
    :232-300, with ``_pp_body``): ``(outputs [B, T, D], aux)``.

    ``block(x, positions, layer) -> (x, aux)`` is the plain loop's body;
    ``stage_layers`` this rank's stage, each leaf ``[L/S, ...]``; ``x`` and
    ``positions`` this rank's shard of the batch (its rows along
    ``batch_axes``), which must divide by ``num_microbatches``.  ``aux`` is
    the mean over the stages' layers and the microbatches of ``aux_fn(layer
    aux)`` (each microbatch's aux reduced inside the schedule, on its valid
    ticks only), averaged over ``batch_axes`` (the reference's pmean, with
    a backward that sums the ranks' cotangents: each data rank's loss holds
    the mean); a float32 zero without ``aux_fn``.
    """
    _microbatches(x.shape[0], num_microbatches)
    group = mesh.group(axis)
    S = mesh.shape[axis]
    names = list(stage_layers)
    leaves = [stage_layers[n] for n in names]
    run = functools.partial(_run_stage, block, aux_fn)
    x = copy_to_group(x, group)
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in leaves)):
        y, aux_sum = _Schedule.apply(run, group, num_microbatches, names, x, positions, *leaves)
    else:
        y, aux_sum, _ = _ticks(run, group, num_microbatches, names, x, positions, leaves,
                               keep=False)
    if S > 1:
        # Only the last stage holds real outputs: broadcast them over the
        # pipeline axis (the reference's final psum, :134-146; adding zeros
        # is exact in any dtype).  g's backward hands each stage the whole
        # cotangent, which only the last stage's schedule reads.
        y = reduce_from_group(y, group)
    if aux_fn is None:
        return y, torch.zeros((), dtype=torch.float32, device=x.device)
    # Summed over the stages with g: each stage's layers see the cotangent once.
    aux = reduce_from_group(aux_sum, group) / (S * num_microbatches)
    n = 1
    for a in batch_axes:
        if mesh.shape.get(a, 1) > 1:
            aux = sum_over_group(aux, mesh.group(a))
            n *= mesh.shape[a]
    return y, aux / n


def pipeline_scan_composed(block: Block, x: torch.Tensor, positions: torch.Tensor,
                           stage_layers: Dict[str, torch.Tensor], mesh, *,
                           axis: str = "pipeline", num_microbatches: int = 1,
                           batch_axes: Sequence[str] = (),
                           aux_fn: Optional[Callable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pp_tp``: the same schedule with each stage's layers run under the
    tensor group inside ``block`` (reference ``pipeline_scan_composed``,
    :154-229).  The reference cuts microbatch m from the global batch
    before the data split (global rows ``[m·B/M, (m+1)·B/M)``, :64-66) and
    its body's auto axes see every data rank's tokens of that microbatch;
    here ``x`` is this rank's block of each global microbatch in
    microbatch order (``runtime.train.shard_batch`` cuts the rows so), so
    its local microbatch m is its part of global microbatch m, and a
    ``block`` that routes MoE over the data group routes the reference's
    microbatch.  ``aux_fn`` then returns a value over the global
    microbatch already (the reference's ``batch_axis_names=()``, :211):
    it is not averaged over ``batch_axes`` again.  The global batch must
    divide by the microbatches (the reference's check), and so must the
    local one."""
    n = 1
    for a in batch_axes:
        n *= mesh.shape.get(a, 1)
    if (x.shape[0] * n) % num_microbatches:
        raise RuntimeLayerError(
            f"Global batch {x.shape[0] * n} not divisible by {num_microbatches} microbatches"
        )
    return pipeline_scan(block, x, positions, stage_layers, mesh, axis=axis,
                         num_microbatches=num_microbatches, aux_fn=aux_fn)
