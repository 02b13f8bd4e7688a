"""Flagship decoder-only transformer LM in PyTorch.

Counterpart of ``polyaxon_tpu/models/transformer.py``: the same config
fields, the same stacked ``[L, ...]`` parameter layouts (``wq [L,D,H,hd]``,
``wo [L,H,hd,D]``, ...), bf16 compute over float32 parameters, and the same
block arithmetic, so a JAX parameter tree carries over leaf by leaf
(:mod:`polyaxon_tpu_torch.models.weights`).  The layer scan is a Python loop.

Ported: the plain single-device forward, the dense MLP and the top-1
(switch) MoE MLP with its balance loss, GQA, flash or dense attention, the
remat policies (per-layer ``torch.utils.checkpoint``, selective for the
named policies), the training loss with its blockwise cross-entropy, and
every strategy template (``parallel.templates.PORTED_STRATEGIES``):
``ddp`` (the plain path on each rank's rows of the batch), ``fsdp`` (each
weight sharded by ``param_axes`` and gathered at its use), ``tp`` and
``tp_dp`` (heads, MLP columns and the vocabulary split over the ``tensor``
axis, Megatron style), ``sp_ring`` (ring attention over the sequence axis),
``ulysses`` (all-to-all attention over it), ``pp`` and ``pp_tp`` (the GPipe
schedule over the ``pipeline`` axis, ``parallel/pipeline.py``), ``ep`` (the
experts split over the ``expert`` axis) and ``custom`` (its rules, where the
port splits each).  MoE routes the global batch on every template but
``pp``, whose stages route each microbatch of each data rank, as the
reference's manual body does; under ``pp_tp`` each microbatch is cut from
the global batch and routed over the data ranks' tokens, as the
reference's composed body does.  A ``custom`` rule the port does not split,
MoE under a ``custom`` pipeline with a tensor or expert axis, and meshes
with another axis above 1 (``parallel.templates.check_mesh``) raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, replace
from typing import Any, Dict, Iterator, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from polyaxon_tpu_torch._device import DeviceLike, require_on, resolve_device
from polyaxon_tpu_torch.parallel.axes import Placement, entry_axes
from polyaxon_tpu_torch.parallel.collectives import (
    all_gather_cat,
    broadcast_from,
    copy_to_group,
    gather_from_group,
    group_size,
    reduce_from_group,
    sum_over_group,
)
from polyaxon_tpu_torch.parallel.flash import flash_attention, kernel_takes
from polyaxon_tpu_torch.parallel.pipeline import (
    check_stages,
    pipeline_scan,
    pipeline_scan_composed,
    run_stages,
)
from polyaxon_tpu_torch.parallel.ring import ring_attention_sharded
from polyaxon_tpu_torch.parallel.templates import check_mesh
from polyaxon_tpu_torch.parallel.ulysses import ulysses_attention_sharded

_ATTENTION_IMPLS = ("auto", "dense", "flash")
_REMAT_POLICIES = (
    "none", "dots", "dots_no_batch", "save_attn", "save_attn_mlp", "save_qkv_attn",
)
#: The values each named policy keeps (JAX's ``save_only_these_names``).
_SAVED_NAMES = {
    "save_attn": ("attn_out",),
    "save_attn_mlp": ("attn_out", "mlp_act"),
    "save_qkv_attn": ("q_proj", "k_proj", "v_proj", "attn_out"),
}
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
#: The MoE balance loss's weight in :func:`loss_fn` (the JAX ``loss_fn``'s
#: ``aux_weight`` default, which every caller there takes).
MOE_AUX_WEIGHT = 0.01


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    head_dim: int = 64
    d_ff: int = 2048
    max_seq: int = 1024
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    #: 0 = dense MLP; >0 = MoE with this many experts (top-1 switch routing).
    n_experts: int = 0
    #: Per-expert capacity = capacity_factor * tokens / n_experts.
    capacity_factor: float = 1.25
    #: Activation checkpointing of each layer (see :class:`_SavePolicy`).
    remat: bool = False
    remat_policy: str = "none"
    #: The TPU kernel's VMEM tile edge; kept so configs carry over.  The
    #: Hopper kernel picks its own tiles and does not read it.
    flash_block: int = 1024
    #: Grouped-query attention: number of K/V heads (None = n_heads).
    n_kv_heads: Optional[int] = None
    #: "auto" = the flash kernels on CUDA where they take head_dim and dtype
    #: (``flash.kernel_takes``), dense attention elsewhere and on the CPU;
    #: "flash" = the flash wrapper (its plain version on a CPU tensor);
    #: "dense" = :func:`_dense_attention`.  Under ``sp_ring`` the ring reads
    #: it the same way (:func:`~polyaxon_tpu_torch.parallel.ring.ring_attention_sharded`),
    #: and so does ``ulysses`` at a rank's share of the heads.
    attention_impl: str = "auto"
    #: Blockwise cross-entropy chunk of :func:`loss_fn` (0 = whole logits).
    ce_chunk: int = 0

    def __post_init__(self) -> None:
        if self.remat_policy not in _REMAT_POLICIES:
            raise ValueError(
                f"Unknown remat_policy {self.remat_policy!r} (one of {_REMAT_POLICIES})"
            )
        if self.attention_impl not in _ATTENTION_IMPLS:
            raise ValueError(
                f"Unknown attention_impl {self.attention_impl!r} (one of {_ATTENTION_IMPLS})"
            )
        if self.n_kv_heads is not None and not (0 < self.n_kv_heads <= self.n_heads):
            raise ValueError(
                f"n_kv_heads ({self.n_kv_heads}) must be in [1, n_heads={self.n_heads}]"
            )
        if self.n_heads % self.kv_heads:
            raise ValueError(
                f"n_heads ({self.n_heads}) must be divisible by n_kv_heads "
                f"({self.kv_heads})"
            )

    @property
    def kv_heads(self) -> int:
        return self.n_heads if self.n_kv_heads is None else self.n_kv_heads

    def scaled(self, **overrides) -> "TransformerConfig":
        return replace(self, **overrides)

    @property
    def n_params(self) -> int:
        """Parameter count (for MFU math)."""
        c = self
        attn = c.d_model * c.head_dim * (2 * c.n_heads + 2 * c.kv_heads)
        if c.n_experts:
            mlp = c.d_model * c.n_experts + c.n_experts * c.d_model * c.d_ff * 3
        else:
            mlp = c.d_model * c.d_ff * 3
        per_layer = attn + mlp + 2 * c.d_model
        return c.vocab_size * c.d_model * 2 + c.n_layers * per_layer + c.d_model


def param_axes(cfg: TransformerConfig) -> Dict[str, Any]:
    """Logical axis names for every parameter, mirroring :func:`init_params`
    (reference ``param_axes``, ``transformer.py:131-160``)."""
    block: Dict[str, Any] = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "heads", "head_dim"),
        "wv": ("layers", "embed", "heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "mlp_norm": ("layers", "embed"),
    }
    if cfg.n_experts:
        block.update(
            router=("layers", "embed", "experts"),
            wi=("layers", "experts", "embed", "mlp"),
            wg=("layers", "experts", "embed", "mlp"),
            wd=("layers", "experts", "mlp", "embed"),
        )
    else:
        block.update(
            wi=("layers", "embed", "mlp"),
            wg=("layers", "embed", "mlp"),
            wd=("layers", "mlp", "embed"),
        )
    return {
        "embed": ("vocab", "embed"),
        "unembed": ("embed", "vocab"),
        "final_norm": ("embed",),
        "block": block,
    }


def init_params(cfg: TransformerConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random parameters, drawn on ``generator``'s device.

    Same shapes, scales and layout as the JAX ``init_params``; the numbers
    differ (another generator), so parity tests carry JAX weights over with
    :func:`~polyaxon_tpu_torch.models.weights.params_from_jax` instead.
    """
    c = cfg
    dev, dt = generator.device, c.param_dtype

    def norm(*shape, scale):
        return torch.randn(shape, generator=generator, device=dev, dtype=dt) * scale

    L, D, H, hd, Fd = c.n_layers, c.d_model, c.n_heads, c.head_dim, c.d_ff
    Hkv = c.kv_heads
    block = {
        "attn_norm": torch.ones((L, D), device=dev, dtype=dt),
        "wq": norm(L, D, H, hd, scale=D**-0.5),
        "wk": norm(L, D, Hkv, hd, scale=D**-0.5),
        "wv": norm(L, D, Hkv, hd, scale=D**-0.5),
        "wo": norm(L, H, hd, D, scale=(H * hd) ** -0.5),
        "mlp_norm": torch.ones((L, D), device=dev, dtype=dt),
    }
    if c.n_experts:
        E = c.n_experts
        block.update(
            router=norm(L, D, E, scale=D**-0.5),
            wi=norm(L, E, D, Fd, scale=D**-0.5),
            wg=norm(L, E, D, Fd, scale=D**-0.5),
            wd=norm(L, E, Fd, D, scale=Fd**-0.5),
        )
    else:
        block.update(
            wi=norm(L, D, Fd, scale=D**-0.5),
            wg=norm(L, D, Fd, scale=D**-0.5),
            wd=norm(L, Fd, D, scale=Fd**-0.5),
        )
    return {
        "embed": norm(c.vocab_size, D, scale=1.0),
        "unembed": norm(D, c.vocab_size, scale=D**-0.5),
        "final_norm": torch.ones((D,), device=dev, dtype=dt),
        "block": block,
    }


def _rmsnorm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * w.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last (head_dim) axis, split halves. x: [B,T,H,d]."""
    d = x.shape[-1]
    exponent = -torch.arange(0, d // 2, dtype=torch.float32, device=x.device) / (d // 2)
    # theta stays a Python scalar: a tensor made from it on the card would be
    # a host-to-device copy, which drains the queue and cannot be captured.
    freqs = torch.pow(float(theta), exponent)
    angles = positions[..., None].float() * freqs  # [B,T,d/2]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _dense_attention(q, k, v, q_pos, k_pos):
    """Causal attention. q:[B,Tq,H,d] k,v:[B,Tk,H,d] → [B,Tq,H,d]."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = q_pos[:, None, :, None] >= k_pos[:, None, None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _use_flash(cfg: TransformerConfig, x: torch.Tensor, heads: Optional[int] = None) -> bool:
    """Whether the attention on this rank takes the flash path; x: [B, T, D],
    ``heads`` the rank's query heads (default all)."""
    if cfg.attention_impl == "auto":
        B, T, _ = x.shape
        q_shape = (B, T, heads or cfg.n_heads, cfg.head_dim)
        return x.device.type == "cuda" and kernel_takes(q_shape, x.dtype)
    return cfg.attention_impl == "flash"


class _SavePolicy:
    """What a checkpointed layer keeps for its backward under one
    ``remat_policy``; everything else is recomputed.

    Counterpart of the JAX checkpoint policies (``transformer.py:493-512``).
    A selective-checkpoint policy sees dispatcher ops, so:

    - ``dots`` keeps every matrix product's output (``aten.mm`` /
      ``aten.bmm``; the einsums lower to ``bmm``), ``dots_no_batch`` those
      with no batch dimension (``mm``, and ``bmm`` over a batch of one, which
      is how an einsum without batch axes lowers);
    - the named policies keep every op run inside :meth:`scope` of a name
      they list, the counterpart of ``checkpoint_name``.  The attention is
      one op there, the custom operator ``polyaxon_tpu_torch::flash_attention``
      on the flash path, so ``save_attn`` keeps its ``(out, lse)`` and the
      recompute launches no forward kernel: a ``save_attn`` step makes one
      forward launch per layer, ``none`` and ``dots`` two;
    - ``none`` keeps only the layer's inputs (plain checkpointing).
    """

    def __init__(self, remat_policy: str) -> None:
        self.remat_policy = remat_policy
        self.names = frozenset(_SAVED_NAMES.get(remat_policy, ()))
        self._scope: Optional[str] = None

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator[None]:
        prev, self._scope = self._scope, name
        try:
            yield
        finally:
            self._scope = prev

    def __call__(self, ctx, op, *args, **kwargs) -> CheckpointPolicy:
        keep = self._scope in self.names
        if self.remat_policy == "dots":
            keep = op in _MATMULS
        elif self.remat_policy == "dots_no_batch":
            keep = op is torch.ops.aten.mm.default or (
                op is torch.ops.aten.bmm.default and args[0].shape[0] == 1
            )
        return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE

    def checkpoint_kwargs(self) -> Dict[str, Any]:
        if self.remat_policy == "none":
            return {}
        return {"context_fn": functools.partial(create_selective_checkpoint_contexts, self)}


def _moe_mlp(x: torch.Tensor, layer: Dict[str, torch.Tensor], cfg: TransformerConfig,
             shard: Optional["_Shard"] = None):
    """Top-1 (switch) MoE MLP of x [B,T,D]: ``(y, gates [B,T,E] float32,
    expert_idx [B,T])``.

    Counterpart of the JAX ``_moe_mlp`` (``transformer.py:269-306``), token
    for token: the router's softmax in float32, each token's expert its
    argmax (the first on ties), its slot its rank among its expert's tokens
    in flattened ``[B·T]`` order, and tokens ranked at or past
    ``capacity = max(1, int(capacity_factor · tokens / E))`` dropped (their
    output 0, so the residual carries them); each kept token's expert
    output times its gate, the gate cast to the compute dtype.

    The reference dispatches and combines by einsums over a ``[tokens, E,
    C]`` one-hot.  Each of its rows holds at most one 1, so copying each
    kept token into its slot of ``[E, C, D]`` and gathering each token's
    slot back computes the same function, without those one-hots (335 MB
    each in float32 at 8 × 1024 tokens, E 4, C 2560) or their products.

    Across ranks (``shard``) it is the reference's semantics under GSPMD
    (``polyaxon_tpu/models/transformer.py:268-315``) over the global batch,
    this rank holding its shard of the tokens (``x``: its rows, and its
    sequence shard of them) and, with an expert axis, its block of the
    experts and of the router's columns:

    - each rank's expert indices are gathered over the axes that split
      tokens (:meth:`_Shard.rank_in_expert`, one int32 a token), so each
      token's rank within its expert is its place in the global ``b·T + t``
      order and ``capacity`` counts the global tokens;
    - a rank computes its own kept tokens of its own experts, at most
      ``min(capacity, its tokens)`` an expert;
    - over the expert axis, tokens are replicated: Megatron's f before the
      router and the experts, the router's logits gathered before the
      softmax (its backward keeps this rank's columns), the gate the combine
      reads through f (a rank combines only its experts' tokens, so the
      gates' cotangent is summed over the axis before it reaches the
      router; the balance loss's cotangent is whole on every rank and
      counts once), and g summing the experts' outputs;
    - where the rules split each expert's MLP columns over the tensor axis
      (``mlp`` there and no ``experts`` rule: ``pp_tp``, ``tp_dp``), each
      rank computes its columns of every expert: f before ``wi``/``wg`` on
      the dispatched tokens and g after ``wd``, as the dense MLP's
      Megatron split; the router and the routing are whole and the same on
      every rank of the axis.
    """
    B, T, D = x.shape
    E = cfg.n_experts
    tokens = B * T
    ex = None if shard is None else shard.expert_group
    cols = None if shard is None else shard.expert_mlp_group
    El = E // group_size(ex)
    e0 = (0 if ex is None else ex.rank()) * El
    x = copy_to_group(x, ex)
    logits = torch.einsum("btd,de->bte", x, layer["router"].to(x.dtype))
    gates = torch.softmax(gather_from_group(logits, -1, ex).float(), dim=-1)
    flat_gates = gates.reshape(tokens, E)
    expert_idx = flat_gates.argmax(dim=-1)
    gate_val = flat_gates.gather(1, expert_idx[:, None])[:, 0]
    split = shard is not None and bool(shard.token_groups)
    if split:
        rank, n_tokens = shard.rank_in_expert(expert_idx.view(B, T), E)
    else:
        rank, n_tokens = _rank_in_expert(expert_idx, E), tokens
    capacity = max(1, int(cfg.capacity_factor * n_tokens / E))
    local_e = expert_idx - e0
    mine = rank < capacity
    if ex is not None:
        mine &= (local_e >= 0) & (local_e < El)
        local_e = local_e.clamp(0, El - 1)
    # Each kept token's slot e·C + its place among this rank's kept tokens of
    # expert e (where the ranking counted only this rank's tokens, its rank);
    # the others go to a trash slot E·C, which the dispatch cuts off and the
    # combine reads as zeros.
    cap = min(capacity, tokens)
    place = _rank_in_expert(torch.where(mine, local_e, El), El + 1) if split else rank
    slot = torch.where(mine, local_e * cap + place, El * cap)
    expert_in = x.new_zeros(El * cap + 1, D).index_copy(0, slot, x.reshape(tokens, D))
    expert_in = copy_to_group(expert_in[:-1].view(El, cap, D), cols)
    h = torch.einsum("ecd,edf->ecf", expert_in, layer["wi"].to(x.dtype))
    g = torch.einsum("ecd,edf->ecf", expert_in, layer["wg"].to(x.dtype))
    out = reduce_from_group(torch.einsum("ecf,efd->ecd", F.silu(g) * h,
                                         layer["wd"].to(x.dtype)), cols)
    out = torch.cat([out.reshape(El * cap, D), out.new_zeros(1, D)])
    gate = copy_to_group(gate_val, ex).to(x.dtype)
    y = reduce_from_group(out.index_select(0, slot) * gate[:, None], ex)
    return y.reshape(B, T, D), gates, expert_idx.reshape(B, T)


def _rank_in_expert(expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each token's rank among the tokens of its expert, in order: the
    running count of each expert along the flattened tokens (the JAX
    ``_moe_mlp``'s ``cumsum(onehot) * onehot - 1``, ``transformer.py:288``)."""
    flat = expert_idx.reshape(-1).long()
    counts = (flat == torch.arange(n_experts, device=flat.device)[:, None]).long().cumsum(dim=1)
    return counts.gather(0, flat[None])[0] - 1


def moe_aux_loss(gates: torch.Tensor, expert_idx: torch.Tensor, n_experts: int,
                 groups=()) -> torch.Tensor:
    """Switch-transformer load-balancing loss of one layer (JAX
    ``moe_aux_loss``, ``transformer.py:309-315``; :func:`loss_fn` takes the
    mean over layers): ``E · Σ_e mean gate_e · share of tokens routed to e``.

    ``groups``: the process groups of the axes that split the tokens; the
    means are then over the global tokens (the sums all-reduced with
    :func:`~polyaxon_tpu_torch.parallel.collectives.sum_over_group`, whose
    backward sums the ranks' cotangents: each rank's loss holds the global
    value), as the reference takes them over the global batch."""
    me = gates.reshape(-1, n_experts).sum(dim=0)
    ce = F.one_hot(expert_idx.reshape(-1), n_experts).float().sum(dim=0)
    n = expert_idx.numel()
    for group in groups:
        me, ce = sum_over_group(me, group), sum_over_group(ce, group)
        n *= group.size()
    return n_experts * ((me / n) * (ce / n)).sum()


class TensorSplit:
    """What a spec tree splits over the tensor axis, for the Megatron
    products: the group that sums the attention output (the query heads,
    ``wq``/``wo``), whether the kv heads split with them (``wk``/``wv``), the
    group of the MLP columns (``wi``/``wg``/``wd``) and that of the
    vocabulary (``embed``'s rows, ``unembed``'s columns); None where the
    dimension stays whole.

    Under a template's own rules the three groups are the tensor axis's.  A
    tree fitted to the leaves' shapes (serving's,
    ``decode.decode_param_shardings``) keeps whole a dimension that the axis
    does not divide: ``n_kv_heads: 1`` under ``tensor: 2`` keeps ``wk`` and
    ``wv`` whole while ``wq`` splits.  Each rank's query heads then read the
    kv heads of their global indices (:meth:`kv_view`), a part of a GQA
    group where the axis cuts one (8 heads, 2 kv heads, ``tensor: 4``).
    """

    def __init__(self, cfg: TransformerConfig, specs: Any, mesh, axis: Optional[str]) -> None:
        group = None if axis is None else mesh.group(axis)

        def split(spec, dim: int) -> bool:
            return group is not None and len(spec) > dim and axis in entry_axes(spec[dim])

        blk = specs["block"]
        self.attn = group if split(blk["wq"], 2) else None
        self.kv_split = self.attn is not None and split(blk["wk"], 2)
        self.mlp = group if not cfg.n_experts and split(blk["wi"], 2) else None
        self.vocab = group if split(specs["embed"], 0) else None
        pairs = [("wo", 1, self.attn), ("wv", 2, self.attn if self.kv_split else None),
                 ("unembed", 1, self.vocab)]
        if not cfg.n_experts:
            pairs += [("wg", 2, self.mlp), ("wd", 1, self.mlp)]
        for name, dim, want in pairs:
            spec = specs["unembed"] if name == "unembed" else blk[name]
            if split(spec, dim) != (want is not None):
                raise NotImplementedError(
                    f"the spec {spec} of {name!r} splits the tensor axis {axis!r} unlike its "
                    "pair's (ROADMAP item 7: multi-process and parallelism)")
        #: This rank's query heads, and the global kv head each reads.
        self.heads = cfg.n_heads // group_size(self.attn)
        first = 0 if self.attn is None else self.attn.rank() * self.heads
        self.gqa = cfg.n_heads // cfg.kv_heads
        self.kv_of_q = [(first + i) // self.gqa for i in range(self.heads)]
        self._index: Dict[torch.device, torch.Tensor] = {}

    def kv_view(self, kv: torch.Tensor):
        """``(kv', group)``: of this rank's kv heads ``kv`` (dim 2), the ones its
        query heads read, and how many consecutive query heads share each, for
        the grouped contraction ``q.reshape(..., Hkv', group, d)``.  Where the
        kv heads split with the query heads, or neither splits, that is all of
        them and the model's group; where only the query heads split, the kv
        heads of their global indices: a narrowed view, or one copy a query
        head where the rank's heads straddle a group unevenly."""
        if self.attn is None or self.kv_split:
            return kv, self.gqa
        lo, hi = self.kv_of_q[0], self.kv_of_q[-1] + 1
        per = self.heads // (hi - lo)
        if all(kv_head == lo + i // per for i, kv_head in enumerate(self.kv_of_q)):
            return kv.narrow(2, lo, hi - lo), per
        if kv.device not in self._index:  # made once, outside any capture
            self._index[kv.device] = torch.tensor(self.kv_of_q, device=kv.device)
        return kv.index_select(2, self._index[kv.device]), 1

    def expand_kv(self, kv: torch.Tensor) -> torch.Tensor:
        """One kv head a query head of this rank (the GQA broadcast)."""
        kv, group = self.kv_view(kv)
        return kv.repeat_interleave(group, dim=2) if group > 1 else kv


class _Shard:
    """What one forward under a template needs beyond the config: the
    parameters' :class:`~polyaxon_tpu_torch.parallel.axes.Placement`, each
    block weight's spec within a layer (its ``layers`` dimension unbound),
    the sequence axis of the ring or of Ulysses, the pipeline axis, and
    MoE's routing across ranks: the axes above 1 that split the tokens
    (the batch axes, then the sequence axis; none under ``pp``, whose
    stages route each microbatch of each data rank; the batch axes under a
    composed pipeline, whose microbatches are cut from the global batch
    before the data split, ``runtime.train.shard_batch``), the expert
    axis's group, and the tensor group where it splits each expert's MLP
    columns.

    ``decode``: the decode prefill's (``forward(return_kv=True)``): every
    rank has the whole prompt, so no sequence axis runs; the pipeline axis
    is the one that splits the block's ``layers`` in ``specs`` (none where
    the fitted specs keep them whole), whose stages run their own layers in
    turn; and a weight that is not a layer's (the embedding, the final norm,
    the unembedding) is gathered over it where a rule splits it there."""

    def __init__(self, cfg: TransformerConfig, template, mesh, specs: Any = None,
                 decode: bool = False) -> None:
        self.mesh = mesh
        self.placement = Placement(param_axes(cfg), template, mesh, specs=specs,
                                   pipeline_local=not decode)
        self.tp = self.placement.tp_group
        self.split = TensorSplit(cfg, self.placement.specs, mesh, self.placement.tp_axis)
        self.layer_specs = {name: self.placement.spec("block", name)[1:]
                            for name in param_axes(cfg)["block"]}
        wide = lambda a: a is not None and mesh.shape.get(a, 1) > 1  # noqa: E731
        self.ring_axis = template.ring_axis
        self.ulysses_axis = template.ulysses_axis
        self.pipeline_axis = template.pipeline_axis
        if decode:
            lead = entry_axes((self.placement.spec("block", "wq") or (None,))[0])
            self.ring_axis = self.ulysses_axis = None
            self.pipeline_axis = lead[0] if len(lead) == 1 and wide(lead[0]) else None
        expert_axis = self.placement.expert_axis
        self.expert_group = None if expert_axis is None else mesh.group(expert_axis)
        self.token_batch_axes: tuple = ()
        self.token_seq_axis: Optional[str] = None
        if self.pipeline_axis is None or template.pipeline_composed:
            self.token_batch_axes = tuple(a for a in template.batch_axes if wide(a))
        if self.pipeline_axis is None:
            seq = self.ring_axis or self.ulysses_axis
            self.token_seq_axis = seq if wide(seq) else None
        wi = self.layer_specs.get("wi", ()) if cfg.n_experts else ()
        self.expert_mlp_group = (self.tp if len(wi) == 3 and self.placement.tp_axis
                                 in entry_axes(wi[2]) else None)

    @property
    def token_groups(self) -> list:
        """The process groups of the axes that split the tokens."""
        axes = self.token_batch_axes + ((self.token_seq_axis,) if self.token_seq_axis else ())
        return [self.mesh.group(a) for a in axes]

    def rank_in_expert(self, expert_idx: torch.Tensor, n_experts: int):
        """``(rank, n)``: each of this rank's tokens' rank among its expert's
        tokens in the global ``b·T + t`` order (flattened, this rank's
        ``[B, T]`` block), and the global token count.  ``expert_idx``: this
        rank's ``[B, T]``, gathered as int32 over the batch axes (rows, the
        innermost axis first) and the sequence axis (columns)."""
        B, T = expert_idx.shape
        whole = expert_idx.to(torch.int32)
        for a in reversed(self.token_batch_axes):
            whole = all_gather_cat(whole, 0, self.mesh.group(a))
        if self.token_seq_axis is not None:
            whole = all_gather_cat(whole, 1, self.mesh.group(self.token_seq_axis))
        rank = _rank_in_expert(whole, n_experts).view(whole.shape)
        bi, _ = self.mesh.shard(self.token_batch_axes)
        si = 0 if self.token_seq_axis is None else self.mesh.rank(self.token_seq_axis)
        return rank[bi * B:(bi + 1) * B, si * T:(si + 1) * T].reshape(-1), whole.numel()


def _layer(x, positions, layer, cfg: TransformerConfig, use_flash: bool,
           policy: _SavePolicy, want_kv: bool, shard: Optional[_Shard] = None):
    """One decoder block (JAX ``forward.block``): ``(x, aux)``, aux the
    layer's ``(k, v)`` when ``want_kv``, its MoE ``(gates, expert_idx)`` when
    ``cfg.n_experts``, else None.

    Under a template (``shard``) each weight is gathered here, at its use
    (fsdp; inside the layer's checkpoint, so remat frees the gathered copy
    after the forward and gathers again in the backward), and under a
    tensor axis the products run on the rank's heads and MLP columns:
    Megatron's f (:func:`copy_to_group`) before q/k/v and wi/wg, g
    (:func:`reduce_from_group`) after wo and wd, each over the group of the
    dimension it splits (:class:`TensorSplit`).  The GQA broadcast stays on
    the rank: its kv heads serve its query heads.
    """
    c = cfg
    attn_group = mlp_group = None
    if shard is not None:
        layer = {name: shard.placement.use(w, shard.layer_specs[name])
                 for name, w in layer.items()}
        attn_group, mlp_group = shard.split.attn, shard.split.mlp
    ring_axis = shard.ring_axis if shard is not None else None
    ulysses_axis = shard.ulysses_axis if shard is not None else None
    h = copy_to_group(_rmsnorm(x, layer["attn_norm"]), attn_group)
    wq, wk, wv = (layer[n].to(h.dtype) for n in ("wq", "wk", "wv"))
    with policy.scope("q_proj"):
        q = _rope(torch.einsum("btd,dhk->bthk", h, wq), positions, c.rope_theta)
    with policy.scope("k_proj"):
        k = _rope(torch.einsum("btd,dhk->bthk", h, wk), positions, c.rope_theta)
    with policy.scope("v_proj"):
        v = torch.einsum("btd,dhk->bthk", h, wv)
    kv = (k, v) if want_kv else None  # post-rope, pre-broadcast (GQA)
    # GQA: the ring carries the unexpanded KV (and broadcasts at each
    # kernel call); every other path broadcasts the KV heads here.
    group = c.n_heads // c.kv_heads
    if shard is not None and ring_axis is None:
        k, v = shard.split.expand_kv(k), shard.split.expand_kv(v)
    elif group > 1 and ring_axis is None:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    with policy.scope("attn_out"):
        if ring_axis is not None:
            attn = ring_attention_sharded(q, k, v, shard.mesh, ring_axis, impl=c.attention_impl)
        elif ulysses_axis is not None:
            attn = ulysses_attention_sharded(q, k, v, shard.mesh, ulysses_axis,
                                             impl=c.attention_impl, positions=positions)
        elif use_flash:
            attn = flash_attention(q, k, v, q.shape[-1] ** -0.5, device=x.device)
        else:
            attn = _dense_attention(q, k, v, positions, positions)
    x = x + reduce_from_group(torch.einsum("bthk,hkd->btd", attn, layer["wo"].to(h.dtype)),
                              attn_group)

    h = _rmsnorm(x, layer["mlp_norm"])
    if c.n_experts:
        y, gates, expert_idx = _moe_mlp(h, layer, c, shard)
        return x + y, (gates, expert_idx)
    h = copy_to_group(h, mlp_group)
    up = torch.einsum("btd,df->btf", h, layer["wi"].to(h.dtype))
    gate = torch.einsum("btd,df->btf", h, layer["wg"].to(h.dtype))
    act = F.silu(gate)
    with policy.scope("mlp_act"):
        y = act * up
    x = x + reduce_from_group(torch.einsum("btf,fd->btd", y, layer["wd"].to(h.dtype)), mlp_group)
    return x, kv


def _vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor, group) -> torch.Tensor:
    """The embedding of ``tokens`` from this rank's block of the vocabulary
    (rows ``[r·V/n, (r+1)·V/n)``): its rows where a token falls in the
    block, zeros elsewhere, summed over the group.  The reference's one-hot
    product over the sharded table (``transformer.py:378-393``) gives the
    same numbers: one nonzero term a token."""
    Vl = table.shape[0]
    local = tokens - group.rank() * Vl
    inside = (local >= 0) & (local < Vl)
    rows = table[local.clamp(0, Vl - 1)]
    return reduce_from_group(torch.where(inside[..., None], rows, torch.zeros_like(rows)), group)


def _unstacked(stacked: Dict[str, torch.Tensor]) -> list:
    """Each layer's weights of stacked ``[L, ...]`` ones (``unbind``, not
    ``w[i]``: its backward stacks the per-layer grads once)."""
    per_layer = {name: w.unbind(0) for name, w in stacked.items()}
    n = len(next(iter(per_layer.values())))
    return [{name: ws[i] for name, ws in per_layer.items()} for i in range(n)]


def forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    template=None,
    mesh=None,
    positions: Optional[torch.Tensor] = None,
    return_kv: bool = False,
    return_hidden: bool = False,
    *,
    specs: Any = None,
    device: DeviceLike = "cuda",
):
    """tokens [B,T] → logits [B,T,vocab] (float32).

    ``return_kv`` also returns the per-layer post-rope, unexpanded (GQA)
    key/value stacks ``(k, v)``, each ``[L,B,T,Hkv,d]`` — the decode
    prefill fills its cache from them (no MoE).  Under a template it is the
    decode prefill of every rank on the whole prompt ``tokens``: each
    rank's stacks hold its kv heads (all of them where they stay whole) of
    its layers; ``fsdp`` and ``ep`` gather each weight at its use, ``tp``,
    ``tp_dp`` run the rank's heads, ``sp_ring`` and ``ulysses`` run no
    sequence axis (the prompt is whole on every rank), and under ``pp`` and
    ``pp_tp`` each stage runs its own layers in turn on what the stage
    before sent (``parallel.pipeline.run_stages``; its stacks are
    ``[L/S, ...]``), the last stage's hidden states broadcast over the
    pipeline group before the final norm, so every rank returns the whole
    logits.  ``specs``: the
    spec tree ``params`` were cut by when it is not the template's own
    (serving's, fitted to the leaves: ``decode.decode_param_shardings``).  With ``cfg.n_experts`` the result is ``(logits or hidden, (gates
    [L,B,T,E], expert_idx [L,B,T]))``, the per-layer routing that
    :func:`loss_fn`'s balance loss reads (this rank's tokens; routed over the
    global batch, :func:`_moe_mlp`); under a pipeline ``(..., {"aux_loss":
    scalar})``, the balance loss reduced inside the schedule.
    ``return_hidden`` returns the final-norm hidden states [B,T,D] in the
    compute dtype instead of the logits, for :func:`loss_fn`'s blockwise
    cross-entropy.  With ``cfg.remat`` each layer is checkpointed while
    grads are being recorded.  ``params`` must already lie on ``device``;
    ``tokens`` is moved there.

    ``template`` (a :class:`~polyaxon_tpu_torch.parallel.templates.
    StrategyTemplate`) with ``mesh`` (:func:`~polyaxon_tpu_torch.runtime.
    mesh.build_mesh`) selects the strategy; ``params`` are then this rank's
    shards (``runtime.train.build_train_step`` cuts them by
    :func:`param_axes`).  ``ddp`` is the plain path on ``tokens``, this
    rank's rows when batch axes span ranks; ``fsdp`` gathers each weight at
    its use; ``tp`` and ``tp_dp`` run the layers on the rank's heads and MLP
    columns, the embedding and the logits on its block of the vocabulary
    (the logits returned are gathered: every rank sees the whole ``[B, T,
    vocab]``); ``sp_ring`` and ``ulysses`` run attention across the ranks of
    their sequence axis, ``tokens`` being this rank's sequence shard of its
    rows and ``positions`` their global positions
    (``runtime.train.shard_batch`` cuts both; ``positions`` defaults to
    ``arange(T)``, a shard at offset 0).  Under ``pp`` and ``pp_tp``
    (``template.pipeline_axis``) the layer loop is
    :func:`~polyaxon_tpu_torch.parallel.pipeline.pipeline_scan` (or its
    composed form) over the rank's stage, the same ``_layer`` under the same
    checkpoint as the stage body (the reference's ``jax.checkpoint(block)``
    inside the stage, :500-513); every rank of the pipeline returns the
    whole output.  ``ep`` (and ``tp`` with experts) runs the rank's
    experts on tokens replicated over the expert axis.
    """
    c = cfg
    dev = resolve_device(device)
    check_mesh(template, mesh)
    if return_kv and c.n_experts:
        raise NotImplementedError(
            "return_kv (the decode prefill) takes the dense model (no MoE): MoE decoding is "
            "not supported yet")
    require_on(dev, embed=params["embed"])
    tokens = tokens.to(dev)
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=dev).expand(B, T)
    else:
        positions = positions.to(dev)

    shard = (_Shard(c, template, mesh, specs, decode=return_kv) if template is not None
             else None)
    tp = shard.tp if shard is not None else None
    vocab = shard.split.vocab if shard is not None else None
    if shard is not None and shard.pipeline_axis is not None:
        check_stages(c.n_layers, mesh.shape[shard.pipeline_axis])
        if c.n_experts and not template.pipeline_composed and (
                tp is not None or shard.expert_group is not None):
            raise NotImplementedError(
                f"MoE under {template.name!r} (a pipeline that is not composed, with a "
                "tensor or expert axis) is not ported: the reference's manual body gathers "
                "the experts' weights whole in each stage (ROADMAP item 7: MoE under a "
                "custom pipeline, multi-process and parallelism)"
            )
    table = (params["embed"] if shard is None else shard.placement.at(params, "embed")).to(c.dtype)
    x = table[tokens] if vocab is None else _vocab_parallel_embed(table, tokens, vocab)  # [B,T,D]
    use_flash = _use_flash(c, x, c.n_heads if shard is None else shard.split.heads)
    policy = _SavePolicy(c.remat_policy)
    remat = c.remat and torch.is_grad_enabled()

    def block(h, pos, layer):
        args = (h, pos, layer, c, use_flash, policy, return_kv, shard)
        if remat:
            return checkpoint(_layer, *args, use_reentrant=False, **policy.checkpoint_kwargs())
        return _layer(*args)

    # The layers' aux: on a leading layer axis, (k, v) or (gates,
    # expert_idx); under a pipeline the balance loss reduced inside the
    # schedule, as the reference's {"aux_loss": ...} (:622-628).
    stacked = None
    if return_kv and shard is not None and shard.pipeline_axis is not None:
        check_stages(c.n_layers, mesh.shape[shard.pipeline_axis])
        group = mesh.group(shard.pipeline_axis)
        auxes = []

        def stage(h):
            for layer in _unstacked(params["block"]):
                h, aux = block(h, positions, layer)
                auxes.append(aux)
            return h

        x = broadcast_from(run_stages(x, group, stage), group, group.size() - 1)
        stacked = tuple(torch.stack(parts) for parts in zip(*auxes))
    elif shard is not None and shard.pipeline_axis is not None:
        scan = pipeline_scan_composed if template.pipeline_composed else pipeline_scan
        groups = shard.token_groups
        aux_fn = ((lambda a: moe_aux_loss(a[0], a[1], c.n_experts, groups)) if c.n_experts
                  else None)
        x, pp_aux = scan(block, x, positions, params["block"], mesh,
                         axis=shard.pipeline_axis, num_microbatches=template.num_microbatches,
                         batch_axes=template.batch_axes, aux_fn=aux_fn)
        if c.n_experts:
            stacked = {"aux_loss": pp_aux}
    else:
        auxes = []
        for layer in _unstacked(params["block"]):
            x, aux = block(x, positions, layer)
            auxes.append(aux)
        if return_kv or c.n_experts:
            stacked = tuple(torch.stack(parts) for parts in zip(*auxes))

    x = _rmsnorm(x, params["final_norm"] if shard is None
                 else shard.placement.at(params, "final_norm"))
    if return_hidden:
        return (x, stacked) if c.n_experts else x
    unembed = params["unembed"] if shard is None else shard.placement.at(params, "unembed")
    logits = torch.einsum("btd,dv->btv", copy_to_group(x, vocab), unembed.to(x.dtype)).float()
    logits = gather_from_group(logits, -1, vocab)
    if stacked is not None:
        return logits, stacked
    return logits


def _ce_chunk(xc, unembed, tc, mc, vocab=None):
    """The masked NLL sum and count of one chunk.  ``vocab``: ``(group,
    start)`` when ``unembed`` holds the columns ``[start, start + V/n)`` of
    the vocabulary on each rank of ``group`` (tensor parallelism): the max,
    the sum of exponentials and the target logit are then taken across the
    group, and no rank holds the whole ``[B, C, V]`` logits."""
    logits = torch.einsum("bcd,dv->bcv", xc, unembed.to(xc.dtype)).float()
    if vocab is None:
        lse = torch.logsumexp(logits, dim=-1)
        tl = logits.gather(-1, tc[..., None])[..., 0]
        return ((lse - tl) * mc).sum(), mc.sum()
    group, start = vocab
    with torch.no_grad():  # a shift for the exponentials only: no grad flows through it
        peak = logits.amax(dim=-1)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    sumexp = reduce_from_group(torch.exp(logits - peak[..., None]).sum(dim=-1), group)
    lse = torch.log(sumexp) + peak
    local = tc - start
    inside = (local >= 0) & (local < logits.shape[-1])
    tl = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    tl = reduce_from_group(torch.where(inside, tl, torch.zeros_like(tl)), group)
    return ((lse - tl) * mc).sum(), mc.sum()


def _blockwise_ce(
    x: torch.Tensor,
    unembed: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor],
    chunk: int,
    tp=None,
) -> torch.Tensor:
    """Mean masked next-token NLL without materializing [B,T,V] logits.

    Counterpart of the JAX ``_blockwise_ce``: each ``chunk`` of the sequence
    is projected to logits, reduced to logsumexp and the target logit, and
    dropped; each chunk is checkpointed, so the backward recomputes its
    logits instead of keeping them.  ``tp``: the tensor group when
    ``unembed`` is this rank's block of the vocabulary columns
    (:func:`_ce_chunk`); ``x`` enters it through Megatron's f, so the
    backward sums the ranks' grads of the hidden states once.
    """
    B, T, _ = x.shape
    m = torch.ones((B, T), dtype=torch.float32, device=x.device) if mask is None else mask.float()
    vocab = None
    if tp is not None:
        x = copy_to_group(x, tp)
        vocab = (tp, tp.rank() * unembed.shape[1])
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, T, chunk):
        args = (x[:, s:s + chunk], unembed, targets[:, s:s + chunk], m[:, s:s + chunk], vocab)
        if torch.is_grad_enabled():
            part, n = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            part, n = _ce_chunk(*args)
        nll_sum = nll_sum + part
        cnt = cnt + n
    return nll_sum / torch.clamp(cnt, min=1.0)


def loss_fn(
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    cfg: TransformerConfig,
    template=None,
    mesh=None,
    *,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Next-token cross-entropy of ``batch`` (``tokens``, ``targets``, and
    optional ``mask`` and ``positions``), a float32 scalar; with
    ``cfg.n_experts`` plus :data:`MOE_AUX_WEIGHT` times the mean over layers
    of :func:`moe_aux_loss` (JAX ``loss_fn``, ``transformer.py:632-681``).

    With ``cfg.ce_chunk`` dividing the sequence it goes through
    :func:`_blockwise_ce`, and so does a template with a tensor axis (one
    chunk of the whole sequence unless ``ce_chunk`` divides it): the
    vocabulary-parallel cross-entropy.  Across ranks the batch is this
    rank's shard (its rows, and under ``sp_ring`` and ``ulysses`` its
    sequence shard of them) and the loss its mean;
    ``runtime.train.build_train_step`` weighs the ranks' means into the
    global one.
    """
    dev = resolve_device(device)
    targets = batch["targets"].to(dev).long()
    mask = batch.get("mask")
    mask = None if mask is None else mask.to(dev)
    T = targets.shape[-1]
    chunked = bool(cfg.ce_chunk and T % cfg.ce_chunk == 0)
    shard = _Shard(cfg, template, mesh) if template is not None and mesh is not None else None
    tp = shard.tp if shard is not None else None
    out = forward(params, batch["tokens"], cfg, template=template, mesh=mesh,
                  positions=batch.get("positions"), return_hidden=chunked or tp is not None,
                  device=dev)
    if cfg.n_experts:
        out, aux = out
    if chunked or tp is not None:
        unembed = params["unembed"] if shard is None else shard.placement.at(params, "unembed")
        loss = _blockwise_ce(out, unembed, targets, mask, cfg.ce_chunk if chunked else T, tp)
    else:
        logp = torch.log_softmax(out, dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        if mask is None:
            loss = nll.mean()
        else:
            mask = mask.float()
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if cfg.n_experts:
        if isinstance(aux, dict):  # a pipeline's, reduced inside the schedule (:672-680)
            aux_loss = aux["aux_loss"]
        else:
            groups = shard.token_groups if shard is not None else ()
            aux_loss = torch.stack([moe_aux_loss(g, i, cfg.n_experts, groups)
                                    for g, i in zip(*aux)]).mean()
        loss = loss + MOE_AUX_WEIGHT * aux_loss
    return loss
