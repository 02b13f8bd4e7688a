"""Flagship decoder-only transformer LM in PyTorch.

Counterpart of ``polyaxon_tpu/models/transformer.py``: the same config
fields, the same stacked ``[L, ...]`` parameter layouts (``wq [L,D,H,hd]``,
``wo [L,H,hd,D]``, ...), bf16 compute over float32 parameters, and the same
block arithmetic, so a JAX parameter tree carries over leaf by leaf
(:mod:`polyaxon_tpu_torch.models.weights`).  The layer scan is a Python loop.

Ported: the plain single-device forward, dense MLP, GQA, flash or dense
attention, the remat policies (per-layer ``torch.utils.checkpoint``,
selective for the named policies), the training loss with its blockwise
cross-entropy, and two strategy templates: ``ddp`` on a mesh whose axes are
all 1 (the plain path) and ``sp_ring`` (ring attention over the sequence
axis, each rank on its shard).  Other strategies, meshes with another axis
above 1, and MoE raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, replace
from typing import Any, Dict, Iterator, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from polyaxon_tpu_torch._device import DeviceLike, require_on, resolve_device
from polyaxon_tpu_torch.parallel.flash import flash_attention, kernel_takes
from polyaxon_tpu_torch.parallel.ring import ring_attention_sharded
from polyaxon_tpu_torch.parallel.templates import check_ported

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
    #: 0 = dense MLP; >0 = MoE (not ported yet).
    n_experts: int = 0
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
    #: it the same way (:func:`~polyaxon_tpu_torch.parallel.ring.ring_attention_sharded`).
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


def init_params(cfg: TransformerConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random parameters, drawn on ``generator``'s device.

    Same shapes, scales and layout as the JAX ``init_params``; the numbers
    differ (another generator), so parity tests carry JAX weights over with
    :func:`~polyaxon_tpu_torch.models.weights.params_from_jax` instead.
    """
    c = cfg
    if c.n_experts:
        raise NotImplementedError(
            "MoE is not ported yet (ROADMAP item 7: MoE / expert parallelism)"
        )
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
        "wi": norm(L, D, Fd, scale=D**-0.5),
        "wg": norm(L, D, Fd, scale=D**-0.5),
        "wd": norm(L, Fd, D, scale=Fd**-0.5),
    }
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


def _use_flash(cfg: TransformerConfig, x: torch.Tensor) -> bool:
    """Whether the unsharded attention takes the flash path; x: [B, T, D]."""
    if cfg.attention_impl == "auto":
        B, T, _ = x.shape
        return x.device.type == "cuda" and kernel_takes((B, T, cfg.n_heads, cfg.head_dim), x.dtype)
    return cfg.attention_impl == "flash"


def _check_strategy(template, mesh) -> Optional[str]:
    """The ring axis the forward runs over (None: the plain path), or raise
    on what the port does not run yet."""
    if template is None:
        if mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                f"a mesh {mesh.shape} without a strategy template is not ported "
                "(ROADMAP item 7: multi-process and parallelism)"
            )
        return None
    if mesh is None:
        raise ValueError(f"strategy template {template.name!r} needs a mesh")
    check_ported(template)
    wide = {a: n for a, n in mesh.shape.items() if n > 1 and a != template.ring_axis}
    if wide:
        raise NotImplementedError(
            f"strategy {template.name!r} on mesh axes {wide} is not ported yet: only a "
            "sp_ring sequence axis may span ranks (ROADMAP item 7: multi-process and "
            "parallelism)"
        )
    return template.ring_axis


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


def _layer(x, positions, layer, cfg: TransformerConfig, use_flash: bool,
           policy: _SavePolicy, want_kv: bool, mesh=None, ring_axis: Optional[str] = None):
    """One decoder block (JAX ``forward.block``): ``(x, (k, v) or None)``."""
    c = cfg
    h = _rmsnorm(x, layer["attn_norm"])
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
    if group > 1 and ring_axis is None:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    with policy.scope("attn_out"):
        if ring_axis is not None:
            attn = ring_attention_sharded(q, k, v, mesh, ring_axis, impl=c.attention_impl)
        elif use_flash:
            attn = flash_attention(q, k, v, q.shape[-1] ** -0.5, device=x.device)
        else:
            attn = _dense_attention(q, k, v, positions, positions)
    x = x + torch.einsum("bthk,hkd->btd", attn, layer["wo"].to(h.dtype))

    h = _rmsnorm(x, layer["mlp_norm"])
    up = torch.einsum("btd,df->btf", h, layer["wi"].to(h.dtype))
    gate = torch.einsum("btd,df->btf", h, layer["wg"].to(h.dtype))
    act = F.silu(gate)
    with policy.scope("mlp_act"):
        y = act * up
    x = x + torch.einsum("btf,fd->btd", y, layer["wd"].to(h.dtype))
    return x, kv


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
    device: DeviceLike = "cuda",
):
    """tokens [B,T] → logits [B,T,vocab] (float32).

    ``return_kv`` also returns the per-layer post-rope, unexpanded (GQA)
    key/value stacks ``(k, v)``, each ``[L,B,T,Hkv,d]`` — the decode
    prefill fills its cache from them (plain path only: no template).
    ``return_hidden`` returns the final-norm hidden states [B,T,D] in the
    compute dtype instead of the logits, for :func:`loss_fn`'s blockwise
    cross-entropy.  With ``cfg.remat`` each layer is checkpointed while
    grads are being recorded.  ``params`` must already lie on ``device``;
    ``tokens`` is moved there.

    ``template`` (a :class:`~polyaxon_tpu_torch.parallel.templates.
    StrategyTemplate`) with ``mesh`` (:func:`~polyaxon_tpu_torch.runtime.
    mesh.build_mesh`) selects the strategy: ``ddp`` on a mesh whose axes are
    all 1 is the plain path; ``sp_ring`` runs attention over the ring of its
    sequence axis, ``tokens`` being this rank's sequence shard and
    ``positions`` its global positions (``runtime.train.shard_batch`` cuts
    both; ``positions`` defaults to ``arange(T)``, a shard at offset 0).
    """
    c = cfg
    dev = resolve_device(device)
    ring_axis = _check_strategy(template, mesh)
    if return_kv and template is not None:
        raise NotImplementedError(
            "return_kv supports the plain-scan dense path only (no parallelism template)"
        )
    if c.n_experts:
        raise NotImplementedError(
            "MoE is not ported yet (ROADMAP item 7: MoE / expert parallelism)"
        )
    require_on(dev, embed=params["embed"])
    tokens = tokens.to(dev)
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=dev).expand(B, T)
    else:
        positions = positions.to(dev)

    x = params["embed"].to(c.dtype)[tokens]  # [B,T,D]
    use_flash = _use_flash(c, x)
    policy = _SavePolicy(c.remat_policy)
    remat = c.remat and torch.is_grad_enabled()
    # unbind, not w[i]: its backward stacks the per-layer grads once.
    per_layer = {name: w.unbind(0) for name, w in params["block"].items()}
    ks, vs = [], []
    for i in range(c.n_layers):
        layer = {name: ws[i] for name, ws in per_layer.items()}
        args = (x, positions, layer, c, use_flash, policy, return_kv, mesh, ring_axis)
        if remat:
            x, kv = checkpoint(_layer, *args, use_reentrant=False, **policy.checkpoint_kwargs())
        else:
            x, kv = _layer(*args)
        if return_kv:
            ks.append(kv[0])
            vs.append(kv[1])

    x = _rmsnorm(x, params["final_norm"])
    if return_hidden:
        return x
    logits = torch.einsum("btd,dv->btv", x, params["unembed"].to(x.dtype)).float()
    if return_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits


def _ce_chunk(xc, unembed, tc, mc):
    logits = torch.einsum("bcd,dv->bcv", xc, unembed.to(xc.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, tc[..., None])[..., 0]
    return ((lse - tl) * mc).sum(), mc.sum()


def _blockwise_ce(
    x: torch.Tensor,
    unembed: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor],
    chunk: int,
) -> torch.Tensor:
    """Mean masked next-token NLL without materializing [B,T,V] logits.

    Counterpart of the JAX ``_blockwise_ce``: each ``chunk`` of the sequence
    is projected to logits, reduced to logsumexp and the target logit, and
    dropped; each chunk is checkpointed, so the backward recomputes its
    logits instead of keeping them.
    """
    B, T, _ = x.shape
    m = torch.ones((B, T), dtype=torch.float32, device=x.device) if mask is None else mask.float()
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, T, chunk):
        args = (x[:, s:s + chunk], unembed, targets[:, s:s + chunk], m[:, s:s + chunk])
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
    optional ``mask`` and ``positions``), a float32 scalar.

    With ``cfg.ce_chunk`` dividing the sequence it goes through
    :func:`_blockwise_ce`.  Dense MLP only: MoE (and its balance loss)
    raises in :func:`forward`.  Under ``sp_ring`` the batch is this rank's
    sequence shard and the loss its mean; the whole sequence's loss is the
    mean over the ring's ranks (equal shards, no mask).
    """
    dev = resolve_device(device)
    targets = batch["targets"].to(dev).long()
    mask = batch.get("mask")
    mask = None if mask is None else mask.to(dev)
    chunked = bool(cfg.ce_chunk and targets.shape[-1] % cfg.ce_chunk == 0)
    out = forward(params, batch["tokens"], cfg, template=template, mesh=mesh,
                  positions=batch.get("positions"), return_hidden=chunked, device=dev)
    if chunked:
        return _blockwise_ce(out, params["unembed"], targets, mask, cfg.ce_chunk)
    logp = torch.log_softmax(out, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
