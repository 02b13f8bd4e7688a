"""Flagship decoder-only transformer LM in PyTorch.

Counterpart of ``polyaxon_tpu/models/transformer.py``: the same config
fields, the same stacked ``[L, ...]`` parameter layouts (``wq [L,D,H,hd]``,
``wo [L,H,hd,D]``, ...), bf16 compute over float32 parameters, and the same
block arithmetic, so a JAX parameter tree carries over leaf by leaf
(:mod:`polyaxon_tpu_torch.models.weights`).  The layer scan is a Python loop.

Ported: the plain single-device forward, dense MLP, GQA, and flash or dense
attention.  Parallelism templates and meshes, MoE, remat and ring/Ulysses
attention raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from polyaxon_tpu_torch._device import DeviceLike, require_on, resolve_device
from polyaxon_tpu_torch.parallel.flash import flash_attention

_ATTENTION_IMPLS = ("auto", "dense", "flash")


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
    #: Activation checkpointing (training slice; not ported yet).
    remat: bool = False
    remat_policy: str = "none"
    #: The TPU kernel's VMEM tile edge; kept so configs carry over.  The
    #: Hopper kernel picks its own tiles and does not read it.
    flash_block: int = 1024
    #: Grouped-query attention: number of K/V heads (None = n_heads).
    n_kv_heads: Optional[int] = None
    #: "auto" = the flash kernel on CUDA and dense attention on the CPU;
    #: "flash" = the flash wrapper (its plain version on a CPU tensor);
    #: "dense" = :func:`_dense_attention`.
    attention_impl: str = "auto"
    #: Blockwise cross-entropy chunk (read by the training loss; not ported yet).
    ce_chunk: int = 0

    def __post_init__(self) -> None:
        allowed = (
            "none", "dots", "dots_no_batch", "save_attn", "save_attn_mlp",
            "save_qkv_attn",
        )
        if self.remat_policy not in allowed:
            raise ValueError(
                f"Unknown remat_policy {self.remat_policy!r} (one of {allowed})"
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
        raise NotImplementedError("MoE is not ported yet (ROADMAP: MoE / expert parallelism)")
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
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
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
    if cfg.attention_impl == "auto":
        return x.device.type == "cuda"
    return cfg.attention_impl == "flash"


def forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    template=None,
    mesh=None,
    positions: Optional[torch.Tensor] = None,
    return_kv: bool = False,
    *,
    device: DeviceLike = "cuda",
):
    """tokens [B,T] → logits [B,T,vocab] (float32).

    ``return_kv`` also returns the per-layer post-rope, unexpanded (GQA)
    key/value stacks ``(k, v)``, each ``[L,B,T,Hkv,d]`` — the decode
    prefill fills its cache from them.  ``params`` must already lie on
    ``device``; ``tokens`` is moved there.
    """
    c = cfg
    dev = resolve_device(device)
    if template is not None or mesh is not None:
        raise NotImplementedError(
            "parallelism templates and meshes are not ported yet "
            "(ROADMAP: multi-process and parallelism)"
        )
    if c.n_experts:
        raise NotImplementedError("MoE is not ported yet (ROADMAP: MoE / expert parallelism)")
    if c.remat:
        raise NotImplementedError("remat is not ported yet (ROADMAP: training slice)")
    require_on(dev, embed=params["embed"])
    tokens = tokens.to(dev)
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=dev).expand(B, T)
    else:
        positions = positions.to(dev)

    x = params["embed"].to(c.dtype)[tokens]  # [B,T,D]
    use_flash = _use_flash(c, x)
    group = c.n_heads // c.kv_heads
    blk = params["block"]
    ks, vs = [], []
    for i in range(c.n_layers):
        layer = {name: w[i] for name, w in blk.items()}
        h = _rmsnorm(x, layer["attn_norm"])
        q = torch.einsum("btd,dhk->bthk", h, layer["wq"].to(h.dtype))
        k = torch.einsum("btd,dhk->bthk", h, layer["wk"].to(h.dtype))
        v = torch.einsum("btd,dhk->bthk", h, layer["wv"].to(h.dtype))
        q = _rope(q, positions, c.rope_theta)
        k = _rope(k, positions, c.rope_theta)
        if return_kv:
            ks.append(k)  # post-rope, pre-broadcast (GQA)
            vs.append(v)
        if group > 1:
            k = k.repeat_interleave(group, dim=2)
            v = v.repeat_interleave(group, dim=2)
        if use_flash:
            attn = flash_attention(q, k, v, q.shape[-1] ** -0.5, device=dev)
        else:
            attn = _dense_attention(q, k, v, positions, positions)
        x = x + torch.einsum("bthk,hkd->btd", attn, layer["wo"].to(h.dtype))

        h = _rmsnorm(x, layer["mlp_norm"])
        up = torch.einsum("btd,df->btf", h, layer["wi"].to(h.dtype))
        gate = torch.einsum("btd,df->btf", h, layer["wg"].to(h.dtype))
        y = F.silu(gate) * up
        x = x + torch.einsum("btf,fd->btd", y, layer["wd"].to(h.dtype))

    x = _rmsnorm(x, params["final_norm"])
    logits = torch.einsum("btd,dv->btv", x, params["unembed"].to(x.dtype)).float()
    if return_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits
