"""Vision Transformer in PyTorch: the image-classification flagship family.

Counterpart of ``polyaxon_tpu/models/vit.py``: the same config, the same
stacked ``[L, ...]`` parameter tree as the LM's (``wq [L,D,H,hd]``, ``wo
[L,H,hd,D]``, ``wi``/``wg``/``wd``), patchify as one contraction over
(patch_h, patch_w, C), learned position embeddings, bidirectional attention
with no mask, the LM's RMSNorm/SwiGLU block and a mean-pool head, so a JAX
tree carries over leaf by leaf.  The reference computes the attention as
plain einsums, outside any Pallas kernel, and so does the port (products
and a float32 softmax; no flash kernel runs here).  The layer scan is a
loop over the leading ``layers`` axis; ``remat`` checkpoints each block
(``torch.utils.checkpoint``).  ``param_axes`` names the LM's logical axes,
so the same templates shard both families: under ``fsdp`` each rank holds
its shard of every weight (``runtime.train.build_train_step``) and the
forward gathers each at its use.  ``tp``, ``tp_dp`` and ``ulysses`` on the
image models raise (ROADMAP item 7).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from polyaxon_tpu_torch._device import DeviceLike, require_on, resolve_device
from polyaxon_tpu_torch.models.transformer import _rmsnorm
from polyaxon_tpu_torch.parallel.axes import Placement
from polyaxon_tpu_torch.parallel.templates import check_mesh

#: Templates whose compute the image models do not split yet (ROADMAP item
#: 7).  The reference's ViT takes ``layers: pipeline`` as a GSPMD placement,
#: not as a schedule; the port's pipeline is the transformer's.
UNPORTED_IMAGE_STRATEGIES = ("tp", "tp_dp", "ulysses", "pp", "pp_tp", "ep", "custom")


def image_placement(axes_tree: Any, template, mesh) -> Placement:
    """The image models' :class:`Placement` under ``template``, or raise on
    a template whose compute they do not split (every one but ``ddp`` and
    ``fsdp``: ROADMAP item 7)."""
    if template is not None and template.name in UNPORTED_IMAGE_STRATEGIES:
        raise NotImplementedError(
            f"strategy {template.name!r} on the image models is not ported yet; ddp and "
            "fsdp are (ROADMAP item 7: multi-process and parallelism)")
    if template is not None:
        check_mesh(template, mesh)
    return Placement(axes_tree, template, mesh)


@dataclass(frozen=True)
class ViTConfig:
    """``vit.ViTConfig`` (reference :33-71)."""

    image_size: int = 32
    patch_size: int = 4
    in_channels: int = 3
    d_model: int = 192
    n_layers: int = 6
    n_heads: int = 6
    head_dim: int = 32
    d_ff: int = 768
    n_classes: int = 10
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False

    def scaled(self, **overrides) -> "ViTConfig":
        return replace(self, **overrides)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.in_channels

    @property
    def n_params(self) -> int:
        c = self
        attn = c.d_model * c.n_heads * c.head_dim * 4
        mlp = c.d_model * c.d_ff * 3
        per_layer = attn + mlp + 2 * c.d_model
        return (
            c.patch_dim * c.d_model  # patch embed
            + c.num_patches * c.d_model  # positions
            + c.n_layers * per_layer
            + c.d_model  # final norm
            + c.d_model * c.n_classes  # head
        )


def param_axes(cfg: ViTConfig) -> Dict[str, Any]:
    """Logical axes of every parameter, the LM's (reference ``param_axes``,
    ``vit.py:74-94``)."""
    block = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "heads", "head_dim"),
        "wv": ("layers", "embed", "heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "mlp_norm": ("layers", "embed"),
        "wi": ("layers", "embed", "mlp"),
        "wg": ("layers", "embed", "mlp"),
        "wd": ("layers", "mlp", "embed"),
    }
    return {
        "patch_embed": (None, "embed"),
        "pos_embed": (None, "embed"),
        "final_norm": ("embed",),
        "head": ("embed", "vocab"),
        "block": block,
    }


def init_params(cfg: ViTConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random parameters on ``generator``'s device (reference ``init_params``
    :97-123: the same shapes and scales)."""
    c = cfg
    dev, dt = generator.device, c.param_dtype

    def normal(*shape, scale):
        return torch.randn(shape, generator=generator, device=dev, dtype=dt) * scale

    L, D, H, hd, Fd = c.n_layers, c.d_model, c.n_heads, c.head_dim, c.d_ff
    block = {
        "attn_norm": torch.ones((L, D), device=dev, dtype=dt),
        "wq": normal(L, D, H, hd, scale=D**-0.5),
        "wk": normal(L, D, H, hd, scale=D**-0.5),
        "wv": normal(L, D, H, hd, scale=D**-0.5),
        "wo": normal(L, H, hd, D, scale=(H * hd) ** -0.5),
        "mlp_norm": torch.ones((L, D), device=dev, dtype=dt),
        "wi": normal(L, D, Fd, scale=D**-0.5),
        "wg": normal(L, D, Fd, scale=D**-0.5),
        "wd": normal(L, Fd, D, scale=Fd**-0.5),
    }
    return {
        "patch_embed": normal(c.patch_dim, D, scale=c.patch_dim**-0.5),
        "pos_embed": normal(c.num_patches, D, scale=0.02),
        "final_norm": torch.ones((D,), device=dev, dtype=dt),
        "head": normal(D, c.n_classes, scale=D**-0.5),
        "block": block,
    }


def _patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B,H,W,C] uint8/float → [B, num_patches, patch_dim] in the compute
    dtype, normalized in float32 first (reference :126-134)."""
    B = images.shape[0]
    p = cfg.patch_size
    g = cfg.image_size // p
    x = images.float() / 255.0 - 0.5
    x = x.reshape(B, g, p, g, p, cfg.in_channels)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, cfg.patch_dim)
    return x.to(cfg.dtype)


def _block(x: torch.Tensor, layer: Dict[str, torch.Tensor], cfg: ViTConfig,
           placement: Placement) -> torch.Tensor:
    """One encoder block (reference ``forward.block`` :154-178): dense bidirectional
    attention, probs cast to q's dtype before the product with v, then SwiGLU.
    Each weight is gathered here, at its use (inside the block's checkpoint
    under ``remat``)."""
    layer = {name: placement.use(w, placement.spec("block", name)[1:])
             for name, w in layer.items()}
    h = _rmsnorm(x, layer["attn_norm"])
    q, k, v = (torch.einsum("bnd,dhk->bnhk", h, layer[n].to(h.dtype)) for n in ("wq", "wk", "wv"))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * cfg.head_dim**-0.5
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    x = x + torch.einsum("bnhk,hkd->bnd", attn, layer["wo"].to(h.dtype))

    h = _rmsnorm(x, layer["mlp_norm"])
    up = torch.einsum("bnd,df->bnf", h, layer["wi"].to(h.dtype))
    gate = torch.einsum("bnd,df->bnf", h, layer["wg"].to(h.dtype))
    return x + torch.einsum("bnf,fd->bnd", F.silu(gate) * up, layer["wd"].to(h.dtype))


def forward(params: Dict[str, Any], images: torch.Tensor, cfg: ViTConfig,
            template=None, mesh=None, *, device: DeviceLike = "cuda") -> torch.Tensor:
    """images [B,H,W,C] → logits [B, n_classes] (float32); reference :137-186.

    ``params`` must lie on ``device``; ``images`` are moved there.  With
    ``cfg.remat`` each block is checkpointed while grads are being recorded.
    Under ``template`` and ``mesh`` the params are this rank's shards
    (:func:`image_placement`)."""
    c = cfg
    dev = resolve_device(device)
    placement = image_placement(param_axes(c), template, mesh)
    require_on(dev, patch_embed=params["patch_embed"])
    x = torch.einsum("bnp,pd->bnd", _patchify(images.to(dev), c),
                     placement.at(params, "patch_embed").to(c.dtype))
    x = x + placement.at(params, "pos_embed").to(c.dtype)[None]
    remat = c.remat and torch.is_grad_enabled()
    # unbind, not w[i]: its backward stacks the per-layer grads once.
    per_layer = {name: w.unbind(0) for name, w in params["block"].items()}
    for i in range(c.n_layers):
        layer = {name: ws[i] for name, ws in per_layer.items()}
        x = (checkpoint(_block, x, layer, c, placement, use_reentrant=False) if remat
             else _block(x, layer, c, placement))
    x = _rmsnorm(x, placement.at(params, "final_norm"))
    pooled = x.mean(dim=1)  # [B, D]
    return torch.einsum("bd,dk->bk", pooled, placement.at(params, "head").to(x.dtype)).float()


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: ViTConfig,
            template=None, mesh=None, *, device: DeviceLike = "cuda") -> torch.Tensor:
    """Mean cross-entropy of ``batch`` (``images``, ``labels``); reference :189-199."""
    logits = forward(params, batch["images"], cfg, template, mesh, device=device)
    logp = torch.log_softmax(logits, dim=-1)
    labels = batch["labels"].to(logits.device).long()
    return -logp.gather(-1, labels[:, None])[:, 0].mean()


def accuracy(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: ViTConfig,
             template=None, mesh=None, *, device: DeviceLike = "cuda") -> torch.Tensor:
    """Share of ``batch`` whose argmax logit is its label; reference :202-210."""
    logits = forward(params, batch["images"], cfg, template, mesh, device=device)
    labels = batch["labels"].to(logits.device).long()
    return (logits.argmax(dim=-1) == labels).float().mean()
