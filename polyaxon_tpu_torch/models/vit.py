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
so the same templates shard both families, each rank holding its shard of
every weight (``runtime.train.build_train_step``); the reference takes
every template as GSPMD constraints (:137-186), and the port splits the
compute itself (:func:`forward`): under a tensor axis Megatron's split of
the heads, the MLP columns and the classes; under ``ulysses`` the patches
over the sequence axis with the Ulysses swap around the attention; every
other split weight gathered at its use (``image_placement``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from polyaxon_tpu_torch._device import DeviceLike, require_on, resolve_device
from polyaxon_tpu_torch.models.transformer import _rmsnorm
from polyaxon_tpu_torch.parallel.axes import Placement
from polyaxon_tpu_torch.parallel.collectives import (
    all_to_all_swap,
    copy_to_group,
    gather_from_group,
    reduce_from_group,
    sum_over_group,
)
from polyaxon_tpu_torch.parallel.templates import check_mesh


def image_placement(axes_tree: Any, template, mesh) -> Placement:
    """The image models' :class:`Placement` under ``template`` (after
    ``check_mesh``, which raises on a ``custom`` rule the port does not
    split): the tensor axis local, every other split weight gathered at its
    use, the ``layers`` split over a pipeline axis among them (no schedule
    runs; its ranks hold the same rows, so the gather's backward keeps the
    rank's block of the grad)."""
    if template is not None:
        check_mesh(template, mesh)
    return Placement(axes_tree, template, mesh, pipeline_local=False)


def head_logits(x: torch.Tensor, head: torch.Tensor, bias: Optional[torch.Tensor],
                placement: Placement) -> torch.Tensor:
    """``x [B, D] @ head [+ bias]`` as float32 logits ``[B, n_classes]``,
    every class on every rank.  Under a tensor axis ``head`` (and ``bias``)
    is this rank's block of the classes (the ``vocab`` rule): ``x`` enters
    through Megatron's f, so its grad sums the ranks' blocks, and the
    logits are gathered (``gather_from_group``: the backward keeps this
    rank's block), as the reference's GSPMD program returns them whole."""
    tp = placement.tp_group
    logits = copy_to_group(x, tp) @ head.to(x.dtype)
    if bias is not None:
        logits = logits + bias.to(x.dtype)
    return gather_from_group(logits, -1, tp).float()


def _sequence_group(template, mesh, cfg):
    """The Ulysses axis's group when it spans ranks (None otherwise), after
    checking that the patches and the heads divide over it."""
    axis = None if template is None else template.ulysses_axis
    if axis is None or mesh.shape.get(axis, 1) == 1:
        return None
    n = mesh.shape[axis]
    if cfg.num_patches % n or cfg.n_heads % n:
        raise ValueError(f"Ulysses needs patches ({cfg.num_patches}) and heads ({cfg.n_heads}) "
                         f"divisible by the {axis!r} axis ({n})")
    return mesh.group(axis)


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
           placement: Placement, seq=None) -> torch.Tensor:
    """One encoder block (reference ``forward.block`` :154-178): dense bidirectional
    attention, probs cast to q's dtype before the product with v, then SwiGLU.
    Each weight is gathered here, at its use (inside the block's checkpoint
    under ``remat``).  Under a tensor axis the products run on the rank's
    heads and MLP columns, as the LM's ``_layer``: Megatron's f
    (``copy_to_group``) before q/k/v and wi/wg, g (``reduce_from_group``)
    after wo and wd.  Under ``seq`` (the Ulysses group) ``x`` holds this
    rank's patches: q/k/v swap them for every patch on the rank's share of
    the heads (``all_to_all_swap``), as the reference's ``attn_heads``
    constraint places them (:159-168), and the output swaps back."""
    layer = {name: placement.use(w, placement.spec("block", name)[1:])
             for name, w in layer.items()}
    tp = placement.tp_group
    h = copy_to_group(_rmsnorm(x, layer["attn_norm"]), tp)
    q, k, v = (all_to_all_swap(torch.einsum("bnd,dhk->bnhk", h, layer[n].to(h.dtype)), 2, 1, seq)
               for n in ("wq", "wk", "wv"))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * cfg.head_dim**-0.5
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    attn = all_to_all_swap(torch.einsum("bhqk,bkhd->bqhd", probs, v), 1, 2, seq)
    x = x + reduce_from_group(torch.einsum("bnhk,hkd->bnd", attn, layer["wo"].to(h.dtype)), tp)

    h = copy_to_group(_rmsnorm(x, layer["mlp_norm"]), tp)
    up = torch.einsum("bnd,df->bnf", h, layer["wi"].to(h.dtype))
    gate = torch.einsum("bnd,df->bnf", h, layer["wg"].to(h.dtype))
    y = torch.einsum("bnf,fd->bnd", F.silu(gate) * up, layer["wd"].to(h.dtype))
    return x + reduce_from_group(y, tp)


def forward(params: Dict[str, Any], images: torch.Tensor, cfg: ViTConfig,
            template=None, mesh=None, *, device: DeviceLike = "cuda") -> torch.Tensor:
    """images [B,H,W,C] → logits [B, n_classes] (float32); reference :137-186.

    ``params`` must lie on ``device``; ``images`` are moved there.  With
    ``cfg.remat`` each block is checkpointed while grads are being recorded.
    Under ``template`` and ``mesh`` the params are this rank's shards
    (:func:`image_placement`) and ``images`` this rank's rows; every rank
    returns the whole logits of its rows.  Under ``ulysses`` each rank of
    the sequence axis takes its contiguous block of the patches (and of
    ``pos_embed``), as the reference's ``("batch", "seq", None)`` constraint
    places them (:152); the mean pool is then a sum over the block, summed
    over the axis with ``sum_over_group`` and divided by ``num_patches``.
    Its backward sums the ranks' cotangents: every rank's loss holds the
    pooled logits, and the train step divides the grads it sums over the
    axis by the axis's size, so each rank's grads hold n times what its
    patches contribute.  Under ``sp_ring`` (and any other template) every
    rank of the ring axis computes its rows whole: the same grads on each,
    whose sum the train step divides by n."""
    c = cfg
    dev = resolve_device(device)
    placement = image_placement(param_axes(c), template, mesh)
    seq = _sequence_group(template, mesh, c)
    require_on(dev, patch_embed=params["patch_embed"])
    patches = _patchify(images.to(dev), c)
    pos = placement.at(params, "pos_embed")
    if seq is not None:
        n = c.num_patches // seq.size()
        lo = seq.rank() * n
        patches, pos = patches[:, lo:lo + n], pos[lo:lo + n]
    x = torch.einsum("bnp,pd->bnd", patches, placement.at(params, "patch_embed").to(c.dtype))
    x = x + pos.to(c.dtype)[None]
    remat = c.remat and torch.is_grad_enabled()
    # The layers split over a pipeline axis gathered first (no schedule runs);
    # unbind, not w[i]: its backward stacks the per-layer grads once.
    per_layer = {name: placement.use(w, placement.spec("block", name)[:1]).unbind(0)
                 for name, w in params["block"].items()}
    for i in range(c.n_layers):
        layer = {name: ws[i] for name, ws in per_layer.items()}
        x = (checkpoint(_block, x, layer, c, placement, seq, use_reentrant=False) if remat
             else _block(x, layer, c, placement, seq))
    x = _rmsnorm(x, placement.at(params, "final_norm"))
    if seq is None:
        pooled = x.mean(dim=1)  # [B, D]
    else:
        pooled = sum_over_group(x.sum(dim=1), seq) / c.num_patches
    return head_logits(pooled, placement.at(params, "head"), None, placement)


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
