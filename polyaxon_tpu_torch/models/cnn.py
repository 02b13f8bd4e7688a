"""Image-classifier CNN in PyTorch: the quick-start CIFAR/MNIST workload family.

Counterpart of ``polyaxon_tpu/models/cnn.py``: the same config, the same
parameter tree (``conv{i}.w`` in HWIO ``[3, 3, cin, cout]``, ``dense.w``
with its rows in NHWC flatten order), bf16 compute over float32 parameters
and the same arithmetic, so a JAX tree carries over leaf by leaf
(:func:`~polyaxon_tpu_torch.models.weights.params_from_jax`).  The forward
takes NHWC images, as the reference does, and runs its convolutions in
NCHW (``F.conv2d`` for ``lax.conv_general_dilated``, ``F.max_pool2d`` for
``lax.reduce_window``); it permutes back to NHWC before it flattens, so the
dense layer reads its rows in the reference's (h, w, c) order.
``param_axes`` is the reference's, and each rank holds its shard of every
weight as the template's rules cut it (``runtime.train.build_train_step``),
as the reference's trainer places them (``polyaxon_tpu/builtins/trainers.py:490-495``;
its ``forward`` takes no template): the ``embed`` split over a data axis
(``fsdp``, ``tp_dp``, ``ep``, ``custom``) is gathered at its use
(``vit.image_placement``), the head's classes split over a tensor axis
(``tp``, ``tp_dp``, ``pp_tp``) give the ViT's gathered logits
(``vit.head_logits``), and every other axis (``pipeline``, ``sequence``,
``expert``) leaves the CNN whole, each of its ranks computing the same rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from polyaxon_tpu_torch._device import DeviceLike, require_on, resolve_device
from polyaxon_tpu_torch.models.vit import head_logits, image_placement


@dataclass(frozen=True)
class CNNConfig:
    """``cnn.CNNConfig`` (reference :21-42)."""

    image_size: int = 32
    in_channels: int = 3
    channels: Tuple[int, ...] = (64, 128, 256)
    n_classes: int = 10
    dense_dim: int = 256
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def flat_dim(self) -> int:
        """Features into the dense layer: the last stage's NHWC map, flattened."""
        spatial = self.image_size // (2 ** len(self.channels))
        return spatial * spatial * self.channels[-1]

    @property
    def n_params(self) -> int:
        total = 0
        cin = self.in_channels
        for cout in self.channels:
            total += 3 * 3 * cin * cout + cout
            cin = cout
        total += self.flat_dim * self.dense_dim + self.dense_dim
        total += self.dense_dim * self.n_classes + self.n_classes
        return total


def param_axes(cfg: CNNConfig) -> Dict[str, Any]:
    """Logical axes (reference ``param_axes``, ``cnn.py:45-53``): conv output
    channels and the dense hidden map to ``embed``, so the fsdp template
    shards them; everything else replicates."""
    axes: Dict[str, Any] = {}
    for i in range(len(cfg.channels)):
        axes[f"conv{i}"] = {"w": (None, None, None, "embed"), "b": ("embed",)}
    axes["dense"] = {"w": (None, "embed"), "b": ("embed",)}
    axes["head"] = {"w": ("embed", "vocab"), "b": ("vocab",)}
    return axes


def init_params(cfg: CNNConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random parameters on ``generator``'s device (reference
    ``init_params`` :56-81: the same shapes and scales; other numbers, so
    parity tests carry JAX weights over instead)."""
    dev, dt = generator.device, cfg.param_dtype

    def normal(*shape, scale):
        return torch.randn(shape, generator=generator, device=dev, dtype=dt) * scale

    params: Dict[str, Any] = {}
    cin = cfg.in_channels
    for i, cout in enumerate(cfg.channels):
        params[f"conv{i}"] = {
            "w": normal(3, 3, cin, cout, scale=(2.0 / (3 * 3 * cin)) ** 0.5),
            "b": torch.zeros((cout,), device=dev, dtype=dt),
        }
        cin = cout
    flat = cfg.flat_dim
    params["dense"] = {
        "w": normal(flat, cfg.dense_dim, scale=(2.0 / flat) ** 0.5),
        "b": torch.zeros((cfg.dense_dim,), device=dev, dtype=dt),
    }
    params["head"] = {
        "w": normal(cfg.dense_dim, cfg.n_classes, scale=cfg.dense_dim**-0.5),
        "b": torch.zeros((cfg.n_classes,), device=dev, dtype=dt),
    }
    return params


def forward(params: Dict[str, Any], images: torch.Tensor, cfg: CNNConfig,
            template=None, mesh=None, *, device: DeviceLike = "cuda") -> torch.Tensor:
    """images [B,H,W,C] → logits [B,n_classes] (float32); reference :83-104.

    Each stage is a 3x3 SAME convolution, its bias added in the compute dtype
    after it (as the reference adds it), ReLU and a 2x2 max pool.
    ``params`` must lie on ``device``; ``images`` are moved there.  Under
    ``template`` and ``mesh`` the params are this rank's shards, each
    gathered at its use but the head's block of the classes under a tensor
    axis (``vit.head_logits``)."""
    dev = resolve_device(device)
    dt = cfg.dtype
    placement = image_placement(param_axes(cfg), template, mesh)

    def use(layer, name):
        return placement.at(params, layer, name).to(dt)

    require_on(dev, conv0=params["conv0"]["w"])
    x = images.to(dev).to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW
    for i in range(len(cfg.channels)):
        w = use(f"conv{i}", "w").permute(3, 2, 0, 1)  # HWIO -> OIHW
        x = F.conv2d(x, w, padding="same") + use(f"conv{i}", "b")[:, None, None]
        x = F.max_pool2d(F.relu(x), kernel_size=2, stride=2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
    x = F.relu(x @ use("dense", "w") + use("dense", "b"))
    return head_logits(x, use("head", "w"), use("head", "b"), placement)


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: CNNConfig,
            template=None, mesh=None, *, device: DeviceLike = "cuda") -> torch.Tensor:
    """Mean cross-entropy of ``batch`` (``images``, ``labels``); reference :107-113."""
    logits = forward(params, batch["images"], cfg, template, mesh, device=device)
    logp = torch.log_softmax(logits, dim=-1)
    labels = batch["labels"].to(logits.device).long()
    return -logp.gather(-1, labels[:, None])[:, 0].mean()


def accuracy(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: CNNConfig,
             template=None, mesh=None, *, device: DeviceLike = "cuda") -> torch.Tensor:
    """Share of ``batch`` whose argmax logit is its label; reference :116-120."""
    logits = forward(params, batch["images"], cfg, template, mesh, device=device)
    labels = batch["labels"].to(logits.device).long()
    return (logits.argmax(dim=-1) == labels).float().mean()
