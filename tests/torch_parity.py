"""Shared rig of the model parity tests (``test_torch_cnn.py``,
``test_torch_vit.py``, ``test_torch_moe.py``): a JAX tree carried into the
port (``params_from_jax``) with its leaves requiring grad, grads as a tree,
a tree compared key by key (JAX returns dicts in sorted key order, the port
keeps the init's), seeded numpy images, and three steps of each package's
``build_train_step``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from polyaxon_tpu.parallel import template_for
from polyaxon_tpu.runtime import train as jtrain
from polyaxon_tpu.runtime.mesh import build_mesh
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.runtime import optim
from polyaxon_tpu_torch.runtime.train import build_train_step

#: float32 on both sides, the frameworks differing in summation order only.
LOGITS_ATOL, GRADS_ATOL, STEP_ATOL, GNORM_RTOL = 1e-4, 1e-5, 1e-5, 1e-5


def images_np(seed, batch, size, n_classes=10):
    """uint8 NHWC images and int32 labels from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, size, size, 3)).astype(np.uint8)
    return {"images": images, "labels": rng.integers(0, n_classes, batch).astype(np.int32)}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def carried(jparams):
    """The port's copy of a JAX tree, every leaf requiring grad."""
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    for p in optim.tree_leaves(tparams):
        p.requires_grad_(True)
    return tparams


def assert_tree_close(ttree, jtree, atol, path=""):
    for key, j in jtree.items():
        if isinstance(j, dict):
            assert_tree_close(ttree[key], j, atol, f"{path}{key}/")
        else:
            np.testing.assert_allclose(ttree[key].detach().float().numpy(),
                                       np.asarray(j, np.float32), atol=atol, rtol=0,
                                       err_msg=path + key)


def grads_of(loss, tparams):
    """The grads of ``loss`` as a tree shaped like ``tparams``."""
    leaves = optim.tree_leaves(tparams)
    flat = iter(torch.autograd.grad(loss, leaves))

    def rebuild(tree):
        return {k: rebuild(v) if isinstance(v, dict) else next(flat) for k, v in tree.items()}

    return rebuild(tparams)


def three_steps(jloss, jinit, jaxes, tloss, jparams_key, batch, mu_dtype=None, lr=1e-3):
    """Three steps of the JAX ``build_train_step`` (ddp over a one-device
    CPU mesh, ``optax.adamw(lr, mu_dtype=)``) and of the port's (``AdamW``)
    from the same weights on the same batch: each step's ((port loss, port
    grad_norm), (JAX loss, JAX grad_norm))."""
    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    tmpl = template_for("ddp", {"data": 1})
    jts = jtrain.build_train_step(
        loss_fn=lambda p, b: jloss(p, b, tmpl, mesh), init_fn=jinit, axes_tree=jaxes,
        optimizer=optax.adamw(lr, mu_dtype=jnp.bfloat16 if mu_dtype else None),
        mesh=mesh, template=tmpl)
    jparams, jopt = jts.init(jparams_key)
    tparams = carried(jparams)  # before the JAX step donates them
    jbatch = jts.place_batch({k: jnp.asarray(v) for k, v in batch.items()})
    optimizer = optim.AdamW(lr, mu_dtype=mu_dtype)
    tts = build_train_step(loss_fn=tloss, init_fn=None, optimizer=optimizer)
    topt = optimizer.init(tparams)
    tbatch = to_torch(batch)
    pairs = []
    for _ in range(3):
        jparams, jopt, jm = jts.step(jparams, jopt, jbatch, jparams_key)
        tparams, topt, tm = tts.step(tparams, topt, tbatch)
        pairs.append(((float(tm["loss"]), float(tm["grad_norm"])),
                      (float(jm["loss"]), float(jm["grad_norm"]))))
    return pairs
