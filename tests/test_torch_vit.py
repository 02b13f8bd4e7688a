"""Parity of the port's Vision Transformer (``polyaxon_tpu_torch/models/vit.py``)
with the JAX package's, on the CPU.

Weights come from the JAX ``init_params`` and cross to torch through numpy
(``params_from_jax``); uint8 images and labels come from numpy (both
``_patchify`` normalize them in float32).  A small float32 config (32 px,
patch 4, 2 layers, d 32, 2 heads of 16, d_ff 128), with ``remat`` off and
on.  Tolerances (float32, summation order only): logits, loss and accuracy
atol 1e-4; grads atol 1e-5; three train steps with ``vit_train``'s
optimizer (AdamW with a bf16 first moment) against the JAX
``build_train_step``: loss atol 1e-5, grad norm rtol 1e-5.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import vit as jvit
from polyaxon_tpu_torch.models import vit as tvit
from tests.torch_parity import (GNORM_RTOL, GRADS_ATOL, LOGITS_ATOL, STEP_ATOL,
                                assert_tree_close, carried, grads_of, images_np, three_steps,
                                to_torch)

SMALL = dict(image_size=32, patch_size=4, d_model=32, n_layers=2, n_heads=2, head_dim=16,
             d_ff=128, n_classes=10)


def configs(remat=False):
    return (jvit.ViTConfig(dtype=jnp.float32, remat=remat, **SMALL),
            tvit.ViTConfig(dtype=torch.float32, remat=remat, **SMALL))


def test_param_tree_and_patches_match_the_jax_ones():
    jcfg, tcfg = configs()
    jp = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tvit.init_params(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == jax.tree.map(lambda a: tuple(a.shape), jp)
    assert tcfg.n_params == jcfg.n_params and tcfg.num_patches == 64
    images = images_np(1, 2, SMALL["image_size"])["images"]
    np.testing.assert_array_equal(tvit._patchify(torch.from_numpy(images), tcfg).numpy(),
                                  np.asarray(jvit._patchify(jnp.asarray(images), jcfg)))


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
def test_logits_loss_accuracy_and_grads_match_jax(remat):
    jcfg, tcfg = configs(remat)
    jp = jvit.init_params(jax.random.PRNGKey(1), jcfg)
    tp = carried(jp)
    batch = images_np(2, 4, SMALL["image_size"])
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, to_torch(batch)
    tl = tvit.forward(tp, tb["images"], tcfg, device="cpu")
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (4, 10)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jvit.forward(jp, jb["images"], jcfg)),
                               atol=LOGITS_ATOL)
    np.testing.assert_allclose(float(tvit.accuracy(tp, tb, tcfg, device="cpu")),
                               float(jvit.accuracy(jp, jb, jcfg)), atol=LOGITS_ATOL)
    jloss, jgrads = jax.value_and_grad(jvit.loss_fn)(jp, jb, jcfg)
    tloss = tvit.loss_fn(tp, tb, tcfg, device="cpu")
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=LOGITS_ATOL)
    assert_tree_close(grads_of(tloss, tp), jgrads, atol=GRADS_ATOL)


def test_three_train_steps_with_a_bf16_first_moment_match_jax():
    jcfg, tcfg = configs()
    pairs = three_steps(
        lambda p, b, template, mesh: jvit.loss_fn(p, b, jcfg, template=template, mesh=mesh),
        lambda k: jvit.init_params(k, jcfg), jvit.param_axes(jcfg),
        lambda p, b: tvit.loss_fn(p, b, tcfg, device="cpu"),
        jax.random.PRNGKey(6), images_np(5, 4, SMALL["image_size"]), mu_dtype=torch.bfloat16)
    for (tl, tg), (jl, jg) in pairs:
        np.testing.assert_allclose(tl, jl, atol=STEP_ATOL)
        np.testing.assert_allclose(tg, jg, rtol=GNORM_RTOL)
    assert pairs[-1][0][0] < pairs[0][0][0]
