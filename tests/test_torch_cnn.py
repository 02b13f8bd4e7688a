"""Parity of the port's CNN (``polyaxon_tpu_torch/models/cnn.py``) with the
JAX package's, on the CPU.

Weights come from the JAX ``init_params`` and cross to torch through numpy
(``params_from_jax``, conv weights in HWIO on both sides); images and labels
come from numpy.  A small float32 config (16 px, channels (8, 16), dense
32).  Tolerances (float32, summation order only): logits, loss and accuracy
atol 1e-4; grads atol 1e-5; three AdamW train steps of the port's
``build_train_step`` against the JAX one: loss atol 1e-5, grad norm rtol
1e-5.  The images are normalized as ``cnn_train`` normalizes them
(``images / 255 - 0.5`` in the compute dtype).
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import torch

from polyaxon_tpu.models import cnn as jcnn
from polyaxon_tpu_torch.models import cnn as tcnn
from tests.torch_parity import (GNORM_RTOL, GRADS_ATOL, LOGITS_ATOL, STEP_ATOL,
                                assert_tree_close, carried, grads_of, images_np, three_steps,
                                to_torch)

SMALL = dict(image_size=16, channels=(8, 16), dense_dim=32, n_classes=10)


def configs():
    return jcnn.CNNConfig(dtype=jnp.float32, **SMALL), tcnn.CNNConfig(dtype=torch.float32, **SMALL)


def normalized_np(batch):
    return dict(batch, images=batch["images"].astype(np.float32) / 255.0 - 0.5)


def test_param_tree_matches_the_jax_tree():
    jcfg, tcfg = configs()
    jp = jcnn.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tcnn.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == shapes
    assert tcfg.n_params == jcfg.n_params == sum(a.size for a in jax.tree.leaves(jp))


def test_logits_loss_accuracy_and_grads_match_jax():
    jcfg, tcfg = configs()
    jp = jcnn.init_params(jax.random.PRNGKey(1), jcfg)
    tp = carried(jp)
    batch = normalized_np(images_np(2, 8, SMALL["image_size"]))
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, to_torch(batch)
    tl = tcnn.forward(tp, tb["images"], tcfg, device="cpu")
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (8, 10)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jcnn.forward(jp, jb["images"], jcfg)),
                               atol=LOGITS_ATOL)
    np.testing.assert_allclose(float(tcnn.accuracy(tp, tb, tcfg, device="cpu")),
                               float(jcnn.accuracy(jp, jb, jcfg)), atol=LOGITS_ATOL)
    jloss, jgrads = jax.value_and_grad(jcnn.loss_fn)(jp, jb, jcfg)
    tloss = tcnn.loss_fn(tp, tb, tcfg, device="cpu")
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=LOGITS_ATOL)
    assert_tree_close(grads_of(tloss, tp), jgrads, atol=GRADS_ATOL)


def test_flatten_order_is_the_reference_nhwc():
    """The dense layer's rows are in (h, w, c) order: a dense weight that
    reads one NHWC feature gives that feature's value as the logit."""
    _, tcfg = configs()
    tp = tcnn.init_params(tcfg, torch.Generator().manual_seed(3))
    spatial = SMALL["image_size"] // 4
    h, w, c = 1, 2, 5
    tp["dense"]["w"].zero_()
    tp["dense"]["w"][(h * spatial + w) * SMALL["channels"][-1] + c, 0] = 1.0
    tp["head"]["w"].zero_()
    tp["head"]["w"][0, 0] = 1.0
    images = torch.from_numpy(normalized_np(images_np(4, 2, SMALL["image_size"]))["images"])
    x = images.permute(0, 3, 1, 2)
    for i in range(2):
        wt = tp[f"conv{i}"]["w"].permute(3, 2, 0, 1)
        x = torch.nn.functional.max_pool2d(torch.relu(torch.nn.functional.conv2d(
            x, wt, padding=1)), 2)
    want = torch.relu(x[:, c, h, w])
    torch.testing.assert_close(tcnn.forward(tp, images, tcfg, device="cpu")[:, 0], want)


def test_three_train_steps_match_jax():
    jcfg, tcfg = configs()
    batch = images_np(5, 8, SMALL["image_size"])

    def jloss(p, b, template, mesh):
        return jcnn.loss_fn(p, dict(b, images=b["images"].astype(jcfg.dtype) / 255.0 - 0.5), jcfg)

    def tloss(p, b):
        return tcnn.loss_fn(p, dict(b, images=b["images"].to(tcfg.dtype) / 255.0 - 0.5), tcfg,
                            device="cpu")

    pairs = three_steps(
        jloss, lambda k: jcnn.init_params(k, jcfg), jcnn.param_axes(jcfg), tloss,
        jax.random.PRNGKey(6), batch)
    for (tl, tg), (jl, jg) in pairs:
        np.testing.assert_allclose(tl, jl, atol=STEP_ATOL)
        np.testing.assert_allclose(tg, jg, rtol=GNORM_RTOL)
    assert pairs[-1][0][0] < pairs[0][0][0]  # the same batch every step: the loss falls
