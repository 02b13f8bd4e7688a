"""The image models across ranks under every template but ``ddp`` and
``fsdp`` (``tests/test_torch_sharded.py`` holds those), against the JAX step
on the same virtual mesh.

The port's ranks are threads over gloo (``tests/torch_gang_ranks.py``), each
holding its shard of the params as the template's rules cut ``param_axes``
and its rows of the global batch (``TrainStep.place_batch``); the JAX side
runs ``build_train_step`` on the conftest's virtual CPU devices with the
same template (its ViT takes the template as GSPMD constraints, its CNN
takes none and is placed by ``param_axes``, as its trainer places it).
Weights come from the JAX ``init_params`` through numpy; images and labels
from numpy.  The models are ``tests/test_torch_sharded.py``'s small float32
ViT (16 px, patch 4: 16 patches, d 32, 2 heads of 16, 2 layers) and CNN
(channels (8, 16), dense 32), 10 classes, batch 8, ``adamw(3e-4)``.

Tolerances, float32, as ``tests/test_torch_gang_step.py``'s: each step's
loss and grad norm within 1e-5 of the JAX step's on every rank; each
rank's shard of every param and of AdamW's first moment after ``init`` the
JAX device shard bit for bit; the shards after 3 steps within 1e-5 wherever
the first-step gradient is at least ``GRAD_FLOOR``, within Adam's bound
elsewhere; ranks that hold the same shard hold it bit for bit.  A gather
whose backward summed the grads of ranks that hold the same rows (the
``pipeline`` split, the ``tensor`` axis a ``custom`` rule names) would
double those grads: the grad norm and the steps show it.

Also: the reference's check that ``block.wq`` is split over ``tensor``
(``tests/test_parallel/test_strategies.py:364-377``), and 10 classes over
``tensor: 4``, which both packages refuse with the same error.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyaxon_tpu.exceptions import RuntimeLayerError as JaxRuntimeLayerError
from polyaxon_tpu.models import cnn as jcnn
from polyaxon_tpu.models import vit as jvit
from polyaxon_tpu.parallel import template_for as jax_template_for
from polyaxon_tpu.parallel.axes import tree_specs as jax_tree_specs
from polyaxon_tpu.runtime import train as jtrain
from polyaxon_tpu.runtime.mesh import build_mesh as jax_build_mesh
from polyaxon_tpu_torch.models import cnn as tcnn
from polyaxon_tpu_torch.models import vit as tvit
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.parallel import axes as taxes
from polyaxon_tpu_torch.parallel.templates import RuntimeLayerError, template_for
from polyaxon_tpu_torch.runtime import optim
from polyaxon_tpu_torch.runtime.train import _validate_param_shapes, build_train_step
from tests.test_torch_gang_step import (
    LR,
    STEPS,
    _paths,
    _shard,
    assert_params_close,
    optim_moments,
)
from tests.torch_gang_ranks import run_mesh_ranks
from tests.torch_parity import images_np

VIT = dict(image_size=16, patch_size=4, d_model=32, n_layers=2, n_heads=2, head_dim=16,
           d_ff=64, n_classes=10)
CNN = dict(image_size=16, channels=(8, 16), dense_dim=32, n_classes=10)
BATCH = 8
#: name -> (model, strategy, mesh axes, template options)
CASES = {
    "vit-tp-data2-tensor2": ("vit", "tp", {"data": 2, "tensor": 2}, {}),
    "vit-tp_dp-data2-tensor2": ("vit", "tp_dp", {"data": 2, "tensor": 2}, {}),
    "vit-ulysses-sequence2": ("vit", "ulysses", {"sequence": 2}, {}),
    "vit-pp-pipeline2": ("vit", "pp", {"pipeline": 2}, {}),
    "vit-pp_tp-pipeline2-tensor2": ("vit", "pp_tp", {"pipeline": 2, "tensor": 2}, {}),
    "vit-ep-data2-expert2": ("vit", "ep", {"data": 2, "expert": 2}, {}),
    # The embedding over an axis that splits no rows: its ranks hold the same
    # grads, which the gather's backward must not sum.
    "vit-custom-data2-tensor2": ("vit", "custom", {"data": 2, "tensor": 2},
                                 {"rules": {"embed": "tensor"}}),
    "vit-sp_ring-sequence2": ("vit", "sp_ring", {"sequence": 2}, {}),
    "cnn-tp-tensor2": ("cnn", "tp", {"tensor": 2}, {}),
    "cnn-tp_dp-data2-tensor2": ("cnn", "tp_dp", {"data": 2, "tensor": 2}, {}),
    "cnn-sp_ring-sequence2": ("cnn", "sp_ring", {"sequence": 2}, {}),
}


def models(name):
    """(JAX config, port config, JAX module, port module, JAX loss, port loss);
    the CNN's losses take uint8 images normalized as its trainer does."""
    if name == "vit":
        jcfg = jvit.ViTConfig(dtype=jnp.float32, **VIT)
        tcfg = tvit.ViTConfig(dtype=torch.float32, **VIT)
        return (jcfg, tcfg, jvit, tvit,
                lambda p, b, t, m: jvit.loss_fn(p, b, jcfg, template=t, mesh=m),
                lambda p, b, t, m: tvit.loss_fn(p, b, tcfg, t, m, device="cpu"))
    jcfg = jcnn.CNNConfig(dtype=jnp.float32, **CNN)
    tcfg = tcnn.CNNConfig(dtype=torch.float32, **CNN)

    def jloss(p, b, t, m):
        return jcnn.loss_fn(p, dict(b, images=b["images"].astype(jnp.float32) / 255.0 - 0.5), jcfg)

    def tloss(p, b, t, m):
        return tcnn.loss_fn(p, dict(b, images=b["images"].float() / 255.0 - 0.5), tcfg, t, m,
                            device="cpu")

    return jcfg, tcfg, jcnn, tcnn, jloss, tloss


def batch_np():
    return images_np(11, BATCH, VIT["image_size"])


@functools.lru_cache(maxsize=None)
def one_device_grad(name):
    """The jitted JAX gradient of the loss over the whole batch, one device."""
    jloss = models(name)[4]
    return jax.jit(jax.grad(lambda p, b: jloss(p, b, None, None)))


@functools.lru_cache(maxsize=None)
def jax_run(name, strategy, axes_items, options_json):
    """The JAX step on the virtual mesh: the initial params, each step's
    loss and grad norm, the final params, the one-device gradient at the
    initial params, and per param path each device's index and its shards
    of the param and of the first moment after ``init``."""
    jcfg, _, jmod, _, jloss, _ = models(name)
    axes = dict(axes_items)
    n = int(np.prod(list(axes.values())))
    mesh = jax_build_mesh(axes, devices=jax.devices()[:n])
    tmpl = jax_template_for(strategy, axes, json.loads(options_json))
    jts = jtrain.build_train_step(
        loss_fn=lambda p, b: jloss(p, b, tmpl, mesh), init_fn=lambda k: jmod.init_params(k, jcfg),
        axes_tree=jmod.param_axes(jcfg), optimizer=optax.adamw(LR), mesh=mesh, template=tmpl)
    key = jax.random.PRNGKey(2)
    params, opt_state = jts.init(key)
    init_np = jax.tree.map(np.asarray, params)
    devices = list(mesh.devices.reshape(-1))
    index, placed = {}, {}
    for (path, leaf), (_, sharding) in zip(_paths(params), _paths(jts.param_shardings)):
        by_device = sharding.devices_indices_map(leaf.shape)
        index[path] = [by_device[d] for d in devices]
        shards = {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
        mu = dict(_paths(opt_state[0].mu))[path]
        mu_shards = {s.device: np.asarray(s.data) for s in mu.addressable_shards}
        placed[path] = [(shards[d], mu_shards[d]) for d in devices]
    batch = {k: jnp.asarray(v) for k, v in batch_np().items()}
    grad1 = jax.tree.map(np.asarray, one_device_grad(name)(init_np, batch))
    batch = jts.place_batch(batch)
    history = []
    for _ in range(STEPS):
        params, opt_state, m = jts.step(params, opt_state, batch, key)
        history.append((float(m["loss"]), float(m["grad_norm"])))
    return {"init": init_np, "history": history, "params": jax.tree.map(np.asarray, params),
            "grad1": grad1, "index": index, "placed": placed}


def port_rank(mesh, rank, name, strategy, options, init_np):
    _, tcfg, _, tmod, _, tloss = models(name)
    template = template_for(strategy, dict(mesh.shape), options)
    ts = build_train_step(loss_fn=lambda p, b: tloss(p, b, template, mesh),
                          init_fn=lambda g: params_from_jax(init_np, "cpu"),
                          optimizer=optim.AdamW(LR), mesh=mesh, template=template,
                          axes_tree=tmod.param_axes(tcfg))
    params, opt_state = ts.init(torch.Generator())
    placed = {path: (p.detach().clone(), mu.clone()) for (path, p), mu in
              zip(_paths(params), optim_moments(params, opt_state.mu))}
    batch = ts.place_batch({k: torch.from_numpy(v) for k, v in batch_np().items()})
    history = []
    for _ in range(STEPS):
        params, opt_state, m = ts.step(params, opt_state, batch)
        history.append((float(m["loss"]), float(m["grad_norm"])))
    return history, params, placed


@pytest.mark.parametrize("case", list(CASES))
def test_steps_across_ranks_match_the_jax_step(case):
    name, strategy, axes, options = CASES[case]
    want = jax_run(name, strategy, tuple(axes.items()), json.dumps(options, sort_keys=True))
    results = run_mesh_ranks(axes, lambda mesh, rank: port_rank(
        mesh, rank, name, strategy, options, want["init"]))
    index, whole = want["index"], dict(_paths(want["init"]))
    split = set()
    for rank, (hist, params, placed) in enumerate(results):
        np.testing.assert_allclose(np.array(hist), np.array(want["history"]), atol=1e-5, rtol=0)
        assert placed.keys() == want["placed"].keys()
        for path, (param, mu) in placed.items():
            jparam, jmu = want["placed"][path][rank]
            np.testing.assert_array_equal(param.numpy(), jparam)
            np.testing.assert_array_equal(mu.numpy(), jmu)
            if jparam.size < whole[path].size:
                split.add(path)
        assert_params_close(params, _shard(want["params"], index, rank),
                            _shard(want["grad1"], index, rank))
    for path in index:  # ranks that hold the same shard hold it bit for bit
        mine = dict(_paths(results[0][1]))
        for rank, (_, params, _) in enumerate(results[1:], start=1):
            if index[path][rank] == index[path][0]:
                assert torch.equal(dict(_paths(params))[path], mine[path]), (path, rank)
    if strategy in ("tp", "tp_dp", "pp", "pp_tp", "ep", "custom"):
        assert split  # the template shards some weight of the model
    if strategy in ("pp", "pp_tp") and name == "vit":
        assert {p for p in whole if p.startswith("block/")} <= split


def test_the_vit_under_tp_splits_wq_over_tensor():
    """The reference's check (``test_strategies.py:364-377``): under ``tp``
    ``block.wq`` is split over ``tensor`` on its heads dimension; each
    rank holds its block of the heads."""
    axes = {"data": 2, "tensor": 2}
    jcfg = jvit.ViTConfig(dtype=jnp.float32, **VIT)
    jspec = jax_tree_specs(jvit.param_axes(jcfg), jax_template_for("tp", axes).rules,
                           axes)["block"]["wq"]
    assert "tensor" in tuple(jspec)
    tcfg = tvit.ViTConfig(dtype=torch.float32, **VIT)
    spec = taxes.tree_specs(tvit.param_axes(tcfg), template_for("tp", axes).rules,
                            axes)["block"]["wq"]
    assert spec == tuple(jspec) == (None, None, "tensor")
    want = jax_run("vit", "tp", tuple(axes.items()), "{}")
    for rank in range(4):
        wq = want["placed"]["block/wq"][rank][0]
        assert wq.shape == (VIT["n_layers"], VIT["d_model"], VIT["n_heads"] // 2,
                            VIT["head_dim"])


@pytest.mark.parametrize("name", ["vit", "cnn"])
def test_ten_classes_over_four_tensor_ranks_raise_the_reference_error(name):
    """10 classes do not split over ``tensor: 4``: both packages' shape
    checks refuse with the same words, naming the head."""
    jcfg, tcfg, jmod, tmod, _, _ = models(name)
    if name == "vit":  # heads that split over 4 ranks: the classes are what does not
        jcfg, tcfg = jcfg.scaled(n_heads=4, head_dim=8), tcfg.scaled(n_heads=4, head_dim=8)
    axes = {"tensor": 4}
    jspecs = jax_tree_specs(jmod.param_axes(jcfg), jax_template_for("tp", axes).rules, axes)
    with pytest.raises(JaxRuntimeLayerError) as jerr:
        jtrain._validate_param_shapes(lambda k: jmod.init_params(k, jcfg), jspecs, axes)
    tspecs = taxes.tree_specs(tmod.param_axes(tcfg), template_for("tp", axes).rules, axes)
    with pytest.raises(RuntimeLayerError) as terr:
        _validate_param_shapes(tmod.init_params(tcfg, torch.Generator().manual_seed(0)),
                               tspecs, axes)
    assert str(terr.value) == str(jerr.value)
    assert "'head" in str(terr.value) and "size 10" in str(terr.value)
