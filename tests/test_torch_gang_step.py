"""Parity of the port's train step across ranks with the JAX package's, on the CPU.

The port's ranks are threads over gloo (``tests/torch_gang_ranks.py``), each
holding its shard of the params (the template's rules over ``param_axes``:
whole under ``ddp``, ``sp_ring`` and ``ulysses``) and of the global batch
(``TrainStep.place_batch``); the JAX side runs ``build_train_step`` on the
same mesh over the conftest's virtual CPU devices, with the same template.
Weights come from the JAX ``init_params`` and cross through numpy
(``params_from_jax``); tokens and masks come from numpy (the JAX side takes
a mask of ones where the port takes none: the same loss, and one compiled
step for both).  The config is the
small float32 one of ``tests/test_torch_train.py`` (vocab 256, d 64, 2
layers, 4 heads × 16, ff 128) at batch 4 × 64 with dense attention (some
cases with 2 kv heads, or Ulysses over the flash wrapper: the JAX kernel in
Pallas interpret mode, the port's plain version), and the optimizer
``adamw(3e-4)`` with a float32 first moment.

Placement, bit for bit: after ``init``, each rank's shard of every param and
of both AdamW moments is the JAX array's shard on device r of the mesh
(``devices_indices_map``, the devices in row-major order).

Tolerance, float32, where the frameworks differ only in summation order:
per-step loss and grad norm atol 1e-5; ranks that hold the same shard of a
parameter end with it bit for bit (they apply the same summed grads); each
rank's shards after 3 steps atol 1e-5 (as ``test_three_train_steps_match_jax``) for every
element whose first-step gradient (the JAX gradient of the loss at the
initial weights; under a pipeline with experts, whose stages route each
microbatch on its own, of that template's loss) is at least
``GRAD_FLOOR`` = 1e-5 in magnitude, about a 150th of the median; the
elements below it are held to the bound of Adam's
update instead, |Δ| ≤ 2·steps·lr.  Adam divides each update by √v̂ + 1e-8:
where an element's grads stay near 0 (one ``wi`` element here has 2.9e-10 at
the first step), a float32 summation error in them (an error relative to the
summands, not to the grad) moves its update by a few percent of lr or more.
Measured on this config: the elements at or above the floor end within
3.1e-7 of JAX, those below it within 2.7e-5, once 4.8e-4 (first-step
gradients up to 4.7e-6).  A wrong all-reduce (a rank missing, a wrong scale,
wrong rows) moves the loss and grad norm by far more than 1e-5 and every
parameter by up to lr a step.
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

from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.parallel import template_for as jax_template_for
from polyaxon_tpu.runtime import train as jtrain
from polyaxon_tpu.runtime.mesh import build_mesh as jax_build_mesh
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.parallel.templates import PORTED_STRATEGIES, template_for
from polyaxon_tpu_torch.runtime import optim
from polyaxon_tpu_torch.runtime.mesh import build_mesh
from polyaxon_tpu_torch.runtime.train import build_train_step, shard_batch
from polyaxon_tpu_torch.schemas.environments import STRATEGIES
from tests.torch_gang_ranks import run_mesh_ranks

SMALL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128,
             max_seq=64, attention_impl="dense")
BATCH, SEQ, STEPS, LR = 4, 64, 3, 3e-4
GRAD_FLOOR = 1e-5
CASES = {
    "ddp-data2": ("ddp", {"data": 2}, {}),
    "ddp-data4": ("ddp", {"data": 4}, {}),
    "sp_ring-data2-sequence2": ("sp_ring", {"data": 2, "sequence": 2}, {}),
    "fsdp-data2": ("fsdp", {"data": 2}, {}),
    "fsdp-replica2-data2": ("fsdp", {"replica": 2, "data": 2}, {}),
    "tp-tensor2": ("tp", {"tensor": 2}, {}),
    "tp_dp-data2-tensor2": ("tp_dp", {"data": 2, "tensor": 2}, {}),
    "tp-tensor4": ("tp", {"tensor": 4}, {}),
    "tp-tensor2-kv2": ("tp", {"tensor": 2}, {"n_kv_heads": 2}),
    "ulysses-data2-sequence2-dense": ("ulysses", {"data": 2, "sequence": 2}, {}),
    "ulysses-data2-sequence2-flash": ("ulysses", {"data": 2, "sequence": 2},
                                      {"attention_impl": "flash"}),
    "ulysses-data2-sequence2-flash-kv2": ("ulysses", {"data": 2, "sequence": 2},
                                          {"attention_impl": "flash", "n_kv_heads": 2}),
}
#: The meshes whose placement is held bit for bit after ``init``.
PLACED = ("fsdp-data2", "fsdp-replica2-data2", "tp-tensor2", "tp_dp-data2-tensor2")


def batch_np(masked: bool):
    rng = np.random.default_rng(21)
    tok = rng.integers(0, SMALL["vocab_size"], (BATCH, SEQ + 1))
    batch = {"tokens": tok[:, :-1].astype(np.int32), "targets": tok[:, 1:].astype(np.int32)}
    if masked:
        # Rows keep 10%, 50%, 70% and 95% of their positions: every rank's
        # count differs, so a mean of the ranks' means is not the loss.
        keep = np.array([0.1, 0.5, 0.7, 0.95])[:, None]
        batch["mask"] = (rng.random((BATCH, SEQ)) < keep).astype(np.float32)
    return batch


def _paths(tree, prefix=""):
    """``(path, leaf)`` of a nested dict, in key order."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _paths(tree[key], f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", tree[key]


def jax_batch(masked: bool):
    """The JAX side's batch: ``batch_np``'s, with a mask of ones where the
    port's has none (the same loss, and one compiled program for both)."""
    batch = batch_np(masked)
    batch.setdefault("mask", np.ones((BATCH, SEQ), np.float32))
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_grad_fn(extra_items):
    """The jitted JAX gradient of the loss over the whole batch."""
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **{**SMALL, **dict(extra_items)})
    return jax.jit(jax.grad(lambda p, b: jtr.loss_fn(p, b, jcfg)))


@functools.lru_cache(maxsize=None)
def jax_step(strategy, axes_items, extra_items, options_json):
    """The JAX train step on the virtual mesh, built (and compiled) once for
    the masked and the unmasked batch: ``(config, mesh, template, step,
    the template's jitted loss gradient)``."""
    axes = dict(axes_items)
    n = int(np.prod(list(axes.values())))
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **{**SMALL, **dict(extra_items)})
    mesh = jax_build_mesh(axes, devices=jax.devices()[:n])
    tmpl = jax_template_for(strategy, axes, json.loads(options_json))
    loss = lambda p, b: jtr.loss_fn(p, b, jcfg, template=tmpl, mesh=mesh)  # noqa: E731
    jts = jtrain.build_train_step(
        loss_fn=loss,
        init_fn=lambda k: jtr.init_params(k, jcfg),
        axes_tree=jtr.param_axes(jcfg),
        optimizer=optax.adamw(LR),
        mesh=mesh,
        template=tmpl,
    )
    return jcfg, mesh, tmpl, jts, jax.jit(jax.grad(loss))


@functools.lru_cache(maxsize=None)
def jax_run(strategy, axes_items, masked, extra_items=(), options_json="{}"):
    """The JAX step on the virtual mesh: the initial params, each step's
    loss and grad norm, the final params, the gradient of the loss over the
    whole batch at the initial params, and per param path each device's
    index into it and the shards ``init`` placed on each device (devices in
    the mesh's row-major order, the port's ranks).  ``options_json``: the
    template's options, as JSON (a cache key)."""
    jcfg, mesh, tmpl, jts, template_grad = jax_step(strategy, axes_items, extra_items,
                                                    options_json)
    key = jax.random.PRNGKey(0)
    params, opt_state = jts.init(key)
    init_np = jax.tree.map(np.asarray, params)  # before donation
    devices = list(mesh.devices.reshape(-1))
    index, placed = {}, {}
    for (path, leaf), (_, sharding) in zip(_paths(params), _paths(jts.param_shardings)):
        by_device = sharding.devices_indices_map(leaf.shape)
        index[path] = [by_device[d] for d in devices]
        shards = {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
        mu = dict(_paths(opt_state[0].mu))[path]
        mu_shards = {s.device: np.asarray(s.data) for s in mu.addressable_shards}
        placed[path] = [(shards[d], mu_shards[d]) for d in devices]
    batch = jts.place_batch(jax_batch(masked))
    if tmpl.pipeline_axis and jcfg.n_experts:
        # The stages route each microbatch on its own: this loss is not the
        # one-device loss, and its first-step gradient is its own.
        grad1 = template_grad(params, batch)
    else:
        grad1 = jax_grad_fn(extra_items)(params, jax_batch(masked))
    grad1 = jax.tree.map(np.asarray, grad1)
    history = []
    for _ in range(STEPS):
        params, opt_state, m = jts.step(params, opt_state, batch, key)
        history.append((float(m["loss"]), float(m["grad_norm"])))
    return {"init": init_np, "history": history, "params": jax.tree.map(np.asarray, params),
            "grad1": grad1, "index": index, "placed": placed}


def port_rank(mesh, rank, strategy, init_np, masked, extra=None, steps=STEPS, options=None):
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **{**SMALL, **(extra or {})})
    template = template_for(strategy, dict(mesh.shape), options)
    ts = build_train_step(
        loss_fn=lambda p, b: ttr.loss_fn(p, b, tcfg, template=template, mesh=mesh, device="cpu"),
        init_fn=lambda g: params_from_jax(init_np, "cpu"),
        optimizer=optim.AdamW(LR),
        mesh=mesh,
        template=template,
        axes_tree=ttr.param_axes(tcfg),
    )
    params, opt_state = ts.init(torch.Generator())
    placed = {path: (p.detach().clone(), mu.clone()) for (path, p), mu in
              zip(_paths(params), optim_moments(params, opt_state.mu))}
    batch = ts.place_batch({k: torch.from_numpy(v) for k, v in batch_np(masked).items()})
    history = []
    for _ in range(steps):
        params, opt_state, m = ts.step(params, opt_state, batch)
        history.append((float(m["loss"]), float(m["grad_norm"])))
    return history, params, placed


def optim_moments(params, moments):
    """The moments in ``_paths`` order (they lie in ``tree_leaves`` order)."""
    by_leaf = {id(p): m for p, m in zip(optim.tree_leaves(params), moments)}
    return [by_leaf[id(p)] for _, p in _paths(params)]


def flat_params(tree):
    """All elements of a param tree (torch or numpy leaves, nested or flat
    by path), in key order."""
    return {path: np.asarray(leaf.detach() if isinstance(leaf, torch.Tensor) else leaf)
            for path, leaf in _paths(tree)}


def assert_params_close(tparams, jparams, grad1, atol=1e-5):
    """Within ``atol`` every element whose first-step gradient is at least
    ``GRAD_FLOOR``; the rest within the bound of Adam's update (see the
    module docstring)."""
    tflat, jflat, gflat = flat_params(tparams), flat_params(jparams), flat_params(grad1)
    assert tflat.keys() == jflat.keys() == gflat.keys()
    t, j, g = (np.concatenate([f[k].ravel() for k in sorted(tflat)])
               for f in (tflat, jflat, gflat))
    diff = np.abs(t - j)
    held = np.abs(g) >= GRAD_FLOOR
    assert diff[held].max() <= atol, np.sort(diff[held])[-10:]
    assert diff[~held].max() <= 2 * STEPS * LR, diff[~held].max()


def _shard(tree, index, rank):
    """Rank ``rank``'s slice of every leaf of a numpy tree (``index``: path →
    per-device slices)."""
    return {path: np.asarray(leaf)[index[path][rank]] for path, leaf in _paths(tree)}


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked-by-rank"])
@pytest.mark.parametrize("case", list(CASES))
def test_steps_across_ranks_match_the_jax_step(case, masked):
    strategy, axes, extra = CASES[case]
    want = jax_run(strategy, tuple(axes.items()), masked, tuple(extra.items()))
    results = run_mesh_ranks(axes, lambda mesh, rank: port_rank(
        mesh, rank, strategy, want["init"], masked, extra))
    index = want["index"]
    for rank, (hist, params, _) in enumerate(results):
        np.testing.assert_allclose(np.array(hist), np.array(want["history"]), atol=1e-5, rtol=0)
        assert_params_close(params, _shard(want["params"], index, rank),
                            _shard(want["grad1"], index, rank))
    for path in index:  # ranks that hold the same shard hold it bit for bit
        mine = dict(_paths(results[0][1]))
        for rank, (_, params, _) in enumerate(results[1:], start=1):
            if index[path][rank] == index[path][0]:
                assert torch.equal(dict(_paths(params))[path], mine[path]), (path, rank)


@pytest.mark.parametrize("case", PLACED)
def test_init_places_each_shard_where_jax_places_it(case):
    """Each rank's shard of every param and of AdamW's first moment, after
    ``init``, is the JAX array's shard on device r, bit for bit."""
    strategy, axes, extra = CASES[case]
    want = jax_run(strategy, tuple(axes.items()), False, tuple(extra.items()))
    results = run_mesh_ranks(axes, lambda mesh, rank: port_rank(
        mesh, rank, strategy, want["init"], False, extra, steps=0))
    whole = dict(_paths(want["init"]))
    split = 0
    for rank, (_, _, placed) in enumerate(results):
        assert placed.keys() == want["placed"].keys()
        for path, (param, mu) in placed.items():
            jparam, jmu = want["placed"][path][rank]
            np.testing.assert_array_equal(param.numpy(), jparam)
            np.testing.assert_array_equal(mu.numpy(), jmu)
            split += jparam.size < whole[path].size
    assert split > 0  # the template shards something


def test_under_a_composed_pipeline_a_rank_takes_its_block_of_each_microbatch():
    """Under ``pp_tp {data: 2, pipeline: 2}`` with 2 microbatches, data rank
    d holds rows [4d, 4d + 4) and [8 + 4d, 12 + 4d) of a batch of 16: its
    block of each of the reference's global microbatches (rows [8m, 8m + 8)),
    in order; the stages hold the same rows.  Rows that do not split over
    the ranks times the microbatches raise."""
    axes = {"data": 2, "pipeline": 2, "tensor": 1}
    tmpl = template_for("pp_tp", axes, {"num_microbatches": 2})
    rows = run_mesh_ranks(axes, lambda mesh, rank: shard_batch(
        {"rows": torch.arange(16)}, mesh, tmpl)["rows"].tolist())
    for d in range(2):
        want = [*range(4 * d, 4 * d + 4), *range(8 + 4 * d, 12 + 4 * d)]
        assert rows[2 * d] == rows[2 * d + 1] == want
    odd = template_for("pp_tp", axes, {"num_microbatches": 3})

    def refuse(mesh, rank):
        with pytest.raises(ValueError, match=r"do not split over 2 ranks .* x 3 microbatches"):
            shard_batch({"rows": torch.arange(16)}, mesh, odd)

    run_mesh_ranks(axes, refuse)


def test_ranks_take_the_reference_rows_and_positions():
    """Rank r of a {data: 2, sequence: 2} mesh holds device r's block of the
    reference's batch sharding: rows by data index, the sequence by
    sequence index, with global positions."""
    tokens = torch.arange(4 * 8).reshape(4, 8)
    batch = {"tokens": tokens, "targets": tokens + 100}
    axes = {"data": 2, "sequence": 2}
    tmpl = template_for("sp_ring", axes)
    shards = run_mesh_ranks(axes, lambda mesh, rank: shard_batch(batch, mesh, tmpl))
    jmesh = jax_build_mesh(axes, devices=jax.devices()[:4])
    sharding = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec("data", "sequence"))
    placed = jax.device_put(jnp.asarray(tokens.numpy()), sharding)
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for rank, shard in enumerate(shards):
        device = jmesh.devices.reshape(-1)[rank]
        np.testing.assert_array_equal(shard["tokens"].numpy(), by_device[device])
        np.testing.assert_array_equal(shard["targets"].numpy(), by_device[device] + 100)
        d, s = divmod(rank, 2)
        assert shard["positions"].tolist() == [list(range(s * 4, s * 4 + 4))] * 2
        assert shard["tokens"][:, 0].tolist() == [(d * 2 + i) * 8 + s * 4 for i in range(2)]


#: The strategies this test once held to a refusal: the image models under
#: ``pp`` and ``ep`` and MoE under ``pp_tp`` run now (one rank here; across
#: ranks in ``tests/test_torch_image_strategies.py`` and
#: ``tests/test_torch_pipeline_step.py``), and a ``custom`` rule the port does
#: not split still raises.
STILL_REFUSED = ("pp", "pp_tp", "ep", "custom")


@pytest.mark.parametrize("strategy", STILL_REFUSED)
def test_every_other_strategy_still_raises(strategy):
    """On a mesh of axes of size 1 the ViT under ``pp`` and ``ep`` and the
    MoE transformer under ``pp_tp`` give the plain path's logits bit for
    bit; ``custom`` with a ``head_dim`` rule raises, naming the item."""
    from polyaxon_tpu_torch.models import vit as tvit

    axes = {"data": 1, "pipeline": 1, "expert": 1, "sequence": 1, "tensor": 1}
    assert set(STRATEGIES) == set(PORTED_STRATEGIES)
    mesh = build_mesh(axes)
    if strategy in ("pp", "ep"):
        vcfg = tvit.ViTConfig(image_size=8, patch_size=4, d_model=8, n_layers=2, n_heads=2,
                              head_dim=4, d_ff=16, n_classes=3, dtype=torch.float32)
        params = tvit.init_params(vcfg, torch.Generator().manual_seed(0))
        images = torch.randint(0, 256, (2, 8, 8, 3), generator=torch.Generator().manual_seed(1))
        got = tvit.forward(params, images, vcfg, template_for(strategy, axes), mesh, device="cpu")
        assert torch.equal(got, tvit.forward(params, images, vcfg, device="cpu"))
    elif strategy == "pp_tp":
        tcfg = ttr.TransformerConfig(dtype=torch.float32, **SMALL, n_experts=4)
        params = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
        tokens = torch.randint(0, SMALL["vocab_size"], (2, 8),
                               generator=torch.Generator().manual_seed(1))
        got = ttr.forward(params, tokens, tcfg, template_for(strategy, axes), mesh, device="cpu")
        want = ttr.forward(params, tokens, tcfg, device="cpu")
        assert torch.equal(got[0], want[0])
    else:
        with pytest.raises(NotImplementedError, match="multi-process and parallelism"):
            build_train_step(loss_fn=None, init_fn=None, optimizer=None, mesh=mesh,
                             template=template_for(strategy, axes,
                                                   {"rules": {"head_dim": "tensor"}}))
