"""The sharded strategies' modules alone, the image models under ``fsdp``,
and checkpoints across layouts, on the CPU against the JAX package.

The port's ranks are threads over gloo (``tests/torch_gang_ranks.py``); the
JAX side runs on the conftest's virtual CPU devices.  Inputs and weights
come from numpy (JAX weights cross through ``params_from_jax``).  Float32
throughout; tolerances:

- the collectives against the plain tensor arithmetic they stand for:
  bit for bit (they only move and sum two or four numbers a place);
- ``ulysses_attention_sharded`` against the JAX one (its flash body in
  Pallas interpret mode; the port's plain flash version, or dense
  attention): output atol 2e-5, q/k/v grads atol 5e-4, the ring tests'
  (``tests/test_torch_ring.py``);
- the ``tp`` forward's logits and the vocabulary-parallel cross-entropy
  (whole and chunked, masked) against the JAX single-device ``forward`` and
  ``loss_fn``: atol 1e-5;
- the ViT and the CNN under ``fsdp`` on 2 and 4 ranks, three steps against the
  JAX step on the same mesh: loss atol 1e-5, grad norm rtol 1e-5 (the model
  parity tests' ``STEP_ATOL`` and ``GNORM_RTOL``), each rank's shards
  within Adam's bound of the JAX shards (2·steps·lr); under the templates
  the image models once refused (``tp {tensor: 2}`` and the others on axes
  of size 1) every rank's logits against the JAX one-device forward, atol
  1e-5 (across ranks: ``tests/test_torch_image_strategies.py``);
- checkpoints: bit for bit, an ``fsdp`` run's state restored into one rank
  and a one-rank state into ``fsdp`` ranks.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyaxon_tpu.exceptions import RuntimeLayerError as JaxRuntimeLayerError
from polyaxon_tpu.models import cnn as jcnn
from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.models import vit as jvit
from polyaxon_tpu.parallel import template_for as jax_template_for
from polyaxon_tpu.parallel.axes import logical_to_spec as jax_logical_to_spec
from polyaxon_tpu.parallel.axes import tree_specs as jax_tree_specs
from polyaxon_tpu.parallel.ulysses import ulysses_attention_sharded as jax_ulysses
from polyaxon_tpu.runtime import train as jtrain
from polyaxon_tpu.runtime.mesh import build_mesh as jax_build_mesh
from polyaxon_tpu_torch.builtins.trainers import _open_checkpoints
from polyaxon_tpu_torch.models import cnn as tcnn
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models import vit as tvit
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.parallel import axes as taxes
from polyaxon_tpu_torch.parallel import collectives
from polyaxon_tpu_torch.parallel.templates import RuntimeLayerError, template_for
from polyaxon_tpu_torch.parallel.ulysses import ulysses_attention_sharded
from polyaxon_tpu_torch.runtime import optim
from polyaxon_tpu_torch.runtime.checkpoint import CheckpointManager
from polyaxon_tpu_torch.runtime.mesh import build_mesh
from polyaxon_tpu_torch.runtime.train import _validate_param_shapes, build_train_step
from polyaxon_tpu_torch.tracking.context import Context
from tests.torch_gang_ranks import run_mesh_ranks
from tests.torch_parity import GNORM_RTOL, STEP_ATOL, images_np

LM = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128,
          max_seq=64, attention_impl="dense")
VIT = dict(image_size=16, patch_size=4, d_model=32, n_layers=2, n_heads=2, head_dim=16,
           d_ff=64, n_classes=10)
CNN = dict(image_size=16, channels=(8, 16), dense_dim=32, n_classes=10)
STEPS, LR = 3, 1e-3


def _np(x):
    return x.detach().numpy()


# -- parallel/axes.py --------------------------------------------------------

@pytest.mark.parametrize("strategy, axes", [
    ("fsdp", {"data": 2}), ("fsdp", {"replica": 2, "data": 2}), ("tp", {"tensor": 4}),
    ("tp_dp", {"data": 2, "tensor": 2}), ("ulysses", {"sequence": 2}),
    ("tp_dp", {"tensor": 2}),  # no data axis: the embed rule maps to nothing
])
def test_the_spec_tree_is_the_jax_one(strategy, axes):
    """``tree_specs`` of the LM's and the image models' ``param_axes`` under
    each template: the JAX ``PartitionSpec``'s entries, leaf for leaf."""
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **LM)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **LM)
    pairs = [(jtr.param_axes(jcfg), ttr.param_axes(tcfg)),
             (jvit.param_axes(jvit.ViTConfig(**VIT)), tvit.param_axes(tvit.ViTConfig(**VIT))),
             (jcnn.param_axes(jcnn.CNNConfig(**CNN)), tcnn.param_axes(tcnn.CNNConfig(**CNN)))]
    jrules = jax_template_for(strategy, axes).rules
    trules = template_for(strategy, axes).rules
    for jtree, ttree in pairs:
        assert jtree == ttree
        want = jax.tree.map(tuple, jax_tree_specs(jtree, jrules, axes),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert taxes.tree_specs(ttree, trules, axes) == want
    # An axis names one dimension of a tensor at most; absent axes replicate.
    rules = {"a": ("data", "tensor"), "b": "tensor", "c": "pipeline"}
    for names in (("a", "b"), ("b", "a"), ("c", "b", None), ("c",)):
        assert taxes.logical_to_spec(names, rules, axes) == tuple(
            jax_logical_to_spec(names, rules, axes))


def test_validate_rules_raises_as_the_reference():
    taxes.validate_rules({"embed": "data", "batch": None}, {"data": 2})
    with pytest.raises(RuntimeLayerError, match=r"references mesh axes \['tensor'\]"):
        taxes.validate_rules({"mlp": ("data", "tensor")}, {"data": 2})


def test_two_kv_heads_do_not_shard_over_four_tensor_ranks():
    """``_validate_param_shapes`` names the parameter, in the reference's words."""
    axes = {"tensor": 4}
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, n_kv_heads=2, **LM)
    jspecs = jax_tree_specs(jtr.param_axes(jcfg), jax_template_for("tp", axes).rules, axes)
    with pytest.raises(JaxRuntimeLayerError) as jerr:
        jtrain._validate_param_shapes(lambda k: jtr.init_params(k, jcfg), jspecs, axes)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, n_kv_heads=2, **LM)
    tmpl = template_for("tp", axes)
    tspecs = taxes.tree_specs(ttr.param_axes(tcfg), tmpl.rules, axes)
    params = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeLayerError) as terr:
        _validate_param_shapes(params, tspecs, axes)
    assert str(terr.value) == str(jerr.value)
    assert "'block/wk' dim of size 2" in str(terr.value)

    def init_on_four_ranks(mesh, rank):  # the train step's init checks first
        ts = build_train_step(loss_fn=None, init_fn=lambda g: ttr.init_params(tcfg, g),
                              optimizer=optim.AdamW(LR), mesh=mesh, template=tmpl,
                              axes_tree=ttr.param_axes(tcfg))
        with pytest.raises(RuntimeLayerError, match="block/wk"):
            ts.init(torch.Generator().manual_seed(0))
        return True

    assert run_mesh_ranks(axes, init_on_four_ranks) == [True] * 4


# -- parallel/collectives.py -------------------------------------------------

def _rank_values(rank, shape=(4, 6)):
    return torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape) + 100 * rank


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("fn", ["gather_along", "copy_to_group", "reduce_from_group",
                                "gather_from_group", "all_to_all_swap"])
def test_each_collective_and_its_backward_are_their_plain_arithmetic(fn, n):
    """On n ranks, rank r holding ``x_r`` and back-propagating ``g_r``:
    forward and backward equal the sums and blocks they stand for."""
    xs = [_rank_values(r) for r in range(n)]
    gs_of = {"gather_along": (4 * n, 6), "gather_from_group": (4, 6 * n),
             "all_to_all_swap": (4 * n, 6 // n)}

    def rank_main(mesh, rank):
        group = mesh.group("data")
        x = xs[rank].clone().requires_grad_(True)
        if fn == "gather_along":
            y = collectives.gather_along(x, 0, group)
        elif fn == "gather_from_group":
            y = collectives.gather_from_group(x, 1, group)
        elif fn == "all_to_all_swap":
            y = collectives.all_to_all_swap(x[:, : 6 // n * n], 1, 0, group)
        else:
            y = getattr(collectives, fn)(x, group)
        g = _rank_values(rank, tuple(y.shape)) * 0.5
        (dx,) = torch.autograd.grad(y, x, g)
        return _np(y), _np(dx)

    out = run_mesh_ranks({"data": n}, rank_main)
    total = sum(xs)
    grads = [_rank_values(r, gs_of.get(fn, (4, 6))) * 0.5 for r in range(n)]
    for r, (y, dx) in enumerate(out):
        if fn == "gather_along":  # all-gather; backward: reduce-scatter
            want_y, want_dx = torch.cat(xs, 0), sum(grads).chunk(n, 0)[r]
        elif fn == "gather_from_group":  # all-gather; backward: this rank's block
            want_y, want_dx = torch.cat(xs, 1), grads[r].chunk(n, 1)[r]
        elif fn == "copy_to_group":  # identity; backward: all-reduce
            want_y, want_dx = xs[r], sum(grads)
        elif fn == "reduce_from_group":  # all-reduce; backward: identity
            want_y, want_dx = total, grads[r]
        else:  # block j of dim 1 to rank j, concatenated along dim 0; backward reversed
            w = 6 // n * n
            want_y = torch.cat([x[:, :w].chunk(n, 1)[r] for x in xs], 0)
            back = torch.cat([g.chunk(n, 0)[r] for g in grads], 1)
            want_dx = torch.cat([back, torch.zeros(4, 6 - w)], 1)
        np.testing.assert_array_equal(y, _np(want_y))
        np.testing.assert_array_equal(dx, _np(want_dx))


# -- parallel/ulysses.py -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_ulysses_case(n, B=2, T=32, H=4, d=16):
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal((B, T, H, d)).astype(np.float32) for _ in range(4))
    mesh = jax_build_mesh({"sequence": n}, devices=jax.devices()[:n])
    out, vjp = jax.vjp(lambda q, k, v: jax_ulysses(q, k, v, mesh, "sequence"),
                       *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do))
    return (q, k, v, do), [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("impl", ["flash", "dense", "auto"])
@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_matches_the_jax_ulysses(n, impl):
    (q, k, v, do), want = jax_ulysses_case(n)
    T = q.shape[1]
    Tl = T // n

    def rank_main(mesh, rank):
        sl = slice(rank * Tl, (rank + 1) * Tl)
        qkv = [torch.from_numpy(x[:, sl].copy()).requires_grad_(True) for x in (q, k, v)]
        out = ulysses_attention_sharded(*qkv, mesh, "sequence", impl=impl)
        grads = torch.autograd.grad(out, qkv, torch.from_numpy(do[:, sl].copy()))
        return [_np(out)] + [_np(g) for g in grads]

    ranks = run_mesh_ranks({"sequence": n}, rank_main)
    got = [np.concatenate([r[i] for r in ranks], axis=1) for i in range(4)]
    np.testing.assert_allclose(got[0], want[0], atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=5e-4)


def test_ulysses_refuses_heads_that_do_not_divide():
    def rank_main(mesh, rank):
        x = torch.zeros(1, 4, 3, 8)
        with pytest.raises(ValueError, match=r"heads \(3\) divisible by the 'sequence' axis"):
            ulysses_attention_sharded(x, x, x, mesh, "sequence")
        return True

    assert run_mesh_ranks({"sequence": 2}, rank_main) == [True, True]


# -- the tp forward and the vocabulary-parallel loss ----------------------------

@functools.lru_cache(maxsize=None)
def jax_lm_case(ce_chunk, masked):
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, ce_chunk=ce_chunk, **LM)
    params = jtr.init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, LM["vocab_size"], (2, 33))
    batch = {"tokens": tok[:, :-1].astype(np.int32), "targets": tok[:, 1:].astype(np.int32)}
    if masked:
        batch["mask"] = (rng.random((2, 32)) < 0.6).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits = np.asarray(jtr.forward(params, jb["tokens"], jcfg))
    loss = float(jtr.loss_fn(params, jb, jcfg))
    return jax.tree.map(np.asarray, params), batch, logits, loss


@pytest.mark.parametrize("ce_chunk, masked", [(0, False), (0, True), (8, True)],
                         ids=["whole", "whole-masked", "chunked-masked"])
@pytest.mark.parametrize("axes", [{"tensor": 2}, {"tensor": 4}, {"data": 2, "tensor": 2}],
                         ids=["tp2", "tp4", "tp_dp"])
def test_the_tp_logits_and_loss_match_the_jax_ones(axes, ce_chunk, masked):
    """Every rank of a tensor group returns the whole ``[B, T, vocab]``
    logits and the loss of the vocabulary-parallel cross-entropy."""
    params_np, batch, want_logits, want_loss = jax_lm_case(ce_chunk, masked)
    strategy = "tp_dp" if "data" in axes else "tp"
    tcfg = ttr.TransformerConfig(dtype=torch.float32, ce_chunk=ce_chunk, **LM)

    def rank_main(mesh, rank):
        tmpl = template_for(strategy, axes)
        specs = taxes.tree_specs(ttr.param_axes(tcfg), tmpl.rules, axes)
        params = taxes.tree_shard(params_from_jax(params_np, "cpu"), specs, mesh)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.no_grad():
            logits = ttr.forward(params, tb["tokens"], tcfg, tmpl, mesh, device="cpu")
            loss = ttr.loss_fn(params, tb, tcfg, tmpl, mesh, device="cpu")
        return _np(logits), float(loss)

    for logits, loss in run_mesh_ranks(axes, rank_main):
        np.testing.assert_allclose(logits, want_logits, atol=1e-5)
        np.testing.assert_allclose(loss, want_loss, atol=1e-5)


# -- the image models under fsdp ---------------------------------------------

def _image_models(name):
    if name == "vit":
        jcfg, tcfg = jvit.ViTConfig(dtype=jnp.float32, **VIT), tvit.ViTConfig(dtype=torch.float32,
                                                                              **VIT)
        return (jcfg, tcfg, jvit, tvit,
                lambda p, b, t, m: jvit.loss_fn(p, b, jcfg, template=t, mesh=m),
                lambda p, b, t, m: tvit.loss_fn(p, b, tcfg, t, m, device="cpu"))
    jcfg, tcfg = jcnn.CNNConfig(dtype=jnp.float32, **CNN), tcnn.CNNConfig(dtype=torch.float32,
                                                                         **CNN)

    def jloss(p, b, t, m):
        return jcnn.loss_fn(p, dict(b, images=b["images"].astype(jnp.float32) / 255.0 - 0.5), jcfg)

    def tloss(p, b, t, m):
        return tcnn.loss_fn(p, dict(b, images=b["images"].float() / 255.0 - 0.5), tcfg, t, m,
                            device="cpu")

    return jcfg, tcfg, jcnn, tcnn, jloss, tloss


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["vit", "cnn"])
def test_an_image_model_under_fsdp_matches_the_jax_step(name, n):
    jcfg, tcfg, jmod, tmod, jloss, tloss = _image_models(name)
    axes = {"data": n}
    mesh = jax_build_mesh(axes, devices=jax.devices()[:n])
    jtmpl = jax_template_for("fsdp", axes)
    jts = jtrain.build_train_step(
        loss_fn=lambda p, b: jloss(p, b, jtmpl, mesh), init_fn=lambda k: jmod.init_params(k, jcfg),
        axes_tree=jmod.param_axes(jcfg), optimizer=optax.adamw(LR), mesh=mesh, template=jtmpl)
    key = jax.random.PRNGKey(4)
    jparams, jopt = jts.init(key)
    init_np = jax.tree.map(np.asarray, jparams)
    batch = images_np(9, 8, jcfg.image_size)
    jbatch = jts.place_batch({k: jnp.asarray(v) for k, v in batch.items()})
    jhist = []
    for _ in range(STEPS):
        jparams, jopt, m = jts.step(jparams, jopt, jbatch, key)
        jhist.append((float(m["loss"]), float(m["grad_norm"])))
    jfinal = jax.tree.map(np.asarray, jparams)

    def rank_main(tmesh, rank):
        tmpl = template_for("fsdp", axes)
        ts = build_train_step(loss_fn=lambda p, b: tloss(p, b, tmpl, tmesh),
                              init_fn=lambda g: params_from_jax(init_np, "cpu"),
                              optimizer=optim.AdamW(LR), mesh=tmesh, template=tmpl,
                              axes_tree=tmod.param_axes(tcfg))
        params, opt_state = ts.init(torch.Generator())
        tb = ts.place_batch({k: torch.from_numpy(v) for k, v in batch.items()})
        hist = []
        for _ in range(STEPS):
            params, opt_state, m = ts.step(params, opt_state, tb)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        whole = taxes.tree_map(lambda t: _np(t), ts.full_state(params, opt_state)[0])
        shards = sum(p.numel() for p in optim.tree_leaves(params))
        return hist, whole, shards

    results = run_mesh_ranks(axes, rank_main)
    for hist, whole, shards in results:
        for (tl, tg), (jl, jg) in zip(hist, jhist):
            np.testing.assert_allclose(tl, jl, atol=STEP_ATOL)
            np.testing.assert_allclose(tg, jg, rtol=GNORM_RTOL)
        jflat = dict(_paths(jfinal))
        for path, got in _paths(whole):
            np.testing.assert_allclose(got, jflat[path], atol=2 * STEPS * LR, err_msg=path)
        assert shards < sum(a.size for a in jax.tree.leaves(init_np))  # each holds a part
    assert hist[-1][0] < hist[0][0]


@functools.lru_cache(maxsize=None)
def jax_image_logits(name):
    """The JAX one-device logits of a small image model: ``(params as numpy,
    normalized float images, logits)``."""
    jcfg, _, jmod, _, _, _ = _image_models(name)
    params = jax.jit(jmod.init_params, static_argnums=1)(jax.random.PRNGKey(6), jcfg)
    images = images_np(3, 4, jcfg.image_size)["images"]
    if name == "cnn":
        images = images.astype(np.float32) / 255.0 - 0.5
    logits = jax.jit(jmod.forward, static_argnums=2)(params, jnp.asarray(images), jcfg)
    return jax.tree.map(np.asarray, params), images, np.asarray(logits)


@pytest.mark.parametrize("strategy, axes", [("tp", {"tensor": 2}), ("tp_dp", {"data": 1,
                                                                              "tensor": 1}),
                                            ("ulysses", {"sequence": 1}),
                                            ("pp", {"pipeline": 1}),
                                            ("pp_tp", {"pipeline": 1, "tensor": 1}),
                                            ("ep", {"expert": 1}),
                                            ("custom", {"data": 1})])
def test_the_image_models_refuse_what_they_do_not_split(strategy, axes):
    """Under each template the image models once refused, every rank of
    ``axes`` returns the JAX one-device logits of the ViT and the CNN from
    its shards (atol 1e-5); what they still refuse is a ``custom`` rule the
    port does not split, with ``check_rules``' error."""
    for name in ("vit", "cnn"):
        params_np, images, want = jax_image_logits(name)
        _, tcfg, _, tmod, _, _ = _image_models(name)

        def rank_main(mesh, rank):
            tmpl = template_for(strategy, axes)
            specs = taxes.tree_specs(tmod.param_axes(tcfg), tmpl.rules, axes)
            params = taxes.tree_shard(params_from_jax(params_np, "cpu"), specs, mesh)
            with torch.no_grad():
                logits = tmod.forward(params, torch.from_numpy(images), tcfg, tmpl, mesh,
                                      device="cpu")
            refused = template_for("custom", axes, {"rules": {"head_dim": next(iter(axes))}})
            with pytest.raises(NotImplementedError, match="'head_dim'.*is not ported.*item 7"):
                tmod.forward(params, torch.from_numpy(images), tcfg, refused, mesh,
                             device="cpu")
            return _np(logits)

        for logits in run_mesh_ranks(axes, rank_main):
            np.testing.assert_allclose(logits, want, atol=1e-5, err_msg=name)


def _paths(tree, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _paths(tree[key], f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", tree[key]


# -- checkpoints across layouts -----------------------------------------------

def _lm_step(mesh, strategy, init):
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **LM)
    tmpl = template_for(strategy, dict(mesh.shape))
    return build_train_step(
        loss_fn=lambda p, b: ttr.loss_fn(p, b, tcfg, tmpl, mesh, device="cpu"),
        init_fn=lambda g: ttr.init_params(tcfg, torch.Generator().manual_seed(init)),
        optimizer=optim.AdamW(LR), mesh=mesh, template=tmpl, axes_tree=ttr.param_axes(tcfg))


def _lm_batch():
    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.integers(0, LM["vocab_size"], (4, 17)))
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


def _whole(params, opt_state):
    return ([_np(p).copy() for p in optim.tree_leaves(params)],
            [_np(m).copy() for m in opt_state.mu + opt_state.nu], opt_state.count)


def _assert_same_state(a, b):
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        np.testing.assert_array_equal(x, y)
    assert a[2] == b[2]


def test_an_fsdp_checkpoint_restores_into_one_rank_and_back(tmp_path):
    """Two ``fsdp`` ranks take a step and save through the trainers' hook
    (every rank gathers, the leader writes the one-rank layout); one rank
    restores it bit for bit; then one rank's step is saved and two ``fsdp``
    ranks restore it, each keeping its shard bit for bit."""
    axes = {"data": 2}
    batch = _lm_batch()

    def fsdp_save(mesh, rank):
        ts = _lm_step(mesh, "fsdp", init=1)
        params, opt_state = ts.init(torch.Generator())
        params, opt_state, _ = ts.step(params, opt_state, ts.place_batch(batch))
        ctx = Context(params={}, process_id=rank, num_processes=2, checkpoints_path=tmp_path / "a")
        ckpt, save, params, opt_state, start = _open_checkpoints(ctx, 1, ts, params, opt_state)
        assert start == 0 and save is not None and (ckpt is None) == (rank != 0)
        save(0, params, opt_state)
        if ckpt is not None:
            ckpt.wait_until_finished()
            ckpt.close()
        return _whole(*ts.full_state(params, opt_state)), sum(p.numel() for p in
                                                              optim.tree_leaves(params))

    saved = run_mesh_ranks(axes, fsdp_save)
    whole, half = saved[0][0], saved[0][1]
    assert 2 * half == sum(p.size for p in whole[0])  # each rank held half of the params
    one = _lm_step(build_mesh({"data": 1}), "ddp", init=9)
    params, opt_state = one.init(torch.Generator())
    ctx = Context(params={}, checkpoints_path=tmp_path / "a")
    ckpt, _, params, opt_state, start = _open_checkpoints(ctx, 1, one, params, opt_state)
    ckpt.close()
    assert start == 1
    _assert_same_state(_whole(params, opt_state), whole)

    params, opt_state, _ = one.step(params, opt_state, batch)
    ckpt = CheckpointManager(tmp_path / "b", enable_async=False)
    ckpt.save(1, params, opt_state)
    ckpt.close()
    want = _whole(params, opt_state)

    def fsdp_restore(mesh, rank):
        ts = _lm_step(mesh, "fsdp", init=7)
        params, opt_state = ts.init(torch.Generator())
        ctx = Context(params={}, process_id=rank, num_processes=2, checkpoints_path=tmp_path / "b")
        ckpt, _, params, opt_state, start = _open_checkpoints(ctx, 1, ts, params, opt_state)
        if ckpt is not None:
            ckpt.close()
        mine = [_np(p).copy() for p in optim.tree_leaves(params)]
        return start, mine, _whole(*ts.full_state(params, opt_state))

    for rank, (start, mine, whole) in enumerate(run_mesh_ranks(axes, fsdp_restore)):
        assert start == 2
        _assert_same_state(whole, want)
        for got, full in zip(mine, want[0]):  # this rank's block of the whole
            assert got.size * 2 == full.size or got.shape == full.shape
            assert any(np.array_equal(got, block) for block in
                       (full, *np.split(full, 2, axis=next(
                           (d for d in range(full.ndim) if got.shape[d] != full.shape[d]), 0))))
