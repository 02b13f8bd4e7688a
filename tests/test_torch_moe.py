"""Parity of the port's switch-MoE MLP (``models/transformer.py:_moe_mlp``,
``moe_aux_loss`` and their wiring through ``forward`` and ``loss_fn``) with
the JAX package's, on the CPU.

Weights come from the JAX ``init_params`` and cross to torch through numpy
(``params_from_jax``); hidden states and tokens come from numpy.  The port
dispatches by index where the reference multiplies by dense one-hots, so
the routing is held token for token.  Tolerances, float32: ``expert_idx``
equal, gates atol 1e-6, the MLP's output atol 1e-5 (each kept token's
output is one expert's SwiGLU times its gate, on both sides), the balance
loss atol 1e-6; through the model, loss atol 1e-5 and grads atol 1e-5.
bf16 on the CPU: a checkpointed layer recomputes the same routing, so the
grads with ``remat`` equal those without, bit for bit.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu_torch.builtins.trainers import lm_train
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.parallel.axes import tree_shard, tree_specs
from polyaxon_tpu_torch.parallel.templates import template_for
from polyaxon_tpu_torch.runtime.mesh import build_mesh
from polyaxon_tpu_torch.runtime.optim import tree_leaves
from polyaxon_tpu_torch.tracking.context import Context
from tests.torch_gang_ranks import run_mesh_ranks
from tests.torch_parity import assert_tree_close, carried, grads_of

SMALL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128, max_seq=64,
             attention_impl="dense")
GATES_ATOL, OUT_ATOL, AUX_ATOL, LOSS_ATOL, GRADS_ATOL = 1e-6, 1e-5, 1e-6, 1e-5, 1e-5


def configs(**kw):
    return (jtr.TransformerConfig(dtype=jnp.float32, **SMALL, **kw),
            ttr.TransformerConfig(dtype=torch.float32, **SMALL, **kw))


def tokens_np(seed, B=2, T=16):
    toks = np.random.default_rng(seed).integers(0, SMALL["vocab_size"], (B, T + 1))
    return {"tokens": toks[:, :-1].astype(np.int32), "targets": toks[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("n_experts, capacity_factor, drops", [
    (2, 0.5, True), (4, 0.5, True), (2, 2.0, False), (4, 4.0, False),
])
def test_moe_mlp_routes_and_combines_as_the_reference(n_experts, capacity_factor, drops):
    jcfg, tcfg = configs(n_experts=n_experts, capacity_factor=capacity_factor)
    block = jtr.init_params(jax.random.PRNGKey(n_experts), jcfg)["block"]
    jlayer = jax.tree.map(lambda w: w[0], block)
    x = np.random.default_rng(3).normal(size=(2, 24, SMALL["d_model"])).astype(np.float32)
    jy, jgates, jidx = jtr._moe_mlp(jnp.asarray(x), jlayer, jcfg, {}, None)
    ty, tgates, tidx = ttr._moe_mlp(torch.from_numpy(x), carried(jlayer), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tgates.detach().numpy(), np.asarray(jgates), atol=GATES_ATOL)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=OUT_ATOL)
    dropped = np.all(np.asarray(jy) == 0, axis=-1)
    assert dropped.any() == drops
    # A token is dropped iff its rank among its expert's tokens reaches the capacity.
    capacity = max(1, int(capacity_factor * 48 / n_experts))
    flat = np.asarray(jidx).reshape(-1)
    rank = np.array([np.sum(flat[:i] == e) for i, e in enumerate(flat)])
    np.testing.assert_array_equal(dropped.reshape(-1), rank >= capacity)
    np.testing.assert_allclose(
        float(ttr.moe_aux_loss(tgates, tidx, n_experts).detach()),
        float(jtr.moe_aux_loss(jgates, jidx, n_experts)), atol=AUX_ATOL)


@pytest.mark.parametrize("remat_policy", ["dots", "save_attn"])
def test_blockwise_loss_and_grads_match_jax_under_a_remat_policy(remat_policy):
    """The MoE loss through ``ce_chunk``'s blockwise cross-entropy (forward
    returns the hidden states with the routing) under a selective remat
    policy, against the JAX loss."""
    jcfg, tcfg = configs(n_experts=4, capacity_factor=1.0, ce_chunk=8, remat=True,
                         remat_policy=remat_policy)
    jp = jtr.init_params(jax.random.PRNGKey(7), jcfg)
    tp = carried(jp)
    batch = tokens_np(8)
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tloss = ttr.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
                        device="cpu")
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=LOSS_ATOL)
    assert_tree_close(grads_of(tloss, tp), jgrads, atol=GRADS_ATOL)


def test_remat_recomputes_the_same_routing_in_bf16():
    cfg = ttr.TransformerConfig(**dict(SMALL, attention_impl="auto"), n_experts=4,
                                capacity_factor=0.75)
    batch = {k: torch.from_numpy(v) for k, v in tokens_np(9, B=4, T=32).items()}
    grads = []
    for remat in (False, True):
        params = ttr.init_params(cfg, torch.Generator().manual_seed(0))
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss = ttr.loss_fn(params, batch, cfg.scaled(remat=remat), device="cpu")
        grads.append(grads_of(loss, params))
    for a, b in zip(tree_leaves(grads[0]), tree_leaves(grads[1])):
        assert torch.equal(a, b)


def test_moe_on_a_mesh_above_one_rank_raises_naming_the_roadmap_item():
    """MoE across ranks runs on every template (``tests/test_torch_moe_ranks.py``,
    ``tests/test_torch_pipeline_step.py``): under ``pp_tp {pipeline: 2,
    tensor: 2}`` with one microbatch every rank returns one rank's logits
    (atol 1e-5: the tensor axis splits each expert's MLP columns).  What
    still raises, naming the item: MoE under a ``custom`` pipeline that is
    not composed, with a tensor axis."""
    _, tcfg = configs(n_experts=4)
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(tokens_np(4)["tokens"]).long()
    want = ttr.forward(tp, tokens, tcfg, device="cpu")[0]
    axes = {"pipeline": 2, "tensor": 2}

    def rank_main(mesh, rank):
        tmpl = template_for("pp_tp", axes, {"num_microbatches": 1})
        specs = tree_specs(ttr.param_axes(tcfg), tmpl.rules, axes)
        with torch.no_grad():
            return ttr.forward(tree_shard(tp, specs, mesh), tokens, tcfg, tmpl, mesh,
                               device="cpu")[0]

    for got in run_mesh_ranks(axes, rank_main):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    two_ranks = SimpleNamespace(size=lambda: 2, rank=lambda: 0)  # a group's stand-in
    mesh = build_mesh(axes, groups={"pipeline": two_ranks, "tensor": two_ranks})
    custom = template_for("custom", axes, {
        "pipeline_axis": "pipeline",
        "rules": {"layers": "pipeline", "heads": "tensor", "mlp": "tensor", "vocab": "tensor"}})
    with pytest.raises(NotImplementedError, match="ROADMAP item 7: MoE under a custom pipeline"):
        ttr.forward(tp, torch.zeros((2, 4), dtype=torch.long), tcfg, device="cpu",
                    template=custom, mesh=mesh)
    with pytest.raises(NotImplementedError, match="no MoE"):
        ttr.forward(tp, torch.zeros((1, 4), dtype=torch.long), tcfg, device="cpu",
                    return_kv=True)
    # One rank, under either ported template, routes as without one.
    one = ttr.forward(tp, torch.zeros((1, 4), dtype=torch.long), tcfg, device="cpu")[0]
    for strategy, axis in (("ddp", "data"), ("sp_ring", "sequence")):
        got = ttr.forward(tp, torch.zeros((1, 4), dtype=torch.long), tcfg, device="cpu",
                          template=template_for(strategy, {axis: 1}), mesh=build_mesh({axis: 1}))
        torch.testing.assert_close(got[0], one)


def test_lm_train_with_experts_trains_on_the_cpu():
    records = []
    lm_train(Context(params=dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8,
                                 d_ff=64, n_experts=4, seq=16, batch=4, steps=11, lr=1e-2,
                                 device="cpu"), seed=3, records=records))
    losses = {r["step"]: r["values"]["loss"] for r in records
              if r["kind"] == "metric" and "loss" in r["values"]}
    assert sorted(losses) == [0, 10] and losses[10] < losses[0]
    assert any("lm_train done: 11 steps" in r["line"] for r in records if r["kind"] == "log")
