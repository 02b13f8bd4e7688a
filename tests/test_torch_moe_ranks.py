"""MoE across ranks against the JAX package: the train step under ``ep``,
pp×MoE and MoE under ``ddp``, ``fsdp``, ``tp`` and ``sp_ring`` (under
``pp_tp`` in ``tests/test_torch_pipeline_step.py``), the placement and
checkpoints of ``ep``, and the routing alone.

The steps are held by ``tests/test_torch_pipeline_step.py``'s machinery (that
of ``tests/test_torch_gang_step.py``, with its tolerances) on its small
float32 config with 4 experts (capacity factor 1.25).  Every template but a
pipeline routes the global batch, as the reference's GSPMD program does;
under ``pp`` each stage routes each microbatch of each data rank, as the
reference's manual body does, so ``pp {data: 2, pipeline: 2}`` with 2
microbatches is held to the JAX step, not to one rank.

The routing alone: each rank's ``_moe_mlp`` on its shard of a global batch
against the JAX ``_moe_mlp`` on the whole (one device, float32): the expert
index and the kept mask token for token, the output within 1e-5 (float32
products in another order), under ``sp_ring {data: 2, sequence: 2}`` (a
rank's tokens interleave with the others' in the global ``b·T + t`` order),
``ep {data: 2, expert: 2}``, ``tp {tensor: 2}`` and ``tp_dp {data: 2,
tensor: 2}`` (each expert's MLP columns split over ``tensor``), and under
``pp_tp`` each global microbatch's routing, with a capacity factor
that drops tokens (0.5) and one that keeps them all (4.0); and the global
balance loss within 1e-6.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.parallel.axes import shard_tensor
from polyaxon_tpu_torch.parallel.templates import template_for
from polyaxon_tpu_torch.runtime.train import shard_batch
from tests.test_torch_pipeline_step import MOE, check_checkpoint, check_placed, check_steps
from tests.torch_gang_ranks import run_mesh_ranks

#: name -> (strategy, mesh axes, config overrides, template options)
CASES = {
    "pp-moe-data2-pipeline2-micro2": ("pp", {"data": 2, "pipeline": 2}, MOE,
                                      {"num_microbatches": 2}),
    "ep-data2-expert2": ("ep", {"data": 2, "expert": 2}, MOE, {}),
    "ddp-moe-data2": ("ddp", {"data": 2}, MOE, {}),
    "fsdp-moe-data2": ("fsdp", {"data": 2}, MOE, {}),
    "tp-moe-tensor2": ("tp", {"tensor": 2}, MOE, {}),
    "sp_ring-moe-data2-sequence2": ("sp_ring", {"data": 2, "sequence": 2}, MOE, {}),
}


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked-by-rank"])
@pytest.mark.parametrize("case", list(CASES))
def test_steps_across_ranks_match_the_jax_step(case, masked):
    check_steps(CASES[case], masked)


def test_init_places_each_expert_where_jax_places_it():
    """Under ``ep {data: 2, expert: 2}`` each rank's shard of every param and
    of AdamW's first moment is the JAX device shard, bit for bit: half of the
    experts, the router's columns of them, every weight's embedding
    dimension split over ``data``."""
    check_placed(CASES["ep-data2-expert2"])


def test_an_ep_checkpoint_restores_into_one_rank_and_back(tmp_path):
    check_checkpoint(tmp_path, "ep", {"data": 2, "expert": 2}, MOE)


# -- the routing alone ----------------------------------------------------------

D, F, E, B, T = 16, 32, 4, 4, 8
ROUTES = {"sp_ring": {"data": 2, "sequence": 2}, "ep": {"data": 2, "expert": 2},
          "tp": {"tensor": 2}, "tp_dp": {"data": 2, "tensor": 2}}


def _inputs():
    rng = np.random.default_rng(5)
    layer = {"router": rng.normal(size=(D, E)) * D ** -0.5,
             "wi": rng.normal(size=(E, D, F)) * D ** -0.5,
             "wg": rng.normal(size=(E, D, F)) * D ** -0.5,
             "wd": rng.normal(size=(E, F, D)) * F ** -0.5}
    x = rng.normal(size=(B, T, D))
    return {k: v.astype(np.float32) for k, v in layer.items()}, x.astype(np.float32)


@pytest.mark.parametrize("capacity_factor", [0.5, 4.0], ids=["drops", "keeps-all"])
@pytest.mark.parametrize("strategy", list(ROUTES))
def test_routing_across_ranks_is_the_jax_routing_of_the_global_batch(strategy, capacity_factor):
    layer, x = _inputs()
    jcfg = jtr.TransformerConfig(d_model=D, d_ff=F, n_experts=E, capacity_factor=capacity_factor,
                                 dtype=jnp.float32)
    jy, jgates, jidx = jtr._moe_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()},
                                    jcfg, {}, None)
    jy, jgates, jidx = np.asarray(jy), np.asarray(jgates), np.asarray(jidx)
    jaux = float(jtr.moe_aux_loss(jnp.asarray(jgates), jnp.asarray(jidx), E))
    kept = np.abs(jy).sum(-1) > 0
    if capacity_factor < 1:
        assert 0 < kept.sum() < B * T  # the case drops tokens
    else:
        assert kept.all()
    tcfg = ttr.TransformerConfig(d_model=D, d_ff=F, n_experts=E, capacity_factor=capacity_factor,
                                 dtype=torch.float32)
    axes = ROUTES[strategy]

    def rank_main(mesh, rank):
        tmpl = template_for(strategy, dict(mesh.shape))
        shard = ttr._Shard(tcfg, tmpl, mesh)
        assert shard.token_groups or shard.expert_group is not None
        # tp_dp splits each expert's MLP columns over tensor, tp the experts.
        assert (shard.expert_mlp_group is not None) == (strategy == "tp_dp")
        mine = {n: shard_tensor(torch.from_numpy(w), shard.layer_specs[n], mesh)
                for n, w in layer.items()}
        mine = {n: shard.placement.use(w, shard.layer_specs[n]) for n, w in mine.items()}
        # This rank's tokens: its rows, and under sp_ring its sequence shard.
        positions = shard_batch({"tokens": torch.arange(B * T).view(B, T)}, mesh,
                                tmpl)["tokens"].numpy()
        rows, cols = np.divmod(positions, T)
        y, gates, idx = ttr._moe_mlp(torch.from_numpy(x[rows, cols]), mine, tcfg, shard)
        aux = ttr.moe_aux_loss(gates, idx, E, shard.token_groups)
        return positions, y.numpy(), idx.numpy(), float(aux)

    for positions, y, idx, aux in run_mesh_ranks(axes, rank_main):
        rows, cols = np.divmod(positions, T)
        np.testing.assert_array_equal(idx, jidx[rows, cols])
        np.testing.assert_array_equal(np.abs(y).sum(-1) > 0, kept[rows, cols])
        np.testing.assert_allclose(y, jy[rows, cols], atol=1e-5, rtol=0)
        np.testing.assert_allclose(aux, jaux, atol=1e-6, rtol=0)


@pytest.mark.parametrize("capacity_factor", [0.5, 4.0], ids=["drops", "keeps-all"])
def test_routing_under_pp_tp_is_the_jax_routing_of_each_global_microbatch(capacity_factor):
    """Under ``pp_tp {data: 2, tensor: 2, pipeline: 2}`` with 2 microbatches
    each rank's local microbatch m is its block of global microbatch m
    (``shard_batch``), routed over the data ranks' tokens with each expert's
    MLP columns split over ``tensor``: the JAX ``_moe_mlp`` of global
    microbatch m (rows ``[m·B/2, (m+1)·B/2)``), token for token, drops
    included, the output within 1e-5 and the balance loss within 1e-6."""
    M, axes = 2, {"data": 2, "tensor": 2, "pipeline": 2}
    layer, x = _inputs()
    jcfg = jtr.TransformerConfig(d_model=D, d_ff=F, n_experts=E, capacity_factor=capacity_factor,
                                 dtype=jnp.float32)
    want = []
    for m in range(M):
        rows = slice(m * B // M, (m + 1) * B // M)
        jy, jgates, jidx = jtr._moe_mlp(jnp.asarray(x[rows]),
                                        {k: jnp.asarray(v) for k, v in layer.items()}, jcfg, {},
                                        None)
        jaux = float(jtr.moe_aux_loss(jgates, jidx, E))
        want.append((np.asarray(jy), np.asarray(jidx), jaux))
    kept = np.concatenate([np.abs(w[0]).sum(-1) > 0 for w in want])
    assert (0 < kept.sum() < B * T) if capacity_factor < 1 else kept.all()
    tcfg = ttr.TransformerConfig(d_model=D, d_ff=F, n_experts=E, capacity_factor=capacity_factor,
                                 dtype=torch.float32)

    def rank_main(mesh, rank):
        tmpl = template_for("pp_tp", dict(mesh.shape), {"num_microbatches": M})
        shard = ttr._Shard(tcfg, tmpl, mesh)
        assert shard.expert_mlp_group is not None and shard.token_batch_axes == ("data",)
        mine = {n: shard_tensor(torch.from_numpy(w), shard.layer_specs[n], mesh)
                for n, w in layer.items()}
        mine = {n: shard.placement.use(w, shard.layer_specs[n]) for n, w in mine.items()}
        rows = shard_batch({"rows": torch.arange(B)}, mesh, tmpl)["rows"]
        out = []
        for m, mb in enumerate(rows.chunk(M)):
            y, gates, idx = ttr._moe_mlp(torch.from_numpy(x[mb.numpy()]), mine, tcfg, shard)
            aux = ttr.moe_aux_loss(gates, idx, E, shard.token_groups)
            out.append((mb.numpy(), y.numpy(), idx.numpy(), float(aux)))
        return out

    for out in run_mesh_ranks(axes, rank_main):
        for m, (rows, y, idx, aux) in enumerate(out):
            jy, jidx, jaux = want[m]
            local = rows - m * B // M  # the rows of global microbatch m
            assert ((local >= 0) & (local < B // M)).all()
            np.testing.assert_array_equal(idx, jidx[local])
            np.testing.assert_array_equal(np.abs(y).sum(-1) > 0, np.abs(jy[local]).sum(-1) > 0)
            np.testing.assert_allclose(y, jy[local], atol=1e-5, rtol=0)
            np.testing.assert_allclose(aux, jaux, atol=1e-6, rtol=0)
