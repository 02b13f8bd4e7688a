"""Parity of the port's train step with the JAX package's under the pipeline
across ranks: ``pp``, ``pp_tp`` (dense and flash, and with 4 experts: each
microbatch cut from the global batch and routed over the data ranks' tokens,
as the reference's composed body routes it) and ``custom``; the other MoE
cases are in ``tests/test_torch_moe_ranks.py``.

The cases extend ``tests/test_torch_gang_step.py``'s ``CASES`` and are held
by its machinery with its tolerances (loss and grad norm 1e-5 a step; the
parameters after 3 steps 1e-5 above ``GRAD_FLOOR``, Adam's bound below it;
ranks holding the same shard of a parameter hold it bit for bit), in files
of their own so that the test workers run them beside that file's cases.
The model is that file's small float32 config.  Under ``attention_impl:
flash`` the JAX kernel runs in Pallas interpret mode and the port its plain
version.

Placement, bit for bit: after ``init`` each rank's shard of every param and
of AdamW's first moment is the JAX device shard, for ``pp {data: 2,
pipeline: 2}`` (a stage holds its layer) and ``pp_tp {data: 2, tensor: 2,
pipeline: 2}``.

Checkpoints: a ``pp`` run saves the one-rank layout through the trainers'
hook and one rank restores it bit for bit, and the reverse.

``lm_train``: the entry point runs each new strategy, and MoE under the
templates that route it across ranks, on thread ranks (bf16, as a gang runs
it) within 1e-2 of one rank's losses.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json

import numpy as np
import pytest
import torch

from polyaxon_tpu_torch.builtins.trainers import _open_checkpoints, lm_train
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.parallel.templates import template_for
from polyaxon_tpu_torch.runtime import optim
from polyaxon_tpu_torch.runtime.checkpoint import CheckpointManager
from polyaxon_tpu_torch.runtime.mesh import build_mesh
from polyaxon_tpu_torch.runtime.train import build_train_step
from polyaxon_tpu_torch.tracking.context import Context
from tests.test_torch_gang_step import (
    _paths,
    _shard,
    assert_params_close,
    jax_run,
    port_rank,
)
from tests.torch_gang_ranks import run_mesh_ranks

MOE = {"n_experts": 4}
#: name -> (strategy, mesh axes, config overrides, template options)
CASES = {
    "pp-pipeline2-micro2": ("pp", {"pipeline": 2}, {}, {"num_microbatches": 2}),
    "pp-data2-pipeline2": ("pp", {"data": 2, "pipeline": 2}, {}, {}),
    "pp_tp-data2-tensor2-pipeline2-dense": ("pp_tp", {"data": 2, "tensor": 2, "pipeline": 2},
                                            {}, {}),
    "pp_tp-data2-tensor2-pipeline2-flash": ("pp_tp", {"data": 2, "tensor": 2, "pipeline": 2},
                                            {"attention_impl": "flash"}, {}),
    "custom-data2-tensor2": ("custom", {"data": 2, "tensor": 2}, {},
                             {"rules": {"embed": "data", "heads": "tensor", "mlp": "tensor",
                                        "vocab": "tensor"}}),
    "pp_tp-moe-data2-tensor2-pipeline2-micro2-dense": (
        "pp_tp", {"data": 2, "tensor": 2, "pipeline": 2}, MOE, {"num_microbatches": 2}),
    "pp_tp-moe-data2-tensor2-pipeline2-micro2-flash": (
        "pp_tp", {"data": 2, "tensor": 2, "pipeline": 2}, dict(MOE, attention_impl="flash"),
        {"num_microbatches": 2}),
}
#: The meshes whose placement is held bit for bit after ``init``.
PLACED = ("pp-data2-pipeline2", "pp_tp-data2-tensor2-pipeline2-dense")


def _want(case, masked):
    strategy, axes, extra, options = case
    return jax_run(strategy, tuple(axes.items()), masked, tuple(extra.items()),
                   json.dumps(options, sort_keys=True))


def check_steps(case, masked):
    """The case's ranks against the JAX step (the module docstring)."""
    strategy, axes, extra, options = case
    want = _want(case, masked)
    results = run_mesh_ranks(axes, lambda mesh, rank: port_rank(
        mesh, rank, strategy, want["init"], masked, extra, options=options))
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


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked-by-rank"])
@pytest.mark.parametrize("case", list(CASES))
def test_steps_across_ranks_match_the_jax_step(case, masked):
    check_steps(CASES[case], masked)


def check_placed(case):
    """Each rank's shard of every param and of AdamW's first moment, after
    ``init``, is the JAX array's shard on device r, bit for bit: under
    ``pp`` a stage holds its layer of the block and not the other's, under
    ``ep`` a rank holds half of the experts."""
    strategy, axes, extra, options = case
    want = _want(case, False)
    results = run_mesh_ranks(axes, lambda mesh, rank: port_rank(
        mesh, rank, strategy, want["init"], False, extra, steps=0, options=options))
    whole = dict(_paths(want["init"]))
    split = set()
    for rank, (_, _, placed) in enumerate(results):
        assert placed.keys() == want["placed"].keys()
        for path, (param, mu) in placed.items():
            jparam, jmu = want["placed"][path][rank]
            np.testing.assert_array_equal(param.numpy(), jparam)
            np.testing.assert_array_equal(mu.numpy(), jmu)
            if jparam.size < whole[path].size:
                split.add(path)
    if strategy.startswith("pp"):
        assert {p for p in whole if p.startswith("block/")} <= split
    else:
        assert {"block/wi", "block/wg", "block/wd", "block/router"} <= split


@pytest.mark.parametrize("case", PLACED)
def test_init_places_each_shard_where_jax_places_it(case):
    check_placed(CASES[case])


# -- checkpoints across layouts -----------------------------------------------

LM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64, max_seq=16,
          attention_impl="dense")


def _np(t):
    return t.detach().float().numpy()


def _lm_step(mesh, strategy, init, extra):
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **{**LM, **extra})
    tmpl = template_for(strategy, dict(mesh.shape))
    return build_train_step(
        loss_fn=lambda p, b: ttr.loss_fn(p, b, tcfg, tmpl, mesh, device="cpu"),
        init_fn=lambda g: ttr.init_params(tcfg, torch.Generator().manual_seed(init)),
        optimizer=optim.AdamW(1e-3), mesh=mesh, template=tmpl, axes_tree=ttr.param_axes(tcfg))


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


def test_a_pp_checkpoint_restores_into_one_rank_and_back(tmp_path):
    check_checkpoint(tmp_path, "pp", {"pipeline": 2}, {})


def check_checkpoint(tmp_path, strategy, axes, extra):
    """The ranks take a step and save through the trainers' hook (every rank
    gathers, the leader writes the one-rank layout); one rank restores it bit
    for bit; then one rank's step is saved and the ranks restore it, each
    holding its shard of the whole, bit for bit."""
    world = int(np.prod(list(axes.values())))
    batch = _lm_batch()

    def save(mesh, rank):
        ts = _lm_step(mesh, strategy, 1, extra)
        params, opt_state = ts.init(torch.Generator())
        params, opt_state, _ = ts.step(params, opt_state, ts.place_batch(batch))
        ctx = Context(params={}, process_id=rank, num_processes=world,
                      checkpoints_path=tmp_path / "a")
        ckpt, hook, params, opt_state, start = _open_checkpoints(ctx, 1, ts, params, opt_state)
        assert start == 0 and hook is not None and (ckpt is None) == (rank != 0)
        hook(0, params, opt_state)
        if ckpt is not None:
            ckpt.wait_until_finished()
            ckpt.close()
        return (_whole(*ts.full_state(params, opt_state)),
                sum(p.numel() for p in optim.tree_leaves(params)))

    saved = run_mesh_ranks(axes, save)
    whole = saved[0][0]
    assert all(held < sum(p.size for p in whole[0]) for _, held in saved)  # each holds a part
    one = _lm_step(build_mesh({"data": 1}), "ddp", 9, extra)
    params, opt_state = one.init(torch.Generator())
    ckpt, _, params, opt_state, start = _open_checkpoints(
        Context(params={}, checkpoints_path=tmp_path / "a"), 1, one, params, opt_state)
    ckpt.close()
    assert start == 1
    _assert_same_state(_whole(params, opt_state), whole)

    params, opt_state, _ = one.step(params, opt_state, batch)
    ckpt = CheckpointManager(tmp_path / "b", enable_async=False)
    ckpt.save(1, params, opt_state)
    ckpt.close()
    want = _whole(params, opt_state)

    def restore(mesh, rank):
        ts = _lm_step(mesh, strategy, 7, extra)
        params, opt_state = ts.init(torch.Generator())
        ctx = Context(params={}, process_id=rank, num_processes=world,
                      checkpoints_path=tmp_path / "b")
        ckpt, _, params, opt_state, start = _open_checkpoints(ctx, 1, ts, params, opt_state)
        if ckpt is not None:
            ckpt.close()
        mine = [(_np(p).copy(), spec) for p, spec in
                zip(optim.tree_leaves(params), _leaf_specs(ts, params))]
        return start, mine, _whole(*ts.full_state(params, opt_state)), dict(mesh.shape), {
            a: mesh.rank(a) for a in mesh.shape}

    for start, mine, got, shape, ranks in run_mesh_ranks(axes, restore):
        assert start == 2
        _assert_same_state(got, want)
        for (shard, spec), full in zip(mine, want[0]):  # this rank's block of the whole
            block = full
            for dim, entry in enumerate(spec):
                for a in ((entry,) if isinstance(entry, str) else entry or ()):
                    n = shape[a]
                    size = block.shape[dim] // n
                    block = np.take(block, range(ranks[a] * size, (ranks[a] + 1) * size), dim)
            np.testing.assert_array_equal(shard, block)


def _leaf_specs(ts, params):
    from polyaxon_tpu_torch.runtime.train import _spec_leaves

    return _spec_leaves(params, ts.param_specs)


# -- the entry point ----------------------------------------------------------

TINY_LM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
               seq=16, batch=4, steps=3)
LM_TRAIN_CASES = {
    "pp": ("pp", {"pipeline": 2}, {}, None),
    "pp_tp": ("pp_tp", {"pipeline": 2, "tensor": 2}, {}, None),
    "ep": ("ep", {"data": 2, "expert": 2}, MOE, None),
    "custom": ("custom", {"data": 2, "tensor": 2}, {},
               {"rules": {"embed": "data", "heads": "tensor", "mlp": "tensor", "vocab": "tensor"}}),
    "moe-ddp": ("ddp", {"data": 2}, MOE, None),
    "moe-fsdp": ("fsdp", {"data": 2}, MOE, None),
    "moe-tp": ("tp", {"tensor": 2}, MOE, None),
    "moe-sp_ring": ("sp_ring", {"sequence": 2}, MOE, None),
    "moe-pp": ("pp", {"pipeline": 2}, MOE, {"num_microbatches": 1}),
    "moe-pp_tp": ("pp_tp", {"pipeline": 2, "tensor": 2}, MOE, {"num_microbatches": 1}),
}


def _lm_losses(records):
    return {r["step"]: r["values"]["loss"] for r in records
            if r["kind"] == "metric" and "loss" in r["values"]}


@pytest.mark.parametrize("case", list(LM_TRAIN_CASES))
def test_lm_train_runs_the_strategy_across_ranks(case):
    """``lm_train`` (bf16) on thread ranks logs one rank's losses within 1e-2
    relative (each rank's partial weight grads round to bf16 before the
    sum) and names the strategy in its last line."""
    strategy, axes, extra, options = LM_TRAIN_CASES[case]
    world = int(np.prod(list(axes.values())))
    params = dict(TINY_LM, device="cpu", **extra)

    def rank_main(mesh, rank):
        records = []
        lm_train(Context(params=params, seed=5, records=records, mesh=mesh, strategy=strategy,
                         strategy_options=options, process_id=rank, num_processes=world))
        return records

    records = run_mesh_ranks(axes, rank_main)[0]
    one = []
    lm_train(Context(params=params, seed=5, records=one))
    got, want = _lm_losses(records), _lm_losses(one)
    assert sorted(got) == sorted(want) == [0, 2]
    assert [got[s] for s in (0, 2)] == pytest.approx([want[s] for s in (0, 2)], rel=1e-2)
    assert f"strategy={strategy}" in [r for r in records if r["kind"] == "log"][-1]["line"]
