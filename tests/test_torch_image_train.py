"""The port's image trainers, ``cnn_train`` and ``vit_train``
(``builtins/trainers.py``), on the CPU: the dataset path on a
``make_image_fixture`` dataset (on one rank, and on thread ranks under
``tp``, ``tp_dp``, ``ulysses`` and ``pp_tp``), the synthetic path,
checkpoint and resume, and a 2-process ``ddp`` gang of each through the
port's worker.

Models are small (16 px; the CNN at channels (8, 16), the ViT at d 32, 2
layers, 2 heads of 16) in the trainers' bf16 compute.  Tolerances: a
resumed run ends on the uninterrupted run's parameters bit for bit (the
data stream fast-forwards to the restored step); the gang logs a one-rank
trainer's losses on the same global batch within 1e-2 relative (each
rank's partial weight grads round to bf16 before the sum, as in
``test_torch_worker.py``).  Every gang caps its threads through the spec's
``env_vars`` and every wait has a timeout.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import time

import pytest
import torch

from polyaxon_tpu_torch.builtins.trainers import cnn_train, vit_train
from polyaxon_tpu_torch.compiler import compile_gang_plan
from polyaxon_tpu_torch.models import cnn, vit
from polyaxon_tpu_torch.runtime.checkpoint import CheckpointManager
from polyaxon_tpu_torch.runtime.datasets import make_image_fixture
from polyaxon_tpu_torch.runtime.optim import tree_leaves
from polyaxon_tpu_torch.spawner.local import LocalGangSpawner, LocalRun
from polyaxon_tpu_torch.stores.layout import StoreLayout
from polyaxon_tpu_torch.tracking import ledger
from polyaxon_tpu_torch.tracking.context import Context

GANG_TIMEOUT_S = 60.0
THREADS = {"OMP_NUM_THREADS": "1"}
BF16_RTOL = 1e-2
SIZE = 16
CNN = dict(image_size=SIZE, channels=[8, 16], batch=16, lr=3e-3)
VIT = dict(image_size=SIZE, patch_size=4, d_model=32, n_layers=2, n_heads=2, head_dim=16,
           d_ff=64, batch=16, lr=3e-3)
TRAINERS = {"cnn_train": (cnn_train, CNN), "vit_train": (vit_train, VIT)}


def reports(handle, process_id=0):
    path = handle.paths.report_file(process_id)
    return [json.loads(line) for line in path.read_text().splitlines()]


def of_type(lines, kind):
    return [line for line in lines if line["type"] == kind]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    make_image_fixture(root, "fixture", num_examples=128, image_size=SIZE)
    return root


def _run(trainer, params, data_dir=None, **ctx):
    records, rows = [], []
    ledger.configure(sink=rows.append)
    try:
        trainer(Context(params=dict(params, device="cpu"), seed=3, records=records,
                        data_path=None if data_dir is None else str(data_dir), **ctx))
    finally:
        ledger.configure(sink=None)
    metrics = {}
    for r in records:
        if r["kind"] == "metric":
            metrics.setdefault(r["step"], {}).update(r["values"])
    return metrics, [r["line"] for r in records if r["kind"] == "log"], rows


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_the_dataset_path_trains_and_accounts(name, data_dir):
    trainer, params = TRAINERS[name]
    metrics, logs, rows = _run(trainer, dict(params, dataset="fixture", steps=12), data_dir)
    assert sorted(metrics) == [0, 10, 11, 12]
    assert metrics[11]["loss"] < metrics[0]["loss"]
    final = metrics[12]
    assert 0.0 <= final["accuracy"] <= 1.0 and final["images_per_s"] > 0
    assert final["first_step_s"] > 0 and final["data_wait_s"] >= 0
    assert 0 < final["step_wall_s_p50"] <= final["step_wall_s_p95"] <= final["step_wall_s_p99"]
    assert logs[-1].startswith(f"{name} done: 12 steps, strategy=ddp")
    (row,) = [r for r in rows if r["final"]]
    assert row["steps"] == 12 and row["tokens"] == 12 * params["batch"]
    assert row["buckets"]["data_wait_s"] >= 0 and row["flops"] > 0


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_the_synthetic_path_learns_its_fixed_batch(name):
    trainer, params = TRAINERS[name]
    metrics, logs, _ = _run(trainer, dict(params, steps=21))
    assert metrics[20]["loss"] < metrics[0]["loss"]
    assert metrics[21]["accuracy"] > 0.5  # 10 classes: chance is 0.1
    assert "prefetch=2" in logs[-1]


#: (trainer, strategy, mesh axes): ranks that hold the same rows (tensor,
#: sequence, pipeline) must read the same rows of the dataset.
STRATEGY_CASES = {
    "vit_train-tp_dp": ("vit_train", "tp_dp", {"data": 2, "tensor": 2}),
    "vit_train-ulysses": ("vit_train", "ulysses", {"sequence": 2}),
    "vit_train-pp_tp": ("vit_train", "pp_tp", {"pipeline": 2, "tensor": 2}),
    "cnn_train-tp": ("cnn_train", "tp", {"tensor": 2}),
}


@pytest.mark.parametrize("case", list(STRATEGY_CASES))
def test_the_dataset_path_under_a_template_logs_the_one_rank_losses(case, data_dir):
    """The trainer on thread ranks of the template's mesh reads the dataset
    by the ranks' shard of the batch axes and logs one rank's losses within
    1e-2 relative (bf16), and the accuracy of the last batch over every
    rank's rows, and names the strategy in its last line."""
    from tests.torch_gang_ranks import run_mesh_ranks

    name, strategy, axes = STRATEGY_CASES[case]
    trainer, params = TRAINERS[name]
    params = dict(params, dataset="fixture", steps=3)
    world = 1
    for n in axes.values():
        world *= n

    def rank_main(mesh, rank):
        return _run(trainer, params, data_dir, mesh=mesh, strategy=strategy, process_id=rank,
                    num_processes=world)[:2]

    metrics, logs = run_mesh_ranks(axes, rank_main)[0]
    one, _, _ = _run(trainer, params, data_dir)
    assert sorted(metrics) == sorted(one) == [0, 2, 3]
    assert [metrics[s]["loss"] for s in (0, 2)] == pytest.approx(
        [one[s]["loss"] for s in (0, 2)], rel=BF16_RTOL)
    assert abs(metrics[3]["accuracy"] - one[3]["accuracy"]) <= 1 / params["batch"]
    assert logs[-1].startswith(f"{name} done: 3 steps, strategy={strategy}")


def _saved_params(ckpt_dir, template, step):
    manager = CheckpointManager(ckpt_dir)
    try:
        return manager.restore_params(template, step=step)["params"]
    finally:
        manager.close()


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_a_resumed_run_ends_on_the_uninterrupted_params(name, data_dir, tmp_path):
    """Saves every 2 steps: the whole run of 5 steps, against one of 3 steps
    resumed from its step-2 save to 5, on the dataset path (8 batches an
    epoch, so the resumed stream starts mid-epoch)."""
    trainer, params = TRAINERS[name]
    params = dict(params, dataset="fixture", save_every=2)
    whole, part = tmp_path / "whole", tmp_path / "part"
    _run(trainer, dict(params, steps=5), data_dir, checkpoints_path=str(whole))
    _run(trainer, dict(params, steps=3), data_dir, checkpoints_path=str(part))
    _, logs, _ = _run(trainer, dict(params, steps=5), data_dir, checkpoints_path=str(part))
    assert "restored checkpoint at step 2" in logs
    if name == "cnn_train":
        cfg = cnn.CNNConfig(image_size=SIZE, channels=(8, 16))
        make = lambda: cnn.init_params(cfg, torch.Generator().manual_seed(0))  # noqa: E731
    else:
        cfg = vit.ViTConfig(image_size=SIZE, **{k: VIT[k] for k in (
            "patch_size", "d_model", "n_layers", "n_heads", "head_dim", "d_ff")})
        make = lambda: vit.init_params(cfg, torch.Generator().manual_seed(0))  # noqa: E731
    want, got = _saved_params(whole, make(), 4), _saved_params(part, make(), 4)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(want), tree_leaves(got)))


def test_the_trainers_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-absent path; a card is present")
    for trainer, params in TRAINERS.values():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer(Context(params=dict(params), records=[]))


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_a_two_process_gang_logs_the_one_rank_losses(name, tmp_path):
    """The trainer from a spec on 2 gloo ranks (``ddp`` on {data: 2}) of the
    dataset path: each rank reads its half of every global batch, the step
    sums their grads; the leader logs the losses of one rank's run on the
    whole batches, and the accuracy over both ranks' rows."""
    trainer, params = TRAINERS[name]
    layout = StoreLayout(tmp_path)
    make_image_fixture(layout.data_dir, "fixture", num_examples=128, image_size=SIZE)
    declarations = dict(params, dataset="fixture", steps=11, prefetch=0)
    doc = {"kind": "experiment",
           "run": {"entrypoint": f"polyaxon_tpu_torch.builtins.trainers:{name}"},
           "declarations": declarations,
           "environment": {"seed": 3, "env_vars": dict(THREADS), "topology": {
               "accelerator": "cpu", "num_devices": 2, "num_hosts": 2, "mesh": {"data": 2},
               "strategy": "ddp"}}}
    spawner = LocalGangSpawner(layout, heartbeat_interval=0.5)
    handle = spawner.start(LocalRun(doc, id=1), compile_gang_plan(doc))
    try:
        deadline = time.monotonic() + GANG_TIMEOUT_S
        while not handle.all_exited:
            assert time.monotonic() < deadline, handle.poll()
            time.sleep(0.1)
    finally:
        spawner.stop(handle, grace=1.0)
    assert handle.poll() == {0: 0, 1: 0}, handle.paths.log_file(1).read_text()[-2000:]
    lines = reports(handle)
    got = {m["step"]: m["values"] for m in of_type(lines, "metric")}
    assert not of_type(reports(handle, 1), "metric")  # the leader logs
    want, _, _ = _run(trainer, dict(declarations, prefetch=2), layout.data_dir)
    assert sorted(got) == sorted(want) == [0, 10, 11]
    for step in (0, 10):
        assert got[step]["loss"] == pytest.approx(want[step]["loss"], rel=BF16_RTOL)
    assert got[11]["accuracy"] == pytest.approx(want[11]["accuracy"], abs=1.0 / 16)
    assert of_type(lines, "log")[-1]["line"].startswith(f"{name} done: 11 steps, strategy=ddp")
    for i in (0, 1):  # each rank's ledger accounts its own half of the batch
        final = [row for row in of_type(reports(handle, i), "ledger") if row.get("final")][-1]
        assert final["tokens"] == 11 * params["batch"] // 2
