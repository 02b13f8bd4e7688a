"""The port's ``lm_generate`` entrypoint on the CPU (random weights, and a
``target`` run's checkpoint against the port's and the JAX package's
``generate`` on the restored weights), and the port's isolation from JAX and
from the JAX package."""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import decode as jdec
from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu_torch.builtins.trainers import lm_generate, lm_train
from polyaxon_tpu_torch.models import decode
from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params
from polyaxon_tpu_torch.runtime.checkpoint import CheckpointManager
from polyaxon_tpu_torch.tracking.context import Context

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128,
             seq=64, batch=2, prompt_len=8, max_new_tokens=6)


@pytest.mark.parametrize("extra", [{}, {"quantize": "int8", "n_kv_heads": 2},
                                   {"temperature": 0.8}], ids=["greedy", "int8-gqa", "sampled"])
def test_lm_generate_logs_the_three_metrics(extra):
    records = []
    ctx = Context(params=dict(SMALL, device="cpu", **extra), seed=3, records=records)
    out = lm_generate(ctx)
    assert tuple(out.shape) == (2, 6) and int(out.max()) < 256
    metrics = [r["values"] for r in records if r["kind"] == "metric"]
    assert len(metrics) == 1
    assert set(metrics[0]) == {"decode_tokens_per_s", "prefill_s", "generated"}
    assert metrics[0]["generated"] == 12 and metrics[0]["decode_tokens_per_s"] > 0
    assert any("lm_generate done" in r["line"] for r in records if r["kind"] == "log")


def test_lm_generate_is_seeded():
    run = lambda: lm_generate(Context(params=dict(SMALL, device="cpu"), seed=5, records=[]))
    assert torch.equal(run(), run())


def _trained_run(tmp_path, uuid="trained", steps=3):
    """An lm_train run with checkpoints under <tmp>/runs/<uuid>; returns the
    runs root."""
    run = tmp_path / "runs" / uuid
    train = {k: v for k, v in SMALL.items() if k not in ("prompt_len", "max_new_tokens")}
    lm_train(Context(params=dict(train, steps=steps, save_every=1, device="cpu"), seed=4,
                     outputs_path=str(run / "outputs"), checkpoints_path=str(run / "checkpoints"),
                     records=[]))
    return tmp_path / "runs"


def test_lm_generate_target_gives_the_tokens_of_the_restored_weights(tmp_path):
    runs = _trained_run(tmp_path)
    records = []
    out = lm_generate(Context(params=dict(SMALL, device="cpu", target="trained"), seed=3,
                              runs_root=str(runs), records=records))
    assert "restored weights from run trained step 2" in [
        r["line"] for r in records if r["kind"] == "log"]
    cfg = TransformerConfig(max_seq=64, **{k: SMALL[k] for k in (
        "vocab_size", "d_model", "n_layers", "n_heads", "head_dim", "d_ff")})
    params = init_params(cfg, torch.Generator().manual_seed(0))
    mgr = CheckpointManager(runs / "trained" / "checkpoints")
    assert mgr.restore_params(params)["step"] == 2
    mgr.close()
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 8)))
    want = decode.generate(params, prompt, cfg, max_new_tokens=6, device="cpu")
    assert torch.equal(out, want)
    # The JAX package's generate on the same weights gives the same tokens.
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, max_seq=64, **{
        k: SMALL[k] for k in ("vocab_size", "d_model", "n_layers", "n_heads", "head_dim", "d_ff")})
    jparams = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), params)
    jout = jdec.generate(jparams, jnp.asarray(prompt.numpy()), jcfg, max_new_tokens=6)
    np.testing.assert_array_equal(np.asarray(jout), out.numpy())
    # Random weights give other tokens.
    assert not torch.equal(lm_generate(Context(params=dict(SMALL, device="cpu"), seed=3,
                                               records=[])), out)


def test_lm_generate_target_without_a_checkpoint_raises(tmp_path):
    (tmp_path / "runs" / "empty" / "outputs").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="No checkpoint under .*empty/checkpoints"):
        lm_generate(Context(params=dict(SMALL, device="cpu", target="empty"),
                            runs_root=str(tmp_path / "runs"), records=[]))
    # The runs root defaults to two above the run's outputs, as lm_server's does.
    here = tmp_path / "runs" / "me" / "outputs"
    with pytest.raises(RuntimeError, match="No checkpoint under .*runs/empty/checkpoints"):
        lm_generate(Context(params=dict(SMALL, device="cpu", target="empty"),
                            outputs_path=str(here), records=[]))
    with pytest.raises(ValueError, match="runs_root or outputs_path"):
        lm_generate(Context(params=dict(SMALL, device="cpu", target="empty"), records=[]))


def test_lm_generate_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-absent path; a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_generate(Context(params=dict(SMALL), records=[]))


def test_context_writes_json_lines_without_a_record_list(capsys):
    ctx = Context(params={"a": 1})
    ctx.log_metrics(step=2, loss=0.5)
    ctx.log_text("hello")
    out = capsys.readouterr().out.splitlines()
    assert out == ['{"kind": "metric", "step": 2, "values": {"loss": 0.5}}',
                   '{"kind": "log", "line": "hello"}']
    assert ctx.get_param("a") == 1 and ctx.get_param("b", 7) == 7 and ctx.is_leader


def _port_files():
    return sorted((REPO / "polyaxon_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "polyaxon_tpu", "flax", "optax"), (
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}"
            )


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import polyaxon_tpu_torch.builtins.trainers, polyaxon_tpu_torch.models\n"
        "import polyaxon_tpu_torch.serving.replica, polyaxon_tpu_torch.serving.fleet\n"
        "import polyaxon_tpu_torch.serving.router, polyaxon_tpu_torch.serving.autoscaler\n"
        "import polyaxon_tpu_torch.tracking.reporter, polyaxon_tpu_torch.tracking.flightrec\n"
        "import polyaxon_tpu_torch.tracking.ledger, polyaxon_tpu_torch.monitor.resources\n"
        "import polyaxon_tpu_torch.runtime.datasets, polyaxon_tpu_torch.runtime.data\n"
        "import polyaxon_tpu_torch.runtime.pipeline, polyaxon_tpu_torch.runtime.worker\n"
        "import polyaxon_tpu_torch.spawner.local, polyaxon_tpu_torch.compiler.service\n"
        "import polyaxon_tpu_torch.stores.layout, polyaxon_tpu_torch.schemas\n"
        "import polyaxon_tpu_torch.orchestrator, polyaxon_tpu_torch.scheduler.tasks\n"
        "import polyaxon_tpu_torch.monitor, polyaxon_tpu_torch.stats.tsdb\n"
        "import polyaxon_tpu_torch.stores.artifacts, polyaxon_tpu_torch.notifier\n"
        "import polyaxon_tpu_torch.tracker, polyaxon_tpu_torch.ci\n"
        "import polyaxon_tpu_torch.schemas.polyaxonfile, polyaxon_tpu_torch.schemas.hptuning\n"
        "import polyaxon_tpu_torch.schemas.matrix, polyaxon_tpu_torch.hpsearch\n"
        "import polyaxon_tpu_torch.hpsearch.search_managers, polyaxon_tpu_torch.hpsearch.tasks\n"
        "import polyaxon_tpu_torch.polyflow, polyaxon_tpu_torch.query\n"
        "import polyaxon_tpu_torch.checks, polyaxon_tpu_torch.checks.health\n"
        "import polyaxon_tpu_torch.api.app, polyaxon_tpu_torch.api.sso\n"
        "import polyaxon_tpu_torch.api.dashboard, polyaxon_tpu_torch.cli.main\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'polyaxon_tpu')]\n"
        "assert not bad, bad\n"
        "# The API and the CLI load aiohttp where they serve or sign in, not at import.\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'aiohttp']\n"
        "assert not bad, bad\n"
        "# The card's machine has none of these: the spec sections are checked\n"
        "# without them, and BO fits the port's own Gaussian process.\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('pydantic', 'yaml', 'sklearn')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_the_control_plane_loads_no_torch_and_no_cuda_context(tmp_path):
    """Importing the orchestrator and building one (with a JSON spec and a
    group submitted, the group's trials created) loads no torch, so no CUDA
    context: the control plane initialises nothing on a card its gangs
    use."""
    code = (
        "import sys\n"
        "from polyaxon_tpu_torch.orchestrator import Orchestrator\n"
        "import polyaxon_tpu_torch.scheduler, polyaxon_tpu_torch.monitor\n"
        "import polyaxon_tpu_torch.stats, polyaxon_tpu_torch.stores, polyaxon_tpu_torch.notifier\n"
        "import polyaxon_tpu_torch.checks, polyaxon_tpu_torch.query\n"
        "from polyaxon_tpu_torch.serving.fleet import ServingFleet\n"
        "orch = Orchestrator(sys.argv[1])\n"
        "orch.submit('{\"kind\": \"experiment\", \"run\": {\"cmd\": \"true\"}}')\n"
        "group = orch.submit({'kind': 'group', 'run': {'cmd': 'true'}, 'hptuning': {\n"
        "    'matrix': {'lr': {'uniform': [0, 1]}},\n"
        "    'bo': {'n_initial_trials': 2, 'n_iterations': 1,\n"
        "           'metric': {'name': 'loss'}}}})\n"
        "ServingFleet(orch, replicas=0).stop()\n"
        "polyaxon_tpu_torch.checks.run_health_checks(orch)\n"
        "from polyaxon_tpu_torch.workers import HPTasks\n"
        "orch.bus._tasks[HPTasks.CREATE](group_id=group.id)  # the trials, not dispatched\n"
        "assert len(orch.registry.list_runs(group_id=group.id)) == 2\n"
        "from polyaxon_tpu_torch.hpsearch import get_search_manager\n"
        "bo = get_search_manager(orch.get_run(group.id).spec.hptuning)\n"
        "bo.get_suggestions({'configs': [{'lr': 0.2}, {'lr': 0.6}], 'metrics': [1.0, 0.5]})\n"
        "import polyaxon_tpu_torch.cli.main\n"
        "from polyaxon_tpu_torch.api.app import create_app\n"
        "create_app(orch)\n"
        "orch.stop()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'polyaxon_tpu',\n"
        "                                                     'yaml', 'sklearn')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "plane")], cwd=REPO, check=True,
                   timeout=120)
