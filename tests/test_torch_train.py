"""Parity of the port's training slice with the JAX package's, on the CPU:
``loss_fn`` (whole and blockwise cross-entropy), the remat policies, AdamW
against ``optax.adamw``, three train steps against the JAX
``build_train_step``, and ``lm_train``.

Weights come from the JAX ``init_params`` and cross to torch through numpy
(``params_from_jax``); tokens, masks and grads come from numpy.  The config
is bench.py's CPU-smoke shape (bench.py:63-73) in float32 on both sides.
Tolerances, all float32, where the frameworks differ only in summation
order:

- loss atol 1e-5, grads atol 1e-6 (grads here are at most about 0.1);
- a remat policy gives the no-remat grads to 1e-6 (the recompute repeats
  the same ops);
- AdamW against the jitted ``optax.adamw`` update: parameters and moments
  atol 1e-7 after 3 updates (same arithmetic in the same order); with a
  bf16 first moment, mu is compared at one bf16 ulp (rtol 2**-7) since a
  float32 difference can flip its rounding;
- three train steps: per-step loss atol 1e-5, final parameters atol 1e-5
  (an Adam update is lr·mû/(sqrt(nû)+eps), so where a grad is near 0 a
  1e-6 relative difference in it moves the update by up to about 1e-6).
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.parallel import template_for
from polyaxon_tpu.runtime import checkpoint as jckpt
from polyaxon_tpu.runtime import train as jtrain
from polyaxon_tpu.runtime.mesh import build_mesh
from polyaxon_tpu.tracking import ledger as jledger
from polyaxon_tpu.tracking import profiling as jprofiling
from polyaxon_tpu_torch.builtins.trainers import lm_train
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.parallel import flash as tflash
from polyaxon_tpu_torch.parallel.templates import template_for as port_template_for
from polyaxon_tpu_torch.runtime import optim
from polyaxon_tpu_torch.runtime.checkpoint import latest_complete_step
from polyaxon_tpu_torch.runtime.mesh import build_mesh as build_port_mesh
from polyaxon_tpu_torch.runtime.train import build_train_step
from polyaxon_tpu_torch.tracking.context import Context
from polyaxon_tpu_torch.tracking.ledger import transformer_flops_per_token
from polyaxon_tpu_torch.tracking.profiling import StepClock

REPO = Path(__file__).resolve().parents[1]
SMOKE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128, max_seq=64)
BATCH, SEQ = 4, 64


def configs(**kw):
    return (
        jtr.TransformerConfig(dtype=jnp.float32, **SMOKE, **kw),
        ttr.TransformerConfig(dtype=torch.float32, **SMOKE, **kw),
    )


def jax_params(jcfg, seed=0):
    params = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    return params, params_from_jax(jax.tree.map(np.asarray, params), "cpu")


def batch_np(seed=0, T=SEQ):
    tok = np.random.default_rng(seed).integers(0, SMOKE["vocab_size"], (BATCH, T + 1))
    return {"tokens": tok[:, :-1].astype(np.int32), "targets": tok[:, 1:].astype(np.int32)}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def torch_leaves(params):
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def assert_tree_close(tparams, jtree, atol, rtol=0.0):
    for key, j in jtree.items():
        if isinstance(j, dict):
            assert_tree_close(tparams[key], j, atol, rtol)
        else:
            np.testing.assert_allclose(tparams[key].detach().float().numpy(),
                                       np.asarray(j, np.float32), atol=atol, rtol=rtol,
                                       err_msg=key)


@pytest.mark.parametrize(
    "ce_chunk, masked", [(0, False), (0, True), (16, False), (16, True)],
    ids=["whole", "whole-masked", "chunked", "chunked-masked"],
)
def test_loss_and_grads_match_jax(ce_chunk, masked):
    jcfg, tcfg = configs(ce_chunk=ce_chunk)
    jp, tp = jax_params(jcfg)
    batch = batch_np(1)
    if masked:
        batch["mask"] = (np.random.default_rng(2).random((BATCH, SEQ)) > 0.3).astype(np.float32)
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves = torch_leaves(tp)
    tloss = ttr.loss_fn(tp, to_torch(batch), tcfg, device="cpu")
    tgrads = torch.autograd.grad(tloss, leaves)
    assert tloss.dtype == torch.float32 and tloss.dim() == 0
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5)
    grads = dict(zip([id(p) for p in leaves], tgrads))

    def graft(tree):  # the port's grads in the params' tree shape
        return {k: graft(v) if isinstance(v, dict) else grads[id(v)] for k, v in tree.items()}

    assert_tree_close(graft(tp), jgrads, atol=1e-6)


def test_return_hidden_is_the_prelogit_state():
    jcfg, tcfg = configs()
    jp, tp = jax_params(jcfg, seed=4)
    toks = batch_np(3)["tokens"]
    jh = jtr.forward(jp, jnp.asarray(toks), jcfg, return_hidden=True)
    th = ttr.forward(tp, torch.from_numpy(toks).long(), tcfg, return_hidden=True, device="cpu")
    assert tuple(th.shape) == (BATCH, SEQ, SMOKE["d_model"])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)


@pytest.mark.parametrize(
    "policy, fwd_per_layer",
    [("none", 2), ("dots", 2), ("dots_no_batch", 2), ("save_attn", 1), ("save_attn_mlp", 1),
     ("save_qkv_attn", 1)],
)
def test_remat_policy_gives_the_no_remat_grads(policy, fwd_per_layer, monkeypatch):
    """Each policy recomputes what it does not keep and changes no number.
    Through the flash path (its plain version here), the forward attention
    runs once per layer in the forward pass and once more in the recompute
    unless the policy keeps the attention's output."""
    calls = []
    plain = tflash.flash_block_fwd_reference
    monkeypatch.setattr(tflash, "flash_block_fwd_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    _, tcfg = configs(attention_impl="flash")
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    leaves = torch_leaves(tp)
    batch = to_torch(batch_np(5, T=24))
    ref_loss = ttr.loss_fn(tp, batch, tcfg, device="cpu")
    ref = torch.autograd.grad(ref_loss, leaves)
    calls.clear()
    loss = ttr.loss_fn(tp, batch, tcfg.scaled(remat=True, remat_policy=policy), device="cpu")
    grads = torch.autograd.grad(loss, leaves)
    assert len(calls) == fwd_per_layer * tcfg.n_layers
    assert loss.item() == ref_loss.item()
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_adamw_matches_optax(mu_dtype):
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 5), "b": {"c": (3,), "d": (2, 4, 6)}}

    def draw(tree, scale=1.0):
        return {k: draw(v, scale) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32) for k, v in tree.items()}

    params = draw(shapes)
    grads = [draw(shapes, 0.1) for _ in range(3)]
    grads[1]["a"][0, :] = 0.0  # a zero grad: only the decay moves it
    jopt = optax.adamw(3e-4, mu_dtype=jnp.bfloat16 if mu_dtype else None)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)  # as the JAX train step runs it
    topt = optim.AdamW(3e-4, mu_dtype=torch.bfloat16 if mu_dtype else None)
    tparams = params_from_jax(params, "cpu")
    tstate = topt.init(tparams)
    for g in grads:
        updates, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tstate = topt.update_(tparams, optim.tree_leaves(params_from_jax(g, "cpu")), tstate)
    assert tstate.count == 3 and tstate.mu[0].dtype == (torch.bfloat16 if mu_dtype else torch.float32)
    assert_tree_close(tparams, jparams, atol=1e-7)
    jmu, jnu = jstate[0].mu, jstate[0].nu
    for t, j in zip(tstate.nu, jax.tree.leaves(jnu)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-7)
    for t, j in zip(tstate.mu, jax.tree.leaves(jmu)):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=1e-7,
                                   rtol=2**-7 if mu_dtype else 0)


def test_three_train_steps_match_jax():
    """The whole slice: loss, grads, grad norm and AdamW through three steps
    of the port's train step against the JAX build_train_step (ddp over a
    one-device CPU mesh), on the same weights and the same batch every step
    (as lm_train feeds it), with bench.py's optimizer: adamw(3e-4) with a
    bf16 first moment.  (The float32 first moment is held against optax in
    test_adamw_matches_optax.)"""
    mu_dtype = "bfloat16"
    jcfg, tcfg = configs()
    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    tmpl = template_for("ddp", {"data": 1})
    jts = jtrain.build_train_step(
        loss_fn=lambda p, b: jtr.loss_fn(p, b, jcfg, template=tmpl, mesh=mesh),
        init_fn=lambda k: jtr.init_params(k, jcfg),
        axes_tree=jtr.param_axes(jcfg),
        optimizer=optax.adamw(3e-4, mu_dtype=jnp.bfloat16 if mu_dtype else None),
        mesh=mesh,
        template=tmpl,
    )
    key = jax.random.PRNGKey(0)
    jparams, jopt = jts.init(key)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")  # before donation
    batch = batch_np(0)
    jbatch = jts.place_batch({k: jnp.asarray(v) for k, v in batch.items()})

    optimizer = optim.AdamW(3e-4, mu_dtype=torch.bfloat16 if mu_dtype else None)
    tts = build_train_step(loss_fn=lambda p, b: ttr.loss_fn(p, b, tcfg, device="cpu"),
                           init_fn=lambda g: ttr.init_params(tcfg, g), optimizer=optimizer)
    torch_leaves(tparams)
    topt = optimizer.init(tparams)
    tbatch = to_torch(batch)
    for _ in range(3):
        jparams, jopt, jm = jts.step(jparams, jopt, jbatch, key)
        tparams, topt, tm = tts.step(tparams, topt, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert_tree_close(tparams, jparams, atol=1e-5)


def test_train_step_init_and_unported_parallelism():
    _, tcfg = configs()
    ts = build_train_step(loss_fn=None, init_fn=lambda g: ttr.init_params(tcfg, g),
                          optimizer=optim.AdamW(1e-3, mu_dtype=torch.bfloat16))
    params, state = ts.init(torch.Generator().manual_seed(0))
    leaves = optim.tree_leaves(params)
    assert all(p.requires_grad for p in leaves) and state.count == 0
    assert [m.dtype for m in state.mu] == [torch.bfloat16] * len(leaves)
    assert [tuple(n.shape) for n in state.nu] == [tuple(p.shape) for p in leaves]
    two_ranks = SimpleNamespace(size=lambda: 2, rank=lambda: 0)  # a group's stand-in
    # Every strategy is ported (tests/test_torch_gang_step.py,
    # test_torch_pipeline_step.py); a mesh without a template, a custom rule
    # the port does not split and an axis above 1 that the template does not
    # spread over still raise.
    for kw in ({"mesh": build_port_mesh({"data": 2}, groups={"data": two_ranks})},
               {"template": port_template_for("custom", {"tensor": 1},
                                              {"rules": {"head_dim": "tensor"}})},
               {"template": port_template_for("sp_ring", {"sequence": 2, "tensor": 2}),
                "mesh": build_port_mesh({"sequence": 2, "tensor": 2},
                                        groups={"sequence": two_ranks, "tensor": two_ranks})}):
        with pytest.raises(NotImplementedError, match="multi-process and parallelism"):
            build_train_step(loss_fn=None, init_fn=None, optimizer=None, **kw)


SMALL_TRAIN = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128,
                   seq=32, batch=2)


def test_lm_train_logs_loss_then_throughput():
    records = []
    lm_train(Context(params=dict(SMALL_TRAIN, steps=12, device="cpu"), seed=1, records=records))
    metrics = [(r["step"], r["values"]) for r in records if r["kind"] == "metric"]
    assert [s for s, _ in metrics] == [0, 10, 11, 12]
    for _, values in metrics[:3]:
        assert set(values) == {"loss", "grad_norm"} and np.isfinite(values["loss"])
    assert metrics[2][1]["loss"] < metrics[0][1]["loss"]  # the same batch every step
    final = metrics[3][1]
    assert set(final) == {"tokens_per_s", "first_step_s", "step_wall_s", "step_wall_s_p50",
                          "step_wall_s_p95", "step_wall_s_p99"}
    assert final["tokens_per_s"] > 0 and final["first_step_s"] > 0
    assert 0 < final["step_wall_s_p50"] <= final["step_wall_s_p95"] <= final["step_wall_s_p99"]
    assert any("lm_train done: 12 steps" in r["line"] for r in records if r["kind"] == "log")


def test_lm_train_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-absent path; a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_train(Context(params=dict(SMALL_TRAIN), records=[]))


def _run_dirs(tmp_path, uuid="run1"):
    run = tmp_path / "runs" / uuid
    (run / "outputs").mkdir(parents=True)
    return dict(outputs_path=str(run / "outputs"), checkpoints_path=str(run / "checkpoints"))


def _in_subprocess(params, dirs, seed=1, before=""):
    """lm_train in a child process (stdout as JSON lines); returns it done."""
    code = (
        "import signal\n"
        f"{before}\n"
        "from polyaxon_tpu_torch.builtins.trainers import lm_train\n"
        "from polyaxon_tpu_torch.tracking.context import Context\n"
        f"lm_train(Context(params={params!r}, seed={seed}, **{dirs!r}))\n"
    )
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=240)


def _metrics(records):
    """Metric values by step, the records of one step merged."""
    by_step = {}
    for r in records:
        if r["kind"] == "metric":
            by_step.setdefault(r["step"], {}).update(r["values"])
    return by_step


def _logs(records):
    return [r["line"] for r in records if r["kind"] == "log"]


def test_preempted_lm_train_resumes_to_the_uninterrupted_loss(tmp_path):
    """Killed by SIGKILL before step 3 (saves at 0 and 2, step 2's write and
    marker not yet final), resumed in process: the final loss is the
    uninterrupted run's, bit for bit; a second resume has nothing to do."""
    params = dict(SMALL_TRAIN, steps=5, device="cpu")
    whole = []
    lm_train(Context(params=params, seed=1, records=whole))
    dirs = _run_dirs(tmp_path)
    child = _in_subprocess(dict(params, save_every=2, preempt_step=3), dirs)
    assert child.returncode == -signal.SIGKILL, child.stderr
    assert "injecting preemption at step 3 (signal=kill)" in child.stdout
    ckpt_dir = Path(dirs["checkpoints_path"])
    left = latest_complete_step(ckpt_dir)
    assert left == jckpt.latest_complete_step(ckpt_dir) == 0
    assert (Path(dirs["outputs_path"]) / "preempted_p0").read_text() == "3"

    resumed = []
    lm_train(Context(params=dict(params, save_every=2, preempt_step=3), seed=1,
                     records=resumed, **dirs))
    assert f"restored checkpoint at step {left}" in _logs(resumed)
    got, want = _metrics(resumed), _metrics(whole)
    assert got[4]["loss"] == want[4]["loss"] and got[4]["grad_norm"] == want[4]["grad_norm"]
    assert {s for s, v in got.items() if "ckpt_bytes" in v} == {2, 4}
    assert got[5]["ckpt_block_s"] > 0 and latest_complete_step(ckpt_dir) == 4

    again = []
    lm_train(Context(params=dict(params, save_every=2), seed=1, records=again, **dirs))
    assert _logs(again) == ["restored checkpoint at step 4",
                            "lm_train: nothing to do (checkpoint already at end)"]


@pytest.mark.parametrize("handler, rc", [("", -signal.SIGTERM),
                                         ("signal.signal(signal.SIGTERM, lambda *a: None)",
                                          -signal.SIGKILL)],
                         ids=["term", "term-ignored-then-kill"])
def test_preempt_signal_term_then_kill_after_the_grace(tmp_path, handler, rc):
    dirs = _run_dirs(tmp_path)
    params = dict(SMALL_TRAIN, steps=4, device="cpu", preempt_step=1, preempt_signal="term",
                  preempt_grace_s=0.2)
    child = _in_subprocess(params, dirs, before=handler)
    assert child.returncode == rc, child.stderr
    assert "injecting preemption at step 1 (signal=term)" in child.stdout


def test_stall_and_an_earlier_preemption_train_through(tmp_path):
    """With the preemption marker already in outputs/, a resumed attempt
    trains through its preempt_step; the stall sleeps at its step."""
    dirs = _run_dirs(tmp_path)
    (Path(dirs["outputs_path"]) / "preempted_p0").write_text("1")
    records = []
    t0 = time.perf_counter()
    lm_train(Context(params=dict(SMALL_TRAIN, steps=3, device="cpu", preempt_step=1,
                                 stall_at_step=2, stall_s=0.3), seed=1, records=records, **dirs))
    assert time.perf_counter() - t0 >= 0.3
    assert "injecting 0.3s stall at step 2" in _logs(records)
    assert sorted(_metrics(records)) == [0, 2, 3]


@pytest.mark.parametrize("params", [
    {}, {"preempt_step": 0}, {"stall_at_step": 1}, {"stall_at_step": 1, "stall_s": 0.5},
    {"stall_s": 0.5}, {"preempt_step": -1, "stall_at_step": 0, "stall_s": 1},
])
def test_fault_injection_arms_as_the_reference_does(params):
    from polyaxon_tpu.builtins import trainers as jtrainers
    from polyaxon_tpu.tracking import Context as JaxContext
    from polyaxon_tpu_torch.builtins import trainers as ttrainers

    port = ttrainers._fault_injection(Context(params=params, records=[]))
    ref = jtrainers._fault_injection(JaxContext(params=params))
    assert (port is None) == (ref is None)


def test_logged_losses_are_the_loop_losses_in_step_order():
    """lm_train's losses leave the loop through the MetricsDrain: each logged
    value equals the train step's own at that step, and the records come in
    step order before the run's summary."""
    records = []
    lm_train(Context(params=dict(SMALL_TRAIN, steps=12, lr=1e-3, device="cpu"), seed=2,
                     records=records))
    cfg = ttr.TransformerConfig(max_seq=32, **{k: v for k, v in SMALL_TRAIN.items()
                                               if k not in ("seq", "batch")})
    ts = build_train_step(loss_fn=lambda p, b: ttr.loss_fn(p, b, cfg, device="cpu"),
                          init_fn=lambda g: ttr.init_params(cfg, g), optimizer=optim.AdamW(1e-3))
    params, opt = ts.init(torch.Generator().manual_seed(2))
    tok = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (2, 33)))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    losses = []
    for _ in range(12):
        params, opt, m = ts.step(params, opt, batch)
        losses.append((m["loss"].item(), m["grad_norm"].item()))
    logged = [(r["step"], r["values"]) for r in records if r["kind"] == "metric"]
    assert [s for s, _ in logged] == [0, 10, 11, 12]
    for step, values in logged[:3]:
        assert (values["loss"], values["grad_norm"]) == losses[step]


def test_metrics_drain_matches_the_jax_drain():
    """Both drains emit the pushed values as floats in push order and
    surface an emit error at close."""
    from polyaxon_tpu.runtime.pipeline import MetricsDrain as JaxDrain
    from polyaxon_tpu_torch.runtime.pipeline import MetricsDrain

    pushes = [(i, {"loss": np.float32(1.0 / (i + 1)), "n": np.int32(i)}) for i in range(20)]
    seen = {}
    for name, cls, conv in (("jax", JaxDrain, jnp.asarray), ("port", MetricsDrain,
                                                            torch.as_tensor)):
        out = seen[name] = []
        drain = cls(lambda step, vals: out.append((step, vals)), depth=2)
        for step, vals in pushes:
            drain.push(step, {k: conv(v) for k, v in vals.items()})
        drain.close()
        assert drain.last_step == 19 and drain.close_wait_s >= 0

        def boom(step, vals):
            raise KeyError("emit failed")

        broken = cls(boom)
        broken.push(0, {"loss": conv(np.float32(1))})
        with pytest.raises(KeyError, match="emit failed"):
            broken.close()
    assert seen["port"] == seen["jax"]
    assert [s for s, _ in seen["port"]] == list(range(20))


def test_copies_of_step_clock_and_flops_match_the_jax_package():
    assert transformer_flops_per_token(671_000_000, 8, 32, 64, 1024) == \
        jledger.transformer_flops_per_token(671_000_000, 8, 32, 64, 1024)
    clocks = [StepClock(), jprofiling.StepClock()]
    for c in clocks:
        assert c.tick() is None and c.summary() == {}
        c.start()
        assert c.tick() >= 0
        c.add("data_wait_s", 0.5)
        assert set(c.summary()) == {"step_wall_s", "data_wait_s"}
        assert c.summary()["data_wait_s"] == 0.5
