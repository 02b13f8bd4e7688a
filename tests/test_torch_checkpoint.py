"""The port's checkpoint manager (``polyaxon_tpu_torch/runtime/checkpoint.py``)
on the CPU, held against the JAX package's where the two meet.

- The save policy: for each ``(save_interval_steps, steps, max_to_keep)``
  the port's manager and the JAX (orbax) manager, given the same steps,
  save the same ones and leave the same step directories, markers and
  ``latest_step()``.
- The markers: the JAX package's ``latest_complete_step`` (what the control
  plane's remediation calls) reads a directory the port wrote as the port
  does, a torn tail step included.
- The weights: a JAX tree carried over by ``params_from_jax``, saved and
  restored, is the same bits and gives the JAX logits (float32, atol 1e-4,
  the model tests' tolerance).
- State: AdamW with a bf16 first moment round-trips bitwise, ``count``
  included; a save is a copy of the step it was given even when the
  optimizer updates the tensors in place before the write runs.
- The reference's own cases (``tests/test_runtime/test_checkpoint.py``),
  mirrored on torch trees.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import signal
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.runtime import checkpoint as jckpt
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.runtime import checkpoint as tckpt
from polyaxon_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    CheckpointNowService,
    latest_complete_step,
)
from polyaxon_tpu_torch.runtime.optim import AdamW
from polyaxon_tpu_torch.runtime.train import build_train_step

REPO = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=32, d_model=16, n_layers=2, n_heads=4, head_dim=8, d_ff=32, max_seq=8)
TCFG = ttr.TransformerConfig(dtype=torch.float32, **CFG)


def tiny_tree(offset=0.0):
    """Small torch trees: params and an AdamW state over them."""
    params = {"w": torch.arange(8, dtype=torch.float32) + offset, "b": torch.ones(())}
    return params, AdamW(1e-3).init(params)


def tiny_numpy_tree():
    return ({"w": np.arange(8, dtype=np.float32), "b": np.ones((), np.float32)},
            {"mu": np.zeros(8, dtype=np.float32)})


def step_dirs(directory):
    return sorted(int(p.name) for p in Path(directory).iterdir() if p.name.isdigit())


def markers(directory):
    marks = Path(directory) / ".complete"
    return sorted(int(p.name) for p in marks.iterdir() if p.name.isdigit())


def train_step(optimizer=AdamW(1e-2)):
    return build_train_step(loss_fn=lambda p, b: ttr.loss_fn(p, b, TCFG, device="cpu"),
                            init_fn=lambda g: ttr.init_params(TCFG, g), optimizer=optimizer)


def batch(seed=0):
    tok = torch.as_tensor(np.random.default_rng(seed).integers(0, 32, (4, 9)))
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


def assert_trees_equal(a, b):
    fa, fb = tckpt._flatten(a), tckpt._flatten(b)
    assert fa.keys() == fb.keys()
    for path in fa:
        assert fa[path].dtype == fb[path].dtype, path
        assert torch.equal(fa[path], fb[path]), path


# -- the save policy, against the JAX manager --------------------------------


@pytest.mark.parametrize("interval, steps, keep", [(1, 5, 3), (2, 5, 3), (3, 7, 2), (4, 9, 5)])
def test_save_policy_matches_the_jax_manager(tmp_path, interval, steps, keep):
    jmgr = jckpt.CheckpointManager(tmp_path / "jax", save_interval_steps=interval,
                                   max_to_keep=keep)
    tmgr = CheckpointManager(tmp_path / "port", save_interval_steps=interval, max_to_keep=keep)
    jp, jo = tiny_numpy_tree()
    tp, to = tiny_tree()
    jsaved = [jmgr.save(i, jp, jo) for i in range(steps)]
    tsaved = [tmgr.save(i, tp, to) for i in range(steps)]
    jmgr.wait_until_finished()
    tmgr.wait_until_finished()
    assert tsaved == jsaved
    assert step_dirs(tmp_path / "port") == step_dirs(tmp_path / "jax")
    assert markers(tmp_path / "port") == markers(tmp_path / "jax")
    assert tmgr.latest_step() == jmgr.latest_step()
    assert tmgr.saves == sum(jsaved)
    jmgr.close()
    tmgr.close()


# -- the markers, read by the JAX package ------------------------------------


def _kill_mid_save(directory):
    """A process that saves step 0 (fenced), stages step 1, and is SIGKILLed."""
    script = textwrap.dedent(
        """
        import os, signal, sys
        import torch
        from polyaxon_tpu_torch.runtime.checkpoint import CheckpointManager

        params = {"w": torch.arange(8, dtype=torch.float32)}
        opt = {"mu": torch.zeros(8)}
        mgr = CheckpointManager(sys.argv[1])
        mgr.save(0, params, opt, force=True)
        mgr.wait_until_finished()
        mgr.save(1, params, opt, force=True)
        os.kill(os.getpid(), signal.SIGKILL)
        """
    )
    proc = subprocess.run([sys.executable, "-c", script, str(directory)], cwd=REPO, timeout=120)
    assert proc.returncode == -signal.SIGKILL


def _unfinalized_tail(directory):
    """Step 1's files land (the writer finishes) but its owner never fences."""
    params, opt = tiny_tree()
    mgr = CheckpointManager(directory)
    mgr.save(0, params, opt, force=True)
    mgr.wait_until_finished()
    mgr.save(1, params, opt, force=True)
    mgr._inflight.result()
    assert step_dirs(directory) == [0, 1] and markers(directory) == [0]


def _pruned(directory):
    params, opt = tiny_tree()
    mgr = CheckpointManager(directory, max_to_keep=2)
    for step in range(5):
        mgr.save(step, params, opt)
    mgr.close()


@pytest.mark.parametrize("write, want", [(_kill_mid_save, 0), (_unfinalized_tail, 0),
                                         (_pruned, 4)], ids=["killed", "unfinalized", "pruned"])
def test_jax_latest_complete_step_reads_port_directories(tmp_path, write, want):
    directory = tmp_path / "ckpt"
    write(directory)
    assert jckpt.latest_complete_step(directory) == want
    assert latest_complete_step(directory) == want
    mgr = CheckpointManager(directory)
    assert mgr.latest_step() == want
    mgr.close()


# -- weights and state --------------------------------------------------------


def test_jax_weights_round_trip_and_give_the_jax_logits(tmp_path):
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **CFG)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(0, tparams, AdamW(1e-3).init(tparams), force=True)
    template = ttr.init_params(TCFG, torch.Generator().manual_seed(7))
    restored = mgr.restore_params(template)
    mgr.close()
    assert restored["step"] == 0 and restored["params"] is template
    assert_trees_equal(template, tparams)
    tokens = np.random.default_rng(0).integers(0, 32, (2, 8))
    jlogits = np.asarray(jtr.forward(jparams, jnp.asarray(tokens), jcfg))
    tlogits = ttr.forward(template, torch.as_tensor(tokens), TCFG, device="cpu")
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, atol=1e-4)


def test_bf16_mu_adamw_state_round_trips_bitwise(tmp_path):
    ts = train_step(AdamW(1e-2, mu_dtype=torch.bfloat16))
    params, opt = ts.init(torch.Generator().manual_seed(0))
    for _ in range(3):
        params, opt, _ = ts.step(params, opt, batch())
    assert opt.count == 3 and all(m.dtype == torch.bfloat16 for m in opt.mu)
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(2, params, opt, force=True)
    fresh_params, fresh_opt = ts.init(torch.Generator().manual_seed(1))
    restored = mgr.restore(fresh_params, fresh_opt)
    mgr.close()
    assert restored["step"] == 2 and restored["opt_state"].count == 3
    assert_trees_equal(restored["params"], params)
    assert_trees_equal(restored["opt_state"], opt)


def test_a_save_is_the_step_it_was_given_not_the_next(tmp_path, monkeypatch):
    """The optimizer updates params, mu and nu in place: the write, held
    back here until after the next step, must still hold step i."""
    release = threading.Event()
    write = CheckpointManager._write

    def held_write(self, *args):
        assert release.wait(60)
        return write(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", held_write)
    ts = train_step()
    params, opt = ts.init(torch.Generator().manual_seed(0))
    params, opt, _ = ts.step(params, opt, batch())
    before = ({k: v.detach().clone() for k, v in tckpt._flatten(params).items()},
              {k: v.clone() for k, v in tckpt._flatten(opt).items()})
    mgr = CheckpointManager(tmp_path / "ckpt")
    assert mgr.save(1, params, opt)
    params, opt, _ = ts.step(params, opt, batch())  # in place, before the write
    release.set()
    fresh_params, fresh_opt = ts.init(torch.Generator().manual_seed(3))
    restored = mgr.restore(fresh_params, fresh_opt)
    mgr.close()
    assert restored["opt_state"].count == 1
    for tree, want in zip((restored["params"], restored["opt_state"]), before):
        got = tckpt._flatten(tree)
        assert got.keys() == want.keys()
        for path in want:
            assert torch.equal(got[path], want[path]), path
    assert not torch.equal(tckpt._flatten(params)["embed"], before[0]["embed"])


@pytest.mark.parametrize("change, match", [
    (lambda p: p.update(w=torch.zeros(9)), r"'w'.*shape.*\[8\]"),
    (lambda p: p.update(w=torch.zeros(8, dtype=torch.bfloat16)), r"'w'.*bfloat16"),
    (lambda p: p.pop("b"), r"'b' is in step 0 but not in the template"),
    (lambda p: p.update(extra=torch.zeros(2)), r"'extra' is in the template but not in step 0"),
], ids=["shape", "dtype", "missing", "extra"])
def test_restore_onto_another_template_names_the_leaf(tmp_path, change, match):
    params, opt = tiny_tree()
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(0, params, opt, force=True)
    template, _ = tiny_tree()
    change(template)
    with pytest.raises(ValueError, match=match):
        mgr.restore_params(template)
    mgr.close()


def test_nothing_to_restore_and_a_step_saved_twice(tmp_path):
    params, opt = tiny_tree()
    mgr = CheckpointManager(tmp_path / "ckpt", enable_async=False)
    assert mgr.restore(params, opt) is None and mgr.restore_params(params) is None
    assert mgr.save(0, params, opt) and markers(tmp_path / "ckpt") == []
    assert mgr._inflight is None and step_dirs(tmp_path / "ckpt") == [0]  # written in save()
    assert not mgr.save(0, params, opt)  # the policy: not later than step 0
    with pytest.raises(ValueError, match="already exists"):
        mgr.save(0, params, opt, force=True)
    assert mgr.history[0]["step"] == 0 and mgr.history[0]["write_s"] > 0
    assert mgr.history[0]["bytes"] == 3 * (8 + 1) * 4 + 8  # params, mu, nu; the int64 count
    mgr.close()


# -- the reference's cases, mirrored -----------------------------------------


def test_roundtrip_restores_exact_state(tmp_path):
    ts = train_step()
    params, opt = ts.init(torch.Generator().manual_seed(0))
    for _ in range(3):
        params, opt, _ = ts.step(params, opt, batch())
    mgr = CheckpointManager(tmp_path / "ckpt")
    assert mgr.latest_step() is None
    mgr.save(2, params, opt, force=True)
    mgr.wait_until_finished()
    assert mgr.latest_step() == 2
    fresh_params, fresh_opt = ts.init(torch.Generator().manual_seed(1))
    restored = mgr.restore(fresh_params, fresh_opt)
    mgr.close()
    assert restored["step"] == 2
    assert_trees_equal(restored["params"], params)
    assert_trees_equal(restored["opt_state"], opt)


def test_async_save_then_restore_sees_latest_step(tmp_path):
    ts = train_step()
    params, opt = ts.init(torch.Generator().manual_seed(0))
    mgr = CheckpointManager(tmp_path / "ckpt", enable_async=True)
    for step in range(3):
        mgr.save(step, params, opt, force=True)
    # No wait_until_finished here — restore() itself must fence.
    fresh_params, fresh_opt = ts.init(torch.Generator().manual_seed(1))
    restored = mgr.restore(fresh_params, fresh_opt)
    assert restored["step"] == 2
    assert_trees_equal(restored["params"], params)
    assert mgr.saves == 3 and mgr.save_block_s > 0
    mgr.close()


def test_latest_step_fences_inflight_saves(tmp_path):
    params, opt = tiny_tree()
    mgr = CheckpointManager(tmp_path / "ckpt", enable_async=True)
    mgr.save(7, params, opt, force=True)
    assert mgr.latest_step() == 7  # visible without an explicit wait
    mgr.close()


def test_max_to_keep_prunes(tmp_path):
    params, opt = tiny_tree()
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    for step in range(4):
        mgr.save(step, params, opt, force=True)
    mgr.wait_until_finished()
    assert mgr.latest_step() == 3
    assert step_dirs(tmp_path / "ckpt") == [2, 3]
    mgr.close()


def test_latest_complete_step_marked_and_legacy_dirs(tmp_path):
    assert latest_complete_step(tmp_path / "missing") is None
    legacy = tmp_path / "legacy"
    (legacy / "3").mkdir(parents=True)
    (legacy / "7").mkdir()
    assert latest_complete_step(legacy) == 7  # no .complete/: trust the digit dirs
    marked = tmp_path / "marked"
    (marked / "2").mkdir(parents=True)
    (marked / "6").mkdir()
    (marked / ".complete").mkdir()
    (marked / ".complete" / "2").touch()
    assert latest_complete_step(marked) == 2  # step 6 was never finalized
    empty = tmp_path / "empty"
    (empty / ".complete").mkdir(parents=True)
    assert latest_complete_step(empty) is None
    for d in ("legacy", "marked", "empty"):
        assert jckpt.latest_complete_step(tmp_path / d) == latest_complete_step(tmp_path / d)


def test_unfinalized_tail_save_is_skipped_on_restore(tmp_path):
    params, opt = tiny_tree()
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(0, params, opt, force=True)
    mgr.wait_until_finished()  # full fence: step 0's marker is durable
    torn, _ = tiny_tree(offset=1.0)
    mgr.save(1, torn, opt, force=True)
    mgr._inflight.result()  # the write lands; its owner never fences
    assert mgr._pending_marks == {1}
    again = CheckpointManager(tmp_path / "ckpt")
    assert again.latest_step() == 0  # a fresh process must not bless the torn step
    assert latest_complete_step(tmp_path / "ckpt") == 0
    fp, fo = tiny_tree(offset=5.0)
    restored = again.restore(fp, fo)
    assert restored["step"] == 0
    assert torch.equal(restored["params"]["w"], params["w"])
    # The torn step neither blocks its step's next save nor survives it.
    fresh, _ = tiny_tree(offset=2.0)
    assert again.save(1, fresh, opt)
    restored = again.restore(*tiny_tree(offset=5.0))
    assert restored["step"] == 1 and torch.equal(restored["params"]["w"], fresh["w"])
    again.close()


def test_owner_fence_finalizes_its_own_save(tmp_path):
    params, opt = tiny_tree()
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(5, params, opt, force=True)
    mgr.wait_until_finished()
    assert mgr.latest_step() == 5
    assert (tmp_path / "ckpt" / ".complete" / "5").is_file()
    mgr.close()


def test_pruned_step_markers_are_garbage_collected(tmp_path):
    params, opt = tiny_tree()
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    for step in range(4):
        mgr.save(step, params, opt, force=True)
    mgr.wait_until_finished()
    assert markers(tmp_path / "ckpt") == step_dirs(tmp_path / "ckpt") == [2, 3]
    mgr.close()


def test_kill_mid_save_subprocess(tmp_path):
    _kill_mid_save(tmp_path / "ckpt")
    assert latest_complete_step(tmp_path / "ckpt") == 0
    mgr = CheckpointManager(tmp_path / "ckpt")
    assert mgr.latest_step() == 0
    params, opt = tiny_tree()
    assert mgr.save(2, params, opt)  # a torn step's leftovers never block a later save
    assert mgr.latest_step() == 2
    assert not list((tmp_path / "ckpt").glob("*.tmp"))
    mgr.close()


class RecordingAgent:
    """CaptureAgent seam for CheckpointNowService: handler registry +
    command_event recording."""

    def __init__(self):
        self.handlers = {}
        self.events = []

    def register_handler(self, kind, fn):
        self.handlers[kind] = fn

    def command_event(self, uuid, state, message=None, **attrs):
        self.events.append((uuid, state, message, attrs))


def test_pending_command_forces_save_and_acks_step(tmp_path):
    params, opt = tiny_tree()
    mgr = CheckpointManager(tmp_path / "ckpt", save_interval_steps=100)
    agent = RecordingAgent()
    svc = CheckpointNowService(mgr, agent)
    assert svc.maybe_save(0, params, opt) is False  # nothing pending, no IO
    agent.handlers["checkpoint-now"]({"uuid": "u1", "kind": "checkpoint-now"})
    assert svc.maybe_save(3, params, opt) is True
    assert agent.events == [("u1", "complete", None, {"step": 3})]
    assert latest_complete_step(tmp_path / "ckpt") == 3
    assert svc.maybe_save(4, params, opt) is False  # drained
    # A command on a step the interval policy already saved fences that save.
    assert mgr.save(100, params, opt)
    agent.handlers["checkpoint-now"]({"uuid": "u2"})
    assert svc.maybe_save(100, params, opt) is True
    assert agent.events[-1] == ("u2", "complete", None, {"step": 100})
    mgr.close()


def test_save_failure_fails_the_command_not_the_loop():
    class BrokenManager:
        def save(self, *a, **k):
            raise RuntimeError("disk gone")

        def wait_until_finished(self):
            raise RuntimeError("disk gone")

    agent = RecordingAgent()
    svc = CheckpointNowService(BrokenManager(), agent)
    agent.handlers["checkpoint-now"]({"uuid": "u2"})
    params, opt = tiny_tree()
    assert svc.maybe_save(1, params, opt) is False  # the loop survives
    (uuid, state, message, attrs) = agent.events[0]
    assert (uuid, state) == ("u2", "failed")
    assert "disk gone" in message
