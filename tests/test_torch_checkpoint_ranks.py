"""``checkpoint-now`` across the ranks of a template that shards the params
(``runtime/checkpoint.py:GangCheckpointNowService``, wired by
``builtins/trainers.py:_checkpoint_now``), on the CPU.

Two thread ranks over gloo (``tests/torch_gang_ranks.py``) under ``fsdp
{data: 2}`` train the small float32 LM of ``tests/test_torch_pipeline_step.py``
(vocab 64, d 32, 2 layers).  Each process of a gang gets its own copy of the
command (``commands/proc<N>/``); here each rank has its own stand-in for
the capture agent, and a copy is "dropped" by calling the handler the
service registered, at a step chosen per rank.  What is held:

- copies of one command dropped at different steps give one save, at the
  step after the first copy's (the ranks read the count posted a step
  before), and every copy acks ``complete`` with that step (the late copy
  without a second save);
- the saved state restores into one rank bit for bit equal to the
  ``full_state`` the ranks gathered at that step;
- a save that fails on the leader fails the command on every process, and
  training goes on;
- on a template that shards nothing the leader's ``CheckpointNowService``
  serves the command alone, as before.

And end to end, a 2-process ``lm_train`` gang under ``fsdp`` through the
port's spawner and worker (gloo on the CPU): a command file dropped into
each process's mailbox while both stall at a step gives one save, at the
next step, which each process acks ``complete`` on its report channel.

Every run of ranks and the gang have a time limit of their own
(``RANKS_TIMEOUT_S``, ``GANG_TIMEOUT_S``): a rank that waits for a
collective its peer never makes fails the test instead of hanging it.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import time

import numpy as np
import torch

from polyaxon_tpu_torch.builtins.trainers import _checkpoint_now
from polyaxon_tpu_torch.compiler import compile_gang_plan
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.parallel.templates import template_for
from polyaxon_tpu_torch.runtime import optim
from polyaxon_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    CheckpointNowService,
    GangCheckpointNowService,
    latest_complete_step,
)
from polyaxon_tpu_torch.runtime.mesh import build_mesh
from polyaxon_tpu_torch.runtime.train import build_train_step
from polyaxon_tpu_torch.spawner.local import LocalGangSpawner, LocalRun
from polyaxon_tpu_torch.stores.layout import StoreLayout
from tests.torch_gang_ranks import run_mesh_ranks

LM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64, max_seq=16,
          attention_impl="dense")
AXES = {"data": 2}
STEPS = 6
RANKS_TIMEOUT_S = 60.0
GANG_TIMEOUT_S = 90.0


class Agent:
    """The capture agent's two methods the service uses, one per rank."""

    def __init__(self):
        self.handlers, self.events = {}, []

    def register_handler(self, kind, fn):
        self.handlers[kind] = fn

    def command_event(self, uuid, state, message=None, **attrs):
        self.events.append((uuid, state, message, attrs))

    def drop(self, uuid):
        self.handlers["checkpoint-now"]({"kind": "checkpoint-now", "uuid": uuid})


class FailingManager(CheckpointManager):
    def save(self, step, params, opt_state, force=False):
        raise OSError("disk full")


def _step(mesh):
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **LM)
    tmpl = template_for("fsdp" if mesh.size > 1 else "ddp", dict(mesh.shape))
    return build_train_step(
        loss_fn=lambda p, b: ttr.loss_fn(p, b, tcfg, tmpl, mesh, device="cpu"),
        init_fn=lambda g: ttr.init_params(tcfg, torch.Generator().manual_seed(3)),
        optimizer=optim.AdamW(1e-3), mesh=mesh, template=tmpl, axes_tree=ttr.param_axes(tcfg))


def _batch():
    rng = np.random.default_rng(8)
    tok = torch.from_numpy(rng.integers(0, LM["vocab_size"], (4, 17)))
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


def _flat(params, opt_state):
    return ([p.detach().clone() for p in optim.tree_leaves(params)],
            [m.clone() for m in opt_state.mu + opt_state.nu], opt_state.count)


def _train(tmp_path, drops, manager=CheckpointManager):
    """Both ranks train ``STEPS`` steps with the service, ``drops[rank]``
    mapping a step to the uuids dropped on that rank before its end.  Per
    rank: its agent's events, the steps at which a save served a command,
    the whole state gathered at each step, and the leader's save history."""

    def rank_main(mesh, rank):
        ts = _step(mesh)
        params, opt_state = ts.init(torch.Generator())
        ckpt = manager(tmp_path, save_interval_steps=100) if rank == 0 else None
        agent = Agent()
        service = _checkpoint_now(ckpt, lambda *a: None, agent, ts)
        assert isinstance(service, GangCheckpointNowService)
        batch = ts.place_batch(_batch())
        served, states = [], {}
        for step in range(STEPS):
            params, opt_state, _ = ts.step(params, opt_state, batch)
            for uuid in drops[rank].get(step, ()):
                agent.drop(uuid)
            if service.maybe_save(step, params, opt_state):
                served.append(step)
            states[step] = _flat(*ts.full_state(params, opt_state))
        history = None
        if ckpt is not None:
            history = [h["step"] for h in ckpt.history]
            ckpt.close()
        return agent.events, served, states, history

    return run_mesh_ranks(AXES, rank_main, timeout=RANKS_TIMEOUT_S)


def test_copies_dropped_at_different_steps_give_one_save_and_one_acked_step(tmp_path):
    # "a" reaches rank 0 at step 1 and rank 1 at step 3; "b" both at step 4.
    drops = [{1: ["a"], 4: ["b"]}, {3: ["a"], 4: ["b"]}]
    (ev0, served0, states, history), (ev1, served1, _, _) = _train(tmp_path, drops)
    assert history == [2, 5]  # one save a command, the step after its first copy's
    assert served0 == served1 == [2, 5]
    for events in (ev0, ev1):
        assert [(u, s, a) for u, s, _, a in events] == [
            ("a", "complete", {"step": 2}), ("b", "complete", {"step": 5})]
    one = _step(build_mesh({"data": 1}))
    params, opt_state = one.init(torch.Generator())
    manager = CheckpointManager(tmp_path)
    try:
        restored = manager.restore(params, opt_state, step=2)
    finally:
        manager.close()
    got = _flat(restored["params"], restored["opt_state"])
    want = states[2]
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    assert got[2] == want[2]


def test_a_failed_save_fails_the_command_on_every_process(tmp_path):
    drops = [{2: ["c"]}, {2: ["c"], 5: ["c"]}]
    (ev0, served0, states, _), (ev1, served1, _, _) = _train(tmp_path, drops, FailingManager)
    assert served0 == served1 == []
    assert [(u, s) for u, s, _, _ in ev0] == [("c", "failed")]
    assert "disk full" in ev0[0][2]
    assert [(u, s) for u, s, _, _ in ev1] == [("c", "failed"), ("c", "failed")]
    assert sorted(states) == list(range(STEPS))  # training went on


def test_an_unsharded_template_keeps_the_leaders_service(tmp_path):
    ts = _step(build_mesh({"data": 1}))
    assert not ts.sharded
    ckpt = CheckpointManager(tmp_path)
    try:
        agent = Agent()
        assert isinstance(_checkpoint_now(ckpt, lambda *a: None, agent, ts),
                          CheckpointNowService)
        assert _checkpoint_now(None, None, agent, ts) is None  # a non-leader keeps none
        assert _checkpoint_now(ckpt, None, agent, ts) is None  # a run that keeps none
    finally:
        ckpt.close()


def _reports(handle, process_id):
    path = handle.paths.report_file(process_id)
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def test_a_two_process_gang_serves_the_command_with_one_save(tmp_path):
    stall_at, steps = 2, 5
    doc = {
        "kind": "experiment",
        "run": {"entrypoint": "polyaxon_tpu_torch.builtins.trainers:lm_train"},
        "declarations": dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8,
                             d_ff=64, seq=16, batch=4, steps=steps, save_every=100,
                             stall_at_step=stall_at, stall_s=3.0, stall_process=-1),
        "environment": {"seed": 5, "env_vars": {"OMP_NUM_THREADS": "1"},
                        "topology": {"accelerator": "cpu", "num_devices": 2, "num_hosts": 2,
                                     "mesh": {"data": 2}, "strategy": "fsdp"}},
    }
    spawner = LocalGangSpawner(StoreLayout(tmp_path), heartbeat_interval=0.2)
    handle = spawner.start(LocalRun(doc, id=1), compile_gang_plan(doc))
    try:
        deadline = time.monotonic() + GANG_TIMEOUT_S
        while not any("stall at step" in line.get("line", "") for line in _reports(handle, 0)):
            assert time.monotonic() < deadline and not handle.all_exited, handle.poll()
            time.sleep(0.05)
        for pid in (0, 1):  # one copy a process, as the control plane drops them
            box = handle.paths.command_dir(pid)
            (box / "u1.json").write_text(json.dumps({"kind": "checkpoint-now", "uuid": "u1"}))
        while not handle.all_exited:
            assert time.monotonic() < deadline, handle.poll()
            time.sleep(0.1)
    finally:
        spawner.stop(handle, grace=1.0)
    assert handle.poll() == {0: 0, 1: 0}, handle.paths.log_file(1).read_text()[-2000:]
    for pid in (0, 1):
        events = [(r["state"], r.get("step")) for r in _reports(handle, pid)
                  if r["type"] == "command" and r["uuid"] == "u1"]
        assert events == [("acked", None), ("complete", stall_at + 1)], events
    ckpts = handle.paths.checkpoints
    assert sorted(int(p.name) for p in ckpts.iterdir() if p.name.isdigit()) == [0, stall_at + 1]
    assert latest_complete_step(ckpts) == stall_at + 1
