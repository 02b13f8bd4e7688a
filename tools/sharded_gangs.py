#!/usr/bin/env python3
"""The trainers under each sharded strategy template as gangs of the port's
worker, one process a card over NCCL, against one rank's run.

Run from the repository root on a machine with 4 cards:
``python3 tools/sharded_gangs.py [--cpu] [trainer ...]`` (``--cpu``: 4
processes on the CPU over gloo at small widths, a rehearsal; trainer names,
e.g. ``vit_train``, or trainer and strategy, e.g. ``lm_train:sp_ring``: only
their cases).  For ``lm_train`` under ``ddp``,
``fsdp``, ``tp``, ``tp_dp``, ``ulysses``, ``pp {data: 2, pipeline: 2}``,
``pp_tp {pipeline: 2, tensor: 2}``, ``sp_ring {sequence: 4}`` and ``{data:
2, sequence: 2}`` (at T 8192, batch 2) and, with 4 experts, ``ep {data: 2,
expert: 2}`` and ``pp_tp {pipeline: 2, tensor: 2}`` (one microbatch: the
tokens one rank routes), ``vit_train`` under ``fsdp``, ``tp_dp {data: 2,
tensor: 2}`` and ``pp_tp {pipeline: 2, tensor: 2}``, and ``cnn_train``
under ``fsdp`` and ``tp_dp``, over 4 ranks, it launches a ``kind:
experiment`` spec naming the trainer through
``spawner.local.LocalGangSpawner`` (topology ``h100``, 4 devices on 4
"hosts" of this machine: the worker takes ``cuda:<LOCAL_RANK>`` and NCCL),
waits for every process, and reads the leader's report file: its losses
(the first and the last step's), its done-line (which names the strategy)
and each process's status.  Then each trainer runs in this process on one
card on the same global batch and seed.  Each gang's losses must be within
1e-2 relative of one rank's (bf16: each rank's partial weight grads round
before they are summed) and every process must end ``succeeded``.

One more ``lm_train`` gang under ``fsdp {data: 4}`` keeps checkpoints and
stalls every process at step 2: while they stall, a ``checkpoint-now``
command is written into each process's mailbox, and each process must ack it
``complete`` with step 3 (the ranks read the count posted a step before),
the run's checkpoints holding steps 0 (the interval's) and 3 only.  Last, 4 processes of this script join one
``torch.distributed`` world (NCCL, one card each) and time the flag the
ranks agree on at each step's end under a sharded template: on an idle
card, one int64 all-reduce (max) on the hosts over the gloo group
``runtime.checkpoint.host_group`` makes, and for comparison the same
all-reduce of a card's int64 over NCCL and its host read; then inside the
loop, ``lm_train``'s model and step under ``fsdp {data: 4}``, LOOP_STEPS
steps a run synchronized only at the end (as ``lm_train``'s loop), in
LOOP_ROUNDS rounds of four arms in turn: no agreement,
``GangCheckpointNowService.maybe_save`` after each step (the hosts' flag,
read a step later), the hosts' flag read at once, and the card's int64
all-reduced and read after each step.  It prints the cards' names
and power limits (``nvidia-smi``), one line per gang and, last, a JSON
summary of every gang and of the flag.

The models: bench.py's 671M width cut to 2 layers (vocab 32768, d 2048, 32
heads of 64, d_ff 8192; global batch 8 x 1024), ViT-B/16's widths cut to
2 layers (224 px, patch 16, d 768, 12 heads of 64, d_ff 3072; batch 32)
and the CIFAR-10 guide's CNN (32 px, channels (64, 128, 256); batch 256),
3 steps each on synthetic data.  ``vit_train`` under ``fsdp`` runs three
times: at batch 32, whose fixed batch it fits to a loss near 0 by its 3rd
step; at batch 256 for 2 steps, which one update fits as well; and at batch
32 with lr 1e-5, whose loss stays near its start; under ``tp_dp`` and
``pp_tp`` it runs at lr 1e-5.  A case's overrides apply to its gang and to
its one-rank run; its template options to its gang.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from polyaxon_tpu_torch.builtins import trainers  # noqa: E402
from polyaxon_tpu_torch.compiler import compile_gang_plan  # noqa: E402
from polyaxon_tpu_torch.spawner.local import LocalGangSpawner, LocalRun  # noqa: E402
from polyaxon_tpu_torch.stores.layout import StoreLayout  # noqa: E402
from polyaxon_tpu_torch.tracking.context import Context  # noqa: E402

RANKS, SEED, RTOL, TIMEOUT_S = 4, 0, 1e-2, 600
#: Per trainer, its params on the cards and at the CPU rehearsal's widths.
MODELS = {
    "lm_train": (dict(vocab_size=32768, d_model=2048, n_layers=2, n_heads=32, head_dim=64,
                      d_ff=8192, seq=1024, batch=8, steps=3),
                 dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128,
                      seq=32, batch=8, steps=3)),
    "vit_train": (dict(image_size=224, patch_size=16, d_model=768, n_layers=2, n_heads=12,
                       head_dim=64, d_ff=3072, classes=10, batch=32, steps=3),
                  dict(image_size=16, patch_size=4, d_model=32, n_layers=2, n_heads=2,
                       head_dim=16, d_ff=64, classes=10, batch=16, steps=3)),
    "cnn_train": (dict(image_size=32, channels=[64, 128, 256], classes=10, batch=256, steps=3),
                  dict(image_size=16, channels=[8, 16], classes=10, batch=16, steps=3)),
}
LONG = {"seq": 8192, "batch": 2}
#: checkpoint-now's gang: the step every process stalls at, and for how long.
CKPT_NOW = {"steps": 5, "save_every": 100, "stall_at_step": 2, "stall_s": 6.0,
            "stall_process": -1}
FLAG_RANK, FLAG_REPS = "--flag-rank", 200
#: The agreement's cost in the loop: steps a run, rounds of the three arms.
LOOP_STEPS, LOOP_ROUNDS = 20, 5
#: (trainer, strategy, mesh, overrides of its params[, template options])
CASES = (("lm_train", "ddp", {"data": 4}, {}), ("lm_train", "fsdp", {"data": 4}, {}),
         ("lm_train", "tp", {"tensor": 4}, {}),
         ("lm_train", "tp_dp", {"data": 2, "tensor": 2}, {}),
         ("lm_train", "ulysses", {"sequence": 4}, {}), ("vit_train", "fsdp", {"data": 4}, {}),
         ("vit_train", "fsdp", {"data": 4}, {"batch": 256, "steps": 2}),
         ("vit_train", "fsdp", {"data": 4}, {"lr": 1e-5}),
         ("cnn_train", "fsdp", {"data": 4}, {}),
         ("lm_train", "pp", {"data": 2, "pipeline": 2}, {}),
         ("lm_train", "pp_tp", {"pipeline": 2, "tensor": 2}, {}),
         ("lm_train", "ep", {"data": 2, "expert": 2}, {"n_experts": 4}),
         ("lm_train", "sp_ring", {"sequence": 4}, LONG),
         ("lm_train", "sp_ring", {"data": 2, "sequence": 2}, LONG),
         ("lm_train", "pp_tp", {"pipeline": 2, "tensor": 2}, {"n_experts": 4},
          {"num_microbatches": 1}),
         ("vit_train", "tp_dp", {"data": 2, "tensor": 2}, {"lr": 1e-5}),
         ("vit_train", "pp_tp", {"pipeline": 2, "tensor": 2}, {"lr": 1e-5}),
         ("cnn_train", "tp_dp", {"data": 2, "tensor": 2}, {}),
         ("lm_train", "fsdp", {"data": 4}, CKPT_NOW))


def _reports(handle, process_id):
    path = handle.paths.report_file(process_id)
    text = path.read_text() if path.exists() else ""
    return [json.loads(line) for line in text.split("\n")[:-1]]


def _losses(records):
    return {r["step"]: r["values"]["loss"] for r in records
            if r["kind"] == "metric" and "loss" in r["values"]}


def _drop_checkpoint_now(handle, deadline):
    """Once the leader logs its stall, write a checkpoint-now command into
    every process's mailbox, as the control plane does."""
    while not any("stall at step" in r.get("line", "") for r in _reports(handle, 0)
                  if r["type"] == "log"):
        if time.monotonic() > deadline or handle.all_exited:
            raise TimeoutError(f"checkpoint-now gang: no stall logged: {handle.poll()}")
        time.sleep(0.1)
    for i in range(RANKS):
        box = handle.paths.command_dir(i)
        box.mkdir(parents=True, exist_ok=True)
        (box / "ckpt-now.json").write_text(json.dumps({"kind": "checkpoint-now",
                                                       "uuid": "ckpt-now"}))


def run_gang(spawner, run_id, entry, strategy, mesh, model, accelerator, options):
    spec = {
        "kind": "experiment",
        "run": {"entrypoint": f"polyaxon_tpu_torch.builtins.trainers:{entry}"},
        "declarations": dict(model),
        "environment": {"seed": SEED, "env_vars": {"OMP_NUM_THREADS": "1"},
                        "topology": {"accelerator": accelerator, "num_devices": RANKS,
                                     "num_hosts": RANKS, "mesh": mesh,
                                     "strategy": strategy, "strategy_options": options}},
    }
    t0 = time.perf_counter()
    handle = spawner.start(LocalRun(spec, id=run_id), compile_gang_plan(spec))
    try:
        deadline = time.monotonic() + TIMEOUT_S
        if "stall_at_step" in model:
            _drop_checkpoint_now(handle, deadline)
        while not handle.all_exited:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{strategy} {mesh}: {handle.poll()}")
            time.sleep(0.2)
    finally:
        spawner.stop(handle, grace=1.0)
    wall = time.perf_counter() - t0
    rcs = handle.poll()
    lines = _reports(handle, 0)
    out = {
        "entry": entry, "strategy": strategy, "mesh": mesh, "rcs": rcs, "wall_s": wall,
        "losses": {m["step"]: m["values"]["loss"] for m in lines
                   if m["type"] == "metric" and "loss" in m["values"]},
        "final": [m["values"] for m in lines if m["type"] == "metric"
                  and ("tokens_per_s" in m["values"] or "images_per_s" in m["values"])],
        "done": [m["line"] for m in lines if m["type"] == "log"][-1:],
        "statuses": [[s["status"] for s in _reports(handle, i) if s["type"] == "status"][-1:]
                     for i in range(RANKS)],
    }
    if "stall_at_step" in model:
        out["commands"] = [[[r["state"], r.get("step")] for r in _reports(handle, i)
                            if r["type"] == "command"] for i in range(RANKS)]
        out["checkpoints"] = sorted(int(p.name) for p in handle.paths.checkpoints.iterdir()
                                    if p.name.isdigit())
    failed = [i for i, rc in rcs.items() if rc]
    if failed:
        out["log_tail"] = handle.paths.log_file(failed[0]).read_text()[-3000:]
    return out


def _key(entry, overrides):
    """A one-rank run's key: its trainer and its overrides."""
    return entry + json.dumps(overrides, sort_keys=True)


class _Agent:
    """The capture agent's one method the checkpoint-now service calls when
    nothing is queued."""

    def register_handler(self, kind, fn):
        pass


def _loop_arms(device, cpu):
    """``{arm: a step's wall in ms}``, the median over LOOP_ROUNDS rounds of
    LOOP_STEPS steps of ``lm_train``'s model and step under ``fsdp`` over
    the world, the arms in turn: ``none``, ``service`` (the checkpoint-now
    service's ``maybe_save`` after each step), ``host`` (a CPU int64
    all-reduced over ``host_group``'s group and read at once) and, on the
    cards, ``card`` (a card's int64 all-reduced over NCCL and read)."""
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from polyaxon_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
        loss_fn,
        param_axes,
    )
    from polyaxon_tpu_torch.parallel.templates import template_for
    from polyaxon_tpu_torch.runtime.checkpoint import GangCheckpointNowService, host_group
    from polyaxon_tpu_torch.runtime.mesh import mesh_from_world
    from polyaxon_tpu_torch.runtime.optim import AdamW
    from polyaxon_tpu_torch.runtime.train import build_train_step

    model = MODELS["lm_train"][1 if cpu else 0]
    cfg = TransformerConfig(max_seq=model["seq"], **{
        k: model[k] for k in ("vocab_size", "d_model", "n_layers", "n_heads", "head_dim", "d_ff")})
    mesh = mesh_from_world({"data": RANKS})
    template = template_for("fsdp", dict(mesh.shape))
    ts = build_train_step(
        loss_fn=lambda p, b: loss_fn(p, b, cfg, template=template, mesh=mesh, device=device),
        init_fn=lambda g: init_params(cfg, g), optimizer=AdamW(3e-4), mesh=mesh,
        template=template, axes_tree=param_axes(cfg))
    params, opt_state = ts.init(torch.Generator(device=device).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (model["batch"], model["seq"] + 1)),
                             device=device)
    batch = ts.place_batch({"tokens": tokens[:, :-1], "targets": tokens[:, 1:]})
    service = GangCheckpointNowService(None, _Agent(), ts)
    flags = {"host": (torch.zeros(1, dtype=torch.int64), host_group(dist.group.WORLD)),
             "card": (torch.zeros(1, dtype=torch.int64, device=device), None)}

    def after_step(arm, i):
        if arm == "service":
            service.maybe_save(i, params, opt_state)
        elif arm != "none":
            flag, group = flags[arm]
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
            flag.item()

    arms = ("none", "service", "host") + (() if cpu else ("card",))
    walls = {arm: [] for arm in arms}
    for round_ in range(LOOP_ROUNDS + 1):  # round 0 warms every arm
        for arm in arms:
            if device != "cpu":
                torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(LOOP_STEPS):
                params, opt_state, _ = ts.step(params, opt_state, batch)
                after_step(arm, i)
            if device != "cpu":
                torch.cuda.synchronize()
            if round_:
                walls[arm].append((time.perf_counter() - t) / LOOP_STEPS * 1e3)
    return {arm: statistics.median(w) for arm, w in walls.items()}


def _flag_rank(rank, port, cpu) -> int:
    """One process of the flag's timing: join a world of RANKS (NCCL on
    ``cuda:<rank>``, or gloo on the CPU), time FLAG_REPS all-reduces (max)
    of one int64 on the host over ``host_group``'s group and, on the cards,
    of one int64 on the card over NCCL with its host read, then the three
    arms in the loop (``_loop_arms``); print the means in ms as JSON."""
    import datetime

    import torch
    import torch.distributed as dist

    from polyaxon_tpu_torch.runtime.checkpoint import host_group

    rank = int(rank)
    device = "cpu" if cpu else f"cuda:{rank}"
    if not cpu:
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if cpu else "nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=RANKS, rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        out = {"rank": rank}
        flags = {"host": (torch.zeros(1, dtype=torch.int64), host_group(dist.group.WORLD))}
        if not cpu:
            flags["card"] = (torch.zeros(1, dtype=torch.int64, device=device), None)
        for name, (flag, group) in flags.items():
            for reps in (10, FLAG_REPS):  # the first 10 warm the communicator
                t = time.perf_counter()
                for _ in range(reps):
                    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
                    flag.item()
            out[name] = (time.perf_counter() - t) / FLAG_REPS * 1e3
        out["loop_step_ms"] = _loop_arms(device, cpu)
        print(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def _time_the_flag(cpu):
    """RANKS processes of this script timing the flag (``_flag_rank``):
    their means in ms, by rank."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")  # as the gangs' workers run
    procs = [subprocess.Popen([sys.executable, __file__, FLAG_RANK, str(r), str(port)]
                              + (["--cpu"] if cpu else []),
                              stdout=subprocess.PIPE, text=True, env=env) for r in range(RANKS)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"the flag's processes ended with {[p.returncode for p in procs]}")
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def main() -> int:
    cpu = "--cpu" in sys.argv[1:]
    if sys.argv[1:2] == [FLAG_RANK]:
        return _flag_rank(sys.argv[2], sys.argv[3], cpu)
    only = [a for a in sys.argv[1:] if a != "--cpu"]
    cases = [(*c, {}) if len(c) == 4 else c for c in CASES
             if not only or c[0] in only or f"{c[0]}:{c[1]}" in only]
    cards = [] if cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    print("\n".join(cards), flush=True)
    models = {entry: pair[1 if cpu else 0] for entry, pair in MODELS.items()}
    accelerator = "cpu" if cpu else "h100"
    base = Path(tempfile.mkdtemp(prefix="sharded-gangs-"))
    spawner = LocalGangSpawner(StoreLayout(base), heartbeat_interval=0.5)
    gangs = [dict(run_gang(spawner, i + 1, entry, strategy, mesh,
                           dict(models[entry], **overrides), accelerator, options),
                  overrides=overrides, options=options)
             for i, (entry, strategy, mesh, overrides, options) in enumerate(cases)]
    one_rank = {}
    for entry, _, _, overrides, _ in cases:
        key = _key(entry, overrides)
        if key in one_rank:
            continue
        records = []
        t0 = time.perf_counter()
        getattr(trainers, entry)(Context(
            params=dict(models[entry], **overrides, device="cpu" if cpu else "cuda"),
            seed=SEED, records=records))
        one_rank[key] = {"losses": _losses(records), "s": time.perf_counter() - t0}
    ok = True
    for g in gangs:
        one = one_rank[_key(g["entry"], g["overrides"])]["losses"]
        steps = sorted(one)
        worst = (max(abs(g["losses"][s] - one[s]) / abs(one[s]) for s in steps)
                 if steps and all(s in g["losses"] for s in steps) else None)
        g["max_rel_diff"] = worst
        good = (worst is not None and worst <= RTOL and not any(g["rcs"].values())
                and all(s == ["succeeded"] for s in g["statuses"])
                and g["done"] and f"strategy={g['strategy']}" in g["done"][0])
        if "commands" in g:  # one save the step after the stall's, acked by every process
            at = g["overrides"]["stall_at_step"] + 1
            good = good and g["checkpoints"] == [0, at] and all(
                c == [["acked", None], ["complete", at]] for c in g["commands"])
        ok = ok and good
        print(f"{g['entry']} {g['strategy']} {g['mesh']} {g['overrides']} {g['options']}: "
              f"rcs {g['rcs']}, statuses {g['statuses']}, losses {g['losses']} against one "
              f"rank's {one}: max rel diff {worst}"
              + (f"; checkpoint-now acks {g['commands']}, checkpoints {g['checkpoints']}"
                 if "commands" in g else "")
              + f" ({'ok' if good else 'FAILED'}), {g['wall_s']:.1f} s launch to exit; "
              f"{g['done'][0] if g['done'] else g.get('log_tail', '')}", flush=True)
    flag_ms = _time_the_flag(cpu)
    print(f"the checkpoint-now flag (one int64 all-reduce, max, and its host read), {RANKS} "
          f"ranks ({'gloo on the CPU' if cpu else 'NCCL world, one card a rank'}), idle, ms a "
          f"call by rank: on the hosts over host_group's gloo group "
          f"{[f['host'] for f in flag_ms]}"
          + ("" if cpu else f"; a card's int64 over NCCL {[f['card'] for f in flag_ms]}")
          + f"; in the loop (fsdp, {LOOP_STEPS} steps a run, median of {LOOP_ROUNDS} rounds), "
          f"ms a step by rank: {[f['loop_step_ms'] for f in flag_ms]}", flush=True)
    print(json.dumps({"ok": ok, "cards": cards, "one_rank": one_rank, "gangs": gangs,
                      "checkpoint_now_flag_ms": flag_ms}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
