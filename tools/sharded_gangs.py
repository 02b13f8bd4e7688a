#!/usr/bin/env python3
"""The trainers under each sharded strategy template as gangs of the port's
worker, one process a card over NCCL, against one rank's run.

Run from the repository root on a machine with 4 cards:
``python3 tools/sharded_gangs.py [--cpu] [trainer ...]`` (``--cpu``: 4
processes on the CPU over gloo at small widths, a rehearsal; trainer names,
e.g. ``vit_train``: only their cases).  For ``lm_train`` under ``ddp``,
``fsdp``, ``tp``, ``tp_dp``, ``ulysses``, ``pp {data: 2, pipeline: 2}``,
``pp_tp {pipeline: 2, tensor: 2}`` and, with 4 experts, ``ep {data: 2,
expert: 2}``, and ``vit_train`` and ``cnn_train`` under ``fsdp``, over 4
ranks, it launches a ``kind:
experiment`` spec naming the trainer through
``spawner.local.LocalGangSpawner`` (topology ``h100``, 4 devices on 4
"hosts" of this machine: the worker takes ``cuda:<LOCAL_RANK>`` and NCCL),
waits for every process, and reads the leader's report file: its losses
(steps 0 and 2), its done-line (which names the strategy) and each
process's status.  Then each trainer runs in this process on one card on
the same global batch and seed.  Each gang's losses must be within 1e-2
relative of one rank's (bf16: each rank's partial weight grads round
before they are summed) and every process must end ``succeeded``.  It
prints the cards' names and power limits (``nvidia-smi``), one line per
gang and, last, a JSON summary of every gang.

The models: bench.py's 671M width cut to 2 layers (vocab 32768, d 2048, 32
heads of 64, d_ff 8192; global batch 8 x 1024), ViT-B/16's widths cut to
2 layers (224 px, patch 16, d 768, 12 heads of 64, d_ff 3072; batch 32)
and the CIFAR-10 guide's CNN (32 px, channels (64, 128, 256); batch 256),
3 steps each on synthetic data.  ``vit_train`` runs three times: at batch
32, whose fixed batch it fits to a loss near 0 by its 3rd step; at batch
256 for 2 steps, which one update fits as well; and at batch 32 with lr
1e-5, whose loss stays near its start.  A case's overrides apply to its
gang and to its one-rank run.
"""

from __future__ import annotations

import json
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
#: (trainer, strategy, mesh, overrides of its params)
CASES = (("lm_train", "ddp", {"data": 4}, {}), ("lm_train", "fsdp", {"data": 4}, {}),
         ("lm_train", "tp", {"tensor": 4}, {}),
         ("lm_train", "tp_dp", {"data": 2, "tensor": 2}, {}),
         ("lm_train", "ulysses", {"sequence": 4}, {}), ("vit_train", "fsdp", {"data": 4}, {}),
         ("vit_train", "fsdp", {"data": 4}, {"batch": 256, "steps": 2}),
         ("vit_train", "fsdp", {"data": 4}, {"lr": 1e-5}),
         ("cnn_train", "fsdp", {"data": 4}, {}),
         ("lm_train", "pp", {"data": 2, "pipeline": 2}, {}),
         ("lm_train", "pp_tp", {"pipeline": 2, "tensor": 2}, {}),
         ("lm_train", "ep", {"data": 2, "expert": 2}, {"n_experts": 4}))


def _reports(handle, process_id):
    path = handle.paths.report_file(process_id)
    text = path.read_text() if path.exists() else ""
    return [json.loads(line) for line in text.split("\n")[:-1]]


def _losses(records):
    return {r["step"]: r["values"]["loss"] for r in records
            if r["kind"] == "metric" and "loss" in r["values"]}


def run_gang(spawner, run_id, entry, strategy, mesh, model, accelerator):
    spec = {
        "kind": "experiment",
        "run": {"entrypoint": f"polyaxon_tpu_torch.builtins.trainers:{entry}"},
        "declarations": dict(model),
        "environment": {"seed": SEED, "env_vars": {"OMP_NUM_THREADS": "1"},
                        "topology": {"accelerator": accelerator, "num_devices": RANKS,
                                     "num_hosts": RANKS, "mesh": mesh,
                                     "strategy": strategy}},
    }
    t0 = time.perf_counter()
    handle = spawner.start(LocalRun(spec, id=run_id), compile_gang_plan(spec))
    try:
        deadline = time.monotonic() + TIMEOUT_S
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
    failed = [i for i, rc in rcs.items() if rc]
    if failed:
        out["log_tail"] = handle.paths.log_file(failed[0]).read_text()[-3000:]
    return out


def _key(entry, overrides):
    """A one-rank run's key: its trainer and its overrides."""
    return entry + json.dumps(overrides, sort_keys=True)


def main() -> int:
    cpu = "--cpu" in sys.argv[1:]
    only = [a for a in sys.argv[1:] if a != "--cpu"]
    cases = [c for c in CASES if not only or c[0] in only]
    cards = [] if cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    print("\n".join(cards), flush=True)
    models = {entry: pair[1 if cpu else 0] for entry, pair in MODELS.items()}
    accelerator = "cpu" if cpu else "h100"
    base = Path(tempfile.mkdtemp(prefix="sharded-gangs-"))
    spawner = LocalGangSpawner(StoreLayout(base), heartbeat_interval=0.5)
    gangs = [dict(run_gang(spawner, i + 1, entry, strategy, mesh,
                           dict(models[entry], **overrides), accelerator), overrides=overrides)
             for i, (entry, strategy, mesh, overrides) in enumerate(cases)]
    one_rank = {}
    for entry, _, _, overrides in cases:
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
        ok = ok and good
        print(f"{g['entry']} {g['strategy']} {g['mesh']} {g['overrides']}: rcs {g['rcs']}, "
              f"statuses {g['statuses']}, losses {g['losses']} against one rank's {one}: "
              f"max rel diff {worst} "
              f"({'ok' if good else 'FAILED'}), {g['wall_s']:.1f} s launch to exit; "
              f"{g['done'][0] if g['done'] else g.get('log_tail', '')}", flush=True)
    print(json.dumps({"ok": ok, "cards": cards, "one_rank": one_rank, "gangs": gangs}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
