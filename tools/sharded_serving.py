#!/usr/bin/env python3
"""``lm_server`` sharded over one host's cards, against one card's ``lm_server``.

Run from the repository root on a machine with 4 cards:
``python3 tools/sharded_serving.py [--cpu] [strategy ...]``.  For ``tp
{tensor: 4}``, ``tp_dp {data: 2, tensor: 2}``, ``pp {pipeline: 4}`` and
``pp_tp {pipeline: 2, tensor: 2}`` (the strategies named, or all) it launches a ``kind: service`` spec of
``polyaxon_tpu_torch.builtins.services:lm_server`` through
``spawner.local.LocalGangSpawner`` with topology ``h100``, ``num_devices: 4``,
``num_hosts: 1``: one rank process a card, one NCCL world, the mesh's rank 0
serving HTTP and the others following its calls (``serving/engine.py``).
Then a one-card ``lm_server`` of the same spec (``num_devices: 1``).  Each
server gets the same 16 concurrent greedy ``/generate`` requests (distinct
random prompts, so that no prefix is shared and each request's tokens
depend on its prompt alone), and the tool reads ``/v1/stats``: the engine's
``decode_step_s`` p50, the descriptor broadcast's (``mesh_descriptor_s``)
p50, ``steady_state_compiles`` and whether the leader's step family is
captured (``mesh.captured``: under a pipeline the graphs hold the stage hop's
NCCL send and receive and the logits' broadcast); TTFT p50 comes from the
answers' ``ttft_s``.  A server is stopped as the control plane stops a service
(SIGTERM to each process group).

The rule for the tokens is chip_smoke's phase 47's for bf16 (``lm_server``
computes in bf16): a sharded request's tokens equal one card's, or the
first position where they differ is one where one card's top-2 logits lie
within 2^-3 (two rounding orders of the same sums flip only near-ties); the
gap is computed in this process with the same seeded weights on one card.

The model: bench.py's 671M width at its 8 layers (vocab 32768, d 2048, 32
heads of 64, d_ff 8192), random weights from the seed, ``seq`` 1024, 8
slots, 256-token prefill chunks, 64 new tokens a request.  ``--cpu``
rehearses the same ``lm_server`` path at a small width in 4 processes of
this script joined over gloo (``runtime.mesh.mesh_from_world``; the spawner
runs a ``cpu`` plan as one process a host, so the gang is formed here), each
stopping when the tool writes its stop file.  It prints the cards' names and
power limits (``nvidia-smi``), one line per server and, last, a JSON
summary.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

RANKS, SEED, GAP, REQUESTS, TIMEOUT_S = 4, 0, 2.0 ** -3, 16, 900
CASES = (("tp", {"tensor": 4}), ("tp_dp", {"data": 2, "tensor": 2}), ("pp", {"pipeline": 4}),
         ("pp_tp", {"pipeline": 2, "tensor": 2}))
MODEL = {True: dict(vocab_size=256, d_model=64, n_layers=4, n_heads=4, head_dim=16, d_ff=128,
                    seq=128, slots=4, block_size=8, prefill_chunk=32, max_new_tokens=8),
         False: dict(vocab_size=32768, d_model=2048, n_layers=8, n_heads=32, head_dim=64,
                     d_ff=8192, seq=1024, slots=8, block_size=16, prefill_chunk=256,
                     max_new_tokens=64)}
CPU_RANK = "--cpu-rank"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, path, payload=None, timeout=600):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _prompts(model):
    rng = np.random.default_rng(SEED + 47)
    hi = model["seq"] - model["max_new_tokens"]
    return [rng.integers(0, model["vocab_size"], int(n)).tolist()
            for n in rng.integers(hi // 8, hi // 2, REQUESTS)]


def _await_ready(port, alive, deadline):
    while True:
        try:
            if _http(port, "/healthz", timeout=30)["state"] == "ready":
                return
        except OSError:
            pass
        if not alive() or time.monotonic() > deadline:
            raise TimeoutError(f"the server on port {port} did not become ready")
        time.sleep(0.2)


def _traffic(port, model):
    """16 concurrent requests: their tokens and TTFTs, then the stats."""
    prompts = _prompts(model)
    answers = [None] * len(prompts)

    def client(i):
        answers[i] = _http(port, "/generate", {"prompts": [prompts[i]]})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT_S)
    wall = time.perf_counter() - t0
    if any(a is None for a in answers):
        raise RuntimeError("a request did not answer")
    stats = _http(port, "/v1/stats")
    lat = stats.get("latency", {})
    return {
        "tokens": [a["tokens"][0] for a in answers],
        "ttft_s_p50": float(np.median([a["ttft_s"][0] for a in answers])),
        "burst_s": wall,
        "tokens_per_s": len(prompts) * model["max_new_tokens"] / wall,
        "decode_step_s_p50": lat.get("decode_step_s", {}).get("p50"),
        "mesh_descriptor_ms_p50": (1e3 * lat["mesh_descriptor_s"]["p50"]
                                   if "mesh_descriptor_s" in lat else None),
        "steady_state_compiles": stats["steady_state_compiles"],
        "mesh": stats.get("mesh"),
        "kv_pool_bytes": stats["kv_pool_bytes"], "kv_pool_rank_bytes": stats["kv_pool_rank_bytes"],
    }


def _serve_gang(spawner, run_id, model, topology):
    """A ``kind: service`` lm_server gang on the cards: its traffic's
    figures, its processes' return codes after the stop."""
    from polyaxon_tpu_torch.compiler import compile_gang_plan
    from polyaxon_tpu_torch.spawner.local import LocalRun

    port = _free_port()
    spec = {"kind": "service",
            "run": {"entrypoint": "polyaxon_tpu_torch.builtins.services:lm_server"},
            "declarations": dict(model, host="127.0.0.1", service_port=port),
            "environment": {"seed": SEED, "topology": topology}}
    t0 = time.perf_counter()
    handle = spawner.start(LocalRun(spec, id=run_id), compile_gang_plan(spec))
    try:
        _await_ready(port, lambda: all(rc is None for rc in handle.poll().values()),
                     time.monotonic() + TIMEOUT_S)
        ready_s = time.perf_counter() - t0
        out = _traffic(port, model)
    except BaseException:
        for i in handle.processes:
            print(handle.paths.log_file(i).read_text()[-3000:], file=sys.stderr)
        raise
    finally:
        spawner.stop(handle, grace=10.0)
    out.update(launch_to_ready_s=ready_s, processes=len(handle.processes),
               rcs=handle.poll(), stopped_by_sigterm=all(
                   rc == -signal.SIGTERM for rc in handle.poll().values()))
    return out


def _cpu_rank(rank, port, axes_json, strategy, http_port, stop_file) -> int:
    """One rank process of the rehearsal: join a gloo world of RANKS, build
    the mesh and run lm_server until the stop file appears."""
    import datetime

    import torch.distributed as dist

    from polyaxon_tpu_torch.builtins.services import lm_server
    from polyaxon_tpu_torch.runtime.mesh import mesh_from_world
    from polyaxon_tpu_torch.tracking.context import Context

    rank = int(rank)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=RANKS,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        ctx = Context(params=dict(MODEL[True], host="127.0.0.1", service_port=int(http_port),
                                  device="cpu"),
                      process_id=rank, num_processes=RANKS, num_hosts=1,
                      mesh=mesh_from_world(json.loads(axes_json)), strategy=strategy, seed=SEED)

        def watch():
            while not Path(stop_file).exists():
                time.sleep(0.1)
            ctx.stop.set()

        threading.Thread(target=watch, daemon=True).start()
        lm_server(ctx)
    finally:
        dist.destroy_process_group()
    return 0


def _serve_cpu(model, strategy, axes):
    """The rehearsal's gang: RANKS processes of this script over gloo."""
    port, http_port = _free_port(), _free_port()
    stop = Path(tempfile.mkdtemp(prefix="sharded-serving-")) / "stop"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, CPU_RANK, str(r), str(port),
                               json.dumps(axes), strategy, str(http_port), str(stop)], env=env)
             for r in range(RANKS)]
    try:
        t0 = time.perf_counter()
        _await_ready(http_port, lambda: all(p.poll() is None for p in procs),
                     time.monotonic() + TIMEOUT_S)
        out = _traffic(http_port, model)
        out["launch_to_ready_s"] = time.perf_counter() - t0
        stop.touch()
        out["rcs"] = {i: p.wait(timeout=120) for i, p in enumerate(procs)}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out["processes"] = RANKS
    return out


def _first_divergences(model, one, sharded, cpu):
    """Per request whose tokens leave one card's: (its index, the first
    position that differs, one card's top-2 logit gap there)."""
    import torch

    from polyaxon_tpu_torch.models.transformer import TransformerConfig, forward, init_params

    device = "cpu" if cpu else "cuda"
    fields = ("vocab_size", "d_model", "n_layers", "n_heads", "head_dim", "d_ff")
    cfg = TransformerConfig(max_seq=model["seq"], **{k: model[k] for k in fields})
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED))
    out = []
    for i, (prompt, a, b) in enumerate(zip(_prompts(model), one, sharded)):
        pos = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if pos is None:
            continue
        with torch.inference_mode():
            top = forward(params, torch.tensor([prompt + a[:pos]]), cfg,
                          device=device)[0, -1].float().topk(2).values
        out.append((i, pos, float(top[0] - top[1])))
    return out


def main() -> int:
    if sys.argv[1:2] == [CPU_RANK]:
        return _cpu_rank(*sys.argv[2:])
    cpu = "--cpu" in sys.argv[1:]
    named = [a for a in sys.argv[1:] if not a.startswith("--")]
    cases = [(s, axes) for s, axes in CASES if not named or s in named]
    model = MODEL[cpu]
    cards = [] if cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    print("\n".join(cards), flush=True)
    from polyaxon_tpu_torch.spawner.local import LocalGangSpawner
    from polyaxon_tpu_torch.stores.layout import StoreLayout

    spawner = LocalGangSpawner(StoreLayout(Path(tempfile.mkdtemp(prefix="sharded-serving-"))),
                               heartbeat_interval=1.0)
    servers = {}
    for i, (strategy, axes) in enumerate(cases):
        topology = {"accelerator": "h100", "num_devices": RANKS, "num_hosts": 1,
                    "strategy": strategy, "mesh": axes}
        try:
            servers[f"{strategy} {axes}"] = (_serve_cpu(model, strategy, axes) if cpu else
                                             _serve_gang(spawner, i + 1, model, topology))
        except Exception as e:  # the next case still runs; this one fails the tool
            print(f"lm_server {strategy} {axes}: FAILED: {e!r}", flush=True)
            servers[f"{strategy} {axes}"] = {"error": repr(e)}
    if cpu:
        from polyaxon_tpu_torch.builtins.services import lm_server
        from polyaxon_tpu_torch.tracking.context import Context

        port = _free_port()
        ctx = Context(params=dict(model, host="127.0.0.1", service_port=port, device="cpu"),
                      seed=SEED)
        server = threading.Thread(target=lm_server, args=(ctx,), daemon=True)
        server.start()
        try:
            _await_ready(port, server.is_alive, time.monotonic() + TIMEOUT_S)
            one = _traffic(port, model)
        finally:
            ctx.stop.set()
            server.join(timeout=60)
    else:
        one = _serve_gang(spawner, 9, model, {"accelerator": "h100", "num_devices": 1,
                                              "num_hosts": 1})
    ok = True
    for name, got in servers.items():
        if "error" in got:
            ok = False
            continue
        got["divergences"] = _first_divergences(model, one["tokens"], got["tokens"], cpu)
        good = (all(gap <= GAP for _, _, gap in got["divergences"])
                and got["steady_state_compiles"] == 0 and got["mesh"] is not None
                and got["processes"] == RANKS
                and (got["rcs"] == {i: 0 for i in range(RANKS)} if cpu
                     else got["stopped_by_sigterm"]))
        ok = ok and good
        print(f"lm_server {name} on {got['processes']} rank processes "
              f"({'gloo, CPU' if cpu else 'NCCL, one card each'}): ready "
              f"{got['launch_to_ready_s']:.1f} s after launch; {REQUESTS} concurrent requests "
              f"x {model['max_new_tokens']} tokens in {got['burst_s']:.3f} s "
              f"({got['tokens_per_s']:.1f} tokens/s); decode_step_s p50 "
              f"{got['decode_step_s_p50']}, TTFT p50 {got['ttft_s_p50']:.4f} s, descriptor "
              f"ms p50 {got['mesh_descriptor_ms_p50']}, steady_state_compiles "
              f"{got['steady_state_compiles']}, captured {got['mesh'].get('captured')}, stages "
              f"{got['mesh'].get('stages')}, KV pool a rank {got['kv_pool_rank_bytes']} of "
              f"{got['kv_pool_bytes']} B; requests whose tokens leave one card's (index, "
              f"first position, one card's top-2 gap): {got['divergences']} "
              f"({'ok' if good else 'FAILED'})", flush=True)
    print(f"lm_server on one card: decode_step_s p50 {one['decode_step_s_p50']}, TTFT p50 "
          f"{one['ttft_s_p50']:.4f} s, {one['tokens_per_s']:.1f} tokens/s", flush=True)
    for got in servers.values():
        got.pop("tokens", None)
    one.pop("tokens")
    print(json.dumps({"ok": ok, "cards": cards, "gap_bound": GAP, "servers": servers,
                      "one_card": one}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
