#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors across processes on one card,
and whether thread ranks on one card can run a collective inside a backward.

Run from the repository root on a machine with one CUDA card:
``python3 tools/gloo_probe.py``.  It starts 2 processes of itself on the
card, joined over gloo at ``tcp://127.0.0.1:<free port>``; each tries the
list forms (``all_reduce``, ``all_gather``, ``reduce_scatter``,
``all_to_all``) and the tensor forms (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single``) on float32 and bfloat16
CUDA tensors and prints ``RESULT {form/dtype: "ok" or the error}`` with the
wall of one 128 MiB ``all_gather``.  Then, one pair of processes a form
(a form that crashes its process takes no other with it), the
point-to-point forms the pipeline's stage hop could use: ``send`` /
``recv`` paired by rank parity, ``isend`` / ``irecv``, and
``batch_isend_irecv`` of ``P2POp`` s; each prints ``P2P {form/dtype: "ok",
"wrong values" or the error}`` and the wall of one 64 MiB exchange, and the
parent prints each pair's exit codes.  Then 2 threads of the parent, each
with its own ``ProcessGroupGloo`` (20 s timeout), back-propagate through an
autograd function whose backward all-reduces; it prints ``THREADS`` with
each thread's grad sum or error.  The autograd engine runs a CUDA backward
on one thread per device, so both ranks' backward waits land on that
thread: the all-reduce times out.  This is why the port's sharded
strategies run on the card as rank processes (``chip_smoke.py`` phases
34-37), and why the Ulysses swap is an all-gather on gloo
(``polyaxon_tpu_torch/parallel/collectives.py``).
"""

import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time

import torch
import torch.distributed as dist


def child(rank: int, world: int, port: int) -> None:
    """One rank: every collective form on float32 and bfloat16 CUDA tensors."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    torch.cuda.set_device(0)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.full((4, 3), float(rank + 1), device="cuda", dtype=dt)
        forms = {
            "all_reduce": lambda: dist.all_reduce(x.clone()),
            "all_gather": lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(world)], x),
            "reduce_scatter": lambda: dist.reduce_scatter(
                torch.empty_like(x), [x.clone() for _ in range(world)]),
            "all_to_all": lambda: dist.all_to_all(
                [torch.empty_like(x) for _ in range(world)], [x.clone() for _ in range(world)]),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(world * 4, 3, device="cuda", dtype=dt), x),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                torch.empty(2, 3, device="cuda", dtype=dt), x.clone()),
            "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x.clone()),
        }
        for name, fn in forms.items():
            try:
                fn()
                torch.cuda.synchronize()
                out[f"{name}/{dt}"] = "ok"
            except Exception as e:
                out[f"{name}/{dt}"] = f"{type(e).__name__}: {str(e)[:160]}"
    big = torch.ones(32 * 1024 * 1024, device="cuda")  # 128 MiB of float32
    outs = [torch.empty_like(big) for _ in range(world)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    dist.all_gather(outs, big)
    torch.cuda.synchronize()
    out["all_gather_128MB_s"] = time.perf_counter() - t
    print("RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()


P2P_FORMS = ("send_recv", "isend_irecv", "batch_isend_irecv")


def p2p_child(form: str, rank: int, world: int, port: int) -> None:
    """One rank of a pair: ``form`` between ranks 0 and 1 on CUDA tensors,
    each rank sending its tensor and receiving the other's."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    torch.cuda.set_device(0)
    peer = 1 - rank
    out = {}

    def exchange(x, got):
        if form == "send_recv":  # a blocking send before a receive on both would deadlock
            if rank == 0:
                dist.send(x, peer)
                dist.recv(got, peer)
            else:
                dist.recv(got, peer)
                dist.send(x, peer)
        elif form == "isend_irecv":
            works = [dist.isend(x, peer), dist.irecv(got, peer)]
            for w in works:
                w.wait()
        else:
            ops = [dist.P2POp(dist.isend, x, peer), dist.P2POp(dist.irecv, got, peer)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()

    for dt in (torch.float32, torch.bfloat16):
        x = torch.full((4, 3), float(rank + 1), device="cuda", dtype=dt)
        got = torch.zeros_like(x)
        try:
            exchange(x, got)
            torch.cuda.synchronize()
            ok = bool((got == float(peer + 1)).all())
            out[f"{form}/{dt}"] = "ok" if ok else "wrong values"
        except Exception as e:
            out[f"{form}/{dt}"] = f"{type(e).__name__}: {str(e)[:160]}"
        print("P2P " + json.dumps(out), flush=True)
    if all(v == "ok" for v in out.values()):
        big = torch.ones(16 * 1024 * 1024, device="cuda")  # 64 MiB of float32
        got = torch.empty_like(big)
        torch.cuda.synchronize()
        t = time.perf_counter()
        exchange(big, got)
        torch.cuda.synchronize()
        out[f"{form}_64MB_s"] = time.perf_counter() - t
    print("P2P " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def threads_backward() -> dict:
    """Two thread ranks on the card, an all-reduce inside the backward."""
    store = dist.HashStore()
    res = {}

    class AllReduceBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return x.clone()

        @staticmethod
        def backward(ctx, gy):
            gy = gy.contiguous().clone()
            dist.all_reduce(gy, group=ctx.group)
            return gy, None

    def run(rank):
        group = dist.ProcessGroupGloo(dist.PrefixStore("t", store), rank, 2,
                                      datetime.timedelta(seconds=20))
        x = torch.ones(8, device="cuda", requires_grad=True)
        try:
            y = AllReduceBackward.apply(x * 2, group).sum()
            (gx,) = torch.autograd.grad(y, x)
            res[rank] = float(gx.sum())
        except Exception as e:
            res[rank] = f"{type(e).__name__}: {str(e)[:200]}"

    threads = [threading.Thread(target=run, args=(r,), daemon=True) for r in range(2)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    res["alive"] = [th.is_alive() for th in threads]
    res["s"] = time.perf_counter() - t
    return res


def main() -> None:
    if sys.argv[1:2] == ["child"]:
        child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
        return
    if sys.argv[1:2] == ["p2p"]:
        p2p_child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]))
        return
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    port = _free_port()
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, "child", str(r), "2", str(port)])
             for r in range(2)]
    print("rcs", [p.wait(timeout=300) for p in procs], "wall", time.perf_counter() - t,
          flush=True)
    for form in P2P_FORMS:
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, __file__, "p2p", form, str(r), "2", str(port)])
                 for r in range(2)]
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=120))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(f"killed after 120 s: {p.wait()}")
        print(f"P2P {form} rcs {rcs}", flush=True)
    print("THREADS", threads_backward(), flush=True)
    os._exit(0)  # the timed-out gloo threads may still hold the interpreter


if __name__ == "__main__":
    main()
