#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``polyaxon_tpu_torch``) on one CUDA card.

Run from the repository root, on a machine with one NVIDIA Hopper card and
the CUDA toolkit: ``python3 chip_smoke.py``.  It builds the port's kernels
from ``polyaxon_tpu_torch/csrc``, holds each against its plain PyTorch
version, and drives the port's paths at the full width of the 671M bench
model: generation (``lm_generate``: prefill through the flash forward
kernel, then KV-cache decode as one captured CUDA graph replayed once a
token), training (``lm_train``: the flash forward and the two backward
kernels in every layer) and serving (``lm_server``: the continuous-batching
engine over a paged KV pool, whose steps use plain attention and no kernel
of the port, each step shape captured once as a CUDA graph), then long
context: ``lm_train`` at T = 8192 and through the ``sp_ring`` strategy at
T = 16384; then checkpoint, preemption and restore; then the compiled
decode paths against their eager runs; then the engine's KV tiers (the
pinned host tier and the persistent prefix store) and request tracing;
then the serving fleet (replica processes behind the router, failover,
the autoscaler under chaos).  Phases:

1. the card, its power limit, and the toolchain;
2. the kernel build (one ``nvcc`` per source, all started together);
3. each kernel against its plain version on the card, at the shape of the
   path that runs it and at edge shapes, with its time beside the plain
   version's, the PyTorch library call's and its bound: the forward at the
   prefill shape, then the two backward kernels (and the forward) at the
   training shape (bf16 inputs run the tensor-core kernels, float32 inputs
   the FMA kernels);
4. small float32 models: greedy ``generate`` through the kernel gives the
   same tokens as with dense attention, and ``loss_fn`` and every
   parameter grad through the kernels match dense attention; small bf16
   models (head_dim 64 and 128): the grads of ``loss_fn`` through the
   tensor-core kernels match the plain backward after the same forward on
   the card, and the loss and grads match the plain versions on the CPU;
   control runs with dq and with dk scaled by 1.01 fail the card comparison;
5. the serving path: ``lm_generate`` at the 671M width (batch 4, prompt
   512, 64 new tokens, greedy, bf16 compute, random weights from a seed),
   with the kernels' launch counts set to 0 before it and read after;
6. the prefill logits through the kernel against the same forward with
   dense attention;
7. the training path: ``lm_train`` at the 671M width (batch 20, seq 1024,
   5 steps, lr 3e-4, no remat, float32 mu), its launch counts per step,
   tokens/s, MFU and a falling loss, with its tracking wired as a worker
   wires it (a ``Reporter`` on a run dir, the ledger's and the tracer's
   sinks, a ``FlightRecorder``, a ``ResourceSampler``): its final ledger
   row's buckets sum to its wall, its step compute is the loop's
   synchronized wall less checkpoint and drain, its FLOPs the analytic ones,
   its MFU bench.py's, with the card's name, peak and memory; then the same
   run without tracking, with it and without (the overhead, recorded); a
   stalled 2-layer ``lm_train`` under a recorder with a 0.5 s floor (one
   ``stall`` anomaly, a dump naming the card's memory and the fault
   injector's frame); ``TrainPipeline`` with ``device_prefetch`` feeding the
   train step (device batches equal to their host source, the ledger's data
   wait the pipeline's); whether ``CUDAGraph.debug_dump`` writes without
   debug mode; then bench.py's train configuration
   (remat ``save_attn``, bf16 mu) through ``build_train_step`` for 3 steps,
   whose first step must give the same loss and grad norm;
8. where the time goes: device time by kernel over one prefill, over
   decode steps (eager, and one captured step replayed) and over one train
   step (torch.profiler), and the device's idle share;
9. the paged serving engine on small float32 models (MHA and GQA): its
   greedy tokens equal the static ``generate`` on the card with prefix
   reuse, copy-on-write, ``prefill_chunk=8``, speculative decoding and the
   warmup on; with an int8 KV pool, tokens with speculation and prefix reuse
   on equal those with both off;
10. the paged steps at the 671M width in bf16: ``paged_prefill_chunk``'s
    last logits against ``prefill`` with dense attention, and one
    ``paged_decode_step`` against the static ``decode_step`` (min cosine
    and argmax);
11. the serving entry point ``lm_server`` at the 671M width (seq 1024,
    8 slots, 16-token blocks, 256-token prefill chunks, prefix cache on),
    in a thread on a free local port: 16 concurrent ``POST /generate`` of
    64 tokens, 8 of them sharing a 256-token prefix, 2 sampled; then
    ``/v1/stats``, ``/metrics``, no leaked block, and a ``/v1/cancel`` that
    frees its slot; TTFT, queue wait, decode step, tokens/s and peak
    memory; the flash kernels' launch counts over it must stay 0 (the
    paged steps use plain attention, as the reference's do); the engine's
    final ledger row holds the reference's extras, a step per decode step
    and prompt, a token per emitted token; the capture agent's registered
    decode step names a captured graph;
12. where the serving time goes: one paged decode step with 8 live slots
    and one 256-token prefill chunk under torch.profiler;
13. the three kernels at the long-context shapes of phases 14 and 15 (d 64,
    bf16, causal): BH 2 x 32 at T 8192 with the first 8 heads against the
    plain version, BH 1 x 32 at T 16384 with the first and the last head
    against it; each kernel's time beside SDPA's and its bound (by
    operations there);
14. ``lm_train`` at T = 8192, batch 2, through the kernels, then bench.py's
    long-context arm through ``build_train_step`` with the ``ddp``
    template (remat ``save_attn``, float32 mu, 2 warm and 6 timed steps):
    tokens/s, MFU, launches per step, peak memory, a falling loss; and one
    of its steps under torch.profiler;
15. ``lm_train`` with ``strategy="sp_ring"`` on a ``{"sequence": 1}`` mesh
    at T = 16384, batch 1: its first step against the plain path's, its
    forward launches through ``ring_flash_attention``; then bench.py's
    T = 16384 arm (remat ``save_attn``, bf16 mu);
16. the ring's hop functions for 4 ranks as threads of one process on the
    card (bf16; GQA and MHA; d 64 and 128): against the same hops with the
    plain versions swapped in, against whole-sequence plain attention, and
    a control with dk x 1.01 in one hop that must fail;
17. checkpoint, preemption and restore at bench.py's 671M configuration
    (seq 1024, batch 8, float32 params, bf16 compute, ``AdamW(lr)``; a save
    is params, mu and nu, 8.05 GB): 5 steps through ``build_train_step`` in
    process as the reference; ``lm_train`` with ``save_every=2`` in a child
    process, SIGKILLed by its ``preempt_step=3`` (rc -9), with the step dirs
    and markers it left against ``latest_complete_step``; ``lm_train``
    resumed in process from the newest complete step, its launch counts set
    to 0 before it and read after, its final loss against the reference's
    (rtol 1e-6; bitwise equality reported) and a profiler window on its
    last step whose trace must name each kernel once per layer; the save
    blocks, write rates and the weights-only and full restore times;
    ``lm_generate`` and ``lm_server`` with the run as ``target`` (the
    static ``generate``'s and an engine's tokens on the reference's last
    params); a ``profile`` and a ``drain`` command through the capture
    agent's mailbox (a manifest over 4 decode steps, then ``draining`` and a
    typed 503);
18. the serving engine's step family at the 671M width (8 slots, seq 1024,
    256-token chunks, spec_k 4; bf16 and int8 pools), each captured entry
    (the decode step, every chunk bucket, every verify width) against the
    eager step function on a clone of the same pool and inputs: the same
    argmax, logits within 1e-3 of the largest, the pool equal but for the
    trash block; bitwise equality reported;
19. ``generate`` at the 671M width (batch 4, prompt 512, 64 new tokens,
    greedy), captured, against a loop of eager one-token steps: equal
    tokens, and each one's time;
20. one engine decode step of 8 live slots, eager and captured, each under
    torch.profiler: device busy, wall, idle share and host-launched ops (the
    captured step launches one graph);
21. bench.py's loaded arm (24 Poisson arrivals through ``poisson_load``,
    every third a 768-token prompt, 32 new tokens, 8 slots, 128-token
    chunks, prefix cache off, seed 17) at 60% of the capacity the eager
    engine's sequential service time gives, offered to an eager and a
    captured engine: short-request TTFT p50 and p99, the long requests'
    mean TTFT, tokens/s, completions, equal greedy tokens, and no entry
    built after ready;
22. bench.py's serving_kv_offload arm (the loaded arm's prompts at twice
    its calibrated rate, seed 23, a pool of 52 16-token blocks: one long
    span, the trash block and one more), offload off then on, on a bf16
    and an int8 pool, each beside a pool that never fills: offload on
    completes 24 of 24 with 0 sheds, spills and restores blocks, builds no
    entry after ready and gives every request the ample pool's tokens;
    sheds, TTFT p50/p99, tokens/s, parks, blocks moved, the copies' GB/s
    over their events and the host time a spill and a restore hold the
    scheduler; then, on each pool, 4 shared prefixes of 240 tokens served
    in turn for 3 rounds against 41 blocks with the prefix cache on: cold
    prefixes demote to the tier and later hits restore them, each request
    gets the tokens of a pool that never fills;
23. bench.py's serving_warm_boot arm (2 prefixes of 240 tokens, 12
    prompts, 96 blocks, 48 persisted): an incumbent persists on stop, a
    cold and a warm replacement take the same seeded schedule; the warm one
    preloaded blocks, the probe's tokens are equal; TTFT, hit rate, the
    save's and the preload's bytes and seconds;
24. bench.py's trace-overhead arm (16 prompts of 24 tokens, 16 new, 4
    slots, 16 interleaved runs a side on one engine, the garbage collector
    on and its collections counted), in a child process of its own:
    overhead under 3%, waterfalls within 10% of client latency; then
    ``lm_server`` with a ``traceparent``: the
    same trace id back, and ``/v1/trace/<id>`` with ``serving.generate``,
    ``serving.request`` and ``serving.queue_wait``;
25. the serving fleet, bench.py's ``serving_fleet`` arm at the 671M width:
    replica subprocesses (``serving/replica.py``) on the one card, each
    with lm_server's configuration of phase 11 (warmup on), behind a
    ``make_router_handler`` front; 48 requests from 4 shared 256-token
    prefixes, 64 new tokens, a seeded burst at 200 rps to N = 1 and then
    N = 2: each replica's seconds from launch to ready, tokens/s, the
    scale-up ratio (recorded, not gated), completions, hangs, TTFT p99,
    0 captures after ready; one greedy prompt's tokens equal through the
    router, from every replica and from an in-process engine; a merged
    trace with a router and a replica track;
26. on the same two replicas, bench.py's failover arm: 128 new tokens,
    seed 13, one replica SIGKILLed at 30% of the N = 2 wall: no request
    lost, none hung, every completed request the survivor's tokens; the
    router's failovers, retries and ejections; then the dead replica
    reaped, a replacement booted and SIGSTOPped while it serves: ejected,
    re-admitted after SIGCONT, its request completed or typed;
27. bench.py's ``serving_autoscale_chaos`` at the 671M width: one replica of
    2 slots, the router's shedding at 0.8, the autoscaler, a shared prefix
    store; one replica's capacity measured, then 2x, 2x with a kill, 0.8x
    and an idle tail: none lost, a scale-up that succeeded and preloaded
    the store, the kill repaired, back at one replica with target 1; shed
    fractions, decisions, the scale-ups' preloaded blocks and first TTFT.

Any failed check raises, and the script exits non-zero; an atexit hook
SIGKILLs any replica left.  On success its last lines are the serving
figures as JSON (``lm_generate``'s decode rate, ``lm_server``'s, and the
paged profile), the long-context, the checkpoint, the compiled decode and
the KV-tier and tracing figures as JSON, the tracking figures (the
training and serving ledger rows, the overhead, the watchdog, the dataset
path) as JSON, the card's name and power limit,
the kernels' JSON record, the fleet's figures and
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1
at once.
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import json
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no sparsity

# The 671M bench model (bench.py: on-chip config), full width, full depth.
BENCH_MODEL = dict(vocab_size=32768, d_model=2048, n_layers=8, n_heads=32,
                   head_dim=64, d_ff=8192)
BATCH, PROMPT, NEW_TOKENS, SEED = 4, 512, 64, 0
# The 671M bench train shape (bench.py: batch 20, seq 1024) and the steps run.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, BENCH_STEPS, LR = 20, 1024, 5, 3, 3e-4

# bf16 small models, the backward kernels vs the plain backward on the card
# after the same forward kernel: the same GEMMs and the same forward, so
# only the backward kernels differ.  A dq, dk or dv a float32 ulp away can
# round to another bf16 value, and such flips spread through the bf16
# model's backward, so each parameter grad may differ by 5e-3 of its norm;
# dq or dk scaled by 1.01 moves q's or k's projection grad by 1e-2, and must
# fail.
# Against the plain versions on the CPU the whole bf16 model runs on two
# devices (every GEMM output rounds to bf16 on each), so the loss may
# differ by 1e-3 and grads by 2e-2 of their norm there; printed beside: the
# two devices' spread with dense attention, where no kernel runs.
BF16_BWD_GRAD_RTOL = 5e-3
BF16_MODEL_LOSS_ATOL, BF16_MODEL_GRAD_RTOL = 1e-3, 2e-2
# Kernel vs plain version: p is rounded to bf16 before P.V in both, but the
# kernel's online softmax rounds p against a running max that the one-pass
# plain version never sees, so o differs by bf16 rounding of p.
O_ATOL, LSE_ATOL = 2e-2, 1e-3
# Backward kernels vs plain version: both round ds and p to the input type
# at the same places; a float32 difference in summation order can flip one
# bf16 rounding.  Float32 inputs differ by summation order alone.
BWD_ATOL = {torch.bfloat16: 2e-3, torch.float32: 1e-4}
# What the bf16 paths of the three kernels are built from.
FWD_DESIGN = "mma.sync m16n8k16 bf16, cp.async two-stage K/V ring, p in registers"
DQ_DESIGN = ("mma.sync m16n8k16 bf16, q fragments in registers, cp.async two-stage K/V ring, "
             "ds in registers, ds near a bf16 rounding boundary summed again in the plain "
             "order")
DKV_DESIGN = ("mma.sync m16n8k16 bf16, transposed scores, cp.async two-stage q/do ring, "
              "p/ds near a bf16 rounding boundary summed again in the plain order")
# The backward bounds at the training shape, worked from the data sheet
# (bytes moved and FLOPs): attention_bound must reproduce them.
TRAIN_SHAPE_BOUNDS = {"fwd": (422.1e6, None), "dq": (508.6e6, 129.0e9),
                      "dkv": (676.3e6, 172.0e9)}
# lm_server at the 671M width: per-request context, batch slots, KV block
# size, prefill chunk, and tokens generated per request.
SERVE_SEQ, SERVE_SLOTS, SERVE_BLOCK, SERVE_CHUNK, SERVE_NEW = 1024, 8, 16, 256, 64
# Small float32 engine models (head_dim 64, so the static path's prefill
# could take the kernel; both sides run dense attention here).
SMALL_SERVE = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=4, head_dim=64, d_ff=512,
                   max_seq=128)
# Long context, bench.py's long-context arm (bench.py:190-267): lm_train at
# T = 8192, batch 2, then the arm itself (remat save_attn, float32 mu, 2
# warm and 6 timed steps); sp_ring on a one-rank sequence mesh at T = 16384,
# batch 1 (bf16 mu, 2 warm and 4 timed steps).
LONG_SEQ, LONG_BATCH, LONG_STEPS, LONG_WARM, LONG_TIMED = 8192, 2, 4, 2, 6
RING_SEQ, RING_BATCH, RING_STEPS, RING_WARM, RING_TIMED = 16384, 1, 3, 2, 4
# The plain version of a whole [64, 8192, 8192] block needs about 17 GB per
# float32 score tensor, and it keeps several: at the long shapes the kernels
# run on every head and a few heads are held against the plain version on
# those heads (at T 8192 the first LONG_REF_HEADS, 2 GiB a score tensor; at
# T 16384 the first and the last, 2 GiB too).
LONG_REF_HEADS = 8
# The products at the long shape (causal pairs T(T+1)/2, BH 64, d 64):
# attention_bound must give these FLOPs, bound by operations there.
LONG_SHAPE_OPS = {"fwd": 549.8e9, "dq": 824.7e9, "dkv": 1099.6e9}
# The ring's hops for n = 4 ranks as threads of one process on the card:
# (B, T per rank) and (H, Hkv, d) per case, bf16.
RING_RANKS, RING_B, RING_TL = 4, 2, 512
RING_CASES = ((8, 2, 64), (8, 8, 64), (8, 2, 128), (8, 8, 128))
# Tracking (phase 7's ledger, the watchdog, the dataset path): the stalled
# lm_train runs 2 layers of the 671M width for 6 steps with a 3 s stall at step
# 3; the dataset path feeds the 671M train step 6 batches through TrainPipeline.
WD_LAYERS, WD_STEPS, WD_STALL_AT, WD_STALL_S, DATA_STEPS = 2, 6, 3, 3.0, 6
# The utilization ledger's final serving row carries the reference engine's
# extras (polyaxon_tpu/serving/engine.py:1130-1154).
SERVING_EXTRA = ("decode_busy_frac", "slot_occupancy", "decode_utilization", "block_occupancy",
                 "prefix_cache_hit_rate", "prefix_cache_hits", "prefix_cache_misses",
                 "prefix_cache_evictions", "prefix_cache_demotions", "prefix_cache_restores",
                 "parked_sequences", "requests_shed", "host_spilled_blocks_total",
                 "host_restored_blocks_total", "prefill_backlog_chunks", "kv_pool_bytes",
                 "kv_dtype", "spec_proposed_total", "spec_accepted_total", "spec_accept_rate")
# Checkpoint, preemption and restore (phase 17), at bench.py's 671M
# configuration (seq 1024, batch 8): 5 steps, a save every 2, a SIGKILL
# before step 3; lm_generate (batch 2, prompt 128, 16 new tokens) and
# lm_server (4 slots, 16 new tokens, a 4-step capture window) from the run.
CKPT_RUN, CKPT_BATCH, CKPT_STEPS, CKPT_EVERY, CKPT_PREEMPT = "ckpt-run", 8, 5, 2, 3
CKPT_GEN_BATCH, CKPT_PROMPT, CKPT_NEW, CKPT_SLOTS, CKPT_WINDOW = 2, 128, 16, 4, 4
# The compiled decode paths (phases 18-21): the serving engine's step family
# at lm_server's shapes with speculation at spec_k 4; the graph against the
# eager step: the same argmax and logits within GRAPH_ATOL of the largest
# absolute logit (the same kernels on the same inputs; bitwise equality is
# reported).  bench.py's loaded arm (bench.py:1022-1094, its TPU-side sizes):
# 24 requests, every third a 768-token prompt and the rest 16 tokens, 32 new
# tokens each, 8 slots, 128-token chunks, prefix cache off, seed 17, offered
# at 60% of the capacity the eager engine's sequential service time gives.
SPEC_K, GRAPH_ATOL = 4, 1e-3
LOADED_N, LOADED_LONG, LOADED_SHORT, LOADED_NEW, LOADED_CHUNK, LOADED_SEED = 24, 768, 16, 32, 128, 17
LOADED_LOAD = 0.6
# The KV tiers and tracing (phases 22-24), bench.py's arms at its TPU-side
# sizes.  serving_kv_offload (bench.py:1331-1430): the loaded arm's 24
# prompts at 2x its calibrated rate, seed 23, 16-token blocks, a pool of
# one long span plus the trash block and one more.  serving_warm_boot
# (bench.py:1432-1520): 2 prefixes of 240 tokens with 8-token tails, seed
# 47, 12 prompts of 4 new tokens, 96 blocks, 48 persisted, a replacement
# offered 0.6 / the incumbent's service time at seed 31.  The trace-overhead
# arm (bench.py:1997-2090): 16 prompts of 24 tokens, 16 new, 4 slots, the
# budget 3% and the waterfall within 10%; 16 interleaved runs a side where
# bench.py takes 2: on one H100 the walls of these 0.25 s runs spread by
# about 10% with the same work (the host's time to launch each captured
# step varies), and the minimum of 2 a side read from 0 to 8.8% in 24
# repetitions of one phase.
OFFLOAD_BLOCK, OFFLOAD_RATE_X, OFFLOAD_SEED = 16, 2.0, 23
WB_PREFIXES, WB_PREFIX, WB_TAIL, WB_N, WB_NEW, WB_BLOCKS, WB_PERSIST = 2, 240, 8, 12, 4, 96, 48
WB_SEED, WB_LOAD, WB_LOAD_SEED = 47, 0.6, 31
# Demotion under the captured family: 4 prefixes of 240 tokens with 8-token
# tails served one after another for 3 rounds, 8 new tokens, against a pool
# of the trash block and 40 more (each request holds 16, each prefix caches
# 15), so cold prefixes demote to the host tier and later hits restore them.
DM_PREFIXES, DM_PREFIX, DM_TAIL, DM_ROUNDS, DM_NEW, DM_BLOCKS, DM_SEED = 4, 240, 8, 3, 8, 41, 29
TRACE_N, TRACE_PROMPT, TRACE_NEW, TRACE_SLOTS, TRACE_REPS = 16, 24, 16, 4, 16
TRACING_ONLY = "--tracing-phase"
TRACE_BUDGET_PCT, WATERFALL_PCT = 3.0, 10.0
# The serving fleet (phases 25-27): replica subprocesses on the one card, each
# lm_server's phase-11 configuration at the 671M width (SERVE_SEQ, 16-token
# blocks, 256-token chunks, prefix cache on, bf16, warmup on), behind a
# make_router_handler front.  bench.py's serving_fleet arms (bench.py:1682-1860):
# 48 prompts from shared_prefix_prompts (4 groups, a 256-token prefix, a 64-token
# suffix), 64 new tokens, a burst offered at 200 rps with seed 11 to N = 1 and
# N = 2, the router's shedding off; the failover arm: 128 new tokens, seed 13, one
# replica SIGKILLed at 30% of the N = 2 wall (at least 0.5 s).  Two processes
# time-share the card, so the scale-up ratio is recorded, not gated.
FLEET_N, FLEET_PREFIX, FLEET_SUFFIX, FLEET_GROUPS, FLEET_SEED = 48, 256, 64, 4, 11
FLEET_NEW, FLEET_RPS, FAILOVER_NEW, FAILOVER_SEED, STALL_NEW = 64, 200.0, 128, 13, 256
# serving_autoscale_chaos (bench.py:1862-1990): one replica of 2 slots, the
# router's shed_occupancy 0.8, the autoscaler's settings of bench.py:1900-1906, a
# shared prefix store, seed 17.  The rates are multiples of one replica's capacity
# measured here as phase 21 measures it (the sequential service time of 3
# prompts after a warm-up), since a 671M replica serves more than bench.py's 8
# rps; each loaded phase holds the measured boot time plus up_hold_s, the kill
# lands 3 s into the sustained phase, then an idle tail and a settle back to 1.
CHAOS_SLOTS, CHAOS_SHED_OCCUPANCY, CHAOS_SEED, CHAOS_OVER, CHAOS_RECOVER = 2, 0.8, 17, 2.0, 0.8
CHAOS_SCALER = dict(enabled=True, shed_rate=0.25, idle_occupancy=0.3, min_replicas=1,
                    max_replicas=2, up_hold_s=1.0, down_hold_s=1.0, up_cooldown_s=1.0,
                    down_cooldown_s=2.0, budget=8)
CHAOS_KILL_S, CHAOS_IDLE_S, CHAOS_SETTLE_S = 3.0, 6.0, 60.0
KERNEL_NAMES = ("flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel")


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _counts():
    """The kernels' launch counts: (flash_fwd, flash_bwd_dq, flash_bwd_dkv)."""
    from polyaxon_tpu_torch.parallel import flash

    return (flash.flash_block_fwd.launches, flash.flash_block_dq.launches,
            flash.flash_block_dkv.launches)


def _reset_counts() -> None:
    """Set the kernels' launch counts, and the ring's count of forward
    blocks, to 0."""
    from polyaxon_tpu_torch.parallel import flash

    flash.flash_block_fwd.launches = 0
    flash.flash_block_dq.launches = 0
    flash.flash_block_dkv.launches = 0
    flash.ring_flash_fwd.blocks = 0


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def attention_bound(BH, Tq, Tk, d, dtype, causal, kind="fwd"):
    """Least time (ms) the card could take for one flash kernel call, what
    sets it, and the bytes and operations counted: each input byte read
    once and each output written once at the HBM rate, against the
    products over the visible (q, k) pairs at the tensor-core peak for the
    input type.  ``kind``: ``fwd`` reads q, k, v and writes o (f32) and lse
    (two products: q·kᵀ, p·v); ``dq`` reads q, k, v, do, lse, delta and
    writes dq (three: q·kᵀ, do·vᵀ, ds·k); ``dkv`` reads the same and writes
    dk, dv (four: q·kᵀ, do·vᵀ, pᵀ·do, dsᵀ·q)."""
    e = torch.tensor([], dtype=dtype).element_size()
    rows = BH * Tq * 4  # one float32 per query row (lse, delta)
    if kind == "fwd":
        moved, products = BH * (Tq + 2 * Tk) * d * e + BH * Tq * d * 4 + rows, 2
    elif kind == "dq":
        moved, products = BH * 2 * (Tq + Tk) * d * e + 2 * rows + BH * Tq * d * 4, 3
    else:
        moved, products = BH * 2 * (Tq + Tk) * d * e + 2 * rows + 2 * BH * Tk * d * 4, 4
    pairs = sum(min(r + 1, Tk) for r in range(Tq)) if causal else Tq * Tk
    ops = 2 * d * products * pairs * BH
    t_bytes = moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_PEAK_FLOPS[dtype] * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return (*bound, moved, ops)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    from polyaxon_tpu_torch import kernels_available

    avail = kernels_available()
    nvcc = subprocess.run([avail["nvcc"], "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} nvcc {nvcc}")
    return smi


def phase_build():
    from polyaxon_tpu_torch import _build

    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {sorted(reports)} in {time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():  # ptxas -v: one line per instantiation
        lines = report.splitlines()
        usage = [line.split(":", 1)[-1].strip() for line in lines if "registers" in line]
        spills = [line.strip() for line in lines if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
        log(f"  {name}: {usage}; spills: {spills or 'none'}")


def phase_kernels():
    """flash_fwd against its plain version; returns its record (less launches)."""
    from polyaxon_tpu_torch.parallel import flash

    cases = [  # (BH, Tq, Tk, d, dtype, causal): the main path's shape first
        (BATCH * BENCH_MODEL["n_heads"], PROMPT, PROMPT, 64, torch.bfloat16, True),
        (8, 1000, 1000, 64, torch.bfloat16, True),  # ragged tail
        (8, 300, 200, 64, torch.bfloat16, False),  # non-causal, Tq != Tk
        (16, 512, 512, 128, torch.bfloat16, True),  # d = 128
        (8, 129, 129, 64, torch.bfloat16, True),  # one row past a tile edge
        (8, 300, 200, 128, torch.bfloat16, True),  # causal, Tq > Tk
        (4, 100, 100, 64, torch.float32, True),  # float32 inputs
    ]
    record = None
    for BH, Tq, Tk, d, dtype, causal in cases:
        g = torch.Generator(device="cuda").manual_seed(BH + Tq + d)
        q = torch.randn(BH, Tq, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(BH, Tk, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(BH, Tk, d, generator=g, device="cuda").to(dtype)
        scale = d**-0.5
        o, lse = flash.flash_block_fwd(q, k, v, causal=causal, sm_scale=scale)
        torch.cuda.synchronize()
        ro, rlse = flash.flash_block_fwd_reference(q, k, v, causal=causal, sm_scale=scale)
        o_err = (o - ro).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        ok = o_err <= O_ATOL and lse_err <= LSE_ATOL and bool(torch.isfinite(o).all())
        log(f"flash_fwd BH={BH} Tq={Tq} Tk={Tk} d={d} {dtype} causal={causal}: "
            f"o max abs err {o_err:.3e} (<= {O_ATOL}), lse {lse_err:.3e} (<= {LSE_ATOL})")
        if not ok:
            raise AssertionError("flash_fwd disagrees with its plain version")
        if record is None:
            ms = time_ms(lambda: flash.flash_block_fwd(q, k, v, causal=causal, sm_scale=scale))
            plain_ms = time_ms(lambda: flash.flash_block_fwd_reference(
                q, k, v, causal=causal, sm_scale=scale), reps=20)
            B, H = BATCH, BENCH_MODEL["n_heads"]
            q4, k4, v4 = (x.view(B, H, -1, d) for x in (q, k, v))
            library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, scale=scale))
            bound_ms, bound_by, _, _ = attention_bound(BH, Tq, Tk, d, dtype, causal)
            log(f"  kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms (sdpa) "
                f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
            record = {
                "name": "flash_fwd", "route": "cuda", "design": FWD_DESIGN,
                "source": "polyaxon_tpu_torch/csrc/flash_fwd.cu",
                "replaces": "polyaxon_tpu/parallel/flash.py:58",
                "max_abs_err": o_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            }
    return record


def _sdpa_bwd_ms(q, k, v, do, B, causal, scale):
    """SDPA's backward on the same inputs: one autograd call that computes
    dq, dk and dv together."""
    q4, k4, v4 = (x.view(B, -1, *x.shape[1:]).detach().requires_grad_(True) for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                                           scale=scale)
    do4 = do.view(B, -1, *do.shape[1:])
    return time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True),
                   reps=20)


def phase_bwd_kernels():
    """The two backward kernels against their plain version at the training
    shape, then at edge shapes; at the training shape, each kernel's time
    (and the forward kernel's) beside the plain version's, SDPA's and the
    bound.  Returns the records, keyed by kernel."""
    from polyaxon_tpu_torch.parallel import flash

    H = BENCH_MODEL["n_heads"]
    cases = [  # (BH, Tq, Tk, d, dtype, causal): the training path's shape first
        (TRAIN_BATCH * H, TRAIN_SEQ, TRAIN_SEQ, 64, torch.bfloat16, True),
        (8, 1000, 1000, 64, torch.bfloat16, True),  # ragged tail
        (8, 300, 200, 64, torch.bfloat16, False),  # non-causal, Tq != Tk
        (16, 512, 512, 128, torch.bfloat16, True),  # d = 128
        (8, 129, 129, 64, torch.bfloat16, True),  # one row past a tile edge
        (8, 300, 200, 128, torch.bfloat16, True),  # causal, Tq > Tk
        (4, 100, 100, 64, torch.float32, True),  # float32 inputs
        (8, 300, 200, 128, torch.float32, False),  # all the edges at once
    ]
    records = {}
    for BH, Tq, Tk, d, dtype, causal in cases:
        g = torch.Generator(device="cuda").manual_seed(BH + Tq + Tk + d)
        q, do = (torch.randn(BH, Tq, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(BH, Tk, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        kw = dict(causal=causal, sm_scale=d**-0.5)
        o, lse = flash.flash_block_fwd(q, k, v, **kw)
        delta = (do.float() * o.to(dtype).float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        got = (flash.flash_block_dq(*args, **kw), *flash.flash_block_dkv(*args, **kw))
        torch.cuda.synchronize()
        ref = flash.flash_block_bwd_reference(*args, **kw)
        errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        log(f"flash_bwd BH={BH} Tq={Tq} Tk={Tk} d={d} {dtype} causal={causal}: max abs err "
            f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (<= {BWD_ATOL[dtype]}); "
            f"finite {finite}")
        if max(errs) > BWD_ATOL[dtype] or not finite:
            raise AssertionError("a backward kernel disagrees with its plain version")
        if records:
            continue
        del ref
        dq_ms = time_ms(lambda: flash.flash_block_dq(*args, **kw), reps=20)
        dkv_ms = time_ms(lambda: flash.flash_block_dkv(*args, **kw), reps=20)
        fwd_ms = time_ms(lambda: flash.flash_block_fwd(q, k, v, **kw), reps=20)
        plain_ms = time_ms(lambda: flash.flash_block_bwd_reference(*args, **kw), reps=5, warmup=1)
        fwd_plain_ms = time_ms(lambda: flash.flash_block_fwd_reference(q, k, v, **kw), reps=5,
                               warmup=1)
        sdpa_bwd_ms = _sdpa_bwd_ms(q, k, v, do, TRAIN_BATCH, causal, kw["sm_scale"])
        q4, k4, v4 = (x.view(TRAIN_BATCH, H, -1, d) for x in (q, k, v))
        sdpa_fwd_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=kw["sm_scale"]), reps=20)
        bounds = {}
        for kind in ("fwd", "dq", "dkv"):
            bound_ms, bound_by, moved, ops = attention_bound(BH, Tq, Tk, d, dtype, causal, kind)
            want_bytes, want_ops = TRAIN_SHAPE_BOUNDS[kind]
            if abs(moved - want_bytes) > 0.1e6 or (want_ops and abs(ops - want_ops) > 0.1e9):
                raise AssertionError(f"attention_bound({kind}) gives {moved} B, {ops} FLOP; "
                                     f"expected {want_bytes} B, {want_ops} FLOP")
            bounds[kind] = (bound_ms, bound_by)
            log(f"  bound {kind}: {moved / 1e6:.1f} MB, {ops / 1e9:.1f} GFLOP -> "
                f"{bound_ms * 1e3:.1f} us ({bound_by})")
        log(f"  training shape: dq kernel_ms {dq_ms:.4f} (bound_ms {bounds['dq'][0]:.4f}), "
            f"dk/dv kernel_ms {dkv_ms:.4f} (bound_ms {bounds['dkv'][0]:.4f}), fwd kernel_ms "
            f"{fwd_ms:.4f} (bound_ms {bounds['fwd'][0]:.4f}); plain_ms bwd {plain_ms:.4f} fwd "
            f"{fwd_plain_ms:.4f}; library_ms (sdpa) bwd {sdpa_bwd_ms:.4f} fwd {sdpa_fwd_ms:.4f}")
        common = {"route": "cuda", "source": "polyaxon_tpu_torch/csrc/flash_bwd.cu",
                  "plain_ms": plain_ms, "library_ms": sdpa_bwd_ms}
        records["dq"] = dict(name="flash_bwd_dq", design=DQ_DESIGN,
                             replaces="polyaxon_tpu/parallel/flash.py:177",
                             max_abs_err=errs[0], ms=dq_ms, bound_ms=bounds["dq"][0],
                             bound_by=bounds["dq"][1], **common)
        records["dkv"] = dict(name="flash_bwd_dkv", design=DKV_DESIGN,
                              replaces="polyaxon_tpu/parallel/flash.py:219",
                              max_abs_err=max(errs[1:]), ms=dkv_ms, bound_ms=bounds["dkv"][0],
                              bound_by=bounds["dkv"][1], **common)
        records["fwd"] = dict(ms=fwd_ms, plain_ms=fwd_plain_ms, library_ms=sdpa_fwd_ms,
                              bound_ms=bounds["fwd"][0], bound_by=bounds["fwd"][1])
    return records


def phase_small_model():
    """Greedy tokens through the kernel equal those through dense attention
    on a small float32 model (head_dim 64, a ragged 48-token prompt)."""
    from polyaxon_tpu_torch.models import decode
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, forward, init_params

    cfg = TransformerConfig(vocab_size=256, d_model=256, n_layers=2, n_heads=4, head_dim=64,
                            d_ff=512, max_seq=128, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    prompt = torch.randint(0, 256, (2, 48), generator=torch.Generator().manual_seed(2)).cuda()
    outs, logits = {}, {}
    for impl in ("auto", "dense"):
        c = cfg.scaled(attention_impl=impl)
        outs[impl] = decode.generate(params, prompt, c, max_new_tokens=16, device="cuda")
        with torch.inference_mode():
            logits[impl] = forward(params, prompt, c, device="cuda")
    diff = (logits["auto"] - logits["dense"]).abs().max().item()
    log(f"small f32 model: logits max abs diff kernel vs dense {diff:.3e} (<= 1e-3); "
        f"greedy tokens equal: {torch.equal(outs['auto'], outs['dense'])}")
    if diff > 1e-3 or not torch.equal(outs["auto"], outs["dense"]):
        raise AssertionError("small-model generate through the kernel disagrees with dense")


def phase_small_model_grads():
    """Autograd through the kernels: on a small float32 model (head_dim 64,
    a ragged 100-token sequence), the loss and every parameter grad of
    loss_fn with attention_impl "auto" (the three kernels) match "dense"."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params, loss_fn
    from polyaxon_tpu_torch.runtime.optim import tree_leaves

    cfg = TransformerConfig(vocab_size=256, d_model=256, n_layers=2, n_heads=4, head_dim=64,
                            d_ff=512, max_seq=128, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(3))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tok = torch.as_tensor(np.random.default_rng(4).integers(0, 256, (2, 101)), device="cuda")
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    out = {}
    for impl in ("auto", "dense"):
        _reset_counts()
        loss = loss_fn(params, batch, cfg.scaled(attention_impl=impl), device="cuda")
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[impl] = (loss.item(), grads, _counts())
    loss_diff = abs(out["auto"][0] - out["dense"][0])
    grad_diff = max((a - b).abs().max().item() for a, b in zip(out["auto"][1], out["dense"][1]))
    grad_max = max(b.abs().max().item() for b in out["dense"][1])
    log(f"small f32 model loss_fn: loss {out['auto'][0]:.6f} kernel vs dense diff {loss_diff:.3e} "
        f"(<= 1e-5); grads max abs diff {grad_diff:.3e} (<= 1e-5, largest grad {grad_max:.3e}); "
        f"launches fwd/dq/dkv {out['auto'][2]} (expected (2, 2, 2)), dense {out['dense'][2]}")
    if loss_diff > 1e-5 or grad_diff > 1e-5 or out["auto"][2] != (2, 2, 2) or \
            out["dense"][2] != (0, 0, 0):
        raise AssertionError("loss_fn grads through the kernels disagree with dense attention")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.detach().to(device)


@contextlib.contextmanager
def _swapped(**fns):
    """Replace functions of the flash module while the block runs (the
    attention op and its backward look them up by name at each call)."""
    from polyaxon_tpu_torch.parallel import flash

    saved = {name: getattr(flash, name) for name in fns}
    for name, fn in fns.items():
        setattr(flash, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(flash, name, fn)


def phase_small_model_grads_bf16():
    """The bf16 paths under autograd, on small bf16 models (head_dim 64 and
    128, a ragged 100-token sequence), attention_impl "flash" throughout.
    Every parameter grad of loss_fn through the tensor-core kernels matches
    the same forward kernel with the plain backward swapped in on the card
    (so only the backward kernels differ), and, more loosely, the loss and
    grads match the plain versions on the CPU.  Control runs with dq and
    with dk scaled by 1.01 must fail the card comparison: they show the
    limit can see an error of that size in either backward kernel."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params, loss_fn
    from polyaxon_tpu_torch.parallel import flash
    from polyaxon_tpu_torch.runtime.optim import tree_leaves

    real_bwd = flash.flash_block_bwd

    def bwd_with_dq_off_by_one_percent(*args, **kw):
        dq, dk, dv = real_bwd(*args, **kw)
        return dq * 1.01, dk, dv

    def bwd_with_dk_off_by_one_percent(*args, **kw):
        dq, dk, dv = real_bwd(*args, **kw)
        return dq, dk * 1.01, dv

    plain_bwd_on_card = dict(flash_block_bwd=flash.flash_block_bwd_reference)
    runs = (("kernel", "flash", "cuda", {}), ("plain_bwd", "flash", "cuda", plain_bwd_on_card),
            ("fault_dq", "flash", "cuda", dict(flash_block_bwd=bwd_with_dq_off_by_one_percent)),
            ("fault", "flash", "cuda", dict(flash_block_bwd=bwd_with_dk_off_by_one_percent)),
            ("plain", "flash", "cpu", {}), ("dense", "dense", "cpu", {}),
            ("dense_cuda", "dense", "cuda", {}))
    tok = np.random.default_rng(6).integers(0, 256, (2, 101))
    for head_dim, n_heads in ((64, 4), (128, 2)):
        base = TransformerConfig(vocab_size=256, d_model=256, n_layers=2, n_heads=n_heads,
                                 head_dim=head_dim, d_ff=512, max_seq=128, dtype=torch.bfloat16)
        weights = init_params(base, torch.Generator(device="cuda").manual_seed(5))
        out = {}
        for name, impl, device, swap in runs:
            params = _to(weights, device)
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            t = torch.as_tensor(tok, device=device)
            _reset_counts()
            with _swapped(**swap):
                loss = loss_fn(params, {"tokens": t[:, :-1], "targets": t[:, 1:]},
                               base.scaled(attention_impl=impl), device=device)
                grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
            out[name] = (loss.item(), grads, _counts())

        def spread(a, b):
            return (abs(out[a][0] - out[b][0]),
                    max(((x - y).norm() / y.norm()).item() for x, y in zip(out[a][1], out[b][1])))

        _, card_rel = spread("kernel", "plain_bwd")
        _, fault_dq_rel = spread("fault_dq", "plain_bwd")
        _, fault_rel = spread("fault", "plain_bwd")
        loss_diff, grad_rel = spread("kernel", "plain")
        dev_loss, dev_rel = spread("dense_cuda", "dense")
        log(f"small bf16 model head_dim {head_dim}: loss {out['kernel'][0]:.6f}; backward "
            f"kernels vs the plain backward on the card: largest grad error / grad norm "
            f"{card_rel:.3e} (<= {BF16_BWD_GRAD_RTOL}); controls with dq x 1.01: "
            f"{fault_dq_rel:.3e}, dk x 1.01: {fault_rel:.3e} (each > {BF16_BWD_GRAD_RTOL}); "
            f"kernels vs plain on the CPU: loss diff {loss_diff:.3e} "
            f"(<= {BF16_MODEL_LOSS_ATOL}), grads {grad_rel:.3e} (<= {BF16_MODEL_GRAD_RTOL}); "
            f"dense on the card vs the CPU: {dev_loss:.3e}, {dev_rel:.3e}; launches "
            f"fwd/dq/dkv {out['kernel'][2]} (expected (2, 2, 2)), plain backward "
            f"{out['plain_bwd'][2]} (expected (2, 0, 0))")
        if card_rel > BF16_BWD_GRAD_RTOL or loss_diff > BF16_MODEL_LOSS_ATOL or \
                grad_rel > BF16_MODEL_GRAD_RTOL or out["kernel"][2] != (2, 2, 2) or \
                out["plain_bwd"][2] != (2, 0, 0):
            raise AssertionError("bf16 loss_fn grads through the kernels disagree with the "
                                 "plain versions")
        if fault_dq_rel <= BF16_BWD_GRAD_RTOL:
            raise AssertionError("the bf16 grad check does not see dq scaled by 1.01")
        if fault_rel <= BF16_BWD_GRAD_RTOL:
            raise AssertionError("the bf16 grad check does not see dk scaled by 1.01")


def phase_main_path():
    """lm_generate at the 671M width; returns the launch counts of the run
    (fwd, dq, dkv) and its metrics."""
    from polyaxon_tpu_torch.builtins.trainers import lm_generate
    from polyaxon_tpu_torch.tracking.context import Context

    records = []
    ctx = Context(
        params=dict(BENCH_MODEL, seq=1024, batch=BATCH, prompt_len=PROMPT,
                    max_new_tokens=NEW_TOKENS, temperature=0.0, device="cuda"),
        seed=SEED, records=records,
    )
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = lm_generate(ctx)
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    metrics = next(r["values"] for r in records if r["kind"] == "metric")
    for r in records:
        if r["kind"] == "log":
            log(r["line"])
    log(f"lm_generate 671M: prefill_s {metrics['prefill_s']} decode_tokens_per_s "
        f"{metrics['decode_tokens_per_s']} generated {metrics['generated']} "
        f"peak_memory_allocated {peak} B; launches fwd/dq/dkv {launches}")
    # lm_generate runs four prefills (two generate calls, two timed prefills)
    # and no backward.
    want = (4 * BENCH_MODEL["n_layers"], 0, 0)
    if launches != want:
        raise AssertionError(f"expected launches fwd/dq/dkv {want}, got {launches}")
    if tuple(out.shape) != (BATCH, NEW_TOKENS) or int(out.min()) < 0 or \
            int(out.max()) >= BENCH_MODEL["vocab_size"]:
        raise AssertionError(f"bad generated tokens: shape {tuple(out.shape)}")
    return launches, {k: metrics[k] for k in ("prefill_s", "decode_tokens_per_s")}


def phase_prefill_parity():
    """Last-position prefill logits through the kernel vs dense attention, on
    the same weights lm_generate drew (same seed, same device generator)."""
    from polyaxon_tpu_torch.models import decode
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params
    from polyaxon_tpu_torch.parallel import flash

    cfg = TransformerConfig(max_seq=1024, **BENCH_MODEL)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)), device="cuda")
    logits = {}
    for impl in ("auto", "dense"):
        cache = decode.init_cache(cfg, BATCH, PROMPT + NEW_TOKENS, "cuda")
        flash.flash_block_fwd.launches = 0
        logits[impl], _ = decode.prefill(params, prompt, cache, cfg.scaled(attention_impl=impl),
                                         device="cuda")
        torch.cuda.synchronize()
        expected = cfg.n_layers if impl == "auto" else 0
        if flash.flash_block_fwd.launches != expected:
            raise AssertionError(f"{impl} prefill launched flash_fwd "
                                 f"{flash.flash_block_fwd.launches} times, expected {expected}")
    a, b = logits["auto"], logits["dense"]
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
    diff = (a - b).abs().max().item()
    same = torch.equal(a.argmax(-1), b.argmax(-1))
    log(f"prefill logits kernel vs dense: min cosine {cos:.6f} (>= 0.999), max abs diff "
        f"{diff:.4f}, greedy first tokens equal: {same}; finite: {bool(torch.isfinite(a).all())}")
    if cos < 0.999 or not same or not bool(torch.isfinite(a).all()):
        raise AssertionError("prefill through the kernel disagrees with dense attention")
    return params, cfg, prompt


def _profile(label, fn, calls, top=8):
    """Device time by kernel over one call of ``fn`` (torch.profiler), beside
    the same call's wall time taken without the profiler; returns the wall
    time, the device time, the idle share and the device ops per call, or
    None where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, launches, runtime = {}, 0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
            launches += 1
        elif e.name.startswith("cuda"):  # CUDA runtime calls, on the host
            ms, count = runtime.get(e.name, (0.0, 0))
            runtime[e.name] = (ms + e.cpu_time_total / 1e3, count + 1)
    busy_ms = sum(by_name.values())
    if busy_ms == 0:
        log(f"profile {label}: the trace holds no device time (not measured)")
        return None
    idle = max(0.0, 1 - busy_ms / wall_ms)
    log(f"profile {label}: wall_ms {wall_ms:.3f} device_busy_ms {busy_ms:.3f} "
        f"idle_share {idle:.3f} device_ops_per_call {launches / calls:.0f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for i, (name, ms) in enumerate(ranked):  # the largest, and the port's own kernels
        if i < top or "flash_" in name:
            log(f"    {ms:9.3f} ms {ms / busy_ms:6.1%}  {name[:120]}")
    calls_by_time = sorted(runtime.items(), key=lambda kv: -kv[1][0])[:4]
    log("    host, CUDA runtime calls: " + "; ".join(
        f"{name} {ms:.3f} ms x{count}" for name, (ms, count) in calls_by_time))
    # What the host launched onto the card: kernels, graphs, copies, fills.
    host_ops = {name: count for name, (_, count) in runtime.items()
                if name.startswith(("cudaLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset"))}
    syncs = runtime.get("cudaStreamSynchronize", (0.0, 0))[1]
    log(f"    host: {sum(host_ops.values()) / calls:.0f} launched ops and {syncs / calls:g} "
        f"stream syncs a call")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": idle,
            "device_ops_per_call": launches / calls,
            "host_launched_ops_per_call": sum(host_ops.values()) / calls,
            "host_launches": host_ops, "stream_syncs_per_call": syncs / calls}


def phase_profile(params, cfg, prompt, steps: int = 8):
    """Where the serving time goes: one prefill and ``steps`` decode steps
    at the serving path's shapes, as ``generate`` runs them (weights cast
    once, the position a device tensor): eager, then one captured step
    replayed ``steps`` times."""
    from polyaxon_tpu_torch.models import decode

    params = decode.cast_weights(params, cfg)
    cache = decode.init_cache(cfg, BATCH, PROMPT + NEW_TOKENS, "cuda")
    logits, _ = decode.prefill(params, prompt, cache, cfg, device="cuda")
    token = logits.argmax(-1)
    pos = torch.full((), PROMPT, dtype=torch.long, device="cuda")

    def run_prefill():
        decode.prefill(params, prompt, cache, cfg, device="cuda")

    def step():
        return decode.decode_step(params, cache, token, pos, cfg)[0]

    def run_decode():
        for _ in range(steps):
            step()

    graph, _ = decode.capture_step(step)

    def run_captured():
        for _ in range(steps):
            graph.replay()

    _profile("prefill", run_prefill, 1)
    return {"eager": _profile(f"decode x{steps}", run_decode, steps),
            "captured": _profile(f"decode x{steps}, captured", run_captured, steps)}


def _train_setup(cfg, optimizer, batch_size=TRAIN_BATCH, seq=TRAIN_SEQ, template=None,
                 mesh=None):
    """A train step for ``cfg`` on lm_train's weights (seeded init on the
    card) and lm_train's batch, under ``template`` over ``mesh`` if given."""
    from polyaxon_tpu_torch.models.transformer import init_params, loss_fn
    from polyaxon_tpu_torch.runtime.train import build_train_step

    ts = build_train_step(
        loss_fn=lambda p, b: loss_fn(p, b, cfg, template=template, mesh=mesh, device="cuda"),
        init_fn=lambda g: init_params(cfg, g), optimizer=optimizer, mesh=mesh, template=template)
    params, opt_state = ts.init(torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch_size, seq + 1)), device="cuda")
    return ts, params, opt_state, ts.place_batch({"tokens": tok[:, :-1], "targets": tok[:, 1:]})


def _mfu(tokens_per_s, seq):
    """bench.py's MFU: tokens/s x (6N + 12·L·H·hd·T) over the bf16 peak."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig
    from polyaxon_tpu_torch.tracking.ledger import transformer_flops_per_token

    cfg = TransformerConfig(max_seq=seq, **BENCH_MODEL)
    fpt = transformer_flops_per_token(cfg.n_params, cfg.n_layers, cfg.n_heads, cfg.head_dim, seq)
    return tokens_per_s * fpt / H100_PEAK_FLOPS[torch.bfloat16]


def _lm_train(label, seq, batch, steps, strategy="ddp", mesh=None, reporter=None, **params):
    """lm_train at the 671M width, the kernels' counts set to 0 just before
    it and read just after: its loss must be finite (and fall, over more
    than one step) and each kernel must launch once per layer and step.
    ``reporter`` goes on the run's Context.  Returns the launch counts, the
    first step's and the final metrics."""
    from polyaxon_tpu_torch.builtins.trainers import lm_train
    from polyaxon_tpu_torch.tracking.context import Context

    records = []
    ctx = Context(params=dict(BENCH_MODEL, seq=seq, batch=batch, steps=steps, lr=LR,
                              device="cuda", **params),
                  strategy=strategy, mesh=mesh, seed=SEED, records=records, reporter=reporter)
    _free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    lm_train(ctx)
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    for r in records:
        if r["kind"] == "log":
            log(r["line"])
    by_step = {r["step"]: r["values"] for r in records if r["kind"] == "metric"}
    final, first, last = by_step[steps], by_step[0], by_step[steps - 1]
    per_step = tuple(n / steps for n in launches)
    log(f"{label} (batch {batch}, seq {seq}, {steps} steps): tokens_per_s "
        f"{final['tokens_per_s']} mfu {_mfu(final['tokens_per_s'], seq):.4f} first_step_s "
        f"{final['first_step_s']} step_wall_s {final['step_wall_s']} "
        f"peak_memory_allocated {peak} B; loss {first['loss']} -> {last['loss']}, "
        f"grad_norm {first['grad_norm']} -> {last['grad_norm']}; launches fwd/dq/dkv "
        f"{launches}, per step {per_step}")
    n = BENCH_MODEL["n_layers"]
    if per_step != (n, n, n):
        raise AssertionError(f"expected {n} launches of each flash kernel per step, got {per_step}")
    falls = steps == 1 or last["loss"] < first["loss"]
    if not (np.isfinite(first["loss"]) and np.isfinite(last["loss"]) and falls):
        raise AssertionError(f"{label}: the loss is not finite and falling")
    return launches, first, final


@contextlib.contextmanager
def _tracking(run_dir, **recorder):
    """Wire a run's tracking as a worker does: a Reporter on
    ``<run_dir>/reports/proc0.jsonl`` (heartbeat every second), the ledger's
    and the tracer's sinks on it, a FlightRecorder (``recorder`` overrides its
    knobs) and a ResourceSampler (every second); all undone on exit."""
    from polyaxon_tpu_torch.monitor.resources import ResourceSampler
    from polyaxon_tpu_torch.tracking import ledger, trace
    from polyaxon_tpu_torch.tracking.flightrec import FlightRecorder, get_progress
    from polyaxon_tpu_torch.tracking.reporter import Reporter, report_file

    reporter = Reporter(report_file(run_dir, 0))
    ledger.configure(sink=reporter.ledger)
    trace.configure(sink=reporter.span)
    get_progress().reset()
    flight = FlightRecorder(get_progress(), reporter=reporter, out_dir=Path(run_dir) / "reports",
                            **recorder)
    sampler = ResourceSampler(reporter, interval=1.0)
    reporter.start_heartbeat(1.0)
    flight.start()
    sampler.start()
    try:
        yield reporter
    finally:
        sampler.stop()
        flight.stop()
        ledger.configure(sink=None)
        trace.configure(sink=None)
        get_progress().reset()
        reporter.close()


def _report_lines(run_dir):
    from polyaxon_tpu_torch.tracking.reporter import report_file

    return [json.loads(line) for line in report_file(run_dir, 0).read_text().splitlines()]


def _train_flops_per_step(seq, batch, n_layers=None):
    from polyaxon_tpu_torch.models.transformer import TransformerConfig
    from polyaxon_tpu_torch.tracking.ledger import transformer_flops_per_token

    model = dict(BENCH_MODEL, n_layers=n_layers or BENCH_MODEL["n_layers"])
    cfg = TransformerConfig(max_seq=seq, **model)
    return transformer_flops_per_token(cfg.n_params, cfg.n_layers, cfg.n_heads, cfg.head_dim,
                                       seq) * batch * seq


def _check_train_ledger(lines, steps, batch, seq, final):
    """lm_train's final ledger row against the run: its buckets sum to its
    wall (5%, the bound of tests/test_e2e/test_goodput_flow.py), its step
    compute is the loop's synchronized wall less checkpoint and drain (5%),
    its FLOPs are steps x the analytic FLOPs a step, its MFU over the loop's
    wall is bench.py's (_mfu, 5%), the card's name, peak and memory."""
    rows = [e for e in lines if e["type"] == "ledger"]
    finals = [e for e in rows if e["final"]]
    if len(finals) != 1:
        raise AssertionError(f"lm_train: {len(finals)} final ledger rows in {len(rows)}")
    row = finals[0]
    b = row["buckets"]
    loop_wall = steps * batch * seq / final["tokens_per_s"]
    want_compute = loop_wall - b["ckpt_block_s"] - b["metric_drain_s"]
    in_band = row["mfu"] * row["wall_s"] / loop_wall
    bench = _mfu(final["tokens_per_s"], seq)
    kind = torch.cuda.get_device_name(0)
    out = {
        "wall_s": row["wall_s"], "buckets": b, "buckets_sum_s": sum(b.values()),
        "loop_wall_s": loop_wall, "goodput": row["goodput"], "mfu": row["mfu"],
        "mfu_over_loop_wall": in_band, "bench_mfu": bench, "flops": row["flops"],
        "steps": row["steps"], "tokens": row["tokens"], "hbm_peak_bytes": row["hbm_peak_bytes"],
        "device_kind": row["device_kind"], "peak_flops_per_s": row["peak_flops_per_s"],
        "compile_events": row["compile_events"], "compile_cache_hits": row["compile_cache_hits"],
        "ledger_rows": len(rows),
        "lines": {t: sum(e["type"] == t for e in lines)
                  for t in ("metric", "log", "span", "progress", "heartbeat", "resources",
                            "anomaly")},
    }
    log(f"lm_train ledger: {out}")
    if abs(out["buckets_sum_s"] - row["wall_s"]) > 0.05 * row["wall_s"]:
        raise AssertionError("the ledger's buckets do not sum to its wall")
    if abs(b["step_compute_s"] - want_compute) > 0.05 * want_compute:
        raise AssertionError(f"step_compute_s {b['step_compute_s']} is not the loop's "
                             f"synchronized wall less checkpoint and drain {want_compute}")
    if not np.isclose(row["flops"], steps * _train_flops_per_step(seq, batch), rtol=1e-9):
        raise AssertionError("the ledger's FLOPs are not steps x the analytic FLOPs a step")
    if abs(in_band - bench) > 0.05 * bench:
        raise AssertionError(f"the ledger's MFU over the loop wall {in_band} is not _mfu {bench}")
    if row["device_kind"] != kind or row["devices"] != 1 or (
            kind == "NVIDIA H100 80GB HBM3" and row["peak_flops_per_s"] != 989e12):
        raise AssertionError(f"the ledger's device: {row['device_kind']}, "
                             f"{row['peak_flops_per_s']}")
    if not row["hbm_peak_bytes"] > 0 or not out["lines"]["progress"] or \
            not out["lines"]["span"]:
        raise AssertionError("the ledger saw no card memory, or no progress or span line")
    return out


def phase_train():
    """The training path: lm_train at the 671M width, its tracking wired as
    a worker wires it, and its final ledger row checked against the run.
    Returns the launch counts of the run, the first step's metrics and the
    ledger's figures."""
    run_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        with _tracking(run_dir) as reporter:
            launches, first, final = _lm_train("lm_train 671M", TRAIN_SEQ, TRAIN_BATCH,
                                               TRAIN_STEPS, reporter=reporter)
        ledger = _check_train_ledger(_report_lines(run_dir), TRAIN_STEPS, TRAIN_BATCH,
                                     TRAIN_SEQ, final)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    ledger["tokens_per_s"] = final["tokens_per_s"]
    return launches, first, ledger


def phase_tracking_overhead():
    """lm_train at the 671M width as phase 7 ran it, in turns without and
    with the reporter, the ledger's sink, the recorder and the sampler
    (three pairs, each side first in turn): tokens/s of each and the
    overhead of the medians (recorded, not gated: on one H100 the rate at
    T 1024 has spread from 58k to 78k tokens/s across calls without any
    tracking)."""
    rates = {"wired": [], "unwired": []}
    for wired in (False, True, True, False, False, True):
        _free()
        if wired:
            run_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_overhead_"))
            try:
                with _tracking(run_dir) as reporter:
                    _, _, final = _lm_train("lm_train 671M, tracking wired", TRAIN_SEQ,
                                            TRAIN_BATCH, TRAIN_STEPS, reporter=reporter)
            finally:
                shutil.rmtree(run_dir, ignore_errors=True)
        else:
            _, _, final = _lm_train("lm_train 671M, no tracking", TRAIN_SEQ, TRAIN_BATCH,
                                    TRAIN_STEPS)
        rates["wired" if wired else "unwired"].append(final["tokens_per_s"])
    out = {"tokens_per_s": rates,
           "overhead_pct": 100.0 * (1 - statistics.median(rates["wired"]) /
                                    statistics.median(rates["unwired"]))}
    log(f"tracking overhead at T {TRAIN_SEQ}: {out}")
    return out


def phase_watchdog():
    """A stalled lm_train on the card (2 layers of the 671M width, a 3 s stall
    at step 3) under a FlightRecorder with a 0.5 s floor polling every 0.1 s:
    exactly one stall anomaly, its dump flightrec-0-1.json with the card's
    memory and the main thread's stack inside the fault injector."""
    import inspect

    from polyaxon_tpu_torch.builtins import trainers
    from polyaxon_tpu_torch.tracking.context import Context

    run_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_watchdog_"))
    try:
        with _tracking(run_dir, floor_s=0.5, interval_s=0.1) as reporter:
            trainers.lm_train(Context(
                params=dict(BENCH_MODEL, n_layers=WD_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                            steps=WD_STEPS, lr=LR, stall_at_step=WD_STALL_AT,
                            stall_s=WD_STALL_S, device="cuda"),
                seed=SEED, reporter=reporter, records=[]))
        lines = _report_lines(run_dir)
        dump = run_dir / "reports" / "flightrec-0-1.json"
        doc = json.loads(dump.read_text()) if dump.exists() else {}
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    anomalies = [e for e in lines if e["type"] == "anomaly"]
    main = "".join(next((v for k, v in doc.get("threads", {}).items()
                         if k.startswith("MainThread")), []))
    src, first = inspect.getsourcelines(trainers._fault_injection)
    frames = [int(ln.split("line ")[1].split(",")[0]) for ln in main.splitlines()
              if "trainers.py" in ln and "in on_step" in ln]
    card = f"sys/hbm{torch.cuda.current_device()}_mb"
    out = {"anomalies": [(e["kind"], e.get("step"), e.get("dump_artifact")) for e in anomalies],
           "devices": doc.get("devices"),
           "time_to_dump_s": doc["ts"] - doc["progress"]["last_beat_at"] if doc else None,
           "deadline_s": anomalies[0].get("deadline_s") if anomalies else None,
           "on_step_lines": frames, "fault_injection_lines": [first, first + len(src) - 1]}
    log(f"watchdog: {out}")
    if [e["kind"] for e in anomalies] != ["stall"] or not doc:
        raise AssertionError(f"the stalled lm_train did not leave one stall and its dump: {out}")
    if not doc["devices"].get(card, 0) > 0:
        raise AssertionError(f"the dump does not name the card's memory ({card}): {out}")
    if not any(first <= n < first + len(src) for n in frames):
        raise AssertionError(f"no stack of the dump is inside _fault_injection: {main[-2000:]}")
    if not 0.5 <= out["time_to_dump_s"] < WD_STALL_S:
        raise AssertionError(f"the dump came {out['time_to_dump_s']} s after the last beat")
    return out


def phase_dataset_path():
    """TrainPipeline over synthetic_token_batches, placed on the card through
    device_prefetch (pinned buffers, a copy stream), feeding the 671M train
    step for DATA_STEPS steps with the ledger fed as the reference's image
    trainer feeds it: every device batch equals its host source, as every
    batch of the synchronous pipeline (prefetch=0) does; the ledger's
    data_wait_s is the sum of the pipeline's pop_data_wait_s; the loss is
    finite."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig
    from polyaxon_tpu_torch.runtime.data import synthetic_token_batches
    from polyaxon_tpu_torch.runtime.optim import AdamW
    from polyaxon_tpu_torch.runtime.pipeline import TrainPipeline
    from polyaxon_tpu_torch.tracking.ledger import get_ledger

    V = BENCH_MODEL["vocab_size"]

    def host():
        return synthetic_token_batches(vocab_size=V, global_batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                       seed=SEED)

    want = [b for _, b in zip(range(DATA_STEPS), host())]
    cfg = TransformerConfig(max_seq=TRAIN_SEQ, **BENCH_MODEL)
    ts, params, opt_state, _ = _train_setup(cfg, AdamW(LR))
    rows = []
    led = get_ledger()
    led.configure(sink=rows.append)
    try:
        led.start(source="train", device="cuda")
        led.set_flops_per_step(_train_flops_per_step(TRAIN_SEQ, TRAIN_BATCH))
        got, waits, walls, losses = [], [], [], []
        with TrainPipeline(host(), "cuda", prefetch=2, tasks=False) as pipe:
            torch.cuda.synchronize()
            led.mark_loop_start()
            t0 = last = time.perf_counter()
            for _ in range(DATA_STEPS):
                batch = next(pipe)
                params, opt_state, m = ts.step(params, opt_state, batch)
                got.append(batch)
                losses.append(m["loss"])
                now = time.perf_counter()
                walls.append(now - last)
                last = now
                waits.append(pipe.pop_data_wait_s())
                led.account("data_wait_s", waits[-1])
                led.step(walls[-1], tokens=TRAIN_BATCH * TRAIN_SEQ)
            torch.cuda.synchronize()
            loop_wall = time.perf_counter() - t0
            data_wait_s = pipe.data_wait_s
        row = led.flush(final=True)
    finally:
        led.configure(sink=None)
    with TrainPipeline(host(), "cuda", prefetch=0, tasks=False) as pipe:
        sync = [next(pipe) for _ in range(DATA_STEPS)]
    equal = [all(np.array_equal(g[k].cpu().numpy(), w[k]) and
                 np.array_equal(y[k].cpu().numpy(), w[k]) for k in ("tokens", "targets"))
             for g, y, w in zip(got, sync, want)]
    losses = [float(x) for x in losses]
    out = {"steps": DATA_STEPS, "loop_wall_s": loop_wall, "step_walls_s": walls,
           "data_wait_s": waits, "pipeline_data_wait_s": data_wait_s,
           "ledger_data_wait_s": row["buckets"]["data_wait_s"], "ledger_goodput": row["goodput"],
           "tokens_per_s": DATA_STEPS * TRAIN_BATCH * TRAIN_SEQ / loop_wall,
           "losses": losses, "batches_equal": equal}
    log(f"dataset path: {out}")
    if not all(equal):
        raise AssertionError(f"device batches differ from their host source: {equal}")
    if not np.isclose(row["buckets"]["data_wait_s"], sum(waits), rtol=1e-9, atol=1e-12) or \
            not np.isclose(sum(waits), data_wait_s, rtol=1e-9, atol=1e-12):
        raise AssertionError("the ledger's data_wait_s is not the pipeline's")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"dataset path: non-finite loss {losses}")
    return out


def _graph_debug_dump():
    """Whether CUDAGraph.debug_dump writes a graph captured as the engine
    captures its steps, after enable_debug_mode(), and one built with
    keep_graph=True (what the capture agent could register for the captured
    decode step)."""
    import warnings

    x = torch.ones(16, device="cuda")
    out = {}
    for mode in ("default", "enable_debug_mode", "keep_graph"):
        try:
            g = torch.cuda.CUDAGraph(keep_graph=True) if mode == "keep_graph" \
                else torch.cuda.CUDAGraph()
        except TypeError as e:
            out[mode] = {"error": f"{type(e).__name__}: {e}"}
            continue
        if mode == "enable_debug_mode":
            g.enable_debug_mode()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x * 2
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(g):
            x * 2
        path = Path(tempfile.mkdtemp(prefix="chip_smoke_graph_")) / "graph.dot"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                g.debug_dump(str(path))
                err = None
            except Exception as e:
                err = f"{type(e).__name__}: {e}"
        out[mode] = {
            "written": path.exists(), "bytes": path.stat().st_size if path.exists() else 0,
            "warnings": [str(w.message)[:200] for w in caught], "error": err}
        shutil.rmtree(path.parent, ignore_errors=True)
    log(f"CUDAGraph.debug_dump: {out}")
    return out


def phase_bench_config(first):
    """bench.py's train configuration (remat save_attn, bf16 mu) through
    build_train_step on the same weights and batch: its first step gives
    lm_train's first loss and grad norm (the recompute repeats the same
    ops, so only reduction order may differ: loss rtol 1e-4, grad norm
    rtol 1e-3)."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig
    from polyaxon_tpu_torch.runtime.optim import AdamW

    cfg = TransformerConfig(max_seq=TRAIN_SEQ, remat=True, remat_policy="save_attn",
                            **BENCH_MODEL)
    ts, params, opt_state, batch = _train_setup(cfg, AdamW(LR, mu_dtype=torch.bfloat16))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    metrics, walls = [], []
    for _ in range(BENCH_STEPS):
        t0 = time.perf_counter()
        params, opt_state, m = ts.step(params, opt_state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))  # a host read syncs
        walls.append(time.perf_counter() - t0)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    steady = TRAIN_BATCH * TRAIN_SEQ / statistics.median(walls[1:])
    loss_rel = abs(metrics[0][0] - first["loss"]) / abs(first["loss"])
    gn_rel = abs(metrics[0][1] - first["grad_norm"]) / abs(first["grad_norm"])
    per_step = tuple(n / BENCH_STEPS for n in launches)
    log(f"bench config (remat save_attn, bf16 mu), {BENCH_STEPS} steps: losses "
        f"{[x[0] for x in metrics]} grad_norms {[x[1] for x in metrics]}; first step vs "
        f"lm_train: loss rel diff {loss_rel:.3e} (<= 1e-4), grad_norm {gn_rel:.3e} (<= 1e-3); "
        f"step walls {walls} s, tokens_per_s after the first {steady}; "
        f"peak_memory_allocated {peak} B; launches fwd/dq/dkv per step {per_step}")
    n = BENCH_MODEL["n_layers"]
    if per_step != (n, n, n):
        raise AssertionError(f"save_attn: expected {n} launches of each kernel per step "
                             f"(the policy keeps the forward's output), got {per_step}")
    if loss_rel > 1e-4 or gn_rel > 1e-3:
        raise AssertionError("bench config's first step disagrees with lm_train's")


def phase_profile_train():
    """Where the training time goes: one train step of the lm_train
    configuration (no remat, float32 mu)."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig
    from polyaxon_tpu_torch.runtime.optim import AdamW

    cfg = TransformerConfig(max_seq=TRAIN_SEQ, **BENCH_MODEL)
    ts, params, opt_state, batch = _train_setup(cfg, AdamW(LR))
    _profile("train step", lambda: ts.step(params, opt_state, batch), 1, top=12)


def _small_serving_traffic(rng):
    """(concurrent, sequential) lists of (prompt, max_new): mixed lengths and
    two templated prompts the n-gram drafter can match, submitted together;
    then two prompts sharing two 8-token blocks and diverging inside the
    third, and the bare prefix twice (a block-aligned full hit: copy-on-write),
    one after another so each finds the last one's blocks cached."""
    mixed = [(rng.integers(0, 256, t).tolist(), n) for t, n in ((3, 12), (17, 9), (40, 16),
                                                                (25, 5), (9, 20))]
    loop = [5, 9, 13, 2, 40, 7]
    templated = [(loop * 4, 24), (rng.integers(0, 256, 5).tolist() + loop * 3, 20)]
    pre, a, b = (rng.integers(0, 256, t).tolist() for t in (16, 5, 4))
    shared = [(pre + a, 10), (pre + a[:2] + b, 12), (pre, 8), (pre, 6)]
    return mixed + templated, shared


def _serve_small(engine, together, sequential):
    engine.start()
    try:
        reqs = [engine.submit(p, n) for p, n in together]
        outs = [r.wait(timeout=300) for r in reqs]
        outs += [engine.submit(p, n).wait(timeout=300) for p, n in sequential]
        return outs, engine.stats()
    finally:
        engine.stop()


def phase_engine_small():
    """The paged engine on small float32 models on the card, MHA and GQA:
    greedy tokens equal the static generate's (dense attention, so the two
    differ only in the KV layout and the scheduling) with prefix reuse,
    copy-on-write, prefill_chunk=8, speculative decoding and the warmup on;
    and on an int8 pool, tokens with speculation and prefix reuse on equal
    those with both off (an int8 pool is near the float one, not equal)."""
    from polyaxon_tpu_torch.models import decode
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params
    from polyaxon_tpu_torch.serving import ServingEngine

    for variant, extra in (("mha", {}), ("gqa", {"n_kv_heads": 2})):
        cfg = TransformerConfig(dtype=torch.float32, **SMALL_SERVE, **extra)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7))
        together, sequential = _small_serving_traffic(np.random.default_rng(8))
        kw = dict(slots=3, max_len=cfg.max_seq, block_size=8, prefill_chunk=8, spec_k=4,
                  device="cuda")
        t0 = time.perf_counter()
        outs, stats = _serve_small(
            ServingEngine(params, cfg, spec_decode=True, warmup=True, **kw), together, sequential)
        wall = time.perf_counter() - t0
        dense = cfg.scaled(attention_impl="dense")
        want = [decode.generate(params, torch.tensor([p], device="cuda"), dense, max_new_tokens=n,
                                device="cuda")[0].tolist() for p, n in together + sequential]
        equal = sum(a == b for a, b in zip(outs, want))
        leaked = stats["blocks_total"] - stats["blocks_free"] - stats["prefix_cache_blocks"]
        log(f"small f32 engine {variant}: {equal}/{len(want)} requests equal to static generate; "
            f"cow_copies {stats['cow_copies']} prefix_cache_hits {stats['prefix_cache_hits']} "
            f"spec proposed/accepted {stats['spec_proposed_total']}/"
            f"{stats['spec_accepted_total']} warmup {stats['warmup']} leaked blocks {leaked}; "
            f"{wall:.2f} s")
        if equal != len(want) or stats["cow_copies"] < 1 or stats["prefix_cache_hits"] < 4 or \
                stats["spec_accepted_total"] < 1 or leaked or \
                stats["warmup"]["done"] != stats["warmup"]["total"]:
            raise AssertionError(f"the {variant} engine disagrees with static generate")
        int8 = {}
        for on in (True, False):
            int8[on], s = _serve_small(
                ServingEngine(params, cfg, kv_quantize="int8", spec_decode=on, prefix_cache=on,
                              warmup=False, **kw), [], together + sequential)
        log(f"small f32 engine {variant}, int8 pool: spec and prefix reuse on vs off: "
            f"{sum(a == b for a, b in zip(int8[True], int8[False]))}/{len(want)} requests equal; "
            f"{sum(a == b for a, b in zip(int8[True], want))}/{len(want)} equal to the float32 "
            f"static generate (not required)")
        if int8[True] != int8[False]:
            raise AssertionError(f"the {variant} int8 pool gives other tokens with spec and prefix "
                                 "reuse on")


def _agree(label, a, b):
    """Min cosine >= 0.999 and the same argmax per row, as phase 6 holds the
    static path."""
    cos = torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min().item()
    same = torch.equal(a.argmax(-1), b.argmax(-1))
    finite = bool(torch.isfinite(a).all())
    log(f"{label}: min cosine {cos:.6f} (>= 0.999), max abs diff {(a - b).abs().max().item():.4f}, "
        f"argmax equal: {same}; finite: {finite}")
    if cos < 0.999 or not same or not finite:
        raise AssertionError(f"{label} disagree")


def phase_paged_parity():
    """The paged steps at the 671M width in bf16, on lm_server's weights (the
    same seed): a 500-token prompt through two prefill chunks (256, then 244
    padded to 256) into blocks in a shuffled order, against prefill with
    dense attention; then one decode step at position 500 against the static
    decode_step.  Returns (params, cfg) for the profile."""
    from polyaxon_tpu_torch.models import decode
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params
    from polyaxon_tpu_torch.parallel import flash

    cfg = TransformerConfig(max_seq=SERVE_SEQ, **BENCH_MODEL)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    T, W = 500, SERVE_SEQ // SERVE_BLOCK
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, T), device="cuda")
    pool = decode.init_block_pool(cfg, 1 + W, SERVE_BLOCK, device="cuda")
    table = torch.as_tensor(1 + rng.permutation(W), device="cuda")
    _reset_counts()
    for start in range(0, T, SERVE_CHUNK):
        n = min(SERVE_CHUNK, T - start)
        chunk = torch.zeros(SERVE_CHUNK, dtype=torch.long, device="cuda")
        chunk[:n] = prompt[start:start + n]
        paged, pool = decode.paged_prefill_chunk(params, pool, table, chunk, start, n, cfg)
    cache = decode.init_cache(cfg, 1, T + 1, "cuda")
    static, cache = decode.prefill(params, prompt[None], cache, cfg.scaled(attention_impl="dense"),
                                   device="cuda")
    _agree("671M paged_prefill_chunk last logits vs prefill (dense)", paged[None], static)
    token = static.argmax(-1)
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    paged, pool = decode.paged_decode_step(params, pool, table[None], token,
                                           torch.full((1,), T, device="cuda"), one, cfg)
    static, cache = decode.decode_step(params, cache, token, T, cfg)
    _agree("671M paged_decode_step vs decode_step at position 500", paged, static)
    torch.cuda.synchronize()
    if _counts() != (0, 0, 0):
        raise AssertionError(f"the paged steps launched flash kernels: {_counts()}")
    del pool, cache
    return params, cfg


def phase_profile_paged(params, cfg):
    """Where the serving time goes: one paged decode step of 8 live slots at
    position 512 (host state to the card, the step, the argmax and its host
    read, as the engine's step runs it), and one 256-token prefill chunk at
    position 256; with the step's least time (its weights and the live KV
    rows read once at the HBM rate).  The weights are the engine's: cast to
    bf16 once."""
    from polyaxon_tpu_torch.models import decode

    params = decode.cast_weights(params, cfg)
    W = SERVE_SEQ // SERVE_BLOCK
    pool = decode.init_block_pool(cfg, 1 + SERVE_SLOTS * W, SERVE_BLOCK, device="cuda")
    rng = np.random.default_rng(SEED + 2)
    tables = np.arange(1, 1 + SERVE_SLOTS * W).reshape(SERVE_SLOTS, W)
    pos = np.full(SERVE_SLOTS, 512)
    tok = rng.integers(0, cfg.vocab_size, SERVE_SLOTS)
    active = np.ones(SERVE_SLOTS, bool)

    def step():
        dev = [torch.as_tensor(x, device="cuda") for x in (tables, tok, pos, active)]
        logits, _ = decode.paged_decode_step(params, pool, dev[0], dev[1], dev[2], dev[3], cfg)
        logits.argmax(-1).cpu()

    chunk = torch.as_tensor(rng.integers(0, cfg.vocab_size, SERVE_CHUNK), device="cuda")
    table0 = torch.as_tensor(tables[0], device="cuda")

    def prefill_chunk():
        decode.paged_prefill_chunk(params, pool, table0, chunk, 256, SERVE_CHUNK, cfg)[0].cpu()

    weights = sum(t.numel() * t.element_size()
                  for t in [*params["block"].values(), params["unembed"]])
    kv = 2 * cfg.n_layers * SERVE_SLOTS * 513 * cfg.kv_heads * cfg.head_dim * \
        pool["k"].element_size()
    bound_ms = (weights + kv) / H100_BYTES_PER_S * 1e3
    log(f"paged decode step bound: {weights / 1e6:.1f} MB of weights + {kv / 1e6:.1f} MB of live "
        f"KV rows at the HBM rate -> {bound_ms:.4f} ms (bytes)")
    return {
        "paged_decode_step_bound_ms": bound_ms,
        "paged_decode_step": _profile(f"paged decode step ({SERVE_SLOTS} live slots, position 512)",
                                      step, 1, top=10),
        "paged_prefill_chunk": _profile(f"paged prefill chunk ({SERVE_CHUNK} tokens at 256)",
                                        prefill_chunk, 1, top=10),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(base, path, payload=None, timeout=600, headers=None):
    """(status, body) of a GET (payload None) or a JSON POST; /metrics as text."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, (body.decode() if path == "/metrics" else json.loads(body))


def _await_stats(base, cond, what, timeout=120):
    deadline = time.time() + timeout
    while True:
        stats = _http(base, "/v1/stats")[1]
        if cond(stats):
            return stats
        if time.time() > deadline:
            raise AssertionError(f"lm_server: {what} did not happen in {timeout} s: {stats}")
        time.sleep(0.05)


def _await_ready(base, errors, what, timeout=300):
    deadline = time.time() + timeout
    while True:
        if errors:
            raise errors[0]
        try:
            health = _http(base, "/healthz", timeout=30)[1]
            if health["state"] == "ready":
                return health
        except OSError:
            pass
        if time.time() > deadline:
            raise AssertionError(f"{what} did not become ready in {timeout} s")
        time.sleep(0.1)


def phase_lm_server():
    """The serving entry point at the 671M width: lm_server in a thread, 16
    concurrent /generate requests of 64 tokens (8 sharing a 256-token prefix
    with suffixes of 64-448 tokens, 8 independent prompts of 128-512 tokens;
    2 of the 16 sampled at temperature 0.8), then the stats, the metrics,
    the block count and a cancel.  Returns the flash kernels' launch counts
    over the run and the run's figures."""
    from polyaxon_tpu_torch.builtins.services import lm_server
    from polyaxon_tpu_torch.tracking import ledger
    from polyaxon_tpu_torch.tracking.capture import get_capture_agent
    from polyaxon_tpu_torch.tracking.context import Context

    V = BENCH_MODEL["vocab_size"]
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    records = []
    ctx = Context(params=dict(BENCH_MODEL, seq=SERVE_SEQ, slots=SERVE_SLOTS,
                              block_size=SERVE_BLOCK, prefill_chunk=SERVE_CHUNK, prefix_cache=1,
                              max_new_tokens=SERVE_NEW, service_port=port, host="127.0.0.1",
                              device="cuda"), seed=SEED, records=records)
    errors = []

    def serve():
        try:
            lm_server(ctx)
        except Exception as e:  # re-raised by the main thread below
            errors.append(e)

    _free()
    torch.cuda.reset_peak_memory_stats()
    ledger_rows = []
    ledger.configure(sink=ledger_rows.append)
    _reset_counts()
    t0 = time.perf_counter()
    server = threading.Thread(target=serve, name="lm_server", daemon=True)
    server.start()
    try:
        health = _await_ready(base, errors, "lm_server")
        ready_s = time.perf_counter() - t0
        warmup = health["engine"]["warmup"]
        log(f"lm_server ready in {ready_s:.2f} s: warmup {warmup}, "
            f"{health['model']['n_params']} params")
        if not warmup["total"] or warmup["done"] != warmup["total"]:
            raise AssertionError(f"lm_server's warmup did not run every step: {warmup}")
        if health["engine"]["steady_state_compiles"]:
            raise AssertionError(f"lm_server captured after ready: {health['engine']}")

        rng = np.random.default_rng(SEED + 3)
        prefix = rng.integers(0, V, 256).tolist()
        shared = [prefix + rng.integers(0, V, int(n)).tolist() for n in np.linspace(64, 448, 8)]
        alone = [rng.integers(0, V, int(n)).tolist() for n in np.linspace(128, 512, 8)]
        # Interleaved, so the first 8 admitted hold about half the shared
        # prompts and the rest, admitted as slots free, find the prefix
        # cached (a block is published when its prompt's prefill ends).
        prompts = [p for pair in zip(shared, alone) for p in pair]
        temps = [0.8 if i in (6, 11) else 0.0 for i in range(len(prompts))]
        results = [None] * len(prompts)

        def client(i):
            results[i] = _http(base, "/generate", {"prompts": [prompts[i]],
                                                   "max_new_tokens": SERVE_NEW,
                                                   "temperature": temps[i]})

        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        t1 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t1
        if any(c.is_alive() for c in clients) or errors:
            raise AssertionError(f"lm_server requests did not finish: {errors}")
        for i, (status, body) in enumerate(results):
            toks = body.get("tokens", [[]])[0] if status == 200 else []
            if status != 200 or len(toks) != SERVE_NEW or not all(0 <= t < V for t in toks):
                raise AssertionError(f"request {i}: status {status}, {str(body)[:300]}")
        ttft = [body["ttft_s"][0] for _, body in results]
        stats = _http(base, "/v1/stats")[1]
        lat = stats["latency"]
        n_tok = len(prompts) * SERVE_NEW
        # One window of 16 requests: a smoke-level reading.  Its TTFT tail
        # is reported as the maximum (a p99 of 16 samples is the maximum).
        summary = {
            "requests": len(prompts), "new_tokens": SERVE_NEW,
            "prompt_tokens": sum(map(len, prompts)), "wall_s": wall,
            "aggregate_tokens_per_s": n_tok / wall, "ttft_s_p50": float(np.median(ttft)),
            "ttft_s_max": max(ttft), "queue_wait_s_p50": lat["queue_wait_s"]["p50"],
            "decode_step_s_p50": lat["decode_step_s"]["p50"],
            "decode_steps": stats["decode_steps"],
            "prefix_cache_hit_rate": stats["prefix_cache_hit_rate"],
            "steady_state_compiles": stats["steady_state_compiles"],
        }
        log(f"lm_server 671M, {len(prompts)} concurrent requests x {SERVE_NEW} tokens "
            f"({summary['prompt_tokens']} prompt tokens): wall {wall:.3f} s, aggregate "
            f"tokens_per_s {summary['aggregate_tokens_per_s']:.1f}; client ttft_s p50 "
            f"{summary['ttft_s_p50']:.4f} max {summary['ttft_s_max']:.4f}; engine histograms: "
            f"ttft_s {lat['ttft_s']}, queue_wait_s {lat['queue_wait_s']}, decode_step_s "
            f"{lat['decode_step_s']}, batch_occupancy {lat['batch_occupancy']}")
        log(f"lm_server stats: decode_steps {stats['decode_steps']} tokens_generated "
            f"{stats['tokens_generated']} prefix_cache_hit_rate {stats['prefix_cache_hit_rate']} "
            f"hits {stats['prefix_cache_hits']} cow_copies {stats['cow_copies']} "
            f"prefix_cache_blocks {stats['prefix_cache_blocks']} blocks_free "
            f"{stats['blocks_free']}/{stats['blocks_total']} block_parks {stats['block_parks']} "
            f"decode_busy_frac {stats['decode_busy_frac']} slot_occupancy "
            f"{stats['slot_occupancy']} kv_pool_bytes {stats['kv_pool_bytes']}")
        if not stats["prefix_cache_hit_rate"] > 0:
            raise AssertionError("lm_server: no prefix-cache hit on the shared prefix")
        if stats["steady_state_compiles"]:
            raise AssertionError(f"lm_server: {stats['steady_state_compiles']} step entries "
                                 "built after ready (the warmup missed a shape)")
        used = stats["blocks_total"] - stats["blocks_free"]
        if used != stats["prefix_cache_blocks"] or stats["slots_active"]:
            raise AssertionError(f"lm_server: {used} blocks in use after the traffic, "
                                 f"{stats['prefix_cache_blocks']} held by the prefix cache")
        status, metrics = _http(base, "/metrics")
        if status != 200 or "# TYPE polyaxon_tpu_serving_ttft_s histogram" not in metrics:
            raise AssertionError("lm_server: /metrics carries no TTFT histogram")

        # Cancel a long request mid-decode, by the id /v1/stats shows in its
        # slot.
        long_result = []
        long_client = threading.Thread(target=lambda: long_result.append(_http(
            base, "/generate", {"prompts": [alone[0][:64]], "max_new_tokens": 900})))
        long_client.start()
        before = stats["tokens_generated"]
        busy = _await_stats(base, lambda s: s["slots_active"] == 1 and
                            s["tokens_generated"] > before + 8, "the long request's decode")
        (rid,) = [i for i in busy["slot_request_ids"] if i is not None]
        cancelled = _http(base, "/v1/cancel", {"request_id": rid})
        long_client.join(timeout=120)
        after = _await_stats(base, lambda s: s["slots_active"] == 0, "the cancel")
        used = after["blocks_total"] - after["blocks_free"]
        log(f"lm_server cancel of request {rid}: {cancelled}; its /generate answered "
            f"{long_result[0] if long_result else None}; slots_active {after['slots_active']} "
            f"blocks in use {used} (prefix cache {after['prefix_cache_blocks']}) "
            f"requests_cancelled {after['requests_cancelled']}")
        if cancelled != (200, {"cancelled": True}) or not long_result or \
                long_result[0][0] != 503 or long_result[0][1]["error"]["kind"] != "cancelled" or \
                used != after["prefix_cache_blocks"]:
            raise AssertionError("lm_server: the cancel did not free the request's slot and blocks")
        family = get_capture_agent()._executables["serving_decode_step"].as_text()
    finally:
        ctx.stop.set()
        server.join(timeout=120)
        ledger.configure(sink=None)
    if server.is_alive() or errors:
        raise AssertionError(f"lm_server did not stop cleanly: {errors}")
    torch.cuda.synchronize()
    launches = _counts()
    # The engine's final ledger row (stop()): the reference's extras, and one
    # step a decode step and a prompt's last chunk, one token an emitted one.
    finals = [r for r in ledger_rows if r["final"] and r["source"] == "serving"]
    row = finals[-1] if finals else {}
    extra = row.get("extra", {})
    summary["ledger"] = {k: row.get(k) for k in ("wall_s", "buckets", "steps", "tokens",
                                                  "goodput", "device_kind", "hbm_peak_bytes")}
    summary["ledger"].update(rows=len(ledger_rows), finals=len(finals),
                             **{k: extra.get(k) for k in ("decode_busy_frac", "slot_occupancy",
                                                          "decode_utilization")})
    summary["family_text_lines"] = family.splitlines()[:3]
    log(f"lm_server ledger: {summary['ledger']}; the registered decode step: "
        f"{family.splitlines()[:3]}")
    if len(finals) != 1 or set(SERVING_EXTRA) - set(extra):
        raise AssertionError(f"lm_server's final serving row lacks the reference's extras: "
                             f"{sorted(set(SERVING_EXTRA) - set(extra))}, {len(finals)} rows")
    if row["tokens"] != after["tokens_generated"] or \
            row["steps"] != after["decode_steps"] + after["requests_submitted"]:
        raise AssertionError(f"the serving row's steps {row['steps']} and tokens {row['tokens']}"
                             f" are not the engine's ({after['decode_steps']} decode steps, "
                             f"{after['requests_submitted']} prompts, "
                             f"{after['tokens_generated']} tokens)")
    if "decode: cuda graph" not in family:
        raise AssertionError(f"the registered decode step is not a captured graph: {family}")
    summary["peak_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    log(f"lm_server peak_memory_allocated {summary['peak_memory_allocated_bytes']} B; flash "
        f"launches fwd/dq/dkv {launches} (expected (0, 0, 0))")
    for r in records:  # the server's own lines, less its HTTP access log
        if r["kind"] == "log" and not r["line"].startswith('lm_server: "'):
            log(r["line"])
    if launches != (0, 0, 0):
        raise AssertionError(f"lm_server launched flash kernels: {launches}")
    return launches, summary


def _long_shape(batch, T, heads, want_ops=None):
    """The three kernels at one long causal shape (B ``batch`` x H 32, T,
    d 64, bf16): the kernels on every head, the heads ``heads`` held
    against the plain version on those heads (the kernels' limits), and
    each kernel's time beside SDPA's on every head and its bound, which must
    be set by operations at this length (and give ``want_ops`` FLOP, where
    given).  Returns each kernel's figures, keyed fwd, dq, dkv."""
    from polyaxon_tpu_torch.parallel import flash

    H, d = BENCH_MODEL["n_heads"], BENCH_MODEL["head_dim"]
    BH, dtype = batch * H, torch.bfloat16
    idx = torch.tensor(heads, device="cuda")
    named = f"{heads[0]}-{heads[-1]}" if list(heads) == list(range(heads[0], heads[-1] + 1)) \
        else ", ".join(map(str, heads))
    g = torch.Generator(device="cuda").manual_seed(T + d)
    q, k, v, do = (torch.randn(BH, T, d, generator=g, device="cuda").to(dtype) for _ in range(4))
    kw = dict(causal=True, sm_scale=d**-0.5)
    o, lse = flash.flash_block_fwd(q, k, v, **kw)
    delta = (do.float() * o.to(dtype).float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    grads = (flash.flash_block_dq(*args, **kw), *flash.flash_block_dkv(*args, **kw))
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(x).all()) for x in (o, lse, *grads))

    def head(*xs):
        return tuple(x.index_select(0, idx) for x in xs)

    ro, rlse = flash.flash_block_fwd_reference(*head(q, k, v), **kw)
    errs = {"o": (head(o)[0] - ro).abs().max().item(),
            "lse": (head(lse)[0] - rlse).abs().max().item()}
    del ro, rlse
    ref = flash.flash_block_bwd_reference(*head(*args), **kw)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        errs[name] = (head(got)[0] - want).abs().max().item()
    del ref, grads, o
    _free()
    lim = BWD_ATOL[dtype]
    log(f"long shape BH={BH} T={T} d={d} {dtype} causal, heads {named} against the plain "
        f"version: o max abs err {errs['o']:.3e} (<= {O_ATOL}), lse {errs['lse']:.3e} "
        f"(<= {LSE_ATOL}), dq {errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e} "
        f"(<= {lim}); all {BH} heads finite {finite}")
    if errs["o"] > O_ATOL or errs["lse"] > LSE_ATOL or max(errs[x] for x in ("dq", "dk", "dv")) \
            > lim or not finite:
        raise AssertionError(f"a kernel disagrees with its plain version at T {T}")
    ms = {"fwd": time_ms(lambda: flash.flash_block_fwd(q, k, v, **kw), reps=20),
          "dq": time_ms(lambda: flash.flash_block_dq(*args, **kw), reps=20),
          "dkv": time_ms(lambda: flash.flash_block_dkv(*args, **kw), reps=20)}
    plain = {"fwd": time_ms(lambda: flash.flash_block_fwd_reference(*head(q, k, v), **kw),
                            reps=5, warmup=1),
             "bwd": time_ms(lambda: flash.flash_block_bwd_reference(*head(*args), **kw),
                            reps=5, warmup=1)}
    _free()
    q4, k4, v4 = (x.view(batch, H, T, d) for x in (q, k, v))
    sdpa_fwd = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=kw["sm_scale"]), reps=20)
    sdpa_bwd = _sdpa_bwd_ms(q, k, v, do, batch, True, kw["sm_scale"])
    out = {}
    for kind in ("fwd", "dq", "dkv"):
        bound_ms, bound_by, moved, ops = attention_bound(BH, T, T, d, dtype, True, kind)
        if bound_by != "operations" or (want_ops and abs(ops - want_ops[kind]) > 0.1e9):
            raise AssertionError(f"attention_bound({kind}) at T {T} gives {ops} FLOP "
                                 f"({bound_by}); expected {want_ops and want_ops[kind]} "
                                 "(operations)")
        out[kind] = {
            "shape": f"BH {BH} T {T} d {d} bf16 causal", "ms": ms[kind], "ref_heads": named,
            "plain_ms_ref_heads": plain["fwd" if kind == "fwd" else "bwd"],
            "library_ms": sdpa_fwd if kind == "fwd" else sdpa_bwd,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err_ref_heads": errs["o"] if kind == "fwd" else
            (errs["dq"] if kind == "dq" else max(errs["dk"], errs["dv"])),
        }
        log(f"  {kind}: {moved / 1e6:.1f} MB, {ops / 1e9:.1f} GFLOP -> bound_ms {bound_ms:.4f} "
            f"({bound_by}); kernel_ms {ms[kind]:.4f} ({ms[kind] / bound_ms:.2f}x the bound)")
    log(f"  plain_ms on heads {named} of {BH}: fwd {plain['fwd']:.4f} bwd {plain['bwd']:.4f}; "
        f"library_ms (sdpa, all heads): fwd {sdpa_fwd:.4f} bwd {sdpa_bwd:.4f}")
    return out


def phase_long_kernels():
    """The three kernels at the long-context shapes of phases 14 and 15:
    lm_train's BH 64 x T 8192 (the first LONG_REF_HEADS heads against the
    plain version) and sp_ring's BH 32 x T 16384 (its first and last heads,
    so that both the longest grid and the largest offsets are held).
    Returns the figures of each, keyed t8192 and t16384, then by kernel."""
    long = _long_shape(LONG_BATCH, LONG_SEQ, tuple(range(LONG_REF_HEADS)), LONG_SHAPE_OPS)
    _free()
    ring = _long_shape(RING_BATCH, RING_SEQ, (0, RING_BATCH * BENCH_MODEL["n_heads"] - 1))
    return {"t8192": long, "t16384": ring}


def _bench_arm(label, ts, params, opt_state, batch, seq, warm, timed, first):
    """bench.py's long-context measurement: ``warm`` steps, then ``timed``
    steps ended by a host read of the loss.  The first step must give the
    first step of ``first`` (lm_train's metrics on the same weights and
    batch; the recompute repeats the same ops, so only reduction order may
    differ: loss rtol 1e-4, grad norm rtol 1e-3), each kernel must launch
    once per layer and step (save_attn keeps the forward's output), and the
    loss must be finite and fall."""
    batch_size = batch["tokens"].shape[0]
    _free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    for i in range(warm + timed):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        params, opt_state, m = ts.step(params, opt_state, batch)
        if i == 0:
            loss0, gn0 = m["loss"].item(), m["grad_norm"].item()
    last = m["loss"].item()  # a host read ends the timed steps
    dt = time.perf_counter() - t0
    launches, peak = _counts(), torch.cuda.max_memory_allocated()
    tps = timed * batch_size * seq / dt
    loss_rel = abs(loss0 - first["loss"]) / abs(first["loss"])
    gn_rel = abs(gn0 - first["grad_norm"]) / abs(first["grad_norm"])
    per_step = tuple(c / (warm + timed) for c in launches)
    log(f"{label}: {warm} warm + {timed} timed steps, tokens_per_s {tps} mfu "
        f"{_mfu(tps, seq):.4f}; loss {loss0} -> {last}, grad_norm {gn0}; first step vs "
        f"lm_train: loss rel diff {loss_rel:.3e} (<= 1e-4), grad_norm {gn_rel:.3e} (<= 1e-3); "
        f"peak_memory_allocated {peak} B; launches fwd/dq/dkv per step {per_step}")
    n = BENCH_MODEL["n_layers"]
    if per_step != (n, n, n):
        raise AssertionError(f"{label}: expected {n} launches of each kernel per step, got "
                             f"{per_step}")
    if loss_rel > 1e-4 or gn_rel > 1e-3:
        raise AssertionError(f"{label}: the first step disagrees with lm_train's")
    if not (np.isfinite(last) and last < loss0):
        raise AssertionError(f"{label}: the loss is not finite and falling")
    return {"tokens_per_s": tps, "mfu": _mfu(tps, seq), "peak_memory_allocated": peak}


def phase_long_train():
    """lm_train at T = 8192, batch 2, attention_impl "flash" (671M, full
    width and depth), then bench.py's long-context arm through
    build_train_step with the ddp template on a {"data": 1} mesh: remat
    save_attn, AdamW(3e-4) with a float32 mu, 2 warm and 6 timed steps;
    then where one of its steps spends the time (torch.profiler).  Returns
    lm_train's launch counts and the figures."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig
    from polyaxon_tpu_torch.parallel.templates import template_for
    from polyaxon_tpu_torch.runtime.mesh import build_mesh
    from polyaxon_tpu_torch.runtime.optim import AdamW

    launches, first, final = _lm_train("lm_train 671M long context", LONG_SEQ, LONG_BATCH,
                                       LONG_STEPS, attention_impl="flash")
    mesh = build_mesh({"data": 1})
    template = template_for("ddp", dict(mesh.shape))
    cfg = TransformerConfig(max_seq=LONG_SEQ, remat=True, remat_policy="save_attn",
                            attention_impl="flash", **BENCH_MODEL)
    ts, params, opt_state, batch = _train_setup(cfg, AdamW(LR), LONG_BATCH, LONG_SEQ, template,
                                                mesh)
    arm = _bench_arm("bench long-context arm (T 8192, ddp, save_attn, f32 mu)", ts, params,
                     opt_state, batch, LONG_SEQ, LONG_WARM, LONG_TIMED, first)
    profile = _profile("train step T=8192 (save_attn)",
                       lambda: ts.step(params, opt_state, batch), 1, top=12)
    del ts, params, opt_state, batch
    return launches, {"lm_train_tokens_per_s": final["tokens_per_s"],
                      "lm_train_mfu": _mfu(final["tokens_per_s"], LONG_SEQ),
                      "bench_arm": arm, "profile": profile}


def phase_ring_train():
    """sp_ring on a one-rank {"sequence": 1} mesh at T = 16384, batch 1, as
    bench.py:233-267 runs it: lm_train with strategy sp_ring, whose first
    step must equal the plain path's (lm_train with ddp, one step) on the
    same weights and batch (a one-rank ring is one causal block: loss rtol
    1e-4, grad norm rtol 1e-3) and whose forward launches go through
    ring_flash_attention (one ring block per layer and step); then the
    same through build_train_step with remat save_attn and a bf16 mu.
    Returns the sp_ring lm_train's launch counts and the figures."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig
    from polyaxon_tpu_torch.parallel import flash
    from polyaxon_tpu_torch.parallel.templates import template_for
    from polyaxon_tpu_torch.runtime.mesh import build_mesh
    from polyaxon_tpu_torch.runtime.optim import AdamW

    _, plain, _ = _lm_train("lm_train 671M T 16384, ddp (the plain path)", RING_SEQ, RING_BATCH,
                            1, attention_impl="flash")
    plain_blocks = flash.ring_flash_fwd.blocks
    mesh = build_mesh({"sequence": 1})
    launches, first, final = _lm_train("lm_train 671M T 16384, sp_ring", RING_SEQ, RING_BATCH,
                                       RING_STEPS, strategy="sp_ring", mesh=mesh,
                                       attention_impl="flash")
    blocks = flash.ring_flash_fwd.blocks
    loss_rel = abs(first["loss"] - plain["loss"]) / abs(plain["loss"])
    gn_rel = abs(first["grad_norm"] - plain["grad_norm"]) / abs(plain["grad_norm"])
    n = BENCH_MODEL["n_layers"]
    log(f"sp_ring vs the plain path, first step: loss {first['loss']} vs {plain['loss']} "
        f"(rel diff {loss_rel:.3e} <= 1e-4), grad_norm {first['grad_norm']} vs "
        f"{plain['grad_norm']} ({gn_rel:.3e} <= 1e-3); ring blocks {blocks} (expected "
        f"{n * RING_STEPS}), the plain path's {plain_blocks} (expected 0)")
    if loss_rel > 1e-4 or gn_rel > 1e-3:
        raise AssertionError("sp_ring's first step disagrees with the plain path's")
    if blocks != n * RING_STEPS or plain_blocks != 0:
        raise AssertionError("the forward launches did not go through ring_flash_attention")
    template = template_for("sp_ring", dict(mesh.shape))
    cfg = TransformerConfig(max_seq=RING_SEQ, remat=True, remat_policy="save_attn",
                            attention_impl="flash", **BENCH_MODEL)
    ts, params, opt_state, batch = _train_setup(
        cfg, AdamW(LR, mu_dtype=torch.bfloat16), RING_BATCH, RING_SEQ, template, mesh)
    arm = _bench_arm("bench T 16384 arm (sp_ring on {sequence: 1}, save_attn, bf16 mu)", ts,
                     params, opt_state, batch, RING_SEQ, RING_WARM, RING_TIMED, first)
    del ts, params, opt_state, batch
    return launches, {"lm_train_tokens_per_s": final["tokens_per_s"],
                      "lm_train_mfu": _mfu(final["tokens_per_s"], RING_SEQ), "bench_arm": arm}


def phase_ring_threads():
    """The ring's hop functions for n = 4 ranks on one card, the ranks as
    threads over an in-process ring (LocalRing), called directly (an
    exchange inside backward() would stall the autograd engine's one
    thread for the card).  bf16, B 2, T 4 x 512, H 8, Hkv 2 and 8, d 64
    and 128.  The kernels' hops against the same hops with the plain
    forward swapped in (o, lse) and with the plain backward swapped in after
    the same forward (dq, dk, dv), at the kernels' limits; against plain
    attention over the whole sequence on the card (o and lse; the grads
    given the ring's softmax statistics); and a control run with dk x 1.01
    in one hop (rank 0's diagonal block), which must fail the limit."""
    import threading

    from polyaxon_tpu_torch.parallel import flash
    from polyaxon_tpu_torch.parallel.ring import LocalRing

    n, B, Tl, dtype = RING_RANKS, RING_B, RING_TL, torch.bfloat16
    lim = BWD_ATOL[dtype]
    real_bwd = flash.flash_block_bwd
    for H, Hkv, d in RING_CASES:
        g = torch.Generator(device="cuda").manual_seed(H + Hkv + d)
        q, do = (torch.randn(B, n * Tl, H, d, generator=g, device="cuda").to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(B, n * Tl, Hkv, d, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        scale, group = d**-0.5, H // Hkv

        def shard(x, r):
            return x[:, r * Tl:(r + 1) * Tl]

        def fwd(ring):
            r = ring.rank
            return flash.ring_flash_fwd(shard(q, r), shard(k, r), shard(v, r), scale, ring)

        def bwd(stats):
            def run(ring):
                r = ring.rank
                o, lse = stats[r]
                return flash.ring_flash_bwd(shard(q, r), shard(k, r), shard(v, r), o.to(dtype),
                                            lse, shard(do, r), scale, ring)
            return run

        def cat(results, i):
            return torch.cat([res[i] for res in results], dim=1)

        def err(a, b, i):
            return (cat(a, i) - cat(b, i)).abs().max().item()

        kernel_fwd = LocalRing.run(n, fwd)
        kernel_bwd = LocalRing.run(n, bwd(kernel_fwd))
        torch.cuda.synchronize()
        with _swapped(flash_block_fwd=flash.flash_block_fwd_reference):
            plain_fwd = LocalRing.run(n, fwd)
        with _swapped(flash_block_bwd=flash.flash_block_bwd_reference):
            plain_bwd = LocalRing.run(n, bwd(kernel_fwd))
        hit = []

        def one_hop_dk_off(*args, **kw):  # rank 0's one hop: its causal diagonal block
            dq, dk, dv = real_bwd(*args, **kw)
            if threading.current_thread().name == "ring-rank-0":
                hit.append(kw["causal"])
                dk = dk * 1.01
            return dq, dk, dv

        with _swapped(flash_block_bwd=one_hop_dk_off):
            fault_bwd = LocalRing.run(n, bwd(kernel_fwd))
        hops = (err(kernel_fwd, plain_fwd, 0), err(kernel_fwd, plain_fwd, 1),
                max(err(kernel_bwd, plain_bwd, i) for i in range(3)),
                max(err(fault_bwd, plain_bwd, i) for i in range(3)))
        # Whole-sequence plain attention, the KV heads broadcast to the query heads.
        qf, dof = flash._bhd(q), flash._bhd(do)
        kf, vf = (flash._gqa_expand(flash._bhd(x), B, group) for x in (k, v))
        wo, wlse = flash.flash_block_fwd_reference(qf, kf, vf, causal=True, sm_scale=scale)
        ring_o, ring_lse = flash._bhd(cat(kernel_fwd, 0)), cat(kernel_fwd, 1)
        delta = (dof.float() * ring_o.to(dtype).float()).sum(-1)
        wdq, wdk, wdv = flash.flash_block_bwd_reference(qf, kf, vf, dof, ring_lse, delta,
                                                        causal=True, sm_scale=scale)
        whole = ((ring_o - wo).abs().max().item(), (ring_lse - wlse).abs().max().item(),
                 max((flash._bhd(cat(kernel_bwd, i)) - w).abs().max().item()
                     for i, w in enumerate((wdq, flash._gqa_reduce(wdk, B, group),
                                            flash._gqa_reduce(wdv, B, group)))))
        log(f"ring n={n} on threads, B={B} T={n}x{Tl} H={H} Hkv={Hkv} d={d} {dtype}: kernels vs "
            f"plain hops: o {hops[0]:.3e} (<= {O_ATOL}), lse {hops[1]:.3e} (<= {LSE_ATOL}), "
            f"dq/dk/dv {hops[2]:.3e} (<= {lim}); vs whole-sequence plain attention: o "
            f"{whole[0]:.3e}, lse {whole[1]:.3e}, dq/dk/dv {whole[2]:.3e}; control with dk x "
            f"1.01 in rank 0's hop: {hops[3]:.3e} (> {lim})")
        if hops[0] > O_ATOL or hops[1] > LSE_ATOL or hops[2] > lim or whole[0] > O_ATOL or \
                whole[1] > LSE_ATOL or whole[2] > lim:
            raise AssertionError("the ring's hops through the kernels disagree with the plain "
                                 "versions")
        if hops[3] <= lim or hit != [True]:
            raise AssertionError("the ring check does not see dk scaled by 1.01 in one hop")

def _filesystem(path: Path) -> str:
    """The mount that holds ``path``: type, mount point and device, from
    /proc/mounts, and the free bytes there."""
    path = path.resolve()
    best = ("?", "?", "?")
    with open("/proc/mounts") as mounts:
        for line in mounts:
            device, mount, fstype = line.split()[:3]
            if path.is_relative_to(mount) and len(mount) >= len(best[1]):
                best = (fstype, mount, device)
    free = shutil.disk_usage(path).free
    return f"{best[0]} at {best[1]} ({best[2]}), {free} bytes free"


def kernel_launches_in_trace(trace: Path) -> dict:
    """Kernel events of a Chrome trace (torch.profiler's) by the port's
    kernel names."""
    names = [e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "kernel"]
    return {k: sum(k in n for n in names) for k in KERNEL_NAMES}


class _Reporter:
    """The capture agent's reporter: records capture and command events."""

    def __init__(self):
        self.captures, self.commands = [], []

    def capture(self, record):
        self.captures.append(dict(record))

    def command_event(self, uuid, state, message=None, **attrs):
        self.commands.append((uuid, state, message))


def phase_checkpoint():
    """Checkpoint, preemption and restore at bench.py's 671M configuration
    (full width and depth; batch 8, seq 1024, AdamW(lr), f32 mu): an
    uninterrupted 5-step reference in process; lm_train with save_every 2 in
    a child process that a preemption at step 3 SIGKILLs; lm_train resumed in
    process from the newest complete step, with a profiler window on its
    last step; lm_generate and lm_server restoring the run as their target;
    a profile and a drain command through the capture agent's mailbox.
    Returns the resumed run's launch counts and the phase's figures."""
    from polyaxon_tpu_torch.builtins.services import lm_server
    from polyaxon_tpu_torch.builtins.trainers import lm_generate, lm_train
    from polyaxon_tpu_torch.models import decode
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params
    from polyaxon_tpu_torch.parallel.templates import template_for
    from polyaxon_tpu_torch.runtime.checkpoint import CheckpointManager, latest_complete_step
    from polyaxon_tpu_torch.runtime.mesh import build_mesh
    from polyaxon_tpu_torch.runtime.optim import AdamW, tree_leaves
    from polyaxon_tpu_torch.serving import ServingEngine
    from polyaxon_tpu_torch.tracking.capture import configure
    from polyaxon_tpu_torch.tracking.context import Context

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    figures = {"filesystem": _filesystem(tmp)}
    log(f"checkpoint phase: {tmp} on {figures['filesystem']}")
    try:
        run = tmp / "runs" / CKPT_RUN
        ckpt_dir = run / "checkpoints"
        (run / "outputs").mkdir(parents=True)
        dirs = {"outputs_path": str(run / "outputs"), "checkpoints_path": str(ckpt_dir)}
        train = dict(BENCH_MODEL, seq=TRAIN_SEQ, batch=CKPT_BATCH, steps=CKPT_STEPS, lr=LR,
                     device="cuda", save_every=CKPT_EVERY, preempt_step=CKPT_PREEMPT)
        cfg = TransformerConfig(max_seq=TRAIN_SEQ, **BENCH_MODEL)
        V = cfg.vocab_size

        # 1. The uninterrupted reference: lm_train's weights, batch and template.
        mesh = build_mesh({"data": 1})
        ts, params, opt_state, batch = _train_setup(
            cfg, AdamW(LR), CKPT_BATCH, TRAIN_SEQ, template_for("ddp", dict(mesh.shape)), mesh)
        ref_losses, ref_params = [], []
        for _ in range(CKPT_STEPS):
            params, opt_state, m = ts.step(params, opt_state, batch)
            ref_losses.append(m["loss"].item())
            ref_params.append([p.detach().cpu() for p in tree_leaves(params)])
        log(f"uninterrupted reference: losses {ref_losses}")
        del ts, params, opt_state, batch, m
        _free()

        # 2. The preempted run, in a child process that has the card to itself.
        code = ("from polyaxon_tpu_torch.builtins.trainers import lm_train\n"
                "from polyaxon_tpu_torch.tracking.context import Context\n"
                f"lm_train(Context(params={train!r}, seed={SEED}, **{dirs!r}))\n")
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent,
                               capture_output=True, text=True, timeout=900)
        child_s = time.perf_counter() - t0
        for line in child.stdout.splitlines():
            log(f"  child: {line}")
        left_dirs = sorted(p.name for p in ckpt_dir.iterdir())
        left_marks = sorted(p.name for p in (ckpt_dir / ".complete").iterdir())
        left = latest_complete_step(ckpt_dir)
        marked = {int(n) for n in left_marks if n.isdigit()} & \
            {int(n) for n in left_dirs if n.isdigit()}
        log(f"preempted child: rc {child.returncode} in {child_s:.2f} s; left {left_dirs}, "
            f"markers {left_marks}; latest_complete_step {left}")
        if child.returncode != -signal.SIGKILL:
            raise AssertionError(f"the preempted child ended with rc {child.returncode}, not "
                                 f"-9: {child.stderr[-2000:]}")
        if left is None or left != max(marked):
            raise AssertionError(f"latest_complete_step {left} is not the newest marked step "
                                 f"dir of {left_dirs} / {left_marks}")

        # 3. The resumed run, with a profiler window on its last step.
        records = []
        ctx = Context(params=dict(train, profile_start=CKPT_STEPS - 1, profile_steps=1),
                      seed=SEED, records=records, **dirs)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        lm_train(ctx)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        launches = _counts()
        logs = [r["line"] for r in records if r["kind"] == "log"]
        by_step = {}
        for r in records:
            if r["kind"] == "metric":
                by_step.setdefault(r["step"], {}).update(r["values"])
        for line in logs:
            log(f"  {line}")
        if f"restored checkpoint at step {left}" not in logs:
            raise AssertionError(f"the resumed run did not restore step {left}: {logs}")
        loss, want = by_step[CKPT_STEPS - 1]["loss"], ref_losses[-1]
        rel = abs(loss - want) / abs(want)
        saves = [{"step": s, "block_s": v["ckpt_save_block_s"], "write_s": v["ckpt_write_s"],
                  "bytes": v["ckpt_bytes"], "write_GBps": v["ckpt_bytes"] / v["ckpt_write_s"] / 1e9}
                 for s, v in sorted(by_step.items()) if "ckpt_bytes" in v]
        steps_run = CKPT_STEPS - (left + 1)
        (trace,) = (run / "outputs" / "profile").glob("*.pt.trace.json")
        in_trace = kernel_launches_in_trace(trace)
        n = BENCH_MODEL["n_layers"]
        log(f"resumed lm_train: {steps_run} steps in {resume_s:.2f} s, final loss {loss!r} vs the "
            f"uninterrupted {want!r} (rel diff {rel:.3e} <= 1e-6; bitwise equal {loss == want}); "
            f"launches fwd/dq/dkv {launches}; the profiled step's trace {in_trace}; "
            f"ckpt_block_s {by_step[CKPT_STEPS]['ckpt_block_s']} per step; saves {saves}; peak "
            f"memory allocated {torch.cuda.max_memory_allocated()} B")
        if rel > 1e-6:
            raise AssertionError("the resumed run's final loss is not the uninterrupted run's")
        if launches != (n * steps_run,) * 3:
            raise AssertionError(f"expected {n * steps_run} launches of each kernel, got {launches}")
        if set(in_trace.values()) != {n}:
            raise AssertionError(f"the profiled step's trace holds {in_trace}, not {n} of each")
        if [s["step"] for s in saves] != [s for s in range(left + 1, CKPT_STEPS)
                                           if s % CKPT_EVERY == 0]:
            raise AssertionError(f"the resumed run saved {saves}")
        _free()
        figures.update(preempted_child={"rc": child.returncode, "seconds": child_s,
                                        "left": left_dirs, "markers": left_marks,
                                        "latest_complete_step": left},
                       resumed={"restored_step": left, "final_loss": loss,
                                "uninterrupted_loss": want, "bitwise_equal": loss == want,
                                "launches": launches, "trace_launches": in_trace,
                                "seconds": resume_s}, saves=saves)
        newest = latest_complete_step(ckpt_dir)

        # 4. lm_generate with the run as its target, against the static
        # generate on the reference's last params.
        gen_records = []
        out = lm_generate(Context(params=dict(BENCH_MODEL, seq=TRAIN_SEQ, batch=CKPT_GEN_BATCH,
                                              prompt_len=CKPT_PROMPT, max_new_tokens=CKPT_NEW,
                                              device="cuda", target=CKPT_RUN),
                                  seed=SEED, runs_root=str(tmp / "runs"), records=gen_records))
        template = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 1))
        for leaf, ref in zip(tree_leaves(template), ref_params[-1]):
            leaf.copy_(ref)
        prompt = torch.as_tensor(np.random.default_rng(SEED).integers(0, V, (CKPT_GEN_BATCH,
                                                                             CKPT_PROMPT)),
                                 device="cuda")
        want_tokens = decode.generate(template, prompt, cfg, max_new_tokens=CKPT_NEW,
                                      device="cuda")
        restore_line = [r["line"] for r in gen_records if r["kind"] == "log"][0]
        log(f"lm_generate target: {restore_line}; tokens equal the static generate's on the "
            f"reference's step {CKPT_STEPS - 1} params: {torch.equal(out, want_tokens)}")
        if restore_line != f"restored weights from run {CKPT_RUN} step {newest}" or \
                not torch.equal(out, want_tokens):
            raise AssertionError("lm_generate's target tokens are not the step's")

        # The restores, timed: weights only, then weights and optimizer state.
        mgr = CheckpointManager(ckpt_dir)
        fresh = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = mgr.restore_params(fresh)
        torch.cuda.synchronize()
        params_s = time.perf_counter() - t0
        diff = max((leaf.cpu() - ref).abs().max().item()
                   for leaf, ref in zip(tree_leaves(restored["params"]), ref_params[-1]))
        opt_template = AdamW(LR).init(fresh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.restore(fresh, opt_template)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        mgr.close()
        del fresh, opt_template, restored
        sizes = {p.name: p.stat().st_size for p in (ckpt_dir / str(newest)).iterdir()}
        log(f"restore of step {newest}: weights only {params_s:.3f} s ({sizes['params.pt']} B), "
            f"weights and optimizer {full_s:.3f} s ({sum(sizes.values())} B); restored leaves "
            f"against the reference's: max abs diff {diff}")
        if diff != 0:
            raise AssertionError("the restored weights are not the reference's")
        figures.update(restore_s={"params": params_s, "full": full_s}, files=sizes,
                       restored_max_abs_diff=diff)

        # 5. lm_server with the same target: its tokens against an engine on
        # the reference's params; a profile and a drain command.
        prompts = [np.random.default_rng(SEED + 5 + i).integers(0, V, CKPT_PROMPT >> i).tolist()
                   for i in range(2)]
        engine = ServingEngine(template, cfg, slots=CKPT_SLOTS, max_len=TRAIN_SEQ,
                               device="cuda").start()
        try:
            engine_tokens = [engine.submit(p, CKPT_NEW).wait(timeout=300) for p in prompts]
        finally:
            engine.stop()
        static = [decode.generate(template, torch.tensor([p], device="cuda"), cfg,
                                  max_new_tokens=CKPT_NEW, device="cuda")[0].tolist()
                  for p in prompts]
        del template, engine
        _free()
        mailbox = tmp / "commands" / "proc0"
        mailbox.mkdir(parents=True)
        reporter = _Reporter()
        agent = configure(reporter=reporter, mailbox=mailbox, profiles_root=tmp / "profiles")
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        server_records, errors = [], []
        sctx = Context(params=dict(BENCH_MODEL, seq=TRAIN_SEQ, slots=CKPT_SLOTS,
                                   max_new_tokens=CKPT_NEW, service_port=port, host="127.0.0.1",
                                   device="cuda", target=CKPT_RUN),
                       seed=SEED, runs_root=str(tmp / "runs"), records=server_records)

        def serve():
            try:
                lm_server(sctx)
            except Exception as e:  # re-raised by the main thread
                errors.append(e)

        server = threading.Thread(target=serve, name="lm_server", daemon=True)
        server.start()
        try:
            health = _await_ready(base, errors, "lm_server with a target")
            answers = [_http(base, "/generate", {"prompts": [p], "max_new_tokens": CKPT_NEW})
                       for p in prompts]
            served = [body["tokens"][0] if status == 200 else body for status, body in answers]
            agree = [sum(a == b for a, b in zip(s, t)) for s, t in zip(served, static)]
            restored_line = f"lm_server: restored run {CKPT_RUN} step {newest}"
            logged = restored_line in [r["line"] for r in server_records if r["kind"] == "log"]
            log(f"lm_server target: /healthz target {health['target']} checkpoint_step "
                f"{health['checkpoint_step']}; logged {restored_line!r}: {logged}; two requests "
                f"equal the engine's tokens on the reference's params: "
                f"{served == engine_tokens}; tokens equal to the static generate's {agree} of "
                f"{CKPT_NEW}")
            if health["checkpoint_step"] != newest or health["target"] != CKPT_RUN or \
                    not logged or served != engine_tokens:
                raise AssertionError(f"lm_server's target: {health}, {served}, {engine_tokens}")

            (mailbox / "cap1.json").write_text(json.dumps({
                "uuid": "cap1", "kind": "profile",
                "payload": {"capture_id": "cap1", "num_steps": CKPT_WINDOW}}))
            agent.poll()
            status, _ = _http(base, "/generate", {"prompts": [prompts[0]],
                                                  "max_new_tokens": CKPT_NEW})
            manifest_path = tmp / "profiles" / "cap1" / "proc0" / "manifest.json"
            deadline = time.time() + 60
            while not manifest_path.exists() and time.time() < deadline:
                time.sleep(0.05)
            manifest = json.loads(manifest_path.read_text())
            traces = sorted((manifest_path.parent / "trace").glob("*.pt.trace.json"))
            kernels = sum(e.get("cat") == "kernel" for e in
                          json.loads(traces[0].read_text())["traceEvents"]) if traces else 0
            log(f"profile command: /generate {status}; manifest num_steps "
                f"{manifest['num_steps']} start_step {manifest['start_step']} attrs "
                f"{manifest['attrs']} artifacts {manifest['artifacts']}; {kernels} kernel "
                f"events in the trace")
            if status != 200 or manifest["num_steps"] != CKPT_WINDOW or \
                    not manifest["attrs"]["trace"] or not kernels or \
                    not any(a.endswith("memory.json") for a in manifest["artifacts"]):
                raise AssertionError("the profile command gave no trace of the decode steps")

            (mailbox / "drain1.json").write_text(json.dumps({"uuid": "drain1", "kind": "drain"}))
            agent.poll()
            state = _http(base, "/healthz")[1]["state"]
            status, body = _http(base, "/generate", {"prompts": [prompts[1]],
                                                     "max_new_tokens": 4})
            log(f"drain command: state {state}; a new /generate {status} {body}; commands "
                f"{reporter.commands}")
            if state != "draining" or status != 503 or body["error"]["kind"] != "draining" or \
                    ("drain1", "complete", "engine draining") not in reporter.commands or \
                    ("cap1", "complete", None) not in reporter.commands:
                raise AssertionError("the drain command did not drain lm_server")
        finally:
            sctx.stop.set()
            server.join(timeout=120)
            configure(reporter=None, mailbox=None, profiles_root=None)
        if server.is_alive() or errors:
            raise AssertionError(f"lm_server did not stop cleanly: {errors}")
        figures.update(lm_server={"checkpoint_step": health["checkpoint_step"],
                                  "tokens_equal_engine": True,
                                  "tokens_equal_static_generate": agree,
                                  "capture_steps": manifest["num_steps"],
                                  "trace_kernel_events": kernels})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    figures["seconds"] = time.perf_counter() - t_phase
    log(f"checkpoint phase: {figures['seconds']:.1f} s")
    return launches, figures


def _serving_model():
    """The 671M model at lm_server's length, weights from the seed, as
    phases 10-12 make them."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(max_seq=SERVE_SEQ, **BENCH_MODEL)
    return init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED)), cfg


def _family_engine(params, cfg, kv, eager=False, **kw):
    from polyaxon_tpu_torch.serving import ServingEngine

    return ServingEngine(params, cfg, slots=SERVE_SLOTS, max_len=SERVE_SEQ,
                         block_size=SERVE_BLOCK, prefill_chunk=SERVE_CHUNK, spec_decode=True,
                         spec_k=SPEC_K, kv_quantize=kv, warmup=False, device="cuda",
                         _eager=eager, **kw)


def _fill_slots(engine, rng, length=512):
    """Every slot of an engine that has not started: a prompt of ``length``
    tokens through the eager chunk step into its own blocks, and the slot's
    host state at the next position (as the engine leaves a slot after its
    prefill)."""
    from polyaxon_tpu_torch.models import decode

    W = engine._table_width
    engine._tables[:] = 1 + rng.permutation(engine.slots * W).reshape(engine.slots, W)
    for slot in range(engine.slots):
        table = torch.as_tensor(engine._tables[slot], device="cuda")
        prompt = rng.integers(0, engine.cfg.vocab_size, length)
        for start in range(0, length, SERVE_CHUNK):
            chunk = torch.as_tensor(prompt[start:start + SERVE_CHUNK], device="cuda")
            decode.paged_prefill_chunk(engine._params, engine._pool, table, chunk, start,
                                       len(chunk), engine.cfg)
    engine._tok[:] = rng.integers(0, engine.cfg.vocab_size, engine.slots)
    engine._pos[:] = length
    engine._active[:] = True


def phase_graph_family():
    """(a) Each member of the serving engine's step family at the 671M width,
    captured, against the eager step function on a clone of the same pool
    and the same inputs: the decode step at 8 live slots, every chunk bucket
    up to 256 (real rows 3 fewer than the bucket where it has room, at
    position 512 of slot 0), every verify width at spec_k 4 (each lane
    drafting the full width), on a bf16 and an int8 pool.  The same argmax
    on every row, logits within GRAPH_ATOL of the largest absolute logit, and
    every pool block but the trash block equal after the step (rows that
    land in block 0 do so in an order the card does not fix)."""
    from polyaxon_tpu_torch.models import decode

    params, cfg = _serving_model()
    rows = []
    for kv in (None, "int8"):
        engine = _family_engine(params, cfg, kv)
        rng = np.random.default_rng(SEED + 4)
        _fill_slots(engine, rng)
        host = dict(tables=engine._table_array(), pos=engine._pos.copy(),
                    active=engine._active.copy())
        S = engine.slots

        def eager_decode(pool, inputs):
            return decode.paged_decode_step(engine._params, pool, inputs["tables"],
                                            inputs["tokens"], inputs["pos"], inputs["active"],
                                            cfg)[0]

        def eager_chunk(pool, inputs):
            return decode.paged_prefill_chunk(engine._params, pool, inputs["table"],
                                              inputs["tokens"], inputs["start"],
                                              inputs["length"], cfg)[0]

        def eager_verify(pool, inputs):
            return decode.paged_verify_step(engine._params, pool, inputs["tables"],
                                            inputs["tokens"], inputs["pos"], inputs["n_tok"],
                                            inputs["active"], cfg)[0]

        cases = [("decode", engine._get_step(), dict(host, tokens=engine._tok.copy()),
                  eager_decode)]
        for c_pad in engine._warmup_buckets():
            n = c_pad - 3 if c_pad > 8 else c_pad
            tokens = np.zeros(c_pad, np.int64)
            tokens[:n] = rng.integers(0, cfg.vocab_size, n)
            cases.append((f"chunk {c_pad}", engine._get_chunk(c_pad),
                          dict(table=host["tables"][0], tokens=tokens, start=512, length=n),
                          eager_chunk))
        for width in engine._spec_widths():
            cases.append((f"verify {width}", engine._get_verify(width),
                          dict(host, tokens=rng.integers(0, cfg.vocab_size, (S, width)),
                               n_tok=np.full(S, width)), eager_verify))
        for label, entry, inputs, eager in cases:
            if entry.graph is None:
                raise AssertionError(f"{label}: the engine did not capture a CUDA graph")
            before = {name: leaf.clone() for name, leaf in engine._pool.items()}
            got = entry(**inputs).clone()
            want = eager(before, entry.inputs)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            argmax = torch.equal(got.argmax(-1), want.argmax(-1))
            pools = all(torch.equal(engine._pool[name][:, 1:], before[name][:, 1:])
                        for name in before)
            row = {"pool": kv or "bf16", "entry": label, "max_abs_err": err,
                   "largest_logit": scale, "argmax_equal": argmax, "pool_equal": pools,
                   "bitwise": torch.equal(got, want)}
            rows.append(row)
            log(f"graph vs eager, {row['pool']} pool, {label}: max abs err {err:.3e} of largest "
                f"|logit| {scale:.3f} (limit {GRAPH_ATOL:g} of it), argmax equal {argmax}, pool "
                f"equal {pools}, bitwise {row['bitwise']}")
            if not (argmax and pools and err <= GRAPH_ATOL * scale and
                    bool(torch.isfinite(got).all())):
                raise AssertionError(f"{label} on the {row['pool']} pool: the graph disagrees "
                                     "with the eager step")
            del before
        log(f"graph family, {kv or 'bf16'} pool: {engine._compiled_count()} entries captured")
        del engine
        _free()
    return {"entries": len(rows), "bitwise": sum(r["bitwise"] for r in rows),
            "max_rel_err": max(r["max_abs_err"] / r["largest_logit"] for r in rows)}


def phase_generate_graph():
    """(b) generate at the 671M width (batch 4, prompt 512, 64 new tokens,
    greedy): one captured decode step replayed, against a loop of eager
    one-token steps at int positions; the tokens must be equal.  Host clock
    around each, ended by a synchronize (the captured call includes its
    capture)."""
    from polyaxon_tpu_torch.models import decode

    params, cfg = _serving_model()
    params = decode.cast_weights(params, cfg)
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)), device="cuda")

    def eager_loop():
        cache = decode.init_cache(cfg, BATCH, PROMPT + NEW_TOKENS, "cuda")
        logits, cache = decode.prefill(params, prompt, cache, cfg, device="cuda")
        out = []
        for i in range(NEW_TOKENS):
            out.append(logits.argmax(-1))
            if i < NEW_TOKENS - 1:
                logits, cache = decode.decode_step(params, cache, out[-1], PROMPT + i, cfg)
        return torch.stack(out, dim=1)

    def captured():
        return decode.generate(params, prompt, cfg, max_new_tokens=NEW_TOKENS, device="cuda")

    figures = {}
    outs = {}
    for label, fn in (("eager", eager_loop), ("captured", captured)) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[label] = fn()
        torch.cuda.synchronize()
        figures[f"{label}_s"] = time.perf_counter() - t0  # the second run of each stays
    equal = torch.equal(outs["eager"], outs["captured"])
    log(f"generate 671M ({BATCH} x {PROMPT} prompt, {NEW_TOKENS} new, greedy): captured "
        f"{figures['captured_s']:.4f} s (capture included) vs eager loop "
        f"{figures['eager_s']:.4f} s; tokens equal: {equal}")
    if not equal:
        raise AssertionError("the captured generate gives other tokens than the eager loop")
    figures["tokens_equal"] = equal
    return figures


def phase_profile_graph_step():
    """(c) One paged decode step of the engine at 8 live slots, position 512,
    eager and captured in the same run (host state to the card, the step,
    the sampling and its host read, as the engine's step runs it), each under
    torch.profiler: device busy, wall, idle share, host-launched ops; the
    captured step must launch one graph."""
    params, cfg = _serving_model()
    out = {}
    for label, eager in (("eager", True), ("captured", False)):
        engine = _family_engine(params, cfg, None, eager=eager)
        _fill_slots(engine, np.random.default_rng(SEED + 5))
        prof = _profile(f"engine decode step, {label} ({SERVE_SLOTS} live slots, position 512)",
                        lambda: engine._decode().cpu(), 1, top=6)
        if prof is None:
            raise AssertionError(f"the {label} step's trace holds no device time")
        log(f"  host launches a step, {label}: {prof['host_launches']}")
        out[label] = prof
        del engine
        _free()
    graphs = out["captured"]["host_launches"].get("cudaGraphLaunch", 0)
    if graphs != 1 or out["eager"]["host_launches"].get("cudaGraphLaunch", 0):
        raise AssertionError(f"the captured step launched {graphs} graphs, not 1")
    return out


class _Recorder:
    """An engine whose submitted requests are kept in submission order."""

    def __init__(self, engine):
        self.engine, self.requests = engine, []

    def submit(self, *args):
        req = self.engine.submit(*args)
        self.requests.append(req)
        return req


def _loaded_prompts(vocab):
    rng = np.random.default_rng(LOADED_SEED)
    return [rng.integers(0, vocab, LOADED_LONG if i % 3 == 0 else LOADED_SHORT).tolist()
            for i in range(LOADED_N)]


def phase_loaded_arm():
    """(d) bench.py's loaded arm at the 671M width through poisson_load: the
    eager engine calibrates the rate (60% of the capacity its sequential
    service time of the first three prompts gives) and takes the load; the
    captured engine takes the same schedule.  Short-request TTFT p50/p99, the
    long requests' mean TTFT, tokens/s; every request completes on both with
    the same greedy tokens, and no entry is built after ready."""
    from polyaxon_tpu_torch.serving import ServingEngine
    from polyaxon_tpu_torch.serving.loadgen import _pct, poisson_load

    params, cfg = _serving_model()
    prompts = _loaded_prompts(cfg.vocab_size)
    rate, out, tokens = None, {}, {}
    for label, eager in (("eager", True), ("captured", False)):
        engine = ServingEngine(params, cfg, slots=SERVE_SLOTS, max_len=SERVE_SEQ,
                               block_size=SERVE_BLOCK, prefill_chunk=LOADED_CHUNK,
                               prefix_cache=False, seed=LOADED_SEED, device="cuda",
                               _eager=eager).start()
        try:
            if not engine.wait_ready(timeout=300):
                raise AssertionError(f"the {label} engine did not become ready")
            ready = engine.stats()
            for t in (LOADED_LONG, LOADED_SHORT):  # as bench.py: one of each first
                engine.submit([1] * t, 2).wait(timeout=300)
            if rate is None:
                t0 = time.perf_counter()
                for p in prompts[:3]:
                    engine.submit(p, LOADED_NEW).wait(timeout=300)
                svc = (time.perf_counter() - t0) / 3
                rate = LOADED_LOAD / svc
                log(f"loaded arm: sequential service time {svc:.4f} s -> offered {rate:.4f} rps")
            rec = _Recorder(engine)
            res = poisson_load(rec, prompts, LOADED_NEW, rate_rps=rate, seed=LOADED_SEED)
            tokens[label] = [r.tokens for r in rec.requests]
            stats = engine.stats()
        finally:
            engine.stop()
        short = sorted(t for i, t in enumerate(res["ttft_s"]) if i % 3 and t is not None)
        longs = [t for i, t in enumerate(res["ttft_s"]) if i % 3 == 0 and t is not None]
        out[label] = {
            "offered_rps": rate, "completed": res["completed"], "errors": res["errors"],
            "sheds": res["sheds"], "wall_s": res["wall_s"], "tokens_per_s": res["tokens_per_s"],
            "short_ttft_p50_s": _pct(short, 50), "short_ttft_p99_s": _pct(short, 99),
            "long_ttft_mean_s": float(np.mean(longs)) if longs else None,
            "decode_step_s_p50": engine.latency_summaries()["decode_step_s"]["p50"],
            "warmup": ready["warmup"], "steady_state_compiles": stats["steady_state_compiles"],
        }
        log(f"loaded arm, {label} engine: {out[label]}")
        if res["completed"] != LOADED_N or res["errors"] or stats["steady_state_compiles"]:
            raise AssertionError(f"the {label} engine under load: {out[label]}")
        del engine
        _free()
    same = sum(a == b for a, b in zip(tokens["eager"], tokens["captured"]))
    log(f"loaded arm: {same}/{LOADED_N} requests with equal greedy tokens on both engines")
    if same != LOADED_N:
        raise AssertionError("the captured engine gives other tokens than the eager one")
    return out


def phase_kv_offload(rate):
    """(e) bench.py's serving_kv_offload arm at the 671M width: the loaded
    arm's prompts at twice its calibrated ``rate`` against a pool of one long
    span plus two blocks, offload off and then on, on a bf16 and an int8
    pool, each beside an engine whose pool never fills (every prompt at
    once) for the tokens.  Offload on must complete 24 of 24 with 0 sheds
    and 0 errors, spill and restore blocks, build no entry after ready, and
    give every request the ample pool's greedy tokens."""
    from polyaxon_tpu_torch.models import decode
    from polyaxon_tpu_torch.serving import ServingEngine
    from polyaxon_tpu_torch.serving.loadgen import _pct, poisson_load

    params, cfg = _serving_model()
    prompts = _loaded_prompts(cfg.vocab_size)
    span = -(-(LOADED_LONG + LOADED_NEW) // OFFLOAD_BLOCK)
    blocks = 1 + span + 1
    orate = OFFLOAD_RATE_X * rate
    out = {"kv_blocks": blocks, "long_span_blocks": span, "offered_rps": orate}

    def engine(kv, **kw):
        return ServingEngine(params, cfg, slots=SERVE_SLOTS, max_len=SERVE_SEQ,
                             block_size=OFFLOAD_BLOCK, prefill_chunk=LOADED_CHUNK,
                             prefix_cache=False, warmup=True, kv_quantize=kv, device="cuda",
                             **kw).start()

    for kv in (None, "int8"):
        pool = kv or "bf16"
        block_mib = decode.kv_block_bytes(cfg, OFFLOAD_BLOCK, kv) / 2**20
        ample = engine(kv)
        try:
            if not ample.wait_ready(timeout=300):
                raise AssertionError("the ample engine did not become ready")
            reqs = [ample.submit(p, LOADED_NEW) for p in prompts]
            want = [r.wait(timeout=300) for r in reqs]
        finally:
            ample.stop()
        del ample
        _free()
        for offload in (False, True):
            label = f"{pool} pool, offload {'on' if offload else 'off'}"
            eng = engine(kv, num_blocks=blocks, kv_offload=offload)
            try:
                if not eng.wait_ready(timeout=300):
                    raise AssertionError(f"{label}: the engine did not become ready")
                rec = _Recorder(eng)
                res = poisson_load(rec, prompts, LOADED_NEW, rate_rps=orate, seed=OFFLOAD_SEED)
                got = [(r.tokens if r.error is None else None) for r in rec.requests]
                stats = eng.stats()
                copies = eng._copy_figures()
            finally:
                eng.stop()
            short = sorted(t for i, t in enumerate(res["ttft_s"]) if i % 3 and t is not None)
            row = {
                "completed": res["completed"], "sheds": res["sheds"], "errors": res["errors"],
                "ttft_p50_s": res["ttft_p50_s"], "ttft_p99_s": res["ttft_p99_s"],
                "short_ttft_p50_s": _pct(short, 50), "short_ttft_p99_s": _pct(short, 99),
                "tokens_per_s": res["tokens_per_s"], "wall_s": res["wall_s"],
                "block_parks": stats["block_parks"],
                "spilled_blocks": stats["host_spilled_blocks_total"],
                "restored_blocks": stats["host_restored_blocks_total"],
                "steady_state_compiles": stats["steady_state_compiles"],
                "tokens_equal": sum(g == w for g, w in zip(got, want)),
                "block_mib": block_mib,
            }
            for kind in ("spill", "restore"):
                c = copies[kind]
                row[f"{kind}_gb_per_s"] = c["bytes"] / c["copy_s"] / 1e9 if c["copy_s"] else None
                row[f"{kind}_copy_s"] = c["copy_s"]
                row[f"{kind}_bytes"] = c["bytes"]
                row[f"{kind}_host_s"] = c["host_s"]
            if offload:
                row["spill_host_ms_per_park"] = (1e3 * copies["spill"]["host_s"] / stats["block_parks"]
                                                 if stats["block_parks"] else None)
                row["restore_host_ms_per_block"] = (
                    1e3 * copies["restore"]["host_s"] / copies["restore"]["blocks"]
                    if copies["restore"]["blocks"] else None)
            out[f"{pool}_{'on' if offload else 'off'}"] = row
            log(f"kv offload A/B, {label}: {row}")
            del eng
            _free()
            if offload and not (row["completed"] == LOADED_N and row["sheds"] == 0
                                and row["errors"] == 0 and row["spilled_blocks"] > 0
                                and row["restored_blocks"] > 0
                                and row["steady_state_compiles"] == 0
                                and row["tokens_equal"] == LOADED_N):
                raise AssertionError(f"{label}: {row}")
            if not offload and row["steady_state_compiles"]:
                raise AssertionError(f"{label}: an entry was built after ready: {row}")
        out[f"{pool}_demotion"] = _kv_demotion(params, cfg, kv)
    return out


def _kv_demotion(params, cfg, kv):
    """Prefix reuse that demotes: shared prefixes served one after another
    against a pool that holds fewer of them than the traffic cycles
    through, with the tier armed and the step family captured, beside an
    engine whose pool never fills.  Demotions export single blocks between
    replays and hits restore them in place inside admission; every request
    must get the ample engine's tokens, with demotions and restores above 0
    and no entry built after ready."""
    from polyaxon_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(DM_SEED)
    prefixes = [rng.integers(0, cfg.vocab_size, DM_PREFIX).tolist() for _ in range(DM_PREFIXES)]
    prompts = [prefixes[i % DM_PREFIXES] + rng.integers(0, cfg.vocab_size, DM_TAIL).tolist()
               for i in range(DM_PREFIXES * DM_ROUNDS)]
    label = f"{kv or 'bf16'} pool, prefix demotion"
    outs, stats = [], []
    for kw in (dict(num_blocks=DM_BLOCKS, kv_offload=True), {}):
        eng = ServingEngine(params, cfg, slots=SERVE_SLOTS, max_len=SERVE_SEQ,
                            block_size=OFFLOAD_BLOCK, prefill_chunk=LOADED_CHUNK,
                            prefix_cache=True, warmup=True, kv_quantize=kv, device="cuda",
                            **kw).start()
        try:
            if not eng.wait_ready(timeout=300):
                raise AssertionError(f"{label}: the engine did not become ready")
            outs.append([eng.submit(p, DM_NEW).wait(timeout=300) for p in prompts])
            stats.append(eng.stats())
        finally:
            eng.stop()
        del eng
        _free()
    s = stats[0]
    row = {key: s[key] for key in ("prefix_cache_hits", "prefix_cache_demotions",
                                   "prefix_cache_restores", "host_spilled_blocks_total",
                                   "host_restored_blocks_total", "requests_shed",
                                   "steady_state_compiles")}
    row["tokens_equal"] = sum(a == b for a, b in zip(*outs))
    log(f"kv offload, {label}: {row}")
    if not (row["tokens_equal"] == len(prompts) and row["prefix_cache_demotions"] > 0
            and row["prefix_cache_restores"] > 0 and row["requests_shed"] == 0
            and row["steady_state_compiles"] == 0):
        raise AssertionError(f"{label}: {row}")
    return row


def phase_warm_boot():
    """(f) bench.py's serving_warm_boot arm at the 671M width: an incumbent
    serves the two prefixes and persists its hottest blocks on stop; a cold
    and a warm replacement take the same seeded schedule.  The warm one must
    have preloaded blocks (the cold one none), give the probe the cold one's
    tokens, and build no entry after ready."""
    from polyaxon_tpu_torch.models import decode
    from polyaxon_tpu_torch.serving import ServingEngine, kvstore
    from polyaxon_tpu_torch.serving.loadgen import poisson_load

    params, cfg = _serving_model()
    rng = np.random.default_rng(WB_SEED)
    prefixes = [rng.integers(0, cfg.vocab_size, WB_PREFIX).tolist() for _ in range(WB_PREFIXES)]
    prompts = [prefixes[i % WB_PREFIXES] + rng.integers(0, cfg.vocab_size, WB_TAIL).tolist()
               for i in range(WB_N)]
    probe = prefixes[0] + [3, 1, 4, 1, 5, 9, 2, 6]
    block_bytes = decode.kv_block_bytes(cfg, OFFLOAD_BLOCK)

    def engine(store):
        return ServingEngine(params, cfg, slots=SERVE_SLOTS, max_len=SERVE_SEQ,
                             block_size=OFFLOAD_BLOCK, num_blocks=WB_BLOCKS,
                             prefill_chunk=LOADED_CHUNK, prefix_cache=True, warmup=True,
                             kv_persist_dir=store, kv_persist_sig="bench",
                             kv_persist_blocks=WB_PERSIST, device="cuda").start()

    out = {}
    store = tempfile.mkdtemp(prefix="chip_smoke_kv_")
    try:
        inc = engine(store)
        try:
            if not inc.wait_ready(timeout=300):
                raise AssertionError("the incumbent did not become ready")
            t0 = time.perf_counter()
            for pref in prefixes:
                inc.submit(list(pref), WB_NEW).wait(timeout=300)
            svc = (time.perf_counter() - t0) / WB_PREFIXES
        finally:
            t0 = time.perf_counter()
            inc.stop()  # the final snapshot
            stop_s = time.perf_counter() - t0
        version = kvstore.latest_complete_version(store)
        saved = inc.stats()["kv_persisted_blocks"]
        npz = Path(store) / str(version) / "blocks.npz"
        out["save"] = {"blocks": saved, "bytes": npz.stat().st_size, "stop_s": stop_s,
                       "gb_per_s": npz.stat().st_size / stop_s / 1e9, "version": version}
        del inc
        _free()
        rate = WB_LOAD / svc
        out["offered_rps"] = rate
        for label, where in (("cold", None), ("warm", store)):
            eng = engine(where)
            try:
                if not eng.wait_ready(timeout=300):
                    raise AssertionError(f"the {label} replacement did not become ready")
                ready = eng.stats()
                res = poisson_load(eng, prompts, WB_NEW, rate_rps=rate, seed=WB_LOAD_SEED)
                probe_tokens = eng.submit(list(probe), WB_NEW).wait(timeout=300)
                stats = eng.stats()
            finally:
                eng.stop()
            out[label] = {
                "kv_preloaded_blocks": ready["kv_preloaded_blocks"],
                "ready_s": ready["warmup"]["ready_s"],
                "completed": res["completed"], "errors": res["errors"],
                "ttft_p50_s": res["ttft_p50_s"], "ttft_p99_s": res["ttft_p99_s"],
                "ttft_mean_s": res["ttft_mean_s"],
                "prefix_cache_hit_rate": stats["prefix_cache_hit_rate"],
                "steady_state_compiles": stats["steady_state_compiles"],
                "probe_tokens": probe_tokens,
            }
            log(f"warm boot, {label} replacement: "
                f"{ {k: v for k, v in out[label].items() if k != 'probe_tokens'} }")
            del eng
            _free()
        # The preload alone, on an engine that is not started: the store
        # read, then the whole preload (read, copies to the card, installs).
        eng = ServingEngine(params, cfg, slots=SERVE_SLOTS, max_len=SERVE_SEQ,
                            block_size=OFFLOAD_BLOCK, num_blocks=WB_BLOCKS,
                            prefill_chunk=LOADED_CHUNK, prefix_cache=True, kv_persist_dir=store,
                            kv_persist_sig="bench", kv_persist_blocks=WB_PERSIST, device="cuda")
        t0 = time.perf_counter()
        kvstore.load_prefix_store(store, expect=eng._kv_store_meta())
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng._preload_prefixes()
        eng._copy_figures()
        preload_s = time.perf_counter() - t0
        eng.stop()
        del eng
        _free()
    finally:
        shutil.rmtree(store, ignore_errors=True)
    cold, warm = out["cold"], out["warm"]
    out["preload"] = {"blocks": warm["kv_preloaded_blocks"],
                      "bytes": warm["kv_preloaded_blocks"] * block_bytes,
                      "ready_s_over_cold": warm["ready_s"] - cold["ready_s"],
                      "store_read_s": load_s, "preload_s": preload_s}
    out["token_identical"] = cold["probe_tokens"] == warm["probe_tokens"]
    log(f"warm boot: save {out['save']}, preload {out['preload']}, probe tokens equal "
        f"{out['token_identical']}")
    if not (out["token_identical"] and warm["kv_preloaded_blocks"] > 0
            and cold["kv_preloaded_blocks"] == 0 and saved > 0
            and cold["completed"] == warm["completed"] == WB_N
            and cold["steady_state_compiles"] == warm["steady_state_compiles"] == 0):
        raise AssertionError(f"warm boot: {out}")
    for side in (cold, warm):
        side.pop("probe_tokens")
    return out


def phase_tracing():
    """(g) bench.py's trace-overhead arm at the 671M width: interleaved
    runs with request tracing off and on (16 a side in turns, the minimum
    wall of each), 16 prompts of 24 tokens queued at once; the overhead must
    stay under 3% and every traced request's waterfall within 10% of its
    client latency.  Then one lm_server /generate with a traceparent header: the
    answer carries that trace id, and /v1/trace/<id> returns
    serving.generate, serving.request and serving.queue_wait under it."""
    from polyaxon_tpu_torch.builtins.services import lm_server
    from polyaxon_tpu_torch.serving import ServingEngine
    from polyaxon_tpu_torch.tracking.context import Context
    from polyaxon_tpu_torch.tracking.trace import TraceContext, new_trace_id

    params, cfg = _serving_model()
    rng = np.random.default_rng(SEED + 7)
    prompts = [rng.integers(0, cfg.vocab_size, TRACE_PROMPT).tolist() for _ in range(TRACE_N)]

    # The collector stays on, as in lm_server: the span records, waterfalls
    # and exemplars that tracing allocates are part of what it costs.  A
    # callback counts the collections and their time in each timed run, so
    # the readout says what share of the difference they are.
    collections = {"n": 0, "s": 0.0, "t0": 0.0}

    def on_collect(phase, info):
        if phase == "start":
            collections["t0"] = time.perf_counter()
        else:
            collections["n"] += 1
            collections["s"] += time.perf_counter() - collections["t0"]

    def run(eng, traced):
        eng.trace_requests = traced
        eng.submit([1] * TRACE_PROMPT, 2).wait(timeout=300)  # the card busy again
        n0, s0 = collections["n"], collections["s"]
        t0 = time.perf_counter()
        # All 16 queued before the scheduler admits any (submit takes the
        # engine's reentrant lock too), so every run steps the same batches.
        with eng._cv:
            pending = [(eng.submit(p, TRACE_NEW,
                                   trace=TraceContext(new_trace_id()) if traced else None),
                        time.perf_counter()) for p in prompts]
        errs = []
        for i, (r, ts) in enumerate(pending):
            r.wait(timeout=300)
            lat = time.perf_counter() - ts
            woke = time.time()
            if r.trace_summary is not None:
                total = sum(r.trace_summary["waterfall"].values())
                errs.append((abs(total - lat) / lat * 100, {
                    "request": i, "client_s": lat, "waterfall_s": total,
                    "woke_after_finish_s": woke - r.finished_at}))
        wall = time.perf_counter() - t0
        if traced and len(errs) != TRACE_N:
            raise AssertionError(f"{len(errs)} of {TRACE_N} traced requests have a waterfall")
        return wall, errs, collections["n"] - n0, collections["s"] - s0

    # One engine for every run (tracing switched between runs), so the runs
    # differ only by tracing, not by a new capture of the step family.
    eng = ServingEngine(params, cfg, slots=TRACE_SLOTS, max_len=SERVE_SEQ, prefix_cache=False,
                        warmup=True, device="cuda").start()
    walls = {False: [], True: []}
    gcs = {False: [0, 0.0], True: [0, 0.0]}
    errs = []
    gc.callbacks.append(on_collect)
    try:
        if not eng.wait_ready(timeout=300):
            raise AssertionError("the tracing engine did not become ready")
        run(eng, False)  # untimed: the card and the host settle first
        # In turns, off, on, on, off, on, off, off, on: a drift across the
        # runs falls on both sides.
        for traced in ((False, True, True, False, True, False, False, True)
                       * TRACE_REPS)[:2 * TRACE_REPS]:
            wall, e, n_gc, s_gc = run(eng, traced)
            walls[traced].append(wall)
            gcs[traced][0] += n_gc
            gcs[traced][1] += s_gc
            errs += e
        if eng.stats()["steady_state_compiles"]:
            raise AssertionError("the tracing engine built an entry after ready")
    finally:
        gc.callbacks.remove(on_collect)
        eng.stop()
    off, on = min(walls[False]), min(walls[True])
    out = {"walls_off_s": walls[False], "walls_on_s": walls[True],
           "overhead_pct": max(0.0, (on - off) / off * 100),
           "waterfall_err_pct": max(e for e, _ in errs),
           "waterfall_worst": max(errs, key=lambda e: e[0])[1],
           "gc_collections_off": gcs[False][0], "gc_collections_on": gcs[True][0],
           "gc_s_off": gcs[False][1], "gc_s_on": gcs[True][1]}
    log(f"tracing at 671M: {out}")
    if not (out["overhead_pct"] < TRACE_BUDGET_PCT and out["waterfall_err_pct"] <= WATERFALL_PCT):
        raise AssertionError(f"request tracing: {out}")

    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    ctx = Context(params=dict(BENCH_MODEL, seq=SERVE_SEQ, slots=TRACE_SLOTS,
                              block_size=SERVE_BLOCK, service_port=port, host="127.0.0.1",
                              device="cuda"), seed=SEED, records=[])
    errors = []

    def serve():
        try:
            lm_server(ctx)
        except Exception as e:  # re-raised by the main thread
            errors.append(e)

    server = threading.Thread(target=serve, name="lm_server", daemon=True)
    server.start()
    try:
        _await_ready(base, errors, "lm_server (tracing)")
        trace_id = new_trace_id()
        status, body = _http(base, "/generate",
                             {"prompts": [prompts[0]], "max_new_tokens": TRACE_NEW},
                             headers={"traceparent": f"00-{trace_id}-00f067aa0ba902b7-01"})
        want = {"serving.generate", "serving.request", "serving.queue_wait"}
        deadline = time.time() + 30
        while True:  # serving.generate is recorded once the answer is out
            spans = _http(base, f"/v1/trace/{trace_id}")[1]["spans"]
            names = {s["name"] for s in spans if s.get("trace_id") == trace_id}
            if want <= names or time.time() > deadline:
                break
            time.sleep(0.05)
        out["lm_server"] = {"status": status, "trace_id_equal": body.get("trace", {}).get(
            "trace_id") == trace_id, "spans": sorted(names),
            "waterfalls": len(body.get("trace", {}).get("waterfalls", []))}
        log(f"lm_server traceparent round trip: {out['lm_server']}")
        if not (status == 200 and out["lm_server"]["trace_id_equal"] and want <= names
                and out["lm_server"]["waterfalls"] == 1):
            raise AssertionError(f"lm_server tracing: {out['lm_server']}")
    finally:
        ctx.stop.set()
        server.join(timeout=120)
    if server.is_alive() or errors:
        raise AssertionError(f"lm_server (tracing) did not stop cleanly: {errors}")
    return out


# -- the serving fleet (phases 25-27) ---------------------------------------------

#: Every fleet this run started: its replicas run in sessions of their own, so a
#: run that dies must still take them down (an atexit hook SIGKILLs what is left).
_FLEETS = []


def _kill_fleets() -> None:
    for fleet in _FLEETS:
        for ref in list(fleet._procs.values()):
            ref.signal(signal.SIGKILL)


atexit.register(_kill_fleets)


def _fleet(workdir, replicas, slots, router, **kw):
    """A LocalServingFleet of lm_server's 671M configuration on the card."""
    from polyaxon_tpu_torch.serving import LocalServingFleet

    fleet = LocalServingFleet(Path(workdir), BENCH_MODEL, replicas=replicas, seq=SERVE_SEQ,
                              slots=slots, block_size=SERVE_BLOCK, prefill_chunk=SERVE_CHUNK,
                              seed=SEED, router=router,
                              env={"POLYAXON_TPU_SERVING_WARMUP": "1"}, device="cuda", **kw)
    _FLEETS.append(fleet)
    return fleet


def _fleet_router(**kw):
    from polyaxon_tpu_torch.serving import FleetRouter

    return FleetRouter(probe_timeout_s=1.0, retry_limit=2, eject_failures=2,
                       eject_backoff_s=0.5, **kw)


def _replica_log(fleet, name) -> str:
    path = fleet.workdir / f"{name}.log"
    return path.read_text(errors="replace") if path.exists() else ""


def _await_replicas(fleet, launched, timeout=300):
    """Seconds from launch to ``ready`` of each replica in ``launched`` (name
    -> perf_counter at launch), probing every 50 ms; a replica that exits or
    never gets there fails the run with its log."""
    boot = {}
    deadline = time.perf_counter() + timeout
    while len(boot) < len(launched):
        fleet.router.probe_all()
        for name, t0 in launched.items():
            if name in boot:
                continue
            rc = fleet._procs[name].poll()
            if rc is not None:
                raise AssertionError(f"replica {name} exited with rc {rc}:\n"
                                     f"{_replica_log(fleet, name)[-4000:]}")
            if fleet.router.replica(name).state == "ready":
                boot[name] = time.perf_counter() - t0
        if time.perf_counter() > deadline:
            raise AssertionError(f"replicas not ready in {timeout} s: {fleet.router.stats()}")
        time.sleep(0.05)
    return boot


def _start_fleet(fleet):
    t0 = time.perf_counter()
    fleet.start()
    return _await_replicas(fleet, {name: t0 for name in fleet._procs})


def _scale_up(fleet):
    t0 = time.perf_counter()
    name = fleet.scale_up()
    return name, _await_replicas(fleet, {name: t0})[name]


def _front(router, name):
    from http.server import ThreadingHTTPServer

    from polyaxon_tpu_torch.serving.router import make_router_handler

    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 make_router_handler(router, {"fleet_name": name}))
    threading.Thread(target=server.serve_forever, name=f"front-{name}", daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


#: What a replica's HTTP server may log when a client went away first (the
#: router's probes of a stalled replica time out and close their sockets).
_CLIENT_GONE = ("BrokenPipeError", "ConnectionResetError")


def _stop_fleet(fleet, front=None):
    """Stop the front and the fleet, then fail on any replica traceback but
    a write to a client that had gone (its handler threads may interleave
    their tracebacks, so every exception line is read, not each block)."""
    if front is not None:
        front.shutdown()
        front.server_close()
    fleet.stop()
    for log_path in sorted(fleet.workdir.glob("*.log")):
        text = log_path.read_text(errors="replace")
        lines = text.splitlines()
        raised = [ln for ln in lines if ln[:1].isalpha() and ln.split(":")[0].endswith(
            ("Error", "Exception", "Interrupt", "Exit"))]
        if any(not ln.startswith(_CLIENT_GONE) for ln in raised) or \
                len(raised) < sum(ln.startswith("Traceback") for ln in lines):
            raise AssertionError(f"replica {log_path.stem} logged a traceback:\n{text[-6000:]}")


def _replica_call(fleet, name, path, payload=None, timeout=600):
    status, body = _http(fleet.router.replica(name).base_url, path, payload, timeout=timeout)
    if status != 200:
        raise AssertionError(f"replica {name} {path}: {status} {body}")
    return body


def _steady_compiles(fleet):
    return {name: _replica_call(fleet, name, "/healthz")["engine"]["steady_state_compiles"]
            for name in fleet._procs}


def _fleet_warm(fleet, prompt, max_new):
    """One request straight at every replica before the timed run (bench.py's
    fleet_warm): the first request of a process pays its one-off costs."""
    for name in list(fleet._procs):
        _replica_call(fleet, name, "/generate", {"prompts": [prompt], "max_new_tokens": max_new})


def _record_generate(router):
    """Wrap the router's generate to keep what every routed request returned:
    (prompt, tokens, replica, engine-side TTFT, when)."""
    records = []
    generate = router.generate

    def recorded(prompts, *args, **kwargs):
        body = generate(prompts, *args, **kwargs)
        records.append({"prompt": list(prompts[0]), "tokens": body["tokens"][0],
                        "replica": body["replica"], "ttft_s": body["ttft_s"][0],
                        "at": time.perf_counter()})
        return body

    router.generate = recorded
    return records


def _burst_figures(res):
    return {k: res[k] for k in ("n_requests", "completed", "sheds", "errors", "failures",
                                "hangs", "wall_s", "tokens_per_s", "total_tokens",
                                "ttft_p50_s", "ttft_p99_s")}


def phase_fleet():
    """Phases 25 and 26 (bench.py's serving_fleet arms at the 671M width):
    the burst against N = 1 and N = 2 replicas with the boot times, one
    greedy prompt's tokens on every replica, through the router and from an
    in-process engine, a merged trace; then on the same two replicas the
    failover arm (a SIGKILL mid-load: no request lost, every completed
    request the survivor's tokens) and a SIGSTOPped replacement ejected and
    re-admitted.  Returns the figures."""
    from polyaxon_tpu_torch.serving import ServingEngine
    from polyaxon_tpu_torch.serving.loadgen import http_poisson_load, shared_prefix_prompts

    from polyaxon_tpu_torch.tracking.trace import get_tracer

    # This process is the fleet's router now.  Phases 11 and 17 ran
    # lm_server in it, which labelled its tracer "lm_server-<port>"; a span
    # id carries the label, and a label with a "-" makes a traceparent of
    # five fields, which the replica's extract() refuses (so its spans
    # would start a trace of their own).
    get_tracer().configure(process="router")
    V = BENCH_MODEL["vocab_size"]
    prompts = shared_prefix_prompts(FLEET_N, V, prefix_len=FLEET_PREFIX, suffix_len=FLEET_SUFFIX,
                                    groups=FLEET_GROUPS, seed=FLEET_SEED)
    probe = prompts[0][:FLEET_PREFIX] + [3, 1, 4, 1, 5, 9, 2, 6]
    out = {"boot_s": {}}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    try:
        # -- phase 25: N = 1, then N = 2 -------------------------------------
        bursts = {}
        for n in (1, 2):
            router = _fleet_router(probe_interval_s=0.2, request_timeout_s=300.0,
                                   shed_occupancy=1e9)
            fleet = _fleet(root / f"n{n}", n, SERVE_SLOTS, router)
            front = None
            try:
                boot = _start_fleet(fleet)
                out["boot_s"][f"n{n}"] = boot
                log(f"fleet N={n}: replicas ready after {boot} s (launch to ready)")
                front, url = _front(router, f"n{n}")
                _fleet_warm(fleet, prompts[0], 2 * FLEET_NEW)
                res = http_poisson_load(url, prompts, FLEET_NEW, rate_rps=FLEET_RPS,
                                        seed=FLEET_SEED, timeout_s=300.0)
                bursts[n] = dict(_burst_figures(res), steady_state_compiles=_steady_compiles(fleet))
                log(f"fleet N={n} burst: {bursts[n]}")
                if res["completed"] != FLEET_N or res["hangs"] or any(
                        bursts[n]["steady_state_compiles"].values()):
                    raise AssertionError(f"fleet N={n} burst: {bursts[n]}")
                if n == 1:
                    _stop_fleet(fleet, front)
                    continue
                # Identity: the probe's greedy tokens through the router, from
                # each replica, and from an in-process engine from the seed.
                status, body = _http(url, "/generate", {"prompts": [probe],
                                                        "max_new_tokens": FLEET_NEW})
                if status != 200:
                    raise AssertionError(f"the front answered {status}: {body}")
                routed = body["tokens"][0]
                direct = {name: _replica_call(fleet, name, "/generate",
                                              {"prompts": [probe], "max_new_tokens": FLEET_NEW}
                                              )["tokens"][0] for name in fleet._procs}
                params, cfg = _serving_model()
                engine = ServingEngine(params, cfg, slots=SERVE_SLOTS, max_len=SERVE_SEQ,
                                       block_size=SERVE_BLOCK, prefill_chunk=SERVE_CHUNK,
                                       seed=SEED, device="cuda").start()
                try:
                    if not engine.wait_ready(timeout=300):
                        raise AssertionError("the in-process engine did not become ready")
                    local = engine.submit(probe, FLEET_NEW).wait(timeout=300)
                finally:
                    engine.stop()
                del engine, params
                _free()
                same = all(t == routed for t in direct.values()) and local == routed
                out["identity"] = {"replicas": sorted(direct), "tokens_equal": same,
                                   "new_tokens": len(routed)}
                log(f"fleet identity: router, replicas {sorted(direct)} and the in-process "
                    f"engine give equal greedy tokens: {same}")
                if not same:
                    raise AssertionError(f"replicas disagree: routed {routed}, direct {direct}, "
                                         f"in-process {local}")
                # One traced request: the front's merged trace has a router
                # track and the serving replica's track.
                trace_id = body["trace"]["trace_id"]
                status, merged = _http(url, f"/v1/trace/{trace_id}")
                tracks = sorted({e["args"]["name"] for e in merged["chrome_trace"]["traceEvents"]
                                 if e["ph"] == "M" and e["name"] == "process_name"}) \
                    if status == 200 else []
                out["merged_trace"] = {"status": status, "tracks": tracks,
                                       "spans": len(merged.get("spans", []))}
                log(f"fleet merged trace {trace_id}: {out['merged_trace']}")
                if status != 200 or "router" not in tracks or body["replica"] not in tracks:
                    raise AssertionError(f"merged trace: {out['merged_trace']}")

                # -- phase 26: failover and ejection on the same fleet ----------
                records = _record_generate(router)
                victim, survivor = sorted(fleet._procs)
                kill_at = max(0.5, res["wall_s"] * 0.3)
                resf = http_poisson_load(url, prompts, FAILOVER_NEW, rate_rps=FLEET_RPS,
                                         seed=FAILOVER_SEED, timeout_s=300.0,
                                         kill_at_s={victim: kill_at}, fleet=fleet)
                counters = router.stats()["counters"]
                tail = [t for t in resf["ttft_s"][-(FLEET_N // 3):] if t is not None]
                want = _replica_call(fleet, survivor, "/generate",
                                     {"prompts": prompts, "max_new_tokens": FAILOVER_NEW})["tokens"]
                by_prompt = {tuple(p): t for p, t in zip(prompts, want)}
                equal = sum(r["tokens"] == by_prompt[tuple(r["prompt"])] for r in records)
                failover = dict(_burst_figures(resf), kill_at_s=kill_at, victim=victim,
                                router_failovers=counters["failovers"],
                                router_retries=counters["retries"],
                                router_ejections=counters["ejections"],
                                tail_ttft_p99_s=max(tail) if tail else None,
                                completed_equal_to_survivor=equal,
                                served_by={name: sum(r["replica"] == name for r in records)
                                           for name in (victim, survivor)})
                log(f"fleet failover (SIGKILL {victim} at {kill_at:.3f} s): {failover}")
                accounted = resf["completed"] + resf["sheds"] + resf["errors"]
                if accounted != FLEET_N or resf["hangs"] or resf["failures"]:
                    raise AssertionError(f"failover lost requests: {failover}")
                if equal != resf["completed"] or len(records) != resf["completed"]:
                    raise AssertionError(f"failover tokens differ from the survivor's: {failover}")

                # The dead replica is reaped before its replacement starts.
                deadline = time.time() + 30
                while victim in fleet._procs and time.time() < deadline:
                    fleet.poll()
                    time.sleep(0.05)
                if victim in fleet._procs:
                    raise AssertionError(f"replica {victim} was not reaped")
                repl, boot_s = _scale_up(fleet)
                out["boot_s"]["replacement"] = {repl: boot_s}
                failover["stall"] = _stall_and_resume(fleet, url, repl)
                out["failover"] = failover
            finally:
                if fleet._procs:
                    _stop_fleet(fleet, front)
        out["bursts"] = {f"n{n}": b for n, b in bursts.items()}
        out["scaleup"] = bursts[2]["tokens_per_s"] / bursts[1]["tokens_per_s"]
        log(f"fleet scale-up N=2 over N=1 (recorded, not gated: two processes time-share "
            f"one card): {out['scaleup']:.3f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _stall_and_resume(fleet, url, name):
    """SIGSTOP ``name`` while it serves a request routed to it: the router
    ejects it once its probes time out; after SIGCONT it is re-admitted and
    the request ends completed or typed, never hung."""
    router = fleet.router
    rep = router.replica(name)
    ready = [router.replica(n) for n in router.replica_names()]
    rng = np.random.default_rng(FAILOVER_SEED)
    prompt = rng.integers(0, BENCH_MODEL["vocab_size"], FLEET_SUFFIX).tolist()
    while router._affine(prompt, ready) is not rep:  # a prompt the router sends to it
        prompt = rng.integers(0, BENCH_MODEL["vocab_size"], FLEET_SUFFIX).tolist()
    result = []
    client = threading.Thread(target=lambda: result.append(_http(
        url, "/generate", {"prompts": [prompt], "max_new_tokens": STALL_NEW}, timeout=600)))
    client.start()
    deadline = time.time() + 60
    while _replica_call(fleet, name, "/v1/stats")["slots_active"] == 0:
        if time.time() > deadline or not client.is_alive():
            raise AssertionError(f"the request never reached {name}: {result}")
        time.sleep(0.01)
    t0 = time.perf_counter()
    fleet.stall_replica(name)
    try:
        while rep.state != "ejected":
            if time.perf_counter() - t0 > 60:
                raise AssertionError(f"stalled {name} was not ejected: {router.stats()}")
            time.sleep(0.02)
        eject_s = time.perf_counter() - t0
    finally:
        fleet.resume_replica(name)
    t1 = time.perf_counter()
    while rep.state != "ready":
        if time.perf_counter() - t1 > 60:
            raise AssertionError(f"{name} was not re-admitted: {router.stats()}")
        time.sleep(0.02)
    readmit_s = time.perf_counter() - t1
    client.join(timeout=600)
    if client.is_alive() or not result:
        raise AssertionError(f"the stalled request hung: {result}")
    status, body = result[0]
    outcome = "completed" if status == 200 else f"error:{body.get('error', {}).get('kind')}"
    if status == 200 and len(body["tokens"][0]) != STALL_NEW or \
            status != 200 and "error" not in body:
        raise AssertionError(f"the stalled request: {status} {body}")
    figures = {"replica": name, "eject_s": eject_s, "readmit_s": readmit_s,
               "outcome": outcome, "readmissions": router.counters["readmissions"]}
    log(f"fleet stall of {name}: {figures}")
    return figures


def phase_autoscale_chaos():
    """Phase 27 (bench.py's serving_autoscale_chaos at the 671M width): one
    replica of 2 slots with the autoscaler, a shared prefix store; overload at
    2x one replica's measured capacity, then sustained 2x with a SIGKILL, then
    0.8x, then idle, then a settle back to one replica.  No request lost, a
    scale-up that succeeded, the kill repaired, the fleet back at
    min_replicas.  Returns the figures."""
    from polyaxon_tpu_torch.serving.loadgen import (ChaosEvent, chaos_poisson_load,
                                                    shared_prefix_prompts)

    V = BENCH_MODEL["vocab_size"]
    prompts = shared_prefix_prompts(FLEET_N, V, prefix_len=FLEET_PREFIX, suffix_len=FLEET_SUFFIX,
                                    groups=FLEET_GROUPS, seed=FLEET_SEED)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_chaos_"))
    router = _fleet_router(probe_interval_s=0.1, request_timeout_s=120.0,
                           shed_occupancy=CHAOS_SHED_OCCUPANCY)
    fleet = _fleet(root / "fleet", 1, CHAOS_SLOTS, router, kv_persist_dir=str(root / "kv_cache"),
                   kv_persist_sig=f"random:{SEED}")
    front = None
    try:
        boot = _start_fleet(fleet)
        (incumbent,) = boot
        boot_s = boot[incumbent]
        # Capacity as phase 21 measures it: one request of each group first,
        # in one call (the engine's first idle snapshot, which a scale-up
        # preloads, then holds every prefix; later ones wait out
        # POLYAXON_TPU_KV_PERSIST_INTERVAL_S), then 3 timed one at a time.
        _replica_call(fleet, incumbent, "/generate",
                      {"prompts": prompts[:FLEET_GROUPS], "max_new_tokens": 2})
        t0 = time.perf_counter()
        for p in prompts[FLEET_GROUPS:FLEET_GROUPS + 3]:
            _replica_call(fleet, incumbent, "/generate",
                          {"prompts": [p], "max_new_tokens": FLEET_NEW})
        svc = (time.perf_counter() - t0) / 3
        capacity = 1.0 / svc
        deadline = time.time() + 30  # the idle snapshot a scale-up preloads
        while not _replica_call(fleet, incumbent, "/v1/stats")["kv_persisted_blocks"]:
            if time.time() > deadline:
                raise AssertionError("the incumbent persisted no prefix block")
            time.sleep(0.1)
        persisted = _replica_call(fleet, incumbent, "/v1/stats")["kv_persisted_blocks"]
        hold = boot_s + CHAOS_SCALER["up_hold_s"]
        phases = [(hold + 2.0, CHAOS_OVER * capacity),
                  (hold + CHAOS_KILL_S + 2.0, CHAOS_OVER * capacity),
                  (hold + 2.0, CHAOS_RECOVER * capacity),
                  (CHAOS_IDLE_S, 0.0)]
        kill_at = phases[0][0] + CHAOS_KILL_S
        log(f"autoscale chaos: {incumbent} ready in {boot_s:.2f} s, sequential service time "
            f"{svc:.4f} s -> capacity {capacity:.3f} rps; {persisted} blocks persisted; "
            f"phases {phases}, kill at {kill_at:.2f} s")
        scaler = fleet.attach_autoscaler(**CHAOS_SCALER)
        front, url = _front(router, "autoscale-chaos")
        records = _record_generate(router)
        decisions, kills, launches, ready_at, ready_stats = [], [], [], {}, {}
        kill, scale_up = fleet.kill_replica, fleet.scale_up

        def recorded_kill(name):
            kills.append((name, time.perf_counter()))
            kill(name)

        def recorded_scale_up():
            name = scale_up()
            launches.append((name, time.perf_counter()))
            return name

        fleet.kill_replica, fleet.scale_up = recorded_kill, recorded_scale_up

        def pump():
            fleet.poll()
            now = time.perf_counter()
            last = scaler.last_decision
            if last and (not decisions or decisions[-1][1] != last):
                decisions.append((now, dict(last)))
            for name, _ in launches:
                rep = router.replica(name)
                if name not in ready_at and rep is not None and rep.state == "ready":
                    ready_at[name] = now
                    ready_stats[name] = router.replica_stats().get(name, {})

        t_run = time.perf_counter()
        res = chaos_poisson_load(url, prompts, FLEET_NEW, phases=phases, seed=CHAOS_SEED,
                                 events=[ChaosEvent(kill_at, "kill")], fleet=fleet, pump=pump,
                                 pump_interval_s=0.05, timeout_s=300.0)
        t_settle = time.perf_counter()
        while time.perf_counter() - t_settle < CHAOS_SETTLE_S:
            pump()
            st = scaler.status()
            if router.stats()["n_ready"] == 1 and len(fleet._procs) == 1 and \
                    st["state"] == "idle":
                break
            time.sleep(0.05)
        settle_s = time.perf_counter() - t_settle
        st = scaler.status()
        kill_t = kills[0][1] if kills else None
        scale_ups = {name: {"launched_at_s": t - t_run,
                            "boot_s": ready_at[name] - t if name in ready_at else None,
                            "after_kill": kill_t is not None and t > kill_t}
                     for name, t in launches}
        for name, fig in scale_ups.items():
            mine = [r for r in records if r["replica"] == name]
            fig["kv_preloaded_blocks"] = ready_stats.get(name, {}).get("kv_preloaded_blocks")
            fig["first_request_ttft_s"] = mine[0]["ttft_s"] if mine else None
        up_ok = [n for n, f in scale_ups.items() if f["boot_s"] is not None]
        repaired = [n for n in up_ok if scale_ups[n]["after_kill"]]
        counts = {k: v for k, v in router.metrics.snapshot()["counters"].items()
                  if k.startswith("autoscaler_decision_total")}

        def shed_frac(p):
            return (p["sheds"] + p["errors"]) / p["n"] if p["n"] else None

        out = {
            "boot_s": boot_s, "service_time_s": svc, "capacity_rps": capacity,
            "persisted_blocks": persisted, "phases": phases, "kill_at_s": kill_at,
            "killed": [k for k, _ in kills],
            **{k: res[k] for k in ("n_requests", "completed", "sheds", "errors", "failures",
                                   "hangs", "wall_s", "tokens_per_s", "ttft_p50_s",
                                   "ttft_p99_s", "by_phase")},
            "overload_shed_frac": shed_frac(res["by_phase"][0]),
            "sustain_shed_frac": shed_frac(res["by_phase"][1]),
            "recovery_shed_frac": shed_frac(res["by_phase"][2]),
            "decisions_spent": scaler.decisions_spent, "decision_counts": counts,
            "decisions": [dict(d, at=t - t_run) for t, d in decisions],
            "scale_ups": scale_ups, "repaired_by": repaired, "settle_s": settle_s,
            "final": {"n_ready": router.stats()["n_ready"], "replicas": sorted(fleet._procs),
                      "state": st["state"], "target_replicas": st["target_replicas"]},
        }
        out["recovery_below_overload"] = (out["recovery_shed_frac"] is not None and
                                          out["recovery_shed_frac"] < out["overload_shed_frac"])
        log(f"autoscale chaos: {out}")
        accounted = res["completed"] + res["sheds"] + res["errors"]
        if accounted != res["n_requests"] or res["hangs"] or res["failures"]:
            raise AssertionError(f"autoscale chaos lost requests: {out}")
        if not up_ok or not repaired or not kills:
            raise AssertionError(f"autoscale chaos: no successful scale-up or no repair: {out}")
        if out["final"]["n_ready"] != 1 or len(fleet._procs) != 1 or st["state"] != "idle" \
                or st["target_replicas"] != CHAOS_SCALER["min_replicas"]:
            raise AssertionError(f"autoscale chaos did not settle back to one replica: {out}")
        return out
    finally:
        _stop_fleet(fleet, front)
        shutil.rmtree(root, ignore_errors=True)


def _tracing_in_a_process_of_its_own():
    """Phase 24 in a child process of this script: a serving process holds
    one engine, not the objects, threads and heap of the 23 phases before,
    and in this process the walls of the same run spread twice as wide."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), TRACING_ONLY],
                          capture_output=True, text=True, timeout=600)
    log(proc.stdout.rstrip())
    if proc.returncode:
        raise AssertionError(f"the tracing phase failed (rc {proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == [TRACING_ONLY]:  # the child of _tracing_in_a_process_of_its_own
        print(json.dumps(phase_tracing()))
        return 0
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    fwd = phase_kernels()
    bwd = phase_bwd_kernels()
    phase_small_model()
    phase_small_model_grads()
    phase_small_model_grads_bf16()
    gen_launches, gen_metrics = phase_main_path()
    static_decode = phase_profile(*phase_prefill_parity())
    _free()
    train_launches, first, train_ledger = phase_train()
    tracking = {"train_ledger": train_ledger}
    tracking["overhead"] = phase_tracking_overhead()
    _free()
    tracking["watchdog"] = phase_watchdog()
    _free()
    tracking["dataset_path"] = phase_dataset_path()
    _free()
    tracking["graph_debug_dump"] = _graph_debug_dump()
    _free()
    phase_bench_config(first)
    _free()
    phase_profile_train()
    _free()
    phase_engine_small()
    _free()
    paged_profile = phase_profile_paged(*phase_paged_parity())
    _free()
    server_launches, server = phase_lm_server()
    tracking["serving_ledger"] = server["ledger"]
    _free()
    long_kernels = phase_long_kernels()
    _free()
    long_launches, long_train = phase_long_train()
    _free()
    ring_launches, ring_train = phase_ring_train()
    _free()
    phase_ring_threads()
    _free()
    ckpt_launches, ckpt = phase_checkpoint()
    _free()
    _reset_counts()
    compiled = {"graph_family": phase_graph_family()}
    _free()
    compiled["generate"] = phase_generate_graph()
    _free()
    compiled["paged_decode_step"] = phase_profile_graph_step()
    _free()
    compiled["loaded_arm"] = phase_loaded_arm()
    _free()
    tiers = {"kv_offload": phase_kv_offload(compiled["loaded_arm"]["eager"]["offered_rps"])}
    _free()
    tiers["warm_boot"] = phase_warm_boot()
    _free()
    tiers["tracing"] = _tracing_in_a_process_of_its_own()
    torch.cuda.synchronize()
    if _counts() != (4 * BENCH_MODEL["n_layers"], 0, 0):  # the two generate prefills, twice
        raise AssertionError(f"the compiled decode paths and the KV tiers launched flash "
                             f"kernels {_counts()}")
    _free()
    fleet = phase_fleet()
    _free()
    fleet["autoscale_chaos"] = phase_autoscale_chaos()
    torch.cuda.synchronize()
    if _counts() != (4 * BENCH_MODEL["n_layers"], 0, 0):  # the fleet's in-process engine: none
        raise AssertionError(f"the fleet phases launched flash kernels {_counts()}")
    fwd["train_shape"] = bwd["fwd"]
    by_path = {"lm_generate": gen_launches, "lm_train": train_launches,
               "lm_server": server_launches, "lm_train_t8192": long_launches,
               "lm_train_sp_ring_t16384": ring_launches, "lm_train_resumed": ckpt_launches}
    for i, (kind, record) in enumerate((("fwd", fwd), ("dq", bwd["dq"]), ("dkv", bwd["dkv"]))):
        record["launches_by_path"] = {path: counts[i] for path, counts in by_path.items()}
        record["launches"] = sum(record["launches_by_path"].values())
        record["t8192"] = dict(long_kernels["t8192"][kind],
                               launches_per_step=long_launches[i] / LONG_STEPS)
        record["t16384"] = dict(long_kernels["t16384"][kind],
                                launches_per_step=ring_launches[i] / RING_STEPS)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    # The serving and long-context figures of this run, on lines of their
    # own so that they stand in the output's tail beside the kernels' record.
    print(json.dumps({"serving": {"lm_generate": gen_metrics, "lm_server": server,
                                  "static_decode_step": static_decode, **paged_profile}}))
    print(json.dumps({"long_context": {"t8192": long_train, "sp_ring_t16384": ring_train}}))
    print(json.dumps({"checkpoint": ckpt}))
    print(json.dumps({"compiled_decode": compiled}))
    print(json.dumps({"kv_tiers_and_tracing": tiers}))
    print(json.dumps({"tracking": tracking}))
    print(smi)
    print(json.dumps({"kernels": [fwd, bwd["dq"], bwd["dkv"]]}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
