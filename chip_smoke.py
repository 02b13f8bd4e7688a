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
the autoscaler under chaos); then the gang layer (the port's spawner and
worker running ``lm_train`` and ``lm_server`` from specs, and the train
step across ranks); then the image classifiers (``cnn_train``,
``vit_train``) and ``lm_train`` with switch-MoE experts; then the sharded
strategies without a pipeline (``fsdp``, ``tp``, ``tp_dp``, ``ulysses``)
across rank processes on the one card; then the pipeline and the experts
across them (``pp``, pp×MoE, ``pp_tp``, ``ep``); then the rest of the
parallel layer across them (the image models under ``tp``, ``tp_dp``,
``ulysses``, ``pp``, ``pp_tp`` and ``ep``, ``sp_ring``, MoE under
``pp_tp``, ``checkpoint-now`` under ``fsdp``); then serving a model split
over the card's rank processes; then the non-model services, a gang through
the ssh transport, and the control plane's state and bus; then the port's
own control plane running runs, a serving fleet of its runs, a sweep and a
pipeline; then the API and the CLI; then the static analysis and the
control plane's saturation harness.  Phases:

1. the card, its power limit, and the toolchain;
2. the kernel build (one ``nvcc`` per source, all started together);
3. each kernel against its plain version on the card, at the shape of the
   path that runs it and at edge shapes, with its time beside the plain
   version's, the PyTorch library call's and its bound: the forward at the
   prefill shape, then the two backward kernels (and the forward) at the
   training shape (bf16 inputs run the tensor-core kernels, float32 inputs
   the FMA kernels); then every tile width the kernels are compiled for
   (head_dim 8, 12 padded to 16, 32, 80, 96, 160, 256; causal and full, a
   ragged T, Tq != Tk, one row past a tile edge; bf16 and float32), and
   the three kernels' times at the training shapes of head_dim 96 (BH 20 x
   32) and 256 (BH 20 x 8);
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
17. checkpoint, preemption and restore at bench.py's 671M widths cut to 2 of
    its 8 layers (seq 1024, batch 8, float32 params, bf16 compute,
    ``AdamW(lr)``; a save is params, mu and nu, 3.22 GB): 5 steps through
    ``build_train_step`` in process as the reference; ``lm_train`` with
    ``save_every=2`` in a child process, SIGKILLed by its ``preempt_step=3``
    (rc -9), with the step dirs and markers it left against
    ``latest_complete_step``; ``lm_train`` resumed in process from the newest
    complete step, its launch counts set to 0 before it and read after, its
    final loss against the reference's (rtol 1e-6; bitwise equality reported)
    and a profiler window on its last step whose trace must name each kernel
    once per layer; the save blocks, write rates and the weights-only and full
    restore times; ``lm_generate`` and ``lm_server`` with the run as ``target``
    (the static ``generate``'s and an engine's tokens on the reference's last
    params); a ``profile`` and a ``drain`` command through the capture agent's
    mailbox (a manifest over 4 decode steps, then ``draining`` and a typed
    503);
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
    span, the trash block and one more), offload off then on on a bf16
    pool and on on an int8 pool, each beside a pool that never fills:
    offload on completes 24 of 24 with 0 sheds, spills and restores blocks,
    builds no entry after ready and gives every request the ample pool's
    tokens; offload off parks slots that keep their blocks, moves none,
    answers or sheds every request and gives each answer the ample pool's
    tokens;
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
    overhead under 3% (the median over the turns of a traced run's wall
    against its untraced neighbour's; the minima's printed beside it),
    waterfalls within 10% of client latency; then
    ``lm_server`` with a ``traceparent``: the
    same trace id back, and ``/v1/trace/<id>`` with ``serving.generate``,
    ``serving.request`` and ``serving.queue_wait``;
25. the serving fleet, bench.py's ``serving_fleet`` arm at the 671M width
    cut to 4 layers:
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
27. bench.py's ``serving_autoscale_chaos`` at the 671M width (4 layers): one replica of
    2 slots, the router's shedding at 0.8, the autoscaler, a shared prefix
    store; one replica's capacity measured, then 2x, 2x with a kill, 0.8x
    and an idle tail: none lost, a scale-up that succeeded and preloaded
    the store, the kill repaired, back at one replica with target 1; shed
    fractions, decisions, the scale-ups' preloaded blocks and first TTFT;
28. the gang layer: a one-rank gang of ``lm_train`` on the card, launched by
    the port's ``LocalGangSpawner`` (``python -m
    polyaxon_tpu_torch.runtime.worker``) from a ``kind: experiment`` spec
    naming accelerator ``h100`` (1 device, 1 host) at phase 7's
    configuration with a profiler window on the last step: its report
    file's statuses (starting, running, succeeded), a falling loss,
    tokens/s beside phase 7's in-process rate, one final ledger row on the
    card, and the profiled step's trace naming each kernel once a layer
    (these counts are the kernels' ``lm_train_gang`` launches); the boot
    (launch to running, to the first metric) and the worker's rc;
29. a ``kind: service`` gang of ``lm_server`` at phase 11's configuration:
    the port from ``allocate_service_port``, the worker's serving line
    naming it, 8 concurrent greedy ``/generate`` of 64 tokens (4 prompts of
    whole 256-token chunks and one token, each twice: equal tokens for
    equal prompts, whether or not a copy finds the other's prefix cached),
    0 captures after ready, and
    ``stop`` ending the process group by its SIGTERM within the grace;
    launch to ready and tokens/s;
30. the multi-rank train step: 2 ranks as threads of this process over gloo
    on CUDA tensors (NCCL takes one rank a device), ``ddp`` on {data: 2},
    2 steps on a global batch of 4: the 671M width cut to 2 layers in bf16
    (each rank's loss and grad norm within 1e-2 of one rank's step on the
    whole batch; the kernels launch on both ranks) and the small float32
    model (within 1e-5); the all-reduce's wall a step, over gloo, not NCCL;
31. ``cnn_train`` at the CIFAR-10 guide's shape (32 px, channels (64, 128,
    256), dense 256, 10 classes, batch 256): 50 steps on synthetic images (a
    falling loss, the fixed batch's accuracy above chance), then 20 through
    the dataset path (``TrainPipeline`` with ``device_prefetch``) on a
    4096-image ``make_image_fixture`` store; one bf16 step's loss, logits and
    grads on the card against the port's CPU step on the same weights and
    images (the layout and flatten order); images/s, step wall, data wait,
    the ledger's MFU and a profiled step's idle share;
32. ``vit_train`` at ViT-B/16's widths (224 px, patch 16, d 768, 12 layers,
    12 heads x 64, d_ff 3072, batch 128, 20 synthetic steps): a falling
    loss, images/s, MFU, peak memory, the card-vs-CPU step at 2 layers, and
    a profiled step's top device ops;
33. ``lm_train`` with 4 experts at the 671M widths (capacity factor 1.25,
    batch 8 x 1024, bf16, 5 steps): a falling loss, each flash kernel once
    a layer a step (its counts, and the trace of the profiled last step),
    tokens/s, MFU (counting every expert's params), peak memory, the share
    of tokens each layer drops at capacity, the MoE MLP's share of a step's
    device time; a small float32 ``_moe_mlp`` on the card routes as on the
    CPU (but for near-ties) and gives its output within 1e-4, and a small
    bf16 MoE model's grads with remat on match those with it off (the
    recompute routes as the forward did);
34. the sharded train step across rank processes of this script
    (``--sharded-rank``) on the one card, over gloo: ``fsdp {data: 2}``,
    ``tp {tensor: 2}`` and ``tp_dp {data: 2, tensor: 2}`` (4 processes) at
    the 671M width cut to 2 layers, global batch 4 x 1024, bf16, 2 steps:
    each rank's loss and grad norm within 1e-2 of one rank's step on the
    whole batch, the kernels launched on every rank, each rank's param and
    AdamW bytes beside one rank's (half of them under fsdp), and the walls
    of the gathers, reduce-scatters, all-reduces and all-to-alls (over gloo,
    which copies through the host: nothing of NCCL); and two rules the port
    once refused: ``custom {tensor: 2}`` with a ``head_dim`` rule (stored
    split, gathered at each use: a rank holds less than the whole state) and
    ``ddp`` on ``{tensor: 2}``, an axis no rule names (a replica axis: each
    rank the whole state and batch);
35. ``ulysses {sequence: 2}`` at T 8192, batch 1, ``attention_impl``
    ``auto`` (the kernels at the rank's 16 heads over the whole sequence):
    the same checks;
36. the three kernels at the Ulysses rank's shape (BH 16, T 8192, d 64,
    bf16 causal) against their plain versions on two heads, with their
    times beside SDPA's and their bounds;
37. ``vit_train`` (ViT-B/16) under ``fsdp {data: 2}`` through the entry
    point, 2 steps: its losses within 1e-2 relative of one rank's;
38. the pipeline across rank processes (2, over gloo; phase 34's processes
    run these cases after theirs) at the 671M width cut
    to 2 layers, bf16, 2 steps: ``pp {pipeline: 2}``, batch 4 x 1024, 2
    microbatches, one layer a stage; each rank's loss and grad norm within
    1e-2 of one rank's step on the whole batch, a stage holding half of the
    block's bytes, the kernels launched M times a layer a step on every
    rank, the stage hops' walls and bytes;
39. pp×MoE ``{pipeline: 2}``: 4 experts, capacity factor 1.25, batch 4 x
    1024, one microbatch (which routes exactly what one rank routes): the
    same checks;
40. ``pp_tp {pipeline: 2, tensor: 2}`` (4 processes), the dense model of
    phase 38: the same checks;
41. ``ep {data: 2, expert: 2}`` (4 processes): the MoE model of phase 39
    at batch 8 x 1024, routed over the global batch: the same checks, a rank
    holding half of the experts (a quarter of their bytes: ``ep`` also
    splits their embedding dimension over ``data``), and the tokens each
    layer's global ranking drops at the initial weights, at capacity
    factors 1.25, 1.0 and 0.5, those of one rank but for tokens whose
    expert differs (bf16 near-ties), beside what a rank routing only its
    own rows would drop;
42. ``vit_train`` at ViT-B/16's widths cut to 2 layers (batch 32, bf16, 2
    steps, lr 1e-5, synthetic images) through the entry point, its train
    step recorded, across rank processes (phase 34's
    launches run these cases after theirs): ``tp {tensor: 2}``, ``ulysses
    {sequence: 2}`` (each rank its 98 of the 196 patches, the Ulysses swap
    around the attention) and ``pp {pipeline: 2}`` (the layers gathered at
    use) on 2 processes, ``tp_dp {data: 2, tensor: 2}``, ``pp_tp {pipeline:
    2, tensor: 2}`` and ``ep {data: 2, expert: 2}`` on 4: each rank's loss
    and grad norm within 1e-2 of one rank's run of ``vit_train``, the
    leader's logged losses its steps', each rank's param, AdamW and block
    bytes, no flash launch (the ViT's attention is plain products, as the
    reference's), the collectives' walls;
43. ``cnn_train`` at the CIFAR shape (batch 256) under ``tp {tensor: 2}``
    (the classes split, the logits gathered), reading a fixture dataset
    (every rank the whole batch: no data axis): the same checks;
44. ``sp_ring {sequence: 2}`` at T 8192, batch 1, the 671M width cut to 2
    layers: the ring's hops between the rank processes (``GroupRing.rotate``
    over gloo, staged through the host), each rank's loss and grad norm
    within 1e-2 of one rank's, the kernels launched on both ranks;
45. MoE under ``pp_tp`` (4 processes): the 671M width cut to 2 layers with
    4 experts, batch 8 x 1024, ``attention_impl`` flash, on ``{pipeline: 2,
    tensor: 2}`` (each expert's MLP columns split over ``tensor``) with one
    microbatch (which routes the tokens one rank routes) and on ``{data: 2,
    pipeline: 2}`` with two (a data rank's rows its block of each global
    microbatch, each microbatch routed over both data ranks): the same
    checks, the kernels launched exactly M times a stage's layer a step on
    every rank, and on ``{data: 2, pipeline: 2}`` the tokens the MoE of the
    layer each rank holds drops, microbatch by microbatch, at capacity
    factors 1.25, 1.0 and 0.5, those of one rank routing each global
    microbatch but for tokens whose expert differs, beside what routing each
    data rank's rows alone would drop; and MoE under a ``custom`` pipeline
    that is not composed, ``{pipeline: 2, tensor: 2}`` with ``layers:
    pipeline`` and the tensor rules, one microbatch: each stage gathers its
    layers' weights whole, experts included;
46. ``checkpoint-now`` under ``fsdp {data: 2}`` (2 processes, the 671M width
    cut to 2 layers, 5 steps): each process's copy of one command written
    into its own mailbox at another step (1 and 3) and drained by its
    capture agent: one save, at step 2 (the step after the first copy's),
    acked ``complete`` with that step by both processes (the late copy
    without a second save), the saved step
    restored bit for bit equal to the ``full_state`` the ranks gathered
    there; ``maybe_save`` with nothing queued (the flag's all-reduce on the
    hosts, over gloo) timed on an idle card;
47. mesh serving (phase 34's 2 rank processes run it after their cases),
    three cases at the 671M width: ``tp {tensor: 2}`` at 2 layers,
    ``pp {pipeline: 2}`` at 4 layers (a stage-owned decode: each rank runs
    its stage's two layers, the hidden state hops stage to stage, the last
    stage's logits are broadcast) and ``fsdp {data: 2}`` at 2 layers (each
    weight gathered at its use; over gloo each gather passes through the
    host, so this case makes 4 tokens a ``generate`` and serves 3 requests
    of 4 tokens: the first and the two on its prefix); each
    float32 then bf16, every rank its
    shards of the seeded weights (``decode.decode_param_shardings``), the
    decode step and the engine eager where they call a collective (gloo's
    run on the host): ``sharded_generate_fn`` on 4 prompts of 128 tokens,
    32 new, and ``ServingEngine(mesh=)`` on 8 requests (a 256-token prefix
    that two later ones hit, a repeating prompt whose drafts the verify step
    scores), rank 0 leading and rank 1 following; against one rank's
    ``generate`` and eager engine here: float32 tokens equal; bf16 tokens
    equal but where one rank's top-2 logits lie within 2^-3 at the first
    position that differs (reported); the decode prefill's last logits
    within cosine 0.999; the flash forward launched once a layer a rank runs
    a ``generate`` (2 a rank in each case) and never in the engine; a rank
    half of the weights' bytes under ``tp`` and ``fsdp``, half of the
    block's and half of one rank's KV pool under ``pp``; no step built after
    ready on either rank; each case's wall, the engine's ``decode_step_s``
    and TTFT p50, the descriptor broadcast's ms a step and, under ``fsdp``,
    the weight bytes a rank gathers a decode step;
48. (run while phases 34-47's rank processes run: it takes the host, not
    the card) the non-model services as gangs of the port's worker on the
    card's host (LocalGangSpawner, accelerator ``h100``, the port from
    ``allocate_service_port``): ``output_server`` over phase 28's run, one
    file of its outputs (the profiler trace) fetched byte for byte;
    ``kind: notebook`` with no run section (``jupyter`` with a stub
    ``jupyter_bin`` this phase writes), whose reported service URL carries
    ``?token=`` and answers; ``kind: tensorboard`` with no run section where
    ``tensorboard`` is installed (else the line ``tensorboard: not installed
    on this host``); each one's seconds from launch to its first answer;
49. a gang through the ssh transport: ``spawner_from_conf`` over the port's
    ``ConfService`` (``spawner.backend=ssh``, ``spawner.hosts=127.0.0.1``), a
    stub ``ssh`` on PATH running the remote script on this host, ``lm_train``
    at the 671M width and depth (batch 4 x 1024, 3 steps, the last profiled:
    each kernel once a layer); its rc through the rc file, its final loss
    within 1e-2 relative of the same gang's from LocalGangSpawner (run beside
    it); then an endless gang that ignores SIGTERM: a TERM through its
    ``_RemoteProcessRef`` leaves it running, the spawner's ``reattach``
    rebuilds the ref, and a KILL through it records rc 137 in the rc file;
50. the state and the bus: a ``RunRegistry`` records phase 49's ssh gang (its
    run row, its statuses ``created`` to ``succeeded`` read off its report
    lines, each gated by the lifecycle, and its metrics), an ``Auditor``
    records its events and ``ExecutorHandlers`` on a ``TaskBus`` dispatch
    them (``experiment_done``: a stop with cleanup); two processes write
    2000 metrics each to one WAL database together, every row read back;
51. phase 49's ``lm_train`` spec (with a ``build`` section) and a queued
    ``noop`` through the port's ``Orchestrator`` with one ``h100`` device
    registered; 52. a 2-layer ``lm_train`` SIGKILLed at step 5 and
    remediated from its latest complete checkpoint;
53. a control-plane ``ServingFleet`` of 2 ``lm_server`` replicas (the
    671M width, 4 layers) as ``kind: service`` runs: a 16-request burst,
    both replicas' greedy tokens equal, the exemplar harvest, one replica
    SIGSTOPped, drained and replaced, ``run_health_checks`` healthy;
54. a ``kind: group`` grid over ``lr`` of phase 51's spec, one trial at a
    time on the one registered slice, the ``lr`` 3e-4 loss phase 51's;
55. a ``kind: pipeline``: ``lm_train`` at 2 layers, then ``lm_generate``,
    each op's flash launches counted (``counted_entry``);
56. the surfaces: ``python -m polyaxon_tpu_torch.cli.main serve`` on a free
    port, and the CLI in remote mode submitting ``run -f spec.json --watch``
    for phase 55's ``train`` op as a JSON spec that names no accelerator
    (stored with the card, run on it, 6 launches of each kernel); the run
    read back over HTTP (its detail, its metrics, the WS metrics tail, the
    status with the card probe, the version, ``/metrics``, the dashboard)
    and through the CLI's ``ps``, ``get``, ``logs`` and ``statuses``; the
    server stopped, its control-plane lease released.  Where aiohttp is not
    installed the API cannot serve: the same run goes through the CLI's
    local mode, and a line says so;
    phases 52 and 55, and 53 and 56, in two child processes of the script
    (``--control-lane``: a lane each, its phases in order) started before
    phase 49 and running beside phases 49-51 and 54: each drives its own
    orchestrator, base directory and gangs and reads no other's result;
57. the analysis and the saturation harness: ``python -m
    polyaxon_tpu_torch.analysis --format json`` over the port's package (rc
    0, no finding, every suppression with a reason, the health probe's
    ``static_analysis`` clean from its state); in a child process a step
    with ``.item()`` refused by ``capture_step`` and the same step without
    it captured, replayed and equal to its eager result; then
    ``monitor/cploadgen.py`` over the port's control plane with bench.py's
    arguments (saturation, scrape overhead, idle tick) in a process that
    loads no torch, bench.py's budgets reported as ``_ok`` flags;
58. the head widths past 64 and 128: ``lm_train`` on the 671M trunk with
    Gemma-2B's attention (8 heads x 256, one KV head; batch 20 x 1024,
    bf16, 5 steps, a profiler window on the last): the loss falls, each
    kernel launches once a layer a step and the profiled step names each
    once a layer, its tokens/s, MFU and peak memory; its first loss within
    1e-2 relative of the same model's with dense attention; ``lm_generate``
    on it (batch 4, prompt 512, 16 new tokens: the prefills' launches) and
    its prefill logits against dense attention as phase 6; then the wide
    kernels past 256 (the bf16 forward's and dk/dv's blocks own 512 output
    columns and sum each score once up to head_dim 512; the bf16 dq pass's
    and the float32 kernels' own 128 and sum their scores over the whole
    head_dim in chunks of 64) against their plain versions at head_dim 264,
    300 (padded to 304), 384, 512 and 1024, bf16 and float32, causal with a
    ragged T and full with Tq != Tk, the bf16 forward's and dk/dv's launches
    (grid, threads, shared memory, registers) logged at 512 and 1024, and
    the three timed at the training shape at 512 (BH 20 x 4, T 1024) beside
    their plain versions, SDPA (the backend it takes named) and their
    bounds; ``lm_train`` and
    ``lm_generate`` as above with 4 heads x 512 and one KV head (q width
    2048), the profiled step naming each wide kernel once a layer; then
    ``lm_train`` at Phi-3-mini's 32 heads x 96 on 2 layers of the trunk;
    in a child process of the script, as phase 24, started before phase 57
    and running beside it (phase 57 takes the host, phase 58 the card).

Any failed check raises, and the script exits non-zero; an atexit hook
SIGKILLs any replica or gang worker left.  On success its last lines are the serving
figures as JSON (``lm_generate``'s decode rate, ``lm_server``'s, and the
paged profile), the long-context, the checkpoint, the compiled decode and
the KV-tier and tracing figures as JSON, the tracking figures (the
training and serving ledger rows, the overhead, the watchdog, the dataset
path) as JSON, the card's name and power limit,
the kernels' JSON record, the fleet's figures, the gang layer's, the image
classifiers' and the MoE run's, the sharded strategies', the pipeline's and
the experts', the rest of the parallel layer's, mesh serving's, the services',
the ssh gang's, the state and bus's and the orchestrator's, the fleet's,
the sweep's and the pipeline's (phases 53–55), the surfaces' (phase 56),
the analysis and the saturation harness's (phase 57), the head widths'
(phase 58), and ``{"ok": true,
"device": {...}}``.  Without CUDA it exits 1
at once.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import gc
import json
import math
import os
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
# The model of phase 17: bench.py's widths at 2 of its 8 layers (a save 3.22 GB;
# at 8 layers 8.05 GB), cut to keep the whole script near its time aim.
CKPT_MODEL = dict(BENCH_MODEL, n_layers=2)
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
FLEET_LAYERS = 4
FLEET_MODEL = dict(BENCH_MODEL, n_layers=FLEET_LAYERS)
# The serving fleet (phases 25-27): replica subprocesses on the one card, each
# lm_server's phase-11 configuration at the 671M width cut to FLEET_LAYERS
# layers (SERVE_SEQ, 16-token blocks, 256-token chunks, prefix cache on,
# bf16, warmup on; 4 layers rather than 8 keep the whole script nearer its
# 600 s aim), behind a
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
# The gang layer (phases 28-30): one port worker on the card (accelerator h100,
# one device on one host); lm_train at phase 7's configuration with a profiler
# window on its last step; the multi-rank step as 2 thread ranks over gloo,
# ddp on {data: 2}, global batch 4, 2 steps, at the 671M width cut to 2 layers
# (bf16: each rank's loss and grad norm within 1e-2 of one rank's on the whole
# batch, since bf16 rounds each rank's partial weight grads before the sum)
# and on the small float32 model (within 1e-5: summation order alone).
GANG_TOPOLOGY = {"accelerator": "h100", "num_devices": 1, "num_hosts": 1}
GANG_STEPS = TRAIN_STEPS
STEP_RANKS_LAYERS, STEP_RANKS_BATCH, STEP_RANKS_STEPS = 2, 4, 2
STEP_RANKS_BF16_RTOL, STEP_RANKS_F32_ATOL = 1e-2, 1e-5
# The image classifiers (phases 31-32).  cnn_train at the CIFAR-10 guide's shape
# (docs/training-cifar10.md: 32 px, the default channels (64, 128, 256), dense
# 256, 10 classes, global batch 256, lr 1e-3): 50 steps on synthetic images,
# then 20 through the dataset path on a 4096-example make_image_fixture store
# (the real archive is not in the repository).  vit_train at ViT-B/16's widths
# (Dosovitskiy et al. 2020: 224 px, patch 16, d 768, 12 layers, 12 heads x 64,
# d_ff 3072) on the repo's RMSNorm/SwiGLU block, 10 classes, batch 128, 20
# synthetic steps.  Each model's loss, logits and grads of one bf16 step on the
# card against the port's own CPU step on the same weights and IMAGE_CHECK_BATCH
# images (the ViT cut to VIT_CHECK_LAYERS layers): the whole bf16 model runs on
# two devices, so the loss may differ by 1e-2 relative, the logits by 2e-2 of
# the largest and each grad by BF16_MODEL_GRAD_RTOL of its norm; a layout or
# flatten-order error moves them by their own size.
CNN_MODEL = dict(image_size=32, channels=(64, 128, 256), classes=10)
CNN_BATCH, CNN_STEPS, CNN_DATA_STEPS, CNN_DATA_EXAMPLES = 256, 50, 20, 4096
VIT_B16 = dict(image_size=224, patch_size=16, d_model=768, n_layers=12, n_heads=12, head_dim=64,
               d_ff=3072, classes=10)
VIT_BATCH, VIT_STEPS, VIT_CHECK_LAYERS = 128, 20, 2
IMAGE_CHECK_BATCH, IMAGE_LOSS_RTOL, IMAGE_LOGITS_RTOL = 8, 1e-2, 2e-2
# lm_train with experts (phase 33): bench.py's 671M widths with 4 experts
# (about 1.88 B parameters, 1.61 B of them in the experts), capacity factor
# 1.25, batch 8 x 1024, bf16, 5 steps, a profiler window on the last.  The
# small float32 _moe_mlp on the card against the CPU (TF32 off, main() sets
# it): the same expert for every token whose top two gates differ by more
# than MOE_TIE, and the output within MOE_OUT_ATOL where both route a token to
# the same expert slot.
MOE_EXPERTS, MOE_CAPACITY, MOE_BATCH, MOE_STEPS = 4, 1.25, 8, 5
MOE_SMALL = dict(vocab_size=256, d_model=256, n_layers=1, n_heads=4, head_dim=64, d_ff=512,
                 n_experts=4, capacity_factor=1.0)
MOE_SMALL_TOKENS, MOE_TIE, MOE_OUT_ATOL = (4, 256), 1e-6, 1e-4
# A checkpointed layer recomputes its forward in the backward: its routing
# must be the same, or the grads are wrong.  A small bf16 MoE model (2
# layers, 4 experts, capacity factor 1.0, so tokens drop; the flash kernels
# run its attention) gives its loss_fn grads with remat on and off on the
# card, within BF16_BWD_GRAD_RTOL of each grad's norm (equal bits reported):
# another expert for a token moves a grad by its own size.
MOE_REMAT_BATCH, MOE_REMAT_SEQ = 4, 128
# The analysis and the saturation harness (phase 57), with bench.py's
# arguments (bench.py:2236-2246, 2311-2320, 2326) and its budgets, which are
# reported as _ok flags beside the numbers and not gated
# (bench.py:2259-2261, 2327, 2352-2353, 2361).
CP_SATURATION = dict(n_registry_runs=1000, n_gangs=8, procs_per_gang=2, duration_s=6.0,
                     write_hz=20.0, api_concurrency=4, stall_after_s=0.75,
                     monitor_interval_s=0.05)
CP_SCRAPE = dict(n_registry_runs=1000, n_replicas=16, n_gangs=4, duration_s=4.0,
                 monitor_interval_s=0.05, api_duration_s=2.0, api_concurrency=2)
CP_IDLE_ITERS = 200
CP_BUDGETS = {"watcher_ingest_lag_p99_s": 1.0, "alert_fire_latency_s": 2.0, "api_p99_s": 0.25,
              "scrape_share": 0.10, "query_p99_s": 0.1, "idle_tick_us": 5000.0,
              "lint_s": 10.0}
# GL001's bug class on the card (phase 57), in a child process of the script:
# a step captured with and without a host read of a device value.
CAPTURE_PROBE = "--capture-probe"
CAPTURE_PROBE_ATOL = 1e-5
# Head widths past {64, 128} (phases 3 and 58).  Every tile width the
# kernels are compiled for (32, 64, 96, 128, 256), a head_dim padded to the
# next multiple of 8 (12), and the widths of Phi-2 (80), Phi-3-mini (96)
# and Gemma (256); the three kernels timed at the training shapes (BH 20 x
# H, T 1024) of Phi-3-mini's 32 heads x 96 and Gemma's 8 x 256.  Phase 58
# recuts the 671M trunk's attention to Gemma-2B's (8 heads x 256, one KV
# head; d_model 2048 as in Gemma-2B) and to Phi-3-mini's heads on 2 layers
# (the dispatch at d 96, not a second full-width path); lm_train's builtin,
# like the reference's, takes no remat option, so both run as phase 7 runs
# lm_train.  The first loss against dense attention within 1e-2 relative:
# the kernels round p and ds to bf16 where dense attention rounds its
# softmax, and the bf16 model's other roundings follow.
WIDE_DIMS = (8, 12, 32, 80, 96, 160, 256)
WIDE_TRAIN_SHAPES = ((32, 96), (8, 256))  # (H, d) at BH TRAIN_BATCH x H, T TRAIN_SEQ
WIDE_MODEL = dict(BENCH_MODEL, n_heads=8, head_dim=256, n_kv_heads=1)
PHI3_MODEL = dict(BENCH_MODEL, n_layers=2, n_heads=32, head_dim=96)
WIDE_NEW, WIDE_LOSS_RTOL, PHI3_STEPS = 16, 1e-2, 3
HEAD_WIDTHS_ONLY = "--head-widths-phase"
# Phases 52 and 55, and 53 and 56, run in two child processes of the script
# (a lane each, its phases in order), started before phase 49 and running
# beside phases 49-51 and 54 in the script's process: each phase drives its
# own orchestrator, base directory and gangs, and reads no other's result.
# Their gangs and replicas spend their walls booting processes on the host
# more than on the card (a gang of 3 steps 25-30 s, 10-12 s of it launch
# to running); run in turn, these four phases took 238.7 s of the 1,157.8 s
# of a run on an H100 host.
CONTROL_LANE = "--control-lane"
CONTROL_LANES = {"remedy": ("52", "55"), "fleet": ("53", "56")}
# Past 256 the wide kernels run (csrc/head_dims.cuh): their grids split the
# output columns in blocks.  The bf16 forward and dk/dv kernels own 512
# columns a block and sum each score once up to d 512; the bf16 dq pass and
# the float32 kernels own 128 and sum the scores over the whole d in chunks
# of 64.  Phase 58 holds them to their plain versions at one 128-column
# block past 256 (264), a d padded from 300 to 304, 384, 512 and 1024, both
# types; logs the bf16 forward's and dk/dv's launches (grid, threads, shared
# memory, registers) at d 512 and 1024; times the three at the training
# shape at d 512 (BH 20 x 4, T 1024, bf16, causal) beside SDPA and the
# backend it takes; and recuts the 671M trunk's attention to 4 heads x 512
# with one KV head (q width 2048, as WIDE_MODEL's 8 x 256) for lm_train and
# lm_generate, whose profiled step must name each wide kernel once a layer.
HUGE_DIMS = (264, 300, 384, 512, 1024)
HUGE_TRAIN_SHAPE = (4, 512)  # (H, d) at BH TRAIN_BATCH x H, T TRAIN_SEQ
HUGE_MODEL = dict(BENCH_MODEL, n_heads=4, head_dim=512, n_kv_heads=1)
WIDE_KERNEL_NAMES = ("flash_fwd_wide_bf16_kernel", "flash_bwd_dq_wide_bf16_kernel",
                     "flash_bwd_dkv_wide_bf16_kernel")


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

    return tuple(flash.launch_counts().values())


def _reset_counts() -> None:
    """Set the kernels' launch counts, and the ring's count of forward
    blocks, to 0."""
    from polyaxon_tpu_torch.parallel import flash

    for fn in (flash.flash_block_fwd, flash.flash_block_dq, flash.flash_block_dkv):
        fn.launches = fn.padded = 0
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


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device():
    smi = _card()
    from polyaxon_tpu_torch import kernels_available

    avail = kernels_available()
    nvcc = subprocess.run([avail["nvcc"], "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} nvcc {nvcc}")
    return smi


def _ptxas_table(report):
    """``nvcc -Xptxas -v``'s report as one entry per instantiation, by
    kernel and template arguments (``flash_fwd_bf16_kernel<64, 1>``): its
    registers and the bytes it spills (stores, loads)."""
    import re

    def name(mangled):
        m = re.search(r"(flash_[a-z0-9_]+_kernel)I((?:L[a-z]\d+E)+)E", mangled)
        if m is None:  # a kernel that is not a template (the wide ones)
            m = re.search(r"(flash_[a-z0-9_]+_kernel)E", mangled)
            return mangled if m is None else re.sub(r"^.*\d(?=flash_)", "", m.group(1))
        kernel = re.sub(r"^.*\d(?=flash_)", "", m.group(1))  # drop the file's namespace
        args = ", ".join(re.findall(r"L[a-z](\d+)E", m.group(2)))
        return f"{kernel}<{args}>"

    table, current, props = {}, None, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            current = name(line.split("'")[1])
            table.setdefault(current, {"registers": None, "spill_stores": 0, "spill_loads": 0})
        elif "Function properties for" in line:
            props = name(line.split("for", 1)[1].strip())
        elif "spill stores" in line and props in table:
            nums = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            table[props]["spill_stores"], table[props]["spill_loads"] = nums[0], nums[1]
        elif "Used" in line and "registers" in line and current:
            table[current]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return table


def phase_build():
    """The kernels' build (one nvcc a source, all at once): its wall and,
    for each instantiation, the registers and the spills ptxas reports."""
    from polyaxon_tpu_torch import _build

    t0 = time.perf_counter()
    reports = _build.build()
    wall = time.perf_counter() - t0
    log(f"build: {sorted(reports)} in {wall:.2f} s")
    out = {"build_s": wall, "instantiations": {}}
    for name, report in reports.items():  # ptxas -v: one entry per instantiation
        table = _ptxas_table(report)
        out["instantiations"].update(table)
        spills = {k: (v["spill_stores"], v["spill_loads"]) for k, v in table.items()
                  if v["spill_stores"] or v["spill_loads"]}
        log(f"  {name}: " + "; ".join(f"{k} {v['registers']} registers" for k, v in table.items())
            + f"; spills (stores, loads bytes): {spills or 'none'}")
    return out


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
        *_width_cases(),
    ]
    record = None
    padded_before = flash.flash_block_fwd.padded
    for BH, Tq, Tk, d, dtype, causal in cases:
        g = torch.Generator(device="cuda").manual_seed(BH + Tq + d)
        q = torch.randn(BH, Tq, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(BH, Tk, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(BH, Tk, d, generator=g, device="cuda").to(dtype)
        scale = d**-0.5
        padded = flash.flash_block_fwd.padded
        o, lse = flash.flash_block_fwd(q, k, v, causal=causal, sm_scale=scale)
        torch.cuda.synchronize()
        if flash.flash_block_fwd.padded - padded != int(d % 8 != 0):
            raise AssertionError(f"flash_fwd at d {d}: padded count {flash.flash_block_fwd.padded}")
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
    # head_dim 12 padded to 16 by the wrapper, once a comparison
    record["padded_launches_in_checks"] = flash.flash_block_fwd.padded - padded_before
    return record


def _width_cases():
    """(BH, Tq, Tk, d, dtype, causal) at every width of WIDE_DIMS, bf16 and
    float32: causal with one row past a 128-row tile edge (a ragged T),
    full with Tq != Tk; and a longer ragged causal T at d 96 and 256."""
    return [*((8, 129, 129, d, dt, True) for d in WIDE_DIMS
              for dt in (torch.bfloat16, torch.float32)),
            *((8, 300, 200, d, dt, False) for d in WIDE_DIMS
              for dt in (torch.bfloat16, torch.float32)),
            (8, 1000, 1000, 96, torch.bfloat16, True), (8, 1000, 1000, 256, torch.bfloat16, True)]


def _sdpa_bwd_ms(q, k, v, do, B, causal, scale):
    """SDPA's backward on the same inputs: one autograd call that computes
    dq, dk and dv together."""
    q4, k4, v4 = (x.view(B, -1, *x.shape[1:]).detach().requires_grad_(True) for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                                           scale=scale)
    do4 = do.view(B, -1, *do.shape[1:])
    return time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True),
                   reps=20)


def _bwd_case(BH, Tq, Tk, d, dtype, causal):
    """One backward case: inputs from a seeded card generator, the forward
    kernel's lse, and the two backward kernels against their plain version
    (a head_dim off a multiple of 8 must count one padded launch each).
    Returns the inputs, the keywords and the largest errors of dq, dk, dv."""
    from polyaxon_tpu_torch.parallel import flash

    g = torch.Generator(device="cuda").manual_seed(BH + Tq + Tk + d)
    q, do = (torch.randn(BH, Tq, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(BH, Tk, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    kw = dict(causal=causal, sm_scale=d**-0.5)
    o, lse = flash.flash_block_fwd(q, k, v, **kw)
    delta = (do.float() * o.to(dtype).float()).sum(-1)
    del o
    args = (q, k, v, do, lse, delta)
    padded = flash.flash_block_dq.padded + flash.flash_block_dkv.padded
    got = (flash.flash_block_dq(*args, **kw), *flash.flash_block_dkv(*args, **kw))
    torch.cuda.synchronize()
    ref = flash.flash_block_bwd_reference(*args, **kw)
    errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    del got, ref
    log(f"flash_bwd BH={BH} Tq={Tq} Tk={Tk} d={d} {dtype} causal={causal}: max abs err "
        f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (<= {BWD_ATOL[dtype]}); "
        f"finite {finite}")
    if max(errs) > BWD_ATOL[dtype] or not finite:
        raise AssertionError("a backward kernel disagrees with its plain version")
    if flash.flash_block_dq.padded + flash.flash_block_dkv.padded - padded != 2 * (d % 8 != 0):
        raise AssertionError(f"flash_bwd at d {d}: padded counts {flash.padded_counts()}")
    return args, kw, errs


def _train_shape_times(label, args, kw, errs, B, want_bounds=None):
    """The three kernels at a training shape (q, k, v [B*H, T, d] bf16,
    causal): each one's time beside the plain versions', SDPA's forward and
    backward and its bound, and the forward's largest error against its
    plain version.  Returns the records keyed by kernel (fwd, dq, dkv)."""
    from polyaxon_tpu_torch.parallel import flash

    q, k, v, do = args[:4]
    BH, Tq, d = q.shape
    Tk, dtype, causal, scale = k.shape[1], q.dtype, kw["causal"], kw["sm_scale"]
    o, lse = flash.flash_block_fwd(q, k, v, **kw)
    ro, rlse = flash.flash_block_fwd_reference(q, k, v, **kw)
    o_err = (o - ro).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    del o, lse, ro, rlse
    if o_err > O_ATOL or lse_err > LSE_ATOL:
        raise AssertionError(f"{label}: flash_fwd o err {o_err}, lse err {lse_err}")
    dq_ms = time_ms(lambda: flash.flash_block_dq(*args, **kw), reps=20)
    dkv_ms = time_ms(lambda: flash.flash_block_dkv(*args, **kw), reps=20)
    fwd_ms = time_ms(lambda: flash.flash_block_fwd(q, k, v, **kw), reps=20)
    plain_ms = time_ms(lambda: flash.flash_block_bwd_reference(*args, **kw), reps=5, warmup=1)
    fwd_plain_ms = time_ms(lambda: flash.flash_block_fwd_reference(q, k, v, **kw), reps=5,
                           warmup=1)
    sdpa_bwd_ms = _sdpa_bwd_ms(q, k, v, do, B, causal, scale)
    q4, k4, v4 = (x.view(B, -1, x.shape[1], d) for x in (q, k, v))
    sdpa_fwd_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal, scale=scale), reps=20)
    bounds = {}
    for kind in ("fwd", "dq", "dkv"):
        bound_ms, bound_by, moved, ops = attention_bound(BH, Tq, Tk, d, dtype, causal, kind)
        if want_bounds:
            want_bytes, want_ops = want_bounds[kind]
            if abs(moved - want_bytes) > 0.1e6 or (want_ops and abs(ops - want_ops) > 0.1e9):
                raise AssertionError(f"attention_bound({kind}) gives {moved} B, {ops} FLOP; "
                                     f"expected {want_bytes} B, {want_ops} FLOP")
        bounds[kind] = (bound_ms, bound_by)
        log(f"  bound {kind}: {moved / 1e6:.1f} MB, {ops / 1e9:.1f} GFLOP -> "
            f"{bound_ms * 1e3:.1f} us ({bound_by})")
    log(f"  {label}: dq kernel_ms {dq_ms:.4f} (bound_ms {bounds['dq'][0]:.4f}), "
        f"dk/dv kernel_ms {dkv_ms:.4f} (bound_ms {bounds['dkv'][0]:.4f}), fwd kernel_ms "
        f"{fwd_ms:.4f} (bound_ms {bounds['fwd'][0]:.4f}); plain_ms bwd {plain_ms:.4f} fwd "
        f"{fwd_plain_ms:.4f}; library_ms (sdpa) bwd {sdpa_bwd_ms:.4f} fwd {sdpa_fwd_ms:.4f}")
    shape = {"BH": BH, "T": Tq, "d": d}
    bwd = dict(plain_ms=plain_ms, library_ms=sdpa_bwd_ms, **shape)
    return {"fwd": dict(ms=fwd_ms, plain_ms=fwd_plain_ms, library_ms=sdpa_fwd_ms,
                        bound_ms=bounds["fwd"][0], bound_by=bounds["fwd"][1],
                        max_abs_err=o_err, **shape),
            "dq": dict(ms=dq_ms, bound_ms=bounds["dq"][0], bound_by=bounds["dq"][1],
                       max_abs_err=errs[0], **bwd),
            "dkv": dict(ms=dkv_ms, bound_ms=bounds["dkv"][0], bound_by=bounds["dkv"][1],
                        max_abs_err=max(errs[1:]), **bwd)}


def phase_bwd_kernels():
    """The two backward kernels against their plain version at the training
    shape, then at edge shapes and every tile width; at the training shape,
    each kernel's time (and the forward kernel's) beside the plain
    version's, SDPA's and the bound, and the same at the training shapes of
    WIDE_TRAIN_SHAPES.  Returns the records, keyed by kernel, and the wide
    shapes' under ``wide``."""
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
        *_width_cases(),
    ]
    records = {}
    padded_before = flash.padded_counts()
    for i, case in enumerate(cases):
        args, kw, errs = _bwd_case(*case)
        if i == 0:
            times = _train_shape_times("training shape", args, kw, errs, TRAIN_BATCH,
                                       TRAIN_SHAPE_BOUNDS)
            common = {"route": "cuda", "source": "polyaxon_tpu_torch/csrc/flash_bwd.cu"}
            records["dq"] = dict(name="flash_bwd_dq", design=DQ_DESIGN,
                                 replaces="polyaxon_tpu/parallel/flash.py:177",
                                 **common, **times["dq"])
            records["dkv"] = dict(name="flash_bwd_dkv", design=DKV_DESIGN,
                                  replaces="polyaxon_tpu/parallel/flash.py:219",
                                  **common, **times["dkv"])
            records["fwd"] = times["fwd"]
        del args
        _free()
    for kind, name in (("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv")):
        records[kind]["padded_launches_in_checks"] = (flash.padded_counts()[name]
                                                      - padded_before[name])
    records["wide"] = {}
    for heads, d in WIDE_TRAIN_SHAPES:
        args, kw, errs = _bwd_case(TRAIN_BATCH * heads, TRAIN_SEQ, TRAIN_SEQ, d, torch.bfloat16,
                                   True)
        records["wide"][f"d{d}_h{heads}_t{TRAIN_SEQ}"] = _train_shape_times(
            f"training shape, {heads} heads x {d}", args, kw, errs, TRAIN_BATCH)
        del args
        _free()
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


def phase_prefill_parity(model=BENCH_MODEL):
    """Last-position prefill logits through the kernel vs dense attention, on
    the same weights lm_generate drew (same seed, same device generator)."""
    from polyaxon_tpu_torch.models import decode
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params
    from polyaxon_tpu_torch.parallel import flash

    cfg = TransformerConfig(max_seq=1024, **model)
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
    log(f"prefill logits kernel vs dense ({cfg.n_heads} heads x {cfg.head_dim}, "
        f"{cfg.kv_heads} KV heads): min cosine {cos:.6f} (>= 0.999), max abs diff "
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
                 mesh=None, axes_tree=None):
    """A train step for ``cfg`` on lm_train's weights (seeded init on the
    card) and lm_train's batch, under ``template`` over ``mesh`` if given
    (this rank's shards of the params by ``axes_tree``)."""
    from polyaxon_tpu_torch.models.transformer import init_params, loss_fn
    from polyaxon_tpu_torch.runtime.train import build_train_step

    ts = build_train_step(
        loss_fn=lambda p, b: loss_fn(p, b, cfg, template=template, mesh=mesh, device="cuda"),
        init_fn=lambda g: init_params(cfg, g), optimizer=optimizer, mesh=mesh, template=template,
        axes_tree=axes_tree)
    params, opt_state = ts.init(torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch_size, seq + 1)), device="cuda")
    return ts, params, opt_state, ts.place_batch({"tokens": tok[:, :-1], "targets": tok[:, 1:]})


def _mfu(tokens_per_s, seq, model=BENCH_MODEL):
    """bench.py's MFU: tokens/s x (6N + 12·L·H·hd·T) over the bf16 peak."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig
    from polyaxon_tpu_torch.tracking.ledger import transformer_flops_per_token

    cfg = TransformerConfig(max_seq=seq, **model)
    fpt = transformer_flops_per_token(cfg.n_params, cfg.n_layers, cfg.n_heads, cfg.head_dim, seq)
    return tokens_per_s * fpt / H100_PEAK_FLOPS[torch.bfloat16]


def _lm_train(label, seq, batch, steps, strategy="ddp", mesh=None, reporter=None,
              model=BENCH_MODEL, outputs_path=None, **params):
    """lm_train at the width of ``model`` (the 671M bench model's by
    default), the kernels' counts set to 0 just before it and read just
    after: its loss must be finite (and fall, over more than one step) and
    each kernel must launch once per layer and step (never with
    ``attention_impl="dense"``).  ``reporter`` and ``outputs_path`` go on
    the run's Context.  Returns the launch counts, the first step's and the
    final metrics (with the run's peak memory and its first and last loss)."""
    from polyaxon_tpu_torch.builtins.trainers import lm_train
    from polyaxon_tpu_torch.tracking.context import Context

    records = []
    ctx = Context(params=dict(model, seq=seq, batch=batch, steps=steps, lr=LR,
                              device="cuda", **params),
                  strategy=strategy, mesh=mesh, seed=SEED, records=records, reporter=reporter,
                  outputs_path=outputs_path)
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
    final.update(peak_memory_allocated=peak, losses=[first["loss"], last["loss"]])
    log(f"{label} (batch {batch}, seq {seq}, {steps} steps): tokens_per_s "
        f"{final['tokens_per_s']} mfu {_mfu(final['tokens_per_s'], seq, model):.4f} first_step_s "
        f"{final['first_step_s']} step_wall_s {final['step_wall_s']} "
        f"peak_memory_allocated {peak} B; loss {first['loss']} -> {last['loss']}, "
        f"grad_norm {first['grad_norm']} -> {last['grad_norm']}; launches fwd/dq/dkv "
        f"{launches}, per step {per_step}")
    n = 0 if params.get("attention_impl") == "dense" else model["n_layers"]
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
    for key in ("tokens_per_s", "first_step_s", "step_wall_s_p50"):
        ledger[key] = final[key]
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
    """(status, body) of a GET (payload None) or a JSON POST; /metrics and the
    dashboard at / as text."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, (body.decode() if path in ("/metrics", "/") else json.loads(body))


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


def _long_shape(batch, T, heads, want_ops=None, n_heads=None):
    """The three kernels at one long causal shape (B ``batch`` x H, T, d 64,
    bf16; H the bench model's 32 heads, or ``n_heads``): the kernels on every
    head, the heads ``heads`` held
    against the plain version on those heads (the kernels' limits), and
    each kernel's time beside SDPA's on every head and its bound, which must
    be set by operations at this length (and give ``want_ops`` FLOP, where
    given).  Returns each kernel's figures, keyed fwd, dq, dkv."""
    from polyaxon_tpu_torch.parallel import flash

    H, d = n_heads or BENCH_MODEL["n_heads"], BENCH_MODEL["head_dim"]
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


def kernel_launches_in_trace(trace: Path, kernels=KERNEL_NAMES) -> dict:
    """Kernel events of a Chrome trace (torch.profiler's) by the port's
    kernel names (``kernels``)."""
    names = [e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "kernel"]
    return {k: sum(k in n for n in names) for k in kernels}


class _Reporter:
    """The capture agent's reporter: records capture and command events."""

    def __init__(self):
        self.captures, self.commands = [], []

    def capture(self, record):
        self.captures.append(dict(record))

    def command_event(self, uuid, state, message=None, **attrs):
        self.commands.append((uuid, state, message))


def phase_checkpoint():
    """Checkpoint, preemption and restore at bench.py's 671M configuration (full
    width, 2 of its 8 layers: ``CKPT_MODEL``; batch 8, seq 1024, AdamW(lr), f32
    mu): an uninterrupted 5-step reference in process; lm_train with save_every
    2 in a child process that a preemption at step 3 SIGKILLs; lm_train resumed
    in process from the newest complete step, with a profiler window on its
    last step; lm_generate and lm_server restoring the run as their target; a
    profile and a drain command through the capture agent's mailbox.
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
        train = dict(CKPT_MODEL, seq=TRAIN_SEQ, batch=CKPT_BATCH, steps=CKPT_STEPS, lr=LR,
                     device="cuda", save_every=CKPT_EVERY, preempt_step=CKPT_PREEMPT)
        cfg = TransformerConfig(max_seq=TRAIN_SEQ, **CKPT_MODEL)
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
        n = CKPT_MODEL["n_layers"]
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
        out = lm_generate(Context(params=dict(CKPT_MODEL, seq=TRAIN_SEQ, batch=CKPT_GEN_BATCH,
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
        sctx = Context(params=dict(CKPT_MODEL, seq=TRAIN_SEQ, slots=CKPT_SLOTS,
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


def _serving_model(model=None):
    """The 671M model (or ``model``'s widths) at lm_server's length, weights
    from the seed, as phases 10-12 make them."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(max_seq=SERVE_SEQ, **(model or BENCH_MODEL))
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
    span plus two blocks, on a bf16 pool offload off and then on, on an int8
    pool offload on, each beside an engine whose pool never fills (every
    prompt at once) for the tokens.  Offload on must complete 24 of 24 with
    0 sheds and 0 errors, spill and restore blocks, build no entry after
    ready, and give every request the ample pool's greedy tokens.  Offload
    off (no host tier: a slot parked on an exhausted pool keeps its blocks
    and resumes without a restore, or its request is shed) must park slots,
    move no block, answer or shed every request with 0 errors, give every
    answered request the ample pool's tokens and build no entry after ready.
    The int8 pool's off arm went to make room for phase 58's wide kernels:
    it drives the same park as the bf16 one on a smaller block."""
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

    for kv, arms in ((None, (False, True)), ("int8", (True,))):
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
        for offload in arms:
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
            if not offload and not (row["completed"] + row["sheds"] == LOADED_N
                                    and row["errors"] == 0 and row["block_parks"] > 0
                                    and row["spilled_blocks"] == 0
                                    and row["restored_blocks"] == 0
                                    and row["steady_state_compiles"] == 0
                                    and row["tokens_equal"] == row["completed"]):
                raise AssertionError(f"{label}: {row}")
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
    runs with request tracing off and on (16 a side in turns), 16 prompts of
    24 tokens queued at once; the overhead, the median over the 16 turns of
    the traced run's wall against its untraced neighbour's, must stay under
    3% (the minimum against the minimum is printed beside it), and every
    traced request's waterfall within 10% of its client latency.  Then one lm_server /generate with a traceparent header: the
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
    # The gate's statistic: the median over the turns of each traced run's
    # wall against its untraced neighbour's (the pattern pairs them: off on,
    # on off, ...), so that one fast untraced run cannot fail it alone; the
    # minimum against the minimum is printed beside it.
    off, on = min(walls[False]), min(walls[True])
    turns = [100.0 * (t / f - 1) for f, t in zip(walls[False], walls[True])]
    out = {"walls_off_s": walls[False], "walls_on_s": walls[True],
           "overhead_pct": statistics.median(turns), "overhead_pct_by_turn": turns,
           "overhead_pct_of_the_minima": max(0.0, (on - off) / off * 100),
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
    """A LocalServingFleet of lm_server's 671M configuration, cut to
    FLEET_LAYERS layers, on the card."""
    from polyaxon_tpu_torch.serving import LocalServingFleet

    fleet = LocalServingFleet(Path(workdir), FLEET_MODEL, replicas=replicas, seq=SERVE_SEQ,
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
    their tracebacks, so every exception line is read, not each block; a
    line may start with another thread's separator, socketserver's row of
    40 dashes, glued to it)."""
    if front is not None:
        front.shutdown()
        front.server_close()
    fleet.stop()
    for log_path in sorted(fleet.workdir.glob("*.log")):
        text = log_path.read_text(errors="replace")
        lines = [ln.lstrip("-") for ln in text.splitlines()]
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
                params, cfg = _serving_model(FLEET_MODEL)
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


# -- the gang layer (phases 28-30) -------------------------------------------------

#: Every gang this run launched: its workers run in sessions of their own, so a
#: run that dies must still take them down (an atexit hook SIGKILLs what is left).
_GANGS = []
#: Phase 28's run (its store's base dir, uuid and profiler trace), served by phase 48.
_GANG_RUN = {}


def _kill_gangs() -> None:
    """SIGKILL the process group of every gang process still running.  Every
    gang of this run lives on this machine, phase 49's ssh ones too (its ssh
    is a stub), so the group is killed here, not through the transport."""
    for handle in _GANGS:
        for ref in handle.processes.values():
            if ref.poll() is None:
                with contextlib.suppress(ProcessLookupError, PermissionError):
                    os.killpg(ref.pid, signal.SIGKILL)


atexit.register(_kill_gangs)


def _gang_spec(kind, entry, declarations):
    """A spec of one port worker on the card: accelerator ``h100``, one device
    on one host (no catalog entry: the counts are given)."""
    module = "services" if entry == "lm_server" else "trainers"
    return {"kind": kind,
            "run": {"entrypoint": f"polyaxon_tpu_torch.builtins.{module}:{entry}"},
            "declarations": declarations,
            "environment": {"seed": SEED, "topology": dict(GANG_TOPOLOGY)}}


def _gang_lines(handle):
    """Process 0's complete report lines so far."""
    path = handle.paths.report_file(0)
    text = path.read_text() if path.exists() else ""
    return [json.loads(line) for line in text.split("\n")[:-1]]


def _gang_log_tail(handle) -> str:
    path = handle.paths.log_file(0)
    return path.read_text()[-4000:] if path.exists() else ""


def _await_line(handle, pred, what, timeout):
    """The first report line of process 0 that ``pred`` holds for; raises if
    the worker exits first or ``timeout`` passes."""
    deadline = time.time() + timeout
    while True:
        for line in _gang_lines(handle):
            if pred(line):
                return line
        rc = handle.processes[0].poll()
        if rc is not None or time.time() > deadline:
            raise AssertionError(f"{what}: not seen (worker rc {rc}):\n{_gang_log_tail(handle)}")
        time.sleep(0.05)


def _start_gang(spawner, run, plan):
    handle = spawner.start(run, plan)
    _GANGS.append(handle)
    return handle


def phase_gang_train(in_process):
    """A one-rank gang of lm_train on the card: the port's LocalGangSpawner
    over a temp StoreLayout launches ``python -m
    polyaxon_tpu_torch.runtime.worker`` with a ``kind: experiment`` spec at
    the 671M width (batch 20, seq 1024, 5 steps, a profiler window on the
    last step), accelerator h100.  Its report file: starting, running,
    succeeded; a falling loss, tokens_per_s, one final ledger row on the
    card; the trace of the profiled step names each kernel once a layer.
    ``in_process`` holds phase 7's figures (``tokens_per_s``,
    ``first_step_s``, ``step_wall_s_p50``) to print beside the gang's: the
    worker is a fresh process, whose first step loads CUDA's modules.
    Returns the kernels' launches in that step and the gang's figures."""
    from polyaxon_tpu_torch.compiler import compile_gang_plan
    from polyaxon_tpu_torch.spawner.local import LocalGangSpawner, LocalRun
    from polyaxon_tpu_torch.stores.layout import StoreLayout

    base = Path(tempfile.mkdtemp(prefix="chip_smoke_gang_"))
    spawner = LocalGangSpawner(StoreLayout(base), heartbeat_interval=1.0)
    spec = _gang_spec("experiment", "lm_train", dict(
        BENCH_MODEL, seq=TRAIN_SEQ, batch=TRAIN_BATCH, steps=GANG_STEPS, lr=LR,
        profile_start=GANG_STEPS - 1, profile_steps=1))
    run = LocalRun(spec, id=28)
    _free()
    t0 = time.time()
    handle = _start_gang(spawner, run, compile_gang_plan(spec))
    try:
        running = _await_line(handle, lambda e: e["type"] == "status" and
                              e["status"] == "running", "the lm_train gang's running status", 300)
        first_metric = _await_line(handle, lambda e: e["type"] == "metric",
                                   "the lm_train gang's first metric", 600)
        rc = handle.processes[0].wait(600)
        wall_s = time.time() - t0
    finally:
        spawner.stop(handle, grace=5.0)
    lines = _gang_lines(handle)
    statuses = [e["status"] for e in lines if e["type"] == "status"]
    if rc != 0 or statuses != ["starting", "running", "succeeded"]:
        raise AssertionError(f"the lm_train gang: rc {rc}, statuses {statuses}:\n"
                             f"{_gang_log_tail(handle)}")
    metrics = {e["step"]: e["values"] for e in lines if e["type"] == "metric"}
    first, last, final = metrics[0], metrics[GANG_STEPS - 1], metrics[GANG_STEPS]
    if not (np.isfinite(first["loss"]) and last["loss"] < first["loss"]):
        raise AssertionError(f"the lm_train gang's loss is not finite and falling: {metrics}")
    # lm_train flushes a final row and the worker flushes one more as it
    # exits, as the reference's do: the last one is the run's.
    finals = [e for e in lines if e["type"] == "ledger" and e["final"]]
    kind = torch.cuda.get_device_name(0)
    if not finals or finals[-1]["device_kind"] != kind or finals[-1]["steps"] != GANG_STEPS:
        raise AssertionError(f"the lm_train gang's final ledger rows: {finals}")
    (trace,) = (handle.paths.outputs / "profile").glob("*.pt.trace.json")
    in_trace = kernel_launches_in_trace(trace)
    n = BENCH_MODEL["n_layers"]
    launches = tuple(in_trace[k] for k in KERNEL_NAMES)
    out = {"rc": rc, "launch_to_running_s": running["ts"] - t0,
           "launch_to_first_metric_s": first_metric["ts"] - t0, "wall_s": wall_s,
           "tokens_per_s": final["tokens_per_s"], "first_step_s": final["first_step_s"],
           "step_wall_s_p50": final["step_wall_s_p50"], "in_process": dict(in_process),
           "loss": [first["loss"], last["loss"]],
           "goodput": finals[-1]["goodput"], "mfu": finals[-1]["mfu"],
           "device_kind": finals[-1]["device_kind"], "launches_in_profiled_step": in_trace}
    log(f"lm_train gang (1 rank, h100): rc {rc}; launch to running {out['launch_to_running_s']:.2f}"
        f" s, to the first metric {out['launch_to_first_metric_s']:.2f} s; tokens_per_s "
        f"{final['tokens_per_s']}, first step {final['first_step_s']} s, step wall p50 "
        f"{final['step_wall_s_p50']} s (in process, phase 7 of this run: {in_process}); loss "
        f"{first['loss']} -> {last['loss']}; ledger goodput {out['goodput']} mfu "
        f"{out['mfu']} on {out['device_kind']}; kernels in the profiled step "
        f"{in_trace}")
    # Kept for phase 48, whose output_server serves this run's outputs.
    _GANG_RUN.update(base=base, uuid=run.uuid, file=trace.relative_to(handle.paths.outputs))
    if launches != (n, n, n):
        raise AssertionError(f"the gang's profiled step names the kernels {in_trace}, "
                             f"expected {n} each")
    return launches, out


def phase_gang_server():
    """A ``kind: service`` gang of lm_server at phase 11's configuration on
    the card: the port from the spawner's ``allocate_service_port`` (the
    plan's ``service_port`` and ``POLYAXON_TPU_SERVICE_PORT``, as the
    control plane's dispatch sets them), the worker's log line naming it,
    8 concurrent greedy /generate of 64 tokens (4 prompts of whole prefill
    chunks and one token, each twice: equal tokens for equal prompts), 0
    captures after ready, and ``stop`` ending the process group by its
    SIGTERM within the grace period."""
    import dataclasses

    from polyaxon_tpu_torch.compiler import compile_gang_plan
    from polyaxon_tpu_torch.spawner.local import LocalGangSpawner, LocalRun
    from polyaxon_tpu_torch.stores.layout import StoreLayout

    base = Path(tempfile.mkdtemp(prefix="chip_smoke_gang_server_"))
    spawner = LocalGangSpawner(StoreLayout(base), heartbeat_interval=1.0)
    spec = _gang_spec("service", "lm_server", dict(
        BENCH_MODEL, seq=SERVE_SEQ, slots=SERVE_SLOTS, block_size=SERVE_BLOCK,
        prefill_chunk=SERVE_CHUNK, prefix_cache=1, max_new_tokens=SERVE_NEW, host="127.0.0.1"))
    run = LocalRun(spec, id=29)
    plan = compile_gang_plan(spec)
    port = spawner.allocate_service_port(run)
    plan = dataclasses.replace(plan, service_port=port, env_vars={
        **plan.env_vars, "POLYAXON_TPU_SERVICE_PORT": str(port)})
    base_url = f"http://127.0.0.1:{port}"
    _free()
    t0 = time.time()
    handle = _start_gang(spawner, run, plan)
    try:
        served = _await_line(handle, lambda e: e["type"] == "log" and
                             e["line"].startswith("lm_server:") and f":{port} " in e["line"],
                             "the lm_server gang's serving line", 300)
        while True:
            try:
                health = _http(base_url, "/healthz", timeout=30)[1]
                if health["state"] == "ready":
                    break
            except OSError:
                pass
            if handle.processes[0].poll() is not None or time.time() - t0 > 300:
                raise AssertionError(f"the lm_server gang did not become ready:\n"
                                     f"{_gang_log_tail(handle)}")
            time.sleep(0.1)
        ready_s = time.time() - t0
        if health["engine"]["steady_state_compiles"]:
            raise AssertionError(f"the lm_server gang captured before traffic: {health}")
        # A copy of a prompt may find the other copy's blocks cached: its
        # tokens equal the other's only where the cached prefix is whole
        # prefill chunks (a cached prefix's KV then is the one a cold
        # prefill computes, ROADMAP Queue 3), so each prompt is whole
        # chunks and one token: 257, 513, 769 and 257 tokens.
        rng = np.random.default_rng(SEED + 29)
        distinct = [rng.integers(0, BENCH_MODEL["vocab_size"], SERVE_CHUNK * k + 1).tolist()
                    for k in (1, 2, 3, 1)]
        prompts = distinct + distinct
        results = [None] * len(prompts)

        def client(i):
            results[i] = _http(base_url, "/generate", {"prompts": [prompts[i]],
                                                       "max_new_tokens": SERVE_NEW})

        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        t1 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        burst_s = time.perf_counter() - t1
        if any(r is None or r[0] != 200 for r in results):
            raise AssertionError(f"the lm_server gang's requests: {results}")
        tokens = [r[1]["tokens"][0] for r in results]
        if any(len(t) != SERVE_NEW for t in tokens) or tokens[:4] != tokens[4:]:
            raise AssertionError("the lm_server gang gave unequal greedy tokens to equal prompts")
        after = _http(base_url, "/healthz")[1]["engine"]["steady_state_compiles"]
        if after:
            raise AssertionError(f"the lm_server gang captured {after} entries after ready")
        grace = 10.0
        t2 = time.time()
        spawner.stop(handle, grace=grace)
        stop_s = time.time() - t2
        rc = handle.processes[0].poll()
    finally:
        spawner.stop(handle, grace=1.0)
    try:
        os.killpg(handle.processes[0].pid, 0)
        alive = True
    except ProcessLookupError:
        alive = False
    out = {"port": port, "launch_to_serving_line_s": served["ts"] - t0,
           "launch_to_ready_s": ready_s, "burst_s": burst_s,
           "tokens_per_s": len(prompts) * SERVE_NEW / burst_s, "stop_s": stop_s, "rc": rc,
           "captures_after_ready": after}
    log(f"lm_server gang (h100, port {port} from allocate_service_port): serving line "
        f"{out['launch_to_serving_line_s']:.2f} s and ready {ready_s:.2f} s after launch; 8 "
        f"concurrent requests x {SERVE_NEW} tokens in {burst_s:.3f} s, "
        f"{out['tokens_per_s']:.1f} tokens/s; equal prompts gave equal tokens; stop took "
        f"{stop_s:.3f} s (grace {grace} s), rc {rc}, process group alive: {alive}")
    shutil.rmtree(base, ignore_errors=True)
    if rc != -signal.SIGTERM or stop_s > grace or alive:
        raise AssertionError("the lm_server gang did not end by its SIGTERM within the grace")
    return out


def _thread_rank_steps(label, cfg, batch, seq, steps):
    """``steps`` train steps of ``cfg`` on 2 ranks of a {data: 2} mesh, the
    ranks threads of this process over gloo (an in-memory store) on the card,
    each on its rows of the global batch; then one rank on the whole batch.
    Returns each rank's and the one rank's (loss, grad_norm) a step, the
    kernels' launches over the two ranks, and the all-reduce's walls."""
    import datetime

    import torch.distributed as dist

    from polyaxon_tpu_torch.parallel.ring import LocalRing
    from polyaxon_tpu_torch.parallel.templates import template_for
    from polyaxon_tpu_torch.runtime.mesh import build_mesh
    from polyaxon_tpu_torch.runtime.optim import AdamW

    store = dist.HashStore()
    walls = []
    real_all_reduce = dist.all_reduce

    def timed_all_reduce(tensor, *args, **kw):  # synchronized before and after
        torch.cuda.synchronize()
        t = time.perf_counter()
        work = real_all_reduce(tensor, *args, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t, tensor.numel() * tensor.element_size()))
        return work

    def rank_main(ring):
        group = dist.ProcessGroupGloo(dist.PrefixStore(label, store), ring.rank, 2,
                                      datetime.timedelta(seconds=300))
        mesh = build_mesh({"data": 2}, {"data": group})
        ts, params, opt_state, local = _train_setup(
            cfg, AdamW(LR), batch_size=batch, seq=seq,
            template=template_for("ddp", dict(mesh.shape)), mesh=mesh)
        hist = []
        for _ in range(steps):
            params, opt_state, m = ts.step(params, opt_state, local)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        return hist

    _free()
    _reset_counts()
    dist.all_reduce = timed_all_reduce
    try:
        ranks = LocalRing.run(2, rank_main, timeout=600)
    finally:
        dist.all_reduce = real_all_reduce
    torch.cuda.synchronize()
    launches = _counts()
    _free()
    ts, params, opt_state, whole = _train_setup(cfg, AdamW(LR), batch_size=batch, seq=seq)
    one = []
    for _ in range(steps):
        params, opt_state, m = ts.step(params, opt_state, whole)
        one.append((float(m["loss"]), float(m["grad_norm"])))
    del ts, params, opt_state, whole
    _free()
    return ranks, one, launches, walls


def phase_train_step_ranks():
    """The multi-rank train step on the card: 2 thread ranks over gloo on
    CUDA tensors (NCCL takes one rank a device, and this machine has one),
    ``ddp`` on {data: 2}.  The bench width with 2 layers, global batch
    4 x 1024, bf16 compute, 2 steps: each rank's loss and grad norm against
    one rank's step on the whole batch within STEP_RANKS_BF16_RTOL, the
    kernels launched on both ranks; the small float32 model (4 x 128) within
    STEP_RANKS_F32_ATOL.  The all-reduce's wall a step goes over gloo, which
    copies through the host: it says nothing of NCCL."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig

    out = {}
    n = STEP_RANKS_LAYERS
    for label, cfg, batch, seq, check in (
            ("bf16, the 671M width with 2 layers",
             TransformerConfig(max_seq=TRAIN_SEQ, **dict(BENCH_MODEL, n_layers=n)),
             STEP_RANKS_BATCH, TRAIN_SEQ,
             lambda a, b: abs(a - b) <= STEP_RANKS_BF16_RTOL * abs(b)),
            ("float32, the small model",
             TransformerConfig(dtype=torch.float32, **SMALL_SERVE),
             STEP_RANKS_BATCH, SMALL_SERVE["max_seq"],
             lambda a, b: abs(a - b) <= STEP_RANKS_F32_ATOL)):
        ranks, one, launches, walls = _thread_rank_steps(label, cfg, batch, seq,
                                                         STEP_RANKS_STEPS)
        layers = cfg.n_layers * STEP_RANKS_STEPS
        ok = all(check(a, b) for hist in ranks for pair in zip(hist, one)
                 for a, b in zip(*pair))
        per_step = [w for w, _ in walls]
        log(f"train step on 2 thread ranks over gloo (not NCCL), ddp {{data: 2}}, {label}, "
            f"batch {batch} x {seq}, {STEP_RANKS_STEPS} steps: (loss, grad_norm) per step "
            f"rank 0 {ranks[0]}, rank 1 {ranks[1]}, one rank on the whole batch {one}; "
            f"kernels fwd/dq/dkv {launches} over both ranks (one rank alone: {layers} each); "
            f"all-reduce walls {per_step} s for {walls[0][1]} B a rank (synchronized before "
            f"and after, host copies through gloo)")
        if not ok:
            raise AssertionError(f"the 2-rank step ({label}) disagrees with one rank's")
        if cfg.dtype == torch.bfloat16 and not all(layers < c <= 2 * layers for c in launches):
            raise AssertionError(f"the kernels did not launch on both ranks: {launches}")
        out[label] = {"ranks": ranks, "one_rank": one, "launches": launches,
                      "all_reduce_s": per_step, "all_reduce_bytes": walls[0][1],
                      "backend": "gloo on thread ranks"}
    return out


def _fresh_step_walls():
    """Drop the process's train step-wall and data-wait histograms, so that
    the next trainer's percentiles hold its own steps alone (``get_stats()``
    is process-wide, as the reference's is)."""
    from polyaxon_tpu_torch.stats import get_stats

    for key in ("train.step_wall_s", "train.data_wait_s", "train.ckpt_block_s"):
        get_stats().histograms.pop(key, None)


def _image_run(trainer, params, data_path=None):
    """``trainer`` on the card from a Context, the ledger's rows caught: its
    metrics by step, its final ledger row and the card's peak memory."""
    from polyaxon_tpu_torch.tracking import ledger
    from polyaxon_tpu_torch.tracking.context import Context

    records, rows = [], []
    _free()
    _fresh_step_walls()
    torch.cuda.reset_peak_memory_stats()
    ledger.configure(sink=rows.append)
    try:
        trainer(Context(params=dict(params, device="cuda"), seed=SEED, records=records,
                        data_path=data_path))
    finally:
        ledger.configure(sink=None)
    torch.cuda.synchronize()
    metrics = {}
    for r in records:
        if r["kind"] == "metric":
            metrics.setdefault(r["step"], {}).update(r["values"])
        else:
            log(r["line"])
    (row,) = [r for r in rows if r["final"]]
    if row["device_kind"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"the trainer's ledger row is not the card's: {row['device_kind']}")
    return metrics, row, torch.cuda.max_memory_allocated()


def _falls(label, metrics, steps):
    first, last = metrics[0]["loss"], metrics[steps - 1]["loss"]
    if not (np.isfinite(first) and np.isfinite(last) and last < first):
        raise AssertionError(f"{label}: the loss is not finite and falling: {first} -> {last}")
    return [first, last]


def _card_vs_cpu(label, init, loss, forward, batch):
    """One bf16 step of an image model on the card against the port's own
    CPU step, from the same weights (made on the CPU from the seed) and the
    same batch: the loss, the logits and every parameter grad."""
    from polyaxon_tpu_torch.runtime.optim import tree_leaves

    weights = init(torch.Generator().manual_seed(SEED))
    out = {}
    for device in ("cpu", "cuda"):
        params = _to(weights, device)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        placed = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        with torch.no_grad():
            logits = forward(params, placed["images"], device).cpu()
        value = loss(params, placed, device)
        grads = [g.float().cpu() for g in torch.autograd.grad(value, leaves)]
        out[device] = (value.item(), logits, grads)
    (cpu_loss, cpu_logits, cpu_grads), (loss_card, logits_card, grads_card) = out["cpu"], out["cuda"]
    figures = {
        "loss_cpu": cpu_loss, "loss_card": loss_card,
        "loss_rel": abs(loss_card - cpu_loss) / abs(cpu_loss),
        "logits_rel": ((logits_card - cpu_logits).abs().max() / cpu_logits.abs().max()).item(),
        "grads_rel": max(((a - b).norm() / b.norm()).item() for a, b in zip(grads_card, cpu_grads)),
    }
    log(f"{label}, one bf16 step on the card vs the CPU ({len(batch['labels'])} images): "
        f"{figures} (limits: loss {IMAGE_LOSS_RTOL}, logits {IMAGE_LOGITS_RTOL} of the largest, "
        f"each grad {BF16_MODEL_GRAD_RTOL} of its norm)")
    if not (figures["loss_rel"] <= IMAGE_LOSS_RTOL and figures["logits_rel"] <= IMAGE_LOGITS_RTOL
            and figures["grads_rel"] <= BF16_MODEL_GRAD_RTOL):
        raise AssertionError(f"{label}: the card's step disagrees with the CPU's")
    return figures


def _image_batch(batch, size, classes):
    from polyaxon_tpu_torch.runtime.datasets import synthetic_class_images

    images, labels = synthetic_class_images(np.random.default_rng(SEED + 31), batch, size, classes)
    return {"images": images, "labels": labels}


def _profiled_image_step(label, loss, init, optimizer, batch, top=8):
    """One train step of an image model at the trainer's batch under
    torch.profiler (``_profile``), its weights from the seed on the card."""
    from polyaxon_tpu_torch.runtime.train import build_train_step

    ts = build_train_step(loss_fn=lambda p, b: loss(p, b, "cuda"), init_fn=init,
                          optimizer=optimizer)
    params, opt_state = ts.init(torch.Generator(device="cuda").manual_seed(SEED))
    placed = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    figures = _profile(label, lambda: ts.step(params, opt_state, placed), 1, top=top)
    del ts, params, opt_state, placed
    _free()
    return figures


def phase_cnn_train():
    """cnn_train at the CIFAR-10 guide's shape: CNN_STEPS steps on synthetic
    images (the loss falls, the fixed batch's accuracy above chance), then
    CNN_DATA_STEPS through the dataset path on a make_image_fixture store of
    CNN_DATA_EXAMPLES images (TrainPipeline with device_prefetch); one bf16
    step on the card against the CPU; a profiled step's idle share."""
    from polyaxon_tpu_torch.builtins.trainers import cnn_train
    from polyaxon_tpu_torch.models import cnn
    from polyaxon_tpu_torch.runtime.datasets import make_image_fixture
    from polyaxon_tpu_torch.runtime.optim import AdamW

    params = dict(CNN_MODEL, batch=CNN_BATCH)
    synth, synth_row, synth_peak = _image_run(cnn_train, dict(params, steps=CNN_STEPS))
    final = synth[CNN_STEPS]
    losses = _falls("cnn_train (synthetic)", synth, CNN_STEPS)
    chance = 1.0 / CNN_MODEL["classes"]
    if not final["accuracy"] > chance:
        raise AssertionError(f"cnn_train: accuracy {final['accuracy']} on its fixed batch is not "
                             f"above chance {chance}")
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_cifar_"))
    try:
        make_image_fixture(store, "cifar-fixture", num_examples=CNN_DATA_EXAMPLES,
                           image_size=CNN_MODEL["image_size"], n_classes=CNN_MODEL["classes"])
        data, data_row, _ = _image_run(cnn_train, dict(params, steps=CNN_DATA_STEPS,
                                                       dataset="cifar-fixture"), str(store))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    data_losses = _falls("cnn_train (dataset path)", data, CNN_DATA_STEPS)
    cfg = cnn.CNNConfig(image_size=CNN_MODEL["image_size"], channels=CNN_MODEL["channels"],
                        n_classes=CNN_MODEL["classes"])

    def normalized(images):  # cnn_train's: in the compute dtype, on the device
        return images.to(cfg.dtype) / 255.0 - 0.5

    def loss(p, b, device):
        return cnn.loss_fn(p, dict(b, images=normalized(b["images"])), cfg, device=device)

    agreement = _card_vs_cpu(
        "cnn (CIFAR-10 guide shape)", lambda g: cnn.init_params(cfg, g), loss,
        lambda p, images, device: cnn.forward(p, normalized(images), cfg, device=device),
        _image_batch(IMAGE_CHECK_BATCH, cfg.image_size, cfg.n_classes))
    profiled = _profiled_image_step(
        f"cnn_train step (batch {CNN_BATCH})", loss, lambda g: cnn.init_params(cfg, g),
        AdamW(1e-3), _image_batch(CNN_BATCH, cfg.image_size, cfg.n_classes))
    out = {"synthetic": {"loss": losses, "accuracy": final["accuracy"],
                         "images_per_s": final["images_per_s"],
                         "first_step_s": final["first_step_s"],
                         "step_wall_s_p50": final["step_wall_s_p50"],
                         "ledger_mfu": synth_row["mfu"], "ledger_goodput": synth_row["goodput"],
                         "hbm_peak_bytes": synth_row["hbm_peak_bytes"],
                         "peak_memory_allocated": synth_peak},
           "dataset": {"loss": data_losses, "accuracy": data[CNN_DATA_STEPS]["accuracy"],
                       "images_per_s": data[CNN_DATA_STEPS]["images_per_s"],
                       "step_wall_s_p50": data[CNN_DATA_STEPS]["step_wall_s_p50"],
                       "data_wait_s_per_step": data[CNN_DATA_STEPS]["data_wait_s"],
                       "ledger_mfu": data_row["mfu"],
                       "ledger_data_wait_s": data_row["buckets"]["data_wait_s"]},
           "card_vs_cpu": agreement, "profiled_step": profiled, "card": _card()}
    log(f"cnn_train (32 px, channels {CNN_MODEL['channels']}, batch {CNN_BATCH}): {out}")
    return out


def phase_vit_train():
    """vit_train at ViT-B/16's widths: VIT_STEPS synthetic steps (the loss
    falls), images/s, MFU and peak memory; one bf16 step on the card against
    the CPU at VIT_CHECK_LAYERS layers; a profiled step's top device ops."""
    from polyaxon_tpu_torch.builtins.trainers import vit_train
    from polyaxon_tpu_torch.models import vit
    from polyaxon_tpu_torch.runtime.optim import AdamW

    metrics, row, peak = _image_run(vit_train, dict(VIT_B16, batch=VIT_BATCH, steps=VIT_STEPS))
    final = metrics[VIT_STEPS]
    losses = _falls("vit_train", metrics, VIT_STEPS)
    widths = {k: VIT_B16[k] for k in ("image_size", "patch_size", "d_model", "n_layers",
                                      "n_heads", "head_dim", "d_ff")}
    cfg = vit.ViTConfig(n_classes=VIT_B16["classes"], **widths)

    def loss(p, b, device, cfg=cfg):
        return vit.loss_fn(p, b, cfg, device=device)

    check = cfg.scaled(n_layers=VIT_CHECK_LAYERS)
    agreement = _card_vs_cpu(
        f"vit (ViT-B/16 widths, {VIT_CHECK_LAYERS} layers)", lambda g: vit.init_params(check, g),
        lambda p, b, device: vit.loss_fn(p, b, check, device=device),
        lambda p, images, device: vit.forward(p, images, check, device=device),
        _image_batch(IMAGE_CHECK_BATCH, cfg.image_size, cfg.n_classes))
    profiled = _profiled_image_step(
        f"vit_train step (ViT-B/16 widths, batch {VIT_BATCH})", loss,
        lambda g: vit.init_params(cfg, g), AdamW(1e-3, mu_dtype=torch.bfloat16),
        _image_batch(VIT_BATCH, cfg.image_size, cfg.n_classes), top=12)
    loop_mfu = final["images_per_s"] * row["flops"] / (row["steps"] * VIT_BATCH) / \
        H100_PEAK_FLOPS[torch.bfloat16]
    out = {"loss": losses, "accuracy": final["accuracy"], "images_per_s": final["images_per_s"],
           "first_step_s": final["first_step_s"], "step_wall_s_p50": final["step_wall_s_p50"],
           "ledger_mfu": row["mfu"], "mfu_over_loop_wall": loop_mfu,
           "hbm_peak_bytes": row["hbm_peak_bytes"], "peak_memory_allocated": peak,
           "n_params": cfg.n_params, "card_vs_cpu": agreement, "profiled_step": profiled,
           "card": _card()}
    log(f"vit_train (ViT-B/16 widths, batch {VIT_BATCH}): {out}")
    return out


# The sharded strategies without a pipeline (phases 34-37).  Each rank is a
# process of this script (SHARDED_RANK) on the one card, joined over gloo by
# init_process_group at tcp://127.0.0.1: the collectives of these strategies
# run inside the backward, which the autograd engine runs on one thread a
# device, so thread ranks of one process on one card would wait for each
# other there (phase 30's thread ranks all-reduce after the backward), and
# NCCL takes one rank a device.  Gloo copies every CUDA tensor through the
# host, so no wall here says anything of NCCL.
SHARDED_RANK = "--sharded-rank"
SHARDED_LM = {"fsdp": ("fsdp", {"data": 2}), "tp": ("tp", {"tensor": 2}),
              "tp_dp": ("tp_dp", {"data": 2, "tensor": 2}),
              "ulysses": ("ulysses", {"sequence": 2}), "sp_ring": ("sp_ring", {"sequence": 2})}
ULYSSES_BATCH, ULYSSES_SEQ = 1, 8192
VIT_FSDP_BATCH, VIT_FSDP_STEPS = 32, 2
SHARDED_TIMEOUT_S = 600
COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all", "batch_isend_irecv")
# The pipeline and the experts across ranks (phases 38-41): name -> (strategy,
# mesh axes, template options).  pp_moe and ep carry MOE_EXPERTS experts at
# capacity factor MOE_CAPACITY; ep at batch MOE_BATCH, the others at
# STEP_RANKS_BATCH.
PIPELINE_EXPERTS = {"pp": ("pp", {"pipeline": 2}, {"num_microbatches": 2}),
                    "pp_moe": ("pp", {"pipeline": 2}, {"num_microbatches": 1}),
                    "pp_tp": ("pp_tp", {"pipeline": 2, "tensor": 2}, {"num_microbatches": 2}),
                    "ep": ("ep", {"data": 2, "expert": 2}, {}),
                    "pp_tp_moe": ("pp_tp", {"pipeline": 2, "tensor": 2},
                                  {"num_microbatches": 1}),
                    "pp_dp_moe": ("pp_tp", {"data": 2, "pipeline": 2, "tensor": 1},
                                  {"num_microbatches": 2})}
# Rules the port once refused, in the same lanes (held to one rank as the
# others): a custom head_dim split (stored split, gathered at each use), ddp
# on an axis that no rule names (a replica axis), and MoE under a custom
# pipeline that is not composed, whose stages gather their layers' weights
# whole, experts included (one microbatch and no data axis: each stage
# routes the whole batch, as one rank does).
RULE_CASES = {"custom_head_dim": ("custom", {"tensor": 2}, {"rules": {"head_dim": "tensor"}}),
              "ddp_replica": ("ddp", {"tensor": 2}, {}),
              "custom_pp_moe": ("custom", {"pipeline": 2, "tensor": 2}, {
                  "pipeline_axis": "pipeline", "num_microbatches": 1,
                  "rules": {"layers": "pipeline", "heads": "tensor", "mlp": "tensor",
                            "vocab": "tensor"}})}
MOE_RANK_CASES = ("pp_moe", "ep", "pp_tp_moe", "pp_dp_moe", "custom_pp_moe")
# The rest of the parallel layer (phases 42-46): the image models under the
# templates ddp and fsdp do not cover, name -> (model, strategy, mesh axes),
# at ViT-B/16's widths cut to STEP_RANKS_LAYERS layers (batch VIT_FSDP_BATCH,
# lr VIT_RANK_LR) and the CIFAR shape (batch CNN_BATCH), STEP_RANKS_STEPS
# steps.  At lr 1e-3 one update fits the ViT's fixed batch to a loss near 7e-4,
# where bf16 rounding in another order moves the loss and grad norm by 2e-2
# relative while float32 agrees within 1e-6 (H100 80GB HBM3, 700 W): at lr 1e-5 the loss
# stays near its start, as tools/sharded_gangs.py's vit_train runs.  Then sp_ring
# {sequence: 2} (SHARDED_LM), MoE under pp_tp (PIPELINE_EXPERTS, flash: on
# {pipeline: 2, tensor: 2} one microbatch, the tokens one rank routes; on
# {data: 2, pipeline: 2} two, each routed over the data ranks' blocks of it)
# and checkpoint-now under fsdp.
IMAGE_RANK_CASES = {"vit_tp": ("vit", "tp", {"tensor": 2}),
                    "vit_ulysses": ("vit", "ulysses", {"sequence": 2}),
                    "vit_pp": ("vit", "pp", {"pipeline": 2}),
                    "cnn_tp": ("cnn", "tp", {"tensor": 2}),
                    "vit_tp_dp": ("vit", "tp_dp", {"data": 2, "tensor": 2}),
                    "vit_pp_tp": ("vit", "pp_tp", {"pipeline": 2, "tensor": 2}),
                    "vit_ep": ("vit", "ep", {"data": 2, "expert": 2})}
# checkpoint-now over 2 rank processes under fsdp {data: 2} at the 671M width
# cut to STEP_RANKS_LAYERS layers: CKPT_NOW_STEPS steps, rank r's copy of one
# command dropped into its mailbox at step CKPT_NOW_DROPS[r]; the flag's
# all-reduce timed over CKPT_NOW_REPS calls on an idle card.
CKPT_NOW_STEPS, CKPT_NOW_DROPS, CKPT_NOW_REPS, CKPT_NOW_UUID = 5, (1, 3), 50, "ckpt-now-1"
VIT_RANK_LR = 1e-5
# Phase 47, mesh serving over 2 rank processes on the one card (gloo): the
# 671M width cut to MESH_LAYERS layers under tp {tensor: 2}, float32 then
# bf16.  sharded_generate_fn on MESH_BATCH prompts of MESH_PROMPT tokens,
# MESH_NEW new; the engine (MESH_SLOTS slots, max_len MESH_SEQ, speculative
# decoding on) on 8 requests of MESH_NEW tokens: one with a MESH_PREFIX-token
# prefix, then, once its first token is out, two more on that prefix (cache
# hits), one that echoes the static batch's first continuation (its own
# greedy tokens, then their first half again: where the model's next token
# follows the token before it, as a random init's mostly does, the n-gram
# drafts land) and four others, together.
# In bf16 a token that differs from one rank's must sit where one rank's
# top-2 logits lie within MESH_BF16_GAP: two rounding orders of the same
# sums flip only near-ties (bf16 keeps 8 bits: 2^-3 is 32 of its steps at a
# logit of 1, where the init's logits lie within a few units).
MESH_AXES, MESH_LAYERS, MESH_SEQ = {"tensor": 2}, 2, 512
MESH_BATCH, MESH_PROMPT, MESH_NEW, MESH_PREFIX, MESH_SLOTS = 4, 128, 32, 256, 8
MESH_SEED, MESH_BF16_GAP, MESH_LOGITS_COS = 53, 2.0 ** -3, 0.999
# Phase 47's cases, each a rank case of its own in the 2-rank launch:
# (strategy, axes, layers, new tokens a generate and a request, the engine's
# requests after the first).  pp at 4 layers, so that each stage runs two.
# fsdp gathers every weight over gloo through the host at each device call
# (537 MB a step in float32 at 2 layers, 1.26 s a step on an H100 80GB
# HBM3 at 700 W, PERF.md): at phase 47's 32 tokens and 8 requests its case
# took 244 s a rank, so it
# serves the first request and the two that hit its prefix, 4 tokens each,
# and its generate makes 4 tokens.
MESH_CASES = {"mesh_serving": ("tp", MESH_AXES, MESH_LAYERS, MESH_NEW, 7),
              "mesh_serving_pp": ("pp", {"pipeline": 2}, 4, MESH_NEW, 7),
              "mesh_serving_fsdp": ("fsdp", {"data": 2}, MESH_LAYERS, 4, 2)}
# Phase 41 counts the tokens dropped at these capacity factors from one
# routing at the initial weights: at MOE_CAPACITY a random init drops none
# (PR 15 call 2), so the smaller ones show which capacity and ranking apply.
DROP_FACTORS = (MOE_CAPACITY, 1.0, 0.5)


@contextlib.contextmanager
def _timed_collectives():
    """Each list-form collective synchronized before and after and timed:
    yields ``{name: [(seconds, bytes sent by this rank), ...]}``."""
    import torch.distributed as dist

    walls = {name: [] for name in COLLECTIVES}
    real = {name: getattr(dist, name) for name in COLLECTIVES}

    def timed(name):
        def call(*args, **kw):
            if name == "batch_isend_irecv":  # the stage hop: what this rank sends
                sent = [op.tensor for op in args[0]
                        if getattr(op.op, "__name__", "") == "isend"]
            else:
                sent = args[1] if name != "all_reduce" else args[0]
            sent = sent if isinstance(sent, (list, tuple)) else [sent]
            torch.cuda.synchronize()
            t = time.perf_counter()
            work = real[name](*args, **kw)
            if name == "batch_isend_irecv":
                # Waited here, inside the wall; a gloo send's work waited a
                # second time blocks, so the caller gets none to wait on.
                for w in work:
                    w.wait()
                work = []
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t,
                                sum(x.numel() * x.element_size() for x in sent)))
            return work
        return call

    for name in COLLECTIVES:
        setattr(dist, name, timed(name))
    try:
        yield walls
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def _state_bytes(params, opt_state):
    from polyaxon_tpu_torch.runtime.optim import tree_leaves

    return (sum(p.numel() * p.element_size() for p in tree_leaves(params)),
            sum(m.numel() * m.element_size() for m in opt_state.mu + opt_state.nu))


def _sharded_lm_shape(name):
    """(config, global batch, seq) of a case of SHARDED_LM or PIPELINE_EXPERTS."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig

    batch, seq = ((ULYSSES_BATCH, ULYSSES_SEQ) if name in ("ulysses", "sp_ring")
                  else (MOE_BATCH if name in ("ep", "pp_tp_moe", "pp_dp_moe")
                        else STEP_RANKS_BATCH, TRAIN_SEQ))
    model = dict(BENCH_MODEL, n_layers=STEP_RANKS_LAYERS)
    if name in MOE_RANK_CASES:
        model.update(n_experts=MOE_EXPERTS, capacity_factor=MOE_CAPACITY)
    if name in ("pp_tp_moe", "pp_dp_moe", "custom_pp_moe"):
        model.update(attention_impl="flash")
    return TransformerConfig(max_seq=seq, **model), batch, seq


def _case_template(name):
    """(strategy, axes, template options) of a rank-process case."""
    if name in PIPELINE_EXPERTS:
        return PIPELINE_EXPERTS[name]
    if name in RULE_CASES:
        return RULE_CASES[name]
    return (*SHARDED_LM[name], {})


def _block_bytes(params, keys=None):
    return sum(w.numel() * w.element_size() for k, w in params["block"].items()
               if keys is None or k in keys)


def _dropped_at_capacity(params, tokens, cfg, template=None, mesh=None):
    """Per capacity factor of DROP_FACTORS and per layer, the global tokens
    one no-grad forward on ``tokens`` (this rank's) drops at capacity,
    counted by the model's own ranking (``_Shard.rank_in_expert`` across
    ranks), and the global expert indices (int lists, one per layer)."""
    from polyaxon_tpu_torch.models.transformer import _Shard, forward
    from polyaxon_tpu_torch.parallel.collectives import all_gather_cat

    E = cfg.n_experts
    with torch.no_grad():
        _, (_, idx) = forward(params, tokens, cfg, template=template, mesh=mesh, device="cuda")
        dropped, whole = [], []
        for layer in idx:
            if template is None:
                full = layer.reshape(-1)
                rank = torch.nn.functional.one_hot(full, E).cumsum(0).gather(
                    1, full[:, None])[:, 0] - 1
                n = full.numel()
            else:
                shard = _Shard(cfg, template, mesh)
                rank, n = shard.rank_in_expert(layer, E)
                full = layer.to(torch.int32)
                for a in reversed(shard.token_batch_axes):
                    full = all_gather_cat(full, 0, mesh.group(a))
                full = full.reshape(-1)
            count = torch.stack([(rank >= max(1, int(f * n / E))).sum() for f in DROP_FACTORS])
            count = count.float()
            if template is not None:
                for group in shard.token_groups:
                    torch.distributed.all_reduce(count, group=group)
            dropped.append([int(c) for c in count.tolist()])
            whole.append(full.tolist())
    return [list(by_factor) for by_factor in zip(*dropped)], whole


def _microbatch_drops(params, cfg, batch, seq, template=None, mesh=None):
    """The routing of a composed pipeline's MoE, microbatch by microbatch:
    ``_moe_mlp`` of a layer (under ``template``, this rank's first, layer
    ``stage·L/S``, on the rows ``shard_batch`` gives it; else every layer)
    routes a hidden state made from the seed, each global microbatch of
    ``template.num_microbatches`` in turn.  Returns ``{layer: (per capacity
    factor of DROP_FACTORS the global tokens dropped, summed over the
    microbatches; per microbatch its global expert indices, int lists)}``,
    counted by the model's own ranking (``_Shard.rank_in_expert`` across
    ranks) at the initial weights."""
    from polyaxon_tpu_torch.models.transformer import _moe_mlp, _rank_in_expert, _Shard
    from polyaxon_tpu_torch.parallel.collectives import all_gather_cat
    from polyaxon_tpu_torch.runtime.train import shard_batch

    E, M = cfg.n_experts, PIPELINE_EXPERTS["pp_dp_moe"][2]["num_microbatches"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 45)
    h = torch.randn(batch, seq, cfg.d_model, generator=g, device="cuda").to(cfg.dtype)
    out = {}
    with torch.no_grad():
        if template is None:
            rows = torch.arange(batch, device="cuda")
            layers = {i: ({n: w[i] for n, w in params["block"].items()}, None)
                      for i in range(cfg.n_layers)}
        else:
            shard = _Shard(cfg, template, mesh)
            rows = shard_batch({"rows": torch.arange(batch, device="cuda")}, mesh, template)["rows"]
            first = mesh.rank(template.pipeline_axis) * cfg.n_layers // mesh.shape[
                template.pipeline_axis]
            layers = {first: ({n: shard.placement.use(w[0], shard.layer_specs[n],
                                                      shard.layer_keep[n])
                               for n, w in params["block"].items()}, shard)}
        for i, (layer, sh) in layers.items():
            dropped = torch.zeros(len(DROP_FACTORS), device="cuda")
            whole = []
            for mb in rows.chunk(M):
                _, _, idx = _moe_mlp(h[mb], layer, cfg, sh)
                if sh is None:
                    rank, n, full = _rank_in_expert(idx, E), idx.numel(), idx
                else:
                    rank, n = sh.rank_in_expert(idx, E)
                    full = idx.to(torch.int32)
                    for a in reversed(sh.token_batch_axes):
                        full = all_gather_cat(full, 0, mesh.group(a))
                dropped += torch.stack([(rank >= max(1, int(f * n / E))).sum()
                                        for f in DROP_FACTORS]).float()
                whole.append(full.reshape(-1).tolist())
            if sh is not None:
                for group in sh.token_groups:
                    torch.distributed.all_reduce(dropped, group=group)
            out[i] = ([int(c) for c in dropped.tolist()], whole)
    return out


def _sharded_lm_rank(name):
    """This rank's run of SHARDED_LM[name] or PIPELINE_EXPERTS[name]: the
    kernels' counts set to 0 just before its steps and read just after,
    (loss, grad_norm) a step, its state's bytes (and its block's, its
    experts'), the tokens dropped at capacity under MoE, and the
    collectives' walls."""
    from polyaxon_tpu_torch.models.transformer import param_axes
    from polyaxon_tpu_torch.parallel.templates import template_for
    from polyaxon_tpu_torch.runtime.mesh import mesh_from_world
    from polyaxon_tpu_torch.runtime.optim import AdamW

    strategy, axes, options = _case_template(name)
    cfg, batch, seq = _sharded_lm_shape(name)
    mesh = mesh_from_world(axes)
    template = template_for(strategy, axes, options)
    ts, params, opt_state, local = _train_setup(
        cfg, AdamW(LR), batch_size=batch, seq=seq, template=template,
        mesh=mesh, axes_tree=param_axes(cfg))
    state = _state_bytes(params, opt_state)
    extra = {"block_bytes": _block_bytes(params)}
    if cfg.n_experts:
        extra.update(expert_bytes=_block_bytes(params, ("wi", "wg", "wd", "router")),
                     experts_held=params["block"]["wi"].shape[1])
        if template.pipeline_axis is None:
            extra["dropped"], whole = _dropped_at_capacity(params, local["tokens"], cfg,
                                                           template, mesh)
            if torch.distributed.get_rank() == 0:
                extra["expert_idx"] = whole
        elif name == "pp_dp_moe":
            ((layer, (dropped, whole)),) = _microbatch_drops(params, cfg, batch, seq, template,
                                                             mesh).items()
            extra.update(layer=layer, dropped=dropped)
            if mesh.rank("data") == 0:
                extra["expert_idx"] = whole
    torch.cuda.synchronize()
    _reset_counts()
    hist = []
    with _timed_collectives() as walls:
        for _ in range(STEP_RANKS_STEPS):
            params, opt_state, m = ts.step(params, opt_state, local)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
    launches = _counts()
    del ts, params, opt_state, local
    _free()
    return {"history": hist, "launches": launches, "param_bytes": state[0],
            "adam_bytes": state[1], **extra,
            "walls": {k: {"calls": len(v), "s": sum(w for w, _ in v), "bytes": sum(b for _, b in v)}
                      for k, v in walls.items()}}


def _vit_fsdp_run(mesh=None, rank=0, world=1):
    """vit_train at ViT-B/16's widths through the entry point, under fsdp on
    ``mesh`` (or on one rank): the leader's [step, loss] pairs and log lines."""
    from polyaxon_tpu_torch.builtins.trainers import vit_train
    from polyaxon_tpu_torch.tracking.context import Context

    records = []
    _free()
    vit_train(Context(params=dict(VIT_B16, batch=VIT_FSDP_BATCH, steps=VIT_FSDP_STEPS,
                                  device="cuda"),
                      seed=SEED, records=records, mesh=mesh, strategy="fsdp" if mesh else "ddp",
                      process_id=rank, num_processes=world))
    torch.cuda.synchronize()
    lines = [r["line"] for r in records if r["kind"] == "log"]
    return {"losses": [[r["step"], r["values"]["loss"]] for r in records
                       if r["kind"] == "metric" and "loss" in r["values"]], "lines": lines}


def _sharded_rank_main(world, rank, port, out_dir, cases):
    """One rank process of phases 34-47: join the gloo world, run ``cases``
    (names of SHARDED_LM, PIPELINE_EXPERTS or IMAGE_RANK_CASES, ``vit_fsdp``,
    ``ckpt_now`` or ``mesh_serving``) in order, write their results to
    ``<out_dir>/rank<rank>.json``."""
    import datetime

    import torch.distributed as dist

    from polyaxon_tpu_torch.runtime.mesh import mesh_from_world

    world, rank = int(world), int(rank)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=180))
    try:
        out = {}
        for case in cases.split(","):
            t = time.perf_counter()
            if case == "vit_fsdp":
                out[case] = _vit_fsdp_run(mesh_from_world({"data": world}), rank, world)
            elif case in IMAGE_RANK_CASES:
                out[case] = _sharded_image_rank(case)
            elif case == "ckpt_now":
                out[case] = _ckpt_now_rank(rank, out_dir)
            elif case in MESH_CASES:
                out[case] = _mesh_serving_rank(case)
            else:
                out[case] = _sharded_lm_rank(case)
            out[case]["wall_s"] = time.perf_counter() - t
            log(f"rank {rank}: {case} done in {out[case]['wall_s']:.1f} s")
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def _run_rank_processes(world, cases):
    """Start ``world`` rank processes of this script on the card, wait for
    them (a failed one stops the others), and return each rank's results.
    Their logs are printed."""
    out = Path(tempfile.mkdtemp(prefix="sharded-ranks-"))
    port = _free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            logs.append(open(out / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), SHARDED_RANK, str(world), str(r),
                 str(port), str(out), ",".join(cases)],
                stdout=logs[-1], stderr=subprocess.STDOUT,
                cwd=str(Path(__file__).resolve().parent)))
        deadline = time.monotonic() + SHARDED_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r in range(world):
        for line in (out / f"rank{r}.log").read_text().splitlines()[-40:]:
            log(f"  [rank {r}] {line}")
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise AssertionError(f"the rank processes of {cases} ended with {rcs}")
    results = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
    shutil.rmtree(out, ignore_errors=True)
    log(f"{world} rank processes ran {cases} in {wall:.1f} s (launch to exit)")
    return results, wall


#: The rank processes' cases, in the order each process runs them: phases
#: 34-47 share launches of 2 processes and of 4, so that the later cases
#: run in processes whose first step (library loads, the kernels' first
#: launch) an earlier case has paid.  A tuple of lanes, each a tuple of
#: ``(world, cases)`` launches: the lanes run at the same time, a lane's
#: launches one after the other (a ``{world: cases}`` dict is one lane a
#: world).  Phase 46's checkpoint-now case follows the 4-rank launch: in one
#: 2-rank launch with the others the 2-rank cases took 134.2 s against the
#: 4-rank ones' 61.6, and two 2-rank launches at once beside the 4-rank one
#: slowed all three (137.3, 130.3, 91.8 s: 8 processes on 8 cores; an H100
#: 80GB HBM3 at 700 W, PERF.md).
RANK_CASES = (
    ((2, ("fsdp", "tp", "ulysses", "vit_fsdp", "pp", "pp_moe", "vit_tp", "vit_ulysses",
          "vit_pp", "cnn_tp", "sp_ring", *MESH_CASES, "custom_head_dim", "ddp_replica")),),
    ((4, ("tp_dp", "pp_tp", "ep", "vit_tp_dp", "vit_pp_tp", "vit_ep", "pp_tp_moe",
          "pp_dp_moe", "custom_pp_moe")),
     (2, ("ckpt_now",))),
)


def _lanes(cases=None) -> tuple:
    """RANK_CASES as a tuple of lanes (a ``{world: cases}`` dict: one lane a
    world)."""
    cases = RANK_CASES if cases is None else cases
    if isinstance(cases, dict):
        return tuple(((world, tuple(c)),) for world, c in cases.items())
    return cases


@functools.lru_cache(maxsize=None)
def _rank_cases():
    """Every case of RANK_CASES run once: ``{world: (results by rank, launch
    to exit s)}``, a world's launches merged rank by rank (its wall the
    longest of them).  The lanes run at the same time (6 processes on the
    card): their processes wait on gloo's host copies and their own boots
    far more than on the card, and this process only waits for them."""
    from concurrent.futures import ThreadPoolExecutor

    def lane(launches):
        return [(world, _run_rank_processes(world, list(cases))) for world, cases in launches]

    with ThreadPoolExecutor(len(_lanes())) as pool:
        ran = [done.result() for done in [pool.submit(lane, launches) for launches in _lanes()]]
    out = {}
    for world, (ranks, wall) in (launch for lane_ran in ran for launch in lane_ran):
        if world not in out:
            out[world] = (ranks, wall)
            continue
        merged, longest = out[world]
        for mine, its in zip(merged, ranks):
            mine.update(its)
        out[world] = (merged, max(longest, wall))
    return out


def phase_sharded_strategies():
    """Phases 34-37 (see the module docstring).  Returns the figures by
    case and each case's kernel launches summed over its ranks."""
    from polyaxon_tpu_torch.runtime.optim import AdamW

    (two, wall2), (four, wall4) = _rank_cases()[2], _rank_cases()[4]
    out = {"rank_processes_wall_s": {"2 ranks": wall2, "4 ranks": wall4,
                                     "lanes": [[[w, list(c)] for w, c in lane]
                                               for lane in _lanes()]},
           "backend": "gloo across processes on one card", "card": _card()}
    launches = {}
    for name, ranks in (("fsdp", two), ("tp", two), ("ulysses", two), ("tp_dp", four),
                        ("custom_head_dim", two), ("ddp_replica", two)):
        strategy, axes, options = _case_template(name)
        cfg, batch, seq = _sharded_lm_shape(name)
        _free()
        ts, params, opt_state, whole = _train_setup(cfg, AdamW(LR), batch_size=batch, seq=seq)
        one_bytes = _state_bytes(params, opt_state)
        torch.cuda.synchronize()
        _reset_counts()
        one = []
        for _ in range(STEP_RANKS_STEPS):
            params, opt_state, m = ts.step(params, opt_state, whole)
            one.append((float(m["loss"]), float(m["grad_norm"])))
        one_launches = _counts()
        del ts, params, opt_state, whole
        _free()
        got = [r[name] for r in ranks]
        ok = all(abs(a - b) <= STEP_RANKS_BF16_RTOL * abs(b) for g in got
                 for pair in zip(g["history"], one) for a, b in zip(*pair))
        log(f"{strategy} {axes} on {len(got)} rank processes over gloo (not NCCL), bf16, the "
            f"671M width with {STEP_RANKS_LAYERS} layers, batch {batch} x {seq}, "
            f"{STEP_RANKS_STEPS} steps: (loss, grad_norm) per step "
            + "; ".join(f"rank {i} {g['history']}" for i, g in enumerate(got))
            + f"; one rank on the whole batch {one}")
        for i, g in enumerate(got):
            log(f"  rank {i}: kernels fwd/dq/dkv {g['launches']} (one rank alone: "
                f"{one_launches}); params {g['param_bytes']} B, AdamW {g['adam_bytes']} B "
                f"(one rank: {one_bytes[0]} B, {one_bytes[1]} B); collectives over "
                f"{STEP_RANKS_STEPS} steps, synchronized before and after, host copies "
                f"through gloo: {g['walls']}; case wall {g['wall_s']:.1f} s")
        if not ok:
            raise AssertionError(f"{strategy} across ranks disagrees with one rank's step")
        if not all(c > 0 for g in got for c in g["launches"]):
            raise AssertionError(f"{strategy}: a kernel did not launch on every rank: "
                                 f"{[g['launches'] for g in got]}")
        if strategy == "fsdp" and not all(2 * g["param_bytes"] == one_bytes[0] and
                                          2 * g["adam_bytes"] == one_bytes[1] for g in got):
            raise AssertionError("fsdp {data: 2}: a rank does not hold half of the state")
        # head_dim over tensor stores half of each attention weight on a rank;
        # an axis no rule names replicates the whole state.
        if name == "custom_head_dim" and not all(g["param_bytes"] < one_bytes[0] for g in got):
            raise AssertionError("custom head_dim: a rank holds the whole state")
        if name == "ddp_replica" and not all(g["param_bytes"] == one_bytes[0] for g in got):
            raise AssertionError("ddp on a replica axis: a rank does not hold the whole state")
        key = strategy if name in SHARDED_LM else name
        launches[f"train_step_{key}"] = tuple(sum(g["launches"][i] for g in got)
                                              for i in range(3))
        out[key] = {"axes": axes, "options": options, "ranks": got, "one_rank": one,
                         "one_rank_launches": one_launches, "one_rank_param_bytes": one_bytes[0],
                         "one_rank_adam_bytes": one_bytes[1]}
    _free()
    H = BENCH_MODEL["n_heads"] // SHARDED_LM["ulysses"][1]["sequence"]
    out["ulysses_kernels"] = _long_shape(ULYSSES_BATCH, ULYSSES_SEQ, (0, H - 1), n_heads=H)
    _free()
    vit_ranks = two[0]["vit_fsdp"]
    vit_one = _vit_fsdp_run()
    steps = [s for s, _ in vit_one["losses"]]
    pairs = [(a, b) for (_, a), (_, b) in zip(vit_ranks["losses"], vit_one["losses"])]
    log(f"vit_train (ViT-B/16 widths) under fsdp {{data: 2}} on 2 rank processes, batch "
        f"{VIT_FSDP_BATCH}, {VIT_FSDP_STEPS} steps: losses (2 ranks, one rank) {pairs}; "
        f"{vit_ranks['lines'][-1] if vit_ranks['lines'] else ''}")
    if [s for s, _ in vit_ranks["losses"]] != steps or not steps or not all(
            abs(a - b) <= IMAGE_LOSS_RTOL * abs(b) for a, b in pairs):
        raise AssertionError("vit_train under fsdp disagrees with one rank's")
    if "strategy=fsdp" not in vit_ranks["lines"][-1]:
        raise AssertionError("vit_train's done-line does not name fsdp")
    out["vit_fsdp"] = {"losses": pairs, "wall_s": vit_ranks["wall_s"]}
    return launches, out


def _local_drops(idx, ranks, cfg):
    """Per capacity factor of DROP_FACTORS and per layer, what would drop if
    each of ``ranks`` data ranks routed only its own rows (capacity from its
    own tokens): the counterfactual that global routing replaces."""
    out = []
    for factor in DROP_FACTORS:
        by_layer = []
        for layer in idx:
            total = 0
            for part in np.array_split(np.asarray(layer), ranks):
                onehot = np.eye(cfg.n_experts, dtype=np.int64)[part]
                rank = (onehot.cumsum(0) * onehot).sum(1) - 1
                total += int((rank >= max(1, int(factor * part.size / cfg.n_experts))).sum())
            by_layer.append(total)
        out.append(by_layer)
    return out


def phase_pipeline_and_experts():
    """Phases 38-41 (see the module docstring): the rank processes' cases
    (run with phases 34-37's, ``_rank_cases``), then one rank's steps on the
    whole batch in this process for each case.  Returns each case's kernel
    launches summed over its ranks and the figures."""
    from polyaxon_tpu_torch.runtime.optim import AdamW

    (two, _), (four, _) = _rank_cases()[2], _rank_cases()[4]
    out = {"backend": "gloo across processes on one card; the stage hop through host copies",
           "card": _card()}
    launches = {}
    for name, ranks in (("pp", two), ("pp_moe", two), ("pp_tp", four), ("ep", four),
                        ("custom_pp_moe", four)):
        strategy, axes, options = _case_template(name)
        cfg, batch, seq = _sharded_lm_shape(name)
        _free()
        ts, params, opt_state, whole = _train_setup(cfg, AdamW(LR), batch_size=batch, seq=seq)
        one_bytes = _state_bytes(params, opt_state)
        one_block = _block_bytes(params)
        one_experts = _block_bytes(params, ("wi", "wg", "wd", "router"))
        one_dropped = one_idx = None
        if name == "ep":
            one_dropped, one_idx = _dropped_at_capacity(params, whole["tokens"], cfg)
        torch.cuda.synchronize()
        _reset_counts()
        one = []
        for _ in range(STEP_RANKS_STEPS):
            params, opt_state, m = ts.step(params, opt_state, whole)
            one.append((float(m["loss"]), float(m["grad_norm"])))
        one_launches = _counts()
        del ts, params, opt_state, whole
        _free()
        got = [r[name] for r in ranks]
        rank_idx = next((g.pop("expert_idx") for g in got if "expert_idx" in g), None)
        ok = all(abs(a - b) <= STEP_RANKS_BF16_RTOL * abs(b) for g in got
                 for pair in zip(g["history"], one) for a, b in zip(*pair))
        stages = axes.get("pipeline", 1)
        micro = options.get("num_microbatches", 1) if stages > 1 else 1
        want_launches = STEP_RANKS_STEPS * micro * cfg.n_layers // stages
        log(f"{strategy} {axes} {options} on {len(got)} rank processes over gloo (not NCCL), "
            f"bf16, the 671M width with {STEP_RANKS_LAYERS} layers"
            + (f", {MOE_EXPERTS} experts at capacity factor {MOE_CAPACITY}"
               if cfg.n_experts else "")
            + f", batch {batch} x {seq}, {STEP_RANKS_STEPS} steps: (loss, grad_norm) per step "
            + "; ".join(f"rank {i} {g['history']}" for i, g in enumerate(got))
            + f"; one rank on the whole batch {one}")
        for i, g in enumerate(got):
            log(f"  rank {i}: kernels fwd/dq/dkv {g['launches']} (expected {want_launches} "
                f"each: {STEP_RANKS_STEPS} steps x {micro} microbatches x "
                f"{cfg.n_layers // stages} layers; one rank alone: {one_launches}); params "
                f"{g['param_bytes']} B, AdamW {g['adam_bytes']} B, block {g['block_bytes']} B"
                + (f", experts {g['expert_bytes']} B ({g['experts_held']} of {MOE_EXPERTS} "
                   f"experts)" if cfg.n_experts else "")
                + f" (one rank: {one_bytes[0]} B, {one_bytes[1]} B, block {one_block} B"
                + (f", experts {one_experts} B" if cfg.n_experts else "")
                + f"); collectives and hops over {STEP_RANKS_STEPS} steps, synchronized "
                f"before and after, host copies through gloo: {g['walls']}; case wall "
                f"{g['wall_s']:.1f} s")
        if not ok:
            raise AssertionError(f"{strategy} {axes} across ranks disagrees with one rank's step")
        if not all(c == want_launches for g in got for c in g["launches"]):
            raise AssertionError(f"{strategy} {axes}: kernel launches "
                                 f"{[g['launches'] for g in got]}, expected {want_launches} "
                                 "each on every rank")
        # A stage holds its layers only: 1/S of the block's bytes under pp, less
        # under pp_tp, whose tensor axis splits them again.
        if stages > 1 and not all(g["block_bytes"] * stages == one_block if strategy == "pp"
                                  else g["block_bytes"] * stages < one_block for g in got):
            raise AssertionError(f"{strategy}: a stage does not hold 1/{stages} of the block")
        case = {"axes": axes, "options": options, "ranks": got, "one_rank": one,
                "one_rank_launches": one_launches, "one_rank_param_bytes": one_bytes[0],
                "one_rank_adam_bytes": one_bytes[1], "one_rank_block_bytes": one_block,
                "launches_expected_per_rank": want_launches}
        if name == "ep":
            if not all(g["experts_held"] * 2 == MOE_EXPERTS and
                       g["expert_bytes"] * 4 == one_experts for g in got):
                raise AssertionError("ep {data: 2, expert: 2}: a rank does not hold half of "
                                     "the experts (a quarter of their bytes)")
            differ = [int(np.sum(np.asarray(a) != np.asarray(b)))
                      for a, b in zip(rank_idx, one_idx)]
            local = _local_drops(one_idx, axes["data"], cfg)
            log(f"  ep tokens dropped by layer at the initial weights, at capacity factors "
                f"{DROP_FACTORS} (the model runs at {MOE_CAPACITY}): ranks "
                f"{[g['dropped'] for g in got]}, one rank {one_dropped}, tokens whose expert "
                f"differs {differ}; if each data rank routed only its rows: {local}")
            if not all(abs(a - b) <= d for g in got for ranks_f, one_f in zip(g["dropped"],
                                                                              one_dropped)
                       for a, b, d in zip(ranks_f, one_f, differ)):
                raise AssertionError("ep: the tokens dropped at capacity are not one rank's")
            case.update(one_rank_expert_bytes=one_experts, one_rank_dropped=one_dropped,
                        tokens_whose_expert_differs=differ, dropped_if_routed_locally=local)
        launches[f"train_step_{name}"] = tuple(sum(g["launches"][i] for g in got)
                                               for i in range(3))
        out[name] = case
    return launches, out


@contextlib.contextmanager
def _recorded_steps():
    """The trainers' own train step, recorded while the block runs: yields a
    dict that gets this rank's state bytes at init (``param_bytes``,
    ``adam_bytes``, ``block_bytes`` where the model has a block) and, after
    the block, ``history``: (loss, grad_norm) a step.  Only the trainers'
    ``build_train_step`` is wrapped; the metrics are read after the run, so
    the loop synchronizes no more than it does without the wrapper."""
    from polyaxon_tpu_torch.builtins import trainers

    real = trainers.build_train_step
    seen, metrics = {}, []

    def build(**kw):
        ts = real(**kw)
        init, step = ts.init, ts.step

        def recording_init(generator):
            params, opt_state = init(generator)
            seen["param_bytes"], seen["adam_bytes"] = _state_bytes(params, opt_state)
            seen["block_bytes"] = _block_bytes(params) if "block" in params else None
            return params, opt_state

        def recording_step(params, opt_state, batch):
            params, opt_state, m = step(params, opt_state, batch)
            metrics.append((m["loss"], m["grad_norm"]))
            return params, opt_state, m

        ts.init, ts.step = recording_init, recording_step
        return ts

    trainers.build_train_step = build
    try:
        yield seen
    finally:
        trainers.build_train_step = real
    seen["history"] = [(float(loss), float(norm)) for loss, norm in metrics]


def _image_trainer_run(model, strategy="ddp", axes=None):
    """``vit_train`` (ViT-B/16's widths cut to STEP_RANKS_LAYERS layers, batch
    VIT_FSDP_BATCH, lr VIT_RANK_LR, synthetic images) or ``cnn_train`` (the
    CIFAR shape, batch CNN_BATCH, a make_image_fixture dataset read through
    the trainer's DatasetReader) for STEP_RANKS_STEPS steps, through the entry
    point, under ``strategy`` over the world's ranks on ``axes`` (or on one
    rank): the recorded steps (``_recorded_steps``) and the leader's logged
    [step, loss] pairs."""
    from polyaxon_tpu_torch.builtins.trainers import cnn_train, vit_train
    from polyaxon_tpu_torch.runtime.datasets import make_image_fixture
    from polyaxon_tpu_torch.runtime.mesh import mesh_from_world
    from polyaxon_tpu_torch.tracking.context import Context

    if model == "vit":
        trainer, params = vit_train, dict(VIT_B16, n_layers=STEP_RANKS_LAYERS,
                                          batch=VIT_FSDP_BATCH, lr=VIT_RANK_LR)
    else:
        trainer, params = cnn_train, dict(CNN_MODEL, batch=CNN_BATCH,
                                          dataset="cifar-fixture")
    world = 1 if axes is None else int(np.prod(list(axes.values())))
    rank = torch.distributed.get_rank() if world > 1 else 0
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_cifar_"))
    records = []
    _free()
    try:
        if model == "cnn":
            make_image_fixture(store, "cifar-fixture", num_examples=4 * CNN_BATCH,
                               image_size=CNN_MODEL["image_size"],
                               n_classes=CNN_MODEL["classes"])
        with _recorded_steps() as seen:
            trainer(Context(params=dict(params, steps=STEP_RANKS_STEPS, device="cuda"),
                            seed=SEED, records=records, data_path=str(store),
                            mesh=None if axes is None else mesh_from_world(axes),
                            strategy=strategy, process_id=rank, num_processes=world))
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(store, ignore_errors=True)
    seen["losses"] = [[r["step"], r["values"]["loss"]] for r in records
                      if r["kind"] == "metric" and "loss" in r["values"]]
    return seen


def _sharded_image_rank(name):
    """This rank's run of IMAGE_RANK_CASES[name] through its trainer
    (``_image_trainer_run``), the kernels' counts over it (the image models
    launch none) and the collectives' walls."""
    model, strategy, axes = IMAGE_RANK_CASES[name]
    torch.cuda.synchronize()
    _reset_counts()
    with _timed_collectives() as walls:
        out = _image_trainer_run(model, strategy, axes)
    out["launches"] = _counts()
    out["walls"] = {k: {"calls": len(v), "s": sum(w for w, _ in v),
                        "bytes": sum(b for _, b in v)} for k, v in walls.items()}
    return out


class _CommandEvents:
    """The reporter's two methods the capture agent calls, kept in a list."""

    def __init__(self):
        self.lines = []

    def command_event(self, uuid, state, message=None, **attrs):
        self.lines.append({"uuid": uuid, "state": state, "message": message, **attrs})

    def capture(self, record):
        pass


def _ckpt_now_rank(rank, out_dir):
    """Phase 46 on this rank: ``fsdp {data: 2}`` train steps with the
    trainers' checkpoint-now service (``_checkpoint_now``) on the process's
    capture agent, its copy of one command written into its own mailbox at
    step CKPT_NOW_DROPS[rank] and drained by ``agent.poll()``; every rank
    gathers the whole state again after the save that served it, and the
    leader restores the saved step and compares it bit for bit.  Then the
    cost of the ranks' agreement: ``maybe_save`` with nothing queued (the
    flag's all-reduce on the hosts), on an idle card."""
    from polyaxon_tpu_torch.builtins.trainers import _checkpoint_now
    from polyaxon_tpu_torch.models.transformer import param_axes
    from polyaxon_tpu_torch.parallel.templates import template_for
    from polyaxon_tpu_torch.runtime.checkpoint import CheckpointManager
    from polyaxon_tpu_torch.runtime.mesh import mesh_from_world
    from polyaxon_tpu_torch.runtime.optim import AdamW, tree_leaves
    from polyaxon_tpu_torch.tracking import capture

    rank = int(rank)
    axes = {"data": 2}
    mesh = mesh_from_world(axes)
    cfg, batch, seq = _sharded_lm_shape("fsdp")
    ts, params, opt_state, local = _train_setup(
        cfg, AdamW(LR), batch_size=batch, seq=seq, template=template_for("fsdp", axes),
        mesh=mesh, axes_tree=param_axes(cfg))
    root = Path(out_dir)
    ckpt = CheckpointManager(root / "ckpt-now", save_interval_steps=10**9) if rank == 0 else None
    box = root / "commands" / f"proc{rank}"
    box.mkdir(parents=True, exist_ok=True)
    events = _CommandEvents()
    agent = capture.configure(reporter=events, mailbox=box, process_id=rank)
    service = _checkpoint_now(ckpt, lambda *a: None, agent, ts)

    def flat(state):
        p, o = state
        return [t.detach().cpu() for t in tree_leaves(p) + o.mu + o.nu]

    served, kept = [], None
    for step in range(CKPT_NOW_STEPS):
        params, opt_state, _ = ts.step(params, opt_state, local)
        if step == CKPT_NOW_DROPS[rank]:
            (box / f"{CKPT_NOW_UUID}.json").write_text(
                json.dumps({"kind": "checkpoint-now", "uuid": CKPT_NOW_UUID}))
            agent.poll()
        if service.maybe_save(step, params, opt_state):
            served.append(step)
            whole = ts.full_state(params, opt_state)  # every rank joins the gathers
            if rank == 0:
                kept = (step, flat(whole))
            del whole
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(CKPT_NOW_REPS):
        service.maybe_save(CKPT_NOW_STEPS, params, opt_state)
    idle_ms = (time.perf_counter() - t) / CKPT_NOW_REPS * 1e3
    out = {"served": served, "events": events.lines, "maybe_save_idle_ms": idle_ms}
    if ckpt is not None:
        ckpt.close()
        out["history"] = [h["step"] for h in ckpt.history]
        out["save_bytes"] = [h["bytes"] for h in ckpt.history]
        out["save_block_s"] = ckpt.save_block_s
        manager = CheckpointManager(root / "ckpt-now")
        try:
            restored = manager.restore(*ts.empty_full_state(params, opt_state), step=kept[0])
        finally:
            manager.close()
        got = flat((restored["params"], restored["opt_state"]))
        out["restored_step"] = restored["step"]
        out["restore_equal"] = len(got) == len(kept[1]) and all(
            torch.equal(a, b) for a, b in zip(got, kept[1]))
    capture.configure(reporter=None, mailbox=None)
    del ts, params, opt_state, local
    _free()
    return out


def _worst(got, one):
    """The worst relative difference of any rank's (loss, grad_norm) from
    one rank's, step by step."""
    return max(abs(a - b) / abs(b) for g in got for pair in zip(g["history"], one)
               for a, b in zip(*pair))


def _agrees(label, worst):
    """Raise unless ``worst`` is within STEP_RANKS_BF16_RTOL."""
    if not worst <= STEP_RANKS_BF16_RTOL:
        raise AssertionError(f"{label} across ranks disagrees with one rank's step ({worst})")


def _check_microbatch_routing(name, got, one_routing, axes, cfg):
    """Phase 45's routing check on ``{data: 2, pipeline: 2}``: each rank's
    drops at its layer (``_microbatch_drops``) those of one rank routing each
    global microbatch whole, but for tokens whose expert differs (bf16
    near-ties); beside them what would drop if each data rank routed only
    its rows of each microbatch."""
    figures = {"one_rank_dropped": {}, "tokens_whose_expert_differs": {},
               "dropped_if_routed_locally": {}}
    for g in got:
        layer = g["layer"]
        one_dropped, one_idx = one_routing[layer]
        rank_idx = next(r["expert_idx"] for r in got if r["layer"] == layer and "expert_idx" in r)
        differ = sum(int(np.sum(np.asarray(a) != np.asarray(b)))
                     for a, b in zip(rank_idx, one_idx))
        local = [sum(_local_drops([part], axes["data"], cfg)[f][0] for part in one_idx)
                 for f in range(len(DROP_FACTORS))]
        figures["one_rank_dropped"][layer] = one_dropped
        figures["tokens_whose_expert_differs"][layer] = differ
        figures["dropped_if_routed_locally"][layer] = local
        if not all(abs(a - b) <= differ for a, b in zip(g["dropped"], one_dropped)):
            raise AssertionError(f"{name}: layer {layer}'s tokens dropped at capacity "
                                 f"{g['dropped']} are not one rank's {one_dropped}")
    log(f"  {name} tokens dropped at the initial weights by the layer each rank holds, "
        f"summed over {len(one_routing[0][1])} global microbatches, at capacity factors "
        f"{DROP_FACTORS} (the model runs at {MOE_CAPACITY}): ranks "
        f"{[(g['layer'], g['dropped']) for g in got]}, one rank {figures['one_rank_dropped']}, "
        f"tokens whose expert differs {figures['tokens_whose_expert_differs']}; if each data "
        f"rank routed only its rows of each microbatch: "
        f"{figures['dropped_if_routed_locally']}")
    for g in got:
        g.pop("expert_idx", None)
    return figures


def phase_rest_of_the_parallel_layer():
    """Phases 42-46 (see the module docstring): the rank processes' cases
    (run with phases 34-41's, ``_rank_cases``), then one rank's steps on the
    whole batch in this process.  Returns the kernels' launches summed over
    the ranks of sp_ring and of MoE under pp_tp, and the figures."""
    from polyaxon_tpu_torch.runtime.optim import AdamW

    (two, _), (four, _) = _rank_cases()[2], _rank_cases()[4]
    out = {"backend": "gloo across processes on one card", "card": _card()}
    one_image = {model: _image_trainer_run(model) for model in ("vit", "cnn")}
    _free()
    for name, (model, strategy, axes) in IMAGE_RANK_CASES.items():
        got = [r[name] for r in (two if np.prod(list(axes.values())) == 2 else four)]
        one = one_image[model]
        worst = _worst(got, one["history"])
        log(f"{name}: {model}_train under {strategy} {axes} on {len(got)} rank processes over "
            f"gloo, bf16, " + ("ViT-B/16 widths at 2 layers, batch " + str(VIT_FSDP_BATCH)
                               if model == "vit" else f"the CIFAR shape, batch {CNN_BATCH}, "
                               "a fixture dataset")
            + f", {STEP_RANKS_STEPS} steps: (loss, grad_norm) "
            + "; ".join(f"rank {i} {g['history']}" for i, g in enumerate(got))
            + f"; one rank {one['history']}; worst relative difference {worst:.3g}; the "
            f"leader's logged losses {got[0]['losses']}, one rank's {one['losses']}")
        for i, g in enumerate(got):
            log(f"  rank {i}: params {g['param_bytes']} B, AdamW {g['adam_bytes']} B"
                + (f", block {g['block_bytes']} B" if g["block_bytes"] else "")
                + f" (one rank: {one['param_bytes']} B, {one['adam_bytes']} B"
                + (f", block {one['block_bytes']} B" if one["block_bytes"] else "")
                + f"); kernels {g['launches']}; collectives: {g['walls']}; case wall "
                f"{g['wall_s']:.1f} s")
        _agrees(f"{name} {axes}", worst)
        logged = [loss for _, loss in got[0]["losses"]]
        if logged != [got[0]["history"][s][0] for s, _ in got[0]["losses"]] or not logged:
            raise AssertionError(f"{name}: the leader's logged losses {got[0]['losses']} are "
                                 f"not its steps' {got[0]['history']}")
        if any(c for g in got for c in g["launches"]):
            raise AssertionError(f"{name}: the image model launched a flash kernel")
        out[name] = {"axes": axes, "ranks": got, "one_rank": one["history"],
                     "one_rank_param_bytes": one["param_bytes"],
                     "one_rank_adam_bytes": one["adam_bytes"], "worst_rel_diff": worst}
    launches = {}
    for name, ranks in (("sp_ring", two), ("pp_tp_moe", four), ("pp_dp_moe", four)):
        strategy, axes, options = _case_template(name)
        cfg, batch, seq = _sharded_lm_shape(name)
        _free()
        ts, params, opt_state, whole = _train_setup(cfg, AdamW(LR), batch_size=batch, seq=seq)
        one_bytes = _state_bytes(params, opt_state)
        one_routing = (_microbatch_drops(params, cfg, batch, seq) if name == "pp_dp_moe"
                       else None)
        torch.cuda.synchronize()
        _reset_counts()
        one = []
        for _ in range(STEP_RANKS_STEPS):
            params, opt_state, m = ts.step(params, opt_state, whole)
            one.append((float(m["loss"]), float(m["grad_norm"])))
        one_launches = _counts()
        del ts, params, opt_state, whole
        _free()
        got = [r[name] for r in ranks]
        worst = _worst(got, one)
        stages = axes.get("pipeline", 1)
        micro = options.get("num_microbatches", 1) if stages > 1 else 1
        # The ring launches each kernel once a hop; a stage M times a layer a step.
        want_launches = (STEP_RANKS_STEPS * micro * cfg.n_layers // stages if stages > 1
                         else None)
        log(f"{name}: {strategy} {axes} {options} on {len(got)} rank processes over gloo, "
            f"bf16, the 671M width with {STEP_RANKS_LAYERS} layers"
            + (f", {MOE_EXPERTS} experts, attention_impl flash" if cfg.n_experts else "")
            + f", batch {batch} x {seq}, {STEP_RANKS_STEPS} steps: (loss, grad_norm) "
            + "; ".join(f"rank {i} {g['history']}" for i, g in enumerate(got))
            + f"; one rank {one}; worst relative difference {worst:.3g}")
        for i, g in enumerate(got):
            log(f"  rank {i}: kernels fwd/dq/dkv {g['launches']} (expected "
                f"{want_launches or 'above 0'}; one rank alone: {one_launches}); params "
                f"{g['param_bytes']} B, AdamW {g['adam_bytes']} B (one rank: {one_bytes[0]} B, "
                f"{one_bytes[1]} B); collectives and ring hops: {g['walls']}; case wall "
                f"{g['wall_s']:.1f} s")
        _agrees(f"{strategy} {axes}", worst)
        if not all(c == want_launches if want_launches else c > 0
                   for g in got for c in g["launches"]):
            raise AssertionError(f"{name}: kernel launches {[g['launches'] for g in got]}, "
                                 f"expected {want_launches or 'some'} each on every rank")
        launches[f"train_step_{name}"] = tuple(sum(g["launches"][i] for g in got)
                                               for i in range(3))
        out[name] = {"axes": axes, "options": options, "ranks": got, "one_rank": one,
                     "one_rank_launches": one_launches, "worst_rel_diff": worst,
                     "launches_expected_per_rank": want_launches}
        if one_routing is not None:
            out[name].update(_check_microbatch_routing(name, got, one_routing, axes, cfg))
    ranks = [r["ckpt_now"] for r in two]
    lead = ranks[0]
    at = CKPT_NOW_DROPS[0] + 1  # the ranks read the count posted a step before
    want = [{"uuid": CKPT_NOW_UUID, "state": "acked", "message": None},
            {"uuid": CKPT_NOW_UUID, "state": "complete", "message": None, "step": at}]
    log(f"checkpoint-now under fsdp {{data: 2}} on 2 rank processes over gloo (the 671M width "
        f"with {STEP_RANKS_LAYERS} layers): copies dropped at steps {CKPT_NOW_DROPS}; saves "
        f"{lead['history']} ({lead['save_bytes']} B, {lead['save_block_s']:.2f} s blocked), "
        f"served at {[r['served'] for r in ranks]}, events {[r['events'] for r in ranks]}, "
        f"restored step {lead['restored_step']} equal to full_state: {lead['restore_equal']}; "
        f"maybe_save with nothing queued (the flag's all-reduce on the hosts) "
        f"{[round(r['maybe_save_idle_ms'], 4) for r in ranks]} ms; case wall "
        f"{[round(r['wall_s'], 1) for r in ranks]} s")
    if not (lead["history"] == [at] and lead["restore_equal"]
            and all(r["served"] == [at] and r["events"] == want for r in ranks)):
        raise AssertionError("checkpoint-now across ranks: not one save at one step acked by "
                             "every process, or a restore that differs")
    out["ckpt_now"] = {"ranks": ranks}
    return launches, out


def _moe_routing_on_card_vs_cpu():
    """A small float32 _moe_mlp on the card and on the CPU on the same
    inputs and weights (TF32 off): the same expert wherever the top two
    gates differ by more than MOE_TIE, the output within MOE_OUT_ATOL
    wherever both put a token in the same expert slot."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, _moe_mlp, init_params

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the float32 MoE comparison needs TF32 off")
    cfg = TransformerConfig(dtype=torch.float32, **MOE_SMALL)
    layer = {k: w[0] for k, w in init_params(cfg, torch.Generator().manual_seed(SEED))[
        "block"].items() if k in ("router", "wi", "wg", "wd")}
    x = torch.randn(*MOE_SMALL_TOKENS, cfg.d_model, generator=torch.Generator().manual_seed(33))
    got = {}
    for device in ("cpu", "cuda"):
        with torch.no_grad():
            y, gates, idx = _moe_mlp(x.to(device), _to(layer, device), cfg)
        got[device] = (y.cpu(), gates.cpu().reshape(-1, cfg.n_experts), idx.cpu().reshape(-1))
    (y_cpu, gates_cpu, idx_cpu), (y_card, _, idx_card) = got["cpu"], got["cuda"]
    top2 = gates_cpu.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > MOE_TIE
    capacity = max(1, int(cfg.capacity_factor * idx_cpu.numel() / cfg.n_experts))

    def slots(idx):
        rank = torch.nn.functional.one_hot(idx, cfg.n_experts).cumsum(0).gather(
            1, idx[:, None])[:, 0] - 1
        return torch.where(rank < capacity, idx * capacity + rank, -1)

    same_slot = slots(idx_cpu) == slots(idx_card)
    y_cpu, y_card = y_cpu.reshape(-1, cfg.d_model), y_card.reshape(-1, cfg.d_model)
    out_err = (y_card[same_slot] - y_cpu[same_slot]).abs().max().item()
    figures = {"tokens": idx_cpu.numel(), "near_ties": int((~clear).sum()),
               "expert_mismatches_off_ties": int((idx_card != idx_cpu)[clear].sum()),
               "dropped_cpu": int((slots(idx_cpu) < 0).sum()), "same_slot": int(same_slot.sum()),
               "out_max_abs_err": out_err}
    log(f"_moe_mlp float32 on the card vs the CPU: {figures} (limit {MOE_OUT_ATOL})")
    if figures["expert_mismatches_off_ties"] or not out_err <= MOE_OUT_ATOL or \
            not figures["dropped_cpu"]:
        raise AssertionError("the card's MoE routing or output disagrees with the CPU's")
    return figures


def _moe_remat_grads_on_card():
    """``loss_fn``'s grads of a small bf16 MoE model on the card with remat
    on and with it off (see MOE_REMAT_BATCH): the largest grad difference
    over that grad's norm, and whether every grad is bit for bit equal."""
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params, loss_fn
    from polyaxon_tpu_torch.runtime.optim import tree_leaves

    cfg = TransformerConfig(**dict(MOE_SMALL, n_layers=2, max_seq=MOE_REMAT_SEQ))
    weights = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    tok = torch.as_tensor(np.random.default_rng(SEED + 33).integers(
        0, cfg.vocab_size, (MOE_REMAT_BATCH, MOE_REMAT_SEQ + 1)), device="cuda")
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    grads = {}
    _reset_counts()
    for remat in (False, True):
        params = _to(weights, "cuda")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, batch, cfg.scaled(remat=remat), device="cuda")
        grads[remat] = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    launches = _counts()
    rel = max(((a.float() - b.float()).norm() / b.float().norm()).item()
              for a, b in zip(grads[True], grads[False]))
    figures = {"grads_rel": rel, "bitwise_equal": all(
        torch.equal(a, b) for a, b in zip(grads[True], grads[False])), "launches": launches}
    log(f"small bf16 MoE model, loss_fn grads with remat on vs off on the card: {figures} "
        f"(limit {BF16_BWD_GRAD_RTOL}; fwd launches 2 a layer with remat)")
    if not rel <= BF16_BWD_GRAD_RTOL or launches != (6, 4, 4):
        raise AssertionError("the MoE model's grads with remat differ from those without")
    return figures


def phase_moe_train():
    """lm_train with MOE_EXPERTS experts at bench.py's 671M widths (batch
    MOE_BATCH x 1024, bf16, MOE_STEPS steps, a profiler window on the last):
    the loss falls, each flash kernel launches once a layer a step, and the
    profiled step's trace names each n_layers times.  Then, on the run's
    initial weights and batch: the share of tokens each layer drops at
    capacity, one step under torch.profiler and the MoE MLP's share of its
    device time (n_layers x the MLP's forward and backward, timed alone by
    CUDA events, over the step's device-busy time); the small float32
    _moe_mlp on the card against the CPU; and a small bf16 MoE model's
    grads with remat on and off.  Returns the kernels' launches over the
    run and the figures."""
    from polyaxon_tpu_torch.builtins.trainers import lm_train
    from polyaxon_tpu_torch.models.transformer import (
        TransformerConfig, _moe_mlp, _rmsnorm, forward)
    from polyaxon_tpu_torch.runtime.optim import AdamW
    from polyaxon_tpu_torch.tracking import ledger
    from polyaxon_tpu_torch.tracking.context import Context

    n, seq = BENCH_MODEL["n_layers"], TRAIN_SEQ
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_"))
    records, rows = [], []
    ctx = Context(params=dict(BENCH_MODEL, n_experts=MOE_EXPERTS, seq=seq, batch=MOE_BATCH,
                              steps=MOE_STEPS, lr=LR, device="cuda", profile_start=MOE_STEPS - 1,
                              profile_steps=1),
                  seed=SEED, records=records, outputs_path=str(out_dir))
    _free()
    _fresh_step_walls()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    ledger.configure(sink=rows.append)
    try:
        lm_train(ctx)
    finally:
        ledger.configure(sink=None)
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    (trace,) = (out_dir / "profile").glob("*.pt.trace.json")
    in_trace = kernel_launches_in_trace(trace)
    shutil.rmtree(out_dir, ignore_errors=True)
    metrics = {}
    for r in records:
        if r["kind"] == "metric":
            metrics.setdefault(r["step"], {}).update(r["values"])
        else:
            log(r["line"])
    final = metrics[MOE_STEPS]
    losses = _falls("lm_train with experts", metrics, MOE_STEPS)
    (row,) = [r for r in rows if r["final"]]
    cfg = TransformerConfig(max_seq=seq, n_experts=MOE_EXPERTS, capacity_factor=MOE_CAPACITY,
                            **BENCH_MODEL)
    per_step = tuple(c / MOE_STEPS for c in launches)
    if per_step != (n, n, n) or tuple(in_trace[k] for k in KERNEL_NAMES) != (n, n, n):
        raise AssertionError(f"lm_train with experts: launches {launches} over {MOE_STEPS} "
                             f"steps, the profiled step names {in_trace}; expected {n} each a step")

    _free()
    ts, params, opt_state, batch = _train_setup(cfg, AdamW(LR), batch_size=MOE_BATCH, seq=seq)
    capacity = max(1, int(cfg.capacity_factor * MOE_BATCH * seq / cfg.n_experts))
    with torch.no_grad():
        _, (_, expert_idx) = forward(params, batch["tokens"], cfg, device="cuda")
        flat = expert_idx.reshape(n, -1)
        rank = torch.nn.functional.one_hot(flat, cfg.n_experts).cumsum(1).gather(
            2, flat[..., None])[..., 0] - 1
        dropped = (rank >= capacity).float().mean(dim=1).tolist()
        routed = [torch.bincount(f, minlength=cfg.n_experts).tolist() for f in flat]
    step = _profile(f"lm_train step with {MOE_EXPERTS} experts (batch {MOE_BATCH} x {seq})",
                    lambda: ts.step(params, opt_state, batch), 1, top=12)
    layer = {k: params["block"][k][0].detach().requires_grad_(True)
             for k in ("router", "wi", "wg", "wd")}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    h = _rmsnorm(torch.randn(MOE_BATCH, seq, cfg.d_model, device="cuda", generator=g),
                 params["block"]["mlp_norm"][0].detach()).to(cfg.dtype).requires_grad_(True)
    dy = torch.randn(MOE_BATCH, seq, cfg.d_model, device="cuda", generator=g).to(cfg.dtype)

    def moe_fwd_bwd():
        y, _, _ = _moe_mlp(h, layer, cfg)
        torch.autograd.grad(y, [h, *layer.values()], grad_outputs=dy)

    moe_ms = time_ms(moe_fwd_bwd, reps=10, warmup=2)
    del ts, params, opt_state, batch, layer, h, dy
    _free()
    active = cfg.n_params - (cfg.n_experts - 1) * n * 3 * cfg.d_model * cfg.d_ff
    out = {"loss": losses, "tokens_per_s": final["tokens_per_s"],
           "first_step_s": final["first_step_s"], "step_wall_s_p50": final["step_wall_s_p50"],
           "ledger_mfu_all_experts": row["mfu"],
           "mfu_all_experts_over_loop_wall": _moe_mfu(final["tokens_per_s"], cfg),
           "n_params_all_experts": cfg.n_params, "n_params_active_per_token": active,
           "hbm_peak_bytes": row["hbm_peak_bytes"], "peak_memory_allocated": peak,
           "capacity": capacity, "dropped_share_by_layer_at_init": dropped,
           "tokens_by_expert_at_init": routed, "launches": launches,
           "launches_in_profiled_step": in_trace, "profiled_step": step,
           "moe_mlp_fwd_bwd_ms_per_layer": moe_ms,
           "moe_mlp_share_of_device_time": (n * moe_ms / step["device_busy_ms"]) if step else None,
           "small_f32_card_vs_cpu": _moe_routing_on_card_vs_cpu(),
           "remat_grads_on_card": _moe_remat_grads_on_card(), "card": _card()}
    log(f"lm_train with {MOE_EXPERTS} experts (671M widths, capacity factor {MOE_CAPACITY}, "
        f"batch {MOE_BATCH} x {seq}; MFU counts every expert's params): {out}")
    return launches, out


def _moe_mfu(tokens_per_s, cfg):
    """bench.py's MFU formula on an MoE config: 6N + 12·L·H·hd·T with N
    counting every expert (as the reference's lm_train counts it)."""
    from polyaxon_tpu_torch.tracking.ledger import transformer_flops_per_token

    fpt = transformer_flops_per_token(cfg.n_params, cfg.n_layers, cfg.n_heads, cfg.head_dim,
                                      cfg.max_seq)
    return tokens_per_s * fpt / H100_PEAK_FLOPS[torch.bfloat16]


def _mesh_cfg(dtype: str, layers: int = MESH_LAYERS):
    from polyaxon_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(max_seq=MESH_SEQ, **dict(BENCH_MODEL, n_layers=layers),
                             dtype=getattr(torch, dtype))


def _mesh_prompts(vocab, echo=()):
    """(the static batch's prompts [MESH_BATCH, MESH_PROMPT], the engine's
    first request, its other seven); ``echo``: the tokens the static batch's
    first prompt continued with."""
    rng = np.random.default_rng(MESH_SEED)
    batch = torch.as_tensor(rng.integers(0, vocab, (MESH_BATCH, MESH_PROMPT)))
    prefix = rng.integers(0, vocab, MESH_PREFIX).tolist()

    def tail(n):
        return rng.integers(0, vocab, n).tolist()

    first = prefix + tail(16)
    echoed = list(echo) + list(echo[:len(echo) // 2])
    rest = [prefix + tail(24), prefix + tail(40), echoed] + [tail(n) for n in (64, 96, 160, 200)]
    return batch, first, rest


def _mesh_engine(params, cfg, **kw):
    from polyaxon_tpu_torch.serving import ServingEngine

    return ServingEngine(params, cfg, slots=MESH_SLOTS, max_len=MESH_SEQ, block_size=SERVE_BLOCK,
                         prefill_chunk=SERVE_CHUNK, spec_decode=True, spec_k=SPEC_K, warmup=True,
                         device="cuda", **kw)


def _mesh_engine_traffic(engine, vocab, echo, new=MESH_NEW, others=7):
    """Start ``engine`` and serve phase 47's requests of ``new`` tokens: the
    first, then (once its first token is out, its prefix cached) the first
    ``others`` of the other seven together.  Returns their tokens, its stats
    and latency summaries; stops it."""
    _, first, rest = _mesh_prompts(vocab, echo)
    rest = rest[:others]
    try:
        engine.start()
        if not engine.wait_ready(timeout=600):
            raise AssertionError("phase 47: the engine's warmup did not end")
        head = engine.submit(first, new)
        deadline = time.monotonic() + 300
        while head.first_token_at is None and not head.done.is_set():
            if time.monotonic() > deadline:
                raise AssertionError("phase 47: the first request made no token")
            time.sleep(0.01)
        reqs = [head] + [engine.submit(p, new) for p in rest]
        tokens = [r.wait(timeout=600) for r in reqs]
        ttfts = [r.first_token_at - r.submitted_at for r in reqs]
    finally:
        engine.stop()
    stats = engine.stats()
    lat = engine.latency_summaries()
    keep = ("steady_state_compiles", "kv_pool_bytes", "kv_pool_rank_bytes", "prefix_cache_hits",
            "cow_copies", "spec_steps", "spec_accepted_total", "decode_steps", "mesh")
    return tokens, {**{k: stats[k] for k in keep}, "latency": lat,
                    "ttft_s_p50": statistics.median(ttfts)}


def _gathered_bytes_a_step(params, specs, shard):
    """The weight bytes a rank receives to gather its weights once, as a
    decode step does (``DecodeShard.use`` of each of its layers and of the
    embedding, the final norm and the unembedding): of each dimension split
    over an axis the step does not keep whole-split (the tensor axis, and a
    layer's pipeline axis, are kept), the other ranks' shards, in the dtype
    the step reads it."""
    from polyaxon_tpu_torch.parallel.axes import entry_axes

    sizes = []

    def count(leaf, spec, keep):
        n = 1
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry)
            if dim < len(keep) and keep[dim] is not None and axes[:1] == (keep[dim],):
                axes = axes[1:]
            n *= math.prod(shard.mesh.shape.get(a, 1) for a in axes)
        sizes.append((n - 1) * leaf.numel() * leaf.element_size())

    for name, leaf in params["block"].items():  # the stage's ``layers`` kept
        count(leaf, specs["block"][name][1:], shard.layer_keep(name))
    for name in ("embed", "final_norm", "unembed"):
        count(params[name], specs[name], shard.placement.kept(name))
    return sum(sizes)


#: The phase 47 cases a rank process has run a generate of (the first pays
#: the libraries' loads in an untimed call).
_MESH_WARM: list = []


def _mesh_serving_rank(case="mesh_serving"):
    """This rank's phase 47 case (a rank process of MESH_CASES[case]),
    float32 then bf16: its shards of the seeded weights,
    ``sharded_generate_fn`` on the static batch (once untimed, then timed
    with the kernels' counts set to 0 just before and read just after), its
    decode prefill's last logits (rank 0), and the engine: rank 0 leads
    phase 47's traffic, rank 1 follows."""
    from polyaxon_tpu_torch.models import decode
    from polyaxon_tpu_torch.models.transformer import forward, init_params
    from polyaxon_tpu_torch.parallel.axes import tree_shard
    from polyaxon_tpu_torch.parallel.templates import template_for
    from polyaxon_tpu_torch.runtime.mesh import mesh_from_world
    from polyaxon_tpu_torch.runtime.optim import tree_leaves

    strategy, axes, layers, new, others = MESH_CASES[case]
    mesh = mesh_from_world(axes)
    template = template_for(strategy, axes)
    rank = torch.distributed.get_rank()
    out = {}
    for dt in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        cfg = _mesh_cfg(dt, layers)
        full = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
        whole_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(full))
        whole_block = sum(t.numel() * t.element_size() for t in full["block"].values())
        specs = decode.decode_param_shardings(cfg, mesh, template, params=full)
        params = tree_shard(full, specs, mesh)
        del full
        _free()
        gathered = _gathered_bytes_a_step(decode.cast_weights(params, cfg), specs,
                                          decode.DecodeShard(cfg, mesh, specs))
        batch, _, _ = _mesh_prompts(cfg.vocab_size)
        fn, _ = decode.sharded_generate_fn(cfg, mesh, template, max_new_tokens=new,
                                           param_shardings=specs, device="cuda")
        if not _MESH_WARM:  # the process's first call's library loads, untimed
            fn(params, batch, None, 0.0, None)
            _MESH_WARM.append(case)
        torch.cuda.synchronize()
        _reset_counts()
        t = time.perf_counter()
        tokens = fn(params, batch, None, 0.0, None)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
        gen_launches = _counts()
        with torch.inference_mode():
            logits = forward(params, batch, cfg, template=template, mesh=mesh, specs=specs,
                             return_kv=True, device="cuda")[0][:, -1].float().cpu()
        engine = _mesh_engine(params, cfg, mesh=mesh, param_shardings=specs)
        _reset_counts()
        if engine.is_leader:
            served, stats = _mesh_engine_traffic(engine, cfg.vocab_size, tokens[0].tolist(),
                                                 new, others)
        else:
            engine.follow()
            served, stats = None, {k: engine.stats()[k] for k in (
                "steady_state_compiles", "kv_pool_rank_bytes", "mesh")}
        torch.cuda.synchronize()
        out[dt] = {"generate_tokens": tokens.tolist(), "generate_s": gen_s,
                   "generate_launches": gen_launches, "engine_tokens": served,
                   "engine_launches": _counts(), "engine": stats,
                   "weight_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(params)),
                   "block_bytes": sum(t.numel() * t.element_size()
                                      for t in params["block"].values()),
                   "whole_weight_bytes": whole_bytes, "whole_block_bytes": whole_block,
                   "gathered_bytes_a_step": gathered,
                   "prefill_logits": logits.tolist() if rank == 0 else None,
                   "wall_s": time.perf_counter() - t0}
        del params, engine
        _free()
    return out


def _first_divergence(params, cfg, prompts, one, mesh):
    """Per sequence where ``mesh``'s tokens leave ``one``'s: (its index, the
    first position that differs, one rank's top-2 logit gap there)."""
    from polyaxon_tpu_torch.models.transformer import forward

    out = []
    for i, (prompt, a, b) in enumerate(zip(prompts, one, mesh)):
        pos = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if pos is None:
            continue
        seq = torch.as_tensor([list(prompt) + list(a[:pos])])
        with torch.inference_mode():
            top = forward(params, seq, cfg, device="cuda")[0, -1].float().topk(2).values
        out.append((i, pos, float(top[0] - top[1])))
    return out


@functools.lru_cache(maxsize=None)
def _one_rank_mesh_reference(layers, dt, echo, new, others):
    """One rank's ``generate`` (timed, with its kernel counts) and eager
    engine on a phase 47 case's traffic, for its width, dtype, tokens and
    requests (``echo``: the ranks' first continuation, which one request
    repeats)."""
    from polyaxon_tpu_torch.models import decode
    from polyaxon_tpu_torch.models.transformer import forward, init_params

    cfg = _mesh_cfg(dt, layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    batch, _, _ = _mesh_prompts(cfg.vocab_size, echo)
    decode.generate(params, batch, cfg, max_new_tokens=new, device="cuda")
    torch.cuda.synchronize()
    _reset_counts()
    t = time.perf_counter()
    tokens = decode.generate(params, batch, cfg, max_new_tokens=new, device="cuda")
    torch.cuda.synchronize()
    gen_s, launches = time.perf_counter() - t, _counts()
    with torch.inference_mode():
        logits = forward(params, batch, cfg, device="cuda")[:, -1].float().cpu()
    served, stats = _mesh_engine_traffic(_mesh_engine(params, cfg, _eager=True),
                                         cfg.vocab_size, list(echo), new, others)
    del params
    _free()
    return {"tokens": tokens.tolist(), "generate_s": gen_s, "launches": launches,
            "logits": logits, "engine_tokens": served, "engine": stats}


def phase_mesh_serving():
    """Phase 47 (see the module docstring): each case's rank processes' runs
    (with phases 34-46's, ``_rank_cases``) against one rank's ``generate``
    and engine in this process.  Returns, by case, the flash forward's
    launches summed over the ranks' generates and engines, and the
    figures."""
    from polyaxon_tpu_torch.models.transformer import init_params

    (two, wall) = _rank_cases()[2]
    out = {"backend": "gloo across 2 processes on one card: the engine and the decode step "
           "eager where they call a collective (gloo's run on the host)",
           "card": _card(), "bf16_gap_bound": MESH_BF16_GAP, "rank_cases_wall_s": wall}
    launches = {}
    for case, (strategy, axes, layers, new, others) in MESH_CASES.items():
        got = [r[case] for r in two]
        stages = axes.get("pipeline", 1)
        pool_share = 1.0 if strategy == "fsdp" else 0.5
        res = {"strategy": strategy, "axes": axes, "layers": layers, "new_tokens": new,
               "requests": 1 + others,
               "case_wall_s_a_rank": [g["wall_s"] for g in got]}
        fwd_launches = 0
        for dt in ("float32", "bfloat16"):
            cfg = _mesh_cfg(dt, layers)
            echo = tuple(got[0][dt]["generate_tokens"][0])
            one = _one_rank_mesh_reference(layers, dt, echo, new, others)
            batch, first, rest = _mesh_prompts(cfg.vocab_size, echo)
            one_stats = one["engine"]
            mesh_logits = torch.tensor(got[0][dt]["prefill_logits"])
            cos = torch.nn.functional.cosine_similarity(mesh_logits, one["logits"], dim=-1)
            fig = {"wall_s_a_rank": [g[dt]["wall_s"] for g in got],
                   "generate_one_rank_s": one["generate_s"],
                   "generate_ranks_s": [g[dt]["generate_s"] for g in got],
                   "flash_fwd_launches_a_rank_generate": [g[dt]["generate_launches"][0]
                                                          for g in got],
                   "flash_fwd_launches_a_rank_engine": [g[dt]["engine_launches"][0] for g in got],
                   "one_rank_generate_launches": one["launches"],
                   "weight_bytes_a_rank": [g[dt]["weight_bytes"] for g in got],
                   "one_rank_weight_bytes": got[0][dt]["whole_weight_bytes"],
                   "block_bytes_a_rank": [g[dt]["block_bytes"] for g in got],
                   "one_rank_block_bytes": got[0][dt]["whole_block_bytes"],
                   "gathered_bytes_a_decode_step": [g[dt]["gathered_bytes_a_step"] for g in got],
                   "prefill_logits_cosine_min": float(cos.min()),
                   "prefill_logits_max_abs_diff": float((mesh_logits - one["logits"]).abs().max()),
                   "engine_leader": got[0][dt]["engine"], "engine_follower": got[1][dt]["engine"],
                   "engine_one_rank": one_stats}
            prompts_gen = batch.tolist()
            prompts_eng = [first] + rest[:others]
            one_tok, eng_tok, one_served = one["tokens"], got[0][dt]["engine_tokens"], one[
                "engine_tokens"]
            for g in got:
                if g[dt]["generate_tokens"] != got[0][dt]["generate_tokens"]:
                    raise AssertionError(f"phase 47 {case} {dt}: the ranks' generates differ")
            mesh_gen = got[0][dt]["generate_tokens"]
            if dt == "float32":
                fig["generate_tokens_equal"] = mesh_gen == one_tok
                fig["engine_tokens_equal"] = eng_tok == one_served
                fig["spec_equal"] = all(fig["engine_leader"][k] == one_stats[k]
                                        for k in ("spec_steps", "spec_accepted_total"))
                if not (fig["generate_tokens_equal"] and fig["engine_tokens_equal"]
                        and fig["spec_equal"]):
                    raise AssertionError(
                        f"phase 47 {case} float32: the sharded tokens differ from one rank's "
                        f"(generate {fig['generate_tokens_equal']}, engine "
                        f"{fig['engine_tokens_equal']}, speculation {fig['spec_equal']})")
            else:
                params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
                fig["generate_divergence"] = _first_divergence(params, cfg, prompts_gen,
                                                               one_tok, mesh_gen)
                fig["engine_divergence"] = _first_divergence(params, cfg, prompts_eng,
                                                             one_served, eng_tok)
                del params
                _free()
                far = [d for d in fig["generate_divergence"] + fig["engine_divergence"]
                       if not d[2] <= MESH_BF16_GAP]
                if far:
                    raise AssertionError(f"phase 47 {case} bf16: sharded tokens leave one rank's "
                                         f"where its top-2 gap exceeds {MESH_BF16_GAP}: {far}")
            if not fig["prefill_logits_cosine_min"] >= MESH_LOGITS_COS:
                raise AssertionError(f"phase 47 {case} {dt}: prefill logits cosine "
                                     f"{fig['prefill_logits_cosine_min']} < {MESH_LOGITS_COS}")
            if fig["flash_fwd_launches_a_rank_generate"] != [layers // stages] * 2:
                raise AssertionError(f"phase 47 {case} {dt}: flash forward launches a rank a "
                                     f"generate {fig['flash_fwd_launches_a_rank_generate']}, "
                                     f"want {layers // stages}")
            if any(fig["flash_fwd_launches_a_rank_engine"]) or any(
                    c for g in got for c in g[dt]["engine_launches"]):
                raise AssertionError(f"phase 47 {case} {dt}: the engine launched a flash kernel")
            ratios = [b / fig["one_rank_weight_bytes"] for b in fig["weight_bytes_a_rank"]]
            block = [b / fig["one_rank_block_bytes"] for b in fig["block_bytes_a_rank"]]
            pools = [fig[role]["kv_pool_rank_bytes"] / one_stats["kv_pool_rank_bytes"]
                     for role in ("engine_leader", "engine_follower")]
            fig.update(weight_bytes_ratio=ratios, block_bytes_ratio=block,
                       kv_pool_rank_bytes_ratio=pools)
            if strategy == "pp":  # its stage's layers; the embedding and unembedding whole
                if block != [0.5, 0.5]:
                    raise AssertionError(f"phase 47 {case} {dt}: a stage holds {block} of the "
                                         "block's weights, not half")
            elif not all(0.49 <= r <= 0.51 for r in ratios):
                raise AssertionError(f"phase 47 {case} {dt}: a rank holds {ratios} of the "
                                     "weights, not half")
            if pools != [pool_share] * 2:
                raise AssertionError(f"phase 47 {case} {dt}: a rank's KV pool is {pools} of one "
                                     f"rank's, not {pool_share}")
            for role in ("engine_leader", "engine_follower"):
                if fig[role]["steady_state_compiles"]:
                    raise AssertionError(f"phase 47 {case} {dt}: {role} built a step after ready")
            if fig["engine_leader"]["prefix_cache_hits"] < 2:
                raise AssertionError(f"phase 47 {case} {dt}: the traffic missed the prefix "
                                     f"cache ({fig['engine_leader']})")
            fwd_launches += sum(fig["flash_fwd_launches_a_rank_generate"])
            fwd_launches += sum(fig["flash_fwd_launches_a_rank_engine"])
            lat = fig["engine_leader"]["latency"]
            log(f"phase 47 {case} {dt}: {strategy} {axes} over 2 rank processes (gloo), the "
                f"671M width at {layers} layers, {new} tokens, {1 + others} requests, "
                f"{fig['wall_s_a_rank']} s a rank: generate "
                f"{fig['generate_ranks_s']} s on the ranks, {one['generate_s']:.3f} s on one "
                f"rank; flash fwd a rank {fig['flash_fwd_launches_a_rank_generate']} "
                f"(generate), {fig['flash_fwd_launches_a_rank_engine']} (engine); weights a "
                f"rank {ratios}, the block's {block}, KV pool {pools}; gathered a decode step "
                f"{fig['gathered_bytes_a_decode_step']} B; prefill logits cosine "
                f"{fig['prefill_logits_cosine_min']:.6f}, max |d| "
                f"{fig['prefill_logits_max_abs_diff']:.3g}; engine decode_step_s p50 "
                f"{lat.get('decode_step_s', {}).get('p50')}, ttft p50 "
                f"{fig['engine_leader']['ttft_s_p50']:.4f} s, descriptor ms p50 "
                f"{1e3 * lat.get('mesh_descriptor_s', {}).get('p50', float('nan')):.3f}; one "
                f"rank's engine (eager) decode_step_s p50 "
                f"{one_stats['latency'].get('decode_step_s', {}).get('p50')}"
                + ("" if dt == "float32" else f"; divergences (seq, pos, one rank's top-2 "
                   f"gap): generate {fig['generate_divergence']}, engine "
                   f"{fig['engine_divergence']}"))
            res[dt] = fig
        out[case] = res
        launches[case] = (fwd_launches, 0, 0)
    _one_rank_mesh_reference.cache_clear()
    _free()
    return launches, out


# -- the services, the ssh transport, the state and the bus (phases 48-50) ---------

# Phase 48: the non-model services as gangs of the port's worker on the card's
# host.  The stub jupyter server answers 200 to a path that ends in its token.
JUPYTER_STUB = """#!{python}
import http.server, sys
args = dict(a.split("=", 1) for a in sys.argv[1:] if a.startswith("--ServerApp."))
token = args["--ServerApp.token"]
class Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        ok = self.path.endswith("?token=" + token)
        body = b"jupyter stub" if ok else b"forbidden"
        self.send_response(200 if ok else 403)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
    def log_message(self, *args):
        pass
http.server.ThreadingHTTPServer((args["--ServerApp.ip"], int(args["--ServerApp.port"])),
                                Handler).serve_forever()
"""
SERVICE_BOOT_S = 180
# Phase 49: lm_train at the 671M width and depth (bench.py's configuration),
# batch 4 x 1024, 3 steps (a profiler window on the last), as a gang built by
# spawner_from_conf with spawner.backend=ssh over a stub ssh, and as the same
# gang launched by LocalGangSpawner: the final losses within SSH_LOSS_RTOL
# (bf16 compute; the two runs differ only in how their process was started).
SSH_BATCH, SSH_STEPS, SSH_LOSS_RTOL = 4, 3, 1e-2
SSH_STUB = '#!/bin/sh\nfor last; do :; done\nexec sh -c "$last"\n'
# Phase 50: metrics two processes write to one WAL registry at once.
WAL_ROWS_PER_WRITER = 2000


def ignore_term_until_killed(ctx) -> None:
    """A gang entrypoint (phase 49's endless gang): SIGTERM is ignored, so only
    a SIGKILL ends it."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    ctx.log_text("endless: ignoring SIGTERM")
    while True:
        time.sleep(0.1)


@contextlib.contextmanager
def _environ(**overrides):
    """``os.environ`` with ``overrides`` for the block, then as it was."""
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _service_gang(spawner, kind, declarations, run_id, entry=None):
    """A service gang on the card as the control plane dispatches one: the port
    from ``allocate_service_port`` in the plan and in POLYAXON_TPU_SERVICE_PORT."""
    import dataclasses

    from polyaxon_tpu_torch.compiler import compile_gang_plan
    from polyaxon_tpu_torch.spawner.local import LocalRun

    spec = {"kind": kind, "declarations": dict(declarations, host="127.0.0.1"),
            "environment": {"seed": SEED, "topology": dict(GANG_TOPOLOGY)}}
    if entry:
        spec["run"] = {"entrypoint": f"polyaxon_tpu_torch.builtins.services:{entry}"}
    run = LocalRun(spec, id=run_id)
    plan = compile_gang_plan(spec)
    port = spawner.allocate_service_port(run)
    plan = dataclasses.replace(plan, service_port=port, env_vars={
        **plan.env_vars, "POLYAXON_TPU_SERVICE_PORT": str(port)})
    return _start_gang(spawner, run, plan), port


def _first_answer(handle, url, t0):
    """(status, body, seconds from launch) of the first answer at ``url``."""
    while True:
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                return resp.status, resp.read(), time.time() - t0
        except (urllib.error.URLError, ConnectionError, OSError):
            if handle.processes[0].poll() is not None or time.time() - t0 > SERVICE_BOOT_S:
                raise AssertionError(f"no answer at {url}:\n{_gang_log_tail(handle)}")
            time.sleep(0.05)


def phase_services():
    """Phase 48: ``output_server`` serves phase 28's run outputs (its profiler
    trace fetched and compared byte for byte), ``kind: notebook`` with no run
    section runs ``jupyter`` with a stub ``jupyter_bin`` (the reported service
    URL carries ``?token=`` and the stub answers it), and ``kind:
    tensorboard`` with no run section where tensorboard is installed; each as a
    gang of the port's worker from LocalGangSpawner, each one's launch to its
    first answer timed, then stopped."""
    import importlib.util

    from polyaxon_tpu_torch.spawner.local import LocalGangSpawner
    from polyaxon_tpu_torch.stores.layout import StoreLayout

    base, target = _GANG_RUN["base"], _GANG_RUN["uuid"]
    served_file = StoreLayout(base).run_paths(target).outputs / _GANG_RUN["file"]
    stub = base / "jupyter-stub"
    stub.write_text(JUPYTER_STUB.format(python=sys.executable))
    stub.chmod(0o755)
    spawner = LocalGangSpawner(StoreLayout(base), heartbeat_interval=1.0)
    tensorboard = importlib.util.find_spec("tensorboard") is not None
    t0 = time.time()
    gangs = {"output_server": _service_gang(spawner, "service", {"target": target}, 481,
                                            "output_server"),
             "notebook": _service_gang(spawner, "notebook", {"jupyter_bin": str(stub)}, 482)}
    if tensorboard:
        gangs["tensorboard"] = _service_gang(spawner, "tensorboard", {"target": target}, 483)
    out = {}
    try:
        handle, port = gangs["output_server"]
        url = f"http://{spawner.host_for(0)}:{port}"
        status, listing, first_s = _first_answer(handle, url + "/", t0)
        rel = str(_GANG_RUN["file"])
        with urllib.request.urlopen(f"{url}/{rel}", timeout=30) as resp:
            fetched = resp.read()
        if status != 200 or rel.split("/")[0].encode() not in listing:
            raise AssertionError(f"output_server's listing: {status} {listing[:400]!r}")
        if fetched != served_file.read_bytes():
            raise AssertionError(f"output_server served {len(fetched)} bytes of {rel}, not the "
                                 f"{served_file.stat().st_size} bytes on disk")
        out["output_server"] = {"launch_to_first_answer_s": first_s, "file": rel,
                                "bytes": len(fetched)}

        handle, port = gangs["notebook"]
        reported = _await_line(handle, lambda e: e["type"] == "service", "the notebook's token",
                               SERVICE_BOOT_S)
        service_url = f"http://{spawner.host_for(0)}:{port}/?{reported['query']}"
        if "?token=" not in service_url:
            raise AssertionError(f"the notebook's service URL carries no token: {service_url}")
        status, body, first_s = _first_answer(handle, service_url, t0)
        if (status, body) != (200, b"jupyter stub"):
            raise AssertionError(f"the notebook's stub answered {status} {body!r}")
        out["notebook"] = {"launch_to_first_answer_s": first_s,
                           "service_url": service_url.split("?token=")[0] + "?token=..."}

        if tensorboard:
            handle, port = gangs["tensorboard"]
            status, body, first_s = _first_answer(
                handle, f"http://{spawner.host_for(0)}:{port}/", t0)
            if status != 200:
                raise AssertionError(f"tensorboard answered {status}")
            out["tensorboard"] = {"launch_to_first_answer_s": first_s}
        else:
            out["tensorboard"] = "not installed on this host"
            log("tensorboard: not installed on this host")
        for name, (handle, _) in gangs.items():
            spawner.stop(handle, grace=5.0)
            if handle.processes[0].poll() is None:
                raise AssertionError(f"the {name} gang outlived its stop")
    finally:
        for handle, _ in gangs.values():
            spawner.stop(handle, grace=1.0)
    shutil.rmtree(base, ignore_errors=True)
    log("services as gangs on the card's host: " + "; ".join(
        f"{k} {v['launch_to_first_answer_s']:.2f} s launch to first answer"
        if isinstance(v, dict) else f"{k}: {v}" for k, v in out.items())
        + f"; output_server served {out['output_server']['bytes']} bytes of "
          f"{out['output_server']['file']} equal to the file")
    return out


def phase_ssh_gang():
    """Phase 49: ``spawner_from_conf`` builds the spawner from the port's
    ``ConfService`` (``spawner.backend=ssh``, ``spawner.hosts=127.0.0.1``), a
    stub ``ssh`` on PATH runs the remote script on this host, and the gang runs
    ``lm_train`` at the 671M width and depth on the card; beside it the same
    gang from LocalGangSpawner.  The ssh gang's rc comes back through its rc
    file, its report over the shared run dir; its final loss is the local
    gang's within SSH_LOSS_RTOL, its profiled step names each kernel once a
    layer.  Then an endless gang (SIGTERM ignored) over ssh: a TERM through its
    ``_RemoteProcessRef`` leaves it running, the spawner's ``reattach``
    rebuilds the ref from the rc file path, and a KILL through that ref ends it
    with rc 137 in the rc file.  Returns the kernels' launches in the profiled
    step, the figures, and what phase 50 reads."""
    from polyaxon_tpu_torch.compiler import compile_gang_plan
    from polyaxon_tpu_torch.conf.service import ConfService
    from polyaxon_tpu_torch.spawner.local import LocalGangSpawner, LocalRun
    from polyaxon_tpu_torch.spawner.remote import RemoteGangSpawner, spawner_from_conf
    from polyaxon_tpu_torch.spawner.transport import SSHTransport
    from polyaxon_tpu_torch.stores.layout import StoreLayout

    base = Path(tempfile.mkdtemp(prefix="chip_smoke_ssh_"))
    (base / "bin").mkdir()
    (base / "bin" / "ssh").write_text(SSH_STUB)
    (base / "bin" / "ssh").chmod(0o755)
    spec = _gang_spec("experiment", "lm_train", dict(
        BENCH_MODEL, seq=TRAIN_SEQ, batch=SSH_BATCH, steps=SSH_STEPS, lr=LR,
        profile_start=SSH_STEPS - 1, profile_steps=1))
    plan = compile_gang_plan(spec)
    with _environ(PATH=f"{base / 'bin'}{os.pathsep}{os.environ['PATH']}",
                  POLYAXON_TPU_SPAWNER_BACKEND="ssh", POLYAXON_TPU_SPAWNER_HOSTS="127.0.0.1",
                  POLYAXON_TPU_SPAWNER_REMOTE_PYTHON=sys.executable):
        ssh = spawner_from_conf(StoreLayout(base / "ssh"), ConfService(), heartbeat_interval=1.0)
        if not (isinstance(ssh, RemoteGangSpawner) and isinstance(ssh.transport, SSHTransport)
                and ssh.hosts == ["127.0.0.1"]):
            raise AssertionError(f"spawner_from_conf built {ssh!r} over {ssh.transport!r}")
        local = LocalGangSpawner(StoreLayout(base / "local"), heartbeat_interval=1.0)
        # The endless gang boots beside the two lm_train gangs.
        endless_spec = {"kind": "job", "run": {"entrypoint": "chip_smoke:ignore_term_until_killed"},
                        "environment": {"seed": SEED, "topology": dict(GANG_TOPOLOGY)}}
        endless_run, endless_plan = LocalRun(endless_spec, id=493), compile_gang_plan(endless_spec)
        _free()
        t0 = time.time()
        handles = {"ssh": _start_gang(ssh, LocalRun(spec, id=491), plan),
                   "local": _start_gang(local, LocalRun(spec, id=492), plan)}
        handle = _start_gang(ssh, endless_run, endless_plan)
        try:
            running = {k: _await_line(h, lambda e: e["type"] == "status" and
                                      e["status"] == "running", f"the {k} gang's running", 300)
                       for k, h in handles.items()}
            deadline = time.time() + 600
            while not all(h.all_exited for h in handles.values()):
                if time.time() > deadline:
                    raise AssertionError(f"the lm_train gangs did not exit: "
                                         f"{ {k: h.poll() for k, h in handles.items()} }")
                time.sleep(0.1)
            wall_s = time.time() - t0
        finally:
            for name, h in handles.items():
                (ssh if name == "ssh" else local).stop(h, grace=5.0)
        rcs = {k: h.processes[0].poll() for k, h in handles.items()}
        rc_file = handles["ssh"].paths.log_file(0).with_suffix(".rc").read_text().strip()
        lines = {k: _gang_lines(h) for k, h in handles.items()}
        statuses = [e["status"] for e in lines["ssh"] if e["type"] == "status"]
        if rcs != {"ssh": 0, "local": 0} or rc_file != "0" or statuses != [
                "starting", "running", "succeeded"]:
            raise AssertionError(f"the lm_train gangs: rc {rcs}, rc file {rc_file!r}, statuses "
                                 f"{statuses}:\n{_gang_log_tail(handles['ssh'])}")
        loss = {k: {e["step"]: e["values"]["loss"] for e in v
                    if e["type"] == "metric" and "loss" in e["values"]}[SSH_STEPS - 1]
                for k, v in lines.items()}
        rel = abs(loss["ssh"] - loss["local"]) / abs(loss["local"])
        (trace,) = (handles["ssh"].paths.outputs / "profile").glob("*.pt.trace.json")
        in_trace = kernel_launches_in_trace(trace)
        launches = tuple(in_trace[k] for k in KERNEL_NAMES)

        try:
            _await_line(handle, lambda e: e["type"] == "log" and "ignoring SIGTERM" in e["line"],
                        "the endless gang's start", 300)
            ref = handle.processes[0]
            ref.signal(signal.SIGTERM)
            after_term = ref.wait(2.0)
            again = ssh.reattach(endless_run, endless_plan, [{"process_id": 0, "pid": ref.pid}])
            again_ref = again.processes[0]
            before_kill = again_ref.poll()
            t1 = time.time()
            again_ref.signal(signal.SIGKILL)
            killed_rc = again_ref.wait(30.0)
            kill_s = time.time() - t1
        finally:
            ssh.stop(handle, grace=1.0)
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.killpg(handle.processes[0].pid, signal.SIGKILL)
        endless_rc_file = handle.paths.log_file(0).with_suffix(".rc").read_text().strip()
        if (after_term, before_kill, killed_rc, endless_rc_file, ref.poll()) != (
                None, None, 137, "137", 137):
            raise AssertionError(
                f"the endless gang: after TERM {after_term}, reattached {before_kill}, after KILL "
                f"{killed_rc}, rc file {endless_rc_file!r}, first ref {ref.poll()}:\n"
                f"{_gang_log_tail(handle)}")
    out = {"rc": rcs, "rc_file": rc_file, "wall_s": wall_s,
           "launch_to_running_s": {k: running[k]["ts"] - t0 for k in running},
           "final_loss": loss, "loss_rel_diff": rel, "launches_in_profiled_step": in_trace,
           "endless": {"after_term": after_term, "after_kill": killed_rc,
                       "rc_file": endless_rc_file, "kill_to_rc_s": kill_s}}
    log(f"lm_train gangs (671M, batch {SSH_BATCH} x {TRAIN_SEQ}, {SSH_STEPS} steps): over ssh rc "
        f"{rcs['ssh']} (rc file {rc_file!r}), local rc {rcs['local']}; launch to running "
        + ", ".join(f"{k} {v:.2f} s" for k, v in out["launch_to_running_s"].items())
        + f"; final loss ssh {loss['ssh']} local {loss['local']} (relative {rel:.3g}); "
          f"kernels in the ssh gang's profiled step {in_trace}; the endless gang after TERM "
          f"{after_term}, reattached {before_kill}, KILL -> rc {killed_rc} (rc file "
          f"{endless_rc_file!r}) in {kill_s:.2f} s")
    n = BENCH_MODEL["n_layers"]
    if rel > SSH_LOSS_RTOL or launches != (n, n, n):
        raise AssertionError(f"the ssh gang's loss {loss} (relative {rel}) or its kernels "
                             f"{in_trace}, expected {n} each")
    return launches, out, {"base": base, "spec": spec, "lines": lines["ssh"]}


# Phase 50's writer process: the repository root, the database, the writer's
# number and its row count in argv.  It imports the registry alone (no torch),
# says ``ready``, waits for a line on stdin (so that the writers start
# together), writes its metrics of run 1 and prints the wall clock's first and
# last second of them.
WAL_WRITER = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
from polyaxon_tpu_torch.db.registry import RunRegistry
reg = RunRegistry(sys.argv[2])
worker, n = float(sys.argv[3]), int(sys.argv[4])
print("ready", flush=True)
sys.stdin.readline()
t0 = time.time()
for i in range(n):
    reg.add_metric(1, {"loss": float(i), "worker": worker}, step=i)
print(json.dumps({"t0": t0, "t1": time.time()}))
reg.close()
"""


def phase_state_and_bus(ssh_run):
    """Phase 50: a port ``RunRegistry`` in the phase's directory records phase
    49's ssh gang, its run row and its statuses from ``created`` to
    ``succeeded`` read off the gang's report lines (each write gated by the
    lifecycle; a write after ``succeeded`` refused), and its metrics; an
    ``Auditor`` on the registry records the run's events, and
    ``ExecutorHandlers`` on a ``TaskBus`` turn them into the scheduler's tasks
    (``experiment_done`` into a stop with cleanup); two processes write
    metrics to the one WAL database at once and every row is read back."""
    from polyaxon_tpu_torch.auditor import Auditor
    from polyaxon_tpu_torch.db.registry import RunRegistry
    from polyaxon_tpu_torch.events import EventTypes
    from polyaxon_tpu_torch.executor import ExecutorHandlers
    from polyaxon_tpu_torch.workers import HPTasks, PipelineTasks, SchedulerTasks, TaskBus

    base = Path(tempfile.mkdtemp(prefix="chip_smoke_state_"))
    reg = RunRegistry(base / "registry.db")
    try:
        bus, calls = TaskBus(), []
        for cls in (SchedulerTasks, HPTasks, PipelineTasks):
            for name in (v for k, v in vars(cls).items() if k.isupper()):
                bus.register(name, lambda name=name, **kw: calls.append((name, kw)))
        auditor = Auditor(reg)
        auditor.subscribe(ExecutorHandlers(bus))
        t0 = time.perf_counter()
        run = reg.create_run(ssh_run["spec"], name="lm_train over ssh")
        auditor.record(EventTypes.EXPERIMENT_CREATED, run_id=run.id)
        written = []
        for e in ssh_run["lines"]:
            if e["type"] == "status":
                written.append((e["status"], reg.set_status(run.id, e["status"], e.get("message"))))
                auditor.record(EventTypes.EXPERIMENT_NEW_STATUS, run_id=run.id, status=e["status"])
            elif e["type"] == "metric":
                reg.add_metric(run.id, e["values"], step=e["step"])
        refused = reg.set_status(run.id, "running")
        if reg.get_run(run.id).is_done:
            auditor.record(EventTypes.EXPERIMENT_DONE, run_id=run.id)
        tasks = bus.pump()
        record_s = time.perf_counter() - t0
        statuses = [s["status"] for s in reg.get_statuses(run.id)]
        activity = [a["event_type"] for a in reversed(reg.get_activities())]
        last = reg.last_metric(run.id)
        if (statuses != ["created", "starting", "running", "succeeded"] or refused
                or not all(ok for _, ok in written) or "loss" not in last):
            raise AssertionError(f"the registry's run: statuses {statuses}, writes {written}, "
                                 f"refused {refused}, last metric {last}")
        want = [(SchedulerTasks.EXPERIMENTS_BUILD, {"run_id": run.id}),
                (SchedulerTasks.EXPERIMENTS_STOP, {"run_id": run.id, "cleanup": True})]
        if calls != want or activity[0] != EventTypes.EXPERIMENT_CREATED or activity[-1] != (
                EventTypes.EXPERIMENT_DONE):
            raise AssertionError(f"the bus ran {calls}; the auditor recorded {activity}")

        wal = RunRegistry(base / "wal.db")
        wal.create_run(ssh_run["spec"])
        root = str(Path(__file__).resolve().parent)
        writers = [subprocess.Popen([sys.executable, "-c", WAL_WRITER, root, str(base / "wal.db"),
                                     str(w), str(WAL_ROWS_PER_WRITER)],
                                    stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
                   for w in (0, 1)]
        for p in writers:  # both have loaded the port and opened the database
            if p.stdout.readline().strip() != "ready":
                raise AssertionError(f"a WAL writer did not start (rc {p.wait(60)})")
        for p in writers:
            p.stdin.write("go\n")
            p.stdin.flush()
        spans = [json.loads(p.communicate(timeout=300)[0].strip().splitlines()[-1])
                 for p in writers]
        rcs = [p.returncode for p in writers]
        rows = wal.get_metrics(1)
        wal.close()
        got = sorted((m["values"]["worker"], m["step"]) for m in rows)
        overlap_s = min(x["t1"] for x in spans) - max(x["t0"] for x in spans)
        wal_s = max(x["t1"] for x in spans) - min(x["t0"] for x in spans)
        if rcs != [0, 0] or overlap_s <= 0 or got != [(float(w), i) for w in (0, 1)
                                                      for i in range(WAL_ROWS_PER_WRITER)]:
            raise AssertionError(f"the WAL writers: rc {rcs}, overlap {overlap_s} s, "
                                 f"{len(rows)} rows read back")
    finally:
        reg.close()
        shutil.rmtree(base, ignore_errors=True)
        shutil.rmtree(ssh_run["base"], ignore_errors=True)
    out = {"statuses": statuses, "activity": activity, "tasks": [c[0] for c in calls],
           "record_s": record_s, "wal_rows": len(rows), "wal_s": wal_s, "overlap_s": overlap_s,
           "wal_rows_per_s": len(rows) / wal_s}
    log(f"state and bus: the ssh gang's run recorded {statuses} ({len(written)} status writes "
        f"gated, a write after succeeded refused), {len(activity)} audited events, {tasks} "
        f"tasks dispatched {out['tasks']}, in {record_s * 1e3:.1f} ms; 2 processes wrote "
        f"{len(rows)} metric rows to one WAL database in {wal_s:.3f} s ({overlap_s:.3f} s of "
        f"it together), {out['wal_rows_per_s']:.0f} rows/s, all read back")
    return out


# Phase 51: two runs submitted together to the port's Orchestrator, with one
# h100 device registered (admission on) and a file:// artifact store: phase
# 49's lm_train spec with a build section whose code snapshot holds its entry
# point (ORCH_ENTRY), and a noop as JSON text.  Its final loss is phase 49's
# local gang's within ORCH_LOSS_RTOL.
ORCH_ENTRY_MODULE = "chip_smoke_snapshot_entry"
ORCH_ENTRY = """
import os
from polyaxon_tpu_torch.builtins.trainers import lm_train


def main(ctx):
    ctx.log_text("code snapshot entry " + os.path.abspath(__file__))
    lm_train(ctx)
"""
ORCH_LOSS_RTOL, ORCH_WAIT_S = 1e-3, 600
# Phase 52: a preempted lm_train at phase 17's model, remediated from its
# latest complete checkpoint, beside the same run without preemption.  A
# save's finalize marker is written at the next save's fence, and the
# preemption strikes at the top of its step, so a kill at step 5 leaves step
# 2 the latest complete one (at step 4 it would be step 0).
REMEDY_STEPS, REMEDY_EVERY, REMEDY_PREEMPT, REMEDY_RTOL = 6, 2, 5, 1e-2


def _orchestrator(base, **env):
    """A port ``Orchestrator`` over ``base`` (its options from ``env``)."""
    from polyaxon_tpu_torch.orchestrator import Orchestrator

    with _environ(**env):
        return Orchestrator(base, monitor_interval=0.2, heartbeat_interval=1.0)


def _await_done(orch, run_ids, timeout):
    """Pump ``orch``'s bus until every run in ``run_ids`` is done."""
    deadline = time.time() + timeout
    while not all(orch.get_run(r).is_done for r in run_ids):
        if time.time() > deadline:
            raise AssertionError(f"runs not done after {timeout} s: "
                                 f"{ {r: orch.get_run(r).status for r in run_ids} }")
        orch.pump(max_wait=0.1)


def _status_times(orch, run_id):
    return [(s["status"], s["created_at"]) for s in orch.registry.get_statuses(run_id)]


def _losses(orch, run_id):
    return {m["step"]: m["values"]["loss"] for m in orch.registry.get_metrics(run_id)
            if "loss" in m["values"]}


def _run_trace_launches(orch, run):
    (trace,) = (orch.layout.run_paths(run.uuid).outputs / "profile").glob("*.pt.trace.json")
    in_trace = kernel_launches_in_trace(trace)
    return in_trace, tuple(in_trace[k] for k in KERNEL_NAMES)


def phase_orchestrator_run(local_loss):
    """Phase 51: the port's ``Orchestrator`` runs the platform's main path on
    the card.  One ``h100`` device is registered, so admission is on, and
    ``stores.artifacts_url`` is a ``file://`` store in the phase's directory.
    Run 1 is phase 49's ``lm_train`` spec (671M, batch 4 x 1024, 3 steps, a
    profiled last step) with a ``build`` section: the build task snapshots a
    directory holding the run's entry point, which logs its own path and
    calls ``lm_train``.  Run 2 is a ``noop`` submitted as JSON text through
    ``PolyaxonFile``; it queues at admission until run 1 is done.  Checks: run
    1's statuses from ``created`` through ``building`` to ``succeeded`` (the
    port's watcher writes them), its ``code_ref`` the snapshot's hash and its
    entry imported from ``<run dir>/code``, its final loss phase 49's local
    gang's within ORCH_LOSS_RTOL, each kernel once a layer in the profiled
    step, its goodput row and ``MetricStore`` series, no alert fired, its
    outputs in the store; run 2 scheduled only after run 1 succeeded."""
    from polyaxon_tpu_torch.events import EventTypes
    from polyaxon_tpu_torch.monitor.watcher import goodput_status
    from polyaxon_tpu_torch.schemas import BuildConfig, PolyaxonFile
    from polyaxon_tpu_torch.stores import run_prefix
    from polyaxon_tpu_torch.stores.snapshots import snapshot_hash

    base = Path(tempfile.mkdtemp(prefix="chip_smoke_orch_"))
    code = base / "context"
    code.mkdir()
    (code / f"{ORCH_ENTRY_MODULE}.py").write_text(ORCH_ENTRY)
    store_url = f"file://{base / 'artifacts'}"
    orch = _orchestrator(base / "plane", POLYAXON_TPU_STORES_ARTIFACTS_URL=store_url)
    try:
        if orch.artifact_store is None or orch.artifact_store.url != store_url:
            raise AssertionError(f"the orchestrator's artifact store: {orch.artifact_store}")
        orch.register_device("card-0", GANG_TOPOLOGY["accelerator"], 1)
        spec = _gang_spec("experiment", "lm_train", dict(
            BENCH_MODEL, seq=TRAIN_SEQ, batch=SSH_BATCH, steps=SSH_STEPS, lr=LR,
            profile_start=SSH_STEPS - 1, profile_steps=1))
        spec["run"] = {"entrypoint": f"{ORCH_ENTRY_MODULE}:main"}
        spec["build"] = {"context": str(code)}
        noop = json.dumps(_gang_spec("experiment", "noop", {}))
        _free()
        t0 = time.time()
        train = orch.submit(spec, name="lm_train through the orchestrator")
        queued = orch.submit(PolyaxonFile.load(noop).specification, name="noop, queued")
        _await_done(orch, [train.id, queued.id], ORCH_WAIT_S)
        train, queued = orch.get_run(train.id), orch.get_run(queued.id)
        deadline = time.time() + 300
        while not orch.registry.get_activities(EventTypes.EXPERIMENT_ARTIFACTS_SYNCED):
            if time.time() > deadline:
                raise AssertionError("run 1's artifacts were not synced to the store")
            orch.pump(max_wait=0.1)
        statuses = _status_times(orch, train.id)
        waits = _status_times(orch, queued.id)
        logs = [l["line"] for l in orch.registry.get_logs(train.id)]
        loss = _losses(orch, train.id)
        in_trace, launches = _run_trace_launches(orch, train)
        goodput = goodput_status(orch.registry, train.id)
        series = orch.metrics.series_keys("run_mfu")
        alerts = [a for a in orch.registry.get_alerts(train.id) if a["state"] != "pending"]
        stored = orch.artifact_store.list(f"{run_prefix(train.uuid)}/outputs")
        listed = orch.list_artifacts(train.id)
        ticks = {k: v for k, v in orch.stats.summaries().items()
                 if k.startswith(("tick_phase_s", "monitor_tick_s"))}
        run_dir = orch.layout.run_paths(train.uuid).root
    finally:
        orch.stop()
    want = ["created", "building", "scheduled", "starting", "running", "succeeded"]
    at = dict(statuses)
    entry_line = [l for l in logs if "code snapshot entry" in l]
    ref = snapshot_hash(BuildConfig.from_dict(spec["build"]), code)
    rel = abs(loss.get(SSH_STEPS - 1, float("nan")) - local_loss) / abs(local_loss)
    n = BENCH_MODEL["n_layers"]
    noop_scheduled = next((t for s, t in waits if s == "scheduled"), None)
    out = {"statuses": [s for s, _ in statuses], "queued_statuses": [s for s, _ in waits],
           "submit_to_running_s": at.get("running", t0) - t0,
           "submit_to_succeeded_s": at.get("succeeded", t0) - t0,
           "queued_wait_s": (noop_scheduled or t0) - dict(waits).get("queued", t0),
           "code_ref": train.code_ref, "final_loss": loss.get(SSH_STEPS - 1),
           "phase49_local_loss": local_loss, "loss_rel_diff": rel,
           "launches_in_profiled_step": in_trace, "goodput_rows": goodput["rows"],
           "goodput_ratio": goodput["goodput_ratio"], "mfu": goodput["mfu"],
           "run_mfu_series": series, "alerts": alerts, "stored_outputs": len(stored),
           "tick_phase_s": ticks}
    log(f"orchestrator: lm_train (671M, batch {SSH_BATCH} x {TRAIN_SEQ}, {SSH_STEPS} steps) "
        f"{out['statuses']}, submit to running {out['submit_to_running_s']:.2f} s, to succeeded "
        f"{out['submit_to_succeeded_s']:.2f} s; the noop {out['queued_statuses']} waited "
        f"{out['queued_wait_s']:.2f} s in queued; final loss {out['final_loss']} against phase "
        f"49's {local_loss} (relative {rel:.3g}); kernels in the profiled step {in_trace}; "
        f"goodput {goodput['goodput_ratio']:.3f} over {goodput['rows']} ledger rows; "
        f"{len(stored)} output files in the store; monitor tick phases "
        + ", ".join(f"{k} p50 {v['p50'] * 1e3:.2f} ms max-bucket n {v['count']}"
                    for k, v in ticks.items()))
    problems = []
    if train.status != "succeeded" or out["statuses"] != want:
        problems.append(f"run 1 statuses {out['statuses']}")
    if queued.status != "succeeded" or "queued" not in out["queued_statuses"] or (
            noop_scheduled is None or noop_scheduled < at.get("succeeded", float("inf"))):
        problems.append(f"run 2 statuses {waits}, run 1 succeeded at {at.get('succeeded')}")
    if train.code_ref != ref or not entry_line or not entry_line[0].endswith(
            f"{run_dir / 'code' / ORCH_ENTRY_MODULE}.py"):
        problems.append(f"code_ref {train.code_ref} against {ref}, entry log {entry_line}")
    if not rel <= ORCH_LOSS_RTOL or launches != (n, n, n):
        problems.append(f"loss {loss} (relative {rel}) or kernels {in_trace}")
    if not goodput["rows"] or f'run_mfu{{run="{train.id}"}}' not in series or alerts:
        problems.append(f"goodput rows {goodput['rows']}, series {series}, alerts {alerts}")
    if not stored or not all(k[len(run_prefix(train.uuid)) + 1:] in listed for k in stored):
        problems.append(f"stored outputs {stored}")
    if problems:
        raise AssertionError("the orchestrator's run: " + "; ".join(problems))
    shutil.rmtree(base, ignore_errors=True)
    return launches, out


def phase_remediated_preemption():
    """Phase 52: preemption remediated from a checkpoint.  A port
    ``Orchestrator`` (no device registered: admission off) runs ``lm_train``
    at the 671M width and phase 17's 2 layers (batch 8 x 1024) for
    REMEDY_STEPS steps, ``save_every`` REMEDY_EVERY, a SIGKILL of its own
    process at step REMEDY_PREEMPT and ``restart_policy {max_restarts: 1}``,
    beside the same run without preemption or saves; a profiled last step.
    Checks: the run succeeds with one restart, a ``resume`` remediation row
    SUCCEEDED with ``from_step`` >= REMEDY_EVERY, the second attempt logs
    "restored checkpoint at step", ``experiment.restarted`` and
    ``experiment.resumed`` audited, the last loss the unpreempted run's within
    REMEDY_RTOL, each kernel once a layer in the profiled step."""
    from polyaxon_tpu_torch.db.registry import RemediationStatus
    from polyaxon_tpu_torch.events import EventTypes

    base = Path(tempfile.mkdtemp(prefix="chip_smoke_remedy_"))
    orch = _orchestrator(base / "plane")
    decl = dict(CKPT_MODEL, seq=TRAIN_SEQ, batch=CKPT_BATCH, steps=REMEDY_STEPS, lr=LR)
    # The unpreempted run's loss does not depend on its saves: it takes none.
    preempted = _gang_spec("experiment", "lm_train", dict(
        decl, save_every=REMEDY_EVERY, preempt_step=REMEDY_PREEMPT,
        profile_start=REMEDY_STEPS - 1, profile_steps=1))
    preempted["environment"]["restart_policy"] = {"max_restarts": 1}
    try:
        _free()
        run = orch.submit(preempted, name="preempted lm_train")
        plain = orch.submit(_gang_spec("experiment", "lm_train", decl), name="no preemption")
        _await_done(orch, [run.id, plain.id], ORCH_WAIT_S)
        run, plain = orch.get_run(run.id), orch.get_run(plain.id)
        rows = orch.registry.get_remediations(run.id, action="resume")
        logs = "\n".join(l["line"] for l in orch.registry.get_logs(run.id))
        audited = {e: bool(orch.registry.get_activities(e)) for e in (
            EventTypes.EXPERIMENT_RESTARTED, EventTypes.EXPERIMENT_RESUMED)}
        statuses = _status_times(orch, run.id)
        loss, plain_loss = _losses(orch, run.id), _losses(orch, plain.id)
        saves = [{k: m["values"][k] for k in ("ckpt_save_block_s", "ckpt_write_s", "ckpt_bytes")}
                 | {"step": m["step"]} for m in orch.registry.get_metrics(run.id)
                 if "ckpt_write_s" in m["values"]]
        in_trace, launches = _run_trace_launches(orch, run)
        first = orch.layout.run_paths(run.uuid).reports / "proc0.jsonl.attempt0"
        killed_at = next(e["ts"] for e in map(json.loads, first.read_text().splitlines())
                         if e.get("type") == "log" and "injecting preemption" in e.get("line", ""))
    finally:
        orch.stop()
    running = [t for s, t in statuses if s == "running"]
    last = REMEDY_STEPS - 1
    rel = abs(loss.get(last, float("nan")) - plain_loss[last]) / abs(plain_loss[last])
    row = rows[0] if rows else {}
    from_step = (row.get("attrs") or {}).get("from_step")
    out = {"statuses": [s for s, _ in statuses], "restarts": run.restarts,
           "remediation": {k: row.get(k) for k in ("action", "status", "message")},
           "from_step": from_step, "audited": audited,
           "preemption_to_running_s": (running[-1] - killed_at) if len(running) > 1 else None,
           "saves": saves, "final_loss": loss.get(last), "plain_final_loss": plain_loss[last],
           "loss_rel_diff": rel, "launches_in_profiled_step": in_trace}
    log(f"remediation: lm_train (2 layers, batch {CKPT_BATCH} x {TRAIN_SEQ}, {REMEDY_STEPS} "
        f"steps, save every {REMEDY_EVERY}, SIGKILL at step {REMEDY_PREEMPT}) {out['statuses']}, "
        f"{run.restarts} restart, {out['remediation']} from step {from_step}; preemption to "
        f"running {out['preemption_to_running_s']} s; saves {saves}; final loss "
        f"{out['final_loss']} against {plain_loss[last]} without preemption (relative "
        f"{rel:.3g}); kernels in the profiled step {in_trace}")
    n = CKPT_MODEL["n_layers"]
    if (run.status != "succeeded" or run.restarts != 1 or plain.status != "succeeded"
            or row.get("status") != RemediationStatus.SUCCEEDED or from_step is None
            or from_step < REMEDY_EVERY or "restored checkpoint at step" not in logs
            or not all(audited.values()) or not rel <= REMEDY_RTOL or launches != (n, n, n)
            or out["preemption_to_running_s"] is None):
        raise AssertionError(f"the remediated preemption: {out}")
    shutil.rmtree(base, ignore_errors=True)
    return launches, out


# Phase 53: a control-plane ServingFleet of CP_REPLICAS lm_server replicas at
# FLEET_MODEL (phase 25's replica configuration), kind: service runs of a port
# Orchestrator with no device registered (admission off, as phase 25's fleet
# shares the card: with one h100 device registered the second replica would
# wait in queued for the first, which never finishes).  CP_BURST greedy
# requests of CP_PROMPT tokens and CP_NEW new ones through the router; one
# replica's worker SIGSTOPped with heartbeat_stale's threshold at CP_STALE_S
# (heartbeats every second), a drain deadline of CP_DRAIN_S (a stopped
# replica never drains) and CP_MEANWHILE requests sent while it drains.
CP_REPLICAS, CP_BURST, CP_PROMPT, CP_NEW, CP_SEED = 2, 16, 256, 32, 53
CP_STALE_S, CP_DRAIN_S, CP_READY_S, CP_MEANWHILE = 4.0, 2.0, 300.0, 4
# Phase 54: a grid sweep of phase 51's lm_train spec over SWEEP_LRS with
# concurrency 2 and one h100 device registered.  Phase 55: a pipeline of
# lm_train at CKPT_MODEL (PIPE_STEPS steps, batch SSH_BATCH) and, after it,
# lm_generate at the same width (batch PIPE_BATCH, prompt PIPE_PROMPT,
# PIPE_NEW new tokens), each op through counted_entry.
SWEEP_LRS, SWEEP_WAIT_S = (3e-4, 1e-3), 600
PIPE_STEPS, PIPE_BATCH, PIPE_PROMPT, PIPE_NEW = 3, 4, 512, 16


def counted_entry(ctx) -> None:
    """A gang entry point (phase 55's ops): the builtin trainer named by the
    ``counted`` declaration, the flash kernels' launch counts set to 0 just
    before it and logged just after, as a metric row of its run."""
    from polyaxon_tpu_torch.builtins import trainers

    _reset_counts()
    getattr(trainers, ctx.get_param("counted"))(ctx)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    fwd, dq, dkv = _counts()
    ctx.log_metrics(launches_fwd=fwd, launches_dq=dq, launches_dkv=dkv)


def _pump_fleet(orch, fleet, cond, timeout, what, each=None):
    """Pump ``orch`` and poll ``fleet`` until ``cond()`` holds; ``each()``
    runs after the pump and after the poll (a remediation row opened in the
    pump can move on in the next poll)."""
    deadline = time.time() + timeout
    while True:
        for step in (functools.partial(orch.pump, max_wait=0.05), fleet.poll):
            step()
            if each is not None:
                each()
        if cond():
            return
        if time.time() > deadline:
            raise AssertionError(f"control-plane fleet: {what} not seen in {timeout} s: "
                                 f"{fleet.status()}")


def _through_router(router, prompts, max_new, orch, fleet, each=None):
    """Send ``prompts`` through ``router`` at once, one thread each, pumping
    ``orch`` and ``fleet`` (:func:`_pump_fleet`) until all are answered:
    [(replica, tokens)], an error raised."""
    results, errors = [None] * len(prompts), []

    def send(i, prompt):
        try:
            body = router.generate([prompt], max_new_tokens=max_new)
            results[i] = (body["replica"], body["tokens"][0])
        except Exception as e:  # raised below, after every thread is done
            errors.append(e)

    threads = [threading.Thread(target=send, args=(i, p), daemon=True)
               for i, p in enumerate(prompts)]
    for th in threads:
        th.start()
    _pump_fleet(orch, fleet, lambda: not any(th.is_alive() for th in threads), CP_READY_S,
                f"the answers to {len(prompts)} requests", each=each)
    if errors:
        raise errors[0]
    return results


def phase_control_plane_fleet():
    """Phase 53: the control plane's ``ServingFleet`` on the card.
    CP_REPLICAS ``lm_server`` replicas at FLEET_MODEL as ``kind: service``
    runs of a port ``Orchestrator`` with no device registered, the router
    probing every 0.2 s.  Admission is then off: ``experiments_start``
    (``scheduler/tasks.py``) calls ``RunRegistry.acquire_device``, which
    returns ``{"unmanaged": True}`` for a family with no inventory, and the
    run is scheduled at once; with one ``h100`` registered it would return
    None for the second replica, which would wait in ``queued`` for the
    first, a service that never finishes.  Checks: both replicas probe ``ready``; the
    burst all completes with CP_NEW tokens each; one probe prompt sent
    straight to each replica gives the same greedy tokens; where a replica's
    ``/v1/stats`` reports ``trace_exemplars``, its run holds a ``ttft_slow``
    anomaly whose dump file exists; after a SIGSTOP of one replica's worker,
    ``heartbeat_stale`` fires, the remediation engine opens
    ``drain_replace`` and its row passes ``draining`` -> ``replacing`` ->
    ``done``, closed ``succeeded``; the requests sent while it drains all
    complete on the survivor; the replacement probes ``ready`` and gives the
    probe prompt the same greedy tokens; then
    ``run_health_checks(orch, include_devices=True)`` is healthy with the
    fleet 2/2 ready and ``devices`` naming the card; no flash kernel runs in
    this process, nor in any replica's (its ``/v1/stats`` ``flash_launches``,
    the replacement's read after it served the probe).  Returns the figures:
    each replica's submit-to-ready s and the alert-to-replacement-ready s."""
    from polyaxon_tpu_torch.checks import run_health_checks
    from polyaxon_tpu_torch.db.registry import RemediationStatus
    from polyaxon_tpu_torch.serving.fleet import ServingFleet

    base = Path(tempfile.mkdtemp(prefix="chip_smoke_cp_fleet_"))
    orch = _orchestrator(base / "plane", POLYAXON_TPU_ALERT_INTERVAL_S="0.2",
                         POLYAXON_TPU_SCHEDULER_TERMINAL_GRACE="0.5")
    router = _fleet_router(probe_interval_s=0.2)
    fleet = ServingFleet(
        orch, name="cp-fleet", replicas=CP_REPLICAS, drain_deadline_s=CP_DRAIN_S,
        ready_timeout_s=CP_READY_S, router=router,
        declarations=dict(FLEET_MODEL, seq=SERVE_SEQ, slots=SERVE_SLOTS, block_size=SERVE_BLOCK,
                          prefill_chunk=SERVE_CHUNK,
                          **{"alert.heartbeat_stale.threshold_s": CP_STALE_S}),
        environment={"seed": SEED, "topology": dict(GANG_TOPOLOGY)})
    rng = np.random.default_rng(CP_SEED)
    V = FLEET_MODEL["vocab_size"]
    stopped = None
    out = {}
    _reset_counts()
    try:
        t0 = time.time()
        fleet.start()
        ready_at = {}

        def note_ready():
            now = time.time()
            for name in fleet.run_ids():
                rep = router.replica(name)
                if name not in ready_at and rep is not None and rep.state == "ready":
                    ready_at[name] = now

        _pump_fleet(orch, fleet, lambda: len(ready_at) == CP_REPLICAS, CP_READY_S,
                    "both replicas ready", each=note_ready)
        out["submit_to_ready_s"] = {name: at - t0 for name, at in ready_at.items()}
        prompts = [rng.integers(0, V, CP_PROMPT).tolist() for _ in range(CP_BURST)]
        tb = time.time()
        burst = _through_router(router, prompts, CP_NEW, orch, fleet, each=note_ready)
        out["burst_s"] = time.time() - tb
        out["burst_by_replica"] = {n: sum(r == n for r, _ in burst) for n in fleet.run_ids()}
        if any(len(tokens) != CP_NEW for _, tokens in burst):
            raise AssertionError(f"control-plane fleet: burst answers {burst}")
        probe = rng.integers(0, V, CP_PROMPT).tolist()
        same = {name: _http(router.replica(name).base_url, "/generate",
                            {"prompts": [probe], "max_new_tokens": CP_NEW})[1]["tokens"][0]
                for name in fleet.run_ids()}
        if len({tuple(t) for t in same.values()}) != 1:
            raise AssertionError(f"control-plane fleet: the replicas' greedy tokens {same}")
        # The exemplar harvest: a sweep every EXEMPLAR_HARVEST_INTERVAL_S.
        harvest_until = time.time() + 2 * ServingFleet.EXEMPLAR_HARVEST_INTERVAL_S + 0.5
        _pump_fleet(orch, fleet, lambda: time.time() > harvest_until, 60, "exemplar harvest")
        exemplars, replica_launches = {}, {}
        for name, run_id in fleet.run_ids().items():
            stats = _http(router.replica(name).base_url, "/v1/stats")[1]
            replica_launches[name] = stats["flash_launches"]
            reported = stats.get("trace_exemplars") or []
            rows = orch.registry.get_anomalies(run_id, kind="ttft_slow")
            dumps = [orch.layout.run_paths(orch.get_run(run_id).uuid).root
                     / r["attrs"]["dump_artifact"] for r in rows]
            exemplars[name] = {"reported": len(reported), "anomaly_rows": len(rows),
                               "dumps": [str(p.relative_to(base)) for p in dumps]}
            if reported and not (rows and all(p.exists() for p in dumps)):
                raise AssertionError(f"control-plane fleet: {name} reports exemplars but "
                                     f"holds no ttft_slow anomaly with a dump: {rows}")
        out["exemplars"] = exemplars
        # Wedge one replica: alive, silent.
        victim, survivor = sorted(fleet.run_ids())
        victim_run = fleet.run_ids()[victim]
        stopped = int(orch.registry.get_processes(victim_run)[0]["pid"])
        os.kill(stopped, signal.SIGSTOP)
        t_stop = time.time()
        phases, done = [], []

        def watch():
            note_ready()
            for row in orch.registry.get_remediations(victim_run, action="drain_replace"):
                phase = (row["attrs"] or {}).get("phase")
                if not phases or phases[-1][0] != phase:
                    phases.append((phase, time.time()))
                if row["status"] == RemediationStatus.SUCCEEDED:
                    done.append(row)

        _pump_fleet(orch, fleet, lambda: phases, CP_READY_S, "drain_replace opened", each=watch)
        sent = [rng.integers(0, V, CP_PROMPT).tolist() for _ in range(CP_MEANWHILE)]
        meanwhile = _through_router(router, sent, CP_NEW, orch, fleet, each=watch)
        _pump_fleet(orch, fleet, lambda: done, CP_READY_S, "drain_replace succeeded",
                    each=watch)
        row = done[0]
        replacement = row["attrs"]["replacement"]
        alert = orch.registry.get_alerts(victim_run, rule="heartbeat_stale")
        fired_at = alert[0]["fired_at"] if alert else None
        _pump_fleet(orch, fleet, lambda: replacement in ready_at, 60, "the replacement ready",
                    each=note_ready)
        same[replacement] = _http(router.replica(replacement).base_url, "/generate",
                                  {"prompts": [probe], "max_new_tokens": CP_NEW})[1]["tokens"][0]
        replica_launches[replacement] = _http(router.replica(replacement).base_url,
                                              "/v1/stats")[1]["flash_launches"]
        members = sorted(fleet.run_ids())
        with _environ(POLYAXON_TPU_LINT_STATE=str(base / "lint_state.json")):
            health = run_health_checks(orch, include_devices=True)
        live = list(fleet.run_ids().values())
        for run_id in live:
            orch.stop_run(run_id)
        _await_done(orch, live, 120)
    finally:
        if stopped is not None:
            try:
                os.kill(stopped, signal.SIGCONT)
            except ProcessLookupError:
                pass
        fleet.stop()
        orch.stop()
    torch.cuda.synchronize()
    launches = _counts()
    out.update(
        stall_to_fired_s=(fired_at - t_stop) if fired_at else None,
        phases=[p for p, _ in phases],
        alert_to_replacement_ready_s=(ready_at[replacement] - fired_at) if fired_at else None,
        stall_to_replacement_ready_s=ready_at[replacement] - t_stop,
        drain_timed_out=row["attrs"].get("drain_timed_out"),
        meanwhile_by_replica=[r for r, _ in meanwhile], members=members,
        health={k: v for k, v in health["checks"].items()
                if k in ("fleet", "devices", "remediation", "alerts")},
        healthy=health["healthy"], launches=launches, replica_launches=replica_launches)
    log(f"control-plane fleet: {CP_REPLICAS} lm_server replicas ({FLEET_LAYERS} layers) as "
        f"kind: service runs, submit to ready {out['submit_to_ready_s']} s; {CP_BURST} requests "
        f"in {out['burst_s']:.2f} s {out['burst_by_replica']}; exemplars {exemplars}; "
        f"SIGSTOP of {victim}: heartbeat_stale fired {out['stall_to_fired_s']} s later, "
        f"drain_replace {out['phases']} ({row['status']}), the {CP_MEANWHILE} requests meanwhile "
        f"on {out['meanwhile_by_replica']}, alert to replacement ready "
        f"{out['alert_to_replacement_ready_s']} s; health {health['healthy']} {out['health']}; "
        f"flash launches {launches} here, {replica_launches} in the replicas' processes")
    problems = []
    if out["phases"] != ["draining", "replacing", "done"] or fired_at is None:
        problems.append(f"phases {phases}, alert {alert}")
    if row["trigger"] != "heartbeat_stale" or members != sorted([survivor, replacement]):
        problems.append(f"row {row}, members {members}")
    if any(r != survivor for r in out["meanwhile_by_replica"]):
        problems.append(f"requests while draining went to {out['meanwhile_by_replica']}")
    fleet_detail = health["checks"]["fleet"]["detail"]
    devices = health["checks"]["devices"]
    if not health["healthy"] or "2/2 ready" not in fleet_detail or not devices["ok"] or \
            torch.cuda.get_device_name(0) not in devices["detail"]:
        problems.append(f"health {health}")
    if len({tuple(t) for t in same.values()}) != 1:
        problems.append(f"the replacement's greedy tokens {same[replacement]}, not {same[victim]}")
    if launches != (0, 0, 0) or any(any(c.values()) for c in replica_launches.values()):
        problems.append(f"flash launches {launches} here, {replica_launches} in the replicas")
    if problems:
        raise AssertionError("control-plane fleet: " + "; ".join(problems))
    shutil.rmtree(base, ignore_errors=True)
    return out


def phase_sweep(orch_loss):
    """Phase 54: a ``kind: group`` grid sweep through the port's
    ``Orchestrator``: phase 51's ``lm_train`` spec (671M, batch 4 x 1024, 3
    steps, a profiled last step) over ``lr`` in SWEEP_LRS with ``concurrency:
    2`` and one ``h100`` device registered.  Checks: the group and both trials
    succeed; the second trial is scheduled only after the first succeeded
    (the one slice runs them one at a time); the group's iteration row holds
    both configs and its trial ids, and each trial reported its loss; the
    ``lr`` 3e-4 trial's final loss is phase 51's (``orch_loss``) within
    ORCH_LOSS_RTOL; each kernel once a layer in each trial's profiled step.
    Returns the launches of both trials' profiled steps and the figures."""
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_sweep_"))
    orch = _orchestrator(base / "plane")
    try:
        orch.register_device("card-0", GANG_TOPOLOGY["accelerator"], 1)
        spec = _gang_spec("group", "lm_train", dict(
            BENCH_MODEL, seq=TRAIN_SEQ, batch=SSH_BATCH, steps=SSH_STEPS,
            profile_start=SSH_STEPS - 1, profile_steps=1))
        spec["hptuning"] = {"matrix": {"lr": {"values": list(SWEEP_LRS)}}, "concurrency": 2,
                            "grid_search": {}}
        _free()
        t0 = time.time()
        group = orch.submit(spec, name="lm_train lr sweep")
        _await_done(orch, [group.id], SWEEP_WAIT_S)
        group = orch.get_run(group.id)
        trials = sorted(orch.registry.list_runs(group_id=group.id), key=lambda r: r.id)
        iterations = orch.registry.get_iterations(group.id)
        statuses = {t.id: _status_times(orch, t.id) for t in trials}
        losses = {t.id: _losses(orch, t.id) for t in trials}
        traced = {t.id: _run_trace_launches(orch, t) for t in trials}
    finally:
        orch.stop()
    n = BENCH_MODEL["n_layers"]
    lrs = [t.spec.declarations["lr"] for t in trials]
    first, second = sorted(trials, key=lambda t: dict(statuses[t.id]).get("scheduled", 0))
    first_done = dict(statuses[first.id]).get("succeeded", float("inf"))
    second_scheduled = dict(statuses[second.id]).get("scheduled", 0.0)
    final = {lr: losses[t.id].get(SSH_STEPS - 1) for lr, t in zip(lrs, trials)}
    got = final.get(SWEEP_LRS[0])
    rel = abs(got - orch_loss) / abs(orch_loss) if got is not None else float("nan")
    out = {"group_status": group.status, "trial_statuses": {
               lr: [s for s, _ in statuses[t.id]] for lr, t in zip(lrs, trials)},
           "submit_to_succeeded_s": {lr: dict(statuses[t.id]).get("succeeded", t0) - t0
                                     for lr, t in zip(lrs, trials)},
           "second_waited_s": second_scheduled - dict(statuses[second.id]).get("created", t0),
           "final_loss": final, "phase51_loss": orch_loss, "loss_rel_diff": rel,
           "iterations": [{k: row["data"].get(k) for k in ("configs", "trial_ids")}
                          for row in iterations],
           "launches_in_profiled_steps": {lr: traced[t.id][0] for lr, t in zip(lrs, trials)}}
    log(f"sweep: grid over lr {list(SWEEP_LRS)} of lm_train (671M, batch {SSH_BATCH} x "
        f"{TRAIN_SEQ}, {SSH_STEPS} steps), concurrency 2 on one registered h100: group "
        f"{group.status}, trials {out['trial_statuses']}, submit to succeeded "
        f"{out['submit_to_succeeded_s']} s, the second scheduled "
        f"{second_scheduled - first_done:.2f} s after the first succeeded; final losses {final} "
        f"(lr {SWEEP_LRS[0]} against phase 51's {orch_loss}: relative {rel:.3g}); kernels in "
        f"the profiled steps {out['launches_in_profiled_steps']}")
    problems = []
    if group.status != "succeeded" or len(trials) != 2 or \
            any(t.status != "succeeded" for t in trials) or sorted(lrs) != sorted(SWEEP_LRS):
        problems.append(f"group {group.status}, trials {out['trial_statuses']}, lrs {lrs}")
    if second_scheduled < first_done:
        problems.append(f"the second trial was scheduled at {second_scheduled}, before the "
                        f"first succeeded at {first_done}")
    if len(iterations) != 1 or iterations[0]["data"]["configs"] != [
            {"lr": lr} for lr in SWEEP_LRS] or sorted(iterations[0]["data"]["trial_ids"]) != \
            [t.id for t in trials] or any(v is None or not np.isfinite(v)
                                           for v in final.values()):
        problems.append(f"iterations {out['iterations']}, losses {final}")
    if not rel <= ORCH_LOSS_RTOL:
        problems.append(f"the lr {SWEEP_LRS[0]} trial's loss relative {rel}")
    if any(launches != (n, n, n) for _, launches in traced.values()):
        problems.append(f"kernels {out['launches_in_profiled_steps']}")
    if problems:
        raise AssertionError("the sweep: " + "; ".join(problems))
    shutil.rmtree(base, ignore_errors=True)
    total = tuple(sum(launches[i] for _, launches in traced.values()) for i in range(3))
    return total, out


def phase_pipeline():
    """Phase 55: a ``kind: pipeline`` through the port's ``Orchestrator``
    (admission off): op ``train`` is ``lm_train`` at CKPT_MODEL (PIPE_STEPS
    steps, batch SSH_BATCH x 1024) and op ``generate``, which depends on it,
    ``lm_generate`` at the same width (batch PIPE_BATCH, prompt PIPE_PROMPT,
    PIPE_NEW new tokens), each through ``counted_entry``.  Checks: the
    pipeline and both ops succeed; ``generate`` is dispatched only after
    ``train`` succeeded; ``train``'s loss is finite and falls; ``generate``
    made PIPE_BATCH x PIPE_NEW tokens; each op's launches are phase 7's and
    phase 5's at 2 layers (each kernel once a layer a step; four prefills'
    forward launches).  Returns each op's launches and the figures."""
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_pipeline_"))
    orch = _orchestrator(base / "plane")
    env = {"seed": SEED, "topology": dict(GANG_TOPOLOGY)}
    entry = {"entrypoint": "chip_smoke:counted_entry"}
    ops = [{"name": "train", "run": entry, "environment": env,
            "declarations": dict(CKPT_MODEL, seq=TRAIN_SEQ, batch=SSH_BATCH, steps=PIPE_STEPS,
                                 lr=LR, counted="lm_train")},
           {"name": "generate", "dependencies": ["train"], "run": entry, "environment": env,
            "declarations": dict(CKPT_MODEL, seq=TRAIN_SEQ, batch=PIPE_BATCH,
                                 prompt_len=PIPE_PROMPT, max_new_tokens=PIPE_NEW,
                                 temperature=0.0, counted="lm_generate")}]
    try:
        _free()
        t0 = time.time()
        pipe = orch.submit({"kind": "pipeline", "ops": ops}, name="train, then generate")
        _await_done(orch, [pipe.id], ORCH_WAIT_S)
        pipe = orch.get_run(pipe.id)
        runs = {r.name: r for r in orch.registry.list_runs(pipeline_id=pipe.id)}
        statuses = {name: _status_times(orch, r.id) for name, r in runs.items()}
        metrics = {name: [m for m in orch.registry.get_metrics(r.id)] for name, r in runs.items()}
    finally:
        orch.stop()
    launches = {}
    for name, rows in metrics.items():
        counted = [m["values"] for m in rows if "launches_fwd" in m["values"]]
        launches[name] = tuple(int(counted[-1][f"launches_{k}"]) for k in ("fwd", "dq", "dkv")) \
            if counted else None
    losses = {m["step"]: m["values"]["loss"] for m in metrics.get("train", [])
              if "loss" in m["values"]}
    generated = next((m["values"]["generated"] for m in metrics.get("generate", [])
                      if "generated" in m["values"]), None)
    train_done = dict(statuses.get("train", [])).get("succeeded", float("inf"))
    gen_dispatched = dict(statuses.get("generate", [])).get("queued", 0.0)
    n = CKPT_MODEL["n_layers"]
    out = {"status": pipe.status, "op_statuses": {k: [s for s, _ in v] for k, v in statuses.items()},
           "op_order": sorted(statuses, key=lambda k: dict(statuses[k]).get("queued", 0.0)),
           "submit_to_succeeded_s": {k: dict(v).get("succeeded", t0) - t0
                                     for k, v in statuses.items()},
           "generate_dispatched_after_train_s": gen_dispatched - train_done,
           "train_loss": losses, "generated": generated,
           "launches": launches}
    log(f"pipeline: train (lm_train, {n} layers, batch {SSH_BATCH} x {TRAIN_SEQ}, {PIPE_STEPS} "
        f"steps) then generate (lm_generate, batch {PIPE_BATCH}, prompt {PIPE_PROMPT}, {PIPE_NEW} "
        f"new): {pipe.status}, ops {out['op_statuses']}, order {out['op_order']}, submit to "
        f"succeeded {out['submit_to_succeeded_s']} s, generate dispatched "
        f"{out['generate_dispatched_after_train_s']:.2f} s after train succeeded; losses "
        f"{out['train_loss']}; generated {generated}; launches {launches}")
    first, last = losses.get(0), losses.get(PIPE_STEPS - 1)
    if (pipe.status != "succeeded" or sorted(runs) != ["generate", "train"]
            or any(r.status != "succeeded" for r in runs.values()) or gen_dispatched < train_done
            or first is None or last is None or not (np.isfinite(first) and np.isfinite(last)
                                                     and last < first)
            or generated != PIPE_BATCH * PIPE_NEW
            or launches.get("train") != (n * PIPE_STEPS,) * 3
            or launches.get("generate") != (4 * n, 0, 0)):
        raise AssertionError(f"the pipeline: {out}")
    shutil.rmtree(base, ignore_errors=True)
    return launches, out


_SERVERS = []  # phase 56's serve processes


def _stop_servers() -> None:
    """TERM each serve process still running (its orchestrator then stops its
    gangs), KILL it if it does not exit."""
    for proc in _SERVERS:
        if proc.poll() is None:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.killpg(proc.pid, signal.SIGTERM)
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                with contextlib.suppress(ProcessLookupError, PermissionError):
                    os.killpg(proc.pid, signal.SIGKILL)


atexit.register(_stop_servers)


def _cli(*argv):
    """(rc, stdout, stderr, seconds) of the port's CLI called in this process."""
    import io

    from polyaxon_tpu_torch.cli.main import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli_main(list(argv))
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def _ws_rows(url, timeout=120):
    """The rows a WS tail delivers up to its ``done`` event, and that event."""
    import asyncio

    import aiohttp

    async def tail():
        rows = []
        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(url, timeout=timeout) as ws:
                async for msg in ws:
                    row = msg.json()
                    if row.get("event") == "done":
                        return rows, row
                    rows.append(row)
        raise AssertionError(f"the WS tail {url} closed without its done event: {rows}")

    return asyncio.run(asyncio.wait_for(tail(), timeout))


def phase_surfaces():
    """Phase 56: the API and the CLI drive phase 55's ``train`` op (``lm_train``
    at CKPT_MODEL, batch SSH_BATCH x 1024, PIPE_STEPS steps, through
    ``counted_entry``) as a JSON spec naming no accelerator.  The port's
    ``serve`` runs as a subprocess over its own base directory; the CLI in
    remote mode submits ``run -f spec.json --watch``.  Checks: the run
    succeeds, its stored topology names the card, its launches are each
    kernel once a layer a step and its loss is finite and falls; over HTTP
    its detail, its metrics (the registry's loss rows), the WS metrics tail
    (the same rows), ``/api/v1/status?devices=1`` healthy naming the card,
    ``/api/v1/version`` naming torch and its CUDA, ``/metrics`` with
    ``api_request_s``, and the dashboard at ``/``; the CLI's remote ``ps``,
    ``get``, ``logs`` and ``statuses``; the server stops with rc 0 and
    releases its lease.  Without aiohttp the API cannot serve: the CLI's
    local mode drives the same run and reads, and a line says why."""
    import importlib.util

    from polyaxon_tpu_torch.api.dashboard import DASHBOARD_HTML
    from polyaxon_tpu_torch.db.registry import RunRegistry

    t_phase = time.perf_counter()
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_surfaces_"))
    plane = base / "plane"
    spec_file = base / "spec.json"
    spec_file.write_text(json.dumps({
        "kind": "experiment", "run": {"entrypoint": "chip_smoke:counted_entry"},
        "declarations": dict(CKPT_MODEL, seq=TRAIN_SEQ, batch=SSH_BATCH, steps=PIPE_STEPS, lr=LR,
                             counted="lm_train"),
        "environment": {"seed": SEED}}))
    api = importlib.util.find_spec("aiohttp") is not None
    reads, out, server = {}, {"api": api}, None
    if api:
        port = _free_port()
        url = f"http://127.0.0.1:{port}"
        target = ["--host", url]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(Path(__file__).resolve().parent), os.environ.get("PYTHONPATH", "")]))
        server_log = open(base / "serve.log", "w")
        server = subprocess.Popen(
            [sys.executable, "-m", "polyaxon_tpu_torch.cli.main", "--base-dir", str(plane),
             "serve", "--port", str(port)],
            env=env, stdout=server_log, stderr=subprocess.STDOUT, start_new_session=True)
        _SERVERS.append(server)
    else:
        log("surfaces: the API was not driven: aiohttp is not installed on this host, so the "
            "port's serve cannot run here; the CLI's local mode drives the same run")
        target = ["--base-dir", str(plane)]
    try:
        if api:
            deadline = time.time() + 120
            while True:
                try:
                    if _http(url, "/api/v1/status", timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                if server.poll() is not None or time.time() > deadline:
                    raise AssertionError(f"serve did not come up: "
                                         f"{(base / 'serve.log').read_text()[-4000:]}")
                time.sleep(0.1)
            out["serve_up_s"] = time.perf_counter() - t_phase
        _free()
        watched = []
        watch = threading.Thread(target=lambda: watched.append(_cli(
            *target, "run", "-f", str(spec_file), "--watch", "--name", "surfaces")), daemon=True)
        watch.start()
        watch.join(ORCH_WAIT_S)
        if not watched:
            raise AssertionError(f"surfaces: run --watch did not end in {ORCH_WAIT_S} s")
        rc, printed, status_lines, reads["run_watch"] = watched[0]
        if rc != 0:
            raise AssertionError(f"surfaces: run --watch rc {rc}: {status_lines[-4000:]}\n"
                                 f"{printed[-4000:]}")
        run_id = int(status_lines.split("Created run ")[1].split()[0])
        registry = RunRegistry(plane / "registry.db")
        try:
            statuses = {s["status"]: s["created_at"] for s in registry.get_statuses(run_id)}
            rows = registry.get_metrics(run_id)
            stored = registry.get_run(run_id).spec_data["environment"]["topology"]
        finally:
            registry.close()
        out["submit_to_succeeded_s"] = statuses["succeeded"] - statuses["created"]
        losses = {m["step"]: m["values"]["loss"] for m in rows if "loss" in m["values"]}
        counted = [m["values"] for m in rows if "launches_fwd" in m["values"]]
        launches = tuple(int(counted[-1][f"launches_{k}"]) for k in ("fwd", "dq", "dkv")) \
            if counted else None
        out.update(stored_topology=stored, train_loss=losses, launches=launches)
        checks = {}
        printed_right = {"ps": lambda t: "succeeded" in t and "surfaces" in t,
                         "get": lambda t: json.loads(t)["status"] == "succeeded",
                         "logs": lambda t: "final loss" in t,
                         "statuses": lambda t: "created" in t and "succeeded" in t}
        for name in printed_right:
            argv = [name] if name == "ps" else [name, str(run_id)]
            rc, text, err, reads[f"cli {name}"] = _cli(*target, *argv)
            checks[f"cli {name}"] = rc == 0 and printed_right[name](text)
        if api:
            def timed(name, path):
                t0 = time.perf_counter()
                got = _http(url, path, timeout=60)
                reads[name] = time.perf_counter() - t0
                return got

            code, detail = timed("GET /api/v1/runs/{id}", f"/api/v1/runs/{run_id}")
            checks["run detail"] = code == 200 and detail["status"] == "succeeded" and detail[
                "spec"]["environment"]["topology"] == stored
            code, metrics = timed("GET /api/v1/runs/{id}/metrics", f"/api/v1/runs/{run_id}/metrics")
            http_losses = {m["step"]: m["values"]["loss"] for m in metrics["results"]
                           if "loss" in m["values"]}
            checks["metrics over HTTP"] = code == 200 and http_losses == losses
            t0 = time.perf_counter()
            ws_rows, done = _ws_rows(url.replace("http", "ws") + f"/ws/v1/runs/{run_id}/metrics")
            reads["WS /ws/v1/runs/{id}/metrics"] = time.perf_counter() - t0
            ws_losses = {m["step"]: m["values"]["loss"] for m in ws_rows if "loss" in m["values"]}
            checks["WS metrics tail"] = ws_losses == losses and done["status"] == "succeeded"
            code, health = timed("GET /api/v1/status?devices=1", "/api/v1/status?devices=1")
            out["devices_probe"] = health["checks"].get("devices")
            checks["status"] = code == 200 and health["healthy"] and \
                torch.cuda.get_device_name(0) in health["checks"]["devices"]["detail"]
            code, version = timed("GET /api/v1/version", "/api/v1/version")
            out["version"] = version
            checks["version"] = code == 200 and version.get("torch") == torch.__version__ \
                and version.get("cuda") == torch.version.cuda and "jax" not in version
            code, exposition = timed("GET /metrics", "/metrics")
            checks["/metrics"] = code == 200 and "api_request_s" in exposition
            code, page = timed("GET /", "/")
            checks["dashboard"] = code == 200 and page == DASHBOARD_HTML
    finally:
        if server is not None:
            _stop_servers()
            out["serve_rc"] = server.poll()
            server_log.close()
    if api:
        registry = RunRegistry(plane / "registry.db")
        try:
            checks["lease released"] = out["serve_rc"] == 0 and registry.get_option(
                "platform.lease") is None
        finally:
            registry.close()
    out["reads_s"] = reads
    out["checks"] = checks
    out["phase_s"] = time.perf_counter() - t_phase
    n = CKPT_MODEL["n_layers"]
    log(f"surfaces: {'the API and the CLI' if api else 'the CLI (local mode)'}: lm_train "
        f"({n} layers, batch {SSH_BATCH} x {TRAIN_SEQ}, {PIPE_STEPS} steps) naming no "
        f"accelerator, stored as {stored}; submit to succeeded "
        f"{out['submit_to_succeeded_s']:.2f} s; launches {launches}; losses {losses}; "
        f"reads (s) {reads}; checks {checks}; phase {out['phase_s']:.1f} s")
    first, last = losses.get(0), losses.get(PIPE_STEPS - 1)
    if (not all(checks.values()) or stored.get("accelerator") != "h100"
            or "succeeded" not in statuses or launches != (n * PIPE_STEPS,) * 3
            or first is None or last is None
            or not (np.isfinite(first) and np.isfinite(last) and last < first)):
        raise AssertionError(f"the surfaces: {out}")
    shutil.rmtree(base, ignore_errors=True)
    return launches, out


def _capture_probe():
    """GL001's bug class on the card, in a process of its own (phase 57's
    child): one small step captured by ``decode.capture_step`` without, then
    with, a host read of a device value (``.item()``).  Without it the graph
    replays, after its input is rewritten in place, what the eager step gives
    on the new input; with it the capture must raise.  The failed capture
    comes last: nothing after it in this process uses the card."""
    from polyaxon_tpu_torch.models.decode import capture_step

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(256, 256, device="cuda", generator=gen)
    w = torch.randn(256, 256, device="cuda", generator=gen) / 16

    def step(host_read):
        y = torch.tanh(x @ w)
        peak = y.abs().max()
        return y / (peak.item() if host_read else peak)

    graph, out = capture_step(lambda: step(False))
    first = out.clone()
    x.mul_(0.5).add_(1.0)  # the next input, written into the captured buffer
    graph.replay()
    eager = step(False)
    torch.cuda.synchronize()
    got = {"replay_vs_eager_max_abs_err": (out - eager).abs().max().item(),
           "replay_moved": (out - first).abs().max().item()}
    try:
        capture_step(lambda: step(True))
        got["host_read_capture"] = "captured"
    except RuntimeError as e:
        cause = e
        while cause.__context__ is not None:  # the capture's end fails after the read
            cause = cause.__context__
        got["host_read_capture"] = (f"raised {type(e).__name__}, first "
                                    f"{type(cause).__name__}: {str(cause).splitlines()[0][:200]}")
    return got


def phase_analysis_and_cploadgen():
    """Phase 57: the port's static analysis and its control-plane saturation
    harness on the card's machine.  ``python -m polyaxon_tpu_torch.analysis
    --format json`` lints the port's package in a subprocess (its state in a
    temporary directory): rc 0, no unsuppressed finding, every suppression
    with a reason, and ``checks/health.py:check_static_analysis`` healthy from
    that state.  Beside it, in a child of this script (this process's CUDA
    context is never put at risk), GL001's bug class: a step with a host read
    must fail to capture, the same step without it must capture, replay and
    match its eager result.  Then, in a process of its own that loads no
    torch, ``monitor/cploadgen.py`` over the port's control plane with
    bench.py's arguments: ``run_saturation``, ``run_scrape_overhead``,
    ``measure_idle_tick_us``; the phase fails on a monitor, API, query or
    scrape error, no alert, no ingest-lag sample or no report byte ingested,
    and reports bench.py's budgets as ``_ok`` flags.  No kernel launches in
    this process."""
    from polyaxon_tpu_torch.checks.health import check_static_analysis

    t_phase = time.perf_counter()
    launches = _counts()
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_analysis_"))
    root = Path(__file__).resolve().parent
    state = base / "lint_state.json"
    env = dict(os.environ, POLYAXON_TPU_LINT_STATE=str(state), PYTHONPATH=os.pathsep.join(
        [str(root), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    lint = subprocess.Popen([sys.executable, "-m", "polyaxon_tpu_torch.analysis", "--format",
                             "json", "--show-suppressed"], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    probe = subprocess.Popen([sys.executable, str(root / "chip_smoke.py"), CAPTURE_PROBE],
                             cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    lint_out, lint_err = lint.communicate(timeout=300)
    lint_s = time.perf_counter() - t0
    probe_out, probe_err = probe.communicate(timeout=300)
    if lint.returncode != 0 or not lint_out:
        raise AssertionError(f"the lint exited {lint.returncode}: {lint_out[-4000:]}"
                             f"{lint_err[-4000:]}")
    report = json.loads(lint_out)
    unjustified = [f for f in report["findings"] if f["suppressed"] and not f["suppress_reason"]]
    with _environ(POLYAXON_TPU_LINT_STATE=str(state)):
        health = check_static_analysis(None)
    out = {"lint": {"rc": lint.returncode, "wall_s": lint_s, "summary": report["summary"],
                    "suppressed": [f"{f['path']}:{f['line']} {f['rule']} -- "
                                   f"{f['suppress_reason']}" for f in report["findings"]],
                    "health": list(health)}}
    if report["summary"]["unsuppressed"] or unjustified or not health[0] \
            or not health[1].startswith("clean"):
        raise AssertionError(f"the lint of the port: {out['lint']}")
    if probe.returncode != 0:
        raise AssertionError(f"the capture probe exited {probe.returncode}: "
                             f"{probe_out[-4000:]}{probe_err[-4000:]}")
    out["capture_probe"] = json.loads(probe_out.strip().splitlines()[-1])
    cap = out["capture_probe"]
    if not (cap["host_read_capture"].startswith("raised")
            and cap["replay_vs_eager_max_abs_err"] <= CAPTURE_PROBE_ATOL
            and cap["replay_moved"] > 0.0):
        raise AssertionError(f"the capture probe: {cap}")
    code = ("import json, sys, tempfile\n"
            "from polyaxon_tpu_torch.monitor.cploadgen import (measure_idle_tick_us,\n"
            "    run_saturation, run_scrape_overhead)\n"
            f"out = {{'saturation': run_saturation(tempfile.mkdtemp(dir={str(base)!r}), "
            f"**{CP_SATURATION!r}),\n"
            f"       'scrape': run_scrape_overhead(tempfile.mkdtemp(dir={str(base)!r}), "
            f"**{CP_SCRAPE!r}),\n"
            f"       'idle_tick_us': measure_idle_tick_us(tempfile.mkdtemp(dir={str(base)!r}), "
            f"iters={CP_IDLE_ITERS})}}\n"
            "out['torch_loaded'] = 'torch' in sys.modules\n"
            "print(json.dumps(out))\n")
    t0 = time.perf_counter()
    harness = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                             capture_output=True, text=True, timeout=300)
    harness_s = time.perf_counter() - t0
    if harness.returncode != 0:
        raise AssertionError(f"the saturation harness exited {harness.returncode}: "
                             f"{harness.stderr[-4000:]}")
    got = json.loads(harness.stdout.strip().splitlines()[-1])
    sat, scrape = got["saturation"], got["scrape"]
    out.update(saturation=sat, scrape=scrape, idle_tick_us=got["idle_tick_us"],
               harness_wall_s=harness_s, harness_loaded_torch=got["torch_loaded"])
    figures = {"watcher_ingest_lag_p99_s": sat["watcher_ingest_lag_p99_s"],
               "alert_fire_latency_s": sat["alert_fire_latency_s"],
               "api_p99_s": sat["api_p99_s"], "scrape_share": scrape["scrape_share"],
               "query_p99_s": scrape["query_p99_s"], "idle_tick_us": got["idle_tick_us"],
               "lint_s": lint_s}
    out["budgets_ok"] = {f"{k}_ok": v is not None and v < CP_BUDGETS[k]
                         for k, v in figures.items()}
    if (sat["monitor_errors"] or sat["api_errors"] or sat["alert_fire_latency_s"] is None
            or not sat["watcher_ingest_lag_samples"] or not sat["report_bytes_ingested"]
            or scrape["query_errors"] or scrape["scrape_errors"] or got["torch_loaded"]):
        raise AssertionError(f"the saturation harness on the port's control plane: {out}")
    if _counts() != launches:
        raise AssertionError(f"phase 57 launched flash kernels: {launches} -> {_counts()}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"analysis: lint {report['summary']['unsuppressed']} finding(s), "
        f"{report['summary']['suppressed']} suppressed, {lint_s:.2f} s; health {health}; "
        f"capture probe {cap}; saturation {sat}; scrape {scrape}; idle tick "
        f"{got['idle_tick_us']:.1f} us; budgets {out['budgets_ok']}; phase {out['phase_s']:.1f} s")
    shutil.rmtree(base, ignore_errors=True)
    return out


def _width_lm_train(label, model, steps, profile=False, kernels=KERNEL_NAMES, **params):
    """:func:`_lm_train` on ``model`` at TRAIN_BATCH x TRAIN_SEQ, with a
    profiler window on the last step if ``profile``, whose trace must name
    each of ``kernels`` once a layer.  Returns the launches and the run's
    figures."""
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_widths_"))
    if profile:
        params.update(profile_start=steps - 1, profile_steps=1)
    _fresh_step_walls()
    try:
        launches, first, final = _lm_train(label, TRAIN_SEQ, TRAIN_BATCH, steps, model=model,
                                           outputs_path=str(out_dir), **params)
        in_trace = None
        if profile:
            (trace,) = (out_dir / "profile").glob("*.pt.trace.json")
            in_trace = kernel_launches_in_trace(trace, kernels)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    n = model["n_layers"]
    if in_trace and tuple(in_trace[k] for k in kernels) != (n, n, n):
        raise AssertionError(f"{label}: the profiled step names {in_trace}; expected {n} each")
    return launches, {
        "loss": final["losses"],
        "tokens_per_s": final["tokens_per_s"], "mfu": _mfu(final["tokens_per_s"], TRAIN_SEQ, model),
        "first_step_s": final["first_step_s"], "step_wall_s_p50": final["step_wall_s_p50"],
        "peak_memory_allocated": final["peak_memory_allocated"], "launches": launches,
        "launches_in_profiled_step": in_trace}


def _sdpa_backend(q4, k4, v4, causal, scale) -> str:
    """The backend SDPA takes for these inputs (torch's own dispatch
    choice, ``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend

    choice = torch._fused_sdp_choice(q4, k4, v4, attn_mask=None, dropout_p=0.0,
                                     is_causal=causal, scale=scale)
    return SDPBackend(choice).name


def _huge_kernels():
    """The three kernels past 256 against their plain versions at every d of
    HUGE_DIMS, bf16 and float32, causal with one row past a tile edge (a
    ragged T) and full with Tq != Tk; then timed at the training shape at
    d 512 beside their plain versions, SDPA and their bounds, and the bf16
    forward's and dk/dv's launches logged at d 512 and 1024.  Returns the
    largest errors by kernel and the timed records under
    ``d512_h4_t1024``."""
    from polyaxon_tpu_torch.parallel import flash

    worst = {"fwd": 0.0, "lse": 0.0, "dq": 0.0, "dkv": 0.0}
    for dt in (torch.bfloat16, torch.float32):
        for BH, Tq, Tk, causal in ((8, 129, 129, True), (8, 300, 200, False)):
            for d in HUGE_DIMS:
                g = torch.Generator(device="cuda").manual_seed(BH + Tq + d)
                q, k, v = (torch.randn(BH, t, d, generator=g, device="cuda").to(dt)
                           for t in (Tq, Tk, Tk))
                o, lse = flash.flash_block_fwd(q, k, v, causal=causal, sm_scale=d**-0.5)
                ro, rlse = flash.flash_block_fwd_reference(q, k, v, causal=causal,
                                                           sm_scale=d**-0.5)
                o_err, lse_err = (o - ro).abs().max().item(), (lse - rlse).abs().max().item()
                if o_err > O_ATOL or lse_err > LSE_ATOL or not bool(torch.isfinite(o).all()):
                    raise AssertionError(f"wide flash_fwd at d {d} {dt} causal={causal}: o err "
                                         f"{o_err}, lse err {lse_err}")
                worst["fwd"], worst["lse"] = max(worst["fwd"], o_err), max(worst["lse"], lse_err)
                del q, k, v, o, lse, ro, rlse
                _, _, errs = _bwd_case(BH, Tq, Tk, d, dt, causal)
                worst["dq"], worst["dkv"] = max(worst["dq"], errs[0]), max(worst["dkv"], *errs[1:])
    log(f"wide kernels at d {HUGE_DIMS}, bf16 and float32, causal and full: largest errors "
        f"{worst}")
    H, d = HUGE_TRAIN_SHAPE
    args, kw, errs = _bwd_case(TRAIN_BATCH * H, TRAIN_SEQ, TRAIN_SEQ, d, torch.bfloat16, True)
    label = f"training shape, {H} heads x {d}"
    times = _train_shape_times(label, args, kw, errs, TRAIN_BATCH)
    for at in (d, 1024):  # past 512 the column blocks come back
        _log_wide_launches(TRAIN_BATCH * H, TRAIN_SEQ, at)
    q4, k4, v4 = (x.view(TRAIN_BATCH, H, TRAIN_SEQ, d) for x in args[:3])
    backend = _sdpa_backend(q4, k4, v4, True, kw["sm_scale"])
    log(f"  {label}: SDPA takes its {backend} backend")
    for rec in times.values():
        rec["library"] = f"scaled_dot_product_attention, {backend} backend"
    del args, q4, k4, v4
    _free()
    return worst, {f"d{d}_h{H}_t{TRAIN_SEQ}": times}


def _log_wide_launches(BH, T, d):
    """Logs the bf16 wide forward's and dk/dv kernel's launches at (BH, T, d)
    as their launchers make them (``flash_fwd_wide_bf16_shape``,
    ``flash_bwd_dkv_wide_bf16_shape`` read the launchers' own helper): grid,
    threads a block, dynamic shared memory and registers a thread."""
    import ctypes

    from polyaxon_tpu_torch import _build

    for lib, kernel in (("flash_fwd", "flash_fwd_wide_bf16_kernel"),
                        ("flash_bwd", "flash_bwd_dkv_wide_bf16_kernel")):
        fn = getattr(_build.load(lib), kernel.replace("_kernel", "_shape"))
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        got = (ctypes.c_int * 6)()
        rc = fn(BH, T, d, got)
        if rc:
            raise AssertionError(f"{kernel}: launch shape at d {d}: CUDA error {rc}")
        log(f"  {kernel} at BH {BH}, T {T}, d {d}: grid {list(got[:3])}, "
            f"{got[3]} threads, {got[4]} B of shared memory, {got[5]} registers")


def _width_model_runs(key, model, kernels, launches, out):
    """lm_train and lm_generate on ``model`` (the 671M trunk with its
    attention recut): one dense step, then TRAIN_STEPS through the kernels
    with a profiled last step; the first loss against dense attention;
    lm_generate's launches; the prefill logits against dense attention.
    Fills ``launches`` and ``out`` under ``lm_train_<key>`` and
    ``lm_generate_<key>``."""
    from polyaxon_tpu_torch.builtins.trainers import lm_generate
    from polyaxon_tpu_torch.tracking.context import Context

    n, shape = model["n_layers"], f"{model['n_heads']} heads x {model['head_dim']}"
    _, dense = _width_lm_train(f"lm_train 671M trunk, {shape}, 1 KV head, attention_impl "
                               "dense, one step", model, 1, attention_impl="dense")
    launches[f"lm_train_{key}"], out[f"lm_train_{key}"] = _width_lm_train(
        f"lm_train 671M trunk, {shape}, 1 KV head", model, TRAIN_STEPS, profile=True,
        kernels=kernels)
    first, first_dense = out[f"lm_train_{key}"]["loss"][0], dense["loss"][0]
    rel = abs(first - first_dense) / abs(first_dense)
    out[f"first_loss_vs_dense_{key}"] = {
        "flash": first, "dense": first_dense, "rel_diff": rel,
        "dense_tokens_per_s": dense["tokens_per_s"],
        "dense_peak_memory_allocated": dense["peak_memory_allocated"]}
    log(f"{shape} first loss: kernels {first}, dense {first_dense}, rel diff {rel:.3e} "
        f"(<= {WIDE_LOSS_RTOL})")
    if rel > WIDE_LOSS_RTOL:
        raise AssertionError(f"the {shape} model's first loss through the kernels disagrees "
                             "with dense attention")

    records = []
    ctx = Context(params=dict(model, seq=1024, batch=BATCH, prompt_len=PROMPT,
                              max_new_tokens=WIDE_NEW, temperature=0.0, device="cuda"),
                  seed=SEED, records=records)
    _free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tokens = lm_generate(ctx)
    torch.cuda.synchronize()
    launches[f"lm_generate_{key}"] = _counts()
    metrics = next(r["values"] for r in records if r["kind"] == "metric")
    want = (4 * n, 0, 0)  # four prefills (two generate calls, two timed prefills)
    if launches[f"lm_generate_{key}"] != want or tuple(tokens.shape) != (BATCH, WIDE_NEW):
        raise AssertionError(f"lm_generate {shape}: launches {launches[f'lm_generate_{key}']} "
                             f"(expected {want}), tokens {tuple(tokens.shape)}")
    out[f"lm_generate_{key}"] = {
        "prefill_s": metrics["prefill_s"], "decode_tokens_per_s": metrics["decode_tokens_per_s"],
        "peak_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches[f"lm_generate_{key}"]}
    log(f"lm_generate 671M trunk, {shape}, 1 KV head: {out[f'lm_generate_{key}']}")
    del tokens
    phase_prefill_parity(model)
    _free()


def phase_head_widths():
    """Phase 58: lm_train and lm_generate with Gemma-2B's attention on the
    671M trunk (WIDE_MODEL: 8 heads x 256, one KV head), their first loss
    and prefill logits against dense attention; the wide kernels past 256
    against their plain versions and timed at the training shape at d 512
    (``_huge_kernels``); the same two entry points at 4 heads x 512
    (HUGE_MODEL); then lm_train at Phi-3-mini's 32 heads x 96
    (PHI3_MODEL).  The attention op and the dense run go first: they warm
    the process (the op's first call, CUDA, cuBLAS, the allocator) for the
    kernels' runs.  Returns the launches by path and the figures."""
    from polyaxon_tpu_torch.parallel import flash

    t0 = time.perf_counter()
    launches, out = {}, {"card": _card()}
    # The attention op's first call with autograd in a process takes 7-9 s
    # of torch's own lazy imports (tools/flash_first_call.py); paid here, it
    # stays out of the timed runs' first steps, as in the script's process.
    x = torch.randn(1, 128, 8, 256, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    flash.flash_attention(x, x, x, 256**-0.5, device=x.device).float().sum().backward()
    torch.cuda.synchronize()
    _width_model_runs("d256_kv1", WIDE_MODEL, KERNEL_NAMES, launches, out)
    out["first_loss_vs_dense"] = out.pop("first_loss_vs_dense_d256_kv1")
    out["wide_kernel_errors"], out["huge_train_shape"] = _huge_kernels()
    _width_model_runs("d512_kv1", HUGE_MODEL, WIDE_KERNEL_NAMES, launches, out)

    launches["lm_train_d96"], out["lm_train_d96_2_layers"] = _width_lm_train(
        "lm_train 671M trunk at 2 layers, 32 heads x 96", PHI3_MODEL, PHI3_STEPS)
    out["wall_s"] = time.perf_counter() - t0
    return launches, out


def _start_child(flag, *args):
    """This script in a child process with ``flag`` and ``args``, started,
    its output going to files (a full pipe would stall it).  Phase 58's
    child (``HEAD_WIDTHS_ONLY``): late in this process a profiled lm_train
    step's trace once held 7 of its 8 forward kernels while the wrapper
    counted 8 (a record the profiler lost: the run's loss was bit for bit
    that of a run whose trace held all 8); in a process of its own every
    profiled step named every launch.  It runs while this process runs
    phase 57, which takes the host and not the card.  The control lanes'
    children (``CONTROL_LANE``) run beside phases 49-51 and 54."""
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_child_"))
    files = (open(out / "stdout", "w+"), open(out / "stderr", "w+"))
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), flag, *args],
                            stdout=files[0], stderr=files[1], text=True)
    return proc, files, out


def _kill_child(started) -> None:
    """Stop a child of ``_start_child`` that still runs: SIGTERM, on which
    it unwinds and its atexit hooks stop the gangs, replicas and servers it
    started (``_exit_on_term``), then SIGKILL if it has not ended in 60 s."""
    proc = started[0]
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _exit_on_term(signum, frame):
    """A child's SIGTERM handler: exit through SystemExit, so that ``finally``
    blocks and atexit hooks run."""
    sys.exit(128 + signum)


def _child_result(started, what):
    """A child of ``_start_child`` waited for: its output logged, the JSON
    of its last line returned; raises naming ``what`` if it failed."""
    proc, files, out = started
    try:
        proc.wait(timeout=900)
    finally:
        _kill_child(started)
    stdout, stderr = ((f.seek(0), f.read())[1] for f in files)
    for f in files:
        f.close()
    shutil.rmtree(out, ignore_errors=True)
    log(stdout.rstrip())
    if proc.returncode:
        raise AssertionError(f"{what} failed (rc {proc.returncode}):\n{stderr[-4000:]}")
    return json.loads(stdout.strip().splitlines()[-1])


def _control_lane(name):
    """A child's lane of CONTROL_LANES, its phases in order: ``{phase:
    [what the phase returned, its wall s]}``."""
    phases = {"52": phase_remediated_preemption, "53": phase_control_plane_fleet,
              "55": phase_pipeline, "56": phase_surfaces}
    out = {}
    for phase in CONTROL_LANES[name]:
        t = time.perf_counter()
        result = phases[phase]()
        out[phase] = [result, time.perf_counter() - t]
        _free()
    return out


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
    if sys.argv[1:] == [HEAD_WIDTHS_ONLY]:  # phase 58's child (_start_child)
        signal.signal(signal.SIGTERM, _exit_on_term)
        print(json.dumps(phase_head_widths()), flush=True)
        return 0
    if sys.argv[1:2] == [CONTROL_LANE] and len(sys.argv) == 3:  # a lane's child (_start_child)
        signal.signal(signal.SIGTERM, _exit_on_term)
        print(json.dumps(_control_lane(sys.argv[2])), flush=True)
        return 0
    if sys.argv[1:2] == [SHARDED_RANK]:  # a child of _run_rank_processes
        return _sharded_rank_main(*sys.argv[2:])
    if sys.argv[1:] == [CAPTURE_PROBE]:  # the child of phase_analysis_and_cploadgen
        print(json.dumps(_capture_probe()), flush=True)
        os._exit(0)  # no teardown of a context whose last capture failed
    t0 = time.perf_counter()
    phase_s = {}
    last = [t0]

    def mark(phases: str) -> None:
        """Free the card and file the wall since the last mark under ``phases``."""
        _free()
        now = time.perf_counter()
        phase_s[phases], last[0] = now - last[0], now

    smi = phase_device()
    build = phase_build()
    fwd = phase_kernels()
    bwd = phase_bwd_kernels()
    phase_small_model()
    phase_small_model_grads()
    phase_small_model_grads_bf16()
    gen_launches, gen_metrics = phase_main_path()
    static_decode = phase_profile(*phase_prefill_parity())
    mark("1-8 kernels, small models, lm_generate")
    train_launches, first, train_ledger = phase_train()
    tracking = {"train_ledger": train_ledger}
    tracking["overhead"] = phase_tracking_overhead()
    mark("7 lm_train, tracking overhead")
    tracking["watchdog"] = phase_watchdog()
    mark("7 watchdog")
    tracking["dataset_path"] = phase_dataset_path()
    mark("7 dataset path")
    tracking["graph_debug_dump"] = _graph_debug_dump()
    mark("graph debug dump")
    phase_bench_config(first)
    mark("bench.py config")
    phase_profile_train()
    mark("8 profiled train step")
    phase_engine_small()
    mark("9 engine, small models")
    paged_profile = phase_profile_paged(*phase_paged_parity())
    mark("10, 12 paged steps")
    server_launches, server = phase_lm_server()
    tracking["serving_ledger"] = server["ledger"]
    mark("11 lm_server")
    long_kernels = phase_long_kernels()
    mark("13 long kernels")
    long_launches, long_train = phase_long_train()
    mark("14 lm_train T 8192")
    ring_launches, ring_train = phase_ring_train()
    mark("15 sp_ring T 16384")
    phase_ring_threads()
    mark("16 ring hops on threads")
    ckpt_launches, ckpt = phase_checkpoint()
    mark("17 checkpoint, preemption, restore")
    _reset_counts()
    compiled = {"graph_family": phase_graph_family()}
    mark("18 graph family")
    compiled["generate"] = phase_generate_graph()
    mark("19 captured generate")
    compiled["paged_decode_step"] = phase_profile_graph_step()
    mark("20 profiled graph step")
    compiled["loaded_arm"] = phase_loaded_arm()
    mark("21 loaded arm")
    tiers = {"kv_offload": phase_kv_offload(compiled["loaded_arm"]["eager"]["offered_rps"])}
    mark("22 KV offload")
    tiers["warm_boot"] = phase_warm_boot()
    mark("23 warm boot")
    tiers["tracing"] = _tracing_in_a_process_of_its_own()
    torch.cuda.synchronize()
    if _counts() != (4 * BENCH_MODEL["n_layers"], 0, 0):  # the two generate prefills, twice
        raise AssertionError(f"the compiled decode paths and the KV tiers launched flash "
                             f"kernels {_counts()}")
    mark("24 tracing")
    fleet = phase_fleet()
    mark("25-26 fleet")
    fleet["autoscale_chaos"] = phase_autoscale_chaos()
    torch.cuda.synchronize()
    if _counts() != (4 * BENCH_MODEL["n_layers"], 0, 0):  # the fleet's in-process engine: none
        raise AssertionError(f"the fleet phases launched flash kernels {_counts()}")
    mark("27 autoscale chaos")
    gang_launches, gang = phase_gang_train(
        {k: tracking["train_ledger"][k] for k in ("tokens_per_s", "first_step_s",
                                                  "step_wall_s_p50")})
    gang["lm_server"] = phase_gang_server()
    mark("28-29 gangs")
    gang["train_step_ranks"] = phase_train_step_ranks()
    ranks_launches = gang["train_step_ranks"]["bf16, the 671M width with 2 layers"]["launches"]
    mark("30 thread ranks")
    images = {"cnn_train": phase_cnn_train()}
    mark("31 cnn_train")
    images["vit_train"] = phase_vit_train()
    mark("32 vit_train")
    moe_launches, images["lm_train_moe"] = phase_moe_train()
    mark("33 MoE")
    # The rank processes of phases 34-47 start, and phase 48 (services on
    # the host, no card) runs while they do; this process would only wait.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_rank_cases)
        control = {"services": phase_services()}
        mark("48 services (beside the rank processes)")
        ranks.result()
    mark("34-47 the rank processes (the rest of their run)")
    sharded_launches, sharded = phase_sharded_strategies()
    mark("34-37 sharded strategies")
    pipeline_launches, pipeline = phase_pipeline_and_experts()
    mark("38-41 pipeline and experts")
    rest_launches, rest = phase_rest_of_the_parallel_layer()
    mark("42-46 rest of the parallel layer")
    mesh_launches, mesh_serving = phase_mesh_serving()
    mark("47 mesh serving")
    # Phases 52-53 and 55-56 run in the control lanes' children beside
    # phases 49-51 and 54 here; a failure here stops them.
    lanes = {name: _start_child(CONTROL_LANE, name) for name in CONTROL_LANES}
    try:
        ssh_launches, control["ssh_gang"], ssh_run = phase_ssh_gang()
        mark("49 ssh gang")
        control["state_and_bus"] = phase_state_and_bus(ssh_run)
        mark("50 state and bus")
        orch_launches, control["orchestrator"] = phase_orchestrator_run(
            control["ssh_gang"]["final_loss"]["local"])
        mark("51 orchestrator run")
        search = {}
        sweep_launches, search["sweep"] = phase_sweep(control["orchestrator"]["final_loss"])
        mark("54 sweep")
        lane = {name: _child_result(started, f"the control lane {name} ({', '.join(phases)})")
                for (name, started), phases in zip(lanes.items(), CONTROL_LANES.values())}
    finally:
        for started in lanes.values():
            _kill_child(started)
    mark("52-53, 55-56 (the rest of the control lanes' run)")
    beside_s = {f"{phase} (control lane {name})": wall
                for name, ran in lane.items() for phase, (_, wall) in ran.items()}
    remedy_launches, control["remediated_preemption"] = lane["remedy"]["52"][0]
    search["control_plane_fleet"] = lane["fleet"]["53"][0]
    pipe_launches, search["pipeline"] = lane["remedy"]["55"][0]
    surface_launches, surfaces = lane["fleet"]["56"][0]
    widths_child = _start_child(HEAD_WIDTHS_ONLY)  # phase 58 runs beside phase 57
    try:
        analysis_and_cploadgen = phase_analysis_and_cploadgen()
    except BaseException:
        _kill_child(widths_child)  # the script stops every process it starts
        raise
    mark("57 analysis and cploadgen")
    width_launches, head_widths = _child_result(widths_child, "the head widths phase")
    width_launches = {path: tuple(counts) for path, counts in width_launches.items()}
    beside_s["58 head widths (in a child beside phase 57)"] = head_widths["wall_s"]
    mark("58 head widths (the rest of its child's run)")
    fwd["train_shape"] = bwd["fwd"]
    by_path = {"lm_generate": gen_launches, "lm_train": train_launches,
               "lm_server": server_launches, "lm_train_t8192": long_launches,
               "lm_train_sp_ring_t16384": ring_launches, "lm_train_resumed": ckpt_launches,
               "lm_train_gang": gang_launches, "train_step_2_ranks": ranks_launches,
               "lm_train_moe": moe_launches, **sharded_launches, **pipeline_launches,
               **rest_launches, **mesh_launches,
               "lm_train_ssh_gang": ssh_launches, "lm_train_orchestrator": orch_launches,
               "lm_train_remediated": remedy_launches, "lm_train_sweep": sweep_launches,
               "lm_train_pipeline": pipe_launches["train"],
               "lm_generate_pipeline": pipe_launches["generate"],
               "lm_train_surfaces": surface_launches, **width_launches}
    for i, (kind, record) in enumerate((("fwd", fwd), ("dq", bwd["dq"]), ("dkv", bwd["dkv"]))):
        record["launches_by_path"] = {path: counts[i] for path, counts in by_path.items()}
        record["launches"] = sum(record["launches_by_path"].values())
        record["t8192"] = dict(long_kernels["t8192"][kind],
                               launches_per_step=long_launches[i] / LONG_STEPS)
        record["t16384"] = dict(long_kernels["t16384"][kind],
                                launches_per_step=ring_launches[i] / RING_STEPS)
        record["ulysses_t8192"] = dict(sharded["ulysses_kernels"][kind],
                                       launches_per_step_per_rank=sharded_launches[
                                           "train_step_ulysses"][i] / (2 * STEP_RANKS_STEPS))
        for shape, times in bwd["wide"].items():  # launches: phase 58's training runs
            path = "lm_train_d96" if shape.startswith("d96") else "lm_train_d256_kv1"
            steps = PHI3_STEPS if path == "lm_train_d96" else TRAIN_STEPS
            record[shape] = dict(times[kind], launches_per_step=width_launches[path][i] / steps)
        for shape, times in head_widths["huge_train_shape"].items():  # the wide kernels
            record[shape] = dict(times[kind], launches_per_step=width_launches[
                "lm_train_d512_kv1"][i] / TRAIN_STEPS)
    script_s = time.perf_counter() - t0
    log(f"chip_smoke: all phases passed in {script_s:.1f} s ({1200 - script_s:.1f} s inside "
        "the 1,200 s limit); by phase: "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
        + "; in children beside them: " + ", ".join(f"{k} {v:.1f}" for k, v in beside_s.items()))
    # The serving and long-context figures of this run, on lines of their
    # own so that they stand in the output's tail beside the kernels' record.
    print(json.dumps({"serving": {"lm_generate": gen_metrics, "lm_server": server,
                                  "static_decode_step": static_decode, **paged_profile}}))
    print(json.dumps({"long_context": {"t8192": long_train, "sp_ring_t16384": ring_train}}))
    print(json.dumps({"checkpoint": ckpt}))
    print(json.dumps({"compiled_decode": compiled}))
    print(json.dumps({"kv_tiers_and_tracing": tiers}))
    print(json.dumps({"tracking": tracking}))
    print(json.dumps({"script_s": script_s, "phase_s": phase_s,  # the kernels' build included
                      "beside_s": beside_s}))
    print(smi)
    print(json.dumps({"kernels": [fwd, bwd["dq"], bwd["dkv"]]}))
    print(json.dumps({"kernel_build": build}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"gang": gang}))
    print(json.dumps({"image_classifiers_and_moe": images}))
    print(json.dumps({"sharded_strategies": sharded}))
    print(json.dumps({"pipeline_and_experts": pipeline}))
    print(json.dumps({"rest_of_the_parallel_layer": rest}))
    print(json.dumps({"mesh_serving": mesh_serving}))
    print(json.dumps({"services_transport_state": control}))
    print(json.dumps({"fleet_search_pipelines": search}))
    print(json.dumps({"surfaces": surfaces}))
    print(json.dumps({"analysis_and_cploadgen": analysis_and_cploadgen}))
    print(json.dumps({"head_widths": head_widths}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
