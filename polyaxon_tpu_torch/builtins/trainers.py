"""Built-in entrypoints of the port.

Counterpart of ``polyaxon_tpu/builtins/trainers.py``: the probe entry points
the platform's gang tests drive (``noop``, ``failing``, ``sleepy``,
``flaky_once``, ``stalling``, ``resume_counter``, ``metric_probe``, :33-112
and :667-678 there), ``synthetic_regression`` (the quickstart's job,
:904-958), the image classifiers ``cnn_train`` and ``vit_train`` (:469-563,
over ``_train_image_classifier`` :175-466), ``lm_generate``, and
``lm_train`` (every ported template, on one rank or across a gang's ranks;
dense or switch-MoE); the trainers with checkpoint save, resume, restore
and ``checkpoint-now`` under every template, the fault
injection the platform's preemption tests drive, and the trainers' run
accounting (the utilization ledger, the progress beacon, tracer spans and
step-wall percentiles).  Metrics are logged by the leader (process 0), as
the reference's are.
"""

from __future__ import annotations

import functools
import itertools
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist

from polyaxon_tpu_torch._device import resolve_device
from polyaxon_tpu_torch.models import cnn, decode, vit
from polyaxon_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    loss_fn,
    param_axes,
)
from polyaxon_tpu_torch.parallel.templates import template_for
from polyaxon_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    CheckpointNowService,
    GangCheckpointNowService,
)
from polyaxon_tpu_torch.runtime.data import global_batch_from_host_data
from polyaxon_tpu_torch.runtime.datasets import DatasetReader, synthetic_class_images
from polyaxon_tpu_torch.runtime.mesh import build_mesh
from polyaxon_tpu_torch.runtime.optim import SGD, AdamW
from polyaxon_tpu_torch.runtime.pipeline import MetricsDrain, TrainPipeline
from polyaxon_tpu_torch.runtime.train import build_train_step
from polyaxon_tpu_torch.stats import get_stats
from polyaxon_tpu_torch.tracking.capture import get_capture_agent
from polyaxon_tpu_torch.tracking.context import Context
from polyaxon_tpu_torch.tracking.flightrec import get_progress
from polyaxon_tpu_torch.tracking.ledger import (
    conv_classifier_flops_per_image,
    get_ledger,
    transformer_flops_per_token,
)
from polyaxon_tpu_torch.tracking.profiling import StepClock, StepProfiler
from polyaxon_tpu_torch.tracking.trace import get_tracer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _percentile_metrics(run_stats, key: str, out_prefix: str) -> dict:
    """Histogram percentiles for ``key`` as flat metric fields."""
    summary = run_stats.summaries().get(key)
    if not summary or not summary["count"]:
        return {}
    return {
        f"{out_prefix}_p50": summary["p50"],
        f"{out_prefix}_p95": summary["p95"],
        f"{out_prefix}_p99": summary["p99"],
    }


def _int_params(ctx: Context, names) -> dict:
    return {f: int(ctx.get_param(f)) for f in names if ctx.get_param(f) is not None}


def noop(ctx: Context) -> None:
    """Smallest possible run: report one metric."""
    ctx.log_text("noop trainer running")
    ctx.log_metrics(step=0, done=1.0)


def failing(ctx: Context) -> None:
    """Always fails (failure-path probe)."""
    raise RuntimeError("intentional failure")


def sleepy(ctx: Context) -> None:
    """Sleeps `seconds` (stop/zombie probe)."""
    time.sleep(float(ctx.get_param("seconds", 30.0)))


def flaky_once(ctx: Context) -> None:
    """Fails on the first gang attempt, succeeds after restart.

    Uses a marker file in outputs/ (which survives a gang restart) to
    remember the first attempt.
    """
    marker = ctx.outputs_path / f"attempt_p{ctx.process_id}"
    if not marker.exists():
        marker.write_text("1")
        raise RuntimeError("flaky first attempt")
    ctx.log_metrics(recovered=1.0)


def stalling(ctx: Context) -> None:
    """Beats the progress beacon, then one process goes silent
    (stall/straggler-detection probe).

    Every process beats ``warm_steps`` steps ``beat_interval`` apart, then
    the ``stall_process`` victim (-1 = all of them) sleeps ``stall_s``
    without beating while its peers advance ``peer_steps`` more: a
    gang-wide *stall* (everyone silent, heartbeats fresh) against a
    *straggler* (one host behind the gang median).  ``recover_steps`` > 0
    makes the victim beat again after the sleep (``recover_interval``
    apart): a stall that clears while the gang still runs.
    """
    progress = get_progress()
    warm = int(ctx.get_param("warm_steps", 5))
    interval = float(ctx.get_param("beat_interval", 0.02))
    for i in range(warm):
        progress.beat(step=i)
        time.sleep(interval)
    victim = int(ctx.get_param("stall_process", -1))
    recover = int(ctx.get_param("recover_steps", 0))
    if victim in (-1, ctx.process_id):
        time.sleep(float(ctx.get_param("stall_s", 2.0)))
        recover_interval = float(ctx.get_param("recover_interval", interval))
        for i in range(warm, warm + recover):
            progress.beat(step=i)
            time.sleep(recover_interval)
    else:
        for i in range(warm, warm + int(ctx.get_param("peer_steps", 100))):
            progress.beat(step=i)
            time.sleep(interval)
    ctx.log_metrics(step=warm, done=1.0)


def resume_counter(ctx: Context) -> None:
    """Counts resume attempts via a checkpoint file (artifact-store probe).

    Each attempt reads the counter from checkpoints/ (which clone/resume
    restores), increments it, and reports it; outputs/ gets a marker file
    so output shipping is observable too.
    """
    state = ctx.checkpoints_path / "counter.txt"
    n = int(state.read_text()) if state.exists() else 0
    state.write_text(str(n + 1))
    (ctx.outputs_path / f"attempt_{n + 1}.marker").write_text("ok")
    ctx.log_metrics(step=n + 1, counter=float(n + 1))
    ctx.log_text(f"resume_counter attempt {n + 1}")


def metric_probe(ctx: Context) -> None:
    """Report a deterministic metric of the hyperparams (hpsearch probe).

    score = -(lr - 0.7)^2  (max at lr=0.7); loss = (lr - 0.3)^2 (min at 0.3).
    """
    lr = float(ctx.get_param("lr", 0.0))
    ctx.log_metrics(
        step=int(ctx.get_param("epochs", 1)),
        score=-((lr - 0.7) ** 2),
        loss=(lr - 0.3) ** 2,
    )


def synthetic_regression(ctx: Context) -> None:
    """A real (tiny) distributed training loop: linear regression by SGD.

    Counterpart of the JAX ``synthetic_regression`` (the quickstart's job):
    the same data from ``np.random.default_rng(seed)``, zero-initialized
    weights and plain SGD, so the port logs the same losses.  The batch is
    split over the mesh's data-like axes (``ddp``'s batch axes), each rank
    takes its rows, and the train step sums the ranks' grads
    (``runtime/train.py``).  Params: ``lr``, ``steps``, ``batch``, ``dim``
    and ``device`` (default ``cuda``).
    """
    device = resolve_device(ctx.get_param("device", "cuda"))
    lr = float(ctx.get_param("lr", 0.1))
    steps = int(ctx.get_param("steps", 20))
    batch = int(ctx.get_param("batch", 64))
    dim = int(ctx.get_param("dim", 8))
    seed = ctx.seed if ctx.seed is not None else 0

    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(dim, 1)).astype(np.float32)
    x = rng.normal(size=(batch, dim)).astype(np.float32)
    y = x @ w_true + 0.01 * rng.normal(size=(batch, 1)).astype(np.float32)

    mesh = ctx.mesh if ctx.mesh is not None else build_mesh({"data": 1})

    def loss(params, b):
        return torch.mean((b["x"] @ params["w"] - b["y"]) ** 2)

    ts = build_train_step(
        loss_fn=loss,
        init_fn=lambda g: {"w": torch.zeros((dim, 1), dtype=torch.float32, device=g.device)},
        optimizer=SGD(lr),
        mesh=mesh,
        template=template_for("ddp", dict(mesh.shape)),
    )
    params, opt_state = ts.init(torch.Generator(device=device))
    data = ts.place_batch({"x": torch.from_numpy(x).to(device),
                           "y": torch.from_numpy(y).to(device)})
    metrics = None
    for i in range(steps):
        params, opt_state, metrics = ts.step(params, opt_state, data)
        if ctx.is_leader and (i % 5 == 0 or i == steps - 1):
            ctx.log_metrics(step=i, loss=float(metrics["loss"]))
    ctx.log_text(f"final loss {float(metrics['loss']):.6f}")


def restore_target(ctx: Context, target, params) -> int:
    """Restore run ``target``'s newest complete weights into ``params``'s
    tensors; returns the step.  The run's checkpoints are
    ``<runs root>/<target>/checkpoints``, the runs root being
    ``ctx.runs_root`` or, without one, the dir two above this run's outputs
    (the run layout's ``runs/<uuid>/outputs``).  Raises ``RuntimeError``
    when there is no complete step."""
    runs_root = ctx.runs_root
    if runs_root is None and ctx.outputs_path is not None:
        runs_root = ctx.outputs_path.parent.parent
    if runs_root is None:
        raise ValueError(f"target {target!r} needs the context's runs_root or outputs_path")
    ckpt_dir = runs_root / str(target) / "checkpoints"
    ckpt = CheckpointManager(ckpt_dir)
    try:
        restored = ckpt.restore_params(params)
    finally:
        ckpt.close()
    if restored is None:
        raise RuntimeError(f"No checkpoint under {ckpt_dir}")
    return restored["step"]


def _fault_injection(ctx: Context):
    """Per-step fault injector for the declared chaos params, or None.

    ``preempt_step``/``preempt_process``/``preempt_signal`` kill a worker
    mid-loop with REAL process death (SIGKILL, or SIGTERM then SIGKILL
    after ``preempt_grace_s`` — the preemption-notice shape), once per run:
    an outputs marker survives the restart so the resumed attempt trains
    through.  ``stall_at_step``/``stall_s``/``stall_process`` stall a
    worker mid-loop to trip the stall/straggler detectors against a live
    train loop.
    """
    preempt_step = int(ctx.get_param("preempt_step", -1))
    stall_at = int(ctx.get_param("stall_at_step", -1))
    stall_s = float(ctx.get_param("stall_s", 0.0))
    if preempt_step < 0 and (stall_at < 0 or stall_s <= 0):
        return None
    preempt_process = int(ctx.get_param("preempt_process", 0))
    preempt_signal = str(ctx.get_param("preempt_signal", "kill"))
    preempt_grace_s = float(ctx.get_param("preempt_grace_s", 0.5))
    stall_process = int(ctx.get_param("stall_process", -1))

    def on_step(step: int) -> None:
        if step == stall_at and stall_s > 0 and stall_process in (-1, ctx.process_id):
            ctx.log_text(f"injecting {stall_s:.1f}s stall at step {step}")
            time.sleep(stall_s)
        if step == preempt_step and preempt_process in (-1, ctx.process_id):
            if ctx.outputs_path is not None:
                marker = ctx.outputs_path / f"preempted_p{ctx.process_id}"
                if marker.exists():
                    return
                marker.write_text(str(step))
            ctx.log_text(f"injecting preemption at step {step} (signal={preempt_signal})")
            if preempt_signal == "term":
                os.kill(os.getpid(), signal.SIGTERM)
                time.sleep(max(preempt_grace_s, 0.0))
            os.kill(os.getpid(), signal.SIGKILL)

    return on_step


def _open_checkpoints(ctx: Context, save_every: int, ts, params, opt_state):
    """The run's checkpoint manager, its save hook and the step to start at
    (the reference ``lm_train``'s :752-762 and ``_train_image_classifier``'s
    :250-262): with ``save_every`` > 0 and a checkpoints dir, restore the
    newest complete step there into ``params`` and ``opt_state`` (a resumed
    clone inherits the original's) and start after it.  Every rank
    restores; only the leader keeps the manager and saves.

    A step holds the whole state, the one-rank layout, whatever the
    template.  Under a template that shards the params (``ts.sharded``)
    every rank reads the whole tensors and keeps its shard
    (``TrainStep.load_shards``), as orbax restores onto the target mesh, and
    at each step ``save_every`` divides every rank joins the gathers of the
    whole state (``TrainStep.full_state``) that the leader then saves; so a
    checkpoint moves between one rank and a sharded run either way.
    Returns ``(ckpt or None, save hook or None, params, opt_state,
    start_step)``; the hook is ``save(step, params, opt_state)``."""
    if save_every <= 0 or ctx.checkpoints_path is None:
        return None, None, params, opt_state, 0
    ckpt = CheckpointManager(ctx.checkpoints_path, save_interval_steps=save_every)
    start_step = 0
    if ts.sharded:
        restored = ckpt.restore(*ts.empty_full_state(params, opt_state))
        if restored is not None:
            ts.load_shards((restored["params"], restored["opt_state"]), params, opt_state)
    else:
        restored = ckpt.restore(params, opt_state)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt_state"]
    if restored is not None:
        start_step = restored["step"] + 1
        ctx.log_text(f"restored checkpoint at step {restored['step']}")
    if not ctx.is_leader:
        ckpt.close()
        ckpt = None

    def save(step: int, params, opt_state) -> None:
        if not ts.sharded:
            ckpt.save(step, params, opt_state)  # async; fenced at the loop's end
        elif step % save_every == 0:  # the manager's interval, decided alike on every rank
            full = ts.full_state(params, opt_state)
            if ckpt is not None:
                ckpt.save(step, *full)

    return ckpt, (save if ckpt is not None or ts.sharded else None), params, opt_state, start_step


def _checkpoint_now(ckpt, save, capture, ts):
    """The run's ``checkpoint-now`` service, or None when it keeps no
    checkpoints (no ``save`` hook).  Under a template that shards the params
    a save needs every rank, and every process gets its own copy of the
    command: each process serves its copy through
    ``GangCheckpointNowService``, whose ranks agree at each step's end on
    whether to save (one all-reduce) and then save once together.
    Otherwise the leader's ``CheckpointNowService`` saves alone, as the
    reference's (``polyaxon_tpu/runtime/checkpoint.py:311-360``)."""
    if save is None:
        return None
    if ts.sharded:
        return GangCheckpointNowService(ckpt, capture, ts)
    return None if ckpt is None else CheckpointNowService(ckpt, capture)


def _train_image_classifier(
    ctx: Context,
    *,
    label: str,
    loss_fn,
    accuracy_fn,
    init_fn,
    axes_tree,
    optimizer,
    flops_per_example: float,
    device: torch.device,
) -> None:
    """The image classifiers' shared train loop (``cnn_train``,
    ``vit_train``): the JAX ``_train_image_classifier`` (reference
    :175-466), eager.

    ``loss_fn(params, batch, template, mesh)`` and ``accuracy_fn(params,
    batch, template, mesh)`` take a batch of uint8 NHWC ``images`` and int
    ``labels`` on ``device``; ``axes_tree`` is the model's ``param_axes``.  Params:
    ``steps``, ``batch`` (global), ``image_size``, ``classes``, ``dataset``,
    ``save_every``, ``prefetch``, ``prefetch_workers``, ``profile_start``,
    ``profile_steps`` and the fault injection's (``_fault_injection``).  The
    template comes from ``ctx.strategy`` over ``ctx.mesh`` (default
    ``build_mesh({"data": 1})``): any ported strategy, on one rank or across
    a gang's ranks (the models split what the template splits,
    ``models/vit.py``, ``models/cnn.py``).  Two data paths, one loop:

    - ``dataset: <name>``, a registered dataset (``runtime/datasets.py``):
      each rank reads the rows of its shard of the batch axes of every
      global batch (``DatasetReader(num_processes=, process_id=)``, uint8 on the wire,
      per-epoch shuffles), and a resumed run's stream fast-forwards to its
      restored step, position for position.  With ``prefetch`` > 0 a
      ``TrainPipeline`` gathers rows on ``prefetch_workers`` threads and
      places batches ahead through ``device_prefetch`` (pinned buffers and a
      copy stream on a card); ``prefetch: 0`` gathers inline and places each
      rank's rows with ``global_batch_from_host_data`` (the same stream).
    - no dataset: synthetic class-conditional images from the seed
      (``synthetic_class_images``), one fixed batch every step, each rank on
      its rows (``TrainStep.place_batch``): compute apart from input.

    With ``save_every`` the run saves, resumes and answers ``checkpoint-now``
    as ``lm_train`` does.  Logs ``loss`` at every tenth step and the last,
    then ``accuracy`` (on the last batch, over every rank's rows),
    ``images_per_s`` (the global batch), ``first_step_s`` (the first step's
    wall, synchronized, kernel loading included), the ``StepClock`` means
    (``data_wait_s`` among them) and ``step_wall_s_p50/p95/p99``; the leader
    logs the final line.  The ledger is fed as ``lm_train`` feeds it (this
    rank's images as its tokens, the last step's wall running to the end of
    the loop's synchronize), with each step's data wait in ``data_wait_s``.
    No counterpart, as in ``lm_train``: ``aot_compile_s`` (an eager step
    compiles nothing ahead) and ``_should_measure_flops`` (no XLA cost
    analysis): the FLOPs are the caller's analytic ``flops_per_example``.
    """
    led = get_ledger().start(source="train", device=device)
    steps = int(ctx.get_param("steps", 20))
    batch_size = int(ctx.get_param("batch", 64))
    image_size = int(ctx.get_param("image_size", 32))
    n_classes = int(ctx.get_param("classes", 10))
    dataset = ctx.get_param("dataset")
    save_every = int(ctx.get_param("save_every", 0))
    prefetch = int(ctx.get_param("prefetch", 2))
    prefetch_workers = int(ctx.get_param("prefetch_workers", 2))
    seed = ctx.seed or 0

    mesh = ctx.mesh if ctx.mesh is not None else build_mesh({"data": 1})
    template = template_for(ctx.strategy, dict(mesh.shape), ctx.strategy_options)
    ts = build_train_step(loss_fn=lambda p, b: loss_fn(p, b, template, mesh), init_fn=init_fn,
                          optimizer=optimizer, mesh=mesh, template=template, axes_tree=axes_tree)
    params, opt_state = ts.init(torch.Generator(device=device).manual_seed(seed))
    ckpt, save, params, opt_state, start_step = _open_checkpoints(
        ctx, save_every, ts, params, opt_state)
    shard, ranks = mesh.shard(template.batch_axes)
    local_rows = batch_size // ranks

    if dataset is not None:
        # Each rank reads the rows of its shard of the batch axes: ranks that
        # differ only on another axis (tensor, pipeline, sequence, expert)
        # read the same rows, as place_batch would give them.
        reader = DatasetReader(ctx.data_path, str(dataset), global_batch=batch_size, seed=seed,
                               num_processes=ranks, process_id=shard)
        place = device if prefetch > 0 else functools.partial(
            global_batch_from_host_data, device=device, num_processes=ranks)
        pipe = TrainPipeline(reader.batch_tasks(start_step), place, prefetch=prefetch,
                             workers=prefetch_workers)
    else:
        images, labels = synthetic_class_images(np.random.default_rng(seed), batch_size,
                                                image_size, n_classes)
        fixed = ts.place_batch({"images": torch.from_numpy(images).to(device),
                                "labels": torch.from_numpy(labels).to(device)})
        pipe = TrainPipeline(itertools.repeat(fixed), prefetch=0, tasks=False)

    profiler = StepProfiler(
        ctx.outputs_path or ".",
        start_step=int(ctx.get_param("profile_start", -1)),
        num_steps=int(ctx.get_param("profile_steps", 0)),
    )
    capture = get_capture_agent()
    ckpt_now = _checkpoint_now(ckpt, save, capture, ts)
    inject = _fault_injection(ctx)
    drain = MetricsDrain(lambda step, vals: ctx.log_metrics(step=step, **vals))
    clock = StepClock()
    tracer = get_tracer()
    run_stats = get_stats()
    progress = get_progress()
    # This rank's share of the global step's FLOPs, as lm_train counts it.
    led.set_flops_per_step(flops_per_example * batch_size / mesh.size)
    metrics = batch = first_step_s = last_dt = None
    data_wait_accounted = 0.0
    t0 = time.perf_counter()
    clock.start()
    led.mark_loop_start()
    try:
        with tracer.span("train.loop", steps=steps - start_step):
            for i in range(start_step, steps):
                profiler.on_step(i)
                capture.on_step(i)
                if inject is not None:
                    inject(i)
                with tracer.span("train.step", sample=tracer.hot_sample, step=i):
                    batch = next(pipe)
                    params, opt_state, metrics = ts.step(params, opt_state, batch)
                if ctx.is_leader and (i % 10 == 0 or i == steps - 1):
                    drain.push(i, {"loss": metrics["loss"]})
                if save is not None:
                    save(i, params, opt_state)
                if ckpt_now is not None:
                    ckpt_now.maybe_save(i, params, opt_state)
                if i == start_step:
                    _sync(device)  # the cold-start metric is the first step's full time
                    first_step_s = step_dt = clock.tick()
                else:
                    step_dt = clock.tick()
                ticked = time.perf_counter()
                dwait = pipe.pop_data_wait_s()
                run_stats.timing("train.data_wait_s", dwait)
                led.account("data_wait_s", dwait)
                data_wait_accounted += dwait
                if i < steps - 1:
                    run_stats.timing("train.step_wall_s", step_dt)
                    led.step(step_dt, tokens=local_rows)
                    led.maybe_flush()
                else:
                    last_dt = step_dt
                progress.beat(step=i)
            _sync(device)
            dt = time.perf_counter() - t0
        if last_dt is not None:
            # The steps still queued on the card when the host left the loop
            # finish inside the synchronize: the last step's wall runs to its end.
            last_dt += time.perf_counter() - ticked
            run_stats.timing("train.step_wall_s", last_dt)
            led.step(last_dt, tokens=local_rows)
    finally:
        profiler.close()
        pipe.close()
        drain.close()
        if ckpt is not None:
            ckpt.wait_until_finished()
            ckpt.close()
    led.account("data_wait_s", max(0.0, pipe.data_wait_s - data_wait_accounted))
    if ckpt is not None:
        led.account("ckpt_block_s", ckpt.save_block_s)
    led.account("metric_drain_s", drain.close_wait_s)
    led.flush(final=True)
    steps_run = steps - start_step
    if steps_run <= 0 or batch is None:
        if ctx.is_leader:
            ctx.log_text(f"{label}: nothing to do (checkpoint already at end)")
        return
    with torch.no_grad():
        acc = accuracy_fn(params, batch, template, mesh)
    if mesh.size > 1:  # every rank holds as many rows: the mean of the ranks' shares
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=mesh.world)
        acc = acc / mesh.size
    acc = float(acc)
    if not ctx.is_leader:
        return
    ips = steps_run * batch_size / dt
    clock.add("data_wait_s", pipe.data_wait_s)
    if ckpt is not None:
        clock.add("ckpt_block_s", ckpt.save_block_s)
        run_stats.timing("train.ckpt_block_s", ckpt.save_block_s)
    stats = clock.summary()
    stats.update(_percentile_metrics(run_stats, "train.step_wall_s", "step_wall_s"))
    ctx.log_metrics(step=steps, accuracy=acc, images_per_s=ips, first_step_s=first_step_s,
                    **stats)
    ctx.log_text(
        f"{label} done: {steps} steps, strategy={template.name}, "
        f"loss {float(metrics['loss']):.4f}, acc {acc:.3f}, {ips:.0f} img/s "
        f"(data wait {pipe.data_wait_s * 1e3 / steps_run:.1f} ms/step, "
        f"prefetch={'off' if prefetch <= 0 else prefetch})"
    )


def cnn_train(ctx: Context) -> None:
    """Train the CNN image classifier (the CIFAR-10 quick-start shape).

    Counterpart of the JAX ``cnn_train`` (reference :469-511).  Params:
    ``steps``, ``batch`` (global), ``image_size``, ``classes``, ``lr``,
    ``channels``, ``dataset``, ``save_every`` and ``device`` (default
    ``cuda``; ``cpu`` only when asked); the data and checkpoint contracts
    are :func:`_train_image_classifier`'s.  uint8 images ride to the device
    and are normalized there in the compute dtype (``images / 255 - 0.5``,
    as the reference's trainer does); ``AdamW(lr)`` with a float32 first
    moment.
    """
    device = resolve_device(ctx.get_param("device", "cuda"))
    cfg = cnn.CNNConfig(
        image_size=int(ctx.get_param("image_size", 32)),
        n_classes=int(ctx.get_param("classes", 10)),
        channels=tuple(int(c) for c in ctx.get_param("channels", (64, 128, 256))),
    )

    def normalized(fn):
        def wrapped(p, b, template, mesh):
            images = b["images"].to(cfg.dtype) / 255.0 - 0.5
            return fn(p, {**b, "images": images}, cfg, template, mesh, device=device)

        return wrapped

    _train_image_classifier(
        ctx,
        label="cnn_train",
        loss_fn=normalized(cnn.loss_fn),
        accuracy_fn=normalized(cnn.accuracy),
        init_fn=lambda g: cnn.init_params(cfg, g),
        axes_tree=cnn.param_axes(cfg),
        optimizer=AdamW(float(ctx.get_param("lr", 1e-3))),
        flops_per_example=conv_classifier_flops_per_image(
            cfg.image_size, cfg.in_channels, cfg.channels, cfg.dense_dim, cfg.n_classes),
        device=device,
    )


def vit_train(ctx: Context) -> None:
    """Train the Vision Transformer image classifier.

    Counterpart of the JAX ``vit_train`` (reference :514-563).  Params:
    ``steps``, ``batch``, ``image_size``, ``patch_size``, ``classes``,
    ``lr``, ``d_model``, ``n_layers``, ``n_heads``, ``head_dim``, ``d_ff``,
    ``dataset``, ``save_every`` and ``device`` (default ``cuda``); the data
    and checkpoint contracts are :func:`_train_image_classifier`'s.
    ``AdamW(lr)`` keeps its first moment in bf16, as the reference's optax
    ``adamw(mu_dtype=bfloat16)``.  FLOPs: an image is a ``num_patches``-token
    sequence (``transformer_flops_per_token``).
    """
    device = resolve_device(ctx.get_param("device", "cuda"))
    d_model = int(ctx.get_param("d_model", 192))
    n_heads = int(ctx.get_param("n_heads", 6))
    cfg = vit.ViTConfig(
        image_size=int(ctx.get_param("image_size", 32)),
        patch_size=int(ctx.get_param("patch_size", 4)),
        n_classes=int(ctx.get_param("classes", 10)),
        d_model=d_model,
        n_layers=int(ctx.get_param("n_layers", 6)),
        n_heads=n_heads,
        head_dim=int(ctx.get_param("head_dim", max(8, d_model // n_heads))),
        d_ff=int(ctx.get_param("d_ff", 4 * d_model)),
    )
    _train_image_classifier(
        ctx,
        label="vit_train",
        loss_fn=lambda p, b, template, mesh: vit.loss_fn(p, b, cfg, template, mesh,
                                                         device=device),
        accuracy_fn=lambda p, b, template, mesh: vit.accuracy(p, b, cfg, template, mesh,
                                                              device=device),
        init_fn=lambda g: vit.init_params(cfg, g),
        axes_tree=vit.param_axes(cfg),
        optimizer=AdamW(float(ctx.get_param("lr", 1e-3)), mu_dtype=torch.bfloat16),
        flops_per_example=transformer_flops_per_token(
            cfg.n_params, cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.num_patches)
        * cfg.num_patches,
        device=device,
    )


def lm_generate(ctx: Context) -> torch.Tensor:
    """Autoregressive generation from the flagship LM (the serving story).

    Params: ``target`` (the uuid of a run whose newest complete checkpoint
    gives the weights, typically an ``lm_train`` run with ``save_every``;
    omitted = random weights from ``ctx.seed``), ``prompt_len``,
    ``max_new_tokens``, ``batch``, ``temperature``, ``quantize`` (``int8``),
    ``seq`` (max_seq), the model-shape params of ``lm_train`` (matching the
    checkpointed config when ``target`` is set), and ``device`` (default
    ``cuda``; ``cpu`` only when asked).  Reports ``decode_tokens_per_s``,
    ``prefill_s`` and ``generated``, and returns the tokens of the timed
    ``generate`` call, [batch, max_new_tokens].
    """
    device = resolve_device(ctx.get_param("device", "cuda"))
    seq = int(ctx.get_param("seq", 256))
    cfg = TransformerConfig(max_seq=seq, **_int_params(ctx, (
        "vocab_size", "d_model", "n_layers", "n_heads",
        "head_dim", "d_ff", "n_kv_heads", "n_experts",
    )))
    batch = int(ctx.get_param("batch", 1))
    prompt_len = int(ctx.get_param("prompt_len", 16))
    max_new = int(ctx.get_param("max_new_tokens", 64))
    temperature = float(ctx.get_param("temperature", 0.0))
    seed = ctx.seed or 0

    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    target = ctx.get_param("target")
    if target is not None:
        # Weights-only restore: no optimizer template, no optimizer IO.
        step = restore_target(ctx, target, params)
        ctx.log_text(f"restored weights from run {target} step {step}")

    qweights = None
    if str(ctx.get_param("quantize", "") or "") == "int8":
        qweights = decode.quantize_weights(params)
        ctx.log_text("lm_generate: int8 weight-only decode enabled")
    # The compute-dtype weights once, not in every call (after quantizing,
    # which scales the float32 weights).
    params = decode.cast_weights(params, cfg)

    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)), device=device)

    def gen():
        return decode.generate(
            params, prompt, cfg, max_new_tokens=max_new, temperature=temperature,
            generator=torch.Generator(device=device).manual_seed(seed),
            qweights=qweights, device=device,
        )

    def pre():
        cache = decode.init_cache(cfg, batch, prompt_len + max_new, device)
        return decode.prefill(params, prompt, cache, cfg, device=device)[0]

    # A first call of each warms the allocator and builds the kernel; the
    # device barriers bound each timing.  Prefill is timed separately so the
    # decode rate isn't diluted by the O(T^2) prompt pass.
    gen()
    pre()
    _sync(device)
    p0 = time.perf_counter()
    pre()
    _sync(device)
    prefill_s = time.perf_counter() - p0
    t0 = time.perf_counter()
    out = gen()
    _sync(device)
    total_s = time.perf_counter() - t0
    first = out[0, :16].cpu()
    tps = batch * max_new / max(total_s - prefill_s, 1e-9)
    if ctx.is_leader:
        ctx.log_metrics(
            decode_tokens_per_s=tps,
            prefill_s=prefill_s,
            generated=batch * max_new,
        )
        ctx.log_text(
            f"lm_generate done: {batch}x{max_new} tokens at {tps:.0f} tok/s "
            f"decode (prefill {prefill_s*1e3:.0f} ms); sample: {first.tolist()}"
        )
    return out


def lm_train(ctx: Context) -> None:
    """Train the flagship transformer LM under the context's strategy.

    Counterpart of the JAX ``lm_train``: the same params (``steps``,
    ``batch``, ``seq``, ``lr``, ``attention_impl`` and the
    ``TransformerConfig`` fields ``vocab_size``, ``d_model``, ``n_layers``,
    ``n_heads``, ``head_dim``, ``d_ff``, ``n_experts``, ``n_kv_heads``,
    ``ce_chunk``), plus ``device`` (default ``cuda``; ``cpu`` only when
    asked).  With ``n_experts`` the MLP is the switch MoE under every
    template (``models/transformer.py:forward``), and the loss carries its
    balance term; the ledger's FLOPs stay the reference's ``6·n_params + ...``, and
    ``n_params`` counts every expert, so a top-1 MoE's MFU counts FLOPs its
    tokens do not spend.  The template comes from ``ctx.strategy`` over ``ctx.mesh``
    (default ``build_mesh({"data": 1})``): any ported template (the params
    sharded by ``param_axes``; ``sp_ring`` on a ``{"sequence": 1}`` mesh
    runs one causal block over the whole sequence, as bench.py runs T =
    16384), on one rank or across a gang's ranks (the worker's
    ``ctx.mesh``).  Data is the same synthetic next-token batch, drawn once
    from ``np.random.default_rng(seed)`` on every rank (as the reference
    draws it on the host) and fed every step;
    each rank takes its rows and sequence shard (``TrainStep.place_batch``).
    The optimizer is ``AdamW(lr)``.  ``tokens_per_s`` counts the global
    batch; each rank's ledger counts its share, the global step's tokens
    and FLOPs over ``mesh.size``.

    With ``save_every`` > 0 and ``ctx.checkpoints_path`` set, the run
    resumes from the newest complete checkpoint there (``start_step`` = its
    step + 1), saves every ``save_every`` steps (asynchronously; fenced at
    the end) and answers ``checkpoint-now`` commands from the capture
    agent's bus (on every process under a template that shards the params:
    ``_checkpoint_now``).  ``profile_start``/``profile_steps`` trace a
    window of steps into ``<outputs>/profile``; a ``profile`` command captures one on
    demand.  ``preempt_*`` and ``stall_*`` inject faults (``_fault_injection``).

    Logs ``loss`` and ``grad_norm`` at every tenth step and the last (read
    off the loop by a ``MetricsDrain``), then ``tokens_per_s``,
    ``first_step_s`` (the first step's wall, synchronized, kernel loading
    included), the ``StepClock`` means (``ckpt_block_s`` among them when
    saving) and ``step_wall_s_p50/p95/p99``, one record per save
    (``ckpt_save_block_s``, ``ckpt_write_s``, ``ckpt_bytes``), and names the
    strategy in its last line.

    The run is accounted as the reference accounts it: the process-wide
    utilization ledger (``tracking/ledger.py``) is armed first, gets the
    analytic FLOPs of a step, a step record a step, the checkpoint's blocking
    and the metric drain's backlog, and flushes a final row to its sink (the
    reporter's ``ledger`` lines, where one is configured); each step beats
    the progress beacon (``tracking/flightrec.py``) and records its wall in
    ``get_stats()``'s ``train.step_wall_s``.  One ordering differs: the host
    dispatches steps ahead of the card and the loop synchronizes once, after
    its last step, so the last step's ledger wall runs to the end of that
    synchronize and the steps' walls together cover the card's work.
    ``aot_compile_s`` has no counterpart in eager mode.
    """
    device = resolve_device(ctx.get_param("device", "cuda"))
    # Armed first: model build, weight init and data setup belong to the run.
    led = get_ledger().start(source="train", device=device)
    steps = int(ctx.get_param("steps", 10))
    batch_size = int(ctx.get_param("batch", 8))
    seq = int(ctx.get_param("seq", 128))
    lr = float(ctx.get_param("lr", 3e-4))
    cfg_fields = _int_params(ctx, (
        "vocab_size", "d_model", "n_layers", "n_heads",
        "head_dim", "d_ff", "n_experts", "n_kv_heads", "ce_chunk",
    ))
    if ctx.get_param("attention_impl") is not None:
        cfg_fields["attention_impl"] = str(ctx.get_param("attention_impl"))
    cfg = TransformerConfig(max_seq=seq, **cfg_fields)
    seed = ctx.seed or 0

    mesh = ctx.mesh if ctx.mesh is not None else build_mesh({"data": 1})
    template = template_for(ctx.strategy, dict(mesh.shape), ctx.strategy_options)
    ts = build_train_step(
        loss_fn=lambda p, b: loss_fn(p, b, cfg, template=template, mesh=mesh, device=device),
        init_fn=lambda g: init_params(cfg, g),
        optimizer=AdamW(lr),
        mesh=mesh,
        template=template,
        axes_tree=param_axes(cfg),
    )
    params, opt_state = ts.init(torch.Generator(device=device).manual_seed(seed))

    ckpt, save, params, opt_state, start_step = _open_checkpoints(
        ctx, int(ctx.get_param("save_every", 0)), ts, params, opt_state)

    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch_size, seq + 1)), device=device)
    batch = ts.place_batch({"tokens": tokens[:, :-1], "targets": tokens[:, 1:]})

    profiler = StepProfiler(
        ctx.outputs_path or ".",
        start_step=int(ctx.get_param("profile_start", -1)),
        num_steps=int(ctx.get_param("profile_steps", 0)),
    )
    # On-demand capture (`profile` commands): the same per-step hook as the
    # launch-time profiler, armed only when a command arrives.
    capture = get_capture_agent()
    # checkpoint-now lands on the bus thread but must save from the loop
    # thread (the optimizer updates the state in place).
    ckpt_now = _checkpoint_now(ckpt, save, capture, ts)
    inject = _fault_injection(ctx)
    # Losses leave the loop as device scalars; the drain thread reads them.
    drain = MetricsDrain(lambda step, vals: ctx.log_metrics(step=step, **vals))
    clock = StepClock()
    tracer = get_tracer()
    run_stats = get_stats()
    progress = get_progress()
    # This rank's ledger accounts this rank's card: its share of the global
    # step's tokens and FLOPs (under tp its ranks hold the same rows, and
    # each does its share of their work).
    step_tokens = batch_size * seq // mesh.size
    led.set_flops_per_step(transformer_flops_per_token(
        cfg.n_params, cfg.n_layers, cfg.n_heads, cfg.head_dim, seq) * batch_size * seq / mesh.size)
    metrics = None
    first_step_s = None
    last_dt = None
    t0 = time.perf_counter()
    clock.start()
    led.mark_loop_start()
    try:
        with tracer.span("train.loop", steps=steps - start_step):
            for i in range(start_step, steps):
                profiler.on_step(i)
                capture.on_step(i)
                if inject is not None:
                    inject(i)
                with tracer.span("train.step", sample=tracer.hot_sample, step=i):
                    params, opt_state, metrics = ts.step(params, opt_state, batch)
                if ctx.is_leader and (i % 10 == 0 or i == steps - 1):
                    drain.push(i, {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"]})
                if save is not None:
                    save(i, params, opt_state)
                if ckpt_now is not None:
                    ckpt_now.maybe_save(i, params, opt_state)
                if i == start_step:
                    _sync(device)  # the cold-start metric is the first step's full time
                    first_step_s = step_dt = clock.tick()
                else:
                    step_dt = clock.tick()
                ticked = time.perf_counter()
                if i < steps - 1:
                    run_stats.timing("train.step_wall_s", step_dt)
                    led.step(step_dt, tokens=step_tokens)
                    led.maybe_flush()
                else:
                    last_dt = step_dt
                progress.beat(step=i)
            _sync(device)
            dt = time.perf_counter() - t0
        if last_dt is not None:
            # The steps still queued on the card when the host left the loop
            # finish inside the synchronize: the last step's wall runs to its end.
            last_dt += time.perf_counter() - ticked
            run_stats.timing("train.step_wall_s", last_dt)
            led.step(last_dt, tokens=step_tokens)
    finally:
        profiler.close()
        drain.close()
        if ckpt is not None:
            ckpt.wait_until_finished()
            ckpt.close()
    # Ledger finalization: checkpoint write blocks, the drain backlog paid
    # at close, then the final row.
    if ckpt is not None:
        led.account("ckpt_block_s", ckpt.save_block_s)
    led.account("metric_drain_s", drain.close_wait_s)
    led.flush(final=True)
    steps_run = steps - start_step
    if steps_run <= 0:
        if ctx.is_leader:
            ctx.log_text("lm_train: nothing to do (checkpoint already at end)")
        return
    if not ctx.is_leader:
        return
    tps = steps_run * batch_size * seq / dt
    if ckpt is not None:
        clock.add("ckpt_block_s", ckpt.save_block_s)
        run_stats.timing("train.ckpt_block_s", ckpt.save_block_s)
        for save in ckpt.history:
            ctx.log_metrics(step=save["step"], ckpt_save_block_s=save["block_s"],
                            ckpt_write_s=save["write_s"], ckpt_bytes=save["bytes"])
    stats = clock.summary()
    stats.update(_percentile_metrics(run_stats, "train.step_wall_s", "step_wall_s"))
    ctx.log_metrics(step=steps, tokens_per_s=tps, first_step_s=first_step_s, **stats)
    ctx.log_text(
        f"lm_train done: {steps} steps, strategy={template.name}, "
        f"final loss {float(metrics['loss']):.4f}, "
        f"{tps:.0f} tokens/s (first step {first_step_s:.2f}s)"
    )
