"""Built-in entrypoints of the port.

Counterpart of ``polyaxon_tpu/builtins/trainers.py``; so far ``lm_generate``
and ``lm_train`` (``ddp`` and ``sp_ring`` on one rank), with checkpoint
save, resume and restore, the fault injection the platform's preemption
tests drive, and ``lm_train``'s run accounting (the utilization ledger, the
progress beacon, tracer spans and step-wall percentiles).
"""

from __future__ import annotations

import os
import signal
import time

import numpy as np
import torch

from polyaxon_tpu_torch._device import resolve_device
from polyaxon_tpu_torch.models import decode
from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params, loss_fn
from polyaxon_tpu_torch.parallel.templates import template_for
from polyaxon_tpu_torch.runtime.checkpoint import CheckpointManager, CheckpointNowService
from polyaxon_tpu_torch.runtime.mesh import build_mesh
from polyaxon_tpu_torch.runtime.optim import AdamW
from polyaxon_tpu_torch.runtime.pipeline import MetricsDrain
from polyaxon_tpu_torch.runtime.train import build_train_step
from polyaxon_tpu_torch.stats import get_stats
from polyaxon_tpu_torch.tracking.capture import get_capture_agent
from polyaxon_tpu_torch.tracking.context import Context
from polyaxon_tpu_torch.tracking.flightrec import get_progress
from polyaxon_tpu_torch.tracking.ledger import get_ledger, transformer_flops_per_token
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
    asked).  The template comes from ``ctx.strategy`` over ``ctx.mesh``
    (default ``build_mesh({"data": 1})``): ``ddp``, or ``sp_ring`` (ring
    attention; on a ``{"sequence": 1}`` mesh one causal block over the whole
    sequence, as bench.py runs T = 16384), on a mesh whose axes are all 1.
    Data is the same synthetic next-token batch, drawn once from
    ``np.random.default_rng(seed)`` and fed every step; the optimizer is
    ``AdamW(lr)``.

    With ``save_every`` > 0 and ``ctx.checkpoints_path`` set, the run
    resumes from the newest complete checkpoint there (``start_step`` = its
    step + 1), saves every ``save_every`` steps (asynchronously; fenced at
    the end) and answers ``checkpoint-now`` commands from the capture
    agent's bus.  ``profile_start``/``profile_steps`` trace a window of
    steps into ``<outputs>/profile``; a ``profile`` command captures one on
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
    )
    params, opt_state = ts.init(torch.Generator(device=device).manual_seed(seed))

    # Checkpoint/resume: restore whatever the checkpoints/ dir holds (a
    # resumed clone inherits the original's checkpoints), save every
    # `save_every` steps.
    save_every = int(ctx.get_param("save_every", 0))
    start_step = 0
    ckpt = None
    if save_every > 0 and ctx.checkpoints_path is not None:
        ckpt = CheckpointManager(ctx.checkpoints_path, save_interval_steps=save_every)
        restored = ckpt.restore(params, opt_state)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt_state"]
            start_step = restored["step"] + 1
            ctx.log_text(f"restored checkpoint at step {restored['step']}")

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
    ckpt_now = CheckpointNowService(ckpt, capture) if ckpt is not None else None
    inject = _fault_injection(ctx)
    # Losses leave the loop as device scalars; the drain thread reads them.
    drain = MetricsDrain(lambda step, vals: ctx.log_metrics(step=step, **vals))
    clock = StepClock()
    tracer = get_tracer()
    run_stats = get_stats()
    progress = get_progress()
    step_tokens = batch_size * seq
    led.set_flops_per_step(transformer_flops_per_token(
        cfg.n_params, cfg.n_layers, cfg.n_heads, cfg.head_dim, seq) * step_tokens)
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
                if ckpt is not None:
                    ckpt.save(i, params, opt_state)  # async; fenced below
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
