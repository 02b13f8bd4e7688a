"""Built-in entrypoints of the port.

Counterpart of ``polyaxon_tpu/builtins/trainers.py``; so far ``lm_generate``
and ``lm_train`` (``ddp`` and ``sp_ring`` on one rank).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from polyaxon_tpu_torch._device import resolve_device
from polyaxon_tpu_torch.models import decode
from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params, loss_fn
from polyaxon_tpu_torch.parallel.templates import template_for
from polyaxon_tpu_torch.runtime.mesh import build_mesh
from polyaxon_tpu_torch.runtime.optim import AdamW
from polyaxon_tpu_torch.runtime.train import build_train_step
from polyaxon_tpu_torch.tracking.context import Context
from polyaxon_tpu_torch.tracking.profiling import StepClock


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _int_params(ctx: Context, names) -> dict:
    return {f: int(ctx.get_param(f)) for f in names if ctx.get_param(f) is not None}


def lm_generate(ctx: Context) -> torch.Tensor:
    """Autoregressive generation from the flagship LM (the serving story).

    Params: ``prompt_len``, ``max_new_tokens``, ``batch``, ``temperature``,
    ``quantize`` (``int8``), ``seq`` (max_seq), the model-shape params of
    ``lm_train``, and ``device`` (default ``cuda``; ``cpu`` only when
    asked).  Weights are random from ``ctx.seed``; ``target`` (restoring a
    checkpoint) is not ported yet.  Reports ``decode_tokens_per_s``,
    ``prefill_s`` and ``generated``, and returns the tokens of the timed
    ``generate`` call, [batch, max_new_tokens].
    """
    if ctx.get_param("target") is not None:
        raise NotImplementedError(
            "lm_generate target (checkpoint restore) is not ported yet "
            "(ROADMAP: checkpoint restore for lm_generate)"
        )
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

    qweights = None
    if str(ctx.get_param("quantize", "") or "") == "int8":
        qweights = decode.quantize_weights(params)
        ctx.log_text("lm_generate: int8 weight-only decode enabled")

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
    ``AdamW(lr)``.  Logs ``loss`` and ``grad_norm`` at every tenth step and
    the last, then ``tokens_per_s``, ``first_step_s`` (the first step's wall,
    synchronized, kernel loading included) and the ``StepClock`` means, and
    names the strategy in its last line.

    Not ported yet, each named in ROADMAP: ``save_every`` checkpointing
    (raises when > 0), the profiler and capture hooks, fault injection, the
    utilization ledger and the metrics drain; ``aot_compile_s`` has no
    counterpart in eager mode.
    """
    if int(ctx.get_param("save_every", 0)) > 0:
        raise NotImplementedError(
            "lm_train save_every (checkpoint save/resume) is not ported yet "
            "(ROADMAP: device-side runtime glue, runtime/checkpoint.py)"
        )
    device = resolve_device(ctx.get_param("device", "cuda"))
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
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch_size, seq + 1)), device=device)
    batch = ts.place_batch({"tokens": tokens[:, :-1], "targets": tokens[:, 1:]})

    clock = StepClock()
    t0 = time.perf_counter()
    clock.start()
    for i in range(steps):
        params, opt_state, metrics = ts.step(params, opt_state, batch)
        if ctx.is_leader and (i % 10 == 0 or i == steps - 1):
            ctx.log_metrics(step=i, loss=float(metrics["loss"]),
                            grad_norm=float(metrics["grad_norm"]))
        if i == 0:
            _sync(device)  # the cold-start metric is the first step's full time
            first_step_s = clock.tick()
        else:
            clock.tick()
    _sync(device)
    dt = time.perf_counter() - t0
    if steps <= 0 or not ctx.is_leader:
        return
    tps = steps * batch_size * seq / dt
    ctx.log_metrics(step=steps, tokens_per_s=tps, first_step_s=first_step_s, **clock.summary())
    ctx.log_text(
        f"lm_train done: {steps} steps, strategy={template.name}, "
        f"final loss {float(metrics['loss']):.4f}, "
        f"{tps:.0f} tokens/s (first step {first_step_s:.2f}s)"
    )
