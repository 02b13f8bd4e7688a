"""Built-in entrypoints of the port.

Counterpart of ``polyaxon_tpu/builtins/trainers.py``; so far ``lm_generate``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from polyaxon_tpu_torch._device import resolve_device
from polyaxon_tpu_torch.models import decode
from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params
from polyaxon_tpu_torch.tracking.context import Context


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    cfg_fields = {
        f: int(ctx.get_param(f))
        for f in (
            "vocab_size", "d_model", "n_layers", "n_heads",
            "head_dim", "d_ff", "n_kv_heads", "n_experts",
        )
        if ctx.get_param(f) is not None
    }
    seq = int(ctx.get_param("seq", 256))
    cfg = TransformerConfig(max_seq=seq, **cfg_fields)
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
