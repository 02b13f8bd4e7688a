"""Autoregressive decoding for the flagship LM: KV cache + sampling.

Counterpart of the static-cache path of ``polyaxon_tpu/models/decode.py``:

- a ``[L, B, max_len, Hkv, d]`` cache in the compute dtype, holding the
  unexpanded KV heads (GQA broadcast happens inside the one-token
  attention contraction);
- prefill through the training forward (``return_kv=True``), whose
  attention is the flash kernel on CUDA;
- one-token decode steps with masked einsum attention over the cache.

Where JAX returns a new cache, the port writes the cache in place (prefill
rows and each step's row at ``pos``): the cache is the largest buffer of
the loop and a copy per step would double its traffic.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from polyaxon_tpu_torch._device import DeviceLike, resolve_device
from polyaxon_tpu_torch.models.transformer import (
    TransformerConfig,
    _rmsnorm,
    _rope,
    forward,
)


def init_cache(
    cfg: TransformerConfig, batch: int, max_len: int, device: DeviceLike = "cuda"
) -> Dict[str, torch.Tensor]:
    """Zeroed KV cache: k/v [L, B, max_len, Hkv, d] in the compute dtype."""
    c = cfg
    dev = resolve_device(device)
    shape = (c.n_layers, batch, max_len, c.kv_heads, c.head_dim)
    return {
        "k": torch.zeros(shape, dtype=c.dtype, device=dev),
        "v": torch.zeros(shape, dtype=c.dtype, device=dev),
    }


#: Block matmul weights the int8 path quantizes, mapped to the contraction
#: dims of each layout: [L,D,H,k] contracts D; [L,H,k,D] contracts H,k;
#: [L,D,F] contracts D; [L,F,D] contracts F.
QUANTIZED_BLOCK_WEIGHTS = {
    "wq": (1,),
    "wk": (1,),
    "wv": (1,),
    "wo": (1, 2),
    "wi": (1,),
    "wg": (1,),
    "wd": (1,),
}


@torch.inference_mode()
def quantize_weights(params: Dict[str, Any]) -> Dict[str, Any]:
    """int8 weight-only quantization of the decode matmul weights.

    Symmetric per-output-channel scales over each weight's contraction
    dims; norms and the embedding table stay full precision.  Returns
    ``(int8_q, f32_scale)`` pairs that :func:`decode_step` consumes through
    :func:`_wdq`; prefill keeps the full-precision weights.
    """

    def q(w, axes):
        w = w.float()
        amax = w.abs().amax(dim=axes, keepdim=True) + 1e-12
        scale = amax / 127.0
        qi = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return (qi, scale)

    blk = params["block"]
    out = {name: q(blk[name], axes) for name, axes in QUANTIZED_BLOCK_WEIGHTS.items()}
    out["unembed"] = q(params["unembed"], (0,))  # [D, V]: contract D
    return out


def _wdq(w, dtype: torch.dtype) -> torch.Tensor:
    """Weight in the compute dtype: dequantize an ``(int8, scale)`` pair or cast."""
    if isinstance(w, tuple):
        qi, scale = w
        return qi.to(dtype) * scale.to(dtype)
    return w.to(dtype)


def _attend_cached(q, ck, cv, pos: int, group: int):
    """One-token attention against the cache.

    q: [B, 1, H, d]; ck/cv: [B, max_len, Hkv, d]; entries past ``pos`` are
    future or empty slots and are masked with -1e30.
    """
    B, L, Hkv, d = ck.shape
    scale = d**-0.5
    qg = q.reshape(B, 1, Hkv, group, d)  # GQA stays grouped
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck) * scale  # [B,Hkv,g,1,L]
    valid = (torch.arange(L, device=q.device) <= pos)[None, None, None, None, :]
    s = s.masked_fill(~valid, -1e30)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, cv)
    return out.reshape(B, 1, Hkv * group, d)


def _block_step(x, pos: int, layer, ck, cv, cfg: TransformerConfig):
    """One transformer block for one new token, writing its KV row at ``pos``.

    x: [B, 1, D]; ck/cv: [B, max_len, Hkv, d], this layer's cache (updated
    in place).
    """
    c = cfg
    h = _rmsnorm(x, layer["attn_norm"])
    q = torch.einsum("btd,dhk->bthk", h, _wdq(layer["wq"], h.dtype))
    k = torch.einsum("btd,dhk->bthk", h, _wdq(layer["wk"], h.dtype))
    v = torch.einsum("btd,dhk->bthk", h, _wdq(layer["wv"], h.dtype))
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    q = _rope(q, positions, c.rope_theta)
    k = _rope(k, positions, c.rope_theta)
    ck[:, pos : pos + 1] = k
    cv[:, pos : pos + 1] = v
    attn = _attend_cached(q, ck, cv, pos, c.n_heads // c.kv_heads)
    x = x + torch.einsum("bthk,hkd->btd", attn, _wdq(layer["wo"], h.dtype))

    h = _rmsnorm(x, layer["mlp_norm"])
    up = torch.einsum("btd,df->btf", h, _wdq(layer["wi"], h.dtype))
    gate = torch.einsum("btd,df->btf", h, _wdq(layer["wg"], h.dtype))
    y = torch.nn.functional.silu(gate) * up
    return x + torch.einsum("btf,fd->btd", y, _wdq(layer["wd"], h.dtype))


@torch.inference_mode()
def decode_step(
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    token: torch.Tensor,
    pos: int,
    cfg: TransformerConfig,
    qweights: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token [B] at absolute ``pos`` → (logits [B, vocab] float32, the cache
    with this token's rows written)."""
    c = cfg
    x = params["embed"].to(c.dtype)[token][:, None, :]  # [B,1,D]
    blk = params["block"]
    if qweights is None:
        layers, unembed = blk, params["unembed"]
    else:
        layers = {
            "attn_norm": blk["attn_norm"],
            "mlp_norm": blk["mlp_norm"],
            **{k: qweights[k] for k in QUANTIZED_BLOCK_WEIGHTS},
        }
        unembed = qweights["unembed"]
    for i in range(c.n_layers):
        layer = {
            name: (tuple(t[i] for t in w) if isinstance(w, tuple) else w[i])
            for name, w in layers.items()
        }
        x = _block_step(x, pos, layer, cache["k"][i], cache["v"][i], c)
    x = _rmsnorm(x, params["final_norm"])
    logits = torch.einsum("btd,dv->btv", x, _wdq(unembed, x.dtype))
    return logits[:, 0].float(), cache


@torch.inference_mode()
def prefill(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    cfg: TransformerConfig,
    *,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt [B, T] through the training forward, filling
    cache[:, :, :T]; returns (last-position logits [B, vocab], cache)."""
    logits, (k, v) = forward(params, tokens, cfg, return_kv=True, device=device)
    T = k.shape[2]
    cache["k"][:, :, :T] = k
    cache["v"][:, :, :T] = v
    return logits[:, -1], cache


@torch.inference_mode()
def generate(
    params: Dict[str, Any],
    prompt: torch.Tensor,
    cfg: TransformerConfig,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    qweights: Optional[Dict[str, Any]] = None,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """prompt [B, T] → generated tokens [B, max_new_tokens] (int64).

    Greedy when ``temperature <= 0``; otherwise temperature sampling from
    ``generator`` (one on ``device``; seed 0 when omitted).  ``qweights``
    (from :func:`quantize_weights`) switches the per-token steps to int8
    weights; prefill stays full precision.
    """
    if cfg.n_experts:
        raise NotImplementedError("MoE decoding is not supported yet")
    dev = resolve_device(device)
    B, T = prompt.shape
    max_len = T + max_new_tokens
    if max_len > cfg.max_seq:
        raise ValueError(
            f"prompt ({T}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq ({cfg.max_seq})"
        )
    greedy = float(temperature) <= 0.0
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    prompt = prompt.to(dev)
    cache = init_cache(cfg, B, max_len, dev)
    logits, cache = prefill(params, prompt, cache, cfg, device=dev)

    def pick(logits):
        if greedy:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / float(temperature), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    # N-1 steps; the final token needs only a pick, not another full step.
    tokens = []
    for i in range(max_new_tokens - 1):
        token = pick(logits)
        tokens.append(token)
        logits, cache = decode_step(params, cache, token, T + i, cfg, qweights=qweights)
    tokens.append(pick(logits))
    return torch.stack(tokens, dim=1)
