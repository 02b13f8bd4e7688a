"""Autoregressive decoding for the flagship LM: KV cache + sampling.

Counterpart of the static-cache path of ``polyaxon_tpu/models/decode.py``:

- a ``[L, B, max_len, Hkv, d]`` cache in the compute dtype, holding the
  unexpanded KV heads (GQA broadcast happens inside the one-token
  attention contraction);
- prefill through the training forward (``return_kv=True``), whose
  attention is the flash kernel on CUDA;
- one-token decode steps with masked einsum attention over the cache,
  whose position is a tensor on the cache's device: :func:`generate` runs
  them as one CUDA graph replayed once a token (the counterpart of the
  reference's ``lax.scan``), and eagerly on the CPU;

and of its paged (block-table) path, which the serving engine runs: a pool
of fixed-size KV blocks ``[L, num_blocks, block_size, Hkv, d]`` (compute
dtype, or int8 rows with one float32 scale per row and kv-head), per-request
block tables, chunked prefill, one-token decode steps and multi-token
speculative verify steps.  Block 0 is the trash block: pad rows and inactive
lanes write there, unset table entries point there, and the position mask
hides every read of it.  The paged steps use plain PyTorch attention, as the
reference uses XLA's: no kernel of the port runs on this path.

Where JAX returns a new cache or pool, the port writes it in place
(``copy_``, ``index_copy_``, ``index_put_``) and returns the same dict, so
calls read like the reference's: the cache is the largest buffer of the loop
and a copy per step would double its traffic.

No step reads a host value: positions, chunk bounds, tables and masks are
tensors on the device, so a step can be captured into a CUDA graph (a
host-to-device copy inside a capture is an error).  :func:`cast_weights`
makes the compute-dtype copies of the weights once, where each step would
otherwise cast every float32 weight again.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from polyaxon_tpu_torch._device import DeviceLike, resolve_device
from polyaxon_tpu_torch.models.transformer import (
    TransformerConfig,
    _dense_attention,
    _rmsnorm,
    _rope,
    forward,
)
from polyaxon_tpu_torch.tracking.ledger import record_compile


def _on(x: Union[int, torch.Tensor], device: torch.device) -> torch.Tensor:
    """An int position or bound as a 0-d tensor on ``device``; a tensor as it is."""
    return x if torch.is_tensor(x) else torch.tensor(int(x), device=device)


def capture_step(fn: Callable[[], Any], pool=None, warmup: int = 2):
    """Capture one call of ``fn`` into a CUDA graph → (graph, its output).

    ``fn`` reads only tensors whose addresses stay fixed (its static inputs,
    the weights, the cache or pool), and ``graph.replay()`` then runs it
    again on whatever those tensors hold.  It first runs ``warmup`` times on
    a side stream, as capture requires (lazy initialisation, allocator
    warm-up); those runs execute, so ``fn``'s inputs must already hold
    values whose writes are harmless.  ``pool`` (from
    ``torch.cuda.graph_pool_handle()``) lets graphs replayed one at a time
    share their memory.  Only the calling thread's CUDA calls are checked
    during the capture, and the garbage collector is off meanwhile: a
    collection there that frees an unreachable CUDA graph (a stopped
    engine's step entries sit in reference cycles with their engine)
    destroys it on the capturing thread, and that invalidates the capture.
    The warm-up and the capture are one compile event of the utilization
    ledger (``tracking/ledger.py:record_compile``), with their seconds.
    """
    t0 = time.perf_counter()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            out = fn()
    finally:
        if collecting:
            gc.enable()
    record_compile(time.perf_counter() - t0, events=1)
    return graph, out


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


def cast_weights(params: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    """``params`` with the leaves the decode steps read in the compute dtype
    (the block matmul weights, ``unembed`` and ``embed``) cast to it once.

    The steps' own casts (:func:`_wdq`, the embedding lookups) then return
    these tensors as they are, so every logit is bit for bit what the
    uncast tree gives.  The norms stay as they are (they are read in their
    own dtype).  Quantize from the uncast tree: :func:`quantize_weights` of
    a cast tree would scale the rounded weights.
    """
    dt = cfg.dtype
    blk = params["block"]
    return {
        **params,
        "embed": params["embed"].to(dt),
        "unembed": params["unembed"].to(dt),
        "block": {**blk, **{name: blk[name].to(dt) for name in QUANTIZED_BLOCK_WEIGHTS}},
    }


def _wdq(w, dtype: torch.dtype) -> torch.Tensor:
    """Weight in the compute dtype: dequantize an ``(int8, scale)`` pair or cast
    (a weight already in ``dtype`` is returned as it is)."""
    if isinstance(w, tuple):
        qi, scale = w
        return qi.to(dtype) * scale.to(dtype)
    return w.to(dtype)


def _decode_weights(params: Dict[str, Any], qweights: Optional[Dict[str, Any]]):
    """(stacked block weights, unembed) for a decode step: the ``(int8,
    scale)`` pairs of ``qweights`` in place of the matmul weights, if given."""
    blk = params["block"]
    if qweights is None:
        return blk, params["unembed"]
    layers = {
        "attn_norm": blk["attn_norm"],
        "mlp_norm": blk["mlp_norm"],
        **{k: qweights[k] for k in QUANTIZED_BLOCK_WEIGHTS},
    }
    return layers, qweights["unembed"]


def _layer_at(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of stacked weights (both halves of a quantized pair)."""
    return {
        name: (tuple(t[i] for t in w) if isinstance(w, tuple) else w[i])
        for name, w in layers.items()
    }


def _attend_cached(q, ck, cv, pos: torch.Tensor, group: int):
    """One-token attention against the cache.

    q: [B, 1, H, d]; ck/cv: [B, max_len, Hkv, d]; entries past ``pos`` (a
    0-d tensor) are future or empty slots and are masked with -1e30.
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


def _block_step(x, pos: torch.Tensor, layer, ck, cv, cfg: TransformerConfig):
    """One transformer block for one new token, writing its KV row at ``pos``
    (a 0-d tensor).

    x: [B, 1, D]; ck/cv: [B, max_len, Hkv, d], this layer's cache (updated
    in place).
    """
    c = cfg
    h = _rmsnorm(x, layer["attn_norm"])
    q = torch.einsum("btd,dhk->bthk", h, _wdq(layer["wq"], h.dtype))
    k = torch.einsum("btd,dhk->bthk", h, _wdq(layer["wk"], h.dtype))
    v = torch.einsum("btd,dhk->bthk", h, _wdq(layer["wv"], h.dtype))
    positions = pos.expand(x.shape[0], 1)
    q = _rope(q, positions, c.rope_theta)
    k = _rope(k, positions, c.rope_theta)
    row = pos.reshape(1)
    ck.index_copy_(1, row, k)
    cv.index_copy_(1, row, v)
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
    pos: Union[int, torch.Tensor],
    cfg: TransformerConfig,
    qweights: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token [B] at absolute ``pos`` → (logits [B, vocab] float32, the cache
    with this token's rows written).  ``pos`` is a 0-d integer tensor on the
    cache's device (an int is copied there first)."""
    c = cfg
    pos = _on(pos, token.device)
    x = params["embed"].to(c.dtype)[token][:, None, :]  # [B,1,D]
    layers, unembed = _decode_weights(params, qweights)
    for i in range(c.n_layers):
        x = _block_step(x, pos, _layer_at(layers, i), cache["k"][i], cache["v"][i], c)
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

    The ``max_new_tokens - 1`` one-token steps are the reference's scan: on
    CUDA one :func:`decode_step`, captured once into a CUDA graph and
    replayed once a token, reads the token and the position from two static
    device buffers, which the loop advances on the device; each token is
    picked outside the graph from its logits, on the device, so sampling
    draws from ``generator`` as an eager loop would, and no token reaches
    the host before the end.  On the CPU the same steps run eagerly.
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
    params = cast_weights(params, cfg)
    prompt = prompt.to(dev)
    cache = init_cache(cfg, B, max_len, dev)
    logits, cache = prefill(params, prompt, cache, cfg, device=dev)

    def pick(logits):
        if greedy:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / float(temperature), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    # The step's inputs: the token to feed and its position.
    token = pick(logits)
    pos = torch.full((), T, dtype=torch.long, device=dev)

    def step():
        return decode_step(params, cache, token, pos, cfg, qweights=qweights)[0]

    graph = None
    if dev.type == "cuda" and max_new_tokens > 1:
        # The capture's warm-up runs write row T from this very token, as
        # the first replay does again.
        graph, captured = capture_step(step)

    # N-1 steps; the final token needs only a pick, not another full step.
    tokens = []
    for _ in range(max_new_tokens - 1):
        tokens.append(token.clone())
        if graph is None:
            logits = step()
        else:
            graph.replay()
            logits = captured
        pos += 1
        token.copy_(pick(logits))
    tokens.append(token)
    return torch.stack(tokens, dim=1)


# -- paged (block-table) cache ops -----------------------------------------
# Counterpart of decode.py:343-831 of the JAX package.  The pool is a dict of
# tensors the serving engine owns; every function below writes it in place
# and returns it.  Tables, positions, the active mask and a prefill chunk's
# ``start`` and ``length`` are tensors on the pool's device, so no step reads
# a host value and the serving engine can capture each step once per shape.


def _check_kv_dtype(kv_dtype: Optional[str]) -> None:
    if kv_dtype is not None and str(kv_dtype) != "int8":
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (int8 or None)")


def init_block_pool(
    cfg: TransformerConfig,
    num_blocks: int,
    block_size: int,
    kv_dtype: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    """Zeroed paged KV pool: k/v [L, num_blocks, block_size, Hkv, d] in the
    compute dtype, or with ``kv_dtype="int8"`` int8 ``k_q``/``v_q`` of that
    shape and float32 ``k_scale``/``v_scale`` [L, num_blocks, block_size, Hkv]
    (one scale per appended row per kv-head)."""
    _check_kv_dtype(kv_dtype)
    c = cfg
    dev = resolve_device(device)
    shape = (c.n_layers, num_blocks, block_size, c.kv_heads, c.head_dim)
    if kv_dtype is None:
        return {
            "k": torch.zeros(shape, dtype=c.dtype, device=dev),
            "v": torch.zeros(shape, dtype=c.dtype, device=dev),
        }
    return {
        "k_q": torch.zeros(shape, dtype=torch.int8, device=dev),
        "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        "v_q": torch.zeros(shape, dtype=torch.int8, device=dev),
        "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
    }


def is_quantized_pool(pool: Dict[str, torch.Tensor]) -> bool:
    """True for the (k_q, k_scale, v_q, v_scale) int8 pool layout."""
    return "k_q" in pool


def pool_geometry(pool: Dict[str, torch.Tensor]) -> Tuple[int, int, int]:
    """(block_size, kv_heads, head_dim) for either pool layout."""
    leaf = pool["k_q"] if is_quantized_pool(pool) else pool["k"]
    return leaf.shape[2], leaf.shape[3], leaf.shape[4]


def kv_block_bytes(
    cfg: TransformerConfig, block_size: int, kv_dtype: Optional[str] = None
) -> int:
    """Device bytes one pool block costs (all layers, k and v, scales included)."""
    _check_kv_dtype(kv_dtype)
    c = cfg
    rows = c.n_layers * block_size * c.kv_heads  # head-rows per block
    if kv_dtype is None:
        return 2 * rows * c.head_dim * torch.tensor([], dtype=c.dtype).element_size()
    return 2 * rows * (c.head_dim + 4)  # int8 row + one float32 scale


def _kv_quant(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-head-row quantization: rows [..., Hkv, d] → (int8
    [..., Hkv, d], float32 scale [..., Hkv]).  Rounds half to even, as
    ``jnp.round`` does; zero rows get scale 0 and dequantize to zeros."""
    r = rows.float()
    scale = r.abs().amax(dim=-1) / 127.0
    q = torch.round(r / torch.where(scale > 0, scale, torch.ones_like(scale))[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return q.to(dtype) * scale[..., None].to(dtype)


def _pool_append(
    pool_l: Dict[str, torch.Tensor],
    name: str,
    rows: torch.Tensor,
    write_blk: torch.Tensor,
    write_off: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Write one layer's new KV rows [..., Hkv, d] at (write_blk, write_off)
    [...] of its pool leaves, quantizing them for the int8 layout."""
    idx = (write_blk, write_off)
    if name + "_q" in pool_l:
        q, scale = _kv_quant(rows)
        pool_l[name + "_q"].index_put_(idx, q)
        pool_l[name + "_scale"].index_put_(idx, scale)
    else:
        leaf = pool_l[name]
        leaf.index_put_(idx, rows.to(leaf.dtype))
    return pool_l


def _pool_gather(
    pool_l: Dict[str, torch.Tensor], name: str, table: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """One layer's KV rows for a block table [..., W] → [..., W, bs, Hkv, d],
    int8 leaves dequantized."""
    if name + "_q" in pool_l:
        return _kv_dequant(pool_l[name + "_q"][table], pool_l[name + "_scale"][table], dtype)
    return pool_l[name][table]


@torch.inference_mode()
def copy_block(pool: Dict[str, torch.Tensor], src: int, dst: int) -> Dict[str, torch.Tensor]:
    """Copy one block's rows (all layers, every leaf) from ``src`` to ``dst``:
    the copy-on-write primitive, bit-exact for both layouts."""
    for leaf in pool.values():
        leaf[:, dst].copy_(leaf[:, src])
    return pool


@torch.inference_mode()
def export_block(pool: Dict[str, torch.Tensor], src: int) -> Dict[str, torch.Tensor]:
    """One block's rows (all layers) as ``{leaf: [L, block_size, ...]}`` in the
    pool's own storage dtypes: a copy, independent of later pool writes."""
    return {name: leaf[:, src].clone() for name, leaf in pool.items()}


@torch.inference_mode()
def import_block(
    pool: Dict[str, torch.Tensor], data: Dict[str, torch.Tensor], dst: int
) -> Dict[str, torch.Tensor]:
    """Write an :func:`export_block` payload into block ``dst``: bit-exact for
    both layouts (values keep their storage dtype; only the address moves)."""
    for name, leaf in pool.items():
        leaf[:, dst].copy_(data[name])
    return pool


def _paged_block(x, positions, layer, pool_l, tables, write_blk, write_off, attend,
                 cfg: TransformerConfig):
    """One decoder block over the paged pool: write this call's KV rows, then
    attend against everything the table holds (the rows just written are the
    call's own causal keys).  x: [B, T, D]; tables [W] (B = 1) or [B, W];
    write_blk/write_off index each new row."""
    h = _rmsnorm(x, layer["attn_norm"])
    q = torch.einsum("btd,dhk->bthk", h, _wdq(layer["wq"], h.dtype))
    k = torch.einsum("btd,dhk->bthk", h, _wdq(layer["wk"], h.dtype))
    v = torch.einsum("btd,dhk->bthk", h, _wdq(layer["wv"], h.dtype))
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    rows = write_blk.shape + k.shape[-2:]
    _pool_append(pool_l, "k", k.reshape(rows), write_blk, write_off)
    _pool_append(pool_l, "v", v.reshape(rows), write_blk, write_off)
    Hkv, d = k.shape[-2:]
    ck = _pool_gather(pool_l, "k", tables, h.dtype).reshape(x.shape[0], -1, Hkv, d)
    cv = _pool_gather(pool_l, "v", tables, h.dtype).reshape(x.shape[0], -1, Hkv, d)
    attn = attend(q, ck, cv)
    x = x + torch.einsum("bthk,hkd->btd", attn, _wdq(layer["wo"], h.dtype))

    h = _rmsnorm(x, layer["mlp_norm"])
    up = torch.einsum("btd,df->btf", h, _wdq(layer["wi"], h.dtype))
    gate = torch.einsum("btd,df->btf", h, _wdq(layer["wg"], h.dtype))
    y = torch.nn.functional.silu(gate) * up
    return x + torch.einsum("btf,fd->btd", y, _wdq(layer["wd"], h.dtype))


def _paged_forward(params, pool, x, positions, tables, write_blk, write_off, attend,
                   cfg: TransformerConfig, qweights, last=None):
    """The layer loop of the three paged steps → float32 logits [B, T, vocab]
    (of row ``last`` only, [B, 1, vocab], when given: a [1] index tensor)."""
    layers, unembed = _decode_weights(params, qweights)
    for i in range(cfg.n_layers):
        pool_l = {name: leaf[i] for name, leaf in pool.items()}
        x = _paged_block(x, positions, _layer_at(layers, i), pool_l, tables,
                         write_blk, write_off, attend, cfg)
    if last is not None:
        x = x.index_select(1, last)
    x = _rmsnorm(x, params["final_norm"])
    return torch.einsum("btd,dv->btv", x, _wdq(unembed, x.dtype)).float()


@torch.inference_mode()
def paged_prefill_chunk(
    params: Dict[str, Any],
    pool: Dict[str, torch.Tensor],
    table: torch.Tensor,
    tokens: torch.Tensor,
    start: Union[int, torch.Tensor],
    length: Union[int, torch.Tensor],
    cfg: TransformerConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Insert one prompt chunk into the pool; returns (float32 logits [vocab]
    of its last real token, pool).

    tokens [C] (right-padded to a bucket) start at absolute position
    ``start``; the first ``length`` are real (``start`` and ``length`` are
    0-d integer tensors on the pool's device; ints are copied there first).
    With ``length`` 0 every row is a pad row and the logits are row 0's.  ``table`` [W] maps the
    sequence's logical blocks to pool blocks; those covering [start,
    start + length) must be allocated and private.  Pad rows write to trash
    block 0.  Numerics are the training forward's block (GQA heads broadcast,
    ``_dense_attention``'s ``-inf`` mask), so greedy outputs match
    :func:`generate`.  Only the last real row goes through the unembedding.
    """
    c = cfg
    C, W = tokens.shape[0], table.shape[0]
    bs, _, _ = pool_geometry(pool)
    group = c.n_heads // c.kv_heads
    start, length = _on(start, tokens.device), _on(length, tokens.device)
    ar = torch.arange(C, device=tokens.device)
    qpos = start + ar  # [C] absolute positions
    valid = ar < length
    # Pad writes go to the trash block: their logical blocks may not be
    # allocated yet (they belong to future generation).
    write_blk = torch.where(valid, table[torch.clamp(qpos // bs, 0, W - 1)], 0)
    write_off = torch.where(valid, qpos % bs, 0)
    kpos = torch.arange(W * bs, device=tokens.device)[None]  # keys in logical order
    positions = qpos[None]

    def attend(q, ck, cv):
        if group > 1:
            ck = ck.repeat_interleave(group, dim=2)
            cv = cv.repeat_interleave(group, dim=2)
        return _dense_attention(q, ck, cv, positions, kpos)

    x = params["embed"].to(c.dtype)[tokens][None]  # [1, C, D]
    last = torch.clamp(length - 1, min=0).reshape(1)
    logits = _paged_forward(params, pool, x, positions, table, write_blk, write_off,
                            attend, c, None, last=last)
    return logits[0, 0], pool


def _attend_paged(q, ck, cv, pos, group):
    """One-token attention over block-table-gathered KV.

    q: [S, 1, H, d]; ck/cv: [S, W*bs, Hkv, d] in logical order; pos [S]:
    each slot's absolute position (keys past it masked with -1e30).
    """
    S, K, Hkv, d = ck.shape
    scale = d**-0.5
    qg = q.reshape(S, 1, Hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck) * scale  # [S,Hkv,g,1,K]
    valid = (torch.arange(K, device=q.device)[None, :] <= pos[:, None])[:, None, None, None, :]
    s = s.masked_fill(~valid, -1e30)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, cv)
    return out.reshape(S, 1, Hkv * group, d)


@torch.inference_mode()
def paged_decode_step(
    params: Dict[str, Any],
    pool: Dict[str, torch.Tensor],
    tables: torch.Tensor,
    tokens: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    cfg: TransformerConfig,
    qweights: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Advance a mixed batch one token against the pool → (float32 logits
    [S, vocab], pool).

    tables [S, W] (unset entries → trash block 0); slot s feeds ``tokens[s]``
    at ``pos[s]``; inactive lanes write their row to block 0, offset 0.
    ``qweights`` streams the matmul weights as int8 pairs.
    """
    c = cfg
    S = tables.shape[0]
    bs, _, _ = pool_geometry(pool)
    pos = torch.where(active, pos, 0)
    lanes = torch.arange(S, device=tables.device)
    write_blk = torch.where(active, tables[lanes, pos // bs], 0)
    write_off = torch.where(active, pos % bs, 0)
    group = c.n_heads // c.kv_heads
    x = params["embed"].to(c.dtype)[tokens][:, None, :]  # [S,1,D]
    logits = _paged_forward(
        params, pool, x, pos[:, None], tables, write_blk, write_off,
        lambda q, ck, cv: _attend_paged(q, ck, cv, pos, group), c, qweights,
    )
    return logits[:, 0], pool


def _attend_spec(q, ck, cv, qpos, group):
    """Multi-row attention over block-table-gathered KV: q [S, T, H, d], one
    row per drafted token at absolute positions qpos [S, T]; the masked
    float32 softmax of :func:`_attend_paged` per row (-1e30)."""
    S, K, Hkv, d = ck.shape
    T = q.shape[1]
    scale = d**-0.5
    qg = q.reshape(S, T, Hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck) * scale  # [S,Hkv,g,T,K]
    valid = torch.arange(K, device=q.device)[None, None, :] <= qpos[:, :, None]  # [S,T,K]
    s = s.masked_fill(~valid[:, None, None, :, :], -1e30)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, cv)
    return out.reshape(S, T, Hkv * group, d)


@torch.inference_mode()
def paged_verify_step(
    params: Dict[str, Any],
    pool: Dict[str, torch.Tensor],
    tables: torch.Tensor,
    tokens: torch.Tensor,
    pos: torch.Tensor,
    n_tok: torch.Tensor,
    active: torch.Tensor,
    cfg: TransformerConfig,
    qweights: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Score each lane's drafted run in one pass → (float32 logits [S, T,
    vocab], pool).

    tokens [S, T]: the next token to feed, then up to T-1 drafts (the first
    ``n_tok[s]`` are real); ``pos[s]`` is the position of ``tokens[s, 0]``.
    ``logits[s, j]`` is the distribution after feeding ``tokens[s, :j+1]``.
    Rows past ``n_tok`` and inactive lanes write to trash block 0; rejected
    rows leave stale KV past the lane's next position, masked until
    overwritten.  Numerics are :func:`paged_decode_step`'s per row.
    """
    c = cfg
    S, W = tables.shape
    T = tokens.shape[1]
    bs, _, _ = pool_geometry(pool)
    pos = torch.where(active, pos, 0)
    steps = torch.arange(T, device=tables.device)
    qpos = pos[:, None] + steps[None, :]  # [S, T]
    row_ok = active[:, None] & (steps[None, :] < n_tok[:, None])
    lanes = torch.arange(S, device=tables.device)[:, None]
    write_blk = torch.where(row_ok, tables[lanes, torch.clamp(qpos // bs, 0, W - 1)], 0)
    write_off = torch.where(row_ok, qpos % bs, 0)
    group = c.n_heads // c.kv_heads
    x = params["embed"].to(c.dtype)[tokens]  # [S, T, D]
    logits = _paged_forward(
        params, pool, x, qpos, tables, write_blk, write_off,
        lambda q, ck, cv: _attend_spec(q, ck, cv, qpos, group), c, qweights,
    )
    return logits, pool
