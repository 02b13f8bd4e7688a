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

Sharded decode (the reference's ``decode_param_shardings``,
``quantized_weight_shardings`` and ``sharded_generate_fn``), under every
template whose rules the port splits: every rank of a mesh holds its shard
of the weights under the template's rules, fitted to the leaves' shapes (an
axis that does not divide a dimension leaves it whole), and a
:class:`DecodeShard` runs every step above on it.  Over a tensor axis
(``tp``, ``tp_dp``, ``pp_tp``) the rank's query heads, kv heads and MLP
columns, summing over the axis after ``wo`` and ``wd`` and gathering the
vocabulary's logits; weights split over another axis (``embed`` over
``data`` under ``fsdp``, ``ep`` and ``tp_dp``) are gathered at their use;
over a pipeline axis (``pp``, ``pp_tp``) a rank owns its stage's layers and
their cache or pool rows, the stages run in turn on the hidden state that
hops from one to the next, and the last stage's logits are broadcast to
every rank; ``ddp``, ``sp_ring`` and ``ulysses`` split no weight and decode
as one card does, on the whole prompt.  The cache and the pool hold the
rank's kv heads, all of them where they stay whole, of its layers.  Every
rank of the mesh runs every step together: the sums, gathers, hops and
broadcasts are collectives.

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
import math
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from polyaxon_tpu_torch._device import DeviceLike, resolve_device
from polyaxon_tpu_torch.models.transformer import (
    TensorSplit,
    TransformerConfig,
    _dense_attention,
    _rmsnorm,
    _rope,
    _vocab_parallel_embed,
    forward,
    param_axes,
)
from polyaxon_tpu_torch.parallel.axes import (
    entry_axes,
    gather_shards,
    shard_tensor,
    tree_map,
    tree_specs,
)
from polyaxon_tpu_torch.parallel.collectives import (
    all_gather_cat,
    broadcast_from,
    reduce_from_group,
)
from polyaxon_tpu_torch.parallel.pipeline import run_stages
from polyaxon_tpu_torch.parallel.templates import check_mesh
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
    cfg: TransformerConfig, batch: int, max_len: int, device: DeviceLike = "cuda",
    kv_heads: Optional[int] = None, layers: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Zeroed KV cache: k/v [L, B, max_len, Hkv, d] in the compute dtype
    (``kv_heads`` and ``layers``: a rank's, :attr:`DecodeShard.kv_heads` and
    :attr:`DecodeShard.layers`; default all)."""
    c = cfg
    dev = resolve_device(device)
    shape = (layers or c.n_layers, batch, max_len, kv_heads or c.kv_heads, c.head_dim)
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


# -- sharded decode --------------------------------------------------------
# Counterpart of decode.py:834-962 of the JAX package.  There the specs place
# arrays and GSPMD inserts the collectives; here each rank holds its shards
# (``parallel.axes.tree_shard`` of the specs below) and :class:`DecodeShard`
# runs the steps on them.


def _fit_spec(spec, shape, mesh_shape: Dict[str, int]) -> tuple:
    """``spec`` with a dimension whole where its axes' mesh size does not
    divide it (the reference's shape-aware replication fallback, :834-850):
    one entry a dimension of ``shape``."""
    names = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, name in zip(shape, names):
        total = math.prod(mesh_shape.get(a, 1) for a in entry_axes(name))
        out.append(name if name is not None and total and dim % total == 0 else None)
    return tuple(out)


def quantized_weight_shardings(cfg: TransformerConfig, mesh, template,
                               qweights: Dict[str, Any]) -> Dict[str, tuple]:
    """The specs of a :func:`quantize_weights` tree under a template's rules
    (reference :853-875): each ``(q, scale)`` pair takes its source weight's
    logical axes, fitted to each half's shape, so the int8 tensor splits as
    the weight it replaced and the scale's kept contraction dims (size 1)
    stay whole.  Each rank streams only its shard's int8 bytes."""
    axes = param_axes(cfg)
    name_axes = {k: axes["block"][k] for k in QUANTIZED_BLOCK_WEIGHTS}
    name_axes["unembed"] = axes["unembed"]
    base = tree_specs(name_axes, template.rules, mesh.shape)
    return {name: tuple(_fit_spec(base[name], leaf.shape, mesh.shape) for leaf in qweights[name])
            for name in qweights}


def shard_qweights(qweights: Dict[str, Any], qspecs: Dict[str, tuple], mesh) -> Dict[str, tuple]:
    """This rank's shards of a :func:`quantize_weights` tree under
    :func:`quantized_weight_shardings`' specs (each half of a pair by its own)."""
    return {name: tuple(shard_tensor(t, spec, mesh) for t, spec in zip(pair, qspecs[name]))
            for name, pair in qweights.items()}


def decode_param_shardings(cfg: TransformerConfig, mesh, template,
                           params: Optional[Any] = None) -> Dict[str, Any]:
    """The weights' specs under a template's rules (reference :878-904): what
    serving shards the initial and the restored params by.  With ``params``
    (or any tree of the same shapes) a dimension that its axes' mesh size
    does not divide stays whole: ``n_kv_heads: 1`` under ``tensor: 2`` keeps
    ``wk``/``wv`` whole while ``wq`` splits, so serving degrades to
    replication instead of failing for any model the spec accepts."""
    specs = tree_specs(param_axes(cfg), template.rules, mesh.shape)
    if params is not None:
        specs = tree_map(lambda spec, leaf: _fit_spec(spec, leaf.shape, mesh.shape), specs,
                         params, is_leaf=lambda x: isinstance(x, tuple))
    return specs


class DecodeShard:
    """One rank's part of a sharded decode: the mesh, the spec trees its
    weights were cut by (``specs``, and ``qspecs`` for an int8 tree), what
    they split over the tensor axis (:class:`~polyaxon_tpu_torch.models.
    transformer.TensorSplit`) and over the pipeline axis.

    - The tensor axis is the one mesh axis that splits the heads, the MLP
      columns or the vocabulary (``tp``, ``tp_dp``, ``pp_tp``).
    - The pipeline axis is the one that splits the block weights' stacked
      ``layers`` dimension (``pp``, ``pp_tp``; a ``custom`` ``layers``
      rule).  A rank then owns its stage: :attr:`layers` consecutive layers
      from :attr:`first_layer`, whose weights it holds and whose cache or
      pool rows it writes; every step runs the stages in order, the hidden
      state passing stage to stage (:func:`_run_layers`), and the last
      stage's logits reach every rank (:func:`_final_logits`).  A layer's
      weights never leave their stage.
    - Every other split (``embed`` over ``data`` under ``fsdp``, ``ep`` and
      ``tp_dp``) is gathered at its use (:meth:`use`).  ``sp_ring`` and
      ``ulysses`` split no weight: their ranks decode as one card does.

    :attr:`kv_heads` is the rank's kv heads (all of them where they stay
    whole) and :attr:`layers` its cache depth.  ``capturable``: whether a
    step can be captured into a CUDA graph (every group the step calls
    NCCL: gloo's collectives run on the host)."""

    #: (weight, dimension) pairs the tensor axis may split.
    _TENSOR_DIMS = {("wq", 2), ("wk", 2), ("wv", 2), ("wo", 1), ("wi", 2), ("wg", 2),
                    ("wd", 1), ("embed", 0), ("unembed", 1)}

    def __init__(self, cfg: TransformerConfig, mesh, specs: Dict[str, Any],
                 qspecs: Optional[Dict[str, tuple]] = None) -> None:
        if cfg.n_experts:
            raise NotImplementedError("MoE decoding is not supported yet")
        self.mesh = mesh
        self.specs = specs
        self.qspecs = qspecs
        self.vocab_size = cfg.vocab_size
        named = [("embed", specs["embed"]), ("unembed", specs["unembed"])]
        named += [(k, v) for k, v in specs["block"].items()]
        # A spec tree the rules of a template make has one axis on a tensor
        # dimension, one for all three of them, and never the tensor axis
        # elsewhere (parallel/templates.py:check_rules refuses the others);
        # these checks hold a tree given by hand to the same.
        tensor_axes = set()
        for name, spec in named:
            for dim, entry in enumerate(spec):
                if (name, dim) in self._TENSOR_DIMS and entry is not None:
                    if len(entry_axes(entry)) > 1:
                        raise NotImplementedError(
                            f"{name!r} split over {entry} (one axis a dimension) is not ported "
                            "(ROADMAP item 7: multi-process and parallelism)")
                    tensor_axes.add(entry_axes(entry)[0])
        if len(tensor_axes) > 1:
            raise NotImplementedError(
                f"heads, MLP columns and vocabulary split over {sorted(tensor_axes)}: the "
                "port splits them over one axis (ROADMAP item 7: multi-process and parallelism)")
        axis = tensor_axes.pop() if tensor_axes else None
        if axis is not None and mesh.shape.get(axis, 1) == 1:
            axis = None
        for name, spec in named:
            for dim, entry in enumerate(spec):
                if axis in entry_axes(entry) and (name, dim) not in self._TENSOR_DIMS:
                    raise NotImplementedError(
                        f"{name!r} dimension {dim} split over the tensor axis {axis!r} is not "
                        "ported (ROADMAP item 7: multi-process and parallelism)")
        stage_axes = {entry_axes(spec[0]) if spec else () for spec in specs["block"].values()}
        if len(stage_axes) > 1 or any(len(a) > 1 for a in stage_axes):
            raise NotImplementedError(
                f"the block's layers split over {sorted(stage_axes)}: the port's stages lie "
                "along one axis (ROADMAP item 7: multi-process and parallelism)")
        stage_axis = next(iter(stage_axes), ())
        stage_axis = stage_axis[0] if stage_axis and mesh.shape.get(stage_axis[0], 1) > 1 else None
        self.keep = (axis,) if axis else ()
        self.split = TensorSplit(cfg, specs, mesh, axis)
        self.kv_heads = cfg.kv_heads // (mesh.shape[axis] if self.split.kv_split else 1)
        #: The pipeline axis (None: every rank runs every layer), its group,
        #: the stage count, this rank's stage, and the stage's layers.
        self.stage_axis = stage_axis
        self.pipe = None if stage_axis is None else mesh.group(stage_axis)
        self.stages = 1 if stage_axis is None else mesh.shape[stage_axis]
        self.stage = 0 if stage_axis is None else mesh.rank(stage_axis)
        self.layers = cfg.n_layers // self.stages
        self.first_layer = self.stage * self.layers
        called = {a for _, spec in named for entry in spec for a in entry_axes(entry)}
        groups = [mesh.group(a) for a in called if mesh.shape.get(a, 1) > 1]
        self.capturable = all(g.name() != "gloo" for g in groups)

    @property
    def last_stage(self) -> bool:
        """Whether this rank's stage computes the logits."""
        return self.stage == self.stages - 1

    def check(self, params: Dict[str, Any]) -> None:
        """Raise unless ``params`` are this rank's shards under :attr:`specs`
        (``parallel.axes.tree_shard``), not the whole tree."""
        layers, heads = params["block"]["wq"].shape[0], params["block"]["wq"].shape[2]
        if heads != self.split.heads or layers != self.layers:
            raise ValueError(
                f"wq holds {layers} layers of {heads} heads where this rank's shard holds "
                f"{self.layers} of {self.split.heads}: pass each rank its shards "
                "(parallel.axes.tree_shard(params, specs, mesh))")

    def use(self, w, spec):
        """``w`` (a rank's shard, or an int8 ``(q, scale)`` pair of them with
        a spec each) gathered along every dimension split over an axis other
        than the tensor axis."""
        if isinstance(w, tuple):
            return tuple(gather_shards(t, sp, self.mesh, self.keep) for t, sp in zip(w, spec))
        return gather_shards(w, spec, self.mesh, self.keep)

    def layer_specs(self, qweights: Optional[Dict[str, Any]]) -> Tuple[Dict[str, Any], Any]:
        """The specs of :func:`_decode_weights`'s two trees, a layer's
        (the stacked ``layers`` dimension dropped)."""
        blk = self.specs["block"]
        if qweights is None:
            return {k: v[1:] for k, v in blk.items()}, self.specs["unembed"]
        q = self.qspecs or {k: ((), ()) for k in qweights}
        layer = {"attn_norm": blk["attn_norm"][1:], "mlp_norm": blk["mlp_norm"][1:],
                 **{k: tuple(sp[1:] for sp in q[k]) for k in QUANTIZED_BLOCK_WEIGHTS}}
        return layer, q["unembed"]

    def embed(self, params: Dict[str, Any], tokens: torch.Tensor, dtype) -> torch.Tensor:
        """The tokens' embeddings: a vocabulary-parallel lookup where the
        table's rows split over the tensor axis.  Every stage embeds (a
        lookup), so that a table split over the pipeline axis is gathered
        by all of its ranks; the first stage's is the one the layers read."""
        table = self.use(params["embed"], self.specs["embed"]).to(dtype)
        if self.split.vocab is None:
            return table[tokens]
        return _vocab_parallel_embed(table, tokens, self.split.vocab)

    def logits(self, x: torch.Tensor, unembed, spec) -> torch.Tensor:
        """float32 logits over the whole vocabulary on every rank: the rank's
        columns gathered."""
        local = torch.einsum("btd,dv->btv", x, _wdq(self.use(unembed, spec), x.dtype)).float()
        return all_gather_cat(local, -1, self.split.vocab)


def _run_layers(x: torch.Tensor, shard: Optional[DecodeShard], n_layers: int,
                body: Callable[[int, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``x`` through ``body(i, x)`` for each of this rank's layers ``i``; under
    a pipeline its stage's, the stages in order (``parallel.pipeline.
    run_stages``): the last stage ends with the model's hidden state."""

    def layers(h: torch.Tensor, n: int) -> torch.Tensor:
        for i in range(n):
            h = body(i, h)
        return h

    if shard is None or shard.pipe is None:
        return layers(x, n_layers)
    return run_stages(x, shard.pipe, lambda h: layers(h, shard.layers))


def _embed(params, tokens, dtype, shard: Optional[DecodeShard]) -> torch.Tensor:
    if shard is None:
        return params["embed"].to(dtype)[tokens]
    return shard.embed(params, tokens, dtype)


def _final_logits(params, x, unembed, shard: Optional[DecodeShard], unembed_spec=None):
    """The final norm and the unembedding of x [B, T, D] → float32 logits.
    Under a pipeline the last stage computes them and broadcasts them over
    the pipeline group, so every rank picks the same token; every stage
    calls :meth:`DecodeShard.use` on the two weights first (a gather where a
    ``custom`` rule splits them over the pipeline axis, else nothing)."""
    if shard is None:
        x = _rmsnorm(x, params["final_norm"])
        return torch.einsum("btd,dv->btv", x, _wdq(unembed, x.dtype)).float()
    norm = shard.use(params["final_norm"], shard.specs["final_norm"])
    if shard.pipe is None:
        return shard.logits(_rmsnorm(x, norm), unembed, unembed_spec)
    unembed = shard.use(unembed, unembed_spec)
    if shard.last_stage:
        local = torch.einsum("btd,dv->btv", _rmsnorm(x, norm), _wdq(unembed, x.dtype)).float()
        logits = all_gather_cat(local, -1, shard.split.vocab)
    else:
        logits = x.new_empty(x.shape[:2] + (shard.vocab_size,), dtype=torch.float32)
    return broadcast_from(logits, shard.pipe, shard.stages - 1)


def _layers_of(params, qweights, shard: Optional[DecodeShard]):
    """``(layer i → its weights, unembed, unembed's spec)`` for the steps:
    under a shard each weight gathered along its non-tensor splits (``i``
    counts the rank's own layers: its stage's under a pipeline)."""
    layers, unembed = _decode_weights(params, qweights)
    if shard is None:
        return (lambda i: _layer_at(layers, i)), unembed, None
    lspecs, uspec = shard.layer_specs(qweights)

    def at(i):
        return {k: shard.use(w, lspecs[k]) for k, w in _layer_at(layers, i).items()}

    return at, unembed, uspec


def _kv_for(split: Optional[TensorSplit], kv: torch.Tensor, group: int):
    """``(kv', group')`` the grouped contraction reads (:meth:`TensorSplit.kv_view`)."""
    return (kv, group) if split is None else split.kv_view(kv)


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


def _block_step(x, pos: torch.Tensor, layer, ck, cv, cfg: TransformerConfig,
                split: Optional[TensorSplit] = None):
    """One transformer block for one new token, writing its KV row at ``pos``
    (a 0-d tensor).

    x: [B, 1, D]; ck/cv: [B, max_len, Hkv, d], this layer's cache (updated
    in place); under ``split`` the rank's heads and MLP columns, summed over
    the tensor axis after ``wo`` and ``wd``.
    """
    c = cfg
    attn_group = None if split is None else split.attn
    mlp_group = None if split is None else split.mlp
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
    (ck, group), (cv, _) = (_kv_for(split, kv, c.n_heads // c.kv_heads) for kv in (ck, cv))
    attn = _attend_cached(q, ck, cv, pos, group)
    x = x + reduce_from_group(torch.einsum("bthk,hkd->btd", attn, _wdq(layer["wo"], h.dtype)),
                              attn_group)

    h = _rmsnorm(x, layer["mlp_norm"])
    up = torch.einsum("btd,df->btf", h, _wdq(layer["wi"], h.dtype))
    gate = torch.einsum("btd,df->btf", h, _wdq(layer["wg"], h.dtype))
    y = torch.nn.functional.silu(gate) * up
    return x + reduce_from_group(torch.einsum("btf,fd->btd", y, _wdq(layer["wd"], h.dtype)),
                                 mlp_group)


@torch.inference_mode()
def decode_step(
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    token: torch.Tensor,
    pos: Union[int, torch.Tensor],
    cfg: TransformerConfig,
    qweights: Optional[Dict[str, Any]] = None,
    shard: Optional[DecodeShard] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token [B] at absolute ``pos`` → (logits [B, vocab] float32, the cache
    with this token's rows written).  ``pos`` is a 0-d integer tensor on the
    cache's device (an int is copied there first).  ``shard``: this rank's
    part of a sharded decode (``params``, ``qweights`` and the cache its
    shards); every rank of the mesh calls it together."""
    c = cfg
    pos = _on(pos, token.device)
    x = _embed(params, token, c.dtype, shard)[:, None, :]  # [B,1,D]
    layer_at, unembed, uspec = _layers_of(params, qweights, shard)
    split = None if shard is None else shard.split
    x = _run_layers(x, shard, c.n_layers, lambda i, h: _block_step(
        h, pos, layer_at(i), cache["k"][i], cache["v"][i], c, split))
    return _final_logits(params, x, unembed, shard, uspec)[:, 0], cache


@torch.inference_mode()
def prefill(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    cfg: TransformerConfig,
    *,
    template=None,
    mesh=None,
    specs: Any = None,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt [B, T] through the training forward, filling
    cache[:, :, :T]; returns (last-position logits [B, vocab], cache).  Under
    ``template`` and ``mesh`` the forward is the decode prefill of
    ``forward(return_kv=True)`` on the rank's shards cut by ``specs``: its
    keys and values are the rank's kv heads of its stage's layers."""
    logits, (k, v) = forward(params, tokens, cfg, template=template, mesh=mesh,
                             return_kv=True, specs=specs, device=device)
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
    template=None,
    mesh=None,
    specs: Any = None,
    qspecs: Optional[Dict[str, tuple]] = None,
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

    Sharded (``template`` and ``mesh``, any template whose rules the port
    splits, see :func:`sharded_generate_fn`): ``params`` and ``qweights``
    are the rank's shards under ``specs`` and ``qspecs``, the prefill runs
    the template's decode prefill (``forward(return_kv=True)``), and the
    one-token step runs a :class:`DecodeShard`; every rank returns the same
    tokens.  Over NCCL the step is captured as above (the prefill's
    collectives have run on the group before the capture); over gloo, whose
    collectives run on the host, it runs eagerly where it calls one.
    """
    if cfg.n_experts:
        raise NotImplementedError("MoE decoding is not supported yet")
    dev = resolve_device(device)
    shard = None
    if mesh is not None and mesh.size > 1:
        check_mesh(template, mesh)
        if specs is None:
            specs = decode_param_shardings(cfg, mesh, template)
        shard = DecodeShard(cfg, mesh, specs, qspecs)
        shard.check(params)
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
    cache = (init_cache(cfg, B, max_len, dev) if shard is None else
             init_cache(cfg, B, max_len, dev, kv_heads=shard.kv_heads, layers=shard.layers))
    if shard is None:
        logits, cache = prefill(params, prompt, cache, cfg, device=dev)
    else:
        logits, cache = prefill(params, prompt, cache, cfg, template=template, mesh=mesh,
                                specs=specs, device=dev)

    def pick(logits):
        if greedy:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / float(temperature), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    # The step's inputs: the token to feed and its position.
    token = pick(logits)
    pos = torch.full((), T, dtype=torch.long, device=dev)

    def step():
        return decode_step(params, cache, token, pos, cfg, qweights=qweights, shard=shard)[0]

    graph = None
    if dev.type == "cuda" and max_new_tokens > 1 and (shard is None or shard.capturable):
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


def sharded_generate_fn(
    cfg: TransformerConfig,
    mesh,
    template,
    *,
    max_new_tokens: int,
    greedy: bool = True,
    params: Optional[Any] = None,
    param_shardings: Optional[Any] = None,
    qweights_shardings: Optional[Dict[str, tuple]] = None,
    device: DeviceLike = "cuda",
):
    """``(fn, specs)`` for decoding across the ranks of ``mesh`` under a
    template (reference :907-962): the template's rules shard every weight
    (the heads over ``tensor`` under ``tp``, the layers over ``pipeline``
    under ``pp``, each weight's ``embed`` over ``data`` under ``fsdp``), each
    rank's cache holds its kv heads of its layers, and every rank gets the
    logits once a token (gathered over the tensor axis, broadcast from the
    last stage).

    Every rank shards the whole params by ``specs``
    (``parallel.axes.tree_shard(params, specs, mesh)``) and calls ``fn(shard,
    prompt, generator, temperature, qweights_shard)`` at the same time, with
    the same prompt, a generator in the same state and the same temperature
    (they replicate, as the reference's do); each gets the same tokens
    ``[B, max_new_tokens]``.  ``specs`` are ``param_shardings`` when given,
    else :func:`decode_param_shardings` of ``params`` (fitted to their shapes
    when given).  ``qweights_shardings`` (:func:`quantized_weight_shardings`)
    makes int8 compose with the sharding: pass the rank's int8 shards as the
    fifth argument, or None.
    """
    specs = (param_shardings if param_shardings is not None
             else decode_param_shardings(cfg, mesh, template, params=params))

    def fn(params_shard, prompt, generator, temperature, qweights_shard):
        return generate(params_shard, prompt, cfg, max_new_tokens=max_new_tokens,
                        temperature=0.0 if greedy else temperature, generator=generator,
                        qweights=qweights_shard, device=device, template=template, mesh=mesh,
                        specs=specs, qspecs=qweights_shardings)

    return fn, specs


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
    kv_heads: Optional[int] = None,
    layers: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Zeroed paged KV pool: k/v [L, num_blocks, block_size, Hkv, d] in the
    compute dtype, or with ``kv_dtype="int8"`` int8 ``k_q``/``v_q`` of that
    shape and float32 ``k_scale``/``v_scale`` [L, num_blocks, block_size, Hkv]
    (one scale per appended row per kv-head, so the scales split with the
    rows).  ``kv_heads`` and ``layers``: a rank's (:attr:`DecodeShard.kv_heads`,
    all of them where they stay whole; :attr:`DecodeShard.layers`, its
    stage's under a pipeline); default the model's."""
    _check_kv_dtype(kv_dtype)
    c = cfg
    dev = resolve_device(device)
    shape = (layers or c.n_layers, num_blocks, block_size, kv_heads or c.kv_heads, c.head_dim)
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
                 cfg: TransformerConfig, split: Optional[TensorSplit] = None):
    """One decoder block over the paged pool: write this call's KV rows, then
    attend against everything the table holds (the rows just written are the
    call's own causal keys).  x: [B, T, D]; tables [W] (B = 1) or [B, W];
    write_blk/write_off index each new row; ``attend(q, ck, cv)`` gets the
    kv heads the rank's query heads read.  Under ``split`` the rank's heads
    and MLP columns, summed over the tensor axis after ``wo`` and ``wd``."""
    attn_group = None if split is None else split.attn
    mlp_group = None if split is None else split.mlp
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
    x = x + reduce_from_group(torch.einsum("bthk,hkd->btd", attn, _wdq(layer["wo"], h.dtype)),
                              attn_group)

    h = _rmsnorm(x, layer["mlp_norm"])
    up = torch.einsum("btd,df->btf", h, _wdq(layer["wi"], h.dtype))
    gate = torch.einsum("btd,df->btf", h, _wdq(layer["wg"], h.dtype))
    y = torch.nn.functional.silu(gate) * up
    return x + reduce_from_group(torch.einsum("btf,fd->btd", y, _wdq(layer["wd"], h.dtype)),
                                 mlp_group)


def _paged_forward(params, pool, x, positions, tables, write_blk, write_off, attend,
                   cfg: TransformerConfig, qweights, last=None,
                   shard: Optional[DecodeShard] = None):
    """The layer loop of the three paged steps → float32 logits [B, T, vocab]
    (of row ``last`` only, [B, 1, vocab], when given: a [1] index tensor)."""
    layer_at, unembed, uspec = _layers_of(params, qweights, shard)
    split = None if shard is None else shard.split
    x = _run_layers(x, shard, cfg.n_layers, lambda i, h: _paged_block(
        h, positions, layer_at(i), {name: leaf[i] for name, leaf in pool.items()}, tables,
        write_blk, write_off, attend, cfg, split))
    if last is not None:
        x = x.index_select(1, last)
    return _final_logits(params, x, unembed, shard, uspec)


@torch.inference_mode()
def paged_prefill_chunk(
    params: Dict[str, Any],
    pool: Dict[str, torch.Tensor],
    table: torch.Tensor,
    tokens: torch.Tensor,
    start: Union[int, torch.Tensor],
    length: Union[int, torch.Tensor],
    cfg: TransformerConfig,
    shard: Optional[DecodeShard] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Insert one prompt chunk into the pool; returns (float32 logits [vocab]
    of its last real token, pool).  ``shard``: as :func:`paged_decode_step`'s.

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
        if shard is not None:
            return _dense_attention(q, shard.split.expand_kv(ck), shard.split.expand_kv(cv),
                                    positions, kpos)
        if group > 1:
            ck = ck.repeat_interleave(group, dim=2)
            cv = cv.repeat_interleave(group, dim=2)
        return _dense_attention(q, ck, cv, positions, kpos)

    x = _embed(params, tokens, c.dtype, shard)[None]  # [1, C, D]
    last = torch.clamp(length - 1, min=0).reshape(1)
    logits = _paged_forward(params, pool, x, positions, table, write_blk, write_off,
                            attend, c, None, last=last, shard=shard)
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
    shard: Optional[DecodeShard] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Advance a mixed batch one token against the pool → (float32 logits
    [S, vocab], pool).

    tables [S, W] (unset entries → trash block 0); slot s feeds ``tokens[s]``
    at ``pos[s]``; inactive lanes write their row to block 0, offset 0.
    ``qweights`` streams the matmul weights as int8 pairs.  ``shard``: this
    rank's part of a sharded step (``params``, ``qweights`` and the pool its
    shards, :class:`DecodeShard`); every rank of the mesh calls it together
    with the same tables, tokens and positions, and gets the same logits.
    """
    c = cfg
    S = tables.shape[0]
    bs, _, _ = pool_geometry(pool)
    pos = torch.where(active, pos, 0)
    lanes = torch.arange(S, device=tables.device)
    write_blk = torch.where(active, tables[lanes, pos // bs], 0)
    write_off = torch.where(active, pos % bs, 0)
    split = None if shard is None else shard.split

    def attend(q, ck, cv):
        (ck, group), (cv, _) = (_kv_for(split, kv, c.n_heads // c.kv_heads) for kv in (ck, cv))
        return _attend_paged(q, ck, cv, pos, group)

    x = _embed(params, tokens, c.dtype, shard)[:, None, :]  # [S,1,D]
    logits = _paged_forward(params, pool, x, pos[:, None], tables, write_blk, write_off,
                            attend, c, qweights, shard=shard)
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
    shard: Optional[DecodeShard] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Score each lane's drafted run in one pass → (float32 logits [S, T,
    vocab], pool).  ``shard``: as :func:`paged_decode_step`'s.

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
    split = None if shard is None else shard.split

    def attend(q, ck, cv):
        (ck, group), (cv, _) = (_kv_for(split, kv, c.n_heads // c.kv_heads) for kv in (ck, cv))
        return _attend_spec(q, ck, cv, qpos, group)

    x = _embed(params, tokens, c.dtype, shard)  # [S, T, D]
    logits = _paged_forward(params, pool, x, qpos, tables, write_blk, write_off,
                            attend, c, qweights, shard=shard)
    return logits, pool
