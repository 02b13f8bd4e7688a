"""Sharded decode: the port's specs, shards and tokens against the JAX package's.

The reference shards a decode with ``decode_param_shardings`` /
``quantized_weight_shardings`` and lets GSPMD carry the sharding through
``generate`` on one process's devices (``tests/test_parallel/
test_decode_sharded.py``: sharded tokens equal one device's).  The port runs
one rank a process: each thread rank here (``tests/torch_gang_ranks.py``)
holds its shards and calls ``sharded_generate_fn``'s ``fn`` with the others.

- The fitted specs equal the JAX ones on the conftest's virtual CPU devices,
  and each rank's shard (``parallel.axes.tree_shard``) equals the JAX device
  shard of the same index bit for bit, for the weights and the int8 pairs.
- The tokens equal JAX's single-device ``generate`` (float32, greedy) for
  each case of the reference test at 2 and 4 ranks in place of 8: ``tp``,
  ``ddp``, ``tp_dp``, kv heads that do not divide (whole on every rank),
  int8 under ``tp``, GQA, and a part of a GQA group on a rank; and under
  every other template the reference serves: ``fsdp`` and ``ep`` (each
  weight gathered at its use), ``sp_ring`` and ``ulysses`` (whole weights,
  the whole prompt), ``pp`` and ``pp_tp`` (a stage-owned decode: a rank
  runs its stage's layers, the hidden state hops stage to stage, the last
  stage's logits are broadcast), a ``custom`` pipeline with its layers'
  ``embed`` over ``data``, and int8 under ``pp`` and ``fsdp``.
- What still refuses: MoE decoding on a mesh, a ``custom`` rule the port
  does not split; and a ``pp`` rank holds its stage's layers and cache,
  gathering no weight during a decode.

The reference test's model: vocab 128, d_model 32, 2 layers (4 under
``pp {pipeline: 4}``), 8 heads of 8, d_ff 64, max_seq 48.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from polyaxon_tpu.models import decode as jdec
from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.parallel import template_for as jax_template_for
from polyaxon_tpu_torch.models import decode as tdec
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.parallel.axes import tree_map, tree_shard
from polyaxon_tpu_torch.parallel.templates import template_for
from polyaxon_tpu_torch.runtime.mesh import Mesh
import torch.distributed as dist
from tests.torch_gang_ranks import run_mesh_ranks

CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=8, head_dim=8, d_ff=64, max_seq=48)


@functools.lru_cache(maxsize=None)
def model(seed: int, n_kv_heads=None, n_layers: int = 2):
    """(JAX config, port config, JAX params, the port's copy) of one model."""
    kw = dict(CFG, n_kv_heads=n_kv_heads, n_layers=n_layers)
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **kw)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **kw)
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@functools.lru_cache(maxsize=None)
def jax_tokens(seed: int, n_kv_heads, batch: int, prompt_len: int, max_new: int,
               quantize: bool = False, n_layers: int = 2):
    """JAX's single-device greedy tokens, and the prompt they continue."""
    jcfg, _, jp, _ = model(seed, n_kv_heads, n_layers)
    prompt = np.random.default_rng(seed).integers(0, CFG["vocab_size"], (batch, prompt_len))
    qw = jdec.quantize_weights(jp) if quantize else None
    out = jdec.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=max_new, qweights=qw)
    return prompt, np.asarray(out)


class _Coord:
    """A rank's place along one mesh axis, for specs and shards without a
    process group (``Mesh.shard`` reads only ``rank()``)."""

    def __init__(self, size: int, rank: int) -> None:
        self._size, self._rank = size, rank

    def size(self) -> int:
        return self._size

    def rank(self) -> int:
        return self._rank

    def name(self) -> str:
        return "gloo"


def rank_mesh(axes: dict, rank: int) -> Mesh:
    """Rank ``rank``'s port mesh over ``axes`` (row-major, outermost first)."""
    sizes = list(axes.values())
    coords, r = [], rank
    for n in reversed(sizes):
        coords.append(r % n)
        r //= n
    coords.reverse()
    return Mesh(axes, {a: _Coord(n, i) for (a, n), i in zip(axes.items(), coords) if n > 1})


def jax_mesh(axes: dict) -> JaxMesh:
    """Device r at the row-major position of rank r."""
    n = int(np.prod(list(axes.values())))
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(tuple(axes.values())), tuple(axes))


def _padded(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _device_shard(arr, device) -> np.ndarray:
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == device)


#: A custom template: the pipeline's stages, each weight's ``embed`` over
#: ``data`` within a stage (a stage-owned decode that gathers at use).
CUSTOM = {"pipeline_axis": "pipeline", "rules": {"layers": "pipeline", "embed": "data"}}

SPEC_CASES = [
    ("tp", {"tensor": 2}, None, None),
    ("tp_dp", {"data": 2, "tensor": 2}, None, None),
    ("tp", {"data": 2, "tensor": 2}, 1, None),
    ("tp_dp", {"data": 2, "tensor": 2}, 4, None),
    ("fsdp", {"data": 2}, None, None),
    ("pp", {"pipeline": 2}, None, None),
    ("pp_tp", {"pipeline": 2, "tensor": 2}, None, None),
    ("ulysses", {"sequence": 2}, None, None),
    ("sp_ring", {"sequence": 2}, None, None),
    ("ep", {"data": 2, "expert": 2}, None, None),
    ("custom", {"data": 2, "pipeline": 2}, None, CUSTOM),
]


@pytest.mark.parametrize("strategy,axes,n_kv_heads,options", SPEC_CASES,
                         ids=[f"{s}-{'x'.join(map(str, a.values()))}-kv{k}"
                              for s, a, k, _ in SPEC_CASES])
def test_fitted_specs_and_shards_equal_the_jax_ones(strategy, axes, n_kv_heads, options):
    jcfg, tcfg, jp, tp = model(0, n_kv_heads)
    jq, tq = jdec.quantize_weights(jp), tdec.quantize_weights(tp)
    jm = jax_mesh(axes)
    jtpl = jax_template_for(strategy, axes, options)
    tpl = template_for(strategy, axes, options)
    jsh = jdec.decode_param_shardings(jcfg, jm, jtpl, params=jp)
    jqsh = jdec.quantized_weight_shardings(jcfg, jm, jtpl, jq)
    specs = tdec.decode_param_shardings(tcfg, rank_mesh(axes, 0), tpl, params=tp)
    qspecs = tdec.quantized_weight_shardings(tcfg, rank_mesh(axes, 0), tpl, tq)

    def same_spec(spec, sharding, leaf):
        assert _padded(spec, leaf.ndim) == _padded(sharding.spec, leaf.ndim)

    tree_map(same_spec, specs, jsh, tp)
    for name in tq:
        for spec, sharding, leaf in zip(qspecs[name], jqsh[name], tq[name]):
            same_spec(spec, sharding, leaf)
    if n_kv_heads == 1:  # kv projections whole, the query projection split
        assert specs["block"]["wk"] == (None,) * 4 and "tensor" in specs["block"]["wq"]
    if "pipeline" in axes:  # the stages' layers
        assert all(spec[0] == "pipeline" for spec in specs["block"].values())

    placed = jax.device_put(jp, jsh)
    qplaced = jax.device_put(jq, jqsh)
    for rank, device in enumerate(jm.devices.reshape(-1)):
        mesh = rank_mesh(axes, rank)
        mine = tree_shard(tp, specs, mesh)
        tree_map(lambda t, arr: np.testing.assert_array_equal(
            t.numpy(), _device_shard(arr, device)), mine, placed)
        qmine = tdec.shard_qweights(tq, qspecs, mesh)
        for name in tq:
            for half, arr in zip(qmine[name], qplaced[name]):
                np.testing.assert_array_equal(half.numpy(), _device_shard(arr, device))


def _sharded_tokens(strategy, axes, tcfg, tp, prompt, max_new, quantize=False, options=None):
    """Every rank's tokens from ``sharded_generate_fn`` over thread ranks."""
    tq = tdec.quantize_weights(tp) if quantize else None

    def rank_main(mesh, rank):
        tpl = template_for(strategy, axes, options)
        qspecs = tdec.quantized_weight_shardings(tcfg, mesh, tpl, tq) if quantize else None
        fn, specs = tdec.sharded_generate_fn(tcfg, mesh, tpl, max_new_tokens=max_new,
                                             params=tp, qweights_shardings=qspecs, device="cpu")
        qshard = tdec.shard_qweights(tq, qspecs, mesh) if quantize else None
        return fn(tree_shard(tp, specs, mesh), torch.as_tensor(prompt), None, 0.0, qshard)

    return run_mesh_ranks(axes, rank_main, timeout=120)


GENERATE_CASES = {
    # name: (strategy, axes, seed, n_kv_heads, batch, prompt length, new tokens, int8);
    # a ninth entry: (n_layers, the template's options)
    "tp-2": ("tp", {"tensor": 2}, 0, None, 2, 16, 16, False),
    "tp-4": ("tp", {"tensor": 4}, 0, None, 2, 16, 16, False),
    "ddp-2": ("ddp", {"data": 2}, 0, None, 2, 16, 16, False),
    "ddp-4": ("ddp", {"data": 4}, 0, None, 2, 16, 16, False),
    "tp_dp-2x2": ("tp_dp", {"data": 2, "tensor": 2}, 0, None, 2, 16, 16, False),
    "kv1-2x2": ("tp", {"data": 2, "tensor": 2}, 2, 1, 1, 8, 8, False),
    "int8-tp-2": ("tp", {"tensor": 2}, 3, None, 1, 8, 10, True),
    "int8-tp-4": ("tp", {"tensor": 4}, 3, None, 1, 8, 10, True),
    "gqa-2x2": ("tp", {"data": 2, "tensor": 2}, 1, 4, 1, 8, 12, False),
    # 8 heads, 2 kv heads over 4 ranks: each rank's 2 heads half a group.
    "gqa-part-4": ("tp", {"tensor": 4}, 1, 2, 1, 8, 12, False),
    "fsdp-2": ("fsdp", {"data": 2}, 0, None, 2, 16, 16, False),
    "fsdp-4": ("fsdp", {"data": 4}, 0, None, 2, 16, 16, False),
    "pp-2": ("pp", {"pipeline": 2}, 0, None, 2, 16, 16, False),
    "pp-4": ("pp", {"pipeline": 4}, 0, None, 2, 16, 16, False, (4, None)),
    "pp_tp-2x2": ("pp_tp", {"pipeline": 2, "tensor": 2}, 0, None, 2, 16, 16, False),
    "pp_tp-gqa-2x2": ("pp_tp", {"pipeline": 2, "tensor": 2}, 1, 4, 1, 8, 12, False),
    "ulysses-2": ("ulysses", {"sequence": 2}, 0, None, 2, 16, 16, False),
    "ulysses-4": ("ulysses", {"sequence": 4}, 0, None, 2, 16, 16, False),
    "sp_ring-2": ("sp_ring", {"sequence": 2}, 0, None, 2, 16, 16, False),
    "sp_ring-4": ("sp_ring", {"sequence": 4}, 0, None, 2, 16, 16, False),
    "ep-2": ("ep", {"expert": 2}, 0, None, 2, 16, 16, False),
    "ep-2x2": ("ep", {"data": 2, "expert": 2}, 0, None, 2, 16, 16, False),
    "custom-2x2": ("custom", {"data": 2, "pipeline": 2}, 0, None, 2, 16, 16, False,
                   (2, CUSTOM)),
    "int8-pp-2": ("pp", {"pipeline": 2}, 3, None, 1, 8, 10, True),
    "int8-fsdp-2": ("fsdp", {"data": 2}, 3, None, 1, 8, 10, True),
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_sharded_tokens_equal_jax_generate(case):
    strategy, axes, seed, kv, batch, t, max_new, quantize, *rest = GENERATE_CASES[case]
    n_layers, options = rest[0] if rest else (2, None)
    _, tcfg, _, tp = model(seed, kv, n_layers)
    prompt, ref = jax_tokens(seed, kv, batch, t, max_new, quantize, n_layers)
    outs = _sharded_tokens(strategy, axes, tcfg, tp, prompt, max_new, quantize, options)
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), ref)


def test_sharded_prefill_refuses_the_templates_serving_does_not_take():
    """Every template whose rules the port splits serves; what still
    refuses is MoE decoding on a mesh (in both packages) and a ``custom``
    rule that ``check_rules`` refuses, which names ROADMAP item 7."""
    moe = ttr.TransformerConfig(dtype=torch.float32, **dict(CFG, n_experts=4))
    moe_params = ttr.init_params(moe, torch.Generator().manual_seed(0))
    axes = {"tensor": 2}
    tpl = template_for("tp", axes)
    for rank in (0, 1):
        mesh = rank_mesh(axes, rank)
        with pytest.raises(NotImplementedError, match="MoE decoding"):
            tdec.generate(moe_params, torch.zeros(1, 4, dtype=torch.long), moe,
                          max_new_tokens=2, template=tpl, mesh=mesh, device="cpu")
        with pytest.raises(NotImplementedError, match="no MoE"):
            ttr.forward(moe_params, torch.zeros(1, 4, dtype=torch.long), moe, template=tpl,
                        mesh=mesh, return_kv=True, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE decoding"):
        tdec.DecodeShard(moe, rank_mesh(axes, 0),
                         tdec.decode_param_shardings(moe, rank_mesh(axes, 0), tpl))
    _, tcfg, _, tp = model(0)
    for rules in ({"head_dim": "tensor"}, {"heads": ("data", "tensor"), "mlp": ("data", "tensor"),
                                           "vocab": ("data", "tensor")}):
        custom = template_for("custom", {"data": 2, "tensor": 2}, {"rules": rules})
        with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
            tdec.generate(tp, torch.zeros(1, 4, dtype=torch.long), tcfg, max_new_tokens=2,
                          template=custom, mesh=rank_mesh({"data": 2, "tensor": 2}, 0),
                          device="cpu")


def test_a_pipeline_rank_holds_its_stage_and_gathers_no_weight():
    """Under ``pp {pipeline: 2}`` a rank holds its stage's half of the
    block's weights (the embedding, the unembedding and the final norm
    whole), its ``DecodeShard`` runs one layer of two, and ``generate``'s
    cache holds that layer only; a decode on the thread ranks makes no
    all-gather and no all-reduce (no weight is gathered at any point): its
    collectives are the stage hop and the logits' broadcast."""
    _, tcfg, _, tp = model(0)
    axes = {"pipeline": 2}
    tpl = template_for("pp", axes)
    specs = tdec.decode_param_shardings(tcfg, rank_mesh(axes, 0), tpl, params=tp)
    for rank in (0, 1):
        mine = tree_shard(tp, specs, rank_mesh(axes, rank))
        for name, w in tp["block"].items():
            assert mine["block"][name].shape == (1,) + w.shape[1:]
            torch.testing.assert_close(mine["block"][name], w[rank:rank + 1], rtol=0, atol=0)
        for name in ("embed", "unembed", "final_norm"):
            assert mine[name].shape == tp[name].shape
        shard = tdec.DecodeShard(tcfg, rank_mesh(axes, rank), specs)
        assert (shard.stage, shard.stages, shard.layers, shard.first_layer) == (rank, 2, 1, rank)
        assert shard.kv_heads == CFG["n_heads"]
        cache = tdec.init_cache(tcfg, 2, 16, "cpu", kv_heads=shard.kv_heads, layers=shard.layers)
        assert cache["k"].shape == (1, 2, 16, CFG["n_heads"], CFG["head_dim"])
        pool = tdec.init_block_pool(tcfg, 5, 4, kv_dtype="int8", device="cpu",
                                    kv_heads=shard.kv_heads, layers=shard.layers)
        assert pool["k_q"].shape[0] == 1 and pool["k_scale"].shape[0] == 1

    caches, calls = [], []
    real_cache = tdec.init_cache
    real = {name: getattr(dist, name) for name in ("all_gather", "all_reduce", "broadcast")}

    def recording(fn, name):
        def wrapped(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return wrapped

    def cache_of(*args, **kw):
        out = real_cache(*args, **kw)
        caches.append(out["k"].shape)
        return out

    prompt, ref = jax_tokens(0, None, 2, 16, 16)
    try:
        tdec.init_cache = cache_of
        for name, fn in real.items():
            setattr(dist, name, recording(fn, name))
        outs = _sharded_tokens("pp", axes, tcfg, tp, prompt, 16)
    finally:
        tdec.init_cache = real_cache
        for name, fn in real.items():
            setattr(dist, name, fn)
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), ref)
    assert caches == [(1, 2, 32, CFG["n_heads"], CFG["head_dim"])] * 2
    # The prefill's broadcast of the hidden states, then one a step of the
    # logits (15 steps), on each of the two ranks; nothing else.
    assert calls == ["broadcast"] * 2 * 16


def test_a_rank_holds_its_share_of_the_weights_and_the_cache():
    """Under ``tp {tensor: 2}`` a rank's weights are half of the heads, MLP
    columns and vocabulary (the norms whole), and its cache half of the kv
    heads; with one kv head the cache keeps it whole."""
    for kv, cache_heads in ((None, 4), (1, 1)):
        _, tcfg, _, tp = model(0, kv)
        specs = tdec.decode_param_shardings(tcfg, rank_mesh({"tensor": 2}, 0),
                                            template_for("tp", {"tensor": 2}), params=tp)
        shard = tree_shard(tp, specs, rank_mesh({"tensor": 2}, 1))
        whole = sum(t.numel() for t in jax.tree.leaves(tp))
        norms = sum(tp["block"][k].numel() for k in ("attn_norm", "mlp_norm"))
        norms += tp["final_norm"].numel()
        kv_whole = 0 if kv is None else 2 * tp["block"]["wk"].numel()
        assert sum(t.numel() for t in jax.tree.leaves(shard)) == (
            (whole - norms - kv_whole) // 2 + norms + kv_whole)
        assert tdec.DecodeShard(tcfg, rank_mesh({"tensor": 2}, 1), specs).kv_heads == cache_heads
