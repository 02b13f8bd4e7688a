"""Parity of the port's ring attention (``parallel/ring.py`` and the ring over
the kernels in ``parallel/flash.py``) with the JAX package's, on the CPU.

The port runs on 2 and 4 gloo ranks, one thread of this process each
(``tests/torch_ring_ranks.py``), each rank on its sequence shard; the JAX
side runs ``ring_attention_sharded`` on ``build_mesh({"sequence": n})`` over
the virtual CPU devices, its flash ring in Pallas interpret mode, the
port's flash ring on the kernels' plain versions.  The same numpy inputs
go to both.  Tolerances are those of the JAX package's own ring tests
(``tests/test_parallel/test_strategies.py``, ``TestRingFlash``): values
atol 2e-5, grads atol 5e-4, float32.  The model under ``sp_ring``: the mean
of the ranks' losses within 1e-5 of the JAX single-device loss, and the sum
of the ranks' grads within 1e-4 of each JAX grad's norm.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.parallel import flash as jflash
from polyaxon_tpu.parallel.ring import ring_attention_sharded as jax_ring_attention
from polyaxon_tpu.runtime.mesh import build_mesh as jax_build_mesh
from polyaxon_tpu_torch.builtins.trainers import lm_train
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.parallel import flash as tflash
from polyaxon_tpu_torch.parallel.ring import GroupRing, LocalRing, ring_attention_sharded
from polyaxon_tpu_torch.parallel.templates import template_for
from polyaxon_tpu_torch.runtime.mesh import build_mesh
from polyaxon_tpu_torch.runtime.optim import tree_leaves
from polyaxon_tpu_torch.tracking.context import Context
from tests.torch_ring_ranks import run_ranks

# (B, T, H, Hkv, d): the global sequence; each of n ranks holds T / n.
SHAPES = {"mha": (2, 64, 4, 4, 8), "gqa": (2, 64, 4, 2, 8)}
IMPLS = ("dense", "flash")
# Small float32 models for sp_ring: head_dim 8 and 16, both GQA.
MODELS = {
    "hd8": dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
                d_ff=64, max_seq=32),
    "hd16": dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                 d_ff=96, max_seq=32),
}
MODEL_BATCH, MODEL_SEQ = 2, 32


def qkvdo(variant):
    B, T, H, Hkv, d = SHAPES[variant]
    rng = np.random.default_rng(13 + H + Hkv)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, T, H, d), (B, T, Hkv, d), (B, T, Hkv, d), (B, T, H, d)))


@functools.lru_cache(maxsize=None)
def jax_ring(n, impl, variant):
    """The JAX ring's output and its q/k/v grads for sum(out * do)."""
    mesh = jax_build_mesh({"sequence": n}, devices=jax.devices()[:n])
    q, k, v, do = (jnp.asarray(x) for x in qkvdo(variant))

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(
            lambda q, k, v: jax_ring_attention(q, k, v, mesh, "sequence", impl=impl), q, k, v)
        return out, vjp(do)

    out, grads = run(q, k, v, do)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@functools.lru_cache(maxsize=None)
def model_case(name):
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, attention_impl="dense", **MODELS[name])
    params = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(3), jcfg))
    tok = np.random.default_rng(4).integers(0, MODELS[name]["vocab_size"],
                                            (MODEL_BATCH, MODEL_SEQ + 1))
    tokens, targets = tok[:, :-1].astype(np.int64), tok[:, 1:].astype(np.int64)
    return jcfg, params, tokens, targets


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(name):
    """The JAX single-device loss and grads of model ``name`` (dense
    attention: the reference for every port impl)."""
    jcfg, params, tokens, targets = model_case(name)
    batch = {"tokens": jnp.asarray(tokens, jnp.int32), "targets": jnp.asarray(targets, jnp.int32)}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jtr.loss_fn(p, batch, jcfg)))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def port_runs():
    """The port's results on n gloo ranks, one run per n for every case."""
    runs = {}

    def get(n):
        if n not in runs:
            payload = {"ring": [(impl, *qkvdo(v)) for impl in IMPLS for v in SHAPES]}
            if n == 2:
                payload["model"] = [
                    ({**MODELS[name], "attention_impl": impl}, *model_case(name)[1:])
                    for name in MODELS for impl in ("auto", "flash")]
            runs[n] = run_ranks(n, payload)
        return runs[n]

    return get


@pytest.mark.parametrize("variant", list(SHAPES))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", [2, 4])
def test_ring_on_gloo_ranks_matches_the_jax_ring(port_runs, n, impl, variant):
    ranks = port_runs(n)
    assert [r["rank"] for r in ranks] == list(range(n))
    case = IMPLS.index(impl) * len(SHAPES) + list(SHAPES).index(variant)
    port = [np.concatenate([r["ring"][case][i] for r in ranks], axis=1) for i in range(4)]
    want = jax_ring(n, impl, variant)
    np.testing.assert_allclose(port[0], want[0], atol=2e-5)
    for got, ref in zip(port[1:], want[1:]):
        assert got.shape == ref.shape  # the KV grads stay [B, T, Hkv, d]
        np.testing.assert_allclose(got, ref, atol=5e-4)


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("name", list(MODELS))
def test_sp_ring_model_on_two_ranks_matches_the_jax_loss(port_runs, name, impl):
    """loss_fn under sp_ring, each of 2 ranks on its shard with its global
    positions: the mean loss and the summed grads are the JAX single-device
    loss and grads of the whole sequence."""
    ranks = port_runs(2)
    case = list(MODELS).index(name) * 2 + ("auto", "flash").index(impl)
    loss, grads = jax_loss_and_grads(name)
    assert abs(np.mean([r["model"][case][0] for r in ranks]) - loss) <= 1e-5
    summed = jax.tree.map(lambda *g: np.sum(g, axis=0), *[r["model"][case][1] for r in ranks])
    for path, ref in jax.tree_util.tree_leaves_with_path(grads):
        got = summed
        for key in path:
            got = got[key.key]
        assert got.shape == ref.shape
        assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref), path


def _local_ring_hops(n, variant):
    """The flash ring's hop functions on n threads of this process."""
    B, T, H, Hkv, d = SHAPES[variant]
    q, k, v, do = (torch.from_numpy(x) for x in qkvdo(variant))
    Tl = T // n

    def rank(ring):
        sl = slice(ring.rank * Tl, (ring.rank + 1) * Tl)
        out, lse = tflash.ring_flash_fwd(q[:, sl], k[:, sl], v[:, sl], d**-0.5, ring)
        grads = tflash.ring_flash_bwd(q[:, sl], k[:, sl], v[:, sl], out, lse, do[:, sl],
                                      d**-0.5, ring)
        return (out, *grads)

    results = LocalRing.run(n, rank, timeout=60)
    return [torch.cat([res[i] for res in results], dim=1).numpy() for i in range(4)]


@pytest.mark.parametrize("n", [1, 4])
def test_ring_hops_on_threads_match_the_jax_ring(n):
    """The in-process ring (ranks as threads) that runs the hops with n > 1
    on one card gives the JAX flash ring's values and grads."""
    got = _local_ring_hops(n, "gqa")
    want = jax_ring(n, "flash", "gqa")
    np.testing.assert_allclose(got[0], want[0], atol=2e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=5e-4)


def test_local_ring_rotates_and_a_failing_rank_stops_every_rank():
    def rotate_twice(ring):
        t = torch.tensor([float(ring.rank)])
        (once,) = ring.rotate((t,))
        (back,) = ring.rotate((once,), reverse=True)
        return once.item(), back.item()

    assert LocalRing.run(4, rotate_twice, timeout=30) == [(3.0, 0.0), (0.0, 1.0), (1.0, 2.0),
                                                          (2.0, 3.0)]

    def rank_two_fails(ring):
        if ring.rank == 2:
            raise ValueError("rank 2 failed")
        ring.rotate((torch.zeros(1),))

    with pytest.raises(ValueError, match="rank 2 failed"):
        LocalRing.run(4, rank_two_fails, timeout=30)


@pytest.mark.parametrize("n", [2, 3])
def test_group_ring_on_gloo_rotates_cpu_tensors_as_they_are(n):
    """``GroupRing.rotate`` over a gloo group stages only CUDA tensors
    through the host: CPU tensors of two dtypes arrive from rank r - 1
    (``reverse``: r + 1) on the CPU, in their dtype, with their values, and
    the sent tensors are left as they were."""
    from tests.torch_gang_ranks import run_mesh_ranks

    def rank_main(mesh, rank):
        ring = mesh.ring("sequence")
        assert isinstance(ring, GroupRing) and ring.group.name() == "gloo"
        sent = (torch.arange(6, dtype=torch.float32).view(2, 3) + 10 * rank,
                torch.full((4,), rank, dtype=torch.int64))
        kept = tuple(t.clone() for t in sent)
        got = ring.rotate(sent)
        back = ring.rotate(got, reverse=True)
        assert all(torch.equal(a, b) for a, b in zip(sent, kept))
        assert all(t.device.type == "cpu" and t.dtype == s.dtype for t, s in zip(got, sent))
        return [t.tolist() for t in got], [t.tolist() for t in back]

    for rank, (got, back) in enumerate(run_mesh_ranks({"sequence": n}, rank_main, timeout=60)):
        src = (rank - 1) % n
        assert got == [(torch.arange(6.0).view(2, 3) + 10 * src).tolist(), [src] * 4]
        assert back == [(torch.arange(6.0).view(2, 3) + 10 * rank).tolist(), [rank] * 4]


def test_merge_matches_jax_and_empty_blocks_are_its_identity():
    rng = np.random.default_rng(0)
    o, o_b = (rng.standard_normal((3, 5, 4)).astype(np.float32) for _ in range(2))
    lse, lse_b = (rng.standard_normal((3, 5)).astype(np.float32) for _ in range(2))
    lse[0, :2] = -np.inf  # one side empty
    lse[1, 0] = lse_b[1, 0] = -np.inf  # a row empty in both
    o[0, :2] = 0.0
    o[1, 0] = o_b[1, 0] = 0.0
    jo, jl = jflash._merge(*(jnp.asarray(x) for x in (o, lse, o_b, lse_b)))
    to, tl = tflash._merge(*(torch.from_numpy(x) for x in (o, lse, o_b, lse_b)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
    assert torch.isneginf(tl[1, 0]) and torch.all(to[1, 0] == 0)
    assert torch.equal(to[0, :2], torch.from_numpy(o_b[0, :2]))
    # An empty key block (the kernels' Tk = 0 result) leaves the state as it was.
    q = torch.from_numpy(rng.standard_normal((3, 5, 4)).astype(np.float32))
    e_o, e_lse = tflash.flash_block_fwd(q, q[:, :0], q[:, :0], causal=False, sm_scale=0.5)
    mo, ml = tflash._merge(torch.from_numpy(o_b), torch.from_numpy(lse_b), e_o, e_lse)
    assert torch.equal(mo, torch.from_numpy(o_b)) and torch.equal(ml, torch.from_numpy(lse_b))


def test_hop_case_matches_jax():
    for idx in range(4):
        for i in range(4):
            assert tflash._hop_case(i, idx) == int(jflash._hop_case(i, idx))


@pytest.mark.parametrize("group", [1, 2, 4])
def test_gqa_expand_and_reduce_match_jax(group):
    B, Hkv, T, d = 2, 2, 5, 3
    x = np.random.default_rng(group).standard_normal((B * Hkv, T, d)).astype(np.float32)
    dx = np.random.default_rng(group + 1).standard_normal((B * Hkv * group, T, d))
    dx = dx.astype(np.float32)
    np.testing.assert_array_equal(tflash._gqa_expand(torch.from_numpy(x), B, group).numpy(),
                                  np.asarray(jflash._gqa_expand(jnp.asarray(x), B, group)))
    np.testing.assert_allclose(tflash._gqa_reduce(torch.from_numpy(dx), B, group).numpy(),
                               np.asarray(jflash._gqa_reduce(jnp.asarray(dx), B, group)),
                               atol=1e-6)
    # query head h of batch b reads KV head h // group, as repeat_interleave
    # broadcasts the model's K/V heads
    kv = torch.from_numpy(x).reshape(B, Hkv, T, d)
    expanded = kv.repeat_interleave(group, dim=1).reshape(-1, T, d)
    assert torch.equal(tflash._gqa_expand(torch.from_numpy(x), B, group), expanded)


def test_one_rank_ring_makes_no_call_and_auto_is_dense_on_the_cpu():
    ring = GroupRing()
    t = torch.ones(2)
    assert ring.size == 1 and ring.rank == 0 and ring.rotate((t,))[0] is t
    mesh = build_mesh({"sequence": 1})
    q, k, v, _ = (torch.from_numpy(x) for x in qkvdo("gqa"))
    before = tflash.ring_flash_fwd.blocks
    auto = ring_attention_sharded(q, k, v, mesh, "sequence")
    assert tflash.ring_flash_fwd.blocks == before  # "auto" on the CPU: the dense body
    dense = ring_attention_sharded(q, k, v, mesh, "sequence", impl="dense")
    assert torch.equal(auto, dense)
    flash = ring_attention_sharded(q, k, v, mesh, "sequence", impl="flash")
    assert tflash.ring_flash_fwd.blocks == before + 1
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), atol=2e-5)


def test_ring_raises_on_indivisible_heads_and_unknown_impl():
    mesh = build_mesh({"sequence": 1})
    q = torch.zeros(1, 8, 3, 8)
    with pytest.raises(ValueError, match="divisible"):
        ring_attention_sharded(q, torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 2, 8), mesh,
                               "sequence")
    with pytest.raises(ValueError, match="Unknown ring attention impl"):
        ring_attention_sharded(q, q, q, mesh, "sequence", impl="ulysses")


def test_save_attn_keeps_the_ring_output():
    """Under remat ``save_attn`` the ring op's output is kept: the backward's
    recompute runs no forward hop (one block per layer and step, n = 1),
    and the grads equal those without remat."""
    kw = dict(MODELS["hd16"], dtype=torch.float32, attention_impl="flash")
    jcfg, params_np, tokens, targets = model_case("hd16")
    mesh = build_mesh({"sequence": 1})
    template = template_for("sp_ring", dict(mesh.shape))
    batch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
    grads = {}
    for remat in (False, True):
        cfg = ttr.TransformerConfig(remat=remat, remat_policy="save_attn", **kw)
        params = params_from_jax(params_np, "cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        before = tflash.ring_flash_fwd.blocks
        loss = ttr.loss_fn(params, batch, cfg, template=template, mesh=mesh, device="cpu")
        grads[remat] = torch.autograd.grad(loss, leaves)
        assert tflash.ring_flash_fwd.blocks - before == cfg.n_layers
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_lm_train_sp_ring_on_one_rank_is_the_plain_path():
    """lm_train with strategy sp_ring on a {"sequence": 1} mesh (bench.py's
    T = 16384 arm, here at the smoke size): the ring is one causal block,
    so its losses are the ddp path's with the same kernels' plain versions."""
    params = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128,
                  seq=64, batch=2, steps=3, attention_impl="flash", device="cpu")
    logs = {}
    for strategy, mesh in (("sp_ring", build_mesh({"sequence": 1})), ("ddp", None)):
        records = []
        before = tflash.ring_flash_fwd.blocks
        lm_train(Context(params=params, strategy=strategy, mesh=mesh, seed=1, records=records))
        blocks = tflash.ring_flash_fwd.blocks - before
        losses = [r["values"]["loss"] for r in records if r["kind"] == "metric"
                  and "loss" in r["values"]]
        line = [r["line"] for r in records if r["kind"] == "log"][-1]
        logs[strategy] = (losses, blocks, line)
    assert logs["sp_ring"][0] == logs["ddp"][0]
    assert logs["sp_ring"][1] == 3 * 2 and logs["ddp"][1] == 0  # a block per layer and step
    assert "strategy=sp_ring" in logs["sp_ring"][2] and "strategy=ddp" in logs["ddp"][2]
